"""Pileup, consensus and variant calling over mapped reads.

The counterpart of ``bitnuc_tpu/ops/pileup.py``, with the same outputs bit
for bit:

* ``pileup_counts`` lays each kept read down gaplessly at its mapped start
  (reverse-strand reads as their reverse complement, the forward
  reference's bases) and counts bases per reference position: one int32
  ``index_add_`` into a [ref_len, 4] grid. Contributions outside
  [0, ref_len) and reads masked out by ``keep`` drop. Integer adds are
  exact, so the order of the card's atomics does not matter.
* ``pileup_counts_ops`` projects each read through its alignment ops
  (``mapper.traceback_cigars``): exclusive cumsums of the query- and
  reference-consuming ops give each op's query index and reference
  position, and three adds count aligned bases, deletions and insertion
  runs (once, at a run's first op).
* ``consensus_calls`` picks the majority base (ties to the smallest code)
  where the depth reaches min_depth and the winner's share reaches
  min_frac, in float32 as the JAX package decides it:
  float32(best) >= float32(min_frac) * float32(depth).
* ``call_variants`` is the host convenience over mapper outputs, with the
  indel calls of ``cigar=True`` in host numpy and float64 as in the JAX
  package.

The gapless layout mis-piles reads downstream of an indel; callers filter
them by the mapper's cost (``max_cost``). The JAX package has no Pallas
kernel here, and neither has the port: the adds are one PyTorch call each.
"""

from __future__ import annotations

import numpy as np
import torch

from . import align as align_ops
from . import revcomp as revcomp_ops
from ..utils import bitops

PILEUP_BATCH = 262_144  # reads per pileup pass in call_variants


def _on(x, like: torch.Tensor, dtype) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(dtype)


def _oriented_codes(words, lengths, use_rc):
    """[B, 16W] int32 codes of each read in its mapped orientation."""
    rc_words = revcomp_ops.reverse_complement_reads(words, lengths)
    w = torch.where(use_rc[:, None], rc_words, words)
    return bitops.unpack_words(w)


def _count_into(size: int, key: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[size] int32 counts of the keys where valid."""
    out = torch.zeros(size, dtype=torch.int32, device=key.device)
    sel = key[valid].to(torch.int64)
    out.index_add_(0, sel, torch.ones_like(sel, dtype=torch.int32))
    return out


def pileup_counts(words, lengths, ref_start, use_rc, keep, ref_len: int) -> torch.Tensor:
    """Base counts per forward-reference position: [ref_len, 4] int32.

    words/lengths: the reads as read; reads with use_rc True contribute
    their reverse complement (map_reads' strand convention); keep masks
    reads out. ref_start may be negative or past the reference."""
    lengths = _on(lengths, words, torch.int32)
    ref_start = _on(ref_start, words, torch.int32)
    keep = _on(keep, words, torch.bool)
    codes = _oriented_codes(words, lengths, _on(use_rc, words, torch.bool))
    L = codes.shape[-1]
    pos = torch.arange(L, dtype=torch.int32, device=words.device)
    gpos = ref_start[:, None] + pos
    valid = keep[:, None] & (pos < lengths[:, None]) & (gpos >= 0) & (gpos < ref_len)
    return _count_into(4 * ref_len, gpos * 4 + codes, valid).reshape(ref_len, 4)


def consensus_calls(counts: torch.Tensor, ref_words: torch.Tensor, min_depth=1, min_frac=0.5):
    """Consensus and substitution calls from a pileup grid.

    counts: [ref_len, 4] int32 (pileup_counts); ref_words: the packed
    reference (int32 views) covering ref_len bases. Returns (cons
    [ref_len] int32, depth [ref_len] int32, is_variant [ref_len] bool,
    support [ref_len] int32): the majority code where depth >= min_depth
    and float32(best) >= float32(min_frac) * float32(depth), else the
    reference code; ties go to the smallest code; support is the winner's
    count."""
    ref_len = counts.shape[0]
    refc = bitops.unpack_words(ref_words.reshape(1, -1)).reshape(-1)[:ref_len]
    depth = counts.sum(-1, dtype=torch.int32)
    best = counts.amax(-1)
    code = torch.arange(4, dtype=torch.int32, device=counts.device)
    winner = torch.where(counts == best[:, None], code, 4).amin(-1).to(torch.int32)
    frac = torch.tensor(float(min_frac), dtype=torch.float32, device=counts.device)
    confident = (depth >= int(min_depth)) & (
        best.to(torch.float32) >= frac * depth.to(torch.float32))
    cons = torch.where(confident, winner, refc)
    is_variant = confident & (winner != refc)
    return cons, depth, is_variant, best


def pileup_counts_ops(words, lengths, ref_start, use_rc, keep, ops, ref_len: int):
    """Indel-aware pileup through each read's alignment ops (the
    forward-order op codes of mapper.traceback_cigars) [B, T].

    Returns (counts [ref_len, 4] int32, aligned bases (OP_EQ / OP_X), equal
    to pileup_counts for indel-free reads; dels [ref_len] int32, reads
    deleting that reference base; ins [ref_len] int32, insertion runs
    anchored before that position, one a run)."""
    lengths = _on(lengths, words, torch.int32)
    ref_start = _on(ref_start, words, torch.int32)
    keep = _on(keep, words, torch.bool)
    codes = _oriented_codes(words, lengths, _on(use_rc, words, torch.bool))
    L = codes.shape[-1]
    op = _on(ops, words, torch.int32)
    is_base = (op == align_ops.OP_EQ) | (op == align_ops.OP_X)
    q_cons = (is_base | (op == align_ops.OP_INS)).to(torch.int32)
    r_cons = (is_base | (op == align_ops.OP_DEL)).to(torch.int32)
    q_idx = torch.cumsum(q_cons, 1, dtype=torch.int32) - q_cons  # exclusive
    r_pos = ref_start[:, None] + torch.cumsum(r_cons, 1, dtype=torch.int32) - r_cons
    base = torch.gather(codes, 1, torch.clamp(q_idx, 0, L - 1).to(torch.int64))

    live = keep[:, None] & (r_pos >= 0) & (r_pos < ref_len)
    counts = _count_into(4 * ref_len, r_pos * 4 + base, live & is_base).reshape(ref_len, 4)
    dels = _count_into(ref_len, r_pos, live & (op == align_ops.OP_DEL))
    # one event per insertion run: its first op
    prev_op = torch.cat([torch.zeros_like(op[:, :1]), op[:, :-1]], 1)
    ins = _count_into(ref_len, r_pos,
                      live & (op == align_ops.OP_INS) & (prev_op != align_ops.OP_INS))
    return counts, dels, ins


def _insertion_consensus(reads, map_result, ops_np, keep, anchors):
    """The majority inserted sequence at each called anchor, from host
    replays of the op rows of the reads that carry an insertion
    (``Counter.most_common(1)`` over them in row order)."""
    from collections import Counter

    anchors = set(int(a) for a in anchors)
    if not anchors:
        return {}
    has_ins = (ops_np == align_ops.OP_INS).any(axis=1) & np.asarray(keep)
    rows = np.nonzero(has_ins)[0]
    if rows.size == 0:
        return {}
    sel = torch.from_numpy(rows).to(reads.words.device)
    use_rc = np.asarray(map_result["strand"] == b"-")[rows]
    codes = _oriented_codes(reads.words[sel], reads.lengths[sel].to(torch.int32),
                            torch.from_numpy(use_rc).to(reads.words.device)).cpu().numpy()
    rs = np.asarray(map_result["ref_start"], np.int64)[rows]
    seqs_at = {}
    base = b"ACGT"
    for rr, row in enumerate(rows):
        op = ops_np[row]
        qc = np.cumsum((op == align_ops.OP_EQ) | (op == align_ops.OP_X)
                       | (op == align_ops.OP_INS))
        rc = np.cumsum((op == align_ops.OP_EQ) | (op == align_ops.OP_X)
                       | (op == align_ops.OP_DEL))
        t = 0
        T = len(op)
        while t < T and op[t] != align_ops.OP_STOP:
            if op[t] == align_ops.OP_INS:
                # rc is inclusive: the ops before t consumed rc[t - 1] bases
                anchor = int(rs[rr] + (rc[t - 1] if t else 0))
                t0 = t
                while t < T and op[t] == align_ops.OP_INS:
                    t += 1
                if anchor in anchors:
                    q0 = int(qc[t0 - 1] if t0 else 0)
                    seq = bytes(base[c] for c in codes[rr, q0 : q0 + (t - t0)])
                    seqs_at.setdefault(anchor, Counter())[seq] += 1
            else:
                t += 1
    return {a: cnt.most_common(1)[0][0] for a, cnt in seqs_at.items()}


def call_variants(
    index,
    reads,
    map_result: dict,
    max_cost: int = 8,
    min_depth: int = 2,
    min_frac: float = 0.5,
    cigar: bool = False,
    ops=None,
) -> dict:
    """Pileup and calls from mapper outputs, on the index's device.

    index: MinimizerIndex (ref_words, ref_len); reads: the PackedReads that
    were mapped; map_result: mapper.map_reads' dict. Reads pile in batches
    of PILEUP_BATCH (the grids add exactly). Returns numpy arrays {counts
    [ref_len, 4], depth, consensus (codes), variant_pos, variant_ref,
    variant_alt, variant_depth, variant_support}, the variant_* arrays over
    the called sites only.

    cigar=True projects reads through their alignment ops (from ``ops``, or
    the port's mapper.traceback_cigars) and adds the indel calls:
    del_pos/del_len/del_support/del_depth (deletion runs merged across
    consecutive positions), ins_pos/ins_seq/ins_support/ins_depth
    (insertions before ins_pos, with the majority inserted sequence), and
    the dels and ins grids."""
    keep = map_result["mapped"] & (map_result["cost"] <= max_cost)
    dev = index.device
    ref_len = index.ref_len
    ops_np = None
    if cigar:
        if ops is None:
            from .. import mapper as mapper_mod

            ops = mapper_mod.traceback_cigars(index, reads, map_result)["ops"]
        ops_np = np.asarray(ops)
    rs_all = np.array(map_result["ref_start"], np.int32)
    rc_all = np.array(map_result["strand"] == b"-")
    keep = np.array(keep, bool)
    counts = torch.zeros((ref_len, 4), dtype=torch.int32, device=dev)
    dels = torch.zeros(ref_len, dtype=torch.int32, device=dev)
    ins = torch.zeros(ref_len, dtype=torch.int32, device=dev)
    B = int(reads.words.shape[0])
    for s in range(0, B, PILEUP_BATCH):
        e = min(B, s + PILEUP_BATCH)
        args = (reads.words[s:e].to(dev), reads.lengths[s:e].to(dev),
                torch.from_numpy(rs_all[s:e]).to(dev), torch.from_numpy(rc_all[s:e]).to(dev),
                torch.from_numpy(keep[s:e]).to(dev))
        if cigar:
            op_rows = torch.from_numpy(np.ascontiguousarray(ops_np[s:e])).to(dev)
            c, d, i = pileup_counts_ops(*args, op_rows, ref_len)
            dels += d
            ins += i
        else:
            c = pileup_counts(*args, ref_len)
        counts += c
    cons, depth, is_var, support = consensus_calls(counts, index.ref_words, min_depth, min_frac)
    counts = counts.cpu().numpy()
    cons = cons.cpu().numpy()
    depth = depth.cpu().numpy()
    support = support.cpu().numpy()
    vpos = np.nonzero(is_var.cpu().numpy())[0]
    rw = bitops.words_to_u32_np(index.ref_words)
    shifts = np.arange(16, dtype=np.uint32) * 2
    refc = ((rw[:, None] >> shifts[None, :]) & 3).reshape(-1)[:ref_len].astype(np.int32)
    out = {
        "counts": counts,
        "depth": depth,
        "consensus": cons,
        "variant_pos": vpos.astype(np.int64),
        "variant_ref": refc[vpos],
        "variant_alt": cons[vpos],
        "variant_depth": depth[vpos],
        "variant_support": support[vpos],
    }
    if cigar:
        dels = dels.cpu().numpy()
        ins = ins.cpu().numpy()
        md = int(min_depth)
        # a read spanning a position adds a base (depth) or a deletion (dels);
        # call where the deletion allele wins
        cover_d = depth + dels
        del_call = (dels >= md) & (
            dels.astype(np.float64) >= min_frac * np.maximum(cover_d, 1))
        starts = np.nonzero(del_call & ~np.concatenate([[False], del_call[:-1]]))[0]
        d_pos, d_len, d_sup, d_dep = [], [], [], []
        for p0 in starts:  # consecutive called positions make one event
            p1 = p0
            while p1 + 1 < del_call.shape[0] and del_call[p1 + 1]:
                p1 += 1
            d_pos.append(int(p0))
            d_len.append(int(p1 - p0 + 1))
            d_sup.append(int(dels[p0 : p1 + 1].min()))
            d_dep.append(int(cover_d[p0 : p1 + 1].max()))
        out["del_pos"] = np.asarray(d_pos, np.int64)
        out["del_len"] = np.asarray(d_len, np.int64)
        out["del_support"] = np.asarray(d_sup, np.int64)
        out["del_depth"] = np.asarray(d_dep, np.int64)

        cover_i = depth + ins  # supporting reads carry an insertion run at the anchor
        ins_call = (ins >= md) & (
            ins.astype(np.float64) >= min_frac * np.maximum(cover_i, 1))
        anchors = np.nonzero(ins_call)[0]
        seqs = _insertion_consensus(reads, map_result, ops_np, keep, anchors)
        i_pos = [int(a) for a in anchors if int(a) in seqs]
        out["ins_pos"] = np.asarray(i_pos, np.int64)
        out["ins_seq"] = [seqs[a] for a in i_pos]
        out["ins_support"] = np.asarray([int(ins[a]) for a in i_pos], np.int64)
        out["ins_depth"] = np.asarray([int(cover_i[a]) for a in i_pos], np.int64)
        out["dels"] = dels
        out["ins"] = ins
    return out
