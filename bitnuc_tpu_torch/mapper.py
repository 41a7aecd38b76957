"""Minimizer-index short-read mapping (seed, vote, extend) and CIGARs.

The counterpart of the short-read path of ``bitnuc_tpu/mapper.py``:
``MinimizerIndex`` (``build``, ``build_multi``, ``save``, ``load``),
``map_reads`` and ``traceback_cigars``, with the same outputs bit for bit.

1. Seeds: (w,k)-minimizers with positions (``ops.kmer.minimizer_positions``
   for k <= 15, ``minimizer_positions64`` above, then
   ``minimizer_sketch_mask``). Keys are (lo, hi) int32 views of the JAX
   package's uint32 pairs; hi is 0 for k <= 15.
2. Index: the distinct minimizer keys of the reference, ascending by
   unsigned (hi, lo), with up to ``max_occ`` positions each; keys seen
   more often are dropped whole (repeat masking).
3. Join: each read's compacted seed keys find their table row. The table
   keys are sorted and distinct, so the row is one ``torch.searchsorted``
   over their int64 order keys (``bitops.u64_sort_key``), a hit when the
   key found equals the query's. The JAX package sorts table and queries
   together and fills the row pointer forward, because a TPU has no
   scalable gather; both give every query the row of its key or the
   all-miss row, so the candidates are the same.
4. Vote: candidate diagonals (ref_pos - read_pos) are sorted per read and
   the longest run of equal diagonal bins wins, over two half-shifted
   binnings.
5. Extend: the winning strand's read is fitted into a word-aligned window
   of the reference with the banded span fit
   (``ops.align.fit_distance_span_banded``), which runs K8 on the card.

Both strands of a batch go through one join and one vote; coordinates are
on the forward reference (PAF). ``map_reads`` maps in batches of
MAP_BATCH reads; each read's result depends only on itself and the index,
so the batching changes no output.

Long reads (``map_reads_long``) share steps 1-3, then chain each strand's
anchors (``ops.chain.chain_anchors``, C1 ``chain`` on the card) in place of
the vote; with ``extend=True`` the read is fitted into the chain's window
by the unbanded span fit (``ops.align.fit_distance_span``, C3 ``fit_span``
on the card, one launch a chunk: the JAX package passes no band there).
They map in chunks sized by ``_long_chunk``. ``map_pairs`` maps both mates of a pair batch through one
``map_reads`` call and applies the proper-pair rule on the host.

With a mesh (``parallel.mesh.Mesh``) the reads split over the mesh axis and
the index is copied to each device (``map_reads_sharded``,
``map_reads_long_sharded``): each device maps its slab in the same
batches or chunks, the shards are visited in turn, and the results come
to the host once, after the last shard's launch.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import config
from .ops import align as align_ops
from .ops import chain as chain_ops
from .ops import kmer as kmer_ops
from .ops import revcomp as revcomp_ops
from .utils import bitops

_SENT = bitops.ALL_ONES  # 0xFFFFFFFF as int32: a slot with no minimizer
_BIG = 2**30
_DOFF = 1 << 20  # makes diagonals nonnegative before binning
# gap-drift budget of the banded fit: paths that wander more than this many
# net indels from the seeded start diagonal leave the band, and their cost
# is an achievable upper bound
_BAND_GAP = 32
MAP_BATCH = 262_144  # reads per map_reads batch
BIN_BITS = 5  # map_reads' default diagonal bin (32 bp)
PAD = 32  # map_reads' default window padding on each side of the read
# device bytes of one traceback chunk on the card: under the plain backend
# its direction plane (3 GiB: 37,282 reads of 150 bp at the default pad,
# (N + 1) * T = 86,400 bytes each); on C2's route its operands, about
# _TB_KERNEL_BYTES_PER_BASE a read and window base (codes, gather indices,
# ops; C2's own scratch is bounded in ops.align), at most MAP_BATCH reads
_TB_PLANE_BUDGET = 3 << 30
_TB_KERNEL_BYTES_PER_BASE = 16
_TB_CHUNK_CPU = 1024
# device bytes of one map_reads_long chunk, by the estimate of _long_chunk
_LONG_BYTES = 8 << 30


def _band_k8(off_lo: int, off_hi: int, sa: int = 8):
    """(K, effective off_hi): the band widened so that K is a multiple of
    ``sa``. The JAX package widens the mapper's band this way on every
    backend, so the widened band is part of the mapper's output (costs and
    spans); K8 itself takes any band."""
    K, _ = align_ops._band_geometry(off_lo, off_hi, 1 << 30)
    K8 = -(-K // sa) * sa
    return K8, off_lo + 2 * (K8 - 2)


# -- index build ----------------------------------------------------------------


def _seed_keys(words, lengths, k: int, w: int, base_valid=None):
    """(lo, hi, pos, valid) minimizer seeds for any k <= 31; hi is 0 for
    k <= 15."""
    if k > 15:
        return kmer_ops.minimizer_positions64(words, lengths, k, w, base_valid=base_valid)
    vals, pos, valid = kmer_ops.minimizer_positions(words, lengths, k, w, base_valid=base_valid)
    return vals, torch.zeros_like(vals), pos, valid


def _build_table(words, length, k: int, w: int, max_occ: int, base_valid=None):
    """Distinct-key minimizer table of one packed sequence [1, W].

    Returns (lo [N], hi [N], pos [N, max_occ] int32 with -1 padding, nocc
    [N]): distinct keys ascending by unsigned (hi, lo), sentinel rows
    after them. Keys with more than max_occ occurrences are dropped whole."""
    vlo, vhi, pos, valid = _seed_keys(words, length, k, w, base_valid)
    sel = kmer_ops.minimizer_sketch_mask(pos, valid)
    lo = torch.where(sel, vlo, _SENT).reshape(-1)
    hi = torch.where(sel, vhi, _SENT).reshape(-1)
    rpos = torch.where(sel, pos, _BIG).reshape(-1)

    # (hi, lo, pos) ascending; rows equal on all three are identical
    perm = bitops.lex_argsort([bitops.u64_sort_key(hi, lo), rpos])
    hi_s, lo_s, pos_s = hi[perm], lo[perm], rpos[perm]
    first = kmer_ops._run_starts(lo_s, hi_s)
    # run lengths at run starts, 0 elsewhere, by one reverse cummin
    # (kmer._run_start_counts): only run starts are kept, once per index
    run_len = kmer_ops._run_start_counts(first)

    keep = ((lo_s != _SENT) | (hi_s != _SENT)) & (run_len <= max_occ)
    start = first & keep
    # the rank-i occurrence of a run sits i rows after its start
    cols = [
        torch.where(start & (i < run_len), kmer_ops._shift_tail(pos_s, i, _BIG), -1)
        for i in range(max_occ)
    ]
    shi = torch.where(start, hi_s, _SENT)
    slo = torch.where(start, lo_s, _SENT)
    nocc = torch.where(start, run_len, 0)
    # start rows have distinct keys; the rest are identical sentinel rows
    order = torch.sort(bitops.u64_sort_key(shi, slo)).indices
    return slo[order], shi[order], torch.stack(cols, -1)[order], nocc[order]


def _tensor_on(x, device) -> torch.Tensor:
    """An int32 tensor of ``x`` on ``device``: tensors move, host uint32
    words become int32 bit-views, other host integers int32."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return bitops.words_from_u32_np(a).to(device)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


class MinimizerIndex:
    """Reference minimizer index on one device: distinct sorted keys
    (``keys`` low words, ``keys_hi`` high words, int32 views) with up to
    ``max_occ`` forward positions each (``pos`` [Nk, max_occ] int32, -1
    padded; ``nocc`` [Nk]), and the packed reference (``ref_words`` int32
    views) for the extension windows."""

    def __init__(self, keys, pos, nocc, ref_words, ref_len, k, w, max_occ,
                 contig_starts=None, keys_hi=None, device=None):
        if device is None and isinstance(keys, torch.Tensor):
            device = keys.device
        device = config.resolve_device(device)
        self.keys = _tensor_on(keys, device)
        self.keys_hi = (torch.zeros_like(self.keys) if keys_hi is None
                        else _tensor_on(keys_hi, device))
        self.pos = _tensor_on(pos, device).reshape(self.keys.shape[0], int(max_occ))
        self.nocc = _tensor_on(nocc, device)
        self.ref_words = _tensor_on(ref_words, device).reshape(-1)
        self.ref_len = int(ref_len)
        self.k, self.w, self.max_occ = int(k), int(w), int(max_occ)
        # build_multi: the concatenated coordinate of each contig's start
        self.contig_starts = (
            None if contig_starts is None else np.asarray(contig_starts, np.int64)
        )

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def to(self, device) -> "MinimizerIndex":
        """This index on ``device`` (itself when it is there already)."""
        device = torch.device(device)
        if device == self.device:
            return self
        return MinimizerIndex(self.keys, self.pos, self.nocc, self.ref_words, self.ref_len,
                              self.k, self.w, self.max_occ, self.contig_starts,
                              keys_hi=self.keys_hi, device=device)

    @classmethod
    def build(
        cls,
        ref: Union[bytes, np.ndarray, torch.Tensor],
        k: int = 15,
        w: int = 10,
        max_occ: int = 8,
        ref_len: Optional[int] = None,
        base_valid: Optional[np.ndarray] = None,
        contig_starts=None,
        device=None,
    ) -> "MinimizerIndex":
        """Build from an ASCII reference (bytes) or packed words + ref_len,
        on ``device`` (default: the card, see ``config.resolve_device``).

        Bytes mask their non-ACGT bases: k-mers touching one never become
        seeds, and the bases pack by the arithmetic ASCII map, so windows
        see them as mismatching bases. base_valid narrows the mask further
        (the contig separators of build_multi)."""
        if not 1 <= k <= 31:
            raise ValueError(f"minimizer keys must leave sentinel headroom (1 <= k <= 31), got {k}")
        if w < 1 or max_occ < 1:
            raise ValueError(f"w and max_occ must be >= 1, got {w}, {max_occ}")
        device = config.resolve_device(device)
        if isinstance(ref, (bytes, bytearray)):
            from . import io as bnio
            from .sequence import PackedReads

            ref = bytes(ref).upper()
            packed = PackedReads.from_ascii([ref], validate=False, device=device)
            words = packed.words
            n = len(ref)
            bv = bnio._VALID_BASE[np.frombuffer(ref, np.uint8)]
            if base_valid is not None:
                bv = bv & np.asarray(base_valid, bool)
            base_valid = bv
        else:
            words = _tensor_on(ref, device).reshape(1, -1)
            n = int(ref_len)
        if base_valid is not None:
            base_valid = torch.from_numpy(np.asarray(base_valid, bool).copy())[None, :].to(device)
        lengths = torch.tensor([n], dtype=torch.int32, device=device)
        lo, hi, pos, nocc = _build_table(words, lengths, k, w, max_occ, base_valid)
        live = int(((lo != _SENT) | (hi != _SENT)).sum())
        return cls(lo[:live], pos[:live], nocc[:live], words[0], n, k, w, max_occ,
                   contig_starts, keys_hi=hi[:live], device=device)

    @classmethod
    def build_multi(cls, contigs, k: int = 15, w: int = 10, max_occ: int = 8,
                    device=None) -> "MinimizerIndex":
        """Multi-contig build: contigs join with one masked separator base,
        so no seed's k-mer spans a junction; contig c covers
        [contig_starts[c], contig_starts[c] + len(contigs[c])) of the
        concatenation. ``device`` defaults to the card."""
        contigs = [bytes(c).upper() for c in contigs]
        genome = b"A".join(contigs)  # the separator's content is masked below
        starts, bad, off = [], [], 0
        for i, c in enumerate(contigs):
            if i:
                bad.append(off)
                off += 1
            starts.append(off)
            off += len(c)
        bv = np.ones(len(genome), bool)
        bv[np.array(bad, np.int64)] = False
        return cls.build(genome, k, w, max_occ, base_valid=bv,
                         contig_starts=np.array(starts, np.int64), device=device)

    def save(self, path) -> None:
        """The JAX package's .npz layout: keys, keys_hi and ref_words as
        uint32, pos and nocc int32, meta [ref_len, k, w, max_occ] int64 and,
        after build_multi, contig_starts."""
        extra = {}
        if self.contig_starts is not None:
            extra["contig_starts"] = self.contig_starts
        np.savez_compressed(
            path,
            keys=bitops.words_to_u32_np(self.keys),
            keys_hi=bitops.words_to_u32_np(self.keys_hi),
            pos=self.pos.cpu().numpy(),
            nocc=self.nocc.cpu().numpy(),
            ref_words=bitops.words_to_u32_np(self.ref_words),
            meta=np.array([self.ref_len, self.k, self.w, self.max_occ], np.int64),
            **extra,
        )

    @classmethod
    def load(cls, path, device=None) -> "MinimizerIndex":
        """Read an index saved by either package, on ``device`` (default:
        the card)."""
        with np.load(path) as z:
            ref_len, k, w, max_occ = (int(v) for v in z["meta"])
            return cls(
                z["keys"].astype(np.uint32), z["pos"].astype(np.int32),
                z["nocc"].astype(np.int32), z["ref_words"].astype(np.uint32),
                ref_len, k, w, max_occ,
                z["contig_starts"] if "contig_starts" in z.files else None,
                keys_hi=z["keys_hi"].astype(np.uint32) if "keys_hi" in z.files else None,
                device=device,
            )

    def __len__(self) -> int:
        return int(self.keys.shape[0])


# -- query ----------------------------------------------------------------------


def _seed_cap(L: int, w: int) -> int:
    """Compacted seed slots per read: about twice the expected minimizer
    count 2L/(w+1), 32-aligned, never above L."""
    want = 4 * L // (w + 1) + 8
    return max(32, min(L, -(-want // 32) * 32))


def _seed_anchors(words, lengths, t_lo, t_hi, t_pos, k: int, w: int):
    """Seed anchors of every read: (cand [B, S, max_occ] int32 reference
    positions, -1 where there is none; qpos [B, S] int32; hit [B, S,
    max_occ] bool), S = _seed_cap(L, w).

    The selected minimizer slots move to the front of each row first, in
    position order (the unselected slots are identical sentinels, so the
    row sort's tie order does not matter)."""
    vlo, vhi, pos, valid = _seed_keys(words, lengths, k, w)
    sel = kmer_ops.minimizer_sketch_mask(pos, valid)
    qlo = torch.where(sel, vlo, _SENT)
    qhi = torch.where(sel, vhi, _SENT)
    qp = torch.where(sel, pos, 0)
    L = qlo.shape[-1]
    S = _seed_cap(L, w)
    if S < L:
        slot = torch.arange(L, dtype=torch.int32, device=qlo.device)
        order = torch.sort(torch.where(sel, slot, L), dim=-1).indices[:, :S]
        qlo, qhi, qp = (torch.gather(x, 1, order) for x in (qlo, qhi, qp))
        sel = qlo != _SENT  # as the JAX package decides it after compaction
    # the join: the table keys are distinct and ascending by unsigned
    # (hi, lo), so a query's row is where its int64 order key would sort
    Nk = t_lo.shape[0]
    t_key = bitops.u64_sort_key(t_hi, t_lo)
    q_key = bitops.u64_sort_key(qhi, qlo).reshape(-1)
    if Nk:
        row = torch.searchsorted(t_key, q_key)
        found = t_key[torch.clamp(row, max=Nk - 1)] == q_key
        tq = torch.where(found, row, Nk).reshape(qlo.shape)
    else:  # an empty table: every query takes the all-miss row 0
        tq = torch.zeros(qlo.shape, dtype=torch.int64, device=qlo.device)
    pos_pad = torch.cat([t_pos, t_pos.new_full((1, t_pos.shape[1]), -1)])
    cand = pos_pad[tq]  # [B, S, max_occ]
    hit = (cand >= 0) & sel[..., None]
    return cand, qp, hit


def _seed_candidates(words, lengths, t_lo, t_hi, t_pos, k: int, w: int):
    """Candidate diagonals of every read: [B, S * max_occ] int32,
    ref_pos - read_pos + _DOFF, or _BIG where there is no candidate."""
    cand, qp, hit = _seed_anchors(words, lengths, t_lo, t_hi, t_pos, k, w)
    diag = torch.where(hit, cand - qp[..., None] + _DOFF, _BIG)
    return diag.reshape(words.shape[0], -1)


def _vote(diag: torch.Tensor, bin_bits: int):
    """Longest same-bin run per read over two half-shifted binnings.
    diag [B, M] (_BIG = no candidate). Returns (support [B], best_diag
    [B]: the smallest raw diagonal in the winning bin, _BIG for a read
    with no candidate)."""
    d = torch.sort(diag, dim=-1).values
    B, M = d.shape
    idx = torch.arange(M, dtype=torch.int32, device=d.device)
    half = (1 << (bin_bits - 1)) if bin_bits > 0 else 0
    best_sup = torch.zeros(B, dtype=torch.int32, device=d.device)
    best_lo = torch.full((B,), _BIG, dtype=torch.int32, device=d.device)
    live = d != _BIG
    for off in (0, half):
        q = (d + off) >> bin_bits  # monotone in d: one sort serves both
        first = torch.ones_like(live)
        first[:, 1:] = q[:, 1:] != q[:, :-1]
        # one past each row's last entry equal to q: the end of its run
        # (a row-wise searchsorted; the JAX package takes a reverse cummin)
        run_end = torch.searchsorted(q, q, right=True, out_int32=True)
        run_len = torch.where(first & live, run_end - idx, 0)
        sup = run_len.amax(-1)
        # the winning bin: the smallest bin that attains sup
        win_bin = torch.where(run_len == sup[:, None], q, _BIG).amin(-1)
        lo = torch.where((q == win_bin[:, None]) & live, d, _BIG).amin(-1)
        better = sup > best_sup
        best_lo = torch.where(better, lo, best_lo)
        best_sup = torch.maximum(best_sup, sup)
    return best_sup, best_lo


def _windows(ws, ref_words, ref_len: int, Wwin: int):
    """(win [B, Wwin] words, wlen [B]): the reference windows that start at
    words ws, as the JAX package's clamped dynamic_slice of the zero-padded
    reference cuts them (the start clamped to [0, Wr]; wlen from the
    unclamped ws)."""
    Wr = ref_words.shape[0]
    ref_pad = torch.cat([ref_words, ref_words.new_zeros(Wwin)])
    first = torch.clamp(ws, 0, Wr)  # a window never starts past the padding
    cols = torch.arange(Wwin, dtype=torch.int64, device=ws.device)
    win = ref_pad[first.to(torch.int64)[:, None] + cols[None, :]]
    wlen = torch.clamp(ref_len - ws * 16, 0, Wwin * 16).to(torch.int32)
    return win, wlen


def _fit_inputs(ws, ref_words, ref_len: int, Wwin: int, start_slack: int, band_gap: int):
    """(win [B, Wwin] words, wlen [B], off_lo, off_hi): the reference
    windows that start at words ws, and the band of the fit.

    The window puts each read's start diagonal within [0, start_slack] of
    its origin, so the live band is j - i in [-band_gap, start_slack +
    band_gap], widened by _band_k8 as the JAX package widens it."""
    win, wlen = _windows(ws, ref_words, ref_len, Wwin)
    off_lo = -int(band_gap)
    _, off_hi = _band_k8(off_lo, int(start_slack) + int(band_gap))
    return win, wlen, off_lo, off_hi


def _fit_extend(q_words, lengths, ws, win, wlen, off_lo: int, off_hi: int, mismatch, gap):
    """Base-exact (cost, ref_start, ref_end) of each read fitted into its
    word-aligned reference window (first word ws): one span-carrying banded
    fit, so start and end come from one optimal path."""
    cost, startj, endj = align_ops.fit_distance_span_banded(
        q_words, lengths, win, wlen, mismatch, gap, off_lo=off_lo, off_hi=off_hi,
    )
    return cost, ws * 16 + startj, ws * 16 + endj


def _seed_vote(words, lengths, index: MinimizerIndex, bin_bits: int, pad: int):
    """Seeding, join and vote of one batch: (support [B], use_rc [B], the
    reads in their winning orientation [B, W], the window's first word ws
    [B], the window width Wwin)."""
    B, W = words.shape
    lengths = lengths.to(torch.int32)
    rc_words = revcomp_ops.reverse_complement_reads(words, lengths)
    # both strands through one join and one vote
    diag2 = _seed_candidates(
        torch.cat([words, rc_words]), torch.cat([lengths, lengths]),
        index.keys, index.keys_hi, index.pos, index.k, index.w,
    )
    sup2, lo2 = _vote(diag2, bin_bits)
    del diag2
    sup_f, sup_r = sup2[:B], sup2[B:]
    lo_f, lo_r = lo2[:B], lo2[B:]
    use_rc = sup_r > sup_f
    support = torch.maximum(sup_f, sup_r)
    d0 = torch.where(use_rc, lo_r, lo_f) - _DOFF  # estimated forward start
    q_words = torch.where(use_rc[:, None], rc_words, words)
    # a word-aligned window around the diagonal; the fit's free ends absorb
    # the word-alignment slack
    Lb = W * bitops.BASES_PER_WORD
    Wwin = (Lb + 2 * pad) // bitops.BASES_PER_WORD + 1
    ws = torch.div(torch.clamp(d0 - pad, 0, max(index.ref_len - 1, 0)), 16,
                   rounding_mode="floor")
    return support, use_rc, q_words, ws, Wwin


def _fit_operands(words, lengths, index: MinimizerIndex, bin_bits: int, pad: int):
    """Seeding, join and vote of one batch, and the operands of its banded
    fit: (support, use_rc, q_words, ws, win, wlen, off_lo, off_hi)."""
    support, use_rc, q_words, ws, Wwin = _seed_vote(words, lengths, index, bin_bits, pad)
    win, wlen, off_lo, off_hi = _fit_inputs(
        ws, index.ref_words, index.ref_len, Wwin,
        start_slack=pad + 16 + (1 << bin_bits), band_gap=_BAND_GAP,
    )
    return support, use_rc, q_words, ws, win, wlen, off_lo, off_hi


def _map_core(words, lengths, index: MinimizerIndex, bin_bits: int, pad: int,
              mismatch: int, gap: int):
    """(support, use_rc, ref_start, ref_end, cost) of one batch, [B] each."""
    support, use_rc, q_words, ws, win, wlen, off_lo, off_hi = _fit_operands(
        words, lengths, index, bin_bits, pad)
    cost, ref_start, ref_end = _fit_extend(q_words, lengths.to(torch.int32), ws, win, wlen,
                                           off_lo, off_hi, mismatch, gap)
    return support, use_rc, ref_start, ref_end, cost


def map_reads(
    index: MinimizerIndex,
    reads,
    min_seeds: int = 2,
    bin_bits: int = BIN_BITS,
    pad: int = PAD,
    mismatch: int = 1,
    gap: int = 1,
    mesh=None,
    axis: str = "data",
) -> dict:
    """Map a PackedReads batch against a MinimizerIndex, MAP_BATCH reads at
    a time, on the index's device.

    Returns numpy arrays, one entry per read, as the JAX package does:
      mapped    bool  — at least min_seeds diagonal votes agreed
      strand    bytes b'+'/b'-' — reverse-complement reads map to '-'
      ref_start int32 — forward-reference start of the fit
      ref_end   int32 — one past its end
      cost      int32 — fitting-alignment cost of the whole read
      support   int32 — seed votes on the winning diagonal bin
    Unmapped rows carry the attempt's numbers and should be ignored.
    mesh: a ``parallel.mesh.Mesh`` — the batch is zero-padded to a device
    multiple, mapped by ``map_reads_sharded`` and sliced back, so any batch
    size works and the output equals the single-device run's."""
    if mesh is not None:
        from .parallel.mesh import pad_batch

        B = int(reads.words.shape[0])
        res = map_reads_sharded(index, pad_batch(reads, int(mesh.shape[axis])), mesh, axis,
                                min_seeds=min_seeds, bin_bits=bin_bits, pad=pad,
                                mismatch=mismatch, gap=gap)
        return {f: v[:B] for f, v in res.items()}
    out = _map_slab(reads.words, reads.lengths, index, bin_bits, pad, mismatch, gap)
    return _map_result(*(x.cpu().numpy() for x in out), min_seeds)


def _concat(parts, n_out: int):
    """Column-wise concatenation of per-batch device results; [0]-sized
    int32 columns (bool for use_rc) when there are none."""
    if parts:
        return [torch.cat(c) for c in zip(*parts)]
    return [torch.zeros(0, dtype=torch.bool if i == 1 else torch.int32) for i in range(n_out)]


def _map_slab(words, lengths, index: MinimizerIndex, bin_bits: int, pad: int, mismatch: int,
              gap: int):
    """(support, use_rc, ref_start, ref_end, cost) of a slab of reads on
    the index's device, MAP_BATCH reads a batch; nothing is read back."""
    dev = index.device
    B = int(words.shape[0])
    parts = [_map_core(words[s : s + MAP_BATCH].to(dev), lengths[s : s + MAP_BATCH].to(dev),
                       index, bin_bits, pad, mismatch, gap) for s in range(0, B, MAP_BATCH)]
    return _concat(parts, 5)


def _map_result(support, use_rc, ref_start, ref_end, cost, min_seeds: int) -> dict:
    return {
        "mapped": support >= min_seeds,
        "strand": np.where(use_rc, b"-", b"+"),
        "ref_start": ref_start,
        "ref_end": ref_end,
        "cost": cost,
        "support": support,
    }


def _index_copies(index: MinimizerIndex, mesh) -> list:
    """The index on each device of the mesh (one copy a distinct device)."""
    copies = {}
    for d in mesh.flat_devices:
        if d not in copies:
            copies[d] = index.to(d)
    return [copies[d] for d in mesh.flat_devices]


def _sharded_columns(index: MinimizerIndex, reads, mesh, axis: str, slab_fn) -> list:
    """slab_fn(words, lengths, index copy) on each device's slab of the
    reads, in mesh order with no host read between shards; then each
    column of the results on the host, in batch order."""
    from .parallel import mesh as pmesh

    n = mesh.shape[axis]
    B = int(reads.words.shape[0])
    assert B % n == 0, f"mesh axis size {n} must divide batch {B}"
    sharded = pmesh.shard_reads(reads, mesh, axis)
    outs = []
    for d, w, ln, idx in zip(mesh.flat_devices, sharded.word_shards, sharded.length_shards,
                             _index_copies(index, mesh)):
        with pmesh.on_device(d):
            outs.append(slab_fn(w, ln, idx))
    slabs = [outs[g] for g in mesh.groups(axis)[0]]
    return [np.concatenate([col.cpu().numpy() for col in c]) for c in zip(*slabs)]


def map_reads_sharded(
    index: MinimizerIndex,
    reads,
    mesh,
    axis: str = "data",
    min_seeds: int = 2,
    bin_bits: int = BIN_BITS,
    pad: int = PAD,
    mismatch: int = 1,
    gap: int = 1,
) -> dict:
    """Data-parallel map_reads: the reads split over ``axis``, the index
    copied to each device. The batch (a PackedReads, or a
    ``parallel.mesh.ShardedReads`` of this mesh and axis) must divide the
    axis; results equal map_reads'."""
    cols = _sharded_columns(index, reads, mesh, axis, lambda w, ln, idx: _map_slab(
        w, ln, idx, bin_bits, pad, mismatch, gap))
    return _map_result(*cols, min_seeds)


# -- per-base traceback (CIGAR) of mapped reads ---------------------------------


def _traceback_core(words, lengths, ref_codes, ref_start, ref_end, use_rc,
                    win_width: int, mismatch, gap, band: int = 0):
    """Global alignment ops of each read, in its mapped orientation,
    against its exact reference window [ref_start, ref_end). Returns
    (cost [B], ops [B, T] uint8 in forward order)."""
    lengths = lengths.to(torch.int32)
    rc_words = revcomp_ops.reverse_complement_reads(words, lengths)
    w = torch.where(use_rc[:, None], rc_words, words)
    codes_a = bitops.unpack_words(w)
    Rn = ref_codes.shape[0]
    wlen = torch.clamp(ref_end - ref_start, 0, win_width)
    gidx = torch.clamp(
        ref_start.to(torch.int64)[:, None]
        + torch.arange(win_width, dtype=torch.int64, device=words.device)[None, :],
        0, Rn - 1,
    )
    codes_b = ref_codes[gidx]
    if band:
        cost, _, ops = align_ops.align_ops_codes_banded(
            codes_a, lengths, codes_b, wlen, mismatch, gap,
            ends_free_b=False, off_lo=-int(band), off_hi=int(band),
        )
    else:
        cost, _, ops = align_ops.align_ops_codes(
            codes_a, lengths, codes_b, wlen, mismatch, gap, ends_free_b=False
        )
    return cost, ops


def _traceback_chunk(device, W: int, pad: int = PAD, band: int = 0) -> int:
    """Reads per traceback chunk: 1024 on the CPU, as in the JAX package;
    on the card, through C2, as many as keep the operands within 3 GiB, at
    most MAP_BATCH; under backend('torch') as many as keep the plain
    version's direction plane ((M+N)(N+1) bytes a read, (M+N)(band+2) with a
    band) within 3 GiB."""
    if torch.device(device).type != "cuda":
        return _TB_CHUNK_CPU
    L = 16 * W
    N = L + 2 * pad
    if config.get_backend() != "torch":
        return max(1, min(MAP_BATCH, _TB_PLANE_BUDGET // (_TB_KERNEL_BYTES_PER_BASE * (L + N))))
    lanes = (N + 1) if not band else min(N + 1, (2 * band + 1) // 2 + 2)
    return max(1, _TB_PLANE_BUDGET // ((L + N) * lanes))


def traceback_cigars(
    index: MinimizerIndex,
    reads,
    map_result: dict,
    mismatch: int = 1,
    gap: int = 1,
    pad: int = PAD,
    chunk: Optional[int] = None,
    eqx: bool = True,
    band: int = 0,
) -> dict:
    """Per-read CIGAR strings for a map_reads result.

    Re-derives each read's global alignment against its exact window
    [ref_start, ref_end) under the mapper's cost model; tb_cost equals the
    map cost wherever the map fit's band held an optimal path. band > 0
    runs the banded traceback (net indel drift within +-band). Runs in
    ``chunk``-read slabs (default ``_traceback_chunk``); the chunk changes no
    output. The strings come from one vectorised run-length pass
    (``ops.align.cigars``).

    Returns {"cigar": [B] list (None for unmapped rows), "tb_cost" [B]
    int32, "ops" [B, T] uint8 forward-order op codes (ops.align.OP_*)}."""
    dev = index.device
    B = int(reads.words.shape[0])
    W = int(reads.words.shape[1])
    L = W * 16
    win_width = L + 2 * int(pad)
    T = L + win_width
    if chunk is None:
        chunk = _traceback_chunk(dev, W, pad, band)
    costs = np.zeros(B, np.int32)
    ops_all = np.zeros((B, T), np.uint8)
    mapped = np.asarray(map_result["mapped"], bool)
    use_rc = torch.from_numpy(np.asarray(map_result["strand"] == b"-")).to(dev)
    # unmapped rows: an empty window at 0
    rs = torch.from_numpy(np.where(mapped, map_result["ref_start"], 0).astype(np.int32)).to(dev)
    re_ = torch.from_numpy(np.where(mapped, map_result["ref_end"], 0).astype(np.int32)).to(dev)
    ref_codes = bitops.unpack_words(index.ref_words[None, :]).reshape(-1)
    for s in range(0, B, int(chunk)):
        e = min(B, s + int(chunk))
        cost, ops = _traceback_core(
            reads.words[s:e].to(dev), reads.lengths[s:e].to(dev), ref_codes,
            rs[s:e], re_[s:e], use_rc[s:e], win_width, int(mismatch), int(gap),
            band=int(band),
        )
        costs[s:e] = cost.cpu().numpy()
        ops_np = ops.cpu().numpy()
        ops_all[s:e, : ops_np.shape[1]] = ops_np
    strings = align_ops.cigars(ops_all, eqx)
    cig = [c if m else None for c, m in zip(strings, mapped.tolist())]
    return {"cigar": cig, "tb_cost": costs, "ops": ops_all}


# -- long reads: chaining instead of the vote -----------------------------------


def _reverse_reads(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse without complement: complement, then reverse-complement
    (both bit-local)."""
    W = words.shape[-1]
    comp = words ^ bitops.word_valid_mask(W, lengths.to(torch.int32))
    return revcomp_ops.reverse_complement_reads(comp, lengths)


def _long_chunk(W: int, index: MinimizerIndex, extend: bool, pad: int) -> int:
    """Reads per map_reads_long chunk: as many as keep an estimate of the
    chunk's largest tensors within _LONG_BYTES. A read holds two strands of
    minimizer rows (about 64 bytes a base each), of anchors with their sort
    keys and order (about 48 bytes an anchor each) and, with extend, the
    wavefront's diagonals over the read and its window."""
    L = W * bitops.BASES_PER_WORD
    anchors = _seed_cap(L, index.w) * index.max_occ if L else 0
    per_read = 2 * (64 * L + 48 * anchors)
    if extend:
        per_read += 80 * (L + L + L // 4 + 2 * pad)
    return max(1, _LONG_BYTES // max(per_read, 1))


def _map_long_core(words, lengths, index: MinimizerIndex, max_gap, gap_unit, lookback: int,
                   extend: bool = False, pad: int = PAD, mismatch: int = 1, gap: int = 1):
    """(score, use_rc, ref_start, ref_end, q_start, q_end, cost) of one
    chunk, [B] each (cost 0 without extend)."""
    B, W = words.shape
    k = index.k
    lengths = lengths.to(torch.int32)
    rc_words = revcomp_ops.reverse_complement_reads(words, lengths)
    # both strands through one join and one chaining pass
    cand, qp, hit = _seed_anchors(
        torch.cat([words, rc_words]), torch.cat([lengths, lengths]),
        index.keys, index.keys_hi, index.pos, k, index.w,
    )
    M = cand.shape[1] * cand.shape[2]
    rpos = torch.where(hit, cand, -1).reshape(2 * B, M)
    qpos = qp[:, :, None].expand(cand.shape).reshape(2 * B, M)
    del cand, hit
    score, sr, er, sq, eq = chain_ops.chain_anchors(rpos, qpos, rpos >= 0, max_gap, gap_unit,
                                                    lookback)
    del rpos, qpos
    use_rc = score[B:] > score[:B]  # the forward strand wins ties

    def pick(x):
        return torch.where(use_rc, x[B:], x[:B])

    score, sr, er, sq, eq = map(pick, (score, sr, er, sq, eq))
    # a reverse-strand k-mer start p spans forward [L - p - k, L - p)
    q_start = torch.where(use_rc, lengths - eq - k, sq)
    q_end = torch.where(use_rc, lengths - sq - k, eq)
    if not extend:
        return score, use_rc, sr, er, q_start, q_end, torch.zeros_like(score)
    # the whole read fitted into the chain's window, capped at 1.25 times the
    # read plus the padding
    Lb = W * bitops.BASES_PER_WORD
    Wwin = (Lb + Lb // 4 + 2 * pad) // bitops.BASES_PER_WORD + 1
    q_words = torch.where(use_rc[:, None], rc_words, words)
    ws = torch.div(torch.clamp(sr - pad, min=0), 16, rounding_mode="floor")
    win, wlen = _windows(ws, index.ref_words, index.ref_len, Wwin)
    cost, startj, endj = align_ops.fit_distance_span(q_words, lengths, win, wlen, mismatch, gap)
    return score, use_rc, ws * 16 + startj, ws * 16 + endj, q_start, q_end, cost


def map_reads_long(
    index: MinimizerIndex,
    reads,
    min_chain: int = 3,
    max_gap: int = 2048,
    gap_unit: int = 16,
    lookback: int = 64,
    extend: bool = False,
    pad: int = 32,
    mismatch: int = 1,
    gap: int = 1,
    mesh=None,
    axis: str = "data",
) -> dict:
    """Chain-based mapping of long or indel-rich reads, on the index's
    device, in chunks of ``_long_chunk`` reads (the chunk changes no output).

    Anchors come from the same minimizer join as map_reads; placement comes
    from collinear chaining (``ops.chain``) instead of the diagonal vote, so
    a diagonal drift of up to max_gap a link is tolerated. Returns numpy
    arrays, one entry per read, as the JAX package does: mapped (chain score
    >= min_chain), strand, ref_start / ref_end and q_start / q_end (the
    inclusive first and last chained anchors, forward-read k-mer starts) and
    chain_score. extend=True fits the whole read into the chain's reference
    window (at most 1.25 times the read plus 2 pad) with the unbanded span
    fit, replaces ref_start / ref_end with its base-exact span and adds
    "cost". mesh: the batch is zero-padded to a device multiple, mapped by
    ``map_reads_long_sharded`` and sliced back; results equal the
    single-device run's."""
    if mesh is not None:
        from .parallel.mesh import pad_batch

        B = int(reads.words.shape[0])
        res = map_reads_long_sharded(
            index, pad_batch(reads, int(mesh.shape[axis])), mesh, axis, min_chain=min_chain,
            max_gap=max_gap, gap_unit=gap_unit, lookback=lookback, extend=extend, pad=pad,
            mismatch=mismatch, gap=gap)
        return {f: v[:B] for f, v in res.items()}
    out = _map_long_slab(reads.words, reads.lengths, index, max_gap, gap_unit, lookback,
                         extend, pad, mismatch, gap)
    return _long_result(*(x.cpu().numpy() for x in out), min_chain, extend)


def _map_long_slab(words, lengths, index: MinimizerIndex, max_gap, gap_unit, lookback: int,
                   extend: bool, pad: int, mismatch: int, gap: int):
    """(score, use_rc, ref_start, ref_end, q_start, q_end, cost) of a slab
    of reads on the index's device, in ``_long_chunk`` chunks; nothing is
    read back."""
    dev = index.device
    B, W = (int(x) for x in words.shape)
    chunk = _long_chunk(W, index, extend, pad)
    parts = [_map_long_core(words[s : s + chunk].to(dev), lengths[s : s + chunk].to(dev),
                            index, max_gap, gap_unit, lookback, extend, pad, mismatch, gap)
             for s in range(0, B, chunk)]
    return _concat(parts, 7)


def _long_result(score, use_rc, sr, er, q_start, q_end, cost, min_chain: int,
                 extend: bool) -> dict:
    out = {
        "mapped": score >= min_chain,
        "strand": np.where(use_rc, b"-", b"+"),
        "ref_start": sr,
        "ref_end": er,
        "q_start": q_start,
        "q_end": q_end,
        "chain_score": score,
    }
    if extend:
        out["cost"] = cost
    return out


def map_reads_long_sharded(
    index: MinimizerIndex,
    reads,
    mesh,
    axis: str = "data",
    min_chain: int = 3,
    max_gap: int = 2048,
    gap_unit: int = 16,
    lookback: int = 64,
    extend: bool = False,
    pad: int = 32,
    mismatch: int = 1,
    gap: int = 1,
) -> dict:
    """Data-parallel map_reads_long: the reads split over ``axis``, the
    index copied to each device, each device mapping its slab in
    ``_long_chunk`` chunks. The batch must divide the axis; results equal
    map_reads_long's."""
    cols = _sharded_columns(index, reads, mesh, axis, lambda w, ln, idx: _map_long_slab(
        w, ln, idx, max_gap, gap_unit, lookback, extend, pad, mismatch, gap))
    return _long_result(*cols, min_chain, extend)


# -- read pairs -----------------------------------------------------------------


def map_pairs(
    index: MinimizerIndex,
    reads1,
    reads2,
    min_insert: int = 0,
    max_insert: int = 1000,
    min_seeds: int = 2,
    mesh=None,
    axis: str = "data",
    **kw,
) -> dict:
    """Map R1/R2 mates and mark proper pairs: both mates map, on opposite
    strands, the '+' mate leftmost (FR), and the outer span (insert) within
    [min_insert, max_insert].

    Both mates map through one map_reads call on the stacked batch, widened
    to one word count with zero words (with a mesh, through
    ``map_reads_sharded``, padded to a device multiple). Returns {"r1",
    "r2" (map_reads dicts), "proper" [B] bool, "insert" [B] int32, -1
    where a pair is not proper}."""
    from .sequence import PackedReads

    B = int(reads1.words.shape[0])
    if int(reads2.words.shape[0]) != B:
        raise ValueError(
            f"mate batches differ: {B} R1 reads vs {int(reads2.words.shape[0])} R2 reads"
        )
    W = max(int(reads1.words.shape[1]), int(reads2.words.shape[1]))
    dev = index.device

    def widen(r):
        w = r.words.to(dev)
        return torch.nn.functional.pad(w, (0, W - w.shape[1])) if w.shape[1] < W else w

    stacked = PackedReads(
        words=torch.cat([widen(reads1), widen(reads2)]),
        lengths=torch.cat([reads1.lengths.to(dev), reads2.lengths.to(dev)]),
    )
    both_res = map_reads(index, stacked, min_seeds=min_seeds, mesh=mesh, axis=axis, **kw)
    r1 = {f: v[:B] for f, v in both_res.items()}
    r2 = {f: v[B:] for f, v in both_res.items()}
    both = r1["mapped"] & r2["mapped"]
    opposite = r1["strand"] != r2["strand"]
    fwd_is_1 = r1["strand"] == b"+"  # the forward mate must be leftmost
    left_start = np.where(fwd_is_1, r1["ref_start"], r2["ref_start"])
    right_end = np.where(fwd_is_1, r2["ref_end"], r1["ref_end"])
    insert = right_end - left_start
    fr = left_start <= np.where(fwd_is_1, r2["ref_start"], r1["ref_start"])
    proper = both & opposite & fr & (insert >= min_insert) & (insert <= max_insert)
    return {
        "r1": r1,
        "r2": r2,
        "proper": proper,
        "insert": np.where(proper, insert, -1).astype(np.int32),
    }
