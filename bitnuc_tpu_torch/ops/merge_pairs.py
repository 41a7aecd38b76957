"""Paired-end overlap merging (PEAR/FLASH-class) on packed reads.

The counterpart of ``bitnuc_tpu/ops/merge_pairs.py``. A fragment shorter
than the two reads together leaves R1's tail overlapping rc(R2)'s head;
merging recovers the whole fragment. The JAX package has no Pallas kernel
here, and this module is plain PyTorch on the device of its inputs.

Offset convention: o = fragment length - len2 is rc(R2)'s start in the
fragment, searched over [0, L1 - min_overlap] in ascending order; among
qualifying offsets the fewest mismatches win, ties to the longest overlap
(the lowest o). Both scans give the same result bit for bit:

* ``packed`` (default): rc(R2) and its mask are shifted up by r = 0..15
  bases once; the 16 offsets o = 16 q + r of a word shift q are one slice of
  that stack, compared by XOR, a 2-bit collapse and a popcount, with
  overlaps from the length vectors.
* ``codes``: one offset a step on 2-bit code planes, counting the overlap
  and its mismatches base by base; the cross-check of the packed scan.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import bitops
from . import revcomp

_BIG = 2**30  # the mismatch count of an offset that does not qualify
_R = bitops.BASES_PER_WORD  # offsets a step of the packed scan


def _up(x: torch.Tensor, r: int) -> torch.Tensor:
    """Shift packed rows up by r bases (word w takes word w - 1's top
    bases); r = 0 is the identity, so no shift reaches 32."""
    if r == 0:
        return x
    carry = bitops.srl(F.pad(x, (1, 0))[:, :-1], 32 - 2 * r)
    return (x << (2 * r)) | carry


def _qualify(mm, ov, min_overlap: int, mmf) -> torch.Tensor:
    """mm where the overlap is long enough and mm <= floor(mmf * ov) in
    float32, else _BIG."""
    allowed = torch.floor(mmf * ov.to(torch.float32)).to(torch.int32)
    return torch.where((ov >= min_overlap) & (mm <= allowed), mm, _BIG)


def _packed_offset_scan(words1, lens1, rc2w, lens2, min_overlap: int, mmf):
    """(best_mm, best_o, best_ov) [B] of the offset search on packed words,
    the 16 offsets of one word shift at a time."""
    B, W1 = words1.shape
    W2 = rc2w.shape[-1]
    n_off = max(16 * W1 - min_overlap + 1, 0)
    n_q = -(-n_off // _R)
    qmax = max(n_q - 1, 0)
    dev = words1.device

    m1 = bitops.word_valid_mask(W1, lens1)
    c1 = (words1 & m1)[None]
    m2 = bitops.word_valid_mask(W2, lens2)
    # rc(R2) shifted up by o = 16 q + r bases is words [qmax - q, qmax - q +
    # W1) of copy r. The right pad makes that slice whole at q = 0 for any
    # W1 and W2: a slice cut short would compare at the wrong shift.
    back = max(0, W1 - (W2 + 1))
    stk = F.pad(torch.stack([_up(F.pad(rc2w & m2, (0, 1)), r) for r in range(_R)]),
                (qmax, back))
    mstk = F.pad(torch.stack([_up(F.pad(m2, (0, 1)), r) for r in range(_R)]), (qmax, back))

    best_mm = torch.full((B,), _BIG, dtype=torch.int32, device=dev)
    best_o = torch.zeros(B, dtype=torch.int32, device=dev)
    r = torch.arange(_R, dtype=torch.int32, device=dev)[:, None]
    for q in range(n_q):
        lo = qmax - q
        rs, ms = stk[:, :, lo : lo + W1], mstk[:, :, lo : lo + W1]
        assert rs.shape[-1] == W1, "the shift window was cut short"
        diff = bitops.basewise_diff(c1, rs) & m1[None] & ms
        mm = bitops.popcount32(diff).sum(-1, dtype=torch.int32)  # [16, B]
        o = 16 * q + r
        ov = torch.clamp(torch.minimum(lens1[None] - o, lens2[None]), min=0)
        mm_q = torch.where(o < n_off, _qualify(mm, ov, min_overlap, mmf), _BIG)
        # the fewest mismatches, then the lowest o: one min of unique keys
        key = torch.min(mm_q.to(torch.int64) * _R + r, 0).values
        g_mm = (key // _R).to(torch.int32)
        better = g_mm < best_mm  # strict: an earlier group keeps a tie
        best_mm = torch.where(better, g_mm, best_mm)
        best_o = torch.where(better, (16 * q + key % _R).to(torch.int32), best_o)
    best_ov = torch.clamp(torch.minimum(lens1 - best_o, lens2), min=0)
    best_ov = torch.where(best_mm < _BIG, best_ov, 0)
    return best_mm, best_o, best_ov


def _codes_offset_scan(c1, lens1, c2, lens2, min_overlap: int, mmf):
    """(best_mm, best_o, best_ov) [B] of the offset search on code planes,
    one offset a step."""
    B, L1 = c1.shape
    L2 = c2.shape[-1]
    dev = c1.device
    in1 = torch.arange(L1, device=dev) < lens1[:, None]
    in2 = torch.arange(L2, device=dev) < lens2[:, None]
    # both sides padded by L1, so the shift by o is the slice at L1 - o
    c2p = F.pad(c2, (L1, L1), value=-1)
    in2p = F.pad(in2.to(torch.int8), (L1, L1)).bool()
    best_mm = torch.full((B,), _BIG, dtype=torch.int32, device=dev)
    best_o = torch.zeros(B, dtype=torch.int32, device=dev)
    best_ov = torch.zeros(B, dtype=torch.int32, device=dev)
    for o in range(max(L1 - min_overlap + 1, 0)):
        both = in1 & in2p[:, L1 - o : 2 * L1 - o]
        ov = both.sum(-1, dtype=torch.int32)
        mm = (both & (c1 != c2p[:, L1 - o : 2 * L1 - o])).sum(-1, dtype=torch.int32)
        mm_q = _qualify(mm, ov, min_overlap, mmf)
        better = mm_q < best_mm  # o ascends: strict < keeps the longest overlap
        best_mm = torch.where(better, mm_q, best_mm)
        best_o = torch.where(better, o, best_o)
        best_ov = torch.where(better, ov, best_ov)
    return best_mm, best_o, best_ov


def merge_pairs(
    words1: torch.Tensor,
    lens1: torch.Tensor,
    words2: torch.Tensor,
    lens2: torch.Tensor,
    min_overlap: int = 10,
    max_mismatch_frac=0.1,
    scan: str = "packed",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge R1/R2 pairs whose fragment is shorter than lens1 + lens2.

    words1, words2: packed reads [B, W1], [B, W2], R2 as sequenced (this op
    reverse-complements it). Returns (merged_words [B, Wm], merged_lens
    [B], merged [B] bool, best_overlap [B], mismatches [B]). Unmerged rows
    carry R1 and mismatches -1.

    A pair merges when some overlap >= min_overlap has mismatches <=
    floor(max_mismatch_frac * overlap), in float32; the fewest mismatches
    win, ties to the longest overlap. Overlap bases take R1's call; when
    rc(R2) lies inside R1 the fragment is all of R1. scan: 'packed' or
    'codes' (module docstring)."""
    if scan not in ("packed", "codes"):
        raise ValueError(f"scan must be 'packed' or 'codes', got {scan!r}")
    min_overlap = int(min_overlap)
    dev = words1.device
    lens1 = lens1.to(torch.int32)
    lens2 = lens2.to(torch.int32)
    rc2w = revcomp.reverse_complement_reads(words2, lens2)
    B, W1 = words1.shape
    W2 = rc2w.shape[-1]
    L1, L2 = 16 * W1, 16 * W2
    mmf = torch.as_tensor(max_mismatch_frac, dtype=torch.float32, device=dev)
    if scan == "packed":
        best_mm, best_o, best_ov = _packed_offset_scan(words1, lens1, rc2w, lens2,
                                                       min_overlap, mmf)
    else:
        c1 = bitops.unpack_words(words1).to(torch.int8)
        c2 = bitops.unpack_words(rc2w).to(torch.int8)
        best_mm, best_o, best_ov = _codes_offset_scan(c1, lens1, c2, lens2, min_overlap, mmf)

    merged = best_mm < _BIG
    # containment (best_o + lens2 < lens1) keeps all of R1
    frag_len = torch.where(merged, torch.maximum(best_o + lens2, lens1), lens1)
    Wm = bitops.n_words_for(L1 + L2)
    if scan == "packed":
        # rc(R2) funnel-shifted up by best_o bases, word by word, under R1
        ext = F.pad(rc2w & bitops.word_valid_mask(W2, lens2), (0, Wm - W2))
        q = torch.div(best_o, 16, rounding_mode="floor")[:, None]
        rb = (2 * (best_o - 16 * q[:, 0]))[:, None]
        widx = torch.arange(Wm, dtype=torch.int32, device=dev)[None] - q
        cur = torch.gather(ext, 1, torch.clamp(widx, 0, Wm - 1).long())
        cur = torch.where(widx >= 0, cur, 0)
        prv = torch.gather(ext, 1, torch.clamp(widx - 1, 0, Wm - 1).long())
        prv = torch.where(widx >= 1, prv, 0)
        # rb = 0 must not shift by 32: srl of an int64 view takes 32 as 0
        rc2s = torch.where(rb == 0, cur, (cur << rb) | bitops.srl(prv, 32 - rb))
        m1w = bitops.word_valid_mask(Wm, lens1)
        r1p = F.pad(words1, (0, Wm - W1)) & m1w
        mwords = (r1p | (rc2s & ~m1w)) & bitops.word_valid_mask(Wm, frag_len)
    else:
        Lm = L1 + L2
        posm = torch.arange(Lm, device=dev)[None]
        take2 = torch.clamp(posm - best_o[:, None], 0, L2 - 1)
        c2m = torch.gather(F.pad(c2, (0, Lm - L2)), 1, take2)
        cm = torch.where(posm < lens1[:, None], F.pad(c1, (0, Lm - L1)), c2m)
        cm = torch.where(posm < frag_len[:, None], cm, 0)
        mwords = bitops.pack_codes(F.pad(cm, (0, 16 * Wm - Lm)))
    out_words = torch.where(merged[:, None], mwords, F.pad(words1, (0, Wm - W1)))
    return out_words, frag_len, merged, best_ov, torch.where(merged, best_mm, -1)
