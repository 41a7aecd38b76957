"""Open reading frames on packed reads: the longest ATG..stop ORF over six
frames, and translation with the standard genetic code.

The counterpart of ``bitnuc_tpu/ops/orf.py``. An ORF starts at ATG and runs
in frame to the first stop codon (TAA, TAG, TGA; the stop is not part of
the span); with no stop in frame it stays open and runs to the last whole
codon. A codon counts only when it lies wholly inside the read. The reverse
strand is the one-strand scan of ``reverse_complement_reads``, its
coordinates mapped back to the forward strand.

The scan has a hand-written kernel, K10 ``orf_scan`` (``csrc/orf.cu``), run
on CUDA words: one launch scans one strand, or both, the reverse
complement's words made in the kernel from the forward ones. Its plain
version ``best_orf_one_strand_torch`` is the JAX package's XLA path: one
reverse ``cummin`` over a [B, L3/3, 3] view of the stop positions gives
each position the next stop in its frame; ``best_orf_two_strands_torch``
runs it on the words and on their reverse complement. Neither keeps the
TPU kernel's L <= 32767 bound, which exists for its multiply-shift
division by 3.
``translate_reads`` looks codons up in a 64-entry table (the JAX package
contracts a one-hot instead, a rule of the TPU: no gathers).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import config, kernels
from ..kernels import _build
from ..utils import bitops
from . import revcomp

_BIG = 2**30
# codon value = c0*16 + c1*4 + c2 with A=0 C=1 G=2 T=3
_ATG = 0 * 16 + 3 * 4 + 2
_STOPS = (3 * 16 + 0 * 4 + 0, 3 * 16 + 0 * 4 + 2, 3 * 16 + 2 * 4 + 0)  # TAA, TAG, TGA

# the standard genetic code (NCBI table 1), indexed by the codon value above
_CODON_AA = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}
_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
_AA_LUT = np.zeros(64, np.uint8)
for _codon, _aa in _CODON_AA.items():
    _AA_LUT[
        _BASE_CODE[_codon[0]] * 16 + _BASE_CODE[_codon[1]] * 4 + _BASE_CODE[_codon[2]]
    ] = ord(_aa)


def best_orf_one_strand_torch(words: torch.Tensor, lengths: torch.Tensor):
    """Plain version of K10: (length [B] int32, start [B] int32, stopped [B]
    bool) of the longest ATG..stop ORF over the three frames of one strand.
    The length counts coding bases (the stop excluded) and is 0 where no
    ATG exists; then start is 0 and stopped False. Ties go to the smallest
    start."""
    lengths = lengths.to(torch.int32)
    codes = bitops.unpack_words(words)
    B, L = codes.shape
    if L == 0:
        zero = torch.zeros(B, dtype=torch.int32, device=words.device)
        return zero, zero.clone(), torch.zeros(B, dtype=torch.bool, device=words.device)
    # codon(p) = c[p] 16 + c[p+1] 4 + c[p+2], bases past 16W read as A; it
    # counts only where p + 3 <= length
    pos = torch.arange(L, dtype=torch.int32, device=words.device)
    ext = torch.nn.functional.pad(codes, (0, 2))
    codon = codes * 16 + ext[:, 1 : L + 1] * 4 + ext[:, 2 : L + 2]
    cvalid = pos + 3 <= lengths[:, None]
    is_stop = ((codon == _STOPS[0]) | (codon == _STOPS[1]) | (codon == _STOPS[2])) & cvalid
    is_start = (codon == _ATG) & cvalid

    # next stop in frame at or after p: pad L to a multiple of 3 and view as
    # [B, L3/3, 3], whose column r holds frame r's codons in order; one
    # reverse cummin along the codon axis
    L3 = -(-L // 3) * 3
    stop_pos = torch.where(is_stop, pos, _BIG)
    stop_pos = torch.nn.functional.pad(stop_pos, (0, L3 - L), value=_BIG)
    v3 = torch.flip(stop_pos.reshape(B, L3 // 3, 3), (1,))
    nxt = torch.flip(torch.cummin(v3, 1).values, (1,)).reshape(B, L3)[:, :L]

    # open ORFs end at the last whole codon in frame: p + 3 floor((len - p) / 3)
    open_end = pos + torch.div(lengths[:, None] - pos, 3, rounding_mode="floor") * 3
    stopped_here = nxt < _BIG
    olen = torch.where(is_start, torch.where(stopped_here, nxt, open_end) - pos, 0)

    best = olen.amax(-1)
    at_best = (olen == best[:, None]) & is_start
    start = torch.where(at_best, pos, _BIG).amin(-1)
    stopped = (at_best & (pos == start[:, None]) & stopped_here).any(-1) & (best > 0)
    return best, torch.where(best > 0, start, 0), stopped


def best_orf_two_strands_torch(words: torch.Tensor, lengths: torch.Tensor):
    """Plain version of K10 on both strands: (length, start, stopped), each
    [2, B], of ``best_orf_one_strand_torch`` on the words (row 0) and on
    ``reverse_complement_reads(words, lengths)`` (row 1, in the reverse
    strand's own coordinates)."""
    lengths = lengths.to(torch.int32)
    both = torch.cat([words, revcomp.reverse_complement_reads(words, lengths)])
    out = best_orf_one_strand_torch(both, torch.cat([lengths, lengths]))
    return tuple(x.reshape(2, words.shape[0]) for x in out)


def _orf_scan_kernel(words: torch.Tensor, lengths: torch.Tensor, strands: int):
    """K10 on the card (``csrc/orf.cu``), one launch: (length, start,
    stopped), each [strands, B], of the forward strand and, at strands = 2,
    the reverse complement's, built in the kernel from the same words."""
    kernels.require(words, "orf_scan words", torch.int32, 2)
    kernels.require(lengths, "orf_scan lengths", torch.int32, 1)
    B, W = words.shape
    if lengths.shape[0] != B or lengths.device != words.device:
        raise ValueError("orf_scan: words and lengths need one batch size and device")
    if 16 * W >= 2**31:
        raise ValueError(f"orf_scan: rows of {16 * W} bases pass int32 positions")
    dev = words.device
    best = torch.empty((strands, B), dtype=torch.int32, device=dev)
    start = torch.empty((strands, B), dtype=torch.int32, device=dev)
    stopped = torch.empty((strands, B), dtype=torch.bool, device=dev)
    code = _build.library().bn_orf_scan(
        words.data_ptr(), lengths.data_ptr(), B, W, strands, best.data_ptr(), start.data_ptr(),
        stopped.data_ptr(), kernels.stream_handle(dev),
    )
    _build.check(code, "orf_scan")
    kernels.LAUNCHES["orf_scan"] += 1
    return best, start, stopped


def best_orf_one_strand_kernel(words: torch.Tensor, lengths: torch.Tensor):
    """K10 on one strand: contiguous int32 CUDA words [B, W] and int32
    lengths [B]; rows of any length below 2^31 bases."""
    return tuple(x[0] for x in _orf_scan_kernel(words, lengths, 1))


def best_orf_two_strands_kernel(words: torch.Tensor, lengths: torch.Tensor):
    """K10 on both strands in one launch, as ``best_orf_two_strands_torch``:
    the reverse strand's words are made in the kernel, so no reverse
    complement is made on the device."""
    return _orf_scan_kernel(words, lengths, 2)


def _best_orf_two_strands(words: torch.Tensor, lengths: torch.Tensor):
    """(length, start, stopped) [2, B] of both strands; K10 on CUDA words
    (see ``config``)."""
    if config.use_kernel(words):
        return best_orf_two_strands_kernel(words.contiguous(),
                                           lengths.to(torch.int32).contiguous())
    return best_orf_two_strands_torch(words, lengths)


def translate_reads(words: torch.Tensor, lengths: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Translate frame 0 of each read with the standard genetic code.

    Returns (aa [B, L//3] uint8 ASCII amino acids, '*' for a stop, 0 past
    each read's last whole codon; n_aa [B] int32). Slice an ORF first with
    ``ops.split.slice_reads`` to translate another frame or strand."""
    codes = bitops.unpack_words(words)
    B, L = codes.shape
    lengths = lengths.to(torch.int32)
    L3 = (L // 3) * 3
    v = codes[:, :L3].reshape(B, L3 // 3, 3)
    codon = v[..., 0] * 16 + v[..., 1] * 4 + v[..., 2]
    lut = torch.from_numpy(_AA_LUT).to(words.device)
    aa = lut[codon.to(torch.int64)]
    n_aa = torch.div(lengths, 3, rounding_mode="floor")
    idx = torch.arange(L3 // 3, dtype=torch.int32, device=words.device)
    return torch.where(idx[None, :] < n_aa[:, None], aa, 0).to(torch.uint8), n_aa


def longest_orf(words: torch.Tensor, lengths: torch.Tensor):
    """Longest ORF per read across all six frames.

    Returns (length [B], start [B], end [B], is_rc [B] bool, stopped [B]
    bool): the length in coding bases (the stop excluded; 0 where no frame
    has an ATG), [start, end) in forward-strand coordinates (for a
    reverse-strand ORF they bracket the reverse-complement span), and
    whether the ORF ends at a stop rather than the read's end. Ties go to
    the forward strand, then to the smallest start on that strand."""
    lengths = lengths.to(torch.int32)
    (len_f, len_r), (start_f, start_r), (stop_f, stop_r) = _best_orf_two_strands(words, lengths)
    use_rc = len_r > len_f  # strict: the forward strand wins ties
    length = torch.where(use_rc, len_r, len_f)
    stopped = torch.where(use_rc, stop_r, stop_f)
    # reverse-strand [s, s + len) is forward [L - s - len, L - s)
    fwd_start = torch.where(use_rc, lengths - start_r - len_r, start_f)
    found = length > 0
    return (
        length,
        torch.where(found, fwd_start, 0),
        torch.where(found, fwd_start + length, 0),
        use_rc & found,
        stopped,
    )
