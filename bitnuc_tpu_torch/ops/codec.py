"""Batched encode/decode between ASCII nucleotides and packed 2-bit words.

The counterpart of ``bitnuc_tpu/ops/codec.py``. ``encode_reads`` runs the
hand-written K1 kernel (``csrc/pack.cu``) on CUDA tensors and its plain
PyTorch version, ``encode_reads_torch``, on CPU tensors (see ``config``);
``decode_reads`` does the same with K2 (``csrc/unpack.cu``) and
``decode_reads_torch``.

Semantics, shared by both encode paths: words [..., W] (int32 bit-views,
W even, W * 16 >= L) hold each read's bases LSB-first and are zero past
its length; ``first_bad`` is the earliest offset below the length whose
byte is not in ACGTacgt, or -1. Lengths are clamped to [0, L], and bytes at
or past a read's length are never inspected.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import config, kernels
from ..kernels import _build
from ..utils import bitops

_INT32_MAX = 2**31 - 1


def _n_words(L: int, n_words: Optional[int]) -> int:
    W = bitops.n_words_for(L) if n_words is None else int(n_words)
    if W % 2 or W * bitops.BASES_PER_WORD < L:
        raise ValueError(
            f"n_words={W} must be even and hold L={L} bases (16 per word)"
        )
    return W


def encode_reads_torch(
    ascii_u8: torch.Tensor, lengths: torch.Tensor, n_words: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch encode of a [..., L] uint8 batch: (words [..., W]
    int32, first_bad [...] int32)."""
    L = ascii_u8.shape[-1]
    W = _n_words(L, n_words)
    Lp = W * bitops.BASES_PER_WORD
    lens = torch.clamp(lengths.to(torch.int32), 0, L)
    pos = torch.arange(L, dtype=torch.int32, device=ascii_u8.device)
    in_range = pos < lens[..., None]
    codes = torch.nn.functional.pad(bitops.ascii_to_code(ascii_u8), (0, Lp - L))
    words = bitops.pack_codes(codes) & bitops.word_valid_mask(W, lens)
    bad = in_range & ~bitops.ascii_is_valid(ascii_u8)
    if L:
        first = torch.where(bad, pos, _INT32_MAX).amin(-1)
    else:  # amin has no identity for an empty axis
        first = torch.full_like(lens, _INT32_MAX)
    first_bad = torch.where(first == _INT32_MAX, -1, first).to(torch.int32)
    return words, first_bad


def encode_reads_kernel(
    ascii_u8: torch.Tensor, lengths: torch.Tensor, n_words: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on the card: [B, L] uint8 + [B] int32 -> ([B, W] int32,
    [B] int32). One launch; rows longer than a stage also take a fill of
    first_bad before it (``csrc/pack.cu``). Raises on anything but
    contiguous CUDA tensors."""
    kernels.require(ascii_u8, "pack ascii", torch.uint8, 2)
    kernels.require(lengths, "pack lengths", torch.int32, 1)
    B, L = ascii_u8.shape
    if lengths.shape[0] != B or lengths.device != ascii_u8.device:
        raise ValueError("pack: lengths must be [B] on the device of the reads")
    W = _n_words(L, n_words)
    words = torch.empty((B, W), dtype=torch.int32, device=ascii_u8.device)
    first_bad = torch.empty((B,), dtype=torch.int32, device=ascii_u8.device)
    code = _build.library().bn_pack(
        ascii_u8.data_ptr(), lengths.data_ptr(), B, L, W,
        words.data_ptr(), first_bad.data_ptr(), kernels.stream_handle(ascii_u8.device),
    )
    _build.check(code, "pack")
    kernels.LAUNCHES["pack"] += 1
    return words, first_bad


def encode_reads(
    ascii_u8: torch.Tensor, lengths: torch.Tensor, n_words: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backend-dispatching batched encode of [..., L] uint8 reads.

    Returns (words [..., W] int32 bit-views, first_bad [...] int32)."""
    if not config.use_kernel(ascii_u8):
        return encode_reads_torch(ascii_u8, lengths, n_words)
    lead = ascii_u8.shape[:-1]
    flat = ascii_u8.reshape(-1, ascii_u8.shape[-1]).contiguous()
    lens = lengths.to(torch.int32).reshape(-1).contiguous()
    words, first_bad = encode_reads_kernel(flat, lens, n_words)
    return words.reshape(lead + words.shape[-1:]), first_bad.reshape(lead)


def decode_reads_torch(
    words: torch.Tensor, lengths: torch.Tensor, max_len: Optional[int] = None
) -> torch.Tensor:
    """Plain version of K2: [..., W] words -> [..., max_len] uint8 ASCII,
    zero past each length and past the words' capacity 16 * W."""
    W = words.shape[-1]
    L = W * bitops.BASES_PER_WORD if max_len is None else int(max_len)
    codes = bitops.unpack_words(words)[..., :L]
    out = bitops.code_to_ascii(codes)
    cap = codes.shape[-1]
    if L > cap:
        out = torch.nn.functional.pad(out, (0, L - cap))
    pos = torch.arange(L, dtype=torch.int32, device=words.device)
    keep = pos < lengths.to(torch.int32)[..., None]
    return torch.where(keep, out, torch.zeros((), dtype=torch.uint8, device=out.device))


def decode_reads_kernel(
    words: torch.Tensor, lengths: torch.Tensor, max_len: Optional[int] = None
) -> torch.Tensor:
    """K2 on the card: [B, W] int32 + [B] int32 -> [B, max_len] uint8.
    Raises on anything but contiguous CUDA tensors."""
    kernels.require(words, "unpack words", torch.int32, 2)
    kernels.require(lengths, "unpack lengths", torch.int32, 1)
    B, W = words.shape
    if lengths.shape[0] != B or lengths.device != words.device:
        raise ValueError("unpack: lengths must be [B] on the device of the words")
    L = W * bitops.BASES_PER_WORD if max_len is None else int(max_len)
    if L < 0:
        raise ValueError(f"unpack: max_len must be >= 0, got {L}")
    out = torch.empty((B, L), dtype=torch.uint8, device=words.device)
    code = _build.library().bn_unpack(
        words.data_ptr(), lengths.data_ptr(), B, W, L, out.data_ptr(),
        kernels.stream_handle(words.device),
    )
    _build.check(code, "unpack")
    kernels.LAUNCHES["unpack"] += 1
    return out


def decode_reads(
    words: torch.Tensor, lengths: torch.Tensor, max_len: Optional[int] = None
) -> torch.Tensor:
    """Backend-dispatching batched decode: [..., W] words + [...] lengths
    -> [..., max_len] uint8 ASCII (max_len defaults to 16 * W), zero past
    each length and past the words' capacity."""
    if not config.use_kernel(words):
        return decode_reads_torch(words, lengths, max_len)
    lead = words.shape[:-1]
    flat = words.reshape(lead.numel(), words.shape[-1]).contiguous()  # W may be 0
    lens = lengths.to(torch.int32).reshape(-1).contiguous()
    out = decode_reads_kernel(flat, lens, max_len)
    return out.reshape(lead + out.shape[-1:])


def validity_mask(ascii_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """[..., L] bool: True where the byte is an in-range ACGT/acgt base."""
    L = ascii_u8.shape[-1]
    pos = torch.arange(L, dtype=torch.int32, device=ascii_u8.device)
    return (pos < lengths.to(torch.int32)[..., None]) & bitops.ascii_is_valid(ascii_u8)


def pack_kmers(
    ascii_u8: torch.Tensor, lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched as_2bit: [..., k<=32] ASCII -> [..., 2] words (one u64 pair
    per k-mer) + first_bad."""
    if ascii_u8.shape[-1] > 32:
        raise ValueError("pack_kmers takes at most 32 bases per k-mer")
    return encode_reads(ascii_u8, lengths, n_words=2)


def unpack_kmers(
    words: torch.Tensor, lengths: torch.Tensor, max_len: int = 32
) -> torch.Tensor:
    """Batched from_2bit."""
    return decode_reads(words, lengths, max_len)
