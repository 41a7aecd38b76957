"""The hand-written CUDA kernels against their plain PyTorch versions, bit
for bit, on the card. Every test here carries the ``cuda`` marker and skips
where no CUDA device is present. The file imports neither jax nor the
conftest's helpers, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

chip_smoke.py runs the same comparisons at the main path's full sizes."""

import numpy as np
import pytest
import torch

from bitnuc_tpu_torch import config, entry, kernels
from bitnuc_tpu_torch.ops import codec, hamming, kmer, merge

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) for the hand-written kernels")
    return torch.device("cuda")


def _reads_on(device, B, L, seed):
    g = torch.Generator().manual_seed(seed)
    alphabet = torch.tensor(list(b"ACGTacgtN"), dtype=torch.uint8)
    a = alphabet[torch.randint(0, 9, (B, L), generator=g)]
    lens = torch.randint(0, L + 1, (B,), generator=g, dtype=torch.int32)
    return a.to(device), lens.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(1, 1), (5, 33), (3, 1000), (300, 150)])
def test_pack_kernel_matches_plain(cuda, B, L):
    a, lens = _reads_on(cuda, B, L, 1)
    for got, want in zip(codec.encode_reads_kernel(a, lens), codec.encode_reads_torch(a, lens)):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 8, 12])
def test_histogram_kernels_match_plain(cuda, k):
    a, lens = _reads_on(cuda, 300, 150, 2)
    words, _ = codec.encode_reads_torch(a, lens)
    valid = codec.validity_mask(a, lens)
    lo, _, v = kmer._window_keys(words, lens, k, True, valid)
    keys = torch.where(v, lo, 4**k).reshape(-1).contiguous()
    assert torch.equal(kmer.histogram_from_keys_kernel(keys, k),
                       kmer.histogram_from_keys_torch(keys, k))
    assert torch.equal(kmer.histogram_from_words_kernel(words, lens, k),
                       kmer.histogram_from_words_torch(words, lens, k))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,nb", [(1, 512), (3, 150), (64, 7)])
def test_hdist_scan_kernel_matches_plain(cuda, Q, nb):
    g = torch.Generator().manual_seed(3)
    db = torch.randint(-(2**31), 2**31 - 1, (32, 1000), generator=g, dtype=torch.int32)
    q = torch.randint(-(2**31), 2**31 - 1, (Q, 32), generator=g, dtype=torch.int32)
    db, q = db.to(cuda), q.to(cuda)
    assert torch.equal(hamming.hdist_scan_kernel(q, db, nb), hamming.hdist_scan_torch(q, db, nb))


@pytest.mark.cuda
def test_flagship_step_on_card_matches_plain(cuda):
    fwd, args = entry.entry(device=cuda, batch=300, read_len=150, db_size=5000)
    kernels.reset_launches()
    got = fwd(*args)
    step = ("pack", "hist_keys", "hist_words", "hdist_scan")
    assert all(kernels.LAUNCHES[name] > 0 for name in step), kernels.LAUNCHES
    with config.backend("torch"):
        want = fwd(*args)
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.cuda
@pytest.mark.parametrize("B,W,max_len", [(1, 2, 1), (5, 4, 33), (300, 10, 150),
                                         (3, 2, 48), (4, 2, None), (7, 4, 0)])
def test_unpack_kernel_matches_plain(cuda, B, W, max_len):
    g = torch.Generator().manual_seed(4)
    words = torch.randint(-(2**31), 2**31 - 1, (B, W), generator=g, dtype=torch.int32)
    lens = torch.randint(-2, 16 * W + 20, (B,), generator=g, dtype=torch.int32)
    words, lens = words.to(cuda), lens.to(cuda)
    want = codec.decode_reads_torch(words, lens, max_len)
    assert torch.equal(codec.decode_reads_kernel(words, lens, max_len), want)
    before = kernels.LAUNCHES["unpack"]
    assert torch.equal(codec.decode_reads(words[0], lens[0], max_len), want[0])
    assert kernels.LAUNCHES["unpack"] == before + 1


def _sorted_cols(rng, n, n_keys, n_pay, dups):
    """n rows sorted by unsigned key words; ``dups`` draws keys from a few
    values around the sign bit and the all-ones word."""
    pool = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    ks = [rng.choice(pool, n) if dups else
          rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
          for _ in range(n_keys)]
    order = np.lexsort(tuple(reversed(ks)))
    cols = [k[order] for k in ks]
    cols += [rng.integers(-100, 100, n).astype(np.int32) for _ in range(n_pay)]
    return [torch.from_numpy(c.view(np.int32).copy()) for c in cols]


@pytest.mark.cuda
@pytest.mark.parametrize("dups", [False, True])
@pytest.mark.parametrize("n_keys,n_pay", [(1, 0), (2, 1), (3, 2)])
@pytest.mark.parametrize("na,nb", [(0, 5), (7, 0), (300, 200), (5000, 3000)])
def test_merge_kernel_matches_plain(cuda, na, nb, n_keys, n_pay, dups):
    rng = np.random.default_rng(na + 7 * nb + n_keys)
    a = [c.to(cuda) for c in _sorted_cols(rng, na, n_keys, n_pay, dups)]
    b = [c.to(cuda) for c in _sorted_cols(rng, nb, n_keys, n_pay, dups)]
    pad = tuple(range(n_pay)) or None
    got = merge.merge_sorted_kernel(a, b, n_keys, pad)
    want = merge.merge_sorted_torch(a, b, n_keys, pad)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
