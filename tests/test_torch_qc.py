"""bitnuc_tpu_torch.qc against bitnuc_tpu.qc on the same numpy-seeded
records: the batch fold's accumulators against the JAX package's numpy
fold and its native fold, and qc_profile's report key for key, with
ragged lengths, lower-case and non-ACGT bases, qualities outside 33..96,
several batches of different widths, and .gz input."""

import gzip

import numpy as np
import pytest
import torch

from bitnuc_tpu import native, qc as jqc
from bitnuc_tpu_torch import qc

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = ("base_by_cycle", "qual_by_cycle", "mean_q_hist", "gc_hist", "reads", "bases",
          "min_len", "max_len", "width")


def _batch(rng, R, L, qlo=20, qhi=110):
    a = np.frombuffer(b"ACGTacgtNnRY", np.uint8)[rng.integers(0, 12, (R, L))]
    a[rng.random((R, L)) < 0.6] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4)]
    q = rng.integers(qlo, qhi, (R, L)).astype(np.uint8)
    lens = rng.integers(0, L + 1, R).astype(np.int64)
    return a, q, lens


def _acc_state(acc):
    return {f: getattr(acc, f) for f in FIELDS}


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("use_native", [False, True])
def test_fold_matches_jax_folds(use_native):
    if use_native and not native.available():
        pytest.skip("the JAX package's native library is not built")
    rng = np.random.default_rng(int(use_native))
    want, got = jqc._Acc(), qc._Acc(CPU)
    for R, L in ((50, 30), (0, 10), (120, 151), (7, 1), (60, 90)):
        a, q, lens = _batch(rng, R, L)
        want.fold(a, q, lens, use_jax=False, use_native=use_native)
        got.fold(a, q, lens)
    _equal(_acc_state(got), _acc_state(want))


def test_fold_rounds_half_to_even_as_numpy():
    """Mean phred and GC percent at exact halves: 2 bases of phred 0 and 1
    (mean 0.5 -> 0), of 2 and 3 (2.5 -> 2), one G in 8 bases (12.5 -> 12)."""
    a = np.frombuffer(b"AAAAAAAG" * 3, np.uint8).reshape(3, 8).copy()
    q = np.array([[33, 34] + [0] * 6, [35, 36] + [0] * 6, [40] * 8], np.uint8)
    lens = np.array([2, 2, 8], np.int64)
    want, got = jqc._Acc(), qc._Acc(CPU)
    want.fold(a, q, lens, use_jax=False, use_native=False)
    got.fold(a, q, lens)
    _equal(_acc_state(got), _acc_state(want))
    assert got.mean_q_hist[0] == 1 and got.mean_q_hist[2] == 1 and got.gc_hist[12] == 1


def _write(path, rng, n, lo, hi):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        for i in range(n):
            L = int(rng.integers(lo, hi))
            s = np.frombuffer(b"ACGTacgtN", np.uint8)[rng.integers(0, 9, L)].tobytes()
            q = rng.integers(30, 100, L).astype(np.uint8).tobytes()
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, q))


@pytest.mark.parametrize("suffix", [".fq", ".fq.gz"])
@pytest.mark.parametrize("batch", [13, 65536])
def test_qc_profile_matches_jax(tmp_path, suffix, batch):
    rng = np.random.default_rng(batch)
    path = tmp_path / f"r{suffix}"
    _write(path, rng, 200, 1, 140)
    want = jqc.qc_profile(path, batch_reads=batch)
    got = qc.qc_profile(path, batch_reads=batch, device=CPU)
    assert got == want
    assert got["per_cycle"] and got["reads"] == 200


def test_qc_profile_status_levels_match_jax(tmp_path):
    """Low qualities late in the read and a skewed base content."""
    rng = np.random.default_rng(3)
    with open(tmp_path / "s.fq", "wb") as f:
        for i in range(300):
            s = np.frombuffer(b"AAAAACGT", np.uint8)[rng.integers(0, 8, 60)].tobytes()
            q = np.concatenate([np.full(30, 73), rng.integers(33, 60, 30)]).astype(np.uint8)
            f.write(b"@x%d\n%s\n+\n%s\n" % (i, s, q.tobytes()))
    got = qc.qc_profile(tmp_path / "s.fq", device=CPU)
    assert got == jqc.qc_profile(tmp_path / "s.fq")
    assert got["status"] == {"per_base_quality": "fail", "per_base_content": "fail"}


def test_qc_profile_of_an_empty_file_matches_jax(tmp_path):
    (tmp_path / "e.fq").write_bytes(b"")
    assert qc.qc_profile(tmp_path / "e.fq", device=CPU) == jqc.qc_profile(tmp_path / "e.fq")


def test_percentile_and_status_helpers_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        h = rng.integers(0, 5, 64) * (rng.random(64) < 0.3)
        for frac in (0.0, 0.1, 0.25, 0.5, 0.9, 1.0):
            assert qc._percentile_from_hist(h, frac) == jqc._percentile_from_hist(h, frac)
    rows = [{"q_p25": int(rng.integers(0, 40)), "q_median": int(rng.integers(0, 40)),
             "a": int(rng.integers(0, 50)), "c": int(rng.integers(0, 50)),
             "g": int(rng.integers(0, 50)), "t": int(rng.integers(0, 50))} for _ in range(8)]
    for n in range(len(rows) + 1):
        assert qc._status(rows[:n]) == jqc._status(rows[:n])


def test_qc_profile_needs_a_device_or_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _write(tmp_path / "r.fq", np.random.default_rng(0), 3, 5, 9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qc.qc_profile(tmp_path / "r.fq")
