"""The port's flagship step against the JAX step, the package boundary (no
jax, no bitnuc_tpu), and the backend switch. The kernels themselves are
tested in test_torch_kernels.py."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import __graft_entry__  # noqa: E402
from bitnuc_tpu_torch import PackedDB, PackedReads, config, entry, kernels, mapper, pipeline
from bitnuc_tpu_torch.ops import codec, hamming, kmer
from bitnuc_tpu_torch.utils.bitops import words_to_u32_np

torch.set_num_threads(1)
CPU = torch.device("cpu")

PORT = ROOT / "bitnuc_tpu_torch"


def test_flagship_step_matches_jax():
    fn, args = __graft_entry__.entry()
    want = jax.jit(fn)(*args)
    tfn, targs = entry.entry(device=CPU)
    got = tfn(*targs)
    assert set(got) == set(want)
    for key, value in want.items():
        w = np.asarray(value)
        g = words_to_u32_np(got[key]) if w.dtype == np.uint32 else got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


def test_import_leaves_jax_out():
    code = (
        "import sys, bitnuc_tpu_torch, bitnuc_tpu_torch.entry, bitnuc_tpu_torch.pipeline, "
        "bitnuc_tpu_torch.mapper; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'bitnuc_tpu.'))"
        " or m == 'bitnuc_tpu']; assert not bad, bad"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True, timeout=120)


def test_port_sources_import_neither_jax_nor_reference():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|bitnuc_tpu)\b", re.M)
    sources = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders


def test_kernel_backend_refuses_cpu_tensors():
    words = torch.zeros((2, 2), dtype=torch.int32)
    lens = torch.tensor([20, 20], dtype=torch.int32)
    with config.backend("kernel"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            codec.encode_reads(torch.zeros((2, 20), dtype=torch.uint8), lens)
        with pytest.raises(ValueError, match="CUDA tensor"):
            kmer.count_kmers_reads(words, lens, 4)
        with pytest.raises(ValueError, match="CUDA tensor"):
            kmer.count_kmers_reads(words, lens, 4, canonical=True)
        with pytest.raises(ValueError, match="CUDA tensor"):
            hamming.hdist_scan(words, words, 20)
    assert config.get_backend() == "auto"
    with pytest.raises(ValueError):
        config.set_backend("xla")


@pytest.mark.parametrize("call", [
    lambda: PackedReads.from_ascii([b"ACGT"]),
    lambda: PackedReads.from_numpy(np.zeros((1, 2), np.uint32), [4]),
    lambda: PackedDB.from_numpy(np.zeros((2, 3), np.uint32), 20),
    lambda: entry.entry(batch=2, read_len=8, db_size=4),
    lambda: pipeline.count_fasta(b">x\nACGTACGT\n", 4),
    lambda: mapper.MinimizerIndex.build(b"ACGT" * 20),
    lambda: mapper.MinimizerIndex.build_multi([b"ACGT" * 20, b"TTGCA" * 9]),
], ids=["from_ascii", "from_numpy", "PackedDB", "entry", "count_fasta", "index_build",
        "index_build_multi"])
def test_entry_points_default_to_the_card(monkeypatch, call):
    """With no CUDA device and no ``device`` argument an entry point raises
    an error that names the argument; it does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="`device` argument"):
        call()


def test_launch_counters_untouched_by_plain_paths():
    kernels.reset_launches()
    tfn, targs = entry.entry(device=CPU, batch=4, read_len=40, db_size=8)
    tfn(*targs)
    assert all(n == 0 for n in kernels.LAUNCHES.values())
