"""The flagship single-device step of the port.

The counterpart of ``__graft_entry__.entry()``: an ASCII batch goes to packed
words (K1), a k-mer histogram plain and canonical (K3b, K3b), GC content,
reverse complements, and a Hamming top-k of the first read against a
packed database (K4). It calls the dispatching functions, so CUDA tensors
run the kernels and CPU tensors their plain versions, and it returns the
JAX step's eight named outputs (words as int32 bit-views).

``dryrun_multichip`` is the counterpart of ``__graft_entry__``'s: one
checked distributed step over a mesh (``parallel``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import config
from .database import PackedDB
from .ops import analysis, codec, kmer, revcomp
from .utils import bitops

K = 8
TOPK = 16


def example_batch(batch=64, read_len=128, db_size=256, seed=0):
    """Host inputs (ascii uint8 [batch, read_len], lengths int32 [batch],
    db uint32 [db_size, W]) made exactly as ``__graft_entry__`` makes them."""
    rng = np.random.default_rng(seed)
    ascii_u8 = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(batch, read_len))
    lengths = np.full((batch,), read_len, dtype=np.int32)
    n_words = bitops.n_words_for(read_len)
    db_words = rng.integers(0, 2**32, size=(db_size, n_words), dtype=np.uint32)
    return ascii_u8, lengths, db_words


def forward(ascii_u8: torch.Tensor, lengths: torch.Tensor, db: PackedDB) -> dict:
    """One step over a [B, L] uint8 batch and a word-major database whose
    entries have the reads' word count."""
    words, first_bad = codec.encode_reads(ascii_u8, lengths)
    hist = kmer.count_kmers_reads(words, lengths, K)
    hist_canon = kmer.count_kmers_reads(words, lengths, K, canonical=True)
    gc = analysis.gc_content_reads(words, lengths)
    rc = revcomp.reverse_complement_reads(words, lengths)
    dists, idx = db.search(words[0], TOPK)
    return {
        "words": words,
        "first_bad": first_bad,
        "kmer_hist": hist,
        "kmer_hist_canonical": hist_canon,
        "gc_content": gc,
        "revcomp_words": rc,
        "top_dists": dists,
        "top_idx": idx,
    }


def entry(device=None, **sizes):
    """(forward, args): the step and its example inputs on ``device``
    (default: the card, see ``config.resolve_device``). The database's
    n_bases is min(lengths[0], 16 W), as in the JAX step."""
    device = config.resolve_device(device)
    ascii_np, lengths_np, db_np = example_batch(**sizes)
    n_bases = min(int(lengths_np[0]), 16 * db_np.shape[1])
    db = PackedDB.from_numpy(db_np.T, n_bases, device)
    return forward, (
        torch.from_numpy(ascii_np).to(device),
        torch.from_numpy(lengths_np).to(device),
        db,
    )


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """One full distributed step on an n_devices mesh, checked: the
    counterpart of ``__graft_entry__.dryrun_multichip``. ``devices``
    defaults to the first n_devices CUDA devices; a repeated device serves
    (``[torch.device("cpu")] * 8`` runs eight CPU shards). Batch-sharded
    k-mer counts (dense and sorted), the database split by rows and by
    columns (one query and a batch), a 2-D grid search for an even
    n_devices, one long sequence split along its words (dense and sorted),
    sharded short-read, paired and long-read mapping, a sharded pileup,
    and a sharded streaming k = 21 count of a FASTQ with Ns against a host
    dict oracle. Raises AssertionError when a result is wrong."""
    import os
    import tempfile

    from . import mapper, oracle, pipeline
    from .assemble import rc_ascii
    from .ops import pileup as pileup_ops
    from .parallel import kmer as pkmer, mesh as pmesh, search
    from .sequence import PackedReads

    if devices is None:
        if torch.cuda.device_count() < n_devices:
            raise AssertionError(
                f"need {n_devices} devices, have {torch.cuda.device_count()}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    devices = [torch.device(d) for d in devices][:n_devices]
    assert len(devices) == n_devices, f"need {n_devices} devices, got {len(devices)}"
    mesh = pmesh.make_mesh((n_devices,), ("data",), devices=devices)
    dev0 = devices[0]

    K6 = 6
    topk = 8
    batch = 4 * n_devices
    read_len = 64
    db_size = 16 * n_devices
    ascii_np, lengths_np, db_np = example_batch(batch, read_len, db_size, seed=1)

    # reads over the batch axis (each shard packed by K1 on its device),
    # the database over its rows, the query replicated
    a_sh = pmesh.split(torch.from_numpy(ascii_np), mesh, "data")
    l_sh = pmesh.split(torch.from_numpy(lengths_np), mesh, "data")
    w_sh = []
    for d, a, ln in zip(devices, a_sh, l_sh):
        with pmesh.on_device(d):
            w_sh.append(codec.encode_reads(a, ln)[0])
    words = pmesh.Sharded(w_sh, mesh, "data")
    lengths = pmesh.Sharded(l_sh, mesh, "data")
    words_full = words.full()
    query = words_full[0]
    db_rows = bitops.words_from_u32_np(db_np)
    db_wm = bitops.words_from_u32_np(np.ascontiguousarray(db_np.T))

    hist = pkmer.count_kmers_sharded(words, lengths, K6, mesh)
    dists, idx = search.hdist_search_sharded(query, db_rows, read_len, topk, mesh)
    wm_d, wm_i = search.hdist_search_db_sharded(query, db_wm, read_len, topk, mesh)
    lo_s, hi_s, cts, n_u = pkmer.count_kmers_sorted_sharded(words, lengths, 21, mesh)
    bq_d, bq_i = search.hdist_search_batch_db_sharded(words_full[:4], db_wm, read_len, topk,
                                                      mesh)
    g_d = None
    if n_devices % 2 == 0:  # queries on one axis, database columns on the other
        mesh2d = pmesh.make_mesh((n_devices // 2, 2), ("data", "model"), devices=devices)
        g_d, _ = search.hdist_search_grid(words_full[: 2 * (n_devices // 2)], db_wm, read_len,
                                          topk, mesh2d, "data", "model")

    # one long sequence's words split over the mesh, windows across shard
    # edges served by the halo
    words_per_shard = 8
    long_words = bitops.words_from_u32_np(np.random.default_rng(2).integers(
        0, 2**32, size=(n_devices * words_per_shard,), dtype=np.uint32))
    total_len = n_devices * words_per_shard * 16
    hist_seq = pkmer.count_kmers_seqsharded(long_words, total_len, K6, mesh, "data")
    _, _, scts, _ = pkmer.count_kmers_seqsharded_sorted(long_words, total_len, 21, mesh, "data")

    # read mapping: reads split over the mesh, the index on every device
    ref = bytes(np.random.default_rng(3).choice(np.frombuffer(b"ACGT", np.uint8), size=2000))
    m_idx = mapper.MinimizerIndex.build(ref, k=13, w=8, device=dev0)
    m_reads = PackedReads.from_ascii(
        [ref[100 + 37 * i : 100 + 37 * i + 96] for i in range(batch)], device=dev0)
    m_out = mapper.map_reads_sharded(m_idx, m_reads, mesh, "data")
    use_rc = torch.from_numpy(m_out["strand"] == b"-")
    keep = torch.from_numpy(m_out["mapped"])
    starts = torch.from_numpy(m_out["ref_start"])
    grid_sh = pileup_ops.pileup_counts_sharded(m_reads.words, m_reads.lengths, starts, use_rc,
                                               keep, len(ref), mesh, "data")
    grid_loc = pileup_ops.pileup_counts(m_reads.words, m_reads.lengths, starts.to(dev0),
                                        use_rc.to(dev0), keep.to(dev0), len(ref))

    pair_b = 2 * n_devices
    r1 = PackedReads.from_ascii([ref[50 + 29 * i : 50 + 29 * i + 80] for i in range(pair_b)],
                                device=dev0)
    r2 = PackedReads.from_ascii(
        [rc_ascii(ref[50 + 29 * i + 120 : 50 + 29 * i + 200]) for i in range(pair_b)],
        device=dev0)
    pres = mapper.map_pairs(m_idx, r1, r2, max_insert=300, mesh=mesh)

    long_reads = []
    for i in range(batch):
        s = 40 + 11 * i
        src = ref[s : s + 700]
        long_reads.append(src[:200] + src[203:500] + src[502:])  # two deletions
    lr = PackedReads.from_ascii(long_reads, device=dev0)
    l_one = mapper.map_reads_long(m_idx, lr, min_chain=5, extend=True)
    l_mesh = mapper.map_reads_long(m_idx, lr, min_chain=5, extend=True, mesh=mesh)

    # streaming k = 21 with Ns: a run list a device, one merge at the end
    rng3 = np.random.default_rng(4)
    stream_seqs = []
    for n_ in rng3.integers(40, 90, 4 * n_devices):
        s = bytearray(rng3.choice(np.frombuffer(b"ACGT", np.uint8), int(n_)).tobytes())
        s[rng3.integers(len(s))] = ord("N")
        stream_seqs.append(bytes(s))
    fd, fq_path = tempfile.mkstemp(suffix=".fq")
    try:
        with os.fdopen(fd, "wb") as f:
            for i, s in enumerate(stream_seqs):
                f.write(b"@d%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
        got21 = pipeline.count_fastq(fq_path, 21, batch_size=2 * n_devices, mesh=mesh,
                                     on_invalid="skip", sparse_capacity=2048)
    finally:
        os.unlink(fq_path)
    want21 = {}
    for s in stream_seqs:
        for q in range(len(s) - 21 + 1):
            win = s[q : q + 21]
            if all(c in b"ACGT" for c in win):
                key = oracle.as_2bit(win)
                want21[key] = want21.get(key, 0) + 1

    assert int(hist.sum()) == sum(max(0, int(n) - K6 + 1) for n in lengths_np)
    assert int(hist_seq.sum()) == total_len - K6 + 1
    assert bool((dists[:-1] <= dists[1:]).all())
    assert torch.equal(wm_d, dists)
    assert int(cts.sum()) == sum(max(0, int(n) - 21 + 1) for n in lengths_np)
    assert int(n_u) == int((cts > 0).sum())
    assert torch.equal(bq_d[0], wm_d)  # the batch's row 0 is the one-query scan
    if g_d is not None:
        assert torch.equal(g_d.full()[0], wm_d)
    assert int(scts.sum()) == total_len - 21 + 1
    assert m_out["mapped"].all() and (m_out["cost"] == 0).all()
    assert m_out["ref_start"].tolist() == [100 + 37 * i for i in range(batch)]
    assert torch.equal(grid_sh, grid_loc)
    assert pres["proper"].all() and (pres["insert"] == 200).all()
    assert l_one["mapped"].all() and (l_one["cost"] == 5).all()
    for f in l_one:
        assert np.array_equal(l_one[f], l_mesh[f]), f
    assert got21 == want21
