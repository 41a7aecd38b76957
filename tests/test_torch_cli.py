"""bitnuc_tpu_torch.cli against bitnuc_tpu.cli, byte for byte: every
subcommand but info (map, call and align are in test_torch_cli_map.py) runs
through ``bitnuc_tpu.cli.main(argv)`` and ``bitnuc_tpu_torch.cli.main(
["--device", "cpu", *argv])`` on the same small files made from a numpy
seed. Standard output, standard error (with each side's output directory
written as {out}), the exit code or the error raised, and every file a
command writes are compared; a .npz array for array. Also: --devices 8
(the port on 8 CPU shards) against the JAX CLI's 8-device mesh and
against the port's single-device run, --devices N on the card without N
cards, the command line without a
card and without --device exits before it reads anything, info's JSON,
``python -m bitnuc_tpu_torch`` in a fresh process, and ``| head`` ending
with 0."""

import gzip
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bitnuc_tpu import cli as jcli
from bitnuc_tpu.database import PackedDB as JPackedDB
from bitnuc_tpu_torch import cli, native

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def rc(s: bytes) -> bytes:
    return s.translate(COMP)[::-1]


def _fastq(path, seqs, quals=None, names=None):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            q = quals[i] if quals is not None else b"I" * len(s)
            n = names[i] if names is not None else b"r%d" % i
            f.write(b"@%s\n%s\n+\n%s\n" % (n, s, q))


def _fasta(path, seqs, names=None, width=None):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            n = names[i] if names is not None else b"r%d" % i
            body = s if width is None else b"\n".join(
                s[j : j + width] for j in range(0, len(s), width))
            f.write(b">%s\n%s\n" % (n, body))


def _mutate(rng, s: bytes, sub: float, n_rate: float = 0.0, indel: float = 0.0) -> bytes:
    a = bytearray(s)
    for p in np.flatnonzero(rng.random(len(a)) < sub):
        a[p] = ACGT[(np.flatnonzero(ACGT == a[p])[0] + rng.integers(1, 4)) % 4] \
            if a[p] in ACGT else a[p]
    for p in np.flatnonzero(rng.random(len(a)) < n_rate):
        a[p] = ord("N")
    if indel:
        out = bytearray()
        for b in a:
            r = rng.random()
            if r < indel / 2:
                continue  # deletion
            out.append(b)
            if r > 1 - indel / 2:
                out.append(int(ACGT[rng.integers(0, 4)]))  # insertion
        a = out
    return bytes(a)


def make_inputs(d: Path) -> None:
    """The shared inputs, all from one numpy seed: a two-contig genome, a
    donor with SNPs and indels and reads of it (with Ns), clean reads,
    pairs, long reads, duplicates, quality-trimmed reads with adapters, a
    search database and queries, barcoded reads."""
    rng = np.random.default_rng(2026)
    c0 = ACGT[rng.integers(0, 4, 3000)].tobytes()
    c1 = ACGT[rng.integers(0, 4, 1500)].tobytes()
    genome = [c0, c1]
    _fasta(d / "genome.fa", genome, [b"c0 first contig", b"c1"], width=70)
    donor = []
    for c in genome:
        a = bytearray(c)
        for p in rng.choice(np.arange(50, len(a) - 50), len(a) // 300, replace=False):
            a[p] = ACGT[(np.flatnonzero(ACGT == a[p])[0] + 1) % 4]
        p = len(a) // 2
        a = a[:p] + a[p + 3 :]  # a 3-bp deletion
        p = len(a) // 3
        a = a[:p] + b"GATC" + a[p:]  # a 4-bp insertion
        donor.append(bytes(a))
    reads, clean = [], []
    for i in range(360):
        c = donor[int(i % 3 == 0)]
        s = int(rng.integers(0, len(c) - 100))
        r = c[s : s + 100]
        if rng.random() < 0.5:
            r = rc(r)
        reads.append(_mutate(rng, r, 0.005, 0.003))
        clean.append(_mutate(rng, r, 0.005))
    _fastq(d / "reads.fq", reads)
    _fasta(d / "reads.fa", reads[:120])
    _fastq(d / "clean.fq", clean)
    _fastq(d / "clean2.fq", clean[::3] + [ACGT[rng.integers(0, 4, 80)].tobytes()
                                          for _ in range(20)])
    with gzip.open(d / "clean.fq.gz", "wb") as f:
        f.write((d / "clean.fq").read_bytes())
    (d / "mystery").write_bytes(b">x\n" + c1[:200] + b"\n")
    r1, r2 = [], []
    for i in range(150):
        c = genome[i % 2]
        n = int(rng.integers(110, 260))
        s = int(rng.integers(0, len(c) - n))
        frag = c[s : s + n]
        r1.append(_mutate(rng, frag[:100], 0.01))
        r2.append(_mutate(rng, rc(frag)[:100], 0.01))
    _fastq(d / "r1.fq", r1)
    _fastq(d / "r2.fq", r2)
    longs = []
    for i in range(10):
        n = int(rng.integers(400, 1200))
        s = int(rng.integers(0, len(c0) - n))
        r = c0[s : s + n]
        longs.append(_mutate(rng, r if i % 2 else rc(r), 0.01, indel=0.01))
    _fastq(d / "long.fq", longs)
    dups = [clean[i] for i in rng.integers(0, 40, 120)]
    _fasta(d / "dups.fa", dups)
    qseqs, quals = [], []
    adapter = b"AGATCGGAAGAGC"
    for i in range(200):
        n = int(rng.integers(20, 120))
        s = bytearray(_mutate(rng, c0[i * 10 : i * 10 + n], 0.0, 0.01))
        if i % 4 == 0:
            p = int(rng.integers(0, n))
            s[p:] = (adapter * 10)[: n - p]
        if i % 17 == 0:
            s[:] = b"A" * n
        q = np.clip(rng.normal(32, 6, n) - np.arange(n) * 0.15, 2, 41).astype(np.uint8) + 33
        qseqs.append(bytes(s))
        quals.append(q.tobytes())
    _fastq(d / "q.fq", qseqs, quals, [b"q%d extra" % i for i in range(200)])
    _fastq(d / "q2.fq", [rc(s) for s in qseqs], quals[::-1])
    db = [ACGT[rng.integers(0, 4, 64)].tobytes() for _ in range(300)]
    _fastq(d / "db.fq", db)
    JPackedDB.from_fastq(str(d / "db.fq"), 64).save(str(d / "db.npz"))
    _fasta(d / "q10.fa", [_mutate(rng, db[i * 7], 0.05) for i in range(10)])
    _fasta(d / "q3.fa", [db[5][:40], _mutate(rng, db[9], 0.1), db[11]])
    bcs = [ACGT[rng.integers(0, 4, 8)].tobytes() for _ in range(4)]
    (d / "bc.tsv").write_bytes(b"".join(b"bc%d\t%s\n" % (i, b) for i, b in enumerate(bcs)))
    dm = []
    for i in range(120):
        b = bcs[i % 5] if i % 5 < 4 else ACGT[rng.integers(0, 4, 8)].tobytes()
        dm.append(_mutate(rng, b, 0.04) + ACGT[rng.integers(0, 4, 50)].tobytes())
    _fastq(d / "dm.fq", dm)
    from bitnuc_tpu import io as jio, sequence as jseq

    jio.save_packed(str(d / "clean.npz"), jseq.PackedReads.from_ascii(clean[:50]))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    make_inputs(d)
    return d


def _files(out: Path) -> dict:
    got = {}
    for p in sorted(out.rglob("*")):
        if not p.is_file():
            continue
        if p.suffix == ".npz":
            with np.load(p, allow_pickle=False) as z:
                got[p.name] = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes()) for k in z.files}
        else:
            got[p.name] = p.read_bytes()
    return got


def run(main, argv, inp: Path, out: Path, monkeypatch):
    """One command line: (outcome, stdout bytes, stderr with the output
    directory as {out}, the files written). The outcome is the exit code,
    or the SystemExit's message, or the error's type and message."""
    out.mkdir(parents=True, exist_ok=True)
    argv = [a.replace("{in}", str(inp)).replace("{out}", str(out)) for a in argv]
    so = io.TextIOWrapper(io.BytesIO(), encoding="utf-8", write_through=True)
    se = io.StringIO()
    monkeypatch.setattr(sys, "stdout", so)
    monkeypatch.setattr(sys, "stderr", se)
    try:
        outcome = ("rc", main(argv))
    except SystemExit as e:
        outcome = ("exit", str(e.code))
    except Exception as e:  # noqa: BLE001 - compared between the packages
        outcome = ("raised", type(e).__name__, str(e))
    finally:
        so.flush()
        monkeypatch.undo()
    return (outcome, so.buffer.getvalue(), se.getvalue().replace(str(out), "{out}"),
            _files(out))


def port_main(argv):
    return cli.main(["--device", "cpu", *argv])


def check_same(argv, inputs, tmp_path, monkeypatch, want_rc=0):
    want = run(jcli.main, argv, inputs, tmp_path / "jax", monkeypatch)
    got = run(port_main, argv, inputs, tmp_path / "torch", monkeypatch)
    for name, g, w in zip(("outcome", "stdout", "stderr", "files"), got, want):
        assert g == w, (name, argv)
    if want_rc is not None:
        assert want[0] == ("rc", want_rc), want
        assert want[1] or want[3], "the command wrote nothing"
    return got


CASES = {
    "count": [
        ["count", "{in}/reads.fq", "-k", "5"],  # an N: InvalidBase in both
        ["count", "{in}/reads.fq", "-k", "5", "--skip-invalid", "--canonical",
         "--out", "{out}/c.tsv"],
        ["count", "{in}/reads.fq", "-k", "21", "--skip-invalid", "--min-count", "2",
         "--top", "25"],
        ["count", "{in}/genome.fa", "-k", "13", "--canonical"],
        ["count", "{in}/clean.fq.gz", "-k", "4", "--batch-size", "64",
         "--checkpoint", "{out}/ck.npz"],
        ["count", "{in}/mystery", "-k", "8", "--devices", "1"],
    ],
    "spectrum": [
        ["spectrum", "{in}/reads.fq", "-k", "7", "--skip-invalid", "--max-mult", "20"],
        ["spectrum", "{in}/clean.fq", "-k", "17", "--out", "{out}/s.tsv"],
    ],
    "sketch": [
        ["sketch", "{in}/genome.fa", "{in}/clean.fq", "-k", "11", "-w", "5"],
        ["sketch", "{in}/genome.fa", "{in}/clean.fq", "{in}/clean2.fq", "-k", "21",
         "--canonical", "--out", "{out}/sk.tsv"],
        ["sketch", "{in}/clean.fq", "{in}/clean2.fq", "{in}/genome.fa"],
    ],
    "search": [
        ["search", "{in}/db.fq", "{in}/q10.fa", "--n-bases", "64", "-n", "3"],
        ["search", "{in}/db.npz", "{in}/q3.fa", "-n", "2"],
        ["search", "{in}/db.npz", "acgtACGTTTGA", "GGGGCCCCAAAATTTTGGGG", "-n", "4"],
        ["search", "{in}/db.fq", "{in}/q3.fa"],  # no --n-bases: the message
    ],
    "pack": [
        ["pack", "{in}/clean.fq", "-o", "{out}/p.npz"],
        ["pack", "{in}/genome.fa", "--out", "{out}/g.npz"],
    ],
    "unpack": [
        ["unpack", "{in}/clean.npz"],
        ["unpack", "{in}/clean.npz", "--limit", "7"],
    ],
    "setop": [
        ["setop", "union_sum", "{in}/clean.fq", "{in}/clean2.fq", "-k", "5"],
        ["setop", "subtract", "{in}/clean.fq", "{in}/genome.fa", "-k", "21", "--canonical",
         "--out", "{out}/so.tsv"],
        ["setop", "intersect_min", "{in}/clean.fq", "{in}/clean2.fq", "{in}/genome.fa",
         "-k", "15"],
        ["setop", "union_max", "{in}/reads.fq", "{in}/clean2.fq", "-k", "3",
         "--skip-invalid"],
    ],
    "gc": [
        ["gc", "{in}/genome.fa", "-w", "100"],
        ["gc", "{in}/clean.fq", "-w", "30", "--step", "10", "--out", "{out}/gc.tsv"],
    ],
    "revcomp": [
        ["revcomp", "{in}/clean.fq"],
        ["revcomp", "{in}/genome.fa", "--out", "{out}/rc.fa"],
    ],
    "stats": [
        ["stats", "{in}/clean.fq"],
        ["stats", "{in}/genome.fa", "--batch-size", "7"],
    ],
    "dedupe": [
        ["dedupe", "{in}/dups.fa"],
        ["dedupe", "{in}/clean.fq", "--out", "{out}/dd.fa"],
    ],
    "filter": [
        ["filter", "{in}/q.fq", "-o", "{out}/f.fq"],
        ["filter", "{in}/q.fq", "-o", "{out}/f.fq", "--min-len", "30", "--min-qual", "20",
         "--trim-qual", "15", "--max-n", "1", "--adapter", "AGATCGGAAGAGC",
         "--min-complexity", "0.3", "--min-entropy", "2.0"],
        ["filter", "{in}/q.fq", "-o", "{out}/f1.fq", "--paired", "{in}/q2.fq",
         "--out2", "{out}/f2.fq", "--trim-qual", "20", "--min-len", "25"],
        ["filter", "{in}/q.fq", "-o", "{out}/f1.fq", "--paired", "{in}/q2.fq"],
    ],
    "screen": [
        ["screen", "{in}/genome.fa", "{in}/clean.fq", "-k", "15", "--canonical"],
        ["screen", "{in}/genome.fa", "{in}/clean.fq", "-k", "11", "--min-frac", "0.5",
         "--out", "{out}/sc.tsv"],
        ["screen", "{in}/reads.fq", "{in}/clean.fq", "-k", "9", "--skip-invalid",
         "--min-count", "2"],
        ["screen", "{in}/genome.fa", "{in}/reads.fq", "-k", "15"],  # an N: InvalidBase
    ],
    "merge": [
        ["merge", "{in}/r1.fq", "{in}/r2.fq"],
        ["merge", "{in}/r1.fq", "{in}/r2.fq", "--unmerged", "{out}/u.fa", "--out",
         "{out}/m.fa", "--min-overlap", "15", "--max-mismatch-frac", "0.05"],
        ["merge", "{in}/r1.fq", "{in}/clean2.fq"],  # unequal counts: the message
    ],
    "demux": [
        ["demux", "{in}/dm.fq", "{in}/bc.tsv", "-o", "{out}/dm"],
        ["demux", "{in}/dm.fq", "{in}/bc.tsv", "--prefix", "{out}/t", "--trim",
         "--max-dist", "0"],
    ],
    "sample": [
        ["sample", "{in}/reads.fq", "0.3", "-s", "5"],
        ["sample", "{in}/genome.fa", "1", "--out", "{out}/s.fa"],
        ["sample", "{in}/clean.fq", "50"],
    ],
    "subseq": [
        ["subseq", "{in}/genome.fa", "c1:10-80"],
        ["subseq", "{in}/reads.fq", "r3", "--out", "{out}/ss.fa"],
        ["subseq", "{in}/genome.fa", "c9"],
    ],
    "orf": [
        ["orf", "{in}/genome.fa"],
        ["orf", "{in}/reads.fq", "--translate", "--min-len", "30"],
        ["orf", "{in}/reads.fa", "--translate", "--out", "{out}/o.tsv"],
    ],
    "correct": [
        ["correct", "{in}/reads.fq", "-k", "15"],
        ["correct", "{in}/reads.fq", "-k", "11", "--ref", "{in}/genome.fa", "--canonical",
         "--out", "{out}/c.fq"],
        ["correct", "{in}/reads.fa", "-k", "13", "--rounds", "2", "--min-count", "3"],
    ],
    "assemble": [
        ["assemble", "{in}/reads.fq", "-k", "21", "--skip-invalid"],
        ["assemble", "{in}/reads.fq", "-k", "21", "--skip-invalid", "--clean", "--gfa",
         "{out}/a.gfa", "--out", "{out}/a.fa"],
        ["assemble", "{in}/clean.fq", "-k", "11", "--strand-specific", "--min-count", "1",
         "--clean", "--tip-len", "30"],
        ["assemble", "{in}/genome.fa", "-k", "31", "--gfa", "{out}/g.gfa"],
        ["assemble", "{in}/clean.fq", "-k", "7", "--min-count", "3"],
    ],
    "qc": [
        ["qc", "{in}/q.fq"],
        ["qc", "{in}/q.fq", "--compact", "--strict", "--batch-size", "50", "--out",
         "{out}/q.json"],
    ],
}
# argument sets that end otherwise than with exit code 0 and output: in a
# message or an error (None), or with qc --strict's exit code 1
EXITS = {("count", 0): None, ("search", 3): None, ("filter", 3): None, ("screen", 3): None,
         ("merge", 2): None, ("subseq", 2): None, ("qc", 1): 1}


@pytest.mark.parametrize("command,i", [(c, i) for c in CASES for i in range(len(CASES[c]))])
def test_command_matches_jax(inputs, tmp_path, monkeypatch, command, i):
    check_same(CASES[command][i], inputs, tmp_path, monkeypatch,
               want_rc=EXITS.get((command, i), 0))


def test_every_command_is_covered():
    """The two files cover the 24 subcommands other than info."""
    from test_torch_cli_map import MAP_CASES

    names = set(cli.build_parser()._subparsers._group_actions[0].choices)
    assert names == set(jcli.build_parser()._subparsers._group_actions[0].choices)
    assert names - {"info"} == set(CASES) | set(MAP_CASES) and len(names) == 25


def test_parsers_match_jax():
    """Each subcommand's options: the same flags, defaults and help."""
    def spec(parser):
        sub = parser._subparsers._group_actions[0].choices
        return {name: sorted((tuple(a.option_strings), a.dest, repr(a.default), a.nargs,
                              a.help) for a in p._actions if a.dest != "devices")
                for name, p in sub.items() if name != "info"}

    assert spec(cli.build_parser()) == spec(jcli.build_parser())


# --devices 8: the JAX CLI on its 8-device CPU mesh, the port's on 8 CPU
# shards (--device cpu); the databases, batches and contigs divide no mesh
DEVICES_CASES = [
    ["count", "{in}/reads.fq", "-k", "5", "--skip-invalid", "--batch-size", "50"],
    ["count", "{in}/reads.fq", "-k", "21", "--skip-invalid", "--batch-size", "50"],
    ["count", "{in}/genome.fa", "-k", "21"],
    ["count", "{in}/genome.fa", "-k", "9", "--canonical"],
    ["search", "{in}/db.fq", "{in}/q10.fa", "--n-bases", "64", "-n", "3"],
    ["search", "{in}/db.npz", "{in}/q3.fa", "-n", "2"],
    ["map", "{in}/genome.fa", "{in}/reads.fa", "--no-cigar"],
    ["map", "{in}/genome.fa", "{in}/long.fq", "--long", "--all"],
    ["map", "{in}/genome.fa", "{in}/long.fq", "--long", "--extend"],
    ["assemble", "{in}/clean.fq", "-k", "21"],
]


@pytest.mark.parametrize("i", range(len(DEVICES_CASES)))
def test_devices_8_matches_jax(inputs, tmp_path, monkeypatch, i):
    argv = DEVICES_CASES[i] + ["--devices", "8"]
    got = check_same(argv, inputs, tmp_path, monkeypatch)
    one = run(port_main, DEVICES_CASES[i], inputs, tmp_path / "one", monkeypatch)
    assert got[:3] == one[:3]


def test_devices_n_on_the_card_needs_n_cards(inputs):
    """--devices N on CUDA takes the first N distinct cards and exits
    naming the visible count when fewer are seen; 0 and 1 build no mesh."""
    from types import SimpleNamespace

    seen = torch.cuda.device_count()
    n = max(2, seen + 1)
    with pytest.raises(SystemExit, match=f"only {seen} device"):
        cli._build_mesh(SimpleNamespace(devices=n, device=torch.device("cuda")))
    for d in (None, 0, 1):
        assert cli._build_mesh(SimpleNamespace(devices=d, device=torch.device("cpu"))) is None
    m = cli._build_mesh(SimpleNamespace(devices=3, device=torch.device("cpu")))
    assert m.shape == {"data": 3} and m.flat_devices == [torch.device("cpu")] * 3


def test_no_card_and_no_device_exits_before_any_work(inputs, monkeypatch):
    """Without CUDA and without --device the command exits non-zero with
    resolve_device's message and reads nothing; --device cuda raises
    rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    def refuse(*args, **kwargs):
        raise AssertionError("a command ran without a device")

    monkeypatch.setattr(cli, "_sniff_format", refuse)
    for argv in (["count", str(inputs / "clean.fq"), "-k", "5"],
                 ["assemble", str(inputs / "clean.fq"), "-k", "9"],
                 ["sample", str(inputs / "clean.fq"), "3"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code != 0 and "no CUDA device" in str(e.value.code)
    monkeypatch.undo()
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["--device", "cuda", "count", str(inputs / "clean.fq"), "-k", "5"])


def test_info_json(capsys):
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    want = "cuda" if torch.cuda.is_available() else None
    assert info == {"backend": "auto", "device": want, "devices": torch.cuda.device_count(),
                    "native": native.available()}
    assert cli.main(["--device", "cpu", "info"]) == 0
    assert json.loads(capsys.readouterr().out)["device"] == "cpu"


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_python_m_in_a_fresh_process(inputs):
    """__main__ in a fresh process, without jax: info and one count."""
    code = ("import runpy, sys; sys.argv = ['bitnuc_tpu_torch'] + sys.argv[1:]; "
            "runpy.run_module('bitnuc_tpu_torch', run_name='__main__')")
    for argv, check in ((["--device", "cpu", "info"], lambda o: json.loads(o)["device"] == "cpu"),
                        (["--device", "cpu", "count", str(inputs / "mystery"), "-k", "8"],
                         lambda o: o.count("\n") == 193)):
        r = subprocess.run([sys.executable, "-c", code, *argv], env=_env(), cwd=inputs,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0 and check(r.stdout), r.stderr
    r = subprocess.run([sys.executable, "-m", "bitnuc_tpu_torch", "--device", "cpu", "info"],
                       env=_env(), cwd=inputs, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and json.loads(r.stdout)["backend"] == "auto", r.stderr


def test_head_ends_quietly(inputs):
    """A reader that closes the pipe early (``| head``): exit 0, nothing
    on stderr."""
    r = subprocess.run(
        ["bash", "-c", "set -o pipefail; " + sys.executable + " -m bitnuc_tpu_torch --device cpu"
         f" count {inputs / 'clean.fq'} -k 10 | head -n 2"],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.count("\n") == 2 and r.stderr == "", r.stderr
