"""bitnuc_tpu_torch.cli against bitnuc_tpu.cli, byte for byte, for the
mapping commands: map (PAF, --sam, --paired --sam, --long with and without
--extend, --index), call (gapless and --cigar, VCF, consensus and depth
files) and align (local, fit, global and edit). The inputs and the
comparison are test_torch_cli.py's."""

import pytest
import torch

from test_torch_cli import check_same, make_inputs

torch.set_num_threads(1)

MAP_CASES = {
    "map": [
        ["map", "{in}/genome.fa", "{in}/reads.fq"],
        ["map", "{in}/genome.fa", "{in}/reads.fq", "--sam", "--index", "{out}/ix.npz"],
        ["map", "{in}/genome.fa", "{in}/reads.fa", "--all", "--no-cigar", "-k", "13",
         "-w", "7", "--max-occ", "4", "--min-seeds", "3", "--out", "{out}/m.paf"],
        ["map", "{in}/genome.fa", "{in}/r1.fq", "--paired", "{in}/r2.fq", "--sam",
         "--max-insert", "200"],
        ["map", "{in}/genome.fa", "{in}/long.fq", "--long", "--all"],
        ["map", "{in}/genome.fa", "{in}/long.fq", "--long", "--extend"],
        ["map", "{in}/genome.fa", "{in}/long.fq", "--long", "--sam", "--extend"],
        ["map", "{in}/genome.fa", "{in}/r1.fq", "--paired", "{in}/r2.fq"],
        ["map", "{in}/genome.fa", "{in}/long.fq", "--long", "--sam"],
    ],
    "call": [
        ["call", "{in}/genome.fa", "{in}/reads.fq"],
        ["call", "{in}/genome.fa", "{in}/reads.fq", "--vcf", "--consensus", "{out}/c.fa",
         "--depth", "{out}/d.bg", "--min-depth", "3"],
        ["call", "{in}/genome.fa", "{in}/reads.fq", "--cigar", "--vcf", "--out",
         "{out}/v.vcf"],
        ["call", "{in}/genome.fa", "{in}/reads.fq", "--cigar", "--min-frac", "0.3"],
    ],
    "align": [
        ["align", "{in}/q3.fa", "{in}/q10.fa"],  # 3 queries vs 10 targets: the message
        ["align", "{in}/q10.fa", "ACGTTGCAACGTAGGCTTAACGGATCCAGT"],
        ["align", "{in}/q10.fa", "{in}/q10.fa", "--mode", "fit", "--mismatch-cost", "2"],
        ["align", "ACGTTGCAAC", "ACGTGCAACGTT", "--mode", "global", "--gap-cost", "3"],
        ["align", "{in}/reads.fa", "{in}/mystery", "--mode", "edit"],
        ["align", "{in}/q3.fa", "{in}/q3.fa", "--mode", "local", "--match", "3",
         "--mismatch", "-1", "--gap-open", "-4", "--gap-extend", "-1", "--out",
         "{out}/al.tsv"],
    ],
}
EXITS = {("map", 7), ("map", 8), ("align", 0)}  # a message in both packages


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    make_inputs(d)
    return d


@pytest.mark.parametrize("command,i", [(c, i) for c in MAP_CASES
                                       for i in range(len(MAP_CASES[c]))])
def test_mapping_command_matches_jax(inputs, tmp_path, monkeypatch, command, i):
    check_same(MAP_CASES[command][i], inputs, tmp_path, monkeypatch,
               want_rc=None if (command, i) in EXITS else 0)
