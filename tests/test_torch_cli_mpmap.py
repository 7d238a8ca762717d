"""The port's command line against vg_tpu's, the subcommands that map
besides giraffe: map with and without -A (the MEM mapper; the suffix
array each builds and caches), mpmap (single-end, -2, -A, and reads
across a novel splice junction, single-end and paired), mapeval,
benchmark, cluster and haplotypes (from reads, recombined, from KFF kmer
counts), on the fixture of tests/cli_cases.py with VGTPU_PLATFORM=cpu:
outputs compared exactly."""
import pytest
import torch

import cli_cases
from vg_tpu_torch.cli.main import main as torch_main

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("VGTPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_mpmap")
    return cli_cases.build_fixture(d)


@pytest.mark.parametrize("argv,opts", [c[1:] for c in cli_cases.MPMAP_CASES],
                         ids=[c[0] for c in cli_cases.MPMAP_CASES])
def test_mpmap_subcommand_parity(fx, tmp_path, capsysbinary, argv, opts):
    cli_cases.run_case(capsysbinary, tmp_path, fx, argv, opts)


def test_mpmap_spliced_read_has_a_connection(fx, tmp_path):
    from vg_tpu_torch.io.gamp import read_gamp

    out = tmp_path / "s.gamp"
    assert torch_main(["mpmap", "-Z", fx["sx"], "-f", fx["spliced"],
                       "--output", str(out)]) == 0
    mps = {mp.name: mp for mp in read_gamp(str(out))}
    assert len(mps) == 8
    sp = mps["spliced1"]
    assert len(sp.subpaths) == 2 and sp.subpaths[0].connection[0].next == 1


def test_mpmap_paired_spliced_mate_has_a_connection(fx, tmp_path):
    from vg_tpu_torch.io.gamp import read_gamp

    out = tmp_path / "s2.gamp"
    assert torch_main(["mpmap", "-Z", fx["sx"], "-f", fx["spliced1"], "-2",
                       fx["spliced2"], "--output", str(out)]) == 0
    mps = list(read_gamp(str(out)))
    assert len(mps) == 16
    sp, mate = mps[0], mps[1]
    assert sp.name == mate.paired_read_name == "spliced1"
    assert len(sp.subpaths) == 2 and sp.subpaths[0].connection[0].next == 1
    assert mate.subpaths
