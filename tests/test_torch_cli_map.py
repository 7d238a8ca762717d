"""The port's command line against vg_tpu's, giraffe: GAM, GAF, JSON and
SAM out; single-end, paired -2 and interleaved -i; -G, --kff-name, the
hifi and fast presets, --track-provenance, --sweep, --comments-as-tags,
and a GBZ index from autoindex --gbz-out, on the fixture of
tests/cli_cases.py with VGTPU_PLATFORM=cpu: outputs compared exactly.
Then the platform rule: unset means the card, which fails where there is
none and writes no GAM; an unknown value exits 2."""
import pytest
import torch

import cli_cases
from vg_tpu_torch.cli.main import main as torch_main

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    from vg_tpu.cli.main import main as jax_main

    d = tmp_path_factory.mktemp("cli_map")
    p = cli_cases.build_fixture(d)
    p["truth"] = str(d / "truth.gam")
    assert jax_main(["sim", "-Z", p["x"], "-n", "80", "-l", "120", "-e",
                     "0.01", "-s", "5", "-a", "--output", p["truth"]]) == 0
    return p


@pytest.mark.parametrize("argv,opts", [c[1:] for c in cli_cases.MAP_CASES],
                         ids=[c[0] for c in cli_cases.MAP_CASES])
def test_map_subcommand_parity(fx, tmp_path, capsysbinary, monkeypatch,
                               argv, opts):
    monkeypatch.setenv("VGTPU_PLATFORM", "cpu")
    cli_cases.run_case(capsysbinary, tmp_path, fx, argv, opts)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the error where CUDA is absent")
def test_unset_platform_is_the_card_and_fails_without_cuda(
        fx, tmp_path, monkeypatch):
    monkeypatch.delenv("VGTPU_PLATFORM", raising=False)
    for argv in (["giraffe", "-Z", fx["x"], "-f", fx["reads"]],
                 ["giraffe", "-Z", fx["x"], "-f", fx["r1"], "-2", fx["r2"]],
                 ["map", "-A", "-Z", fx["x"], "-f", fx["reads"]],
                 ["mpmap", "-Z", fx["x"], "-f", fx["reads"]]):
        out = tmp_path / f"{argv[0]}{len(argv)}.gam"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_main(argv + ["--output", str(out)])
        assert not out.exists()


def test_platform_cpu_maps_on_the_cpu(fx, tmp_path, monkeypatch):
    from vg_tpu_torch.io.gam import read_gam

    monkeypatch.setenv("VGTPU_PLATFORM", "cpu")
    out = tmp_path / "g.gam"
    assert torch_main(["giraffe", "-Z", fx["x"], "-f", fx["reads"],
                       "--output", str(out)]) == 0
    alns = list(read_gam(str(out)))
    assert len(alns) == cli_cases.N_READS
    assert sum(1 for a in alns if a.path and a.path.mappings) >= 0.9 * len(
        alns)


@pytest.mark.parametrize("plat", ["tpu", "CUDA", "cpu0"])
def test_unknown_platform_exits_2(fx, tmp_path, monkeypatch, capsys, plat):
    monkeypatch.setenv("VGTPU_PLATFORM", plat)
    out = tmp_path / "g.gam"
    assert torch_main(["giraffe", "-Z", fx["x"], "-f", fx["reads"],
                       "--output", str(out)]) == 2
    assert "VGTPU_PLATFORM" in capsys.readouterr().err
    assert not out.exists()
