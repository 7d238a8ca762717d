"""The port's command line against vg_tpu's, alignment tools: surject to
SAM, BAM and CRAM, pack, call, depth, sim, gamcompare (with the distance
index), gampcompare, gamsort (indexed, external), find -l, filter, stats
-a, inject from SAM and BAM, annotate, vectorize, augment, translate,
genotype, mcmc and viz's SVG, on alignments that vg_tpu's CLI made from
the fixture (tests/cli_cases.py); outputs compared exactly. Also the
three copied modules that no subcommand imports (index/registry,
utils/runtime, utils/benchmark) against vg_tpu's."""
import io

import numpy as np
import pytest
import torch

import cli_cases

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("VGTPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_tools")
    p = cli_cases.build_fixture(d)
    return cli_cases.build_derived(d, p)


@pytest.mark.parametrize("argv,opts", [c[1:] for c in cli_cases.TOOL_CASES],
                         ids=[c[0] for c in cli_cases.TOOL_CASES])
def test_tool_subcommand_parity(fx, tmp_path, capsysbinary, argv, opts):
    cli_cases.run_case(capsysbinary, tmp_path, fx, argv, opts)


def test_index_registry_recipes_build_the_same_bundle(fx, tmp_path):
    """index/registry: the default giraffe recipes, solved and run from
    the fixture's FASTA and VCF by each package, plan alike and write the
    same arrays; a second plan finds everything on disk."""
    from vg_tpu.index.registry import IndexRegistry as JaxRegistry
    from vg_tpu_torch.index.registry import IndexRegistry

    regs = []
    for tag, R in (("jax", JaxRegistry), ("torch", IndexRegistry)):
        reg = R(str(tmp_path / tag / "r"))
        (tmp_path / tag).mkdir()
        reg.provide("reference", fx["fa"])
        reg.provide("vcf", fx["vcf"])
        targets = R.giraffe_targets()
        assert [r.output for r in reg.plan(targets)] == targets
        assert reg.make(targets) == [
            "construct graph from FASTA+VCF", "thread sample haplotypes",
            "build minimizer index"]
        assert reg.plan(targets) == []
        regs.append(reg)
    for art in ("graph", "haplotypes", "minimizer"):
        a = cli_cases.npz_arrays(open(regs[0].path(art), "rb").read())
        b = cli_cases.npz_arrays(open(regs[1].path(art), "rb").read())
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=art)


def test_runtime_logger_crash_context_and_watchdog():
    import time

    from vg_tpu.utils import runtime as jax_rt
    from vg_tpu_torch.utils import runtime as rt

    outs = []
    for mod in (jax_rt, rt):
        buf = io.StringIO()
        log = mod.Logger("vg_tpu giraffe", stream=buf)
        log.info("start")
        log.warn("slow")
        log.error("bad")
        mod.set_crash_context("read r7")
        with pytest.raises(AssertionError) as e:
            mod.crash_unless(False, "length")
        mod.set_crash_context(None)
        wbuf = io.StringIO()
        with mod.Watchdog(0.05, mod.Logger("wd", stream=wbuf)) as wd:
            wd.check_out(wd.check_in("fast"))
            wd.check_in("batch 3")
            time.sleep(0.3)
        assert wd.warnings == 1
        warn = wbuf.getvalue()
        assert warn.startswith("warning[wd]: task 'batch 3' has been "
                               "running for ") and warn.endswith(
                                   "s (> 0s)\n")
        outs.append((buf.getvalue(), str(e.value)))
    assert outs[1] == outs[0] == (
        "info[vg_tpu giraffe]: start\nwarning[vg_tpu giraffe]: slow\n"
        "error[vg_tpu giraffe]: bad\n", "length violated while processing "
        "read r7")


def test_benchmark_harness_runs_and_reports_alike():
    from vg_tpu.utils import benchmark as jax_bm
    from vg_tpu_torch.utils import benchmark as bm

    rows = []
    for mod in (jax_bm, bm):
        calls = []
        res = mod.run_benchmark("count", lambda: calls.append(1),
                                iterations=25)
        assert len(calls) == 26 and res.iterations == 25
        assert res.seconds > 0 and res.control_seconds > 0
        fixed = mod.BenchmarkResult("dp", 200, 0.5, 0.01)
        rows.append((fixed.line(), fixed.per_iteration,
                     fixed.normalized_score))
    assert rows[1] == rows[0] == ("dp\t200 iters\t2500.00 us/iter\t"
                                  "score 4.0", 0.0025, 4.0)
