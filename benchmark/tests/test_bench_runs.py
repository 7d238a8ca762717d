"""The harness's whole path on the CPU at a tiny size: a sound run is
correct, the control is not, and a run whose timed path is broken is not;
nothing of JAX or the JAX package is loaded; the reference imports
nothing of the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
import faults
import harness
from spans import Tracer

torch.set_num_threads(1)
CELLS = ["giraffe-sr.fastq", "giraffe-hifi.hifi"]


def pieces(ctx):
    """Set-up, window and release as a run makes them; the configuration's
    module, the state and the window for the judge."""
    cfg_mod = harness.load_module(
        tiny.BENCH / "configs" / f"{ctx.cell['config']}.py",
        f"bench_config_{ctx.cell['config']}")
    ctx.tracer = Tracer(ctx.trace)
    state = cfg_mod.setup(ctx)
    win = cfg_mod.window(ctx, state)
    cfg_mod.release(state)
    return cfg_mod, state, win


def failing(checks):
    return [n for n, v, lim in checks if not harness.ok(v, lim)]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_control_is_not(workload):
    ctx = tiny.context(workload, seed=21)
    cfg_mod, state, win = pieces(ctx)
    assert failing(cfg_mod.judge(ctx, state, win)) == []
    bad = failing(cfg_mod.judge(ctx, state, win, control=True))
    assert bad == (["cap_gap_phred"] if "sr" in workload
                   else ["score_differs"])


@pytest.mark.parametrize("workload", CELLS)
def test_whole_run_reports_its_metrics(workload):
    ctx = tiny.context(workload, seed=22)
    out = harness.run(ctx)
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 0
    e2e, _ = harness.cell_metrics(ctx.notes["bench"], ctx.cell)
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


# what each planted fault must fail
CAUGHT_BY = {"altered": {"score_differs"}, "half": {"records_missing"},
             "unmapped": {"misplaced_share"},
             "swapped": {"path_invalid", "misplaced_share"}}


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(workload, kind):
    ctx = tiny.context(workload, seed=23)
    with faults.planted(kind, ctx.cell["config"]):
        out = harness.run(ctx)
    assert out["correct"] is False
    bad = {n for n, c in out["checks"].items()
           if not harness.ok(c["value"], c["limit"])}
    assert bad & CAUGHT_BY[kind]


def test_no_jax_in_a_run():
    """A tiny cell's harness path in a fresh process loads the port and
    no module whose top-level name is jax, jaxlib, flax or vg_tpu."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(tiny.BENCH / 'tests')!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "import tiny, harness\n"
        "out = harness.run(tiny.context('giraffe-sr.fastq', seed=24))\n"
        "tops = sorted({m.split('.', 1)[0] for m in sys.modules})\n"
        "print(json.dumps({'correct': out['correct'], 'tops': tops,\n"
        "                  'bad': harness.forbidden_modules()}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tiny.ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "vg_tpu_torch" in got["tops"]
    assert got["bad"] == []
    assert not {"jax", "jaxlib", "flax", "vg_tpu"} & set(got["tops"])


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "vg_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert "vg_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "vg_tpu.io", object())
    assert "vg_tpu" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    """benchmark/reference/ imports only itself, numpy and the standard
    library: by its source, and in a fresh process."""
    ref = tiny.BENCH / "reference"
    for f in ref.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] in {"numpy", "dataclasses", "typing",
                                           "__future__", "math"}, (f, n)
    code = (f"import sys; sys.path.insert(0, {str(tiny.BENCH)!r})\n"
            "import reference.graph, reference.dp, reference.cap, "
            "reference.gam, reference.judge, reference.alleles\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    tops = set(ast.literal_eval(res.stdout.strip()))
    assert not {"vg_tpu_torch", "vg_tpu", "torch", "jax"} & tops


def test_no_cuda_exits_without_result():
    """run.py without a card: exit 2, no result line."""
    res = subprocess.run(
        [sys.executable, str(tiny.BENCH / "run.py"), "--workload",
         "giraffe-sr.fastq", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=120,
        cwd=str(tiny.ROOT), env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert res.returncode == 2
    assert res.stdout.strip() == ""


@pytest.mark.gpu
def test_card_run_is_correct():
    """On the card: one short traced run of the short-read cell at a test
    size reports every per-layer metric it lists, each share under 100%."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    ctx = tiny.context("giraffe-sr.fastq", seed=25, seconds=3.0, trace=True)
    ctx.device = "cuda"
    ctx.traffic.update(batch_pairs=512, pool_batches=4)
    ctx.config["ref_length_bp"] = 400_000
    out = harness.run(ctx)
    assert out["correct"] is True
    _, per_layer = harness.cell_metrics(ctx.notes["bench"], ctx.cell)
    assert set(out["metrics"]) == {m["name"] for m in per_layer}
    for name, m in out["metrics"].items():
        if name.endswith("roofline_pct"):
            assert 0 < m["value"] <= 100
    assert np.isfinite(out["device"]["busy_s"])


def test_traffic_without_qualities():
    """A mix without qualities (a FASTA cell) needs data only: the pairs
    carry no quality strings, errors come at the mix's rate, and the cap,
    which such reads bypass, is not compared."""
    ctx = tiny.context("giraffe-sr.fastq", seed=26)
    ctx.traffic.update(qualities=None, error_rate=0.01)
    out = harness.run(ctx)
    assert out["correct"] is True
    assert "cap_gap_phred" not in out["checks"]
    assert out["checks"]["dp_slots_differ"]["value"] == 0
