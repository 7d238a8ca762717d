"""The readers of the program's own spans (metrics/sr.seed_us_per_read,
sr.score_offcpu_pct, sr.score_blocked_us_per_read,
sr.emit_starved_us_per_read, sr.cap_offcpu_us_per_read) on hand-made
layers: each value from the stage seconds it reads, and None where the
program has no such span (a build before the spans were added)."""
from __future__ import annotations

import pytest

import tiny  # noqa: F401  (puts benchmark/ and the repo on the path)
import harness

DELTA = {"score": 2.0, "score.cpu": 1.5, "score.seed": 0.4,
         "wait.score_out": 0.01, "wait.emit_in": 0.3,
         "cap.begin": 0.5, "cap.begin.cpu": 0.2, "cap.apply": 0.1,
         "cap.apply.cpu": 0.05, "cap.wait": 0.02,
         "rescue": 1.0, "emit": 3.0, "dev_wait": 0.001}
READS = 100_000

# reader: (its value on DELTA and READS, the keys it reads)
WANT = {
    "sr.seed_us_per_read": (4.0, ("score.seed",)),
    "sr.score_offcpu_pct": (25.0, ("score", "score.cpu")),
    "sr.score_blocked_us_per_read": (0.1, ("wait.score_out",)),
    "sr.emit_starved_us_per_read": (3.0, ("wait.emit_in",)),
    "sr.cap_offcpu_us_per_read": (
        3.3, ("cap.begin", "cap.begin.cpu", "cap.apply", "cap.apply.cpu",
              "cap.wait")),
}


def reader(name):
    return harness.load_module(tiny.BENCH / "metrics" / f"{name}.py",
                               f"reader_{name}")


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value(name):
    got = reader(name).read({"stage_delta": dict(DELTA), "reads": READS})
    assert got == pytest.approx(WANT[name][0], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_without_its_keys(name):
    """Each key it reads left out in turn (the parent program's
    stage_seconds has only score, rescue, emit and dev_wait), and no
    reads: None, not an exception."""
    mod = reader(name)
    for key in WANT[name][1]:
        d = {k: v for k, v in DELTA.items() if k != key}
        assert mod.read({"stage_delta": d, "reads": READS}) is None
    old = {k: DELTA[k] for k in ("score", "rescue", "emit", "dev_wait")}
    assert mod.read({"stage_delta": old, "reads": READS}) is None
    if name.endswith("_per_read"):
        assert mod.read({"stage_delta": dict(DELTA), "reads": 0}) is None
    assert mod.read({}) is None


def test_offcpu_share_none_without_score_time():
    d = dict(DELTA, score=0.0, **{"score.cpu": 0.0})
    assert reader("sr.score_offcpu_pct").read(
        {"stage_delta": d, "reads": READS}) is None


def test_listed_for_the_short_read_cell():
    """Each reader has its BENCHMARK.json entry, a program span's metric
    of the short-read cell that moves its rate."""
    import json

    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["moves"] == "sr_reads_per_s"
        assert m["workloads"] == ["giraffe-sr.fastq"]
