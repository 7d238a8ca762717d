"""The reader metrics/sr.emit_native_share on hand-made layers: the
native rows' share of the rows counted, a missing counter read as none
of its rows, and None where the program keeps neither counter (a build
before the native record writer) or counted no row."""
from __future__ import annotations

import json

import pytest

import tiny
import harness

NAME = "sr.emit_native_share"


def read(delta):
    mod = harness.load_module(tiny.BENCH / "metrics" / f"{NAME}.py",
                              "reader_emit_native_share")
    return mod.read({"stage_delta": delta, "reads": 1000})


@pytest.mark.parametrize("delta, want", [
    ({"emit.rows_native": 990.0, "emit.rows_fallback": 10.0}, 0.99),
    ({"emit.rows_native": 1000.0}, 1.0),
    ({"emit.rows_fallback": 1000.0}, 0.0),
])
def test_share(delta, want):
    assert read(dict(delta, emit=3.0)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("delta", [
    {"emit": 3.0, "score": 2.0},
    {"emit.rows_native": 0.0, "emit.rows_fallback": 0.0},
    {},
])
def test_none(delta):
    assert read(delta) is None


def test_listed_for_the_short_read_cell():
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    m = {m["name"]: m for m in bench["per_layer"]}[NAME]
    assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "program_counter", "host rescue and emit", "sr_reads_per_s",
        ["giraffe-sr.fastq"])
