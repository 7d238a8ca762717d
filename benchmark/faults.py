"""Faults planted in the port's timed path, under the harness: each
breaks what the timed path hands back, where it is produced. The tests
run whole tiny runs with each planted and see `correct` come out false;
control.py reads them on the card at a cell's size.

    altered    each mapped record's score one higher
    half       half of each batch's records left out
    unmapped   each record emitted without a path (score and MAPQ 0)
    swapped    each two records in turn emitted under each other's name
               (a pair's two mates)
"""
from __future__ import annotations

import contextlib

KINDS = ("altered", "half", "unmapped", "swapped")


def broken(kind: str, recs) -> list:
    """The records of one batch as the fault leaves them."""
    from vg_tpu_torch.io.gam import Alignment

    if recs is None:
        return recs
    recs = [r for r in recs if r is not None]
    if kind == "half":
        return recs[: len(recs) // 2]
    alns = [Alignment.decode(bytes(r)) for r in recs]
    if kind == "altered":
        for a in alns:
            if a.path is not None:
                a.score += 1
    elif kind == "unmapped":
        for a in alns:
            a.path, a.score, a.mapping_quality = None, 0, 0
            a.refpos = []
    elif kind == "swapped":
        for a, b in zip(alns[0::2], alns[1::2]):
            a.name, b.name = b.name, a.name
    else:
        raise ValueError(kind)
    return [a.encode() for a in alns]


def target(config: str):
    """(class, method) whose return value is a batch's records."""
    if config == "giraffe-sr":
        from vg_tpu_torch.map.paired import PairedGiraffeMapper

        return PairedGiraffeMapper, "stage_emit"
    from vg_tpu_torch.map.longread import LongReadMapper

    return LongReadMapper, "map_batch_encoded"


@contextlib.contextmanager
def planted(kind: str, config: str):
    """The fault in place until the block ends."""
    cls, attr = target(config)
    orig = getattr(cls, attr)

    def call(self, *a, **kw):
        return broken(kind, orig(self, *a, **kw))

    setattr(cls, attr, call)
    try:
        yield
    finally:
        setattr(cls, attr, orig)
