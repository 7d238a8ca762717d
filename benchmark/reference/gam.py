"""A plain reader of one GAM record (vg's Alignment message), for the
fields the reference judges: sequence (1), path (2) of mappings, each a
position (node id 1, offset 2, is_reverse 4) and edits (from_length 1,
to_length 2, sequence 3); name (3), quality (4), mapping quality (5),
score (6). Protobuf's wire format, written from its specification."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


def _varint(b: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        c = b[i]
        i += 1
        out |= (c & 0x7F) << shift
        if not c & 0x80:
            return out, i
        shift += 7


def fields(b: bytes):
    """(field number, wire type, value) of each field of a message;
    length-delimited values as bytes."""
    i, n = 0, len(b)
    while i < n:
        key, i = _varint(b, i)
        f, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _varint(b, i)
        elif wt == 2:
            ln, i = _varint(b, i)
            v = bytes(b[i : i + ln])
            i += ln
        elif wt == 1:
            v = bytes(b[i : i + 8])
            i += 8
        elif wt == 5:
            v = bytes(b[i : i + 4])
            i += 4
        else:
            raise ValueError(f"wire type {wt}")
        yield f, wt, v


@dataclass
class Edit:
    from_length: int = 0
    to_length: int = 0
    sequence: str = ""


@dataclass
class Mapping:
    node_id: int = 0
    offset: int = 0
    is_reverse: bool = False
    edits: List[Edit] = field(default_factory=list)


@dataclass
class Record:
    name: str = ""
    sequence: str = ""
    mapq: int = 0
    score: int = 0
    mappings: List[Mapping] = field(default_factory=list)
    has_path: bool = False


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def decode(b: bytes) -> Record:
    r = Record()
    for f, wt, v in fields(b):
        if f == 1 and wt == 2:
            r.sequence = v.decode()
        elif f == 2 and wt == 2:
            r.has_path = True
            for pf, pwt, pv in fields(v):
                if pf != 2 or pwt != 2:
                    continue
                m = Mapping()
                for mf, mwt, mv in fields(pv):
                    if mf == 1 and mwt == 2:
                        for qf, _, qv in fields(mv):
                            if qf == 1:
                                m.node_id = qv
                            elif qf == 2:
                                m.offset = qv
                            elif qf == 4:
                                m.is_reverse = bool(qv)
                    elif mf == 2 and mwt == 2:
                        e = Edit()
                        for ef, _, ev in fields(mv):
                            if ef == 1:
                                e.from_length = ev
                            elif ef == 2:
                                e.to_length = ev
                            elif ef == 3:
                                e.sequence = ev.decode()
                        m.edits.append(e)
                r.mappings.append(m)
        elif f == 3 and wt == 2:
            r.name = v.decode()
        elif f == 5 and wt == 0:
            r.mapq = v
        elif f == 6 and wt == 0:
            r.score = _signed(v)
    return r
