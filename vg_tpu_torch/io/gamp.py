"""GAMP: MultipathAlignment data model + codec.

Reference: multipath alignments are alignment DAGs — subpaths (each a
Path with a score) joined by `next` edges, with entry points in `start`
(src/multipath_alignment.{hpp,cpp}, SURVEY.md Appendix E). Field numbers
follow libvgio's vg.proto layout for MultipathAlignment/Subpath; the
wire framing reuses the GAM container with the "GAMP" type tag.

Copied from vg_tpu/io/gamp.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import BinaryIO, Iterable, Iterator, List, Optional

from .gam import Alignment, Path, read_messages, write_messages
from .wire import (field_bytes, field_str, field_varint, iter_fields,
                   signed64)


@dataclass(slots=True)
class Connection:
    """Non-contiguous subpath link (a splice junction): the reference's
    multipath Connection edge (spliced alignment in multipath_mapper;
    vg.proto Connection {next, score})."""
    next: int = 0                      # field 1: target subpath index
    score: int = 0                     # field 2: junction score

    def encode(self) -> bytes:
        out = bytearray()
        if self.next:
            out += field_varint(1, self.next)
        if self.score:
            out += field_varint(2, self.score & 0xFFFFFFFFFFFFFFFF
                                if self.score >= 0 else
                                self.score + (1 << 64))
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Connection":
        c = cls()
        for f, wt, v in iter_fields(buf):
            if f == 1:
                c.next = v
            elif f == 2:
                c.score = signed64(v)
        return c

    def to_json(self) -> dict:
        return {"next": self.next, "score": self.score}


@dataclass(slots=True)
class Subpath:
    path: Optional[Path] = None        # field 1
    next: List[int] = dfield(default_factory=list)   # field 2 (indices)
    score: int = 0                     # field 3
    connection: List[Connection] = dfield(default_factory=list)  # field 4

    def encode(self) -> bytes:
        out = bytearray()
        if self.path is not None:
            out += field_bytes(1, self.path.encode())
        for n in self.next:
            out += field_varint(2, n)
        if self.score:
            out += field_varint(3, self.score & 0xFFFFFFFFFFFFFFFF
                                if self.score >= 0 else
                                self.score + (1 << 64))
        for c in self.connection:
            out += field_bytes(4, c.encode())
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "Subpath":
        sp = cls()
        for f, wt, v in iter_fields(buf):
            if f == 1:
                sp.path = Path.decode(bytes(v))
            elif f == 2:
                sp.next.append(v)
            elif f == 3:
                sp.score = signed64(v)
            elif f == 4:
                sp.connection.append(Connection.decode(bytes(v)))
        return sp

    def to_json(self) -> dict:
        d = {}
        if self.path is not None:
            d["path"] = self.path.to_json()
        if self.next:
            d["next"] = self.next
        if self.score:
            d["score"] = self.score
        if self.connection:
            d["connection"] = [c.to_json() for c in self.connection]
        return d


@dataclass(slots=True)
class MultipathAlignment:
    sequence: str = ""                 # field 1
    quality: bytes = b""               # field 2
    name: str = ""                     # field 3
    sample_name: str = ""              # field 4
    read_group: str = ""               # field 5
    subpaths: List[Subpath] = dfield(default_factory=list)  # field 6
    mapping_quality: int = 0           # field 7
    start: List[int] = dfield(default_factory=list)         # field 8
    paired_read_name: str = ""         # field 9 (mate linkage,
                                       # multipath_alignment.cpp:2376)

    def encode(self) -> bytes:
        out = bytearray()
        if self.sequence:
            out += field_str(1, self.sequence)
        if self.quality:
            out += field_bytes(2, self.quality)
        if self.name:
            out += field_str(3, self.name)
        if self.sample_name:
            out += field_str(4, self.sample_name)
        if self.read_group:
            out += field_str(5, self.read_group)
        for sp in self.subpaths:
            out += field_bytes(6, sp.encode())
        if self.mapping_quality:
            out += field_varint(7, self.mapping_quality)
        for s in self.start:
            out += field_varint(8, s)
        if self.paired_read_name:
            out += field_str(9, self.paired_read_name)
        return bytes(out)

    @classmethod
    def decode(cls, buf: bytes) -> "MultipathAlignment":
        mp = cls()
        for f, wt, v in iter_fields(buf):
            if f == 1:
                mp.sequence = bytes(v).decode()
            elif f == 2:
                mp.quality = bytes(v)
            elif f == 3:
                mp.name = bytes(v).decode()
            elif f == 4:
                mp.sample_name = bytes(v).decode()
            elif f == 5:
                mp.read_group = bytes(v).decode()
            elif f == 6:
                mp.subpaths.append(Subpath.decode(bytes(v)))
            elif f == 7:
                mp.mapping_quality = v
            elif f == 8:
                mp.start.append(v)
            elif f == 9:
                mp.paired_read_name = bytes(v).decode()
        return mp

    def to_json(self) -> dict:
        d = {"sequence": self.sequence}
        if self.name:
            d["name"] = self.name
        if self.subpaths:
            d["subpath"] = [sp.to_json() for sp in self.subpaths]
        if self.mapping_quality:
            d["mapping_quality"] = self.mapping_quality
        if self.start:
            d["start"] = self.start
        return d

    # -- conversions (vg: multipath_alignment_to_alignment & reverse) -----

    def best_alignment(self) -> Alignment:
        """Highest-scoring source-to-sink chain -> single-path Alignment
        (vg optimal_alignment, src/multipath_alignment.cpp)."""
        n = len(self.subpaths)
        aln = Alignment(sequence=self.sequence, name=self.name,
                        quality=self.quality,
                        mapping_quality=self.mapping_quality)
        if n == 0:
            return aln
        best_score = [None] * n
        best_prev = [-1] * n
        order = range(n)            # subpaths are stored in topo order
        starts = set(self.start or range(n))
        for i in order:
            base = self.subpaths[i].score
            if i in starts and (best_score[i] is None or best_score[i] < base):
                best_score[i] = base
                best_prev[i] = -1
            if best_score[i] is None:
                continue
            for nx in self.subpaths[i].next:
                cand = best_score[i] + self.subpaths[nx].score
                if best_score[nx] is None or cand > best_score[nx]:
                    best_score[nx] = cand
                    best_prev[nx] = i
        sinks = [i for i in range(n) if not self.subpaths[i].next
                 and best_score[i] is not None]
        if not sinks:
            return aln
        end = max(sinks, key=lambda i: best_score[i])
        chain = []
        i = end
        while i != -1:
            chain.append(i)
            i = best_prev[i]
        chain.reverse()
        path = Path()
        rank = 0
        for i in chain:
            sp = self.subpaths[i].path
            if sp is None:
                continue
            for mp in sp.mappings:
                rank += 1
                mp.rank = rank
                path.mappings.append(mp)
        aln.path = path
        aln.score = best_score[end]
        return aln

    @classmethod
    def from_alignment(cls, aln: Alignment) -> "MultipathAlignment":
        mp = cls(sequence=aln.sequence, quality=aln.quality, name=aln.name,
                 mapping_quality=aln.mapping_quality)
        if aln.path is not None:
            mp.subpaths.append(Subpath(path=aln.path, score=aln.score))
            mp.start = [0]
        return mp


def write_gamp(path_or_file, mps: Iterable[MultipathAlignment]) -> None:
    msgs = (m.encode() for m in mps)
    if hasattr(path_or_file, "write"):
        write_messages(path_or_file, msgs, tag_name=b"GAMP")
    else:
        with open(path_or_file, "wb") as f:
            write_messages(f, msgs, tag_name=b"GAMP")


def read_gamp(path_or_file) -> Iterator[MultipathAlignment]:
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    for msg in read_messages(data):
        yield MultipathAlignment.decode(msg)
