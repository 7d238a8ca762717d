"""Random-access index over a sorted GAM (reference: vg's .gai,
src/stream_index.hpp — StreamIndex maps node-ID ranges to virtual offsets
in the BGZF stream so `vg find` can pull alignments touching a region
without scanning the file).

TPU-native re-design: instead of htslib virtual offsets (coffset<<16 |
uoffset into a block), the writer flushes the BGZF writer at every message
group so group starts coincide with BGZF block starts, and the sidecar
index stores one (min_node, max_node, file_offset) triple per group.
Groups are self-contained gzip-member runs, so a query decompresses only
the byte ranges of overlapping groups.

Copied from vg_tpu/io/gam_index.py.
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Iterable, Iterator, List, Tuple

from . import bgzf
from .gam import Alignment, decode_varint, encode_varint

MAGIC = b"GAI\x01"
NO_NODE = (1 << 62)  # sort key used for unmapped records


def _node_range(a: Alignment) -> Tuple[int, int]:
    if a.path is None or not a.path.mappings:
        return (NO_NODE, NO_NODE)
    ids = [mp.position.node_id for mp in a.path.mappings]
    return (min(ids), max(ids))


def write_indexed_gam(gam_path: str, index_path: str,
                      alignments: Iterable[Alignment],
                      group_size: int = 256, level: int = 1) -> int:
    """Write a (sorted) alignment stream with a .gai-role sidecar index.

    The caller is responsible for sort order (gamsort); indexing an
    unsorted stream still works but degrades every query to a near-full
    scan, matching the reference's requirement that .gai follows gamsort.
    Returns the record count.
    """
    entries: List[Tuple[int, int, int]] = []
    n = 0
    with open(gam_path, "wb") as f:
        w = bgzf.BGZFWriter(f, level=level)
        group: List[bytes] = []
        lo = hi = NO_NODE

        def flush_group():
            nonlocal lo, hi
            if not group:
                return
            entries.append((lo, hi, f.tell()))
            w.write(encode_varint(len(group)))
            for msg in group:
                w.write(encode_varint(len(msg)) + msg)
            w.flush()  # end the block: next group starts a fresh member
            group.clear()
            lo = hi = NO_NODE

        for a in alignments:
            alo, ahi = _node_range(a)
            if alo != NO_NODE:  # unmapped records don't widen the range
                lo = min(lo, alo)
                hi = ahi if hi == NO_NODE else max(hi, ahi)
            group.append(a.encode())
            n += 1
            if len(group) >= group_size:
                flush_group()
        flush_group()
        w.close()
    with open(index_path, "wb") as f:
        f.write(MAGIC + struct.pack("<Q", len(entries)))
        for e in entries:
            f.write(struct.pack("<QQQ", *e))
    return n


class GamIndex:
    def __init__(self, entries: List[Tuple[int, int, int]]):
        self.entries = entries

    @classmethod
    def load(cls, index_path: str) -> "GamIndex":
        with open(index_path, "rb") as f:
            data = f.read()
        assert data[:4] == MAGIC, "not a GAM index"
        (count,) = struct.unpack_from("<Q", data, 4)
        entries = [struct.unpack_from("<QQQ", data, 12 + 24 * i)
                   for i in range(count)]
        return cls(entries)

    def ranges(self, node_lo: int, node_hi: int,
               file_size: int) -> List[Tuple[int, int]]:
        """Byte ranges of groups that may contain nodes in [lo, hi]."""
        out = []
        for i, (glo, ghi, off) in enumerate(self.entries):
            if glo <= node_hi and ghi >= node_lo:
                end = (self.entries[i + 1][2]
                       if i + 1 < len(self.entries) else file_size)
                if out and out[-1][1] == off:   # coalesce adjacent groups
                    out[-1] = (out[-1][0], end)
                else:
                    out.append((off, end))
        return out


def find_alignments(gam_path: str, index_path: str, node_lo: int,
                    node_hi: int) -> Iterator[Alignment]:
    """Alignments visiting any node in [node_lo, node_hi] (vg find -l/-N
    role), reading only the indexed byte ranges."""
    import os

    idx = GamIndex.load(index_path)
    size = os.path.getsize(gam_path)
    with open(gam_path, "rb") as f:
        for start, end in idx.ranges(node_lo, node_hi, size):
            f.seek(start)
            raw = bgzf.decompress(f.read(end - start))
            pos = 0
            while pos < len(raw):
                count, pos = decode_varint(raw, pos)
                for _ in range(count):
                    length, pos = decode_varint(raw, pos)
                    a = Alignment.decode(raw[pos : pos + length])
                    pos += length
                    if a.path and any(
                            node_lo <= mp.position.node_id <= node_hi
                            for mp in a.path.mappings):
                        yield a
