"""Alignment statistics and filtering (vg stats -a / vg filter roles,
reference: src/subcommand/stats_main.cpp, src/readfilter.cpp).

Copied from vg_tpu/utils/alnstats.py.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from ..io.gam import Alignment


def alignment_stats(alns: Iterable[Alignment]) -> Dict:
    total = aligned = perfect = paired = 0
    softclipped = 0
    score_sum = 0
    mapq: List[int] = []
    identity = []
    for a in alns:
        total += 1
        if a.fragment_next is not None or a.fragment_prev is not None:
            paired += 1
        if a.path is None or not a.path.mappings:
            continue
        aligned += 1
        score_sum += a.score
        mapq.append(a.mapping_quality)
        identity.append(a.identity)
        edits = [e for mp in a.path.mappings for e in mp.edits]
        if all(e.from_length == e.to_length and not e.sequence
               for e in edits):
            perfect += 1
        first, last = edits[0], edits[-1]
        if (first.from_length == 0 and first.to_length > 0) or \
                (last.from_length == 0 and last.to_length > 0):
            softclipped += 1
    return {
        "total": total,
        "aligned": aligned,
        "perfect": perfect,
        "paired": paired,
        "softclipped": softclipped,
        "mean_score": score_sum / aligned if aligned else 0.0,
        "mean_mapq": float(np.mean(mapq)) if mapq else 0.0,
        "mean_identity": float(np.mean(identity)) if identity else 0.0,
    }


def filter_alignments(alns: Iterable[Alignment],
                      min_mapq: int = 0,
                      min_identity: float = 0.0,
                      name_prefix: Optional[str] = None,
                      drop_unmapped: bool = False,
                      max_softclip: Optional[int] = None):
    """Yield alignments passing the filters (vg filter flags -q/-n/...)."""
    for a in alns:
        if name_prefix and not a.name.startswith(name_prefix):
            continue
        mapped = a.path is not None and a.path.mappings
        if drop_unmapped and not mapped:
            continue
        if mapped and a.mapping_quality < min_mapq:
            continue
        if mapped and a.identity < min_identity:
            continue
        if max_softclip is not None and mapped:
            edits = [e for mp in a.path.mappings for e in mp.edits]
            clip = 0
            if edits and edits[0].from_length == 0:
                clip = max(clip, edits[0].to_length)
            if edits and edits[-1].from_length == 0:
                clip = max(clip, edits[-1].to_length)
            if clip > max_softclip:
                continue
        yield a


def sort_key(a: Alignment):
    """Graph-coordinate sort key (vg gamsort: min visited node, offset)."""
    if a.path is None or not a.path.mappings:
        return (1 << 62, 0)
    p = a.path.mappings[0].position
    nid = min(mp.position.node_id for mp in a.path.mappings)
    return (nid, p.offset)


def sort_alignments(alns: List[Alignment]) -> List[Alignment]:
    return sorted(alns, key=sort_key)


def external_sort_gam(in_path: str, out_path: str,
                      chunk_records: int = 100_000) -> int:
    """Disk-backed merge sort for GAMs too large for memory (vg gamsort's
    StreamSorter role, reference src/stream_sorter.hpp). Returns record
    count."""
    import heapq
    import os
    import tempfile

    from ..io.gam import Alignment, read_messages, write_messages
    from ..io import bgzf

    chunks = []
    buf = []

    def flush():
        if not buf:
            return
        buf.sort(key=lambda t: t[0])
        f = tempfile.NamedTemporaryFile(delete=False, suffix=".gamchunk")
        write_messages(f, (m for _, m in buf))
        f.close()
        chunks.append(f.name)
        buf.clear()

    with open(in_path, "rb") as f:
        data = f.read()
    n = 0
    for msg in read_messages(data):
        a = Alignment.decode(msg)
        buf.append((sort_key(a), msg))
        n += 1
        if len(buf) >= chunk_records:
            flush()
    flush()

    def chunk_iter(path):
        with open(path, "rb") as f:
            data = f.read()
        for msg in read_messages(data):
            a = Alignment.decode(msg)
            yield (sort_key(a), msg)

    merged = heapq.merge(*(chunk_iter(c) for c in chunks))
    with open(out_path, "wb") as f:
        write_messages(f, (m for _, m in merged))
    for c in chunks:
        os.unlink(c)
    return n
