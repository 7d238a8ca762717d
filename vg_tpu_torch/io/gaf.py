"""GAF (Graph Alignment Format) text output.

Reference: vg emits GAF via gbwtgraph's support plus vg-side conversion
(src/alignment.cpp gaf functions, io::GafAlignmentEmitter,
src/subcommand/giraffe_main.cpp:2217-2221). Columns follow the GAF spec:
name, qlen, qstart, qend, strand, path(<> runs), plen, pstart, pend,
matches, block length, mapq, then cs-style tags.

Copied from vg_tpu/io/gaf.py.
"""
from __future__ import annotations

from typing import List, TextIO

from .gam import Alignment


def _tag_columns(aln: Alignment) -> str:
    tags = (aln.annotation or {}).get("tags") if aln.annotation else None
    if not tags:
        return ""
    return "\t" + "\t".join(str(tags).split())


def alignment_to_gaf(aln: Alignment) -> str:
    qlen = len(aln.sequence)
    if aln.path is None or not aln.path.mappings:
        return "\t".join([
            aln.name or "*", str(qlen), "0", "0", "*", "*",
            "0", "0", "0", "0", "0", "0"]) + _tag_columns(aln)
    mappings = aln.path.mappings
    # query interval: soft clips are 0-from_length edits at the ends
    qstart = 0
    first = mappings[0].edits
    if first and first[0].from_length == 0:
        qstart = first[0].to_length
    qend = qlen
    last = mappings[-1].edits
    if last and last[-1].from_length == 0:
        qend = qlen - last[-1].to_length

    path_parts: List[str] = []
    plen = 0
    matches = 0
    block = 0
    for mp in mappings:
        p = mp.position
        path_parts.append(("<" if p.is_reverse else ">") + str(p.node_id))
        for e in mp.edits:
            block += max(e.from_length, e.to_length)
            if e.from_length == e.to_length and not e.sequence:
                matches += e.from_length
        plen += sum(e.from_length for e in mp.edits)
    pstart = mappings[0].position.offset
    return "\t".join([
        aln.name or "*", str(qlen), str(qstart), str(qend), "+",
        "".join(path_parts), str(plen + pstart), str(pstart),
        str(pstart + plen), str(matches), str(block),
        str(aln.mapping_quality),
        f"AS:i:{aln.score}", f"id:f:{aln.identity:.6g}"]) \
        + _tag_columns(aln)


def write_gaf(fileobj: TextIO, alns) -> None:
    for a in alns:
        fileobj.write(alignment_to_gaf(a) + "\n")


def parse_gaf_line(line: str) -> Alignment:
    """GAF line -> Alignment. Path and intervals are recovered exactly;
    without a cs/cg tag the aligned interval becomes one aligned block
    (enough for pack coverage and position comparisons — reference
    gaf readers make the same simplification for coverage use)."""
    import re

    from .gam import Edit, Mapping, Path, Position

    cols = line.rstrip("\n").split("\t")
    aln = Alignment(name=cols[0])
    qlen = int(cols[1])
    if cols[5] in ("*", ""):
        return aln
    qstart, qend = int(cols[2]), int(cols[3])
    pstart, pend = int(cols[7]), int(cols[8])
    matches = int(cols[9])
    aln.mapping_quality = int(cols[11]) if cols[11] != "255" else 0
    for tag in cols[12:]:
        if tag.startswith("AS:i:"):
            aln.score = int(tag[5:])
        elif tag.startswith("id:f:"):
            aln.identity = float(tag[5:])
    steps = re.findall(r"([<>])(\d+)", cols[5])
    path = Path()
    consumed = pstart
    remaining = pend - pstart
    for rank, (orient, nid) in enumerate(steps, 1):
        mp = Mapping(position=Position(node_id=int(nid),
                                       is_reverse=(orient == "<")),
                     rank=rank)
        if rank == 1:
            mp.position.offset = pstart
        path.mappings.append(mp)
    # single aligned block over the path interval (per-node split happens
    # against a graph when needed)
    if path.mappings:
        if qstart > 0:
            path.mappings[0].edits.append(
                Edit(from_length=0, to_length=qstart))
        path.mappings[0].edits.append(
            Edit(from_length=remaining, to_length=qend - qstart))
        if qend < qlen:
            path.mappings[-1].edits.append(
                Edit(from_length=0, to_length=qlen - qend))
    aln.path = path
    return aln


def read_gaf(path_or_file) -> "Iterator[Alignment]":
    if hasattr(path_or_file, "read"):
        for line in path_or_file:
            if line.strip():
                yield parse_gaf_line(line)
    else:
        with open(path_or_file) as f:
            for line in f:
                if line.strip():
                    yield parse_gaf_line(line)
