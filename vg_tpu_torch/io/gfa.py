"""GFA 1.0/1.1 import/export for ArrayGraph.

Reference behavior: src/algorithms/gfa_to_handle.{hpp,cpp} (import) and
src/gfa.cpp (export). Supports S/L/P lines plus GFA 1.1 W (walk) lines,
which carry haplotype paths (sample, haplotype, contig, range).

Copied from vg_tpu/io/gfa.py.
"""
from __future__ import annotations

import gzip
import re
from typing import List, Tuple

from ..graph.arraygraph import (
    ArrayGraph,
    GraphBuilder,
    SENSE_GENERIC,
    SENSE_HAPLOTYPE,
    SENSE_REFERENCE,
)

_WALK_STEP = re.compile(r"([><])([^><]+)")


def _open(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def parse_gfa(text: str) -> ArrayGraph:
    b = GraphBuilder()
    path_lines: List[str] = []
    walk_lines: List[str] = []
    for line in text.splitlines():
        if not line:
            continue
        t = line[0]
        if t == "S":
            cols = line.split("\t")
            b.add_node(cols[2], node_id=int(cols[1]))
        elif t == "L":
            cols = line.split("\t")
            b.add_edge(int(cols[1]), int(cols[3]),
                       cols[2] == "-", cols[4] == "-")
        elif t == "P":
            path_lines.append(line)
        elif t == "W":
            walk_lines.append(line)
    for line in path_lines:
        cols = line.split("\t")
        name = cols[1]
        steps: List[Tuple[int, bool]] = []
        if cols[2] and cols[2] != "*":
            for s in cols[2].split(","):
                steps.append((int(s[:-1]), s[-1] == "-"))
        sense = SENSE_REFERENCE
        b.add_path(name, steps, sense=sense, locus=name)
    for line in walk_lines:
        cols = line.split("\t")
        sample, hap, seqid, start, end = cols[1], int(cols[2]), cols[3], cols[4], cols[5]
        steps = [(int(m.group(2)), m.group(1) == "<")
                 for m in _WALK_STEP.finditer(cols[6])]
        if sample == "_gbwt_ref" or sample == "*":
            name = seqid
            sense = SENSE_REFERENCE
            b.add_path(name, steps, sense=sense, sample="", locus=seqid, haplotype=0)
        else:
            name = f"{sample}#{hap}#{seqid}"
            if start not in ("0", "*"):
                name += f"[{start}]"
            b.add_path(name, steps, sense=SENSE_HAPLOTYPE, sample=sample,
                       locus=seqid, haplotype=hap)
    g = b.freeze()
    # make sure path edges exist even if L lines were missing (some GFAs omit)
    for pi in range(g.path_count):
        hs = g.path_handles(pi)
        missing = []
        for a, bh in zip(hs[:-1], hs[1:]):
            if not g.has_edge(int(a), int(bh)):
                missing.append((int(a), int(bh)))
        if missing:
            for a, bh in missing:
                b.add_edge(int(g.node_id[a >> 1]), int(g.node_id[bh >> 1]),
                           bool(a & 1), bool(bh & 1))
    if any(not g.has_edge(int(a), int(bh))
           for pi in range(g.path_count)
           for a, bh in zip(g.path_handles(pi)[:-1], g.path_handles(pi)[1:])):
        g = b.freeze()
    return g


def read_gfa(path: str) -> ArrayGraph:
    with _open(path) as f:
        return parse_gfa(f.read())


def write_gfa(graph: ArrayGraph, path_or_file, use_walks: bool = False) -> str:
    """Serialize to GFA 1.0 (P lines) or 1.1 (W lines for haplotype paths)."""
    lines = ["H\tVN:Z:" + ("1.1" if use_walks else "1.0")]
    for nid, seq in graph.iter_nodes():
        lines.append(f"S\t{nid}\t{seq}")
    for pi, meta in enumerate(graph.path_meta):
        hs = graph.path_handles(pi)
        if use_walks and meta.sense == SENSE_HAPLOTYPE:
            walk = "".join(
                ("<" if h & 1 else ">") + str(graph.node_id[h >> 1]) for h in hs
            )
            plen = graph.path_len(pi)
            lines.append(
                f"W\t{meta.sample}\t{meta.haplotype}\t{meta.locus or meta.name}"
                f"\t0\t{plen}\t{walk}"
            )
        else:
            steps = ",".join(
                str(graph.node_id[h >> 1]) + ("-" if h & 1 else "+") for h in hs
            )
            overlaps = ",".join("0M" for _ in range(max(len(hs) - 1, 0))) or "*"
            lines.append(f"P\t{meta.name}\t{steps}\t{overlaps}")
    for f_id, f_rev, t_id, t_rev in graph.iter_edges():
        lines.append(
            f"L\t{f_id}\t{'-' if f_rev else '+'}\t{t_id}\t{'-' if t_rev else '+'}\t0M"
        )
    text = "\n".join(lines) + "\n"
    if path_or_file is not None:
        if hasattr(path_or_file, "write"):
            path_or_file.write(text)
        else:
            with open(path_or_file, "w") as f:
                f.write(text)
    return text
