"""MSA -> graph conversion (vg msga/MSAConverter role, reference:
src/msa_converter.cpp): aligned FASTA columns become graph nodes, runs of
identical column content merge, one embedded path per input sequence.

Copied from vg_tpu/construct/msa.py.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..graph.arraygraph import ArrayGraph, GraphBuilder


def parse_aligned_fasta(text: str) -> List[Tuple[str, str]]:
    seqs: List[Tuple[str, List[str]]] = []
    for line in text.splitlines():
        if line.startswith(">"):
            seqs.append((line[1:].split()[0], []))
        elif line.strip() and seqs:
            seqs[-1][1].append(line.strip())
    return [(n, "".join(p).upper()) for n, p in seqs]


def msa_to_graph(rows: List[Tuple[str, str]]) -> ArrayGraph:
    """Column-wise construction: at each column, sequences sharing a base
    share a node; gaps skip. Adjacent columns with identical partition
    merge into longer nodes."""
    if not rows:
        return GraphBuilder().freeze()
    names = [n for n, _ in rows]
    seqs = [s for _, s in rows]
    L = len(seqs[0])
    assert all(len(s) == L for s in seqs), "MSA rows must be equal length"
    b = GraphBuilder()
    paths: Dict[str, List[Tuple[int, bool]]] = {n: [] for n in names}
    # active run per partition signature
    run_nodes: Dict[Tuple, Tuple[int, List[str]]] = {}

    def flush_all():
        for sig, (nid, chars) in run_nodes.items():
            b.add_node("".join(chars), node_id=nid)
        run_nodes.clear()

    next_id = 1
    prev_partition = None
    for col in range(L):
        # partition rows by base at this column (gap rows excluded)
        groups: Dict[str, List[int]] = {}
        for ri, s in enumerate(seqs):
            c = s[col]
            if c != "-":
                groups.setdefault(c, []).append(ri)
        partition = {c: tuple(g) for c, g in groups.items()}
        if prev_partition is not None and \
                set(partition.values()) == set(prev_partition.values()) and \
                len(partition) == len(prev_partition):
            # same row grouping: extend the runs
            newruns = {}
            for c, g in partition.items():
                nid, chars = run_nodes[g]
                chars.append(c)
                newruns[g] = (nid, chars)
            run_nodes = newruns
        else:
            flush_all()
            for c, g in partition.items():
                nid = next_id
                next_id += 1
                run_nodes[g] = (nid, [c])
                for ri in g:
                    paths[names[ri]].append((nid, False))
        prev_partition = partition
    flush_all()
    # edges from consecutive path steps
    for n, steps in paths.items():
        dedup = [steps[0]] if steps else []
        for s in steps[1:]:
            if s != dedup[-1]:
                dedup.append(s)
        paths[n] = dedup
    for n, steps in paths.items():
        for (a, ar), (c, cr) in zip(steps[:-1], steps[1:]):
            b.add_edge(a, c, ar, cr)
        b.add_path(n, steps)
    return b.freeze()
