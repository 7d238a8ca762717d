"""JSON graph interchange matching `vg view -j` conventions.

The dict shape mirrors the Graph protobuf JSON: {"node": [{"id", "sequence"}],
"edge": [{"from", "to", "from_start", "to_end"}], "path": [...]} — the
debugging lingua franca of the reference test suite (SURVEY.md Appendix E).

Copied from vg_tpu/io/json_graph.py.
"""
from __future__ import annotations

import json
from typing import List, Tuple

from ..graph.arraygraph import ArrayGraph, GraphBuilder, SENSE_REFERENCE


def graph_to_json(g: ArrayGraph) -> dict:
    d: dict = {
        "node": [{"id": nid, "sequence": seq} for nid, seq in g.iter_nodes()],
    }
    edges = []
    for f_id, f_rev, t_id, t_rev in g.iter_edges():
        e: dict = {"from": f_id, "to": t_id}
        if f_rev:
            e["from_start"] = True
        if t_rev:
            e["to_end"] = True
        edges.append(e)
    if edges:
        d["edge"] = edges
    paths = []
    for pi, meta in enumerate(g.path_meta):
        hs = g.path_handles(pi)
        mappings = []
        for rank, h in enumerate(hs, start=1):
            ln = int(g.node_len_idx(int(h) >> 1))
            pos: dict = {"node_id": int(g.node_id[int(h) >> 1])}
            if h & 1:
                pos["is_reverse"] = True
            mappings.append({
                "position": pos,
                "edit": [{"from_length": ln, "to_length": ln}],
                "rank": rank,
            })
        paths.append({"name": meta.name, "mapping": mappings})
    if paths:
        d["path"] = paths
    return d


def graph_from_json(d: dict) -> ArrayGraph:
    b = GraphBuilder()
    for node in d.get("node", []):
        b.add_node(node["sequence"], node_id=int(node["id"]))
    for e in d.get("edge", []):
        b.add_edge(int(e["from"]), int(e["to"]),
                   bool(e.get("from_start")), bool(e.get("to_end")))
    for p in d.get("path", []):
        steps: List[Tuple[int, bool]] = []
        for m in p.get("mapping", []):
            pos = m["position"]
            steps.append((int(pos["node_id"]), bool(pos.get("is_reverse"))))
        b.add_path(p.get("name", ""), steps, sense=SENSE_REFERENCE)
    return b.freeze()


def read_json_graph(path: str) -> ArrayGraph:
    with open(path) as f:
        return graph_from_json(json.load(f))


def write_json_graph(g: ArrayGraph, path: str) -> None:
    with open(path, "w") as f:
        json.dump(graph_to_json(g), f)
