""".vg protobuf graph format (legacy vg Graph chunks).

Wire schema recovered from reference fixture files (test/graphs/*.vg):
Graph{node=1, edge=2, path=3}; Node{sequence=1, id=3}; Edge{from=1, to=2,
from_start=3, to_end=4}; Path as in GAM. A .vg file is a vg-framed stream
(BGZF groups) of Graph chunk messages; chunks concatenate.

Copied from vg_tpu/io/vg_format.py.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

from ..graph.arraygraph import ArrayGraph, GraphBuilder, SENSE_REFERENCE
from .gam import KNOWN_TAGS, Path, read_messages, write_messages
from .wire import field_bytes, field_str, field_varint, iter_fields


def _encode_node(nid: int, seq: str) -> bytes:
    return field_str(1, seq) + field_varint(3, nid)


def _encode_edge(f_id: int, t_id: int, f_rev: bool, t_rev: bool) -> bytes:
    out = field_varint(1, f_id) + field_varint(2, t_id)
    if f_rev:
        out += field_varint(3, 1)
    if t_rev:
        out += field_varint(4, 1)
    return out


def graph_to_chunks(g: ArrayGraph, chunk_nodes: int = 1000) -> Iterable[bytes]:
    """Serialize an ArrayGraph as Graph protobuf chunk messages."""
    nodes = list(g.iter_nodes())
    edges = list(g.iter_edges())
    first = True
    for i in range(0, max(len(nodes), 1), chunk_nodes):
        out = bytearray()
        for nid, seq in nodes[i : i + chunk_nodes]:
            out += field_bytes(1, _encode_node(nid, seq))
        if first:
            for f_id, f_rev, t_id, t_rev in edges:
                out += field_bytes(2, _encode_edge(f_id, t_id, f_rev, t_rev))
            for pi, meta in enumerate(g.path_meta):
                from .gam import Edit, Mapping, Position
                p = Path(name=meta.name)
                for rank, h in enumerate(g.path_handles(pi), start=1):
                    ln = int(g.node_len_idx(int(h) >> 1))
                    p.mappings.append(Mapping(
                        position=Position(node_id=int(g.node_id[int(h) >> 1]),
                                          is_reverse=bool(h & 1)),
                        edits=[Edit(from_length=ln, to_length=ln)],
                        rank=rank,
                    ))
                out += field_bytes(3, p.encode())
            first = False
        yield bytes(out)


def write_vg(g: ArrayGraph, path_or_file) -> None:
    chunks = graph_to_chunks(g)
    if hasattr(path_or_file, "write"):
        write_messages(path_or_file, chunks, tag_name=None)
    else:
        with open(path_or_file, "wb") as f:
            write_messages(f, chunks, tag_name=None)


def read_vg(path_or_file) -> ArrayGraph:
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    b = GraphBuilder()
    paths: dict[str, List[Tuple[int, int, bool]]] = {}  # (rank, node, rev)
    path_order: List[str] = []
    for msg in read_messages(data):
        for f, wt, v in iter_fields(bytes(msg)):
            if f == 1:  # Node
                seq, nid = "", 0
                for f2, _, v2 in iter_fields(bytes(v)):
                    if f2 == 1:
                        seq = bytes(v2).decode()
                    elif f2 == 3:
                        nid = v2
                    elif f2 == 2:
                        pass  # legacy name field
                b.add_node(seq, node_id=nid)
            elif f == 2:  # Edge
                fr = to = 0
                f_rev = t_rev = False
                for f2, _, v2 in iter_fields(bytes(v)):
                    if f2 == 1:
                        fr = v2
                    elif f2 == 2:
                        to = v2
                    elif f2 == 3:
                        f_rev = bool(v2)
                    elif f2 == 4:
                        t_rev = bool(v2)
                b.add_edge(fr, to, f_rev, t_rev)
            elif f == 3:  # Path
                p = Path.decode(bytes(v))
                if p.name not in paths:
                    paths[p.name] = []
                    path_order.append(p.name)
                for m in p.mappings:
                    rank = m.rank if m.rank else len(paths[p.name]) + 1
                    paths[p.name].append((rank, m.position.node_id,
                                          m.position.is_reverse))
    for name in path_order:
        steps = [(nid, rev) for _, nid, rev in sorted(paths[name],
                                                      key=lambda t: t[0])]
        b.add_path(name, steps, sense=SENSE_REFERENCE, locus=name)
    return b.freeze()
