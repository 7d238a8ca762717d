"""RDF/Turtle export of variation graphs (vg view -t role).

Uses the public vg RDF ontology (http://biohackathon.org/resource/vg#,
reference emitter: src/vg.cpp VG::to_turtle): nodes carry rdf:value
sequences, edges are vg:links{Forward,Reverse}To{Forward,Reverse}
statements, and every path step is a vg:Step with rank, node (or
reverseOfNode), path, and cumulative position.

Copied from vg_tpu/io/rdf.py.
"""
from __future__ import annotations

from typing import TextIO

from ..graph.arraygraph import ArrayGraph


def _pct(s: str) -> str:
    out = []
    for ch in s:
        if ch.isalnum() or ch in "-_.~":
            out.append(ch)
        else:
            out.append("%%%02X" % ord(ch))
    return "".join(out)


def write_turtle(g: ArrayGraph, out: TextIO,
                 base_uri: str = "http://example.org/vg/") -> None:
    w = out.write
    w("@prefix vg:<http://biohackathon.org/resource/vg#> . \n")
    w(f"@prefix node: <{base_uri}node/> . \n")
    w(f"@prefix path: <{base_uri}path/> . \n")
    w(f"@prefix step: <{base_uri}step/> . \n")
    w("@prefix rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#> . \n")
    for i in range(g.node_count):
        nid = int(g.node_id[i])
        w(f'node:{nid} rdf:value "{g.node_seq(nid)}" . \n')
    for pi, meta in enumerate(g.path_meta):
        pname = _pct(meta.name)
        offset = 0
        for rank, h in enumerate(g.path_handles(pi), 1):
            h = int(h)
            nid = int(g.node_id[h >> 1])
            rel = "vg:reverseOfNode" if (h & 1) else "vg:node"
            w(f"step:{pname}-{rank} vg:position {offset} ; \n")
            w(" a vg:Step ; \n")
            w(f" vg:rank {rank} ; \n")
            w(f" {rel} node:{nid} ; \n")
            w(f" vg:path path:{pname} . \n")
            offset += g.node_len(nid)
    for f_id, f_rev, t_id, t_rev in g.iter_edges():
        if f_rev and t_rev:
            rel = "vg:linksReverseToReverse"
        elif f_rev:
            rel = "vg:linksReverseToForward"
        elif t_rev:
            rel = "vg:linksForwardToReverse"
        else:
            rel = "vg:linksForwardToForward"
        w(f"node:{f_id} {rel} node:{t_id} . \n")
