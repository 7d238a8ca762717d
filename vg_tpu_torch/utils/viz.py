"""Graph visualization: Graphviz dot output (vg view -d role, reference:
src/subcommand/view_main.cpp dot emitters; full cairo viz out of scope).

Copied from vg_tpu/utils/viz.py.
"""
from __future__ import annotations

from typing import Optional

from ..graph.arraygraph import ArrayGraph


def to_dot(g: ArrayGraph, max_nodes: int = 2000,
           show_sequences: bool = True) -> str:
    lines = ["digraph graphname {", "    rankdir=LR;",
             "    node [shape=box];"]
    n = min(g.node_count, max_nodes)
    for i in range(n):
        nid = int(g.node_id[i])
        label = f"{nid}"
        if show_sequences:
            s = g.node_seq(nid)
            label += ":" + (s if len(s) <= 12 else s[:10] + "..")
        lines.append(f'    n{nid} [label="{label}"];')
    shown = {int(g.node_id[i]) for i in range(n)}
    for f_id, f_rev, t_id, t_rev in g.iter_edges():
        if f_id in shown and t_id in shown:
            attrs = []
            if f_rev:
                attrs.append("arrowtail=inv")
            if t_rev:
                attrs.append("arrowhead=inv")
            a = f" [{','.join(attrs)}]" if attrs else ""
            lines.append(f"    n{f_id} -> n{t_id}{a};")
    for pi, meta in enumerate(g.path_meta[:8]):
        hs = g.path_handles(pi)
        if len(hs) == 0:
            continue
        lines.append(f'    path_{pi} [label="{meta.name}", shape=plaintext];')
    lines.append("}")
    return "\n".join(lines) + "\n"


# -------------------------------------------------------------- linear SVG
# The reference's `vg viz` renders a linearized SVG/PNG with cairo
# (src/viz.cpp: node ribbon, edge arcs, path rows, read pileup). Emitting
# SVG markup directly needs no cairo and keeps the same visual grammar.

_PALETTE = ["#4e79a7", "#f28e2b", "#e15759", "#76b7b4", "#59a14f",
            "#edc948", "#b07aa1", "#ff9da7", "#9c755f", "#bab0ac"]


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace('"', "&quot;"))


def to_svg(g: ArrayGraph, alignments=None, width: int = 1600,
           max_nodes: int = 5000, show_labels: bool = True) -> str:
    """Linearized SVG: node ribbon laid out by cumulative sequence
    offset, edge arcs above, one colored row per embedded path below,
    and an optional read pileup (vg viz role, reference src/viz.cpp)."""
    import numpy as np

    n = min(g.node_count, max_nodes)
    node_len = (g.seq_start[1 : n + 1] - g.seq_start[:n]).astype(np.int64)
    # order nodes by first reference-path visit where possible, then id
    order = np.arange(n)
    xs = np.zeros(n + 1, np.float64)
    np.cumsum(node_len[order] + 2, out=xs[1:])
    total = float(xs[-1]) or 1.0
    sx = (width - 40) / total
    node_x = {}
    for k, i in enumerate(order):
        node_x[int(g.node_id[i])] = (20 + xs[k] * sx,
                                     max((node_len[i]) * sx, 1.0))
    ribbon_y = 70.0
    nh = 14.0
    paths = [(pi, m) for pi, m in enumerate(g.path_meta)
             if not m.name.startswith("_alt_")][:24]
    rows_y = ribbon_y + nh + 14
    aln_rows = list(alignments or [])[:64]
    height = rows_y + 12 * len(paths) + 16 + 10 * len(aln_rows) + 20
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{height:.0f}" font-family="sans-serif">',
           f'<rect width="{width}" height="{height:.0f}" fill="white"/>']
    # edge arcs
    for f_id, f_rev, t_id, t_rev in g.iter_edges():
        if f_id not in node_x or t_id not in node_x:
            continue
        x0, w0 = node_x[f_id]
        x1, _ = node_x[t_id]
        a, b = x0 + w0, x1
        if abs(b - a) < 3.5 and not (f_rev or t_rev):
            continue   # adjacent forward edge: implied by the ribbon
        mid = (a + b) / 2
        lift = min(40.0, 6 + abs(b - a) / 12)
        color = "#d62728" if (f_rev or t_rev) else "#999999"
        out.append(f'<path d="M {a:.1f} {ribbon_y:.1f} Q {mid:.1f} '
                   f'{ribbon_y - lift:.1f} {b:.1f} {ribbon_y:.1f}" '
                   f'fill="none" stroke="{color}" stroke-width="0.8"/>')
    # node ribbon
    for i in range(n):
        nid = int(g.node_id[i])
        x, w = node_x[nid]
        out.append(f'<rect x="{x:.1f}" y="{ribbon_y:.1f}" width="{w:.1f}" '
                   f'height="{nh}" fill="#cfe2f3" stroke="#4a4a4a" '
                   f'stroke-width="0.4"/>')
        if show_labels and w > 28:
            s = g.node_seq(nid)
            lbl = f"{nid}:{s if len(s) <= 10 else s[:8] + '..'}"
            out.append(f'<text x="{x + 2:.1f}" y="{ribbon_y + nh - 3:.1f}" '
                       f'font-size="8">{_esc(lbl)}</text>')
    # path rows
    for r, (pi, meta) in enumerate(paths):
        y = rows_y + 12 * r
        color = _PALETTE[r % len(_PALETTE)]
        out.append(f'<text x="2" y="{y + 8:.1f}" font-size="8">'
                   f'{_esc(meta.name[:24])}</text>')
        for h in g.path_handles(pi):
            nid = int(g.node_id[int(h) >> 1])
            if nid not in node_x:
                continue
            x, w = node_x[nid]
            out.append(f'<rect x="{x:.1f}" y="{y:.1f}" width="{w:.1f}" '
                       f'height="8" fill="{color}" opacity="0.8"/>')
    # read pileup
    base = rows_y + 12 * len(paths) + 12
    for r, aln in enumerate(aln_rows):
        y = base + 10 * r
        if aln.path is None or not aln.path.mappings:
            continue
        for mp in aln.path.mappings:
            nid = mp.position.node_id
            if nid not in node_x:
                continue
            x, w = node_x[nid]
            mism = any(e.sequence and e.from_length == e.to_length
                       for e in mp.edits)
            color = "#e15759" if mism else "#59a14f"
            out.append(f'<rect x="{x:.1f}" y="{y:.1f}" width="{w:.1f}" '
                       f'height="6" fill="{color}" opacity="0.7"/>')
        out.append(f'<text x="2" y="{y + 6:.1f}" font-size="7">'
                   f'{_esc(aln.name[:20])}</text>')
    out.append("</svg>")
    return "\n".join(out) + "\n"
