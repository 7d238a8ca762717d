"""Augment: embed aligned novel variation from GAM into the graph.

Reference: augment() (src/augment.hpp:46-64, src/augment.cpp) — find edit
breakpoints, split nodes there, add new nodes/edges for novel sequence,
and report a translation from new ids to old. Same two-phase shape here:

1. collect breakpoints (node, offset) from every alignment's edits
2. split all nodes at their breakpoints (building old->new translation)
3. walk each alignment again, adding SNP/insertion nodes and the edges
   that thread the novel allele through the split graph

Copied from vg_tpu/graph/augment.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..io.gam import Alignment
from ..utils import dna
from .arraygraph import ArrayGraph, GraphBuilder


@dataclass
class Translation:
    """old node id -> list of (new node id, offset in old node)."""
    pieces: Dict[int, List[Tuple[int, int]]] = field(default_factory=dict)

    def map_position(self, old_id: int, offset: int) -> Tuple[int, int]:
        parts = self.pieces.get(old_id)
        if not parts:
            return old_id, offset
        for new_id, off in reversed(parts):
            if offset >= off:
                return new_id, offset - off
        return parts[0][0], offset


def augment(g: ArrayGraph, alns: Sequence[Alignment],
            min_coverage: int = 0) -> Tuple[ArrayGraph, Translation]:
    """Return (augmented graph, translation). Novel SNPs/insertions become
    new nodes; deletions become new edges; reference paths are preserved
    through the splits."""
    # -- phase 0: collect novel events with support counts; identical
    # edits from different reads are ONE event (one new node), and
    # events below min_coverage are dropped entirely (the reference's
    # augment -m support filter, src/augment.cpp min_aug_support)
    def fwd_interval(g, node_id, offset, from_len, is_rev):
        nlen = g.node_len(node_id)
        if is_rev:
            return nlen - offset - from_len, nlen - offset
        return offset, offset + from_len

    event_count: Dict[Tuple, int] = {}
    for aln in alns:
        if aln.path is None:
            continue
        for mp in aln.path.mappings:
            p = mp.position
            off = p.offset
            for e in mp.edits:
                key = None
                if e.from_length and e.to_length and e.sequence:
                    a, z = fwd_interval(g, p.node_id, off, e.from_length,
                                        p.is_reverse)
                    seq = e.sequence if not p.is_reverse else \
                        dna.revcomp_str(e.sequence)
                    key = ("S", p.node_id, a, z, seq)
                elif e.from_length and not e.to_length:
                    a, z = fwd_interval(g, p.node_id, off, e.from_length,
                                        p.is_reverse)
                    key = ("D", p.node_id, a, z)
                elif e.to_length and not e.from_length and e.sequence:
                    a, _ = fwd_interval(g, p.node_id, off, 0, p.is_reverse)
                    seq = e.sequence if not p.is_reverse else \
                        dna.revcomp_str(e.sequence)
                    key = ("I", p.node_id, a, seq)
                if key is not None:
                    event_count[key] = event_count.get(key, 0) + 1
                off += e.from_length
    events = [k for k, n in event_count.items() if n >= min_coverage]

    # -- phase 1: breakpoints per node from the qualifying events
    breaks: Dict[int, Set[int]] = {}
    for ev in events:
        if ev[0] in ("S", "D"):
            _, nid_e, a, z = ev[:4]
            breaks.setdefault(nid_e, set()).update((a, z))
        else:
            _, nid_e, a, _ = ev
            breaks.setdefault(nid_e, set()).add(a)

    # -- phase 2: split nodes
    b = GraphBuilder()
    next_id = int(g.node_id[-1]) + 1 if g.node_count else 1
    trans = Translation()
    for i, nid in enumerate(g.node_id):
        nid = int(nid)
        codes = g.seq[g.seq_start[i] : g.seq_start[i + 1]]
        cuts = sorted(c for c in breaks.get(nid, ()) if 0 < c < len(codes))
        if not cuts:
            b.add_node(codes, node_id=nid)
            trans.pieces[nid] = [(nid, 0)]
            continue
        bounds = [0] + cuts + [len(codes)]
        parts = []
        for a, z in zip(bounds[:-1], bounds[1:]):
            pid = nid if a == 0 else next_id
            if a != 0:
                next_id += 1
            b.add_node(codes[a:z], node_id=pid)
            parts.append((pid, a))
        trans.pieces[nid] = parts
        for (p1, _), (p2, _) in zip(parts[:-1], parts[1:]):
            b.add_edge(p1, p2)

    def map_handle(nid, rev, boundary):
        """New (node, rev) at a forward offset boundary: 'boundary' is the
        piece containing offset boundary ('start' uses the piece starting
        there)."""
        return trans.map_position(nid, boundary)

    # original edges, remapped to the outermost pieces
    for f_id, f_rev, t_id, t_rev in g.iter_edges():
        fp = trans.pieces[f_id]
        tp = trans.pieces[t_id]
        f_new = fp[0][0] if f_rev else fp[-1][0]
        t_new = tp[-1][0] if t_rev else tp[0][0]
        b.add_edge(f_new, t_new, f_rev, t_rev)

    # paths, remapped through the splits
    for pi, meta in enumerate(g.path_meta):
        steps = []
        for h in g.path_handles(pi):
            nid = int(g.node_id[int(h) >> 1])
            rev = bool(int(h) & 1)
            parts = trans.pieces[nid]
            seq = parts if not rev else list(reversed(parts))
            steps.extend((p, rev) for p, _ in seq)
        b.add_path(meta.name, steps, meta.sense, meta.sample, meta.locus,
                   meta.haplotype, meta.is_circular)

    # -- phase 3: thread novel alleles (one node per unique event)
    for ev in events:
        if ev[0] == "S":
            _, nid_e, a, z, seq = ev
            new = next_id
            next_id += 1
            b.add_node(seq, node_id=new)
            left = _piece_before(g, trans, b, nid_e, a)
            right = _piece_after(g, trans, b, nid_e, z)
            for ln, lrev in left:
                b.add_edge(ln, new, lrev, False)
            for rn, rrev in right:
                b.add_edge(new, rn, False, rrev)
        elif ev[0] == "I":
            _, nid_e, a, seq = ev
            new = next_id
            next_id += 1
            b.add_node(seq, node_id=new)
            left = _piece_before(g, trans, b, nid_e, a)
            right = _piece_after(g, trans, b, nid_e, a)
            for ln, lrev in left:
                b.add_edge(ln, new, lrev, False)
            for rn, rrev in right:
                b.add_edge(new, rn, False, rrev)
        else:
            _, nid_e, a, z = ev
            left = _piece_before(g, trans, b, nid_e, a)
            right = _piece_after(g, trans, b, nid_e, z)
            for ln, lrev in left:
                for rn, rrev in right:
                    b.add_edge(ln, rn, lrev, rrev)
    return b.freeze(), trans


def _piece_before(g, trans, b, nid, fwd_off):
    """(node, rev) handles that precede forward offset fwd_off of old node
    nid in the split graph."""
    parts = trans.pieces[nid]
    if fwd_off > 0:
        for j, (p, off) in enumerate(parts):
            nxt = parts[j + 1][1] if j + 1 < len(parts) else g.node_len(nid)
            if nxt == fwd_off:
                return [(p, False)]
        # offset inside a piece (unsplit boundary) — shouldn't happen
        return []
    # predecessors of the old node's start
    out = []
    h = g.handle(nid)
    for pred in g.predecessors(h):
        pn = int(g.node_id[int(pred) >> 1])
        prev = bool(int(pred) & 1)
        pp = trans.pieces[pn]
        out.append((pp[0][0] if prev else pp[-1][0], prev))
    return out


def _piece_after(g, trans, b, nid, fwd_off):
    parts = trans.pieces[nid]
    nlen = g.node_len(nid)
    if fwd_off < nlen:
        for p, off in parts:
            if off == fwd_off:
                return [(p, False)]
        return []
    out = []
    h = g.handle(nid)
    for succ in g.follow(h):
        sn = int(g.node_id[int(succ) >> 1])
        srev = bool(int(succ) & 1)
        sp = trans.pieces[sn]
        out.append((sp[-1][0] if srev else sp[0][0], srev))
    return out


def add_variants(g: ArrayGraph, vcf, contig_map=None):
    """`vg add` (variant_adder role, reference src/variant_adder.cpp):
    embed new VCF alleles into an existing graph. Each record becomes a
    synthetic alignment along the reference path with the alt allele as
    its edit; the augment machinery then splits breakpoints and adds the
    novel nodes/edges, preserving embedded paths.

    Returns (augmented graph, translation)."""
    from ..io.gam import Alignment, Edit, Mapping, Path, Position

    alns = []
    for rec in vcf.records:
        contig = contig_map.get(rec.chrom, rec.chrom) if contig_map \
            else rec.chrom
        if not g.has_path(contig):
            continue
        pi = g.path_index(contig)
        handles = g.path_handles(pi)
        offs = g.path_step_offsets(pi)
        start = rec.pos - 1
        for alt in rec.alts:
            ref_a, alt_a = rec.ref, alt
            # trim the shared first base (VCF anchor) when lengths differ
            while ref_a and alt_a and ref_a[0] == alt_a[0]:
                ref_a, alt_a = ref_a[1:], alt_a[1:]
                start += 1
            end = start + len(ref_a)
            path = Path()
            rank = 1
            import numpy as _np

            si = int(_np.searchsorted(offs[1:], start, side="right"))
            pos = start
            while pos < max(end, start + 1) and si < len(handles):
                h = int(handles[si])
                node_id = int(g.node_id[h >> 1])
                node_off = pos - int(offs[si])
                take = min(int(offs[si + 1]) - pos, end - pos)
                edits = []
                if pos == start:
                    if not ref_a:       # pure insertion at this point
                        edits.append(Edit(from_length=0,
                                          to_length=len(alt_a),
                                          sequence=alt_a))
                        take = 0
                    else:
                        covered = min(take, len(ref_a))
                        edits.append(Edit(
                            from_length=covered,
                            to_length=len(alt_a),
                            sequence=alt_a))
                        take = covered
                else:
                    edits.append(Edit(from_length=take, to_length=0))
                path.mappings.append(Mapping(
                    position=Position(node_id=node_id, offset=node_off,
                                      is_reverse=bool(h & 1)),
                    edits=edits, rank=rank))
                rank += 1
                pos += take
                if pos >= int(offs[si + 1]):
                    si += 1
                if take == 0:
                    break
            if path.mappings:
                alns.append(Alignment(
                    name=f"_add_{rec.chrom}_{rec.pos}", path=path))
    return augment(g, alns)


def translate_path(trans: Translation, g_new: ArrayGraph, path):
    """Project a Path expressed against the pre-augment graph onto the
    augmented graph (vg translate role, reference
    src/subcommand/translate_main.cpp + src/translator.cpp): mappings on
    split nodes are cut at the new node boundaries, with edits split by
    from-length and insertions attached to the current mapping."""
    from ..io.gam import Edit, Mapping, Path, Position

    out = Path()
    for mp in path.mappings:
        old = mp.position.node_id
        parts = trans.pieces.get(old)
        if not parts or (len(parts) == 1 and parts[0][0] == old):
            out.mappings.append(mp)
            continue
        rev = mp.position.is_reverse
        from_total = sum(e.from_length for e in mp.edits)
        old_len = sum(g_new.node_len(nid) for nid, _ in parts)
        # forward-strand interval covered in the old node
        fs = mp.position.offset if not rev \
            else old_len - mp.position.offset - from_total
        # pieces overlapped, in forward order
        spans = []   # (new id, piece fwd start, piece len)
        for k, (nid, off) in enumerate(parts):
            plen = (parts[k + 1][1] - off if k + 1 < len(parts)
                    else old_len - off)
            pe = off + plen
            if pe <= fs or off >= fs + from_total:
                if from_total > 0 or not (off <= fs < pe or
                                          (from_total == 0 and off <= fs <= pe)):
                    continue
            spans.append((nid, off, plen))
        if not spans:
            spans = [(parts[0][0], parts[0][1],
                      g_new.node_len(parts[0][0]))]
        if rev:
            spans = spans[::-1]
        # walk edits across the spans in visit order
        new_maps = []
        si = 0

        def span_visit(k):
            nid, off, plen = spans[k]
            lo = max(off, fs)
            hi = min(off + plen, fs + from_total)
            take = max(hi - lo, 0)
            voff = (lo - off) if not rev else (off + plen - max(hi, lo))
            return nid, voff, take

        nid, voff, left = span_visit(0)
        cur = Mapping(position=Position(node_id=nid, offset=voff,
                                        is_reverse=rev))
        new_maps.append(cur)
        for e in mp.edits:
            fl = e.from_length
            if fl == 0:
                cur.edits.append(e)
                continue
            done = 0
            first_chunk = True
            while fl > 0:
                if left == 0 and si + 1 < len(spans):
                    si += 1
                    nid, voff, left = span_visit(si)
                    cur = Mapping(position=Position(
                        node_id=nid, offset=voff, is_reverse=rev))
                    new_maps.append(cur)
                take = min(fl, left) if left else fl
                if e.to_length == e.from_length:
                    seq = e.sequence[done : done + take] if e.sequence \
                        else ""
                    cur.edits.append(Edit(from_length=take,
                                          to_length=take, sequence=seq))
                elif e.to_length == 0:   # deletion
                    cur.edits.append(Edit(from_length=take, to_length=0))
                else:
                    # block substitution (from != to, both > 0): the full
                    # read-side sequence rides the first chunk, later
                    # chunks consume reference only
                    cur.edits.append(Edit(
                        from_length=take,
                        to_length=e.to_length if first_chunk else 0,
                        sequence=e.sequence if first_chunk else ""))
                left -= take
                fl -= take
                done += take
                first_chunk = False
        out.mappings.extend(new_maps)
    for rank, mp in enumerate(out.mappings, 1):
        mp.rank = rank
    return out


def translate_alignment(trans: Translation, g_new: ArrayGraph, aln):
    if aln.path is not None and aln.path.mappings:
        aln.path = translate_path(trans, g_new, aln.path)
    return aln


def embed_alignment_paths(g: ArrayGraph, alns) -> ArrayGraph:
    """`vg augment -i` include-paths role (reference augment.hpp:46-64
    with include_paths=true): add each alignment's walk to the graph as
    an embedded path named after the read. Only exact walks are
    embedded (novel edits go through augment() proper); the reference's
    alt-path GAMs (e.g. test/call/*_alts.gam) are pure-match walks."""
    from .arraygraph import GraphBuilder

    b = GraphBuilder()
    for i in range(g.node_count):
        nid = int(g.node_id[i])
        b.add_node(g.node_seq_codes(nid), node_id=nid)
    for f_id, f_rev, t_id, t_rev in g.iter_edges():
        b.add_edge(f_id, t_id, f_rev, t_rev)
    for pi, meta in enumerate(g.path_meta):
        steps = [(int(g.node_id[h >> 1]), bool(h & 1))
                 for h in g.path_handles(pi)]
        b.add_path(meta.name, steps, sense=meta.sense, sample=meta.sample,
                   locus=meta.locus, haplotype=meta.haplotype,
                   is_circular=meta.is_circular)
    for a in alns:
        if a.path is None or not a.path.mappings or not a.name:
            continue
        for m in a.path.mappings:
            for e in m.edits:
                if e.from_length != e.to_length or e.sequence:
                    raise ValueError(
                        f"embed_alignment_paths: {a.name} has novel "
                        "edits; run augment() first")
        steps = [(m.position.node_id, m.position.is_reverse)
                 for m in a.path.mappings]
        b.add_path(a.name, steps)
    return b.freeze()
