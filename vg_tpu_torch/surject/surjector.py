"""Surjection: graph alignments (GAM) -> reference-path SAM records.

Reference behavior (Surjector::surject, src/surjector.cpp:120-223):
anchor the alignment's on-path mappings, realign the off-path stretches
against the reference path, emit a path-relative CIGAR; soft-clipped read
bases stay clipped ("path anchored surject which keeps aligned stuff
aligned", test/t/15_vg_surject.t:24-26); mapping quality is carried over.

TPU-native shape: the reference path is one linear sequence, so "realign
between anchors" collapses into a single banded DP of the aligned read
segment against the anchored reference window — the same kernel the
mapper uses (vg_tpu.ops.traceback.banded_traceback); batching across
reads on device reuses vg_tpu.ops.align.banded_scores when surjecting a
whole GAM.

Copied from vg_tpu/surject/surjector.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graph.arraygraph import SENSE_REFERENCE, ArrayGraph
from ..io.gam import Alignment
from ..io.sam import (FLAG_FIRST, FLAG_LAST, FLAG_MATE_REVERSE,
                      FLAG_MATE_UNMAPPED, FLAG_PAIRED, FLAG_PROPER,
                      FLAG_REVERSE, FLAG_UNMAPPED, SamRecord, cigar_str,
                      sam_header)
from ..map.project import PathPositionIndex
from ..ops.align import Scoring, DEFAULT_SCORING
from ..ops.traceback import banded_traceback
from ..utils import dna


class Surjector:
    def __init__(self, graph: ArrayGraph,
                 path_names: Optional[Sequence[str]] = None,
                 scoring: Scoring = DEFAULT_SCORING,
                 band_radius: int = 16):
        self.graph = graph
        if path_names is None:
            # prefer reference-sense paths when present (15_vg_surject.t:55)
            ref_sense = [m.name for m in graph.path_meta
                         if m.sense == SENSE_REFERENCE]
            path_names = ref_sense or [m.name for m in graph.path_meta]
        self.path_names = list(path_names)
        self.ppi = PathPositionIndex(graph, self.path_names)
        self.scoring = scoring
        self.band_radius = band_radius
        self.ref_codes: Dict[str, np.ndarray] = {
            n: dna.encode(graph.path_seq(n)) for n in self.path_names}

    def ref_lengths(self) -> List[Tuple[str, int]]:
        return [(n, len(self.ref_codes[n])) for n in self.path_names]

    def header(self, sample=None, read_group=None) -> List[str]:
        return sam_header(self.ref_lengths(), sample, read_group)

    # ----------------------------------------------------------------- core

    def _locate(self, aln: Alignment) -> Optional[Tuple[str, int, bool, int, int]]:
        """Find (path, fwd path offset of the alignment's aligned-segment
        start, is_reverse, clip_left, clip_right) for an aligned GAM record."""
        if aln.path is None or not aln.path.mappings:
            return None
        mappings = aln.path.mappings
        # soft clips (insertions at the path ends in vg's edit encoding)
        clip_left = 0
        first_edits = mappings[0].edits
        if first_edits and first_edits[0].from_length == 0:
            clip_left = first_edits[0].to_length
        clip_right = 0
        last_edits = mappings[-1].edits
        if last_edits and last_edits[-1].from_length == 0:
            clip_right = last_edits[-1].to_length

        # first mapping with a target-path occurrence anchors the alignment
        walked = 0  # graph bases before the anchor
        for mp in mappings:
            p = mp.position
            hits = self.ppi.positions_of(p.node_id, p.offset, p.is_reverse)
            if hits:
                h = hits[0]
                return (h.name, int(h.offset), bool(h.is_reverse),
                        clip_left, clip_right, walked)
            walked += sum(e.from_length for e in mp.edits)
        return None

    # min deletion/jump length surjected as N instead of D (reference
    # Surjector::min_splice_length = 20, src/surjector.hpp:108)
    min_splice_length = 20

    def _split_components(self, aln: Alignment):
        """Spliced-surject component analysis (reference spliced_surject,
        src/surjector.cpp:369): consecutive mappings whose reference
        projections jump by >= min_splice_length (a splice connection or
        a stitched spliced path) split the alignment into colinear
        components surjected independently and joined with N."""
        mappings = aln.path.mappings
        comps: List[List] = [[]]
        prev_off = None
        prev_rev = None
        walked_since = 0
        for mp in mappings:
            p = mp.position
            hits = self.ppi.positions_of(p.node_id, p.offset, p.is_reverse)
            here = hits[0] if hits else None
            if here is not None and prev_off is not None:
                step = -walked_since if prev_rev else walked_since
                gap = (int(here.offset) - (prev_off + step))
                if prev_rev:
                    gap = -gap
                if abs(gap) >= self.min_splice_length and gap > 0:
                    comps.append([])
            comps[-1].append(mp)
            if here is not None:
                prev_off = int(here.offset)
                prev_rev = bool(here.is_reverse)
                walked_since = sum(e.from_length for e in mp.edits)
            else:
                walked_since += sum(e.from_length for e in mp.edits)
        return comps

    def _prep(self, aln: Alignment):
        """Everything before the banded realignment DP. Returns
        ('done', rec) for unmapped/spliced records, or
        ('dp', seg, window, ctx) where ctx carries what _finish needs —
        so surject_batch can run ONE native DP call over all records
        (the per-record ctypes roundtrip was 70% of surjection time)."""
        rec = SamRecord(qname=aln.name or "*")
        seq = aln.sequence
        qual = ("".join(chr(q + 33) for q in aln.quality)
                if aln.quality else "*")
        loc = self._locate(aln)
        if loc is None:
            rec.flag |= FLAG_UNMAPPED
            rec.seq = seq or "*"
            rec.qual = qual
            return ("done", rec)
        if aln.path is not None and len(aln.path.mappings) > 1:
            comps = self._split_components(aln)
            if len(comps) > 1:
                spliced = self._surject_spliced(aln, rec, comps, qual)
                if spliced is not None:
                    return ("done", spliced)
        path_name, off, is_rev, clip_left, clip_right, walked = loc
        L = len(seq)
        codes = dna.encode(seq)
        ref = self.ref_codes[path_name]
        B = self.band_radius

        if is_rev:
            # realign the reverse-complement against the forward path; the
            # anchor offset points at the *end* of the aligned segment
            oriented = dna.revcomp_codes(codes)
            clip_left, clip_right = clip_right, clip_left
        else:
            oriented = codes
        seg = oriented[clip_left : L - clip_right]
        seg_len = len(seg)
        if is_rev:
            # `walked` graph bases precede the anchor in read order, which
            # is the downstream (higher-coordinate) side on the forward path
            seg_start_ref = off - (seg_len - walked)
        else:
            seg_start_ref = off - walked
        wstart = seg_start_ref - B
        TW = seg_len + 2 * B
        pos = wstart + np.arange(TW)
        ok = (pos >= 0) & (pos < len(ref))
        window = np.where(ok, ref[np.clip(pos, 0, len(ref) - 1)],
                          6).astype(np.uint8)
        ctx = (rec, seq, qual, path_name, is_rev, clip_left, clip_right,
               seg_len, wstart, int(aln.mapping_quality))
        return ("dp", seg, window, ctx)

    def _finish(self, ta, ctx) -> SamRecord:
        """Build the SAM record from a completed banded traceback."""
        (rec, seq, qual, path_name, is_rev, clip_left, clip_right,
         seg_len, wstart, mapq) = ctx
        if ta is None:
            rec.flag |= FLAG_UNMAPPED
            rec.seq = seq or "*"
            rec.qual = qual
            return rec

        # CIGAR in oriented (forward-path) order
        ops: List[Tuple[str, int]] = []
        if clip_left + ta.read_start:
            ops.append(("S", clip_left + ta.read_start))
        matches = 0
        nm = 0
        for e in ta.edits:
            kind, n = e[0], e[1]
            if kind in ("M", "X"):
                ops.append(("M", n))
                if kind == "M":
                    matches += n
                else:
                    nm += n
            elif kind == "I":
                ops.append(("I", n))
                nm += n
            elif kind == "D":
                ops.append(("D", n))
                nm += n
        tail = (seg_len - ta.read_end) + clip_right
        if tail:
            ops.append(("S", tail))

        rec.rname = path_name
        rec.pos = int(wstart + ta.text_start) + 1  # SAM is 1-based
        rec.mapq = mapq
        rec.cigar = cigar_str(ops)
        if is_rev:
            rec.flag |= FLAG_REVERSE
            rec.seq = dna.revcomp_str(seq)
            rec.qual = qual[::-1] if qual != "*" else "*"
        else:
            rec.seq = seq
            rec.qual = qual
        rec.tags.append(("AS", "i", int(ta.score)))
        rec.tags.append(("NM", "i", int(nm)))
        return rec

    def surject(self, aln: Alignment) -> SamRecord:
        res = self._prep(aln)
        if res[0] == "done":
            return res[1]
        _, seg, window, ctx = res
        ta = banded_traceback(seg, window, self.band_radius, self.scoring)
        return self._finish(ta, ctx)

    def _surject_spliced(self, aln: Alignment, rec: SamRecord, comps,
                         qual: str) -> Optional[SamRecord]:
        """Surject each colinear component independently and join the
        CIGARs with N gaps (reference spliced_surject,
        src/surjector.cpp:369 + :2515 dist >= min_splice_length -> N).
        Returns None to fall back to the unspliced flow."""
        from ..io.gam import Alignment as GamAln
        from ..io.gam import Mapping as GamMapping
        from ..io.gam import Path as GamPath

        seq = aln.sequence
        first_m = comps[0][0]
        last_m = comps[-1][-1]
        lead = (first_m.edits[0].to_length
                if first_m.edits and first_m.edits[0].from_length == 0
                else 0)
        tail = (last_m.edits[-1].to_length
                if last_m.edits and last_m.edits[-1].from_length == 0
                else 0)
        minis = []
        read_at = 0
        for k, comp in enumerate(comps):
            maps = []
            r0 = read_at
            for mi, m in enumerate(comp):
                edits = list(m.edits)
                if k == 0 and mi == 0 and lead:
                    edits = edits[1:]
                if k == len(comps) - 1 and mi == len(comp) - 1 and tail:
                    edits = edits[:-1]
                read_at += sum(e.to_length for e in m.edits)
                maps.append(GamMapping(position=m.position, edits=edits,
                                       rank=mi + 1))
            if k == 0:
                r0 += lead
            r1 = read_at - (tail if k == len(comps) - 1 else 0)
            if r1 <= r0:
                return None
            sub = GamAln(name=aln.name, sequence=seq[r0:r1],
                         path=GamPath(mappings=maps))
            srec = self.surject(sub)
            if srec.flag & FLAG_UNMAPPED or not srec.cigar:
                return None
            minis.append(srec)
        if len({m.rname for m in minis}) != 1:
            return None
        revs = {bool(m.flag & FLAG_REVERSE) for m in minis}
        if len(revs) != 1:
            return None
        is_rev = revs.pop()
        mlist = minis[::-1] if is_rev else minis
        lead_ref, tail_ref = (tail, lead) if is_rev else (lead, tail)

        ops: List[Tuple[str, int]] = []
        if lead_ref:
            ops.append(("S", lead_ref))
        cur_end = None
        nm = 0
        as_sum = 0
        for idx, srec in enumerate(mlist):
            mops = _parse_cigar(srec.cigar)
            # interior softclips become insertions (SAM allows S only at
            # the read ends)
            fixed = []
            for oi, (op, n) in enumerate(mops):
                interior = (op == "S"
                            and not (idx == 0 and oi == 0)
                            and not (idx == len(mlist) - 1
                                     and oi == len(mops) - 1))
                fixed.append(("I" if interior else op, n))
            if idx > 0:
                gap = srec.pos - cur_end
                if gap < 1:
                    return None
                ops.append(("N", gap))
            cur_end = srec.pos + _ref_span(srec.cigar)
            ops.extend(fixed)
            for t, ty, v in srec.tags:
                if t == "NM":
                    nm += int(v)
                elif t == "AS":
                    as_sum += int(v)
        if tail_ref:
            ops.append(("S", tail_ref))
        # merge adjacent same ops (clip + mini leading S etc.)
        merged: List[Tuple[str, int]] = []
        for op, n in ops:
            if merged and merged[-1][0] == op:
                merged[-1] = (op, merged[-1][1] + n)
            else:
                merged.append((op, n))
        consumed = sum(n for op, n in merged if op in ("S", "M", "I", "X",
                                                       "="))
        if consumed != len(seq):
            return None
        rec.rname = mlist[0].rname
        rec.pos = mlist[0].pos
        rec.mapq = int(aln.mapping_quality)
        rec.cigar = cigar_str(merged)
        if is_rev:
            rec.flag |= FLAG_REVERSE
            rec.seq = dna.revcomp_str(seq)
            rec.qual = qual[::-1] if qual != "*" else "*"
        else:
            rec.seq = seq
            rec.qual = qual
        rec.tags.append(("AS", "i", as_sum))
        rec.tags.append(("NM", "i", nm))
        return rec

    # ------------------------------------------------------------- batched

    def surject_batch(self, alns: Sequence[Alignment]) -> List[SamRecord]:
        """All realignment DPs in ONE native OpenMP call (the same C
        routine the per-record path uses, so records are identical);
        falls back per record when the native lib is absent."""
        from ..native import native_banded_tracebacks

        preps = [self._prep(a) for a in alns]
        tasks = [(k, p[1], p[2], p[3]) for k, p in enumerate(preps)
                 if p[0] == "dp"]
        out: List[Optional[SamRecord]] = [
            p[1] if p[0] == "done" else None for p in preps]
        if tasks:
            n = len(tasks)
            Lmax = max(len(seg) for _, seg, _, _ in tasks)
            B = self.band_radius
            TWmax = Lmax + 2 * B
            reads = np.full((n, max(Lmax, 1)), 5, np.uint8)
            wins = np.full((n, max(TWmax, 1)), 6, np.uint8)
            rlen = np.zeros(n, np.int64)
            for t, (_, seg, win, _) in enumerate(tasks):
                reads[t, : len(seg)] = seg
                wins[t, : len(win)] = win
                rlen[t] = len(seg)
            res = native_banded_tracebacks(reads, rlen, wins, B,
                                           self.scoring)
            if res is None:                      # no native lib
                for k, seg, win, ctx in tasks:
                    ta = banded_traceback(seg, win, B, self.scoring)
                    out[k] = self._finish(ta, ctx)
            else:
                for (k, _, _, ctx), ta in zip(tasks, res):
                    out[k] = self._finish(ta, ctx)
        return out

    def surject_pairs(self, pairs: Sequence[Tuple[Alignment, Alignment]]
                      ) -> List[SamRecord]:
        """Surject mate pairs, filling pair flags, RNEXT/PNEXT and TLEN."""
        flat = self.surject_batch([a for p in pairs for a in p])
        out: List[SamRecord] = []
        for pi, (a1, a2) in enumerate(pairs):
            r1 = flat[2 * pi]
            r2 = flat[2 * pi + 1]
            r1.flag |= FLAG_PAIRED | FLAG_FIRST
            r2.flag |= FLAG_PAIRED | FLAG_LAST
            proper = bool(a1.annotation.get("proper_pair")) if a1.annotation else False
            for r, o in ((r1, r2), (r2, r1)):
                if o.flag & FLAG_UNMAPPED:
                    r.flag |= FLAG_MATE_UNMAPPED
                elif o.flag & FLAG_REVERSE:
                    r.flag |= FLAG_MATE_REVERSE
                if proper and not (r.flag & FLAG_UNMAPPED) \
                        and not (o.flag & FLAG_UNMAPPED):
                    r.flag |= FLAG_PROPER
                if not (o.flag & FLAG_UNMAPPED):
                    r.rnext = "=" if o.rname == r.rname else o.rname
                    r.pnext = o.pos
            if (not (r1.flag & FLAG_UNMAPPED) and not (r2.flag & FLAG_UNMAPPED)
                    and r1.rname == r2.rname):
                left = min(r1.pos, r2.pos)
                right = max(r1.pos + _ref_span(r1.cigar),
                            r2.pos + _ref_span(r2.cigar))
                tlen = right - left
                r1.tlen = tlen if r1.pos <= r2.pos else -tlen
                r2.tlen = -r1.tlen
            out.append(r1)
            out.append(r2)
        return out


def _ref_span(cigar: str) -> int:
    n = 0
    total = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + int(ch)
        else:
            if ch in "MDN=X":
                total += n
            n = 0
    return total


def _parse_cigar(cigar: str) -> List[Tuple[str, int]]:
    ops: List[Tuple[str, int]] = []
    n = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + int(ch)
        else:
            ops.append((ch, n))
            n = 0
    return ops
