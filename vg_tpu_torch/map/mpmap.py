"""Multipath mapping (vg mpmap role).

Reference: MultipathMapper / MultipathAlignmentGraph
(src/multipath_mapper.cpp, src/multipath_alignment_graph.cpp) emit
alignment DAGs (GAMP) that preserve ambiguity: alternative local
alignments share their agreeing flanks and branch only where they
disagree. This implementation builds that structure from the giraffe
engine's scored candidate set:

- candidates that share a placement neighborhood are FACTORED into a
  within-alignment DAG — common mapping prefix subpath -> one branch
  subpath per distinct middle -> common suffix subpath (the alignment-
  DAG shape the reference builds for SNP/indel ambiguity);
- candidates at unrelated placements stay separate start subpaths
  (mapping ambiguity, like the reference's multimappings).

Copied from vg_tpu/map/mpmap.py.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..io.fastq import Read
from ..io.gam import Mapping, Path
from ..io.gamp import MultipathAlignment, Subpath
from .giraffe import GiraffeMapper
from .mapq import mapq_exact


def _mapping_key(mp: Mapping) -> Tuple:
    return (mp.position.node_id, mp.position.offset,
            mp.position.is_reverse,
            tuple((e.from_length, e.to_length, e.sequence)
                  for e in mp.edits))


def _score_mappings(mps: Sequence[Mapping], scoring) -> int:
    s = 0
    for mp in mps:
        for e in mp.edits:
            if e.from_length == e.to_length and not e.sequence:
                s += e.from_length * scoring.match
            elif e.from_length == e.to_length:
                s -= e.from_length * scoring.mismatch
            else:
                g = max(e.from_length, e.to_length)
                s -= scoring.gap_open + (g - 1) * scoring.gap_extend
    return s


def factor_alignments(paths: List[Path], scores: List[int],
                      scoring) -> Tuple[List[Subpath], List[int]]:
    """Factor alternative full alignments into a subpath DAG: shared
    mapping prefix and suffix become common subpaths, distinct middles
    become branches (the MultipathAlignmentGraph shape for the
    SNP/indel-ambiguity case)."""
    seqs = [[(m, _mapping_key(m)) for m in p.mappings] for p in paths]
    keys = [[k for _, k in s] for s in seqs]
    npfx = 0
    while all(len(k) > npfx for k in keys) and \
            all(k[npfx] == keys[0][npfx] for k in keys):
        npfx += 1
    nsfx = 0
    while all(len(k) - npfx > nsfx for k in keys) and \
            all(k[len(k) - 1 - nsfx] == keys[0][len(keys[0]) - 1 - nsfx]
                for k in keys):
        nsfx += 1
    if npfx == 0 and nsfx == 0:
        # nothing shared: plain alternatives
        return ([Subpath(path=p, score=s)
                 for p, s in zip(paths, scores)],
                list(range(len(paths))))
    subs: List[Subpath] = []
    start: List[int] = []
    mk_path = lambda mps: Path(mappings=[m for m in mps])
    pre_id = -1
    if npfx:
        pre = [m for m, _ in seqs[0][:npfx]]
        subs.append(Subpath(path=mk_path(pre),
                            score=_score_mappings(pre, scoring)))
        pre_id = 0
        start = [0]
    mids: List[int] = []
    seen_mid = {}
    for si, s in enumerate(seqs):
        mid = [m for m, _ in s[npfx : len(s) - nsfx]]
        key = tuple(k for k in keys[si][npfx : len(s) - nsfx])
        if key in seen_mid:
            continue
        sp = Subpath(path=mk_path(mid) if mid else None,
                     score=_score_mappings(mid, scoring))
        seen_mid[key] = len(subs)
        mids.append(len(subs))
        subs.append(sp)
        if pre_id >= 0:
            subs[pre_id].next.append(seen_mid[key])
        else:
            start.append(seen_mid[key])
    if nsfx:
        suf = [m for m, _ in seqs[0][len(seqs[0]) - nsfx:]]
        sid = len(subs)
        subs.append(Subpath(path=mk_path(suf),
                            score=_score_mappings(suf, scoring)))
        for mi in mids:
            subs[mi].next.append(sid)
    # empty middles (pure prefix+suffix alternative — a deletion allele):
    # connect prefix straight to suffix via the empty subpath, which is
    # kept (carrying its negative gap score) so scores stay additive
    return subs, start


class MultipathMapper:
    def __init__(self, mapper: GiraffeMapper, max_alternates: int = 4):
        self.mapper = mapper
        self.max_alternates = max_alternates

    def map_batch(self, reads: Sequence[Read]) -> List[MultipathAlignment]:
        from ..ops.align import Scoring

        m = self.mapper
        p = m.params
        scoring = Scoring(p.match, p.mismatch, p.gap_open, p.gap_extend,
                          p.full_length_bonus)
        sb = m.score_reads(reads)
        out: List[MultipathAlignment] = []
        for i, r in enumerate(reads):
            scores = sb.scores[i]
            valid = sb.cand_valid[i] & (scores > 0)
            mp = MultipathAlignment(name=r.name, sequence=r.sequence)
            if not valid.any():
                out.append(mp)
                continue
            order = np.argsort(-np.where(valid, scores, -1))
            js = [int(j) for j in order if valid[j]][: self.max_alternates]
            vs = scores[valid].astype(np.float64)
            which = int(np.nonzero(np.nonzero(valid)[0] == js[0])[0][0])
            mp.mapping_quality = mapq_exact(vs, which=which)
            paths: List[Path] = []
            pscores: List[int] = []
            alns = []
            for j in js:
                aln = m.emit(sb, i, j, 0)
                if aln.path is None:
                    continue
                alns.append((j, aln))
                paths.append(aln.path)
                pscores.append(aln.score)
            # novel splice discovery on a softclipped winner (reference
            # spliced alignment in multipath_mapper.cpp via splicing.cpp;
            # min_softclip_length_for_splice=20): the spliced result
            # becomes two subpaths joined by a Connection
            if alns:
                from ..io.gamp import Connection
                from .splice import try_splice

                j0, a0 = alns[0]
                spl = try_splice(m.haps, sb, i, j0, a0,
                                 band_radius=p.band_radius,
                                 scoring=scoring)
                if spl is not None:
                    seg_paths, _gain, hit, _rev = spl
                    s1 = _score_mappings(seg_paths[0].mappings, scoring)
                    s2 = _score_mappings(seg_paths[1].mappings, scoring)
                    mp.subpaths = [
                        Subpath(path=seg_paths[0], score=s1,
                                connection=[Connection(
                                    next=1, score=hit.junction_score)]),
                        Subpath(path=seg_paths[1], score=s2),
                    ]
                    mp.start = [0]
                    out.append(mp)
                    continue
            if paths:
                mp.subpaths, mp.start = factor_alignments(
                    paths, pscores, scoring)
            out.append(mp)
        return out

    def _build_one(self, sb, i: int, chosen_j: int, mapq: int,
                   scoring) -> MultipathAlignment:
        """Multipath record for read i with `chosen_j` as the primary
        candidate (pairing may have picked a non-top candidate);
        alternates factor into the subpath DAG, a softclipped primary
        attempts novel splice discovery."""
        from ..io.gamp import Connection
        from .splice import try_splice

        m = self.mapper
        r = sb.reads[i]
        scores = sb.scores[i]
        valid = sb.cand_valid[i] & (scores > 0)
        mp = MultipathAlignment(name=r.name, sequence=r.sequence,
                                mapping_quality=int(mapq))
        if not valid.any():
            return mp
        order = np.argsort(-np.where(valid, scores, -1))
        js = [int(chosen_j)] + [int(j) for j in order
                                if valid[j] and int(j) != int(chosen_j)]
        js = js[: self.max_alternates]
        paths: List[Path] = []
        pscores: List[int] = []
        first_aln = None
        for j in js:
            aln = m.emit(sb, i, j, 0)
            if aln.path is None:
                continue
            if first_aln is None:
                first_aln = (j, aln)
            paths.append(aln.path)
            pscores.append(aln.score)
        if first_aln is not None:
            j0, a0 = first_aln
            spl = try_splice(m.haps, sb, i, j0, a0,
                             band_radius=m.params.band_radius,
                             scoring=scoring)
            if spl is not None:
                seg_paths, _gain, hit, _rev = spl
                s1 = _score_mappings(seg_paths[0].mappings, scoring)
                s2 = _score_mappings(seg_paths[1].mappings, scoring)
                mp.subpaths = [
                    Subpath(path=seg_paths[0], score=s1,
                            connection=[Connection(
                                next=1, score=hit.junction_score)]),
                    Subpath(path=seg_paths[1], score=s2)]
                mp.start = [0]
                return mp
        if paths:
            mp.subpaths, mp.start = factor_alignments(paths, pscores,
                                                      scoring)
        return mp

    def map_pairs(self, pairs) -> List[Tuple[MultipathAlignment,
                                             MultipathAlignment]]:
        """Paired multipath mapping (the reference mpmap's standard RNA
        mode): pair selection + fragment model from the giraffe paired
        machinery, multipath DAGs per end with the pair-selected
        candidate primary, mates linked via paired_read_name
        (reference multipath_alignment_emitter.cpp:109)."""
        from ..ops.align import Scoring
        from .paired import PairedGiraffeMapper

        m = self.mapper
        p = m.params
        scoring = Scoring(p.match, p.mismatch, p.gap_open, p.gap_extend,
                          p.full_length_bonus)
        pm = PairedGiraffeMapper(m)
        sb1, sb2 = pm.score_pairs(pairs)
        if not pm.fragdist.finalized:
            pm._observe_batch(sb1, sb2)
            pm.fragdist.finalize()
        pm._rescue(sb1, sb2)
        pm._rescue(sb2, sb1)
        j1, j2, mq1, mq2, any1, any2, use_pair, frags = \
            pm._pair_select(sb1, sb2)
        out = []
        for i in range(len(pairs)):
            mp1 = self._build_one(sb1, i, int(j1[i]), int(mq1[i]), scoring)
            mp2 = self._build_one(sb2, i, int(j2[i]), int(mq2[i]), scoring)
            mp1.paired_read_name = mp2.name
            mp2.paired_read_name = mp1.name
            out.append((mp1, mp2))
        return out

    def map_batch_gam(self, reads: Sequence[Read]):
        """GAM-flavored output: one linear Alignment per read with
        spliced winners stitched into a single path (the surjector
        recognizes the reference-coordinate jump and emits N)."""
        from .splice import stitch_paths, try_splice

        m = self.mapper
        p = m.params
        from ..ops.align import Scoring

        scoring = Scoring(p.match, p.mismatch, p.gap_open, p.gap_extend,
                          p.full_length_bonus)
        sb = m.score_reads(reads)
        alns = m.emit_batch(sb)
        for i, aln in enumerate(alns):
            if aln.path is None or not aln.path.mappings:
                continue
            scores = sb.scores[i]
            valid = sb.cand_valid[i] & (scores > 0)
            if not valid.any():
                continue
            j = int(np.argmax(np.where(valid, scores, -1)))
            spl = try_splice(m.haps, sb, i, j, aln,
                             band_radius=p.band_radius, scoring=scoring)
            if spl is None:
                continue
            seg_paths, gain, hit, _rev = spl
            aln.path = stitch_paths(seg_paths)
            aln.score = int(aln.score) + int(gain)
            aln.annotation["splice_junction"] = float(hit.intron_len)
        return alns
