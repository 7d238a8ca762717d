"""Novel splice junction discovery (mpmap's unannotated-splicing role).

The reference detects splicing the pantranscriptome doesn't already
annotate during multipath mapping (src/splicing.cpp, 1999 LoC; spliced
alignment driven from src/multipath_mapper.cpp): an alignment with a
long softclip (min_softclip_length_for_splice = 20,
multipath_mapper.hpp:663) may be a read spanning an intron; the clipped
tail is re-aligned downstream within max_intron_length = 2^18
(multipath_mapper.hpp:196), candidate junctions are scored with the
canonical splice motifs (GT-AG / GC-AG / AT-AC, human frequencies from
Burset et al. 2000, splicing.cpp:25-29) and a lognormal intron-length
mixture trained on GENCODE v29 (splicing.cpp:31-44).

On the haplotype text this is direct: the donor side is where the
aligned segment ends, the acceptor is found by seeding the clipped tail
in the downstream window, and the junction offset is refined over a
small shift range (the DP may have absorbed a few spliced bases as
matches — max_softclip_overlap = 8, multipath_mapper.hpp:192).

Copied from vg_tpu/map/splice.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

# canonical motifs as dna codes (A=0 C=1 G=2 T=3), with their human
# frequencies (reference splicing.cpp:25-29); scores are
# round(ln(freq)/lambda) in match-score units (lambda for 1/-4 scoring)
_LAMBDA = 1.3863
SPLICE_MOTIFS: List[Tuple[Tuple[int, int], Tuple[int, int], int]] = []
for _donor, _acc, _freq in ((("G", "T"), ("A", "G"), 0.9924),
                            (("G", "C"), ("A", "G"), 0.0069),
                            (("A", "T"), ("A", "C"), 0.0005)):
    _code = {"A": 0, "C": 1, "G": 2, "T": 3}
    d = (_code[_donor[0]], _code[_donor[1]])
    a = (_code[_acc[0]], _code[_acc[1]])
    s = int(round(math.log(_freq) / _LAMBDA))
    SPLICE_MOTIFS.append((d, a, s))
    # reverse-strand transcript: the forward text shows the reverse
    # complement of the motif pair in swapped order (GT..AG -> CT..AC)
    rc = {0: 3, 1: 2, 2: 1, 3: 0}
    d_rc = (rc[a[1]], rc[a[0]])
    a_rc = (rc[d[1]], rc[d[0]])
    SPLICE_MOTIFS.append((d_rc, a_rc, s))

# lognormal intron-length mixture (weights; (mu, sigma)) — reference
# splicing.cpp:31-44 (GENCODE v29)
_MIX_W = (0.056053626960353785, 0.08887092416144658, 0.24633134729683695,
          0.0008866793308038118, 0.6078574222505589)
_MIX_P = ((4.531698286987208, 0.137211790877491),
          (5.272613870298457, 0.432711724560919),
          (9.092960704882925, 1.3246330622550786),
          (0.6443259788228138, 0.5969347049425677),
          (7.256815224883574, 1.0409647232592127))


def intron_length_log_prob(length: float) -> float:
    """log of the mixture density at the given intron length."""
    if length <= 0:
        return -math.inf
    x = math.log(length)
    total = 0.0
    for w, (mu, sig) in zip(_MIX_W, _MIX_P):
        total += w * math.exp(-((x - mu) ** 2) / (2 * sig * sig)) / (
            length * sig * math.sqrt(2 * math.pi))
    return math.log(total) if total > 0 else -math.inf


# density at the dominant component's mode, for a 0-maximum score
_BEST_LOG_PROB = max(intron_length_log_prob(math.exp(mu))
                     for mu, _ in _MIX_P)


def intron_score(length: int) -> int:
    """Length plausibility in match-score units, <= 0 (normalized so the
    most typical intron length scores 0)."""
    lp = intron_length_log_prob(float(length))
    if not math.isfinite(lp):
        return -(10 ** 6)
    return int(round((lp - _BEST_LOG_PROB) / _LAMBDA))


def _motif_score(text: np.ndarray, intron_start: int,
                 intron_end: int) -> Optional[int]:
    """Score of the splice motif at intron [start, end), or None when the
    boundary is not a recognized motif (the reference only splices at
    motif boundaries)."""
    if intron_start + 2 > len(text) or intron_end - 2 < 0:
        return None
    d = (int(text[intron_start]), int(text[intron_start + 1]))
    a = (int(text[intron_end - 2]), int(text[intron_end - 1]))
    best = None
    for dm, am, s in SPLICE_MOTIFS:
        if d == dm and a == am:
            best = s if best is None else max(best, s)
    return best


@dataclass
class SpliceHit:
    junction_read: int     # clip bases left of the junction (stay put)
    donor_end: int         # text position of the intron start
    acceptor: int          # text position just past the intron
    intron_len: int
    score_gain: int        # spliced score - softclipped score
    tail_mism: np.ndarray  # mismatch mask of the re-aligned tail
    tail_pos: int = 0      # text position where the tail sits (differs
                           # from acceptor when the junction shifted into
                           # the aligned segment)
    moved: int = 0         # read bases pulled across the junction from
                           # the aligned segment (junction shift < 0)
    junction_score: int = 0  # motif + intron-length score alone (the
                             # GAMP Connection score)


def _probe_hits(window: np.ndarray, probe: np.ndarray,
                cap: int = 64) -> np.ndarray:
    n = len(window) - len(probe) + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    ok = np.ones(n, bool)
    for j in range(len(probe)):
        ok &= window[j : j + n] == probe[j]
    hits = np.nonzero(ok)[0]
    return hits[:cap]


def find_splice_right(text: np.ndarray, donor_end: int,
                      clip: np.ndarray, *,
                      min_intron: int = 30,
                      max_intron: int = 1 << 18,
                      max_shift: int = 8,
                      min_clip: int = 20,
                      match: int = 1, mismatch: int = 4,
                      full_length_bonus: int = 5
                      ) -> Optional[SpliceHit]:
    """A right-softclipped alignment ends at text position `donor_end`
    with `clip` oriented read bases unaligned. Search the downstream
    window for a motif-bounded placement of the tail; return the best
    junction when splicing scores better than leaving the clip.

    Softclips are free in the DP, so the unspliced baseline is 0 and a
    junction is accepted when tail matches + motif + length score +
    the regained full-length bonus are positive."""
    L = len(clip)
    if L < min_clip or donor_end + min_intron >= len(text):
        return None
    win_lo = max(0, donor_end + min_intron - max_shift)
    win_hi = min(len(text), donor_end + max_intron + L + max_shift)
    window = text[win_lo:win_hi]
    probe_at = max_shift + 4
    if probe_at + 16 > L:
        probe_at = max(0, L - 16)
    probe = clip[probe_at : probe_at + 16]
    if len(probe) < 12:
        return None
    best: Optional[SpliceHit] = None
    for o in _probe_hits(window, probe):
        a0 = win_lo + int(o) - probe_at     # acceptor if junction at clip[0]
        for s in range(-max_shift, max_shift + 1):
            acceptor = a0 + s
            d_end = donor_end + s
            intron = a0 - donor_end         # invariant under the shift
            if intron < min_intron or intron > max_intron:
                continue
            ms = _motif_score(text, d_end, acceptor)
            if ms is None:
                continue
            # gapless re-score of the tail at its new home. s>0: the
            # first s clip bases move into the donor exon (not counted,
            # conservative); s<0: |s| previously-matched read bases move
            # across the junction and lose their old matches.
            tail = clip[max(s, 0):]
            tpos = a0 + max(s, 0)
            seg = text[tpos : tpos + len(tail)]
            if len(seg) < len(tail):
                continue
            mism = seg != tail
            nm = int(mism.sum())
            nmatch = len(tail) - nm
            moved = -min(s, 0)
            jscore = ms + intron_score(intron)
            gain = (nmatch * match - nm * mismatch + jscore
                    - moved * match + full_length_bonus)
            if gain > 0 and (best is None or gain > best.score_gain):
                best = SpliceHit(
                    junction_read=L - len(tail), donor_end=d_end,
                    acceptor=acceptor, intron_len=intron,
                    score_gain=gain, tail_mism=mism, tail_pos=tpos,
                    moved=moved, junction_score=jscore)
    return best


def find_splice_left(text: np.ndarray, acceptor_start: int,
                     clip: np.ndarray, **kw) -> Optional[SpliceHit]:
    """Mirror case: a LEFT softclip whose exon lies UPSTREAM of the
    aligned segment starting at `acceptor_start`. Solved by reverse-
    complementing text and clip (which maps donor/acceptor motifs onto
    the same alphabet) and reusing the right-side search.

    Returned fields, forward coordinates:
      donor_end   = START of the upstream tail segment in the text
      acceptor    = intron END (exclusive) = where the main segment
                    resumes (may differ from acceptor_start by the
                    junction shift)
      junction_read = number of clip bases covered by the tail segment
      tail_mism   = mismatch mask of the tail, forward read order
    """
    T = len(text)
    comp = np.array([3, 2, 1, 0, 4, 5], np.uint8)
    rt = comp[text][::-1]
    rc = comp[clip][::-1]
    hit = find_splice_right(rt, T - acceptor_start, rc, **kw)
    if hit is None:
        return None
    tail_len = len(hit.tail_mism)
    tail_start = T - (hit.tail_pos + tail_len)
    return SpliceHit(
        junction_read=tail_len,
        donor_end=tail_start,                      # tail START fwd
        acceptor=T - hit.donor_end,                # intron end fwd
        intron_len=hit.intron_len,
        score_gain=hit.score_gain,
        tail_mism=hit.tail_mism[::-1].copy(),
        tail_pos=tail_start,
        moved=hit.moved, junction_score=hit.junction_score)


# ------------------------------------------------------------ application

def build_spliced_paths(haps, oriented: np.ndarray, segs,
                        lead_clip: int = 0, tail_clip: int = 0,
                        is_rev: bool = False):
    """Graph Paths for the gapless exon segments of a spliced read.

    segs = [(text_lo, text_hi, read_lo), ...] in oriented-read order;
    `oriented` is the read codes already oriented to the text. Returns
    one Path per segment plus softclip edits attached to the outer ends
    (GAM convention: insertion edits at path extremes). For reverse
    reads each returned Path is flipped to the original strand and the
    list order reversed (read order on the original strand)."""
    from ..io.gam import Edit
    from ..utils import dna
    from .project import gapless_path, reverse_complement_path

    text = haps.text
    paths = []
    for (tlo, thi, rlo) in segs:
        n = thi - tlo
        seg_read = oriented[rlo : rlo + n]
        mism = text[tlo:thi] != seg_read
        p = gapless_path(haps, tlo, thi, mism, dna.decode(seg_read), False)
        paths.append(p)
    if lead_clip and paths:
        first = paths[0].mappings[0]
        seq = dna.decode(oriented[:lead_clip])
        first.edits.insert(0, Edit(from_length=0, to_length=lead_clip,
                                   sequence=seq))
    if tail_clip and paths:
        last = paths[-1].mappings[-1]
        seq = dna.decode(oriented[len(oriented) - tail_clip:])
        last.edits.append(Edit(from_length=0, to_length=tail_clip,
                               sequence=seq))
    if is_rev:
        paths = [reverse_complement_path(haps.graph, p)
                 for p in reversed(paths)]
    return paths


def stitch_paths(paths) -> "Path":
    """One linear Path from segment Paths (mappings concatenated, ranks
    renumbered) — the GAM representation of a spliced alignment; the
    surjector recognizes the reference-coordinate jump between segments
    and emits N (spliced_surject role, reference surjector.cpp:369)."""
    from ..io.gam import Path

    mappings = []
    for p in paths:
        mappings.extend(p.mappings)
    for r, m in enumerate(mappings):
        m.rank = r + 1
    return Path(mappings=mappings)


def try_splice(haps, sb, i: int, j: int, aln, *, min_clip: int = 20,
               band_radius: int = 16, scoring=None):
    """Detect and apply a novel splice on a softclipped winner.

    sb = the ScoredBatch, (i, j) the winner, aln its emitted Alignment.
    Returns (paths, connection_score, hit, is_rev) for a spliced read or
    None. Only gapless winners are attempted (the exon part of a spliced
    read aligns gapless; indel winners are a different signal).

    Segment arithmetic (both sides): the tail segment always reaches its
    read end/start, absorbing `moved` bases the junction shift pulled
    across; the main segment keeps the remaining read interval — the two
    are contiguous in read space by construction."""
    if aln.path is None or not aln.path.mappings:
        return None
    mappings = aln.path.mappings
    fe = mappings[0].edits
    le = mappings[-1].edits
    clip_left = fe[0].to_length if fe and fe[0].from_length == 0 else 0
    clip_right = le[-1].to_length if le and le[-1].from_length == 0 else 0
    if max(clip_left, clip_right) < min_clip:
        return None
    for m in mappings:
        for e in m.edits:
            if e.from_length != e.to_length and not (
                    e.from_length == 0 and (e is fe[0] or e is le[-1])):
                return None     # indel winner: not the splice signal
    codes = sb.codes[i]
    L = len(codes)
    rev = bool(sb.cand_rev[i, j])
    oriented = sb.codes_rc[i] if rev else codes
    if rev:
        clip_left, clip_right = clip_right, clip_left
    # gapless winners sit on the seed diagonal: text interval of the
    # aligned part
    diag = int(sb.cand_start[i, j]) + band_radius
    t0 = diag + clip_left
    t1 = diag + L - clip_right
    text = haps.text
    match = getattr(scoring, "match", 1)
    mismatch = getattr(scoring, "mismatch", 4)
    bonus = getattr(scoring, "full_length_bonus", 5)
    kw = dict(min_clip=min_clip, match=match, mismatch=mismatch,
              full_length_bonus=bonus)
    best = None
    if clip_right >= min_clip:
        hit = find_splice_right(text, t1, oriented[L - clip_right :], **kw)
        if hit is not None:
            tl = len(hit.tail_mism) + hit.moved
            segs = [(t0, hit.donor_end, clip_left),
                    (hit.acceptor, hit.acceptor + tl, L - tl)]
            best = (segs, clip_left, 0, hit)
    if best is None and clip_left >= min_clip:
        hit = find_splice_left(text, t0, oriented[:clip_left], **kw)
        if hit is not None:
            tl = len(hit.tail_mism) + hit.moved
            segs = [(hit.donor_end, hit.donor_end + tl, 0),
                    (hit.acceptor, t1, tl)]
            best = (segs, 0, clip_right, hit)
    if best is None:
        return None
    segs, lead, tail, hit = best
    segs = [(a, b, r) for (a, b, r) in segs if b > a]
    if len(segs) != 2:
        return None
    # read-space contiguity sanity (the derivation above guarantees it)
    if segs[0][2] + (segs[0][1] - segs[0][0]) != segs[1][2]:
        return None
    paths = build_spliced_paths(haps, oriented, segs,
                                lead_clip=lead, tail_clip=tail,
                                is_rev=rev)
    return paths, hit.score_gain, hit, rev
