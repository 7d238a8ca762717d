"""Giraffe-style haplotype-aware short-read mapper, TPU-native.

Pipeline (reference: MinimizerMapper::map_from_extensions,
src/minimizer_mapper.cpp:608 — minimizer → seed → cluster → extend →
align → winner/mapq):

1. **minimizers**: (k,w) canonical minimizers of the read (host, vectorized
   numpy — same code path the index build uses).
2. **seeds**: hash lookup into the MinimizerIndex with vg's hit caps and
   score weighting (score = 1 + ln(hard_hit_cap) - ln(hits), reference
   src/minimizer_mapper.cpp:3918-3931; caps :4349-4360).
3. **cluster**: seeds that agree on (strand, text diagonal) within the DP
   band are one candidate placement. Because seeds live on the flat
   haplotype text, vg's snarl-tree distance clustering
   (src/snarl_seed_clusterer.cpp) reduces to a sort + gap split on
   diagonals; candidates that project to the same graph placement across
   haplotypes are deduplicated (the GBWT gives vg the same dedup for free).
4. **extend/align**: one batched banded DP on device scores every
   (read, candidate) window — vg_tpu.ops.align.banded_scores subsumes both
   the gapless extension stage (a zero-gap path through the DP) and the
   dozeu/GSSW tail alignment.
5. **winner/mapq**: best candidate per read; exact log-sum-exp MAPQ over
   the candidate score set (vg_tpu.map.mapq), clamped to 60.
6. traceback + projection to graph Path + refpos annotation (host).

Fixed-shape batching: reads pad to a length bucket, candidates pad to
``max_candidates`` — vg's own stage caps (max_extensions, max_alignments)
become the padding bounds (SURVEY.md §7 design stance).

Ported from vg_tpu/map/giraffe.py: the device work (text upload, resident
index arrays, the packed single-end steps with host or device seeding, the
DP dispatch, quality-adjusted or not) runs in torch on the mapper's device,
whose banded DP is the CUDA kernel of ops/cuda_align.py and whose device
seeding runs the kernels of ops/cuda_seed.py. The host stages are
unchanged.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..index.haplotypes import HaplotypeSet
from ..index.minimizer import MinimizerIndex, extract_minimizers
from ..io.fastq import Read
from ..io.gam import Alignment, Path
from ..ops import align as align_ops
from ..ops.traceback import banded_traceback
from ..utils import dna
from .mapq import mapq_exact
from .project import PathPositionIndex, text_alignment_to_path


# distinct-placement dedup window (bp of reference projection):
# haplotype copies of ONE placement project within a few bp of each
# other (small indel-allele jitter), while tandem-repeat ALIASES sit a
# period apart — a window wider than common repeat periods merges real
# alternatives and inflates MAPQ on low-complexity reads (measured:
# 6/256 wrong@60 at 75bp vs 2/256 at 16bp on 1mb1kgp low-entropy reads)
PLACEMENT_TOL = 16

def resolve_device(device=None) -> torch.device:
    """The mapper's device: None means the card. Asking for CUDA where
    there is none is an error, never a silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vg_tpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


def to_host(x) -> np.ndarray:
    """Fetch a device result as a writable numpy array (the sync point for
    CUDA tensors; CPU tensors are copied so the array owns its memory)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy() if x.is_cuda else x.numpy().copy()
    return np.asarray(x)


@dataclass
class GiraffeParams:
    hit_cap: int = 10                 # soft cap (reference: default preset)
    hard_hit_cap: int = 500
    score_fraction: float = 0.9
    max_candidates: int = 8           # ~ max_alignments
    band_radius: int = 16
    # device-side seeding (ops/devseed.py): minimizers, lookup, soft caps,
    # clustering and top-C on the device, from the packed reads alone —
    # no host candidate tables in either direction (the seeded steps of
    # GiraffeMapper and PairedGiraffeMapper)
    device_seed: bool = False
    # suffix-array MEM re-seeding for zero-candidate reads (dense-variant
    # recombinants; reference giraffe has no scale cliff here —
    # src/mapper.hpp:210, src/mem.cpp). The SA is built lazily by native
    # SA-IS (linear: ~17 s / 100 Mbp), capped only by the int32 SA
    # position limit; the reference's GCSA2 MEM source works at any
    # scale the same way.
    mem_fallback: bool = True
    # the sharded MEMIndex removed the SA BUILD ceiling (chunk-local
    # int32 coordinates), but the candidate wire (cand_start/lo/hi,
    # ScoredBatch int32 arrays) is the mapper-wide text envelope:
    # reseed diagonals above 2^31 would silently wrap downstream, so
    # the fallback stays gated at the same int32 bound as the rest of
    # the short-read pipeline instead of pretending to more
    mem_fallback_max_text: int = (1 << 31) - 1
    # sort each batch's reads by their best candidate's text position
    # before the device dispatch (unsorted at fetch): the DP window
    # gather then walks HBM near-sequentially instead of randomly —
    # a pure permutation round-trip, bit-identical records
    locality_sort: bool = True
    pad_quantum: int = 32
    batch_reads: int = 512            # device batch (pad to fixed shape)
    max_mapq: int = 60
    match: int = 1
    mismatch: int = 4
    gap_open: int = 6
    gap_extend: int = 1
    full_length_bonus: int = 5
    track_provenance: bool = False    # --track-provenance (funnel stats)
    # base-quality-adjusted DP scoring (QualAdjAligner role, reference
    # src/aligner.hpp:218): mpmap always, vg map when qualities present
    qual_adjusted: bool = False
    # graph-space POA fallback (the dozeu/GSSW-over-extracted-graph role,
    # reference src/minimizer_mapper.cpp:3319-3424): reads whose best
    # haplotype-text score stays below graph_fallback_frac * L realign
    # against the local graph, so allele combinations on no indexed
    # haplotype (recombinants, novel indels) still place correctly
    graph_fallback: bool = True
    graph_fallback_frac: float = 0.6
    graph_fallback_min_clip: int = 10  # clips below this realign cheaper
                                       # as mismatches than a POA could gain
    graph_fallback_radius: int = 64   # extra bp of graph context
    graph_fallback_max_bases: int = 1200  # POA region size cap


@dataclass
class ScoredBatch:
    """Seeded + device-scored read batch (per-read candidate tables).

    ``scores_raw`` may hold the un-fetched device array: the DP dispatch is
    asynchronous, so a caller can score batch i+1 before reading batch i's
    scores (map_stream pipelines on this)."""
    reads: List[Read]
    codes: List[np.ndarray]
    codes_rc: List[np.ndarray]
    cand_start: np.ndarray   # (R, C) int32 window starts (diag - B)
    cand_lo: np.ndarray
    cand_hi: np.ndarray
    cand_rev: np.ndarray
    cand_valid: np.ndarray
    scores_raw: object       # (R, C) int32 DP scores
    cand_refpath: Optional[np.ndarray] = None   # (R, C) ref path id or -1
    cand_refoff: Optional[np.ndarray] = None    # (R, C) approx ref offset (device or host array)
    codes2d: Optional[np.ndarray] = None        # (>=R, RL) padded codes
    codes_rc2d: Optional[np.ndarray] = None
    # (dev_j, mm, bits): device-computed winner mismatch bitmaps for the
    # selection dev_j — rows whose chosen j differs recompute on host
    winner_mism: Optional[tuple] = None

    @property
    def scores(self) -> np.ndarray:
        if not isinstance(self.scores_raw, np.ndarray):
            self.scores_raw = to_host(self.scores_raw)
        return self.scores_raw

    def diag(self) -> np.ndarray:
        return self.cand_start  # + band_radius gives the seed diagonal

    def split(self, n: int) -> Tuple["ScoredBatch", "ScoredBatch"]:
        """Split into the first n reads and the rest. Slicing scores_raw
        on-device keeps the DP fetch lazy, so a folded two-mate dispatch
        (paired path) splits without forcing a transfer."""
        R = len(self.reads)

        def view(lo, hi):
            cut = (lambda x: None if x is None else x[lo:hi])
            return ScoredBatch(
                self.reads[lo:hi], self.codes[lo:hi], self.codes_rc[lo:hi],
                self.cand_start[lo:hi], self.cand_lo[lo:hi],
                self.cand_hi[lo:hi], self.cand_rev[lo:hi],
                self.cand_valid[lo:hi], self.scores_raw[lo:hi],
                cand_refpath=cut(self.cand_refpath),
                cand_refoff=cut(self.cand_refoff),
                codes2d=cut(self.codes2d),
                codes_rc2d=cut(self.codes_rc2d))

        return view(0, n), view(n, R)


def str_blob(strs: Sequence[str]):
    """(offsets int64, uint8 blob) over a list of ASCII strings via ONE
    join + ONE encode — per-item str.encode was ~2 us/read of emit time
    at production batch sizes. Non-ASCII input falls back to per-item
    encoding (lengths then come from the encoded bytes)."""
    n = len(strs)
    off = np.zeros(n + 1, np.int64)
    joined = "".join(strs)
    enc = joined.encode()
    if len(enc) == len(joined):            # pure ASCII: len(str)==bytes
        np.cumsum(np.fromiter(map(len, strs), np.int64, n), out=off[1:])
    else:
        parts = [s.encode() for s in strs]
        np.cumsum([len(p) for p in parts], out=off[1:])
        enc = b"".join(parts)
    return off, np.frombuffer(enc or b"\0", np.uint8)


def qual_blob(quals: Sequence[Optional[str]]):
    """(offsets int64, uint8 blob) of phred values (ASCII char - 33)
    from FASTQ quality strings (None/'' for absent) — one vectorized
    subtract instead of a per-character Python generator."""
    strs = [q or "" for q in quals]
    off, arr = str_blob(strs)
    if int(off[-1]):
        arr = arr - 33
    return off, arr


def _soft_cap_select(ridx: np.ndarray, mscore: np.ndarray,
                     counts: np.ndarray, hit_cap: int,
                     score_fraction: float) -> np.ndarray:
    """Per-read greedy minimizer selection (vectorized over reads).

    ridx must be sorted by read (extract_minimizers_batch order). Returns
    a boolean take-mask aligned with the inputs."""
    n = len(ridx)
    if n == 0:
        return np.zeros(0, bool)
    order = np.lexsort((-mscore, ridx))
    r_s = ridx[order]
    sc = mscore[order]
    cheap = counts[order] <= hit_cap
    first = np.ones(n, bool)
    first[1:] = r_s[1:] != r_s[:-1]
    gstart = np.nonzero(first)[0]
    gend = np.append(gstart[1:], n)
    gix = np.cumsum(first) - 1
    total = np.bincount(gix, weights=sc)
    budget = score_fraction * total
    taken = np.zeros(len(gstart))
    take = np.zeros(n, bool)
    max_rank = int((gend - gstart).max())
    for rk in range(max_rank):
        pos = gstart + rk
        live = pos < gend
        p_live = pos[live]
        g_live = np.nonzero(live)[0]
        t = cheap[p_live] | (taken[g_live] < budget[g_live])
        take[p_live] = t
        taken[g_live] += np.where(t, sc[p_live], 0.0)
    out = np.zeros(n, bool)
    out[order] = take
    return out


@dataclass
class _Candidate:
    diag: int          # text position aligning to oriented-read offset 0
    is_rev: bool
    score: float       # cluster score (sum of minimizer scores)
    n_seeds: int
    lo: int            # haplotype text range
    hi: int


class GiraffeMapper:
    def __init__(self, haps: HaplotypeSet, index: MinimizerIndex,
                 params: Optional[GiraffeParams] = None,
                 ref_path_names: Optional[List[str]] = None,
                 device=None):
        from ..ops.cuda_align import pack_text

        self.haps = haps
        self.index = index
        self.params = params or GiraffeParams()
        self.graph = haps.graph
        self.device = resolve_device(device)
        # 4-bit packed haplotype text on the device: the banded-DP kernel
        # (ops/cuda_align.py) and the winner bitmaps gather from it
        self.text_packed_dev = torch.as_tensor(pack_text(haps.text),
                                               device=self.device)
        self._score_tab = None   # lazy quantized minimizer-score table
        # created here, not lazily: concurrent emitter threads racing on
        # a lazy getattr could each assign a fresh dict and drop the
        # other's entries (same fix as PairedGiraffeMapper._pair_steps)
        self._gf_cache: dict = {}      # graph-fallback (sub, dag) cache
        self._espans_prof: dict = {}   # emit sub-stage profile seconds
        # the MAPQ cap's index keys on the device and, on the card, its
        # stream: built once by whichever emitter thread gets there first
        self._cap_lock = threading.Lock()
        self._cap_state = None
        ref_names = ref_path_names
        if ref_names is None:
            from ..graph.arraygraph import SENSE_REFERENCE

            ref_sense = [m.name for m in self.graph.path_meta
                         if m.sense == SENSE_REFERENCE]
            ref_names = ref_sense or [m.name for m in self.graph.path_meta
                                      if not m.name.startswith("_alt_")]
        self.path_pos = PathPositionIndex(self.graph, ref_names)
        # dense node -> (ref path id, ref offset) for pair-distance checks
        # (first occurrence wins; -1 = off every reference path)
        n = self.graph.node_count
        self._node_ref_path = np.full(n, -1, np.int32)
        self._node_ref_off = np.zeros(n, np.int64)
        self._node_ref_rev = np.zeros(n, bool)
        # occ stores GLOBAL path_meta ids; the emit path indexes the
        # LOCAL path_pos.path_names blob (they differ when the reference
        # path isn't id 0, e.g. GBZ graphs listing haplotypes first)
        local_of = {self.graph.path_index(nm): li
                    for li, nm in enumerate(self.path_pos.path_names)}
        for idx, occs in self.path_pos.occ.items():
            pi, step_off, step_rev = occs[0]
            self._node_ref_path[idx] = local_of[pi]
            self._node_ref_off[idx] = step_off
            self._node_ref_rev[idx] = step_rev
        from ..utils.funnel import Funnel

        self.funnel = Funnel()

    # ------------------------------------------------------------------ seeds

    def _score_table(self) -> np.ndarray:
        """Quantized minimizer scores (index/minimizer.py
        minimizer_score_table): exact-in-f32 sums keep candidate
        tie-breaks identical across the host, XLA and Pallas engines."""
        if self._score_tab is None:
            from ..index.minimizer import minimizer_score_table

            self._score_tab = minimizer_score_table(
                self.params.hard_hit_cap, self.params.hard_hit_cap)
        return self._score_tab

    def _seed_read(self, codes: np.ndarray) -> List[_Candidate]:
        p = self.params
        L = len(codes)
        k = self.index.k
        offs, keys, canon_rev = self.index.extract(codes)
        if len(offs) == 0:
            return []
        counts = self.index.count(keys)
        have = counts > 0
        offs, keys, canon_rev, counts = (
            offs[have], keys[have], canon_rev[have], counts[have])
        if len(offs) == 0:
            return []
        # minimizer score & selection (hit caps)
        mscore = self._score_table()[np.minimum(counts, p.hard_hit_cap)]
        order = np.argsort(-mscore, kind="stable")
        total = mscore.sum()
        taken_score = 0.0
        take = np.zeros(len(offs), dtype=bool)
        for i in order:
            c = counts[i]
            if c <= p.hit_cap:
                take[i] = True
                taken_score += mscore[i]
            elif c <= p.hard_hit_cap and taken_score < p.score_fraction * total:
                take[i] = True
                taken_score += mscore[i]
        offs, keys, canon_rev, mscore = (
            offs[take], keys[take], canon_rev[take], mscore[take])

        # seeds: (diag, strand, read_off, minimizer score)
        diags: List[int] = []
        strands: List[bool] = []
        roffs: List[int] = []
        sscores: List[float] = []
        for i in range(len(offs)):
            pos, prev = self.index.lookup(int(keys[i]))
            strand = prev != canon_rev[i]   # True: read maps reverse
            o_fwd = int(offs[i])
            o_rev = L - k - o_fwd
            for j in range(len(pos)):
                o = o_rev if strand[j] else o_fwd
                diags.append(int(pos[j]) - o)
                strands.append(bool(strand[j]))
                roffs.append(o)
                sscores.append(float(mscore[i]))
        if not diags:
            return []
        diags_a = np.array(diags)
        strands_a = np.array(strands)
        roffs_a = np.array(roffs)
        sscores_a = np.array(sscores)

        # cluster: sort by (strand, diag); split on diag gap > 2B
        order = np.lexsort((diags_a, strands_a))
        cands: List[_Candidate] = []
        gap = 2 * p.band_radius
        T = len(self.haps.text)
        i0 = 0
        idx = order
        for i in range(1, len(idx) + 1):
            boundary = i == len(idx) or (
                strands_a[idx[i]] != strands_a[idx[i0]]
                or diags_a[idx[i]] - diags_a[idx[i - 1]] > gap)
            if not boundary:
                continue
            sel = idx[i0:i]
            i0 = i
            # distinct read offsets only (multiple haplotype hits of one
            # minimizer at same placement already deduped in the index)
            ro = roffs_a[sel]
            uniq_ro, first = np.unique(ro, return_index=True)
            cscore = float(sscores_a[sel][first].sum())
            # representative diagonal: median
            diag = int(np.median(diags_a[sel]))
            anchor = int(np.clip(diag, 0, T - 1))
            hap = int(self.haps.hap_of_text_pos(anchor))
            lo = int(self.haps.text_start[hap])
            hi = int(self.haps.text_start[hap + 1])
            cands.append(_Candidate(
                diag=diag, is_rev=bool(strands_a[sel[0]]), score=cscore,
                n_seeds=len(uniq_ro), lo=lo, hi=hi))

        # dedup candidates that project to the same graph placement
        seen = {}
        for c in cands:
            a = int(np.clip(c.diag, c.lo, c.hi - 1))
            nid, off, rev = self.haps.text_pos_to_graph(a)
            key = (c.is_rev, nid, off, rev)
            if key not in seen or seen[key].score < c.score:
                seen[key] = c
        cands = sorted(seen.values(), key=lambda c: -c.score)
        return cands[: p.max_candidates]

    # -------------------------------------------------------- batch seeding

    def _seed_batch(self, codes2d: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
        """Vectorized seeding for an equal-length read batch.

        Returns candidate arrays (R, C): start, lo, hi, rev, valid —
        the numpy re-expression of find_seeds + cluster (reference:
        src/minimizer_mapper.cpp:4100, src/snarl_seed_clusterer.cpp) as
        sorts and segmented reductions over all reads at once.
        """
        from ..index.minimizer import extract_minimizers_batch

        p = self.params
        # native C++ path: the whole stage in one GIL-releasing call,
        # OpenMP over reads; numpy below is the element-identical fallback
        # (also used under --track-provenance, where the intermediate
        # counts feed the funnel's filter-loss table)
        if not p.track_provenance and self.index.plain_minimizers:
            from ..native import native_seed_batch

            res = native_seed_batch(codes2d, self.index, p, self.haps,
                                    self._node_ref_path, self._node_ref_off)
            if res is not None:
                return res
        R, L = codes2d.shape
        C = p.max_candidates
        B = p.band_radius
        k = self.index.k
        out = (np.zeros((R, C), np.int32), np.zeros((R, C), np.int32),
               np.zeros((R, C), np.int32), np.zeros((R, C), bool),
               np.zeros((R, C), bool), np.full((R, C), -1, np.int32),
               np.zeros((R, C), np.int64))
        (cand_start, cand_lo, cand_hi, cand_rev, cand_valid,
         cand_refpath, cand_refoff) = out

        ridx, offs, keys, canon_rev = self.index.extract_batch(codes2d)
        if len(ridx) == 0:
            return out
        hs, he = self.index.lookup_ranges(keys)
        counts = he - hs
        keep = (counts > 0) & (counts <= p.hard_hit_cap)
        if p.track_provenance:
            found = counts > 0
            self.funnel.filter("seed", "hard-hit-cap",
                               int(found.sum()), int(keep.sum()))
        ridx, offs, canon_rev, hs, he, counts = (
            ridx[keep], offs[keep], canon_rev[keep], hs[keep], he[keep],
            counts[keep])
        if len(ridx) == 0:
            return out
        mscore = self._score_table()[np.minimum(counts, p.hard_hit_cap)]

        # soft-cap selection, same policy as _seed_read (reference hit
        # caps, src/minimizer_mapper.cpp:4349-4360): in per-read descending
        # score order take minimizers with count <= hit_cap always, and
        # heavier ones only while the taken score is below
        # score_fraction * total. Vectorized as a short loop over ranks
        # (one item per read per iteration).
        keep2 = _soft_cap_select(ridx, mscore, counts, p.hit_cap,
                                 p.score_fraction)
        if p.track_provenance:
            self.funnel.filter("seed", "soft-hit-cap",
                               len(keep2), int(keep2.sum()))
        ridx, offs, canon_rev, hs, he, counts, mscore = (
            ridx[keep2], offs[keep2], canon_rev[keep2], hs[keep2], he[keep2],
            counts[keep2], mscore[keep2])
        if len(ridx) == 0:
            return out

        # expand hits: seed s belongs to minimizer m(s)
        midx = np.repeat(np.arange(len(ridx)), counts)
        within = np.arange(len(midx)) - np.repeat(
            np.cumsum(counts) - counts, counts)
        hit_idx = hs[midx] + within
        pos = self.index.pos_text[hit_idx]
        prev = self.index.pos_rev[hit_idx]
        strand = prev != canon_rev[midx]
        o = np.where(strand, L - k - offs[midx], offs[midx])
        diag = pos - o
        sread = ridx[midx]
        sscore = mscore[midx]
        return self._cluster_seeds_to_candidates(
            sread, strand, diag, o, sscore, out)

    def _cluster_seeds_to_candidates(self, sread, strand, diag, o, sscore,
                                     out):
        """Shared seed->candidate stage: (read, strand, diagonal) sort +
        gap split, distinct-offset cluster scoring, top-C selection, and
        haplotype/reference projection. Used by the minimizer path and by
        the MEM mapper's seeding."""
        p = self.params
        (cand_start, cand_lo, cand_hi, cand_rev, cand_valid,
         cand_refpath, cand_refoff) = out
        C = p.max_candidates
        B = p.band_radius
        if len(sread) == 0:
            return out

        # cluster: sort by (read, strand, diag); split on diag gap > 2B
        order = np.lexsort((diag, strand, sread))
        sread, strand, diag, o, sscore = (
            sread[order], strand[order], diag[order], o[order], sscore[order])
        new_c = np.ones(len(sread), dtype=bool)
        if len(sread) > 1:
            new_c[1:] = ((sread[1:] != sread[:-1])
                         | (strand[1:] != strand[:-1])
                         | (diag[1:] - diag[:-1] > 2 * B))
        cid = np.cumsum(new_c) - 1
        ncl = int(cid[-1]) + 1
        # cluster score: sum minimizer scores over distinct read offsets
        uniq = np.ones(len(sread), dtype=bool)
        ou = np.lexsort((o, cid))
        du = np.ones(len(ou), dtype=bool)
        if len(ou) > 1:
            du[1:] = (cid[ou][1:] != cid[ou][:-1]) | (o[ou][1:] != o[ou][:-1])
        uniq[ou] = du
        cl_score = np.bincount(cid, weights=np.where(uniq, sscore, 0.0),
                               minlength=ncl)
        cl_read = sread[new_c]
        cl_strand = strand[new_c]
        # median-ish representative diagonal: middle element of the run
        first = np.nonzero(new_c)[0]
        last = np.append(first[1:], len(sread)) - 1
        mid = (first + last) // 2
        cl_diag = diag[mid]

        # haplotype range per cluster
        T = len(self.haps.text)
        anchor = np.clip(cl_diag, 0, T - 1)
        hap = np.searchsorted(self.haps.text_start[1:], anchor, side="right")
        lo = self.haps.text_start[hap]
        hi = self.haps.text_start[hap + 1]

        keep_idx = np.arange(len(cl_read))

        # top-C per read by score
        o2 = np.lexsort((-cl_score[keep_idx], cl_read[keep_idx]))
        sel = keep_idx[o2]
        rr = cl_read[sel]
        firsts = np.ones(len(sel), dtype=bool)
        if len(sel) > 1:
            firsts[1:] = rr[1:] != rr[:-1]
        group_start = np.nonzero(firsts)[0]
        gix = np.cumsum(firsts) - 1
        rank = np.arange(len(sel)) - group_start[gix]
        if p.track_provenance:
            self.funnel.filter("cluster", "top-C-candidates",
                               len(sel), int((rank < C).sum()))
        final = sel[rank < C]
        rank = rank[rank < C]
        rr = cl_read[final]
        cand_start[rr, rank] = (cl_diag[final] - B).astype(np.int32)
        cand_lo[rr, rank] = lo[final].astype(np.int32)
        cand_hi[rr, rank] = hi[final].astype(np.int32)
        cand_rev[rr, rank] = cl_strand[final]
        cand_valid[rr, rank] = True
        # reference projection of the candidate read start (the same
        # diag-based formula the device derives)
        cand_refpath[:], cand_refoff[:] = self._diag_refproj(
            cand_start, cand_valid)
        return out

    # ------------------------------------------------------------------- map

    def score_reads(self, reads: Sequence[Read]) -> "ScoredBatch":
        """Seed + device-score a batch; returns everything needed to pick
        winners (single-end) or pair/rescue (paired-end)."""
        prep = self.prepare_batch(reads, want_packed2=False)
        p = self.params
        R = len(reads)
        import time as _time

        _t0 = _time.time()
        if p.qual_adjusted and R > 0 and all(
                getattr(r, "quality", None) for r in reads):
            scores_dev = self._device_scores_qual(prep, reads)[:R]
        else:
            scores_dev = self._device_scores(
                prep["reads_arr"], prep["reads_rc_arr"], prep["rlens"],
                prep["cand_start"], prep["cand_lo"], prep["cand_hi"],
                prep["cand_rev"], prep["cand_valid"], p.band_radius)[:R]
        self.funnel.record("align_dispatch", _time.time() - _t0, items_in=R)
        return ScoredBatch(
            reads=list(reads), codes=prep["codes"],
            codes_rc=prep["codes_rc"],
            cand_start=prep["cand_start"][:R], cand_lo=prep["cand_lo"][:R],
            cand_hi=prep["cand_hi"][:R], cand_rev=prep["cand_rev"][:R],
            cand_valid=prep["cand_valid"][:R], scores_raw=scores_dev,
            cand_refpath=prep["cand_refpath"],
            cand_refoff=prep["cand_refoff"],
            codes2d=prep["reads_arr"], codes_rc2d=prep["reads_rc_arr"])

    def _resident_seed_arrays(self):
        """Device-resident minimizer index (split 64-bit keys) for
        device-side seeding (ops/devseed.py)."""
        if getattr(self, "_resident_seed_dev", None) is None:
            from ..ops.devseed import split_keys

            ih, il = split_keys(self.index.keys)
            put = lambda a, dt: torch.as_tensor(np.asarray(a, dt),
                                                device=self.device)
            self._resident_seed_dev = (
                put(ih, np.int64), put(il, np.int64),
                put(self.index.offsets, np.int32),
                put(self.index.pos_text, np.int32),
                put(self.index.pos_rev, np.uint8),
                put(self._score_table(), np.float32))
        return self._resident_seed_dev

    def prepare_light(self, reads: Sequence[Read]) -> dict:
        """Encode + pad only (device-side seeding needs no host
        candidate tables)."""
        p = self.params
        R = len(reads)
        lens = np.array([len(r.sequence) for r in reads], dtype=np.int32)
        codes = [dna.encode(r.sequence) for r in reads]
        codes_rc = [dna.revcomp_codes(c) for c in codes]
        RL = max(int(np.max(lens)) if R else p.pad_quantum, p.pad_quantum)
        RL = -(-RL // p.pad_quantum) * p.pad_quantum
        Rpad = -(-R // 64) * 64
        rlens = np.zeros(Rpad, dtype=np.int32)
        rlens[:R] = lens
        reads_arr = np.full((Rpad, RL), 5, dtype=np.uint8)
        reads_rc_arr = np.full((Rpad, RL), 5, dtype=np.uint8)
        for i, c in enumerate(codes):
            reads_arr[i, : len(c)] = c
            reads_rc_arr[i, : len(c)] = codes_rc[i]
        return {"codes": codes, "codes_rc": codes_rc,
                "reads_arr": reads_arr, "reads_rc_arr": reads_rc_arr,
                "rlens": rlens}

    def prepare_batch(self, reads: Sequence[Read],
                      want_packed2: bool = True) -> dict:
        """Host half of score_reads: encode + pad + seed. Returns padded
        arrays ready for any device scorer (single or folded paired).
        want_packed2=False skips the 2-bit wire words in the fused
        encoder (single-end dispatch and 4-bit-wire mappers drop them)."""
        p = self.params
        R = len(reads)
        lens = np.array([len(r.sequence) for r in reads], dtype=np.int32)
        equal_len = R > 0 and bool(np.all(lens == lens[0]))
        rlens_real = lens
        RL = max(int(np.max(rlens_real)) if R else 0, p.pad_quantum)
        RL = -(-RL // p.pad_quantum) * p.pad_quantum
        C = p.max_candidates
        # pad the batch dimension to a 64 bucket so jit shapes stay stable
        Rpad = -(-R // 64) * 64
        rlens = np.zeros(Rpad, dtype=np.int32)
        rlens[:R] = rlens_real
        packed2 = exc2 = None
        n_exc = -1
        reads_arr = reads_rc_arr = None
        if equal_len:
            L0 = int(lens[0])
            blob = "".join(r.sequence for r in reads)
            # fused native pass: encode + reverse complement + the
            # 2-bit wire words (ops/xfer.pack_reads2 semantics) in one
            # OpenMP sweep — three numpy passes (~2 us/read) otherwise
            from ..native import native_encode_pack_reads
            from ..ops.xfer import EXC_CAP

            res_n = native_encode_pack_reads(blob.encode(), R, L0,
                                             Rpad, RL, EXC_CAP,
                                             want_packed=want_packed2)
            if res_n is not None:
                reads_arr, reads_rc_arr, packed2, exc2, n_exc = res_n
                codes2d = reads_arr[:R, :L0]
                rc2d = reads_rc_arr[:R, :L0]
            else:
                codes2d = dna.encode(blob).reshape(R, L0)
                rc2d = dna.complement_codes(codes2d)[:, ::-1]
            codes = list(codes2d)
            codes_rc = list(rc2d)
        else:
            codes = [dna.encode(r.sequence) for r in reads]
            codes_rc = [dna.revcomp_codes(c) for c in codes]
        if reads_arr is None:
            reads_arr = np.full((Rpad, RL), 5, dtype=np.uint8)
            reads_rc_arr = np.full((Rpad, RL), 5, dtype=np.uint8)
            if equal_len:
                L0 = int(lens[0])
                reads_arr[:R, :L0] = codes2d
                reads_rc_arr[:R, :L0] = rc2d
            else:
                for i, c in enumerate(codes):
                    reads_arr[i, : len(c)] = c
                    reads_rc_arr[i, : len(c)] = codes_rc[i]

        import time as _time

        _t0 = _time.time()
        cand_refpath = np.full((R, C), -1, np.int32)
        cand_refoff = np.zeros((R, C), np.int64)
        if equal_len:
            # fast path: one vectorized seeding pass over the whole batch
            cs, clo, chi, crev, cval, crp, cro = self._seed_batch(codes2d)
            cand_start = np.zeros((Rpad, C), np.int32); cand_start[:R] = cs
            cand_lo = np.zeros((Rpad, C), np.int32); cand_lo[:R] = clo
            cand_hi = np.zeros((Rpad, C), np.int32); cand_hi[:R] = chi
            cand_rev = np.zeros((Rpad, C), bool); cand_rev[:R] = crev
            cand_valid = np.zeros((Rpad, C), bool); cand_valid[:R] = cval
            cand_refpath[:] = crp
            cand_refoff[:] = cro
        else:
            cand_lists = [self._seed_read(c) for c in codes]
            cand_start = np.zeros((Rpad, C), dtype=np.int32)
            cand_lo = np.zeros((Rpad, C), dtype=np.int32)
            cand_hi = np.zeros((Rpad, C), dtype=np.int32)
            cand_rev = np.zeros((Rpad, C), dtype=bool)
            cand_valid = np.zeros((Rpad, C), dtype=bool)
            for i, cl in enumerate(cand_lists):
                for j, c in enumerate(cl):
                    cand_start[i, j] = c.diag - p.band_radius
                    cand_lo[i, j] = c.lo
                    cand_hi[i, j] = c.hi
                    cand_rev[i, j] = c.is_rev
                    cand_valid[i, j] = True

        # MEM re-seed fallback: a read whose every 29-mer spans an
        # allele combination absent from the indexed haplotypes gets
        # ZERO minimizer hits (dense-variant recombinants — reference
        # giraffe re-seeds via its fallback stages). Such reads still
        # have piecewise exact matches to some haplotype, so seed them
        # from the suffix array instead (rare; host-side).
        zero = ~cand_valid[:R].any(axis=1)
        mem_rows = None
        if (zero.any() and p.mem_fallback
                and len(self.haps.text) <= p.mem_fallback_max_text):
            mem_rows = np.nonzero(zero)[0]
            self._mem_reseed(mem_rows, codes,
                             (cand_start, cand_lo, cand_hi, cand_rev,
                              cand_valid))
        # reference projection of the candidate READ START (diag): both
        # seeders (native + numpy) already emit this diag-based value
        # (verified element-equal to _diag_refproj), so only rows written
        # OUTSIDE the seeder — the per-read fallback path and MEM-reseeded
        # rows — need the host recompute. The device paired dispatch
        # derives the same projection from resident arrays
        # (parallel/mesh.derive_candidate_meta) and never uploads it.
        if not equal_len:
            cand_refpath[:], cand_refoff[:] = self._diag_refproj(
                cand_start[:R], cand_valid[:R])
        elif mem_rows is not None and len(mem_rows):
            rp_m, ro_m = self._diag_refproj(cand_start[mem_rows],
                                            cand_valid[mem_rows])
            cand_refpath[mem_rows] = rp_m
            cand_refoff[mem_rows] = ro_m
        self.funnel.record("seed", _time.time() - _t0, items_in=R,
                           items_out=int(cand_valid.sum()))
        return {
            "codes": codes, "codes_rc": codes_rc,
            "reads_arr": reads_arr, "reads_rc_arr": reads_rc_arr,
            "rlens": rlens, "cand_start": cand_start, "cand_lo": cand_lo,
            "cand_hi": cand_hi, "cand_rev": cand_rev,
            "cand_valid": cand_valid, "cand_refpath": cand_refpath,
            "cand_refoff": cand_refoff,
            "packed2": packed2, "exc2": exc2, "n_exc": n_exc,
        }

    def _diag_refproj(self, cand_start: np.ndarray,
                      cand_valid: np.ndarray):
        """(refpath, refoff) of each candidate's seed diagonal text
        position — the same formula the device paired step applies to
        its resident arrays (parallel/mesh.py derive_candidate_meta)."""
        B = self.params.band_radius
        stp = self.haps.step_text_pos
        steps = self.haps.steps
        g = self.graph
        diag = np.clip(cand_start.astype(np.int64) + B, 0,
                       max(len(self.haps.text) - 1, 0))
        si = np.searchsorted(stp[1:], diag, side="right")
        h = steps[si]
        nidx = (h >> 1).astype(np.int64)
        nlen = g.seq_start[nidx + 1] - g.seq_start[nidx]
        off_visit = diag - stp[si]
        fwd_off = np.where(h & 1, nlen - off_visit, off_visit)
        rp = np.where(cand_valid, self._node_ref_path[nidx], -1)
        ro = np.where(cand_valid, self._node_ref_off[nidx] + fwd_off, 0)
        return rp.astype(np.int32), ro

    def _mem_reseed(self, rows: np.ndarray, codes: List[np.ndarray],
                    cand_arrays) -> None:
        """Seed the given zero-candidate reads from the haplotype-text
        suffix array (MEMs >= 19bp) and write their candidate rows in
        place. The suffix array is built lazily on first need."""
        if getattr(self, "_mem_fallback_index", None) is None:
            import sys as _sys
            import time as _time

            from .memmapper import MEMIndex

            _t0 = _time.time()
            # hit cap scales with cohort size: the SA counts text
            # positions, so one graph placement costs ~haps.count hits
            # (the reference's GCSA2 counts graph positions, already
            # deduplicated across haplotypes — src/mem.cpp)
            self._mem_fallback_index = MEMIndex(
                self.haps,
                max_mem_hits=max(64, 4 * self.haps.count))
            _sys.stderr.write(
                f"[vg_tpu] built MEM-fallback suffix array "
                f"({len(self.haps.text)/1e6:.0f} Mbp) in "
                f"{_time.time()-_t0:.1f}s\n")
        mi = self._mem_fallback_index
        C = self.params.max_candidates
        n = len(rows)
        sub = (np.zeros((n, C), np.int32), np.zeros((n, C), np.int32),
               np.zeros((n, C), np.int32), np.zeros((n, C), bool),
               np.zeros((n, C), bool), np.full((n, C), -1, np.int32),
               np.zeros((n, C), np.int64))
        sread: List[int] = []
        strand: List[bool] = []
        diag: List[int] = []
        roff: List[int] = []
        score: List[float] = []
        oriented_list: List[np.ndarray] = []
        for i in rows:
            cc = codes[int(i)]
            oriented_list.append(cc)
            oriented_list.append(dna.revcomp_codes(cc))
        mems = mi.find_mems_batch(oriented_list)
        for k in range(len(rows)):
            for is_rev in (False, True):
                rs, ln, tp = mems[2 * k + (1 if is_rev else 0)]
                for q in range(len(rs)):
                    sread.append(k)
                    strand.append(is_rev)
                    diag.append(int(tp[q]) - int(rs[q]))
                    roff.append(int(rs[q]))
                    score.append(float(ln[q]))
        if not sread:
            return
        self._cluster_seeds_to_candidates(
            np.array(sread, np.int64), np.array(strand, bool),
            np.array(diag, np.int64), np.array(roff, np.int64),
            np.array(score, np.float64), sub)
        cs, cl, ch, cr, cv = cand_arrays
        ii = np.asarray(rows, np.int64)
        cs[ii] = sub[0]
        cl[ii] = sub[1]
        ch[ii] = sub[2]
        cr[ii] = sub[3]
        cv[ii] = sub[4]
        if self.params.track_provenance:
            self.funnel.filter("seed", "mem-reseed", n,
                               int(sub[4].any(axis=1).sum()))

    def _resident_arrays(self):
        """Device-resident index arrays shared by the packed single and
        paired steps (hap bounds, step table, node lens, ref projection)."""
        if getattr(self, "_resident_dev", None) is None:
            dev32 = lambda a: torch.as_tensor(np.asarray(a, np.int32),
                                              device=self.device)
            g = self.graph
            self._resident_dev = (
                dev32(self.haps.text_start),
                dev32(self.haps.step_text_pos),
                dev32(self.haps.steps),
                dev32(g.seq_start[1:] - g.seq_start[:-1]),
                dev32(self._node_ref_path),
                dev32(self._node_ref_off))
        return self._resident_dev

    def _packed_score_fn(self):
        """score_fn for the mesh steps: the banded-DP kernel over the
        packed text (its plain version for CPU tensors)."""
        from ..ops.cuda_align import banded_scores_packed

        p = self.params
        T = len(self.haps.text)

        def score_fn(text, reads, rc, rlen, cand):
            return banded_scores_packed(
                text, T, reads, rc, rlen, *cand[:5],
                band_radius=p.band_radius, match=p.match,
                mismatch=p.mismatch, gap_open=p.gap_open,
                gap_extend=p.gap_extend, bonus=p.full_length_bonus)

        return score_fn

    def _get_single_step(self):
        """Transfer-compressed single-end step: DP + distinct dedup +
        winner + MAPQ + winner mismatch bitmaps in ONE call on the device
        (parallel/mesh.make_single_step), one int16 buffer out. Built
        lazily."""
        if getattr(self, "_single_step", None) is None:
            from ..ops.xfer import (bits_to_pos8_dev, revcomp_dev,
                                    unpack_reads4_dev)
            from ..parallel.mesh import (derive_candidate_meta,
                                         make_single_step)

            p = self.params
            step = make_single_step(
                band_radius=p.band_radius, match=p.match,
                mismatch=p.mismatch, gap_open=p.gap_open,
                gap_extend=p.gap_extend, bonus=p.full_length_bonus,
                max_mapq=p.max_mapq, score_fn=self._packed_score_fn(),
                text_packed=True, text_len=len(self.haps.text))
            B = p.band_radius
            bonus = p.full_length_bonus

            def packed_single(text, hb, stp, steps, nlen, nrp, nro,
                              rp, rl, ca, cf):
                put = lambda a: torch.as_tensor(a, device=text.device)
                rp, rl, ca, cf = put(rp), put(rl), put(ca), put(cf)
                r = unpack_reads4_dev(rp)
                rc = revcomp_dev(r, rl)
                valid = (cf & 1).to(torch.bool)
                rev = ((cf >> 1) & 1).to(torch.bool)
                lo, hi, rpth, ro = derive_candidate_meta(
                    ca + B, hb, stp, steps, nlen, nrp, nro)
                s, j, mapq, anyv, mm, bits = step(
                    text, r, rc, rl, (ca, lo, hi, rev, valid, rpth, ro), 2)
                i16 = lambda a: a.clamp(-32768, 32767).to(torch.int16)
                R_, C_ = s.shape
                if r.shape[1] + 2 * bonus <= 191 and C_ % 2 == 0:
                    s_out = ((s - 64).clamp(-128, 127).to(torch.int8)
                             .reshape(R_, C_ // 2, 2).view(torch.int16)
                             .reshape(-1))
                else:
                    s_out = i16(s).reshape(-1)
                if r.shape[1] <= 255:
                    b_out = (bits_to_pos8_dev(bits).reshape(R_, 4, 2)
                             .view(torch.int16).reshape(-1))
                else:
                    b_out = bits.view(torch.int16).reshape(-1)
                return torch.cat([
                    s_out, i16(j), i16(mapq), anyv.to(torch.int16),
                    i16(mm), b_out])

            self._single_step = (packed_single, self.text_packed_dev,
                                 self._resident_arrays())
        return self._single_step

    def _get_single_step_seeded(self):
        """Single-end dispatch with DEVICE seeding (ops/devseed.py through
        the seeding kernels of ops/cuda_seed.py) + DP + winner + MAPQ +
        mismatch payload: input is just the 4-bit packed reads, output
        one winner-only int16 buffer (the single-end twin of
        PairedGiraffeMapper._get_pair_step_seeded)."""
        if getattr(self, "_single_step_seeded_fn", None) is None:
            from ..ops.cuda_seed import argsort_i32
            from ..ops.devseed import rolling_minimizers, seed_candidates_dev
            from ..ops.xfer import (bits_to_pos8_dev, revcomp_dev,
                                    unpack_reads4_dev)
            from ..parallel.mesh import (derive_candidate_meta,
                                         make_single_step)

            p = self.params
            step = make_single_step(
                band_radius=p.band_radius, match=p.match,
                mismatch=p.mismatch, gap_open=p.gap_open,
                gap_extend=p.gap_extend, bonus=p.full_length_bonus,
                max_mapq=p.max_mapq, score_fn=self._packed_score_fn(),
                text_packed=True, text_len=len(self.haps.text))
            B = p.band_radius
            kk, ww = self.index.k, self.index.w
            seed_kw = dict(k=kk, hit_cap=p.hit_cap,
                           hard_hit_cap=p.hard_hit_cap,
                           score_fraction=p.score_fraction,
                           max_candidates=p.max_candidates,
                           band_radius=B)

            def seeded_single(text, hb, stp, steps, nlen, nrp, nro,
                              ih, il, ioff, ipos, irev, stab, rp, rl):
                put = lambda a: torch.as_tensor(a, device=text.device)
                rp, rl = put(rp), put(rl)
                r = unpack_reads4_dev(rp)
                rc = revcomp_dev(r, rl)
                kh, kl, cr, chosen, vld = rolling_minimizers(r, rl, kk, ww)
                ca, rev, cv = seed_candidates_dev(
                    kh, kl, cr, chosen, vld, rl,
                    ih, il, ioff, ipos, irev, stab, **seed_kw)
                del kh, kl, cr, chosen, vld
                lo, hi, rpth, ro = derive_candidate_meta(
                    ca + B, hb, stp, steps, nlen, nrp, nro)
                cand = (ca, lo, hi, rev, cv, rpth, ro)
                if p.locality_sort:
                    # rows ordered by their top candidate's text position
                    # for the DP window gather, outputs put back
                    key = torch.where(cv[:, 0], ca[:, 0], 2**31 - 1)
                    perm = argsort_i32(key).long()
                    inv = argsort_i32(perm.to(torch.int32)).long()
                    P = lambda a: a.index_select(0, perm)
                    U = lambda a: a.index_select(0, inv)
                    out = step(text, P(r), P(rc), P(rl),
                               tuple(P(a) for a in cand), 2)
                    s, j, mapq, anyv, mm, bits = (U(a) for a in out)
                else:
                    s, j, mapq, anyv, mm, bits = step(text, r, rc, rl,
                                                      cand, 2)
                i16 = lambda a: a.clamp(-32768, 32767).to(torch.int16)
                take = lambda a: torch.gather(
                    a, 1, j.long()[:, None])[:, 0]
                R_ = s.shape[0]
                ws = take(s)
                wstart = take(ca)
                wrev = take(rev)
                wv = take(cv) & (ws > 0) & anyv
                flags = wv.to(torch.int16) | (wrev.to(torch.int16) << 1)
                return torch.cat([
                    i16(ws),
                    wstart.reshape(R_, 1).view(torch.int16).reshape(R_ * 2),
                    flags, i16(mapq), i16(mm),
                    bits_to_pos8_dev(bits).reshape(R_, 4, 2)
                    .view(torch.int16).reshape(R_ * 4)])

            self._single_step_seeded_fn = (
                seeded_single, self.text_packed_dev,
                self._resident_arrays(), self._resident_seed_arrays())
        return self._single_step_seeded_fn

    def score_reads_packed(self, reads: Sequence[Read]) -> "ScoredBatch":
        """score_reads variant where winner selection + MAPQ + mismatch
        bitmaps also run on device and everything returns as ONE int16
        buffer (fetched lazily by emit_batch_encoded)."""
        from ..ops.xfer import pack_reads4

        true_n = len(reads)
        if 0 < true_n < self.params.batch_reads:
            # pad a short (final) batch to the compiled batch shape:
            # a fresh jit shape costs a ~12 s XLA recompile (measured on
            # the v5e), padding wastes <0.5 s of device compute
            reads = list(reads) + [reads[-1]] * (self.params.batch_reads
                                                 - true_n)
        sb = self._score_reads_packed_inner(reads)
        sb._emit_true_n = true_n
        return sb

    def _score_reads_packed_inner(self, reads: Sequence[Read]
                                  ) -> "ScoredBatch":
        from ..ops.xfer import pack_reads4  # noqa: F811

        if self.params.device_seed:
            prep = self.prepare_light(reads)
            if prep["reads_arr"].shape[1] <= 255:     # pos8 wire limit
                step, text_arg, resident, seed_res = \
                    self._get_single_step_seeded()
                packed = step(text_arg, *resident, *seed_res,
                              pack_reads4(prep["reads_arr"]), prep["rlens"])
                sb = ScoredBatch(
                    reads=list(reads), codes=prep["codes"],
                    codes_rc=prep["codes_rc"],
                    cand_start=None, cand_lo=None, cand_hi=None,
                    cand_rev=None, cand_valid=None, scores_raw=None,
                    codes2d=prep["reads_arr"],
                    codes_rc2d=prep["reads_rc_arr"])
                sb._packed_single = ("seeded", packed,
                                     prep["rlens"].shape[0])
                return sb
        prep = self.prepare_batch(reads, want_packed2=False)
        step, text_arg, resident = self._get_single_step()
        perm = None
        if self.params.locality_sort:
            key = np.where(prep["cand_valid"][:, 0],
                           prep["cand_start"][:, 0], np.int32(2**31 - 1))
            perm = np.argsort(key, kind="stable")
            srt = lambda a: a[perm]
        else:
            srt = lambda a: a
        flags = srt(prep["cand_valid"].astype(np.int8)
                    | (prep["cand_rev"].astype(np.int8) << 1))
        rp = pack_reads4(srt(prep["reads_arr"]))
        packed = step(text_arg, *resident, rp, srt(prep["rlens"]),
                      srt(prep["cand_start"]), flags)
        R = len(reads)
        sb = ScoredBatch(
            reads=list(reads), codes=prep["codes"],
            codes_rc=prep["codes_rc"],
            cand_start=prep["cand_start"][:R], cand_lo=prep["cand_lo"][:R],
            cand_hi=prep["cand_hi"][:R], cand_rev=prep["cand_rev"][:R],
            cand_valid=prep["cand_valid"][:R], scores_raw=None,
            cand_refpath=prep["cand_refpath"],
            cand_refoff=prep["cand_refoff"],
            codes2d=prep["reads_arr"], codes_rc2d=prep["reads_rc_arr"])
        Rpad, C = prep["cand_start"].shape
        s_i8 = (rp.shape[1] * 8 + 2 * self.params.full_length_bonus <= 191
                and C % 2 == 0)
        pos_mode = rp.shape[1] * 8 <= 255
        sb._packed_single = ("host", packed, Rpad, C, s_i8, pos_mode,
                             perm)
        return sb

    def _force_single_sel(self, sb: "ScoredBatch"):
        """Fetch + unpack the single-step buffer into the ScoredBatch;
        returns (best_j, mapq, any_valid)."""
        if sb._packed_single[0] == "seeded":
            return self._force_seeded_single(sb)
        _, packed, Rpad, C, s_i8, pos_mode, perm = sb._packed_single
        sb._packed_single = None
        R = len(sb.reads)
        buf = to_host(packed)
        if perm is not None:              # undo the locality sort
            inv = np.empty_like(perm)
            inv[perm] = np.arange(len(perm))
            up = lambda rows: rows[inv]
        else:
            up = lambda rows: rows
        if s_i8:
            n = Rpad * C // 2
            sb.scores_raw = up(np.ascontiguousarray(buf[:n]).view(np.int8)
                               .reshape(Rpad, C))[:R].astype(np.int32) + 64
        else:
            n = Rpad * C
            sb.scores_raw = up(buf[:n].reshape(Rpad, C))[:R].astype(
                np.int32)
        off = n
        j = up(buf[off : off + Rpad])[:R].astype(np.int64)
        mapq = up(buf[off + Rpad : off + 2 * Rpad])[:R].astype(np.int32)
        anyv = up(buf[off + 2 * Rpad : off + 3 * Rpad])[:R].astype(bool)
        off += 3 * Rpad
        mm = up(buf[off : off + Rpad]).astype(np.int32)
        off += Rpad
        W2 = (len(buf) - off) // Rpad
        raw = np.ascontiguousarray(up(buf[off:].reshape(Rpad, W2)))
        payload = raw.view(np.uint8) if pos_mode else raw.view(np.int32)
        sb.winner_mism = (j.copy(), mm[:R], payload[:R])
        return j, mapq, anyv

    def _force_seeded_single(self, sb: "ScoredBatch"):
        """Fetch the device-seeded winner-only buffer and synthesize C=1
        candidate tables so the host emit stages run unchanged (the
        single-end twin of PairedGiraffeMapper._force_seeded_sel)."""
        _, packed, Rpad = sb._packed_single
        sb._packed_single = None
        R = len(sb.reads)
        buf = to_host(packed)
        ws = buf[:Rpad].astype(np.int32)
        start = np.ascontiguousarray(buf[Rpad : 3 * Rpad]).view(np.int32)
        flags = buf[3 * Rpad : 4 * Rpad]
        mq = buf[4 * Rpad : 5 * Rpad].astype(np.int32)
        mm = buf[5 * Rpad : 6 * Rpad].astype(np.int32)
        pos8 = np.ascontiguousarray(
            buf[6 * Rpad : 10 * Rpad].reshape(Rpad, 4)).view(np.uint8)
        wv = (flags & 1).astype(bool)
        wrev = ((flags >> 1) & 1).astype(bool)
        self._fill_winner_tables(sb, R, start, wv, wrev, ws)
        sb.winner_mism = (np.zeros(R, np.int64), mm[:R], pos8[:R].copy())
        return (np.zeros(R, np.int64), mq[:R], wv[:R] & (ws[:R] > 0))

    def _fill_winner_tables(self, sb: "ScoredBatch", R: int, start, wv,
                            wrev, ws) -> None:
        """C=1 candidate tables of a seeded batch from its winners: start,
        haplotype bounds, strand, validity, score and reference
        projection."""
        diag = start.astype(np.int64) + self.params.band_radius
        hap = np.searchsorted(self.haps.text_start[1:],
                              np.clip(diag, 0, len(self.haps.text) - 1),
                              side="right")
        sb.cand_start = start[:R, None].copy()
        sb.cand_lo = self.haps.text_start[hap][:R, None].astype(np.int32)
        sb.cand_hi = self.haps.text_start[hap + 1][:R, None].astype(
            np.int32)
        sb.cand_rev = wrev[:R, None].copy()
        sb.cand_valid = wv[:R, None].copy()
        sb.scores_raw = np.where(wv, ws, -1)[:R, None].copy()
        sb.cand_refpath, sb.cand_refoff = self._diag_refproj(
            sb.cand_start, sb.cand_valid)

    def _device_scores(self, reads_arr, reads_rc_arr, rlens, cand_start,
                       cand_lo, cand_hi, cand_rev, cand_valid,
                       band_radius):
        """Dispatch the batched banded DP on the mapper's device: the
        packed-text CUDA kernel (its plain version on the CPU). Returns
        the (lazy) device tensor."""
        from ..ops.cuda_align import banded_scores_packed

        p = self.params
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                        device=self.device)
        return banded_scores_packed(
            self.text_packed_dev, len(self.haps.text),
            put(reads_arr), put(reads_rc_arr), put(rlens),
            put(cand_start), put(cand_lo), put(cand_hi), put(cand_rev),
            put(cand_valid),
            band_radius=band_radius, match=p.match, mismatch=p.mismatch,
            gap_open=p.gap_open, gap_extend=p.gap_extend,
            bonus=p.full_length_bonus)

    def _device_scores_qual(self, prep: dict, reads) -> "torch.Tensor":
        """Quality-adjusted DP dispatch (ops/cuda_align.
        banded_scores_qual_packed on the packed text, with tables from
        ops/qualadj; reference QualAdjAligner, src/aligner.hpp:218): the
        kernel's quality entry on the card, its plain version on the CPU.
        Returns the (lazy) device tensor."""
        from ..ops.cuda_align import banded_scores_qual_packed
        from ..ops.qualadj import parse_quality, qual_tables

        p = self.params
        mt, mm, bt = qual_tables(p.match, p.mismatch, p.full_length_bonus)
        Rpad, RL = prep["reads_arr"].shape
        quals = np.zeros((Rpad, RL), np.uint8)
        for i, r in enumerate(reads):
            q = parse_quality(r.quality)[:RL]
            quals[i, : len(q)] = q
        put = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                        device=self.device)
        return banded_scores_qual_packed(
            self.text_packed_dev, len(self.haps.text),
            put(prep["reads_arr"]), put(prep["reads_rc_arr"]), put(quals),
            put(prep["rlens"]), put(prep["cand_start"]), put(prep["cand_lo"]),
            put(prep["cand_hi"]), put(prep["cand_rev"]),
            put(prep["cand_valid"]), put(mt), put(mm), put(bt),
            band_radius=p.band_radius, gap_open=p.gap_open,
            gap_extend=p.gap_extend)

    def rescore_candidates(self, sb: "ScoredBatch",
                           cand_start: np.ndarray, cand_lo: np.ndarray,
                           cand_hi: np.ndarray, cand_rev: np.ndarray,
                           cand_valid: np.ndarray,
                           band_radius: Optional[int] = None,
                           force: bool = True):
        """Score additional candidates for an already-encoded batch (used
        by paired rescue). force=False returns the lazy device array so a
        pipeline can overlap the fetch."""
        p = self.params
        R = len(sb.reads)
        RL = max(len(c) for c in sb.codes)
        RL = -(-RL // p.pad_quantum) * p.pad_quantum
        Rpad = max(-(-R // 64) * 64, 64)
        C = cand_start.shape[1]
        rlens = np.zeros(Rpad, np.int32)
        reads_arr = np.full((Rpad, RL), 5, np.uint8)
        reads_rc_arr = np.full((Rpad, RL), 5, np.uint8)
        for i, c in enumerate(sb.codes):
            rlens[i] = len(c)
            reads_arr[i, : len(c)] = c
            reads_rc_arr[i, : len(c)] = sb.codes_rc[i]
        pad = lambda a, fill: np.concatenate(
            [a, np.full((Rpad - R, C), fill, a.dtype)], axis=0)
        out = self._device_scores(
            reads_arr, reads_rc_arr, rlens,
            pad(cand_start, 0), pad(cand_lo, 0), pad(cand_hi, 0),
            pad(cand_rev, False), pad(cand_valid, False),
            band_radius or p.band_radius)[:R]
        return to_host(out) if force else out

    def emit(self, sb: "ScoredBatch", i: int, best_j: int,
             mapping_quality: int) -> Alignment:
        """Build the output Alignment for read i's candidate best_j."""
        r = sb.reads[i]
        qual = bytes((ord(q) - 33) for q in r.quality) if r.quality else b""
        aln = Alignment(name=r.name, sequence=r.sequence, quality=qual)
        if best_j < 0:
            return aln
        aln.mapping_quality = mapping_quality
        self._traceback_into(aln, sb.codes[i], sb.codes_rc[i],
                             int(sb.cand_start[i, best_j]),
                             int(sb.cand_lo[i, best_j]),
                             int(sb.cand_hi[i, best_j]),
                             bool(sb.cand_rev[i, best_j]),
                             int(sb.scores[i, best_j]))
        return aln

    def map_batch(self, reads: Sequence[Read]) -> List[Alignment]:
        p = self.params
        if len(reads) == 0:
            return []
        sb = self.score_reads(reads)
        return self.emit_batch(sb)

    def map_stream_encoded(self, batches):
        """map_stream variant yielding lists of encoded GAM records (native
        fast path; falls back to object emission + encode)."""
        pending = None
        for batch in batches:
            sb = self.score_reads_packed(batch)
            if pending is not None:
                recs = self.emit_batch_encoded(pending)
                if recs is None:
                    recs = [a.encode() for a in self.emit_batch(pending)]
                yield recs
            pending = sb
        if pending is not None:
            recs = self.emit_batch_encoded(pending)
            if recs is None:
                recs = [a.encode() for a in self.emit_batch(pending)]
            yield recs

    def map_stream(self, batches) -> "Iterator[List[Alignment]]":
        """Map an iterator of read batches with device/host overlap: batch
        i+1's DP runs on device while batch i's winners emit on host (the
        TPU answer to the reference's reader/mapper-thread overlap,
        vg::io::for_each_parallel)."""
        pending = None
        for batch in batches:
            sb = self.score_reads(batch)      # async dispatch
            if pending is not None:
                yield self.emit_batch(pending)
            pending = sb
        if pending is not None:
            yield self.emit_batch(pending)

    def emit_batch(self, sb: "ScoredBatch") -> List[Alignment]:
        """Vectorized winner selection, MAPQ, and gapless-path emission;
        only indel winners fall back to the per-read DP traceback."""
        out = self._emit_batch_inner(sb)
        tn = getattr(sb, "_emit_true_n", None)
        return out if tn is None else out[:tn]

    def _emit_batch_inner(self, sb: "ScoredBatch") -> List[Alignment]:
        from .mapq import log_base

        if getattr(sb, "_packed_single", None) is not None:
            self._force_single_sel(sb)     # fills scores_raw
        p = self.params
        R = len(sb.reads)
        scores = sb.scores
        valid = sb.cand_valid & (scores > 0)
        any_valid = valid.any(axis=1)
        masked = np.where(valid, scores, -1)
        best_j = np.argmax(masked, axis=1)
        best_s = masked[np.arange(R), best_j]

        # batch MAPQ: exact log-sum-exp posterior over valid candidates,
        # with haplotype copies of the same placement collapsed to their
        # best score (they are one mapping, not independent evidence)
        lam = log_base(p.match, p.mismatch)
        uniq = self._distinct_placements(sb, valid)
        sc = np.where(valid & uniq, scores * lam, -np.inf)
        mx = np.maximum(sc.max(axis=1), best_s * lam)
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            lse = mx + np.log(np.exp(sc - mx[:, None]).sum(axis=1))
            delta = best_s * lam - lse
            one_minus = np.where(delta < -1e-12,
                                 np.log1p(-np.exp(np.minimum(delta, -1e-12))),
                                 -50.0)
        mapqs = np.clip(-10.0 / np.log(10.0) * one_minus, 0, p.max_mapq)
        mapqs = np.where(np.isfinite(mapqs), mapqs, p.max_mapq).astype(int)
        mapqs = self.apply_mapq_caps(sb, mapqs)
        return self.emit_chosen(sb, best_j, mapqs, any_valid)

    def apply_mapq_caps(self, sb: "ScoredBatch",
                        mapqs: np.ndarray) -> np.ndarray:
        """Explored-minimizer MAPQ cap for quality-carrying reads
        (reference src/minimizer_mapper.cpp:1161-1172: mapq =
        min(mapq, faster_cap(...)); infinite cap without qualities).
        One call of ops/cuda_mapqcap.mapq_cap for the batch (the kernel
        on the card, its plain version on the CPU) gives each read
        map/mapqcap.explored_cap(codes, quals, k, w, index.count); a
        finite cap below the MAPQ replaces it, rounded half to even.
        Reads without quality strings (the bench path) pay nothing: a
        batch without one launches nothing."""
        quals = [(getattr(r, "quality", None) or "").encode()
                 for r in sb.reads]
        qlen = np.fromiter(map(len, quals), np.int32, len(quals))
        if not qlen.any():
            return mapqs
        from ..ops.cuda_mapqcap import mapq_cap

        codes2d, rlen, quals2d = self._cap_inputs(sb, quals, qlen)
        keys, stream = self._cap_keys()
        with torch.cuda.stream(stream):      # None (the CPU): no-op
            put = lambda a: torch.from_numpy(a).to(self.device)
            caps = to_host(mapq_cap(put(codes2d), put(rlen), put(quals2d),
                                    put(qlen), keys, k=self.index.k,
                                    w=self.index.w))
        if np.isnan(caps).any():
            i = int(np.nonzero(np.isnan(caps))[0][0])
            raise IndexError(f"read {sb.reads[i].name}: its quality "
                             f"string ({qlen[i]}) is shorter than the "
                             f"minimizers it covers")
        low = np.isfinite(caps) & (caps < mapqs)
        mapqs[low] = np.maximum(np.rint(caps[low]), 0)
        return mapqs

    def _cap_inputs(self, sb: "ScoredBatch", quals: List[bytes],
                    qlen: np.ndarray) -> tuple:
        """mapq_cap's host inputs for a batch: codes2d (R, L) uint8 (the
        batch's padded codes where it has them), rlen (R,) int32, quals2d
        (R, LQ) uint8 phred, parse_quality's clip to 0-93 in one pass over
        the joined strings."""
        R = len(sb.reads)
        rlen = np.fromiter(map(len, sb.codes), np.int32, R)
        L = max(int(rlen.max()), 1)
        c2 = sb.codes2d
        if c2 is not None and c2.shape[0] >= R and c2.shape[1] >= L:
            codes2d = np.ascontiguousarray(c2[:R])
        else:
            codes2d = np.full((R, L), 5, np.uint8)
            codes2d[np.arange(L) < rlen[:, None]] = np.concatenate(sb.codes)
        q = np.frombuffer(b"".join(quals), np.uint8).astype(np.int16) - 33
        quals2d = np.zeros((R, int(qlen.max())), np.uint8)
        quals2d[np.arange(quals2d.shape[1]) < qlen[:, None]] = np.clip(
            q, 0, 93)
        return codes2d, rlen, quals2d

    def _cap_keys(self):
        """(keys, stream): the index keys that occur, sorted, as an int64
        tensor of their uint64 bits on the mapper's device, and on the
        card the cap's own CUDA stream (so that its fetch waits for the
        cap alone, not for the next batch's DP on the default stream);
        built once, under a lock."""
        if self._cap_state is None:
            with self._cap_lock:
                if self._cap_state is None:
                    keys = np.asarray(self.index.keys, np.uint64)
                    keys = np.unique(keys[np.diff(self.index.offsets) > 0])
                    stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
                    with torch.cuda.stream(stream):
                        t = torch.from_numpy(keys.view(np.int64)).to(
                            self.device)
                    if stream is not None:
                        stream.synchronize()
                    self._cap_state = (t, stream)
        return self._cap_state

    def _distinct_placements(self, sb: "ScoredBatch",
                             valid: np.ndarray) -> np.ndarray:
        """(R, C) mask keeping, per distinct placement, only the
        best-scoring candidate. Placement = (strand, ref projection within
        half a read length); off-reference candidates fall back to their
        haplotype-copy identity (conservative: treated as distinct)."""
        scores = sb.scores
        R, C = scores.shape
        rp = sb.cand_refpath if sb.cand_refpath is not None else             np.full((R, C), -1, np.int32)
        ro = sb.cand_refoff if sb.cand_refoff is not None else             np.zeros((R, C), np.int64)
        tol = PLACEMENT_TOL
        same = ((sb.cand_rev[:, :, None] == sb.cand_rev[:, None, :])
                & (rp[:, :, None] >= 0)
                & (rp[:, :, None] == rp[:, None, :])
                & (np.abs(ro[:, :, None] - ro[:, None, :]) <= tol))
        better = (scores[:, None, :] > scores[:, :, None]) | (
            (scores[:, None, :] == scores[:, :, None])
            & (np.arange(C)[None, None, :] < np.arange(C)[None, :, None]))
        dup = (same & better & valid[:, None, :]).any(axis=2)
        return ~dup

    def emit_chosen(self, sb: "ScoredBatch", best_j: np.ndarray,
                    mapqs: np.ndarray, any_valid: np.ndarray
                    ) -> List[Alignment]:
        """Vectorized emission of one chosen candidate per read (shared by
        the single-end winner path and the paired-end pairing path)."""
        from .project import gapless_path

        import time as _time

        p = self.params
        R = len(sb.reads)
        B = p.band_radius
        _t0 = _time.time()
        scores = sb.scores
        best_s = scores[np.arange(R), best_j]

        # batch gapless detection on the winners
        text = self.haps.text
        L_arr = np.array([len(c) for c in sb.codes])
        RL = int(L_arr.max()) if R else 0
        diag = sb.cand_start[np.arange(R), best_j] + B
        lo = sb.cand_lo[np.arange(R), best_j]
        hi = sb.cand_hi[np.arange(R), best_j]
        rev = sb.cand_rev[np.arange(R), best_j]
        pos = diag[:, None] + np.arange(RL)
        ok = (pos >= lo[:, None]) & (pos < hi[:, None]) & (pos >= 0) & \
             (pos < len(text))
        tw = np.where(ok, text[np.clip(pos, 0, len(text) - 1)],
                      align_ops.SENTINEL).astype(np.uint8)
        if sb.codes2d is not None and sb.codes2d.shape[1] >= RL:
            oriented = np.where(rev[:, None], sb.codes_rc2d[:R, :RL],
                                sb.codes2d[:R, :RL])
        else:
            oriented = np.full((R, RL), 5, np.uint8)
            for i in range(R):
                c = sb.codes_rc[i] if rev[i] else sb.codes[i]
                oriented[i, : len(c)] = c
        col = np.arange(RL)[None, :]
        inread = col < L_arr[:, None]
        mism = ((tw != oriented) | (oriented >= 4)) & inread
        mm = mism.sum(axis=1)
        qual_mode = p.qual_adjusted and R > 0 and all(
            getattr(r, "quality", None) for r in sb.reads)
        if qual_mode:
            # quality-adjusted gapless score so the fast-path equality
            # check matches the qual-adjusted device DP
            from ..ops.qualadj import parse_quality, qual_tables

            mt_t, mm_t, b_t = qual_tables(p.match, p.mismatch,
                                          p.full_length_bonus)
            quals = np.zeros((R, RL), np.int64)
            for i, r in enumerate(sb.reads):
                q = parse_quality(r.quality)
                if rev[i]:
                    q = q[::-1]
                quals[i, : min(len(q), RL)] = q[:RL]
            quals = np.minimum(quals, len(mt_t) - 1)
            per = np.where(mism, mm_t[quals], mt_t[quals]) * inread
            gl_score = (per.sum(1) + b_t[quals[np.arange(R), 0]]
                        + b_t[quals[np.arange(R),
                                    np.maximum(L_arr - 1, 0)]])
        else:
            gl_score = (L_arr - mm) * p.match - mm * p.mismatch \
                + 2 * p.full_length_bonus
        # winners must lie fully inside their haplotype range to take the
        # gapless fast path: an overhanging interval would walk off the
        # text / cross haplotype boundaries (out-of-range columns scored
        # as mismatches above can still tie the clipped DP score)
        fast = (any_valid & (gl_score == best_s)
                & (diag >= lo) & (diag + L_arr <= hi))
        if p.track_provenance:
            self.funnel.filter("align", "gapless-fast-path",
                               int(any_valid.sum()), int(fast.sum()))

        out: List[Alignment] = []
        for i, r in enumerate(sb.reads):
            qual = bytes((ord(q) - 33) for q in r.quality) if r.quality else b""
            aln = Alignment(name=r.name, sequence=r.sequence, quality=qual)
            if not any_valid[i]:
                out.append(aln)
                continue
            aln.mapping_quality = int(mapqs[i])
            L = int(L_arr[i])
            if fast[i]:
                aln.path = gapless_path(
                    self.haps, int(diag[i]), int(diag[i]) + L,
                    mism[i, :L], r.sequence, bool(rev[i]))
                aln.score = int(best_s[i])
                aln.identity = (L - int(mm[i])) / L
                self.path_pos.annotate_refpos(aln)
            else:
                self._traceback_into(
                    aln, sb.codes[i], sb.codes_rc[i],
                    int(sb.cand_start[i, best_j[i]]), int(lo[i]),
                    int(hi[i]), bool(rev[i]), int(best_s[i]))
            out.append(aln)
        emit_s = _time.time() - _t0
        self.funnel.record("winner_emit", emit_s, items_in=R,
                           items_out=int(any_valid.sum()))
        if p.track_provenance:
            per_read = (emit_s + 1e-12) / max(R, 1)
            for aln in out:
                self.funnel.annotate(aln, per_read)
        return out


    # -------------------------------------------------- encoded emission

    def emit_batch_encoded(self, sb: "ScoredBatch"):
        """Winner selection + MAPQ as emit_batch, but gapless winners are
        encoded straight to GAM protobuf bytes by the native kernel
        (the production output path: no per-read Python objects).
        Returns a list of bytes-like protobuf messages in read order, or
        None when the native library is unavailable."""
        recs = self._emit_batch_encoded_inner(sb)
        tn = getattr(sb, "_emit_true_n", None)
        if recs is not None and tn is not None:
            recs = recs[:tn]
        return recs

    def _emit_batch_encoded_inner(self, sb: "ScoredBatch"):
        from ..native import lib as native_lib
        from .mapq import log_base

        if native_lib() is None:
            return None
        if self.params.qual_adjusted:
            # qual-adjusted scores break the native gapless-score check;
            # route through the object emitter (map/mpmap volume)
            return None
        if getattr(sb, "_packed_single", None) is not None:
            # winner/mapq/bitmaps were computed on device in the packed
            # single-end dispatch — one fetch, no host selection math
            best_j, mapqs, any_valid = self._force_single_sel(sb)
            mapqs = self.apply_mapq_caps(sb, mapqs)
            return self.emit_chosen_encoded(sb, best_j, mapqs, any_valid)
        p = self.params
        R = len(sb.reads)
        scores = sb.scores
        valid = sb.cand_valid & (scores > 0)
        any_valid = valid.any(axis=1)
        masked = np.where(valid, scores, -1)
        best_j = np.argmax(masked, axis=1)
        best_s = masked[np.arange(R), best_j]
        lam = log_base(p.match, p.mismatch)
        uniq = self._distinct_placements(sb, valid)
        sc = np.where(valid & uniq, scores * lam, -np.inf)
        mx = np.maximum(sc.max(axis=1), best_s * lam)
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            lse = mx + np.log(np.exp(sc - mx[:, None]).sum(axis=1))
            delta = best_s * lam - lse
            one_minus = np.where(delta < -1e-12,
                                 np.log1p(-np.exp(np.minimum(delta, -1e-12))),
                                 -50.0)
        mapqs = np.clip(-10.0 / np.log(10.0) * one_minus, 0, p.max_mapq)
        mapqs = np.where(np.isfinite(mapqs), mapqs, p.max_mapq).astype(np.int32)
        mapqs = self.apply_mapq_caps(sb, mapqs)
        return self.emit_chosen_encoded(sb, best_j, mapqs, any_valid)

    def emit_chosen_encoded(self, sb: "ScoredBatch", best_j: np.ndarray,
                            mapqs: np.ndarray, any_valid: np.ndarray):
        res = self.emit_chosen_spans(sb, best_j, mapqs, any_valid,
                                     build_records=True)
        return None if res is None else res[0]

    @staticmethod
    def records_from_spans(records, spans):
        """Fill the None entries of a build_records=False result with
        memoryview slices into the span buffers."""
        bufs, src_id, off, ln = spans
        mvs = [memoryview(b) for b in bufs]
        sid = src_id.tolist()
        o = off.tolist()
        n = ln.tolist()
        for i in range(len(records)):
            if records[i] is None:
                records[i] = mvs[sid[i]][o[i] : o[i] + n[i]]
        return records

    def emit_chosen_spans(self, sb: "ScoredBatch", best_j: np.ndarray,
                          mapqs: np.ndarray, any_valid: np.ndarray,
                          build_records: bool = False):
        """emit_chosen_encoded plus a span map describing where each
        record's bytes live: (records, (buffers, src_id, off, len)) with
        per-row (src_id[i], off[i], len[i]) into buffers[src_id[i]] —
        the paired emitter feeds these straight into the native
        scatter-gather record finalizer (native concat_spans) so no
        per-record Python concatenation remains on the hot path. With
        build_records=False (the paired fast path), fast/ta rows stay
        None in the records list — materializing 12k memoryview slices
        per mate per batch costs more than the rest of the bookkeeping;
        records_from_spans fills them on demand."""
        import os as _os
        import time as _time

        from ..native import lib as native_lib, native_emit_gapless_gam

        if native_lib() is None:
            return None
        prof = _os.environ.get("VGTPU_EMIT_PROF")

        def _mark(key, t0):
            d = self._espans_prof          # pre-created in __init__
            t1 = _time.perf_counter()
            d[key] = d.get(key, 0.0) + (t1 - t0)
            return t1

        _t = _time.perf_counter() if prof else 0
        p = self.params
        R = len(sb.reads)
        B = p.band_radius
        scores = sb.scores
        best_s = scores[np.arange(R), best_j]
        mapqs = np.asarray(mapqs, np.int32)

        text = self.haps.text
        L_arr = np.array([len(c) for c in sb.codes])
        RL = int(L_arr.max()) if R else 0
        ar = np.arange(R)
        diag = sb.cand_start[ar, best_j].astype(np.int64) + B
        lo = sb.cand_lo[ar, best_j]
        hi = sb.cand_hi[ar, best_j]
        rev = sb.cand_rev[ar, best_j]

        def host_mism(rows):
            """(len(rows), RL) winner mismatch mask via text-window
            gather — only for rows without a device-computed bitmap."""
            pos = diag[rows, None] + np.arange(RL)
            okr = ((pos >= lo[rows, None]) & (pos < hi[rows, None])
                   & (pos >= 0) & (pos < len(text)))
            twr = np.where(okr, text[np.clip(pos, 0, len(text) - 1)],
                           align_ops.SENTINEL).astype(np.uint8)
            if sb.codes2d is not None and sb.codes2d.shape[1] >= RL:
                orr = np.where(rev[rows, None], sb.codes_rc2d[rows, :RL],
                               sb.codes2d[rows, :RL])
            else:
                orr = np.full((len(rows), RL), 5, np.uint8)
                for k, i in enumerate(rows):
                    c = sb.codes_rc[i] if rev[i] else sb.codes[i]
                    orr[k, : len(c)] = c
            inr = np.arange(RL)[None, :] < L_arr[rows, None]
            return ((twr != orr) | (orr >= 4)) & inr

        wm = sb.winner_mism
        pos_mode = wm is not None and wm[2].dtype == np.uint8
        if wm is not None and not R:
            wm = None
        elif wm is not None and not pos_mode \
                and wm[2].shape[1] * 32 < RL:
            wm = None
        if wm is not None:
            dev_j, mm_dev, payload = wm
            use_dev = best_j == dev_j[:R]
            if pos_mode:
                # the payload carries only the first 8 mismatch
                # positions: rows with more recompute on host
                use_dev &= mm_dev[:R] <= 8
            mm = np.where(use_dev, mm_dev[:R], 0).astype(np.int64)
            hrows = np.nonzero(~use_dev)[0]
            mism_h = host_mism(hrows) if len(hrows) else None
            if mism_h is not None:
                mm[hrows] = mism_h.sum(axis=1)
        else:
            use_dev = np.zeros(R, bool)
            hrows = ar
            mism_h = host_mism(hrows) if R else None
            mm = mism_h.sum(axis=1) if R else np.zeros(0, np.int64)
        if prof:
            _t = _mark("mism", _t)
        gl_score = (L_arr - mm) * p.match - mm * p.mismatch \
            + 2 * p.full_length_bonus
        # in-range winners only (see emit_chosen): overhanging intervals
        # go through _traceback_into, which handles sentinel-masked windows
        fast = (any_valid & (gl_score == best_s)
                & (diag >= lo) & (diag + L_arr <= hi))
        w = np.nonzero(fast)[0]
        Nw = len(w)
        mism_w = np.zeros((Nw, RL), np.uint8)
        if Nw:
            wd = use_dev[w]
            if wd.any():
                if pos_mode:
                    from ..ops.xfer import pos8_to_mism_rows

                    mism_w[wd] = pos8_to_mism_rows(
                        wm[2][w[wd]], mm[w[wd]].astype(np.int64), RL)
                else:
                    bw = np.ascontiguousarray(
                        wm[2][w[wd]]).view(np.uint32)
                    unp = np.unpackbits(
                        bw.view(np.uint8).reshape(int(wd.sum()), -1),
                        axis=1, bitorder="little")
                    mism_w[wd] = unp[:, :RL]
            if (~wd).any():
                posh = np.searchsorted(hrows, w[~wd])
                mism_w[~wd] = mism_h[posh, :RL]

        records: List[object] = [None] * R
        if Nw:
            t0 = diag[w]
            t1 = t0 + L_arr[w]
            # refpos of the alignment's first mapping (vectorized
            # positions_of): fwd winners anchor at t0's node; rev winners
            # at t1's node in flipped orientation
            stp = self.haps.step_text_pos
            si0 = np.searchsorted(stp[1:], t0, side="right")
            si1 = np.searchsorted(stp[1:], t1 - 1, side="right")
            si = np.where(rev[w], si1, si0)
            h = self.haps.steps[si]
            nidx = (h >> 1).astype(np.int64)
            nlen = (self.graph.seq_start[nidx + 1]
                    - self.graph.seq_start[nidx])
            off_fwd = t0 - stp[si0]
            off_rev = nlen - (t1 - stp[si1])
            moff = np.where(rev[w], off_rev, off_fwd)
            mrev = (h & 1).astype(bool) ^ rev[w]
            rp = self._node_ref_path[nidx]
            step_off = self._node_ref_off[nidx]
            step_rev = self._node_ref_rev[nidx]
            same_or = mrev == step_rev
            roff = np.where(same_or, step_off + moff,
                            step_off + (nlen - moff))
            rrev = ~same_or
            wl = w.tolist()
            name_off, names = str_blob([sb.reads[i].name for i in wl])
            read_off, reads_blob = str_blob(
                [sb.reads[i].sequence for i in wl])
            qual_off, quals = qual_blob(
                [sb.reads[i].quality for i in wl])
            refname_off, refnames = str_blob(self.path_pos.path_names)
            arrs = {
                "N": Nw, "t0": t0, "t1": t1,
                "rev": rev[w].astype(np.uint8),
                "mapq": mapqs[w].astype(np.int32),
                "score": best_s[w].astype(np.int32),
                "name_off": name_off, "names": names,
                "read_off": read_off, "reads": reads_blob,
                "qual_off": qual_off, "quals": quals,
                "mism": mism_w,
                "RL": RL, "rlen": L_arr[w].astype(np.int64),
                "step_text_pos": self.haps.step_text_pos,
                "steps": self.haps.steps,
                "n_steps": len(self.haps.steps),
                "node_id": self.graph.node_id,
                "seq_start": self.graph.seq_start,
                "ref_path": rp.astype(np.int32),
                "ref_off": roff.astype(np.int64),
                "ref_rev": rrev.astype(np.uint8),
                "refname_off": refname_off, "refnames": refnames,
            }
            if prof:
                _t = _mark("fastprep", _t)
            cap = int(read_off[-1] * 6 + Nw * 512 + 4096)
            res = native_emit_gapless_gam(arrs, cap)
            if prof:
                _t = _mark("native_emit", _t)
            if res is None:
                return None
            buf, rec_off = res
            if build_records:
                mv = memoryview(buf)
                ro = rec_off.tolist()
                for k, i in enumerate(w.tolist()):
                    records[i] = mv[ro[k] : ro[k + 1]]

        # fallback: unmapped reads encode cheaply; indel/overhang winners
        # get the host traceback but batch through ONE native runs->GAM
        # encode (graph/POA winners keep the object path — rare)
        if prof:
            _t = _mark("fastrec", _t)
        slow = np.nonzero(~fast)[0]
        misc_rows: List[int] = []        # rows whose record is a Python
        ta_buf = None                    # bytes object (joined for spans)
        ta_off = None
        ta_row_ids: List[int] = []
        ta_rows: List[Tuple[int, object, int]] = []
        # batch the common slow case (clean in-band indel winners) into
        # ONE native OpenMP traceback call; rows it can't certify
        # (score disagreement, clipping, wide-band/graph-fallback
        # conditions) take the full per-row path below
        mapped_slow = [int(i) for i in slow if any_valid[i]]
        batch_ta = (self._traceback_slow_batch(
                        sb, mapped_slow, diag, lo, hi, rev, best_s)
                    if len(mapped_slow) >= 2 else {})
        if prof:
            _t = _mark("slow_batch", _t)
        for i in slow:
            if not any_valid[i]:
                r = sb.reads[i]
                qual = bytes((ord(q) - 33) for q in r.quality) \
                    if r.quality else b""
                records[i] = Alignment(
                    name=r.name, sequence=r.sequence,
                    quality=qual).encode()
                misc_rows.append(i)
                continue
            res = batch_ta.get(int(i))
            if res is None:
                res = self._traceback_ta(
                    sb.codes[i], sb.codes_rc[i], int(diag[i]) - B,
                    int(lo[i]), int(hi[i]), bool(rev[i]),
                    int(best_s[i]))
            if res[0] == "ta" and res[1].text_end > res[1].text_start:
                ta_rows.append((i, res[1], res[2]))
            else:
                r = sb.reads[i]
                qual = bytes((ord(q) - 33) for q in r.quality) \
                    if r.quality else b""
                aln = Alignment(name=r.name, sequence=r.sequence,
                                quality=qual)
                aln.mapping_quality = int(mapqs[i])
                self._apply_traceback(aln, res, sb.codes[i],
                                      sb.codes_rc[i], bool(rev[i]))
                records[i] = aln.encode()
                misc_rows.append(i)
        if prof:
            _t = _mark("slow_loop", _t)
        if ta_rows:
            ta_res = self._emit_ta_runs(sb, ta_rows, mapqs, rev)
            if ta_res is None:
                for i, _, _ in ta_rows:
                    aln = self.emit(sb, i, int(best_j[i]), int(mapqs[i]))
                    records[i] = aln.encode()
                    misc_rows.append(i)
            else:
                recs, ta_buf, ta_off = ta_res
                ta_row_ids = [i for i, _, _ in ta_rows]
                for (i, _, _), rec in zip(ta_rows, recs):
                    records[i] = rec
        if prof:
            _t = _mark("slowrows", _t)
        # span map: where each record's bytes live, for the native
        # scatter-gather pair finalizer
        src_id = np.zeros(R, np.uint8)
        off = np.zeros(R, np.int64)
        ln = np.zeros(R, np.int64)
        if Nw:
            src_id[w] = 0
            off[w] = rec_off[:Nw]
            ln[w] = rec_off[1 : Nw + 1] - rec_off[:Nw]
            fast_buf = buf
        else:
            fast_buf = b""
        if ta_row_ids:
            ids = np.asarray(ta_row_ids)
            src_id[ids] = 1
            nta = len(ids)
            off[ids] = ta_off[:nta]
            ln[ids] = ta_off[1 : nta + 1] - ta_off[:nta]
        if misc_rows:
            ids = np.asarray(misc_rows)
            src_id[ids] = 2
            lens = np.array([len(records[i]) for i in misc_rows],
                            np.int64)
            offs = np.zeros(len(ids) + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            off[ids] = offs[:-1]
            ln[ids] = lens
            misc_blob = b"".join(bytes(records[i]) for i in misc_rows)
        else:
            misc_blob = b""
        spans = ([fast_buf, ta_buf if ta_buf is not None else b"",
                  misc_blob], src_id, off, ln)
        return records, spans

    def _emit_ta_runs(self, sb: "ScoredBatch", ta_rows, mapqs, rev):
        """Batch TextAlignment winners (indel / overhang tracebacks) into
        one native runs->GAM encode — the same emit_runs_gam entry the
        long-read pipeline uses, so the ~1% non-gapless short-read winners
        stop paying the per-read Python path/encode cost. Byte-identical
        to the object path (text_alignment_to_path + annotate_refpos +
        Alignment.encode): parity asserted in tests."""
        from ..native import native_emit_runs_gam
        from .project import refpos_walk

        Nw = len(ta_rows)
        op_code = {"M": 0, "X": 1, "I": 2, "D": 3}
        run_blocks = []
        for _, ta, _ in ta_rows:
            runs = np.zeros((len(ta.edits), 3), np.int32)
            rp = ta.read_start
            for k, e in enumerate(ta.edits):
                op = op_code[e[0]]
                ln = int(e[1])
                runs[k] = (op, ln, rp)
                if op != 3:
                    rp += ln
            run_blocks.append(runs)
        runs_off = np.zeros(Nw + 1, np.int64)
        np.cumsum([len(r) for r in run_blocks], out=runs_off[1:])
        runs_all = (np.concatenate(run_blocks) if runs_off[-1]
                    else np.zeros((1, 3), np.int32))
        t0 = np.array([ws + ta.text_start for _, ta, ws in ta_rows],
                      np.int64)
        t1 = np.array([ws + ta.text_end for _, ta, ws in ta_rows], np.int64)
        rows = [i for i, _, _ in ta_rows]
        rv = np.array([bool(rev[i]) for i in rows], np.uint8)
        name_off, names = str_blob([sb.reads[i].name for i in rows])
        read_off, reads_blob = str_blob(
            [sb.reads[i].sequence for i in rows])
        qual_off, quals = qual_blob([sb.reads[i].quality for i in rows])
        refname_off, refnames = str_blob(self.path_pos.path_names)
        name_to_pi = {n: k for k, n in enumerate(self.path_pos.path_names)}
        rp_arr = np.full(Nw, -1, np.int32)
        ro_arr = np.zeros(Nw, np.int64)
        rr_arr = np.zeros(Nw, np.uint8)
        for wi, (i, ta, ws) in enumerate(ta_rows):
            hits = refpos_walk(self.haps, self.graph, self.path_pos,
                               int(t0[wi]), int(t1[wi]), bool(rev[i]))
            if hits:
                rp_arr[wi] = name_to_pi[hits[0].name]
                ro_arr[wi] = hits[0].offset
                rr_arr[wi] = 1 if hits[0].is_reverse else 0
        arrs = {
            "N": Nw, "t0": t0, "rev": rv,
            "mapq": np.array([int(mapqs[i]) for i in rows], np.int32),
            "score": np.array([ta.score for _, ta, _ in ta_rows], np.int32),
            "matches": np.array([ta.matches for _, ta, _ in ta_rows],
                                np.int64),
            "read_start": np.array([ta.read_start for _, ta, _ in ta_rows],
                                   np.int64),
            "read_end": np.array([ta.read_end for _, ta, _ in ta_rows],
                                 np.int64),
            "name_off": name_off, "names": names,
            "read_off": read_off, "reads": reads_blob,
            "qual_off": qual_off, "quals": quals,
            "runs": np.ascontiguousarray(runs_all, np.int32),
            "runs_off": runs_off,
            "step_text_pos": self.haps.step_text_pos,
            "steps": self.haps.steps,
            "n_steps": len(self.haps.steps),
            "node_id": self.graph.node_id,
            "seq_start": self.graph.seq_start,
            "ref_path": rp_arr, "ref_off": ro_arr, "ref_rev": rr_arr,
            "refname_off": refname_off, "refnames": refnames,
        }
        res = native_emit_runs_gam(arrs)
        if res is None:
            return None
        buf, rec_off = res
        mv = memoryview(buf)
        return ([mv[int(rec_off[k]) : int(rec_off[k + 1])]
                 for k in range(Nw)], buf, rec_off)

    def _gapless_check(self, oriented: np.ndarray, window: np.ndarray,
                       device_score: int):
        """If the winner is a full-length gapless alignment on the center
        diagonal (the overwhelmingly common short-read case, vg's
        extension_to_alignment shortcut, src/minimizer_mapper.cpp:3897),
        build the edits directly from the mismatch mask — no DP traceback."""
        from ..ops.traceback import TextAlignment

        p = self.params
        B = p.band_radius
        L = len(oriented)
        t = window[B : B + L]
        mism = (t != oriented) | (oriented >= 4)
        mm = int(mism.sum())
        score = (L - mm) * p.match - mm * p.mismatch + 2 * p.full_length_bonus
        if score != device_score:
            return None
        edits = []
        i = 0
        while i < L:
            j = i
            state = bool(mism[i])
            while j < L and bool(mism[j]) == state:
                j += 1
            if state:
                edits.append(("X", j - i, oriented[i:j]))
            else:
                edits.append(("M", j - i))
            i = j
        return TextAlignment(score=score, read_start=0, read_end=L,
                             text_start=B, text_end=B + L, edits=edits,
                             matches=L - mm)

    def _traceback_into(self, aln: Alignment, codes: np.ndarray,
                        codes_rc: np.ndarray, wstart: int, lo: int, hi: int,
                        is_rev: bool, device_score: int) -> None:
        res = self._traceback_ta(codes, codes_rc, wstart, lo, hi,
                                 is_rev, device_score)
        self._apply_traceback(aln, res, codes, codes_rc, is_rev)

    def _apply_traceback(self, aln: Alignment, res, codes: np.ndarray,
                         codes_rc: np.ndarray, is_rev: bool) -> None:
        """Materialize a _traceback_ta result into an Alignment object."""
        kind = res[0]
        if kind == "graph":
            ga = res[1]
            aln.path = ga.path
            aln.score = ga.score
            aln.identity = ga.identity
            self.path_pos.annotate_refpos(aln)
        elif kind == "ta":
            ta, ws = res[1], res[2]
            L = len(codes)
            oriented = codes_rc if is_rev else codes
            aln.path = text_alignment_to_path(self.haps, ta, ws, oriented,
                                              is_rev)
            aln.score = ta.score
            aln.identity = ta.matches / L if L else 0.0
            self.path_pos.annotate_refpos(aln)

    def _traceback_slow_batch(self, sb: "ScoredBatch", rows, diag, lo,
                              hi, rev, best_s):
        """One native OpenMP banded-traceback call over all mapped slow
        rows. Returns {row: ('ta', TextAlignment, wstart)} for rows
        whose result is certain: host score equals the device score and
        none of the wide-band / graph-fallback conditions of
        _traceback_ta apply. Everything else is left to the per-row
        path (which re-runs the DP — rare by construction)."""
        from ..native import native_banded_tracebacks

        p = self.params
        if p.qual_adjusted or not rows:
            return {}
        rows_a = np.asarray(rows)
        L_arr = np.array([len(sb.codes[i]) for i in rows])
        Lmax = int(L_arr.max())
        B = p.band_radius
        TW = Lmax + 2 * B
        n = len(rows)
        reads = np.full((n, Lmax), 5, np.uint8)
        for k, i in enumerate(rows):
            c = sb.codes_rc[i] if rev[i] else sb.codes[i]
            reads[k, : len(c)] = c
        text = self.haps.text
        wstart = diag[rows_a] - B
        pos = wstart[:, None] + np.arange(TW)
        ok = ((pos >= lo[rows_a, None]) & (pos < hi[rows_a, None])
              & (pos >= 0) & (pos < len(text)))
        wins = np.where(ok, text[np.clip(pos, 0, len(text) - 1)],
                        align_ops.SENTINEL).astype(np.uint8)
        scoring = align_ops.Scoring(p.match, p.mismatch, p.gap_open,
                                    p.gap_extend, p.full_length_bonus)
        res = native_banded_tracebacks(reads, L_arr, wins, B, scoring)
        if res is None:
            return {}
        out = {}
        mc = p.graph_fallback_min_clip
        for k, i in enumerate(rows):
            ta = res[k]
            if ta is None:
                continue
            L = int(L_arr[k])
            if ta.score != int(best_s[i]):
                continue                       # host/device disagree
            if ta.score < (L - 4 * p.mismatch) * p.match:
                continue                       # wide-band retry case
            if p.graph_fallback and (
                    ta.read_start >= mc or ta.read_end <= L - mc
                    or ta.score < p.graph_fallback_frac * L):
                continue                       # graph-fallback case
            if ta.text_end <= ta.text_start:
                continue
            out[int(i)] = ("ta", ta, int(wstart[k]))
        return out

    def _traceback_ta(self, codes: np.ndarray, codes_rc: np.ndarray,
                      wstart: int, lo: int, hi: int, is_rev: bool,
                      device_score: int):
        """Winner traceback decision shared by the object and encoded
        emitters: banded DP (+gapless shortcut), wide-band retry, and
        graph-space POA fallback. Returns one of ('ta', TextAlignment,
        final_wstart) | ('graph', graph_result) | ('none', None)."""
        p = self.params
        L = len(codes)
        TW = L + 2 * p.band_radius
        pos = wstart + np.arange(TW)
        ok = (pos >= lo) & (pos < hi) & (pos >= 0) & (pos < len(self.haps.text))
        window = np.where(ok, self.haps.text[np.clip(pos, 0, len(self.haps.text) - 1)],
                          align_ops.SENTINEL).astype(np.uint8)
        oriented = codes_rc if is_rev else codes
        scoring = align_ops.Scoring(p.match, p.mismatch, p.gap_open,
                                    p.gap_extend, p.full_length_bonus)
        ta = self._gapless_check(oriented, window, device_score)
        if ta is None:
            ta = banded_traceback(oriented, window, p.band_radius, scoring)
        if ta is not None and not p.qual_adjusted:
            assert ta.score == device_score, (
                f"host/device DP disagreement: {ta.score} != {device_score}")
        # wide-band refinement: indels beyond the device band radius clip
        # or gap-split under B; a second host pass with 4x the band
        # recovers them (vg's dozeu tail bands are similarly wider than
        # the extension band)
        if ta is None or ta.score < (L - 4 * p.mismatch) * p.match:
            B2 = 4 * p.band_radius
            diag = wstart + p.band_radius
            pos2 = diag - B2 + np.arange(L + 2 * B2)
            ok2 = (pos2 >= lo) & (pos2 < hi) & (pos2 >= 0) & \
                (pos2 < len(self.haps.text))
            window2 = np.where(
                ok2, self.haps.text[np.clip(pos2, 0, len(self.haps.text) - 1)],
                align_ops.SENTINEL).astype(np.uint8)
            ta2 = banded_traceback(oriented, window2, B2, scoring)
            if ta2 is not None and (ta is None or ta2.score > ta.score):
                ta = ta2
                wstart = diag - B2
        # graph-space fallback: the read's allele combination may sit on
        # no indexed haplotype (recombinant across a variant pair, novel
        # indel) — realign against the local graph region via POA.
        # Triggers on soft-clipped winners (a clipped tail is exactly the
        # "tail needs graph alignment" case, reference
        # find_optimal_tail_alignments src/minimizer_mapper.cpp:5361) and
        # on low absolute score.
        mc = p.graph_fallback_min_clip
        clipped = ta is not None and (
            ta.read_start >= mc or ta.read_end <= L - mc)
        if p.graph_fallback and (
                ta is None or clipped
                or ta.score < p.graph_fallback_frac * L):
            ga = self._graph_fallback(codes, wstart + p.band_radius, lo, hi)
            if p.track_provenance:
                self.funnel.filter(
                    "align", "graph-fallback-won", 1,
                    int(ga is not None and (ta is None
                                            or ga.score > ta.score)))
            if ga is not None and (ta is None or ga.score > ta.score):
                return ("graph", ga)
        if ta is None:
            return ("none", None)
        return ("ta", ta, wstart)

    def _graph_fallback(self, codes: np.ndarray, diag: int, lo: int,
                        hi: int):
        """POA of the (forward) read against the dagified local graph
        around the candidate's projection. The flattened handle DAG holds
        both orientations, so reverse-strand placements come out
        naturally."""
        from ..graph.ops import local_subgraph

        p = self.params
        L = len(codes)
        anchor = int(np.clip(diag, lo, max(lo, hi - 1)))
        node_id, _off, _rev = self.haps.text_pos_to_graph(anchor)
        # subgraph extraction + SCC-unrolling flatten are read-independent
        # given (anchor node, read length): cache them — novel-variant
        # regions attract repeated fallbacks across batches, and the
        # flatten was ~half the fallback's 9 ms (emit-stage tail spikes)
        key = (int(node_id), L)
        cache = self._gf_cache             # pre-created in __init__
        hit = cache.get(key)
        if hit is None:
            # collect nodes within L + radius bp of the anchor node
            # (both directions, both strands)
            budget = L + p.graph_fallback_radius
            g = self.graph
            start_h = g.idx(node_id) * 2
            dist = {start_h: 0, start_h ^ 1: 0}
            queue = [start_h, start_h ^ 1]
            qi = 0
            nodes = {int(node_id)}
            total_bases = g.handle_len(start_h)
            while (qi < len(queue)
                   and total_bases < p.graph_fallback_max_bases):
                h = queue[qi]
                qi += 1
                d = dist[h] + g.handle_len(h)
                if d > budget:
                    continue
                for nxt in g.follow(h):
                    nxt = int(nxt)
                    if nxt not in dist or d < dist[nxt]:
                        dist[nxt] = d
                        queue.append(nxt)
                        nid2 = int(g.node_id[nxt >> 1])
                        if nid2 not in nodes:
                            nodes.add(nid2)
                            total_bases += g.handle_len(nxt)
            try:
                from ..ops.graph_align import _flatten_dagified

                sub = local_subgraph(g, nodes)
                dag = _flatten_dagified(sub, max_walk=L + 32)
            except Exception:
                return None
            if len(cache) >= 1024:
                cache.clear()
            hit = cache[key] = (sub, dag)
        sub, dag = hit
        try:
            from ..ops.graph_align import _align_dag

            return _align_dag(
                dag, sub, codes,
                align_ops.Scoring(p.match, p.mismatch, p.gap_open,
                                  p.gap_extend, p.full_length_bonus))
        except Exception:
            return None
