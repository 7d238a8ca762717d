"""MEM-based mapper: the honest `vg map` (reference: Mapper::align_multi
src/mapper.cpp:4484, BaseMapper::find_mems_deep src/mapper.hpp:210,
src/mem.cpp, MEMChainModel src/cluster.hpp:120).

TPU-native redesign: the GCSA2 graph-kmer suffix array is replaced by a
plain suffix array over the haplotype text (native C++, built once at
index time), so maximal exact matches come from binary-searched text
search instead of FM-index rank walks. Seeds feed the SAME clustering,
batched banded DP, pairing, MAPQ, and emission machinery as the giraffe
engine — only the seeding stage differs (MEMs instead of minimizers),
which is exactly the relationship the two mappers have in the reference.

From vg_tpu/map/memmapper.py, with one change: `MEMMapper` takes the
mapper's `device` (None = the card, "cpu" for the plain versions) and
passes it to `GiraffeMapper`, whose DP it shares.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..index.haplotypes import HaplotypeSet
from ..utils import dna
from .giraffe import GiraffeMapper, GiraffeParams


class MEMIndex:
    """Suffix array over the haplotype text + MEM queries.

    Texts above ``shard_above`` build SHARDED: the text splits into
    chunks (each with a forward overlap so any exact match up to
    ``overlap`` bases starting inside a chunk is fully contained in it),
    per-chunk SA-IS builds run concurrently (the ctypes call releases
    the GIL), and queries merge per-chunk hits with chunk-local int32
    coordinates lifted to global int64 — removing both the single-build
    wall-clock cliff and the int32 position ceiling the reference's
    GCSA2 never had (src/mapper.hpp:210, src/mem.cpp). 128 Mbp shards
    measured: the SA-IS working set fits cache ~2x better per byte than
    256 Mbp shards (1.05 Gbp build 113s -> ~60s on 4 cores) and the
    extra per-shard query pass only touches zero-candidate reads."""

    def __init__(self, haps: HaplotypeSet, sa: Optional[np.ndarray] = None,
                 min_mem_length: int = 19, max_mem_hits: int = 64,
                 shard_above: int = 1 << 27, overlap: int = 1024,
                 cache_dir: Optional[str] = None):
        from ..native import native_build_suffix_array

        self.haps = haps
        self.min_mem_length = min_mem_length
        self.max_mem_hits = max_mem_hits
        self.overlap = overlap
        self.chunks: Optional[List] = None   # [(base, core_len, sa)]
        text = haps.text
        if sa is None and len(text) > shard_above:
            self._build_sharded(text, shard_above, cache_dir)
            self.sa = None
            return
        if sa is None:
            sa = native_build_suffix_array(text)
            if sa is None:
                sa = self._python_suffix_array(text)
        self.sa = np.asarray(sa, np.int32)

    def _build_sharded(self, text: np.ndarray, shard_above: int,
                       cache_dir: Optional[str] = None) -> None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        from ..native import native_build_suffix_array

        n = len(text)
        workers = max(1, os.cpu_count() or 4)
        # enough chunks to feed every core, each at most shard_above long
        n_chunks = max(workers, -(-n // shard_above))
        core = -(-n // n_chunks)
        bases = list(range(0, n, core))

        import hashlib
        import sys
        import time as _t

        # on-disk shard cache: the suffix array is a pure function of
        # the text, and the reference's analogue (GCSA2) is always a
        # prebuilt on-disk artifact (src/subcommand/index_main.cpp) —
        # rebuilding it per process was our own cliff, not parity
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

        def build(base):
            t0 = _t.time()
            end = min(base + core, n)
            slice_end = min(end + self.overlap, n)
            part = np.ascontiguousarray(text[base:slice_end])
            cp = None
            if cache_dir:
                # key on the shard's own FULL bytes (blake2b runs at
                # ~1 GB/s — noise next to the SA-IS build; a sampled
                # hash silently served a stale SA to any same-length
                # text differing outside the sampled windows)
                h = hashlib.blake2b(part.tobytes(), digest_size=12)
                cp = os.path.join(cache_dir,
                                  f"sa_{h.hexdigest()}_{len(part)}.npy")
            if cp and os.path.exists(cp):
                try:
                    sa = np.load(cp)
                    if sa.shape == (len(part),) and sa.dtype == np.int32:
                        return (base, end - base, sa, part)
                except Exception:               # truncated/corrupt file
                    pass                        # (EOFError/ValueError/
                                                # OSError) -> rebuild
            sa = native_build_suffix_array(part)
            if sa is None:
                sys.stderr.write(
                    f"[vg_tpu] WARNING: native lib unavailable — numpy "
                    f"prefix-doubling SA for chunk @{base} "
                    f"({len(part)/1e6:.0f} Mbp, slow)\n")
                sa = self._python_suffix_array(part)
            sa = np.asarray(sa, np.int32)
            if cp:
                try:                            # atomic publish: a
                    # (np.save appends .npy unless the name ends in it)
                    tmp = cp[:-4] + f".{os.getpid()}.tmp.npy"
                    np.save(tmp, sa)            # killed/partial write
                    os.rename(tmp, cp)          # must never leave a
                except OSError:                 # truncated cache file
                    pass                        # cache is best-effort
            sys.stderr.write(
                f"[vg_tpu] SA shard @{base} ({len(part)/1e6:.0f} Mbp) "
                f"in {_t.time()-t0:.0f}s\n")
            return (base, end - base, sa, part)

        with ThreadPoolExecutor(max_workers=workers) as ex:
            self.chunks = list(ex.map(build, bases))

    @staticmethod
    def _python_suffix_array(text: np.ndarray) -> np.ndarray:
        """Fallback SA via numpy prefix-doubling (no native toolchain)."""
        n = len(text)
        rank = text.astype(np.int64)
        sa = np.arange(n)
        k = 1
        while True:
            key2 = np.full(n, -1, np.int64)
            key2[: n - k] = rank[k:]
            order = np.lexsort((key2, rank))
            sa = order
            nr = np.zeros(n, np.int64)
            r1, r2 = rank[order], key2[order]
            new = np.ones(n, bool)
            new[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
            nr[order] = np.cumsum(new) - 1
            rank = nr
            if rank[sa[-1]] == n - 1:
                break
            k <<= 1
        return sa.astype(np.int32)

    def find_mems(self, codes: np.ndarray):
        from ..native import native_find_mems

        if self.chunks is not None:
            return self._find_mems_sharded(codes)
        res = native_find_mems(self.haps.text, self.sa, codes,
                               self.min_mem_length, self.max_mem_hits)
        if res is not None:
            return res
        return self._python_find_mems(codes)

    def find_mems_batch(self, reads: List[np.ndarray]):
        """MEMs for MANY oriented reads: per shard, ONE native OpenMP
        call over all reads (chromosome-scale zero-candidate rescue was
        paying a per-(read, shard) ctypes roundtrip). Returns a list of
        (read_start, length, text_pos) aligned with `reads`."""
        from ..native import native_find_mems_many

        n = len(reads)
        if n == 0:
            return []
        Lmax = max(len(r) for r in reads)
        r2d = np.full((n, Lmax), 5, np.uint8)
        rlen = np.zeros(n, np.int64)
        for k, r in enumerate(reads):
            r2d[k, : len(r)] = r
            rlen[k] = len(r)
        if self.chunks is None:
            res = native_find_mems_many(
                self.haps.text, self.sa, r2d, rlen,
                self.min_mem_length, self.max_mem_hits)
            if res is None:
                return [self.find_mems(r) for r in reads]
            return res
        per_read: List[List] = [[] for _ in range(n)]
        bufs: List = [None] * 4          # reused across the shard loop
        for base, core_len, sa, part in self.chunks:
            res = native_find_mems_many(part, sa, r2d, rlen,
                                        self.min_mem_length,
                                        self.max_mem_hits,
                                        emit_over_cap=True, bufs=bufs)
            if res is None:
                return [self.find_mems(r) for r in reads]
            for k, (rs, ln, tp) in enumerate(res):
                per_read[k].append((base, core_len, rs, ln, tp))
        return [self._merge_chunk_mems(parts) for parts in per_read]

    def _find_mems_sharded(self, codes: np.ndarray):
        from ..native import native_find_mems

        parts_out = []
        for base, core_len, sa, part in self.chunks:
            res = native_find_mems(part, sa, codes,
                                   self.min_mem_length, self.max_mem_hits,
                                   emit_over_cap=True)
            if res is None:
                res = self._python_find_mems_on(part, sa, codes,
                                                emit_over_cap=True)
            rs, ln, tp = res
            parts_out.append((base, core_len, rs, ln, tp))
        return self._merge_chunk_mems(parts_out)

    def _merge_chunk_mems(self, parts):
        """Merge per-chunk MEM query results into EXACTLY the single-SA
        result (matches ≤ ``overlap`` long; longer exact stretches are
        reported truncated at a chunk slice — build with a larger
        overlap for exact lengths on such reads).

        Why this is exact: each text occurrence is OWNED by exactly one
        chunk (tp < core_len) and any owned match up to `overlap` long
        is fully readable there, so (a) the global maximal length at a
        read position is the max of the chunk-maximal lengths, (b) the
        global occurrence count at that length is the sum of owned
        counts over chunks reporting exactly that length (shorter-match
        chunks hold zero occurrences of the longer pattern), and (c) a
        position suppressed by a chunk's containment rule is always
        globally contained too (its container is reported by that same
        chunk with an equal-or-longer global length). Chunk-repetitive
        MEMs arrive as count sentinels (text_pos = -count) so the
        max_mem_hits filter applies to the GLOBAL count — a per-chunk
        cap would re-admit globally repetitive MEMs that the single SA
        deliberately drops. Sentinel counts are raw (they may include
        not-owned overlap occurrences), which can only over-count —
        erring toward dropping an already-repetitive MEM."""
        # read_start -> list of (length, owned_count, owned_tp_global)
        groups: dict = {}
        for base, core_len, rs, ln, tp in parts:
            if len(rs) == 0:
                continue
            brk = np.ones(len(rs), bool)
            brk[1:] = rs[1:] != rs[:-1]
            starts = np.nonzero(brk)[0]
            ends = np.concatenate([starts[1:], [len(rs)]])
            for s, e in zip(starts, ends):
                i = int(rs[s])
                l = int(ln[s])
                if tp[s] < 0:                       # count sentinel
                    groups.setdefault(i, []).append((l, int(-tp[s]), None))
                    continue
                own = tp[s:e] < core_len
                cnt = int(own.sum())
                if cnt:
                    groups.setdefault(i, []).append(
                        (l, cnt, tp[s:e][own].astype(np.int64) + base))
        out_rs: List[int] = []
        out_ln: List[int] = []
        out_tp: List[np.ndarray] = []
        prev_end = -1
        for i in sorted(groups):
            entries = groups[i]
            lmax = max(l for l, _, _ in entries)
            if i + lmax <= prev_end:
                continue
            prev_end = i + lmax                 # updates even when the
            sel = [(c, o) for l, c, o in entries if l == lmax]
            total = sum(c for c, _ in sel)      # MEM is then dropped as
            if total == 0 or total > self.max_mem_hits:
                continue                        # repetitive (single-SA
            for c, o in sel:                    # loop order)
                if o is not None:
                    out_rs.extend([i] * len(o))
                    out_ln.extend([lmax] * len(o))
                    out_tp.append(o)
        return (np.array(out_rs, np.int32), np.array(out_ln, np.int32),
                np.concatenate(out_tp) if out_tp
                else np.zeros(0, np.int64))

    def _python_find_mems(self, codes: np.ndarray):
        return self._python_find_mems_on(self.haps.text, self.sa, codes)

    def _python_find_mems_on(self, text: np.ndarray, sa: np.ndarray,
                             codes: np.ndarray,
                             emit_over_cap: bool = False):
        n = len(text)
        L = len(codes)
        rs: List[int] = []
        ln: List[int] = []
        tp: List[int] = []
        prev_end = -1
        for i in range(L - self.min_mem_length + 1):
            lo, hi, l = 0, n, 0
            while i + l < L and codes[i + l] < 4:
                pat = codes[i : i + l + 1]
                nlo = lo + np.searchsorted(
                    _suffix_keys(text, sa[lo:hi], l + 1), pat.tobytes(),
                    side="left")
                nhi = lo + np.searchsorted(
                    _suffix_keys(text, sa[lo:hi], l + 1), pat.tobytes(),
                    side="right")
                if nlo >= nhi:
                    break
                lo, hi, l = nlo, nhi, l + 1
            if l < self.min_mem_length or i + l <= prev_end:
                continue
            prev_end = i + l
            if hi - lo > self.max_mem_hits:
                if emit_over_cap:        # count sentinel (sharded merge)
                    rs.append(i)
                    ln.append(l)
                    tp.append(-(hi - lo))
                continue
            for x in range(lo, hi):
                rs.append(i)
                ln.append(l)
                tp.append(int(sa[x]))
        return (np.array(rs, np.int32), np.array(ln, np.int32),
                np.array(tp, np.int64))


def _suffix_keys(text, sas, l):
    out = []
    n = len(text)
    for s in sas:
        out.append(text[s : min(n, s + l)].tobytes())
    return out


class MEMMapper(GiraffeMapper):
    """`vg map` engine: MEM seeding, shared giraffe downstream stages."""

    def __init__(self, haps: HaplotypeSet, mem_index: MEMIndex,
                 params: Optional[GiraffeParams] = None,
                 ref_path_names: Optional[List[str]] = None,
                 device=None):
        from ..index.minimizer import MinimizerIndex

        # the giraffe base class wants a minimizer index only for its own
        # seeding, which we replace wholesale; give it an empty one
        super().__init__(haps, MinimizerIndex(), params, ref_path_names,
                         device=device)
        self.mem_index = mem_index

    def _seed_batch(self, codes2d: np.ndarray):
        p = self.params
        R, L = codes2d.shape
        C = p.max_candidates
        out = (np.zeros((R, C), np.int32), np.zeros((R, C), np.int32),
               np.zeros((R, C), np.int32), np.zeros((R, C), bool),
               np.zeros((R, C), bool), np.full((R, C), -1, np.int32),
               np.zeros((R, C), np.int64))
        sread: List[int] = []
        strand: List[bool] = []
        diag: List[int] = []
        roff: List[int] = []
        score: List[float] = []
        for r in range(R):
            codes = codes2d[r]
            rc = dna.revcomp_codes(codes)
            for is_rev, cc in ((False, codes), (True, rc)):
                rs, ln, tp = self.mem_index.find_mems(cc)
                for i in range(len(rs)):
                    sread.append(r)
                    strand.append(is_rev)
                    diag.append(int(tp[i]) - int(rs[i]))
                    roff.append(int(rs[i]))
                    score.append(float(ln[i]))
        return self._cluster_seeds_to_candidates(
            np.array(sread, np.int64), np.array(strand, bool),
            np.array(diag, np.int64), np.array(roff, np.int64),
            np.array(score, np.float64), out)

    def _seed_read(self, codes: np.ndarray):
        # route single-read (ragged-length) seeding through the batch path
        res = self._seed_batch(codes[None, :])
        from .giraffe import _Candidate

        (cs, clo, chi, crev, cval, _rp, _ro) = res
        cands = []
        for j in range(cs.shape[1]):
            if cval[0, j]:
                cands.append(_Candidate(
                    diag=int(cs[0, j]) + self.params.band_radius,
                    is_rev=bool(crev[0, j]), score=0.0, n_seeds=1,
                    lo=int(clo[0, j]), hi=int(chi[0, j])))
        return cands
