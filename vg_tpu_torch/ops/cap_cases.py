"""Inputs of the explored-minimizer MAPQ cap (ops/cuda_mapqcap.mapq_cap),
made with numpy from a seed. tests/test_torch_mapq_cap.py holds the plain
version against vg_tpu's map/mapqcap.explored_cap on them;
tests/test_torch_mapq_cap_kernel.py and chip_smoke.py hold the kernel
against the plain version.

Every case is a dict: `reads`, a list of (codes uint8 (0-4), phred uint8
array or None), and `keys`, the sorted uint64 minimizer keys of an index
(each present once: MinimizerIndex.keys with a count above 0). The index
is the minimizers of a random 20 kbp genome (both strands share canonical
keys), the canonical keys of the cases' repeat kmers, and random 64-bit
keys, half of them at or above 2^63 (a signed comparison sorts them before
the rest). `ragged(case)` lays a case out as mapq_cap takes it (qualities
as FASTQ bytes, phred + 33); `padded_quals` turns those bytes into the
padded phred layout the kernel's first form took. CASES names them:

- "phred60": 64 reads of 150 bases from the genome (both strands, 1%
  substitutions), phred drawn from 0-60;
- "phred93": the same, phred from 0-93 with runs of 0 and of 93;
- "short_and_n": lengths 0, 1, 28 (< k), 29 (= k: one kmer), 30, 38
  (k + w - 2: fewer kmers than a window), 39 (k + w - 1), 40 and 150;
  scattered N bases, a run of N across a kmer, and an all-N read;
- "absent": reads of random sequence (no minimizer in the index), and
  reads half genome, half random (some absent);
- "ties": homopolymers and tandem repeats of period 2, 3, 5, 7 and 12,
  alone (150, 60, 45 and 35 bases) and inside genome sequence, whose
  equal kmers tie in their agglomerations' ends, and in the short reads
  (fewer than 2w - 1 kmers) in their starts too, so that the stable
  order of the sort decides;
- "lengths": reads of 100, 150, 151 and 250 bases in one batch, each
  quality as long as its read;
- "mixed_quality": reads without a quality (None), with an empty one,
  with one longer than the read, and with one a base, among reads with
  qualities;
- "long": reads past the kernel's shared-memory rows
  (cuda_mapqcap.SMEM_POSITIONS = 512 kmer positions, 540 bases at k =
  29) among 150-base reads: 540 (the widest in shared memory), 541 (the
  narrowest past it), 1,000, 4,097 and 10,000 bases, a 6,000-base read
  with a run of N, a 5,000-base read of random sequence (no minimizer in
  the index) and a 10,000-base read without a quality.

`random_case(seed, n)` is n reads of 100, 150, 151 or 250 bases (a few of
10-60), 1% substitutions, N bases in one read in ten, a third of them from
random sequence, phred from several profiles. `of_lengths(lengths)` is
reads of the given lengths. `count_fn(keys)` is MinimizerIndex.count on a
case's key set (1 for a present key), for explored_cap.
"""
from __future__ import annotations

import numpy as np

from ..index.minimizer import DEFAULT_K, DEFAULT_W, _rolling_kmers
from ..map.mapqcap import minimizer_agglomerations
from ..utils.dna import revcomp_codes

K, W = DEFAULT_K, DEFAULT_W
CASES = ("phred60", "phred93", "short_and_n", "absent", "ties", "lengths",
         "mixed_quality", "long")
LONG_LENGTHS = (540, 541, 1000, 4097, 10_000)
GENOME_LEN = 20_000
REPEAT_PERIODS = (1, 2, 3, 5, 7, 12)


def _genome(rng) -> np.ndarray:
    return rng.integers(0, 4, GENOME_LEN).astype(np.uint8)


def _canonical_keys(codes: np.ndarray, k: int = K) -> np.ndarray:
    """The canonical keys of every kmer of codes without N."""
    fwd, rev, valid = _rolling_kmers(codes, k)
    return np.where(rev < fwd, rev, fwd)[valid]


def _repeat(rng, period: int, n: int) -> np.ndarray:
    unit = rng.integers(0, 4, period).astype(np.uint8)
    return np.resize(unit, n)


def _index_keys(rng, genome: np.ndarray, repeats) -> np.ndarray:
    """Sorted unique uint64: the genome's minimizers, the repeats' kmers
    and random keys (half with the top bit set)."""
    mins = minimizer_agglomerations(genome, K, W)[4]
    rep = [_canonical_keys(r) for r in repeats]
    junk = rng.integers(0, 2 ** 62, 500, dtype=np.uint64)
    junk[250:] |= np.uint64(1 << 63)
    return np.unique(np.concatenate([mins, *rep, junk]).astype(np.uint64))


def _sample(rng, genome: np.ndarray, L: int, sub: float = 0.01):
    s = int(rng.integers(0, len(genome) - L + 1))
    c = genome[s : s + L].copy()
    hit = rng.random(L) < sub
    c[hit] = (c[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return revcomp_codes(c) if rng.random() < 0.5 else c


def _phred(rng, L: int, hi: int = 41) -> np.ndarray:
    return rng.integers(0, hi + 1, L).astype(np.uint8)


def _reads_of(rng, genome: np.ndarray, lengths) -> list:
    return [(_sample(rng, genome, L), _phred(rng, L)) for L in lengths]


def _base(seed: int):
    rng = np.random.default_rng(seed)
    genome = _genome(rng)
    repeats = [_repeat(rng, p, 160) for p in REPEAT_PERIODS]
    return rng, genome, repeats, _index_keys(rng, genome, repeats)


def case(name: str, seed: int = 0) -> dict:
    """The named case's reads and index keys."""
    rng, genome, repeats, keys = _base(seed)
    reads = []
    if name in ("phred60", "phred93"):
        hi = 60 if name == "phred60" else 93
        for i in range(64):
            q = _phred(rng, 150, hi)
            if name == "phred93" and i % 4 == 0:
                a = int(rng.integers(0, 120))
                q[a : a + 30] = 0 if i % 8 == 0 else 93
            reads.append((_sample(rng, genome, 150), q))
    elif name == "short_and_n":
        for L in (0, 1, 28, 29, 30, 38, 39, 40, 150):
            reads.append((_sample(rng, genome, L), _phred(rng, L)))
        for L in (39, 150, 151):
            c = _sample(rng, genome, L)
            c[rng.random(L) < 0.03] = 4
            reads.append((c, _phred(rng, L)))
        c = _sample(rng, genome, 150)
        c[60:70] = 4                       # a run of N across kmers
        reads.append((c, _phred(rng, 150)))
        c = _sample(rng, genome, 150)
        c[29] = 4                          # N just past the first kmer
        reads.append((c, _phred(rng, 150)))
        reads.append((np.full(150, 4, np.uint8), _phred(rng, 150)))
    elif name == "absent":
        for _ in range(16):
            reads.append((rng.integers(0, 4, 150).astype(np.uint8),
                          _phred(rng, 150)))
        for _ in range(16):
            c = np.concatenate([_sample(rng, genome, 75),
                                rng.integers(0, 4, 75).astype(np.uint8)])
            reads.append((c, _phred(rng, 150)))
    elif name == "ties":
        for r in repeats:
            reads.append((r[:150].copy(), _phred(rng, 150)))
            c = _sample(rng, genome, 150)
            c[40:100] = r[:60]
            reads.append((c, _phred(rng, 150)))
            for L in (60, 45, 35):         # a window or two of kmers:
                reads.append((r[:L].copy(), _phred(rng, L)))  # equal aggs
    elif name == "lengths":
        for L in (100, 150, 151, 250) * 8:
            reads.append((_sample(rng, genome, L), _phred(rng, L, 60)))
    elif name == "mixed_quality":
        for i in range(24):
            c = _sample(rng, genome, 150)
            kind = i % 6
            q = (None if kind == 0 else np.zeros(0, np.uint8) if kind == 1
                 else _phred(rng, 170) if kind == 2
                 else _phred(rng, 1) if kind == 3 and i < 6
                 else _phred(rng, 150))
            reads.append((c, q))
    elif name == "long":
        for L in LONG_LENGTHS:
            reads += _reads_of(rng, genome, (150, L))
        c = _sample(rng, genome, 6000)
        c[3000:3040] = 4                   # a run of N across kmers
        reads.append((c, _phred(rng, 6000)))
        reads.append((rng.integers(0, 4, 5000).astype(np.uint8),
                      _phred(rng, 5000)))
        reads.append((_sample(rng, genome, 10_000), None))
    else:
        raise ValueError(f"unknown cap case {name!r}")
    return dict(reads=reads, keys=keys, k=K, w=W)


def random_case(seed: int = 0, n: int = 2000) -> dict:
    """n seeded reads over the cases' index (module docstring)."""
    rng, genome, _, keys = _base(seed)
    lens = rng.choice(np.array([100, 150, 151, 250]), n)
    short = rng.random(n) < 0.02
    lens[short] = rng.integers(10, 61, int(short.sum()))
    reads = []
    for i, L in enumerate(lens):
        L = int(L)
        c = (rng.integers(0, 4, L).astype(np.uint8) if i % 3 == 0
             else _sample(rng, genome, L))
        if i % 10 == 1:
            c[rng.random(L) < 0.02] = 4
        profile = i % 4
        q = (_phred(rng, L, 41) if profile == 0
             else _phred(rng, L, 60) if profile == 1
             else np.clip(rng.normal(30, 8, L), 2, 41).astype(np.uint8)
             if profile == 2 else _phred(rng, L, 93))
        reads.append((c, q))
    return dict(reads=reads, keys=keys, k=K, w=W)


def of_lengths(lengths, seed: int = 0) -> dict:
    """Reads of the given lengths from the genome, each with a quality as
    long as the read, over the cases' index."""
    rng, genome, _, keys = _base(seed)
    return dict(reads=_reads_of(rng, genome, lengths), keys=keys, k=K, w=W)


def ragged(c: dict) -> dict:
    """The case as mapq_cap's numpy inputs: codes2d (R, L) uint8 padded
    with 5, rlen (R,) int32, quals the reads' qualities as FASTQ bytes
    (phred + 33) one after another (none for a read without one), qoff
    (R + 1,) int64 their offsets, keys (K,) int64 (the uint64 bits)."""
    reads = c["reads"]
    R = len(reads)
    rlen = np.array([len(s) for s, _ in reads], np.int32)
    qlen = np.array([0 if q is None else len(q) for _, q in reads], np.int64)
    codes2d = np.full((R, max(int(rlen.max(initial=0)), 1)), 5, np.uint8)
    for i, (s, _) in enumerate(reads):
        codes2d[i, : len(s)] = s
    qoff = np.zeros(R + 1, np.int64)
    np.cumsum(qlen, out=qoff[1:])
    quals = np.concatenate([np.zeros(0, np.uint8)] + [
        np.asarray(q, np.uint8) + 33 for _, q in reads if q is not None])
    return dict(codes2d=codes2d, rlen=rlen, quals=quals.astype(np.uint8),
                qoff=qoff, keys=np.asarray(c["keys"], np.uint64).view(
                    np.int64))


def padded_quals(quals: np.ndarray, qoff: np.ndarray) -> tuple:
    """FASTQ quality bytes as the kernel's first form took them: (quals2d
    (R, LQ) uint8 phred, parse_quality's byte - 33 clipped to 0-93,
    padded with 0; qlen (R,) int32)."""
    qlen = np.diff(qoff).astype(np.int32)
    R = len(qlen)
    quals2d = np.zeros((R, max(int(qlen.max(initial=0)), 1)), np.uint8)
    phred = np.clip(quals.astype(np.int16) - 33, 0, 93).astype(np.uint8)
    quals2d[np.arange(quals2d.shape[1]) < qlen[:, None]] = phred[
        : int(qoff[-1])]
    return quals2d, qlen


def count_fn(keys: np.ndarray):
    """MinimizerIndex.count over a sorted key set: 1 where present."""
    keys = np.asarray(keys, np.uint64)

    def count(q):
        q = np.atleast_1d(np.asarray(q, np.uint64))
        i = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return (keys[i] == q).astype(np.int64)
    return count


def quality_string(q) -> str:
    """A phred array as a FASTQ quality string ('' for None)."""
    return "" if q is None else (np.asarray(q, np.uint8) + 33).tobytes(
        ).decode()
