"""Inputs of the link engine's two passes (ops/cuda_links.link_pack and
link_runs), made with numpy from a seed. tests/test_torch_link_passes.py
holds the plain versions against vg_tpu's numpy host passes on them;
tests/test_torch_device_links.py and chip_smoke.py hold each kernel
against its plain version.

`read_batch(name)` is a batch of reads and link tasks in the form
LongReadMapper._device_batch hands to DeviceLinkAligner.align_runs_blob,
over a text built from the tasks' own slices (so that most certify).
BATCHES names them:

- "mixed": 16 reads of 300-1,300 bases with N bases (code 4) among them;
  tasks on both strands with la at 1, 7, 8, 16, 255, 256, 257 and 768,
  each at the read's first base (ra = 0) and ending on its last (ra + la
  = len), and random ones; lb = la + a few bases of indels, a few tasks
  outside the band (|lb - la| > 2B) or above the largest bucket (la >
  768), which fall back to the host;
- "all_fall_back": every task outside the band or above 768;
- "no_certified_bucket": the bucket-768 tasks against random text (none
  certifies), the bucket-256 tasks as in "mixed";
- "empty": reads and no task.

`oriented_rows(batch)` gathers the tasks' oriented slices as vg_tpu's
LongReadMapper._device_batch does (vg_tpu/map/longread.py:656-676: a
forward + reverse-complement blob, one clipped fancy gather, zero from la
on), the host pass link_pack replaces.

`step_case(name)` is (packed, n_steps, cert) as link_runs takes them from
the walk (step s in nibble s % 8 of word s // 8, a task's steps
last-first, halted steps 4). STEP_CASES names them:

- "random": 1,100 tasks at SW = 49 (bucket 256), runs of 7 steps on
  average, n_steps from 0 to 8 SW (0, 1, 2, 7, 8, 9, 8 SW - 1 and 8 SW
  among them), two in three certified;
- "equal_ops_across_tasks": each task's first forward op equals the last
  of the task before it, so that runs would merge across the boundary;
- "full_steps": n_steps = 8 SW, ops alternating (a run a step) or one run;
- "no_certified": no task certified;
- "big": 43,008 tasks at SW = 113 (bucket 768), the card's case.

`big_tasks()` is link_pack's case of the same size: 43,008 bucket-768
tasks (la 1-768, both strands) over 64 reads of 10 kb.
"""
from __future__ import annotations

import numpy as np

from ..utils.dna import revcomp_codes

BATCHES = ("mixed", "all_fall_back", "no_certified_bucket", "empty")
STEP_CASES = ("random", "equal_ops_across_tasks", "full_steps",
              "no_certified", "big")
EDGE_LA = (1, 7, 8, 16, 255, 256, 257, 768)


def _mutate(rng, s, d):
    """s with 2% substitutions and |d| bases inserted (d > 0) or deleted
    (d < 0) at one place; N bases become random bases."""
    s = s.copy()
    n = s == 4
    s[n] = rng.integers(0, 4, int(n.sum()))
    sub = rng.random(len(s)) < 0.02
    s[sub] = (s[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    q = int(rng.integers(0, len(s) + 1))
    if d > 0:
        s = np.concatenate([s[:q], rng.integers(0, 4, d).astype(np.uint8),
                            s[q:]])
    elif d < 0:
        q = min(q, len(s) + d)
        s = np.concatenate([s[:q], s[q - d :]])
    return s


def read_batch(name: str, seed: int = 0, B: int = 16) -> dict:
    """Reads (codes), their blob and offsets, the task table (task_read,
    task_rev, ra, la, ta, lb, int64) and the text, as a dict."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(300, 1300, 16)
    lens[:3] = (768, 1000, 257)
    reads = []
    for L in lens:
        c = rng.integers(0, 4, int(L)).astype(np.uint8)
        c[rng.random(int(L)) < 0.01] = 4
        reads.append(c)
    tasks = []                                # (read, rev, ra, la, d)
    if name != "empty":
        for r, L in enumerate(lens):
            for rev in (0, 1):
                for la in EDGE_LA:
                    if la <= L:
                        tasks.append((r, rev, 0, la, 0))
                        tasks.append((r, rev, int(L) - la, la, 0))
                for _ in range(3):
                    la = int(rng.integers(1, min(int(L), 800) + 1))
                    ra = int(rng.integers(0, int(L) - la + 1))
                    tasks.append((r, rev, ra, la, int(rng.integers(-3, 4))))
        tasks = [(r, rev, ra, la, d if d > -la else 0)
                 for r, rev, ra, la, d in tasks]
        if name == "mixed":                   # a few fall back
            for k in range(0, len(tasks), 17):
                r, rev, ra, la, _ = tasks[k]
                tasks[k] = (r, rev, ra, la, 2 * B + 1 + k % 5)
            tasks.append((1, 1, 50, 900, 0))
        elif name == "all_fall_back":
            tasks = [(r, rev, ra, la, 2 * B + 1 + k % 7) if la <= 768
                     else (r, rev, ra, la, d)
                     for k, (r, rev, ra, la, d) in enumerate(tasks)]
            tasks.append((1, 0, 10, 900, 0))
    text, ta, lb = [], [], []
    pos = 0
    for r, rev, ra, la, d in tasks:
        fwd = reads[r]
        s = (revcomp_codes(fwd) if rev else fwd)[ra : ra + la]
        seg = _mutate(rng, s, d)
        if name == "no_certified_bucket" and la > 256:
            seg = rng.integers(0, 4, len(seg)).astype(np.uint8)
        spacer = rng.integers(0, 4, 20).astype(np.uint8)
        text += [spacer, seg]
        ta.append(pos + 20)
        lb.append(len(seg))
        pos += 20 + len(seg)
    text.append(rng.integers(0, 4, 20).astype(np.uint8))
    cols = np.array([t[:4] for t in tasks], np.int64).reshape(-1, 4)
    read_off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(c) for c in reads], out=read_off[1:])
    return dict(reads=reads, blob=np.concatenate(reads), read_off=read_off,
                task_read=cols[:, 0], task_rev=cols[:, 1].astype(bool),
                ra=cols[:, 2], la=cols[:, 3], ta=np.array(ta, np.int64),
                lb=np.array(lb, np.int64), text=np.concatenate(text))


def oriented_rows(blob, read_off, task_read, task_rev, ra, la, cap=768):
    """(n, LAMAX) uint8 oriented slices as vg_tpu's _device_batch gathers
    them: LAMAX = min(cap, max(la)), zero from la on."""
    rc = np.concatenate([revcomp_codes(blob[a:b])
                         for a, b in zip(read_off[:-1], read_off[1:])])
    base = read_off[task_read] + ra + np.where(task_rev, len(blob), 0)
    LAMAX = int(min(cap, max(int(la.max()) if len(la) else 1, 1)))
    both = np.concatenate([blob, rc])
    idx = base[:, None] + np.arange(LAMAX, dtype=np.int64)[None]
    a_rows = both[np.clip(idx, 0, len(both) - 1)]
    a_rows[np.arange(LAMAX)[None] >= la[:, None]] = 0
    return a_rows


def step_case(name: str, seed: int = 0):
    """(packed (N, SW) int32 holding uint32 words, n_steps (N,) int32,
    cert (N,) bool) for link_runs. The ops are drawn in their stored
    order: a new run starts at a step with probability 1/7, its op
    differing from the run's before it."""
    rng = np.random.default_rng(seed)
    N, SW = (43_008, 113) if name == "big" else (1_100, 49)
    S = 8 * SW
    if name == "full_steps":
        n_steps = np.full(N, S)
    else:
        n_steps = rng.integers(0, S + 1, N)
        n_steps[:8] = (0, 1, 2, 7, 8, 9, S - 1, S)
    change = rng.integers(0, 7, (N, S), dtype=np.uint8) == 0
    step = rng.integers(1, 4, (N, S), dtype=np.uint8) * change
    # uint8 sums wrap at 256, a multiple of 4
    ops = (rng.integers(0, 4, (N, 1), dtype=np.uint8)
           + np.cumsum(step, axis=1, dtype=np.uint8)) % 4
    if name == "full_steps":
        ops[::2] = np.arange(S) % 2
        ops[1::2] = 3
    if name == "equal_ops_across_tasks":
        # the first forward op (stored last) of each task is the last
        # forward op (stored first) of the task before it
        for t in range(1, N):
            if n_steps[t - 1] and n_steps[t]:
                ops[t, n_steps[t] - 1] = ops[t - 1, 0]
    ops = np.where(np.arange(S)[None, :] < n_steps[:, None], ops, 4)
    words = np.zeros((N, SW), np.uint32)
    for j in range(8):
        words |= ops[:, j::8].astype(np.uint32) << np.uint32(4 * j)
    if name == "no_certified":
        cert = np.zeros(N, bool)
    elif name in ("full_steps", "equal_ops_across_tasks"):
        cert = np.ones(N, bool)
    else:
        cert = rng.random(N) < 2 / 3
    return words.view(np.int32), n_steps.astype(np.int32), cert


def big_tasks(seed: int = 0, n: int = 43_008):
    """(blob uint8, read_off int64, tasks (n, 4) int32 rows of read,
    reverse, ra, la) for link_pack at RMAX 768."""
    rng = np.random.default_rng(seed)
    R, L = 64, 10_000
    blob = rng.integers(0, 4, R * L).astype(np.uint8)
    blob[rng.random(R * L) < 0.01] = 4
    la = rng.integers(1, 769, n)
    la[:4] = (1, 7, 8, 768)
    ra = (rng.random(n) * (L - la + 1)).astype(np.int64)
    rev = rng.integers(0, 2, n)
    # tasks 4-7: at a read's first base and ending on its last, each strand
    ra[4:8] = (0, L - la[5], 0, L - la[7])
    rev[4:8] = (0, 0, 1, 1)
    tasks = np.stack([rng.integers(0, R, n), rev, ra, la],
                     axis=1).astype(np.int32)
    return blob, np.arange(R + 1, dtype=np.int64) * L, tasks
