"""A batch that reaches every shard-local branch of the text-sharded steps,
and the ranks' side of the multi-process tests.

shard_case builds on the dry run's _example_batch (R = 64, RL = 64, C = 4,
B = 8, T = 8192) with dryrun_multichip's mate 2 (reverse strand, 300 bp
downstream), and adds what splitting the text into 2 or 4 shards meets:

- windows whose start lies before the text: owner 0, negative local start;
- windows starting in a shard's last RL + 2B bases, which read the next
  shard's bases from the halo, with their reads copied from there;
- windows running past the end of the text;
- three haplotype copies, so lo and hi clip to -1 and Ls on the shards
  after a copy's start, and the dense haplotype ids are not all 0;
- a fifth of the slots invalid (masked to start, lo and hi 0), a quarter
  reverse, reads shorter than RL, reference paths -1 to 1.

sharded_inputs lays the case out for the in-process text-sharded steps,
on any device. case_rank is the body of one rank in tests/test_torch_mesh_dist.py: it
runs the sharded steps on shard_case for one mesh shape and saves its
outputs for the test to gather.
"""
from __future__ import annotations

import numpy as np

from .dryrun import _example_batch

COMP = np.array([3, 2, 1, 0, 4, 5], np.uint8)
R, RL, C, B, T = 64, 64, 4, 8, 8192
COPIES = (0, 2900, 5300, T)            # haplotype copies' starts, and T
MU, SD = 420.0, 60.0


def _copy_bounds(start):
    """lo, hi of the haplotype copy holding each window's diagonal."""
    cuts = np.asarray(COPIES)
    h = np.clip(np.searchsorted(cuts, start + B, side="right") - 1, 0,
                len(cuts) - 2)
    return cuts[h].astype(np.int32), cuts[h + 1].astype(np.int32)


def shard_case(seed: int = 0):
    """(text, mate1, mate2, rescue) with mate = (reads, reads_rc, rlen,
    (start, lo, hi, rev, valid, refpath, refoff)) and rescue = (reads,
    rlen, start, lo, hi, valid) of pre-oriented rescue windows."""
    text, reads, _, rlen, starts, _, _, _, _ = _example_batch(
        R=R, RL=RL, C=C, B=B, T=T, seed=seed)
    rng = np.random.default_rng(seed + 1)
    reads, starts, rlen = reads.copy(), starts.copy(), rlen.copy()
    place = []                         # window starts of rows 0, 1, ...
    for edge in (2048, 4096, 6144):             # shard starts, D = 2 and 4
        place += [edge - RL // 2, edge - RL - 2 * B + 1]
    place += [-B, -B - 5, T - RL - B]           # the text's two ends
    for i, s in enumerate(place):
        starts[i, 0] = s
        a = max(s + B, 0)
        reads[i] = text[a : a + RL]
    neg = rng.choice(np.arange(len(place), R), 8, replace=False)
    starts[neg, 2] = -rng.integers(1, RL, 8)
    short = np.arange(1, R, 5)
    rlen[short] = RL - 7
    reads[short, RL - 7 :] = 5
    reads_rc = np.full_like(reads, 5)
    for i in range(R):
        reads_rc[i, : rlen[i]] = COMP[reads[i, : rlen[i]]][::-1]
    lo, hi = _copy_bounds(starts)
    rev = rng.random((R, C)) < 0.25
    rev[:, 0] = False
    valid = rng.random((R, C)) > 0.2
    valid[:, 0] = True
    rp = rng.integers(-1, 2, (R, C)).astype(np.int32)
    mate1 = (reads, reads_rc, rlen,
             (starts, lo, hi, rev, valid, rp, starts.astype(np.int32)))
    starts2 = (starts + 300).astype(np.int32)
    lo2, hi2 = _copy_bounds(starts2)
    mate2 = (reads_rc, reads, rlen,
             (starts2, lo2, hi2, ~rev, valid, rp, starts2.copy()))
    # rescue: the forward reads as the rescue path hands them over
    # (oriented), at their own windows on the edge rows and at windows
    # near the mates on a third of the rows
    r_start = np.concatenate([starts[:, :2] + 280, starts[:, 2:] - 280], 1)
    r_start[: len(place), 0] = starts[: len(place), 0]
    r_lo, r_hi = _copy_bounds(r_start)
    r_valid = np.zeros((R, C), bool)
    r_valid[::3] = True
    r_valid[: len(place), 0] = True
    rescue = (reads, rlen, r_start.astype(np.int32), r_lo, r_hi, r_valid)
    return text, mate1, mate2, rescue


def sharded_inputs(D: int, device):
    """(own_len, halo, step arguments, rescue arguments) of shard_case for
    make_sharded_text_paired_step and make_sharded_rescue_scorer holding
    all D text shards, as tensors on device."""
    import torch

    from .mesh import basediff_table, localize_candidates, split_text_shards

    halo = RL + 2 * B + 16
    text, mate1, mate2, (reads, rlen, r_start, r_lo, r_hi,
                         r_valid) = shard_case()
    own, shards = split_text_shards(text, D, halo)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    mates = []
    for m in (mate1, mate2):
        loc = localize_candidates(m[3], own, D, halo)
        mates += [put(m[0]), put(m[1]), put(m[2]),
                  tuple(put(a) for a in loc)]
    rloc = localize_candidates(
        (r_start, r_lo, r_hi, np.zeros_like(r_valid), r_valid,
         np.full(r_valid.shape, -1), np.zeros(r_valid.shape, np.int64)),
        own, D, halo)
    step = (put(shards), put(basediff_table(own, D)), *mates, MU, SD)
    rescue = (put(shards), put(reads), put(rlen),
              *(put(a) for a in rloc[:4]), put(rloc[6]))
    return own, halo, step, rescue


def case_rank(rank, world, device, shape, out_dir):
    """One rank of the gloo tests: shape (n,) runs the data-parallel map
    and paired steps, and checks that R - 1 rows raise; shape (dd, dt)
    the text-sharded paired step and rescue. Saves rank<r>.npz."""
    import os

    import torch

    from .mesh import (make_mesh, sharded_map_step, sharded_paired_step,
                       sharded_rescue_scores, sharded_text_paired_step)

    text, mate1, mate2, rescue = shard_case()
    out = {}
    if len(shape) == 1:
        mesh = make_mesh(world, "data", shape, device=device)
        reads, reads_rc, rlen, cand = mate1
        map_args = (text, reads, reads_rc, rlen, *cand[:5])
        scores, cov = sharded_map_step(mesh, *map_args, band_radius=B)
        out.update(map_scores=scores, map_cov=cov)
        step = sharded_paired_step(mesh, text, mate1, mate2, MU, SD,
                                   band_radius=B)
        try:
            sharded_map_step(mesh, text, *(a[:-1] for a in map_args[1:]),
                             band_radius=B)
            out["uneven_raises"] = torch.tensor(0)
        except ValueError:
            out["uneven_raises"] = torch.tensor(1)
    else:
        mesh = make_mesh(world, ("data", "text"), shape, device=device)
        step = sharded_text_paired_step(mesh, text, mate1, mate2, MU, SD,
                                        band_radius=B)
        out["rescue"] = sharded_rescue_scores(mesh, text, *rescue,
                                              band_radius=B)
    out.update({f"step_{i}": o for i, o in enumerate(step)})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.cpu().numpy() for k, v in out.items()})
