"""Mapping steps on one device and on a device mesh: DP, pair selection,
MAPQ, winner payloads, and their sharded forms.

The torch port of vg_tpu/parallel/mesh.py. The reference parallelizes with
OpenMP threads over read batches (vg::io::for_each_parallel, reference
src/subcommand/giraffe_main.cpp:2369); here one step scores every (read,
candidate) on the card and selects winners there, so only the winners'
payload returns to the host.

Single device: make_single_step, make_paired_step and their helpers. On a
mesh (one process per device, torch.distributed): make_mesh, the
data-parallel sharded_map_step and sharded_paired_step, and the
text-sharded steps (split_text_shards, localize_candidates,
make_sharded_rescue_scorer, sharded_rescue_scores,
make_sharded_text_paired_step, sharded_text_paired_step), where the
haplotype text splits over a 'text' axis with int32 coordinates local to
each shard. Every score goes through the byte-text DP, the kernel's
banded_scores_bytes entry on the card.

Floating point follows the JAX reference operation by operation in
float32 (constants such as sqrt(2*pi), log(10) are rounded to float32
before use, as JAX does with x64 off), so MAPQs truncate identically.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import align as align_ops
from ..ops import cuda_align

F32 = torch.float32
NEGF = -1e30               # float32(-1e30) in the reference


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=F32, device=device)


def _mapq_scale(device) -> torch.Tensor:
    """-10 / log(10), evaluated in float32 like jnp.log(10.0)."""
    return -10.0 / torch.log(_f32(10.0, device))


def _one_minus(delta: torch.Tensor) -> torch.Tensor:
    """log(1 - exp(delta)) for delta < -1e-12, else -50 (reference)."""
    return torch.where(delta < -1e-12,
                       torch.log1p(-torch.exp(torch.clamp_max(delta, -1e-12))),
                       _f32(-50.0, delta.device))


def _take(a: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return torch.gather(a, 1, j.to(torch.int64)[:, None])[:, 0]


def _to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def winner_mismatch_bits(text, text_len, text_packed, B,
                         reads, reads_rc, rlen, start, lo_a, hi_a, rev_a,
                         j):
    """Mismatch bitmap of the chosen winner's gapless alignment at its
    seed diagonal, computed where the text already lives (device memory)
    so the host emit path never re-gathers R x RL text windows. Bit k of
    word w = mismatch at read column w*32+k. text is the byte text, or
    the 4-bit packed words (ops/cuda_align.pack_text) when text_packed."""
    R, RL = reads.shape
    W = (RL + 31) // 32
    dev = reads.device
    T = text_len if text_len is not None else text.shape[0]
    diag = _take(start, j).to(torch.int64) + B
    lo_w = _take(lo_a, j)
    hi_w = _take(hi_a, j)
    rev_w = _take(rev_a, j).to(torch.bool)
    pos = diag[:, None] + torch.arange(RL, device=dev)
    okm = ((pos >= lo_w[:, None]) & (pos < hi_w[:, None])
           & (pos >= 0) & (pos < T))
    nt = text.shape[0]
    if text_packed:
        # base at p is nibble p % 8 of int32 word p // 8
        words = text[(pos >> 3).clamp(0, nt - 1)].to(torch.int64)
        base = ((words & 0xFFFFFFFF) >> ((pos & 7) * 4)) & 15
    else:
        base = text[pos.clamp(0, nt - 1)]
    tw = torch.where(okm, base, align_ops.SENTINEL).to(torch.uint8)
    oriented = torch.where(rev_w[:, None], reads_rc, reads)
    inread = (torch.arange(RL, device=dev)[None, :]
              < rlen[:R, None].to(torch.int64))
    msk = ((tw != oriented) | (oriented >= 4)) & inread
    mm = msk.sum(dim=1).to(torch.int32)
    padded = torch.zeros((R, W * 32), dtype=torch.int64, device=dev)
    padded[:, :RL] = msk.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = (padded.reshape(R, W, 32) << shifts).sum(dim=2)
    return mm, _to_i32_bits(words)


def derive_candidate_meta(diag, hb, stp, steps, node_len, nrp, nro):
    """Per-candidate (lo, hi, refpath, refoff) derived ON DEVICE from the
    seed diagonal text position and resident index arrays — so the host
    uploads only (start, rev|valid) per candidate. Mirrors the host
    formula (GiraffeMapper._diag_refproj)."""
    diag = diag.contiguous()
    hap = (torch.searchsorted(hb, diag, right=True) - 1).clamp(
        0, hb.shape[0] - 2)
    lo = hb[hap]
    hi = hb[hap + 1]
    si = (torch.searchsorted(stp, diag, right=True) - 1).clamp(
        0, steps.shape[0] - 1)
    h = steps[si]
    nidx = (h >> 1).to(torch.int64)
    off_visit = diag - stp[si]
    fwd_off = torch.where((h & 1).to(torch.bool),
                          node_len[nidx] - off_visit, off_visit)
    return lo, hi, nrp[nidx], nro[nidx] + fwd_off


# ------------------------------------------------------- full paired step

def _top2_T(smT):
    """Candidate-major top-2: (max, second-max) along axis 0 of (C, R)."""
    t0 = smT.max(dim=0).values
    am = torch.argmax(smT, dim=0)
    idx = torch.arange(smT.shape[0], device=smT.device)
    masked = torch.where(idx[:, None] == am[None, :],
                         _f32(NEGF, smT.device), smT)
    return t0, masked.max(dim=0).values


def _distinct_mask_T(scoresT, revT, rpT, roT, validT, tol):
    """Distinct-placement mask, candidate-major: inputs (C, R), dup mask
    over (C_i, C_j, R). axis0 = the candidate being tested (i), axis1 =
    the competitor (j)."""
    C = scoresT.shape[0]
    same = ((revT[:, None, :] == revT[None, :, :])
            & (rpT[:, None, :] >= 0)
            & (rpT[:, None, :] == rpT[None, :, :])
            & ((roT[:, None, :] - roT[None, :, :]).abs() <= tol))
    idx = torch.arange(C, device=scoresT.device)
    better = (scoresT[None, :, :] > scoresT[:, None, :]) | (
        (scoresT[None, :, :] == scoresT[:, None, :])
        & (idx[None, :, None] < idx[:, None, None]))
    dup = (same & better & validT[None, :, :]).any(dim=1)
    return ~dup


def _pair_core_T(f1T, f2T, vd1T, vd2T, fragT, properT, rl1, rl2, mu, sd,
                 lam, unpaired_penalty, max_mapq, max_fragment_length):
    """Pair selection + MAPQ + fragment statistics, candidate-major
    (C, C, R) / (C, R) float32. Tie-breaking: flat combo index i*C+j,
    argmax takes the first max."""
    dev = f1T.device
    negf = _f32(NEGF, dev)
    C = f1T.shape[0]
    ll = (-((fragT - mu) ** 2) / (2 * sd * sd)
          - torch.log(sd * torch.sqrt(_f32(2 * math.pi, dev))))
    pair_scaled = torch.where(
        properT, lam * (f1T[:, None, :] + f2T[None, :, :]) + ll, negf)
    flat = pair_scaled.reshape(C * C, -1)
    best_pair, best_combo = flat.max(dim=0).values, torch.argmax(flat, dim=0)
    j1p = torch.div(best_combo, C, rounding_mode="floor")
    j2p = best_combo % C

    m1 = torch.where(vd1T, f1T, negf)
    m2 = torch.where(vd2T, f2T, negf)
    b1 = torch.argmax(m1, dim=0)
    b2 = torch.argmax(m2, dim=0)
    zero = _f32(0.0, dev)
    s1b = torch.where(vd1T.any(dim=0), m1.max(dim=0).values, zero)
    s2b = torch.where(vd2T.any(dim=0), m2.max(dim=0).values, zero)
    indep = lam * (s1b + s2b) - lam * unpaired_penalty
    use_pair = (best_pair > negf / 2) & (best_pair >= indep)

    # pair MAPQ: logsumexp over proper combos
    lsep = best_pair + torch.log(torch.exp(torch.where(
        flat > negf / 2, flat - best_pair[None, :], negf)).sum(dim=0))
    deltap = best_pair - lsep
    scale = _mapq_scale(dev)
    mq_pair = torch.clamp(scale * _one_minus(deltap), 0, max_mapq)

    def end_mapq(fT, vdT, chosen):
        sc = torch.where(vdT, fT * lam, negf)
        mx = sc.max(dim=0).values
        lse = mx + torch.log(torch.exp(sc - mx[None, :]).sum(dim=0))
        oh = (torch.arange(C, device=dev)[:, None] == chosen[None, :])
        ch = torch.where(oh, fT, zero).sum(dim=0) * lam
        return torch.clamp(scale * _one_minus(ch - lse), 0, max_mapq)

    j1 = torch.where(use_pair, j1p, b1)
    j2 = torch.where(use_pair, j2p, b2)
    mq1s = end_mapq(f1T, vd1T, j1)
    mq2s = end_mapq(f2T, vd2T, j2)
    mq1 = torch.where(use_pair, torch.minimum(mq_pair, mq1s + 25), mq1s)
    mq2 = torch.where(use_pair, torch.minimum(mq_pair, mq2s + 25), mq2s)
    ohc = (torch.arange(C * C, device=dev)[:, None] == best_combo[None, :])
    frags = torch.where(ohc, fragT.reshape(C * C, -1), zero).sum(dim=0)
    frags = torch.where(use_pair, frags, zero)

    # fragment statistics over confident proper pairs
    t1a, t1b = _top2_T(m1)
    uniq1 = (s1b >= 0.8 * rl1) & ((vd1T.sum(0) <= 1) | (t1b < t1a - 5))
    t2a, t2b = _top2_T(m2)
    uniq2 = (s2b >= 0.8 * rl2) & ((vd2T.sum(0) <= 1) | (t2b < t2a - 5))
    obs = (use_pair & uniq1 & uniq2 & (frags > 0)
           & (frags <= max_fragment_length))
    stat_n = obs.sum().to(F32)
    stat_sum = torch.where(obs, frags, zero).sum()
    stat_sumsq = torch.where(obs, frags * frags, zero).sum()
    return (j1, j2, mq1, mq2, use_pair, frags,
            torch.stack([stat_n, stat_sum, stat_sumsq]))


def _select_pairs(s1, s2, m1, m2, frag_txtT, same_copyT, rl1, rl2, mu, sd,
                  lam, unpaired_penalty, max_mapq, max_fragment_length):
    """The paired steps' selection after scoring: distinct-placement masks,
    the fragment length of every (C, C) combo and which combos are proper,
    then _pair_core_T. m = (rev, valid, refpath, refoff) of a mate;
    frag_txtT / same_copyT are the text-space fragment lengths and the
    same-copy test, which each step derives from its own coordinates.
    Returns (vd1T, vd2T, _pair_core_T's outputs)."""
    from ..map.giraffe import PLACEMENT_TOL

    (s1_rev, s1_valid, s1_rp, s1_ro) = m1
    (s2_rev, s2_valid, s2_rp, s2_ro) = m2
    dev = s1.device
    mu = torch.as_tensor(mu, dtype=F32, device=dev)
    sd = torch.as_tensor(sd, dtype=F32, device=dev)
    f1T = s1.T.to(F32)
    f2T = s2.T.to(F32)
    v1T = (s1_valid & (s1 > 0)).T
    v2T = (s2_valid & (s2 > 0)).T
    vd1T = v1T & _distinct_mask_T(s1.T, s1_rev.T, s1_rp.T, s1_ro.T, v1T,
                                  PLACEMENT_TOL)
    vd2T = v2T & _distinct_mask_T(s2.T, s2_rev.T, s2_rp.T, s2_ro.T, v2T,
                                  PLACEMENT_TOL)

    L1r = rl1.to(F32)[None, None, :]
    L2r = rl2.to(F32)[None, None, :]
    rev1T = s1_rev.T
    rev2T = s2_rev.T
    rp1T = s1_rp.T
    rp2T = s2_rp.T
    on_refT = (rp1T[:, None, :] >= 0) & (rp1T[:, None, :]
                                         == rp2T[None, :, :])
    ro1T = s1_ro.to(F32).T
    ro2T = s2_ro.to(F32).T
    rffT = (ro2T[None, :, :] + L2r) - ro1T[:, None, :]
    rfrT = (ro1T[:, None, :] + L1r) - ro2T[None, :, :]
    frag_refT = torch.where(rev1T[:, None, :], rfrT, rffT)
    fragT = torch.where(same_copyT, frag_txtT,
                        torch.where(on_refT, frag_refT, _f32(-1.0, dev)))
    properT = ((rev1T[:, None, :] != rev2T[None, :, :])
               & (same_copyT | on_refT)
               & (fragT > 0) & (fragT <= max_fragment_length)
               & vd1T[:, None, :] & vd2T[None, :, :])
    return vd1T, vd2T, _pair_core_T(
        f1T, f2T, vd1T, vd2T, fragT, properT, rl1, rl2, mu, sd, lam,
        unpaired_penalty, max_mapq, max_fragment_length)


def _coverage(n_buckets, bucket_ends, dev) -> torch.Tensor:
    """Pack-style coverage histogram: (bucket, hit) per mate, int32."""
    cov = torch.zeros(n_buckets, dtype=torch.int32, device=dev)
    for bucket, hit in bucket_ends:
        cov.index_add_(0, bucket.clamp(0, n_buckets - 1).to(torch.int64),
                       hit.to(torch.int32))
    return cov


def _default_score_fn(band_radius, match, mismatch, gap_open, gap_extend,
                      bonus):
    """The byte-text DP (vg_tpu's default score function): the kernel's
    byte-text entry on the card, its plain version ops/align.banded_scores
    for CPU tensors."""
    def score_fn(text, reads, reads_rc, rlen, cand):
        return cuda_align.banded_scores_bytes(
            text, reads, reads_rc, rlen, *cand[:5],
            band_radius=band_radius, match=match, mismatch=mismatch,
            gap_open=gap_open, gap_extend=gap_extend, bonus=bonus)
    return score_fn


def make_single_step(band_radius: int = 16, match: int = 1,
                     mismatch: int = 4, gap_open: int = 6,
                     gap_extend: int = 1, bonus: int = 5,
                     max_mapq: int = 60, score_fn=None,
                     text_packed: bool = False,
                     text_len: Optional[int] = None):
    """Single-end device step: DP scores + distinct-placement dedup +
    winner + MAPQ + winner mismatch bitmaps, one call (the torch port of
    GiraffeMapper.emit_batch_encoded's host selection)."""
    from ..map.giraffe import PLACEMENT_TOL
    from ..map.mapq import log_base

    lam = log_base(match, mismatch)
    B = band_radius
    if score_fn is None:
        score_fn = _default_score_fn(band_radius, match, mismatch, gap_open,
                                     gap_extend, bonus)

    def step(text, reads, reads_rc, rlen, cand, tol_div):
        (c_start, c_lo, c_hi, c_rev, c_valid, c_rp, c_ro) = cand
        s = score_fn(text, reads, reads_rc, rlen, cand)
        dev = s.device
        negf = _f32(NEGF, dev)
        fT = s.T.to(F32)
        validT = (c_valid & (s > 0)).T
        any_valid = validT.any(dim=0)
        maskedT = torch.where(validT, fT, _f32(-1.0, dev))
        best_j = torch.argmax(maskedT, dim=0)
        best_s = maskedT.max(dim=0).values
        uniqT = _distinct_mask_T(s.T, c_rev.T, c_rp.T, c_ro.T, validT,
                                 PLACEMENT_TOL)
        sc = torch.where(validT & uniqT, fT * lam, negf)
        mx = torch.maximum(sc.max(dim=0).values, best_s * lam)
        lse = mx + torch.log(torch.exp(sc - mx[None, :]).sum(dim=0))
        delta = best_s * lam - lse
        mapq = torch.clamp(_mapq_scale(dev) * _one_minus(delta), 0,
                           max_mapq)
        mapq = torch.where(torch.isfinite(mapq), mapq,
                           _f32(max_mapq, dev))
        mm, bits = winner_mismatch_bits(
            text, text_len, text_packed, B, reads, reads_rc, rlen,
            c_start, c_lo, c_hi, c_rev, best_j)
        return (s, best_j.to(torch.int32), mapq.to(torch.int32),
                any_valid, mm, bits)

    return step


def make_paired_step(band_radius: int = 16, match: int = 1,
                     mismatch: int = 4, gap_open: int = 6,
                     gap_extend: int = 1, bonus: int = 5,
                     max_fragment_length: int = 2000,
                     unpaired_penalty: float = 30.0,
                     max_mapq: int = 60, n_buckets: int = 1024,
                     score_fn=None, text_packed: bool = False,
                     text_len: Optional[int] = None):
    """The full paired mapping step: seed-result candidate tables in ->
    per-mate DP scores, pair selection with the fragment model, pair/solo
    MAPQs, pack-style coverage histogram, and the fragment-length
    statistics out. Everything except host seeding and GAM emission runs
    on the device of its inputs."""
    from ..map.mapq import log_base

    lam = log_base(match, mismatch)
    if score_fn is None:
        score_fn = _default_score_fn(band_radius, match, mismatch, gap_open,
                                     gap_extend, bonus)

    def step(text, r1, r1rc, rl1, c1, r2, r2rc, rl2, c2, mu, sd):
        (s1_start, s1_lo, s1_hi, s1_rev, s1_valid, s1_rp, s1_ro) = c1
        (s2_start, s2_lo, s2_hi, s2_rev, s2_valid, s2_rp, s2_ro) = c2
        s1 = score_fn(text, r1, r1rc, rl1, c1)
        s2 = score_fn(text, r2, r2rc, rl2, c2)
        B = band_radius
        L1r = rl1.to(F32)[None, None, :]
        L2r = rl2.to(F32)[None, None, :]
        d1T = (s1_start + B).to(F32).T
        d2T = (s2_start + B).to(F32).T
        ffT = (d2T[None, :, :] + L2r) - d1T[:, None, :]
        frT = (d1T[:, None, :] + L1r) - d2T[None, :, :]
        frag_txtT = torch.where(s1_rev.T[:, None, :], frT, ffT)
        same_copyT = s1_lo.T[:, None, :] == s2_lo.T[None, :, :]
        vd1T, vd2T, (j1, j2, mq1, mq2, use_pair, frags, stats) = \
            _select_pairs(s1, s2, c1[3:], c2[3:], frag_txtT, same_copyT,
                          rl1, rl2, mu, sd, lam, unpaired_penalty, max_mapq,
                          max_fragment_length)

        mm1, bits1 = winner_mismatch_bits(
            text, text_len, text_packed, B, r1, r1rc, rl1,
            s1_start, s1_lo, s1_hi, s1_rev, j1)
        mm2, bits2 = winner_mismatch_bits(
            text, text_len, text_packed, B, r2, r2rc, rl2,
            s2_start, s2_lo, s2_hi, s2_rev, j2)

        # pack-style coverage histogram over winner placements
        bsz = max((text_len if text_len is not None
                   else text.shape[0]) // n_buckets, 1)
        cov = _coverage(n_buckets, [
            (torch.div(_take(st, j), bsz, rounding_mode="floor"),
             vd.any(dim=0))
            for st, j, vd in ((s1_start, j1, vd1T), (s2_start, j2, vd2T))],
            s1.device)
        return (s1, s2, j1, j2,
                mq1.clamp(0, max_mapq).to(torch.int32),
                mq2.clamp(0, max_mapq).to(torch.int32),
                use_pair, frags, mm1, mm2, bits1, bits2, stats, cov)

    return step


# ----------------------------------------------------------- device mesh
# One process per device (SPMD). A mesh is a torch DeviceMesh whose
# dimension names are vg_tpu's axis names, ("data",) or ("data", "text"),
# ranks laid out row-major over them. The sharded functions take the same
# global inputs on every rank, as vg_tpu's take global arrays, and return
# the rank's rows of each data-sharded output and the replicated outputs
# whole; an all_reduce(SUM) on a mesh dimension's group stands where
# vg_tpu's shardings make XLA insert a psum.

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n_devices: Optional[int] = None, axis="data",
              shape: Optional[tuple] = None, *, device: str = "cuda"):
    """The device mesh over every rank of the default process group: a
    1-D mesh named `axis`, or, with `axis` a tuple of names, a mesh of
    `shape`. device "cuda" runs NCCL on the card of the local rank
    (LOCAL_RANK, else the rank modulo the cards); "cpu" runs gloo. It takes
    the initialized default process group, or initializes one from the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), and raises
    where the group's backend does not serve `device` or there is no CUDA:
    it never switches backend or device on its own. n_devices, if given,
    must be the world size."""
    import os

    from torch.distributed.device_mesh import init_device_mesh

    if device not in BACKENDS:
        raise ValueError(f"make_mesh: device {device!r}, expected one of "
                         f"{sorted(BACKENDS)}")
    backend = BACKENDS[device]
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: CUDA is not available; pass "
                           "device='cpu' for a gloo mesh on the CPU")
    if dist.is_initialized():
        have = dist.get_backend()
        if backend not in str(have):
            raise ValueError(f"make_mesh: the default process group runs "
                             f"{have}; a {device} mesh needs {backend}")
    if device == "cuda":
        local = os.environ.get("LOCAL_RANK")
        rank = dist.get_rank() if dist.is_initialized() else int(
            os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend)
    world = dist.get_world_size()
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if shape is None:
        if len(names) != 1:
            raise ValueError(f"make_mesh: axes {names} need a shape")
        shape = (world,)
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(names) or math.prod(shape) != world:
        raise ValueError(f"make_mesh: shape {shape} over axes {names} does "
                         f"not cover the {world} ranks")
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the "
                         f"process group has {world} ranks")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_size(mesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def shard_rows(R: int, mesh, axis: Optional[str] = None) -> slice:
    """The rows of an R-row batch this rank owns on the mesh's data axis
    (its first, as vg_tpu's P(axis) shards over mesh.axis_names[0]), or
    on `axis`. R must divide evenly, as jax.device_put requires."""
    axis = axis or mesh.mesh_dim_names[0]
    n = _axis_size(mesh, axis)
    if R % n:
        raise ValueError(f"{R} rows do not split over the {n} ranks of "
                         f"mesh axis {axis!r}")
    per = R // n
    i = mesh.get_local_rank(axis)
    return slice(i * per, (i + 1) * per)


def _put(a, dev, rows: slice = slice(None)) -> torch.Tensor:
    """A global numpy array or tensor's rows, contiguous on dev."""
    if isinstance(a, torch.Tensor):
        return a[rows].to(dev).contiguous()
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a)[rows]),
                           device=dev)


def sharded_map_step(mesh, text, reads, reads_rc, rlen,
                     cand_start, cand_lo, cand_hi, cand_rev, cand_valid,
                     band_radius: int = 16):
    """One data-parallel mapping step over the mesh.

    Scores this rank's rows (the mesh's first axis) with the banded DP,
    the text whole on every rank, then sums the ranks' winner-bucket
    coverage histograms over that axis, the collective the pack stage uses
    to merge coverage across shards.

    Returns (scores, coverage): scores (R / n, C), this rank's rows;
    coverage (buckets,) int32, the same on every rank."""
    axis = mesh.mesh_dim_names[0]
    dev = mesh_device(mesh)
    rows = shard_rows(len(reads), mesh)
    text = _put(text, dev)
    (reads, reads_rc, rlen, cand_start, cand_lo, cand_hi, cand_rev,
     cand_valid) = (_put(a, dev, rows) for a in (
         reads, reads_rc, rlen, cand_start, cand_lo, cand_hi, cand_rev,
         cand_valid))
    n_buckets = 1024
    scores = cuda_align.banded_scores_bytes(
        text, reads, reads_rc, rlen, cand_start, cand_lo, cand_hi, cand_rev,
        cand_valid, band_radius=band_radius)
    # winner text bucket per read -> coverage histogram (pack-style)
    best = torch.argmax(scores, dim=1)
    start = _take(cand_start, best)
    bsz = max(text.shape[0] // n_buckets, 1)
    cov = _coverage(n_buckets, [(torch.div(start, bsz, rounding_mode="floor"),
                                 _take(scores, best) > 0)], dev)
    dist.all_reduce(cov, group=mesh.get_group(axis))
    return scores, cov


def _put_mate(mate, dev, rows):
    reads, reads_rc, rlen, cand = mate
    return (_put(reads, dev, rows), _put(reads_rc, dev, rows),
            _put(rlen, dev, rows), tuple(_put(a, dev, rows) for a in cand))


def sharded_paired_step(mesh, text, mate1, mate2, mu, sd,
                        band_radius: int = 16, **kw):
    """Run the full paired step data-parallel over the mesh.

    mate1/mate2 = (reads, reads_rc, rlen, cand_tuple) with cand_tuple =
    (start, lo, hi, rev, valid, refpath, refoff), all batch-major and
    global. Each rank runs make_paired_step on its rows of the mesh's
    first axis; the text and the fragment model are whole on every rank.
    The per-read outputs are the rank's rows; the fragment statistics and
    the coverage, the step's only cross-row values, are summed over the
    axis and come back the same on every rank."""
    axis = mesh.mesh_dim_names[0]
    dev = mesh_device(mesh)
    rows = shard_rows(len(mate1[0]), mesh)
    step = make_paired_step(band_radius=band_radius, **kw)
    out = list(step(_put(text, dev), *_put_mate(mate1, dev, rows),
                    *_put_mate(mate2, dev, rows), mu, sd))
    group = mesh.get_group(axis)
    for i in (12, 13):                     # stats (float32), cov (int32)
        dist.all_reduce(out[i], group=group)
    return tuple(out)


# ---------------------------------------------------- sharded haplotype text

def split_text_shards(text: np.ndarray, n_shards: int, halo: int):
    """Host: split the haplotype text into contiguous shards with a
    right-side `halo` so any DP window whose start lies in a shard's
    owned range fits in its local slice. Coordinates on each shard are
    int32 regardless of total length — the replicated design's 2.1 Gbp
    global-int32 ceiling (README) becomes per-shard, so a D-way text
    axis holds up to D x 2.1 Gbp (SURVEY.md §2.3 item 6, the reference's
    `vg chunk` index-sharding answer re-expressed as a mesh axis).

    Returns (own_len, shards (D, own+halo) uint8 sentinel-padded)."""
    T = len(text)
    D = n_shards
    own = -(-T // D)
    Ls = own + halo
    shards = np.full((D, Ls), 6, np.uint8)
    for d in range(D):
        s = d * own
        e = min(T, s + Ls)
        if s < T:
            shards[d, : e - s] = text[s:e]
    return own, shards


def localize_candidates(cand, own_len: int, n_shards: int, halo: int):
    """Host: convert global candidate meta -> per-shard-local int32.

    cand = (start, lo, hi, rev, valid, rp, ro) with start/lo/hi int64-
    capable global text coordinates. Returns (start_l, owner, lo_l,
    hi_l, hap, rev, valid, rp, ro): owner = shard owning the window
    start, start_l/lo_l/hi_l local to that shard (clamped to its halo'd
    slice), hap = dense haplotype id (factorized lo) for same-copy
    pairing checks without global coordinates."""
    start, lo, hi, rev, valid, rp, ro = (np.asarray(a) for a in cand)
    start64 = start.astype(np.int64)
    owner = np.clip(start64 // own_len, 0, n_shards - 1).astype(np.int32)
    base = owner.astype(np.int64) * own_len
    Ls = own_len + halo
    start_l = (start64 - base).astype(np.int32)
    lo_l = np.clip(lo.astype(np.int64) - base, -1, Ls).astype(np.int32)
    hi_l = np.clip(hi.astype(np.int64) - base, 0, Ls).astype(np.int32)
    _, hap = np.unique(lo.astype(np.int64), return_inverse=True)
    return (start_l, owner, lo_l, hi_l,
            hap.reshape(lo.shape).astype(np.int32),
            rev, valid, rp.astype(np.int32), ro.astype(np.int32))


def basediff_table(own_len: int, n_shards: int) -> np.ndarray:
    """Host: (D, D) int32 base offsets between shards, bases[b] - bases[a]
    saturated at +-2^30, for fragment lengths across shards."""
    bases = np.arange(n_shards, dtype=np.int64) * own_len
    return np.clip(bases[None, :] - bases[:, None],
                   -(2 ** 30), 2 ** 30).astype(np.int32)


def _mismatch_bits_all(text, B, reads, reads_rc, rlen,
                       start, lo, hi, rev, valid):
    """Gapless mismatch bitmaps for EVERY candidate against one local
    text shard (winner_mismatch_bits, widened to (R, C) so the winner
    can be chosen after the cross-shard combine)."""
    R, RL = reads.shape
    C = start.shape[1]
    W = (RL + 31) // 32
    dev = reads.device
    nt = text.shape[0]
    pos = ((start.to(torch.int64) + B)[:, :, None]
           + torch.arange(RL, device=dev))
    okm = ((pos >= lo[:, :, None]) & (pos < hi[:, :, None])
           & (pos >= 0) & (pos < nt))
    tw = torch.where(okm, text[pos.clamp(0, nt - 1)],
                     align_ops.SENTINEL).to(torch.uint8)
    oriented = torch.where(rev[:, :, None], reads_rc[:, None, :],
                           reads[:, None, :])
    inread = (torch.arange(RL, device=dev)[None, None, :]
              < rlen[:R, None, None].to(torch.int64))
    msk = ((tw != oriented) | (oriented >= 4)) & inread & valid[:, :, None]
    mm = msk.sum(dim=2).to(torch.int32)                    # (R, C)
    padded = torch.zeros((R, C, W * 32), dtype=torch.int64, device=dev)
    padded[:, :, :RL] = msk.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = (padded.reshape(R, C, W, 32) << shifts).sum(dim=3)
    return mm, _to_i32_bits(words)                         # (R,C), (R,C,W)


def _local_shards(tshards, D: int, shard_ids, group):
    """Pair each local text shard with its shard id. Without a text group
    the step holds all D shards (vg_tpu's function on one device); with
    one, this rank's and its group's shards make up the D."""
    k = tshards.shape[0]
    ids = list(range(k)) if shard_ids is None else [int(d) for d in
                                                     shard_ids]
    held = k if group is None else k * dist.get_world_size(group)
    if len(ids) != k or held != D:
        raise ValueError(f"{k} local text shards (ids {ids}) and a text "
                         f"group of {1 if group is None else held // k} "
                         f"do not make up the {D} shards")
    return list(zip(ids, tshards))


def _score_on_shards(score_fn, shards, group, reads, reads_rc, rlen,
                     start_l, owner, lo_l, hi_l, rev, valid, B=None):
    """Score every valid candidate on the shard owning its window (its
    valid mask routes it there; masked slots get start, lo and hi 0) and
    sum the owner-masked scores over the local shards and then over the
    text group: exactly one shard adds to each candidate, so the int32
    sums are exact. With B, also each candidate's gapless mismatch count
    and bitmap words, summed the same way. Returns (s, mm, bits); s is -1
    on invalid slots, mm and bits None without B."""
    zero = torch.zeros((), dtype=torch.int32, device=reads.device)
    s = torch.zeros(valid.shape, dtype=torch.int32, device=reads.device)
    mm = bits = None
    for d, t in shards:
        v = valid & (owner == d)
        sd_ = score_fn(t, reads, reads_rc, rlen,
                       (torch.where(v, start_l, zero),
                        torch.where(v, lo_l, zero),
                        torch.where(v, hi_l, zero), rev, v))
        s += torch.where(v, sd_, zero)
        if B is not None:
            mmd, bitsd = _mismatch_bits_all(t, B, reads, reads_rc, rlen,
                                            start_l, lo_l, hi_l, rev, v)
            mm = mmd if mm is None else mm + mmd
            bits = bitsd if bits is None else bits + bitsd
    if group is not None:
        for x in (s, mm, bits):
            if x is not None:
                dist.all_reduce(x, group=group)
    return torch.where(valid, s, -1), mm, bits


def make_sharded_rescue_scorer(n_text_shards: int, band_radius: int = 16,
                               match: int = 1, mismatch: int = 4,
                               gap_open: int = 6, gap_extend: int = 1,
                               bonus: int = 5):
    """Rescue-candidate scoring against a TEXT-SHARDED index.

    Rescue windows are candidate-sized (the host seed-scan inside the
    mate's fragment window already reduced them to diagonals,
    map/paired.py _rescue_begin), so each is scored once, on the shard
    owning its start — same owner-routing + masked-sum pattern as the
    main sharded step, bit-identical to the replicated scorer. Reads
    arrive pre-ORIENTED (the rescue path orients on the host), so rev is
    all False.

    step(tshards, reads, rlen, start_l, owner, lo_l, hi_l, valid, *,
    shard_ids=None, group=None): tshards (k, Ls) uint8, the text shards
    this process holds, shard_ids their ids (default 0..k-1). With no
    group k = D, vg_tpu's function as written for one device; with the
    text group, this rank's part, the masked sums all-reduced over it.
    Both forms give identical (R, C) int32 scores, -1 where invalid."""
    D = n_text_shards
    score_fn = _default_score_fn(band_radius, match, mismatch, gap_open,
                                 gap_extend, bonus)

    def step(tshards, reads, rlen, start_l, owner, lo_l, hi_l, valid, *,
             shard_ids=None, group=None):
        s, _, _ = _score_on_shards(
            score_fn, _local_shards(tshards, D, shard_ids, group), group,
            reads, reads, rlen, start_l, owner, lo_l, hi_l,
            torch.zeros_like(valid), valid)
        return s

    return step


def _text_axes(mesh):
    """(text axis, data axis or None) as vg_tpu picks them: 'text' if the
    mesh has it, else its last axis; 'data' only beside 'text'."""
    names = mesh.mesh_dim_names
    taxis = "text" if "text" in names else names[-1]
    daxis = "data" if "data" in names and "text" in names else None
    return taxis, daxis


def _rank_shard(mesh, taxis, shards):
    """This rank's text shard as a (1, Ls) tensor, its id, the text group."""
    d = mesh.get_local_rank(taxis)
    return (_put(shards[d : d + 1], mesh_device(mesh)), [d],
            mesh.get_group(taxis))


def sharded_rescue_scores(mesh, text, reads, rlen,
                          r_start, r_lo, r_hi, r_valid,
                          band_radius: int = 16, halo: Optional[int] = None,
                          **kw):
    """Score pre-oriented rescue candidates with the text sharded over
    the mesh's 'text' axis (its last axis if it has none). r_start/lo/hi
    are GLOBAL coordinates (int64-capable); the reads are whole on every
    rank; returns the (R, C) int32 scores, -1 where invalid, the same on
    every rank."""
    taxis, _ = _text_axes(mesh)
    Dt = _axis_size(mesh, taxis)
    if halo is None:
        halo = reads.shape[1] + 2 * band_radius + 16
    own, shards = split_text_shards(np.asarray(text), Dt, halo)
    valid = np.asarray(r_valid)
    (start_l, owner, lo_l, hi_l, _hap, _rev, valid, _rp, _ro) = \
        localize_candidates((r_start, r_lo, r_hi, np.zeros_like(valid),
                             valid, np.full(valid.shape, -1),
                             np.zeros(valid.shape, np.int64)),
                            own, Dt, halo)
    tsh, ids, group = _rank_shard(mesh, taxis, shards)
    dev = mesh_device(mesh)
    step = make_sharded_rescue_scorer(Dt, band_radius=band_radius, **kw)
    return step(tsh, *(_put(a, dev) for a in (reads, rlen, start_l, owner,
                                               lo_l, hi_l, valid)),
                shard_ids=ids, group=group)


def make_sharded_text_paired_step(
        n_text_shards: int, own_len: int, halo: int,
        band_radius: int = 16, match: int = 1, mismatch: int = 4,
        gap_open: int = 6, gap_extend: int = 1, bonus: int = 5,
        max_fragment_length: int = 2000, unpaired_penalty: float = 30.0,
        max_mapq: int = 60, n_buckets: int = 1024,
        text_fits_i32: bool = True):
    """Full paired step against a TEXT-SHARDED haplotype index.

    Each candidate window is scored exactly once, on the shard that owns
    its start (valid masks route it), so DP scores — and therefore
    winners, MAPQs and pair selection — are bit-identical to the
    replicated-text step. Cross-shard combines are owner-masked sums;
    fragment distances between mates on different shards use a saturated
    (D, D) base-offset table, exact within max_fragment_length even when
    global coordinates exceed int32 (the point of sharding the text).

    step(tshards, basediff, r1, r1rc, rl1, c1, r2, r2rc, rl2, c2, mu, sd,
    *, shard_ids=None, group=None), c = localize_candidates' 9-tuple: as
    make_sharded_rescue_scorer's step, all D shards with no group, or
    this rank's with the text group, over which the scores, mismatch
    counts and bitmap words are all-reduced; the pair selection then runs
    identically on every text rank."""
    from ..map.mapq import log_base

    lam = log_base(match, mismatch)
    B = band_radius
    D = n_text_shards
    score_fn = _default_score_fn(band_radius, match, mismatch, gap_open,
                                 gap_extend, bonus)

    def step(tshards, basediff, r1, r1rc, rl1, c1, r2, r2rc, rl2, c2,
             mu, sd, *, shard_ids=None, group=None):
        shards = _local_shards(tshards, D, shard_ids, group)
        (s1_sl, s1_ow, s1_lo, s1_hi, s1_hap, s1_rev, s1_valid,
         s1_rp, s1_ro) = c1
        (s2_sl, s2_ow, s2_lo, s2_hi, s2_hap, s2_rev, s2_valid,
         s2_rp, s2_ro) = c2
        s1, mm1a, bits1a = _score_on_shards(
            score_fn, shards, group, r1, r1rc, rl1, s1_sl, s1_ow, s1_lo,
            s1_hi, s1_rev, s1_valid, B)
        s2, mm2a, bits2a = _score_on_shards(
            score_fn, shards, group, r2, r2rc, rl2, s2_sl, s2_ow, s2_lo,
            s2_hi, s2_rev, s2_valid, B)

        # fragment length in text space via the saturated base-offset
        # table: d2g - d1g = basediff[ow1, ow2] + (l2 - l1), exact while
        # |true distance| << the saturation bound
        L1r = rl1.to(F32)[None, None, :]
        L2r = rl2.to(F32)[None, None, :]
        ow1T = s1_ow.T.to(torch.int64)
        ow2T = s2_ow.T.to(torch.int64)
        bdT = basediff[ow1T[:, None, :], ow2T[None, :, :]].to(F32)
        dl1T = (s1_sl + B).to(F32).T
        dl2T = (s2_sl + B).to(F32).T
        deltaT = bdT + (dl2T[None, :, :] - dl1T[:, None, :])   # d2g - d1g
        frag_txtT = torch.where(s1_rev.T[:, None, :], -deltaT + L1r,
                                deltaT + L2r)
        same_copyT = s1_hap.T[:, None, :] == s2_hap.T[None, :, :]
        vd1T, vd2T, (j1, j2, mq1, mq2, use_pair, frags, stats) = \
            _select_pairs(s1, s2, (s1_rev, s1_valid, s1_rp, s1_ro),
                          (s2_rev, s2_valid, s2_rp, s2_ro), frag_txtT,
                          same_copyT, rl1, rl2, mu, sd, lam,
                          unpaired_penalty, max_mapq, max_fragment_length)

        mm1 = _take(mm1a, j1)
        mm2 = _take(mm2a, j2)
        bits1 = bits1a[torch.arange(len(j1), device=j1.device), j1]
        bits2 = bits2a[torch.arange(len(j2), device=j2.device), j2]

        # coverage: exact global bucketing when the text fits int32,
        # shard-local bucketing (n_buckets/D per shard) beyond that
        ow1, ow2 = _take(s1_ow, j1), _take(s2_ow, j2)
        sl1, sl2 = _take(s1_sl, j1), _take(s2_sl, j2)
        if text_fits_i32:
            bsz = max(D * own_len // n_buckets, 1)
            g1 = torch.div(ow1 * own_len + sl1, bsz, rounding_mode="floor")
            g2 = torch.div(ow2 * own_len + sl2, bsz, rounding_mode="floor")
        else:
            per = max(n_buckets // D, 1)
            bsz = max(own_len // per, 1)
            g1, g2 = (ow.clamp(0, D - 1) * per + torch.div(
                sl, bsz, rounding_mode="floor").clamp(0, per - 1)
                for ow, sl in ((ow1, sl1), (ow2, sl2)))
        cov = _coverage(n_buckets, [(g1, vd1T.any(dim=0)),
                                    (g2, vd2T.any(dim=0))], s1.device)
        return (s1, s2, j1, j2,
                mq1.clamp(0, max_mapq).to(torch.int32),
                mq2.clamp(0, max_mapq).to(torch.int32),
                use_pair, frags, mm1, mm2, bits1, bits2, stats, cov)

    return step


def sharded_text_paired_step(mesh, text, mate1, mate2, mu, sd,
                             band_radius: int = 16, halo: Optional[int] = None,
                             **kw):
    """Run the full paired step with the haplotype TEXT sharded over the
    mesh's 'text' axis and reads data-parallel over its 'data' axis (if
    present). mate = (reads, reads_rc, rlen, cand) with GLOBAL candidate
    meta (start, lo, hi, rev, valid, rp, ro); start/lo/hi may be int64.
    Every rank splits the text and localizes the WHOLE batch's candidates
    (the dense haplotype ids come from all of lo) before it takes its
    rows; per-shard coordinates stay int32 so total text capacity scales
    with the text-axis size. Returns the rank's rows of the per-read
    outputs; stats and coverage summed over the data axis only (the
    winners are already the same on every text rank)."""
    taxis, daxis = _text_axes(mesh)
    Dt = _axis_size(mesh, taxis)
    r1, r1rc, rl1, c1g = mate1
    r2, r2rc, rl2, c2g = mate2
    R, RL = r1.shape
    if halo is None:
        halo = RL + 2 * band_radius + 16
    own, shards = split_text_shards(np.asarray(text), Dt, halo)
    c1 = localize_candidates(c1g, own, Dt, halo)
    c2 = localize_candidates(c2g, own, Dt, halo)
    text_fits = (Dt * own) < 2 ** 31

    dev = mesh_device(mesh)
    rows = shard_rows(R, mesh, daxis) if daxis else slice(None)
    tsh, ids, group = _rank_shard(mesh, taxis, shards)
    step = make_sharded_text_paired_step(
        Dt, own, halo, band_radius=band_radius, text_fits_i32=text_fits,
        **kw)
    out = list(step(tsh, _put(basediff_table(own, Dt), dev),
                    *_put_mate((r1, r1rc, rl1, c1), dev, rows),
                    *_put_mate((r2, r2rc, rl2, c2), dev, rows),
                    mu, sd, shard_ids=ids, group=group))
    if daxis:
        for i in (12, 13):                 # stats (float32), cov (int32)
            dist.all_reduce(out[i], group=mesh.get_group(daxis))
    return tuple(out)
