"""Device twin of the anchor-chaining DP, in torch ops.

The torch port of vg_tpu/ops/device_chain.py. Reference role:
algorithms/chain_items.cpp chain_items_dp — the sequential
sparse-chaining recurrence behind the hifi/r10 long-read presets
(minimizer_mapper_from_chains.cpp:1646). Anchors sorted by (text_pos,
read_off) stream through a loop whose carry is a rolling window of the
last J anchors' (f, roff, tpos, index), so each step scores all J
candidate predecessors as one vector op and the whole batch of reads
advances in lockstep. Work is O(N * J) — the same shape as the
numpy/native host DP (map/chain.chain_anchors), which stays the
production chain DP; this twin is on no mapping path.

Semantics match chain_anchors element for element: window = previous J
anchors in sort order, first-maximum argmax, strict improvement over the
anchor's own score, parent -1 otherwise. Floating point is float32 on the
device (the host DP is float64): exact for exactly representable
parameter sets, within float32 rounding otherwise.
"""
from __future__ import annotations

import numpy as np
import torch

NEGF = np.float32(-3.0e38)


def chain_scan(roff, tpos, ascore, valid, *, J: int, kmer: int,
               max_lookback: int, max_indel: int, gap_scale: float,
               gap_open: float):
    """(R, N) int32 roff/tpos, float32 ascore, bool valid on one device ->
    (f float32 (R, N), parent int32 (R, N))."""
    dev = roff.device
    R, N = roff.shape
    i32 = torch.int32
    f32 = torch.float32
    gap_scale = torch.tensor(gap_scale, dtype=f32, device=dev)
    gap_open = torch.tensor(gap_open, dtype=f32, device=dev)
    negf = torch.tensor(NEGF, dtype=f32, device=dev)
    fwin = torch.full((R, J), float(NEGF), dtype=f32, device=dev)
    rwin = torch.zeros((R, J), dtype=i32, device=dev)
    twin = torch.zeros((R, J), dtype=i32, device=dev)
    jwin = torch.full((R, J), -1, dtype=i32, device=dev)
    f_out = torch.empty((R, N), dtype=f32, device=dev)
    p_out = torch.empty((R, N), dtype=i32, device=dev)
    sh = lambda w, nv: torch.cat([w[:, 1:], nv[:, None]], dim=1)
    for i in range(N):
        r_i, t_i, s_i, v_i = roff[:, i], tpos[:, i], ascore[:, i], valid[:, i]
        dt = t_i[:, None] - twin
        dr = r_i[:, None] - rwin
        ok = ((jwin >= 0) & (dr > 0) & (dt > 0) & (dt <= max_lookback)
              & ((dt - dr).abs() <= max_indel))
        gap = (dt - dr).abs().to(f32)
        gain = torch.minimum(torch.minimum(dr, dt),
                             torch.tensor(kmer, dtype=i32,
                                          device=dev)).to(f32)
        cost = torch.where(gap > 0, gap_open + gap_scale * gap,
                           torch.zeros((), dtype=f32, device=dev))
        cand = torch.where(ok, fwin + gain - cost, negf)
        best = torch.argmax(cand, dim=1, keepdim=True)   # first max
        bv = torch.gather(cand, 1, best)[:, 0]
        base = s_i.to(f32)
        better = bv > base
        f_i = torch.where(better, bv, base)
        p_i = torch.where(better, torch.gather(jwin, 1, best)[:, 0],
                          torch.tensor(-1, dtype=i32, device=dev))
        f_i = torch.where(v_i, f_i, negf)
        p_i = torch.where(v_i, p_i, torch.tensor(-1, dtype=i32, device=dev))
        j_i = torch.where(v_i, torch.tensor(i, dtype=i32, device=dev),
                          torch.tensor(-1, dtype=i32, device=dev))
        f_out[:, i] = f_i
        p_out[:, i] = p_i
        fwin, rwin = sh(fwin, f_i), sh(rwin, r_i)
        twin, jwin = sh(twin, t_i), sh(jwin, j_i)
    return f_out, p_out


def chain_anchors_device_batch(roff, tpos, ascore, valid, params,
                               device=None):
    """Batched device chain DP over (R, N) anchor arrays (each row sorted
    by (tpos, roff), padded with valid=False trailing slots) on `device`
    (None: the card). Returns host (f float32 (R, N), parent int32
    (R, N))."""
    from ..map.giraffe import resolve_device

    device = resolve_device(device)
    put = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x, dt),
                                        device=device)
    R, N = np.shape(roff)
    J = int(min(params.lookback_cands, max(N - 1, 1)))
    f, parent = chain_scan(
        put(roff, np.int32), put(tpos, np.int32), put(ascore, np.float32),
        put(valid, bool), J=J, kmer=int(params.kmer),
        max_lookback=int(params.max_lookback),
        max_indel=int(params.max_indel),
        gap_scale=float(params.gap_scale), gap_open=float(params.gap_open))
    return f.cpu().numpy(), parent.cpu().numpy()


def chain_anchors_device(roff, tpos, ascore, params, device=None):
    """Single-problem signature matching map/chain.chain_anchors:
    returns (f, parent) for anchors already sorted by (tpos, roff)."""
    n = len(roff)
    if n == 0:
        return (np.zeros(0, np.float64), np.zeros(0, np.int64))
    f, parent = chain_anchors_device_batch(
        np.asarray(roff, np.int64)[None, :],
        np.asarray(tpos, np.int64)[None, :],
        np.asarray(ascore, np.float64)[None, :],
        np.ones((1, n), bool), params, device=device)
    return f[0].astype(np.float64), parent[0].astype(np.int64)
