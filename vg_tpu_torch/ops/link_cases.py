"""Link-engine inputs (ops/cuda_links.py, ops/device_links.link_engine) made
with numpy from a seed: padded task arrays (a4, la, ta, base, lb) in
DeviceLinkAligner's layout over a random text. tests/test_torch_longread.py
holds the plain fill and walk against vg_tpu's link_engine on them;
tests/test_torch_device_links.py and chip_smoke.py hold each kernel
against its plain version.

`synthetic_links` is a batch of the problems the certification must sort
out. `link_case(name)` builds the cases named in CASES, each where the
kernels could leave their plain versions:

- "row_below_zero": tasks whose walk starts out of the band and steps to
  row -1 (an F move on row 0), one of them task 0, so that the flat index
  wraps once by the array's size, the others reading the previous task's
  last row;
- "text_start" / "text_end": links at text offset 0 and ending at T, past
  T, or starting at T, so the text window holds the code 6 outside [0, T);
- "d_2b": |lb - la| = 2B, the band's edge, short and long reads;
- "la_rmax": la = RMAX, every row of the bucket;
- "extend_ties": tandem repeats and homopolymers with indels inside them,
  where opening and extending a gap often give the same value (the E- and
  F-extend rules' ties), at the default scoring and at gap_open ==
  gap_extend ("open_equals_extend");
- "odd_coordinates": la outside [0, RMAX], lb <= 0, bases away from
  min(0, d) - B, text offsets outside [0, T);
- "ragged_n": N = 45, not a multiple of 32 (nor of the fill's 4 tasks a
  block); the other cases are ragged too.

The fill puts a task on 8 lanes (four tasks a warp), the walk on 4 lanes
(eight a warp); each orders a block's 32 tasks by rows, and
the walk reads tiles of R = 16 rows (cuda_links.FILL_LANES,
FILL_WARP_TASKS, WALK_WARP_TASKS, the BLOCK_TASKS, WALK_TILE_ROWS). The
cases at those edges:

- "tile_edges": la at R - 1, R, R + 1, 2R - 1, 2R, 2R + 1, RMAX - 1 and
  RMAX, with the final column on each edge of a fill lane's columns
  (CPL = ceil(WB / 8) of them);
- "ragged_warp": warps whose tasks run 0, 1, a middle count and RMAX
  rows, both in the tasks' order (quads) and after a block orders them
  (a block of RMAX rows but for three);
- "ins_tile_edge": insertions of 3-12 read bases whose rows cross the
  first and second tile edges of the walk (rows la - R and la - 2R);
- "row_below_zero_tile": walks that reach row -1 (F moves only, or past
  b's end) from la = R - 1, R, R + 1 and 2R, so that the last tile ends
  at row 0 or one row above it;
- "narrow_band" / "wide_band": B = 8 (WB = 33, 5 columns a lane, the last
  lane empty) and B = 23 (WB = 93, 12 columns a lane, the most the fill
  takes); every case gives its B under "B", and WB = 4B + 1.
"""
from __future__ import annotations

import numpy as np

from .cuda_links import FILL_LANES, WALK_TILE_ROWS as TILE_ROWS

DEFAULT_SCORING = (1, 4, 6, 1)     # match, mismatch, gap_open, gap_extend
CASES = ("row_below_zero", "text_start", "text_end", "d_2b", "la_rmax",
         "extend_ties", "open_equals_extend", "odd_coordinates", "ragged_n",
         "tile_edges", "ragged_warp", "ins_tile_edge", "row_below_zero_tile",
         "narrow_band", "wide_band")
CASE_B = {"narrow_band": 8, "wide_band": 23}   # the cases with their own B
_NIB = np.arange(8, dtype=np.uint32) * 4


def pack_read(a, RMAX: int) -> np.ndarray:
    """The (RMAX/8,) uint32 words of read codes `a` (zero past len(a))."""
    ap = np.zeros(RMAX, np.uint8)
    ap[: len(a)] = a[:RMAX]
    return (ap.reshape(-1, 8).astype(np.uint32) << _NIB).sum(
        axis=1, dtype=np.uint32)


def synthetic_links(seed, N=1024, RMAX=256, B=16, T=20000):
    """Link problems the certification must sort out: clean and mutated
    slices, indels that leave the band, junk reads, |d| = 2B, la = RMAX,
    and padding (la = 0) in the last 64 tasks."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, T).astype(np.uint8)
    a4 = np.zeros((N, RMAX // 8), np.uint32)
    la = np.zeros(N, np.int32)
    ta = np.zeros(N, np.int32)
    ba = np.zeros(N, np.int32)
    lb = np.ones(N, np.int32)
    for k in range(N - 64):
        n_a = RMAX if k % 50 == 0 else int(rng.integers(1, RMAX + 1))
        d = 2 * B * (1 if k % 2 else -1) if k % 17 == 0 else \
            int(rng.integers(-2 * B, 2 * B + 1))
        n_b = max(1, n_a + d)
        s = int(rng.integers(0, T - n_b))
        kind = k % 4
        if kind == 3:
            a = rng.integers(0, 5, n_a).astype(np.uint8)     # junk, N bases
        else:
            src = text[s : s + max(n_a, n_b) + 64].copy()
            if kind == 2 and len(src) > 40:                  # a long indel
                q = int(rng.integers(5, len(src) - 30))
                src = np.concatenate([src[:q], src[q + 25 :]])
            a = src[:n_a].copy()
            if len(a) < n_a:
                a = np.concatenate([a, rng.integers(0, 4, n_a - len(a))
                                    .astype(np.uint8)])
            mut = rng.random(n_a) < 0.03
            a[mut] = (a[mut] + 1) % 4
        a4[k] = pack_read(a, RMAX)
        la[k], ta[k], lb[k] = n_a, s, n_b
        ba[k] = min(0, n_b - n_a) - B
    return text, (a4, la, ta, ba, lb)


class _Tasks:
    """Builds a case's task arrays one task at a time."""

    def __init__(self, RMAX, B):
        self.RMAX, self.B = RMAX, B
        self.rows = []

    def add(self, a, ta, lb, base=None, la=None):
        la = len(a) if la is None else la
        if base is None:
            base = min(0, lb - la) - self.B
        self.rows.append((pack_read(np.asarray(a, np.uint8), self.RMAX),
                          la, ta, base, lb))

    def link(self, rng, text, la, ta, lb, err=0.03):
        """A read slice of `la` codes copied from text[ta:] with
        substitutions, against text[ta : ta + lb)."""
        a = text[max(ta, 0) : max(ta, 0) + la].copy()
        if len(a) < la:
            a = np.concatenate([a, rng.integers(0, 4, la - len(a))
                                .astype(np.uint8)])
        mut = rng.random(la) < err
        a[mut] = (a[mut] + 1) % 4
        self.add(a, ta, lb)

    def arrays(self):
        a4 = np.stack([r[0] for r in self.rows])
        cols = [np.array([r[i] for r in self.rows], np.int32)
                for i in range(1, 5)]
        return (a4, *cols)


def _repeat_text(rng, T):
    """Homopolymers and short tandem repeats with random spacers."""
    parts, n = [], 0
    while n < T:
        kind = int(rng.integers(0, 3))
        if kind == 0:
            p = np.full(int(rng.integers(4, 30)), rng.integers(0, 4))
        elif kind == 1:
            unit = rng.integers(0, 4, int(rng.integers(2, 5)))
            p = np.tile(unit, int(rng.integers(3, 12)))
        else:
            p = rng.integers(0, 4, int(rng.integers(3, 20)))
        parts.append(p.astype(np.uint8))
        n += len(p)
    return np.concatenate(parts)[:T]


def _indel_read(rng, src, la, n_indels=3):
    """`la` codes of `src` with n_indels insertions or deletions of 1-4
    codes (repeat units, where the text is a repeat)."""
    a = src.copy()
    for _ in range(n_indels):
        q = int(rng.integers(1, max(2, len(a) - 5)))
        n = int(rng.integers(1, 5))
        if rng.random() < 0.5:
            a = np.concatenate([a[:q], a[q : q + n], a[q:]])
        else:
            a = np.concatenate([a[:q], a[q + n :]])
    return a[:la]


def lane_columns(B: int) -> int:
    """CPL: the band columns a fill lane holds at WB = 4B + 1."""
    return -(-(4 * B + 1) // FILL_LANES)


def link_case(name: str, seed: int = 0, RMAX: int = 256, B: int = 16,
              T: int = 4000) -> dict:
    """One of CASES: {"text": (T,) uint8, "arrays": (a4 (N, RMAX/8) uint32,
    la, ta, base, lb (N,) int32), "scoring": (match, mismatch, gap_open,
    gap_extend), "B": the band radius the arrays are built for (WB = 4B +
    1)}."""
    if name not in CASES:
        raise ValueError(f"unknown link case {name!r}")
    B = CASE_B.get(name, B)
    rng = np.random.default_rng([seed, CASES.index(name), RMAX])
    text = (_repeat_text(rng, T) if name in ("extend_ties",
                                             "open_equals_extend")
            else rng.integers(0, 4, T).astype(np.uint8))
    t = _Tasks(RMAX, B)
    scoring = DEFAULT_SCORING
    W = 2 * B
    if name == "row_below_zero":
        # the walk starts out of the band (lb - la - base < 0 clamps its
        # column to 0) and takes F moves down to row 0 and past it: left
        # of the text (la + base < 0, j < 0: only F moves are open), or
        # right of b's end (la + base > lb: no cell is in the band, and on
        # row -1, j > 0, the previous task's last row decides D or I)
        for k in range(38):
            if k % 3:              # full rows before and after them
                t.link(rng, text, RMAX, int(rng.integers(0, T - RMAX - W)),
                       RMAX + int(rng.integers(-W, W + 1)))
            elif k % 2:
                la = int(rng.integers(1, min(RMAX, 3 * B) + 1))
                base = -la - int(rng.integers(1, B + 1))
                t.add(rng.integers(0, 4, la), int(rng.integers(0, T)),
                      -int(rng.integers(1, B + 1)), base=base)
            else:                  # la < WB: the clamped column stays put
                la = int(rng.integers(B, min(RMAX, 4 * B) + 1))
                base = -int(rng.integers(0, B))
                t.add(rng.integers(0, 4, la), int(rng.integers(0, T)),
                      int(rng.integers(0, la + base)), base=base)
    elif name == "text_start":
        for k in range(41):
            la = int(rng.integers(1, RMAX + 1))
            t.link(rng, text, la, k % (B + 1),
                   max(1, la + int(rng.integers(-W, W + 1))))
    elif name == "text_end":
        for k in range(43):
            la = int(rng.integers(1, RMAX + 1))
            lb = max(1, la + int(rng.integers(-W, W + 1)))
            ta = (T - lb, T - lb + 1 + k % 5, T)[k % 3]
            t.link(rng, text, la, ta, lb)
    elif name == "d_2b":
        for k in range(39):
            la = (1, 2, W, RMAX - W, RMAX, int(rng.integers(1, RMAX + 1))
                  )[k % 6]
            lb = la + (W if k % 2 else -W)
            if lb < 1:
                lb = la + W
            t.link(rng, text, la, int(rng.integers(0, T - lb)), lb)
    elif name == "la_rmax":
        for k in range(35):
            lb = RMAX + int(rng.integers(-W, W + 1))
            t.link(rng, text, RMAX, int(rng.integers(0, T - lb)), lb,
                   err=(0.0, 0.03, 0.3)[k % 3])
    elif name in ("extend_ties", "open_equals_extend"):
        if name == "open_equals_extend":
            scoring = (1, 4, 2, 2)
        for k in range(47):
            la = int(rng.integers(8, RMAX + 1))
            ta = int(rng.integers(0, T - la - 2 * W))
            src = text[ta : ta + la + W]
            a = _indel_read(rng, src, la)
            lb = min(max(1, len(a) + int(rng.integers(-3, 4))), la + W)
            t.add(a, ta, lb)
    elif name == "odd_coordinates":
        for k in range(53):
            la = (-2, 0, RMAX + 3, int(rng.integers(1, RMAX + 1)))[k % 4]
            lb = (-2, 0, int(rng.integers(1, RMAX + 2 * W)))[k % 3]
            base = int(rng.integers(-3 * W, 8))
            ta = (-W, T + 5, int(rng.integers(0, T)))[k % 3 if k % 2
                                                      else 2]
            t.add(rng.integers(0, 5, max(la, 0)), ta, lb, base=base, la=la)
    elif name == "tile_edges":
        R, cpl = TILE_ROWS, lane_columns(B)
        las = (R - 1, R, R + 1, 2 * R - 1, 2 * R, 2 * R + 1, RMAX - 1, RMAX)
        # final column cf = max(d, 0) + B: each lane edge in [B, 3B]
        edges = [e for g in range(1, FILL_LANES + 1)
                 for e in (g * cpl - 1, g * cpl) if B <= e <= 3 * B]
        for k in range(61):
            la = las[k % len(las)]
            d = edges[k % len(edges)] - B if k % 5 else -int(
                rng.integers(1, W + 1))
            t.link(rng, text, la, int(rng.integers(0, T - la - W)), la + d)
    elif name == "ragged_warp":
        mid = RMAX // 2 + 3
        order = [RMAX] * 29
        for k, la in zip((2, 7, 12), (0, 1, mid)):   # in the first 16
            order.insert(k, la)
        order += [(0, 1, mid, RMAX)[(k + k // 4) % 4] for k in range(28)]
        for la in order:
            if la == 0:            # padding, as DeviceLinkAligner pads
                t.add([], 0, 1, base=0)
                continue
            lb = max(1, la + int(rng.integers(-W, W + 1)))
            t.link(rng, text, la, int(rng.integers(0, T - lb)), lb)
    elif name == "ins_tile_edge":
        for k in range(37):
            n = int(rng.integers(3, 13))
            L = int(rng.integers(2 * TILE_ROWS + 40, RMAX - n + 1))
            ta = int(rng.integers(0, T - L))
            src = text[ta : ta + L]
            edge = TILE_ROWS * (1 + k % 2)        # rows la - R, la - 2R
            # the inserted codes take rows q + 1 .. q + n of la = L + n
            q = L + n - edge - int(rng.integers(1, n))
            ins = rng.integers(0, 4, n).astype(np.uint8)
            t.add(np.concatenate([src[:q], ins, src[q:]]), ta, L)
    elif name == "row_below_zero_tile":
        R = TILE_ROWS
        for k in range(42):
            la = (R - 1, R, R + 1, 2 * R)[k % 4]
            if k % 7 == 6:         # full rows between them
                t.link(rng, text, RMAX, int(rng.integers(0, T - RMAX - W)),
                       RMAX + int(rng.integers(-W, W + 1)))
            elif k % 2:            # left of the text: F moves only
                base = -la - int(rng.integers(1, B + 1))
                t.add(rng.integers(0, 4, la), int(rng.integers(0, T)),
                      -int(rng.integers(1, B + 1)), base=base)
            else:                  # past b's end
                base = -int(rng.integers(0, min(B, la - 1)))
                t.add(rng.integers(0, 4, la), int(rng.integers(0, T)),
                      int(rng.integers(0, la + base)), base=base)
    elif name in CASE_B:
        for k in range(51):
            if k % 13 == 12:
                t.add([], 0, 1, base=0)
                continue
            la = (RMAX, int(rng.integers(1, RMAX + 1)))[k % 2]
            lb = max(1, la + (W, -W, int(rng.integers(-W, W + 1)))[k % 3])
            t.link(rng, text, la, int(rng.integers(0, T - lb)), lb)
    else:                          # ragged_n
        for k in range(45):
            if k % 9 == 8:         # padding, as DeviceLinkAligner pads
                t.add([], 0, 1, base=0)
                continue
            la = int(rng.integers(1, RMAX + 1))
            lb = max(1, la + int(rng.integers(-W, W + 1)))
            t.link(rng, text, la, int(rng.integers(0, T - lb)), lb)
    return {"text": text, "arrays": t.arrays(), "scoring": scoring, "B": B}
