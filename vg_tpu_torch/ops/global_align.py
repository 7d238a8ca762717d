"""Small global (both-ends-pinned) affine alignment for chain links.

The reference aligns inter-anchor gaps with WFAExtender::connect
(haplotype-bound wavefronts, src/gbwt_extender.hpp:346+) or the banded
global aligner (src/banded_global_aligner.cpp). On the haplotype text a
link is sequence-vs-sequence; gaps are short (between adjacent chain
anchors), so a dense host DP with an adaptive band is plenty — and the
pure-insertion/deletion shortcuts mirror vg's deletion_aligner
(src/deletion_aligner.cpp).

Copied from vg_tpu/ops/global_align.py.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .align import Scoring, DEFAULT_SCORING

NEG = -(10 ** 8)


def global_align(a: np.ndarray, b: np.ndarray,
                 scoring: Scoring = DEFAULT_SCORING,
                 max_cells: int = 4_000_000
                 ) -> Optional[Tuple[int, List[Tuple]]]:
    """Align read segment ``a`` to text segment ``b`` end-to-end.

    Returns (score, edits) with the same edit vocabulary as
    vg_tpu.ops.traceback; None if the DP would exceed max_cells (caller
    then falls back to a block indel representation, like vg's
    max_dp_cells refusal, minimizer_mapper_from_chains.cpp:3790).
    """
    la, lb = len(a), len(b)
    if la == 0 and lb == 0:
        return 0, []
    m, x = scoring.match, scoring.mismatch
    go, ge = scoring.gap_open, scoring.gap_extend
    if la == 0:
        return -(go + (lb - 1) * ge), [("D", lb)]
    if lb == 0:
        return -(go + (la - 1) * ge), [("I", la, a.copy())]
    if (la + 1) * (lb + 1) > max_cells:
        return None
    from ..native import lib as _native_lib, native_global_align

    if _native_lib() is not None:
        res = native_global_align(a, b, scoring, max_cells)
        if res is not None and res is not False:
            return res

    H = np.full((la + 1, lb + 1), NEG, dtype=np.int64)
    E = np.full((la + 1, lb + 1), NEG, dtype=np.int64)  # gap in a (D)
    F = np.full((la + 1, lb + 1), NEG, dtype=np.int64)  # gap in b (I)
    H[0, 0] = 0
    for j in range(1, lb + 1):
        E[0, j] = -(go + (j - 1) * ge)
        H[0, j] = E[0, j]
    for i in range(1, la + 1):
        F[i, 0] = -(go + (i - 1) * ge)
        H[i, 0] = F[i, 0]
        sub = np.where((b == a[i - 1]) & (a[i - 1] < 4), m, -x)
        # E along the row needs H of same row: do it scalar-free via two
        # passes (numpy recurrence not directly expressible) — row lengths
        # are small, a python loop is acceptable here
        diag = H[i - 1, :-1] + sub
        F[i, 1:] = np.maximum(H[i - 1, 1:] - go, F[i - 1, 1:] - ge)
        Hi = np.maximum(diag, F[i, 1:])
        # in-row E via prefix max of (Hnodel[j'] + ge*j')
        Gj = np.concatenate([[H[i, 0]], Hi]) + ge * np.arange(lb + 1)
        Gmax = np.maximum.accumulate(Gj)
        Ei = Gmax[:-1] - go - ge * np.arange(lb) + 0  # E[i, j+1]
        E[i, 1:] = Ei
        H[i, 1:] = np.maximum(Hi, Ei)
    score = int(H[la, lb])

    # traceback
    edits: List[Tuple] = []

    def push(kind, n=1, seq=None):
        if edits and edits[-1][0] == kind and kind in ("M", "D"):
            edits[-1] = (kind, edits[-1][1] + n)
        elif edits and edits[-1][0] == kind and seq is not None:
            edits[-1] = (kind, edits[-1][1] + n,
                         np.concatenate([seq, edits[-1][2]]))
        else:
            edits.append((kind, n) if seq is None else (kind, n, seq))

    i, j = la, lb
    state = "H"
    while i > 0 or j > 0:
        if state == "H":
            if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + (
                    m if (a[i - 1] == b[j - 1] and a[i - 1] < 4) else -x):
                if a[i - 1] == b[j - 1] and a[i - 1] < 4:
                    push("M")
                else:
                    push("X", 1, a[i - 1 : i])
                i -= 1
                j -= 1
            elif H[i, j] == E[i, j]:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            push("D")
            if j > 1 and E[i, j] == E[i, j - 1] - ge:
                j -= 1
            else:
                j -= 1
                state = "H"
        else:
            push("I", 1, a[i - 1 : i])
            if i > 1 and F[i, j] == F[i - 1, j] - ge:
                i -= 1
            else:
                i -= 1
                state = "H"
    edits.reverse()
    return score, edits
