"""Allele decomposition, frozen for the benchmark's plain reference.

A frozen copy of the host routine that vg's Constructor uses to place an
alt allele's edits against its ref allele (vcflib's global affine
alignment: match 10, mismatch -9, gap open 15, gap extend 6.66; ties
prefer M, then D, then I), so that the reference graph puts an
ambiguous indel where vg construct puts it. Copied, unchanged, from
vg_tpu_torch/construct/allele_align.py; imports nothing of the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

MATCH = 10.0
MISMATCH = -9.0
GAP_OPEN = 15.0
GAP_EXTEND = 6.66


@dataclass(slots=True)
class AlleleEdit:
    """One primitive edit; position is 0-based on the reference contig.

    ref == alt        -> match run
    len(ref)==len(alt)==1, differ -> SNP
    ref == ""         -> insertion (before base at `position`)
    alt == ""         -> deletion of ref bases [position, position+len(ref))
    """
    position: int
    ref: str
    alt: str

    def is_match(self) -> bool:
        return self.ref == self.alt


def align_global(ref: str, alt: str) -> str:
    """Global affine-gap alignment; returns ops string over 'M','I','D'.

    'M' consumes both; 'I' consumes alt only (insertion); 'D' consumes ref
    only (deletion). Ties prefer M, then D, then I (leaves gaps as late as
    possible going left-to-right, since traceback is from the end).
    """
    n, m = len(ref), len(alt)
    if n == 0:
        return "I" * m
    if m == 0:
        return "D" * n
    NEG = -1e18
    # DP over (n+1, m+1): H best ending in match, E gap in alt (deletion,
    # consumes ref), F gap in ref (insertion, consumes alt)
    H = np.full((n + 1, m + 1), NEG)
    E = np.full((n + 1, m + 1), NEG)
    F = np.full((n + 1, m + 1), NEG)
    H[0, 0] = 0.0
    for i in range(1, n + 1):
        E[i, 0] = -GAP_OPEN - GAP_EXTEND * (i - 1)
    for j in range(1, m + 1):
        F[0, j] = -GAP_OPEN - GAP_EXTEND * (j - 1)
    r = np.frombuffer(ref.encode(), dtype=np.uint8)
    a = np.frombuffer(alt.encode(), dtype=np.uint8)
    for i in range(1, n + 1):
        sub = np.where(a == r[i - 1], MATCH, MISMATCH)
        for j in range(1, m + 1):
            best_prev = max(H[i - 1, j - 1], E[i - 1, j - 1], F[i - 1, j - 1])
            H[i, j] = best_prev + sub[j - 1]
            E[i, j] = max(H[i - 1, j] - GAP_OPEN, E[i - 1, j] - GAP_EXTEND,
                          F[i - 1, j] - GAP_OPEN)
            F[i, j] = max(H[i, j - 1] - GAP_OPEN, F[i, j - 1] - GAP_EXTEND,
                          E[i, j - 1] - GAP_OPEN)
    # traceback
    ops: List[str] = []
    i, j = n, m
    state = max(("M", H[n, m]), ("D", E[n, m]), ("I", F[n, m]),
                key=lambda t: t[1])[0]
    while i > 0 or j > 0:
        if i == 0:
            ops.append("I")
            j -= 1
            continue
        if j == 0:
            ops.append("D")
            i -= 1
            continue
        if state == "M":
            s = MATCH if ref[i - 1] == alt[j - 1] else MISMATCH
            prev = max(
                ("M", H[i - 1, j - 1]), ("D", E[i - 1, j - 1]), ("I", F[i - 1, j - 1]),
                key=lambda t: t[1])
            ops.append("M")
            i -= 1
            j -= 1
            state = prev[0]
        elif state == "D":
            cands = [("M", H[i - 1, j] - GAP_OPEN),
                     ("D", E[i - 1, j] - GAP_EXTEND),
                     ("I", F[i - 1, j] - GAP_OPEN)]
            prev = max(cands, key=lambda t: t[1])
            ops.append("D")
            i -= 1
            state = prev[0]
        else:  # I
            cands = [("M", H[i, j - 1] - GAP_OPEN),
                     ("I", F[i, j - 1] - GAP_EXTEND),
                     ("D", E[i, j - 1] - GAP_OPEN)]
            prev = max(cands, key=lambda t: t[1])
            ops.append("I")
            j -= 1
            state = prev[0]
    return "".join(reversed(ops))


def decompose_allele(ref: str, alt: str, pos0: int,
                     mnp_per_base: bool = True) -> List[AlleleEdit]:
    """Decompose one alt allele against the ref allele into AlleleEdits.

    pos0: 0-based contig position of the first ref base.
    """
    edits: List[AlleleEdit] = []
    if ref == alt:
        if ref:
            edits.append(AlleleEdit(pos0, ref, alt))
        return edits
    if len(ref) == len(alt):
        # equal lengths: the affine-gap optimum is the diagonal alignment
        ops = "M" * len(ref)
    else:
        ops = align_global(ref, alt)
    i = j = 0  # cursors into ref/alt
    k = 0
    while k < len(ops):
        op = ops[k]
        k2 = k
        while k2 < len(ops) and ops[k2] == op:
            k2 += 1
        run = k2 - k
        if op == "M":
            # split M run into match runs and SNP edits
            s = 0
            while s < run:
                is_mm = ref[i + s] != alt[j + s]
                e = s
                while e < run and (ref[i + e] != alt[j + e]) == is_mm:
                    e += 1
                if is_mm:
                    if mnp_per_base:
                        for t in range(s, e):
                            edits.append(AlleleEdit(pos0 + i + t,
                                                    ref[i + t], alt[j + t]))
                    else:
                        edits.append(AlleleEdit(pos0 + i + s,
                                                ref[i + s:i + e], alt[j + s:j + e]))
                else:
                    edits.append(AlleleEdit(pos0 + i + s,
                                            ref[i + s:i + e], ref[i + s:i + e]))
                s = e
            i += run
            j += run
        elif op == "D":
            edits.append(AlleleEdit(pos0 + i, ref[i:i + run], ""))
            i += run
        else:  # I
            edits.append(AlleleEdit(pos0 + i, "", alt[j:j + run]))
            j += run
        k = k2
    return edits


def condense_matches(edits: List[AlleleEdit]) -> List[AlleleEdit]:
    """Merge adjacent perfect-match edits (reference: Constructor::
    condense_edits, src/constructor.cpp:143)."""
    out: List[AlleleEdit] = []
    for e in edits:
        if out and out[-1].is_match() and e.is_match() \
                and out[-1].position + len(out[-1].ref) == e.position:
            out[-1] = AlleleEdit(out[-1].position, out[-1].ref + e.ref,
                                 out[-1].alt + e.alt)
        else:
            out.append(e)
    return out


def trim_to_variable(alleles: List[List[AlleleEdit]]) -> None:
    """Jointly trim leading/trailing matches shared by ALL alts of a variant
    (reference: Constructor::trim_to_variable, src/constructor.cpp:26).
    Mutates the lists in place."""

    def match_count(front: bool) -> int:
        count = None
        for allele in alleles:
            if not allele:
                return 0
            e = allele[0] if front else allele[-1]
            if not e.is_match():
                return 0
            count = len(e.ref) if count is None else min(count, len(e.ref))
        return count or 0

    c = match_count(True)
    while c > 0:
        for allele in alleles:
            e = allele[0]
            if len(e.ref) > c:
                allele[0] = AlleleEdit(e.position + c, e.ref[c:], e.ref[c:])
            else:
                allele.pop(0)
        c = match_count(True)
    c = match_count(False)
    while c > 0:
        for allele in alleles:
            e = allele[-1]
            if len(e.ref) > c:
                allele[-1] = AlleleEdit(e.position, e.ref[:-c], e.ref[:-c])
            else:
                allele.pop()
        c = match_count(False)
