"""Judging one emitted record against the reference graph.

A record's path has to be a walk of the graph: each mapping on a node
that exists, at an offset inside it, and each step to the next mapping
either along the same node or over an edge from the node's last base to
the next node's first. Its edits, laid along that walk, have to spell
the read: a match where graph and read bases agree, a substitution where
they differ, inserted bases as the read has them. The score is worked
out again from the edits: match +1, mismatch -4, a gap of n bases
-(6 + (n - 1)), gaps that continue over a node boundary counted once, an
insertion at either end of the read a soft clip (no score, no bonus),
and +5 for each end of the read that the alignment reaches. The leftmost
reference coordinate of the path gives its placement.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .gam import Record
from .graph import RefGraph, encode, revcomp


@dataclass
class Scoring:
    match: int = 1
    mismatch: int = 4
    gap_open: int = 6
    gap_extend: int = 1
    bonus: int = 5


@dataclass
class Verdict:
    mapped: bool
    path_ok: bool
    score: Optional[int]      # the reference's score of the record's edits
    leftmost: Optional[int]   # leftmost reference coordinate of the path
    why: str = ""


def judge(rec: Record, read: np.ndarray, g: RefGraph,
          s: Scoring = Scoring(), acc=np.int64) -> Verdict:
    """`read`: the read's codes as sequenced. `acc` is the type the score
    is summed in (int64; a lower precision for the control)."""
    if not rec.has_path or not rec.mappings:
        return Verdict(False, True, None, None)
    pos = 0
    kinds = []                # per edit: (kind, length) with kind M X I D
    leftmost = None
    prev = None
    for m in rec.mappings:
        node = g.seq.get(m.node_id)
        if node is None:
            return Verdict(True, False, None, None, f"node {m.node_id}")
        seq = revcomp(node) if m.is_reverse else node
        nlen = len(seq)
        off = m.offset
        flen = sum(e.from_length for e in m.edits)
        if off < 0 or off + flen > nlen:
            return Verdict(True, False, None, None, "offset past node")
        if prev is not None:
            p_id, p_rev, p_end, p_len = prev
            same = p_id == m.node_id and p_rev == m.is_reverse \
                and p_end == off
            step = p_end == p_len and off == 0 and g.has_edge(
                p_id, p_rev, m.node_id, m.is_reverse)
            if not (same or step):
                return Verdict(True, False, None, None,
                               f"no step {p_id}->{m.node_id}")
        fwd_off = nlen - off - flen if m.is_reverse else off
        if flen:
            lm = g.ref_pos[m.node_id] + fwd_off
            leftmost = lm if leftmost is None else min(leftmost, lm)
        gi = off
        for e in m.edits:
            f, t = e.from_length, e.to_length
            if f and t:
                if f != t or pos + t > len(read):
                    return Verdict(True, False, None, None, "edit lengths")
                gb = seq[gi : gi + f]
                rb = read[pos : pos + t]
                if e.sequence:
                    if not np.array_equal(encode(e.sequence), rb):
                        return Verdict(True, False, None, None,
                                       "substitution bases")
                    kinds += [("X", 1)] * t
                    if np.any(gb == rb):
                        # bases that agree scored as mismatches
                        return Verdict(True, False, None, None,
                                       "substitution of equal bases")
                else:
                    if not np.array_equal(gb, rb):
                        return Verdict(True, False, None, None,
                                       "match of unequal bases")
                    kinds.append(("M", t))
            elif t:
                if pos + t > len(read) or not np.array_equal(
                        encode(e.sequence), read[pos : pos + t]):
                    return Verdict(True, False, None, None,
                                   "insertion bases")
                kinds.append(("I", t))
            elif f:
                kinds.append(("D", f))
            gi += f
            pos += t
        prev = (m.node_id, m.is_reverse, gi, nlen)
    if pos != len(read):
        return Verdict(True, False, None, None, "read not covered")
    # merge runs of one kind (a gap over a node boundary is one gap)
    runs = []
    for k, n in kinds:
        if runs and runs[-1][0] == k:
            runs[-1][1] += n
        else:
            runs.append([k, n])
    score = acc(0)
    for i, (k, n) in enumerate(runs):
        clip = k == "I" and (i == 0 or i == len(runs) - 1)
        if clip:
            continue
        if k == "M":
            score = acc(score + acc(n * s.match))
        elif k == "X":
            score = acc(score - acc(n * s.mismatch))
        else:
            score = acc(score - acc(s.gap_open + (n - 1) * s.gap_extend))
    if runs[0][0] != "I":
        score = acc(score + acc(s.bonus))
    if runs[-1][0] != "I":
        score = acc(score + acc(s.bonus))
    return Verdict(True, True, int(score), leftmost)
