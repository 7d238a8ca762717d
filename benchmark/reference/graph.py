"""The plain reference's pangenome: nodes, edges and haplotype texts
worked out again from the reference sequence and the variants.

A variant is (pos0, ref allele, alt allele, genotypes), biallelic, and
no two variants overlap (the generator keeps them apart), so each is a
clump of its own in vg construct's terms. Nodes are numbered as vg
construct numbers them for such input: per variant, the reference run
up to the variant, then the alt allele's nodes, then the reference
bases the variant spans; runs are cut into pieces of at most
max_node_size bases, vg's even split. Edges join every node that ends
at position p - 1 to every node that starts at p (not insertion to
insertion), and a deletion arc joins the node before it to the node
after it. A haplotype is the reference with its alt alleles applied;
the text is the reference, then each sample's phases in order, with no
separator, as the port lays its text out.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

import numpy as np

from .alleles import condense_matches, decompose_allele, trim_to_variable


def decode(codes: np.ndarray) -> str:
    return np.frombuffer(b"ACGTN", np.uint8)[np.minimum(codes, 4)].tobytes(
    ).decode()


_CODE = np.full(256, 4, np.uint8)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def encode(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode(), np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return np.where(codes < 4, 3 - codes, codes).astype(np.uint8)[::-1]


@dataclass
class Variant:
    pos0: int                 # 0-based position of the ref allele
    ref: str
    alt: str
    genotypes: List[Tuple[int, int]]   # per sample, phased


@dataclass
class RefGraph:
    seq: Dict[int, np.ndarray] = field(default_factory=dict)
    ref_pos: Dict[int, int] = field(default_factory=dict)
    edges: Set[Tuple[int, int]] = field(default_factory=set)

    def has_edge(self, a: int, a_rev: bool, b: int, b_rev: bool) -> bool:
        """Is (a, a_rev) -> (b, b_rev) a walk step of the graph? This
        graph has only forward-forward edges, so a reverse step is a
        forward edge read backwards."""
        if a_rev != b_rev:
            return False
        return (b, a) in self.edges if a_rev else (a, b) in self.edges


def piece_size(length: int, max_node_size: int) -> int:
    count = length // max_node_size
    if count > 1:
        return min(max_node_size, max(length // count, 1))
    return max_node_size


def build_graph(ref: str, variants: List[Variant],
                max_node_size: int = 32) -> RefGraph:
    """The node table and edges vg construct gives these variants."""
    g = RefGraph()
    starting: Dict[int, Set[int]] = {}
    ending: Dict[int, Set[int]] = {}
    inserts: Set[int] = set()
    del_ending: Dict[int, Set[int]] = {}
    next_id = [1]
    cursor = [0]

    def create(seq: str, pos: int) -> List[int]:
        piece = piece_size(len(seq), max_node_size)
        codes = encode(seq)
        ids = []
        c = 0
        while c < len(seq):
            n = min(piece, len(seq) - c)
            nid = next_id[0]
            next_id[0] += 1
            g.seq[nid] = codes[c : c + n]
            g.ref_pos[nid] = pos + c
            if ids:
                g.edges.add((ids[-1], nid))
            ids.append(nid)
            c += n
        return ids

    def register(ids, start, end):
        starting.setdefault(start, set()).add(ids[0])
        ending.setdefault(end, set()).add(ids[-1])

    def ref_until(target: int) -> None:
        if target < cursor[0]:
            return
        run = create(ref[cursor[0]:target], cursor[0])
        if run:
            register(run, cursor[0], target - 1)
        cursor[0] = target

    for v in variants:
        edits = condense_matches(decompose_allele(v.ref, v.alt, v.pos0))
        alleles = [edits]
        trim_to_variable(alleles)
        edits = alleles[0]
        if not edits:
            continue
        v_start = edits[0].position
        v_end = edits[-1].position + len(edits[-1].ref) - 1
        ref_until(v_start)
        starts, ends, del_ends, del_starts = set(), set(), set(), set()
        for e in edits:
            if e.alt != "":
                run = create(e.alt, e.position)
                register(run, e.position, e.position + len(e.ref) - 1)
                starts.add(e.position)
                ends.add(e.position + len(e.ref) - 1)
                if e.ref == "":
                    inserts.update((run[0], run[-1]))
            elif e.ref != "":
                arc_end = e.position + len(e.ref) - 1
                del_ending.setdefault(arc_end, set()).add(e.position - 1)
                del_ends.add(arc_end)
                del_starts.add(e.position - 1)
        while cursor[0] < v_end + 1:
            pos = cursor[0]
            nxt = min([v_end] + [q - 1 for q in starts if q > pos]
                      + [q for q in ends | del_ends | del_starts if q >= pos])
            run = create(ref[pos : nxt + 1], pos)
            register(run, pos, nxt)
            cursor[0] = nxt + 1
    ref_until(len(ref))
    for pos, rights in starting.items():
        if pos == 0:
            continue
        lefts = ending.get(pos - 1, set())
        for r in rights:
            for left in lefts:
                if not (left in inserts and r in inserts):
                    g.edges.add((left, r))
            for ds in del_ending.get(pos - 1, ()):
                for left in ending.get(ds, ()):
                    if left not in inserts:
                        g.edges.add((left, r))
    return g


@dataclass
class Haplotypes:
    texts: List[np.ndarray]          # codes, ref first
    starts: np.ndarray               # offsets of each in the text
    # per haplotype, where each applied variant's allele ends (0 first)
    # and how far the haplotype's coordinates run ahead of the
    # reference's from there
    shift_at: List[np.ndarray]
    shift: List[np.ndarray]
    # per haplotype, (start, end) of each applied alt allele in its text
    alt_spans: List[np.ndarray]

    @property
    def text(self) -> np.ndarray:
        return np.concatenate(self.texts)

    def to_ref(self, h: int, x) -> np.ndarray:
        x = np.asarray(x, np.int64)
        i = np.searchsorted(self.shift_at[h], x, side="right") - 1
        return x - self.shift[h][i]


def build_haplotypes(ref: str, variants: List[Variant],
                     n_samples: int) -> Haplotypes:
    """The reference and each sample's phases as texts, in the order of
    the port's text: ref, s1#0, s1#1, s2#0, ..."""
    ref_codes = encode(ref)
    texts, shift_at, shift = [ref_codes], [np.zeros(1, np.int64)], \
        [np.zeros(1, np.int64)]
    alt_spans = [np.zeros((0, 2), np.int64)]
    for s in range(n_samples):
        for ph in range(2):
            parts, at, sh, spans = [], [0], [0], []
            cur = built = 0
            for v in variants:
                if v.genotypes[s][ph] != 1:
                    continue
                if v.pos0 < cur:
                    continue
                parts.append(ref_codes[cur : v.pos0])
                built += v.pos0 - cur
                parts.append(encode(v.alt))
                spans.append((built, built + len(v.alt)))
                built += len(v.alt)
                cur = v.pos0 + len(v.ref)
                at.append(built)
                sh.append(built - cur)
            parts.append(ref_codes[cur:])
            texts.append(np.concatenate(parts))
            shift_at.append(np.array(at, np.int64))
            shift.append(np.array(sh, np.int64))
            alt_spans.append(np.array(spans, np.int64).reshape(-1, 2))
    starts = np.zeros(len(texts) + 1, np.int64)
    np.cumsum([len(t) for t in texts], out=starts[1:])
    return Haplotypes(texts, starts, shift_at, shift, alt_spans)
