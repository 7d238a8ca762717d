"""GBZ writer: serialize a graph + haplotype walks as a GBWT+GBWTGraph
container (the reference ecosystem's index interchange format).

Construction notes: the GBWT is the FM-index of the haplotype walks —
record `v` stores, for every visit of node `v` across all sequences, the
successor node, with visits ordered co-lexicographically by their prefix
(ties between identical prefixes broken by sequence id, matching the
endmarker record's sequence order). That ordering is computed here as a
suffix array of the reversed sequences (prefix-doubling, O(n log^2 n)),
which is exact and simple; the reference's incremental insertion
algorithm (deps/gbwt) achieves the same order online.

The wire format mirrors vg_tpu.io.gbz's reader (simple-sds primitives,
byte-coded records, Option-wrapped metadata); writer and reader are
mutually validating: write -> read -> extract returns the input walks.

Copied from vg_tpu/io/gbz_write.py.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .gbz import GBZ_MAGIC, GBWT_MAGIC

META_MAGIC = 0x6B375E7A
NO_PHASE = 0xFFFFFFFF


class Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def u32_pair(self, a: int, b: int):
        self.parts.append(struct.pack("<II", a, b))

    def words(self, arr: np.ndarray):
        self.parts.append(np.ascontiguousarray(arr, "<u8").tobytes())

    def vec_u64(self, arr: np.ndarray):
        self.u64(len(arr))
        self.words(np.asarray(arr, np.uint64))

    def vec_u8(self, data: bytes):
        self.u64(len(data))
        pad = (-len(data)) % 8
        self.parts.append(data + b"\0" * pad)

    def raw_vector_bits(self, bits: np.ndarray):
        """bits: bool array."""
        nb = len(bits)
        words = np.packbits(np.asarray(bits, np.uint8),
                            bitorder="little")
        pad = (-len(words)) % 8
        words = np.concatenate([words, np.zeros(pad, np.uint8)])
        w64 = words.view("<u8")
        self.u64(nb)
        self.vec_u64(w64)

    def option_absent(self):
        self.u64(0)

    def bit_vector(self, bits: np.ndarray):
        self.raw_vector_bits(bits)
        self.option_absent()
        self.option_absent()
        self.option_absent()

    def int_vector(self, vals: np.ndarray, width: Optional[int] = None):
        vals = np.asarray(vals, np.uint64)
        if width is None:
            mx = int(vals.max()) if len(vals) else 0
            width = max(mx.bit_length(), 1)
        n = len(vals)
        self.u64(n)
        self.u64(width)
        bits = np.zeros(n * width, np.uint8)
        for b in range(width):
            bits[b::width] = (vals >> np.uint64(b)) & np.uint64(1)
        nb = n * width
        words = np.packbits(bits, bitorder="little")
        pad = (-len(words)) % 8
        words = np.concatenate([words, np.zeros(pad, np.uint8)])
        self.u64(nb)
        self.vec_u64(words.view("<u8"))

    def sparse_vector(self, positions: np.ndarray, universe: int):
        positions = np.asarray(positions, np.int64)
        ones = len(positions)
        import math

        if ones and universe > ones:
            low_width = max(0, int(math.floor(math.log2(universe / ones))))
        else:
            low_width = 0
        lows = positions & ((1 << low_width) - 1) if low_width else \
            np.zeros(ones, np.int64)
        highs = (positions >> low_width) + np.arange(ones)
        nb = int(highs[-1]) + 2 if ones else 1
        bits = np.zeros(nb, bool)
        if ones:
            bits[highs] = True
        self.u64(universe)
        self.u64(ones)
        self.bit_vector(bits)
        self.int_vector(lows, max(low_width, 1) if low_width else 1)

    def string_array(self, strings: Sequence[str]):
        text = "".join(strings)
        starts = np.zeros(len(strings), np.int64)
        np.cumsum([len(s) for s in strings[:-1]], out=starts[1:] if
                  len(strings) > 1 else np.zeros(0, np.int64))
        alphabet = sorted(set(text))
        amap = {c: i for i, c in enumerate(alphabet)}
        self.sparse_vector(starts, len(text) + 1)
        self.vec_u8("".join(alphabet).encode())
        syms = np.array([amap[c] for c in text], np.uint64)
        width = max((len(alphabet) - 1).bit_length(), 1)
        self.int_vector(syms, width)

    def dictionary(self, strings: Sequence[str]):
        self.string_array(strings)
        order = np.argsort(np.array(strings, dtype=object))
        self.int_vector(np.asarray(order, np.uint64),
                        max((max(len(strings) - 1, 0)).bit_length(), 1))

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


# ------------------------------------------------------------ GBWT build

def _co_lex_ranks(seqs: List[List[int]]) -> List[np.ndarray]:
    """Per-sequence arrays of global co-lex ranks for each prefix end.

    Equivalent to the suffix array of the reversed sequences with unique
    end-markers ordering identical prefixes by sequence id."""
    # build the reversed concatenation: for seq s: reversed walk + marker
    # marker value = (1, s) sorts below all nodes and by seq id
    items = []   # (key_primary, pos_id)
    pos_meta = []  # (seq, idx) for each concatenated position
    text = []
    for s, walk in enumerate(seqs):
        for x in reversed(walk):
            text.append((2, int(x)))
        text.append((1, s))
    n = len(text)
    # initial rank by the symbol itself
    order = sorted(range(n), key=lambda i: text[i])
    rank = np.zeros(n, np.int64)
    r = 0
    for a, b in zip(order[:-1], order[1:]):
        rank[a] = r
        if text[b] != text[a]:
            r += 1
    if n:
        rank[order[-1]] = r
    # prefix doubling over the *following* position in the reversed text
    # (= preceding in original order): suffix array of `text`
    k = 1
    idx = np.arange(n)
    while True:
        nxt = np.where(idx + k < n, rank[np.minimum(idx + k, n - 1)], -1)
        key = rank * (n + 1) + (nxt + 1)
        order2 = np.argsort(key, kind="stable")
        newrank = np.zeros(n, np.int64)
        kv = key[order2]
        newrank[order2] = np.concatenate([[0], np.cumsum(kv[1:] != kv[:-1])])
        if newrank.max() == n - 1 or np.array_equal(newrank, rank):
            rank = newrank
            break
        rank = newrank
        k *= 2
    # map back: position of (seq s, prefix ending at idx i) in text:
    out = []
    pos = 0
    for s, walk in enumerate(seqs):
        L = len(walk)
        # reversed: text[pos + j] corresponds to walk[L-1-j]
        rr = np.zeros(L, np.int64)
        for i in range(L):
            rr[i] = rank[pos + (L - 1 - i)]
        out.append(rr)
        pos += L + 1
    return out


def build_gbwt_records(seqs: List[List[int]], alphabet_size: int):
    """Returns (records, offset): records[node] = (outgoing edges
    [(succ, base)], body values list). Sequences are GBWT-node walks."""
    ranks = _co_lex_ranks(seqs)
    # visits per node: (sort_key, successor)
    visits: Dict[int, List[Tuple[int, int]]] = {}
    for s, walk in enumerate(seqs):
        for i, v in enumerate(walk):
            succ = walk[i + 1] if i + 1 < len(walk) else 0
            visits.setdefault(v, []).append((int(ranks[s][i]), succ))
    # endmarker record: sequence starts in seq-id order
    visits[0] = [(s, walk[0] if walk else 0)
                 for s, walk in enumerate(seqs)]

    # counts per (v, w) for edge offsets
    succ_count: Dict[int, Dict[int, int]] = {}
    for v, vs in visits.items():
        for _, w in vs:
            succ_count.setdefault(w, {})[v] = \
                succ_count.setdefault(w, {}).get(v, 0) + 1

    records: Dict[int, Tuple[List[Tuple[int, int]], List[int]]] = {}
    for v, vs in visits.items():
        vs.sort()
        succs = sorted({w for _, w in vs})
        # base for edge v->w: visits of w from predecessors ordered
        # before v (endmarker counts as predecessor 0)
        edges = []
        for w in succs:
            preds = succ_count.get(w, {})
            base = sum(c for u, c in preds.items() if u < v)
            edges.append((w, base))
        emap = {w: i for i, (w, _) in enumerate(edges)}
        body = [emap[w] for _, w in vs]
        records[v] = (edges, body)
    return records


def _encode_byte(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _encode_record(edges: List[Tuple[int, int]], body: List[int]) -> bytes:
    out = bytearray()
    out += _encode_byte(len(edges))
    prev = 0
    for w, base in edges:
        out += _encode_byte(w - prev)
        out += _encode_byte(base)
        prev = w
    sigma = len(edges)
    if sigma == 0:
        return bytes(out)
    i = 0
    if sigma < 255:
        max_len = 256 // sigma
        while i < len(body):
            v = body[i]
            j = i + 1
            while j < len(body) and body[j] == v:
                j += 1
            length = j - i
            while length > 0:
                take = min(length, 1 << 20)
                if take >= max_len:
                    out.append(v + sigma * (max_len - 1))
                    out += _encode_byte(take - max_len)
                else:
                    out.append(v + sigma * (take - 1))
                length -= take
            i = j
    else:
        while i < len(body):
            v = body[i]
            j = i + 1
            while j < len(body) and body[j] == v:
                j += 1
            out += _encode_byte(v)
            out += _encode_byte(j - i - 1)
            i = j
    return bytes(out)


# --------------------------------------------------------------- top level

def write_gbz(path: str, graph, haps) -> None:
    """Serialize an ArrayGraph + HaplotypeSet as a GBZ container."""
    from ..graph.arraygraph import SENSE_REFERENCE

    first_id = int(graph.node_id[0])
    # GBWT node = 2*node_id + orientation; walks from hap steps
    seqs_fwd: List[List[int]] = []
    for h in range(haps.count):
        s0, s1 = int(haps.steps_start[h]), int(haps.steps_start[h + 1])
        walk = []
        for st in haps.steps[s0:s1]:
            st = int(st)
            nid = int(graph.node_id[st >> 1])
            walk.append(2 * nid + (st & 1))
        seqs_fwd.append(walk)
    # bidirectional: interleave forward and reverse sequences
    seqs: List[List[int]] = []
    for walk in seqs_fwd:
        seqs.append(walk)
        seqs.append([x ^ 1 for x in reversed(walk)])

    max_node = int(graph.node_id[-1])
    alphabet_size = 2 * max_node + 2
    offset = 2 * first_id - 1
    records = build_gbwt_records(seqs, alphabet_size)

    w = Writer()
    # GBZ header + tags
    w.u32_pair(GBZ_MAGIC, 1)
    w.u64(0)
    w.string_array(["source", "jltsiren/gbwtgraph"])

    # GBWT header
    total_size = sum(len(s) for s in seqs) + len(seqs)
    w.u32_pair(GBWT_MAGIC, 5)
    w.u64(len(seqs))
    w.u64(total_size)
    w.u64(offset)
    w.u64(alphabet_size)
    w.u64(0x1 | 0x2 | 0x4)      # bidirectional | metadata | simple-sds
    w.string_array(["source", "jltsiren/gbwt"])

    # BWT: records for ids 0 and offset+1..alphabet-1
    n_rec = alphabet_size - offset
    blobs: List[bytes] = []
    for i in range(n_rec):
        node = 0 if i == 0 else offset + i
        rec = records.get(node)
        if rec is None:
            blobs.append(b"")
        else:
            blobs.append(_encode_record(*rec))
    starts = np.zeros(len(blobs), np.int64)
    np.cumsum([len(b) for b in blobs[:-1]],
              out=starts[1:] if len(blobs) > 1 else np.zeros(0, np.int64))
    data = b"".join(blobs)
    w.sparse_vector(starts, len(data) + 1)
    w.vec_u8(data)
    w.option_absent()           # DA samples

    # metadata (Option-wrapped)
    mw = Writer()
    mw.u32_pair(META_MAGIC, 2)
    samples = sorted({m.sample or "_gbwt_ref" for m in haps.metas})
    contigs = sorted({m.contig or m.name for m in haps.metas})
    smap = {s: i for i, s in enumerate(samples)}
    cmap = {c: i for i, c in enumerate(contigs)}
    mw.u64(len(samples))
    mw.u64(haps.count)
    mw.u64(len(contigs))
    mw.u64(0x1 | 0x2 | 0x4)     # path names | sample names | contig names
    mw.u64(haps.count)
    pn = np.zeros(haps.count * 4, np.uint32)
    for i, m in enumerate(haps.metas):
        pn[4 * i + 0] = smap[m.sample or "_gbwt_ref"]
        pn[4 * i + 1] = cmap[m.contig or m.name]
        pn[4 * i + 2] = NO_PHASE if m.is_ref else m.phase
        pn[4 * i + 3] = 0
    mw.words(pn.view("<u8"))
    mw.dictionary(samples)
    mw.dictionary(contigs)
    body = mw.getvalue()
    w.u64(len(body) // 8)
    w.parts.append(body)

    # GBWTGraph: header + sequences + (empty) translation
    w.u32_pair(0x6B3764AF, 3)
    w.u64(graph.node_count)
    w.u64(0x2)                  # matches the reference's writers
    node_seqs = [graph.node_seq(int(nid)) for nid in graph.node_id]
    w.string_array(node_seqs)
    w.string_array([])          # segment translation: absent
    w.sparse_vector(np.zeros(0, np.int64), 1)

    with open(path, "wb") as f:
        f.write(w.getvalue())
