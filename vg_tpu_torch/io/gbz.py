"""GBZ reader: load GBWT + GBWTGraph containers into vg_tpu structures.

Reference: GBZ is the reference's primary index interchange format — a
simple-sds serialized container holding a GBWT (haplotype FM-index) and a
GBWTGraph (topology + sequences induced by the GBWT); see SURVEY.md
Appendix C and the loader registry (src/io/register_loader_saver_gbz.cpp).

This reader decodes the simple-sds wire format (little-endian 8-byte
words) directly:

- Vec<u64>: count + words; Vec<u8>: count + padded bytes
- RawVector: bit-length + Vec<u64>
- BitVector: RawVector + 3 optional support structures (each: word count
  + body, 0 = absent)
- IntVector: item count + width + RawVector (LSB-first packing)
- SparseVector (Elias-Fano): universe + ones + high BitVector + low
  IntVector
- StringArray: index SparseVector (string start offsets) + sorted
  alphabet Vec<u8> + packed symbol IntVector
- GBWT: header + tags + BWT (record-offset SparseVector + byte-coded
  records: outdegree, delta-coded outgoing edges, run-length encoded
  body) + optional DA samples + optional metadata (path/sample/contig
  names)
- GBWTGraph: header + sequences StringArray + optional segment
  translation

Paths are extracted by LF-walking each sequence from the endmarker, which
yields the haplotype walks vg_tpu's HaplotypeSet wants; node sequences
come from the GBWTGraph's StringArray.

Copied from vg_tpu/io/gbz.py.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

GBZ_MAGIC = 0x205A4247      # "GBZ "
GBWT_MAGIC = 0x6B376B37     # "7k7k"


class Cursor:
    def __init__(self, data: bytes, off: int = 0):
        self.data = data
        self.off = off

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.off)[0]
        self.off += 8
        return v

    def u32_pair(self) -> Tuple[int, int]:
        a, b = struct.unpack_from("<II", self.data, self.off)
        self.off += 8
        return a, b

    def words(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.data, dtype="<u8", count=n, offset=self.off)
        self.off += 8 * n
        return out

    def vec_u64(self) -> np.ndarray:
        n = self.u64()
        return self.words(n)

    def vec_u8(self) -> np.ndarray:
        n = self.u64()
        nwords = (n + 7) // 8
        out = np.frombuffer(self.data, dtype=np.uint8, count=n,
                            offset=self.off)
        self.off += 8 * nwords
        return out

    def raw_vector(self) -> Tuple[int, np.ndarray]:
        bits = self.u64()
        words = self.vec_u64()
        return bits, words

    def skip_option(self) -> None:
        n = self.u64()
        self.off += 8 * n

    def bit_vector(self) -> Tuple[int, np.ndarray]:
        bits, words = self.raw_vector()
        self.skip_option()      # rank support
        self.skip_option()      # select support
        self.skip_option()      # select0 support
        return bits, words

    def int_vector(self) -> np.ndarray:
        return self.int_vector_w()[0]

    def int_vector_w(self) -> Tuple[np.ndarray, int]:
        """IntVector decode returning (values, stored bit width)."""
        n = self.u64()
        width = self.u64()
        bits, words = self.raw_vector()
        return _unpack_ints(words, n, width), int(width)

    def sparse_vector(self) -> np.ndarray:
        """Returns the sorted positions of the ones.

        Elias-Fano reconstruction uses the *stored* width of the low
        IntVector as the shift (a writer may legally pick a different
        split than floor(log2(universe/ones)); simple-sds readers must
        honor what is serialized)."""
        universe = self.u64()
        ones = self.u64()
        hbits, hwords = self.bit_vector()
        lows, low_width = self.int_vector_w()
        if ones == 0:
            return np.zeros(0, np.int64)
        highs = _bit_positions(hwords, hbits)
        assert len(highs) == ones, (len(highs), ones)
        vals = ((highs - np.arange(ones)) << low_width) + lows[:ones]
        return vals.astype(np.int64)

    def string_array(self) -> List[str]:
        starts = self.sparse_vector()
        alphabet = bytes(self.vec_u8())
        syms = self.int_vector()
        text = "".join(chr(alphabet[s]) for s in syms)
        out = []
        for i, s in enumerate(starts):
            e = starts[i + 1] if i + 1 < len(starts) else len(text)
            out.append(text[int(s) : int(e)])
        return out


def _unpack_ints(words: np.ndarray, n: int, width: int) -> np.ndarray:
    if n == 0 or width == 0:
        return np.zeros(n, np.int64)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    need = n * width
    bits = bits[:need].reshape(n, width).astype(np.int64)
    weights = (1 << np.arange(width, dtype=np.int64))
    return bits @ weights


def _bit_positions(words: np.ndarray, nbits: int) -> np.ndarray:
    if len(words) == 0:
        return np.zeros(0, np.int64)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:nbits]
    return np.nonzero(bits)[0].astype(np.int64)


def _low_width(universe: int, ones: int) -> int:
    if ones == 0 or universe <= ones:
        return 0
    import math

    return max(0, int(math.floor(math.log2(universe / ones))))


# ------------------------------------------------------------------ GBWT

@dataclass
class GBWTRecord:
    outgoing: List[Tuple[int, int]]     # (successor node, rank offset)
    body: bytes                         # run-encoded BWT section


class GBWT:
    def __init__(self):
        self.sequences = 0
        self.alphabet_size = 0
        self.offset = 0
        self.flags = 0
        self.records: Dict[int, GBWTRecord] = {}
        self.tags: Dict[str, str] = {}
        self.path_names: List[Tuple[int, int, int, int]] = []
        self.sample_names: List[str] = []
        self.contig_names: List[str] = []

    # -- record decoding ---------------------------------------------------

    @staticmethod
    def _byte_code(data: bytes, pos: int) -> Tuple[int, int]:
        value = 0
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            value |= (b & 0x7F) << shift
            if not (b & 0x80):
                return value, pos
            shift += 7

    def _decode_record(self, node: int, data: bytes) -> GBWTRecord:
        pos = 0
        sigma, pos = self._byte_code(data, pos)
        outgoing = []
        prev = 0
        for i in range(sigma):
            diff, pos = self._byte_code(data, pos)
            off, pos = self._byte_code(data, pos)
            succ = prev + diff
            outgoing.append((succ, off))
            prev = succ
        return GBWTRecord(outgoing=outgoing, body=data[pos:])

    @staticmethod
    def _runs(record: GBWTRecord):
        """Yield (value, length) runs from the record body (gbwt Run
        encoding: short runs packed into one byte when sigma is small)."""
        data = record.body
        sigma = len(record.outgoing)
        pos = 0
        n = len(data)
        if sigma == 0:
            return
        if sigma < 255:
            max_len = 256 // sigma
            while pos < n:
                c = data[pos]
                pos += 1
                value = c % sigma
                length = c // sigma + 1
                if length == max_len:
                    extra, pos = GBWT._byte_code(data, pos)
                    length += extra
                yield value, length
        else:
            while pos < n:
                value, pos = GBWT._byte_code(data, pos)
                length, pos = GBWT._byte_code(data, pos)
                yield value, length + 1

    def lf(self, node: int, offset: int) -> Tuple[int, int]:
        """One LF step: position `offset` in node's record -> (successor
        node, offset in successor)."""
        rec = self.records[node]
        seen = [0] * len(rec.outgoing)
        covered = 0
        for value, length in self._runs(rec):
            if covered + length > offset:
                succ, base = rec.outgoing[value]
                return succ, base + seen[value] + (offset - covered)
            seen[value] += length
            covered += length
        raise IndexError(f"offset {offset} beyond record of node {node}")

    def extract(self, seq_id: int) -> List[int]:
        """Extract sequence seq_id as a list of GBWT node ids."""
        out = []
        node, off = self.lf(0, seq_id)      # endmarker record starts paths
        while node != 0:
            out.append(node)
            node, off = self.lf(node, off)
        return out


def _parse_gbwt(cur: Cursor) -> GBWT:
    tag, version = cur.u32_pair()
    assert tag == GBWT_MAGIC, f"bad GBWT magic {tag:#x}"
    g = GBWT()
    g.sequences = cur.u64()
    size = cur.u64()
    g.offset = cur.u64()
    g.alphabet_size = cur.u64()
    g.flags = cur.u64()
    tags = cur.string_array()
    g.tags = dict(zip(tags[::2], tags[1::2]))
    # BWT: record start offsets + data bytes
    starts = cur.sparse_vector()
    data = bytes(cur.vec_u8())
    n_rec = len(starts)
    for i in range(n_rec):
        s = int(starts[i])
        e = int(starts[i + 1]) if i + 1 < n_rec else len(data)
        node = i + (g.offset if i > 0 else 0)
        if i == 0:
            node = 0
        else:
            node = g.offset + i
        if e > s:
            g.records[node] = g._decode_record(node, data[s:e])
    cur.skip_option()                   # document array samples
    meta_words = cur.u64()              # metadata is Option-wrapped
    if meta_words:
        end = cur.off + 8 * meta_words
        _parse_metadata(cur, g)
        cur.off = end
    return g


def _parse_metadata(cur: Cursor, g: GBWT) -> None:
    tag, version = cur.u32_pair()       # 0x6B375E7A
    g.meta_counts = (cur.u64(), cur.u64(), cur.u64())  # samples, haps, contigs
    flags = cur.u64()
    if flags & 0x0001:                  # path names
        # Vec<PathName>: element count, then 2 words per name
        # (sample u32, contig u32, phase u32, count u32)
        n = cur.u64()
        raw = cur.words(2 * n)
        pn = raw.view("<u4").reshape(-1, 4)
        g.path_names = [tuple(int(x) for x in row) for row in pn]
    if flags & 0x0002:                  # sample names (Dictionary)
        g.sample_names = cur.string_array()
        cur.int_vector()                # sorted-id permutation
    if flags & 0x0004:                  # contig names (Dictionary)
        g.contig_names = cur.string_array()
        cur.int_vector()


# -------------------------------------------------------------- GBWTGraph

def _parse_graph(cur: Cursor):
    tag, version = cur.u32_pair()
    nodes = cur.u64()
    flags = cur.u64()
    sequences = cur.string_array()
    translation = None
    if flags & 0x0002:                  # node-to-segment translation
        segments = cur.string_array()
        mapping = cur.sparse_vector()
        translation = (segments, mapping)
    return nodes, sequences, translation


# ------------------------------------------------------------------ GBZ

@dataclass
class GBZ:
    gbwt: GBWT
    node_count: int
    sequences: List[str]                # forward sequence per graph node
    tags: Dict[str, str]

    def min_node_id(self) -> int:
        return self.gbwt.offset // 2 if self.gbwt.offset % 2 == 0 \
            else (self.gbwt.offset + 1) // 2


def read_gbz(path: str) -> GBZ:
    data = open(path, "rb").read()
    cur = Cursor(data)
    tag, version = cur.u32_pair()
    assert tag == GBZ_MAGIC, f"not a GBZ file: magic {tag:#x}"
    cur.u64()                           # flags
    tags = cur.string_array()
    gbwt = _parse_gbwt(cur)
    nodes, sequences, translation = _parse_graph(cur)
    return GBZ(gbwt=gbwt, node_count=nodes, sequences=sequences,
               tags=dict(zip(tags[::2], tags[1::2])))


def gbz_to_graph(gbz: GBZ):
    """GBZ -> (ArrayGraph, HaplotypeSet): nodes/edges/paths from the
    GBWTGraph + haplotype walks extracted from the GBWT."""
    from ..graph.arraygraph import (SENSE_HAPLOTYPE, SENSE_REFERENCE,
                                    GraphBuilder)
    from ..index.haplotypes import HaplotypeMeta, HaplotypeSet

    g = gbz.gbwt
    first_node = (g.offset + 1) // 2
    b = GraphBuilder()
    for i, seq in enumerate(gbz.sequences):
        if seq:
            b.add_node(seq, node_id=first_node + i)

    def gbwt_to_handle_pair(x: int) -> Tuple[int, bool]:
        return x // 2, bool(x & 1)

    walks_nodes: List[List[Tuple[int, bool]]] = []
    metas: List[HaplotypeMeta] = []
    # forward sequences only (even ids in bidirectional GBWT)
    for sid in range(0, g.sequences, 2 if g.flags & 0x0001 else 1):
        walk = g.extract(sid)
        steps = [gbwt_to_handle_pair(x) for x in walk]
        pi = sid // 2 if g.flags & 0x0001 else sid
        NO_PHASE = 0xFFFFFFFF
        ref_samples = set((g.tags.get("reference_samples") or "").split())
        if g.path_names and pi < len(g.path_names):
            s_i, c_i, phase, count = g.path_names[pi]
            sample = (g.sample_names[s_i] if s_i < len(g.sample_names)
                      else str(s_i))
            contig = (g.contig_names[c_i] if c_i < len(g.contig_names)
                      else str(c_i))
            is_ref = sample == "_gbwt_ref" or sample in ref_samples
            if phase == NO_PHASE:
                phase = 0
            # reference-sense paths surface under the plain contig name
            # (vg's PathSense conventions for GBZ-embedded references)
            name = contig if is_ref else f"{sample}#{phase}#{contig}"
        else:
            sample, contig, phase, name, is_ref = "", "", 0, f"path{pi}", False
        metas.append(HaplotypeMeta(name, sample=sample, phase=phase,
                                   contig=contig, is_ref=is_ref))
        walks_nodes.append(steps)
        for (n1, r1), (n2, r2) in zip(steps[:-1], steps[1:]):
            b.add_edge(n1, n2, r1, r2)
        if steps:
            b.add_path(name, steps,
                       SENSE_REFERENCE if is_ref else SENSE_HAPLOTYPE,
                       sample=sample, locus=contig, haplotype=phase)
    graph = b.freeze()
    walks = [np.array([graph.handle(n, r) for n, r in steps], np.int64)
             for steps in walks_nodes]
    haps = HaplotypeSet(graph, metas, walks)
    return graph, haps
