"""CRAM 3.0 writer/reader (surjection output, reference
hts_alignment_emitter.hpp:131-289 emits SAM/BAM/CRAM via htslib).

Spec-faithful subset of the CRAM 3.0 container format (samtools
hts-specs CRAMv3):

- file definition (magic "CRAM", version 3.0, 20-byte file id);
- ITF8/LTF8 variable-length integers;
- containers (header + landmarks + CRC32) holding blocks
  (method raw|gzip, content types FILE_HEADER / COMPRESSION_HEADER /
  MAPPED_SLICE_HEADER / EXTERNAL_DATA / CORE_DATA, per-block CRC32);
- a compression header whose data-series encoding map routes every
  series to an EXTERNAL block (codec 1) or BYTE_ARRAY_STOP (codec 5),
  preservation map RN=true, AP=false (absolute positions), RR=false
  (reference NOT required: records carry their bases);
- one slice per container; records encoded referencelessly with CRAM
  features: S (softclips), b (aligned base stretches), q (qual
  stretches), I (insertions), D (deletions), N (skips — spliced reads)
  so a decoder reconstructs SEQ and CIGAR without the reference.

Validation status: no htslib/pysam/samtools exists in this environment,
so conformance is asserted by structure tests + full round-trips through
this module's own reader (the same standard the GBZ codec was held to
until a reference toolchain is available).

Copied from vg_tpu/io/cram.py.
"""
from __future__ import annotations

import io
import struct
import zlib
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Iterable, List, Optional, Tuple

from .sam import SamRecord

CRAM_MAGIC = b"CRAM"
VERSION = (3, 0)

# block content types (CRAMv3 §8)
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5

# encoding codecs (CRAMv3 §13)
ENC_EXTERNAL = 1
ENC_BYTE_ARRAY_STOP = 5

# data series -> external block content ids (our layout)
SERIES = ["BF", "CF", "RI", "RL", "AP", "RG", "MQ", "FN", "FC", "FP",
          "DL", "NS", "IN", "SC", "BB", "QQ", "RN"]
CID = {name: i + 1 for i, name in enumerate(SERIES)}


# ------------------------------------------------------------- ITF8/LTF8

def write_itf8(out: bytearray, v: int) -> None:
    """CRAM ITF8: int32 in 1-5 bytes, prefix bits give the length."""
    v &= 0xFFFFFFFF
    if v < 0x80:
        out.append(v)
    elif v < 0x4000:
        out += bytes([(v >> 8) | 0x80, v & 0xFF])
    elif v < 0x200000:
        out += bytes([(v >> 16) | 0xC0, (v >> 8) & 0xFF, v & 0xFF])
    elif v < 0x10000000:
        out += bytes([(v >> 24) | 0xE0, (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    else:
        out += bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                      (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def read_itf8(buf: memoryview, pos: int) -> Tuple[int, int]:
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | buf[pos + 1], pos + 2
    if b0 < 0xE0:
        return (((b0 & 0x3F) << 16) | (buf[pos + 1] << 8)
                | buf[pos + 2]), pos + 3
    if b0 < 0xF0:
        return (((b0 & 0x1F) << 24) | (buf[pos + 1] << 16)
                | (buf[pos + 2] << 8) | buf[pos + 3]), pos + 4
    v = (((b0 & 0x0F) << 28) | (buf[pos + 1] << 20) | (buf[pos + 2] << 12)
         | (buf[pos + 3] << 4) | (buf[pos + 4] & 0x0F))
    return v, pos + 5


def write_ltf8(out: bytearray, v: int) -> None:
    """CRAM LTF8: int64, unary length prefix."""
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        out.append(v)
        return
    n = 1
    while n < 8 and v >= (1 << (7 * (n + 1) - n)):
        n += 1
    if n >= 8 or v >= (1 << 56):
        out.append(0xFF)
        out += v.to_bytes(8, "big")
        return
    prefix = (0xFF << (8 - n)) & 0xFF
    body = v.to_bytes(n + 1, "big")
    out.append(prefix | body[0])
    out += body[1:]


def read_ltf8(buf: memoryview, pos: int) -> Tuple[int, int]:
    b0 = buf[pos]
    n = 0
    while n < 8 and (b0 << n) & 0x80:
        n += 1
    if n == 8:
        return int.from_bytes(buf[pos + 1 : pos + 9], "big"), pos + 9
    mask = 0xFF >> n
    v = b0 & mask
    for i in range(n):
        v = (v << 8) | buf[pos + 1 + i]
    return v, pos + 1 + n


# ------------------------------------------------------------ block layer

def _write_block(out: bytearray, content_type: int, content_id: int,
                 data: bytes, compress: bool = True) -> None:
    raw_size = len(data)
    method = 0
    if compress and raw_size > 64:
        z = zlib.compress(data, 6)
        if len(z) < raw_size:
            data, method = z, 1
    blk = bytearray()
    blk.append(method)
    blk.append(content_type)
    write_itf8(blk, content_id)
    write_itf8(blk, len(data))
    write_itf8(blk, raw_size)
    blk += data
    blk += struct.pack("<I", zlib.crc32(bytes(blk)) & 0xFFFFFFFF)
    out += blk


def _read_block(buf: memoryview, pos: int):
    start = pos
    method = buf[pos]
    ctype = buf[pos + 1]
    pos += 2
    cid, pos = read_itf8(buf, pos)
    csize, pos = read_itf8(buf, pos)
    rsize, pos = read_itf8(buf, pos)
    data = bytes(buf[pos : pos + csize])
    pos += csize
    crc = struct.unpack("<I", buf[pos : pos + 4])[0]
    if zlib.crc32(bytes(buf[start:pos])) & 0xFFFFFFFF != crc:
        raise ValueError("CRAM block CRC mismatch")
    pos += 4
    if method == 1:
        data = zlib.decompress(data)
    elif method != 0:
        raise ValueError(f"unsupported CRAM compression method {method}")
    if len(data) != rsize:
        raise ValueError("CRAM block size mismatch")
    return ctype, cid, data, pos


def _write_container(out: bytearray, ref_id: int, start: int, span: int,
                     n_records: int, counter: int, bases: int,
                     blocks: List[bytes]) -> None:
    body = bytearray()
    landmarks = []
    for b in blocks:
        landmarks.append(len(body))
        body += b
    hdr = bytearray()
    write_itf8(hdr, ref_id & 0xFFFFFFFF)
    write_itf8(hdr, start)
    write_itf8(hdr, span)
    write_itf8(hdr, n_records)
    write_ltf8(hdr, counter)
    write_ltf8(hdr, bases)
    write_itf8(hdr, len(blocks))
    write_itf8(hdr, len(landmarks))
    for lm in landmarks:
        write_itf8(hdr, lm)
    full = bytearray()
    full += struct.pack("<i", len(body))
    full += hdr
    full += struct.pack("<I", zlib.crc32(bytes(full)) & 0xFFFFFFFF)
    full += body
    out += full


def _read_container(buf: memoryview, pos: int):
    length = struct.unpack("<i", buf[pos : pos + 4])[0]
    p = pos + 4
    ref_id, p = read_itf8(buf, p)
    start, p = read_itf8(buf, p)
    span, p = read_itf8(buf, p)
    n_records, p = read_itf8(buf, p)
    counter, p = read_ltf8(buf, p)
    bases, p = read_ltf8(buf, p)
    n_blocks, p = read_itf8(buf, p)
    n_land, p = read_itf8(buf, p)
    for _ in range(n_land):
        _, p = read_itf8(buf, p)
    p += 4   # header CRC
    body_end = p + length
    blocks = []
    while p < body_end:
        ctype, cid, data, p = _read_block(buf, p)
        blocks.append((ctype, cid, data))
    return (ref_id, start, span, n_records, blocks), body_end


# ------------------------------------------------- compression header

def _encoding_external(cid: int) -> bytes:
    out = bytearray()
    write_itf8(out, ENC_EXTERNAL)
    sub = bytearray()
    write_itf8(sub, cid)
    write_itf8(out, len(sub))
    out += sub
    return bytes(out)


def _encoding_bas(cid: int, stop: int) -> bytes:
    out = bytearray()
    write_itf8(out, ENC_BYTE_ARRAY_STOP)
    sub = bytearray()
    sub.append(stop)
    write_itf8(sub, cid)
    write_itf8(out, len(sub))
    out += sub
    return bytes(out)


def _compression_header() -> bytes:
    # preservation map: RN preserved, AP absolute, RR false (no ref)
    pmap = bytearray()
    write_itf8(pmap, 3)
    pmap += b"RN\x01" + b"AP\x00" + b"RR\x00"
    pm = bytearray()
    write_itf8(pm, len(pmap))
    pm += pmap
    # data series encoding map
    entries = []
    for name in SERIES:
        if name == "RN":
            enc = _encoding_bas(CID[name], 0)
        else:
            enc = _encoding_external(CID[name])
        e = bytearray(name.encode())
        e += enc
        entries.append(bytes(e))
    dmap = bytearray()
    write_itf8(dmap, len(entries))
    for e in entries:
        dmap += e
    dm = bytearray()
    write_itf8(dm, len(dmap))
    dm += dmap
    # tag encoding map: empty
    tmap = bytearray()
    write_itf8(tmap, 0)
    tm = bytearray()
    write_itf8(tm, len(tmap))
    tm += tmap
    return bytes(pm + dm + tm)


def _parse_map(buf: memoryview, pos: int):
    size, pos = read_itf8(buf, pos)
    return pos, pos + size


# --------------------------------------------------------------- writer

class CramWriter:
    """Streaming CRAM writer over SamRecords (one slice per container)."""

    def __init__(self, fileobj: BinaryIO, header_lines: List[str],
                 ref_names: List[str]):
        self.f = fileobj
        self.ref_index = {n: i for i, n in enumerate(ref_names)}
        self.counter = 0
        out = bytearray()
        out += CRAM_MAGIC
        out += bytes([VERSION[0], VERSION[1]])
        out += b"vg_tpu.cram".ljust(20, b"\x00")[:20]
        # SAM header container
        text = ("\n".join(header_lines) + "\n").encode()
        hdata = struct.pack("<i", len(text)) + text
        hblk = bytearray()
        _write_block(hblk, CT_FILE_HEADER, 0, hdata)
        _write_container(out, 0, 0, 0, 0, 0, 0, [bytes(hblk)])
        self.f.write(bytes(out))

    def write_batch(self, recs: List[SamRecord]) -> None:
        if not recs:
            return
        cols: Dict[str, bytearray] = {n: bytearray() for n in SERIES}

        def put_i(name, v):
            write_itf8(cols[name], v & 0xFFFFFFFF)

        n_bases = 0
        ref_ids = set()
        starts = []
        ends = []
        for r in recs:
            unmapped = bool(r.flag & 0x4)
            ri = -1 if unmapped or r.rname in ("*", "") else \
                self.ref_index.get(r.rname, -1)
            seq = r.seq if r.seq != "*" else ""
            qual = r.qual if r.qual != "*" else ""
            put_i("BF", r.flag)
            put_i("CF", 3)          # detached, no mate downstream
            put_i("RI", ri)
            put_i("RL", len(seq))
            put_i("AP", max(r.pos - 1, 0) if not unmapped else 0)
            put_i("RG", -1)
            put_i("MQ", r.mapq)
            cols["RN"] += r.qname.encode() + b"\x00"
            n_bases += len(seq)
            if ri >= 0:
                ref_ids.add(ri)
                starts.append(r.pos)
            # features from the CIGAR, referenceless: aligned stretches
            # carry their bases (b) and quals (q via QQ series)
            feats = []
            rp = 0
            from ..surject.surjector import _parse_cigar

            ops = _parse_cigar(r.cigar) if r.cigar not in ("*", "") else []
            fpos = 0          # 1-based read position of each feature
            for opc, n in ops:
                if opc == "S":
                    feats.append((b"S", rp + 1, seq[rp : rp + n].encode()))
                    rp += n
                elif opc in ("M", "X", "="):
                    feats.append((b"b", rp + 1, seq[rp : rp + n].encode()))
                    if qual:
                        cols["QQ"] += bytes(
                            (ord(c) - 33) & 0xFF
                            for c in qual[rp : rp + n])
                    rp += n
                elif opc == "I":
                    feats.append((b"I", rp + 1, seq[rp : rp + n].encode()))
                    rp += n
                elif opc == "D":
                    feats.append((b"D", rp + 1, n))
                elif opc == "N":
                    feats.append((b"N", rp + 1, n))
                elif opc == "H":
                    pass
            if not ops and seq:
                feats.append((b"b", 1, seq.encode()))
            put_i("FN", len(feats))
            prev = 0
            for code, pos1, payload in feats:
                cols["FC"] += code
                put_i("FP", pos1 - prev)
                prev = pos1
                if code == b"D":
                    put_i("DL", payload)
                elif code == b"N":
                    put_i("NS", payload)
                elif code == b"I":
                    put_i("IN", len(payload))
                    cols["BB"] += payload
                elif code == b"S":
                    put_i("SC", len(payload))
                    cols["BB"] += payload
                elif code == b"b":
                    put_i("IN", len(payload))   # shared length series
                    cols["BB"] += payload
            if ri >= 0:
                ends.append(r.pos + sum(
                    n for opc, n in ops if opc in "MDN=X"))

        ref_id = ref_ids.pop() if len(ref_ids) == 1 else -2  # -2 multiref
        start = min(starts) if starts and ref_id >= 0 else 0
        span = (max(ends) - start) if ends and ref_id >= 0 else 0

        blocks: List[bytes] = []
        ch = bytearray()
        _write_block(ch, CT_COMPRESSION_HEADER, 0, _compression_header())
        blocks.append(bytes(ch))
        # slice header
        ext_ids = [CID[n] for n in SERIES if cols[n]]
        sh = bytearray()
        write_itf8(sh, ref_id & 0xFFFFFFFF)
        write_itf8(sh, start)
        write_itf8(sh, span)
        write_itf8(sh, len(recs))
        write_ltf8(sh, self.counter)
        write_itf8(sh, 1 + len(ext_ids))   # core + externals
        write_itf8(sh, len(ext_ids))
        for cid in ext_ids:
            write_itf8(sh, cid)
        write_itf8(sh, -1 & 0xFFFFFFFF)    # no embedded reference
        sh += bytes(16)                    # MD5 (unset)
        shb = bytearray()
        _write_block(shb, CT_SLICE_HEADER, 0, bytes(sh))
        blocks.append(bytes(shb))
        core = bytearray()
        _write_block(core, CT_CORE, 0, b"")
        blocks.append(bytes(core))
        for name in SERIES:
            if cols[name]:
                eb = bytearray()
                _write_block(eb, CT_EXTERNAL, CID[name], bytes(cols[name]))
                blocks.append(bytes(eb))
        out = bytearray()
        _write_container(out, ref_id, start, span, len(recs),
                         self.counter, n_bases, blocks)
        self.counter += len(recs)
        self.f.write(bytes(out))

    # the spec's canonical 38-byte v3 EOF container (CRAMv3 §9; the
    # constant every reader byte-compares against): an empty container
    # at ref -1, start 0x454F46 ("EOF"), holding one empty
    # COMPRESSION_HEADER block, with the blessed CRC32s
    EOF_V3 = bytes.fromhex(
        "0f000000ffffffff0fe045" "4f4600000000010005bdd94f"
        "0001000606010001000100" "ee63014b")

    def close(self) -> None:
        self.f.write(self.EOF_V3)


# --------------------------------------------------------------- reader

def read_cram(data: bytes, ref_names: Optional[List[str]] = None
              ) -> Tuple[List[str], List[SamRecord]]:
    """Decode a CRAM produced by CramWriter: (header lines, records)."""
    buf = memoryview(data)
    if bytes(buf[:4]) != CRAM_MAGIC:
        raise ValueError("not a CRAM file")
    pos = 26
    (_, _, _, _, blocks), pos = _read_container(buf, pos)
    htext = blocks[0][2]
    hlen = struct.unpack("<i", htext[:4])[0]
    header_lines = htext[4 : 4 + hlen].decode().strip("\n").split("\n")
    refs = ref_names
    if refs is None:
        refs = [ln.split("\tSN:")[1].split("\t")[0]
                for ln in header_lines if ln.startswith("@SQ")]
    records: List[SamRecord] = []
    while pos < len(buf):
        if bytes(buf[pos:]) == CramWriter.EOF_V3:
            break
        (ref_id, start, span, n_rec, blocks), pos = _read_container(buf, pos)
        if n_rec == 0:
            if start == 0x454F46:
                break
            continue
        ext = {cid: data for ctype, cid, data in blocks
               if ctype == CT_EXTERNAL}
        cur = {name: 0 for name in SERIES}

        def get_i(name):
            v, cur[name] = read_itf8(memoryview(ext[CID[name]]), cur[name])
            return v

        for _ in range(n_rec):
            r = SamRecord()
            bf = get_i("BF")
            get_i("CF")
            ri = get_i("RI")
            if ri >= (1 << 31):
                ri -= 1 << 32
            rl = get_i("RL")
            ap = get_i("AP")
            get_i("RG")
            mq = get_i("MQ")
            rn = ext[CID["RN"]]
            end = rn.index(0, cur["RN"])
            r.qname = rn[cur["RN"] : end].decode()
            cur["RN"] = end + 1
            r.flag = bf
            r.mapq = mq
            r.rname = refs[ri] if 0 <= ri < len(refs) else "*"
            r.pos = ap + 1 if ri >= 0 else 0
            fn = get_i("FN")
            seq = bytearray()
            quals = bytearray()
            ops: List[Tuple[str, int]] = []
            fc = ext[CID["FC"]]
            for _f in range(fn):
                code = chr(fc[cur["FC"]])
                cur["FC"] += 1
                get_i("FP")
                if code == "D":
                    ops.append(("D", get_i("DL")))
                elif code == "N":
                    ops.append(("N", get_i("NS")))
                elif code in ("I", "b"):
                    n = get_i("IN")
                    bb = ext[CID["BB"]]
                    frag = bb[cur["BB"] : cur["BB"] + n]
                    cur["BB"] += n
                    seq += frag
                    ops.append(("I" if code == "I" else "M", n))
                    if code == "b" and CID["QQ"] in ext:
                        qq = ext[CID["QQ"]]
                        quals += bytes(
                            q + 33 for q in qq[cur["QQ"] : cur["QQ"] + n])
                        cur["QQ"] += n
                elif code == "S":
                    n = get_i("SC")
                    bb = ext[CID["BB"]]
                    seq += bb[cur["BB"] : cur["BB"] + n]
                    cur["BB"] += n
                    ops.append(("S", n))
            r.seq = seq.decode() if seq else "*"
            r.qual = quals.decode() if quals else "*"
            from .sam import cigar_str

            r.cigar = cigar_str(ops) if ops and not (bf & 0x4) else "*"
            assert rl == 0 or len(seq) in (rl, 0)
            records.append(r)
    return header_lines, records


def write_cram(fileobj: BinaryIO, header_lines: List[str],
               ref_names: List[str], recs: Iterable[SamRecord],
               batch: int = 4096) -> None:
    w = CramWriter(fileobj, header_lines, ref_names)
    buf: List[SamRecord] = []
    for r in recs:
        buf.append(r)
        if len(buf) >= batch:
            w.write_batch(buf)
            buf = []
    w.write_batch(buf)
    w.close()
