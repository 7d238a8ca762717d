"""BAM binary read/write (htslib role for alignment output, reference:
HTSWriter src/hts_alignment_emitter.cpp — here implemented directly per
the SAMv1/BAM spec over our BGZF layer; reader and writer are mutually
validating since no htslib is vendored).

Copied from vg_tpu/io/bam.py.
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Iterable, List, Optional, Sequence, Tuple

from . import bgzf
from .sam import SamRecord, cigar_ops

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_NIBBLE_SEQ = "=ACMGRSVTWYHKDBN"


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _ref_span(cigar: str) -> int:
    total = 0
    for op, n in cigar_ops(cigar) if cigar != "*" else []:
        if op in "MDN=X":
            total += n
    return total


def write_bam(fileobj: BinaryIO, header_lines: Sequence[str],
              ref_lengths: Sequence[Tuple[str, int]],
              records: Iterable[SamRecord]) -> None:
    w = bgzf.BGZFWriter(fileobj)
    text = ("\n".join(header_lines) + "\n").encode()
    out = bytearray()
    out += b"BAM\x01"
    out += struct.pack("<i", len(text))
    out += text
    out += struct.pack("<i", len(ref_lengths))
    ref_id = {}
    for i, (name, ln) in enumerate(ref_lengths):
        nb = name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        ref_id[name] = i
    w.write(bytes(out))

    for r in records:
        body = bytearray()
        rid = ref_id.get(r.rname, -1)
        pos0 = r.pos - 1 if r.pos else -1
        name = (r.qname or "*").encode() + b"\x00"
        cig = list(cigar_ops(r.cigar)) if r.cigar != "*" else []
        seq = r.seq if r.seq != "*" else ""
        span = max(_ref_span(r.cigar), 1)
        nrid = ref_id.get(r.rnext if r.rnext != "=" else r.rname, -1)
        body += struct.pack(
            "<iiBBHHHiii", rid, pos0, len(name), r.mapq,
            _reg2bin(max(pos0, 0), max(pos0, 0) + span),
            len(cig), r.flag, len(seq), nrid,
            (r.pnext - 1 if r.pnext else -1))
        body += struct.pack("<i", r.tlen)
        body += name
        for op, n in cig:
            body += struct.pack("<I", (n << 4) | _CIGAR_OPS.index(op))
        for i in range(0, len(seq), 2):
            hi = _SEQ_NIBBLE.get(seq[i].upper(), 15) << 4
            lo = _SEQ_NIBBLE.get(seq[i + 1].upper(), 15) \
                if i + 1 < len(seq) else 0
            body += bytes([hi | lo])
        if r.qual != "*" and len(r.qual) == len(seq):
            body += bytes((ord(c) - 33) for c in r.qual)
        else:
            body += b"\xff" * len(seq)
        for tname, typ, val in r.tags:
            if typ == "i":
                body += tname.encode() + b"i" + struct.pack("<i", int(val))
            elif typ == "f":
                body += tname.encode() + b"f" + struct.pack("<f", float(val))
            else:
                body += tname.encode() + b"Z" + str(val).encode() + b"\x00"
        w.write(struct.pack("<i", len(body)) + bytes(body))
    w.close()


def read_bam(path_or_file) -> Tuple[List[str], List[Tuple[str, int]],
                                    List[SamRecord]]:
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "rb") as f:
            data = f.read()
    raw = bgzf.decompress(data)
    assert raw[:4] == b"BAM\x01", "not a BAM file"
    pos = 4
    (l_text,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    header = raw[pos : pos + l_text].decode().rstrip("\n").split("\n")
    pos += l_text
    (n_ref,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    refs: List[Tuple[str, int]] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        name = raw[pos : pos + l_name - 1].decode()
        pos += l_name
        (l_ref,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        refs.append((name, l_ref))
    records: List[SamRecord] = []
    while pos < len(raw):
        (block,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        end = pos + block
        (rid, pos0, l_name, mapq, _bin, n_cig, flag, l_seq, nrid,
         npos) = struct.unpack_from("<iiBBHHHiii", raw, pos)
        pos += 28
        (tlen,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        qname = raw[pos : pos + l_name - 1].decode()
        pos += l_name
        cig = []
        for _ in range(n_cig):
            (v,) = struct.unpack_from("<I", raw, pos)
            pos += 4
            cig.append(f"{v >> 4}{_CIGAR_OPS[v & 0xF]}")
        nb = (l_seq + 1) // 2
        seq_chars = []
        for i in range(l_seq):
            b = raw[pos + i // 2]
            nib = (b >> 4) if i % 2 == 0 else (b & 0xF)
            seq_chars.append(_NIBBLE_SEQ[nib])
        pos += nb
        qual = raw[pos : pos + l_seq]
        pos += l_seq
        tags = []
        while pos < end:
            tname = raw[pos : pos + 2].decode()
            typ = chr(raw[pos + 2])
            pos += 3
            if typ == "i":
                (v,) = struct.unpack_from("<i", raw, pos)
                pos += 4
                tags.append((tname, "i", v))
            elif typ == "f":
                (v,) = struct.unpack_from("<f", raw, pos)
                pos += 4
                tags.append((tname, "f", v))
            elif typ == "Z":
                z = raw.index(b"\x00", pos)
                tags.append((tname, "Z", raw[pos:z].decode()))
                pos = z + 1
            else:
                break
        pos = end
        records.append(SamRecord(
            qname=qname, flag=flag,
            rname=refs[rid][0] if rid >= 0 else "*",
            pos=pos0 + 1 if pos0 >= 0 else 0, mapq=mapq,
            cigar="".join(cig) or "*",
            rnext=(refs[nrid][0] if nrid >= 0 else "*"),
            pnext=npos + 1 if npos >= 0 else 0, tlen=tlen,
            seq="".join(seq_chars) or "*",
            qual=("".join(chr(q + 33) for q in qual)
                  if l_seq and qual[0] != 0xFF else "*"),
            tags=tags))
    return header, refs, records
