"""SAM text output (reference: HTSWriter/HTSAlignmentEmitter,
src/hts_alignment_emitter.hpp:131-289 — here a direct text writer; binary
BAM output shares these records via io/bam.py).

The sequence dictionary comes from reference-sense paths, like vg's
hts_alignment_emitter builds @SQ from path metadata
(src/hts_alignment_emitter.hpp:62-98).

Copied from vg_tpu/io/sam.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, TextIO, Tuple

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_LAST = 0x80
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800


@dataclass
class SamRecord:
    qname: str = "*"
    flag: int = 0
    rname: str = "*"
    pos: int = 0                 # 1-based; 0 = unmapped
    mapq: int = 0
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: List[Tuple[str, str, object]] = field(default_factory=list)

    def line(self) -> str:
        cols = [self.qname, str(self.flag), self.rname, str(self.pos),
                str(self.mapq), self.cigar, self.rnext, str(self.pnext),
                str(self.tlen), self.seq, self.qual]
        for name, typ, val in self.tags:
            cols.append(f"{name}:{typ}:{val}")
        return "\t".join(cols)


def sam_header(ref_lengths: Sequence[Tuple[str, int]],
               sample: Optional[str] = None,
               read_group: Optional[str] = None,
               sorted_by_coord: bool = False) -> List[str]:
    lines = [f"@HD\tVN:1.6\tSO:{'coordinate' if sorted_by_coord else 'unsorted'}"]
    for name, length in ref_lengths:
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    if read_group:
        rg = f"@RG\tID:{read_group}"
        if sample:
            rg += f"\tSM:{sample}"
        lines.append(rg)
    lines.append("@PG\tID:vg_tpu\tPN:vg_tpu")
    return lines


def cigar_str(ops: Sequence[Tuple[str, int]]) -> str:
    """Compact a list of (op, length) into a CIGAR string, merging runs."""
    out = []
    for op, n in ops:
        if n <= 0:
            continue
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + n)
        else:
            out.append((op, n))
    return "".join(f"{n}{op}" for op, n in out) or "*"


def write_sam(fileobj: TextIO, header: Sequence[str],
              records: Sequence[SamRecord]) -> None:
    for h in header:
        fileobj.write(h + "\n")
    for r in records:
        fileobj.write(r.line() + "\n")


def parse_sam(fileobj) -> "Iterator[SamRecord]":
    """Minimal SAM text reader (vg inject's input side)."""
    for line in fileobj:
        if not line.strip() or line.startswith("@"):
            continue
        cols = line.rstrip("\n").split("\t")
        rec = SamRecord(
            qname=cols[0], flag=int(cols[1]), rname=cols[2],
            pos=int(cols[3]), mapq=int(cols[4]), cigar=cols[5],
            rnext=cols[6], pnext=int(cols[7]), tlen=int(cols[8]),
            seq=cols[9], qual=cols[10])
        for tag in cols[11:]:
            parts = tag.split(":", 2)
            if len(parts) == 3:
                rec.tags.append((parts[0], parts[1], parts[2]))
        yield rec


def cigar_ops(cigar: str):
    n = 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + int(ch)
        else:
            yield ch, n
            n = 0
