"""GTF/GFF exon parsing for transcript projection (vg rna input side;
reference: src/gff_reader.cpp, src/transcriptome.cpp consume GTF/GFF3
exon features grouped by transcript id).

Copied from vg_tpu/io/gtf.py.
"""
from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Transcript:
    transcript_id: str
    chrom: str
    strand: str                      # '+' or '-'
    exons: List[Tuple[int, int]] = field(default_factory=list)  # 0-based [s,e)
    gene_id: str = ""


_ATTR_GTF = re.compile(r'(\w+) "([^"]*)"')
_ATTR_GFF = re.compile(r"(\w+)=([^;]*)")


def _attrs(s: str) -> Dict[str, str]:
    d = dict(_ATTR_GTF.findall(s))
    if not d:
        d = dict(_ATTR_GFF.findall(s))
    return d


def read_gtf(path: str) -> List[Transcript]:
    op = gzip.open if str(path).endswith(".gz") else open
    by_id: Dict[str, Transcript] = {}
    with op(path, "rt") as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 9 or cols[2].lower() != "exon":
                continue
            at = _attrs(cols[8])
            tid = at.get("transcript_id") or at.get("Parent") or at.get("ID")
            if not tid:
                continue
            t = by_id.get(tid)
            if t is None:
                t = by_id[tid] = Transcript(
                    transcript_id=tid, chrom=cols[0], strand=cols[6],
                    gene_id=at.get("gene_id", ""))
            t.exons.append((int(cols[3]) - 1, int(cols[4])))
    out = list(by_id.values())
    for t in out:
        t.exons.sort()
    return out
