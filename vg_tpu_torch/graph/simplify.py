"""Graph simplification (vg simplify, reference:
src/small_snarl_simplifier.cpp): pop small snarls down to their
highest-support or reference traversal, dropping the alternative alleles.

Copied from vg_tpu/graph/simplify.py.
"""
from __future__ import annotations

from typing import List, Optional, Set

from .arraygraph import ArrayGraph
from .ops import _builder_from
from .snarls import snarls_along_path


def simplify_small_snarls(g: ArrayGraph, ref_path: str,
                          max_bubble_size: int = 10) -> ArrayGraph:
    """Remove off-reference contents of snarls whose inner size is at most
    max_bubble_size bases (keeps the reference allele)."""
    pi = g.path_index(ref_path)
    on_ref = {int(h) >> 1 for h in g.path_handles(pi)}
    drop: Set[int] = set()
    for sn in snarls_along_path(g, ref_path):
        inner = set(sn.contents)
        size = sum(int(g.seq_start[i + 1] - g.seq_start[i]) for i in inner)
        if size <= max_bubble_size:
            drop |= {i for i in inner if i not in on_ref}
    drop_ids = {int(g.node_id[i]) for i in drop}
    return _builder_from(g, node_filter=lambda n: n not in drop_ids,
                         trim_paths=True).freeze()
