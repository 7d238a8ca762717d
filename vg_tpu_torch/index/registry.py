"""Index registry: declarative artifact dependency graph with plan solving.

Reference: IndexRegistry (src/index_registry.hpp:28-151, 6.5k LoC) models
every index as a node in a recipe DAG and solves a plan from whatever
inputs exist to the requested targets (vg autoindex). Same shape here,
sized to vg_tpu's artifact set: graph bundle, haplotype text, minimizer
index — recipes re-run only for missing files, and supplying an
intermediate skips its recipe (the reference's resumability contract,
SURVEY.md §5 checkpoint/resume).

Copied from vg_tpu/index/registry.py.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


@dataclass
class Recipe:
    output: str                      # artifact name
    inputs: List[str]                # artifact dependencies
    make: Callable[["IndexRegistry"], None]
    description: str = ""


class IndexRegistry:
    def __init__(self, prefix: str):
        self.prefix = prefix
        self.provided: Dict[str, str] = {}   # artifact -> file path
        self.recipes: Dict[str, Recipe] = {}
        self._register_defaults()

    # -- artifact paths ----------------------------------------------------

    def path(self, artifact: str) -> str:
        if artifact in self.provided:
            return self.provided[artifact]
        ext = {
            "graph": ".vgz.npz",
            "haplotypes": ".hpt.npz",
            "minimizer": ".min.npz",
        }.get(artifact, f".{artifact}")
        return self.prefix + ext

    def provide(self, artifact: str, path: str) -> None:
        self.provided[artifact] = path

    def available(self, artifact: str) -> bool:
        return os.path.exists(self.path(artifact))

    # -- plan solving ------------------------------------------------------

    def plan(self, targets: Sequence[str]) -> List[Recipe]:
        """Topologically ordered recipes needed to produce the targets
        given what already exists on disk."""
        out: List[Recipe] = []
        done = set()

        def need(a: str):
            if a in done or self.available(a):
                return
            r = self.recipes.get(a)
            if r is None:
                raise FileNotFoundError(
                    f"no recipe and no file for artifact '{a}' "
                    f"({self.path(a)})")
            for dep in r.inputs:
                need(dep)
            out.append(r)
            done.add(a)

        for t in targets:
            need(t)
        return out

    def make(self, targets: Sequence[str]) -> List[str]:
        """Execute the plan; returns descriptions of executed recipes."""
        executed = []
        for r in self.plan(targets):
            r.make(self)
            executed.append(r.description or r.output)
        return executed

    # -- default recipes ---------------------------------------------------

    def _register_defaults(self) -> None:
        def make_graph(reg: "IndexRegistry"):
            from ..construct.constructor import Constructor, ConstructorParams
            from ..io import native
            from ..io.fasta import read_fasta
            from ..io.vcf import read_vcf

            ref = read_fasta(reg.path("reference"))
            vcf = read_vcf(reg.path("vcf"))
            g, results = Constructor(ConstructorParams()).construct_graph(
                ref, vcf)
            native.save_graph(reg.path("graph"), g)
            reg._construct_results = (g, results, vcf)

        def make_haps(reg: "IndexRegistry"):
            from ..index.haplotypes import thread_haplotypes
            from ..io import native

            if getattr(reg, "_construct_results", None) is None:
                raise RuntimeError(
                    "haplotype threading needs construction metadata; "
                    "run the graph recipe in the same plan or provide "
                    "the haplotypes artifact directly")
            g, results, vcf = reg._construct_results
            haps = thread_haplotypes(g, results, vcf)
            native.save_haplotypes(reg.path("haplotypes"), haps)

        def make_minimizer(reg: "IndexRegistry"):
            from ..index.minimizer import MinimizerIndex
            from ..io import native

            g = native.load_graph(reg.path("graph"))
            haps = native.load_haplotypes(reg.path("haplotypes"), g)
            idx = MinimizerIndex.build(haps)
            native.save_minimizer(reg.path("minimizer"), idx)

        self.recipes["graph"] = Recipe(
            "graph", ["reference", "vcf"], make_graph,
            "construct graph from FASTA+VCF")
        self.recipes["haplotypes"] = Recipe(
            "haplotypes", ["graph"], make_haps,
            "thread sample haplotypes")
        self.recipes["minimizer"] = Recipe(
            "minimizer", ["haplotypes"], make_minimizer,
            "build minimizer index")

    @staticmethod
    def giraffe_targets() -> List[str]:
        """Default artifact set for the short-read mapper (reference:
        VGIndexes::get_default_short_giraffe_indexes)."""
        return ["graph", "haplotypes", "minimizer"]
