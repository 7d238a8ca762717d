"""vg_tpu_torch command line: the toolkit surface.

Mirrors the reference's subcommand layer (vg_main -> self-registering
Subcommands, src/main.cpp:46, src/subcommand/subcommand.hpp:88; full list
in SURVEY.md Appendix A). Python argparse subparsers replace the C++
registry; each subcommand is a thin shell over the library.

    python -m vg_tpu_torch.cli construct -r ref.fa -v vars.vcf.gz -o graph.vgz
    python -m vg_tpu_torch.cli autoindex -r ref.fa -v vars.vcf.gz -p prefix
    python -m vg_tpu_torch.cli giraffe -Z prefix -f reads.fq > out.gam
    python -m vg_tpu_torch.cli surject -Z prefix -i out.gam > out.sam
    python -m vg_tpu_torch.cli pack -Z prefix -g out.gam -o out.pack.npz
    python -m vg_tpu_torch.cli call -Z prefix -k out.pack.npz > out.vcf

Ported from vg_tpu/cli/main.py. The mappers run on the device that
VGTPU_PLATFORM names: unset, "cuda" or "gpu" is the card (an error where
there is none), "cpu" the plain PyTorch versions of the kernels. The
subcommands, their options and their output bytes are vg_tpu's; the
program name, error prefixes, `version` and `test` name the port.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np


def _load_graph_any(path: str):
    from ..io import gfa, json_graph, native, vg_format

    if path.endswith(".gfa"):
        return gfa.read_gfa(path)
    if path.endswith(".json"):
        return json_graph.read_json_graph(path)
    if path.endswith(".vg"):
        return vg_format.read_vg(path)
    return native.load_graph(path)


def _save_graph_any(g, path: str) -> None:
    from ..io import gfa, json_graph, native, vg_format

    if path.endswith(".gfa"):
        with open(path, "w") as f:
            gfa.write_gfa(g, f)
    elif path.endswith(".json"):
        json_graph.write_json_graph(g, path)
    elif path.endswith(".vg"):
        with open(path, "wb") as f:
            vg_format.write_vg(g, f)
    else:
        native.save_graph(path, g)


def _bundle_paths(prefix: str):
    return prefix + ".vgz.npz", prefix + ".hpt.npz", prefix + ".min.npz"


def _load_bundle(prefix: str):
    from ..io import native

    if prefix.endswith(".gbz"):
        # load a reference-ecosystem GBZ directly; the minimizer index is
        # built on the fly like vg giraffe regenerating missing indexes
        # (test/t/50_vg_giraffe.t:32-43)
        from ..index.minimizer import MinimizerIndex
        from ..io.gbz import gbz_to_graph, read_gbz

        g, haps = gbz_to_graph(read_gbz(prefix))
        import os

        mp = prefix + ".min.npz"
        if os.path.exists(mp):
            idx = native.load_minimizer(mp)
        else:
            idx = MinimizerIndex.build(haps)
            try:
                native.save_minimizer(mp, idx)
            except OSError:
                pass
        return g, haps, idx
    gp, hp, mp = _bundle_paths(prefix)
    g = native.load_graph(gp)
    haps = native.load_haplotypes(hp, g)
    idx = native.load_minimizer(mp)
    return g, haps, idx


# ------------------------------------------------------------ subcommands

def cmd_construct(args) -> int:
    from ..construct.constructor import Constructor, ConstructorParams
    from ..io.fasta import read_fasta
    from ..io.vcf import VcfFile, read_vcf

    ref = read_fasta(args.reference)
    vcf = read_vcf(args.vcf) if args.vcf else None
    params = ConstructorParams(max_node_size=args.node_max,
                               alt_paths=args.alt_paths)
    if vcf is not None:
        g, _ = Constructor(params).construct_graph(ref, vcf)
    else:
        g, _ = Constructor(params).construct_graph(
            ref, VcfFile(samples=[], records=[]))
    if args.output:
        _save_graph_any(g, args.output)
    else:
        from ..io import vg_format
        vg_format.write_vg(g, sys.stdout.buffer)
    print(f"constructed graph: {g.node_count} nodes, {g.edge_count} edges",
          file=sys.stderr)
    return 0


def cmd_autoindex(args) -> int:
    from ..construct.constructor import Constructor, ConstructorParams
    from ..index.haplotypes import haplotypes_from_paths, thread_haplotypes
    from ..index.minimizer import MinimizerIndex
    from ..io import native
    from ..io.fasta import read_fasta
    from ..io.vcf import read_vcf

    if args.gbz:
        from ..io.gbz import gbz_to_graph, read_gbz

        g, haps = gbz_to_graph(read_gbz(args.gbz))
    elif args.gfa:
        g = _load_graph_any(args.gfa)
        haps = haplotypes_from_paths(g)
    else:
        ref = read_fasta(args.reference)
        vcf = read_vcf(args.vcf)
        g, results = Constructor(ConstructorParams(
            max_node_size=args.node_max)).construct_graph(ref, vcf)
        haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps, k=args.kmer_length,
                               w=args.window_length)
    gp, hp, mp = _bundle_paths(args.prefix)
    native.save_graph(gp, g)
    native.save_haplotypes(hp, haps)
    native.save_minimizer(mp, idx)
    if args.gbz_out:
        from ..io.gbz_write import write_gbz

        write_gbz(args.gbz_out, g, haps)
    print(f"indexed: {g.node_count} nodes, {haps.count} haplotypes "
          f"({haps.total_len} bp text), {idx.unique_count} minimizers",
          file=sys.stderr)
    return 0


def _expand_sweeps(specs):
    """Parse `key=start:end[:step]` sweep specs (the reference's
    rangeable options, src/subcommand/options.hpp Range: inclusive end)
    into a list of {key: value} grid points."""
    from itertools import product

    axes = []
    for spec in specs:
        key, _, rng = spec.partition("=")
        parts = rng.split(":")
        conv = float if any("." in x for x in parts) else int
        if len(parts) == 1:
            vals = [conv(parts[0])]
        else:
            start, end = conv(parts[0]), conv(parts[1])
            step = conv(parts[2]) if len(parts) > 2 else 1
            vals = []
            v = start
            while v <= end + (1e-9 if conv is float else 0):
                vals.append(conv(v))
                v += step
        axes.append([(key, v) for v in vals])
    return [dict(combo) for combo in product(*axes)]


def cmd_giraffe(args) -> int:
    from ..io.fastq import (iter_fastq, iter_fastq_interleaved,
                            iter_fastq_paired)
    from ..io.gaf import write_gaf
    from ..io.gam import write_gam
    from ..map.giraffe import GiraffeMapper, GiraffeParams
    from ..map.paired import PairedGiraffeMapper

    if getattr(args, "gam_in", None):
        # take input reads from a GAM (vg map -G role): dump to a temp
        # fastq and fall through the normal streaming paths
        import tempfile

        from ..io.fastq import Read as _Read
        from ..io.gam import read_gam

        tf = tempfile.NamedTemporaryFile("w", suffix=".fq", delete=False)
        for a in read_gam(args.gam_in):
            q = (bytes(a.quality).decode("latin1")
                 if a.quality else "I" * len(a.sequence))
            qual = "".join(chr(min(ord(c) + 33, 126)) for c in q) \
                if a.quality else q
            tf.write(f"@{a.name}\n{a.sequence}\n+\n{qual}\n")
        tf.close()
        args.fastq = tf.name
        args.gam_in = None
    if not args.fastq:
        print("error [vg_tpu_torch giraffe]: provide -f FASTQ or -G GAM",
              file=sys.stderr)
        return 2

    if getattr(args, "sweep", None):
        # parameter grid sweep: one full mapping run per combination,
        # outputs suffixed with the grid point (reference: rangeable
        # options ticked by the subcommand chain, options.hpp:174)
        import argparse as _ap
        import json as _json

        combos = _expand_sweeps(args.sweep)
        for combo in combos:
            sub = _ap.Namespace(**vars(args))
            sub.sweep = None
            sub.param_override = dict(getattr(args, "param_override", None)
                                      or {}, **combo)
            tag = "_".join(f"{k}-{v}" for k, v in combo.items())
            if args.output:
                root, dot, ext = args.output.rpartition(".")
                sub.output = (f"{root}.{tag}.{ext}" if dot
                              else f"{args.output}.{tag}")
            print(f"[sweep] {_json.dumps(combo)} -> "
                  f"{sub.output or 'stdout'}", file=sys.stderr)
            rc = cmd_giraffe(sub)
            if rc != 0:
                return rc
        return 0

    g, haps, idx = _load_bundle(args.index_prefix)
    if getattr(args, "kff_name", None):
        # giraffe-integrated haplotype sampling (reference
        # giraffe --haplotype-name/--kff-name, haplotype-sampling
        # README "Giraffe integration"): sample a diploid personal
        # pangenome from the kmer counts, then map against it
        from ..index.minimizer import MinimizerIndex as _MI
        from ..index.sampling import recombine_haplotypes_diploid
        from ..io.kff import read_kff

        kk, kmers, counts = read_kff(args.kff_name)
        haps = recombine_haplotypes_diploid(haps, kmers, counts, k=kk)
        idx = _MI.build(haps)
        print(f"[giraffe] sampled {haps.count} haplotypes "
              f"({haps.total_len} bp text) from {args.kff_name}",
              file=sys.stderr)
    if args.parameter_preset in ("hifi", "r10", "lr"):
        import os as _os

        from ..io import native as _native
        from ..map.longread import LongReadMapper, LongReadParams

        # long-read presets use their own index parameters (reference
        # IndexingParameters::long_read_minimizer_{k,w,W} = 31/50/weighted,
        # index_registry.cpp:121-123; name-inferred .longread.withzip.min
        # regeneration, test/t/50_vg_giraffe.t:27-44): load
        # <prefix>.lr.min.npz or build-and-save it on the fly
        idx_lr = idx
        if not args.index_prefix.endswith(".gbz"):
            lrp = args.index_prefix + ".lr.min.npz"
            if _os.path.exists(lrp):
                idx_lr = _native.load_minimizer(lrp)
            else:
                from ..index.minimizer import MinimizerIndex as _MI2

                idx_lr = _MI2.build(haps, k=31, w=50, weighted=True)
                _native.save_minimizer(lrp, idx_lr)
                print(f"[giraffe] built long-read minimizers "
                      f"(k=31 w=50 weighted) -> {lrp}", file=sys.stderr)
        mapper = LongReadMapper(
            haps, idx_lr, LongReadParams.preset(args.parameter_preset),
            device=args.device)
    elif getattr(args, "engine", "giraffe") == "mem":
        # honest `vg map`: MEM seeding over a suffix array of the
        # haplotype text (reference src/mapper.cpp:4484, src/mem.cpp),
        # sharing the downstream giraffe machinery
        import os

        import numpy as _np

        from ..map.memmapper import MEMIndex, MEMMapper

        sa_path = args.index_prefix + ".sa.npy"
        sa = None
        if os.path.exists(sa_path):
            sa = _np.load(sa_path)
        mi = MEMIndex(haps, sa=sa)
        if sa is None:
            try:
                _np.save(sa_path, mi.sa)
            except OSError:
                pass
        params = GiraffeParams(max_candidates=args.max_multimaps_internal,
                               batch_reads=args.batch_size,
                               track_provenance=args.track_provenance,
                               # vg map aligns quality-adjusted when the
                               # input has qualities (QualAdjAligner,
                               # reference src/aligner.hpp:218); the flag
                               # activates per batch only when qualities
                               # are present
                               qual_adjusted=getattr(
                                   args, "qual_adjust", False))
        mapper = MEMMapper(haps, mi, params, device=args.device)
    else:
        params = GiraffeParams(max_candidates=args.max_multimaps_internal,
                               batch_reads=args.batch_size,
                               track_provenance=args.track_provenance)
        if args.parameter_preset == "fast":
            # reference fast preset: tighter caps (giraffe_main.cpp:940-951)
            params.hit_cap = 10
            params.hard_hit_cap = 500
            params.score_fraction = 0.5
            params.max_candidates = min(params.max_candidates, 4)
        if getattr(args, "full_l_bonus", None) is not None:
            params.full_length_bonus = args.full_l_bonus
        for k, v in (getattr(args, "param_override", None) or {}).items():
            if not hasattr(params, k):
                print(f"unknown parameter {k!r} in sweep", file=sys.stderr)
                return 2
            setattr(params, k, type(getattr(params, k))(v))
        mapper = GiraffeMapper(haps, idx, params, device=args.device)
    out = sys.stdout
    alns_out: List = []
    comments: dict = {}
    tag_mode = getattr(args, "comments_as_tags", False)

    def note_comment(r):
        if tag_mode and r.comment:
            comments[r.name] = r.comment

    def flush(alns):
        if tag_mode:
            for a in alns:
                c = comments.get(a.name)
                if c:
                    a.annotation["tags"] = c
        if args.output_format == "json":
            for a in alns:
                out.write(a.to_json_str() + "\n")
        elif args.output_format == "gaf":
            write_gaf(out, alns)
        elif args.output_format == "sam":
            alns_out.extend(alns)
        else:
            alns_out.extend(alns)

    n = 0
    # paired GAM: stream encoded interleaved records
    if (args.output_format == "gam" and (args.fastq_mate or args.interleaved)
            and hasattr(mapper, "score_reads")):
        from ..io.gam import write_messages
        from ..map.paired import PairedGiraffeMapper

        pm = PairedGiraffeMapper(mapper)
        if args.fastq_mate:
            it = iter_fastq_paired(args.fastq, args.fastq_mate)
        else:
            it = iter_fastq_interleaved(args.fastq)
        sink = open(args.output, "wb") if args.output else sys.stdout.buffer
        n = 0

        def pair_batches():
            batch = []
            for pair in it:
                batch.append(pair)
                if len(batch) >= args.batch_size:
                    yield batch
                    batch = []
            if batch:
                yield batch

        from ..parallel.pipeline import map_pairs_encoded_mt

        for recs in map_pairs_encoded_mt(pm, pair_batches()):
            write_messages(sink, recs)
            n += len(recs)
        if args.output:
            sink.close()
        print(f"mapped {n} reads", file=sys.stderr)
        return 0
    # long-read GAM: native stitch + runs->GAM encode, no path objects
    if (args.output_format == "gam" and not args.fastq_mate
            and not args.interleaved
            and hasattr(mapper, "map_batch_encoded")):
        from ..io.gam import write_messages

        sink = open(args.output, "wb") if args.output else sys.stdout.buffer
        batch = []

        def flush_lr(batch):
            recs = mapper.map_batch_encoded(batch)
            if recs is None:
                recs = [a.encode() for a in mapper.map_batch(batch)]
            write_messages(sink, recs)
            return len(recs)

        for r in iter_fastq(args.fastq):
            batch.append(r)
            if len(batch) >= args.batch_size:
                n += flush_lr(batch)
                batch = []
        if batch:
            n += flush_lr(batch)
        if args.output:
            sink.close()
        print(f"mapped {n} reads", file=sys.stderr)
        return 0
    # single-end GAM: stream encoded records through the native emitter
    if (args.output_format == "gam" and not args.fastq_mate
            and not args.interleaved and hasattr(mapper, "map_stream_encoded")):
        from ..io.gam import write_messages

        comment_q: List[List] = []

        def batches():
            batch = []
            for r in iter_fastq(args.fastq):
                batch.append(r)
                if len(batch) >= args.batch_size:
                    if tag_mode:
                        comment_q.append([x.comment for x in batch])
                    yield batch
                    batch = []
            if batch:
                if tag_mode:
                    comment_q.append([x.comment for x in batch])
                yield batch

        from ..parallel.pipeline import map_stream_encoded_mt

        def _tag_suffix(comment):
            from ..io.gam import _encode_struct
            from ..io.wire import field_bytes

            return field_bytes(100, _encode_struct({"tags": comment}))

        sink = open(args.output, "wb") if args.output else sys.stdout.buffer
        n = 0
        for recs in map_stream_encoded_mt(mapper, batches()):
            if tag_mode and comment_q:
                cs = comment_q.pop(0)
                recs = [bytes(r) + _tag_suffix(c) if c else r
                        for r, c in zip(recs, cs)]
            write_messages(sink, recs)
            n += len(recs)
        if args.output:
            sink.close()
        print(f"mapped {n} reads", file=sys.stderr)
        return 0
    if args.fastq_mate or args.interleaved:
        pm = PairedGiraffeMapper(mapper)
        if args.fastq_mate:
            it = iter_fastq_paired(args.fastq, args.fastq_mate)
        else:
            it = iter_fastq_interleaved(args.fastq)
        batch = []
        for pair in it:
            note_comment(pair[0])
            note_comment(pair[1])
            batch.append(pair)
            if len(batch) >= args.batch_size:
                flush(pm.map_pairs_flat(batch))
                n += 2 * len(batch)
                batch = []
        if batch:
            flush(pm.map_pairs_flat(batch))
            n += 2 * len(batch)
        tail = pm.finish()
        for a1, a2 in tail:
            flush([a1, a2])
            n += 2
    else:
        batch = []
        for r in iter_fastq(args.fastq):
            note_comment(r)
            batch.append(r)
            if len(batch) >= args.batch_size:
                flush(mapper.map_batch(batch))
                n += len(batch)
                batch = []
        if batch:
            flush(mapper.map_batch(batch))
            n += len(batch)

    if args.output_format == "gam":
        if args.output:
            with open(args.output, "wb") as f:
                write_gam(f, alns_out)
        else:
            write_gam(sys.stdout.buffer, alns_out)
    if args.track_provenance and hasattr(mapper, "funnel"):
        print(mapper.funnel.report(), file=sys.stderr)
    elif args.output_format == "sam":
        from ..io.sam import write_sam
        from ..surject.surjector import Surjector

        sj = Surjector(g)
        if args.fastq_mate or args.interleaved:
            pairs = [(alns_out[i], alns_out[i + 1])
                     for i in range(0, len(alns_out), 2)]
            recs = sj.surject_pairs(pairs)
        else:
            recs = sj.surject_batch(alns_out)
        if tag_mode:
            for rec in recs:
                c = comments.get(rec.qname)
                if c:
                    for tok in str(c).split():
                        parts = tok.split(":", 2)
                        if len(parts) == 3:
                            rec.tags.append((parts[0], parts[1],
                                             parts[2]))
        write_sam(out, sj.header(), recs)
    print(f"mapped {n} reads", file=sys.stderr)
    return 0


def cmd_surject(args) -> int:
    from ..io.gam import read_gam
    from ..io.sam import write_sam
    from ..surject.surjector import Surjector

    if args.index_prefix:
        g, _, _ = _load_bundle(args.index_prefix)
    else:
        g = _load_graph_any(args.xg)
    sj = Surjector(g, [args.path] if args.path else None)
    alns = list(read_gam(args.input))
    if args.paired:
        pairs = [(alns[i], alns[i + 1]) for i in range(0, len(alns) - 1, 2)]
        recs = sj.surject_pairs(pairs)
    else:
        recs = sj.surject_batch(alns)
    header = sj.header(sample=args.sample, read_group=args.read_group)
    if args.bam:
        from ..io.bam import write_bam
        out = open(args.bam, "wb") if args.bam != "-" else sys.stdout.buffer
        write_bam(out, header, sj.ref_lengths(), recs)
        if args.bam != "-":
            out.close()
    elif getattr(args, "cram", None):
        from ..io.cram import write_cram
        out = (open(args.cram, "wb") if args.cram != "-"
               else sys.stdout.buffer)
        write_cram(out, header, [n for n, _ in sj.ref_lengths()], recs)
        if args.cram != "-":
            out.close()
    else:
        write_sam(sys.stdout, header, recs)
    return 0


def cmd_pack(args) -> int:
    from ..call.pack import Packer
    from ..io.gam import read_gam

    if args.index_prefix:
        g, _, _ = _load_bundle(args.index_prefix)
    else:
        g = _load_graph_any(args.xg)
    pk = Packer(g)
    batch = []
    reader = read_gam
    if args.gam.endswith(".gaf"):
        from ..io.gaf import read_gaf as reader
    for a in reader(args.gam):
        batch.append(a)
        if len(batch) >= 4096:
            pk.add_batch(batch)
            batch = []
    pk.add_batch(batch)
    if args.output:
        pk.save(args.output)
    if args.dump:
        for nid, off, c in pk.as_table():
            sys.stdout.write(f"{nid}\t{off}\t{c}\n")
    print(f"packed {pk.n_alignments} alignments, "
          f"mean coverage {pk.base_coverage.mean():.2f}", file=sys.stderr)
    return 0


def cmd_call(args) -> int:
    from ..call.caller import SnarlCaller
    from ..call.pack import Packer
    from ..graph.arraygraph import SENSE_REFERENCE

    haps = None
    if args.index_prefix:
        g, haps, _ = _load_bundle(args.index_prefix)
    else:
        g = _load_graph_any(args.xg)
    if not args.gbwt_restrict:
        haps = None
    pk = Packer.load(g, args.pack)
    ref_path = args.path
    if ref_path is None:
        prefer = [m.name for m in g.path_meta if m.sense == SENSE_REFERENCE]
        names = prefer or [m.name for m in g.path_meta]
        if not names:
            print("error [vg_tpu_torch call]: no REFERENCE or GENERIC sense "
                  "path to call against; pass -p", file=sys.stderr)
            return 1
        ref_path = names[0]
    sc = SnarlCaller(g, pk, ref_path, sample_name=args.sample,
                     haplotypes=haps)
    if args.vcf:
        # genotype-given-VCF mode (VCFGenotyper, graph_caller.hpp:49):
        # needs a graph built with construct -a (embedded alt paths)
        from ..io.vcf import read_vcf

        calls = sc.genotype_given_vcf(read_vcf(args.vcf))
        sc.write_vcf(sys.stdout, calls)
        return 0
    calls = sc.call()
    if args.traversals_out:
        # called-allele traversals as GAF walks (vg call -T role)
        with open(args.traversals_out, "w") as tf:
            for vc in calls:
                for ai, walk in enumerate(vc.traversals or []):
                    pathcol = "".join(
                        ("<" if h & 1 else ">") + str(int(g.node_id[h >> 1]))
                        for h in walk)
                    ln = sum(g.handle_len(int(h)) for h in walk)
                    tf.write(f"{vc.chrom}_{vc.pos}_{ai}\t{ln}\t0\t{ln}\t+"
                             f"\t{pathcol}\t{ln}\t0\t{ln}\t{ln}\t{ln}\t60\n")
    sc.write_vcf(sys.stdout, calls)
    return 0


def cmd_add(args) -> int:
    """vg add: embed new VCF alleles into an existing graph via the
    augment machinery (reference src/variant_adder.cpp role)."""
    from ..graph.augment import add_variants
    from ..io.vcf import read_vcf

    g = _load_graph_any(args.input)
    vcf = read_vcf(args.vcf)
    g2, _tr = add_variants(g, vcf)
    _save_graph_any(g2, args.output)
    print(f"added: {g2.node_count - g.node_count} nodes, "
          f"{g2.edge_count - g.edge_count} edges", file=sys.stderr)
    return 0


def cmd_primers(args) -> int:
    """vg primers role (reference src/primer_filter.cpp): filter primer
    pairs whose binding sites overlap non-reference variation. Input is
    primer3-style TSV/BED rows (name, start, end on the reference path);
    rows overlapping any snarl's variable region are dropped (or kept
    with --all, annotated with a variable flag)."""
    from ..graph.cactus import snarls_on_path

    g = _load_graph_any(args.xg)
    snarls, _children = snarls_on_path(g, args.path)
    offs = g.path_step_offsets(g.path_index(args.path))
    handles = g.path_handles(g.path_index(args.path))
    pos_of = {int(h): int(offs[i]) for i, h in enumerate(handles)}
    var_iv = []
    for sn in snarls:
        a = pos_of.get(sn.start)
        b = pos_of.get(sn.end)
        if a is None or b is None:
            continue
        a += g.handle_len(sn.start)          # variable region between
        var_iv.append((min(a, b), max(a, b)))
    # merge into disjoint sorted intervals for exact bisect checks
    var_iv.sort()
    merged = []
    for a, b in var_iv:
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    import bisect

    starts = [a for a, _ in merged]

    kept = dropped = 0
    with open(args.primers) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3 or parts[0].startswith("#"):
                continue
            name, s, e = parts[0], int(parts[1]), int(parts[2])
            i = bisect.bisect_right(starts, e) - 1
            variable = i >= 0 and merged[i][1] > s and merged[i][0] < e
            if not variable and i + 1 < len(merged):
                variable = merged[i + 1][0] < e and merged[i + 1][1] > s
            if variable and not args.all:
                dropped += 1
                continue
            kept += 1
            flag = "\tVARIABLE" if variable else ""
            sys.stdout.write(f"{name}\t{s}\t{e}{flag}\n")
    print(f"primers: kept {kept}, dropped {dropped} overlapping variation",
          file=sys.stderr)
    return 0


def cmd_clip(args) -> int:
    """vg clip: remove non-reference variation in BED regions or below a
    coverage floor (reference src/clip.cpp role)."""
    from ..graph.ops import clip_regions

    g = _load_graph_any(args.input)
    intervals = None
    if args.bed:
        intervals = []
        with open(args.bed) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3 and parts[0] == args.path:
                    intervals.append((int(parts[1]), int(parts[2])))
    pack = None
    if args.pack:
        from ..call.pack import Packer

        pack = Packer.load(g, args.pack)
    g2 = clip_regions(g, args.path, bed_intervals=intervals, pack=pack,
                      min_depth=args.min_depth)
    _save_graph_any(g2, args.output)
    print(f"clipped: {g.node_count - g2.node_count} nodes removed",
          file=sys.stderr)
    return 0


def cmd_view(args) -> int:
    from ..io import gfa, json_graph, vg_format
    from ..io.gam import read_gam

    if args.gam_json:
        for a in read_gam(args.input):
            sys.stdout.write(a.to_json_str() + "\n")
        return 0
    g = _load_graph_any(args.input)
    if args.turtle:
        from ..io.rdf import write_turtle

        write_turtle(g, sys.stdout, base_uri=args.rdf_base_uri)
        return 0
    if args.output and not args.gfa_out:
        _save_graph_any(g, args.output)
    else:
        gfa.write_gfa(g, sys.stdout)
    return 0


def cmd_stats(args) -> int:
    if args.alignments:
        from ..io.gam import read_gam
        from ..utils.alnstats import alignment_stats

        stats = alignment_stats(read_gam(args.input))
        for k, v in stats.items():
            print(f"{k}\t{v}")
        return 0
    g = _load_graph_any(args.input)
    print(f"nodes\t{g.node_count}")
    print(f"edges\t{g.edge_count}")
    print(f"length\t{g.total_seq_len}")
    print(f"paths\t{g.path_count}")
    return 0


def cmd_paths(args) -> int:
    g = _load_graph_any(args.xg)
    if args.extract_gam:
        from ..io.gam import Alignment, Edit, Mapping, Path, Position, write_gam

        alns = []
        for pi, m in enumerate(g.path_meta):
            path = Path()
            for rank, h in enumerate(g.path_handles(pi), 1):
                h = int(h)
                ln = g.handle_len(h)
                path.mappings.append(Mapping(
                    position=Position(node_id=int(g.node_id[h >> 1]),
                                      is_reverse=bool(h & 1)),
                    edits=[Edit(from_length=ln, to_length=ln)], rank=rank))
            alns.append(Alignment(name=m.name, sequence=g.path_seq(m.name),
                                  path=path))
        write_gam(sys.stdout.buffer, alns)
        return 0
    if args.fasta:
        for m in g.path_meta:
            seq = g.path_seq(m.name)
            sys.stdout.write(f">{m.name}\n")
            for i in range(0, len(seq), 80):
                sys.stdout.write(seq[i : i + 80] + "\n")
    else:
        for m in g.path_meta:
            sys.stdout.write(m.name + "\n")
    return 0


def cmd_sim(args) -> int:
    from ..index.haplotypes import haplotypes_from_paths
    from ..io import native
    from ..io.gam import Alignment, write_gam
    from ..map.project import PathPositionIndex
    from ..sim.simulator import ReadSimulator

    if args.index_prefix:
        g, haps, _ = _load_bundle(args.index_prefix)
    else:
        g = _load_graph_any(args.xg)
        haps = haplotypes_from_paths(g)
    sim = ReadSimulator(haps, seed=args.seed, read_length=args.read_length,
                        error_rate=args.error_rate,
                        indel_rate=args.indel_rate)
    alns = sim.simulate(args.num_reads, annotate_truth=True)
    if args.align_out:
        if args.output:
            with open(args.output, "wb") as f:
                write_gam(f, alns)
        else:
            write_gam(sys.stdout.buffer, alns)
    else:
        for a in alns:
            sys.stdout.write(a.sequence + "\n")
    return 0


def cmd_gamcompare(args) -> int:
    from ..io.gam import read_gam
    from ..map.gamcompare import compare, compare_graph_distance

    test = list(read_gam(args.gam))
    truth = list(read_gam(args.truth_gam))
    if args.distance_graph:
        import os

        g = _load_graph_any(args.distance_graph)
        di = None
        dp = args.distance_graph + ".distidx.npz"
        from ..graph.distindex import DistanceIndex

        if os.path.exists(dp):
            di = DistanceIndex.load(dp, g)
        else:
            # build + cache the snarl-tree distance oracle alongside the
            # graph (reference: .dist built once by vg index -j)
            di = DistanceIndex.build(g)
            try:
                di.save(dp)
            except OSError:
                di = di
        stats = compare_graph_distance(g, test, truth, range_bp=args.range,
                                       dist_index=di)
    else:
        stats = compare(test, truth, range_bp=args.range)
    print(json.dumps(stats))
    return 0


def cmd_mapeval(args) -> int:
    """Accuracy oracle: simulate truth reads from the index, map, score
    (the vgci mapeval loop, vgci/vgci.py:1136, as one subcommand)."""
    from ..eval.mapeval import run_mapeval
    from ..map.giraffe import GiraffeMapper, GiraffeParams

    g, haps, idx = _load_bundle(args.index_prefix)
    mapper = GiraffeMapper(haps, idx, GiraffeParams(
        batch_reads=args.batch_size), device=args.device)
    res = run_mapeval(mapper, n_reads=args.num_reads,
                      read_length=args.read_length,
                      error_rate=args.error_rate,
                      indel_rate=args.indel_rate, paired=args.paired,
                      seed=args.seed, range_bp=args.range)
    out = res.to_dict()
    a30, n30 = res.accuracy_at_mapq(30)
    out["accuracy_mapq30"] = round(a30, 6)
    out["n_mapq30"] = n30
    print(json.dumps(out))
    return 0


def cmd_validate(args) -> int:
    g = _load_graph_any(args.xg)
    problems = g.validate()
    for p in problems:
        print(p, file=sys.stderr)
    return 1 if problems else 0




def cmd_deconstruct(args) -> int:
    from ..call.deconstruct import Deconstructor

    if args.index_prefix:
        g, haps, _ = _load_bundle(args.index_prefix)
    else:
        from ..index.haplotypes import haplotypes_from_paths
        g = _load_graph_any(args.xg)
        haps = haplotypes_from_paths(g)
    ref_path = args.path or g.path_meta[0].name
    Deconstructor(g, haps, ref_path).write_vcf(sys.stdout)
    return 0


def cmd_ids(args) -> int:
    from ..graph import ops

    g = _load_graph_any(args.input)
    if args.compact:
        g, _ = ops.compact_ids(g)
    if args.increment:
        g = ops.increment_ids(g, args.increment)
    _save_graph_any(g, args.output)
    return 0


def cmd_chunk(args) -> int:
    from ..graph import ops

    g = _load_graph_any(args.xg)
    path, rng = args.path_range.split(":")
    a, z = rng.split("-")
    sub = ops.chunk_path(g, path, int(a), int(z), args.context)
    _save_graph_any(sub, args.output)
    print(f"chunk: {sub.node_count} nodes", file=sys.stderr)
    return 0


def cmd_combine(args) -> int:
    from ..graph import ops

    graphs = [_load_graph_any(p) for p in args.inputs]
    _save_graph_any(ops.combine(graphs), args.output)
    return 0


def cmd_mask(args) -> int:
    from ..graph import ops

    g = _load_graph_any(args.xg)
    with open(args.bed) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            chrom, a, z = line.split()[:3]
            if g.has_path(chrom):
                g = ops.mask_path_interval(g, chrom, int(a), int(z))
    _save_graph_any(g, args.output)
    return 0


def cmd_circularize(args) -> int:
    from ..graph import ops

    g = _load_graph_any(args.input)
    _save_graph_any(ops.circularize(g, args.path), args.output)
    return 0


def cmd_mod(args) -> int:
    from ..graph import ops

    g = _load_graph_any(args.input)
    if args.retain_paths:
        g = ops.keep_paths(g, args.retain_paths.split(","))
    if args.drop_paths:
        g = ops.drop_paths(g, args.drop_paths.split(","))
    _save_graph_any(g, args.output)
    return 0


def cmd_prune(args) -> int:
    from ..graph import ops

    g = _load_graph_any(args.input)
    _save_graph_any(ops.prune_complex(g, args.max_degree), args.output)
    return 0


def cmd_find(args) -> int:
    if args.alignments:
        # alignment lookup against a sorted+indexed GAM (vg find -l role)
        from ..io.gam import write_gam
        from ..io.gam_index import find_alignments

        gai = args.gai or args.alignments + ".gai"
        nodes = [int(n) for n in args.node]
        alns = list(find_alignments(args.alignments, gai,
                                    min(nodes), max(nodes)))
        with open(args.output, "wb") as f:
            write_gam(f, alns)
        print(f"found {len(alns)} alignments", file=sys.stderr)
        return 0
    from ..graph import ops

    g = _load_graph_any(args.xg)
    sub = ops.subgraph(g, [int(n) for n in args.node], args.context)
    _save_graph_any(sub, args.output)
    return 0


def cmd_augment(args) -> int:
    from ..graph.augment import augment
    from ..io.gam import read_gam

    g = _load_graph_any(args.input)
    alns = list(read_gam(args.gam))
    g2, trans = augment(g, alns, min_coverage=args.min_coverage)
    _save_graph_any(g2, args.output)
    if getattr(args, "translation", None):
        import json as _json

        with open(args.translation, "w") as f:
            _json.dump({str(k): v for k, v in trans.pieces.items()}, f)
    print(f"augmented: {g.node_count} -> {g2.node_count} nodes",
          file=sys.stderr)
    return 0


def _load_translation(path):
    import json as _json

    from ..graph.augment import Translation

    with open(path) as f:
        raw = _json.load(f)
    return Translation(pieces={int(k): [tuple(p) for p in v]
                               for k, v in raw.items()})


def cmd_translate(args) -> int:
    """Project alignments onto an augmented graph through the augment
    translation (vg translate, reference
    src/subcommand/translate_main.cpp)."""
    from ..graph.augment import translate_alignment
    from ..io.gam import read_gam, write_gam

    g_new = _load_graph_any(args.graph)
    trans = _load_translation(args.translation)
    alns = [translate_alignment(trans, g_new, a)
            for a in read_gam(args.gam)]
    sink = open(args.output, "wb") if args.output else sys.stdout.buffer
    write_gam(sink, alns)
    if args.output:
        sink.close()
    return 0


def cmd_genotype(args) -> int:
    """Legacy augment-based genotyper (vg genotype, reference
    src/subcommand/genotype_main.cpp role): augment the graph with the
    reads' novel variation, project the reads through the translation,
    pack coverage on the augmented graph, and call."""
    from ..call.caller import SnarlCaller
    from ..call.pack import Packer
    from ..graph.augment import augment, translate_alignment
    from ..io.gam import read_gam

    g = _load_graph_any(args.graph)
    alns = list(read_gam(args.gam))
    g2, trans = augment(g, alns, min_coverage=args.min_support)
    pk = Packer(g2)
    pk.add_batch([translate_alignment(trans, g2, a) for a in alns])
    ref_path = args.path or g2.path_meta[0].name
    sc = SnarlCaller(g2, pk, ref_path, sample_name=args.sample)
    sc.write_vcf(sys.stdout, sc.call())
    return 0


def cmd_concat(args) -> int:
    """Serial graph concatenation (vg concat): graphs joined
    head-to-tail with connecting edges, ids offset to stay unique."""
    from ..graph import ops

    graphs = [_load_graph_any(p) for p in args.inputs]
    out = ops.concat(graphs)
    _save_graph_any(out, args.output)
    print(f"concat: {out.node_count} nodes", file=sys.stderr)
    return 0


def cmd_gbwt(args) -> int:
    """Haplotype index utilities (vg gbwt role): metadata report and
    GBZ export of the haplotype set."""
    g, haps, _ = _load_bundle(args.index_prefix)
    if args.output:
        from ..io.gbz_write import write_gbz

        write_gbz(args.output, g, haps)
        print(f"wrote GBZ: {args.output}", file=sys.stderr)
    meta = {}
    for m in haps.metas:
        meta.setdefault(m.sample, []).append(m)
    print(f"threads\t{haps.count}")
    print(f"samples\t{len(meta)}")
    print(f"total_bp\t{haps.total_len}")
    for s, ms in meta.items():
        print(f"sample\t{s}\t{len(ms)} threads")
    return 0


def cmd_kmers(args) -> int:
    """Enumerate graph kmers with their positions (vg kmers role,
    GCSA2 input generation): kmers of the haplotype text with
    node:offset anchors."""
    g, haps, _ = _load_bundle(args.index_prefix)
    from ..utils import dna

    k = args.kmer_size
    text = haps.text
    stp = haps.step_text_pos
    steps = haps.steps
    import numpy as np

    hap_ends = np.asarray(haps.text_start[1:], np.int64)
    n = 0
    hap_i = 0
    for start in range(0, len(text) - k + 1):
        # never emit windows that cross a haplotype boundary: the
        # concatenated text has no separators, and a chimeric kmer
        # exists in no graph walk (start is monotone, so track the
        # current haplotype end incrementally)
        while start >= hap_ends[hap_i]:
            hap_i += 1
        if start + k > hap_ends[hap_i]:
            continue
        km = text[start : start + k]
        if (km >= 4).any():
            continue
        si = int(np.searchsorted(stp[1:], start, side="right"))
        h = int(steps[si])
        nid = int(g.node_id[h >> 1])
        off = start - int(stp[si])
        sys.stdout.write(f"{dna.decode(km)}\t{nid}:{off}"
                         f"{'-' if h & 1 else '+'}\n")
        n += 1
        if args.head and n >= args.head:
            break
    return 0


def cmd_minimizer(args) -> int:
    """Build / report the minimizer index standalone (vg minimizer;
    -c closed syncmers, -W weighted minimizers per
    src/subcommand/minimizer_main.cpp:134-155)."""
    from ..index.minimizer import MinimizerIndex
    from ..io import native

    g = native.load_graph(args.index_prefix + ".vgz.npz")
    haps = native.load_haplotypes(args.index_prefix + ".hpt.npz", g)
    idx = MinimizerIndex.build(
        haps, k=args.kmer_length, w=args.window_length,
        scheme="syncmer" if args.closed_syncmers else "minimizer",
        smer=args.smer_length, weighted=args.weighted,
        weight_threshold=args.threshold,
        weight_iterations=args.iterations)
    out = args.output or (args.index_prefix + ".min.npz")
    native.save_minimizer(out, idx)
    print(f"minimizers\t{idx.unique_count}")
    print(f"positions\t{len(idx.pos_text)}")
    print(f"k\t{idx.k}")
    if args.closed_syncmers:
        print(f"s\t{idx.smer}")
    else:
        print(f"w\t{idx.w}")
    if idx.frequent is not None:
        print(f"frequent_kmers\t{len(idx.frequent)}")
    return 0




def cmd_align(args) -> int:
    from ..ops.graph_align import align_to_graph
    from ..utils import dna

    g = _load_graph_any(args.graph)
    aln = align_to_graph(g, dna.encode(args.sequence),
                         mode="global" if args.global_aln else "local")
    if aln is None:
        print("no alignment", file=sys.stderr)
        return 1
    if args.name:
        aln.name = args.name
    sys.stdout.write(aln.to_json_str() + "\n")
    return 0




def cmd_inject(args) -> int:
    from ..io.gam import write_gam
    from ..io.sam import parse_sam
    from ..map.inject import Injector

    g = _load_graph_any(args.xg)
    inj = Injector(g)
    if args.sam.endswith(".bam"):
        from ..io.bam import read_bam

        _, _, recs = read_bam(args.sam)
        alns = inj.inject_all(recs)
    else:
        with open(args.sam) as f:
            alns = inj.inject_all(parse_sam(f))
    if args.output:
        with open(args.output, "wb") as f:
            write_gam(f, alns)
    else:
        write_gam(sys.stdout.buffer, alns)
    return 0


def cmd_gamsort(args) -> int:
    if args.external:
        from ..utils.alnstats import external_sort_gam

        if not args.output:
            print("error [vg_tpu_torch gamsort]: --external needs --output",
                  file=sys.stderr)
            return 1
        n = external_sort_gam(args.gam, args.output,
                              chunk_records=args.chunk_size)
        print(f"sorted {n} records", file=sys.stderr)
        return 0
    from ..io.gam import read_gam, write_gam
    from ..utils.alnstats import sort_alignments

    alns = sort_alignments(list(read_gam(args.gam)))
    if args.index:
        from ..io.gam_index import write_indexed_gam

        if not args.output:
            print("error [vg_tpu_torch gamsort]: --index needs --output",
                  file=sys.stderr)
            return 1
        n = write_indexed_gam(args.output, args.index, alns)
        print(f"sorted {n} records + index", file=sys.stderr)
        return 0
    if args.output:
        with open(args.output, "wb") as f:
            write_gam(f, alns)
    else:
        write_gam(sys.stdout.buffer, alns)
    return 0


def cmd_filter(args) -> int:
    from ..io.gam import read_gam, write_gam
    from ..utils.alnstats import filter_alignments

    alns = list(filter_alignments(
        read_gam(args.gam), min_mapq=args.min_mapq,
        min_identity=args.min_identity, name_prefix=args.name_prefix,
        drop_unmapped=args.drop_unmapped, max_softclip=args.max_softclip))
    if args.output:
        with open(args.output, "wb") as f:
            write_gam(f, alns)
    else:
        write_gam(sys.stdout.buffer, alns)
    print(f"kept {len(alns)} alignments", file=sys.stderr)
    return 0


def cmd_depth(args) -> int:
    from ..call.pack import Packer

    if args.index_prefix:
        g, _, _ = _load_bundle(args.index_prefix)
    else:
        g = _load_graph_any(args.xg)
    pk = Packer.load(g, args.pack)
    for m in g.path_meta:
        cov = pk.mean_coverage(m.name)
        print(f"{m.name}\t{cov:.3f}")
    return 0




def cmd_chains(args) -> int:
    """Top-level chain decomposition (vg chains, reference
    src/subcommand/chains_main.cpp role): one line per chain listing the
    ordered snarl boundary nodes."""
    from ..graph.cactus import decompose

    g = _load_graph_any(args.graph)
    dec = decompose(g)
    sink = open(args.output, "w") if args.output else sys.stdout
    n = 0
    for ci, c in enumerate(dec.chains):
        if not c.snarls:
            continue
        cols = []
        for si in c.snarls:
            s = dec.snarls[si]
            if s.start < 0:
                continue
            cols.append(f"{int(g.node_id[s.start >> 1])}"
                        f"{'-' if s.start & 1 else '+'}"
                        f"..{int(g.node_id[s.end >> 1])}"
                        f"{'-' if s.end & 1 else '+'}")
        if cols:
            sink.write(f"chain{n}\t" + "\t".join(cols) + "\n")
            n += 1
    if args.output:
        sink.close()
    print(f"{n} chains", file=sys.stderr)
    return 0


def cmd_dotplot(args) -> int:
    """Self/other path dotplot (vg dotplot role): shared-kmer points as
    a gnuplot-ready TSV (x offset, y offset, strand)."""
    g = _load_graph_any(args.xg)
    from ..index.minimizer import extract_minimizers
    from ..utils import dna

    names = [m.name for m in g.path_meta
             if not m.name.startswith("_alt_")]
    if not names:
        print("no paths", file=sys.stderr)
        return 1
    nx = args.path_x or names[0]
    ny = args.path_y or nx

    def path_seq(name):
        pi = g.path_index(name)
        parts = []
        for h in g.path_handles(pi):
            s = g.node_seq_codes(int(g.node_id[int(h) >> 1]))
            parts.append(dna.revcomp_codes(s) if int(h) & 1 else s)
        import numpy as np
        return np.concatenate(parts) if parts else np.zeros(0, np.uint8)

    sx = path_seq(nx)
    sy = path_seq(ny)
    k = args.kmer_size
    ox, kx, rx = extract_minimizers(sx, k, args.window)
    oy, ky, ry = extract_minimizers(sy, k, args.window)
    pos_y = {}
    for o, key, r in zip(oy, ky, ry):
        pos_y.setdefault(int(key), []).append((int(o), bool(r)))
    sys.stdout.write(f"#x\ty\tstrand\t{nx}\t{ny}\n")
    n = 0
    for o, key, r in zip(ox, kx, rx):
        for oy2, r2 in pos_y.get(int(key), ()):
            sys.stdout.write(f"{int(o)}\t{oy2}\t"
                             f"{'+' if bool(r) == r2 else '-'}\n")
            n += 1
            if args.max_points and n >= args.max_points:
                return 0
    return 0


def cmd_cluster(args) -> int:
    """Seed-cluster dump for reads (vg cluster dev tool, reference
    src/subcommand/cluster_main.cpp role): per read, the candidate
    clusters the seeding stage produced — TSV of (read, slot, strand,
    text start, ref path, ref offset)."""
    from ..io.fastq import iter_fastq
    from ..map.giraffe import GiraffeMapper, GiraffeParams
    from ..utils import dna as _dna

    g, haps, idx = _load_bundle(args.index_prefix)
    m = GiraffeMapper(haps, idx, GiraffeParams(batch_reads=256),
                      device=args.device)
    reads = list(iter_fastq(args.fastq))
    sink = open(args.output, "w") if args.output else sys.stdout
    import numpy as _np

    for i0 in range(0, len(reads), 256):
        chunk = reads[i0 : i0 + 256]
        L = max(len(r.sequence) for r in chunk)
        codes2d = _np.full((len(chunk), L), 5, _np.uint8)
        for i, r in enumerate(chunk):
            c = _dna.encode(r.sequence)
            codes2d[i, : len(c)] = c
        cand = m._seed_batch(codes2d)
        start, lo, hi, rev, valid, rp, ro = cand[:7]
        for i, r in enumerate(chunk):
            for j in range(start.shape[1]):
                if not valid[i, j]:
                    continue
                sink.write(f"{r.name}\t{j}\t"
                           f"{'-' if rev[i, j] else '+'}\t"
                           f"{int(start[i, j])}\t{int(rp[i, j])}\t"
                           f"{int(ro[i, j])}\n")
    if args.output:
        sink.close()
    return 0


def cmd_zipcode(args) -> int:
    """Distance-oracle dump (vg zipcode dev tool, reference
    src/subcommand/zipcode_main.cpp role): for random position pairs,
    the text-position distance (this design's zipcode equivalent,
    ARCHITECTURE.md) and, when a distance index is given, the
    snarl-tree oracle's answer."""
    import numpy as _np

    g, haps, idx = _load_bundle(args.index_prefix)
    di = None
    if args.dist:
        from ..graph.distindex import DistanceIndex

        di = DistanceIndex.load(args.dist, g)
    rng = _np.random.default_rng(args.seed)
    T = haps.total_len
    sink = open(args.output, "w") if args.output else sys.stdout
    for _ in range(args.n):
        a = int(rng.integers(0, T))
        b = int(rng.integers(0, T))
        # same-copy text distance (the production pairing metric —
        # this design's zipcode equivalent, ARCHITECTURE.md)
        txt_d = abs(b - a)
        row = [str(a), str(b), str(txt_d)]
        if di is not None:
            na, oa, _ra = haps.text_pos_to_graph(a)
            nb, ob, _rb = haps.text_pos_to_graph(b)
            d = di.upper_bound((na, oa), (nb, ob))
            row.append("inf" if d is None else str(d))
        sink.write("\t".join(row) + "\n")
    if args.output:
        sink.close()
    return 0


def cmd_chain(args) -> int:
    """Solve a serialized hit-chaining problem dump (vg chain, reference
    src/subcommand/chain_main.cpp:298): the input JSON carries a
    subgraph ({"node": [{id, sequence}], "edge": [...]}) and chainable
    items with read intervals + single-node graph positions
    (read_start/read_end/score/graph_start{node_id, offset,
    is_reverse}). Items are projected onto a linearization of the
    subgraph (the text-coordinate analogue of the reference's
    distance-index transition costs) and chained with the anchor DP
    (map/chain.py + native chain_anchors_dp)."""
    import json as _json

    import numpy as np

    from ..map.chain import ChainParams, backtrack_chains, chain_anchors

    with open(args.input) as f:
        prob = _json.load(f)
    sub_g = prob.get("subgraph") or {}
    nodes = {}
    for nd in (sub_g.get("node") or []):
        nodes[int(nd["id"])] = len(nd.get("sequence", "") or "")
    # linearization: ascending node id (constructor ids ascend along the
    # reference path); offset = prefix sum of node lengths
    off = {}
    run = 0
    for nid in sorted(nodes):
        off[nid] = run
        run += max(nodes[nid], 1)
    items = prob.get("items") or []
    roff, tpos, ascore = [], [], []
    for it in items:
        rs = int(it.get("read_start", 0))
        re_ = int(it.get("read_end", rs))
        gs = it.get("graph_start") or {}
        nid = int(gs.get("node_id", 0))
        noff = int(gs.get("offset", 0) or 0)
        roff.append(rs)
        tpos.append(off.get(nid, 0) + noff)
        ascore.append(int(it.get("score", max(re_ - rs, 1))))
    if args.progress:
        print(f"Reconstructed {len(items)} chainable items",
              file=sys.stderr)
    if not roff:
        print("Best chain gets score 0")
        return 0
    roff = np.asarray(roff, np.int64)
    tpos = np.asarray(tpos, np.int64)
    ascore = np.asarray(ascore, np.float64)
    order = np.lexsort((roff, tpos))
    params = ChainParams(min_chain_score=0.0,
                         gap_open=6.0 + float(
                             args.recombination_penalty or 0.0))
    f_dp, parent = chain_anchors(roff[order], tpos[order],
                                 ascore[order], params)
    chains = backtrack_chains(f_dp, parent, params)
    if not chains:
        print("Best chain gets score 0")
        return 0
    best = chains[0]
    print(f"Best chain gets score {int(round(f_dp[best[-1]]))}")
    print("chain items: "
          + " ".join(str(int(order[i])) for i in best))
    return 0


def cmd_bench_dist_query(args) -> int:
    """Distance-query microbenchmark (reference
    src/subcommand/bench_dist_query_main.cpp role): random position
    pairs against the distance oracle, reports queries/s."""
    import time as _time

    import numpy as _np

    g = _load_graph_any(args.graph)
    from ..graph.distindex import DistanceIndex

    if args.dist:
        di = DistanceIndex.load(args.dist, g)
    else:
        di = DistanceIndex.build(g)
    rng = _np.random.default_rng(1)
    n = g.node_count
    pairs = [(int(rng.integers(0, n)), int(rng.integers(0, n)))
             for _ in range(args.n)]
    t0 = _time.time()
    total = 0
    for a, b in pairs:
        d = di.upper_bound((int(g.node_id[a]), 0), (int(g.node_id[b]), 0))
        total += 0 if d is None else 1
    dt = _time.time() - t0
    print(f"{args.n} queries in {dt:.3f}s = {args.n/max(dt,1e-9):.0f} "
          f"queries/s ({total} finite)")
    return 0


def cmd_test(args) -> int:
    """Run the port's unit tests, tests/test_torch_*.py (the reference's
    hidden `vg test` subcommand, src/subcommand/test_main.cpp, runs its
    Catch2 suite)."""
    import glob
    import os
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "pytest",
           *sorted(glob.glob(os.path.join(repo, "tests", "test_torch_*.py")))
           ] + (args.pytest_args or ["-q"])
    return subprocess.call(cmd, cwd=repo)


def cmd_benchmark(args) -> int:
    """Built-in micro-benchmark (vg benchmark role): construct + index +
    map a small synthetic pangenome and print stage timings."""
    import time as _time

    import numpy as np

    from ..construct.constructor import Constructor, ConstructorParams
    from ..index.haplotypes import thread_haplotypes
    from ..index.minimizer import MinimizerIndex
    from ..io.fastq import Read
    from ..io.vcf import VcfFile, VcfRecord
    from ..map.giraffe import GiraffeMapper, GiraffeParams
    from ..utils import dna

    rng = np.random.default_rng(1)
    ref_codes = rng.integers(0, 4, args.size).astype(np.uint8)
    ref = dna.decode(ref_codes)
    recs = []
    for p in range(100, args.size - 100, 997):
        r = ref[p]
        alt = "ACGT"[("ACGT".index(r) + 1) % 4]
        recs.append(VcfRecord("r", p + 1, ".", r, [alt], ".", ".", {},
                              [((1, 0), True)]))
    vcf = VcfFile(samples=["s"], records=recs)
    t0 = _time.time()
    g, results = Constructor(ConstructorParams()).construct_graph(
        {"r": ref}, vcf)
    t1 = _time.time()
    haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps)
    t2 = _time.time()
    m = GiraffeMapper(haps, idx, GiraffeParams(batch_reads=512),
                      device=args.device)
    reads = []
    T = len(haps.text)
    for i in range(1024):
        s = int(rng.integers(0, T - 150))
        reads.append(Read(f"b{i}", dna.decode(haps.text[s : s + 150]),
                          ""))
    m.map_batch(reads[:512])        # warm
    t3 = _time.time()
    alns = m.map_batch(reads[512:])
    t4 = _time.time()
    aligned = sum(1 for a in alns if a.path)
    print(f"construct\t{t1-t0:.3f}s")
    print(f"index\t{t2-t1:.3f}s")
    print(f"map\t{t4-t3:.3f}s\t{len(alns)/(t4-t3):.0f} reads/s\t"
          f"{aligned}/{len(alns)} aligned")
    return 0


def cmd_snarls(args) -> int:
    """Nested snarl decomposition via the cactus machinery (reference:
    IntegratedSnarlFinder, src/integrated_snarl_finder.cpp; handles
    cyclic graphs, inversions, and off-path bubbles)."""
    from ..graph.cactus import decompose
    from ..graph.snarls import Snarl, snarl_traversals

    g = _load_graph_any(args.xg)
    dec = decompose(g)
    for si in dec.real_snarls():
        s = dec.snarls[si]
        contents = dec.snarl_contents(si)
        if not contents and not args.include_trivial:
            continue
        ci = s.chain
        parent = dec.chains[ci].parent_snarl if ci >= 0 else -1
        if parent >= 0 and dec.snarls[parent].start < 0:
            parent = -1              # root pseudo-snarl = top level
        d = {
            "start": {"node_id": str(int(g.node_id[s.start >> 1])),
                      "backward": bool(s.start & 1)},
            "end": {"node_id": str(int(g.node_id[s.end >> 1])),
                    "backward": bool(s.end & 1)},
            "contents": [str(int(g.node_id[i])) for i in contents],
        }
        if parent >= 0:
            p = dec.snarls[parent]
            d["parent"] = {
                "start": {"node_id": str(int(g.node_id[p.start >> 1]))},
                "end": {"node_id": str(int(g.node_id[p.end >> 1]))},
            }
        if args.traversals:
            legacy = Snarl(start=s.start, end=s.end, contents=list(contents))
            d["traversals"] = [
                [("<" if h & 1 else ">") + str(int(g.node_id[h >> 1]))
                 for h in t]
                for t in snarl_traversals(g, legacy)]
        sys.stdout.write(json.dumps(d) + "\n")
    return 0




def cmd_rna(args) -> int:
    from ..io.gtf import read_gtf
    from ..rna.transcriptome import Transcriptome

    haps = None
    if args.index_prefix:
        g, haps, _ = _load_bundle(args.index_prefix)
    else:
        g = _load_graph_any(args.graph)
    ts = read_gtf(args.transcripts)
    tr = Transcriptome(g)
    if args.haplotype_transcripts:
        if haps is None:
            print("error [vg_tpu_torch rna]: -l needs -Z with indexed "
                  "haplotypes", file=sys.stderr)
            return 1
        g2, hap_ts = tr.project_haplotypes(ts, haps)
        projected = [p for p in tr._last_projected]
        if args.output:
            _save_graph_any(g2, args.output)
        if args.index_out:
            # pantranscriptome bundle: map RNA reads with giraffe/mpmap -Z
            from ..index.minimizer import MinimizerIndex
            from ..io import native
            from ..rna.transcriptome import Transcriptome as _T

            tx_haps = _T.pantranscriptome_haplotypes(g2, projected, hap_ts)
            gp, hp_, mp_ = _bundle_paths(args.index_out)
            native.save_graph(gp, g2)
            native.save_haplotypes(hp_, tx_haps)
            native.save_minimizer(mp_, MinimizerIndex.build(tx_haps))
            print(f"pantranscriptome index: {tx_haps.count} transcript "
                  f"texts ({tx_haps.total_len} bp)", file=sys.stderr)
        for ht in hap_ts:
            sys.stdout.write(f"{ht.transcript_id}\t{ht.path_name}"
                             f"\t{ht.strand}\t{','.join(ht.haplotypes)}\n")
        print(f"projected {len(projected)} transcripts, "
              f"{len(hap_ts)} haplotype-specific", file=sys.stderr)
        return 0
    g2, projected = tr.project(ts)
    if args.output:
        _save_graph_any(g2, args.output)
    if args.fasta:
        sys.stdout.write(Transcriptome.transcript_fasta(g2, projected))
    else:
        for p in projected:
            sys.stdout.write(f"{p.transcript_id}\t{p.length}\t{p.n_exons}"
                             f"\t{p.strand}\n")
    print(f"projected {len(projected)} transcripts", file=sys.stderr)
    return 0




def cmd_mcmc(args) -> int:
    """Phased genotyping by Gibbs sampling (vg mcmc,
    reference src/subcommand/mcmc_main.cpp): sample a diploid pair of
    haplotypes from mapped reads and embed them as paths."""
    from ..call.mcmc import MCMCGenotyper, MCMCParams
    from ..io.gam import read_gam

    g = _load_graph_any(args.graph)
    alns = list(read_gam(args.gam))
    mc = MCMCGenotyper(g, ref_path=args.ref_path,
                       params=MCMCParams(n_iter=args.iterations,
                                         seed=args.seed))
    h1, h2, logp = mc.run(alns)
    for si, site in enumerate(mc.sites):
        s_id = int(g.node_id[int(site.snarl.start) >> 1])
        e_id = int(g.node_id[int(site.snarl.end) >> 1])
        print(f"site {s_id}..{e_id}: {int(h1[si])}|{int(h2[si])}",
              file=sys.stderr)
    print(f"MAP log-likelihood: {logp:.2f} over {len(mc.sites)} sites",
          file=sys.stderr)
    out_g = mc.embed_haplotypes(h1, h2, sample=args.sample)
    _save_graph_any(out_g, args.output)
    return 0


def cmd_msga(args) -> int:
    from ..construct.msa import msa_to_graph, parse_aligned_fasta

    with open(args.msa) as f:
        rows = parse_aligned_fasta(f.read())
    g = msa_to_graph(rows)
    if args.output:
        _save_graph_any(g, args.output)
    else:
        from ..io import gfa
        gfa.write_gfa(g, sys.stdout)
    print(f"msa graph: {g.node_count} nodes from {len(rows)} sequences",
          file=sys.stderr)
    return 0


def cmd_viz(args) -> int:
    g = _load_graph_any(args.xg)
    if args.out and args.out.endswith(".svg") or args.format == "svg":
        from ..utils.viz import to_svg

        alns = None
        if args.gam_in:
            from ..io.gam import read_gam

            alns = []
            for path in args.gam_in:
                alns.extend(read_gam(path))
        svg = to_svg(g, alignments=alns, width=args.width,
                     max_nodes=args.max_nodes)
        if args.out:
            with open(args.out, "w") as f:
                f.write(svg)
        else:
            sys.stdout.write(svg)
        return 0
    from ..utils.viz import to_dot

    out = to_dot(g, max_nodes=args.max_nodes)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
    else:
        sys.stdout.write(out)
    return 0


def cmd_simplify(args) -> int:
    from ..graph.simplify import simplify_small_snarls

    g = _load_graph_any(args.input)
    ref = args.path or g.path_meta[0].name
    g2 = simplify_small_snarls(g, ref, args.max_bubble)
    _save_graph_any(g2, args.output)
    print(f"simplified: {g.node_count} -> {g2.node_count} nodes",
          file=sys.stderr)
    return 0


def cmd_trace(args) -> int:
    from ..index.haplotypes import haplotypes_from_paths

    if args.index_prefix:
        g, haps, _ = _load_bundle(args.index_prefix)
    else:
        g = _load_graph_any(args.xg)
        haps = haplotypes_from_paths(g)
    target = int(args.node)
    for h in range(haps.count):
        s0, s1 = int(haps.steps_start[h]), int(haps.steps_start[h + 1])
        walk = haps.steps[s0:s1]
        hits = [i for i, hd in enumerate(walk)
                if int(g.node_id[int(hd) >> 1]) == target]
        for i in hits:
            a = max(0, i - args.context)
            z = min(len(walk), i + args.context + 1)
            steps = "".join(("<" if int(hd) & 1 else ">")
                            + str(int(g.node_id[int(hd) >> 1]))
                            for hd in walk[a:z])
            sys.stdout.write(f"{haps.metas[h].name}\t{steps}\n")
    return 0


def cmd_sort(args) -> int:
    from ..graph import ops
    from ..ops.graph_align import topological_handles

    g = _load_graph_any(args.input)
    order = topological_handles(g)
    if order is None:
        print("error [vg_tpu_torch sort]: graph is cyclic", file=sys.stderr)
        return 1
    seen = []
    got = set()
    for h in order:
        nid = int(g.node_id[h >> 1])
        if nid not in got:
            got.add(nid)
            seen.append(nid)
    id_map = {nid: i + 1 for i, nid in enumerate(seen)}
    g2 = ops._builder_from(g, id_map=id_map).freeze()
    _save_graph_any(g2, args.output)
    return 0


def cmd_vectorize(args) -> int:
    from ..io.gam import read_gam

    for a in read_gam(args.gam):
        mapped = 1 if (a.path and a.path.mappings) else 0
        softclip = 0
        matches = mism = ins = dele = 0
        if mapped:
            edits = [e for mp in a.path.mappings for e in mp.edits]
            for e in edits:
                if e.from_length == e.to_length:
                    if e.sequence:
                        mism += e.to_length
                    else:
                        matches += e.to_length
                elif e.from_length == 0:
                    ins += e.to_length
                else:
                    dele += e.from_length
            if edits and edits[0].from_length == 0:
                softclip += edits[0].to_length
            if edits and edits[-1].from_length == 0:
                softclip += edits[-1].to_length
        row = [a.name, len(a.sequence), mapped, a.score, a.mapping_quality,
               round(a.identity, 4), matches, mism, ins, dele, softclip]
        sys.stdout.write("\t".join(str(x) for x in row) + "\n")
    return 0


def cmd_describe(args) -> int:
    import numpy as np

    path = args.input
    kind = "unknown"
    if path.endswith(".npz"):
        try:
            data = np.load(path)
            import json as _json
            meta = _json.loads(bytes(data["meta"]).decode())
            kind = meta.get("kind", "npz")
        except Exception:
            kind = "npz (no vg_tpu metadata)"
    elif path.endswith((".gfa",)):
        kind = "GFA graph"
    elif path.endswith((".vg",)):
        kind = "vg protobuf graph"
    elif path.endswith((".gam",)):
        kind = "GAM alignments"
    elif path.endswith((".gaf",)):
        kind = "GAF alignments"
    print(f"{path}: {kind}")
    return 0


def cmd_version(args) -> int:
    from .. import __version__

    print(f"vg_tpu_torch {__version__}")
    return 0




def cmd_mpmap(args) -> int:
    from ..io.fastq import iter_fastq
    from ..io.gamp import write_gamp
    from ..map.giraffe import GiraffeMapper, GiraffeParams
    from ..map.mpmap import MultipathMapper

    g, haps, idx = _load_bundle(args.index_prefix)
    mm = MultipathMapper(GiraffeMapper(
        haps, idx, GiraffeParams(
            batch_reads=args.batch_size,
            qual_adjusted=not getattr(args, "no_qual_adjust", False)),
        device=args.device))
    mps = []
    if getattr(args, "fastq_mate", None):
        from ..io.fastq import iter_fastq_paired

        batch = []
        for pair in iter_fastq_paired(args.fastq, args.fastq_mate):
            batch.append(pair)
            if len(batch) >= args.batch_size:
                for a, b in mm.map_pairs(batch):
                    mps.extend((a, b))
                batch = []
        if batch:
            for a, b in mm.map_pairs(batch):
                mps.extend((a, b))
    else:
        batch = []
        for r in iter_fastq(args.fastq):
            batch.append(r)
            if len(batch) >= args.batch_size:
                mps.extend(mm.map_batch(batch))
                batch = []
        if batch:
            mps.extend(mm.map_batch(batch))
    if args.output:
        with open(args.output, "wb") as f:
            write_gamp(f, mps)
    else:
        write_gamp(sys.stdout.buffer, mps)
    print(f"mpmap: {len(mps)} multipath alignments", file=sys.stderr)
    return 0




def cmd_annotate(args) -> int:
    from ..io.gam import read_gam, write_gam
    from ..map.project import PathPositionIndex

    g = _load_graph_any(args.xg)
    ppi = PathPositionIndex(g)
    alns = []
    for a in read_gam(args.gam):
        ppi.annotate_refpos(a)
        alns.append(a)
    if args.output:
        with open(args.output, "wb") as f:
            write_gam(f, alns)
    else:
        write_gam(sys.stdout.buffer, alns)
    return 0




def cmd_convert(args) -> int:
    g = _load_graph_any(args.input)
    if args.output.endswith(".gbz"):
        from ..index.haplotypes import haplotypes_from_paths
        from ..io.gbz_write import write_gbz

        write_gbz(args.output, g, haplotypes_from_paths(g))
        return 0
    _save_graph_any(g, args.output)
    return 0


def cmd_gampcompare(args) -> int:
    from ..io.gamp import read_gamp
    from ..io.gam import read_gam
    from ..map.gamcompare import compare

    test = [mp.best_alignment() for mp in read_gamp(args.gamp)]
    truth = list(read_gam(args.truth_gam))
    # positions for the converted alignments
    g = _load_graph_any(args.xg) if args.xg else None
    if g is not None:
        from ..map.project import PathPositionIndex

        ppi = PathPositionIndex(g)
        for a in test:
            ppi.annotate_refpos(a)
    stats = compare(test, truth, range_bp=args.range)
    print(json.dumps(stats))
    return 0




def cmd_haplotypes(args) -> int:
    from ..index.minimizer import MinimizerIndex
    from ..index.sampling import recombine_haplotypes, sample_haplotypes
    from ..io import native
    from ..io.fastq import iter_fastq

    if not getattr(args, "kff", None) and not args.fastq:
        print("haplotypes: need -f reads or -k counts.kff",
              file=sys.stderr)
        return 1
    g, haps, _ = _load_bundle(args.index_prefix)
    if getattr(args, "kff", None):
        # kmer-count-driven diploid sampling (reference vg haplotypes -k
        # counts.kff --diploid-sampling, Recombinator select_diploid)
        from ..index.sampling import recombine_haplotypes_diploid
        from ..io.kff import read_kff

        kk, kmers, counts = read_kff(args.kff)
        sampled = recombine_haplotypes_diploid(
            haps, kmers, counts, subchain_len=args.subchain_length, k=kk)
        if getattr(args, "gbz_out", None):
            # emit the sampled personal pangenome as a real GBZ (the
            # reference's haplotypes -g: the artifact giraffe consumes)
            from ..io.gbz_write import write_gbz

            write_gbz(args.gbz_out, g, sampled)
            print(f"wrote sampled GBZ {args.gbz_out}", file=sys.stderr)
        gp, hp, mp = _bundle_paths(args.output_prefix)
        native.save_graph(gp, g)
        native.save_haplotypes(hp, sampled)
        native.save_minimizer(mp, MinimizerIndex.build(sampled))
        print(f"sampled {sampled.count} haplotypes "
              f"({sampled.total_len} bp text)", file=sys.stderr)
        return 0
    reads = []
    for i, r in enumerate(iter_fastq(args.fastq)):
        reads.append(r)
        if i >= args.max_reads:
            break
    if args.recombine:
        sampled = recombine_haplotypes(haps, reads,
                                       num_haplotypes=args.num_haplotypes,
                                       subchain_len=args.subchain_length)
    else:
        sampled = sample_haplotypes(haps, reads,
                                    num_haplotypes=args.num_haplotypes)
    gp, hp, mp = _bundle_paths(args.output_prefix)
    native.save_graph(gp, g)
    native.save_haplotypes(hp, sampled)
    native.save_minimizer(mp, MinimizerIndex.build(sampled))
    print(f"sampled {sampled.count} haplotypes "
          f"({sampled.total_len} bp text)", file=sys.stderr)
    return 0


# ----------------------------------------------------------------- parser

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="vg_tpu_torch", description="TPU-native pangenome toolkit")
    sub = ap.add_subparsers(dest="command", required=True)

    c = sub.add_parser("construct", help="FASTA+VCF -> graph")
    c.add_argument("-r", "--reference", required=True)
    c.add_argument("-v", "--vcf")
    c.add_argument("-m", "--node-max", type=int, default=32)
    c.add_argument("-a", "--alt-paths", action="store_true")
    c.add_argument("-o", "--output")
    c.set_defaults(func=cmd_construct)

    # `index` = autoindex alias (the reference's manual index builder
    # role is covered by the recipe-solving autoindexer); one arg set,
    # registered under both names
    for _name, _help in (("autoindex",
                          "build graph + haplotype text + minimizer index"),
                         ("index", "alias of autoindex")):
        a = sub.add_parser(_name, help=_help)
        a.add_argument("-r", "--reference")
        a.add_argument("-v", "--vcf")
        a.add_argument("-g", "--gfa")
        a.add_argument("-Z", "--gbz")
        a.add_argument("--gbz-out", help="also export the index as a GBZ")
        a.add_argument("-m", "--node-max", type=int, default=32)
        a.add_argument("-k", "--kmer-length", type=int, default=29)
        a.add_argument("-w", "--window-length", type=int, default=11)
        a.add_argument("-p", "--prefix", required=True)
        a.set_defaults(func=cmd_autoindex)

    gme = sub.add_parser("giraffe", help="map reads")
    gme.add_argument("-Z", "--index-prefix", required=True)
    gme.add_argument("-f", "--fastq")
    gme.add_argument("-G", "--gam-in",
                     help="take input reads from a GAM (vg map -G role)")
    gme.add_argument("-2", "--fastq-mate")
    gme.add_argument("-i", "--interleaved", action="store_true")
    gme.add_argument("-o", "--output-format", default="gam",
                     choices=["gam", "gaf", "json", "sam"])
    gme.add_argument("--kff-name",
                     help="sample haplotypes with these kmer counts "
                          "before mapping (giraffe-integrated sampling)")
    gme.add_argument("-B", "--batch-size", type=int, default=512)
    gme.add_argument("-M", "--max-multimaps-internal", type=int, default=8)
    gme.add_argument("--output")
    gme.add_argument("-b", "--parameter-preset", default="default",
                     choices=["default", "fast", "hifi", "r10", "lr"])
    gme.add_argument("--track-provenance", action="store_true",
                     help="funnel stage annotations + stderr report")
    gme.add_argument("--comments-as-tags", action="store_true",
                     help="carry FASTQ header comments into output "
                          "tags (SAM/BAM columns, GAF columns, GAM "
                          "annotation on object paths)")
    gme.add_argument("--full-l-bonus", type=int,
                     help="full-length end bonus override")
    gme.add_argument("--sweep", action="append",
                     help="parameter grid sweep key=start:end[:step] "
                          "(repeatable; one mapping run per combination, "
                          "outputs suffixed with the grid point)")
    gme.set_defaults(func=cmd_giraffe)

    s = sub.add_parser("surject", help="GAM -> SAM/BAM on reference paths")
    s.add_argument("-Z", "--index-prefix")
    s.add_argument("-x", "--xg")
    s.add_argument("-i", "--input", required=True)
    s.add_argument("-p", "--path")
    s.add_argument("--paired", action="store_true")
    s.add_argument("-b", "--bam", metavar="FILE",
                   help="write BAM to FILE ('-' for stdout) instead of SAM")
    s.add_argument("-c", "--cram", metavar="FILE",
                   help="write CRAM to FILE ('-' for stdout) "
                        "(reference hts_alignment_emitter.hpp:131-289)")
    s.add_argument("--sample")
    s.add_argument("--read-group")
    s.set_defaults(func=cmd_surject)

    pk = sub.add_parser("pack", help="GAM -> coverage")
    pk.add_argument("-Z", "--index-prefix")
    pk.add_argument("-x", "--xg")
    pk.add_argument("-g", "--gam", required=True)
    pk.add_argument("-o", "--output")
    pk.add_argument("-d", "--dump", action="store_true")
    pk.set_defaults(func=cmd_pack)

    cl = sub.add_parser("call", help="pack -> VCF genotypes")
    cl.add_argument("-Z", "--index-prefix")
    cl.add_argument("-x", "--xg")
    cl.add_argument("-k", "--pack", required=True)
    cl.add_argument("-p", "--path")
    cl.add_argument("-s", "--sample", default="SAMPLE")
    cl.add_argument("-g", "--gbwt-restrict", action="store_true",
                    help="restrict alleles to indexed haplotype walks")
    cl.add_argument("-v", "--vcf",
                    help="genotype exactly these VCF sites (VCFGenotyper "
                         "mode; graph must be built with construct -a)")
    cl.add_argument("-T", "--traversals-out",
                    help="write called allele traversals as GAF walks")
    cl.set_defaults(func=cmd_call)

    v = sub.add_parser("view", help="format conversion")
    v.add_argument("input")
    v.add_argument("-a", "--gam-json", action="store_true",
                   help="GAM -> JSON lines")
    v.add_argument("-g", "--gfa-out", action="store_true")
    v.add_argument("-t", "--turtle", action="store_true",
                   help="RDF/Turtle output (vg ontology)")
    v.add_argument("-r", "--rdf-base-uri",
                   default="http://example.org/vg/")
    v.add_argument("-o", "--output")
    v.set_defaults(func=cmd_view)

    st = sub.add_parser("stats", help="graph or alignment metrics")
    st.add_argument("input")
    st.add_argument("-a", "--alignments", action="store_true")
    st.set_defaults(func=cmd_stats)

    pa = sub.add_parser("paths", help="list/extract paths")
    pa.add_argument("-x", "--xg", required=True)
    pa.add_argument("-F", "--fasta", action="store_true")
    pa.add_argument("-X", "--extract-gam", action="store_true")
    pa.set_defaults(func=cmd_paths)

    sm = sub.add_parser("sim", help="simulate reads with truth")
    sm.add_argument("-Z", "--index-prefix")
    sm.add_argument("-x", "--xg")
    sm.add_argument("-n", "--num-reads", type=int, default=100)
    sm.add_argument("-l", "--read-length", type=int, default=100)
    sm.add_argument("-e", "--error-rate", type=float, default=0.0)
    sm.add_argument("-i", "--indel-rate", type=float, default=0.0)
    sm.add_argument("-s", "--seed", type=int, default=0)
    sm.add_argument("-a", "--align-out", action="store_true")
    sm.add_argument("--output")
    sm.set_defaults(func=cmd_sim)

    gc = sub.add_parser("gamcompare", help="mapping correctness vs truth")
    gc.add_argument("gam")
    gc.add_argument("truth_gam")
    gc.add_argument("-r", "--range", type=int, default=100)
    gc.add_argument("-d", "--distance-graph",
                    help="graph file: use graph min-distance instead of refpos")
    gc.set_defaults(func=cmd_gamcompare)

    me = sub.add_parser("mapeval", help="simulate+map+score accuracy")
    me.add_argument("-Z", "--index-prefix", required=True)
    me.add_argument("-n", "--num-reads", type=int, default=1000)
    me.add_argument("-l", "--read-length", type=int, default=150)
    me.add_argument("-e", "--error-rate", type=float, default=0.01)
    me.add_argument("-i", "--indel-rate", type=float, default=0.0)
    me.add_argument("-p", "--paired", action="store_true")
    me.add_argument("-s", "--seed", type=int, default=7)
    me.add_argument("-r", "--range", type=int, default=100)
    me.add_argument("-B", "--batch-size", type=int, default=512)
    me.set_defaults(func=cmd_mapeval)

    va = sub.add_parser("validate", help="graph invariants")
    va.add_argument("-x", "--xg", required=True)
    va.set_defaults(func=cmd_validate)


    dc = sub.add_parser("deconstruct", help="graph+haplotypes -> VCF")
    dc.add_argument("-Z", "--index-prefix")
    dc.add_argument("-x", "--xg")
    dc.add_argument("-p", "--path")
    dc.set_defaults(func=cmd_deconstruct)

    ids = sub.add_parser("ids", help="node id manipulation")
    ids.add_argument("input")
    ids.add_argument("-c", "--compact", action="store_true")
    ids.add_argument("-i", "--increment", type=int, default=0)
    ids.add_argument("-o", "--output", required=True)
    ids.set_defaults(func=cmd_ids)

    ch = sub.add_parser("chunk", help="extract a path region subgraph")
    ch.add_argument("-x", "--xg", required=True)
    ch.add_argument("-p", "--path-range", required=True,
                    help="path:start-end")
    ch.add_argument("-c", "--context", type=int, default=1)
    ch.add_argument("-o", "--output", required=True)
    ch.set_defaults(func=cmd_chunk)

    cb = sub.add_parser("combine", help="merge graphs")
    cb.add_argument("inputs", nargs="+")
    cb.add_argument("-o", "--output", required=True)
    cb.set_defaults(func=cmd_combine)

    mk = sub.add_parser("mask", help="N-mask BED regions")
    mk.add_argument("-x", "--xg", required=True)
    mk.add_argument("-b", "--bed", required=True)
    mk.add_argument("-o", "--output", required=True)
    mk.set_defaults(func=cmd_mask)

    ci = sub.add_parser("circularize", help="circularize a path")
    ci.add_argument("input")
    ci.add_argument("-p", "--path", required=True)
    ci.add_argument("-o", "--output", required=True)
    ci.set_defaults(func=cmd_circularize)

    mo = sub.add_parser("mod", help="path retention edits")
    mo.add_argument("input")
    mo.add_argument("-r", "--retain-paths")
    mo.add_argument("-d", "--drop-paths")
    mo.add_argument("-o", "--output", required=True)
    mo.set_defaults(func=cmd_mod)

    pr = sub.add_parser("prune", help="cut high-degree hairballs")
    pr.add_argument("input")
    pr.add_argument("-M", "--max-degree", type=int, default=8)
    pr.add_argument("-o", "--output", required=True)
    pr.set_defaults(func=cmd_prune)

    fd = sub.add_parser("find", help="node-context subgraph / indexed GAM lookup")
    fd.add_argument("-x", "--xg")
    fd.add_argument("-n", "--node", action="append", required=True)
    fd.add_argument("-c", "--context", type=int, default=1)
    fd.add_argument("-l", "--alignments", metavar="SORTED.gam",
                    help="pull alignments touching the nodes from an indexed GAM")
    fd.add_argument("--gai", help="index path (default: SORTED.gam.gai)")
    fd.add_argument("-o", "--output", required=True)
    fd.set_defaults(func=cmd_find)

    au = sub.add_parser("augment", help="embed GAM edits into graph")
    au.add_argument("input")
    au.add_argument("gam")
    au.add_argument("-o", "--output", required=True)
    au.add_argument("-Z", "--translation",
                    help="write the old->new node translation (JSON)")
    au.add_argument("-m", "--min-coverage", type=int, default=0,
                    help="only embed edits supported by >= N reads")
    au.set_defaults(func=cmd_augment)

    tr2 = sub.add_parser("translate",
                         help="project GAM through an augment translation")
    tr2.add_argument("translation")
    tr2.add_argument("gam")
    tr2.add_argument("-x", "--graph", required=True,
                     help="the augmented graph")
    tr2.add_argument("--output")
    tr2.set_defaults(func=cmd_translate)

    gt = sub.add_parser("genotype",
                        help="legacy augment-based genotyper")
    gt.add_argument("graph")
    gt.add_argument("gam")
    gt.add_argument("-p", "--path")
    gt.add_argument("-s", "--sample", default="SAMPLE")
    gt.add_argument("-m", "--min-support", type=int, default=3,
                    help="augment support threshold for novel edits")
    gt.set_defaults(func=cmd_genotype)

    cc = sub.add_parser("concat", help="join graphs head-to-tail")
    cc.add_argument("inputs", nargs="+")
    cc.add_argument("-o", "--output", required=True)
    cc.set_defaults(func=cmd_concat)

    gb = sub.add_parser("gbwt",
                        help="haplotype index report / GBZ export")
    gb.add_argument("-Z", "--index-prefix", required=True)
    gb.add_argument("-o", "--output", help="export GBZ here")
    gb.set_defaults(func=cmd_gbwt)

    km = sub.add_parser("kmers", help="graph kmers with positions")
    km.add_argument("-Z", "--index-prefix", required=True)
    km.add_argument("-k", "--kmer-size", type=int, default=16)
    km.add_argument("--head", type=int, default=0,
                    help="stop after N kmers (0 = all)")
    km.set_defaults(func=cmd_kmers)

    mz = sub.add_parser("minimizer",
                        help="(re)build the minimizer index standalone")
    mz.add_argument("-Z", "--index-prefix", required=True)
    mz.add_argument("-k", "--kmer-length", type=int, default=29)
    mz.add_argument("-w", "--window-length", type=int, default=11)
    mz.add_argument("-c", "--closed-syncmers", action="store_true",
                    help="index closed syncmers instead of minimizers")
    mz.add_argument("-s", "--smer-length", type=int, default=18,
                    help="s-mer length for closed syncmers")
    mz.add_argument("-W", "--weighted", action="store_true",
                    help="use weighted minimizers (downweight frequent "
                         "kmers)")
    mz.add_argument("--threshold", type=int, default=500,
                    help="downweight kmers with more than N occurrences")
    mz.add_argument("--iterations", type=int, default=3,
                    help="downweighting re-hash iterations")
    mz.add_argument("-o", "--output")
    mz.set_defaults(func=cmd_minimizer)

    ad = sub.add_parser("add", help="embed new VCF alleles into a graph")
    ad.add_argument("input")
    ad.add_argument("-v", "--vcf", required=True)
    ad.add_argument("-o", "--output", required=True)
    ad.set_defaults(func=cmd_add)

    pr2 = sub.add_parser("primers",
                         help="filter primers overlapping variation")
    pr2.add_argument("primers", help="TSV/BED: name, start, end")
    pr2.add_argument("-x", "--xg", required=True)
    pr2.add_argument("-p", "--path", required=True)
    pr2.add_argument("--all", action="store_true",
                     help="keep all rows, annotate variable ones")
    pr2.set_defaults(func=cmd_primers)

    cp = sub.add_parser("clip", help="remove non-reference variation")
    cp.add_argument("input")
    cp.add_argument("-p", "--path", required=True)
    cp.add_argument("-b", "--bed", help="BED of regions to clip")
    cp.add_argument("-k", "--pack", help="pack file for depth clipping")
    cp.add_argument("-d", "--min-depth", type=float, default=0.0)
    cp.add_argument("-o", "--output", required=True)
    cp.set_defaults(func=cmd_clip)


    al = sub.add_parser("align", help="POA local alignment to a small graph")
    al.add_argument("graph")
    al.add_argument("-s", "--sequence", required=True)
    al.add_argument("-n", "--name")
    al.add_argument("-G", "--global-aln", action="store_true")
    al.set_defaults(func=cmd_align)

    mp = sub.add_parser(
        "map", help="MEM-based mapper (suffix-array seeding, vg map role)")
    mp.add_argument("-Z", "--index-prefix", required=True)
    mp.add_argument("-f", "--fastq", required=True)
    mp.add_argument("-2", "--fastq-mate")
    mp.add_argument("-i", "--interleaved", action="store_true")
    mp.add_argument("-o", "--output-format", default="gam",
                    choices=["gam", "gaf", "json", "sam"])
    mp.add_argument("-B", "--batch-size", type=int, default=512)
    mp.add_argument("-M", "--max-multimaps-internal", type=int, default=8)
    mp.add_argument("--output")
    mp.add_argument("-b", "--parameter-preset", default="default")
    mp.add_argument("--track-provenance", action="store_true")
    mp.add_argument("--engine", default="mem", choices=["mem", "giraffe"],
                    help="seeding engine (MEMs by default; vg map role)")
    mp.add_argument("-A", "--qual-adjust", action="store_true",
                    help="base-quality-adjusted alignment scores "
                         "(reference map_main.cpp:100)")
    mp.set_defaults(func=cmd_giraffe)


    ij = sub.add_parser("inject", help="SAM -> GAM liftover")
    ij.add_argument("-x", "--xg", required=True)
    ij.add_argument("sam")
    ij.add_argument("--output")
    ij.set_defaults(func=cmd_inject)

    gs = sub.add_parser("gamsort", help="sort GAM by graph coordinate")
    gs.add_argument("gam")
    gs.add_argument("--output")
    gs.add_argument("-e", "--external", action="store_true",
                    help="disk-backed merge sort for large inputs")
    gs.add_argument("-i", "--index", metavar="FILE.gai",
                    help="also write a random-access node-range index")
    gs.add_argument("--chunk-size", type=int, default=100000)
    gs.set_defaults(func=cmd_gamsort)

    fl = sub.add_parser("filter", help="filter alignments")
    fl.add_argument("gam")
    fl.add_argument("-q", "--min-mapq", type=int, default=0)
    fl.add_argument("-I", "--min-identity", type=float, default=0.0)
    fl.add_argument("-n", "--name-prefix")
    fl.add_argument("-U", "--drop-unmapped", action="store_true")
    fl.add_argument("-C", "--max-softclip", type=int)
    fl.add_argument("--output")
    fl.set_defaults(func=cmd_filter)

    dp = sub.add_parser("depth", help="coverage depth per path from a pack")
    dp.add_argument("-Z", "--index-prefix")
    dp.add_argument("-x", "--xg")
    dp.add_argument("-k", "--pack", required=True)
    dp.set_defaults(func=cmd_depth)


    sn = sub.add_parser("snarls", help="snarl decomposition (JSON lines)")
    sn.add_argument("-x", "--xg", required=True)
    sn.add_argument("-p", "--path", help="(unused; full decomposition)")
    sn.add_argument("-T", "--traversals", action="store_true")
    sn.add_argument("--include-trivial", action="store_true",
                    help="also print content-free snarls between chain links")
    sn.set_defaults(func=cmd_snarls)


    rn = sub.add_parser("rna", help="project GTF transcripts onto the graph")
    rn.add_argument("graph", nargs="?")
    rn.add_argument("-Z", "--index-prefix")
    rn.add_argument("-n", "--transcripts", required=True, help="GTF/GFF file")
    rn.add_argument("-l", "--haplotype-transcripts", action="store_true",
                    help="also project transcripts through indexed haplotypes")
    rn.add_argument("-b", "--index-out", metavar="PREFIX",
                    help="write a pantranscriptome mapping bundle (map RNA "
                         "reads with giraffe/mpmap -Z PREFIX)")
    rn.add_argument("-o", "--output")
    rn.add_argument("-F", "--fasta", action="store_true")
    rn.set_defaults(func=cmd_rna)


    ms = sub.add_parser("msga", help="aligned FASTA (MSA) -> graph")
    ms.add_argument("msa")
    ms.add_argument("-o", "--output")
    ms.set_defaults(func=cmd_msga)

    mc = sub.add_parser("mcmc",
                        help="phased genotyping by MCMC over snarls")
    mc.add_argument("gam", help="mapped reads (GAM/GAMP)")
    mc.add_argument("graph")
    mc.add_argument("-o", "--output", required=True)
    mc.add_argument("-i", "--iterations", type=int, default=500)
    mc.add_argument("-s", "--seed", type=int, default=42)
    mc.add_argument("-p", "--ref-path")
    mc.add_argument("--sample", default="PHASED_SAMPLE")
    mc.set_defaults(func=cmd_mcmc)

    ch = sub.add_parser("chains", help="snarl chain decomposition")
    ch.add_argument("graph")
    ch.add_argument("-o", "--output")
    ch.set_defaults(func=cmd_chains)

    dp = sub.add_parser("dotplot", help="shared-kmer path dotplot TSV")
    dp.add_argument("-x", "--xg", required=True)
    dp.add_argument("--path-x")
    dp.add_argument("--path-y")
    dp.add_argument("-k", "--kmer-size", type=int, default=16)
    dp.add_argument("-w", "--window", type=int, default=8)
    dp.add_argument("--max-points", type=int, default=100000)
    dp.set_defaults(func=cmd_dotplot)

    cl = sub.add_parser("cluster", help="dump seed clusters (dev tool)")
    cl.add_argument("-Z", "--index-prefix", required=True)
    cl.add_argument("-f", "--fastq", required=True)
    cl.add_argument("--output")
    cl.set_defaults(func=cmd_cluster)

    zc = sub.add_parser("zipcode",
                        help="dump position-pair distances (dev tool)")
    zc.add_argument("-Z", "--index-prefix", required=True)
    zc.add_argument("-d", "--dist", help="distance index file")
    zc.add_argument("-n", type=int, default=100)
    zc.add_argument("--seed", type=int, default=1)
    zc.add_argument("--output")
    zc.set_defaults(func=cmd_zipcode)

    cn = sub.add_parser("chain",
                        help="run a serialized chaining problem "
                             "(dev tool)")
    cn.add_argument("input")
    cn.add_argument("-p", "--progress", action="store_true")
    cn.add_argument("-r", "--recombination-penalty", type=float,
                    default=0.0)
    cn.set_defaults(func=cmd_chain)

    bq = sub.add_parser("bench_dist_query",
                        aliases=["bench-dist-query"],
                        help="distance-oracle microbenchmark (dev tool)")
    bq.add_argument("graph")
    bq.add_argument("-d", "--dist")
    bq.add_argument("-n", type=int, default=1000)
    bq.set_defaults(func=cmd_bench_dist_query)

    ts = sub.add_parser("test", help="run the unit test suite")
    ts.add_argument("pytest_args", nargs=argparse.REMAINDER)
    ts.set_defaults(func=cmd_test)

    bm = sub.add_parser("benchmark", help="built-in micro-benchmark")
    bm.add_argument("--size", type=int, default=100_000)
    bm.set_defaults(func=cmd_benchmark)

    vz = sub.add_parser("viz",
                        help="visualization: linear SVG or Graphviz dot")
    vz.add_argument("-x", "--xg", required=True)
    vz.add_argument("-m", "--max-nodes", type=int, default=2000)
    vz.add_argument("-o", "--out", help=".svg extension selects SVG")
    vz.add_argument("-f", "--format", choices=["dot", "svg"],
                    default="dot")
    vz.add_argument("-d", "--gam-in", action="append",
                    help="read pileup track(s) from GAM")
    vz.add_argument("-w", "--width", type=int, default=1600)
    vz.set_defaults(func=cmd_viz)

    sp = sub.add_parser("simplify", help="pop small non-reference bubbles")
    sp.add_argument("input")
    sp.add_argument("-p", "--path")
    sp.add_argument("-m", "--max-bubble", type=int, default=10)
    sp.add_argument("-o", "--output", required=True)
    sp.set_defaults(func=cmd_simplify)

    tr = sub.add_parser("trace", help="haplotype walks around a node")
    tr.add_argument("-Z", "--index-prefix")
    tr.add_argument("-x", "--xg")
    tr.add_argument("-n", "--node", required=True)
    tr.add_argument("-c", "--context", type=int, default=5)
    tr.set_defaults(func=cmd_trace)

    so = sub.add_parser("sort", help="topological id sort")
    so.add_argument("input")
    so.add_argument("-o", "--output", required=True)
    so.set_defaults(func=cmd_sort)

    vc2 = sub.add_parser("vectorize", help="alignments -> feature table")
    vc2.add_argument("gam")
    vc2.set_defaults(func=cmd_vectorize)

    de = sub.add_parser("describe", help="identify a file")
    de.add_argument("input")
    de.set_defaults(func=cmd_describe)

    vr = sub.add_parser("version", help="print version")
    vr.set_defaults(func=cmd_version)

    hlp = sub.add_parser("help", help="print the subcommand list")
    hlp.set_defaults(func=lambda a: (ap.print_help(), 0)[1])


    mm = sub.add_parser("mpmap", help="multipath mapping (GAMP output)")
    mm.add_argument("-Z", "--index-prefix", required=True)
    mm.add_argument("-f", "--fastq", required=True)
    mm.add_argument("-2", "--fastq-mate",
                    help="second FASTQ: paired multipath mapping")
    mm.add_argument("-B", "--batch-size", type=int, default=512)
    mm.add_argument("-A", "--no-qual-adjust", action="store_true",
                    help="disable base-quality-adjusted scores "
                         "(on by default, reference mpmap_main.cpp:209)")
    mm.add_argument("--output")
    mm.set_defaults(func=cmd_mpmap)


    an = sub.add_parser("annotate", help="add reference-path positions to GAM")
    an.add_argument("-x", "--xg", required=True)
    an.add_argument("-a", "--gam", required=True)
    an.add_argument("--output")
    an.set_defaults(func=cmd_annotate)


    cv = sub.add_parser("convert", help="graph format conversion")
    cv.add_argument("input")
    cv.add_argument("-o", "--output", required=True)
    cv.set_defaults(func=cmd_convert)

    gpc = sub.add_parser("gampcompare", help="multipath correctness compare")
    gpc.add_argument("gamp")
    gpc.add_argument("truth_gam")
    gpc.add_argument("-x", "--xg")
    gpc.add_argument("-r", "--range", type=int, default=100)
    gpc.set_defaults(func=cmd_gampcompare)


    hp = sub.add_parser("haplotypes",
                        help="sample haplotypes best supported by reads")
    hp.add_argument("-Z", "--index-prefix", required=True)
    hp.add_argument("-f", "--fastq",
                    help="sample reads (minimizer-support scoring); "
                         "or give -k for kmer-count scoring")
    hp.add_argument("-n", "--num-haplotypes", type=int, default=4)
    hp.add_argument("-R", "--recombine", action="store_true",
                    help="stitch per-subchain best fragments into synthetic"
                         " haplotypes instead of whole-haplotype selection")
    hp.add_argument("--subchain-length", type=int, default=10000)
    hp.add_argument("--max-reads", type=int, default=20000)
    hp.add_argument("-k", "--kff",
                    help="sample kmer counts (KFF): kmer-classified "
                         "diploid sampling (reference haplotypes -k)")
    hp.add_argument("-g", "--gbz-out",
                    help="also write the sampled graph as GBZ "
                         "(reference haplotypes -g)")
    hp.add_argument("-p", "--output-prefix", required=True)
    hp.set_defaults(func=cmd_haplotypes)

    return ap


def main(argv: Optional[List[str]] = None) -> int:
    import os

    # the mappers' device: the card unless VGTPU_PLATFORM=cpu asks for the
    # plain PyTorch path (resolve_device raises where there is no CUDA)
    plat = os.environ.get("VGTPU_PLATFORM", "")
    if plat in ("", "cuda", "gpu"):
        device = "cuda"
    elif plat == "cpu":
        device = "cpu"
    else:
        print(f"error [vg_tpu_torch]: VGTPU_PLATFORM={plat!r}: expected "
              "cuda, gpu or cpu", file=sys.stderr)
        return 2
    args = build_parser().parse_args(argv)
    args.device = device          # every mapper a subcommand builds
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
