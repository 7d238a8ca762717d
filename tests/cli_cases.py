"""Inputs and a runner for the CLI parity tests (tests/test_torch_cli_*.py):
vg_tpu's command line and vg_tpu_torch's run on the same files, and their
standard output and output files are compared byte for byte.

The fixture is synthetic, made from numpy seeds: bench.make_pangenome's
pangenome as FASTA and plain-text VCF, indexed by vg_tpu's `autoindex`;
single-end and paired 150 bp reads and 2 kb long reads with qualities as
FASTQ; an intron text (a GT..AG intron planted in random sequence, as
tests/test_splice.py plants it) with a read across the junction; kmer
counts as KFF; and small text inputs (BED, primers, GTF, an MSA, a
chaining problem)."""
import io
import pathlib
import re
import struct

import numpy as np

import bench

REF_LEN = 30_000
N_READS, N_PAIRS, L = 96, 48, 150
N_LONG, LONG_L = 12, 2_000
E1, INTRON, SPLICE_T = 10_000, 5_000, 30_000
K = 29


def text_with_intron(seed=7, T=SPLICE_T, e1=E1, intron=INTRON):
    """Random text with a GT..AG intron planted at [e1, e1+intron)."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 4, T).astype(np.uint8)
    text[e1] = 2       # G
    text[e1 + 1] = 3   # T
    text[e1 + intron - 2] = 0   # A
    text[e1 + intron - 1] = 2   # G
    return text


def _decode(codes):
    return "".join("ACGTN"[int(c)] for c in codes)


def _revcomp(codes):
    return np.where(codes < 4, 3 - codes, codes)[::-1].astype(np.uint8)


def _mutate(rng, codes, rate):
    codes = codes.copy()
    ne = rng.binomial(len(codes), rate)
    ps = rng.integers(0, len(codes), ne)
    codes[ps] = (codes[ps] + 1 + rng.integers(0, 3, ne)) % 4
    return codes


def _qual(rng, n):
    return "".join(chr(33 + int(q)) for q in rng.integers(2, 41, n))


def write_fastq(path, reads):
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


def write_vcf(path, vcf):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(vcf.samples) + "\n")
        for r in vcf.records:
            gts = ["|".join(str(a) for a in gt) for gt, _ in r.genotypes]
            f.write(f"{r.chrom}\t{r.pos}\t{r.id}\t{r.ref}\t"
                    f"{','.join(r.alts)}\t.\t.\t.\tGT\t" + "\t".join(gts)
                    + "\n")


def write_kff(path, kmers, counts, k=K):
    """A KFF v1 file of one raw section, one kmer a block, as
    vg_tpu/io/kff.py's read_kff parses it (2-bit A=0 C=1 G=2 T=3, first
    base most significant, right-aligned in (k + 3) // 4 bytes)."""
    out = bytearray(b"KFF" + bytes([1, 0, 0b00011011, 1, 1]))
    out += struct.pack(">I", 0)
    names = (("k", k), ("max", 1), ("data_size", 1), ("ordered", 0))
    out += b"v" + struct.pack(">Q", len(names))
    for name, val in names:
        out += name.encode() + b"\0" + struct.pack(">Q", val)
    out += b"r" + struct.pack(">Q", len(kmers))
    nbytes = (k + 3) // 4
    for km, c in zip(kmers, counts):
        out += int(km).to_bytes(nbytes, "big") + bytes([int(c)])
    out += b"KFF"
    pathlib.Path(path).write_bytes(bytes(out))


def _pack_kmers(codes, k, step):
    starts = np.arange(0, len(codes) - k + 1, step)
    out = []
    for s in starts:
        w = codes[s : s + k]
        if (w > 3).any():
            continue
        fw = rw = 0
        for c in w:
            fw = (fw << 2) | int(c)
        for c in _revcomp(w):
            rw = (rw << 2) | int(c)
        out.append(min(fw, rw))
    return out


def build_fixture(d: pathlib.Path):
    """Write every input file under `d` and index the pangenome with
    vg_tpu's autoindex; returns a dict of paths (str)."""
    from vg_tpu.cli.main import main as jax_main
    from vg_tpu.io import native

    rng = np.random.default_rng(2024)
    g, _results, vcf = bench.make_pangenome(rng, ref_len=REF_LEN)
    p = {k: str(d / v) for k, v in dict(
        fa="ref.fa", vcf="vars.vcf", x="x", reads="reads.fq",
        r1="r1.fq", r2="r2.fq", spliced_fa="intron.fa",
        empty_vcf="empty.vcf", sx="sx", spliced="spliced.fq",
        kff="counts.kff").items()}
    seq = g.path_seq("ref")
    with open(p["fa"], "w") as f:
        f.write(">ref\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i : i + 60] + "\n")
    write_vcf(p["vcf"], vcf)
    assert jax_main(["autoindex", "-r", p["fa"], "-v", p["vcf"],
                     "-p", p["x"]]) == 0
    bg = native.load_graph(p["x"] + ".vgz.npz")
    haps = native.load_haplotypes(p["x"] + ".hpt.npz", bg)
    text = haps.text
    T = len(text)
    reads = []
    for i in range(N_READS):
        s = int(rng.integers(0, T - L))
        c = _mutate(rng, text[s : s + L], 0.01)
        if rng.random() < 0.5:
            c = _revcomp(c)
        reads.append((f"r{i}", _decode(c), _qual(rng, L)))
    write_fastq(p["reads"], reads)
    longs = []
    for i in range(N_LONG):
        s = int(rng.integers(0, T - LONG_L))
        c = _mutate(rng, text[s : s + LONG_L], 0.005)
        longs.append((f"l{i}", _decode(c), _qual(rng, LONG_L)))
    p["long"] = str(d / "long.fq")
    write_fastq(p["long"], longs)
    r1, r2 = [], []
    for i in range(N_PAIRS):
        frag = max(int(rng.normal(450, 50)), L + 10)
        s = int(rng.integers(0, T - frag))
        c1 = _mutate(rng, text[s : s + L], 0.01)
        c2 = _revcomp(_mutate(rng, text[s + frag - L : s + frag], 0.01))
        r1.append((f"p{i}/1", _decode(c1), _qual(rng, L)))
        r2.append((f"p{i}/2", _decode(c2), _qual(rng, L)))
    write_fastq(p["r1"], r1)
    write_fastq(p["r2"], r2)
    # kmer counts of sample s1's two haplotypes (every 5th position)
    km = []
    for i, m in enumerate(haps.metas):
        if m.sample == "s1":
            a, b = haps.hap_text_range(i)
            km += _pack_kmers(text[a:b], K, 5)
    kmers, counts = np.unique(np.array(km, np.uint64), return_counts=True)
    write_kff(p["kff"], kmers, np.minimum(counts * 10, 255))
    # the intron pangenome: one contig, no variants
    itext = text_with_intron()
    with open(p["spliced_fa"], "w") as f:
        f.write(">chr1\n" + _decode(itext) + "\n")
    write_vcf(p["empty_vcf"], type(vcf)(samples=[], records=[]))
    assert jax_main(["autoindex", "-r", p["spliced_fa"],
                     "-v", p["empty_vcf"], "-p", p["sx"]]) == 0
    spliced = [("spliced1", _decode(np.concatenate(
        [itext[E1 - 80 : E1], itext[E1 + INTRON : E1 + INTRON + 70]])),
        _qual(rng, 150))]
    for i in range(7):
        s = int(rng.integers(0, SPLICE_T - L))
        spliced.append((f"u{i}", _decode(itext[s : s + L]), _qual(rng, L)))
    write_fastq(p["spliced"], spliced)
    # pairs on the intron text: mate 1 of the first across the junction
    sp1, sp2 = [], []
    for i, (name, seq1, q1) in enumerate(spliced):
        if i == 0:
            s2 = E1 + INTRON + 300
        else:
            s2 = int(rng.integers(0, SPLICE_T - 600)) + 400
        c2 = _revcomp(itext[s2 - L : s2])
        sp1.append((f"{name}/1", seq1, q1))
        sp2.append((f"{name}/2", _decode(c2), _qual(rng, L)))
    p["spliced1"], p["spliced2"] = str(d / "sp1.fq"), str(d / "sp2.fq")
    write_fastq(p["spliced1"], sp1)
    write_fastq(p["spliced2"], sp2)
    p["inter"] = str(d / "inter.fq")
    write_fastq(p["inter"], [x for pair in zip(r1, r2) for x in pair])
    p["align_seq"] = seq[1_100:1_130] + "A" + seq[1_131:1_170]
    _write_extras(d, p, rng, seq)
    return p


def _write_extras(d, p, rng, seq):
    """The small text inputs that no writer of the repo makes."""
    p.update({k: str(d / v) for k, v in dict(
        reads_c="comments.fq", add_vcf="add.vcf", bed="mask.bed",
        primers="primers.tsv", gtf="tx.gtf", msa="msa.fa",
        chain="chain.json").items()})
    with open(p["reads"]) as f:
        lines = f.read().splitlines()
    with open(p["reads_c"], "w") as f:
        for i in range(0, 64, 4):
            f.write(f"{lines[i]} BC:Z:{'ACGT'[i % 4] * 8}\tRG:Z:grp{i % 3}\n"
                    if i % 8 == 0 else lines[i] + "\n")
            f.write("\n".join(lines[i + 1 : i + 4]) + "\n")
    recs = []
    for pos in (5_003, 12_011, 19_007, 26_013):
        r = seq[pos - 1]
        recs.append(f"ref\t{pos}\t.\t{r}\t{'ACGT'[('ACGT'.index(r) + 2) % 4]}"
                    f"\t.\t.\t.\tGT\t0|1\n")
    with open(p["add_vcf"], "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tnew\n" + "".join(recs))
    with open(p["bed"], "w") as f:
        f.write("ref\t2000\t2600\nref\t15000\t15400\n")
    with open(p["primers"], "w") as f:
        f.write("# name start end\n")
        for i in range(40):
            s = int(rng.integers(100, REF_LEN - 200))
            f.write(f"pr{i}\t{s}\t{s + 24}\n")
    with open(p["gtf"], "w") as f:
        for tid, strand, exons in (
                ("t1", "+", ((1_001, 1_200), (1_501, 1_700), (2_101, 2_400))),
                ("t2", "-", ((8_001, 8_300), (9_001, 9_150))),
                ("t3", "+", ((20_001, 20_500),))):
            for a, b in exons:
                f.write(f"ref\tsim\texon\t{a}\t{b}\t.\t{strand}\t.\t"
                        f'gene_id "g{tid}"; transcript_id "{tid}";\n')
    base = seq[3_000:3_090]
    rows = [base, base[:20] + "-" * 4 + base[24:60] + "T" + base[61:],
            base[:40] + "ACG" + base[43:]]
    rows[2] = rows[2][:70] + "-" * 10 + rows[2][80:]
    with open(p["msa"], "w") as f:
        for i, r in enumerate(rows):
            f.write(f">s{i}\n{r[:45]}\n{r[45:]}\n")
    import json

    nodes = [{"id": i + 1, "sequence": seq[i * 32 : i * 32 + 32]}
             for i in range(40)]
    items = [{"read_start": 10 * i, "read_end": 10 * i + 8, "score": 8,
              "graph_start": {"node_id": 1 + (10 * i) // 32,
                              "offset": (10 * i) % 32}} for i in range(30)]
    items += [{"read_start": 7, "read_end": 15, "score": 5,
               "graph_start": {"node_id": 30, "offset": 3}}]
    with open(p["chain"], "w") as f:
        json.dump({"subgraph": {"node": nodes}, "items": items}, f)


def build_derived(d: pathlib.Path, p: dict):
    """Alignment-side inputs, made by vg_tpu's CLI from the fixture: the
    single-end and paired GAMs, simulated truth, a pack, SAM and BAM, an
    augmented graph with its translation, a distance index, a
    small graph, the graph as .vg and .json, and the simulated reads
    mapped as GAM and GAMP."""
    import contextlib

    from vg_tpu.cli.main import main as jax_main
    from vg_tpu.graph.distindex import DistanceIndex
    from vg_tpu.io import native

    p.update({k: str(d / v) for k, v in dict(
        gam="mapped.gam", pgam="paired.gam", truth="truth.gam",
        pack="cov.pack.npz", sam="mapped.sam", bam="mapped.bam",
        aug="aug.gfa", trans="aug.json", dist="g.distidx.npz", tiny="tiny.gfa",
        gvg="g.vg", gjson="g.json", truth_fq="truth.fq", tgam="tmapped.gam",
        tgamp="tmapped.gamp").items()})
    G = p["x"] + ".vgz.npz"
    runs = [
        ["giraffe", "-Z", p["x"], "-f", p["reads"], "--output", p["gam"]],
        ["giraffe", "-Z", p["x"], "-f", p["r1"], "-2", p["r2"],
         "--output", p["pgam"]],
        ["sim", "-Z", p["x"], "-n", "80", "-l", "120", "-e", "0.01",
         "-s", "5", "-a", "--output", p["truth"]],
        ["pack", "-Z", p["x"], "-g", p["gam"], "-o", p["pack"]],
        ["surject", "-Z", p["x"], "-i", p["gam"], "-b", p["bam"]],
        ["augment", G, p["gam"], "-o", p["aug"], "-Z", p["trans"]],
        ["chunk", "-x", G, "-p", "ref:1000-1400", "-c", "1",
         "-o", p["tiny"]],
        ["convert", G, "-o", p["gvg"]],
        ["convert", G, "-o", p["gjson"]],
    ]
    for argv in runs:
        with contextlib.redirect_stderr(io.StringIO()):
            assert jax_main(argv) == 0, argv
    from vg_tpu.io.gam import read_gam

    write_fastq(p["truth_fq"], [
        (a.name, a.sequence, "I" * len(a.sequence))
        for a in read_gam(p["truth"])])
    for argv in (["giraffe", "-Z", p["x"], "-f", p["truth_fq"],
                  "--output", p["tgam"]],
                 ["mpmap", "-Z", p["x"], "-f", p["truth_fq"],
                  "--output", p["tgamp"]]):
        with contextlib.redirect_stderr(io.StringIO()):
            assert jax_main(argv) == 0, argv
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_main(["surject", "-Z", p["x"], "-i", p["gam"]]) == 0
    pathlib.Path(p["sam"]).write_text(buf.getvalue())
    DistanceIndex.build(native.load_graph(G)).save(p["dist"])
    return p


def _fmt(arg: str, od: pathlib.Path, p: dict) -> str:
    return arg.format(o=od, G=p["x"] + ".vgz.npz", **p)


def run_both(capsysbinary, out_dir: pathlib.Path, p: dict, argv: str,
             outs=(), copies=()):
    """Run vg_tpu's CLI and the port's on `argv` (placeholders: the
    fixture's keys, {G} the bundle's graph, {o} the package's own output
    directory). `copies` are (fixture file, name) pairs copied into that
    directory first, for subcommands that cache next to their input.
    Returns, for each package, (exit code, standard output bytes,
    standard error bytes with the output directory written "{o}",
    {output name: bytes})."""
    import shutil

    from vg_tpu.cli.main import main as jax_main
    from vg_tpu_torch.cli.main import main as torch_main

    res = []
    for tag, main in (("jax", jax_main), ("torch", torch_main)):
        od = out_dir / tag
        od.mkdir(parents=True, exist_ok=True)
        for src, name in copies:
            shutil.copy(_fmt(src, od, p), od / name)
        capsysbinary.readouterr()
        rc, out, err = 0, b"", b""
        for cmd in [argv] if isinstance(argv, str) else argv:
            rc = rc or main([_fmt(a, od, p) for a in cmd.split()])
            cap = capsysbinary.readouterr()
            out += cap.out
            err += cap.err.replace(str(od).encode(), b"{o}")
        res.append((rc, out, err,
                    {n: (od / n).read_bytes() for n in outs}))
    return res


def npz_arrays(data: bytes):
    """An .npz file's arrays by key (the zip's own timestamps differ from
    run to run, so bundles are compared by their arrays)."""
    with np.load(io.BytesIO(data)) as z:
        return {k: z[k] for k in z.files}


def assert_same(res, npz=(), norm=None, norm_err=None):
    """Both packages exited alike and wrote the same bytes; `npz` names
    outputs compared by their arrays, `norm` rewrites standard output
    first (only where it names the package or a wall-clock time).
    Standard error is compared with the package's name made one, after
    `norm_err` where it holds a wall-clock time."""
    (rc_j, out_j, err_j, files_j), (rc_t, out_t, err_t, files_t) = res
    assert rc_t == rc_j
    if norm is not None:
        out_j, out_t = norm(out_j), norm(out_t)
    assert out_t == out_j
    if norm_err is not None:
        err_j, err_t = norm_err(err_j), norm_err(err_t)
    assert norm_name(err_t) == norm_name(err_j)
    for name in files_j:
        if name in npz:
            a, b = npz_arrays(files_j[name]), npz_arrays(files_t[name])
            assert sorted(a) == sorted(b), name
            for k in a:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(b[k], a[k], err_msg=name)
        else:
            assert files_t[name] == files_j[name], name


# ------------------------------------------------------------------ cases
# (id, argv, options): the first word of argv is the subcommand; options
# are run_both's `outs` and `copies`, assert_same's `npz`, `norm` and
# `norm_err`, `quiet` for a subcommand that rightly writes nothing
# (validate on a valid graph) and `check` for what the port's output must
# hold besides. An argv list runs its commands in turn in each package.

BUNDLE = tuple((f"{{x}}.{ext}", f"x.{ext}")
               for ext in ("vgz.npz", "hpt.npz", "min.npz"))
IDX = ("vgz.npz", "hpt.npz", "min.npz")


def _names(prefix):
    return tuple(f"{prefix}.{e}" for e in IDX)


def norm_name(out: bytes) -> bytes:
    return out.replace(b"vg_tpu_torch", b"vg_tpu")


def norm_help(out: bytes) -> bytes:
    return b" ".join(norm_name(out).split())


def norm_bench_dist(out: bytes) -> bytes:
    return re.sub(rb"in [0-9.]+s = [0-9]+ queries/s", b"in Ts = Q queries/s",
                  out)


def norm_provenance(out: bytes) -> bytes:
    """--track-provenance's JSON records without their wall-clock times
    (time_used and the stage_*_time annotations)."""
    import json

    rows = []
    for line in out.splitlines():
        d = json.loads(line)
        d.pop("time_used", None)
        ann = d.get("annotation", {})
        for k in [k for k in ann if k.endswith("_time")]:
            del ann[k]
        rows.append(json.dumps(d, sort_keys=True).encode())
    return b"\n".join(rows)


def norm_funnel(err: bytes) -> bytes:
    """The funnel report's stage table without its seconds column."""
    return re.sub(rb"(?m)^(\w+)\t[0-9.]+\t", rb"\1\tT\t", err)


def norm_benchmark(out: bytes) -> bytes:
    out = re.sub(rb"\t[0-9.]+s", b"\tTs", out)
    return re.sub(rb"\t[0-9]+ reads/s", b"\tR reads/s", out)


GRAPH_CASES = [
    ("construct", "construct -r {fa}", {}),
    ("construct-v-a", "construct -r {fa} -v {vcf} -a -m 24 -o {o}/c.gfa",
     dict(outs=("c.gfa",))),
    ("autoindex", "autoindex -r {fa} -v {vcf} -p {o}/a",
     dict(outs=_names("a"), npz=_names("a"))),
    ("index", "index -r {fa} -v {vcf} -k 25 -w 9 -p {o}/i",
     dict(outs=_names("i"), npz=_names("i"))),
    ("autoindex-g", "autoindex -g {aug} -p {o}/ag",
     dict(outs=_names("ag"), npz=_names("ag"))),
    ("view", "view {G} -g", {}),
    ("view-t", "view {G} -t", {}),
    ("view-o", "view {G} -o {o}/v.vg", dict(outs=("v.vg",))),
    ("stats", "stats {G}", {}),
    ("stats-vg", "stats {gvg}", {}),
    ("paths", "paths -x {G} -F", {}),
    ("paths-X", "paths -x {gjson} -X", {}),
    ("validate", "validate -x {G}", dict(quiet=True)),
    ("deconstruct", "deconstruct -Z {x}", {}),
    ("ids", "ids {G} -c -i 7 -o {o}/i.json", dict(outs=("i.json",))),
    ("chunk", "chunk -x {G} -p ref:5000-6000 -c 2 -o {o}/ch.gfa",
     dict(outs=("ch.gfa",))),
    ("combine", "combine {G} {sx}.vgz.npz -o {o}/cb.gfa",
     dict(outs=("cb.gfa",))),
    ("mask", "mask -x {G} -b {bed} -o {o}/m.gfa", dict(outs=("m.gfa",))),
    ("circularize", "circularize {G} -p ref -o {o}/ci.gfa",
     dict(outs=("ci.gfa",))),
    ("mod", "mod {G} -r ref -o {o}/mo.gfa", dict(outs=("mo.gfa",))),
    ("prune", "prune {G} -M 2 -o {o}/pr.gfa", dict(outs=("pr.gfa",))),
    ("find", "find -x {G} -n 100 -n 205 -c 2 -o {o}/f.gfa",
     dict(outs=("f.gfa",))),
    ("concat", "concat {G} {sx}.vgz.npz -o {o}/cc.gfa",
     dict(outs=("cc.gfa",))),
    ("gbwt", "gbwt -Z {x} -o {o}/g.gbz", dict(outs=("g.gbz",))),
    ("kmers", "kmers -Z {x} -k 16 --head 3000", {}),
    ("minimizer", "minimizer -Z {x} -W -o {o}/mz.npz",
     dict(outs=("mz.npz",), npz=("mz.npz",))),
    ("minimizer-c", "minimizer -Z {x} -c -o {o}/sy.npz",
     dict(outs=("sy.npz",), npz=("sy.npz",))),
    ("add", "add {G} -v {add_vcf} -o {o}/ad.gfa", dict(outs=("ad.gfa",))),
    ("primers", "primers {primers} -x {G} -p ref --all", {}),
    ("clip", "clip {G} -p ref -b {bed} -o {o}/cl.gfa",
     dict(outs=("cl.gfa",))),
    ("align", "align {tiny} -s {align_seq} -n q1", {}),
    ("snarls", "snarls -x {G} -T", {}),
    ("rna", "rna {G} -n {gtf} -F", {}),
    ("rna-l", "rna -Z {x} -n {gtf} -l -o {o}/rna.gfa -b {o}/tx",
     dict(outs=("rna.gfa",) + _names("tx"), npz=_names("tx"))),
    ("msga", "msga {msa}", {}),
    ("msga-o", "msga {msa} -o {o}/ms.vg", dict(outs=("ms.vg",))),
    ("chains", "chains {G}", {}),
    ("dotplot", "dotplot -x {G} -k 12 -w 4 --max-points 3000", {}),
    ("zipcode", "zipcode -Z {x} -d {dist} -n 60", {}),
    ("chain", "chain {chain} -p -r 1.5", {}),
    ("bench_dist_query", "bench_dist_query {G} -d {dist} -n 300",
     dict(norm=norm_bench_dist)),
    ("bench-dist-query", "bench-dist-query {G} -n 100",
     dict(norm=norm_bench_dist)),
    ("viz", "viz -x {G}", {}),
    ("simplify", "simplify {G} -m 10 -o {o}/sp.gfa", dict(outs=("sp.gfa",))),
    ("trace", "trace -Z {x} -n 300 -c 3", {}),
    ("sort", "sort {G} -o {o}/so.gfa", dict(outs=("so.gfa",))),
    ("describe", "describe {G}", {}),
    ("version", "version", dict(norm=norm_name)),
    ("help", "help", dict(norm=norm_help)),
    ("convert", "convert {G} -o {o}/cv.gbz", dict(outs=("cv.gbz",))),
    ("convert-json", "convert {gvg} -o {o}/cv.json",
     dict(outs=("cv.json",))),
]

TOOL_CASES = [
    ("surject", "surject -Z {x} -i {gam}", {}),
    ("surject-b", "surject -Z {x} -i {gam} -b {o}/s.bam",
     dict(outs=("s.bam",))),
    ("surject-cram", "surject -Z {x} -i {gam} --cram {o}/s.cram",
     dict(outs=("s.cram",))),
    ("surject-paired",
     "surject -x {G} -i {pgam} --paired --sample S --read-group RG", {}),
    ("pack", "pack -Z {x} -g {gam} -o {o}/p.npz -d",
     dict(outs=("p.npz",), npz=("p.npz",))),
    ("call", "call -Z {x} -k {pack} -s S1",
     dict(check=lambda o, e, f: _vcf_body(o))),
    ("call-T", "call -x {G} -k {pack} -T {o}/tr.gaf",
     dict(outs=("tr.gaf",))),
    ("depth", "depth -Z {x} -k {pack}", {}),
    ("sim", "sim -Z {x} -n 60 -l 100 -e 0.02 -i 0.002 -s 3 -a "
     "--output {o}/sim.gam", dict(outs=("sim.gam",))),
    ("sim-seq", "sim -x {G} -n 20 -l 50 -s 4", {}),
    ("gamcompare", "gamcompare {tgam} {truth}",
     dict(check=lambda o, e, f: _json_at_least(o, "accuracy", 0.9))),
    ("gamcompare-d", "gamcompare {tgam} {truth} -d {o}/dg.vgz.npz",
     dict(copies=(("{G}", "dg.vgz.npz"),), outs=("dg.vgz.npz.distidx.npz",),
          npz=("dg.vgz.npz.distidx.npz",))),
    ("gampcompare", "gampcompare {tgamp} {truth} -x {G}", {}),
    ("gamsort", "gamsort {gam} --output {o}/so.gam", dict(outs=("so.gam",))),
    ("gamsort-index", "gamsort {gam} -i {o}/so.gam.gai --output {o}/so.gam",
     dict(outs=("so.gam", "so.gam.gai"))),
    ("gamsort-e", "gamsort {gam} -e --chunk-size 25 --output {o}/se.gam",
     dict(outs=("se.gam",))),
    ("find-l", ["gamsort {gam} -i {o}/s.gam.gai --output {o}/s.gam",
                "find -l {o}/s.gam -n 100 -n 600 -o {o}/fl.gam"],
     dict(outs=("fl.gam",), check=lambda o, e, f: _gam_records(f["fl.gam"]))),
    ("filter", "filter {gam} -q 5 -I 0.95 -C 10 --output {o}/fi.gam",
     dict(outs=("fi.gam",))),
    ("stats-a", "stats {gam} -a", {}),
    ("view-a", "view {gam} -a", {}),
    ("inject", "inject -x {G} {sam} --output {o}/ij.gam",
     dict(outs=("ij.gam",), check=lambda o, e, f: _placed(f["ij.gam"]))),
    ("inject-bam", "inject -x {G} {bam} --output {o}/ijb.gam",
     dict(outs=("ijb.gam",))),
    ("annotate", "annotate -x {G} -a {gam} --output {o}/an.gam",
     dict(outs=("an.gam",))),
    ("vectorize", "vectorize {gam}", {}),
    ("augment", "augment {G} {gam} -o {o}/au.gfa -Z {o}/au.json -m 1",
     dict(outs=("au.gfa", "au.json"))),
    ("translate", "translate {trans} {gam} -x {aug} --output {o}/tl.gam",
     dict(outs=("tl.gam",))),
    ("genotype", "genotype {G} {gam} -m 1 -s S", {}),
    ("mcmc", "mcmc {gam} {G} -o {o}/mc.gfa -i 60 -p ref",
     dict(outs=("mc.gfa",))),
    ("viz-svg", "viz -x {tiny} -o {o}/v.svg -d {gam}", dict(outs=("v.svg",))),
]

MAP_CASES = [
    ("giraffe", "giraffe -Z {x} -f {reads} --output {o}/g.gam",
     dict(outs=("g.gam",), check=lambda o, e, f: _placed(f["g.gam"]))),
    ("giraffe-gaf", "giraffe -Z {x} -f {reads} -o gaf", {}),
    ("giraffe-json", "giraffe -Z {x} -f {reads} -o json", {}),
    ("giraffe-sam", "giraffe -Z {x} -f {reads} -o sam", {}),
    ("giraffe-2", "giraffe -Z {x} -f {r1} -2 {r2} --output {o}/p.gam",
     dict(outs=("p.gam",),
          check=lambda o, e, f: _placed(f["p.gam"], 2 * N_PAIRS))),
    ("giraffe-2-sam", "giraffe -Z {x} -f {r1} -2 {r2} -o sam", {}),
    ("giraffe-i", "giraffe -Z {x} -f {inter} -i -o json", {}),
    ("giraffe-G", "giraffe -Z {x} -G {truth} --output {o}/gG.gam",
     dict(outs=("gG.gam",))),
    ("giraffe-kff", "giraffe -Z {x} -f {reads} --kff-name {kff} "
     "--output {o}/k.gam", dict(outs=("k.gam",))),
    ("giraffe-hifi", "giraffe -Z {o}/x -f {long} -b hifi --output {o}/h.gam",
     dict(copies=BUNDLE, outs=("h.gam", "x.lr.min.npz"),
          npz=("x.lr.min.npz",),
          check=lambda o, e, f: _placed(f["h.gam"], N_LONG))),
    ("giraffe-fast", "giraffe -Z {x} -f {reads} -b fast --full-l-bonus 3 "
     "-o json", {}),
    ("giraffe-provenance", "giraffe -Z {x} -f {reads} -o json "
     "--track-provenance", dict(norm=norm_provenance,
                                norm_err=norm_funnel)),
    ("giraffe-sweep", "giraffe -Z {x} -f {reads} --sweep hit_cap=5:10:5 "
     "--output {o}/sw.gam", dict(outs=("sw.hit_cap-5.gam",
                                       "sw.hit_cap-10.gam"))),
    ("giraffe-tags", "giraffe -Z {x} -f {reads_c} --comments-as-tags "
     "--output {o}/t.gam", dict(outs=("t.gam",))),
    ("giraffe-tags-sam", "giraffe -Z {x} -f {reads_c} --comments-as-tags "
     "-o sam", {}),
    ("giraffe-gbz", ["autoindex -r {fa} -v {vcf} -p {o}/b --gbz-out {o}/b.gbz",
                     "giraffe -Z {o}/b.gbz -f {reads} --output {o}/z.gam"],
     dict(outs=("b.gbz", "z.gam", "b.gbz.min.npz") + _names("b"),
          npz=("b.gbz.min.npz",) + _names("b"))),
]

# the MEM mapper, mpmap and the subcommands that build a mapper themselves
MPMAP_CASES = [
    ("map", "map -Z {o}/x -f {reads} --output {o}/m.gam",
     dict(copies=BUNDLE, outs=("m.gam", "x.sa.npy"))),
    ("map-A", "map -A -Z {o}/x -f {reads} --output {o}/mA.gam",
     dict(copies=BUNDLE, outs=("mA.gam", "x.sa.npy"),
          check=lambda o, e, f: _placed(f["mA.gam"]))),
    ("mpmap", "mpmap -Z {x} -f {reads} --output {o}/mp.gamp",
     dict(outs=("mp.gamp",), check=lambda o, e, f: _gamp_records(
         f["mp.gamp"], N_READS))),
    ("mpmap-spliced", "mpmap -Z {sx} -f {spliced}", {}),
    ("mpmap-2-spliced", "mpmap -Z {sx} -f {spliced1} -2 {spliced2}", {}),
    ("mpmap-2", "mpmap -Z {x} -f {r1} -2 {r2} --output {o}/mp2.gamp",
     dict(outs=("mp2.gamp",), check=lambda o, e, f: _gamp_records(
         f["mp2.gamp"], 2 * N_PAIRS))),
    ("mpmap-A", "mpmap -Z {x} -f {reads} -A", {}),
    ("mapeval", "mapeval -Z {x} -n 120 -B 64 -s 3",
     dict(check=lambda o, e, f: _json_at_least(o, "accuracy", 0.9))),
    ("benchmark", "benchmark --size 20000", dict(norm=norm_benchmark)),
    ("cluster", "cluster -Z {x} -f {reads}", {}),
    ("haplotypes", "haplotypes -Z {x} -f {reads} -n 2 -p {o}/h",
     dict(outs=_names("h"), npz=_names("h"))),
    ("haplotypes-R", "haplotypes -Z {x} -f {reads} -R -n 2 "
     "--subchain-length 5000 -p {o}/hr", dict(outs=_names("hr"),
                                             npz=_names("hr"))),
    ("haplotypes-k", "haplotypes -Z {x} -k {kff} -g {o}/hk.gbz -p {o}/hk",
     dict(outs=("hk.gbz",) + _names("hk"), npz=_names("hk"))),
]


def _gam_records(data: bytes, n=None):
    from vg_tpu_torch.io.gam import Alignment, read_messages

    alns = [Alignment.decode(r) for r in read_messages(data)]
    assert alns and (n is None or len(alns) == n), len(alns)
    return alns


def _placed(data: bytes, n=N_READS):
    """n records, at least 90% of them with a path."""
    alns = _gam_records(data, n)
    assert sum(1 for a in alns if a.path and a.path.mappings) >= 0.9 * n


def _gamp_records(data: bytes, n):
    from vg_tpu_torch.io.gamp import read_gamp

    mps = list(read_gamp(io.BytesIO(data)))
    assert len(mps) == n
    assert sum(1 for mp in mps if mp.subpaths) >= 0.9 * n


def _json_at_least(out: bytes, key, floor):
    import json

    assert json.loads(out.splitlines()[-1])[key] >= floor


def _vcf_body(out: bytes):
    assert out.startswith(b"##fileformat=VCF")
    assert any(not ln.startswith(b"#") for ln in out.splitlines())


def run_case(capsysbinary, out_dir, p, argv, opts):
    """One parity case: run both CLIs and hold their outputs equal.
    Returns the port's (exit code, stdout, stderr, files)."""
    res = run_both(capsysbinary, out_dir, p, argv, opts.get("outs", ()),
                   opts.get("copies", ()))
    assert_same(res, npz=opts.get("npz", ()), norm=opts.get("norm"),
                norm_err=opts.get("norm_err"))
    rc, out, err, files = res[1]
    assert rc == 0, err.decode(errors="replace")[-2000:]
    if not opts.get("quiet"):
        assert out or err or any(files.values()), "both wrote nothing"
    if "check" in opts:
        opts["check"](out, err, files)
    return res[1]
