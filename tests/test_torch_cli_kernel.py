"""The port's command line on the card: `giraffe` (single-end and paired
-2) writes the same GAM, and `map -A -o json` the same records, with
VGTPU_PLATFORM unset (the card, through the banded-DP kernel and its
quality entry, and giraffe's through the MAPQ cap kernel) as with
VGTPU_PLATFORM=cpu (their plain versions). Imports no JAX, so it runs on a
machine that has only the card's stack:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cli_kernel.py

The fixture is the port's own: a random reference with SNPs and small
indels in two phased samples, written as FASTA and VCF and indexed by the
port's `autoindex`; a second FASTQ holds reads of 4,200 and 5,000 bases
among short ones. Here, without a card, the `gpu` tests skip and the CPU
test runs."""
import json

import numpy as np
import pytest
import torch

from vg_tpu_torch.cli.main import main
from vg_tpu_torch.io.gam import read_gam
from vg_tpu_torch.ops import cuda_align, cuda_mapqcap

torch.set_num_threads(1)

REF_LEN, N_READS, N_PAIRS, L = 20_000, 256, 128, 150


def _decode(c):
    return "".join("ACGTN"[int(x)] for x in c)


def _revcomp(c):
    return (3 - c)[::-1]


def _mutate(rng, c, rate=0.01):
    c = c.copy()
    ps = rng.integers(0, len(c), rng.binomial(len(c), rate))
    c[ps] = (c[ps] + 1 + rng.integers(0, 3, len(ps))) % 4
    return c


def _fastq(path, reads, rng):
    with open(path, "w") as f:
        for name, c in reads:
            q = "".join(chr(33 + int(x)) for x in rng.integers(2, 41, len(c)))
            f.write(f"@{name}\n{_decode(c)}\n+\n{q}\n")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory, monkeypatch_module):
    d = tmp_path_factory.mktemp("cli_card")
    rng = np.random.default_rng(77)
    ref = rng.integers(0, 4, REF_LEN).astype(np.uint8)
    with open(d / "ref.fa", "w") as f:
        f.write(">ref\n" + _decode(ref) + "\n")
    with open(d / "vars.vcf", "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\ts1\ts2\n")
        for p in range(150, REF_LEN - 150, 211):
            r = _decode(ref[p : p + 1])
            if p % 5 == 0:
                alt, r = r, _decode(ref[p : p + 3])      # 2 bp deletion
            else:
                alt = "ACGT"[(int(ref[p]) + 1) % 4]
            gts = [f"{rng.integers(0, 2)}|{rng.integers(0, 2)}"
                   for _ in range(2)]
            f.write(f"ref\t{p + 1}\t.\t{r}\t{alt}\t.\t.\t.\tGT\t"
                    + "\t".join(gts) + "\n")
    monkeypatch_module.setenv("VGTPU_PLATFORM", "cpu")
    prefix = str(d / "x")
    assert main(["autoindex", "-r", str(d / "ref.fa"), "-v",
                 str(d / "vars.vcf"), "-p", prefix]) == 0
    reads = []
    for i in range(N_READS):
        s = int(rng.integers(0, REF_LEN - L))
        c = _mutate(rng, ref[s : s + L])
        reads.append((f"r{i}", _revcomp(c) if i % 2 else c))
    _fastq(d / "reads.fq", reads, rng)
    r1, r2 = [], []
    for i in range(N_PAIRS):
        s = int(rng.integers(0, REF_LEN - 500))
        r1.append((f"p{i}/1", _mutate(rng, ref[s : s + L])))
        r2.append((f"p{i}/2", _revcomp(_mutate(rng, ref[s + 350 : s + 500]))))
    _fastq(d / "r1.fq", r1, rng)
    _fastq(d / "r2.fq", r2, rng)
    return d, prefix


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _commands(d, prefix):
    return {
        "giraffe": ["giraffe", "-Z", prefix, "-f", str(d / "reads.fq"),
                    "-B", "128"],
        "giraffe-2": ["giraffe", "-Z", prefix, "-f", str(d / "r1.fq"),
                      "-2", str(d / "r2.fq"), "-B", "64"],
        # JSON: map's GAM stream scores through score_reads_packed, which
        # has no quality-adjusted step (in vg_tpu too); map_batch has
        "map-A": ["map", "-A", "-Z", prefix, "-f", str(d / "reads.fq"),
                  "-B", "128", "-o", "json"],
    }


def _run(argv, out, monkeypatch, platform):
    """Run one command; GAM goes to `out` through --output, JSON (written
    to standard output) is redirected there."""
    import contextlib

    if platform is None:
        monkeypatch.delenv("VGTPU_PLATFORM", raising=False)
    else:
        monkeypatch.setenv("VGTPU_PLATFORM", platform)
    if "json" in argv:
        with open(out, "w") as f, contextlib.redirect_stdout(f):
            assert main(argv) == 0
    else:
        assert main(argv + ["--output", str(out)]) == 0
    return out.read_bytes()


def test_cli_maps_on_the_cpu(bundle, tmp_path, monkeypatch):
    """With VGTPU_PLATFORM=cpu each command maps its reads and places
    nearly all of them (the twin the card test compares with)."""
    d, prefix = bundle
    for name, argv in _commands(d, prefix).items():
        out = tmp_path / f"{name}.gam"
        _run(argv, out, monkeypatch, "cpu")
        if "json" in argv:
            paths = [json.loads(ln).get("path", {}).get("mapping")
                     for ln in out.read_text().splitlines()]
        else:
            paths = [a.path and a.path.mappings for a in read_gam(str(out))]
        n = 2 * N_PAIRS if name == "giraffe-2" else N_READS
        assert len(paths) == n, name
        placed = sum(1 for m in paths if m)
        assert placed >= 0.95 * n, (name, placed)


@pytest.mark.gpu
def test_cli_gam_on_the_card_equals_the_cpu(bundle, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    d, prefix = bundle
    for name, argv in _commands(d, prefix).items():
        want = _run(argv, tmp_path / f"{name}.cpu.gam", monkeypatch, "cpu")
        dp0 = cuda_align.banded_scores_packed.launches
        q0 = cuda_align.banded_scores_qual_packed.launches
        c0 = cuda_mapqcap.mapq_cap.launches
        got = _run(argv, tmp_path / f"{name}.card.gam", monkeypatch, None)
        dp = cuda_align.banded_scores_packed.launches - dp0
        q = cuda_align.banded_scores_qual_packed.launches - q0
        cap = cuda_mapqcap.mapq_cap.launches - c0
        assert got == want, name
        if name == "map-A":
            assert q >= N_READS // 128 and dp == 0, (name, dp, q)
        else:
            # the MAPQ cap: once a batch of FASTQ reads, once a mate
            assert dp >= 2 and q == 0 and cap >= 2, (name, dp, q, cap)


@pytest.mark.gpu
def test_cli_giraffe_long_read_on_the_card_equals_the_cpu(bundle, tmp_path,
                                                          monkeypatch):
    """giraffe single-end on a FASTQ whose batch holds reads of 5,000 and
    4,200 bases among 150-base reads: the MAPQ cap kernel takes them (their
    scratch in global memory) and the GAM equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    d, prefix = bundle
    ref = np.array(["ACGT".index(b) for b in
                    (d / "ref.fa").read_text().split("\n")[1]], np.uint8)
    rng = np.random.default_rng(5)
    reads = [("long0", _mutate(rng, ref[1000:6000])),
             ("long1", _revcomp(_mutate(rng, ref[9000:13200])))]
    for i in range(30):
        s = int(rng.integers(0, REF_LEN - L))
        reads.append((f"s{i}", _mutate(rng, ref[s : s + L])))
    _fastq(tmp_path / "long.fq", reads, rng)
    argv = ["giraffe", "-Z", prefix, "-f", str(tmp_path / "long.fq"),
            "-B", "64"]
    want = _run(argv, tmp_path / "long.cpu.gam", monkeypatch, "cpu")
    c0 = cuda_mapqcap.mapq_cap.launches
    got = _run(argv, tmp_path / "long.card.gam", monkeypatch, None)
    assert cuda_mapqcap.mapq_cap.launches - c0 >= 1
    assert got == want
    assert len(list(read_gam(str(tmp_path / "long.card.gam")))) == len(reads)
