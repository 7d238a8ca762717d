"""The port's native record writer (native/pair_emit.cpp, through
PairedGiraffeMapper._emit_pairs_encoded and GiraffeMapper.
emit_chosen_encoded) against the JAX package's records, on the CPU, on one
index carried across as in test_torch_paired.py.

Each case is a batch of pairs that holds what it names: unmapped mates
(random bases), indel winners (3 bases deleted or inserted; encoded by the
mapper's traceback and spliced in), reverse-strand winners (every mate 2),
gapless winners with more than 8 mismatches (the device payload's 8
positions do not cover them), rescued mates (a mismatch every 12th base:
no seed, rescued from their mates, so their winner is not the one the
device step's payload describes), reads without qualities, and a mate name
of 130 bytes (a two-byte length in the mate-name field). The batch goes
through map_pairs_encoded (host pair selection, no device payload),
map_pairs_encoded_mt (the device step's pos8 payload) and, mates apart,
the single-end encoded emitter: records byte-identical to vg_tpu's, each
case seen in them, and the native and fallback row counters summing to
the rows emitted. Without the writer's library the pipeline encodes
Alignment objects: the same alignments, fields in field-number order."""
import numpy as np
import pytest
import torch

import bench
from vg_tpu.index.haplotypes import thread_haplotypes
from vg_tpu.index.minimizer import MinimizerIndex
from vg_tpu.io import native as jax_native
from vg_tpu.map.giraffe import GiraffeMapper as JaxMapper
from vg_tpu.map.giraffe import GiraffeParams as JaxParams
from vg_tpu.map.paired import PairedGiraffeMapper as JaxPaired
from vg_tpu.parallel.pipeline import map_pairs_encoded_mt as jax_mt
from vg_tpu_torch.convert import state_from_arrays
from vg_tpu_torch.io.fastq import Read
from vg_tpu_torch.io.gam import Alignment
from vg_tpu_torch.map import giraffe as tg
from vg_tpu_torch.map.paired import PairedGiraffeMapper as TorchPaired
from vg_tpu_torch.parallel.pipeline import map_pairs_encoded_mt as torch_mt
from vg_tpu_torch.utils import dna

BS = 64
N_MOD = 6                      # pairs of a batch that carry its case
CASES = ("unmapped", "indel", "reverse", "over8", "rescued", "no_quality",
         "long_name")


def quality(rng, n):
    return "".join(chr(33 + q) for q in rng.choice([2, 12, 23, 37], n,
                                                   p=[.01, .04, .1, .85]))


def mutate(seq, positions):
    """seq with each listed base changed (A->C->G->T->A)."""
    s = list(seq)
    for p in positions:
        s[p] = "CGTA"["ACGT".index(s[p])] if s[p] in "ACGT" else "A"
    return "".join(s)


def indel_read(rng, haps, insert, n=150, k=3):
    """A read of the first haplotype with k bases deleted mid-read, or k
    random bases inserted there."""
    end = int(haps.text_start[1]) if len(haps.text_start) > 1 \
        else len(haps.text)
    s = int(rng.integers(0, end - n - k - 1))
    h = n // 2
    if insert:
        codes = np.concatenate([haps.text[s : s + h],
                                rng.integers(0, 4, k).astype(np.uint8),
                                haps.text[s + h : s + n - k]])
    else:
        codes = np.concatenate([haps.text[s : s + h],
                                haps.text[s + h + k : s + n + k]])
    return dna.decode(codes)


def make_case(case, setup):
    """A batch of BS pairs whose first N_MOD pairs carry `case`."""
    rng = np.random.default_rng(CASES.index(case) + 100)
    k = CASES.index(case)
    base = setup["pairs"][BS * (k + 1) : BS * (k + 2)]
    out = []
    for i, (a, b) in enumerate(base):
        a = Read(a.name, a.sequence, quality(rng, len(a.sequence)))
        b = Read(b.name, b.sequence, quality(rng, len(b.sequence)))
        if i < N_MOD:
            if case == "unmapped":
                b = Read(b.name, dna.decode(rng.integers(0, 4, 150)),
                         b.quality)
            elif case == "indel":
                a = Read(a.name, indel_read(rng, setup["haps"], i % 2),
                         a.quality)
            elif case == "over8":
                a = Read(a.name, mutate(a.sequence, range(3, 73, 7)),
                         a.quality)
            elif case == "rescued":
                b = Read(b.name, mutate(b.sequence, range(5, 150, 12)),
                         b.quality)
            elif case == "no_quality":
                a, b = Read(a.name, a.sequence, None), \
                    Read(b.name, b.sequence, None)
            elif case == "long_name" and i == 0:
                a = Read("L" * 130 + "/1", a.sequence, a.quality)
        out.append((a, b))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    # several pytest workers at once: one torch thread each, while this
    # module runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield make_setup(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def make_setup(tmp_path_factory):
    rng = np.random.default_rng(23)
    g, results, vcf = bench.make_pangenome(rng, ref_len=60_000)
    haps = thread_haplotypes(g, results, vcf)
    idx = MinimizerIndex.build(haps)
    d = tmp_path_factory.mktemp("index")
    jax_native.save_graph(str(d / "g.npz"), g)
    jax_native.save_haplotypes(str(d / "h.npz"), haps)
    jax_native.save_minimizer(str(d / "m.npz"), idx)
    _, t_haps, t_idx = state_from_arrays(
        *(dict(np.load(d / f)) for f in ("g.npz", "h.npz", "m.npz")))
    pairs = bench.simulate_pairs(rng, haps, (len(CASES) + 1) * BS)
    jm = JaxPaired(JaxMapper(haps, idx, JaxParams(batch_reads=BS)))
    tm = TorchPaired(tg.GiraffeMapper(t_haps, t_idx,
                                      tg.GiraffeParams(batch_reads=BS),
                                      device="cpu"))
    for pm in (jm, tm):           # the fragment model learns from batch 0
        pm.map_pairs(pairs[:BS])
        pm.finish()
    assert jm.fragdist.finalized and tm.fragdist.finalized
    return dict(haps=haps, jm=jm, tm=tm, pairs=pairs,
                batches={c: make_case(c, dict(haps=haps, pairs=pairs))
                         for c in CASES})


def rows(setup):
    c = setup["tm"].stage_seconds
    return (c.get("emit.rows_native", 0.0), c.get("emit.rows_fallback", 0.0))


class Seen:
    """What GiraffeMapper._emit_mate was handed and made of it, summed over
    its calls: the rows whose device payload covers another candidate than
    the winner, the rows whose payload says more than 8 mismatches, and
    the kinds emit_classify gave the rows (0 unmapped, 1 gapless, 2 off
    the gapless path, spliced in)."""

    def __init__(self, mapper, monkeypatch):
        self.other_j = self.over8 = 0
        self.kinds = np.zeros(3, np.int64)
        orig = mapper._emit_mate

        def spy(sb, best_j, mapqs, any_valid):
            wm = sb.winner_mism
            if wm is not None:
                R = len(sb.reads)
                self.other_j += int(np.sum(
                    any_valid & (best_j != wm[0][:R])))
                self.over8 += int(np.sum(any_valid & (wm[1][:R] > 8)))
            got = orig(sb, best_j, mapqs, any_valid)
            if got is not None:
                self.kinds += np.bincount(got[1]["kind"], minlength=3)
            return got

        monkeypatch.setattr(mapper, "_emit_mate", spy)


def check_case(case, batch, recs):
    """The case is present in the records (mate 1, mate 2 interleaved)."""
    alns = [Alignment.decode(bytes(r)) for r in recs]
    mods = [a for a in alns[: 2 * N_MOD]]
    if case == "unmapped":
        assert any(a.path is None for a in mods[1::2])
    elif case == "indel":
        assert any(e.from_length != e.to_length
                   for a in mods[0::2] if a.path
                   for m in a.path.mappings for e in m.edits)
    elif case == "reverse":
        assert any(a.path and a.path.mappings[0].position.is_reverse
                   for a in alns)
        assert any(a.path and not a.path.mappings[0].position.is_reverse
                   for a in alns)
    elif case == "over8":
        assert any(a.path and sum(len(e.sequence) for m in a.path.mappings
                                  for e in m.edits) > 8
                   for a in mods[0::2])
    elif case == "rescued":
        assert any(a.path is not None for a in mods[1::2])
    elif case == "no_quality":
        assert not any(a.quality for a in mods)
        assert all(a.quality for a in alns[2 * N_MOD :])
    elif case == "long_name":
        assert alns[1].fragment_prev.name == "L" * 130 + "/1"


@pytest.mark.parametrize("case", CASES)
def test_pairs_encoded_equal(setup, case, monkeypatch):
    """map_pairs_encoded: host pair selection, masks from the text."""
    batch = setup["batches"][case]
    seen = Seen(setup["tm"].mapper, monkeypatch)
    before = rows(setup)
    want = setup["jm"].map_pairs_encoded(batch)
    got = setup["tm"].map_pairs_encoded(batch)
    assert len(got) == len(want) == 2 * BS
    assert [bytes(r) for r in got] == [bytes(r) for r in want]
    check_case(case, batch, got)
    native, fallback = (x - y for x, y in zip(rows(setup), before))
    assert (native, fallback) == (2 * BS, 0)
    if case == "indel":        # the indel winners: spliced in
        assert seen.kinds[2] > 0
    if case == "unmapped":
        assert seen.kinds[0] > 0


@pytest.mark.parametrize("case", CASES)
def test_pipeline_records_equal(setup, case, monkeypatch):
    """map_pairs_encoded_mt: the device step's pos8 payload, rescue."""
    batch = setup["batches"][case]
    seen = Seen(setup["tm"].mapper, monkeypatch)
    before = rows(setup)
    if case == "indel":
        # vg_tpu's device pair step gives the reads with an insertion a
        # lower MAPQ than its own host pair selection does (52 against 57
        # and 60 on this batch); the port's step agrees with the host
        # selection, so the port is held to vg_tpu's host path here
        want = [bytes(r) for r in setup["jm"].map_pairs_encoded(batch)]
    else:
        want = [bytes(r) for recs in jax_mt(setup["jm"], iter([batch]))
                for r in recs]
    got = [bytes(r) for recs in torch_mt(setup["tm"], iter([batch]))
           for r in recs]
    assert len(got) == len(want) == 2 * BS
    assert got == want
    check_case(case, batch, got)
    native, fallback = (x - y for x, y in zip(rows(setup), before))
    assert (native, fallback) == (2 * BS, 0)
    if case == "rescued":
        assert seen.other_j > 0
    if case == "over8":
        assert seen.over8 > 0


@pytest.mark.parametrize("case", CASES)
def test_single_end_equal(setup, case):
    """emit_chosen_encoded (map_stream_encoded): one mate's records, no
    pair fields."""
    batch = setup["batches"][case]
    reads = [a for a, _ in batch] + [b for _, b in batch]
    before = rows(setup)
    outs = [[bytes(r) for recs in pm.mapper.map_stream_encoded(
        iter([reads])) for r in recs] for pm in (setup["jm"], setup["tm"])]
    want, got = outs
    assert len(got) == len(want) == 2 * BS
    assert got == want
    native, fallback = (x - y for x, y in zip(rows(setup), before))
    assert (native, fallback) == (2 * BS, 0)


@pytest.mark.parametrize("name_len", [0, 123, 124, 128, 300, 20_000])
def test_pair_fields_equal(name_len):
    """The writer's mate-name fields and pair annotations against vg_tpu's
    (io/wire's fields, its finalizer's annotation Struct), on unmapped rows
    whose pair flags and fragment lengths are set by hand: lengths of every
    sign and size, 0 (no length field), improper and no annotation; names
    of a few bytes (name_len 0) or of name_len bytes and one more a row,
    whose lengths take one, two or three bytes."""
    from vg_tpu.io.wire import field_bytes, field_str
    from vg_tpu.map.paired import _annotation_suffix
    from vg_tpu_torch.map.giraffe import str_blob
    from vg_tpu_torch.native import pair_emit

    L_ = pair_emit.lib()
    assert L_ is not None
    frags = np.array([0, 1, -1, 127, 128, 450, -450, 2 ** 31, -(2 ** 40),
                      300, 301, 5], np.int64)
    R = len(frags)
    use_pair = np.array([1] * 9 + [0, 0, 0], np.uint8)
    any1 = np.array([0] * 9 + [1, 0, 0], np.uint8)
    any2 = np.array([0] * 9 + [0, 1, 0], np.uint8)
    rng = np.random.default_rng(3)
    mates, keep, want, names = [], [], [], []
    for k, anyv in ((1, any1), (2, any2)):
        reads = [Read(f"q{i}/{k}" * (1 + i % 3) if not name_len
                      else f"{i}/{k}".rjust(name_len + i, "N"),
                      dna.decode(rng.integers(0, 4, 20 + i)),
                      None if i % 4 == 0 else quality(rng, 20 + i))
                 for i in range(R)]
        names.append([r.name for r in reads])
        blobs = [str_blob([getattr(r, f) or "" for r in reads])
                 for f in ("name", "sequence", "quality")]
        kind = np.zeros(R, np.uint8)
        keep.append((blobs, kind, anyv))
        p = lambda a: a.ctypes.data
        m = pair_emit.EmitMate()
        m.R = R
        m.any_valid = p(anyv)
        m.name_off, m.names = p(blobs[0][0]), p(blobs[0][1])
        m.seq_off, m.seqs = p(blobs[1][0]), p(blobs[1][1])
        m.qual_off, m.quals = p(blobs[2][0]), p(blobs[2][1])
        m.kind = p(kind)
        mates.append(m)
        want.append([Alignment(name=r.name, sequence=r.sequence, quality=(
            bytes(ord(c) - 33 for c in r.quality) if r.quality else b"")
        ).encode() for r in reads])
    out = np.empty((1 << 16) + 4 * max(name_len, 124) * R, np.uint8)
    rec_off = np.empty(2 * R + 1, np.int64)
    n = L_.emit_records(pair_emit.EmitGraph(), mates[0], mates[1],
                        use_pair.ctypes.data, frags.ctypes.data,
                        out.ctypes.data, out.size, rec_off.ctypes.data)
    assert n == rec_off[-1] > 0
    got = [out[a:b].tobytes() for a, b in zip(rec_off[:-1], rec_off[1:])]
    for i in range(R):
        if use_pair[i]:
            suffix = _annotation_suffix(True, int(frags[i]))
        elif any1[i] or any2[i]:
            suffix = _annotation_suffix(False, 0)
        else:
            suffix = b""
        assert got[2 * i] == (want[0][i] + field_bytes(
            12, field_str(3, names[1][i])) + suffix)
        assert got[2 * i + 1] == (want[1][i] + field_bytes(
            11, field_str(3, names[0][i])) + suffix)
    # a short buffer is refused, not overrun
    assert L_.emit_records(pair_emit.EmitGraph(), mates[0], mates[1],
                           use_pair.ctypes.data, frags.ctypes.data,
                           out.ctypes.data, int(n) - 1,
                           rec_off.ctypes.data) == -1


@pytest.mark.parametrize("case", ("unmapped", "rescued", "long_name"))
def test_no_library_records_equal(setup, case, monkeypatch):
    """Without the writer's library (no compiler), map_pairs_encoded_mt
    encodes the pairs' Alignment objects: vg_tpu's alignments, their
    fields in field-number order (vg_tpu's encoded records append the
    pair's fields), and every row counted as a fallback."""
    from vg_tpu_torch.native import pair_emit

    batch = setup["batches"][case]
    monkeypatch.setattr(pair_emit, "lib", lambda: None)
    before = rows(setup)
    want = [bytes(r) for recs in jax_mt(setup["jm"], iter([batch]))
            for r in recs]
    got = [bytes(r) for recs in torch_mt(setup["tm"], iter([batch]))
           for r in recs]
    assert len(got) == 2 * BS
    assert got == [Alignment.decode(r).encode() for r in want]
    native, fallback = (x - y for x, y in zip(rows(setup), before))
    assert (native, fallback) == (0, 2 * BS)
