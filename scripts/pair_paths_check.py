#!/usr/bin/env python3
"""The two ways a paired batch can take through map_pairs_encoded_mt,
compared in vg_tpu and in vg_tpu_torch on the CPU: host pair selection
("main", a batch scored before the fragment model was finalized) against
the device step ("main_dev"), on one batch of chip_smoke.py's paired
stream (1 Mbp fixture, 6144 pairs a batch, phred 40 on every base as the
CLI's FASTQ gives them), with the fragment model learned on batch 0.

    JAX_PLATFORMS=cpu python3 scripts/pair_paths_check.py [--batch 3]

Prints, for each package, the records that differ between the two ways
(name, mate, MAPQ by host selection, MAPQ by the device step). Both
packages load the same index bundle, written by the port's io.native."""
import argparse
import os
import pathlib
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def ways(pkg, prefix, pairs, bs, b):
    if pkg == "vg_tpu_torch":
        from vg_tpu_torch.io import native
        from vg_tpu_torch.io.fastq import Read
        from vg_tpu_torch.io.gam import Alignment
        from vg_tpu_torch.map.giraffe import GiraffeMapper, GiraffeParams
        from vg_tpu_torch.map.paired import PairedGiraffeMapper
        kw = dict(device="cpu")
    else:
        import jax

        jax.config.update("jax_platforms", "cpu")
        from vg_tpu.io import native
        from vg_tpu.io.fastq import Read
        from vg_tpu.io.gam import Alignment
        from vg_tpu.map.giraffe import GiraffeMapper, GiraffeParams
        from vg_tpu.map.paired import PairedGiraffeMapper
        kw = {}
    g = native.load_graph(prefix + ".vgz.npz")
    haps = native.load_haplotypes(prefix + ".hpt.npz", g)
    idx = native.load_minimizer(prefix + ".min.npz")
    # names as iter_fastq_paired gives them, qualities as the CLI phase's
    reads = [(Read(a.name[:-2], a.sequence, "I" * len(a.sequence)),
              Read(c.name[:-2], c.sequence, "I" * len(c.sequence)))
             for a, c in pairs]
    pm = PairedGiraffeMapper(GiraffeMapper(
        haps, idx, GiraffeParams(batch_reads=bs), **kw))
    t0 = time.time()
    pm.map_pairs(reads[:bs])
    assert pm.fragdist.finalized
    batch = reads[b * bs : (b + 1) * bs]
    out = {}
    for way, item in (("main", lambda: ("host", batch,
                                        pm.score_pairs(batch))),
                      ("main_dev", lambda: pm.stage_score(batch))):
        rescued = pm.stage_rescue(item())
        assert rescued[0] == way, rescued[0]
        out[way] = [bytes(r) for r in pm.stage_emit(rescued)]
    diff = []
    for k, (h, d) in enumerate(zip(out["main"], out["main_dev"])):
        if h != d:
            ah, ad = Alignment.decode(h), Alignment.decode(d)
            diff.append((ah.name, k % 2 + 1, ah.mapping_quality,
                         ad.mapping_quality))
    print(f"{pkg}, batch {b}: {len(diff)} of {len(out['main'])} records "
          f"differ between host pair selection and the device step "
          f"(name, mate, MAPQ host, MAPQ device): {diff[:10]} "
          f"({time.time() - t0:.1f} s)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=3)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    from vg_tpu_torch.io import native

    bs = cs.BATCH
    haps, idx, _mem, _vcf, pairs, _truth = cs.build_fixture(
        args.seed, 1.0, bs * (cs.N_BATCHES + 1))
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "x")
        native.save_graph(prefix + ".vgz.npz", haps.graph)
        native.save_haplotypes(prefix + ".hpt.npz", haps)
        native.save_minimizer(prefix + ".min.npz", idx)
        for pkg in ("vg_tpu_torch", "vg_tpu"):
            ways(pkg, prefix, pairs, bs, args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
