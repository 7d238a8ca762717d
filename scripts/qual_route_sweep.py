#!/usr/bin/env python3
"""Device time of the DP's quality entry on each of its two routes over
batch sizes, on one NVIDIA GPU: the measurements behind the threshold of
ops/cuda_align.qual_lanes.

    python3 scripts/qual_route_sweep.py [--reads 256,512,...] [--iters 30]

For each batch of R reads x 8 candidates (N = 8 R slots), dp_cases.qual_case
on a random 1 Mbp text with qualities, 58% of the slots valid (the vg map
batch's share), band radius 16, RL = 160, qualadj's tables: both routes
(G = 1 and 4 lanes a slot, each forced by standing in for the rule)
checked equal, then timed with chip_smoke.device_ms (device time, the host
ahead of the card). The default batches lie on both sides of the
threshold, QUAL_SPLIT_SLOTS slots an SM (1,584 and 1,600 reads on 132
SMs). Prints a line a batch and, last, one JSON object with the times,
the rule's pick and the card's name and power limit. Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

READS = (256, 512, 1024, 1536, 1584, 1600, 2048, 4096)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", default=",".join(map(str, READS)))
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("qual_route_sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from vg_tpu_torch.ops import cuda_align, dp_cases, qualadj

    dev = torch.device("cuda")
    sms = cuda_align.sm_count(dev)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    text = np.random.default_rng(0).integers(0, 4, 1_000_000).astype(
        np.uint8)
    packed = put(cuda_align.pack_text(text))
    tabs = [put(np.asarray(t, np.int32)) for t in qualadj.qual_tables(1, 4, 5)]
    rows = []
    for R in (int(x) for x in args.reads.split(",")):
        a = list(dp_cases.qual_case(np.random.default_rng(R), R=R, B=16,
                                    text=text))
        a[-1] = np.random.default_rng(R + 1).random(a[-1].shape) < 0.58
        t = [packed, len(text)] + [put(x) for x in a[1:]] + tabs
        rule = cuda_align.qual_lanes(R * 8, sms, a[1].shape[1])
        ms, out = {}, {}
        for G in cuda_align.QUAL_LANES:
            with mock.patch.object(cuda_align, "qual_lanes",
                                   lambda *_, G=G: G):
                run = lambda: cuda_align.banded_scores_qual_packed(
                    *t, band_radius=16)
                out[G] = run()
                ms[G] = chip_smoke.device_ms(run, args.iters)[0]
        bad = int((out[1] != out[4]).sum())
        assert bad == 0, f"R={R}: the routes differ on {bad} slots"
        rows.append(dict(reads=R, slots=R * 8, valid=int(a[-1].sum()),
                         ms=ms, rule=rule))
        print(f"N = {R * 8} slots ({int(a[-1].sum())} valid): device ms by "
              f"lanes a slot {json.dumps(ms)}; the rule takes {rule}",
              flush=True)
    print(json.dumps({"qual_route_sweep": rows, "sms": sms,
                      "card": chip_smoke.smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
