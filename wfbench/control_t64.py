"""The TF32 control of a cell whose adapter is ``serving_t64``: the
float64 PyTorch reference put in the program's place in float32, with
its rebin's product in TF32 (``engines/serving_t64.control_pixels``),
against the float64 reference, at the ticks a run checks.

    python3 -m wfbench.control_t64 --workload <cell> --control-seeds 4,5,6

prints one JSON line a seed, with every number the cell's configuration
compares, each beside its limit.  The program's readings and the float32
FFT control are taken as for any cell: ``python3 -m wfbench.control
--workload <cell> --seeds ... [--backend xla]``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from wfbench import compare, harness
from wfbench.generator import Traffic, seed_words


def control_gap(name: str, seed: int, device, root=None) -> dict:
    """The control's check numbers in cell ``name`` at seed ``seed``, each
    beside its limit: the ticks a run checks, drawn from the seed over the
    first 600 after warm-up, computed by the control and by the
    reference."""
    root = root or harness.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, _, dep = harness.find_cell(name, bench, root)
    mix = json.loads((root / "wfbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    engine = harness.load_module(root / "wfbench" / "engines"
                                 / f"{dep['engine']}.py")
    ref = engine.reference
    look = ref.Look(dep["settings"], dep["audio"], dep["fps"])
    C = min(dep["audio"]["channels"], 2)
    gen = Traffic(mix, dep["streams"], C, look.fft_size,
                  dep["audio"]["samples_per_sec"], dep["fps"], seed)
    warm = (math.ceil((look.fft_size + gen.P) / gen.hop)
            + dep["check"]["history"])
    pick = np.random.default_rng([seed_words(seed), 1])
    ticks = sorted(warm + 1 + pick.choice(600, dep["check"]["ticks"],
                                          replace=False))
    hist = dep["check"]["history"]
    got = engine.control_pixels(look, gen, ticks, hist, device)
    want = ref.expected_pixels(look, gen.ends, gen.frames, gen.first_tick,
                               ticks, hist, device=device)
    return compare.checks(got, want, dep["check"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on the card; no CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t = time.perf_counter()
        r = control_gap(args.workload, seed, "cuda")
        print(json.dumps({"reading": "control", "workload": args.workload,
                          "seed": seed, "correct": all(
                              c["value"] <= c["limit"] for c in r.values()),
                          "checks": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
