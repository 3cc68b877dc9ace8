"""The controls of the check, and the readings its limits are set from.

The configuration states an exact FFT, held to float64's answer, and a
float32 tail and rebin with TF32 off.  The step below the exact FFT is a
float32 one, and the program has that path of its own: the program with
``WAVEFORM_TPU_FFT_BACKEND=xla`` (cuFFT in float32) is the first control
(``--backend xla --seeds ...``).  The second is the reference put in the
program's place with its rebin in TF32: float32 arithmetic throughout,
the rebin's product on operands rounded to TF32's 10-bit mantissa, as a
product on the tensor cores with ``allow_tf32`` would round them.  The
rounding is done explicitly, so it reads the same on the CPU and the
card.

    python3 -m wfbench.control --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 2 [--backend xla]

prints one JSON line a reading, with every number the cell's
configuration compares: the program's in a short window at the cell's
own load for each of ``--seeds`` (the lower reading is their largest,
and with ``--backend xla`` the first control's, whose smallest is the
upper reading), then the TF32 control's at the ticks a run checks for
each of ``--control-seeds``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from wfbench import compare
from wfbench.reference import spectrum as ref


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def control_pixels(look: ref.Look, traffic, ticks: list[int], history: int,
                   device: torch.device | str) -> np.ndarray:
    """The pixels of ``ticks`` as the reference computes them, in float32
    with the rebin's product in TF32: [len(ticks), S, D, width]."""
    device = torch.device(device)
    f32 = torch.float32
    w = torch.tensor(ref.window_coefficients(look.window, look.fft_size,
                                             look.sine_exponent),
                     dtype=f32, device=device)
    coeff = float(np.float32(2.0 / (look.fft_size if look.window == "none"
                                    else float(w.double().sum()))))
    mat = tf32(torch.tensor(ref.rebin_matrix(look), dtype=f32,
                            device=device))
    g = float(np.float32(ref.gravity(look)))
    S = len(traffic.first_tick)
    spans = [np.arange(k - history + 1, k + 1) for k in ticks]
    all_ticks = np.unique(np.concatenate(spans))
    ends = dict(zip(all_ticks.tolist(), traffic.ends(all_ticks)))
    db = torch.empty((len(ticks), S, look.display_channels, look.nbins),
                     dtype=f32, device=device)
    for s in range(S):
        live = [[int(ends[j][s]) if j >= traffic.first_tick[s] else None
                 for j in sp.tolist()] for sp in spans]
        need = sorted({e for q in live for e in q if e is not None})
        x = torch.tensor(traffic.frames(s, need), dtype=f32, device=device)
        mag = torch.fft.rfft(x * w).abs()[..., :look.nbins] * coeff
        row = {e: i for i, e in enumerate(need)}
        state = torch.zeros((len(ticks), *mag.shape[1:]), dtype=f32,
                            device=device)
        for t in range(history):
            idx = [row[q[t]] if q[t] is not None else None for q in live]
            m = torch.stack([mag[i] if i is not None
                             else torch.zeros_like(mag[0]) for i in idx])
            state = g * state + (1.0 - g) * m
        if not look.stereo:
            state = state.mean(-2, keepdim=True)
        db[:, s] = 20.0 * torch.log10(state)
    px = tf32(db.reshape(-1, look.nbins)) @ mat
    return ref.finish_pixels(look, px.reshape(*db.shape[:-1], look.width)
                             .double().cpu().numpy())


def control_gap(name: str, seed: int, device, root=None) -> dict:
    """The control's check numbers in cell ``name`` at seed ``seed``, each
    beside its limit: the ticks a run checks, drawn from the seed over the
    first 600 after warm-up, computed by the control and by the
    reference."""
    from wfbench import harness
    from wfbench.generator import Traffic, seed_words
    root = root or harness.ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, _, dep = harness.find_cell(name, bench, root)
    mix = json.loads((root / "wfbench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    look = ref.look_from_settings(dep["settings"], dep["audio"], dep["fps"])
    C = min(dep["audio"]["channels"], 2)
    gen = Traffic(mix, dep["streams"], C, look.fft_size,
                  dep["audio"]["samples_per_sec"], dep["fps"], seed)
    warm = (math.ceil((look.fft_size + gen.P) / gen.hop)
            + dep["check"]["history"])
    pick = np.random.default_rng([seed_words(seed), 1])
    ticks = sorted(warm + 1 + pick.choice(600, dep["check"]["ticks"],
                                          replace=False))
    hist = dep["check"]["history"]
    got = control_pixels(look, gen, ticks, hist, device)
    want = ref.expected_pixels(look, gen.ends, gen.frames, gen.first_tick,
                               ticks, hist)
    return compare.checks(got, want, dep["check"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on the card; no CUDA device",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if args.backend:
        os.environ["WAVEFORM_TPU_FFT_BACKEND"] = args.backend
    from wfbench.harness import run_cell
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t = time.perf_counter()
        r = run_cell(args.workload, seed, args.seconds, False, "cuda", t,
                     log=lambda line: None)
        print(json.dumps({"reading": "program", "backend": args.backend,
                          "workload": args.workload, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"],
                          "seconds": time.perf_counter() - t}), flush=True)
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
