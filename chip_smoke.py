"""Drive the PyTorch port's spectrum serving paths once on an NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device  — a CUDA device of compute capability 9.0; prints its name and
   power limit as nvidia-smi reports them;
2. build   — the exact FFT kernels compiled from ``waveform_tpu_torch/
   csrc`` with nvcc (one process per source); prints ptxas's entry
   function and register lines as nvcc gives them (no spills allowed),
   and each kernel's IMMA / IGMMA / IDP.4A counts from its SASS: all 10
   kernels (stage 1 and stage 2 of K2, K2-df, K1-gen, K1-df and K3) must
   run on the int8 tensor cores (IMMA or IGMMA, no IDP.4A);
3. kernel  — K1-gen through the router (K1's body at K1's sizes) bit for
   bit against its plain PyTorch twin (NaN lanes by position) and against
   float64 numpy at N in {1024, 2048, 4096}, S in {1, 7, 256}, Hann df32
   window and none, with a silent stream, a silent channel, a 1e20 stream
   and a NaN stream;
4. slice   — ``ServingEngine`` at the headline configuration (stereo 48 kHz,
   N=4096, Hann, 800-px Lanczos rebin, S=256) fed a 440 Hz tone plus noise
   for 8 ticks: one K1-gen launch per tick and no other kernel, finite
   pixels, a silent stream at exactly DB_MIN, agreement with the CPU port
   on the first streams, and the bench's accuracy gate against the
   float64 oracle;
5. times   — K1-gen, its twin and the full tick at S=256, N=4096 on the
   card's clock (CUDA events, median of 30 after warmup);
6. kernel3 — the 3-factor kernel (K2) bit for bit against its twin (NaN
   lanes by position), and against float64 numpy, at
   N in {4096, 8192, 16384, 32768, 65536}, S in {1, 7, 32}, the same windows
   and bad streams as phase 3; at N=4096 (reached through K2's direct entry
   point, since the router sends 4096 to K1-gen) also against K1-gen;
7. slice3  — ``ServingEngine`` on the large-FFT configuration (stereo
   48 kHz, N=65536 behind enable_large_fft, Hann, 800-px Lanczos rebin in
   its gather form, S=32) for 84 ticks, enough to fill the 65536-sample
   window: one K2 launch per tick and no other kernel, finite pixels, the
   silent stream at DB_MIN, the 440 Hz peak within one bin, agreement with
   the CPU port on 2 streams and the accuracy gate against the float64
   oracle;
8. times3  — K2 and its twin at (N, S) = (8192, 256), (16384, 256),
   (32768, 64), (65536, 32), with the library call, K2's int8 rate and its
   share of the bound at (16384, 256) and (65536, 32); K2 in turns with
   K1-gen at (16384, 256); K2's two launches timed apart at both shapes,
   beside the wrapper and the library call, all on the device's clock
   (the device kept busy ahead of each call, so the host's enqueue is not
   timed); and the full tick at N=65536, S=32;
9. cfft    — the complex kernel (K3) bit for bit against its twin (NaN
   lanes by position) and against float64 numpy at
   N in {1024, 3072, 4096, 16384, 32768}, S in {1, 7, 64}, and at the
   slice's (4096, 256); on f32 pairs, on Hann-windowed df32 pairs (path
   a's input) and on a Hann-windowed df32 real part with a zero imaginary
   part (path b's input), with the bad streams of phase 3; one launch per
   call;
10. slice_packed — ``ServingEngine`` under WAVEFORM_TPU_EXACT_FUSED=never
   at the headline configuration, stereo (path a) and mono capture (path
   b), 8 ticks each: one K3 launch per tick and no other kernel, finite
   pixels, the silent stream at DB_MIN, the 440 Hz peak within one bin,
   agreement with the CPU port on the first streams, and the accuracy
   gate against the float64 oracle;
11. slice_small — the auto FFT size (N=800 at 48 kHz and 60 fps), stereo,
   S=256, the gate unset (path c), 8 ticks: the digit lowering in torch
   ops and no kernel launch of any kind, with the checks of phase 10;
12. times_cfft — K3, its twin and the library call (``torch.fft.fft`` of
   the complex128 pair) at (N, S) = (4096, 256), (32768, 32), with K3's
   int8 rate and share of its bound; K3's two launches timed apart at both
   shapes beside the wrapper and the library call on the device's clock
   (as in phase 8); and the full tick of paths a and c at S=256;
13. kernel_gen — K1-gen through the router against its twin and float64
   numpy at N in {3072, 5120, 6144, 7168, 8192, 9216, 16384, 31744},
   S in {1, 7, 64}, at (6144, 256), and at N=32768 under
   WAVEFORM_TPU_STAGE1_SPLIT=2, with the windows and bad streams of phase
   3; against K2 at 8192 and 16384;
14. slice_gen — ``ServingEngine`` at N=6144 (an FFT-size slider position),
   the headline configuration otherwise, S=256, 8 ticks: one K1-gen launch
   per tick and no other kernel, with the checks of phase 4; then
   N=16384 behind enable_large_fft, S=64, 21 ticks, which the JAX split
   rule sends to K1-gen too;
15. times_gen — K1-gen, its twin and the library call
   ``torch.fft.rfft(x.double() * w).abs()`` at (6144, 256) and (16384,
   256), K1-gen's two launches timed apart at both shapes beside the
   wrapper and the library call on the device's clock (as in phase 8), K2
   and its twin at (16384, 256), and the full tick at N=6144, S=256;
16. kernel_df — under WAVEFORM_TPU_KERNEL_TWIDDLE=df, K1-df (K1-gen at
   the df twiddle tier) through the router at N in {1024, 2048, 3072,
   4096, 6144, 16384, 31744} and K2-df (K2 at the df tier) at 8192
   through its direct entry point and at 32768 and 65536 through the
   router, S in {1, 7, 64} (32 at 65536), and (4096, 256), with the
   windows and bad streams of phase 3: bit for bit against the df twin
   (NaN lanes by position), within TOL of float64, nz exact; the f32
   kernel of the same size on the same input bit for bit against its
   twin, its float64 error printed beside the df kernel's;
17. slice_df — ``ServingEngine`` under WAVEFORM_TPU_KERNEL_TWIDDLE=df at the
   headline configuration (S=256, 8 ticks: one K1-df launch per tick) and
   at the large-FFT configuration (S=32, 84 ticks: one K2-df launch per
   tick), no f32-tier kernel launch, with the checks of phases 4 and 7;
18. times_df — K1-df at (4096, 256) and (16384, 256) and K2-df at
   (65536, 32), each beside the f32 kernel of the same shape, with the df
   twin and the library call; K2-df's rate and share of its bound; K2-df
   in turns with K1-df at (16384, 256); K2-df's two launches timed apart
   as in phase 8, and K1-df's at (4096, 256) and (16384, 256); and the
   full df tick at both slices.
19. graph  — the device half of every tick is a captured CUDA graph
   (``runtime/graphs.py``), so every phase above ran graph ticks; here
   each slice path (the headline K1-gen, N=65536 K2, both df tiers, path
   a's K3, path c's lowering) runs a graph engine beside an engine whose
   ticks run the same device function eagerly: bit for bit in 8 ticks'
   pixels and state; the kernels a replay launches counted from the
   capture and from the profiler's kernel names, which must agree; eager
   and graph ticks (feed_batch + tick) in turns on CUDA events; the
   device busy time and share of 5 profiled ticks of each
   (``runtime/profiler.py``); and 60 synchronized graph ticks on the host
   clock: the FrameProfiler's p50/p99 and the tick's host pieces;
20. microbatch — k=4 at the headline: each flush (one graph of four
   packed ticks) bit for bit with four single ticks, four K1-gen launches
   a flush; a frame's time at k=1 and k=4 in turns; the k that
   ``microbatch="auto"`` resolves to on this card;
21. tick_many — T=8 bulk ticks at the headline: 8 K1-gen launches, the
   CPU port's tick_many on 4 of the streams within 1e-4 dB;
22. meter  — ``MeterServingEngine`` at S=256: graph tick bit for bit with
   its eager tick, the CPU port within 1e-4 dB, the tick time;
23. checkpoint — the headline engine's state saved on the card, loaded
   into a card engine and (4 rows, ``keep``) a CPU port engine bit for
   bit, both ticked on within 1e-4 dB.

Every phase's seconds are printed before the kernels' JSON record and the
result line, which are the last two lines.  Each kernel's record carries
its time, its plain twin's, the library call's (timed here, never called
by the port) and its bound: the larger of its int8 operations at the
card's peak and the bytes it must move (inputs read once, outputs written
once) at its memory rate.  The record named ``exact_mag`` (the TPU body
at N1 in {8, 16, 32}) carries K1-gen's numbers at (4096, 256) and the
``slice`` phase's launches: K1-gen serves those sizes.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SR, HOP = 48000, 800
TOL = 2.5e-7          # kernel bound of the JAX package's tests
TOL_SPLITS = 3e-7     # K2 vs K1's body (tests/test_exact_pallas.py:217-229)
SEED = 0
K1_SIZES = (1024, 2048, 4096)   # N1 = 8, 16, 32: K1's sizes, now K1-gen's
INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core peak, ops/s
HBM = 3.35e12         # H100 SXM device memory, bytes/s
# exact_cuda's launch counters: K2, K3, K1-gen, K1-df, K2-df
COUNTERS = ("launches3", "launches_cfft", "launches_gen", "launches_gen_df",
            "launches3_df")
# the library's kernels, all on the int8 tensor cores: stage 1 and stage 2
# of exact_mag3.cu and exact_mag_gen.cu at both tiers and of exact_cfft.cu
KERNELS = 10


@contextlib.contextmanager
def env(name: str, value: str | None):
    """Set (or, for None, unset) one environment variable for a block."""
    old = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def hann_pair(n: int, device):
    w64 = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / (n - 1)))
    hi = w64.astype(np.float32)
    lo = (w64 - hi.astype(np.float64)).astype(np.float32)
    return w64, (torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device))


def cuda_median_ms(fn, reps: int = 30, warmup: int = 5,
                   busy_ahead: bool = False) -> float:
    """Median of per-call CUDA-event times after warmup, in ms.  With
    ``busy_ahead`` the device is kept busy ahead of each timed call
    (torch.cuda._sleep), so the events time the device work alone and not
    the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if busy_ahead:
            torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bad_streams(x: np.ndarray, rng) -> tuple:
    """Make streams 1-4 of ``x`` [S, 2, N] silent / half silent / 1e20 /
    NaN (when S >= 7); returns the streams that no bound applies to."""
    if x.shape[0] < 7:
        return ()
    x[1] = 0.0                   # silent stream
    x[2, 1] = 0.0                # silent channel
    x[3] = 1e20 * rng.standard_normal((2, x.shape[-1]))
    x[4, 0, 11] = np.nan
    return (3, 4)


def phase_kernel(exact_cuda, dev, kernel, twin, counter: str, sizes,
                 streams, seed: int, versus=None, bitwise: bool = False):
    """``kernel`` vs ``twin`` vs float64 over the size/stream/window
    matrix: each call adds one to ``exact_cuda.<counter>``, agrees with
    the twin within TOL (``bitwise``: bit for bit, NaN lanes by position)
    and float64 within TOL, counts nonzeros exactly, and keeps the
    1e20/NaN streams to themselves.  ``versus`` = (other kernel, its
    sizes) also holds those sizes against the other kernel within
    TOL_SPLITS.  Returns the number of cases and the worst relative
    errors."""
    rng = np.random.default_rng(seed)
    worst = {"twin": 0.0, "f64": 0.0, "versus": 0.0}
    cases = 0
    for n in sizes:
        for S in streams:
            for windowed in (True, False):
                x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
                x[0, 0] += np.sin(2 * np.pi * 440.0 * np.arange(n) / SR)
                bad = bad_streams(x, rng)
                good = [s for s in range(S) if s not in bad]
                if windowed:
                    w64, win = hann_pair(n, dev)
                else:
                    w64, win = np.ones(n), None
                xd = torch.from_numpy(x).to(dev)
                before = getattr(exact_cuda, counter)
                mag, nz = kernel(xd, win)
                torch.cuda.synchronize()
                check(getattr(exact_cuda, counter) == before + 1,
                      f"{counter} N={n} S={S}")
                ref, nz_ref = twin(xd, win)
                torch.cuda.synchronize()
                check(not bitwise or same_bits(mag, ref),
                      f"{counter} N={n} S={S} windowed={windowed}: not bit "
                      "for bit with the twin")
                mag, ref = mag.cpu().numpy(), ref.cpu().numpy()
                want = np.abs(np.fft.rfft(x[good].astype(np.float64) * w64))
                want = want[..., :n // 2]
                scale = np.abs(want).max()
                e_twin = np.abs(mag[good] - ref[good]).max() / scale
                e_f64 = np.abs(mag[good].astype(np.float64) - want).max() / scale
                check(e_twin <= TOL, f"N={n} S={S} kernel vs twin {e_twin}")
                check(e_f64 <= TOL, f"N={n} S={S} kernel vs f64 {e_f64}")
                check(np.array_equal(nz.cpu().numpy(),
                                     np.count_nonzero(x, axis=-1)),
                      f"N={n} S={S} nz counts")
                check(np.array_equal(nz.cpu(), nz_ref.cpu()), "nz vs twin")
                if bad:
                    check(np.isfinite(mag[3]).all(), "1e20 stream not finite")
                    check((mag[1] == 0).all() and (mag[2, 1] == 0).all(),
                          "silent rows not zero")
                if versus is not None and n in versus[1]:
                    m1, _ = versus[0](xd, win)
                    m1 = m1.cpu().numpy()
                    e_vs = np.abs(mag[good] - m1[good]).max() / m1[good].max()
                    check(e_vs <= TOL_SPLITS,
                          f"{counter} vs {versus[0].__name__} at N={n} {e_vs}")
                    worst["versus"] = max(worst["versus"], e_vs)
                worst["twin"] = max(worst["twin"], e_twin)
                worst["f64"] = max(worst["f64"], e_f64)
                cases += 1
    return cases, worst


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-for-bit equality of two float tensors, NaN lanes by position
    (NaN != NaN)."""
    return torch.equal(torch.nan_to_num(a, nan=-1.0),
                       torch.nan_to_num(b, nan=-1.0))


def phase_df(exact_cuda, dev, cases, seed: int):
    """The df tier's kernels against their twins, float64 and the f32
    tier.  ``cases`` are (entry, N, streams): ``entry`` "router" runs
    ``rfft_pair_mag`` under WAVEFORM_TPU_KERNEL_TWIDDLE=df and then under
    f32, "k2" K2's direct entry point with ``twiddle`` "df" then "f32".
    Each df call adds one to the df counter of its split and nothing to
    any other, matches the df twin bit for bit (NaN lanes by position)
    and float64 within TOL, and counts nonzeros exactly; each f32 call
    matches its f32 twin bit for bit.  Returns the number of cases and
    the worst relative errors of each tier against float64."""
    rng = np.random.default_rng(seed)
    worst = {"df": 0.0, "f32": 0.0}
    n_cases = 0
    for entry, n, streams in cases:
        split = 3 if entry == "k2" else exact_cuda.stage1_split(n)
        counter = "launches3_df" if split == 3 else "launches_gen_df"
        twins = ((exact_cuda.rfft_pair_mag3_df_ref,
                  exact_cuda.rfft_pair_mag3_ref) if split == 3 else
                 (exact_cuda.rfft_pair_mag_df_ref,
                  exact_cuda.rfft_pair_mag_ref))
        for S in streams:
            for windowed in (True, False):
                x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
                x[0, 0] += np.sin(2 * np.pi * 440.0 * np.arange(n) / SR)
                bad = bad_streams(x, rng)
                good = [s for s in range(S) if s not in bad]
                w64, win = hann_pair(n, dev) if windowed else (np.ones(n),
                                                                None)
                xd = torch.from_numpy(x).to(dev)
                want = np.abs(np.fft.rfft(x[good].astype(np.float64) * w64))
                want = want[..., :n // 2]
                scale = np.abs(want).max()
                for tier, twin in zip(("df", "f32"), twins):
                    before = [getattr(exact_cuda, c) for c in COUNTERS]
                    with env("WAVEFORM_TPU_KERNEL_TWIDDLE", tier):
                        mag, nz = (exact_cuda.rfft_pair_mag3(xd, win, tier)
                                   if entry == "k2" else
                                   exact_cuda.rfft_pair_mag(xd, win))
                    torch.cuda.synchronize()
                    after = [getattr(exact_cuda, c) for c in COUNTERS]
                    moved = [c for c, b, a in zip(COUNTERS, before, after)
                             if a != b]
                    if tier == "df":
                        check(moved == [counter]
                              and after[COUNTERS.index(counter)]
                              == before[COUNTERS.index(counter)] + 1,
                              f"df N={n} S={S}: counters moved {moved}")
                    else:
                        check(len(moved) == 1 and "df" not in moved[0],
                              f"f32 N={n} S={S}: counters moved {moved}")
                    ref, nz_ref = twin(xd, win)
                    torch.cuda.synchronize()
                    check(same_bits(mag, ref) and torch.equal(nz, nz_ref),
                          f"{tier} kernel vs twin at N={n} S={S} "
                          f"windowed={windowed}: not bit-identical")
                    e_f64 = np.abs(mag.cpu().numpy()[good].astype(np.float64)
                                   - want).max() / scale
                    check(e_f64 <= TOL, f"{tier} N={n} S={S} vs f64 {e_f64}")
                    check(np.array_equal(nz.cpu().numpy(),
                                         np.count_nonzero(x, axis=-1)),
                          f"{tier} N={n} S={S} nz counts")
                    worst[tier] = max(worst[tier], e_f64)
                n_cases += 1
    return n_cases, worst


def work(name: str, n: int, S: int) -> tuple[float, float]:
    """(int8 operations, bytes) of one call of kernel ``name`` on S streams
    of size n: 2 operations per digit-pair MAC, 10 digit pairs a product;
    each input, window and constant read once, each output written once."""
    n1 = n // 128
    macs2 = 655360 * n1                       # kept-half or full stage 2
    tw = 2 * n1 * 128 * 4                     # twiddle (f32, or df32 pair)
    if name == "exact_cfft":
        macs1 = 5120 * n1 * n1                # F1b [2N1, 2N1] x 128 columns
        io = 8 * S * n * 4                    # df32 re/im in, df32 out
        consts = 4 * (2 * n1) ** 2 + 4 * 256 * 256 + 2 * tw
    else:
        io = S * 2 * n * 4 + 2 * n * 4 + S * 2 * (n // 2) * 4 + S * 2 * 4
        if name == "exact_mag3":
            a = n1 // 4
            macs1 = 2 * 2 * (4 * a) * (2 * a) * 128 * 10   # c02, c13
            consts = 2 * 4 * (4 * a) * (2 * a)
        else:
            macs1 = 5120 * n1 * n1            # F1r [2N1, N1], two channels
            consts = 4 * 2 * n1 * n1
        consts += 4 * 256 * 128 + tw
    return 2 * S * (macs1 + macs2), io + consts


def bound(name: str, n: int, S: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of one call of kernel ``name`` on S streams of
    size n: the larger of its int8 operations at INT8_OPS and the bytes it
    must move at HBM (:func:`work`)."""
    ops, nbytes = work(name, n, S)
    ops_ms = ops / INT8_OPS * 1e3
    bytes_ms = nbytes / HBM * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def rate_line(name: str, ms: float, n: int, S: int) -> str:
    """A kernel time as its int8 rate and its share of the bound."""
    b_ms, b_by = bound(name, n, S)
    rate = work(name, n, S)[0] / (ms * 1e-3)
    return (f"{rate / 1e12:.1f} TOP/s ({rate / INT8_OPS * 100:.1f}% of "
            f"the int8 peak), bound {b_ms * 1e3:.2f} us ({b_by}), "
            f"{b_ms / ms * 100:.1f}% of bound")


# the two-launch pair kernels whose stages run apart: (stage entry point,
# constants, their keys, the wrapper, the df instance's name)
STAGED = {"K2": ("wf_exact_mag3_stage", "_consts3", "K2_CONSTS",
                 "rfft_pair_mag3", "K2-df"),
          "K1-gen": ("wf_exact_mag_gen_stage", "_consts", "K1GEN_CONSTS",
                     "rfft_pair_mag_gen", "K1-df")}


def stage_ms(exact_cuda, body: str, n: int, S: int, dev, df: bool):
    """The two launches of ``body`` (``STAGED``: K2 or K1-gen; df: K2-df or
    K1-df) timed apart on CUDA events, with the device kept busy ahead of
    each (``cuda_median_ms(busy_ahead=True)``), at [S, 2, n], Hann: (stage
    1 ms, stage 2 ms, both ms, the wrapper ms).  The two stages run one
    after the other through the stage entry point must give the wrapper's
    output bit for bit."""
    entry, consts, keys, wrapper, _ = STAGED[body]
    lib = exact_cuda.build()
    wrap = getattr(exact_cuda, wrapper)
    tier = "df" if df else "f32"
    x = torch.from_numpy((0.5 * np.random.default_rng(SEED + 13)
                          .standard_normal((S, 2, n))).astype(np.float32)
                         ).to(dev)
    _, (w_hi, w_lo) = hann_pair(n, dev)
    c = getattr(exact_cuda, consts)(n, dev)
    rows = torch.empty((2 if df else 1, S, 2, n // 128, 256),
                       dtype=torch.float32, device=dev)
    nz_int = torch.empty((S, 2), dtype=torch.int32, device=dev)
    mag = torch.empty((S, 2, n // 2), dtype=torch.float32, device=dev)
    nz = torch.empty((S, 2), dtype=torch.float32, device=dev)
    tw = ("twr_df", "twi_df") if df else ("twr", "twi")
    ptrs = [t.data_ptr() for t in (x, w_hi, w_lo,
                                   *(c[k] for k in (*getattr(exact_cuda,
                                                             keys), *tw)),
                                   rows, nz_int, mag, nz)]

    def launch(stage):
        err = getattr(lib, entry)(
            stage, int(df), *ptrs, S, n,
            torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"{entry}({stage}) failed: {err}")

    launch(1)
    launch(2)
    ref, nz_ref = wrap(x, (w_hi, w_lo), tier)
    torch.cuda.synchronize()
    check(same_bits(mag, ref) and torch.equal(nz, nz_ref),
          f"{body} stages apart vs the wrapper at N={n} S={S} df={df}")
    return tuple(cuda_median_ms(f, busy_ahead=True) for f in (
        lambda: launch(1), lambda: launch(2),
        lambda: (launch(1), launch(2)),
        lambda: wrap(x, (w_hi, w_lo), tier)))


def library_ms(n: int, S: int, dev, pair: bool = True,
               busy_ahead: bool = False) -> float:
    """The library call that computes a kernel's function in float64, timed
    on CUDA events (the port never calls it): ``torch.fft.rfft(x.double()
    * w).abs()`` for the pair kernels on [S, 2, n], ``torch.fft.fft`` of
    the complex128 pair for K3 on [S, n].  ``busy_ahead`` as in
    :func:`cuda_median_ms`."""
    rng = np.random.default_rng(SEED + 6)
    x = torch.from_numpy((0.5 * rng.standard_normal((S, 2, n))).astype(
        np.float32)).to(dev)
    w64, _ = hann_pair(n, dev)
    w = torch.from_numpy(w64).to(dev)
    if pair:
        return cuda_median_ms(lambda: torch.fft.rfft(x.double() * w).abs(),
                              busy_ahead=busy_ahead)
    return cuda_median_ms(lambda: torch.fft.fft(torch.complex(
        x[:, 0].double() * w, x[:, 1].double() * w)), busy_ahead=busy_ahead)


def c128(z) -> np.ndarray:
    """((re_hi, re_lo), (im_hi, im_lo)) df32 tensors -> complex128."""
    def val(p):
        return (p[0].double() + p[1].double()).cpu().numpy()
    return val(z[0]) + 1j * val(z[1])


def phase_cfft(exact_cuda, exactfft, dev, shapes, seed: int):
    """K3 vs its twin vs float64 at each (N, S) of ``shapes`` on three
    inputs made from ``x`` [S, 2, N]: the channel pair as f32 tensors, as
    Hann-windowed df32 pairs (the packed pair's input), and channel 0 as
    a Hann-windowed df32 real part with a zero f32 imaginary part (the
    mono input).  Each call adds one to ``exact_cuda.launches_cfft``,
    matches the twin bit for bit in all four df32 outputs (NaN lanes by
    position) and float64 within TOL; a silent stream stays exactly 0, the
    1e20 stream finite, and the 1e20/NaN streams keep to themselves.
    Returns the number of cases and the worst relative errors."""
    rng = np.random.default_rng(seed)
    worst = {"twin": 0.0, "f64": 0.0}
    cases = 0
    for n, S in shapes:
        for kind in ("f32", "df32", "mono"):
            x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
            x[0, 0] += np.sin(2 * np.pi * 440.0 * np.arange(n) / SR)
            bad = bad_streams(x, rng)
            good = [s for s in range(S) if s not in bad]
            xd = torch.from_numpy(x).to(dev)
            w64, win = hann_pair(n, dev)
            if kind == "f32":
                w64 = np.ones(n)
                re, im = xd[:, 0].contiguous(), xd[:, 1].contiguous()
            elif kind == "df32":
                re, im = (exactfft._windowed_df(xd[:, c], *win)
                          for c in range(2))
            else:
                x[:, 1] = 0.0
                re = exactfft._windowed_df(xd[:, 0], *win)
                im = torch.zeros_like(xd[:, 0])
            before = exact_cuda.launches_cfft
            z = exact_cuda.cfft_exact_kernel(re, im)
            torch.cuda.synchronize()
            check(exact_cuda.launches_cfft == before + 1,
                  f"launches_cfft N={n} S={S} {kind}")
            ref = exact_cuda.cfft_exact_ref(re, im)
            check(all(same_bits(a, b) for a, b in zip((*z[0], *z[1]),
                                                       (*ref[0], *ref[1]))),
                  f"K3 N={n} S={S} {kind}: not bit for bit with the twin")
            got, twin = c128(z), c128(ref)
            want = np.fft.fft((x[good, 0].astype(np.float64)
                               + 1j * x[good, 1].astype(np.float64)) * w64)
            scale = np.abs(want).max()
            e_twin = np.abs(got[good] - twin[good]).max() / scale
            e_f64 = np.abs(got[good] - want).max() / scale
            check(e_twin <= TOL, f"K3 N={n} S={S} {kind} vs twin {e_twin}")
            check(e_f64 <= TOL, f"K3 N={n} S={S} {kind} vs f64 {e_f64}")
            if bad:
                check(np.isfinite(got[3]).all(), "1e20 stream not finite")
                check((got[1] == 0).all(), "silent stream not zero")
            worst["twin"] = max(worst["twin"], e_twin)
            worst["f64"] = max(worst["f64"], e_f64)
            cases += 1
    return cases, worst


def feed_signal(rng, S: int, k: int, channels: int = 2) -> np.ndarray:
    """[S, channels, HOP]: a 440 Hz tone plus noise; the last stream is
    silent."""
    t = (np.arange(HOP) + k * HOP) / SR
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(
        (S, channels, HOP))
    x[-1] = 0.0
    return x.astype(np.float32)


def oracle_gate(wt, ServingEngine, fft_size: int, ticks: int, rng, now0,
                channels: int = 2):
    """The bench's accuracy gate: TSmoothing NONE, one noise window in the
    ring against the float64 oracle, max |dB err| on bins above -120 dBFS."""
    gcfg = wt.resolve(wt.Settings(fft_size=fft_size,
                                  enable_large_fft=fft_size > 8192,
                                  width=800, window=wt.FFTWindow.HANN,
                                  temporal_smoothing=wt.TSmoothingMode.NONE),
                      wt.AudioInfo(SR, channels))
    geng = ServingEngine(gcfg, 2, device="cuda")
    for k in range(ticks):
        now = now0 + k * 16_666_667
        geng.feed_batch(rng.uniform(-0.5, 0.5, (2, channels, HOP)).astype(
            np.float32), now, now_ns=now)
        geng.tick(now_ns=now)
    window = geng.ring.buf[0].cpu().numpy().astype(np.float64)
    want, _ = wt.oracle.spectrum_frame(window, None, gcfg, dt=1 / 60)
    got = geng.read_decibels()[0]
    gvis = want > -120.0
    gate = float(np.abs(got[gvis] - want[gvis]).max())
    check(gate < 1e-4, f"N={fft_size} accuracy gate {gate} dB")
    return gate


def drive_slice(wt, exact_cuda, eng, cpu, packets, now0):
    """Feed ``packets`` through the card engine (counts set to 0 just
    before, read just after) and, for its first streams and the silent
    last one, through the CPU port; check pixels, silence, the tone's peak
    and card vs CPU.  Returns (the launch counts in ``COUNTERS`` order,
    pixel shape, peak Hz, card-vs-CPU dB)."""
    for name in COUNTERS:
        setattr(exact_cuda, name, 0)
    for k, x in enumerate(packets):
        now = now0 + k * 16_666_667
        eng.feed_batch(x, now, now_ns=now)
        eng.tick(now_ns=now)
    torch.cuda.synchronize()
    counts = tuple(getattr(exact_cuda, name) for name in COUNTERS)
    n_cpu = cpu.S - 1
    for k, x in enumerate(packets):
        now = now0 + k * 16_666_667
        cpu.feed_batch(np.concatenate([x[:n_cpu], x[-1:]]), now, now_ns=now)
        cpu.tick(now_ns=now)
    S, n = eng.S, eng.cfg.fft_size
    px = eng.read_pixels()
    db = eng.read_decibels()
    check(px.shape == (S, 1, 800) and np.isfinite(px).all(), "pixels")
    check((db[-1] == np.float32(wt.DB_MIN)).all(), "silent stream dB")
    check(bool(eng.last_silent[-1]) and not eng.last_silent[:-1].any(),
          "silence latch")
    peak_hz = int(np.argmax(db[0, 0])) * SR / n
    check(abs(peak_hz - 440.0) < SR / n, f"peak at {peak_hz} Hz")
    db_cpu = cpu.read_decibels()
    ref = db_cpu[:n_cpu]
    vis = ref > -120.0
    e_cpu = float(np.abs(db[:n_cpu][vis] - ref[vis]).max())
    check(e_cpu < 1e-4, f"N={n} card vs CPU port {e_cpu} dB")
    check(np.array_equal(db[-1], db_cpu[-1]), "silent stream vs CPU port")
    return counts, px.shape, peak_hz, e_cpu


def only(counter: str, count: int) -> tuple:
    """The launch counts (``COUNTERS`` order) of a run that launched
    ``counter``'s kernel ``count`` times and no other kernel."""
    return tuple(count if c == counter else 0 for c in COUNTERS)


def tick_ms(eng, packets, now0) -> float:
    """Median full tick (feed_batch + tick) on CUDA events, continuing the
    engine's clock after ``packets``."""
    k = [len(packets)]

    def one_tick():
        now = now0 + k[0] * 16_666_667
        eng.feed_batch(packets[k[0] % len(packets)], now, now_ns=now)
        eng.tick(now_ns=now)
        k[0] += 1

    return cuda_median_ms(one_tick)


def kernel_times(kernel, twin, n: int, S: int, dev):
    """(kernel ms, twin ms, max |kernel - twin|) at [S, 2, n], Hann."""
    x = (0.5 * np.random.default_rng(SEED + 2).standard_normal(
        (S, 2, n))).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    _, win = hann_pair(n, dev)
    mag, _ = kernel(xd, win)
    ref, _ = twin(xd, win)
    max_abs = float((mag - ref).abs().max())
    return (cuda_median_ms(lambda: kernel(xd, win)),
            cuda_median_ms(lambda: twin(xd, win)), max_abs)


def cfft_times(exact_cuda, exactfft, n: int, S: int, dev):
    """(K3 ms, twin ms, max |K3 - twin| over the four df32 outputs) on a
    Hann-windowed df32 pair [S, n], the packed pair's input; the
    difference must stay within TOL of the twin's largest bin."""
    rng = np.random.default_rng(SEED + 5)
    x = torch.from_numpy((0.5 * rng.standard_normal((S, 2, n))).astype(
        np.float32)).to(dev)
    _, win = hann_pair(n, dev)
    re, im = (exactfft._windowed_df(x[:, c], *win) for c in range(2))
    z = exact_cuda.cfft_exact_kernel(re, im)
    ref = exact_cuda.cfft_exact_ref(re, im)
    max_abs = max(float((a - b).abs().max())
                  for a, b in zip((*z[0], *z[1]), (*ref[0], *ref[1])))
    scale = max(float(ref[0][0].abs().max()), float(ref[1][0].abs().max()))
    check(max_abs <= TOL * scale,
          f"K3 vs twin at N={n} S={S}: {max_abs} > {TOL} x {scale}")
    return (cuda_median_ms(lambda: exact_cuda.cfft_exact_kernel(re, im)),
            cuda_median_ms(lambda: exact_cuda.cfft_exact_ref(re, im)),
            max_abs)


def cfft_stage_ms(exact_cuda, exactfft, n: int, S: int, dev):
    """K3's two launches timed apart on CUDA events with the device kept
    busy ahead of each (as :func:`stage_ms`), on a Hann-windowed df32 pair
    [S, n] (path a's input): (stage 1 ms, stage 2 ms, both ms, the wrapper
    ms).  The stages run apart must give the wrapper's four outputs bit
    for bit."""
    lib = exact_cuda.build()
    x = torch.from_numpy((0.5 * np.random.default_rng(SEED + 15)
                          .standard_normal((S, 2, n))).astype(np.float32)
                         ).to(dev)
    _, win = hann_pair(n, dev)
    re, im = (tuple(p.contiguous() for p in exactfft._windowed_df(
        x[:, c], *win)) for c in range(2))
    c = exact_cuda._consts_cfft(n, dev)
    rows = torch.empty((2, S, n // 128, 256), dtype=torch.float32,
                       device=dev)
    out = torch.empty((4, S, n), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (*re, *im,
                                   *(c[k] for k in exact_cuda.K3_CONSTS),
                                   rows, out)]

    def launch(stage):
        err = lib.wf_exact_cfft_stage(
            stage, *ptrs, S, n, torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"wf_exact_cfft_stage({stage}) failed: {err}")

    launch(1)
    launch(2)
    z = exact_cuda.cfft_exact_kernel(re, im)
    torch.cuda.synchronize()
    check(all(same_bits(out[i], w) for i, w in enumerate((*z[0], *z[1]))),
          f"K3 stages apart vs the wrapper at N={n} S={S}")
    return tuple(cuda_median_ms(f, busy_ahead=True) for f in (
        lambda: launch(1), lambda: launch(2),
        lambda: (launch(1), launch(2)),
        lambda: exact_cuda.cfft_exact_kernel(re, im)))


def stage_ops(body: str, n: int, S: int) -> tuple[int, int]:
    """The int8 operations of ``body``'s stage 1 and stage 2 at [S, 2, n]
    (``STAGED``; the df tier adds none), or at K3's [S, n] (``body`` "K3":
    F1b is K1-gen's two channels' work, F2b's 256 columns its kept half
    of both channels)."""
    n1 = n // 128
    if body == "K2":
        a = n1 // 4
        macs1 = 2 * 2 * (4 * a) * (2 * a) * 128 * 10       # c02, c13
    else:
        macs1 = 5120 * n1 * n1                              # F1r, 2 channels
    return 2 * S * macs1, 2 * S * 655360 * n1


def print_stages(exact_cuda, card: str, dev, phase: str, body: str,
                 df: bool, shapes) -> None:
    """One line per (n, S) of ``shapes``: ``body``'s (df: its df
    instance's) two stages apart, both, the wrapper and the library call,
    all on the device's clock (:func:`stage_ms`), with each stage's int8
    rate."""
    name = STAGED[body][4] if df else body
    for n, s_n in shapes:
        st1, st2, both, wrapped = stage_ms(exact_cuda, body, n, s_n, dev, df)
        ops1, ops2 = stage_ops(body, n, s_n)
        lib_dev = library_ms(n, s_n, dev, busy_ahead=True)
        print(f"{phase} [{card}]: {name} stages apart (device time) at "
              f"S={s_n} N={n}: stage 1 {st1 * 1e3:.1f} us "
              f"({ops1 / (st1 * 1e-3) / 1e12:.1f} TOP/s), stage 2 "
              f"{st2 * 1e3:.1f} us ({ops2 / (st2 * 1e-3) / 1e12:.1f} TOP/s), "
              f"both {both * 1e3:.1f} us; on the same clock the wrapper "
              f"{wrapped * 1e3:.1f} us, the library call "
              f"{lib_dev * 1e3:.1f} us", flush=True)


def print_k2_extras(exact_cuda, card: str, dev, phase: str, df: bool,
                    lib_ms: float):
    """K2 (df: K2-df) against K1-gen (df: K1-df) in turns at (16384, 256),
    with the library call there (``lib_ms``), K2's rate and share of its
    bound, and the two stages of K2 apart at (65536, 32) and (16384,
    256) (:func:`print_stages`)."""
    tier = "df" if df else "f32"
    name = "K2-df" if df else "K2"
    n, s_n = 16384, 256
    x = torch.from_numpy((0.5 * np.random.default_rng(SEED + 14)
                          .standard_normal((s_n, 2, n))).astype(np.float32)
                         ).to(dev)
    _, win = hann_pair(n, dev)

    def k2():
        return exact_cuda.rfft_pair_mag3(x, win, tier)

    def gen():
        return exact_cuda.rfft_pair_mag_gen(x, win, tier)

    t = [cuda_median_ms(f) for f in (k2, gen, gen, k2)]
    print(f"{phase} [{card}]: {name} {t[0] * 1e3:.1f} / {t[3] * 1e3:.1f} us, "
          f"{'K1-df' if df else 'K1-gen'} {t[1] * 1e3:.1f} / "
          f"{t[2] * 1e3:.1f} us (in turns) at S={s_n} N={n}: {name} "
          f"{(t[1] + t[2]) / (t[0] + t[3]):.2f}x faster; library "
          f"{lib_ms * 1e3:.1f} us; {name} "
          + rate_line("exact_mag3", (t[0] + t[3]) / 2, n, s_n), flush=True)
    print_stages(exact_cuda, card, dev, phase, "K2", df,
                 ((65536, 32), (16384, 256)))


def eager_tick(eng, now: int):
    """One tick of ``eng`` with its device function run eagerly (every
    torch op launched from the host, as the first tick's warm-up runs it):
    the reference and the "before" of the graph tick."""
    eng._flip ^= 1
    eng._bind_buf(eng._flip)
    uniform = eng._stage(now, 1.0 / eng.cfg.fps)
    eng._upload(eng._host[eng._flip], eng._dev_in, eng._events, eng._flip)
    return eng._graph_fn(("tick", uniform))()


# the stage-1 kernel of each launch counter's wrapper (one a launch), and
# whether it is the df instance (a kernel template argument <true>)
STAGE1 = {"launches_gen": ("exact_mag_gen_stage1", False),
          "launches_gen_df": ("exact_mag_gen_stage1", True),
          "launches3": ("exact_mag3_stage1", False),
          "launches3_df": ("exact_mag3_stage1", True),
          "launches_cfft": ("exact_cfft_stage1", None)}


def profiled(profiler, one_tick, n: int = 5):
    """``n`` ticks under ``profiler.trace``: (device summary, device ops a
    tick, {counter: our stage-1 kernels a tick}) read from the trace's
    device kernels by name."""
    torch.cuda.synchronize()
    with profiler.trace() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            one_tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summ = profiler.device_summary(prof, wall)
    ours = {}
    for counter, (stem, df) in STAGE1.items():
        k = sum(c for name, (c, _) in summ["kernels"].items()
                if stem in name and (df is None or ("<true>" in name) == df))
        if k:
            ours[counter] = k / n
    ops = sum(c for c, _ in summ["kernels"].values()) / n
    return summ, ops, ours


def phase_graph(wt, ServingEngine, profiler, exact_cuda, rng, cell):
    """One slice path as a graph tick against its eager tick: bit for bit
    in 8 ticks' pixels and the final state; the kernels a replay launches,
    from the capture and from the profiler's kernel names (which must
    agree, one stage-1 kernel a launch); eager and graph ticks in turns
    (feed_batch + tick, CUDA events); the device busy share of 5 profiled
    ticks of each.  Returns (graph ms, eager ms, busy shares, device ops a
    tick, kernels a replay)."""
    label, settings, channels, envs, S, counter = cell
    with contextlib.ExitStack() as stack:
        for k, v in envs.items():
            stack.enter_context(env(k, v))
        cfg = wt.resolve(wt.Settings(width=800, window=wt.FFTWindow.HANN,
                                     interp_mode=wt.InterpMode.LANCZOS,
                                     **settings), wt.AudioInfo(SR, channels))
        graph = ServingEngine(cfg, S, device="cuda")
        eager = ServingEngine(cfg, S, device="cuda")
        pk = [feed_signal(rng, S, k, channels) for k in range(8)]
        now = time.monotonic_ns()
        for x in pk:
            now += 16_666_667
            graph.feed_batch(x, now, now_ns=now)
            eager.feed_batch(x, now, now_ns=now)
            check(same_bits(graph.tick(now_ns=now), eager_tick(eager, now)),
                  f"graph {label}: graph tick vs eager tick not bit for bit")
        torch.cuda.synchronize()
        for a, b in ((graph.state.tsmooth, eager.state.tsmooth),
                     (graph.state.decibels, eager.state.decibels),
                     (graph.state.last_silent, eager.state.last_silent),
                     (graph.ring.buf, eager.ring.buf)):
            check(torch.equal(a, b), f"graph {label}: state differs")
        want = {counter: 1} if counter else {}
        per_replay = graph.kernels_per_replay
        check(per_replay == {("tick", True): want},
              f"graph {label}: kernels a replay {per_replay}, want {want}")
        clock = [now, 0]

        def ticker(eng, run):
            def one_tick():
                clock[0] += 16_666_667
                clock[1] += 1
                eng.feed_batch(pk[clock[1] % 8], clock[0], now_ns=clock[0])
                run(eng, clock[0])
            return one_tick

        g_tick = ticker(graph, lambda e, t: e.tick(now_ns=t))
        e_tick = ticker(eager, eager_tick)
        turns = [cuda_median_ms(f, reps=20, warmup=3)
                 for f in (e_tick, g_tick, g_tick, e_tick)]
        before = {c: getattr(exact_cuda, c) for c in COUNTERS}
        g_sum, g_ops, g_ours = profiled(profiler, g_tick)
        moved = {c: (getattr(exact_cuda, c) - n) / 5
                 for c, n in before.items() if getattr(exact_cuda, c) != n}
        check(g_ours == want and moved == want,
              f"graph {label}: profiled kernels a replay {g_ours}, counters "
              f"{moved}, want {want}")
        e_sum, e_ops, e_ours = profiled(profiler, e_tick)
        check(e_ours == want, f"graph {label}: eager kernels {e_ours}")
        host = host_split(profiler, graph, g_tick)
    return (turns, (g_sum["busy_share"], e_sum["busy_share"]),
            (g_sum["busy_us"] / 5, e_sum["busy_us"] / 5), (g_ops, e_ops),
            host)


# the engine methods a graph tick's host time is split over (HOST_PIECES
# order), besides the rest of tick() and the wait for the device after it
HOST_PIECES = ("feed_batch", "_bind_buf", "_assemble", "_upload", "_call",
               "_fresh")


def host_split(profiler, eng, one_tick, n: int = 60):
    """``n`` ticks of ``one_tick`` (feed_batch + tick of ``eng``), each
    ended by a synchronize, on the host clock: the FrameProfiler's p50 and
    p99 (ms) and {piece: median µs} of the tick's host pieces — each method
    of ``HOST_PIECES`` (``_call`` is the replay's enqueue), the rest of
    ``tick`` and the wait for the device after ``tick`` returned."""
    acc = {name: [] for name in HOST_PIECES}

    def timed(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            acc[name].append(time.perf_counter() - t)
            return out
        return run

    tick = eng.tick
    for name in HOST_PIECES:
        setattr(eng, name, timed(name, getattr(eng, name)))
    frames = profiler.FrameProfiler(eng.S, eng.cfg.fft_size)
    rest, wait = [], []
    try:
        for _ in range(n):
            stamps = []
            eng.tick = lambda **k: (stamps.append(time.perf_counter()),
                                    tick(**k),
                                    stamps.append(time.perf_counter()))[1]
            with frames.tick():
                one_tick()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
            inside = sum(acc[p][-1] for p in HOST_PIECES[1:])
            rest.append(stamps[1] - stamps[0] - inside)
            wait.append(t3 - stamps[1])
    finally:
        for name in (*HOST_PIECES, "tick"):
            delattr(eng, name)
    med = {name: statistics.median(v) * 1e6 for name, v in acc.items()}
    med["rest of tick"] = statistics.median(rest) * 1e6
    med["device wait"] = statistics.median(wait) * 1e6
    st = frames.stats()
    return st["p50_ms"], st["p99_ms"], med


def kernel_label(fn: str) -> str:
    """A mangled kernel name as name<template arguments>."""
    m = re.search(r"_cu_[0-9a-f]{8}\d+(exact_[a-z0-9_]+?)(I.*?E)?E", fn)
    if m is None:
        return fn
    return f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2) or ''))}>"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    secs = {}

    # 1. device -----------------------------------------------------------
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    check(cap == (9, 0), f"compute capability {cap}, want (9, 0)")
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)              # nvidia-smi's name, power.limit

    import waveform_tpu_torch as wt
    from waveform_tpu_torch.kernels import exact_cuda, exactfft
    from waveform_tpu_torch.runtime.serving import ServingEngine

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    exact_cuda.build()
    secs["build"] = time.perf_counter() - t0
    print(f"build: {secs['build']:.2f} s "
          f"({exact_cuda.build_info['library']}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, capability {cap})", flush=True)
    for ln in exact_cuda.build_info.get("log", "").splitlines():
        if "entry function" in ln or "registers" in ln:
            print(f"build: {ln.strip()}", flush=True)
    # every kernel runs its digit GEMMs on the int8 tensor cores
    sass = exact_cuda.sass_counts()
    for fn, c in sass.items():
        print(f"build: sass {kernel_label(fn)}: "
              + ", ".join(f"{op} {k}" for op, k in c.items()), flush=True)
    check(len(sass) == KERNELS
          and all(c["IMMA"] + c["IGMMA"] > 0 and c["IDP.4A"] == 0
                  for c in sass.values()),
          f"kernels not on the int8 tensor cores, or {KERNELS} expected: "
          f"{sass}")
    props = [ln for ln in exact_cuda.build_info.get("log", "").splitlines()
             if "spill" in ln]
    spills = [ln for ln in props if not re.search(
        r"\b0 bytes spill stores, 0 bytes spill loads", ln)]
    check(not spills, f"ptxas reports spills: {spills}")
    print(f"build: ptxas: {len(props)} functions, no spill stores or loads",
          flush=True)

    # 3. kernel vs twin ---------------------------------------------------
    t0 = time.perf_counter()
    cases, worst = phase_kernel(exact_cuda, dev, exact_cuda.rfft_pair_mag,
                                exact_cuda.rfft_pair_mag_ref, "launches_gen",
                                K1_SIZES, (1, 7, 256), SEED, bitwise=True)
    secs["kernel"] = time.perf_counter() - t0
    print(f"kernel: {cases} K1-gen cases at N in {K1_SIZES} through the "
          f"router, bit for bit vs the twin (max|d|/max|ref| "
          f"{worst['twin']:.3e}), vs float64 {worst['f64']:.3e} (bound "
          f"{TOL}); nz exact; 1e20/NaN streams isolated", flush=True)

    # 4. slice ------------------------------------------------------------
    t0 = time.perf_counter()
    cfg = wt.resolve(wt.Settings(fft_size=4096, width=800,
                                 window=wt.FFTWindow.HANN,
                                 interp_mode=wt.InterpMode.LANCZOS),
                     wt.AudioInfo(SR, 2))
    S, ticks = 256, 8
    eng = ServingEngine(cfg, S, device="cuda")
    cpu = ServingEngine(cfg, 4, device="cpu")
    rng = np.random.default_rng(SEED + 1)
    packets = [feed_signal(rng, S, k) for k in range(ticks)]
    now0 = time.monotonic_ns()
    counts, px_shape, peak_hz, e_cpu = drive_slice(wt, exact_cuda, eng, cpu,
                                                   packets, now0)
    launches = counts[COUNTERS.index("launches_gen")]
    check(counts == only("launches_gen", ticks),
          f"launches {counts} ({'/'.join(COUNTERS)}) in {ticks} ticks at "
          "N=4096: want K1-gen's alone")
    gate = oracle_gate(wt, ServingEngine, 4096, 8, rng, now0)
    torch.cuda.synchronize()
    secs["slice"] = time.perf_counter() - t0
    print(f"slice: S={S} N=4096 800px Lanczos, {ticks} ticks, {launches} "
          f"K1-gen launches, no other kernel, pixels {px_shape} finite, "
          f"silent stream at DB_MIN, peak {peak_hz:.1f} Hz, card vs CPU port {e_cpu:.2e} dB, "
          f"oracle gate {gate:.2e} dB (< 1e-4), assembler "
          f"{'native' if eng._native is not None else 'python'}", flush=True)

    # 5. times ------------------------------------------------------------
    t0 = time.perf_counter()
    k_ms, p_ms, max_abs = kernel_times(exact_cuda.rfft_pair_mag,
                                       exact_cuda.rfft_pair_mag_ref, 4096, S,
                                       dev)
    t_ms = tick_ms(eng, packets, now0)
    secs["times"] = time.perf_counter() - t0
    print(f"times [{card}]: K1-gen {k_ms * 1e3:.1f} us, twin "
          f"{p_ms * 1e3:.1f} us at S={S} N=4096; full tick (feed_batch + "
          f"tick) {t_ms * 1e3:.1f} us = {S / (t_ms * 1e-3):,.0f} frames/s",
          flush=True)
    del eng, cpu

    # 6. kernel3: K2 vs twin ----------------------------------------------
    t0 = time.perf_counter()
    cases3, worst3 = phase_kernel(
        exact_cuda, dev, exact_cuda.rfft_pair_mag3,
        exact_cuda.rfft_pair_mag3_ref, "launches3",
        (4096,) + exact_cuda.SIZES3, (1, 7, 32), SEED + 3,
        versus=(exact_cuda.rfft_pair_mag, (4096,)), bitwise=True)
    secs["kernel3"] = time.perf_counter() - t0
    print(f"kernel3: {cases3} cases at N in {(4096,) + exact_cuda.SIZES3}, "
          f"bit for bit vs the twin (max|d|/max|ref| "
          f"{worst3['twin']:.3e}), vs float64 "
          f"{worst3['f64']:.3e} (bound {TOL}), vs K1-gen at N=4096 "
          f"{worst3['versus']:.3e} (bound {TOL_SPLITS}); nz exact; 1e20/NaN "
          "streams isolated", flush=True)

    # 7. slice3: the large-FFT configuration --------------------------------
    t0 = time.perf_counter()
    cfg3 = wt.resolve(wt.Settings(fft_size=65536, enable_large_fft=True,
                                  width=800, window=wt.FFTWindow.HANN,
                                  interp_mode=wt.InterpMode.LANCZOS),
                      wt.AudioInfo(SR, 2))
    check(cfg3.fft_size == 65536, f"resolved fft_size {cfg3.fft_size}")
    S3, ticks3 = 32, 84
    eng3 = ServingEngine(cfg3, S3, device="cuda")
    cpu3 = ServingEngine(cfg3, 2, device="cpu")
    packets3 = [feed_signal(rng, S3, k) for k in range(ticks3)]
    now3 = time.monotonic_ns()
    counts3, px3, peak3, e_cpu3 = drive_slice(wt, exact_cuda, eng3, cpu3,
                                              packets3, now3)
    launches3 = counts3[COUNTERS.index("launches3")]
    check(counts3 == only("launches3", ticks3),
          f"launches {counts3} ({'/'.join(COUNTERS)}) in {ticks3} ticks at "
          "N=65536: want K2's alone")
    gate3 = oracle_gate(wt, ServingEngine, 65536, ticks3, rng, now3)
    torch.cuda.synchronize()
    secs["slice3"] = time.perf_counter() - t0
    print(f"slice3: S={S3} N=65536 800px Lanczos (gather rebin), {ticks3} "
          f"ticks, {launches3} K2 launches, no other kernel, pixels "
          f"{px3} finite, silent stream at DB_MIN, peak {peak3:.2f} Hz, card "
          f"vs CPU port (2 streams) {e_cpu3:.2e} dB, oracle gate "
          f"{gate3:.2e} dB (< 1e-4)", flush=True)

    # 8. times3 -------------------------------------------------------------
    t0 = time.perf_counter()
    lib3 = {}
    for n, s_n in ((8192, 256), (16384, 256), (32768, 64), (65536, 32)):
        k3_ms, p3_ms, max_abs3 = kernel_times(
            exact_cuda.rfft_pair_mag3, exact_cuda.rfft_pair_mag3_ref, n, s_n,
            dev)
        line = (f"times3 [{card}]: K2 {k3_ms * 1e3:.1f} us, twin "
                f"{p3_ms * 1e3:.1f} us at S={s_n} N={n}")
        if (n, s_n) in ((16384, 256), (65536, 32)):
            lib3[n] = library_ms(n, s_n, dev)
            line += (f", library {lib3[n] * 1e3:.1f} us, "
                     + rate_line("exact_mag3", k3_ms, n, s_n))
        print(line, flush=True)
    mag3_row = (k3_ms, p3_ms, max_abs3)           # (65536, 32)
    print_k2_extras(exact_cuda, card, dev, "times3", False, lib3[16384])
    t3_ms = tick_ms(eng3, packets3, now3)
    secs["times3"] = time.perf_counter() - t0
    print(f"times3 [{card}]: full tick (feed_batch + tick) "
          f"{t3_ms * 1e3:.1f} us at S={S3} N=65536 = "
          f"{S3 / (t3_ms * 1e-3):,.0f} frames/s", flush=True)
    del eng3, cpu3

    # 9. cfft: K3 vs twin ---------------------------------------------------
    t0 = time.perf_counter()
    sizes_c = (1024, 3072, 4096, 16384, 32768)
    shapes_c = [(n, s_n) for n in sizes_c for s_n in (1, 7, 64)]
    cases_c, worst_c = phase_cfft(exact_cuda, exactfft, dev,
                                  shapes_c + [(4096, S)], SEED + 4)
    secs["cfft"] = time.perf_counter() - t0
    print(f"cfft: {cases_c} cases at N in {sizes_c} and (N, S) = "
          f"(4096, {S}), f32/df32/mono inputs, max|d|/max|ref| vs "
          f"twin {worst_c['twin']:.3e}, vs float64 {worst_c['f64']:.3e} "
          f"(bound {TOL}); silent stream 0, 1e20/NaN streams isolated",
          flush=True)

    # 10. slice_packed: paths a (stereo) and b (mono) under FUSED=never -----
    t0 = time.perf_counter()
    packed = {}
    with env("WAVEFORM_TPU_EXACT_FUSED", "never"):
        for path, channels in (("a", 2), ("b", 1)):
            cfg_p = wt.resolve(wt.Settings(fft_size=4096, width=800,
                                           window=wt.FFTWindow.HANN,
                                           interp_mode=wt.InterpMode.LANCZOS),
                               wt.AudioInfo(SR, channels))
            eng_p = ServingEngine(cfg_p, S, device="cuda")
            cpu_p = ServingEngine(cfg_p, 4, device="cpu")
            pk = [feed_signal(rng, S, k, channels) for k in range(ticks)]
            now_p = time.monotonic_ns()
            counts_p, px_p, peak_p, e_cpu_p = drive_slice(
                wt, exact_cuda, eng_p, cpu_p, pk, now_p)
            k3_p = counts_p[COUNTERS.index("launches_cfft")]
            check(counts_p == only("launches_cfft", ticks),
                  f"path {path}: launches {counts_p} ({'/'.join(COUNTERS)}) "
                  f"in {ticks} ticks: want K3's alone")
            gate_p = oracle_gate(wt, ServingEngine, 4096, 8, rng, now_p,
                                 channels)
            packed[path] = (eng_p, pk, now_p, k3_p)
            print(f"slice_packed: path {path} ({channels}-channel capture, "
                  f"EXACT_FUSED=never) S={S} N=4096 800px Lanczos, {ticks} "
                  f"ticks, {k3_p} K3 launches, no other kernel, pixels "
                  f"{px_p} finite, silent stream at DB_MIN, peak "
                  f"{peak_p:.1f} Hz, card vs CPU port {e_cpu_p:.2e} dB, "
                  f"oracle gate {gate_p:.2e} dB (< 1e-4)", flush=True)
            del cpu_p
    torch.cuda.synchronize()
    secs["slice_packed"] = time.perf_counter() - t0

    # 11. slice_small: path c, the auto FFT size through the lowering -----
    t0 = time.perf_counter()
    with env("WAVEFORM_TPU_EXACT_FUSED", None):
        cfg_c = wt.resolve(wt.Settings(auto_fft_size=True, width=800,
                                       window=wt.FFTWindow.HANN,
                                       interp_mode=wt.InterpMode.LANCZOS),
                           wt.AudioInfo(SR, 2))
        check(cfg_c.fft_size == 800, f"auto fft_size {cfg_c.fft_size}")
        eng_c = ServingEngine(cfg_c, S, device="cuda")
        cpu_c = ServingEngine(cfg_c, 4, device="cpu")
        pk_c = [feed_signal(rng, S, k) for k in range(ticks)]
        now_c = time.monotonic_ns()
        counts_c = drive_slice(wt, exact_cuda, eng_c, cpu_c, pk_c, now_c)
        check(counts_c[0] == (0,) * len(COUNTERS), f"path c kernel "
              f"launches {counts_c[0]}")
        gate_c = oracle_gate(wt, ServingEngine, 800, 2, rng, now_c)
    torch.cuda.synchronize()
    secs["slice_small"] = time.perf_counter() - t0
    print(f"slice_small: path c (auto FFT size) S={S} N=800 800px Lanczos, "
          f"{ticks} ticks, K2/K3/K1-gen/K1-df/K2-df launches "
          f"{counts_c[0]}, pixels "
          f"{counts_c[1]} finite, silent stream at DB_MIN, peak "
          f"{counts_c[2]:.1f} Hz, card vs CPU port {counts_c[3]:.2e} dB, "
          f"oracle gate {gate_c:.2e} dB (< 1e-4)", flush=True)
    del cpu_c

    # 12. times_cfft --------------------------------------------------------
    t0 = time.perf_counter()
    lib_c = {}
    for n, s_n in ((4096, 256), (32768, 32)):
        kc_ms, pc_ms, max_abs_c = cfft_times(exact_cuda, exactfft, n, s_n,
                                             dev)
        lib_c[n] = library_ms(n, s_n, dev, pair=False)
        print(f"times_cfft [{card}]: K3 {kc_ms * 1e3:.1f} us, twin "
              f"{pc_ms * 1e3:.1f} us, library {lib_c[n] * 1e3:.1f} us at "
              f"S={s_n} N={n}, max|K3 - twin| {max_abs_c:.1e}; K3 "
              + rate_line("exact_cfft", kc_ms, n, s_n), flush=True)
        if n == 4096:
            cfft_row = (kc_ms, pc_ms, max_abs_c)
        st1, st2, both, wrapped = cfft_stage_ms(exact_cuda, exactfft, n, s_n,
                                                dev)
        ops1, ops2 = stage_ops("K3", n, s_n)
        lib_dev = library_ms(n, s_n, dev, pair=False, busy_ahead=True)
        print(f"times_cfft [{card}]: K3 stages apart (device time) at "
              f"S={s_n} N={n}: stage 1 {st1 * 1e3:.1f} us "
              f"({ops1 / (st1 * 1e-3) / 1e12:.1f} TOP/s), stage 2 "
              f"{st2 * 1e3:.1f} us "
              f"({ops2 / (st2 * 1e-3) / 1e12:.1f} TOP/s), both "
              f"{both * 1e3:.1f} us; on the same clock the wrapper "
              f"{wrapped * 1e3:.1f} us, the library call "
              f"{lib_dev * 1e3:.1f} us", flush=True)
    with env("WAVEFORM_TPU_EXACT_FUSED", "never"):
        eng_a, pk_a, now_a, launches_c = packed["a"]
        ta_ms = tick_ms(eng_a, pk_a, now_a)
    with env("WAVEFORM_TPU_EXACT_FUSED", None):
        tc_ms = tick_ms(eng_c, pk_c, now_c)
    secs["times_cfft"] = time.perf_counter() - t0
    for path, n, t_ms in (("a", 4096, ta_ms), ("c", 800, tc_ms)):
        print(f"times_cfft [{card}]: full tick (feed_batch + tick) path "
              f"{path} {t_ms * 1e3:.1f} us at S={S} N={n} = "
              f"{S / (t_ms * 1e-3):,.0f} frames/s", flush=True)

    # 13. kernel_gen: K1-gen vs twin, float64, K2 and K1 ----------------
    t0 = time.perf_counter()
    sizes_g = (3072, 5120, 6144, 7168, 8192, 9216, 16384, 31744)
    check(all(exact_cuda.stage1_split(n) == 2 for n in sizes_g),
          "K1-gen sizes route to split 2")
    cases_g, worst_g = phase_kernel(
        exact_cuda, dev, exact_cuda.rfft_pair_mag,
        exact_cuda.rfft_pair_mag_ref, "launches_gen", sizes_g, (1, 7, 64),
        SEED + 7, versus=(exact_cuda.rfft_pair_mag3, (8192, 16384)))
    cases_s, worst_s = phase_kernel(
        exact_cuda, dev, exact_cuda.rfft_pair_mag,
        exact_cuda.rfft_pair_mag_ref, "launches_gen", (6144,), (S,),
        SEED + 8)
    with env("WAVEFORM_TPU_STAGE1_SPLIT", "2"):
        check(exact_cuda.supports(32768) and exact_cuda.stage1_split(32768)
              == 2, "N=32768 under STAGE1_SPLIT=2")
        cases_32, worst_32 = phase_kernel(
            exact_cuda, dev, exact_cuda.rfft_pair_mag,
            exact_cuda.rfft_pair_mag_ref, "launches_gen", (32768,),
            (1, 7, 64), SEED + 9)
    secs["kernel_gen"] = time.perf_counter() - t0
    for w in (worst_s, worst_32):
        worst_g = {k: max(v, w[k]) for k, v in worst_g.items()}
    print(f"kernel_gen: {cases_g + cases_s + cases_32} cases at N in "
          f"{sizes_g}, (6144, {S}) and 32768 under STAGE1_SPLIT=2, "
          f"max|d|/max|ref| vs twin {worst_g['twin']:.3e}, vs float64 "
          f"{worst_g['f64']:.3e} (bound {TOL}), vs K2 at 8192/16384 "
          f"{worst_g['versus']:.3e} (bound {TOL_SPLITS}); nz exact; "
          "1e20/NaN streams isolated",
          flush=True)

    # 14. slice_gen: N=6144 (a slider position) and N=16384 -------------
    t0 = time.perf_counter()
    gen = {}
    for n_g, s_g, ticks_g, n_cpu in ((6144, S, ticks, 4), (16384, 64, 21, 2)):
        cfg_g = wt.resolve(wt.Settings(fft_size=n_g,
                                       enable_large_fft=n_g > 8192,
                                       width=800, window=wt.FFTWindow.HANN,
                                       interp_mode=wt.InterpMode.LANCZOS),
                           wt.AudioInfo(SR, 2))
        check(cfg_g.fft_size == n_g, f"resolved fft_size {cfg_g.fft_size}")
        eng_g = ServingEngine(cfg_g, s_g, device="cuda")
        cpu_g = ServingEngine(cfg_g, n_cpu, device="cpu")
        pk_g = [feed_signal(rng, s_g, k) for k in range(ticks_g)]
        now_g = time.monotonic_ns()
        counts_g, px_g, peak_g, e_cpu_g = drive_slice(
            wt, exact_cuda, eng_g, cpu_g, pk_g, now_g)
        gen_g = counts_g[COUNTERS.index("launches_gen")]
        check(counts_g == only("launches_gen", ticks_g),
              f"N={n_g}: launches {counts_g} ({'/'.join(COUNTERS)}) in "
              f"{ticks_g} ticks: want K1-gen's alone")
        gate_g = oracle_gate(wt, ServingEngine, n_g, ticks_g, rng, now_g)
        print(f"slice_gen: S={s_g} N={n_g} 800px Lanczos, {ticks_g} ticks, "
              f"{gen_g} K1-gen launches, no other kernel, "
              f"pixels {px_g} finite, silent stream at DB_MIN, peak "
              f"{peak_g:.2f} Hz, card vs CPU port ({n_cpu} streams) "
              f"{e_cpu_g:.2e} dB, oracle gate {gate_g:.2e} dB (< 1e-4)",
              flush=True)
        if n_g == 6144:
            gen_slice = (eng_g, pk_g, now_g, gen_g)
        del eng_g, cpu_g
    torch.cuda.synchronize()
    secs["slice_gen"] = time.perf_counter() - t0

    # 15. times_gen ---------------------------------------------------------
    t0 = time.perf_counter()
    for n, s_n in ((6144, S), (16384, S)):
        kg_ms, pg_ms, max_abs_g = kernel_times(
            exact_cuda.rfft_pair_mag, exact_cuda.rfft_pair_mag_ref, n, s_n,
            dev)
        lg_ms = library_ms(n, s_n, dev)
        gen[n] = (kg_ms, pg_ms, max_abs_g, lg_ms)
        print(f"times_gen [{card}]: K1-gen {kg_ms * 1e3:.1f} us, twin "
              f"{pg_ms * 1e3:.1f} us, library {lg_ms * 1e3:.1f} us at "
              f"S={s_n} N={n}, max|K1-gen - twin| {max_abs_g:.1e}; K1-gen "
              + rate_line("exact_mag_gen", kg_ms, n, s_n), flush=True)
    k2_ms, p2_ms, _ = kernel_times(exact_cuda.rfft_pair_mag3,
                                   exact_cuda.rfft_pair_mag3_ref, 16384, S,
                                   dev)
    b2_ms, b2_by = bound("exact_mag3", 16384, S)
    print_stages(exact_cuda, card, dev, "times_gen", "K1-gen", False,
                 ((6144, S), (16384, S)))
    print(f"times_gen [{card}]: K2 {k2_ms * 1e3:.1f} us, twin "
          f"{p2_ms * 1e3:.1f} us, bound {b2_ms * 1e3:.2f} us ({b2_by}) at "
          f"S={S} N=16384", flush=True)
    eng_g, pk_g, now_g, launches_gen = gen_slice
    tg_ms = tick_ms(eng_g, pk_g, now_g)
    print(f"times_gen [{card}]: full tick (feed_batch + tick) "
          f"{tg_ms * 1e3:.1f} us at S={S} N=6144 = "
          f"{S / (tg_ms * 1e-3):,.0f} frames/s", flush=True)
    libs = {"exact_mag": library_ms(4096, S, dev),
            "exact_mag3": lib3[65536],
            "exact_cfft": lib_c[4096]}
    secs["times_gen"] = time.perf_counter() - t0

    # 16. kernel_df: K1-df and K2-df vs their twins, float64, the f32 tier
    t0 = time.perf_counter()
    sizes_df = (1024, 2048, 3072, 4096, 6144, 16384, 31744)
    check(all(exact_cuda.stage1_split(n) == 2 for n in sizes_df),
          "K1-df sizes route to split 2")
    cases_df, worst_df = phase_df(
        exact_cuda, dev,
        [("router", n, (1, 7, 64)) for n in sizes_df]
        + [("router", 4096, (S,)), ("k2", 8192, (1, 7, 64)),
           ("router", 32768, (1, 7, 64)), ("router", 65536, (1, 7, 32))],
        SEED + 11)
    secs["kernel_df"] = time.perf_counter() - t0
    print(f"kernel_df: {cases_df} cases, K1-df at N in {sizes_df} and "
          f"(4096, {S}), K2-df at 8192 (direct), 32768 and 65536: bit for "
          f"bit vs the df twins; max|d|/max|ref| vs float64 df "
          f"{worst_df['df']:.3e}, the f32 kernels on the same inputs "
          f"{worst_df['f32']:.3e} (bound {TOL}), bit for bit vs their "
          "twins; nz exact", flush=True)

    # 17. slice_df: both slices under WAVEFORM_TPU_KERNEL_TWIDDLE=df ------
    t0 = time.perf_counter()
    df_slices = {}
    with env("WAVEFORM_TPU_KERNEL_TWIDDLE", "df"):
        for cfg_d, s_d, ticks_d, n_cpu, counter in (
                (cfg, S, ticks, 4, "launches_gen_df"),
                (cfg3, S3, ticks3, 2, "launches3_df")):
            n_d = cfg_d.fft_size
            eng_d = ServingEngine(cfg_d, s_d, device="cuda")
            cpu_d = ServingEngine(cfg_d, n_cpu, device="cpu")
            pk_d = [feed_signal(rng, s_d, k) for k in range(ticks_d)]
            now_d = time.monotonic_ns()
            counts_d, px_d, peak_d, e_cpu_d = drive_slice(
                wt, exact_cuda, eng_d, cpu_d, pk_d, now_d)
            want = only(counter, ticks_d)
            check(counts_d == want, f"df N={n_d}: launches {counts_d} "
                  f"({'/'.join(COUNTERS)}), want {want}")
            gate_d = oracle_gate(wt, ServingEngine, n_d, ticks_d, rng, now_d)
            df_slices[n_d] = (eng_d, pk_d, now_d, counts_d)
            print(f"slice_df: S={s_d} N={n_d} 800px Lanczos, "
                  f"KERNEL_TWIDDLE=df, {ticks_d} ticks, "
                  f"{'K2' if counter == 'launches3_df' else 'K1'}-df "
                  f"launches {ticks_d}, the other kernels 0, pixels {px_d} "
                  f"finite, silent stream at DB_MIN, peak {peak_d:.2f} Hz, "
                  f"card vs CPU port ({n_cpu} streams) {e_cpu_d:.2e} dB, "
                  f"oracle gate {gate_d:.2e} dB (< 1e-4)", flush=True)
            del cpu_d
    torch.cuda.synchronize()
    secs["slice_df"] = time.perf_counter() - t0

    # 18. times_df: each df kernel beside the f32 kernel of its shape -----
    t0 = time.perf_counter()
    df_rows = {}
    for n, s_n, lib_ms in ((4096, S, libs["exact_mag"]),
                           (16384, S, gen[16384][3]),
                           (65536, 32, libs["exact_mag3"])):
        x = torch.from_numpy((0.5 * np.random.default_rng(SEED + 12)
                              .standard_normal((s_n, 2, n)))
                             .astype(np.float32)).to(dev)
        _, win = hann_pair(n, dev)
        twin = (exact_cuda.rfft_pair_mag3_df_ref
                if exact_cuda.stage1_split(n) == 3
                else exact_cuda.rfft_pair_mag_df_ref)
        turns = []
        for tier in ("df", "f32", "f32", "df"):        # in turns
            with env("WAVEFORM_TPU_KERNEL_TWIDDLE", tier):
                turns.append(cuda_median_ms(
                    lambda: exact_cuda.rfft_pair_mag(x, win)))
        with env("WAVEFORM_TPU_KERNEL_TWIDDLE", "df"):
            mag, _ = exact_cuda.rfft_pair_mag(x, win)
        max_abs = float((mag - twin(x, win)[0]).abs().max())
        twin_ms = cuda_median_ms(lambda: twin(x, win))
        body = "K2" if exact_cuda.stage1_split(n) == 3 else "K1"
        b_ms, b_by = bound("exact_mag3" if body == "K2" else "exact_mag_gen",
                           n, s_n)
        df_rows[n] = (turns[0], twin_ms, max_abs, lib_ms)
        print(f"times_df [{card}]: {body}-df {turns[0] * 1e3:.1f} / "
              f"{turns[3] * 1e3:.1f} us, f32 kernel {turns[1] * 1e3:.1f} / "
              f"{turns[2] * 1e3:.1f} us (in turns), df twin "
              f"{twin_ms * 1e3:.1f} us, library {lib_ms * 1e3:.1f} us, bound "
              f"{b_ms * 1e3:.2f} us ({b_by}) at S={s_n} N={n}, "
              f"max|{body}-df - twin| {max_abs:.1e}; {body}-df "
              + rate_line("exact_mag3" if body == "K2" else "exact_mag_gen",
                          turns[0], n, s_n), flush=True)
    print_k2_extras(exact_cuda, card, dev, "times_df", True, lib3[16384])
    print_stages(exact_cuda, card, dev, "times_df", "K1-gen", True,
                 ((4096, S), (16384, S)))
    with env("WAVEFORM_TPU_KERNEL_TWIDDLE", "df"):
        for n_d, (eng_d, pk_d, now_d, _) in df_slices.items():
            td_ms = tick_ms(eng_d, pk_d, now_d)
            print(f"times_df [{card}]: full tick (feed_batch + tick) under "
                  f"df {td_ms * 1e3:.1f} us at S={eng_d.S} N={n_d} = "
                  f"{eng_d.S / (td_ms * 1e-3):,.0f} frames/s", flush=True)
    secs["times_df"] = time.perf_counter() - t0

    # 19. graph: each slice path's graph tick against its eager tick ------
    t0 = time.perf_counter()
    from waveform_tpu_torch.runtime import profiler
    from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
    from waveform_tpu_torch.runtime.serving import link_rtt
    df_env = {"WAVEFORM_TPU_KERNEL_TWIDDLE": "df"}
    large = dict(fft_size=65536, enable_large_fft=True)
    for cell in (("slice", dict(fft_size=4096), 2, {}, S, "launches_gen"),
                 ("slice3", large, 2, {}, S3, "launches3"),
                 ("slice_df", dict(fft_size=4096), 2, df_env, S,
                  "launches_gen_df"),
                 ("slice3_df", large, 2, df_env, S3, "launches3_df"),
                 ("path a", dict(fft_size=4096), 2,
                  {"WAVEFORM_TPU_EXACT_FUSED": "never"}, S, "launches_cfft"),
                 ("path c", dict(auto_fft_size=True), 2, {}, S, None)):
        turns, busy, busy_us, ops, host = phase_graph(
            wt, ServingEngine, profiler, exact_cuda, rng, cell)
        g_ms, e_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        print(f"graph [{card}]: {cell[0]} S={cell[4]}: graph tick = eager "
              f"tick bit for bit (8 ticks, pixels and state); tick "
              f"(feed_batch + tick) eager {turns[0] * 1e3:.1f} / "
              f"{turns[3] * 1e3:.1f} us, graph {turns[1] * 1e3:.1f} / "
              f"{turns[2] * 1e3:.1f} us (in turns, {e_ms / g_ms:.2f}x); "
              f"device busy {busy_us[1]:.1f} us a tick eager, "
              f"{busy_us[0]:.1f} us graph: {busy[1] * 100:.1f}% / "
              f"{busy[0] * 100:.1f}% of the profiled ticks, "
              f"{busy_us[1] / (e_ms * 10):.1f}% / "
              f"{busy_us[0] / (g_ms * 10):.1f}% of the unprofiled ones; "
              f"device ops a tick {ops[1]:.1f} eager, {ops[0]:.1f} graph; "
              f"kernels a replay {cell[5] or 'none'} "
              f"{1 if cell[5] else 0} (capture and profiler agree); graph "
              f"tick host pieces (median of 60, synchronized): "
              + ", ".join(f"{k} {v:.1f} us" for k, v in host[2].items())
              + f"; FrameProfiler p50 {host[0]:.3f} ms, p99 {host[1]:.3f} ms",
              flush=True)
    secs["graph"] = time.perf_counter() - t0

    # 20. microbatch: k=4 flushes at the headline ---------------------------
    t0 = time.perf_counter()
    one = ServingEngine(cfg, S, device="cuda")
    mb = ServingEngine(cfg, S, microbatch=4, device="cuda")
    now = time.monotonic_ns()
    singles = []
    for k, x in enumerate(packets):
        now += 16_666_667
        for e in (one, mb):
            e.feed_batch(x, now, now_ns=now)
        singles.append(one.tick(now_ns=now))
        mb.tick(now_ns=now)
        if k % 4 == 3:
            check(all(same_bits(mb.last_batch_pixels[i], singles[k - 3 + i])
                      for i in range(4)),
                  "microbatch: flush vs single ticks not bit for bit")
    check(mb.kernels_per_replay[("mb", 4, True)] == {"launches_gen": 4},
          f"microbatch: kernels a flush {mb.kernels_per_replay}")
    clock = [now, 0]

    def mb_ticks(eng, n):
        def run():
            for _ in range(n):
                clock[0] += 16_666_667
                clock[1] += 1
                eng.feed_batch(packets[clock[1] % ticks], clock[0],
                               now_ns=clock[0])
                eng.tick(now_ns=clock[0])
        return run

    mb_t = [cuda_median_ms(f, reps=10, warmup=2) / 4
            for f in (mb_ticks(one, 4), mb_ticks(mb, 4), mb_ticks(mb, 4),
                      mb_ticks(one, 4))]
    auto = ServingEngine(cfg, S, microbatch="auto", device="cuda")
    for k in range(64):
        if not auto._mb_auto and auto._mb_fill == 0:
            break
        clock[0] += 16_666_667
        auto.feed_batch(packets[k % ticks], clock[0], now_ns=clock[0])
        auto.tick(now_ns=clock[0])
    check(not auto._mb_auto, "microbatch: auto did not resolve")
    secs["microbatch"] = time.perf_counter() - t0
    print(f"microbatch [{card}]: k=4 S={S} N=4096: each flush = 4 single "
          f"ticks bit for bit, 4 K1-gen launches a flush replay; a frame "
          f"(feed_batch + tick, 4-tick groups) k=1 {mb_t[0] * 1e3:.1f} / "
          f"{mb_t[3] * 1e3:.1f} us, k=4 {mb_t[1] * 1e3:.1f} / "
          f"{mb_t[2] * 1e3:.1f} us (in turns); \"auto\" picks k="
          f"{auto.microbatch} (probe tick {auto._probe_tick * 1e3:.3f} ms, "
          f"link_rtt {link_rtt(dev) * 1e3:.3f} ms)", flush=True)
    del one, mb, auto

    # 21. tick_many: T=8 bulk ticks at the headline ----------------------
    t0 = time.perf_counter()
    T = 8
    bulk_in = np.stack(packets[:T])                    # [T, S, 2, HOP]
    bulk = ServingEngine(cfg, S, device="cuda")
    cpu_b = ServingEngine(cfg, 4, device="cpu")
    rows = [0, 1, 2, S - 1]
    for name in COUNTERS:
        setattr(exact_cuda, name, 0)
    pxs = bulk.tick_many(bulk_in)
    torch.cuda.synchronize()
    counts_b = tuple(getattr(exact_cuda, name) for name in COUNTERS)
    check(counts_b == only("launches_gen", T),
          f"tick_many: launches {counts_b}")
    px_cpu = cpu_b.tick_many(bulk_in[:, rows]).numpy()
    px_b = pxs.cpu().numpy()[:, rows]
    vis = px_cpu > -120.0
    e_b = float(np.abs(px_b[vis] - px_cpu[vis]).max())
    check(pxs.shape == (T, S, 1, 800) and np.isfinite(px_b).all()
          and e_b < 1e-4, f"tick_many: card vs CPU port {e_b} dB")
    check(np.array_equal(bulk.last_silent[rows], cpu_b.last_silent),
          "tick_many: latches")
    tm_ms = cuda_median_ms(lambda: bulk.tick_many(bulk_in), reps=5,
                           warmup=1) / T
    secs["tick_many"] = time.perf_counter() - t0
    print(f"tick_many [{card}]: T={T} S={S} N=4096: {T} K1-gen launches "
          f"(warm-up, capture, {T - 1} replays), pixels {tuple(pxs.shape)}, "
          f"card vs CPU port (4 streams) {e_b:.2e} dB; {tm_ms * 1e3:.1f} us "
          f"a tick (upload included)", flush=True)
    del bulk, cpu_b

    # 22. meter: MeterServingEngine at S=256 --------------------------------
    t0 = time.perf_counter()
    mcfg = wt.resolve(wt.Settings(display_mode=wt.DisplayMode.METER),
                      wt.AudioInfo(SR, 2))
    mg = MeterServingEngine(mcfg, S, device="cuda")
    me = MeterServingEngine(mcfg, S, device="cuda")
    mc = MeterServingEngine(mcfg, 4, device="cpu")
    now = time.monotonic_ns()
    for x in packets:
        now += 16_666_667
        for e in (mg, me):
            e.feed_batch(x, now, now_ns=now)
        mc.feed_batch(x[rows], now, now_ns=now)
        check(same_bits(mg.tick(now_ns=now), eager_tick(me, now)),
              "meter: graph tick vs eager tick not bit for bit")
        mc.tick(now_ns=now)
    got_m = mg.meter_values.cpu().numpy()
    want_m = mc.meter_values.numpy()
    e_m = float(np.abs(got_m[rows[:-1]] - want_m[:-1]).max())
    check(e_m < 1e-4 and (got_m[-1] == np.float32(wt.DB_MIN)).all()
          and np.array_equal(mg.last_silent[rows], mc.last_silent),
          f"meter: card vs CPU port {e_m} dB")
    check(mg.kernels_per_replay == {("tick", True): {}}, "meter replays")
    clock = [now, 0]
    m_ms = cuda_median_ms(mb_ticks(mg, 1), reps=20, warmup=3)
    secs["meter"] = time.perf_counter() - t0
    print(f"meter [{card}]: S={S} M={mcfg.fft_size}: graph tick = eager "
          f"tick bit for bit ({ticks} ticks), card vs CPU port (4 streams) "
          f"{e_m:.2e} dB, silent stream at DB_MIN; tick (feed_batch + tick) "
          f"{m_ms * 1e3:.1f} us", flush=True)
    del mg, me, mc

    # 23. checkpoint: save on the card, load into a CPU port engine -------
    t0 = time.perf_counter()
    import tempfile
    card_e = ServingEngine(cfg, S, device="cuda")
    now = time.monotonic_ns()
    for x in packets:
        now += 16_666_667
        card_e.feed_batch(x, now, now_ns=now)
        card_e.tick(now_ns=now)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        card_e.save_state(path)
        resumed = ServingEngine(cfg, S, device="cuda")
        cpu_r = ServingEngine(cfg, 4, device="cpu")
        resumed.load_state(path)
        cpu_r.load_state(path, keep=rows)
    check(np.array_equal(cpu_r.read_decibels(), card_e.read_decibels()[rows])
          and np.array_equal(resumed.read_decibels(), card_e.read_decibels()),
          "checkpoint: loaded state differs")
    for x in packets[:3]:
        now += 16_666_667
        resumed.feed_batch(x, now, now_ns=now)
        cpu_r.feed_batch(x[rows], now, now_ns=now)
        resumed.tick(now_ns=now)
        cpu_r.tick(now_ns=now)
    db_r, db_c = resumed.read_decibels()[rows], cpu_r.read_decibels()
    vis = db_c > -120.0
    e_r = float(np.abs(db_r[vis] - db_c[vis]).max())
    check(e_r < 1e-4 and np.array_equal(resumed.last_silent[rows],
                                        cpu_r.last_silent),
          f"checkpoint: card vs CPU after resume {e_r} dB")
    secs["checkpoint"] = time.perf_counter() - t0
    print(f"checkpoint: S={S} N=4096 saved on the card, loaded into a card "
          f"engine and (keep={rows}) a CPU port engine bit for bit, 3 ticks "
          f"on: card vs CPU {e_r:.2e} dB", flush=True)
    del card_e, resumed, cpu_r

    jax_mods =[m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "waveform_tpu")]
    check(not jax_mods, f"the JAX package or jax was imported: {jax_mods}")
    print("seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()),
          flush=True)
    records = []
    # the df kernels are the df instances of exact_mag_gen.cu and
    # exact_mag3.cu: the f32 sources' MACs and bytes bound them
    for name, source, line, n, s_n, count, row in (
            ("exact_mag", "exact_mag_gen", 525, 4096, S, launches,
             (k_ms, p_ms, max_abs, libs["exact_mag"])),
            ("exact_mag3", "exact_mag3", 825, 65536, 32, launches3,
             (*mag3_row, libs["exact_mag3"])),
            ("exact_cfft", "exact_cfft", 479, 4096, S, launches_c,
             (*cfft_row, libs["exact_cfft"])),
            ("exact_mag_gen", "exact_mag_gen", 525, 6144, S, launches_gen,
             gen[6144]),
            ("exact_mag_df", "exact_mag_gen", 525, 4096, S,
             df_slices[4096][3][COUNTERS.index("launches_gen_df")],
             df_rows[4096]),
            ("exact_mag3_df", "exact_mag3", 825, 65536, 32,
             df_slices[65536][3][COUNTERS.index("launches3_df")],
             df_rows[65536])):
        b_ms, b_by = bound(source, n, s_n)
        lib = row[3]
        records.append({
            "name": name, "route": "cuda",
            "source": f"waveform_tpu_torch/csrc/{source}.cu",
            "replaces": f"waveform_tpu/kernels/exact_pallas.py:{line}",
            "launches": count, "max_abs_err": row[2], "ms": row[0],
            "plain_ms": row[1], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib})
        print(f"bound: {name} at (N, S) = ({n}, {s_n}): kernel "
              f"{row[0] * 1e3:.1f} us, twin {row[1] * 1e3:.1f} us, library "
              f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by})",
              flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
