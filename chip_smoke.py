"""Drive the PyTorch port's spectrum serving paths once on an NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

or with ``tail``, ``ring`` or ``rebin`` to run phases 1, 2 and 35, 36 or
37 alone (``python3 chip_smoke.py tail``).

Phases, one line each; any failure raises and the script exits non-zero:

1. device  — a CUDA device of compute capability 9.0; prints its name and
   power limit as nvidia-smi reports them;
2. build   — the exact FFT kernels and the spectrum tail's pair compiled
   from ``waveform_tpu_torch/csrc`` with nvcc (one process per source);
   prints ptxas's entry function and register lines as nvcc gives them
   (no spills allowed), and each kernel's IMMA / IGMMA / IDP.4A counts
   from its SASS: all 14 FFT kernels (stage 1 and stage 2 of K2, K2-df,
   K1-gen, K1-df and K3, the pair kernels' stage 1 with and without the
   rows' heads) must run on the int8 tensor cores (IMMA or IGMMA, no
   IDP.4A), beside the tail's 4 (two kernels, two widths), the ring's
   push and the rebin's 4 (the interp at 1, 4 and 8 taps, the filter);
3. kernel  — K1-gen through the router (K1's body at K1's sizes) bit for
   bit against its plain PyTorch twin (NaN lanes by position) and against
   float64 numpy at N in {1024, 2048, 4096}, S in {1, 7, 256}, Hann df32
   window and none, with a silent stream, a silent channel, a 1e20 stream
   and a NaN stream;
4. slice   — ``ServingEngine`` at the headline configuration (stereo 48 kHz,
   N=4096, Hann, 800-px Lanczos rebin, S=256) fed a 440 Hz tone plus noise
   for 8 ticks: one K1-gen launch and one ring push per tick and no
   other kernel, finite pixels, a silent stream at exactly DB_MIN, agreement with the CPU port
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
   window: one K2 launch and one ring push per tick and no other kernel
   (the launch table read after the run), finite pixels, the
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
   and one ring push per tick and no other kernel, with the checks of
   phase 4; then
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
   bit, both ticked on within 1e-4 dB;
24. waveform — ``DeviceWaveformEngine`` (torch ops, no exact kernel) at
   the JAX bench's waveform configuration (W=800, 150 ms window, S=256)
   with per-stream packets (a stream lagging 50 ms, a silent one): the
   graph tick bit for bit with the eager tick over 16 ticks (display,
   latch, ring), the CPU port on 4 of the streams within 1e-4 dB (DB_MIN
   and latch exact), k=8 microbatch flushes bit for bit with single
   ticks; eager and graph ticks in turns, device busy and ops a tick,
   p50/p99 and the host pieces, a frame at k=8 against k=1, the k
   ``"auto"`` picks; then the same at W=3840 with volume normalization
   (the RMS ring), with the RMS window and the per-stream ring push each
   timed in turns with its other form on the device clock;
25. engine — ``WaveformEngine`` (S host ``StreamSource``s, one device
   step): spectrum mode at the headline, 8 ticks, one K1-gen launch a
   tick and no other kernel, the silent stream latched at DB_MIN, the
   accuracy gate against the float64 oracle, the tick time; meter and
   waveform modes at S=256 against the CPU port;
26. multi — ``MultiEngine``: a scene of 304 streams, 16 a group — 16
   spectrum looks at N=4096 (the JAX 16-group test's pattern), a meter,
   two waveform looks at W=800 — in two upload cohorts, 30 ticks of
   per-stream noise and tone: 16 K1-gen launches a tick and no other
   kernel, every group bit for bit with its standalone card engine, two
   groups against the CPU port's scene, one group through the float64
   oracle gate; one host-to-device copy a cohort a tick (the profiler);
   ``render_frames`` of all 304 (time, peak memory, against the CPU
   port's frames); the scene tick against the same groups ticked solo,
   in turns; device busy share, p50/p99 over 60 synchronized ticks and
   the host pieces; live ``add_stream``, ``remove_stream`` and
   ``update_stream``, each recapturing only the edited groups with every
   other stream's values carried bit for bit; device memory over 20
   add/remove cycles;
27. bus — ``OutputBus``: one stereo bus, 500 consumers over 12 looks (8
   spectrum, 2 meters, 2 waveforms), 24 ticks: 8 K1-gen launches a tick,
   each spectrum look within 1e-3 dB of a standalone card
   ``ServingEngine(cfg, 1)``, every look against the CPU port's bus, one
   upload a tick; the tick's time, busy share and p50/p99; a frame of
   each mode; then a live N=65536 subscriber: the grown ring's tail is
   the old ring, every look's state carried bit for bit, 8 K1-gen + 1 K2
   launches a tick;
28. plans  — the plan tuner (``utils/plans.measure``) at N = 4096, 16384
   and 32768, S=64, 3 reps, into a temporary plan file: each entry names a
   body its size runs, faster than the digit lowering; the packaged H100
   table (``data/plans_h100.json``) read on this card; a ``ServingEngine``
   at N=16384, S=64 with no plan variable set launching the body the table
   names once a tick and no other kernel, then under a plan file naming
   the other body, each with the checks of phase 4 and the oracle gate,
   and the two engines' ticks in turns;
29. matmul — the headline configuration under
   WAVEFORM_TPU_FFT_BACKEND=matmul, 8 ticks: no exact kernel launched,
   graph ticks bit for bit with eager ticks, the CPU port on 4 streams
   within 1e-3 dB, the float64 oracle's max |dB err| printed (not gated:
   the f32 GEMM FFT), its tick in turns with the exact backend's;
30. rfft_fn — ``ServingEngine(cfg, 256, rfft_fn=torch.fft.rfft)`` at the
   headline: captured in the graph, bit for bit with its eager ticks, no
   exact kernel, its oracle error within the xla backend's; then
   ``WaveformEngine`` with the same function against the CPU port;
31. demo   — ``waveform_tpu_torch.demo.main`` on a 2-s stereo WAV for a
   curve scene at N=4096, a level meter and a waveform, on the card (one
   K1-gen launch a spectrum tick, none otherwise) and with ``--device
   cpu``: the same PNGs, within one step of 255; the profiler's line;
32. warm   — a new S=256 headline engine's first tick in a fresh process,
   first without warming, then after ``wisdom.warm``.
33. parallel — the sharded engines (``waveform_tpu_torch.parallel``) over
   a 4-entry mesh (the real devices when there are 4, else cuda:0
   repeated), each against its single engine on the same packets within
   1e-4 dB (max |d| and bit for bit printed): ``ShardedServingEngine`` at
   the headline, S=256, on 4x1 and 2x2 for 8 ticks (one K1-gen launch an
   entry a replay, no other kernel); N=65536 S=32 on 4x1 (4 K2 launches a
   tick); under EXACT_FUSED=never one K3 launch an entry a replay (each
   entry's packed pair on K3, as the single engine's); 250 streams padded
   to 252 (trimmed reads, inert pad rows); the meter (2x2) and waveform
   (W=800, 4x1) families, a microbatch=2 flush and ``tick_many`` T=4; a
   resize from 2x2 to 4x1 keeping rows [3, 1, 4] (dB bit for bit) and the
   device memory the program requests over 10 round trips (within 1 MiB);
   two gloo processes on one card, 2 entries each, each fed only its
   rows, the tiles reassembled against the single engine, then a
   collective ``save_state`` that a ``ServingEngine`` loads and
   ``load_state(keep=[5, 0, 3])`` on 6 streams with a live tick; the
   sharded and single ticks in turns (host clock, synchronized, medians
   of 20); and the dry run (``waveform_tpu_torch.dryrun``) over 4
   entries;
34. bench  — ``waveform_tpu_torch.bench.main`` at its defaults (S=256,
   N=4096, scan 128, reps 10, the sweep 1024, 16384, 32768, 65536) in
   this process: it must return 0 with the headline JSON line, its
   accuracy gate under 1e-4 dB, no roofline share over 100%, and each
   timed dispatch's ticks one launch each of the size's kernel and of no
   other (K1-gen at 1024 and 4096, K2 at 16384-65536, the packaged H100
   plan's choice); prints the bench's lines;
35. tail   — the spectrum tail's kernel pair (``kernels/tail_cuda.py``) at
   (65536, 32) and (4096, 256), mono with 2 channels: bit for bit against
   its plain version ``spectrum_tail_ref`` over 4 ticks, with every channel
   voiced and with one silent (the gate's scan); the pair, the gate alone
   and the fused tail alone beside the plain version, each captured in a
   CUDA graph, on the device's clock, and beside their byte bound;
36. ring   — the rotating ring's push (``kernels/ring_cuda.py``) at the
   benchmark's (S, C, L, H) = (32, 2, 65536, 1616), its count a host int,
   a 0-d and an [S] float32 tensor on the card (the upload's own form):
   24 pushes each (counts 0, 1, H, H + 5, 1024 and 800; per stream from
   -3 to H + 7; random heads, so rows wrap), buffer and heads bit for
   bit against ``ring_push_ref`` on the same inputs, one launch a push;
   the push captured in a CUDA graph beside the plain version and the
   shifting ring's push on the device's clock and beside its byte
   bound; and K2 at (65536, 32) and K1-gen at (4096, 256) with the rows'
   heads and without, on the device's clock;
37. rebin  — the rebin's pair (``kernels/rebin_cuda.py``) at the two
   benchmark looks, (S, D, bins) = (256, 2, 8192) -> 800 px through 8
   Lanczos taps with the Gaussian filter and (32, 1, 32768) -> 800 through
   4 Catmull-Rom taps (a channel slice of the state, as the tick hands it
   over): the interp within its T-term float32 bound of float64 and
   against its plain version, the filter bit for bit against its plain
   version, each checked after a synchronize; their times in a CUDA
   graph on the device's clock beside the plain versions', the dense
   product (``library_ms``) and the byte bounds (each bin a row's taps
   touch read once); the studio look's whole rebin, make_rebin_fn's
   kernels against its two plain forms (dense product or gather, then the
   plain filter) built from the plain functions.

Phases 13-15 and 16's K1-df sizes, 18's (16384, 256) and 27's 8192 and
16384 looks test K1-gen (K1-df) at sizes the packaged H100 plan table
sends to K2: they pin split 2 (``WAVEFORM_TPU_STAGE1_SPLIT``; for the bus,
a plan file, since its N=65536 look runs K2).

Every phase's seconds are printed before the kernels' JSON record and the
result line, which are the last two lines.  Each kernel's record carries
its time, its plain twin's, the library call's (timed here, never called
by the port) and its bound: the larger of its int8 operations at the
card's peak and the bytes it must move (inputs read once, outputs written
once) at its memory rate.  The record named ``exact_mag`` (the TPU body
at N1 in {8, 16, 32}) carries K1-gen's numbers at (4096, 256) and the
``slice`` phase's launches: K1-gen serves those sizes.  Each record's
``launches_parallel`` is its kernel's launches in the ``parallel``
phase's meshes (K1-gen's at 4x1 and 2x2 under ``exact_mag``).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from waveform_tpu_torch.kernels import cuda_lib
from waveform_tpu_torch.kernels.cuda_lib import LAUNCHES

SR, HOP = 48000, 800
TOL = 2.5e-7          # kernel bound of the JAX package's tests
TOL_SPLITS = 3e-7     # K2 vs K1's body (tests/test_exact_pallas.py:217-229)
SEED = 0
K1_SIZES = (1024, 2048, 4096)   # N1 = 8, 16, 32: K1's sizes, now K1-gen's
# the library's FFT kernels, all on the int8 tensor cores: stage 1 and
# stage 2 of exact_mag3.cu and exact_mag_gen.cu at both tiers (stage 1 in
# two instances, reading the rows in order or at a rotating ring's heads)
# and of exact_cfft.cu; the spectrum tail's (spectrum_tail.cu: the gate
# and the fused tail, each for 16-byte vectors and single floats); the
# rotating ring's push (ring_push.cu); and the rebin's (rebin.cu: the
# interp at 1, 4 and 8 taps, the Gaussian filter)
KERNELS = 14
TAIL_KERNELS = 4
RING_KERNELS = 1
REBIN_KERNELS = 4
# the tail's launches a spectrum step, by its name in the launch table
TAIL = {"tail": 2}
# the rebin's launches in an unfiltered look: the interp kernel
REBIN = {"rebin": 1}
# the pair kernels, which read a rotating sample ring in place: a
# spectrum engine whose step runs one pushes with one "ring" launch a tick
PAIR_KERNELS = ("K1-gen", "K1-df", "K2", "K2-df")


def replay_launches(counter: str | None, ticks: int = 1) -> dict:
    """The launches a replay of ``ticks`` spectrum ticks of an unfiltered
    look makes where its FFT is ``counter`` (None: no exact kernel): one
    of it, the tail's two, the rebin's interp and, where ``counter`` is a
    pair kernel, the rotating ring's push."""
    want = served_launches(counter, ticks) if counter else {}
    return {**want, **{k: n * ticks for k, n in {**TAIL, **REBIN}.items()}}


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


def phase_kernel(dev, kernel, twin, counter: str, sizes, streams,
                 seed: int, versus=None, bitwise: bool = False):
    """``kernel`` vs ``twin`` vs float64 over the size/stream/window
    matrix: each call adds one to ``LAUNCHES[counter]``, agrees with
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
                before = LAUNCHES[counter]
                mag, nz = kernel(xd, win)
                torch.cuda.synchronize()
                check(LAUNCHES[counter] == before + 1,
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
        counter = "K2-df" if split == 3 else "K1-df"
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
                    before = fft_launches()
                    with env("WAVEFORM_TPU_KERNEL_TWIDDLE", tier):
                        mag, nz = (exact_cuda.rfft_pair_mag3(xd, win, tier)
                                   if entry == "k2" else
                                   exact_cuda.rfft_pair_mag(xd, win))
                    torch.cuda.synchronize()
                    after = fft_launches()
                    moved = [c for c in after if after[c] != before.get(c)]
                    if tier == "df":
                        check(moved == [counter] and after[counter]
                              == before.get(counter, 0) + 1,
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


SPLITS = {"exact_mag_gen": 2, "exact_mag3": 3, "exact_cfft": "cfft"}


def work(name: str, n: int, S: int) -> tuple[float, float]:
    """(int8 operations, bytes) of one call of kernel source ``name`` on S
    streams of size n: ``exact_cuda.kernel_cost`` of its body (the df
    instances run the same digit GEMMs)."""
    from waveform_tpu_torch.kernels import exact_cuda
    c = exact_cuda.kernel_cost(n, S, SPLITS[name], "f32")
    return c["int8_ops"], c["hbm_bytes"]


def bound(name: str, n: int, S: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of one call of kernel source ``name`` on S
    streams of size n (``exact_cuda.kernel_bound``)."""
    from waveform_tpu_torch.kernels import exact_cuda
    s, by = exact_cuda.kernel_bound(n, S, SPLITS[name], "f32")
    return s * 1e3, by


def rate_line(name: str, ms: float, n: int, S: int) -> str:
    """A kernel time as its int8 rate and its share of the bound."""
    from waveform_tpu_torch.kernels.exact_cuda import INT8_PEAK_OPS
    b_ms, b_by = bound(name, n, S)
    rate = work(name, n, S)[0] / (ms * 1e-3)
    return (f"{rate / 1e12:.1f} TOP/s ({rate / INT8_PEAK_OPS * 100:.1f}% of "
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
    lib = cuda_lib.build()
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
    ptrs.insert(1, None)                  # no head: the rows in order

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
    mono input).  Each call adds one to ``LAUNCHES["K3"]``,
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
            before = LAUNCHES["K3"]
            z = exact_cuda.cfft_exact_kernel(re, im)
            torch.cuda.synchronize()
            check(LAUNCHES["K3"] == before + 1, f"K3 N={n} S={S} {kind}")
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


def oracle_err(wt, ServingEngine, fft_size: int, ticks: int, rng, now0,
               channels: int = 2, **engine_kw) -> float:
    """The bench's accuracy measure: TSmoothing NONE, one noise window in
    the ring against the float64 oracle, max |dB err| on bins above -120
    dBFS (``engine_kw`` go to the engine, e.g. an ``rfft_fn``)."""
    gcfg = wt.resolve(wt.Settings(fft_size=fft_size,
                                  enable_large_fft=fft_size > 8192,
                                  width=800, window=wt.FFTWindow.HANN,
                                  temporal_smoothing=wt.TSmoothingMode.NONE),
                      wt.AudioInfo(SR, channels))
    geng = ServingEngine(gcfg, 2, device="cuda", **engine_kw)
    for k in range(ticks):
        now = now0 + k * 16_666_667
        geng.feed_batch(rng.uniform(-0.5, 0.5, (2, channels, HOP)).astype(
            np.float32), now, now_ns=now)
        geng.tick(now_ns=now)
    window = geng.ring.buf[0].cpu().numpy().astype(np.float64)
    want, _ = wt.oracle.spectrum_frame(window, None, gcfg, dt=1 / 60)
    got = geng.read_decibels()[0]
    gvis = want > -120.0
    return float(np.abs(got[gvis] - want[gvis]).max())


def oracle_gate(wt, ServingEngine, fft_size: int, ticks: int, rng, now0,
                channels: int = 2):
    """The bench's accuracy gate: :func:`oracle_err` under 1e-4 dB."""
    gate = oracle_err(wt, ServingEngine, fft_size, ticks, rng, now0,
                      channels)
    check(gate < 1e-4, f"N={fft_size} accuracy gate {gate} dB")
    return gate


def drive_slice(wt, eng, cpu, packets, now0):
    """Feed ``packets`` through the card engine (counts set to 0 just
    before, read just after) and, for its first streams and the silent
    last one, through the CPU port; check pixels, silence, the tone's peak
    and card vs CPU.  Returns (the launch counts (:func:`fft_launches`),
    pixel shape, peak Hz, card-vs-CPU dB)."""
    LAUNCHES.clear()
    for k, x in enumerate(packets):
        now = now0 + k * 16_666_667
        eng.feed_batch(x, now, now_ns=now)
        eng.tick(now_ns=now)
    torch.cuda.synchronize()
    counts = fft_launches()
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


def fft_launches() -> dict:
    """The launches in the launch table (``cuda_lib.LAUNCHES``) of the
    exact FFT kernels and the rotating ring's push, by kernel name: the
    tail's pair, the rebin's kernels and zero counts left out."""
    return {k: n for k, n in LAUNCHES.items()
            if n and k not in ("tail", "rebin")}


def only(counter: str, count: int) -> dict:
    """The launch counts (:func:`fft_launches`) of a run that launched the
    kernel ``counter`` ``count`` times and no other kernel."""
    return {counter: count} if count else {}


def served_launches(counter: str, ticks: int) -> dict:
    """The launch counts (:func:`fft_launches`) of ``ticks`` spectrum
    engine ticks whose FFT is ``counter``: one of it a tick and, where it
    is a pair kernel (the engine's ring rotates), one ring push."""
    want = only(counter, ticks)
    if want and counter in PAIR_KERNELS:
        want["ring"] = ticks
    return want


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
    lib = cuda_lib.build()
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
    (``STAGED``; the df tier adds none), or at K3's [S, n] (``body``
    "K3"): ``exact_cuda.kernel_cost``'s ``stage_ops``."""
    from waveform_tpu_torch.kernels import exact_cuda
    split = {"K2": 3, "K3": "cfft"}.get(body, 2)
    return exact_cuda.kernel_cost(n, S, split, "f32")["stage_ops"]


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
    from waveform_tpu_torch.runtime.serving import upload
    eng._flip ^= 1
    eng._bind_buf(eng._flip)
    uniform = eng._stage(now, 1.0 / eng.cfg.fps)
    upload(eng._host[eng._flip], eng._dev_in, eng._events, eng._flip)
    return eng._graph_fn(("tick", uniform))()


# the stage-1 kernel of each launch counter's wrapper (one a launch), and
# whether it is the df instance (its first template argument true)
STAGE1 = {"K1-gen": ("exact_mag_gen_stage1", False),
          "K1-df": ("exact_mag_gen_stage1", True),
          "K2": ("exact_mag3_stage1", False),
          "K2-df": ("exact_mag3_stage1", True),
          "K3": ("exact_cfft_stage1", None),
          # the spectrum tail: both of its kernels, as its counter counts
          "tail": ("spectrum_tail_", None),
          # the rotating ring's push
          "ring": ("ring_push", None),
          # the rebin: the interp, and the filter where the look filters
          "rebin": ("rebin_", None)}


def profiled(profiler, one_tick, n: int = 5):
    """``n`` ticks under ``profiler.trace``: (device summary, device ops a
    tick, {counter: our kernels a tick}: each FFT kernel's stage 1, the
    tail's two) read from the trace's device kernels by name."""
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
                if stem in name and (df is None or ("<true" in name) == df))
        if k:
            ours[counter] = k / n
    ops = sum(c for c, _ in summ["kernels"].values()) / n
    return summ, ops, ours


def phase_graph(wt, ServingEngine, profiler, rng, cell):
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
        want = replay_launches(counter)
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
        # a trace can lose a tick's records (h2d_copies) and never shows a
        # kernel the device did not run: up to three traces, the first
        # that shows the launch table's counts ending the search
        for _ in range(3):
            before = LAUNCHES.copy()
            g_sum, g_ops, g_ours = profiled(profiler, g_tick)
            moved = {c: n / 5 for c, n in (LAUNCHES - before).items()}
            if g_ours == moved:
                break
        check(g_ours == want and moved == want,
              f"graph {label}: profiled kernels a replay {g_ours}, counters "
              f"{moved}, want {want}")
        for _ in range(3):
            before = LAUNCHES.copy()
            e_sum, e_ops, e_ours = profiled(profiler, e_tick)
            if e_ours == {c: n / 5 for c, n in (LAUNCHES - before).items()}:
                break
        check(e_ours == want, f"graph {label}: eager kernels {e_ours}")
        host = host_split(profiler, graph, g_tick)
    return (turns, (g_sum["busy_share"], e_sum["busy_share"]),
            (g_sum["busy_us"] / 5, e_sum["busy_us"] / 5), (g_ops, e_ops),
            host)


# the engine methods a graph tick's host time is split over (HOST_PIECES
# order; "upload" is runtime/serving.py's function), besides the rest of
# tick() and the wait for the device after it
HOST_PIECES = ("feed_batch", "_bind_buf", "_stage", "upload", "_call",
               "_fresh")


def host_split(profiler, eng, one_tick, n: int = 60):
    """``n`` ticks of ``one_tick`` (feed_batch + tick of ``eng``), each
    ended by a synchronize, on the host clock: the FrameProfiler's p50 and
    p99 (ms) and {piece: median µs} of the tick's host pieces — each method
    of ``HOST_PIECES`` (``_call`` is the replay's enqueue), the rest of
    ``tick`` and the wait for the device after ``tick`` returned."""
    from waveform_tpu_torch.runtime import serving
    owner = {name: serving if name == "upload" else eng
             for name in HOST_PIECES}
    plain = {name: getattr(owner[name], name) for name in HOST_PIECES}
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
        setattr(owner[name], name, timed(name, plain[name]))
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
        for name in HOST_PIECES:
            if owner[name] is eng:
                delattr(eng, name)
            else:
                setattr(owner[name], name, plain[name])
        del eng.tick
    med = {name: statistics.median(v) * 1e6 for name, v in acc.items()}
    med["rest of tick"] = statistics.median(rest) * 1e6
    med["device wait"] = statistics.median(wait) * 1e6
    st = frames.stats()
    return st["p50_ms"], st["p99_ms"], med


WF_LAG = 1                # the waveform stream whose timestamps lag 50 ms
WF_ROWS = [0, WF_LAG, 2]  # the card streams the CPU port also runs (+ last)


def wf_packets(rng, S: int, ticks: int) -> list:
    """``ticks`` packets [S, 2, HOP] of seeded noise, distinct per stream;
    the last stream silent."""
    out = []
    for _ in range(ticks):
        x = (0.3 * rng.standard_normal((S, 2, HOP))).astype(np.float32)
        x[-1] = 0.0
        out.append(x)
    return out


def wf_feed(eng, x: np.ndarray, now: int) -> None:
    """Per-stream feeds of the packet rows ``x``: the ``WF_LAG`` stream
    (the CPU engine's row 1 too) stamped 50 ms behind the clock."""
    for s in range(x.shape[0]):
        eng.feed(s, x[s], now - (50_000_000 if s == WF_LAG else 0),
                 now_ns=now)


def wf_vs_cpu(wt, card_out: np.ndarray, cpu_out: np.ndarray) -> float:
    """Max |card - CPU port| dB over the CPU rows' display, where the CPU
    reads above DB_MIN; DB_MIN itself must match exactly."""
    want = cpu_out
    got = card_out[WF_ROWS + [-1]]
    floor = want == np.float32(wt.DB_MIN)
    check(np.array_equal(got[floor], want[floor]), "waveform: DB_MIN "
          "pixels differ between the card and the CPU port")
    return float(np.abs(got[~floor] - want[~floor]).max())


def wf_eager_vs_graph(wt, DeviceWaveformEngine, cfg, S: int, pk, now: int,
                      label: str, cpu=None, mb=None):
    """A graph engine and an eager engine (and optionally a CPU port engine
    on ``WF_ROWS`` + the last stream, and a microbatch engine) fed ``pk``
    per stream: the graph tick equals the eager tick bit for bit each tick
    (display, latch, ring, RMS ring); card vs CPU within 1e-4 dB each tick,
    DB_MIN and latch exact; each microbatch flush equals its single ticks
    bit for bit.  Returns (graph, eager, worst card-vs-CPU dB, clock)."""
    graph = DeviceWaveformEngine(cfg, S, device="cuda")
    eager = DeviceWaveformEngine(cfg, S, device="cuda")
    singles, worst = [], 0.0
    for k, x in enumerate(pk):
        now += 16_666_667
        for e in (graph, eager) + ((mb,) if mb is not None else ()):
            wf_feed(e, x, now)
        out = graph.tick(now_ns=now)
        check(same_bits(out, eager_tick(eager, now)),
              f"waveform {label}: graph tick vs eager tick (tick {k})")
        states = [(graph.latch, eager.latch), (graph.ring.buf, eager.ring.buf),
                  (graph.buf, eager.buf)]
        if graph.rms_ring is not None:
            states.append((graph.rms_ring.buf, eager.rms_ring.buf))
        check(all(torch.equal(a, b) for a, b in states),
              f"waveform {label}: graph state vs eager state (tick {k})")
        if cpu is not None:
            wf_feed(cpu, x[WF_ROWS + [-1]], now)
            c_out = cpu.tick(now_ns=now).numpy()
            worst = max(worst, wf_vs_cpu(wt, out.cpu().numpy(), c_out))
            check(np.array_equal(graph.last_silent[WF_ROWS + [-1]],
                                 cpu.last_silent), "waveform: latch vs CPU")
        if mb is not None:
            singles.append(out)
            mb.tick(now_ns=now)
            if mb._mb_fill == 0:
                k0 = len(singles) - mb.microbatch
                check(all(same_bits(mb.last_batch_pixels[i], singles[k0 + i])
                          for i in range(mb.microbatch)),
                      f"waveform {label}: microbatch flush vs single ticks")
    check(worst <= 1e-4, f"waveform {label}: card vs CPU port {worst} dB")
    return graph, eager, worst, now


def wf_times(profiler, graph, eager, pk, now: int):
    """Eager and graph ticks (feed_batch + tick) in turns, medians of 20;
    5 profiled ticks of each (device busy, ops a tick; the waveform step
    launches no exact kernel); 60 synchronized graph ticks (p50/p99 and
    the host pieces)."""
    clock = [now, 0]

    def ticker(eng, run):
        def one_tick():
            clock[0] += 16_666_667
            clock[1] += 1
            eng.feed_batch(pk[clock[1] % len(pk)], clock[0], now_ns=clock[0])
            run(eng, clock[0])
        return one_tick

    g_tick = ticker(graph, lambda e, t: e.tick(now_ns=t))
    e_tick = ticker(eager, eager_tick)
    turns = [cuda_median_ms(f, reps=20, warmup=3)
             for f in (e_tick, g_tick, g_tick, e_tick)]
    g_sum, g_ops, g_ours = profiled(profiler, g_tick)
    e_sum, e_ops, e_ours = profiled(profiler, e_tick)
    check(not g_ours and not e_ours,
          f"waveform: exact kernels in the waveform tick {g_ours} {e_ours}")
    host = host_split(profiler, graph, g_tick)
    return turns, (g_sum, e_sum), (g_ops, e_ops), host, clock[0]


def top_ops(summ: dict, ticks: int = 5, n: int = 5) -> str:
    """The ``n`` device operations of a profiled window that took the most
    time, by short name (template and argument lists cut), in µs and
    launches a tick."""
    by = {}
    for name, (c, us) in summ["kernels"].items():
        name = re.sub(r"^void |at::native::|\(anonymous namespace\)::", "",
                      name)
        short = re.split(r"[<(]", name)[0].strip()
        what = [m.group(0) for pat in (r"\w+_kernel_cuda", r"\w+Functor")
                if (m := re.search(pat, name[len(short):]))]
        if "elementwise" in short and what:
            short = f"{short}<{what[0]}>"
        short = short[:60]
        k, t = by.get(short, (0, 0.0))
        by[short] = (k + c, t + us)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:n]
    return ", ".join(f"{k} {t / ticks:.1f} us x{c / ticks:.0f}"
                     for k, (c, t) in top)


def wf_line(card: str, label: str, turns, sums, ops, host) -> str:
    g_ms, e_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    g_us, e_us = sums[0]["busy_us"] / 5, sums[1]["busy_us"] / 5
    return (f"waveform [{card}]: {label}: tick (feed_batch + tick) eager "
            f"{turns[0] * 1e3:.1f} / {turns[3] * 1e3:.1f} us, graph "
            f"{turns[1] * 1e3:.1f} / {turns[2] * 1e3:.1f} us (in turns, "
            f"{e_ms / g_ms:.2f}x); device busy {e_us:.1f} us a tick eager, "
            f"{g_us:.1f} us graph: {sums[1]['busy_share'] * 100:.1f}% / "
            f"{sums[0]['busy_share'] * 100:.1f}% of the profiled ticks, "
            f"{e_us / (e_ms * 10):.1f}% / {g_us / (g_ms * 10):.1f}% of the "
            f"unprofiled ones; device ops a tick {ops[1]:.1f} eager, "
            f"{ops[0]:.1f} graph; the graph tick's top device ops: "
            + top_ops(sums[0]) + "; graph tick host pieces (median of 60, "
            "synchronized): "
            + ", ".join(f"{k} {v:.1f} us" for k, v in host[2].items())
            + f"; FrameProfiler p50 {host[0]:.3f} ms, p99 {host[1]:.3f} ms")


def wf_index_forms(rms_window_sum, push, graph, dev) -> str:
    """The normalized engine's two per-stream row pickers on the device
    clock at its own shapes, each in turns with its other form (bit for
    bit): the RMS window sum over the RMS ring (the port's sliding-view
    pick, against the [S, size] int64-index gather), and the per-stream
    ring push into the ring (the port's [S, L] int64-index gather,
    against the sliding-view pick; both write the ring)."""
    from waveform_tpu_torch.dsp.devring import DeviceRing
    S, size = graph.S, graph.cfg.input_rms_size
    rows = graph.rms_ring.buf[:, 0].clone()
    rng = np.random.default_rng(SEED + 21)
    reserve = torch.from_numpy(rng.integers(0, graph._reserve_limit + 1, S)
                               ).to(dev)
    streams = torch.arange(S, device=dev)

    def window_index():
        Lr = rows.shape[-1]
        start = (Lr - reserve - size).clamp(0, Lr - size)
        idx = start[:, None] + torch.arange(size, device=dev)
        return rows.gather(-1, idx).sum(-1)

    check(same_bits(rms_window_sum(rows, reserve, size), window_index()),
          "waveform: RMS window forms differ")
    ring = DeviceRing(buf=graph.ring.buf.clone())
    ring2 = DeviceRing(buf=graph.ring.buf.clone())
    new = torch.randn((S, graph.C, graph.H), device=dev)
    counts = torch.from_numpy(rng.integers(0, graph.H + 1, S)).to(dev)

    def push_view():
        buf = ring2.buf
        full = torch.cat([buf, new], dim=-1)
        buf.copy_(full.unfold(-1, buf.shape[-1], 1)[streams, :, counts])

    push(ring, new, counts)
    push_view()
    check(same_bits(ring.buf, ring2.buf), "waveform: push forms differ")
    w = [cuda_median_ms(f, busy_ahead=True) for f in (
        window_index, lambda: rms_window_sum(rows, reserve, size),
        lambda: rms_window_sum(rows, reserve, size), window_index)]
    p = [cuda_median_ms(f, busy_ahead=True) for f in (
        lambda: push(ring, new, counts), push_view, push_view,
        lambda: push(ring, new, counts))]
    return (f"RMS window (S={S}, {rows.shape[-1]} squares, {size} summed) "
            f"{w[1] * 1e3:.1f} / {w[2] * 1e3:.1f} us against "
            f"{w[0] * 1e3:.1f} / {w[3] * 1e3:.1f} us for the [S, {size}] "
            f"int64-index form; per-stream ring push "
            f"({tuple(ring.buf.shape)}, the [S, L] int64-index gather) "
            f"{p[0] * 1e3:.1f} / {p[3] * 1e3:.1f} us against "
            f"{p[1] * 1e3:.1f} / {p[2] * 1e3:.1f} us for the sliding-view "
            "pick (device clock, in turns, bit for bit)")


def phase_waveform(wt, profiler, card: str, dev) -> None:
    """``DeviceWaveformEngine`` at the JAX bench's waveform configuration
    (``waveform_tpu/bench.py:382-392``: W=800, 150 ms window, S=256) and
    with volume normalization at W=3840, the widest display the config
    allows (the JAX bench's host-assembly target, ``bench.py:410-413``,
    names W=4096)."""
    from waveform_tpu_torch.dsp.devring import push
    from waveform_tpu_torch.runtime.waveform_device import (
        DeviceWaveformEngine,
        rms_window_sum,
    )
    S = 256
    rng = np.random.default_rng(SEED + 20)
    cfg = wt.resolve(wt.Settings(display_mode=wt.DisplayMode.WAVEFORM,
                                 temporal_smoothing=wt.TSmoothingMode.NONE),
                     wt.AudioInfo(SR, 2))
    pk = wf_packets(rng, S, 16)
    cpu = DeviceWaveformEngine(cfg, len(WF_ROWS) + 1, device="cpu")
    mb = DeviceWaveformEngine(cfg, S, microbatch=8, device="cuda")
    graph, eager, e_cpu, now = wf_eager_vs_graph(
        wt, DeviceWaveformEngine, cfg, S, pk, time.monotonic_ns(), "W=800",
        cpu=cpu, mb=mb)
    # the silent stream displays DB_MIN, and DB_MIN != 0 keeps its latch
    # off (the host scroller's and the reference's silence scan)
    check(not graph.last_silent[-1]
          and (graph.render_values()[-1] == np.float32(wt.DB_MIN)).all(),
          "waveform: the silent stream is not at DB_MIN")
    check(graph.kernels_per_replay == {("tick", False): {}},
          f"waveform: replays {graph.kernels_per_replay}")
    ring_mb = graph.ring.buf.numel() * 4 / 1e6
    up_mb = graph._stride * 4 / 1e6
    print(f"waveform [{card}]: W={graph.W} S={graph.S} (L={graph.L}, "
          f"H={graph.H}, waveform_samples={cfg.waveform_samples}; ring "
          f"{ring_mb:.1f} MB, upload {up_mb:.1f} MB = {graph.packed_width} "
          f"floats a row): graph tick = eager tick bit for bit over "
          f"{len(pk)} ticks (display, latch, ring); card vs CPU port "
          f"({len(WF_ROWS) + 1} streams: the 50 ms lag stream, the silent "
          f"one) {e_cpu:.2e} dB, DB_MIN and latch exact; k=8 flushes = "
          f"single ticks bit for bit", flush=True)
    turns, sums, ops, host, now = wf_times(profiler, graph, eager, pk, now)
    print(wf_line(card, f"W={graph.W} S={graph.S}", turns, sums, ops, host),
          flush=True)
    clock = [now, 0]

    def group(eng, n):
        def run():
            for _ in range(n):
                clock[0] += 16_666_667
                clock[1] += 1
                eng.feed_batch(pk[clock[1] % len(pk)], clock[0],
                               now_ns=clock[0])
                eng.tick(now_ns=clock[0])
        return run

    mb_t = [cuda_median_ms(f, reps=10, warmup=2) / 8
            for f in (group(graph, 8), group(mb, 8), group(mb, 8),
                      group(graph, 8))]
    auto = DeviceWaveformEngine(cfg, S, microbatch="auto", device="cuda")
    for k in range(64):
        if not auto._mb_auto and auto._mb_fill == 0:
            break
        clock[0] += 16_666_667
        auto.feed_batch(pk[k % len(pk)], clock[0], now_ns=clock[0])
        auto.tick(now_ns=clock[0])
    check(not auto._mb_auto, "waveform: auto did not resolve")
    print(f"waveform [{card}]: microbatch W={graph.W} S={graph.S}: a frame "
          f"(feed_batch + tick, 8-tick groups) k=1 {mb_t[0] * 1e3:.1f} / "
          f"{mb_t[3] * 1e3:.1f} us, k=8 {mb_t[1] * 1e3:.1f} / "
          f"{mb_t[2] * 1e3:.1f} us (in turns); \"auto\" picks k="
          f"{auto.microbatch} (probe tick {auto._probe_tick * 1e3:.3f} ms)",
          flush=True)
    del graph, eager, mb, auto, cpu

    # the host-assembly target's W=4096 is past the width property's range
    # (32-3840, core/properties.py): resolve clamps it to 3840
    cfg4 = wt.resolve(wt.Settings(display_mode=wt.DisplayMode.WAVEFORM,
                                  temporal_smoothing=wt.TSmoothingMode.NONE,
                                  width=3840, normalize_volume=True),
                      wt.AudioInfo(SR, 2))
    cpu4 = DeviceWaveformEngine(cfg4, len(WF_ROWS) + 1, device="cpu")
    graph, eager, e_cpu4, now = wf_eager_vs_graph(
        wt, DeviceWaveformEngine, cfg4, S, pk[:8], time.monotonic_ns(),
        "W=3840", cpu=cpu4)
    rms_mb = graph.rms_ring.buf.numel() * 4 / 1e6
    print(f"waveform [{card}]: W={graph.W} S={graph.S} normalize_volume (RMS "
          f"ring {rms_mb:.1f} MB, upload {graph._stride * 4 / 1e6:.1f} MB): "
          f"graph = eager bit for bit over 8 ticks (display, latch, ring, "
          f"RMS ring); card vs CPU port {e_cpu4:.2e} dB; "
          + wf_index_forms(rms_window_sum, push, graph, dev), flush=True)
    turns, sums, ops, host, _ = wf_times(profiler, graph, eager, pk, now)
    print(wf_line(card, f"W={graph.W} S={graph.S} normalize_volume", turns,
                  sums, ops, host), flush=True)


def phase_engine(wt, card: str) -> None:
    """``WaveformEngine`` (S ``StreamSource``s on the host, one device
    step): spectrum mode at the headline, 8 ticks, one K1-gen launch a
    tick and no other kernel, the oracle gate; meter and waveform modes
    against the CPU port."""
    from waveform_tpu_torch.runtime.engine import WaveformEngine
    S = 256
    rng = np.random.default_rng(SEED + 22)
    cfg = wt.resolve(wt.Settings(fft_size=4096, width=800,
                                 window=wt.FFTWindow.HANN,
                                 interp_mode=wt.InterpMode.LANCZOS),
                     wt.AudioInfo(SR, 2))
    eng = WaveformEngine(cfg, S, device="cuda")
    pk = [feed_signal(rng, S, k) for k in range(8)]
    now = time.monotonic_ns()
    LAUNCHES.clear()
    for x in pk:
        now += 16_666_667
        for s in range(eng.S):
            eng.feed(s, x[s], now, now_ns=now)
        db = eng.tick(now_ns=now)
    torch.cuda.synchronize()
    counts = fft_launches()
    check(counts == only("K1-gen", len(pk)),
          f"engine: spectrum launches {counts}")
    db = db.cpu().numpy()
    check(np.isfinite(db).all() and (db[-1] == np.float32(wt.DB_MIN)).all()
          and bool(eng.last_silent[-1]), "engine: the silent stream")
    px = eng.render_values()
    check(px.shape == (eng.S, 1, 800) and np.isfinite(px).all(),
          "engine: pixels")
    clock = [now]

    def one_tick(e, x):
        clock[0] += 16_666_667
        for s in range(e.S):
            e.feed(s, x[s], clock[0], now_ns=clock[0])
        e.tick(now_ns=clock[0])

    t_spec = cuda_median_ms(lambda: one_tick(eng, pk[0]), reps=5, warmup=1)

    gcfg = wt.resolve(wt.Settings(fft_size=4096, width=800,
                                  window=wt.FFTWindow.HANN,
                                  temporal_smoothing=wt.TSmoothingMode.NONE),
                      wt.AudioInfo(SR, 2))
    geng = WaveformEngine(gcfg, 2, device="cuda")
    for k in range(6):
        now += 16_666_667
        for s in range(2):
            geng.feed(s, rng.uniform(-0.5, 0.5, (2, HOP)).astype(np.float32),
                      now, now_ns=now)
        got = geng.tick(now_ns=now)[0].cpu().numpy()
    src = geng.sources[0]
    window = np.stack([r.peek_front(gcfg.fft_size) for r in src.rings]
                      ).astype(np.float64)
    want, _ = wt.oracle.spectrum_frame(window, None, gcfg, dt=1 / 60)
    vis = want > -120.0
    gate = float(np.abs(got[vis] - want[vis]).max())
    check(gate < 1e-4, f"engine: accuracy gate {gate} dB")
    print(f"engine [{card}]: spectrum N=4096 S={eng.S}: {len(pk)} ticks, "
          f"launches {counts} (one K1-gen a tick, no "
          f"other kernel), the silent stream at DB_MIN and latched, pixels "
          f"{px.shape}; oracle gate {gate:.2e} dB; tick (S feeds + tick, "
          f"median of 5) {t_spec:.2f} ms", flush=True)

    for mode in (wt.DisplayMode.METER, wt.DisplayMode.WAVEFORM):
        mcfg = wt.resolve(wt.Settings(display_mode=mode),
                          wt.AudioInfo(SR, 2))
        card_e = WaveformEngine(mcfg, S, device="cuda")
        rows = [0, 1, 2, card_e.S - 1]
        cpu_e = WaveformEngine(mcfg, len(rows), device="cpu")
        for k in range(4):
            x = pk[k]
            now += 16_666_667
            for s in range(card_e.S):
                card_e.feed(s, x[s], now, now_ns=now)
            for i, s in enumerate(rows):
                cpu_e.feed(i, x[s], now, now_ns=now)
            got = np.asarray(card_e.tick(now_ns=now).cpu()
                             if mode == wt.DisplayMode.METER
                             else card_e.tick(now_ns=now))[rows]
            want = np.asarray(cpu_e.tick(now_ns=now))
        floor = want == np.float32(wt.DB_MIN)
        err = float(np.abs(got[~floor] - want[~floor]).max())
        check(err <= 1e-4 and np.array_equal(got[floor], want[floor])
              and np.array_equal(card_e.last_silent[rows],
                                 cpu_e.last_silent),
              f"engine: {mode.value} card vs CPU port {err} dB")
        t_mode = cuda_median_ms(lambda: one_tick(card_e, pk[0]), reps=5,
                                warmup=1)
        print(f"engine [{card}]: {mode.value} S={card_e.S}: 4 ticks, card "
              f"vs CPU port ({len(rows)} streams) {err:.2e} dB, DB_MIN and "
              f"latch exact; tick (S feeds + tick, median of 5) "
              f"{t_mode:.2f} ms",
              flush=True)


# --- 26. multi and 27. bus: the scene layer -------------------------------

SCENE_S = 16          # streams a scene group
SCENE_TICKS = 30
SCENE_CPU = (0, 9)    # the spectrum groups the CPU port's scene also runs
BUS_TICKS = 24        # fills the N=16384 window (20.5 hops of 800)


def scene_cfgs(wt) -> list:
    """The scene: 16 spectrum groups at N=4096, each a distinct config
    after the JAX 16-group test's pattern (``tests/test_serving.py:
    285-318``) at the headline size — Hann or Blackman alternating, a
    Gaussian filter on groups 8-15, cutoff_high = 17000 - 100 g — one
    meter group at the default 150 ms and two waveform groups at W=800
    (meter_buf 150 and 300 ms: one packed width, one cohort); all stereo
    48 kHz, 60 fps, 800 x 225 px."""
    audio = wt.AudioInfo(SR, 2)
    cfgs = [wt.resolve(wt.Settings(
        fft_size=4096,
        window=(wt.FFTWindow.HANN, wt.FFTWindow.BLACKMAN)[g % 2],
        filter_mode=(wt.FilterMode.NONE, wt.FilterMode.GAUSS)[g // 8],
        cutoff_high=17000 - 100 * g), audio) for g in range(16)]
    cfgs.append(wt.resolve(wt.Settings(display_mode=wt.DisplayMode.METER),
                           audio))
    cfgs += [wt.resolve(wt.Settings(display_mode=wt.DisplayMode.WAVEFORM,
                                    meter_buf=ms), audio) for ms in (150, 300)]
    return cfgs


def noise_tone(rng, shape, k: int) -> np.ndarray:
    """A 440 Hz tone at 0.3 plus seeded noise at 0.3, ``shape`` [..., HOP]
    (noise-dominated, as the bench gate's input)."""
    t = (np.arange(HOP) + k * HOP) / SR
    return (0.3 * np.sin(2 * np.pi * 440.0 * t)
            + 0.3 * rng.standard_normal(shape)).astype(np.float32)


def db_vs(wt, got: np.ndarray, want: np.ndarray, what: str) -> float:
    """Max |got - want| dB on bins where ``want`` is above -120 dBFS;
    DB_MIN must match exactly."""
    floor = want == np.float32(wt.DB_MIN)
    check(got.shape == want.shape and np.array_equal(got[floor], want[floor]),
          f"{what}: DB_MIN bins differ")
    vis = want > -120.0
    return float(np.abs(got[vis] - want[vis]).max()) if vis.any() else 0.0


def engine_state(eng) -> list:
    """The device tensors a packed engine carries from tick to tick."""
    if hasattr(eng, "state"):
        st = eng.state
        return [eng.ring.buf] + [getattr(st, f) for f in vars(st)]
    return [eng.ring.buf, eng.buf, eng.latch]


def timed_methods(engines, names, acc):
    """Wrap each of ``names`` on every engine to add its host seconds to
    ``acc[name][-1]``; returns a function that takes the wrappers off."""
    def wrap(name, fn):
        def run(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            acc[name][-1] += time.perf_counter() - t
            return out
        return run

    for e in engines:
        for name in names:
            setattr(e, name, wrap(name, getattr(e, name)))
    return lambda: [delattr(e, name) for e in engines for name in names]


def h2d_copies(step, want: int, n: int = 5) -> int:
    """The host-to-device copies the device ran in ``n`` calls of
    ``step``, counted from a profiler trace's events (a copy within one of
    the trace's microseconds counts all the same).  The profiler traces
    one call first and drops it: without that warm-up the first activity
    records of a trace can be lost (one copy in five went missing so).
    A trace can still lose a record after the warm-up (one bus copy of
    five did once), and never shows a copy the device did not run: the
    count is the largest of up to three traces, the first that reaches
    ``want`` ending the search."""
    from torch.profiler import ProfilerActivity, profile, schedule
    best = -1
    for _ in range(3):
        counted = []

        def ready(prof):      # the active window's trace, as it completes
            counted.append(sum(
                1 for ev in prof.events()
                if getattr(ev, "device_type", None)
                == torch.autograd.DeviceType.CUDA and "HtoD" in ev.name))

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n),
                     on_trace_ready=ready) as prof:
            for _ in range(n + 1):
                step()
                torch.cuda.synchronize()
                prof.step()
        check(len(counted) == 1, f"the profiler gave {len(counted)} traces")
        best = max(best, counted[0])
        if best >= want:
            break
    return best


def graphs_of(scene) -> dict:
    """{cfg: (engine, {tick kind: GraphTick})} of a scene."""
    return {cfg: (e, dict(e._ticks)) for cfg, e in scene._engines.items()}


def recaptured(before: dict, scene) -> list:
    """The groups whose engine or any captured tick is new since
    ``before`` (:func:`graphs_of`)."""
    out = []
    for cfg, (e, ticks) in graphs_of(scene).items():
        old = before.get(cfg)
        if old is None or old[0] is not e or any(
                old[1].get(k) is not t for k, t in ticks.items()):
            out.append(cfg)
    return out


def phase_multi(wt, profiler, card: str) -> None:
    """``MultiEngine``: the full scene of :func:`scene_cfgs`, 16 streams a
    group (304 streams, 19 groups, two upload cohorts)."""
    import gc

    from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
    from waveform_tpu_torch.runtime.multi import MultiEngine
    from waveform_tpu_torch.runtime.serving import ServingEngine
    from waveform_tpu_torch.runtime.waveform_device import (
        DeviceWaveformEngine,
    )

    def make(cfg, n):
        if cfg.spectrum_mode:
            return ServingEngine(cfg, n, device="cuda")
        if cfg.meter_mode:
            return MeterServingEngine(cfg, n, device="cuda")
        return DeviceWaveformEngine(cfg, n, device="cuda")

    cfgs, S = scene_cfgs(wt), SCENE_S
    G = len(cfgs)
    scene = MultiEngine(device="cuda")
    sids = [[scene.add_stream(c) for _ in range(S)] for c in cfgs]
    solo = [make(c, S) for c in cfgs]
    cpu = MultiEngine(device="cpu")
    cpu_ids = {(g, r): cpu.add_stream(cfgs[g]) for g in SCENE_CPU
               for r in range(2)}
    rng = np.random.default_rng(SEED + 30)
    pk = [noise_tone(rng, (G * S, 2, HOP), k) for k in range(SCENE_TICKS)]

    def feed_scene(x, now):
        for g, row in enumerate(sids):
            for r, sid in enumerate(row):
                scene.feed(sid, x[g * S + r], now, now_ns=now)

    def feed_solo(x, now):
        for g, e in enumerate(solo):
            for r in range(S):
                e.feed(r, x[g * S + r], now, now_ns=now)

    now0 = time.monotonic_ns()
    LAUNCHES.clear()
    eng0 = None
    for k, x in enumerate(pk):
        now = now0 + (k + 1) * 16_666_667
        feed_scene(x, now)
        if k == SCENE_TICKS - 1:      # the oracle gate's EMA input
            eng0 = scene._engines[cfgs[0]]
            ts_prev = eng0.state.tsmooth[0].cpu().numpy().copy()
        scene.tick(now_ns=now)
    torch.cuda.synchronize()
    counts = fft_launches()
    check(counts == served_launches("K1-gen", 16 * SCENE_TICKS),
          f"multi: launches {counts} in {SCENE_TICKS} scene ticks, want 16 "
          "K1-gen and 16 ring pushes a tick and no other kernel")
    check(len(scene._cohorts) == 2 and not scene._solo
          and [len(c["engines"]) for c in scene._cohorts] == [17, 2],
          f"multi: cohorts {[len(c['engines']) for c in scene._cohorts]}")
    window = eng0.ring.buf[0].cpu().numpy().astype(np.float64)
    want, _ = wt.oracle.spectrum_frame(window, ts_prev, cfgs[0], dt=1 / 60)
    gate = db_vs(wt, scene.read_decibels(sids[0][0]), want.astype(np.float32),
                 "multi: oracle")
    check(gate < 1e-4, f"multi: oracle gate {gate} dB")
    for k, x in enumerate(pk):
        now = now0 + (k + 1) * 16_666_667
        feed_solo(x, now)
        for e in solo:
            e.tick(now_ns=now)
        for (g, r), sid in cpu_ids.items():
            cpu.feed(sid, x[g * S + r], now, now_ns=now)
        cpu.tick(now_ns=now)
    torch.cuda.synchronize()
    for g, e in enumerate(solo):
        mine = scene._engines[cfgs[g]]
        check(all(torch.equal(a, b) for a, b in
                  zip(engine_state(mine), engine_state(e))),
              f"multi: group {g} differs from its standalone engine")
    e_cpu = max(db_vs(wt, scene.read_decibels(sids[g][r]),
                      cpu.read_decibels(sid), "multi: card vs CPU")
                for (g, r), sid in cpu_ids.items())
    check(e_cpu < 1e-4, f"multi: card vs CPU port {e_cpu} dB")
    print(f"multi [{card}]: {G} groups x {S} streams = {G * S} (16 spectrum "
          f"N=4096, 1 meter, 2 waveform W=800; cohorts of "
          f"{[len(c['engines']) for c in scene._cohorts]} groups, "
          f"{[c['used'] * 4 / 1e6 for c in scene._cohorts]} MB uploads): "
          f"{SCENE_TICKS} ticks, launches {counts} (16 "
          f"K1-gen a scene tick, no other kernel); every group = its "
          f"standalone card engine bit for bit (state, ring, latch); groups "
          f"{SCENE_CPU} vs the CPU port's scene {e_cpu:.2e} dB; oracle gate "
          f"(group 0, stream 0) {gate:.2e} dB", flush=True)

    scene.render_frames()                  # builds the 19 renderers
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames = scene.render_frames()
    t_render = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    cpu_frames = cpu.render_frames()
    e_render = max(float(np.abs(frames[sids[g][r]] - cpu_frames[sid]).max())
                   for (g, r), sid in cpu_ids.items())
    check(len(frames) == G * S
          and all(f.shape == (225, 800, 4) and np.isfinite(f).all()
                  for f in frames.values()),
          "multi: render_frames shapes or values")
    check(e_render <= 1e-5, f"multi: frames vs the CPU port {e_render}")
    print(f"multi [{card}]: render_frames of {len(frames)} streams "
          f"({len(frames) * 225 * 800 * 16 / 1e6:.0f} MB of RGBA f32): "
          f"{t_render * 1e3:.1f} ms (host clock, the copies to the host "
          f"included), peak device memory {peak / 1e6:.1f} MB above the "
          f"scene's {base / 1e6:.1f} MB; the CPU port's frames (4 streams) "
          f"within {e_render:.2e}", flush=True)
    del frames, cpu_frames

    clocks = {"scene": [now0 + 40 * 16_666_667],
              "solo": [now0 + 40 * 16_666_667]}

    def scene_tick():
        c = clocks["scene"]
        c[0] += 16_666_667
        feed_scene(pk[(c[0] // 16_666_667) % SCENE_TICKS], c[0])
        scene.tick(now_ns=c[0])

    def solo_tick():
        c = clocks["solo"]
        c[0] += 16_666_667
        feed_solo(pk[(c[0] // 16_666_667) % SCENE_TICKS], c[0])
        for e in solo:
            e.tick(now_ns=c[0])

    scene_tick()
    solo_tick()
    torch.cuda.synchronize()
    with profiler.trace() as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            scene_tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summ = profiler.device_summary(prof, wall)
    h2d = h2d_copies(scene_tick, 5 * len(scene._cohorts))
    check(h2d == 5 * len(scene._cohorts),
          f"multi: {h2d} host-to-device copies in 5 scene ticks, want one a "
          f"cohort a tick ({len(scene._cohorts)} cohorts)")
    ops = sum(c for c, _ in summ["kernels"].values()) / 5
    turns = [cuda_median_ms(f, reps=10, warmup=2)
             for f in (scene_tick, solo_tick, solo_tick, scene_tick)]
    acc = {"_stage": [], "tick_from_cohort": []}
    untime = timed_methods(list(scene._engines.values()), list(acc), acc)
    frames_p = profiler.FrameProfiler(G * S, 4096)
    feeds, ticks_h, waits = [], [], []
    try:
        for _ in range(60):
            for v in acc.values():
                v.append(0.0)
            c = clocks["scene"]
            c[0] += 16_666_667
            with frames_p.tick():
                t0 = time.perf_counter()
                feed_scene(pk[(c[0] // 16_666_667) % SCENE_TICKS], c[0])
                t1 = time.perf_counter()
                scene.tick(now_ns=c[0])
                t2 = time.perf_counter()
                torch.cuda.synchronize()
                t3 = time.perf_counter()
            feeds.append(t1 - t0)
            ticks_h.append(t2 - t1)
            waits.append(t3 - t2)
    finally:
        untime()
    st = frames_p.stats()
    med = {k: statistics.median(v) * 1e6 for k, v in (
        ("feeds", feeds), ("assembly (_stage)", acc["_stage"]),
        ("replays (tick_from_cohort)", acc["tick_from_cohort"]),
        ("tick()", ticks_h), ("device wait", waits))}
    print(f"multi [{card}]: scene tick (304 feeds + tick, CUDA events, "
          f"medians of 10, in turns) {turns[0]:.2f} / {turns[3]:.2f} ms "
          f"against the same 19 engines ticked solo (own uploads) "
          f"{turns[1]:.2f} / {turns[2]:.2f} ms; host-to-device copies a "
          f"tick {h2d / 5:.0f} (one a cohort; 5 traced ticks after a "
          f"dropped one); device busy "
          f"{summ['busy_us'] / 5:.1f} us a tick, {summ['busy_share']:.1%} "
          f"of the profiled ticks, "
          f"{summ['busy_us'] / 5 / (turns[0] + turns[3]) * 2e-3:.1%} of the "
          f"unprofiled; {ops:.0f} device ops a tick; top "
          f"{top_ops(summ)}; 60 synchronized ticks p50 {st['p50_ms']:.3f} / "
          f"p99 {st['p99_ms']:.3f} ms; host pieces (median us) "
          + ", ".join(f"{k} {v:.1f}" for k, v in med.items()), flush=True)


    edits = []
    clock = [clocks["scene"][0]]

    def tick_scene():
        clock[0] += 16_666_667
        scene.tick(now_ns=clock[0])

    tick_scene()
    for label, edit, moved in (
            ("add_stream (group 3)", lambda: scene.add_stream(cfgs[3]), None),
            ("remove_stream (group 5, row 0)",
             lambda: scene.remove_stream(sids[5][0]), sids[5][0]),
            ("update_stream (group 7 row 1 -> meter)",
             lambda: scene.update_stream(sids[7][1], cfgs[16]),
             sids[7][1])):
        before = graphs_of(scene)
        vals = {sid: scene.read_decibels(sid) for row in sids for sid in row
                if sid in scene._streams and sid != moved}
        edit()
        carried = all(np.array_equal(scene.read_decibels(sid), v)
                      for sid, v in vals.items() if sid in scene._streams)
        tick_scene()
        again = recaptured(before, scene)
        edits.append(f"{label}: {len(again)} group(s) recaptured")
        want = {"add": {cfgs[3]}, "remove": {cfgs[5]},
                "update": {cfgs[7], cfgs[16]}}[label.split("_")[0]]
        check(set(again) == want and carried,
              f"multi: {label} recaptured {len(again)} groups, carried "
              f"{carried}")
    mem = []
    for _ in range(20):
        sid = scene.add_stream(cfgs[2])
        tick_scene()
        scene.remove_stream(sid)
        tick_scene()
        torch.cuda.synchronize()
        gc.collect()
        mem.append(torch.cuda.memory_allocated())
    check(abs(mem[-1] - mem[0]) <= 1 << 20,
          f"multi: memory after 20 add/remove cycles {mem[-1]} against "
          f"{mem[0]} after the first (every cycle: {mem})")
    print(f"multi [{card}]: live edits, each the edited groups only "
          f"recaptured, every other stream's values carried bit for bit: "
          + "; ".join(edits) + f"; torch.cuda.memory_allocated after 1 / 20 "
          f"add+remove cycles (gc.collect() first) {mem[0] / 1e6:.3f} / "
          f"{mem[-1] / 1e6:.3f} MB (margin 1 MiB), max "
          f"{max(mem) / 1e6:.3f} MB", flush=True)


def bus_cfgs(wt) -> list:
    """The bus docstring's example (``waveform_tpu/runtime/bus.py:10-15``)
    as 12 distinct looks: 8 spectrum (six at N=4096 with distinct windows,
    filters and slopes, one at 8192, one at 16384), 2 meters (RMS and
    peak), 2 waveforms (W=800 and W=1920)."""
    audio = wt.AudioInfo(SR, 2)

    def r(**kw):
        return wt.resolve(wt.Settings(**kw), audio)

    W, F = wt.FFTWindow, wt.FilterMode
    return [r(fft_size=4096),
            r(fft_size=4096, window=W.BLACKMAN),
            r(fft_size=4096, window=W.HAMMING, filter_mode=F.GAUSS),
            r(fft_size=4096, window=W.BLACKMAN_HARRIS, slope=0.5),
            r(fft_size=4096, slope=1.0, interp_mode=wt.InterpMode.LANCZOS),
            r(fft_size=4096, window=W.BLACKMAN, filter_mode=F.GAUSS,
              slope=0.25),
            r(fft_size=8192),
            r(fft_size=16384, enable_large_fft=True),
            r(display_mode=wt.DisplayMode.METER, rms_mode=True),
            r(display_mode=wt.DisplayMode.METER, rms_mode=False),
            r(display_mode=wt.DisplayMode.WAVEFORM, width=800),
            r(display_mode=wt.DisplayMode.WAVEFORM, width=1920)]


def bus_state(bus) -> list:
    """Every group's carried device tensors (the ring left out)."""
    out = []
    for g in bus._groups.values():
        if g["mode"] == "waveform":
            out += [g["buf"], g["latch"]]
        else:
            out += [getattr(g["state"], f) for f in vars(g["state"])]
    return out


def phase_bus(wt, profiler, card: str) -> None:
    """``OutputBus``: one stereo bus, 500 consumers over the 12 looks of
    :func:`bus_cfgs`, then a live N=65536 subscriber."""
    from waveform_tpu_torch.runtime.bus import OutputBus
    from waveform_tpu_torch.runtime.serving import ServingEngine

    cfgs = bus_cfgs(wt)
    audio = wt.AudioInfo(SR, 2)
    bus = OutputBus(audio, device="cuda")
    hs = [bus.subscribe(cfgs[i % len(cfgs)]) for i in range(500)]
    first = {c: hs[i] for i, c in enumerate(cfgs)}
    cpu = OutputBus(audio, device="cpu")
    cpu_h = {c: cpu.subscribe(c) for c in cfgs}
    engines = {c: ServingEngine(c, 1, device="cuda") for c in cfgs
               if c.spectrum_mode}
    rng = np.random.default_rng(SEED + 31)
    pk = [noise_tone(rng, (2, HOP), k) for k in range(BUS_TICKS + 80)]
    now0 = time.monotonic_ns()
    LAUNCHES.clear()
    for k in range(BUS_TICKS):
        now = now0 + (k + 1) * 16_666_667
        bus.feed(pk[k], now, now_ns=now)
        bus.tick(now_ns=now)
    torch.cuda.synchronize()
    counts = fft_launches()
    check(counts == only("K1-gen", 8 * BUS_TICKS),
          f"bus: launches {counts} in {BUS_TICKS} ticks, want 8 K1-gen a "
          "tick and no other kernel")
    for k in range(BUS_TICKS):
        now = now0 + (k + 1) * 16_666_667
        cpu.feed(pk[k], now, now_ns=now)
        cpu.tick(now_ns=now)
        for e in engines.values():
            e.feed(0, pk[k], now, now_ns=now)
            e.tick(now_ns=now)
    torch.cuda.synchronize()
    e_eng = max(float(np.abs(bus.read_decibels(first[c])
                             - e.read_decibels()[0]).max())
                for c, e in engines.items())
    check(e_eng < 1e-3, f"bus: spectrum vs standalone engines {e_eng} dB")
    e_cpu = max(db_vs(wt, bus.read_decibels(first[c]),
                      cpu.read_decibels(cpu_h[c]), "bus: card vs CPU")
                for c in cfgs)
    check(e_cpu < 1e-4, f"bus: card vs CPU port {e_cpu} dB")
    latches = [bool(bus._groups[c]["latch"]) == bool(cpu._groups[c]["latch"])
               for c in cfgs if c.display_mode == wt.DisplayMode.WAVEFORM]
    check(all(latches), "bus: waveform latches differ from the CPU port")
    print(f"bus [{card}]: 500 consumers, {bus.num_groups} looks (8 spectrum "
          f"N=4096 x6 / 8192 / 16384, 2 meters, 2 waveforms W=800 / 1920), "
          f"one ring [1, 2, {bus.L}] ({bus.ring.buf.numel() * 4 / 1e6:.2f} "
          f"MB), upload {bus._dev_in.numel() * 4 / 1e3:.1f} KB: {BUS_TICKS} "
          f"ticks, launches {counts} (8 K1-gen a tick, "
          f"no other kernel); spectrum looks vs standalone card "
          f"ServingEngine(cfg, 1) max {e_eng:.2e} dB (bound 1e-3); every "
          f"look vs the CPU port's bus {e_cpu:.2e} dB, DB_MIN and latches "
          f"exact", flush=True)

    clock = [now0 + (BUS_TICKS + 1) * 16_666_667, BUS_TICKS]

    def bus_tick():
        clock[0] += 16_666_667
        clock[1] += 1
        bus.feed(pk[clock[1] % len(pk)], clock[0], now_ns=clock[0])
        bus.tick(now_ns=clock[0])

    bus_tick()
    torch.cuda.synchronize()
    with profiler.trace() as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            bus_tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summ = profiler.device_summary(prof, wall)
    h2d = h2d_copies(bus_tick, 5)
    check(h2d == 5, f"bus: {h2d} host-to-device copies in 5 ticks, want 5")
    ops = sum(c for c, _ in summ["kernels"].values()) / 5
    t_tick = cuda_median_ms(bus_tick, reps=20, warmup=3)
    frames_p = profiler.FrameProfiler(500, 16384)
    for _ in range(60):
        with frames_p.tick():
            bus_tick()
            torch.cuda.synchronize()
    st = frames_p.stats()
    t_render = {}
    for mode, c in (("spectrum", cfgs[0]), ("meter", cfgs[8]),
                    ("waveform", cfgs[11])):
        bus.render_frame(first[c])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = bus.render_frame(first[c])
        t_render[mode] = (time.perf_counter() - t0) * 1e3
        check(img.shape == (c.height, c.width, 4) and np.isfinite(img).all()
              and img[..., 3].max() > 0.5, f"bus: {mode} frame")
    print(f"bus [{card}]: tick (feed + tick, CUDA events, median of 20) "
          f"{t_tick:.3f} ms, one replay; host-to-device copies a tick "
          f"{h2d / 5:.0f}; device busy {summ['busy_us'] / 5:.1f} us a tick, "
          f"{summ['busy_share']:.1%} of the profiled ticks, "
          f"{summ['busy_us'] / 5e3 / t_tick:.1%} of the unprofiled; "
          f"{ops:.0f} device ops a tick; top {top_ops(summ)}; 60 "
          f"synchronized ticks p50 {st['p50_ms']:.3f} / p99 "
          f"{st['p99_ms']:.3f} ms; render_frame (host clock, the copy "
          f"included) " + ", ".join(f"{m} {t:.2f} ms"
                                    for m, t in t_render.items()),
          flush=True)

    big = wt.resolve(wt.Settings(fft_size=65536, enable_large_fft=True),
                     audio)
    torch.cuda.synchronize()
    old_L, old_ring = bus.L, bus.ring.buf.clone()
    before = [t.clone() for t in bus_state(bus)]
    hb = bus.subscribe(big)
    check(bus.L == 65536 + bus.H
          and torch.equal(bus.ring.buf[..., -old_L:], old_ring)
          and not bus.ring.buf[..., :-old_L].any(),
          "bus: the grown ring does not hold the old ring as its tail")
    check(all(torch.equal(a, b) for a, b in zip(bus_state(bus), before)),
          "bus: the groups' state changed across the subscribe")
    LAUNCHES.clear()
    for _ in range(3):
        bus_tick()
    torch.cuda.synchronize()
    counts = fft_launches()
    want = {"K1-gen": 24, "K2": 3}
    check(counts == want, f"bus: launches after the N=65536 subscribe "
          f"{counts}, want 8 K1-gen + 1 K2 a tick")
    t_big = cuda_median_ms(bus_tick, reps=20, warmup=3)
    check(np.isfinite(bus.read_decibels(hb)).all(), "bus: N=65536 look")
    print(f"bus [{card}]: live subscribe of an N=65536 consumer: the ring "
          f"grew {old_L} -> {bus.L} samples with the old ring as its tail, "
          f"every look's state carried bit for bit; 3 ticks launch "
          f"{counts} (8 K1-gen + 1 K2 a tick); tick "
          f"{t_big:.3f} ms", flush=True)


# --- plans, the matmul backend, rfft_fn, the demo, warm -----------------

TUNE_SIZES = (4096, 16384, 32768)   # the tuner's sizes in the plans phase
SPLIT_COUNTER = {2: "K1-gen", 3: "K2"}


@contextlib.contextmanager
def plan_file(splits: dict):
    """``WAVEFORM_TPU_PLAN_FILE`` naming ``splits`` ({N: stage-1 split})
    for a block, in a temporary directory (a user's plan file wins over
    the packaged table)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "plans.json")
        with open(path, "w") as f:
            json.dump({str(n): {"split": s} for n, s in splits.items()}, f)
        with env("WAVEFORM_TPU_PLAN_FILE", path):
            yield path


def headline_cfg(wt):
    """Stereo 48 kHz, N=4096, Hann, 800-px Lanczos rebin."""
    return wt.resolve(wt.Settings(fft_size=4096, width=800,
                                  window=wt.FFTWindow.HANN,
                                  interp_mode=wt.InterpMode.LANCZOS),
                      wt.AudioInfo(SR, 2))


def phase_plans(wt, card: str) -> None:
    """The tuner on this card at TUNE_SIZES, S=64, 3 reps, into a
    temporary plan file; the packaged H100 table read here; an N=16384,
    S=64 engine steered by the table with no variable set, then by a plan
    file naming the other body."""
    from waveform_tpu_torch.runtime.serving import ServingEngine
    from waveform_tpu_torch.utils import plans

    with tempfile.TemporaryDirectory() as d:
        with env("WAVEFORM_TPU_PLAN_FILE", os.path.join(d, "plans.json")):
            tuned = {n: plans.measure(n, streams=64, ticks=32, reps=3)
                     for n in TUNE_SIZES}
            check(all(plans.plan_for(n) == e for n, e in tuned.items()),
                  "plans: the tuner's file does not read back")
    for n, e in tuned.items():
        check(e["split"] in {s for s, _ in plans._candidates(n)}
              and 0 < e["us_per_frame"] < e["xla_us_per_frame"],
              f"plans: tuner entry at N={n}: {e}")
    plans._packaged_plans.cache_clear()
    table = plans._packaged_plans()
    with open(plans.PACKAGED) as f:
        shipped = json.load(f)
    check("H100" in torch.cuda.get_device_name(0) and table == shipped,
          "plans: the packaged H100 table is not read on this card")
    check("WAVEFORM_TPU_PLAN_FILE" not in os.environ
          and "WAVEFORM_TPU_STAGE1_SPLIT" not in os.environ
          and not os.path.exists(plans.plan_path()),
          f"plans: a plan variable or {plans.plan_path()} would steer the "
          "default route")
    print(f"plans [{card}]: tuner at S=64 (3 reps, 32 calls a graph): "
          + "; ".join(f"N={n} split {e['split']} {e['us_per_frame']} "
                      f"us/frame, lowering {e['xla_us_per_frame']} us/frame"
                      f" (packaged S=256 table: split "
                      f"{table[str(n)]['split']})"
                      for n, e in tuned.items())
          + f"; packaged table read ({len(table)} sizes)", flush=True)

    cfg = wt.resolve(wt.Settings(fft_size=16384, enable_large_fft=True,
                                 width=800, window=wt.FFTWindow.HANN,
                                 interp_mode=wt.InterpMode.LANCZOS),
                     wt.AudioInfo(SR, 2))
    rng = np.random.default_rng(SEED + 40)
    named = table["16384"]["split"]
    ticks = 21
    served = []
    for label, split in (("packaged table, no variable", named),
                         ("plan file", 5 - named)):
        with (plan_file({16384: split}) if split != named
              else contextlib.nullcontext()):
            eng = ServingEngine(cfg, 64, device="cuda")
            cpu = ServingEngine(cfg, 2, device="cpu")
            pk = [feed_signal(rng, 64, k) for k in range(ticks)]
            now0 = time.monotonic_ns()
            counts, _, peak, e_cpu = drive_slice(wt, eng, cpu, pk, now0)
            check(counts == served_launches(SPLIT_COUNTER[split], ticks),
                  f"plans: {label}: launches {counts}, want split {split}'s "
                  f"kernel once a tick and no other")
            gate = oracle_gate(wt, ServingEngine, 16384, ticks, rng, now0)
        body = "K1-gen" if split == 2 else "K2"
        served.append((body, eng, pk, now0))
        print(f"plans [{card}]: ServingEngine N=16384 S=64 under the "
              f"{label}: {ticks} {body} launches in {ticks} ticks, no other "
              f"kernel, peak {peak:.2f} Hz, card vs CPU port {e_cpu:.2e} dB, "
              f"oracle gate {gate:.2e} dB (< 1e-4)", flush=True)
        del cpu
    # the two engines' ticks in turns (the route was fixed at capture);
    # each call's clock starts a second after the one before
    turns = [tick_ms(served[j][1], served[j][2],
                     served[j][3] + (i + 1) * 10**9)
             for i, j in enumerate((0, 1, 1, 0))]
    print(f"plans [{card}]: full tick (feed_batch + tick) at N=16384 S=64 "
          f"in turns: {served[0][0]} {turns[0] * 1e3:.1f} / "
          f"{turns[3] * 1e3:.1f} us, {served[1][0]} {turns[1] * 1e3:.1f} / "
          f"{turns[2] * 1e3:.1f} us", flush=True)


def graph_vs_eager(make, packets, now0, cpu_rows=None, cpu=None):
    """Drive two engines from ``make()`` over ``packets``: one by its
    graph ticks (counts set to 0 just before, read just after), one by the
    eager device function; and ``cpu`` on ``cpu_rows``.  Checks the
    pixels of every tick and the final state bit for bit; returns (the
    graph engine, the launch counts)."""
    graph, eager = make(), make()
    same = True
    LAUNCHES.clear()
    for k, x in enumerate(packets):
        now = now0 + k * 16_666_667
        graph.feed_batch(x, now, now_ns=now)
        eager.feed_batch(x, now, now_ns=now)
        same &= torch.equal(graph.tick(now_ns=now), eager_tick(eager, now))
        if cpu is not None:
            cpu.feed_batch(x[cpu_rows], now, now_ns=now)
            cpu.tick(now_ns=now)
    torch.cuda.synchronize()
    counts = fft_launches()
    check(same and all(torch.equal(a, b) for a, b in
                       zip(engine_state(graph), engine_state(eager))),
          "graph ticks differ from eager ticks")
    return graph, counts


def phase_matmul(wt, card: str) -> None:
    """The headline configuration under WAVEFORM_TPU_FFT_BACKEND=matmul."""
    from waveform_tpu_torch.runtime.serving import ServingEngine
    cfg = headline_cfg(wt)
    S, ticks = 256, 8
    rows = [0, 1, 2, S - 1]
    rng = np.random.default_rng(SEED + 41)
    pk = []
    for k in range(ticks):
        x = noise_tone(rng, (S, 2, HOP), k).astype(np.float32)
        x[-1] = 0.0
        pk.append(x)
    now0 = time.monotonic_ns()
    with env("WAVEFORM_TPU_FFT_BACKEND", "matmul"):
        cpu = ServingEngine(cfg, 4, device="cpu")
        eng, counts = graph_vs_eager(
            lambda: ServingEngine(cfg, S, device="cuda"), pk, now0, rows,
            cpu)
        check(not any(counts) and eng.kernels_per_replay
              == {("tick", True): {**TAIL, **REBIN}},
              f"matmul: exact kernels launched {counts}, "
              f"{eng.kernels_per_replay}")
        e_cpu = db_vs(wt, eng.read_decibels()[rows], cpu.read_decibels(),
                      "matmul: card vs CPU port")
        check(e_cpu < 1e-3, f"matmul: card vs CPU port {e_cpu} dB")
        err = oracle_err(wt, ServingEngine, 4096, 8, rng, now0)
        check(np.isfinite(err), "matmul: oracle error not finite")
    exact = ServingEngine(cfg, S, device="cuda")
    for k, x in enumerate(pk):
        now = now0 + k * 16_666_667
        exact.feed_batch(x, now, now_ns=now)
        exact.tick(now_ns=now)
    # in turns; each call's clock starts a second after the one before
    turns = [tick_ms(e, pk, now0 + (i + 1) * 10**9)
             for i, e in enumerate((exact, eng, eng, exact))]
    print(f"matmul [{card}]: S={S} N=4096 800px Lanczos, {ticks} graph "
          f"ticks bit for bit with eager ticks (pixels and state), no exact "
          f"kernel launched ({counts}); card vs CPU "
          f"port (4 streams) {e_cpu:.2e} dB (bound 1e-3); vs the float64 "
          f"oracle {err:.2e} dB (not gated: the f32 GEMM FFT); full tick "
          f"(feed_batch + tick, in turns) matmul {turns[1] * 1e3:.1f} / "
          f"{turns[2] * 1e3:.1f} us, exact {turns[0] * 1e3:.1f} / "
          f"{turns[3] * 1e3:.1f} us", flush=True)


def phase_rfft_fn(wt, card: str) -> None:
    """``rfft_fn=torch.fft.rfft`` in ``ServingEngine`` and
    ``WaveformEngine`` at the headline configuration."""
    from waveform_tpu_torch.runtime.engine import WaveformEngine
    from waveform_tpu_torch.runtime.serving import ServingEngine
    cfg = headline_cfg(wt)
    fn = torch.fft.rfft
    S, ticks = 256, 8
    rng = np.random.default_rng(SEED + 42)
    pk = [feed_signal(rng, S, k) for k in range(ticks)]
    now0 = time.monotonic_ns()
    eng, counts = graph_vs_eager(
        lambda: ServingEngine(cfg, S, rfft_fn=fn, device="cuda"), pk, now0)
    check(not any(counts)
          and eng.kernels_per_replay == {("tick", True): {**TAIL, **REBIN}},
          f"rfft_fn: exact kernels launched {counts}")
    e_fn = oracle_err(wt, ServingEngine, 4096, 8,
                      np.random.default_rng(SEED + 43), now0, rfft_fn=fn)
    with env("WAVEFORM_TPU_FFT_BACKEND", "xla"):
        e_xla = oracle_err(wt, ServingEngine, 4096, 8,
                           np.random.default_rng(SEED + 43), now0)
    check(e_fn <= e_xla, f"rfft_fn: oracle error {e_fn} dB above the xla "
          f"backend's {e_xla} dB")
    t_ms = tick_ms(eng, pk, now0)
    del eng

    weng = WaveformEngine(cfg, S, rfft_fn=fn, device="cuda")
    wcpu = WaveformEngine(cfg, 4, rfft_fn=fn, device="cpu")
    rows = [0, 1, 2, S - 1]
    LAUNCHES.clear()
    now = now0
    for x in pk:
        now += 16_666_667
        for s in range(S):
            weng.feed(s, x[s], now, now_ns=now)
        for i, s in enumerate(rows):
            wcpu.feed(i, x[s], now, now_ns=now)
        db_card = weng.tick(now_ns=now)
        db_cpu = wcpu.tick(now_ns=now)
    torch.cuda.synchronize()
    wcounts = fft_launches()
    check(not any(wcounts) and weng._device_tick.graph is not None,
          f"rfft_fn: WaveformEngine launches {wcounts}, or no graph")
    e_w = db_vs(wt, db_card.cpu().numpy()[rows], db_cpu.numpy(),
                "rfft_fn: WaveformEngine card vs CPU port")
    check(e_w < 1e-3, f"rfft_fn: WaveformEngine card vs CPU {e_w} dB")
    print(f"rfft_fn [{card}]: ServingEngine(cfg, {S}, rfft_fn=torch.fft."
          f"rfft) at the headline: captured in the graph, {ticks} ticks bit "
          f"for bit with eager ticks, no exact kernel; vs the float64 oracle "
          f"{e_fn:.2e} dB (xla backend {e_xla:.2e} dB); full tick "
          f"{t_ms * 1e3:.1f} us; WaveformEngine(rfft_fn=...) S={S}: {ticks} "
          f"graph ticks, no exact kernel, card vs CPU port {e_w:.2e} dB "
          "(bound 1e-3)", flush=True)


def read_png(path: str) -> np.ndarray:
    """RGBA8 [H, W, 4] of a PNG as ``render/image.write_png`` writes it
    (one IDAT stream, filter 0 on every row)."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = (int.from_bytes(body[i:i + 4], "big") for i in (0, 4))
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    return rows[:, 1:].reshape(h, w, 4)


def phase_demo(card: str) -> None:
    """``python -m waveform_tpu_torch.demo`` (its ``main``) on a 2-s
    stereo WAV of two tones plus noise, for a curve scene at N=4096, a
    level meter and a waveform, on the card and with ``--device cpu``."""
    import logging
    import wave

    from waveform_tpu_torch import demo
    from waveform_tpu_torch.utils.log import get_logger

    rng = np.random.default_rng(SEED + 44)
    t = np.arange(2 * SR) / SR
    x = np.stack([0.3 * np.sin(2 * np.pi * 440.0 * t),
                  0.3 * np.sin(2 * np.pi * 1000.0 * t)])
    x = np.clip(x + 0.1 * rng.standard_normal(x.shape), -1.0, 1.0)
    scenes = {"curve": {"display_mode": "curve", "fft_size": 4096},
              "level_meter": {"display_mode": "level_meter",
                              "meter_buf": 100},
              "waveform": {"display_mode": "waveform"}}
    said = []

    class Keep(logging.Handler):
        def emit(self, record):
            said.append(record.getMessage())

    keep = Keep()
    get_logger().addHandler(keep)
    lines = []
    try:
        with tempfile.TemporaryDirectory() as d:
            wav = os.path.join(d, "in.wav")
            with wave.open(wav, "wb") as w:
                w.setnchannels(2)
                w.setsampwidth(2)
                w.setframerate(SR)
                w.writeframes((x.T * 32767).astype("<i2").tobytes())
            ticks = x.shape[1] // HOP
            for name, scene in scenes.items():
                sp = os.path.join(d, f"{name}.json")
                with open(sp, "w") as f:
                    json.dump(scene, f)
                outs = {dev: os.path.join(d, f"{name}_{dev}")
                        for dev in ("cuda", "cpu")}
                args = [wav, "--settings", sp, "--every", "30"]
                LAUNCHES.clear()
                said.clear()
                check(demo.main(args + ["--out", outs["cuda"]]) == 0,
                      f"demo: {name} on the card")
                torch.cuda.synchronize()
                counts = fft_launches()
                stats = [m for m in said if "frames/s" in m]
                want = served_launches("K1-gen",
                            ticks if name == "curve" else 0)
                check(counts == want, f"demo: {name} launches {counts}, want "
                      f"{want}")
                check(demo.main(args + ["--out", outs["cpu"], "--device",
                                        "cpu"]) == 0, f"demo: {name} on CPU")
                names = sorted(os.listdir(outs["cuda"]))
                check(names == sorted(os.listdir(outs["cpu"])) and names
                      == [f"frame_{k:06d}.png" for k in (30, 60, 90)],
                      f"demo: {name} frames {names}")
                worst = 0
                for png in names:
                    a, b = (read_png(os.path.join(outs[dev], png))
                            .astype(np.int16) for dev in ("cuda", "cpu"))
                    check(a.shape == b.shape and a[..., 3].any(),
                          f"demo: {name} {png}")
                    worst = max(worst, int(np.abs(a - b).max()))
                check(worst <= 1, f"demo: {name} card vs CPU frames differ "
                      f"by {worst}/255")
                lines.append(f"{name}: {len(names)} PNGs, "
                             f"{counts.get('K1-gen', 0)}"
                             f" K1-gen launches in {ticks} ticks, card vs CPU "
                             f"port frames max {worst}/255; "
                             + (stats[0] if stats else "no profiler stats"))
    finally:
        get_logger().removeHandler(keep)
    for ln in lines:
        print(f"demo [{card}]: {ln}", flush=True)


WARM_PROBE = """
import json, sys, time
import numpy as np, torch
import waveform_tpu_torch as wt
from waveform_tpu_torch.runtime.serving import ServingEngine
from waveform_tpu_torch.utils import wisdom
cfg = wt.resolve(wt.Settings(fft_size=4096, width=800,
                             window=wt.FFTWindow.HANN,
                             interp_mode=wt.InterpMode.LANCZOS),
                 wt.AudioInfo(48000, 2))
torch.zeros(1, device="cuda")
torch.cuda.synchronize()     # the CUDA context: outside every timing
t_warm = 0.0
if sys.argv[1] == "warm":
    t0 = time.perf_counter()
    wisdom.warm(cfg, 256)
    t_warm = time.perf_counter() - t0
t0 = time.perf_counter()
eng = ServingEngine(cfg, 256)
t_new = time.perf_counter() - t0
x = np.zeros((256, 2, 800), np.float32)
ticks = []
for k in range(2):
    eng.feed_batch(x, 10**10 + k, now_ns=10**10 + k)
    t0 = time.perf_counter()
    eng.tick(now_ns=10**10 + k)
    torch.cuda.synchronize()
    ticks.append(time.perf_counter() - t0)
print(json.dumps({"warm_s": t_warm, "engine_s": t_new, "first_s": ticks[0],
                  "second_s": ticks[1]}))
"""


def phase_warm(card: str) -> None:
    """``wisdom.warm`` at the headline: two fresh processes, in this order,
    each building a new S=256 engine and timing its first two ticks on the
    host clock (synchronized): first without warming, then after
    ``wisdom.warm(cfg, 256)``.  Both find the kernel library that the
    build phase left on disk (an nvcc build, had there been none, would
    fall to the first of them)."""
    root = os.path.dirname(os.path.abspath(__file__))
    got = {}
    for mode in ("cold", "warm"):
        r = subprocess.run([sys.executable, "-c", WARM_PROBE, mode], cwd=root,
                           capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, f"warm: the {mode} process failed:\n"
              f"{r.stderr[-2000:]}")
        got[mode] = json.loads(r.stdout.strip().splitlines()[-1])
    c, w = got["cold"], got["warm"]
    print(f"warm [{card}]: a new S=256 headline engine in a fresh process "
          f"(cold first, then warm): first tick {c['first_s'] * 1e3:.1f} ms "
          f"cold vs {w['first_s'] * 1e3:.1f} ms after wisdom.warm (which "
          f"took {w['warm_s'] * 1e3:.1f} ms); second tick "
          f"{c['second_s'] * 1e3:.2f} / {w['second_s'] * 1e3:.2f} ms; engine "
          f"construction {c['engine_s'] * 1e3:.1f} / "
          f"{w['engine_s'] * 1e3:.1f} ms", flush=True)


PARALLEL_CHILD = """
import datetime, json, os, sys
import numpy as np, torch, torch.distributed as dist
import waveform_tpu_torch as wt
from waveform_tpu_torch.parallel import ShardedServingEngine, make_mesh
from waveform_tpu_torch.utils.checkpoint import to_host
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
dev = torch.device("cuda", 0)
mesh = make_mesh([dev, dev])               # this process's 2 entries
cfg = wt.resolve(wt.Settings(fft_size=4096, width=800,
                             window=wt.FFTWindow.HANN,
                             interp_mode=wt.InterpMode.LANCZOS),
                 wt.AudioInfo(48000, 2))
pk = np.load(os.path.join(out, "packets.npy"))
eng = ShardedServingEngine(cfg, pk.shape[1], mesh=mesh)
lo, hi = eng.local_streams
for t in range(len(pk)):
    x = np.zeros_like(pk[t])
    x[lo:hi] = pk[t, lo:hi]                # ONLY this process's rows
    now = 10**10 + t * 16_666_667
    eng.feed_batch(x, now, now_ns=now)
    eng.tick(now_ns=now)
for k, tl in enumerate(eng.pixels_sharded):
    np.savez(os.path.join(out, f"px_{rank}_{k}.npz"), data=tl.data.cpu().numpy(),
             bounds=np.array([[sl.start or 0, sl.stop or n] for sl, n in
                              zip(tl.index, tl.data.shape)]))
db_old = to_host(eng.state.decibels)       # collective
ck = os.path.join(out, "ck.npz")
eng.save_state(ck)                         # collective; process 0 writes
eng2 = ShardedServingEngine(cfg, 6, mesh=mesh)
eng2.load_state(ck, keep=[5, 0, 3])        # collective
db_new = to_host(eng2.state.decibels)
if rank == 0:
    np.savez(os.path.join(out, "resize.npz"), db_old=db_old, db_new=db_new)
for s in range(*eng2.local_streams):
    eng2.feed(s, pk[0, s], now, now_ns=now)
eng2.tick(now_ns=now + 16_666_667)
ok = all(bool(torch.isfinite(tl.data).all()) for tl in eng2.pixels_sharded)
dist.barrier()
dist.destroy_process_group()
print(json.dumps({"rank": rank, "rows": [lo, hi], "live_finite": ok}))
"""


def tiles_vs(wt, eng, single, what: str) -> tuple:
    """A sharded engine's pixels and dB against a single engine's: (max
    |d| dB on visible values, bit for bit); checks 1e-4 dB."""
    e_px = db_vs(wt, eng.read_pixels(), single.read_pixels(), what)
    e_db = db_vs(wt, eng.read_decibels(), single.read_decibels(), what)
    same = (np.array_equal(eng.read_pixels(), single.read_pixels())
            and np.array_equal(eng.read_decibels(), single.read_decibels()))
    e = max(e_px, e_db)
    check(e < 1e-4, f"{what}: sharded vs single {e} dB")
    return e, same


def phase_parallel(wt, card: str) -> dict:
    """The sharded engines (``waveform_tpu_torch.parallel``) at the
    headline's full width over a 4-entry mesh (the real devices when there
    are 4, else cuda:0 repeated), each against its single engine fed the
    same packets: 4x1 and 2x2 at N=4096 S=256, N=65536 S=32, the routing
    under EXACT_FUSED=never, padding, the meter and waveform families,
    microbatch, tick_many, resize across mesh shapes with the memory over
    10 round trips, two processes on one card, and the sharded and single
    ticks timed in turns.  Returns the phase's launches."""
    import gc

    from waveform_tpu_torch.parallel import (
        ShardedMeterServingEngine,
        ShardedServingEngine,
        ShardedWaveformEngine,
        make_mesh,
    )
    from waveform_tpu_torch.runtime.meter_serving import MeterServingEngine
    from waveform_tpu_torch.runtime.serving import ServingEngine
    from waveform_tpu_torch.runtime.waveform_device import (
        DeviceWaveformEngine,
    )
    from waveform_tpu_torch.dryrun import mesh_devices
    from waveform_tpu_torch.utils.checkpoint import to_host

    devs = mesh_devices(4)
    where = f"{len({str(d) for d in devs})} distinct device(s)"
    cfg = headline_cfg(wt)
    rng = np.random.default_rng(SEED + 13)
    S, ticks = 256, 8
    packets = [noise_tone(rng, (S, 2, HOP), k) for k in range(ticks)]
    now0 = 10**10
    launched = {}

    def drive(engines, pk, t0=0):
        for k, x in enumerate(pk):
            now = now0 + (t0 + k) * 16_666_667
            for e in engines:
                e.feed_batch(x, now, now_ns=now)
                e.tick(now_ns=now)
        torch.cuda.synchronize()

    # 4x1 and 2x2 at the headline, against the single engine
    single = ServingEngine(cfg, S)
    drive([single], packets)
    meshes = {}
    for pp in (1, 2):
        mesh = make_mesh(devs, pixel_parallel=pp)
        shape = f"{mesh.shape['stream']}x{mesh.shape['pixel']}"
        eng = ShardedServingEngine(cfg, S, mesh=mesh)
        LAUNCHES.clear()
        drive([eng], packets)
        got = fft_launches()
        check(got == served_launches("K1-gen", 4 * ticks),
              f"parallel {shape}: launches {got} in {ticks} ticks")
        reps = eng.kernels_per_replay
        check(reps == {("tick", True): replay_launches("K1-gen", 4)},
              f"parallel {shape}: kernels a replay {reps}")
        launched[f"k1_gen_{shape}"] = got.get("K1-gen", 0)
        e, same = tiles_vs(wt, eng, single, f"parallel {shape}")
        tiles = {tuple(t.data.shape) for t in eng.pixels_sharded}
        print(f"parallel [{card}]: {shape} mesh on {where}, S={S} N=4096 "
              f"800px Lanczos, {ticks} ticks: tiles {sorted(tiles)}, "
              f"{got.get('K1-gen', 0)} K1-gen launches (4 a "
              f"replay, one an entry), no other kernel; pixels and dB vs "
              f"the single engine max |d| {e:.3e} dB, bit for bit: {same}",
              flush=True)
        meshes[pp] = (mesh, eng)
    if torch.cuda.device_count() >= 2:    # two real cards, when present
        real = make_mesh([torch.device("cuda", 0), torch.device("cuda", 1)])
        eng = ShardedServingEngine(cfg, S, mesh=real)
        drive([eng], packets)
        e, same = tiles_vs(wt, eng, single, "parallel cuda:0+cuda:1")
        print(f"parallel [{card}]: 2x1 mesh on cuda:0 and cuda:1 vs the "
              f"single engine {e:.3e} dB, bit for bit: {same}", flush=True)
    mesh41, eng41 = meshes[1]

    # the large FFT: K2 on every entry
    big = wt.resolve(wt.Settings(fft_size=65536, enable_large_fft=True,
                                 width=800, window=wt.FFTWindow.HANN,
                                 interp_mode=wt.InterpMode.LANCZOS),
                     wt.AudioInfo(SR, 2))
    pk32 = [noise_tone(rng, (32, 2, HOP), k) for k in range(3)]
    sb = ServingEngine(big, 32)
    drive([sb], pk32)
    eb = ShardedServingEngine(big, 32, mesh=mesh41)
    LAUNCHES.clear()
    drive([eb], pk32)
    got = fft_launches()
    check(got == served_launches("K2", 4 * len(pk32)),
          f"parallel N=65536: launches {got}")
    launched["k2_4x1"] = got.get("K2", 0)
    e, same = tiles_vs(wt, eb, sb, "parallel N=65536")
    print(f"parallel [{card}]: 4x1 N=65536 S=32, {len(pk32)} ticks: "
          f"{launched['k2_4x1']} K2 launches (4 a tick), no other kernel; "
          f"vs the single engine {e:.3e} dB, bit for bit: {same}",
          flush=True)
    del sb, eb

    # the routing: off the pair kernel each entry runs K3, as the single
    # engine does (the JAX sharded engine takes its lowering there)
    with env("WAVEFORM_TPU_EXACT_FUSED", "never"):
        sl = ServingEngine(cfg, S)
        LAUNCHES.clear()
        drive([sl], packets[:3])
        one = fft_launches()
        check(one == only("K3", 3),
              f"parallel FUSED=never: single engine launches {one}")
        el = ShardedServingEngine(cfg, S, mesh=mesh41)
        LAUNCHES.clear()
        drive([el], packets[:3])
        got = fft_launches()
        check(got == only("K3", 4 * 3),
              f"parallel FUSED=never: launches {got}")
        reps = el.kernels_per_replay
        check(reps == {("tick", True): replay_launches("K3", 4)},
              f"parallel FUSED=never: kernels a replay {reps}")
        launched["k3_4x1"] = got.get("K3", 0)
        e, same = tiles_vs(wt, el, sl, "parallel FUSED=never")
    print(f"parallel [{card}]: EXACT_FUSED=never 4x1 S={S}, 3 ticks: "
          f"{launched['k3_4x1']} K3 launches (4 a replay, one an entry; the "
          f"single engine 3 in 3), no other kernel; vs the single engine "
          f"{e:.3e} dB, bit for bit: {same}", flush=True)
    del sl, el

    # padding: 250 streams on 4 row blocks
    ep = ShardedServingEngine(cfg, 250, mesh=mesh41)
    sp = ServingEngine(cfg, 250)
    drive([ep, sp], [x[:250] for x in packets[:3]])
    e, _ = tiles_vs(wt, ep, sp, "parallel padded")
    check(ep.S == 252 and ep.read_pixels().shape[0] == 250
          and ep.last_silent.shape == (250,), "parallel padded: trim")
    pad_db = to_host(ep.state.decibels)[250:]
    check(to_host(ep.state.last_silent)[250:].all()
          and (pad_db == np.float32(wt.DB_MIN)).all(),
          "parallel padded: pad rows not inert")
    del ep, sp

    # the meter and waveform families, microbatch and tick_many
    mcfg = wt.resolve(wt.Settings(display_mode=wt.DisplayMode.METER),
                      wt.AudioInfo(SR, 2))
    em = ShardedMeterServingEngine(mcfg, S, mesh=meshes[2][0])
    smt = MeterServingEngine(mcfg, S)
    drive([em, smt], packets[:4])
    e_m = db_vs(wt, em.meter_values.cpu().numpy(),
                smt.meter_values.cpu().numpy(), "parallel meter")
    check(e_m < 1e-4, f"parallel meter {e_m} dB")
    wcfg = wt.resolve(wt.Settings(display_mode=wt.DisplayMode.WAVEFORM,
                                  width=800,
                                  temporal_smoothing=wt.TSmoothingMode.NONE),
                      wt.AudioInfo(SR, 2))
    ew = ShardedWaveformEngine(wcfg, S, mesh=mesh41)
    sw = DeviceWaveformEngine(wcfg, S)
    drive([ew, sw], packets[:4])
    e_w = db_vs(wt, ew.render_values(), sw.render_values(),
                "parallel waveform")
    check(e_w < 1e-4, f"parallel waveform {e_w} dB")
    emb = ShardedServingEngine(cfg, S, mesh=meshes[2][0], microbatch=2)
    drive([emb], packets[:4])
    batch = np.empty((2, S, 1, 800), np.float32)
    for t in emb.last_batch_pixels:
        batch[t.index] = t.data.cpu().numpy()
    s1 = ServingEngine(cfg, S)
    flush = []
    for k, x in enumerate(packets[:4]):
        now = now0 + k * 16_666_667
        s1.feed_batch(x, now, now_ns=now)
        flush.append(s1.tick(now_ns=now).cpu().numpy())
    e_mb = db_vs(wt, batch, np.stack(flush[2:]), "parallel microbatch")
    check(e_mb < 1e-4, f"parallel microbatch {e_mb} dB")
    bulk = np.stack([noise_tone(rng, (S, 2, HOP), k) for k in range(4)])
    tm = ShardedServingEngine(cfg, S, mesh=meshes[2][0])
    stm = ServingEngine(cfg, S)
    LAUNCHES.clear()
    tiles = tm.tick_many(bulk)
    torch.cuda.synchronize()
    n_bulk = LAUNCHES["K1-gen"]
    got = np.empty((4, S, 1, 800), np.float32)
    for t in tiles:
        got[t.index] = t.data.cpu().numpy()
    e_tm = db_vs(wt, got, stm.tick_many(bulk).cpu().numpy(),
                 "parallel tick_many")
    check(e_tm < 1e-4 and n_bulk == 16, f"parallel tick_many {e_tm} dB, "
          f"{n_bulk} K1-gen launches")
    print(f"parallel [{card}]: meter 2x2 (one shard a row block) vs single "
          f"{e_m:.3e} dB; waveform W=800 4x1 vs single {e_w:.3e} dB; "
          f"microbatch=2 flush 2x2 vs single ticks {e_mb:.3e} dB; "
          f"tick_many T=4 2x2: {n_bulk} K1-gen launches, vs single "
          f"{e_tm:.3e} dB; padded 250 -> 252 rows, pad rows latched at "
          f"DB_MIN, trimmed reads", flush=True)
    del em, smt, ew, sw, emb, s1, tm, stm

    # resize across mesh shapes, and device memory over 10 round trips
    e22 = meshes[2][1]
    before = e22.read_decibels()
    keep = [3, 1, 4]
    r41 = e22.resized(4, keep=keep, mesh=mesh41)
    check(np.array_equal(r41.read_decibels()[:3], before[keep]),
          "parallel resize: kept dB")
    drive([r41], [x[:4] for x in packets[:1]], t0=ticks)
    check(np.isfinite(r41.read_pixels()).all(), "parallel resize: tick")
    mem, asked, live = [], [], []
    cur = e22
    for cycle in range(10):
        a = cur.resized(S, keep=list(range(S)), mesh=mesh41)
        drive([a], packets[:1], t0=ticks + 1 + cycle)
        cur = a.resized(S, keep=list(range(S)), mesh=meshes[2][0])
        drive([cur], packets[:1], t0=ticks + 1 + cycle)
        del a
        gc.collect()
        torch.cuda.synchronize()
        st = torch.cuda.memory_stats()
        mem.append(st["allocated_bytes.all.current"])
        asked.append(st["requested_bytes.all.current"])
        live.append(st["active.all.current"])
    # the bytes the program holds, gated as phase_multi gates its cycles;
    # the allocated bytes also count the rest of each cached block that
    # served a request (a block is split only when 1 MiB or more would be
    # left), so they move with the cache's layout from trip to trip
    check(abs(asked[-1] - asked[0]) <= 1 << 20,
          f"parallel resize: memory after 10 round trips {asked[-1]} against "
          f"{asked[0]} after the first (every trip: {asked}; allocated "
          f"{mem}; live blocks {live})")
    print(f"parallel [{card}]: resized 2x2 -> 4x1 keeping rows {keep}: dB "
          f"carried bit for bit, a live tick after; device memory requested "
          f"after 1 / 10 round trips (2x2 -> 4x1 -> 2x2, S={S}, a tick on "
          f"each, gc.collect() first) {asked[0] / 1e6:.3f} / "
          f"{asked[-1] / 1e6:.3f} MB (margin 1 MiB), live blocks {live[0]} "
          f"/ {live[-1]}; allocated (whole cached blocks) {min(mem) / 1e6:.3f}"
          f"-{max(mem) / 1e6:.3f} MB", flush=True)
    del r41, cur

    # two processes on one card, each a 2-entry mesh on cuda:0
    import socket
    with tempfile.TemporaryDirectory() as out:
        S2 = 16
        pk = np.stack([noise_tone(rng, (S2, 2, HOP), k) for k in range(4)])
        np.save(os.path.join(out, "packets.npy"), pk)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        root = os.path.dirname(os.path.abspath(__file__))
        procs = [subprocess.Popen(
            [sys.executable, "-c", PARALLEL_CHILD, str(r), str(port), out],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        try:
            res = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (o, err) in zip(procs, res):
            check(p.returncode == 0, f"parallel child failed:\n{err[-3000:]}")
        rows = [json.loads(o.strip().splitlines()[-1]) for o, _ in res]
        ref = ServingEngine(cfg, S2)
        for t in range(len(pk)):
            now = 10**10 + t * 16_666_667
            ref.feed_batch(pk[t], now, now_ns=now)
            ref.tick(now_ns=now)
        want = ref.read_pixels()
        got = np.full_like(want, np.nan)
        files = sorted(f for f in os.listdir(out) if f.startswith("px_"))
        for f in files:
            z = np.load(os.path.join(out, f))
            got[tuple(slice(a, b) for a, b in z["bounds"])] = z["data"]
        check(len(files) == 4 and np.isfinite(got).all(),
              "parallel two processes: tiles")
        e2 = db_vs(wt, got, want, "parallel two processes")
        check(e2 < 1e-4, f"parallel two processes {e2} dB")
        z = np.load(os.path.join(out, "resize.npz"))
        db_old, db_new = z["db_old"], z["db_new"]
        check(np.array_equal(db_new[:3], db_old[[5, 0, 3]])
              and (db_new[3:6] == np.float32(wt.DB_MIN)).all(),
              "parallel two processes: load_state(keep)")
        back = ServingEngine(cfg, S2)
        back.load_state(os.path.join(out, "ck.npz"))
        check(np.array_equal(back.state.decibels.cpu().numpy(), db_old),
              "parallel two processes: checkpoint into a ServingEngine")
        check(all(r["live_finite"] for r in rows),
              "parallel two processes: live tick")
    print(f"parallel [{card}]: two gloo processes on one card, 2 entries "
          f"each (4x1, S={S2} N=4096), each fed only its rows "
          f"{[r['rows'] for r in rows]}: reassembled tiles vs the single "
          f"engine {e2:.3e} dB; collective save_state -> a ServingEngine "
          f"loads it; load_state(keep=[5, 0, 3]) on 6 streams carries dB "
          f"bit for bit, a live tick after", flush=True)

    # the sharded and single ticks in turns (host clock, synchronized)
    def tick_s(eng, k):
        now = now0 + (ticks + 40 + k) * 16_666_667
        t = time.perf_counter()
        eng.feed_batch(packets[k % ticks], now, now_ns=now)
        eng.tick(now_ns=now)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    engs = {"single": single, "4x1": eng41, "2x2": meshes[2][1]}
    times = {name: [] for name in engs}
    for k in range(20):
        for name, e in engs.items():
            times[name].append(tick_s(e, k))
    med = {n: statistics.median(v) * 1e3 for n, v in times.items()}
    print(f"parallel [{card}]: feed_batch + tick + synchronize at S={S} "
          f"N=4096, medians of 20 in turns on {where}: single "
          f"{med['single']:.3f} ms, 4x1 {med['4x1']:.3f} ms, 2x2 "
          f"{med['2x2']:.3f} ms (a virtual mesh on one card is not "
          f"expected to be faster; nothing claimed)", flush=True)

    # python -m waveform_tpu_torch.dryrun 4, in this process
    from waveform_tpu_torch.dryrun import dryrun
    print(f"parallel [{card}]: {dryrun(4)}", flush=True)
    return launched


# the kernel each size of the bench's sweep runs on an H100
BENCH_KERNELS = {1024: "K1-gen", 4096: "K1-gen", 16384: "K2", 32768: "K2",
                 65536: "K2"}


def phase_bench(card: str) -> None:
    """``python -m waveform_tpu_torch.bench`` at its defaults, in process:
    return 0, the headline JSON line, the gate under 1e-4 dB, no roofline
    share over 100%, one launch of the size's kernel a timed tick and no
    other kernel's."""
    from waveform_tpu_torch import bench
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main([])
    lines = out.getvalue().strip().splitlines() + \
        err.getvalue().strip().splitlines()
    for ln in lines:
        print(f"bench [{card}]: {ln}", flush=True)
    check(rc == 0, f"bench returned {rc}")
    head = json.loads(out.getvalue().strip().splitlines()[-1])
    check(head["metric"] == "4096pt_spectrum_frames_per_sec_per_chip"
          and head["value"] > 0, f"bench headline {head}")
    gate = re.search(r"oracle: ([0-9.e+-]+) ", err.getvalue())
    check(gate is not None and float(gate.group(1)) < 1e-4,
          f"bench gate {gate and gate.group(1)}")
    mfu = [ln for ln in lines if ln.startswith("# MFU")]
    sizes = sorted(int(re.search(r"N=(\d+) ", ln).group(1)) for ln in mfu)
    check(sizes == sorted(BENCH_KERNELS), f"bench sizes {sizes}")
    for ln in mfu:
        n = int(re.search(r"N=(\d+) ", ln).group(1))
        shares = [float(x) for x in re.findall(r"\(([0-9.]+)% of", ln)]
        check(len(shares) == 2 and max(shares) <= 100,
              f"bench N={n} shares {shares}")
        ticks = int(re.search(r"; (\d+) timed ticks", ln).group(1))
        launched = re.search(r"\[launches: ([^;]*);", ln).group(1)
        check(launched == f"{BENCH_KERNELS[n]} {ticks}" and f"] [{card}]"
              in ln, f"bench N={n}: launches {launched!r} in {ticks} ticks")


def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits (a bool tensor as it is)."""
    return t.view(torch.int32) if t.is_floating_point() else t


def graph_ms(fn) -> float:
    """``fn`` captured in a CUDA graph (as the tick captures it), its
    replay's device time on CUDA events (the device kept busy ahead)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_median_ms(graph.replay, busy_ahead=True)


def phase_tail(wt, exact_cuda, card: str, dev) -> None:
    """The spectrum tail's kernel pair (``kernels/tail_cuda.py``) at
    (65536, 32) and (4096, 256) on the benchmark's look (mono, 2
    channels, EMA), with every channel voiced and with channel 1 silent in
    every stream (the gate scans channel 0): bit for bit against
    ``spectrum_tail_ref`` over 4 ticks, two launches a call; then the
    pair, the gate alone and the fused tail alone against the plain
    version, each captured in a CUDA graph as the tick captures it, on
    the device's clock, beside the bytes these inputs need at 3.35 TB/s
    (inputs read once, outputs written once)."""
    from waveform_tpu_torch.dsp import spectrum as tspec
    from waveform_tpu_torch.kernels import tail_cuda
    for n, S in ((65536, 32), (4096, 256)):
        cfg = wt.resolve(wt.Settings(fft_size=n, enable_large_fft=True,
                                     window=wt.FFTWindow.HANN),
                         wt.AudioInfo(SR, 2))
        k = tail_cuda.tail_constants(cfg)
        C, O, nb = k.channels, k.outputs, n // 2
        slope, rolloff = tspec.tail_tables(cfg, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + n + S)
        state = tspec.init_state(cfg, S, dev)
        gravity = torch.from_numpy(tspec.gravity_pair(cfg, 1 / 60)).to(dev)
        active = torch.ones(S, dtype=torch.bool, device=dev)
        rms = torch.zeros(S, device=dev)
        for label, silent in (("voiced", False), ("channel 1 silent", True)):
            nz = torch.ones((S, C), dtype=torch.bool, device=dev)
            nz[:, C - 1] = not silent
            for t in range(4):
                mag = torch.rand((S, C, nb), generator=gen, device=dev) * 40.0
                mag[:, :, ::97] = 0.0
                old = state
                before = LAUNCHES["tail"]
                got = tail_cuda.spectrum_tail(
                    k, mag, nz, None, old.tsmooth, old.decibels,
                    old.last_silent, gravity, active, None, None, slope,
                    rolloff)
                check(LAUNCHES["tail"] == before + 2,
                      f"tail: {LAUNCHES['tail'] - before} launches")
                state = tspec.spectrum_tail_ref(cfg, mag, nz, None, old,
                                                gravity, active, rms, None,
                                                slope, rolloff)
                torch.cuda.synchronize()
                check(all(torch.equal(bits(a), bits(b)) for a, b in zip(
                    got, (state.tsmooth, state.decibels,
                          state.last_silent))),
                      f"tail ({n}, {S}) {label}: kernel vs plain version "
                      f"not bit for bit at tick {t}")

            def pair(stages=3):
                return tail_cuda.spectrum_tail(
                    k, mag, nz, None, old.tsmooth, old.decibels,
                    old.last_silent, gravity, active, None, None, slope,
                    rolloff, stages=stages)

            ms = [graph_ms(lambda: pair(st)) for st in (3, 1, 2)]
            ref_ms = graph_ms(lambda: tspec.spectrum_tail_ref(
                cfg, mag, nz, None, old, gravity, active, rms, None, slope,
                rolloff))
            # mag and the old tsmooth read, tsmooth and m_decibels written;
            # the gate reads channel 0 of the old m_decibels where a
            # channel is silent
            moved = 4 * S * nb * (3 * C + O + (1 if silent else 0))
            bound_us = moved / exact_cuda.HBM_PEAK_BYTES * 1e6
            print(f"tail [{card}]: (N, S) = ({n}, {S}) mono C={C}, {label}: "
                  f"bit for bit vs spectrum_tail_ref in 4 ticks, 2 launches "
                  f"a call; pair {ms[0] * 1e3:.1f} us (gate "
                  f"{ms[1] * 1e3:.1f}, fused {ms[2] * 1e3:.1f}), plain "
                  f"version {ref_ms * 1e3:.1f} us; bound "
                  f"{bound_us:.1f} us ({moved / 1e6:.2f} MB at 3.35 TB/s), "
                  f"{bound_us / (ms[0] * 1e3) * 100:.1f}% of it", flush=True)


def phase_ring(exact_cuda, card: str, dev) -> dict:
    """The rotating ring's push at the benchmark's shape in its three
    count forms, bit for bit against its plain version; its time beside
    the plain version's, the shifting push's and its bound; the pair
    kernels with and without the rows' heads.  Returns the push's record
    for the kernels line."""
    from waveform_tpu_torch.dsp import devring
    from waveform_tpu_torch.kernels import ring_cuda
    S, C, L, H = 32, 2, 65536, 1616
    rng = np.random.default_rng(SEED + 36)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    for form in ("host int", "0-d float", "[S] float"):
        buf, head_ref = rand(S, C, L), torch.from_numpy(
            rng.integers(0, L, (S, C)).astype(np.int32))
        buf_d, head = buf.to(dev), head_ref.to(dev)
        LAUNCHES.clear()
        for k in range(24):
            count = (0, 1, H, H + 5, 1024, 800)[k % 6]
            new = rand(S, C, H)
            if form == "host int":
                host = counts = count
            elif form == "0-d float":
                host = torch.tensor(float(count))
                counts = host.to(dev)
            else:
                host = torch.from_numpy(
                    rng.integers(-3, H + 8, S).astype(np.float32))
                counts = host.to(dev)
            ring_cuda.ring_push(buf_d, head, new.to(dev), counts)
            ring_cuda.ring_push_ref(buf, head_ref, new, host)
        torch.cuda.synchronize()
        check(fft_launches() == {"ring": 24},
              f"ring {form}: launches {fft_launches()} in 24 pushes")
        check(torch.equal(bits(buf_d.cpu()), bits(buf))
              and torch.equal(head.cpu(), head_ref),
              f"ring {form}: kernel vs ring_push_ref not bit for bit")
    # the benchmark's packet: 1024 samples a row, the 0-d count
    new = rand(S, C, H).to(dev)
    count = torch.tensor(1024.0, device=dev)
    ms = graph_ms(lambda: ring_cuda.ring_push(buf_d, head, new, count))
    plain_ms = cuda_median_ms(
        lambda: ring_cuda.ring_push_ref(buf_d, head, new, count))
    shifted = devring.DeviceRing(buf=buf_d)
    shift_ms = graph_ms(lambda: devring.push(shifted, new, count))
    moved = 2 * S * C * 1024 * 4           # the new samples read, written
    bound_ms = moved / exact_cuda.HBM_PEAK_BYTES * 1e3
    print(f"ring [{card}]: (S, C, L, H) = ({S}, {C}, {L}, {H}), host int, "
          f"0-d and [S] float counts: bit for bit vs ring_push_ref in 24 "
          f"pushes each, 1 launch a push; push of 1024 {ms * 1e3:.2f} us "
          f"(graph), plain version {plain_ms * 1e3:.1f} us, shifting push "
          f"{shift_ms * 1e3:.1f} us (graph); bound {bound_ms * 1e3:.2f} us "
          f"({moved / 1e6:.2f} MB at 3.35 TB/s)", flush=True)
    # the pair kernels with the rows' heads and without
    for name, fn, n, s_n in (("K2", exact_cuda.rfft_pair_mag3, 65536, 32),
                             ("K1-gen", exact_cuda.rfft_pair_mag_gen, 4096,
                              256)):
        x = (0.4 * rand(s_n, 2, n)).to(dev)
        heads = torch.from_numpy(
            rng.integers(0, n, (s_n, 2)).astype(np.int32)).to(dev)
        _, win = hann_pair(n, dev)
        t = {}
        for label, h in (("none", None), ("0", torch.zeros_like(heads)),
                         ("random", heads), ("none", None)):
            t.setdefault(label, []).append(
                graph_ms(lambda: fn(x, win, head=h)) * 1e3)
        print(f"ring [{card}]: {name} at (N, S) = ({n}, {s_n}) on the "
              f"device's clock: no head " + " / ".join(
                  f"{v:.1f}" for v in t["none"])
              + f" us, heads 0 {t['0'][0]:.1f} us, random heads "
              f"{t['random'][0]:.1f} us", flush=True)
    return {"name": "ring_push", "route": "cuda",
            "source": "waveform_tpu_torch/csrc/ring_push.cu",
            "replaces": "waveform_tpu/dsp/devring.py (a dynamic_slice)",
            "launches": 72, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "hbm",
            "library_ms": shift_ms}


def interp_gap(got, x, taps, weights) -> float:
    """The interp's largest error against float64, as a share of its
    bound: T products rounded once and summed in float32 in any order
    are off by at most (T + 1) * 2^-24 * sum|x * w|.  At most 1 where the
    kernel is right."""
    prod = x.double()[..., taps.long()] * weights.double()
    err = (got.double() - prod.sum(-1)).abs()
    bound = (taps.shape[1] + 1) * 2.0 ** -24 * prod.abs().sum(-1)
    return float((err / bound.clamp_min(1e-300)).max())


def phase_rebin(wt, exact_cuda, card: str, dev) -> list:
    """The rebin's pair (``kernels/rebin_cuda.py``) at the benchmark's two
    looks: the interp against its plain version (and float64) on a
    state's display channels as the tick hands them over (a channel
    slice in mono), the filter bit for bit against its plain version,
    each after a synchronize; their times on the device's clock beside
    the plain versions', the dense product (the one PyTorch call that
    computes the interp) and the byte bounds; the whole rebin through
    ``make_rebin_fn`` against its two plain forms.  Returns the kernels'
    records for the kernels line."""
    from waveform_tpu_torch.kernels import rebin_cuda
    from waveform_tpu_torch.rebin import apply
    from waveform_tpu_torch.rebin.filter import build_gauss_tables
    from waveform_tpu_torch.rebin.interp import build_interp_tables
    rng = np.random.default_rng(SEED + 37)
    records = []
    # the benchmark's two looks as the rebin sees them: (label, config,
    # streams S, dB channels O of the state, display channels D)
    looks = (
        ("studio16384", wt.Settings(
            fft_size=16384, enable_large_fft=True, width=800,
            channel_mode=wt.ChannelMode.STEREO,
            interp_mode=wt.InterpMode.LANCZOS,
            filter_mode=wt.FilterMode.GAUSS, filter_radius=1.5), 256, 2, 2),
        ("curve65536", wt.Settings(
            fft_size=65536, enable_large_fft=True, width=800,
            interp_mode=wt.InterpMode.CATROM), 32, 2, 1))
    for label, settings, S, O, D in looks:
        cfg = wt.resolve(settings, wt.AudioInfo(SR, 2))
        t = build_interp_tables(cfg)
        nb, (P, T) = cfg.num_bins, t.taps.shape
        state = torch.from_numpy(rng.uniform(-65.0, 0.0, (S, O, nb)).astype(
            np.float32)).to(dev)
        x = state[:, :D]
        taps = torch.from_numpy(t.taps).to(dev)
        taps64 = taps.long()
        w = torch.from_numpy(t.weights).to(dev)
        before = LAUNCHES["rebin"]
        got = rebin_cuda.rebin_interp(x, taps, w)
        torch.cuda.synchronize()
        check(LAUNCHES["rebin"] == before + 1, f"rebin {label}: launches")
        want = rebin_cuda.rebin_interp_ref(x, taps64, w)
        k_gap = interp_gap(got, x, taps, w)
        r_gap = interp_gap(want, x, taps, w)
        diff = float((got - want).abs().max())
        check(k_gap <= 1.0, f"rebin {label}: interp {k_gap:.3f} of its bound "
                            "off float64")
        imat = torch.from_numpy(apply._interp_matrix(t.taps, t.weights,
                                                     nb)).to(dev)
        ms = graph_ms(lambda: rebin_cuda.rebin_interp(x, taps, w))
        plain_ms = graph_ms(lambda: rebin_cuda.rebin_interp_ref(x, taps64, w))
        lib_ms = graph_ms(lambda: apply._rows_mm(x, imat))
        moved = rebin_cuda.interp_bytes(S * D, t.taps)
        bound_ms = moved / exact_cuda.HBM_PEAK_BYTES * 1e3
        print(f"rebin [{card}]: {label} interp [{S}, {D}, {nb}] -> {P} px, "
              f"T={T}: vs plain version max {diff:.2e} dB, vs float64 "
              f"{k_gap:.3f} of the T-term bound (plain version {r_gap:.3f}); "
              f"kernel {ms * 1e3:.2f} us, plain version "
              f"{plain_ms * 1e3:.1f} us, dense product {lib_ms * 1e3:.1f} us "
              f"(graph); bound {bound_ms * 1e3:.2f} us ({moved / 1e6:.2f} MB "
              f"at 3.35 TB/s)", flush=True)
        records.append({
            "name": f"rebin_interp.{label}", "route": "cuda",
            "source": "waveform_tpu_torch/csrc/rebin.cu",
            "replaces": "none (waveform_tpu/rebin/apply.py is jnp code)",
            "launches": 1, "max_abs_err": diff, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "hbm",
            "library_ms": lib_ms})
        if not apply.filters(cfg):
            continue
        gt = build_gauss_tables(cfg.settings.filter_radius, P)
        gw = torch.from_numpy(gt.weights).to(dev)
        gwl = [float(v) for v in gt.weights]
        gr = torch.from_numpy(gt.renorm).to(dev)
        studio, xs = cfg, x
        # the studio rebin's two plain forms, from the plain functions
        plain_forms = {
            "dense": lambda v, imat=imat, gwl=gwl, gr=gr:
                rebin_cuda.rebin_gauss_ref(apply._rows_mm(v, imat), gwl, gr),
            "gather": lambda v, taps64=taps64, w=w, gwl=gwl, gr=gr:
                rebin_cuda.rebin_gauss_ref(
                    rebin_cuda.rebin_interp_ref(v, taps64, w), gwl, gr)}
        a = rebin_cuda.rebin_gauss(got, gw, gr)
        torch.cuda.synchronize()
        b = rebin_cuda.rebin_gauss_ref(got, gwl, gr)
        check(torch.equal(bits(a), bits(b)),
              f"rebin {label}: filter vs rebin_gauss_ref not bit for bit")
        g_ms = graph_ms(lambda: rebin_cuda.rebin_gauss(got, gw, gr))
        chain_ms = graph_ms(lambda: rebin_cuda.rebin_gauss_ref(got, gwl, gr))
        moved = rebin_cuda.gauss_bytes(S * D, P)
        g_bound = moved / exact_cuda.HBM_PEAK_BYTES * 1e3
        print(f"rebin [{card}]: {label} filter [{S}, {D}, {P}], K={len(gwl)}: "
              f"bit for bit vs rebin_gauss_ref; kernel {g_ms * 1e3:.2f} us, "
              f"node chain {chain_ms * 1e3:.1f} us (graph); bound "
              f"{g_bound * 1e3:.2f} us ({moved / 1e6:.2f} MB)", flush=True)
        records.append({
            "name": f"rebin_gauss.{label}", "route": "cuda",
            "source": "waveform_tpu_torch/csrc/rebin.cu",
            "replaces": "none (waveform_tpu/rebin/apply.py is jnp code)",
            "launches": 1, "max_abs_err": 0.0, "ms": g_ms,
            "plain_ms": chain_ms, "bound_ms": g_bound, "bound_by": "hbm",
            "library_ms": None})
    # the whole rebin of the studio look: make_rebin_fn's kernels against
    # the plain forms (the dense product needs full-float32 matmuls)
    apply.check_full_f32_matmul("chip_smoke's dense rebin")
    forms = {"kernels": apply.make_rebin_fn(studio, apply_pixel_map=False,
                                            device=dev), **plain_forms}
    out = {name: fn(xs) for name, fn in forms.items()}
    torch.cuda.synchronize()
    gaps = {name: float((v - out["kernels"]).abs().max())
            for name, v in out.items() if name != "kernels"}
    check(all(g < 1e-4 for g in gaps.values()),
          f"rebin: the kernels against the plain forms {gaps} dB")
    times = {name: graph_ms(lambda fn=fn: fn(xs)) * 1e3
             for name, fn in forms.items()}
    print(f"rebin [{card}]: studio16384 whole rebin (graph): " + ", ".join(
        f"{k} {v:.1f} us" for k, v in times.items())
        + "; kernels vs dense / gather max " + " / ".join(
            f"{v:.2e}" for v in gaps.values()) + " dB", flush=True)
    return records


def kernel_label(fn: str) -> str:
    """A mangled kernel name as name<template arguments>."""
    m = re.search(r"_cu_[0-9a-f]{8}\d+((?:exact|spectrum_tail|ring|rebin)_"
                  r"[a-z0-9_]+?)(I.*?E)?E", fn)
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
    cuda_lib.build()
    secs["build"] = time.perf_counter() - t0
    print(f"build: {secs['build']:.2f} s "
          f"({cuda_lib.build_info['library']}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, capability {cap})", flush=True)
    for ln in cuda_lib.build_info.get("log", "").splitlines():
        if "entry function" in ln or "registers" in ln:
            print(f"build: {ln.strip()}", flush=True)
    # every FFT kernel runs its digit GEMMs on the int8 tensor cores; the
    # tail's kernels are elementwise
    sass = cuda_lib.sass_counts()
    for fn, c in sass.items():
        print(f"build: sass {kernel_label(fn)}: "
              + ", ".join(f"{op} {k}" for op, k in c.items()), flush=True)
    fft = [c for fn, c in sass.items() if "exact_" in fn]
    tail = [fn for fn in sass if "spectrum_tail_" in fn]
    ring = [fn for fn in sass if "ring_push" in fn]
    rebin = [fn for fn in sass if "rebin_" in fn]
    check(len(fft) == KERNELS and len(tail) == TAIL_KERNELS
          and len(ring) == RING_KERNELS and len(rebin) == REBIN_KERNELS
          and len(sass) == (KERNELS + TAIL_KERNELS + RING_KERNELS
                            + REBIN_KERNELS)
          and all(c["IMMA"] + c["IGMMA"] > 0 and c["IDP.4A"] == 0
                  for c in fft),
          f"FFT kernels not on the int8 tensor cores, or {KERNELS} FFT, "
          f"{TAIL_KERNELS} tail, {RING_KERNELS} ring and {REBIN_KERNELS} "
          f"rebin kernels expected: "
          f"{sass}")
    props = [ln for ln in cuda_lib.build_info.get("log", "").splitlines()
             if "spill" in ln]
    spills = [ln for ln in props if not re.search(
        r"\b0 bytes spill stores, 0 bytes spill loads", ln)]
    check(not spills, f"ptxas reports spills: {spills}")
    print(f"build: ptxas: {len(props)} functions, no spill stores or loads",
          flush=True)
    if sys.argv[1:] == ["tail"]:
        t0 = time.perf_counter()
        phase_tail(wt, exact_cuda, card, dev)
        print(f"seconds: build {secs['build']:.1f}, tail "
              f"{time.perf_counter() - t0:.1f}", flush=True)
        return
    if sys.argv[1:] == ["ring"]:
        t0 = time.perf_counter()
        record = phase_ring(exact_cuda, card, dev)
        print(f"seconds: build {secs['build']:.1f}, ring "
              f"{time.perf_counter() - t0:.1f}", flush=True)
        print(json.dumps({"kernels": [record]}))
        return
    if sys.argv[1:] == ["rebin"]:
        t0 = time.perf_counter()
        records = phase_rebin(wt, exact_cuda, card, dev)
        print(f"seconds: build {secs['build']:.1f}, rebin "
              f"{time.perf_counter() - t0:.1f}", flush=True)
        print(json.dumps({"kernels": records}))
        return

    # 3. kernel vs twin ---------------------------------------------------
    t0 = time.perf_counter()
    cases, worst = phase_kernel(dev, exact_cuda.rfft_pair_mag,
                                exact_cuda.rfft_pair_mag_ref, "K1-gen",
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
    counts, px_shape, peak_hz, e_cpu = drive_slice(wt, eng, cpu, packets,
                                                   now0)
    launches = counts.get("K1-gen", 0)
    check(counts == served_launches("K1-gen", ticks),
          f"launches {counts} in {ticks} ticks at "
          "N=4096: want K1-gen's and the ring's alone")
    gate = oracle_gate(wt, ServingEngine, 4096, 8, rng, now0)
    torch.cuda.synchronize()
    secs["slice"] = time.perf_counter() - t0
    print(f"slice: S={S} N=4096 800px Lanczos, {ticks} ticks, {launches} "
          f"K1-gen launches and {counts.get('ring', 0)} ring pushes, no "
          f"other kernel, pixels {px_shape} finite, "
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
        dev, exact_cuda.rfft_pair_mag3,
        exact_cuda.rfft_pair_mag3_ref, "K2",
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
    counts3, px3, peak3, e_cpu3 = drive_slice(wt, eng3, cpu3, packets3,
                                              now3)
    k2_launches = counts3.get("K2", 0)
    check(counts3 == served_launches("K2", ticks3),
          f"launches {counts3} in {ticks3} ticks at "
          "N=65536: want K2's and the ring's alone")
    gate3 = oracle_gate(wt, ServingEngine, 65536, ticks3, rng, now3)
    torch.cuda.synchronize()
    secs["slice3"] = time.perf_counter() - t0
    print(f"slice3: S={S3} N=65536 800px Lanczos (gather rebin), {ticks3} "
          f"ticks, {k2_launches} K2 launches and {counts3.get('ring', 0)} "
          f"ring pushes, no other kernel, pixels "
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
                wt, eng_p, cpu_p, pk, now_p)
            k3_p = counts_p.get("K3", 0)
            check(counts_p == only("K3", ticks),
                  f"path {path}: launches {counts_p} "
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
        counts_c = drive_slice(wt, eng_c, cpu_c, pk_c, now_c)
        check(counts_c[0] == {}, f"path c kernel "
              f"launches {counts_c[0]}")
        gate_c = oracle_gate(wt, ServingEngine, 800, 2, rng, now_c)
    torch.cuda.synchronize()
    secs["slice_small"] = time.perf_counter() - t0
    print(f"slice_small: path c (auto FFT size) S={S} N=800 800px Lanczos, "
          f"{ticks} ticks, exact kernel launches "
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

    # 13.-15. test K1-gen at sizes the packaged H100 plan table sends to
    # K2 (8192, 16384): pinned to split 2, as N=32768 always was
    with env("WAVEFORM_TPU_STAGE1_SPLIT", "2"):
        # 13. kernel_gen: K1-gen vs twin, float64, K2 and K1 ----------------
        t0 = time.perf_counter()
        sizes_g = (3072, 5120, 6144, 7168, 8192, 9216, 16384, 31744)
        check(all(exact_cuda.stage1_split(n) == 2 for n in sizes_g),
              "K1-gen sizes route to split 2")
        cases_g, worst_g = phase_kernel(
            dev, exact_cuda.rfft_pair_mag,
            exact_cuda.rfft_pair_mag_ref, "K1-gen", sizes_g, (1, 7, 64),
            SEED + 7, versus=(exact_cuda.rfft_pair_mag3, (8192, 16384)))
        cases_s, worst_s = phase_kernel(
            dev, exact_cuda.rfft_pair_mag,
            exact_cuda.rfft_pair_mag_ref, "K1-gen", (6144,), (S,),
            SEED + 8)
        with env("WAVEFORM_TPU_STAGE1_SPLIT", "2"):
            check(exact_cuda.supports(32768) and exact_cuda.stage1_split(32768)
                  == 2, "N=32768 under STAGE1_SPLIT=2")
            cases_32, worst_32 = phase_kernel(
                dev, exact_cuda.rfft_pair_mag,
                exact_cuda.rfft_pair_mag_ref, "K1-gen", (32768,),
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
        for n_g, s_g, ticks_g, n_cpu in ((6144, S, ticks, 4),
                                         (16384, 64, 21, 2)):
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
                wt, eng_g, cpu_g, pk_g, now_g)
            gen_g = counts_g.get("K1-gen", 0)
            check(counts_g == served_launches("K1-gen", ticks_g),
                  f"N={n_g}: launches {counts_g} in "
                  f"{ticks_g} ticks: want K1-gen's and the ring's alone")
            gate_g = oracle_gate(wt, ServingEngine, n_g, ticks_g, rng, now_g)
            print(f"slice_gen: S={s_g} N={n_g} 800px Lanczos, {ticks_g} "
                  f"ticks, "
                  f"{gen_g} K1-gen launches and "
                  f"{counts_g.get('ring', 0)} ring pushes, no other kernel, "
                  f"pixels {px_g} finite, silent stream at DB_MIN, peak "
                  f"{peak_g:.2f} Hz, card vs CPU port ({n_cpu} streams) "
                  f"{e_cpu_g:.2e} dB, oracle gate {gate_g:.2e} dB (< 1e-4)",
                  flush=True)
            if n_g == 6144:
                gen_slice = (eng_g, pk_g, now_g, gen_g)
            del eng_g, cpu_g
        torch.cuda.synchronize()
        secs["slice_gen"] = time.perf_counter() - t0

        # 15. times_gen -----------------------------------------------------
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
        eng_g, pk_g, now_g, gen_launches = gen_slice
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
    # K1-df at 16384, which the packaged H100 table sends to K2: pinned
    with env("WAVEFORM_TPU_STAGE1_SPLIT", "2"):
        cases_df, worst_df = phase_df(
            exact_cuda, dev,
            [("router", n, (1, 7, 64)) for n in sizes_df]
            + [("router", 4096, (S,))], SEED + 11)
    check(all(exact_cuda.stage1_split(n) == 3 for n in (32768, 65536)),
          "K2-df sizes route to split 3")
    cases_k2, worst_k2 = phase_df(
        exact_cuda, dev,
        [("k2", 8192, (1, 7, 64)), ("router", 32768, (1, 7, 64)),
         ("router", 65536, (1, 7, 32))], SEED + 15)
    cases_df += cases_k2
    worst_df = {k: max(v, worst_k2[k]) for k, v in worst_df.items()}
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
                (cfg, S, ticks, 4, "K1-df"),
                (cfg3, S3, ticks3, 2, "K2-df")):
            n_d = cfg_d.fft_size
            eng_d = ServingEngine(cfg_d, s_d, device="cuda")
            cpu_d = ServingEngine(cfg_d, n_cpu, device="cpu")
            pk_d = [feed_signal(rng, s_d, k) for k in range(ticks_d)]
            now_d = time.monotonic_ns()
            counts_d, px_d, peak_d, e_cpu_d = drive_slice(
                wt, eng_d, cpu_d, pk_d, now_d)
            want = served_launches(counter, ticks_d)
            check(counts_d == want, f"df N={n_d}: launches {counts_d}, "
                  f"want {want}")
            gate_d = oracle_gate(wt, ServingEngine, n_d, ticks_d, rng, now_d)
            df_slices[n_d] = (eng_d, pk_d, now_d, counts_d)
            print(f"slice_df: S={s_d} N={n_d} 800px Lanczos, "
                  f"KERNEL_TWIDDLE=df, {ticks_d} ticks, "
                  f"{counter} "
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
        # K1-df at 16384 (the packaged table's K2 size): pinned to split 2
        with env("WAVEFORM_TPU_STAGE1_SPLIT", "2" if n < 32768 else None):
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
    for cell in (("slice", dict(fft_size=4096), 2, {}, S, "K1-gen"),
                 ("slice3", large, 2, {}, S3, "K2"),
                 ("slice_df", dict(fft_size=4096), 2, df_env, S,
                  "K1-df"),
                 ("slice3_df", large, 2, df_env, S3, "K2-df"),
                 ("path a", dict(fft_size=4096), 2,
                  {"WAVEFORM_TPU_EXACT_FUSED": "never"}, S, "K3"),
                 ("path c", dict(auto_fft_size=True), 2, {}, S, None)):
        turns, busy, busy_us, ops, host = phase_graph(
            wt, ServingEngine, profiler, rng, cell)
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
    check(mb.kernels_per_replay[("mb", 4, True)]
          == replay_launches("K1-gen", 4),
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
    LAUNCHES.clear()
    pxs = bulk.tick_many(bulk_in)
    torch.cuda.synchronize()
    counts_b = fft_launches()
    check(counts_b == served_launches("K1-gen", T),
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

    # 24. waveform: DeviceWaveformEngine at S=256 ---------------------------
    t0 = time.perf_counter()
    phase_waveform(wt, profiler, card, dev)
    secs["waveform"] = time.perf_counter() - t0

    # 25. engine: WaveformEngine in its three modes ------------------------
    t0 = time.perf_counter()
    phase_engine(wt, card)
    secs["engine"] = time.perf_counter() - t0

    # 26. multi: a MultiEngine scene of 304 streams -------------------------
    t0 = time.perf_counter()
    phase_multi(wt, profiler, card)
    secs["multi"] = time.perf_counter() - t0

    # 27. bus: an OutputBus with 500 consumers -------------------------------
    # its 8192 and 16384 looks test K1-gen, which the packaged H100 table
    # sends to K2: a plan file pins them to split 2 (the variable cannot:
    # its N=65536 subscriber runs K2)
    t0 = time.perf_counter()
    with plan_file({8192: 2, 16384: 2}):
        phase_bus(wt, profiler, card)
    secs["bus"] = time.perf_counter() - t0

    # 28. plans: the tuner, the packaged table and the route it steers ------
    t0 = time.perf_counter()
    phase_plans(wt, card)
    secs["plans"] = time.perf_counter() - t0

    # 29. matmul: the GEMM FFT backend at the headline -----------------------
    t0 = time.perf_counter()
    phase_matmul(wt, card)
    secs["matmul"] = time.perf_counter() - t0

    # 30. rfft_fn: a caller's FFT captured in the tick ------------------------
    t0 = time.perf_counter()
    phase_rfft_fn(wt, card)
    secs["rfft_fn"] = time.perf_counter() - t0

    # 31. demo: python -m waveform_tpu_torch.demo on a WAV --------------------
    t0 = time.perf_counter()
    phase_demo(card)
    secs["demo"] = time.perf_counter() - t0

    # 32. warm: wisdom.warm against a cold first tick ------------------------
    t0 = time.perf_counter()
    phase_warm(card)
    secs["warm"] = time.perf_counter() - t0

    # 33. parallel: the sharded engines over a 4-entry mesh -------------------
    t0 = time.perf_counter()
    par = phase_parallel(wt, card)
    secs["parallel"] = time.perf_counter() - t0

    # 34. bench: python -m waveform_tpu_torch.bench at its defaults -----------
    t0 = time.perf_counter()
    phase_bench(card)
    secs["bench"] = time.perf_counter() - t0
    print(f"bench [{card}]: {secs['bench']:.1f} s", flush=True)

    # 35. tail: the spectrum tail's kernel pair -------------------------------
    t0 = time.perf_counter()
    phase_tail(wt, exact_cuda, card, dev)
    secs["tail"] = time.perf_counter() - t0

    # 36. ring: the rotating ring's push --------------------------------------
    t0 = time.perf_counter()
    ring_record = phase_ring(exact_cuda, card, dev)
    secs["ring"] = time.perf_counter() - t0

    # 37. rebin: the rebin's interp and filter kernels ------------------------
    t0 = time.perf_counter()
    rebin_records = phase_rebin(wt, exact_cuda, card, dev)
    secs["rebin"] = time.perf_counter() - t0

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
            ("exact_mag3", "exact_mag3", 825, 65536, 32, k2_launches,
             (*mag3_row, libs["exact_mag3"])),
            ("exact_cfft", "exact_cfft", 479, 4096, S, launches_c,
             (*cfft_row, libs["exact_cfft"])),
            ("exact_mag_gen", "exact_mag_gen", 525, 6144, S, gen_launches,
             gen[6144]),
            ("exact_mag_df", "exact_mag_gen", 525, 4096, S,
             df_slices[4096][3].get("K1-df", 0),
             df_rows[4096]),
            ("exact_mag3_df", "exact_mag3", 825, 65536, 32,
             df_slices[65536][3].get("K2-df", 0),
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
        # the parallel phase's launches (its own run, counts zeroed before)
        records[-1]["launches_parallel"] = {
            "exact_mag": par["k1_gen_4x1"] + par["k1_gen_2x2"],
            "exact_mag3": par["k2_4x1"], "exact_cfft": par["k3_4x1"]}.get(
                name, 0)
        print(f"bound: {name} at (N, S) = ({n}, {s_n}): kernel "
              f"{row[0] * 1e3:.1f} us, twin {row[1] * 1e3:.1f} us, library "
              f"{lib * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us ({b_by})",
              flush=True)
    records.append(ring_record)
    records += rebin_records
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
