"""Drive the PyTorch port's spectrum serving path once on an NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device  — a CUDA device of compute capability 9.0; prints its name and
   power limit as nvidia-smi reports them;
2. build   — the exact |rFFT| kernel compiled from ``waveform_tpu_torch/
   csrc`` with nvcc;
3. kernel  — the kernel against its plain PyTorch twin and float64 numpy at
   N in {1024, 2048, 4096}, S in {1, 7, 256}, Hann df32 window and none,
   with a silent stream, a silent channel, a 1e20 stream and a NaN stream;
4. slice   — ``ServingEngine`` at the headline configuration (stereo 48 kHz,
   N=4096, Hann, 800-px Lanczos rebin, S=256) fed a 440 Hz tone plus noise
   for 8 ticks: one kernel launch per tick, finite pixels, a silent stream
   at exactly DB_MIN, agreement with the CPU port on the first streams, and
   the bench's accuracy gate against the float64 oracle;
5. times   — kernel, twin and full tick at S=256, N=4096 on the card's
   clock (CUDA events, median of 30 after warmup).

The last two lines are the kernels' JSON record and the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SR, HOP = 48000, 800
TOL = 2.5e-7
SEED = 0


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


def cuda_median_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of per-call CUDA-event times after warmup, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernel(exact_cuda, dev):
    """Kernel vs twin vs float64 over the size/stream/window matrix."""
    rng = np.random.default_rng(SEED)
    worst_twin = worst_f64 = 0.0
    cases = 0
    for n in exact_cuda.SIZES:
        for S in (1, 7, 256):
            for windowed in (True, False):
                x = (0.5 * rng.standard_normal((S, 2, n))).astype(np.float32)
                x[0, 0] += np.sin(2 * np.pi * 440.0 * np.arange(n) / SR)
                bad = ()
                if S >= 7:
                    x[1] = 0.0                   # silent stream
                    x[2, 1] = 0.0                # silent channel
                    x[3] = 1e20 * rng.standard_normal((2, n))
                    x[4, 0, 11] = np.nan
                    bad = (3, 4)
                good = [s for s in range(S) if s not in bad]
                if windowed:
                    w64, win = hann_pair(n, dev)
                else:
                    w64, win = np.ones(n), None
                xd = torch.from_numpy(x).to(dev)
                mag, nz = exact_cuda.rfft_pair_mag(xd, win)
                torch.cuda.synchronize()
                ref, nz_ref = exact_cuda.rfft_pair_mag_ref(xd, win)
                torch.cuda.synchronize()
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
                worst_twin = max(worst_twin, e_twin)
                worst_f64 = max(worst_f64, e_f64)
                cases += 1
    return cases, worst_twin, worst_f64


def feed_signal(rng, S: int, k: int) -> np.ndarray:
    """[S, 2, HOP]: a 440 Hz tone plus noise; the last stream is silent."""
    t = (np.arange(HOP) + k * HOP) / SR
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(
        (S, 2, HOP))
    x[-1] = 0.0
    return x.astype(np.float32)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")

    # 1. device -----------------------------------------------------------
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    check(cap == (9, 0), f"compute capability {cap}, want (9, 0)")
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)              # nvidia-smi's name, power.limit

    import waveform_tpu_torch as wt
    from waveform_tpu_torch.kernels import exact_cuda
    from waveform_tpu_torch.runtime.serving import ServingEngine

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    exact_cuda.build()
    regs = [ln.split(":", 1)[1].strip()
            for ln in exact_cuda.build_info.get("log", "").splitlines()
            if "registers" in ln]
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({exact_cuda.build_info['library']}; ptxas: {regs}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, capability "
          f"{cap})", flush=True)

    # 3. kernel vs twin ---------------------------------------------------
    cases, e_twin, e_f64 = phase_kernel(exact_cuda, dev)
    torch.cuda.synchronize()
    print(f"kernel: {cases} cases, max|d|/max|ref| vs twin {e_twin:.3e}, "
          f"vs float64 {e_f64:.3e} (bound {TOL}); nz exact; 1e20/NaN "
          "streams isolated", flush=True)

    # 4. slice ------------------------------------------------------------
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
    exact_cuda.launches = 0
    for k, x in enumerate(packets):
        now = now0 + k * 16_666_667
        eng.feed_batch(x, now, now_ns=now)
        eng.tick(now_ns=now)
    torch.cuda.synchronize()
    launches = exact_cuda.launches
    check(launches == ticks, f"{launches} kernel launches in {ticks} ticks")
    for k, x in enumerate(packets):
        now = now0 + k * 16_666_667
        cpu.feed_batch(np.concatenate([x[:3], x[-1:]]), now, now_ns=now)
        cpu.tick(now_ns=now)
    px = eng.read_pixels()
    db = eng.read_decibels()
    check(px.shape == (S, 1, 800) and np.isfinite(px).all(), "pixels")
    check((db[-1] == np.float32(wt.DB_MIN)).all(), "silent stream dB")
    check(bool(eng.last_silent[-1]) and not eng.last_silent[:-1].any(),
          "silence latch")
    peak_hz = int(np.argmax(db[0, 0])) * SR / cfg.fft_size
    check(abs(peak_hz - 440.0) < SR / cfg.fft_size, f"peak at {peak_hz} Hz")
    db_cpu = cpu.read_decibels()
    ref = db_cpu[:3]
    vis = ref > -120.0
    e_cpu = float(np.abs(db[:3][vis] - ref[vis]).max())
    check(e_cpu < 1e-4, f"card vs CPU port {e_cpu} dB")
    check(np.array_equal(db[-1], db_cpu[-1]), "silent stream vs CPU port")

    # the bench's accuracy gate: TSmoothing NONE, one noise window in the
    # ring against the float64 oracle, bins above -120 dBFS
    gcfg = wt.resolve(wt.Settings(fft_size=4096, width=800,
                                  window=wt.FFTWindow.HANN,
                                  temporal_smoothing=wt.TSmoothingMode.NONE),
                      wt.AudioInfo(SR, 2))
    geng = ServingEngine(gcfg, 2, device="cuda")
    for k in range(8):
        now = now0 + k * 16_666_667
        geng.feed_batch(rng.uniform(-0.5, 0.5, (2, 2, HOP)).astype(
            np.float32), now, now_ns=now)
        geng.tick(now_ns=now)
    window = geng.ring.buf[0].cpu().numpy().astype(np.float64)
    want, _ = wt.oracle.spectrum_frame(window, None, gcfg, dt=1 / 60)
    got = geng.read_decibels()[0]
    gvis = want > -120.0
    gate = float(np.abs(got[gvis] - want[gvis]).max())
    check(gate < 1e-4, f"accuracy gate {gate} dB")
    torch.cuda.synchronize()
    print(f"slice: S={S} N=4096 800px Lanczos, {ticks} ticks, {launches} "
          f"kernel launches, pixels {px.shape} finite, silent stream at "
          f"DB_MIN, peak {peak_hz:.1f} Hz, card vs CPU port {e_cpu:.2e} dB, "
          f"oracle gate {gate:.2e} dB (< 1e-4), assembler "
          f"{'native' if eng._native is not None else 'python'}", flush=True)

    # 5. times ------------------------------------------------------------
    xt = (0.5 * np.random.default_rng(SEED + 2).standard_normal(
        (S, 2, 4096))).astype(np.float32)
    xd = torch.from_numpy(xt).to(dev)
    _, win = hann_pair(4096, dev)
    mag, _ = exact_cuda.rfft_pair_mag(xd, win)
    ref_mag, _ = exact_cuda.rfft_pair_mag_ref(xd, win)
    max_abs = float((mag - ref_mag).abs().max())
    k_ms = cuda_median_ms(lambda: exact_cuda.rfft_pair_mag(xd, win))
    p_ms = cuda_median_ms(lambda: exact_cuda.rfft_pair_mag_ref(xd, win))
    k = [ticks]

    def one_tick():
        now = now0 + k[0] * 16_666_667
        eng.feed_batch(packets[k[0] % ticks], now, now_ns=now)
        eng.tick(now_ns=now)
        k[0] += 1

    t_ms = cuda_median_ms(one_tick)
    print(f"times [{card}]: kernel {k_ms * 1e3:.1f} us, twin "
          f"{p_ms * 1e3:.1f} us at S={S} N=4096; full tick (feed_batch + "
          f"tick) {t_ms * 1e3:.1f} us = {S / (t_ms * 1e-3):,.0f} frames/s",
          flush=True)

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    print(json.dumps({"kernels": [{
        "name": "exact_mag", "route": "cuda",
        "source": "waveform_tpu_torch/csrc/exact_mag.cu",
        "replaces": "waveform_tpu/kernels/exact_pallas.py:525",
        "launches": launches, "max_abs_err": max_abs,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
