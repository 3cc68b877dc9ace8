"""The port's benchmark harness: spectrum frames per second on the card.

The PyTorch counterpart of ``waveform_tpu/bench.py``:

    python -m waveform_tpu_torch.bench [--streams 256] [--fft 4096]
        [--width 800] [--scan 128] [--reps 10] [--warmup 2]
        [--sizes 1024,16384,32768,65536] [--seed 0] [--device cuda]

Headline metric: N-point spectrum frames processed per second per card,
one frame being one stream's full tick (device ring push, the exact
|rFFT| with its df32 window, magnitude tail, EMA, silence gating, dBFS,
the log-axis Lanczos rebin to ``--width`` pixels), S streams at a time.

Method, after FFTW's self-benchmark (inputs made in-process, throughput
measured):

* The tick (:func:`make_bench_tick`) is captured once as a CUDA graph
  (``runtime/graphs.GraphTick``, the engine's own capture) and a dispatch
  replays it ``--scan`` times in a row with no host read, state threaded
  in place.  One tick is captured, not the T-tick loop: a replay's
  enqueue (tens of µs) stays under the tick's device time, so the card
  never waits on the host, and each replay is the graph the engine
  serves.
* Fresh audio, uniform in [-0.5, 0.5), is drawn on the card inside every
  captured tick from a ``torch.Generator`` seeded from ``--seed`` and
  registered with the graph; two replays are checked to draw different
  audio.  Nothing crosses to or from the host in a timed round.
* Each round is timed with CUDA events, and the best of the rounds is
  reported (FFTW's ``time_min``).
* The accuracy gate (:func:`accuracy_gate`) runs first on the ring's
  window after the timed rounds: max |dB err| against the float64 oracle
  (``dsp/oracle.py``) on bins above -120 dBFS must stay under 1e-4, with
  the relative L2 beside it, or no throughput is reported.
* Roofline per size: the hand kernel's int8 operations and compulsory
  bytes are static (``kernels/exact_cuda.kernel_cost``), so each size
  reports its int8 TOP/s and GB/s against the H100's peaks
  (``exact_cuda.INT8_PEAK_OPS``, ``HBM_PEAK_BYTES``) and which binds.
  Each size runs the kernel that the router picks (on an H100 the
  packaged plan sends 1024 and 4096 to K1-gen, 16384-65536 to K2).

stdout is one JSON line, ``{"metric": "<N>pt_spectrum_frames_per_sec_per_chip",
"value", "unit": "frames/s", "vs_baseline"}``: ``vs_baseline`` divides by
15,360 frames/s, 256 streams served at 60 frames/s each (the serving need
of ``PERF.md`` section 2), not by the target of ``BASELINE.json``, which
is a number for a TPU.  stderr holds the ``# MFU`` lines and one
summary line (device-only tick latency, the meter and waveform engines,
the 1x1-mesh sharded check, the host-inclusive serving tick and the
``microbatch="auto"`` engine), each naming the card and its power limit.

The bench runs on the card; ``--device cpu`` runs it on the CPU (the
kernels' plain twins, for a smoke run), and without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

SR = 48000
# 256 streams at 60 frames/s each: the frames/s a card must serve
BASELINE_FPS = 256 * 60.0


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (the
    CUDA name alone when it cannot be asked), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader",
                            f"--id={dev.index or 0}"],
                           capture_output=True, text=True, timeout=60,
                           check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(dev: torch.device, fn) -> float:
    """Seconds that ``fn()`` takes: CUDA events around it on the card
    (the device's clock, from the first queued op to the last), the host
    clock on the CPU."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def build_cfg(n: int, width: int):
    """The bench's configuration at FFT size ``n``: stereo 48 kHz, Hann,
    Lanczos rebin to ``width`` pixels, the large-FFT sizes enabled."""
    from . import AudioInfo, FFTWindow, InterpMode, Settings, resolve
    return resolve(Settings(fft_size=n, width=width, window=FFTWindow.HANN,
                            interp_mode=InterpMode.LANCZOS,
                            enable_large_fft=True), AudioInfo(SR, 2))


def make_bench_tick(cfg, num_streams: int, device="cuda"):
    """The bench's tick body at ``cfg`` for ``num_streams`` streams:
    ``bench_tick(ring, state, new) -> pixels`` pushes one hop of ``new``
    [S, 2, hop] into the ring, runs the spectrum step on the window (every
    stream active, no normalization, ``dt`` = 1/60 s) into ``state`` in
    place and returns the rebinned dBFS [S, D, width], in natural bin
    order (the JAX bench's ``push`` -> step -> ``rebin(display_decibels)``;
    its timed dispatch keeps their mean)."""
    from .core.device import checked_device
    from .dsp.devring import push
    from .dsp.spectrum import display_decibels, gravity_pair, \
        make_spectrum_step
    from .rebin.apply import make_rebin_fn
    from .runtime.serving import assign
    dev = checked_device(device, "make_bench_tick")
    step = make_spectrum_step(cfg, device=dev)
    rebin = make_rebin_fn(cfg, apply_pixel_map=False, device=dev)
    hop = int(SR / cfg.fps)
    dt = torch.from_numpy(gravity_pair(cfg, 1 / 60)).to(dev)
    active = torch.ones(num_streams, dtype=torch.bool, device=dev)
    rms = torch.zeros(num_streams, dtype=torch.float32, device=dev)

    def bench_tick(ring, state, new):
        push(ring, new, hop)
        assign(state, step(ring.buf, state, dt, active, rms))
        return rebin(display_decibels(cfg, state))

    return bench_tick


class Dispatch:
    """S streams of ``cfg`` on ``dev``: a ring, a state and the captured
    tick (draw fresh audio on the device, then :func:`make_bench_tick`'s
    body, then the pixels' mean).  ``run(T)`` replays it T times."""

    def __init__(self, cfg, s: int, dev: torch.device, seed: int):
        from .dsp.devring import init_ring
        from .dsp.spectrum import init_state
        from .runtime.graphs import GraphTick
        self.dev = dev
        self.ring = init_ring(s, 2, cfg.fft_size, dev)
        self.state = init_state(cfg, s, dev)
        self.new = torch.empty((s, 2, int(SR / cfg.fps)), dtype=torch.float32,
                               device=dev)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        body = make_bench_tick(cfg, s, dev)

        def tick():
            torch.rand(self.new.shape, generator=self.gen, device=dev,
                       out=self.new)
            self.new.sub_(0.5)
            return body(self.ring, self.state, self.new).mean()

        self.tick = GraphTick(tick, dev, generators=(self.gen,))

    def run(self, ticks: int):
        out = None
        for _ in range(ticks):
            out = self.tick()
        return out

    def check_draws(self) -> None:
        """Two ticks must draw different audio (a generator the graph did
        not register would repeat its draw at every replay)."""
        self.tick()
        a = self.new.clone()
        self.tick()
        if torch.equal(a, self.new):
            raise RuntimeError("two ticks drew the same audio: the tick's "
                               "generator does not advance")


def measure(cfg, s: int, ticks: int, reps: int, warmup: int,
            dev: torch.device, seed: int, rounds: int = 3) -> dict:
    """Best-of-``rounds`` throughput of ``reps`` dispatches of ``ticks``
    ticks at (cfg, s): ``elapsed`` (s, the best round), the
    :class:`Dispatch` (its ring holds the last window) and the kernel
    launches over the timed rounds, a ``Counter`` by kernel name."""
    from .kernels.cuda_lib import LAUNCHES
    d = Dispatch(cfg, s, dev, seed)
    for _ in range(max(warmup, 1)):
        d.run(ticks)
    d.check_draws()
    sync(dev)
    before = LAUNCHES.copy()
    elapsed = min(timed(dev, lambda: [d.run(ticks) for _ in range(reps)])
                  for _ in range(rounds))
    return {"elapsed": elapsed, "dispatch": d, "timed_ticks":
            rounds * reps * ticks,
            "launches": LAUNCHES - before}


def accuracy_gate(cfg, window: np.ndarray, device="cuda"
                  ) -> tuple[float, float]:
    """(max |dB err|, relative L2 error) of the port's spectrum of one
    stream's ``window`` [C, N] against the float64 oracle, over the bins
    the oracle puts above -120 dBFS, with temporal smoothing off (the JAX
    bench's gate, ``waveform_tpu/bench.py:253-276``)."""
    from . import TSmoothingMode, oracle, resolve
    from .core.device import checked_device
    from .dsp.spectrum import display_decibels, init_state, \
        make_spectrum_step
    dev = checked_device(device, "accuracy_gate")
    acc = resolve(dataclasses.replace(
        cfg.settings, temporal_smoothing=TSmoothingMode.NONE), cfg.audio)
    window = np.asarray(window, np.float64)
    want, _ = oracle.spectrum_frame(window, None, acc, dt=1 / 60)
    step = make_spectrum_step(acc, device=dev)
    st = step(torch.from_numpy(window[None].astype(np.float32)).to(dev),
              init_state(acc, 1, dev), 1 / 60,
              torch.ones(1, dtype=torch.bool, device=dev),
              torch.zeros(1, dtype=torch.float32, device=dev))
    got = display_decibels(acc, st)[0].cpu().numpy().astype(np.float64)
    vis = want > -120.0
    err = got[vis] - want[vis]
    return (float(np.abs(err).max()),
            float(np.linalg.norm(err) / max(np.linalg.norm(want[vis]),
                                            1e-30)))


def hand_kernel(n: int, s: int):
    """(``exact_cuda.kernel_cost`` of the hand kernel that a tick of S
    stereo streams at size n launches, or None, and what runs instead)."""
    from .dsp.spectrum import resolve_fft_backend
    from .kernels import exact_cuda, exactfft
    backend = resolve_fft_backend()
    if backend != "exact":
        return None, f"the {backend} FFT backend"
    if exact_cuda.kernel_would_run(n):
        return exact_cuda.kernel_cost(n, s), ""
    if exactfft.use_real_split(n):
        return None, "the real-split lowering in torch ops"
    if exact_cuda.supports_cfft(n) and exact_cuda.enabled():
        return exact_cuda.kernel_cost(n, s, "cfft"), ""
    return None, "the digit lowering in torch ops"


def roofline(cfg, s: int, ticks_per_sec: float) -> tuple[str, dict]:
    """The hand kernel's int8 TOP/s and the tick's GB/s against the H100's
    peaks, from the kernel's static cost plus the engine's compulsory
    bytes outside it (ring read, shift and write, EMA and display state
    read and write, rebin out; f32), and which binds; "serial" when
    neither is at 40% of its peak.  Returns (text, {"int8": share,
    "hbm": share}) with the shares in percent ({} without a kernel)."""
    from .kernels.exact_cuda import HBM_PEAK_BYTES, INT8_PEAK_OPS
    n = cfg.fft_size
    c, instead = hand_kernel(n, s)
    if c is None:
        return f"no hand kernel ({instead}): roofline n/a", {}
    nbins, d = n // 2, cfg.display_channels
    other = (3 * s * 2 * n + 4 * s * d * nbins + s * d * cfg.width) * 4
    tops = c["int8_ops"] * ticks_per_sec / 1e12
    gbs = (c["hbm_bytes"] + other) * ticks_per_sec / 1e9
    int8_u = 100 * tops * 1e12 / INT8_PEAK_OPS
    hbm_u = 100 * gbs * 1e9 / HBM_PEAK_BYTES
    if max(int8_u, hbm_u) < 40:
        binds = ("serial (int8 and HBM both under 40%: the ops between "
                 "the GEMMs and the per-tick launches)")
    else:
        binds = "int8" if int8_u >= hbm_u else "HBM"
    return (f"{tops:.3f} int8 TOP/s ({int8_u:.2f}% of "
            f"{INT8_PEAK_OPS / 1e12:.0f}) | {gbs:.1f} GB/s ({hbm_u:.2f}% of "
            f"{HBM_PEAK_BYTES / 1e9:.0f}) | binds: {binds} "
            f"[{c['kernel']} split={c['split']} twiddle={c['twiddle']}]",
            {"int8": int8_u, "hbm": hbm_u})


def mfu_line(cfg, s: int, m: dict, ticks_per_sec: float, card: str) -> str:
    """One ``# MFU`` line: the roofline, each exact kernel's launches over
    the timed ticks, frames/s and the card."""
    from .kernels.exact_cuda import KERNELS
    text, _ = roofline(cfg, s, ticks_per_sec)
    launched = ", ".join(f"{k} {m['launches'][k]}" for k in KERNELS.values()
                         if m["launches"][k]) or "none"
    return (f"# MFU N={cfg.fft_size} S={s}: {text} [launches: {launched}; "
            f"{m['timed_ticks']} timed ticks] [{s * ticks_per_sec:,.0f} "
            f"frames/s] [{card}]")


def device_latency(d: Dispatch, n: int = 20) -> tuple[float, float]:
    """(p50, p99) ms of one tick from replay to completion on the host's
    clock: on-device audio, no upload."""
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        d.run(1)
        sync(d.dev)
        lat.append(time.perf_counter() - t0)
    return (float(np.percentile(lat, 50)) * 1e3,
            float(np.percentile(lat, 99)) * 1e3)


def meter_fps(s: int, ticks: int, dev: torch.device, seed: int) -> tuple:
    """Device-only meter frames/s at S streams (the default meter at
    ``meter_buf`` 100 ms), DIFFERENCED: replays of one captured meter tick
    (draw, ring push, the serving meter step) timed at ``ticks`` and at
    33·``ticks`` ticks, best of 5 each, and the 32·``ticks`` between them
    divided out, which cancels the fixed cost of a timed block.  Returns
    (frames/s, the meter config)."""
    from . import AudioInfo, DisplayMode, Settings, resolve
    from .dsp.devring import init_ring, push
    from .dsp.meter import init_meter_state, make_meter_serving_step
    from .dsp.spectrum import gravity_pair
    from .runtime.graphs import GraphTick
    from .runtime.serving import assign
    mcfg = resolve(Settings(display_mode=DisplayMode.METER, meter_buf=100),
                   AudioInfo(SR, 2))
    mstep = make_meter_serving_step(mcfg)
    mhop = int(SR / mcfg.fps)
    ring = init_ring(s, 2, mcfg.fft_size, dev)
    mstate = init_meter_state(mcfg, s, dev)
    dt = torch.from_numpy(gravity_pair(mcfg, 1 / 60)).to(dev)
    ones = torch.ones(s, dtype=torch.bool, device=dev)
    new = torch.empty((s, 2, mhop), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)

    def tick():
        torch.rand(new.shape, generator=gen, device=dev, out=new)
        new.sub_(0.5)
        push(ring, new, mhop)
        _, st = mstep(ring, mstate, dt, ones, ones)
        assign(mstate, st)
        return mstate.meter_val.mean()

    g = GraphTick(tick, dev, generators=(gen,))

    def best(t: int) -> float:
        for _ in range(2):
            g()
        sync(dev)
        return min(timed(dev, lambda: [g() for _ in range(t)])
                   for _ in range(5))

    t1, t2 = best(ticks), best(33 * ticks)
    return s * 32 * ticks / max(t2 - t1, 1e-9), mcfg


def waveform_fps(s: int, dev: torch.device, k: int = 8) -> tuple:
    """The waveform engine (``DeviceWaveformEngine``, waveform mode, no
    smoothing) at S streams and microbatch ``k``: best of 3 rounds of 2k
    feed_batch + tick (host assembly, one packed upload a tick, the
    flushes), then the host assembly (``_assemble``) alone, median of 20.
    Returns (frames/s, ms a frame, assembly ms a tick)."""
    from . import AudioInfo, DisplayMode, Settings, TSmoothingMode, resolve
    from .runtime.waveform_device import DeviceWaveformEngine
    wcfg = resolve(Settings(display_mode=DisplayMode.WAVEFORM,
                            temporal_smoothing=TSmoothingMode.NONE),
                   AudioInfo(SR, 2))
    eng = DeviceWaveformEngine(wcfg, s, microbatch=k, device=dev)
    hop = int(SR / wcfg.fps)
    pkt = np.ascontiguousarray(np.broadcast_to(np.asarray(
        0.5 * np.random.default_rng(1).standard_normal((2, hop)),
        np.float32), (s, 2, hop)))
    step_ns = hop * 1_000_000_000 // SR
    now = [1_000_000_000]

    def ticks():
        for _ in range(2 * k):
            eng.feed_batch(pkt, now[0], now_ns=now[0])
            now[0] += step_ns
            eng.tick(now_ns=now[0])

    ticks()                       # warm-up: two flushes, the capture
    sync(dev)
    best = float("inf")
    for _ in range(3):
        best = min(best, timed(dev, ticks))
        sync(dev)
    asm = []
    for _ in range(20):
        eng.feed_batch(pkt, now[0], now_ns=now[0])
        t0 = time.perf_counter()
        eng._assemble(now[0])
        asm.append(time.perf_counter() - t0)
        now[0] += step_ns
    return (s * 2 * k / best, best / (2 * k) * 1e3,
            float(np.median(asm)) * 1e3)


def sharded_check(cfg, dev: torch.device) -> str:
    """A ``ShardedServingEngine`` of 8 streams on a 1x1 mesh of ``dev``
    for 2 ticks: its pixels must be finite."""
    from .parallel import ShardedServingEngine, make_mesh
    eng = ShardedServingEngine(cfg, 8, mesh=make_mesh(devices=[dev]))
    hop = int(SR / cfg.fps)
    pkt = np.full((8, 2, hop), 0.25, np.float32)
    now = 1_000_000_000
    tiles = []
    for _ in range(2):
        eng.feed_batch(pkt, now, now_ns=now)
        now += hop * 1_000_000_000 // SR
        tiles = eng.tick(now_ns=now)
    sync(dev)
    ok = all(bool(torch.isfinite(t.data).all()) for t in tiles)
    return ("ok (mesh=1x1, 8 streams, 2 ticks, finite=True)" if ok
            else "FINITE CHECK FAILED")


def serving_fps(cfg, s: int, hb: int, dev: torch.device) -> tuple:
    """The host-inclusive serving tick: ``ServingEngine(hop_budget=hb)``,
    feed_batch + tick + synchronize, best of 3 rounds of 10 (CUDA
    events), the p99 of that round's ticks on the host clock.  Returns
    (frames/s, p99 ms)."""
    from .runtime.serving import ServingEngine
    eng = ServingEngine(cfg, s, hop_budget=hb, device=dev)
    hop = int(SR / cfg.fps)
    pkt = np.asarray(0.5 * np.random.default_rng(0).standard_normal(
        (s, 2, hop)), np.float32)
    now = [1_000_000_000]

    def one():
        eng.feed_batch(pkt, now[0], now_ns=now[0])
        now[0] += hop * 1_000_000_000 // SR
        eng.tick(now_ns=now[0])

    for _ in range(3):
        one()
    sync(dev)
    fps, p99 = 0.0, float("inf")
    for _ in range(3):
        lat: list = []

        def round_():
            for _ in range(10):
                t0 = time.perf_counter()
                one()
                sync(dev)          # buffer -> spectrum completion
                lat.append(time.perf_counter() - t0)

        f = s * 10 / timed(dev, round_)
        if f > fps:
            fps, p99 = f, float(np.percentile(lat, 99)) * 1e3
    return fps, p99


def auto_microbatch(cfg, s: int, hb: int, dev: torch.device) -> dict:
    """``ServingEngine(microbatch="auto")``: driven until its probe and
    the closed-loop validation lock k, then two clean flushes, then best
    of 3 rounds of 10·max(k, 2) frames (CUDA events), with each frame's
    completion on the host clock (a flush completes its k frames)."""
    from .runtime.serving import ServingEngine
    eng = ServingEngine(cfg, s, microbatch="auto", hop_budget=hb,
                        device=dev)
    hop = int(SR / cfg.fps)
    pkt = np.asarray(0.5 * np.random.default_rng(0).standard_normal(
        (s, 2, hop)), np.float32)
    now = [1_000_000_000]

    def one():
        eng.feed_batch(pkt, now[0], now_ns=now[0])
        now[0] += hop * 1_000_000_000 // SR
        eng.tick(now_ns=now[0])

    guard = eng._PROBE_TICKS + 1 + 4 * eng._MB_MAX * (
        eng._VALIDATE_FLUSHES + 1)
    while eng._mb_auto and guard > 0:
        one()
        guard -= 1
    for _ in range(2 * eng.microbatch):
        one()
    sync(dev)
    k = eng.microbatch
    frames = 10 * max(k, 2)
    out = {"k": k, "completion": eng.microbatch_completion,
           "amort_ms": float("inf"), "p99_ms": float("inf"), "fps": 0.0}
    for _ in range(3):
        lat: list = []

        def round_():
            pending = []
            for i in range(frames):
                pending.append(time.perf_counter())
                one()
                if (i + 1) % k == 0 or i == frames - 1:
                    sync(dev)
                    t_end = time.perf_counter()
                    lat.extend(t_end - t for t in pending)
                    pending.clear()

        total = timed(dev, round_)
        if total / frames * 1e3 < out["amort_ms"]:
            out.update(amort_ms=total / frames * 1e3,
                       p99_ms=float(np.percentile(lat, 99)) * 1e3,
                       fps=s * frames / total)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--fft", type=int, default=4096)
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--scan", type=int, default=128,
                    help="ticks per dispatch (replays between host reads)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--sizes", default="1024,16384,32768,65536",
                    help="extra fft sizes for the per-size roofline sweep "
                         "('' disables; the headline size always reports)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the audio drawn on the device")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)

    from .core.device import checked_device
    dev = checked_device(args.device, "bench")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line(dev)
    S, N, W, T = args.streams, args.fft, args.width, args.scan

    # --- headline: T-tick dispatches of the captured tick ---------------
    cfg = build_cfg(N, W)
    hop = int(SR / cfg.fps)
    m = measure(cfg, S, T, args.reps, args.warmup, dev, args.seed)
    elapsed = m["elapsed"]
    frames_per_sec = S * T * args.reps / elapsed
    ticks_per_sec = T * args.reps / elapsed

    # --- accuracy gate vs the float64 oracle on the ring's window -------
    d = m["dispatch"]
    window = d.ring.buf[0].cpu().numpy().astype(np.float64)
    max_err, l2_err = accuracy_gate(cfg, window, dev)
    if max_err > 1e-4:
        print(json.dumps({"metric": "accuracy_gate_failed",
                          "value": max_err, "unit": "dB",
                          "vs_baseline": 0.0}))
        return 1

    # --- per-size roofline sweep ------------------------------------------
    mfu_lines = [mfu_line(cfg, S, m, ticks_per_sec, card)]
    sweep = [int(x) for x in args.sizes.split(",") if x] if args.sizes \
        else []
    for n_i in sweep:
        if n_i == N:
            continue
        s_i = 256 if n_i <= 16384 else (64 if n_i <= 32768 else 32)
        cfg_i = build_cfg(n_i, W)
        m_i = measure(cfg_i, s_i, T, 3, 1, dev, args.seed, rounds=2)
        del m_i["dispatch"]
        tps_i = T * 3 / m_i["elapsed"]
        mfu_lines.append(mfu_line(cfg_i, s_i, m_i, tps_i, card))

    # --- device-only single-tick latency: on-device audio, no upload ----
    dev_p50, dev_p99 = device_latency(d)
    del d, m

    # --- meter: differenced device-only throughput ----------------------
    m_fps, mcfg = meter_fps(S, T, dev, args.seed)

    # --- waveform engine at microbatch 8, and the host assembly alone ---
    wk = 8
    wf_fps, wf_ms, wf_asm_ms = waveform_fps(S, dev, wk)

    # --- the sharded engine on a 1x1 mesh ---------------------------------
    shard_line = sharded_check(cfg, dev)

    # --- host-inclusive serving tick, tight hop budget --------------------
    # the bench's feeder is metronomic, so hop + 16 pads the upload less
    # than the default 2x jitter headroom (a real engine parameter)
    hb = hop + 16
    srv_fps, srv_p99 = serving_fps(cfg, S, hb, dev)

    # --- microbatch="auto" live serving -------------------------------------
    mb = auto_microbatch(cfg, S, hb, dev)
    mb_val = (f"{mb['completion'] * 1e3:.1f}" if mb["completion"] is not None
              else "n/a")

    print(json.dumps({
        "metric": f"{N}pt_spectrum_frames_per_sec_per_chip",
        "value": round(frames_per_sec, 1),
        "unit": "frames/s",
        "vs_baseline": round(frames_per_sec / BASELINE_FPS, 3),
    }), flush=True)
    for ln in mfu_lines:
        print(ln, file=sys.stderr)
    ms_tick = elapsed / (args.reps * T) * 1e3
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"# accuracy max|dB err| vs float64 oracle: {max_err:.2e} "
          f"(rel L2 {l2_err:.2e}, the FFTW verify-lib metric); "
          f"S={S} N={N} hop={hop} scan={T} reps={args.reps} "
          f"elapsed={elapsed:.4f}s ({ms_tick:.4f} ms/tick, device-only, "
          f"{clock}); single-tick completion p50 {dev_p50:.3f} ms / "
          f"p99 {dev_p99:.3f} ms (one replay and a synchronize a tick, "
          f"no upload); METER (device-only, S={S}, {mcfg.fft_size}-sample "
          f"window, differenced): {m_fps:,.0f} frames/s "
          f"({m_fps / frames_per_sec:.2f}x spectrum); WAVEFORM "
          f"(DeviceWaveformEngine incl. host assembly + packed upload, "
          f"S={S}, microbatch={wk}): {wf_fps:,.0f} frames/s, amortized "
          f"{wf_ms:.3f} ms/frame (host assembly alone {wf_asm_ms:.3f} "
          f"ms/tick); sharded engine: {shard_line}; serving tick (incl. "
          f"feed_batch, assembly and upload, hop_budget={hb}): "
          f"{srv_fps:,.0f} frames/s, p99 buffer->spectrum latency "
          f"{srv_p99:.3f} ms; AUTO-microbatch k={mb['k']}: "
          f"{mb['fps']:,.0f} frames/s, amortized {mb['amort_ms']:.3f} "
          f"ms/frame vs 16.7 ms budget, per-frame completion p99 "
          f"{mb['p99_ms']:.3f} ms, validated flush completion {mb_val} ms; "
          f"device-only amortized {ms_tick:.4f} ms/frame; "
          f"device={dev} [{card}]", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
