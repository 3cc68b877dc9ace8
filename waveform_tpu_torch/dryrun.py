"""Dry run of multi-device serving: the sharded engines over an N-entry mesh.

The PyTorch counterpart of ``__graft_entry__.dryrun_multichip``:

    python -m waveform_tpu_torch.dryrun N [--device cpu]

drives the real mesh-sharded engines (``parallel/``) through the paths a
user calls: ``ShardedServingEngine`` at pixel_parallel 2 (1 for odd N) for
3 ticks with the per-tile shape check, the meter and waveform families,
one microbatch flush of k=2, one ``MultiEngine`` cohort tick (unsharded,
as in the JAX dry run), and one live resize across mesh shapes that keeps
the surviving rows' dB.  The mesh is the CUDA devices when there are N of
them and the first card repeated N times otherwise; ``--device cpu`` runs
it on the CPU (the kernels' plain twins).  The exact backend and the
kernels are forced on for the run and restored after it.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def mesh_devices(n: int, device: str = "cuda") -> list:
    """N mesh entries: the CUDA devices when there are N of them, the
    first card repeated otherwise, or the CPU repeated."""
    from .core.device import checked_device
    dev = checked_device(device, "dryrun")
    if dev.type != "cuda":
        return [dev] * n
    if torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * n


def dryrun(n_devices: int, device: str = "cuda") -> str:
    """Run the dry run over an ``n_devices``-entry mesh; returns its
    summary line.  Raises on any failed check."""
    forced = {"WAVEFORM_TPU_EXACT_KERNEL": "always",
              "WAVEFORM_TPU_FFT_BACKEND": "exact"}
    saved = {k: os.environ.get(k) for k in forced}
    os.environ.update(forced)
    try:
        return _body(mesh_devices(n_devices, device))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _body(devices: list) -> str:
    from . import AudioInfo, Settings, resolve
    from .core.enums import DisplayMode, FFTWindow, InterpMode, TSmoothingMode
    from .kernels import cuda_lib
    from .parallel import (
        PIXEL_AXIS,
        STREAM_AXIS,
        ShardedMeterServingEngine,
        ShardedServingEngine,
        ShardedWaveformEngine,
        make_mesh,
    )
    from .runtime.multi import MultiEngine

    n = len(devices)
    pixel_par = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(devices, pixel_parallel=pixel_par)
    s_ax, p_ax = mesh.shape[STREAM_AXIS], mesh.shape[PIXEL_AXIS]
    N, W = 1024, 256           # the smallest size the pair kernels serve
    S = max(32, 8 * s_ax)
    cfg = resolve(Settings(fft_size=N, width=W, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS),
                  AudioInfo(48000, 2))
    eng = ShardedServingEngine(cfg, S, mesh=mesh, use_native=False)

    rng = np.random.default_rng(0)
    sr, hop = 48000, 800
    step_ns = hop * 1_000_000_000 // sr
    before = cuda_lib.LAUNCHES["K1-gen"]
    now = 1_000_000_000
    for _ in range(3):
        pkt = (0.4 * rng.standard_normal((S, 2, hop))).astype(np.float32)
        eng.feed_batch(pkt, now, now_ns=now)
        now += step_ns
        eng.tick(now_ns=now)
    launches = cuda_lib.LAUNCHES["K1-gen"] - before

    # every entry holds exactly its (S/stream_axis, D, W/pixel_axis) tile
    D = cfg.display_channels
    shapes = {tuple(t.data.shape) for t in eng.pixels_sharded}
    want = (eng.S // s_ax, D, W // p_ax)
    assert shapes == {want} and len(eng.pixels_sharded) == n, shapes
    out = eng.read_pixels()
    assert out.shape == (S, D, W) and np.isfinite(out).all()
    on_card = devices[0].type == "cuda"
    if on_card:   # one K1-gen launch for each entry a tick
        assert launches == 3 * n, launches

    # the meter and waveform families on the same mesh
    Sm = 2 * s_ax
    mcfg = resolve(Settings(display_mode=DisplayMode.METER, meter_buf=50),
                   AudioInfo(48000, 2))
    meng = ShardedMeterServingEngine(mcfg, Sm, mesh=mesh, use_native=False)
    wcfg = resolve(Settings(display_mode=DisplayMode.WAVEFORM,
                            temporal_smoothing=TSmoothingMode.NONE),
                   AudioInfo(48000, 2))
    weng = ShardedWaveformEngine(wcfg, Sm, mesh=mesh, use_native=False)
    now = 1_000_000_000
    for _ in range(2):
        pkt = (0.4 * rng.standard_normal((Sm, 2, hop))).astype(np.float32)
        meng.feed_batch(pkt, now, now_ns=now)
        for s in range(Sm):
            weng.feed(s, pkt[s], now, now_ns=now)
        now += step_ns
        meng.tick(now_ns=now)
        weng.tick(now_ns=now)
    mv = meng.meter_values.cpu().numpy()
    wv = weng.render_values()
    assert mv.shape == (Sm, 2) and np.isfinite(mv).all()
    assert wv.shape[0] == Sm and np.isfinite(wv).all()

    # one microbatch flush: k=2 frames run as one graph on each entry
    mb = ShardedServingEngine(cfg, S, mesh=mesh, use_native=False,
                              microbatch=2)
    now = 1_000_000_000
    for _ in range(2):
        pkt = (0.4 * rng.standard_normal((S, 2, hop))).astype(np.float32)
        mb.feed_batch(pkt, now, now_ns=now)
        now += step_ns
        mb.tick(now_ns=now)
    batch = mb.last_batch_pixels
    assert batch is not None and all(t.data.shape[0] == 2 for t in batch)
    assert all(torch.isfinite(t.data).all() for t in batch)

    # one cohort tick: two spectrum groups of one row width share one
    # upload (runtime/multi.py, unsharded, on the mesh's first device)
    cfg_b = resolve(Settings(fft_size=512, width=W,
                             window=FFTWindow.BLACKMAN), AudioInfo(48000, 2))
    multi = MultiEngine(device=devices[0])
    sids = [multi.add_stream(cfg), multi.add_stream(cfg),
            multi.add_stream(cfg_b)]
    now = 1_000_000_000
    for _ in range(2):
        for sid in sids:
            x = (0.3 * rng.standard_normal((2, hop))).astype(np.float32)
            multi.feed(sid, x, now, now_ns=now)
        now += step_ns
        multi.tick(now_ns=now)
    assert multi.num_groups == 2
    assert len(multi._cohorts) == 1   # the fusion engaged
    for sid in sids:
        assert np.isfinite(multi.read_decibels(sid)).all()

    # a live resize across mesh shapes keeps the surviving rows' dB
    db_before = eng.read_decibels()
    mesh2 = make_mesh(devices, pixel_parallel=1)
    keep = [3, 1, 4]
    eng2 = eng.resized(len(keep) + 1, keep=keep, mesh=mesh2)
    np.testing.assert_array_equal(eng2.read_decibels()[:len(keep)],
                                  db_before[keep])
    pkt = (0.4 * rng.standard_normal(
        (len(keep) + 1, 2, hop))).astype(np.float32)
    eng2.feed_batch(pkt, now, now_ns=now)
    eng2.tick(now_ns=now + step_ns)
    assert np.isfinite(eng2.read_pixels()).all()

    where = (torch.cuda.get_device_name(devices[0]) if on_card
             else "cpu") + f" x{len({str(d) for d in devices})} distinct"
    return (f"dryrun OK ({where}): ShardedServingEngine mesh="
            f"{mesh.shape} S={S} N={N} tiles={want} K1-gen launches "
            f"{launches} in 3 ticks; ShardedMeterServingEngine + "
            f"ShardedWaveformEngine OK (S={Sm}); microbatch flush k=2 OK; "
            f"cohort tick (2 groups, 1 upload) OK; live resize across mesh "
            f"shapes {mesh.shape} -> {mesh2.shape} OK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="mesh entries")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(dryrun(args.n, args.device), flush=True)


if __name__ == "__main__":
    main()
