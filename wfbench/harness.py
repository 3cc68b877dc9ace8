"""One run of one cell: set-up, warm-up, the measured window, the check.

Everything a cell is made of is found by name: the workload and its
metrics in ``BENCHMARK.json``, the configuration in the file it names,
the traffic mix in ``traffic/<name>.json``, the engine adapter in
``engines/<engine>.py`` and each metric's reader in
``metrics/<name>.py``.  Adding a cell, a configuration, a traffic mix, an
engine family or a metric adds files and entries and edits none.

The loop is closed, as OBS's render thread calls a source once a video
frame: feed the tick's packets, tick, wait until the pixels are complete
on the device, then make the next tick's packets.  The audio clock is the
traffic's own and advances one video frame a tick whatever the wall
time, so the loop serves as fast as the program can.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from wfbench import compare
from wfbench import trace as tracing
from wfbench.generator import Traffic, seed_words

ROOT = Path(__file__).resolve().parent.parent
PROFILED_TICKS = 240     # the traced sub-window: 4 s of audio


def load_module(path: Path):
    """A module from its file, whatever its name holds (a metric's name
    may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"wfbench_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(name: str, bench: dict, root: Path = ROOT
              ) -> tuple[dict, dict, dict]:
    """(workload, configuration entry, deployment file) of cell ``name``
    in the checkout at ``root``."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(by_name)})")
    cell = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return cell, conf, json.loads((root / conf["file"]).read_text())


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced; those with a ``workloads`` list only in
    the cells it names."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: torch.device | str, t_start: float,
             log=print, root: Path = ROOT) -> dict:
    """Run cell ``name`` once and return its result line (without the
    device keys the caller adds).  ``t_start`` is the process's start on
    ``time.perf_counter``'s clock; ``log`` takes the stderr lines;
    ``root`` is the checkout whose ``BENCHMARK.json`` and ``wfbench/``
    files define the cell."""
    device = torch.device(device)
    here = root / "wfbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell, conf, dep = find_cell(name, bench, root)
    mix = json.loads((here / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    phases = {"imports": time.perf_counter() - t_start}

    t = time.perf_counter()
    engine = load_module(here / "engines" / f"{dep['engine']}.py")
    adapter = engine.Adapter(dep, device)
    phases["engine"] = time.perf_counter() - t
    t = time.perf_counter()
    gen = Traffic(mix, adapter.S, adapter.C, adapter.N,
                  dep["audio"]["samples_per_sec"], dep["fps"], seed)
    phases["audio"] = time.perf_counter() - t

    def one_tick(k: int, span=None):
        packets, now = gen.packets(k), gen.now_ns(k)
        if span is None:
            t0 = time.perf_counter()
            adapter.feed(packets, now)
            t1 = time.perf_counter()
            px = adapter.tick(now)
            t2 = time.perf_counter()
            _sync(device)
            return px, t0, t1, t2, time.perf_counter()
        with span("feed"):
            adapter.feed(packets, now)
        with span("tick"):
            px = adapter.tick(now)
        with span("wait"):
            _sync(device)
        return px

    # warm-up: the captures, a full ring, a settled smoothing state
    t = time.perf_counter()
    warm = math.ceil((adapter.N + gen.P) / gen.hop) + dep["check"]["history"]
    k = 0
    for k in range(1, warm + 1):
        one_tick(k)
    phases["warm_up"] = time.perf_counter() - t
    phases["warm_up_ticks"] = warm

    # the measured window; a seeded reservoir keeps the checked ticks
    keep = int(dep["check"]["ticks"])
    pick = np.random.default_rng([seed_words(seed), 1])
    kept: list = []
    times = []
    gc.collect()
    gc.freeze()     # set-up's objects are never scanned in the window
    gc0 = gc.get_stats()
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    while True:
        k += 1
        px, t0, t1, t2, t3 = one_tick(k)
        i = len(times)
        times.append((t0, t1, t2, t3))
        if i < keep:
            kept.append((k, px))
        else:
            j = int(pick.integers(0, i + 1))
            if j < keep:
                kept[j] = (k, px)
        del px
        if t3 - w0 >= seconds:
            break
    window_s = times[-1][3] - w0
    gc.unfreeze()
    collected = [b["collections"] - a["collections"]
                 for a, b in zip(gc0, gc.get_stats())]
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    t = np.asarray(times)

    profile = None
    if traced:
        start = k

        def step(span):
            nonlocal k
            k += 1
            one_tick(k, span)

        dev_ops, host = tracing.profile_ticks(step, PROFILED_TICKS)
        profile = tracing.summarize(dev_ops, host, PROFILED_TICKS)
        log(f"# profiled ticks {start + 2}..{k}: "
            f"{len(dev_ops)} device ops, {len(host)} host spans")

    # the check, once the program's state is freed
    kept.sort(key=lambda kp: kp[0])
    ticks = [kk for kk, _ in kept]
    got = np.stack([p.cpu().numpy() for _, p in kept]).astype(np.float64)
    kept.clear()
    adapter.close()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = adapter.expected(gen, ticks, dep["check"]["history"])
    checks = compare.checks(got, want, dep["check"])
    bad_frames = compare.failed_frames(got, want, dep["check"])
    gap = np.abs(got - want)
    log(f"# check: ticks {ticks}, {got.size} pixels, reference "
        f"{time.perf_counter() - t_ref:.3f} s, worst gap at "
        f"{np.unravel_index(np.argmax(gap), got.shape)}")

    # what a metric's reader sees: the window's timings, the traced
    # profile, the peak, and the adapter (its engine and shapes)
    run = SimpleNamespace(
        cell=name, S=adapter.S, device=device, ticks=len(times),
        window_s=window_s, setup_s=setup_s,
        latency_s=t[:, 3] - t[:, 0], feed_s=t[:, 1] - t[:, 0],
        tick_s=t[:, 2] - t[:, 1], wait_s=t[:, 3] - t[:, 2],
        C=adapter.C, N=adapter.N, peak_bytes=int(peak), adapter=adapter,
        profile=profile, log=log)
    metrics = {}
    for m in cell_metrics(bench, name, traced):
        value = load_module(here / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    log("# setup phases (s): " + json.dumps(
        {k_: round(v, 6) for k_, v in phases.items()}))
    per_s = np.bincount(((t[:, 3] - w0) // 1.0).astype(int))
    log(f"# window ticks by second: {per_s.tolist()}; garbage "
        f"collections in it by generation: {collected}")
    log(f"# window: {len(times)} ticks in {window_s:.6f} s, "
        f"latency p50 {np.median(run.latency_s) * 1e3:.6f} ms, "
        f"feed {run.feed_s.mean() * 1e3:.6f} ms, tick "
        f"{run.tick_s.mean() * 1e3:.6f} ms, wait "
        f"{run.wait_s.mean() * 1e3:.6f} ms")
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(times) * adapter.S,
        "failed": bad_frames,
        "metrics": metrics,
        "device": {"memory_peak_bytes": int(peak)},
    }
    if profile is not None:
        result["device"]["busy_s"] = profile["busy_us"] / 1e6
        result["device"]["window_s"] = profile["window_us"] / 1e6
        result["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, (_, us)
                           in profile["ops"][:10]],
            "idle_gaps": [[n, us / 1e6] for n, us
                          in profile["idle_gaps"][:10]]}
        log("# idle by span (us): " + json.dumps(profile["idle_by_span"]))
        log("# device ops (name, count, us): " + json.dumps(
            [[n, c, us] for n, (c, us) in profile["ops"][:25]]))
    result["checks"] = checks
    return result
