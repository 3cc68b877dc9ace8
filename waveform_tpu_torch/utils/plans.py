"""Measured kernel plans: which exact-FFT body serves each size.

The PyTorch counterpart of ``waveform_tpu/utils/plans.py`` (the FFTW
planner's measure-and-pick, its choice kept as wisdom).  On this card the
one per-size choice the router cannot make from geometry alone is the
stage-1 split of the pair kernels: split 2 is K1's body (K1-gen,
``csrc/exact_mag_gen.cu``), split 3 is K2 (``csrc/exact_mag3.cu``).
``kernels/exact_cuda.stage1_split`` resolves it in the JAX package's
order: ``WAVEFORM_TPU_STAGE1_SPLIT``, then :func:`plan_for`, then the
default (3 from N = 32768 up).

The plan file is JSON keyed by N, in the JAX schema: ``split``,
``streams``, ``us_per_frame`` (the winner's device time a frame) and
``xla_us_per_frame`` (the digit lowering's).  The keys only a TPU uses
(``ddt``, ``bs``) are read and ignored.  Lookup order: the user's file
(:func:`plan_path`), then the table measured on an H100 that ships with
the package (``data/plans_h100.json``, read only when the card is an
H100), else None.

:func:`measure` times every candidate, interleaved, on the card and
:func:`record` keeps the winner.  Run on the target card::

    python -m waveform_tpu_torch.utils.plans 4096 16384 --streams 64 --reps 8
"""

from __future__ import annotations

import contextlib
import json
import os
from functools import lru_cache

import numpy as np
import torch


def plan_path() -> str:
    """``WAVEFORM_TPU_PLAN_FILE``, else the port's own file under
    ``~/.cache/waveform_tpu_torch`` (not the JAX package's: a plan tuned
    on a TPU must never steer this card)."""
    return os.environ.get(
        "WAVEFORM_TPU_PLAN_FILE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "waveform_tpu_torch", "plans.json"))


@lru_cache(maxsize=8)
def _load(path: str, mtime: float) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


PACKAGED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "plans_h100.json")


@lru_cache(maxsize=1)
def _packaged_plans() -> dict:
    """The plan table measured on an H100, shipped with the package.  It
    applies only when the current CUDA device names an H100: the CPU and
    other cards keep the default rule, so the table cannot skew them.

    Probing the device may raise while CUDA initialises; ``lru_cache``
    caches no exception, so the next call probes again instead of
    latching an empty table for the life of the process (:func:`plan_for`
    treats the raise as "no table this time")."""
    if not torch.cuda.is_available():
        return {}
    if "H100" not in torch.cuda.get_device_name():   # may raise
        return {}
    try:
        with open(PACKAGED) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def plan_for(n: int) -> dict | None:
    """The stored plan entry for fft_size ``n``: the user's plan file
    first, then the packaged H100 table (on an H100 only), else None."""
    def packaged() -> dict:
        try:
            return _packaged_plans()
        except RuntimeError:
            return {}   # CUDA still initialising: no table this time

    path = plan_path()
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        return packaged().get(str(n))
    entry = _load(path, mtime).get(str(n))
    if entry is not None:
        return entry
    return packaged().get(str(n))


def record(n: int, entry: dict) -> None:
    """Store ``entry`` for fft_size ``n`` in the plan file."""
    path = plan_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        with open(path) as f:
            plans = json.load(f)
    except (OSError, ValueError):
        plans = {}
    plans[str(n)] = entry
    with open(path, "w") as f:
        json.dump(plans, f, indent=1, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def _candidates(n: int) -> list[tuple[int, str]]:
    """(split, twiddle tier) of every pair-kernel body whose geometry
    admits ``n``, each on its own merits (the split the router resolves
    now must not veto the other), at the tier serving resolves
    (``exact_cuda.twiddle_tier``: the tuner times what serving runs)."""
    from ..kernels import exact_cuda
    tier = exact_cuda.twiddle_tier()
    out = []
    if exact_cuda._two_factor(n):
        out.append((2, tier))
    n1, rem = divmod(n, exact_cuda.LANES)
    if not rem and n1 % 32 == 0 and 4096 <= n <= exact_cuda.MAX_N3:
        out.append((3, tier))
    return out


@contextlib.contextmanager
def _kernels_off():
    """``WAVEFORM_TPU_EXACT_KERNEL=never`` for a block: the digit
    lowering the engine serves with the kernels off."""
    old = os.environ.get("WAVEFORM_TPU_EXACT_KERNEL")
    os.environ["WAVEFORM_TPU_EXACT_KERNEL"] = "never"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("WAVEFORM_TPU_EXACT_KERNEL")
        else:
            os.environ["WAVEFORM_TPU_EXACT_KERNEL"] = old


def _graph_timer(tag, n: int, streams: int, ticks: int):
    """A function that times one rep of candidate ``tag`` on the card and
    returns its device µs a frame.

    Every candidate reads the serving ring's flat [S·2, N] rows as the
    engine's tick does (``tag`` (split, tier) launches that body
    directly, "xla" runs ``exactfft.rfft_mag_exact`` with the kernels
    off).  One ``torch.cuda.CUDAGraph`` holds ``ticks`` calls; a rep is
    one replay between two CUDA events, so the host's enqueue is not
    timed."""
    from ..kernels import exact_cuda, exactfft
    from ..runtime.graphs import _side_stream, no_gc

    dev = torch.device("cuda", torch.cuda.current_device())
    S = streams
    rng = np.random.default_rng(0)
    x2 = torch.from_numpy(
        (0.3 * rng.standard_normal((2 * S, n))).astype(np.float32)).to(dev)
    window = (torch.ones(n, dtype=torch.float32, device=dev),
              torch.zeros(n, dtype=torch.float32, device=dev))
    if tag == "xla":
        def call():
            return exactfft.rfft_mag_exact(x2.view(S, 2, n), window)[0]
        route = _kernels_off
    else:
        split, tier = tag
        body = (exact_cuda.rfft_pair_mag_gen if split == 2
                else exact_cuda.rfft_pair_mag3)

        def call():
            return body(x2.view(S, 2, n), window, twiddle=tier)[0]
        route = contextlib.nullcontext

    side = _side_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with route():
        with torch.cuda.stream(side):
            call()                           # warm-up: build and constants
        torch.cuda.current_stream(dev).wait_stream(side)
        with no_gc(), torch.cuda.graph(graph, stream=side):
            for _ in range(ticks):
                call()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def rep() -> float:
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / (ticks * S)

    return rep


def measure(n: int, streams: int = 64, ticks: int = 0, reps: int = 8,
            verbose: bool = True) -> dict:
    """Time every candidate of :func:`_candidates` and the digit lowering
    interleaved on the card; record and return the winning entry.

    ``ticks <= 0`` sizes each graph to ~2^28 samples of work (>= 8
    calls), so a replay lasts milliseconds at every size.  The entry keeps
    the minimum over ``reps`` of each candidate's µs a frame."""
    from ..kernels.cuda_lib import build

    if not torch.cuda.is_available():
        raise RuntimeError("the plan tuner times the kernels on a CUDA "
                           "device and none is available")
    if ticks <= 0:
        ticks = max(8, (1 << 28) // (n * streams))
    build()
    tags = _candidates(n) + ["xla"]
    timers = {t: _graph_timer(t, n, streams, ticks) for t in tags}
    times: dict = {t: [] for t in tags}
    for _ in range(reps):
        for t in tags:
            times[t].append(timers[t]())
    mins = {t: float(np.min(v)) for t, v in times.items()}
    kern = [t for t in tags if t != "xla"]
    entry: dict = {"streams": streams,
                   "xla_us_per_frame": round(mins["xla"], 3)}
    if kern:
        best = min(kern, key=lambda t: mins[t])
        entry.update({"split": best[0], "us_per_frame": round(mins[best], 3)})
    record(n, entry)
    if verbose:
        for t in tags:
            print(f"plan {n} S={streams} T={ticks}: {t}: min "
                  f"{mins[t]:.4f} us/frame over {reps} reps", flush=True)
        print(f"plan[{n}] = {entry}", flush=True)
    return entry


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sizes", type=int, nargs="+")
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=0,
                    help="calls a timed graph holds (0 = ~2^28 samples)")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args(argv)
    from .wisdom import enable
    enable()
    for n in args.sizes:
        measure(n, args.streams, args.ticks, args.reps)


if __name__ == "__main__":
    main()
