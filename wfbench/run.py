"""Run one cell of ``BENCHMARK.json`` once, on the card.

    python3 -m wfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Set-up and the stderr lines come first; the
last lines of standard error are the numbers compared against the
reference, each beside its limit, and the last line of standard output
is the result as one JSON object.  Without a card the run fails and
prints no result: it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()   # before any import: set-up starts here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "waveform_tpu")


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one host thread for the program's CPU work: the load comes from one
    # process, and idle OpenMP workers spinning beside the loop slow it
    # and spread its ticks
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}: no result")
        return 2
    # the dense rebin refuses reduced-precision float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from wfbench.harness import run_cell
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: JAX or the JAX package; no result")
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"], **result["device"]}
    log(f"# card: {card_line()}")
    checks = result.pop("checks")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
