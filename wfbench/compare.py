"""The numbers that decide ``correct``: what the timed ticks returned
against what the reference says they should hold.

Each number is a function of ``got`` and ``want``, the checked ticks'
pixels [ticks, S, D, width] in dBFS (float64), and is compared with the
limit of the same name in the configuration's ``check``; a configuration
compares the numbers it gives a limit.
"""

from __future__ import annotations

import numpy as np


def max_db_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap, in dB, over every checked pixel: a wrong sample,
    state or pixel anywhere."""
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.max(np.abs(got - want)))


def p99_db_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The 99th percentile of the gap, in dB, over every checked pixel:
    the FFT's rounding where it is widest, in the bins far below a loud
    tone, without the few deepest dips of the noise that set the widest
    gap and swing from seed to seed."""
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.percentile(np.abs(got - want), 99))


NUMBERS = {f.__name__: f for f in (max_db_gap, p99_db_gap)}


def checks(got: np.ndarray, want: np.ndarray, limits: dict) -> dict:
    """Every number that ``limits`` (a configuration's ``check``) gives a
    limit, each beside its limit, in the order of :data:`NUMBERS`."""
    return {name: {"value": fn(got, want), "limit": float(limits[name])}
            for name, fn in NUMBERS.items() if name in limits}


def failed_frames(got: np.ndarray, want: np.ndarray, limits: dict) -> int:
    """Checked curves (one tick of one stream's display channel) that
    fail: those whose own widest gap passes ``max_db_gap``'s limit, or
    every checked curve where only a number of the whole set fails."""
    found = checks(got, want, limits)
    if all(c["value"] <= c["limit"] for c in found.values()):
        return 0
    curves = np.abs(got - want).reshape(-1, got.shape[-1])
    curves = np.where(np.isfinite(curves), curves, np.inf)
    bad = int(np.sum(curves.max(-1) > found["max_db_gap"]["limit"])) \
        if "max_db_gap" in found else 0
    return bad or len(curves)
