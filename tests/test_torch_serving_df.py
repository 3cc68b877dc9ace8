"""The whole slice at the df twiddle tier: ``WAVEFORM_TPU_KERNEL_TWIDDLE=df``
in both packages, the port's ServingEngine against the JAX ServingEngine
(its exact kernel in interpret mode), within 1e-4 dB as in
tests/test_torch_serving.py, and the port against the float64 oracle.

The JAX package reads the tier when it traces its engine's step, so each
test drops JAX's compiled functions first: a trace cached at the f32
default by an earlier test in the process would otherwise serve it.
"""

import jax
import numpy as np
import pytest

from test_torch_serving import (FRAME_NS, SR, T0, _assert_same, _audio,
                                _engines, _oracle_gate)
from waveform_tpu.kernels import exact_pallas as jep
from waveform_tpu_torch import (AudioInfo, FFTWindow, InterpMode, Settings,
                                TSmoothingMode, resolve)
from waveform_tpu_torch.kernels import exact_cuda


@pytest.fixture
def df_kernel_on(monkeypatch):
    """The JAX exact kernel on in interpret mode, both packages at the df
    tier; returns the list of (body, df) pairs the port's router ran and
    the tiers the JAX engine traced its kernel with."""
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", "df")
    jax.clear_caches()
    seen = []
    for name in ("_pair_mag", "_pair_mag3"):
        body = getattr(exact_cuda, name)

        def spy(x, window, df, head=None, _body=body, _name=name):
            seen.append((_name, df))
            return _body(x, window, df, head)
        monkeypatch.setattr(exact_cuda, name, spy)
    rows_mag = jep.rfft_rows_mag_packed

    def jax_spy(*args, twiddle, **kw):
        seen.append(("jax", twiddle == "df"))
        return rows_mag(*args, twiddle=twiddle, **kw)
    monkeypatch.setattr(jep, "rfft_rows_mag_packed", jax_spy)
    return seen


@pytest.mark.parametrize("n,split", [(4096, None), (8192, "3")])
def test_df_slice_matches_jax(n, split, df_kernel_on, monkeypatch):
    """The headline configuration (N=4096, 800 px, Hann, Lanczos, stereo)
    through K1-df's twin, and N=8192 forced to split 3 through K2-df's,
    every tick at the df tier (five ticks: the window need not fill for
    the two packages to agree)."""
    if split:
        monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", split)
    cfg = resolve(Settings(fft_size=n, width=800, window=FFTWindow.HANN,
                           interp_mode=InterpMode.LANCZOS), AudioInfo(SR, 2))
    S, ticks = 3, 5
    port, ref = _engines(cfg, S)
    rng = np.random.default_rng(80 + n)
    for k in range(ticks):
        x = _audio(rng, S, k, silent=[2])
        now = T0 + k * FRAME_NS
        for eng in (port, ref):
            eng.feed_batch(x, now, now_ns=now)
            eng.tick(now_ns=now)
    _assert_same(port, ref)
    assert port.last_silent[2] and not port.last_silent[:2].any()
    body = "_pair_mag3" if split else "_pair_mag"
    port_calls = [c for c in df_kernel_on if c[0] != "jax"]
    assert port_calls == [(body, True)] * ticks
    assert ("jax", True) in df_kernel_on and ("jax", False) not in df_kernel_on


@pytest.mark.parametrize("n,split", [(4096, None), (8192, "3")])
def test_df_slice_meets_oracle_gate(n, split, df_kernel_on, monkeypatch):
    if split:
        monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", split)
    _oracle_gate(Settings(fft_size=n, width=800, window=FFTWindow.HANN,
                          temporal_smoothing=TSmoothingMode.NONE),
                 n // 800 + 2, 63)
    assert df_kernel_on and all(df for _, df in df_kernel_on)
