"""Rebin of the PyTorch port against the JAX rebin, both interp forms.

Input dB values span the default display range [-65, 0] dBFS.  The bound
is 1e-5 dB plus two f32 ulps of the value (rtol 2.5e-7): the two sides sum
the signed Lanczos taps in different orders, which alone moves a -43 dB
result by up to 3 ulps (1.1e-5 dB).  Pixel-mapped outputs are held to the
same bound expressed in pixels.  Each package resolves the same settings
with its own ``resolve``.
"""

import enum

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from waveform_tpu import (
    AudioInfo,
    DisplayMode,
    FilterMode,
    InterpMode,
    Settings,
    resolve,
)
from waveform_tpu.rebin import apply as japply
import waveform_tpu_torch as wt
from waveform_tpu_torch.rebin import apply as tapply

CONFIGS = {
    "lanczos": dict(interp_mode=InterpMode.LANCZOS),
    "catrom": dict(interp_mode=InterpMode.CATROM),
    "point": dict(interp_mode=InterpMode.POINT),
    "bars": dict(display_mode=DisplayMode.BAR, interp_mode=InterpMode.LANCZOS,
                 bar_width=8, bar_gap=2),
    "bars_point": dict(display_mode=DisplayMode.BAR,
                       interp_mode=InterpMode.POINT),
    "gauss": dict(interp_mode=InterpMode.CATROM, filter_mode=FilterMode.GAUSS,
                  filter_radius=2.5),
    "mirror": dict(interp_mode=InterpMode.LANCZOS, mirror_freq_axis=True,
                   log_scale=False),
}


def _cfgs(**kw):
    """The same settings at 48 kHz stereo resolved by the JAX package and
    by the port (enum members passed by name): ``(jax_cfg, port_cfg)``."""
    port_kw = {k: (getattr(wt, type(v).__name__)[v.name]
                   if isinstance(v, enum.Enum) else v) for k, v in kw.items()}
    return (resolve(Settings(**kw), AudioInfo(48000, 2)),
            wt.resolve(wt.Settings(**port_kw), wt.AudioInfo(48000, 2)))


@pytest.mark.parametrize("pixel_map", [False, True])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_rebin_matches_jax(name, dense, pixel_map, monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_REBIN", "dense" if dense else "gather")
    cfg, tcfg = _cfgs(fft_size=2048, width=300, **CONFIGS[name])
    rng = np.random.default_rng(len(name))
    db = rng.uniform(-65.0, 0.0, (3, 2, cfg.num_bins)).astype(np.float32)
    ref = japply.make_rebin_fn(cfg, apply_pixel_map=pixel_map)
    port = tapply.make_rebin_fn(tcfg, apply_pixel_map=pixel_map,
                                device="cpu", dense=dense)
    kw = dict(top=4.0, bottom=220.0) if pixel_map else {}
    atol = 1e-5 * ((220.0 - 4.0) / (cfg.ceiling - cfg.floor)
                   if pixel_map else 1.0)
    want = np.asarray(ref(jnp.asarray(db), **kw))
    got = port(torch.from_numpy(db), **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=atol)


def test_interp_matrix_matches_jax():
    cfg, _ = _cfgs(fft_size=1024, width=200, interp_mode=InterpMode.LANCZOS)
    from waveform_tpu.rebin.interp import build_interp_tables
    t = build_interp_tables(cfg)
    np.testing.assert_array_equal(
        tapply._interp_matrix(t.taps, t.weights, cfg.num_bins),
        japply._interp_matrix(t.taps, t.weights, cfg.num_bins))


def test_dense_rebin_refuses_reduced_precision_matmul():
    """The dense product must run in full f32; a lowered global matmul
    precision is refused, not silently overridden."""
    _, cfg = _cfgs(fft_size=1024, width=200)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="full-f32"):
            tapply.make_rebin_fn(cfg, device="cpu", dense=True)
        # the gather has no matmul
        tapply.make_rebin_fn(cfg, device="cpu", dense=False)
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.get_float32_matmul_precision() == before
    tapply.make_rebin_fn(cfg, device="cpu", dense=True)
