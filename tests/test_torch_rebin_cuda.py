"""The rebin's interp and Gaussian filter kernels (``kernels/rebin_cuda.py``).

On the CPU (no marker): ``make_rebin_fn`` sends CPU tensors through the
plain versions, ``rebin_interp_ref`` and ``rebin_gauss_ref``, which are
held to the JAX package's rebin over every interp mode and display mode,
filter on and off, and a pixel block; the wrapper's row layout (strided
leading dims merged into two) is checked on CPU tensors.  The JAX
package is imported inside those tests, so that the card's machine,
which has no JAX, collects this file.

Marked ``cuda`` (each skips without a CUDA device): each kernel against
its plain version at both benchmark cells' shapes, edge-clamped taps, T =
1, the wrapper's refusals, and the kernels a replay of both cells'
ticks.  The filter kernel gives the plain version's bits.  The interp
kernel adds its T products in tap order; the plain gather-and-sum may add
them in another order, and each of T products rounded once and summed in
float32 lies within (T + 1) * 2^-24 * sum|x * w| of the exact sum, so the
two agree within twice that.  On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_rebin_cuda.py
"""

import enum

import numpy as np
import pytest
import torch

import waveform_tpu_torch as wt
from waveform_tpu_torch.kernels import rebin_cuda
from waveform_tpu_torch.kernels.cuda_lib import LAUNCHES
from waveform_tpu_torch.rebin import apply as tapply
from waveform_tpu_torch.rebin.filter import build_gauss_tables
from waveform_tpu_torch.rebin.interp import build_interp_tables

cuda = pytest.mark.cuda

MODES = {"lanczos": "LANCZOS", "catrom": "CATROM", "point": "POINT"}
DISPLAYS = {
    "curve": dict(display_mode="CURVE"),
    "bars": dict(display_mode="BAR", bar_width=8, bar_gap=2),
    "waveform": dict(display_mode="WAVEFORM"),
}


def _port_cfg(**kw):
    """The port's config of ``kw`` at 48 kHz stereo, enum members given by
    name."""
    kinds = {"interp_mode": wt.InterpMode, "display_mode": wt.DisplayMode,
             "filter_mode": wt.FilterMode, "channel_mode": wt.ChannelMode}
    kw = {k: kinds[k][v] if k in kinds else v for k, v in kw.items()}
    return wt.resolve(wt.Settings(**kw), wt.AudioInfo(48000, 2))


def _jax_cfg(cfg):
    """The JAX package's resolve of the port config's settings."""
    import waveform_tpu as jwt
    kw = {k: (getattr(jwt, type(v).__name__)[v.name]
              if isinstance(v, enum.Enum) else v)
          for k, v in vars(cfg.settings).items()}
    return jwt.resolve(jwt.Settings(**kw), jwt.AudioInfo(48000, 2))


def _nbins(cfg) -> int:
    return (cfg.fft_size if cfg.display_mode == wt.DisplayMode.WAVEFORM
            else cfg.num_bins)


@pytest.mark.parametrize("gauss", [False, True], ids=["plain", "gauss"])
@pytest.mark.parametrize("display", list(DISPLAYS))
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_versions_through_make_rebin_fn_match_jax(mode, display, gauss,
                                                        monkeypatch):
    """On the CPU ``make_rebin_fn`` runs ``rebin_interp_ref`` (and, where
    the look filters, ``rebin_gauss_ref``), and its output is the JAX
    rebin's within the rebin tests' bound (the two sum the taps in
    different orders)."""
    import jax.numpy as jnp
    from waveform_tpu.rebin import apply as japply
    monkeypatch.delenv("WAVEFORM_TPU_REBIN", raising=False)
    calls = []
    for name in ("rebin_interp_ref", "rebin_gauss_ref"):
        fn = getattr(tapply, name)
        monkeypatch.setattr(
            tapply, name, lambda *a, fn=fn, name=name: (calls.append(name),
                                                        fn(*a))[1])
    cfg = _port_cfg(fft_size=2048, width=300, interp_mode=MODES[mode],
                    filter_mode="GAUSS" if gauss else "NONE",
                    filter_radius=2.5, **DISPLAYS[display])
    assert tapply.filters(cfg) == gauss
    db = np.random.default_rng(len(mode) + 3 * len(display)).uniform(
        -65.0, 0.0, (3, 2, _nbins(cfg))).astype(np.float32)
    got = tapply.make_rebin_fn(cfg, apply_pixel_map=False, device="cpu")(
        torch.from_numpy(db)).numpy()
    assert calls == ["rebin_interp_ref"] + ["rebin_gauss_ref"] * gauss
    want = np.asarray(japply.make_rebin_fn(_jax_cfg(cfg),
                                           apply_pixel_map=False)(
        jnp.asarray(db)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=1e-5)


@pytest.mark.parametrize("gauss", [False, True], ids=["plain", "gauss"])
def test_plain_versions_give_a_pixel_block_of_the_jax_rebin(gauss):
    """A pixel block (one entry of a mesh's pixel axis) through the plain
    versions is that block of the JAX rebin: the interp's own columns
    unfiltered, the whole row then the cut under the filter."""
    import jax.numpy as jnp
    from waveform_tpu.rebin import apply as japply
    cfg = _port_cfg(fft_size=2048, width=300, interp_mode="LANCZOS",
                    filter_mode="GAUSS" if gauss else "NONE")
    db = np.random.default_rng(5).uniform(
        -65.0, 0.0, (3, 2, cfg.num_bins)).astype(np.float32)
    want = np.asarray(japply.make_rebin_fn(_jax_cfg(cfg),
                                           apply_pixel_map=False)(
        jnp.asarray(db)))
    for p0, p1 in ((0, 150), (150, 300), (77, 78)):
        got = tapply.make_rebin_fn(cfg, apply_pixel_map=False, device="cpu",
                                   pixels=(p0, p1))(torch.from_numpy(db))
        np.testing.assert_allclose(got.numpy(), want[..., p0:p1],
                                   rtol=2.5e-7, atol=1e-5)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    """A CPU tensor goes to the plain version: the same bits, and no
    launch counted."""
    cfg = _port_cfg(fft_size=2048, width=300, interp_mode="LANCZOS")
    t = build_interp_tables(cfg)
    taps, w = torch.from_numpy(t.taps), torch.from_numpy(t.weights)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -65.0, 0.0, (4, 2, cfg.num_bins)).astype(np.float32))
    before = LAUNCHES.copy()
    got = rebin_cuda.rebin_interp(x[:, :1], taps, w)
    assert torch.equal(got, rebin_cuda.rebin_interp_ref(x[:, :1],
                                                        taps.long(), w))
    gt = build_gauss_tables(1.5, 300)
    gw, gr = torch.from_numpy(gt.weights), torch.from_numpy(gt.renorm)
    smooth = rebin_cuda.rebin_gauss(got, gw, gr)
    assert torch.equal(smooth, rebin_cuda.rebin_gauss_ref(
        got, [float(v) for v in gt.weights], gr))
    assert LAUNCHES == before


@pytest.mark.parametrize("case", ["contiguous", "channel_slice", "one_row",
                                  "four_dims", "merged_view", "broadcast"])
def test_rows_layout_merges_strided_dims(case):
    """``_rows`` gives the kernel each row's offset as ``a * stride_a + b
    * stride_b``: every row of the tensor is found at its own offset."""
    base = torch.zeros(6, 4, 3, 50)
    x = {"contiguous": base[0],
         "channel_slice": base[:, 1, :2],
         "one_row": base[2, 1, 0],
         "four_dims": base,
         "merged_view": base[:, :, 1:2],
         "broadcast": base[0, 0, :1].expand(5, 7, 50)}[case]
    rows, inner, sa, sb = rebin_cuda._rows(x)
    flat = x.reshape(-1, x.shape[-1]) if x.dim() > 1 else x[None]
    assert rows == flat.shape[0]
    offs = [(r // inner) * sa + (r % inner) * sb for r in range(rows)]
    lead = x.shape[:-1]
    want = [sum(i * st for i, st in zip(np.unravel_index(r, lead),
                                        x.stride()[:-1])) if lead else 0
            for r in range(rows)]
    assert offs == want


def test_rows_layout_refuses_what_the_kernel_does_not_take():
    """Bins that are not adjacent, and leading dims that do not merge into
    two, raise ValueError."""
    base = torch.zeros(6, 4, 3, 50)
    with pytest.raises(ValueError, match="contiguous along"):
        rebin_cuda._rows(base.transpose(-1, -2))
    with pytest.raises(ValueError, match="two strided dims"):
        rebin_cuda._rows(base[:, 1:3, :2])


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


# the benchmark cells' rebins: (settings, streams S, state channels O,
# display channels D)
CELLS = {
    "studio16384": (dict(fft_size=16384, enable_large_fft=True, width=800,
                         channel_mode="STEREO", interp_mode="LANCZOS",
                         filter_mode="GAUSS", filter_radius=1.5), 256, 2, 2),
    "curve65536": (dict(fft_size=65536, enable_large_fft=True, width=800,
                        interp_mode="CATROM"), 32, 2, 1),
}


def _tables(cfg, dev):
    t = build_interp_tables(cfg)
    return (torch.from_numpy(t.taps).to(dev),
            torch.from_numpy(t.weights).to(dev))


def _assert_interp_close(got, x, taps, w):
    """``got`` within (T + 1) * 2^-24 * sum|x * w| of the exact sum of
    the products."""
    prod = x.double()[..., taps.long()] * w.double()
    bound = (taps.shape[1] + 1) * 2.0 ** -24 * prod.abs().sum(-1)
    err = (got.double() - prod.sum(-1)).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


@cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_interp_kernel_matches_its_plain_version(cell, dev):
    """At the cell's shape, on the state's display channels as the tick
    hands them over (a channel slice in mono): one launch, within the
    T-term bound of the exact sum, and within twice it of the plain
    version, checked after a synchronize."""
    settings, S, O, D = CELLS[cell]
    cfg = _port_cfg(**settings)
    taps, w = _tables(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(7)
    x = (torch.rand(S, O, cfg.num_bins, generator=g, device=dev)
         * -65.0)[:, :D]
    before = LAUNCHES["rebin"]
    got = rebin_cuda.rebin_interp(x, taps, w)
    torch.cuda.synchronize()
    assert LAUNCHES["rebin"] == before + 1
    assert got.shape == (S, D, 800) and got.is_contiguous()
    _assert_interp_close(got, x, taps, w)
    want = rebin_cuda.rebin_interp_ref(x, taps.long(), w)
    prod = x.double()[..., taps.long()] * w.double()
    bound = 2 * (taps.shape[1] + 1) * 2.0 ** -24 * prod.abs().sum(-1)
    assert bool(((got.double() - want.double()).abs() <= bound).all())


@cuda
@pytest.mark.parametrize("radius", [1.5, 4.0, 0.3])
@pytest.mark.parametrize("shape", [(256, 2, 800), (3, 37)])
def test_filter_kernel_is_its_plain_version_bit_for_bit(shape, radius, dev):
    """The filter at the studio cell's shape (K = 9) and others (K = 23,
    K = 1; a bar look's 37 outputs): the plain version's bits."""
    P = shape[-1]
    gt = build_gauss_tables(radius, P)
    gw = torch.from_numpy(gt.weights).to(dev)
    gr = torch.from_numpy(gt.renorm).to(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.rand(shape, generator=g, device=dev) * -65.0
    before = LAUNCHES["rebin"]
    got = rebin_cuda.rebin_gauss(x, gw, gr)
    torch.cuda.synchronize()
    assert LAUNCHES["rebin"] == before + 1
    want = rebin_cuda.rebin_gauss_ref(x, [float(v) for v in gt.weights], gr)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@cuda
def test_interp_kernel_takes_edge_clamped_taps(dev):
    """Cutoffs at 0 Hz and 24 kHz clamp Lanczos taps at both ends of the
    bins (repeated taps of zero weight): the kernel reads them as the
    gather does."""
    cfg = _port_cfg(fft_size=4096, width=800, interp_mode="LANCZOS",
                    cutoff_low=0, cutoff_high=24000)
    t = build_interp_tables(cfg)
    assert (t.taps == 0).sum() > t.taps.shape[0] // 100
    assert (t.taps == cfg.num_bins - 1).sum() > 1
    taps, w = _tables(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.rand(8, 2, cfg.num_bins, generator=g, device=dev) * -65.0
    got = rebin_cuda.rebin_interp(x, taps, w)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _assert_interp_close(got, x, taps, w)


@cuda
def test_interp_kernel_at_one_tap_is_the_gather_bit_for_bit(dev):
    """Point mode (T = 1, weight 1): each output is its bin, as the
    gather gives it, on rows of one, two and three leading dims."""
    cfg = _port_cfg(fft_size=4096, width=300, interp_mode="POINT")
    taps, w = _tables(cfg, dev)
    assert taps.shape[1] == 1
    x = torch.randn(3, 4, 2, cfg.num_bins, device=dev)
    for xx in (x[0, 0, 0], x[:, 1], x[..., :1, :], x):
        got = rebin_cuda.rebin_interp(xx, taps, w)
        torch.cuda.synchronize()
        assert torch.equal(got, rebin_cuda.rebin_interp_ref(xx, taps.long(),
                                                            w))


@cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """On CUDA there is no fallback: a wrong device, dtype or shape, or a
    row whose bins are not adjacent, raises ValueError."""
    cfg = _port_cfg(fft_size=2048, width=300, interp_mode="LANCZOS")
    taps, w = _tables(cfg, dev)
    x = torch.rand(4, 2, cfg.num_bins, device=dev)
    bad_interp = [
        (x, taps.cpu(), w),                        # tables on another device
        (x.double(), taps, w),                     # rows not float32
        (x, taps.long(), w),                       # taps not int32
        (x, taps, w.double()),                     # weights not float32
        (x, taps[:, :3].contiguous(), w[:, :3].contiguous()),   # T = 3
        (x, taps, w[:-1]),                         # shapes differ
        (x.transpose(-1, -2).contiguous().transpose(-1, -2), taps, w),
        (torch.rand(4, 3, 3, cfg.num_bins, device=dev)[:, 1:, :2], taps, w),
    ]
    for args in bad_interp:
        with pytest.raises(ValueError):
            rebin_cuda.rebin_interp(*args)
    gt = build_gauss_tables(1.5, 300)
    gw = torch.from_numpy(gt.weights).to(dev)
    gr = torch.from_numpy(gt.renorm).to(dev)
    v = torch.rand(4, 2, 300, device=dev)
    bad_gauss = [
        (v, gw.cpu(), gr),                         # tables on another device
        (v.double(), gw, gr),                      # rows not float32
        (v, gw[:-1], gr),                          # K even
        (v, gw, gr[:-1]),                          # renorm of another width
        (v[..., ::2], gw, gr[:150].contiguous()),  # rows not contiguous
    ]
    for args in bad_gauss:
        with pytest.raises(ValueError):
            rebin_cuda.rebin_gauss(*args)
    rebin = tapply.make_rebin_fn(cfg, apply_pixel_map=False, device=dev)
    with pytest.raises(ValueError):
        rebin(x.double())


@cuda
def test_make_rebin_fn_forces_no_plain_form_on_the_card(dev, monkeypatch):
    """On CUDA the rebin runs its kernels and nothing else: ``dense=True``
    or ``False``, or ``WAVEFORM_TPU_REBIN`` set to ``dense`` or
    ``gather``, raises ValueError there; the CPU keeps the forced
    forms."""
    cfg = _port_cfg(fft_size=2048, width=300, interp_mode="LANCZOS",
                    filter_mode="GAUSS")
    monkeypatch.delenv("WAVEFORM_TPU_REBIN", raising=False)
    for dense in (True, False):
        with pytest.raises(ValueError, match="on CUDA"):
            tapply.make_rebin_fn(cfg, device=dev, dense=dense)
        tapply.make_rebin_fn(cfg, device="cpu", dense=dense)
    for mode in ("dense", "gather"):
        monkeypatch.setenv("WAVEFORM_TPU_REBIN", mode)
        with pytest.raises(ValueError, match="on CUDA"):
            tapply.make_rebin_fn(cfg, device=dev)
        tapply.make_rebin_fn(cfg, device="cpu")


@cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_cell_tick_replays_the_rebin_kernels(cell, dev, monkeypatch):
    """A captured ``ServingEngine`` tick of the cell's look launches K2,
    the ring's push, the tail's pair and the rebin's kernels, two where
    the look filters; its pixels are those of an engine whose rebin runs
    the plain versions (``rebin_interp_ref``, ``rebin_gauss_ref``) within
    1e-4 dB wherever they show (above -120 dBFS; the empty window's
    DB_MIN, -758.6, carries a larger ulp)."""
    from waveform_tpu_torch.runtime.serving import ServingEngine
    monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", "3")
    monkeypatch.delenv("WAVEFORM_TPU_REBIN", raising=False)
    settings, S, _, _ = CELLS[cell]
    cfg = _port_cfg(**settings)
    eng = ServingEngine(cfg, S, device=dev)
    gwl = [float(v) for v in build_gauss_tables(
        cfg.settings.filter_radius, 800).weights]
    with monkeypatch.context() as plain:
        plain.setattr(tapply, "rebin_interp", lambda x, taps, w:
                      rebin_cuda.rebin_interp_ref(x, taps.long(), w))
        plain.setattr(tapply, "rebin_gauss", lambda x, w, renorm:
                      rebin_cuda.rebin_gauss_ref(x, gwl, renorm))
        ref = ServingEngine(cfg, S, device=dev)
    rng = np.random.default_rng(26)
    shown = 0
    for k in range(6):
        now = 10_000_000_000 + k * 16_666_667
        x = (0.3 * rng.standard_normal((S, 2, 1024))).astype(np.float32)
        for e in (eng, ref):
            e.feed_batch(x, now, now_ns=now)
        a, b = eng.tick(now_ns=now), ref.tick(now_ns=now)
        torch.cuda.synchronize()
        vis = b > -120.0
        shown += int(vis.sum())
        gap = (a - b)[vis].abs()
        assert gap.numel() == 0 or float(gap.max()) < 1e-4, k
    assert shown > 0
    want = {"K2": 1, "ring": 1, "tail": 2,
            "rebin": 2 if tapply.filters(cfg) else 1}
    assert eng.kernels_per_replay == {("tick", True): want}
    assert ref.kernels_per_replay == {
        ("tick", True): {"K2": 1, "ring": 1, "tail": 2}}
