"""The port's auxiliary modules against the JAX package's: settings I/O
(``core/settings_io.py``), the locale tables (``core/locale.py``), the
startup banner (``utils/log.py``) and wisdom (``utils/wisdom.py``).

The copies must behave as the JAX modules do on the same input: the same
OBS key/value dicts, the same ``Settings`` (compared field by field, enum
members by name), the same locale tables entry for entry.
"""

import dataclasses
import enum
import json
import logging

import pytest
import torch

import waveform_tpu as jwt
from waveform_tpu.core import locale as jlocale
from waveform_tpu.core import settings_io as jio
import waveform_tpu_torch as wt
from waveform_tpu_torch.core import locale, settings_io
from waveform_tpu_torch.kernels import cuda_lib
from waveform_tpu_torch.utils import log, wisdom


def _plain(s) -> dict:
    """A Settings dataclass as plain values (enum members by name, colors
    as tuples), comparable across the two packages."""
    out = {}
    for f in dataclasses.fields(s):
        v = getattr(s, f.name)
        if isinstance(v, enum.Enum):
            v = v.name
        elif dataclasses.is_dataclass(v):
            v = dataclasses.astuple(v)
        out[f.name] = v
    return out


OBS_SCENE = {
    # an OBS scene-collection settings block, as the plugin stores it
    "display_mode": "stepped_bars", "fft_size": 2048, "window": "blackman",
    "gravity": 0.3, "color_base": 0xFF0080FF, "color_crest": 0x80FFFFFF,
    "render_mode": "gradient", "temporal_smoothing": "tvexpsmoothing",
    "interp_mode": "catrom", "slope": 1.5, "deadzone": 20, "unknown": 1,
    "filter_mode": "not-an-enum",
}


def test_settings_from_obs_matches_jax():
    got = settings_io.settings_from_obs(OBS_SCENE)
    want = jio.settings_from_obs(OBS_SCENE)
    assert isinstance(got, wt.Settings)
    assert _plain(got) == _plain(want)
    assert settings_io.settings_to_obs(got) == jio.settings_to_obs(want)
    assert got.display_mode == wt.DisplayMode.STEPPED_BAR
    assert got.filter_mode == wt.Settings().filter_mode   # unknown enum


def test_settings_round_trip(tmp_path):
    s = wt.Settings(fft_size=2048, window=wt.FFTWindow.BLACKMAN,
                    display_mode=wt.DisplayMode.STEPPED_BAR, gravity=0.3,
                    color_base=wt.RGBA(1.0, 0.5, 0.0, 1.0), slope=1.5)
    p = tmp_path / "settings.json"
    settings_io.save_settings(str(p), s)
    back = settings_io.load_settings(str(p))
    assert _plain(back) == _plain(jio.load_settings(str(p)))
    # colors travel as packed 8-bit ABGR: the rest comes back as it went
    assert _plain(dataclasses.replace(back, color_base=s.color_base)) \
        == _plain(s)
    jp = tmp_path / "jax.json"
    jio.save_settings(str(jp), jio.load_settings(str(p)))
    assert json.loads(jp.read_text()) == json.loads(p.read_text())


def test_locale_tables_equal_jax():
    assert locale.LOCALES == jlocale.LOCALES
    for loc in list(locale.LOCALES) + ["xx-XX"]:
        for key in ("fft_size", "window", "gravity", "nonexistent"):
            assert locale.label(key, loc) == jlocale.label(key, loc)
            assert locale.tooltip(key, loc) == jlocale.tooltip(key, loc)
        for v in (wt.RenderMode.LINE, wt.FFTWindow.HANN, "solid"):
            jv = (getattr(jwt, type(v).__name__)[v.name]
                  if isinstance(v, enum.Enum) else v)
            assert locale.enum_label(v, loc) == jlocale.enum_label(jv, loc)
    assert locale.label("fft_size", "zh-CN") == "FFT 大小"


@pytest.fixture
def records():
    got = []

    class Keep(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())

    logger = log.get_logger()
    h = Keep()
    logger.addHandler(h)
    yield got
    logger.removeHandler(h)


def test_startup_banner_names_the_cpu(records):
    log.log_startup_banner("cpu")
    text = "\n".join(records)
    assert f"v{wt.__version__}" in text and torch.__version__ in text
    assert "Devices: cpu" in text
    assert log.get_logger().name == "waveform_tpu_torch"
    assert log.get_logger() is log.get_logger()


def test_wisdom_enable_moves_the_build(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_lib, "_BUILD", cuda_lib._BUILD)
    default = wisdom.enable()
    assert default == str(cuda_lib._BUILD)
    d = wisdom.enable(str(tmp_path / "kernels"))
    assert d == str(tmp_path / "kernels") and (tmp_path / "kernels").is_dir()
    assert cuda_lib._BUILD == tmp_path / "kernels"


def test_wisdom_warm_on_the_cpu_builds_nothing(monkeypatch):
    """warm() on the CPU runs one silent tick of a throwaway engine (the
    twin) and never reaches the nvcc build."""
    def no_build():
        raise AssertionError("built on the CPU")

    monkeypatch.setattr(cuda_lib, "build", no_build)
    cfg = wt.resolve(wt.Settings(fft_size=1024, width=200),
                     wt.AudioInfo(48000, 2))
    wisdom.warm(cfg, num_streams=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            wisdom.warm(cfg, num_streams=2)


def test_obs_settings_resolve_as_in_jax():
    """A settings block loaded by the port resolves to the config the JAX
    package resolves from the same block."""
    s = settings_io.settings_from_obs(OBS_SCENE)
    cfg = wt.resolve(s, wt.AudioInfo(48000, 2))
    jcfg = jwt.resolve(jio.settings_from_obs(OBS_SCENE),
                       jwt.AudioInfo(48000, 2))
    assert (cfg.fft_size, cfg.num_bins, cfg.width, cfg.height) == (
        jcfg.fft_size, jcfg.num_bins, jcfg.width, jcfg.height)
    assert cfg.display_mode.name == jcfg.display_mode.name


def test_no_gc_holds_the_collector_off():
    """A capture runs with the collector off (``runtime/graphs.no_gc``): a
    dropped engine's graphs are freed by the collector, and freeing a
    graph inside a capture invalidates it.  Garbage made in the block
    waits for a collection after it; a caller's disabled collector stays
    disabled."""
    import gc
    import weakref

    from waveform_tpu_torch.runtime import graphs

    class Cycle:
        pass

    assert gc.isenabled()
    with graphs.no_gc():
        assert not gc.isenabled()
        a = Cycle()
        a.self = a
        ref = weakref.ref(a)
        del a
        [[] for _ in range(50_000)]     # would set off a collection
        assert ref() is not None
    assert gc.isenabled()
    gc.collect()
    assert ref() is None
    gc.disable()
    try:
        with graphs.no_gc():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
