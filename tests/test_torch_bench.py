"""The port's bench (``waveform_tpu_torch/bench.py``) and its cost model
(``exact_cuda.kernel_cost``) against the JAX package's.

* ``kernel_cost`` resolves the stage-1 split as ``exact_pallas.
  kernel_cost`` does, under the same variable and plan file, and its
  bounds at ``PERF.md`` section 6's shapes are the numbers there (to the
  hundredth of a µs); ``chip_smoke.py``'s ``bound`` is the same function.
* The bench's tick body (``make_bench_tick``) and the JAX bench's (push ->
  step -> ``rebin(display_decibels)``, natural order, the Pallas kernel in
  interpret mode) take 3 ticks of the same seeded numpy audio at S=2,
  N=1024: the pixels agree within 1e-4 dB.
* ``accuracy_gate`` and the JAX gate's steps (``waveform_tpu/bench.py:
  253-276``) on the same window: both under 1e-4 dB and within 1e-5 dB of
  each other.
* ``bench.main`` runs whole on the CPU at a small size and prints the
  headline JSON line; without ``--device cpu`` and without a card it
  raises.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import waveform_tpu as jwt
from waveform_tpu.dsp import devring as jdevring
from waveform_tpu.dsp import oracle as joracle
from waveform_tpu.dsp import spectrum as jspec
from waveform_tpu.kernels import exact_pallas
from waveform_tpu.rebin.apply import make_rebin_fn as jmake_rebin_fn
from waveform_tpu_torch import bench
from waveform_tpu_torch.dsp.devring import init_ring
from waveform_tpu_torch.dsp.spectrum import init_state
from waveform_tpu_torch.kernels import exact_cuda
from waveform_tpu_torch.utils import plans

ROOT = Path(__file__).resolve().parents[1]
N, S, W, HOP = 1024, 2, 800, 800


@pytest.fixture
def plan_file(tmp_path, monkeypatch):
    """An empty plan-file path for both packages and no split variable."""
    pf = tmp_path / "plans.json"
    monkeypatch.setenv("WAVEFORM_TPU_PLAN_FILE", str(pf))
    monkeypatch.delenv("WAVEFORM_TPU_STAGE1_SPLIT", raising=False)
    monkeypatch.setattr(plans, "_packaged_plans", lambda: {})
    return pf


@pytest.fixture
def kernel_on(monkeypatch, plan_file):
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_INTERPRET", "1")
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    for v in ("WAVEFORM_TPU_EXACT_FUSED", "WAVEFORM_TPU_EXACT_PACKED",
              "WAVEFORM_TPU_KERNEL_TWIDDLE"):
        monkeypatch.delenv(v, raising=False)


SPLIT_CASES = {
    # name: (plan file contents or None, WAVEFORM_TPU_STAGE1_SPLIT)
    "default": (None, None),
    "file": ({"4096": {"split": 3}, "16384": {"split": 2}}, None),
    "env2": (None, "2"),
    "env3": (None, "3"),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_kernel_cost_split_matches_jax(case, plan_file, monkeypatch):
    plan, env = SPLIT_CASES[case]
    if plan is not None:
        plan_file.write_text(json.dumps(plan))
    if env is not None:
        monkeypatch.setenv("WAVEFORM_TPU_STAGE1_SPLIT", env)
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "always")
    checked = 0
    for n in (1024, 2048, 4096, 8192, 12288, 16384, 24576, 32768, 65536):
        if not (exact_cuda.supports(n) and exact_pallas.supports(n)):
            continue
        c = exact_cuda.kernel_cost(n, 256)
        assert c["split"] == exact_pallas.kernel_cost(n, 256)["split"], n
        assert c["kernel"] == {2: "K1-gen", 3: "K2"}[c["split"]]
        checked += 1
    assert checked >= 4


# PERF.md section 6's bounds: (split, n, streams) -> (µs, bound by)
BOUNDS = {
    (2, 4096, 256): (6.78, "operations"),      # K1-gen at the headline
    (3, 65536, 32): (32.55, "operations"),     # K2
    ("cfft", 4096, 256): (10.12, "bytes"),     # K3
    ("cfft", 32768, 32): (16.28, "operations"),
    (2, 6144, 256): (11.19, "operations"),
    (2, 16384, 256): (43.41, "operations"),
}


@pytest.mark.parametrize("shape", list(BOUNDS))
def test_kernel_bound_is_perf_md_table(shape):
    split, n, s = shape
    sec, by = exact_cuda.kernel_bound(n, s, split, "f32")
    assert (round(sec * 1e6, 2), by) == BOUNDS[shape]
    c = exact_cuda.kernel_cost(n, s, split, "f32")
    assert sum(c["stage_ops"]) == c["int8_ops"]
    df = exact_cuda.kernel_cost(n, s, split, "df")
    assert (df["int8_ops"], df["hbm_bytes"]) == (c["int8_ops"],
                                                 c["hbm_bytes"])


def test_chip_smoke_bound_calls_kernel_cost():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for (split, n, s), (us, by) in BOUNDS.items():
        name = {2: "exact_mag_gen", 3: "exact_mag3", "cfft": "exact_cfft"}
        ms, got_by = cs.bound(name[split], n, s)
        assert (round(ms * 1e3, 2), got_by) == (us, by)
    assert cs.stage_ops("K3", 4096, 256) == exact_cuda.kernel_cost(
        4096, 256, "cfft")["stage_ops"]


def test_kernel_cost_names_each_kernel(plan_file, monkeypatch):
    monkeypatch.setenv("WAVEFORM_TPU_KERNEL_TWIDDLE", "df")
    assert exact_cuda.kernel_cost(4096, 8)["kernel"] == "K1-df"
    assert exact_cuda.kernel_cost(65536, 8)["kernel"] == "K2-df"
    assert exact_cuda.kernel_cost(4096, 8, twiddle="f32")["kernel"] == \
        "K1-gen"
    assert exact_cuda.kernel_cost(4096, 8, "cfft")["kernel"] == "K3"
    with pytest.raises(ValueError):
        exact_cuda.kernel_cost(4096, 8, 4)


def test_roofline_shares_and_routes(plan_file, monkeypatch):
    """The roofline's shares are the cost over the peaks; a size with no
    hand kernel says what runs instead, and under FUSED=never K3 is the
    kernel of the packed pair."""
    monkeypatch.delenv("WAVEFORM_TPU_EXACT_FUSED", raising=False)
    monkeypatch.delenv("WAVEFORM_TPU_EXACT_PACKED", raising=False)
    monkeypatch.delenv("WAVEFORM_TPU_EXACT_KERNEL", raising=False)
    monkeypatch.setenv("WAVEFORM_TPU_FFT_BACKEND", "exact")
    cfg = bench.build_cfg(4096, W)
    text, share = bench.roofline(cfg, 256, 2000.0)
    c = exact_cuda.kernel_cost(4096, 256)
    assert share["int8"] == pytest.approx(
        100 * c["int8_ops"] * 2000.0 / exact_cuda.INT8_PEAK_OPS)
    assert "K1-gen" in text and "serial" in text
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_FUSED", "never")
    assert "[K3 split=cfft" in bench.roofline(cfg, 256, 2000.0)[0]
    monkeypatch.setenv("WAVEFORM_TPU_EXACT_KERNEL", "never")
    text, share = bench.roofline(cfg, 256, 2000.0)
    assert share == {} and "digit lowering" in text
    assert "no hand kernel" in bench.roofline(bench.build_cfg(800, W), 256,
                                              1.0)[0]


def _audio(k: int) -> np.ndarray:
    rng = np.random.default_rng(100 + k)
    return (rng.random((S, 2, HOP)) - 0.5).astype(np.float32)


def _jax_cfg():
    return jwt.resolve(jwt.Settings(
        fft_size=N, width=W, window=jwt.FFTWindow.HANN,
        interp_mode=jwt.InterpMode.LANCZOS, enable_large_fft=True),
        jwt.AudioInfo(48000, 2))


def test_bench_tick_matches_jax(kernel_on):
    cfg = bench.build_cfg(N, W)
    tick = bench.make_bench_tick(cfg, S, "cpu")
    ring, state = init_ring(S, 2, N, "cpu"), init_state(cfg, S, "cpu")
    jcfg = _jax_cfg()
    jstep = jspec.make_spectrum_step(jcfg)
    jrebin = jmake_rebin_fn(jcfg, apply_pixel_map=False)
    jring, jstate = jdevring.init_ring(S, 2, N), jspec.init_state(jcfg, S)
    ones, zeros = jnp.ones(S, bool), jnp.zeros(S, jnp.float32)
    for k in range(3):
        x = _audio(k)
        px = tick(ring, state, torch.from_numpy(x)).numpy()
        jring = jdevring.push(jring, jnp.asarray(x), jnp.int32(HOP))
        jstate = jstep(jring.view3, jstate, jnp.float32(1 / 60), ones, zeros)
        want = np.asarray(jrebin(jspec.display_decibels(jcfg, jstate)))
        assert px.shape == want.shape == (S, 1, W)
        vis = want > -120.0
        assert vis.mean() > 0.9
        np.testing.assert_allclose(px[vis], want[vis], rtol=0, atol=1e-4,
                                   err_msg=f"tick {k}")
    np.testing.assert_array_equal(ring.buf.numpy(),
                                  np.asarray(jring.view3))


def test_accuracy_gate_matches_jax_gate(kernel_on):
    cfg = bench.build_cfg(N, W)
    ring = init_ring(S, 2, N, "cpu")
    tick = bench.make_bench_tick(cfg, S, "cpu")
    state = init_state(cfg, S, "cpu")
    for k in range(2):
        tick(ring, state, torch.from_numpy(_audio(k)))
    window = ring.buf[0].numpy().astype(np.float64)
    got_max, got_l2 = bench.accuracy_gate(cfg, window, "cpu")
    # the JAX gate's steps, waveform_tpu/bench.py:259-276
    acc = jwt.resolve(jwt.Settings(
        fft_size=N, width=W, window=jwt.FFTWindow.HANN,
        temporal_smoothing=jwt.TSmoothingMode.NONE, enable_large_fft=True),
        jwt.AudioInfo(48000, 2))
    want, _ = joracle.spectrum_frame(window, None, acc, dt=1 / 60)
    st2 = jax.jit(jspec.make_spectrum_step(acc))(
        jnp.asarray(window[None], jnp.float32), jspec.init_state(acc, 1),
        jnp.float32(1 / 60), jnp.ones(1, bool), jnp.zeros(1, jnp.float32))
    got = np.asarray(jspec.display_decibels(acc, st2))[0]
    vis = want > -120.0
    jax_max = float(np.abs(got[vis] - want[vis]).max())
    jax_l2 = float(np.linalg.norm(got[vis] - want[vis])
                   / np.linalg.norm(want[vis]))
    assert got_max < 1e-4 and jax_max < 1e-4
    assert abs(got_max - jax_max) < 1e-5
    assert got_l2 < 1e-6 and jax_l2 < 1e-6


def test_dispatch_draws_new_audio_each_tick():
    cfg = bench.build_cfg(N, W)
    d = bench.Dispatch(cfg, S, torch.device("cpu"), seed=7)
    d.check_draws()
    first = d.new.clone()
    assert float(first.min()) >= -0.5 and float(first.max()) < 0.5
    again = bench.Dispatch(cfg, S, torch.device("cpu"), seed=7)
    again.check_draws()
    assert torch.equal(again.new, first)       # the seed fixes the audio


def test_bench_main_on_the_cpu(capsys, plan_file):
    assert bench.main(["--device", "cpu", "--streams", "2", "--fft", "1024",
                       "--scan", "2", "--reps", "1", "--warmup", "1",
                       "--sizes", ""]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metric"] == "1024pt_spectrum_frames_per_sec_per_chip"
    assert line["unit"] == "frames/s" and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 15360,
                                                abs=1e-3)
    mfu = [ln for ln in err.splitlines() if ln.startswith("# MFU")]
    assert len(mfu) == 1 and "K1-gen" in mfu[0] and mfu[0].endswith("[cpu]")
    summary = err.strip().splitlines()[-1]
    assert summary.startswith("# accuracy") and "sharded engine: ok" in \
        summary


def test_bench_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--streams", "2", "--fft", "1024", "--sizes", ""])
