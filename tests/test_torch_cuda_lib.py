"""The port's CUDA library (``kernels/cuda_lib.py``) on the CPU: the launch
table's names, the twins' silence in it, and who imports the library.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``tests/test_torch_tail_cuda.py``).
"""

import ast
from pathlib import Path

import numpy as np
import torch

import waveform_tpu_torch as wt
from waveform_tpu_torch.dsp import devring
from waveform_tpu_torch.dsp import spectrum as tspec
from waveform_tpu_torch.kernels import cuda_lib, exact_cuda

PKG = Path(wt.__file__).resolve().parent


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _launched_names(tree: ast.Module) -> set:
    """The string constants in the name argument of every ``launched``
    call in ``tree`` (both arms of a conditional name included)."""
    names = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        fn = node.func
        called = fn.attr if isinstance(fn, ast.Attribute) else getattr(
            fn, "id", None)
        if called == "launched":
            names |= {c.value for c in ast.walk(node.args[0])
                      if isinstance(c, ast.Constant)
                      and isinstance(c.value, str)}
    return names


def _imported(tree: ast.Module) -> set:
    """The last dotted part of every module and name ``tree`` imports."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.rsplit(".", 1)[-1] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.module:
                out.add(node.module.rsplit(".", 1)[-1])
            out |= {a.name for a in node.names}
    return out


def test_launchers_count_the_kernel_tables_names():
    """Every kernel of ``exact_cuda.KERNELS``, the tail's pair, the
    rotating ring's push and the rebin's pair is a name that a launcher
    counts, and no launcher counts another name."""
    counted = set()
    for path in sorted((PKG / "kernels").glob("*.py")):
        counted |= _launched_names(_tree(path))
    assert counted == {*exact_cuda.KERNELS.values(), "tail", "ring",
                       "rebin"}


def test_cpu_twins_count_no_launch_and_build_nothing(monkeypatch):
    """The CPU twins of every exact kernel (with and without heads), the
    rotating ring's push, the spectrum step on CPU tensors (its FFT
    twin and the plain tail) and a filtered rebin (the plain interp and
    filter) leave the launch table as it was and never ask for the
    library."""
    def no_build():
        raise AssertionError("the library was built on the CPU")
    monkeypatch.setattr(cuda_lib, "build", no_build)
    before = cuda_lib.LAUNCHES.copy()
    rng = np.random.default_rng(11)
    x = torch.from_numpy((0.3 * rng.standard_normal((2, 2, 4096)))
                         .astype(np.float32))
    for twiddle in ("f32", "df"):
        exact_cuda.rfft_pair_mag_gen(x, twiddle=twiddle)
        exact_cuda.rfft_pair_mag3(x, twiddle=twiddle)
    exact_cuda.rfft_pair_mag(x)
    exact_cuda.rfft_pair_mag(x, head=torch.ones((2, 2), dtype=torch.int32))
    exact_cuda.cfft_exact_kernel(x[:, 0, :1024], x[:, 1, :1024])
    ring = devring.init_ring(2, 2, 4096, device="cpu", rotating=True)
    devring.push_rotating(ring, x[..., :100], torch.tensor(100))
    cfg = wt.resolve(wt.Settings(fft_size=1024, window=wt.FFTWindow.HANN),
                     wt.AudioInfo(48000, 2))
    step = tspec.make_spectrum_step(cfg, device="cpu")
    state = tspec.init_state(cfg, 2, "cpu")
    state = step(x[..., :1024].contiguous(), state, 1 / 60,
                 torch.ones(2, dtype=torch.bool), torch.full((2,), 0.1))
    assert torch.isfinite(state.tsmooth).all()
    from waveform_tpu_torch.rebin.apply import make_rebin_fn
    gauss = wt.resolve(wt.Settings(fft_size=1024, width=200,
                                   filter_mode=wt.FilterMode.GAUSS),
                       wt.AudioInfo(48000, 2))
    px = make_rebin_fn(gauss, device="cpu")(state.decibels)
    assert px.shape == (2, 2, 200)
    assert cuda_lib.LAUNCHES == before


def test_only_the_kernels_reach_the_fft_module():
    """The serving layers (``runtime/``, ``parallel/``) and the tail reach
    the library through ``cuda_lib``, never through the FFT module
    ``exact_cuda``; the library itself imports neither kernel module."""
    paths = [*sorted((PKG / "runtime").glob("*.py")),
             *sorted((PKG / "parallel").glob("*.py")),
             PKG / "kernels" / "tail_cuda.py"]
    for path in paths:
        assert "exact_cuda" not in _imported(_tree(path)), path
    lib = _imported(_tree(PKG / "kernels" / "cuda_lib.py"))
    assert not lib & {"exact_cuda", "tail_cuda"}, lib
