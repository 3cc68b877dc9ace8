"""Exact |rFFT| of channel pairs: the Hopper kernel, its plain twin, the build.

The PyTorch counterpart of ``waveform_tpu/kernels/exact_pallas.py``'s
real-split magnitude kernel (``_kernel_real_mag``, 2-factor stage 1, f32
twiddle tier).  :func:`rfft_pair_mag` is the entry point:

* a CUDA tensor launches the hand-written kernel in ``csrc/exact_mag.cu``,
  built with ``nvcc`` at first use into ``build/waveform_tpu_torch/`` and
  bound with ``ctypes``; a build or launch failure raises;
* a CPU tensor runs :func:`rfft_pair_mag_ref`, the same arithmetic in
  torch ops (digit products in float64, exact because every integer
  partial sum stays far below 2^53).

The kernel and the twin take the same rounding steps in the same order,
so they agree bit for bit.  Bins come out in natural order.

Geometry: N = 128·N1 (j = 128·j1 + j2, k = k1 + N1·k2), 4 base-2^7 digit
planes with the first 6 bits deep, digit pairs with i + j <= 3 kept
(``exactfft.DIGIT_BITS/FIRST_SHIFT/MAX_T``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .exactfft import DIGIT_BITS, FIRST_SHIFT, MAX_T, _windowed_df

LANES = 128                     # N2: the stage-2 transform length
N_DIGITS = MAX_T + 1
SIZES = (1024, 2048, 4096)      # N1 = 8, 16, 32: what the kernel is built for

# fixed-point geometry of the parallel digit extraction: i = rint(r·2^27)
# splits into 4 offset-binary base-128 fields
_SLICE_TOP = FIRST_SHIFT + (N_DIGITS - 1) * DIGIT_BITS            # 27
_SLICE_BIAS = sum(64 << (_SLICE_TOP - FIRST_SHIFT - DIGIT_BITS * k)
                  for k in range(N_DIGITS))
_CLAMP = 2.0 ** 63

# count of kernel launches (not of twin calls): a run reads it to show
# that its main path went through the kernel
launches = 0


# ---------------------------------------------------------------------------
# host plan: the same numpy builders as exact_pallas
# ---------------------------------------------------------------------------

def _vsplit_host(a_f32: np.ndarray) -> np.ndarray:
    """Veltkamp-high half of an f32 array, in f32 arithmetic."""
    c = np.float32(4097.0)
    t = (c * a_f32).astype(np.float32)
    return (t - (t - a_f32).astype(np.float32)).astype(np.float32)


def _digit_planes(a64: np.ndarray) -> np.ndarray:
    """f64 constant -> N_DIGITS integer digit planes (f32 storage)."""
    out = np.empty((N_DIGITS,) + a64.shape, np.float32)
    r = a64.astype(np.float64)
    for k in range(N_DIGITS):
        sc = 2.0 ** (FIRST_SHIFT + DIGIT_BITS * k)
        d = np.rint(r * sc)
        out[k] = d.astype(np.float32)
        r = r - d / sc
    return out


@functools.lru_cache(maxsize=8)
def _kernel_plan_real(n: int):
    """Constants of the real-split transform at size ``n``.

    Returns ``(n1, n2, f1d, f2d, twr_hi, twr_lo, twi_hi, twi_lo, twr_h,
    twi_h)``: ``f1d`` [4, 2n1, n1] digit planes of F1r = [Re f1; Im f1]
    (stage 1 per channel, contracting j1), ``f2d`` [4, 2n2, n2] digit
    planes of the kept-half stage-2 block [[Re f2, Im f2], [-Im f2, Re f2]]
    restricted to k2 < n2/2, the outer twiddle exp(-2πi·k1·j2/n) [n1, n2]
    as a df32 pair, and the Veltkamp-high halves of its hi words.  The f32
    twiddle tier reads ``twr_hi``/``twi_hi`` only; the rest serve the df
    tier (see ROADMAP).
    """
    n1, n2 = n // LANES, LANES
    f1 = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1)
    f2 = np.exp(-2j * np.pi * np.outer(np.arange(n2), np.arange(n2)) / n2)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)
    f1r = np.concatenate([f1.real, f1.imag], axis=0)          # [2n1, n1]
    keep = n2 // 2
    f2b_kept = np.block([[f2.real[:, :keep], f2.imag[:, :keep]],
                         [-f2.imag[:, :keep], f2.real[:, :keep]]])
    twr_hi = tw.real.astype(np.float32)
    twi_hi = tw.imag.astype(np.float32)
    twr_lo = (tw.real - twr_hi.astype(np.float64)).astype(np.float32)
    twi_lo = (tw.imag - twi_hi.astype(np.float64)).astype(np.float32)
    return (n1, n2, _digit_planes(f1r), _digit_planes(f2b_kept),
            twr_hi, twr_lo, twi_hi, twi_lo,
            _vsplit_host(twr_hi), _vsplit_host(twi_hi))


@functools.lru_cache(maxsize=16)
def _consts(n: int, device: torch.device):
    """The plan as tensors on ``device``: the digit planes as float64
    matrices (``f1``, ``f2``) for the twin's exact products, and packed
    four int8 digits to an int32 word along each GEMM's contraction axis
    (``f1w`` [4, 2n1, n1/4] over j1, ``f2w`` [4, 2n2/4, n2] over the
    [br | bi] row), the layout the kernel's ``__dp4a`` reads."""
    n1, n2, f1d, f2d, twr, _, twi, _, _, _ = _kernel_plan_real(n)
    f1b = np.ascontiguousarray(f1d.astype(np.int8))
    f2b = np.ascontiguousarray(
        f2d.astype(np.int8).reshape(N_DIGITS, 2 * n2 // 4, 4, n2)
        .transpose(0, 1, 3, 2))
    host = {"twr": twr, "twi": twi,
            "f1": f1d.astype(np.float64), "f2": f2d.astype(np.float64),
            "f1w": f1b.view("<i4").copy(), "f2w": f2b.view("<i4").copy()}
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------

def _pow2_scale(m: torch.Tensor):
    """(s, 1/s) = 2^e with e = clip(ceil(log2(max(m, 1e-30))) + 1, ±125).

    ceil(log2) is read exactly from the float's exponent and mantissa bits,
    as the kernel reads it; a NaN ``m`` gives NaN scales (the lane's own
    output turns NaN, its neighbours keep their scales).
    """
    bits = torch.clamp_min(m, 1e-30).view(torch.int32)
    e = ((bits >> 23) & 255) - 127 + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    e = torch.clamp(e + 1, -125, 125)
    s = ((e + 127) << 23).view(torch.float32)
    s_inv = ((127 - e) << 23).view(torch.float32)
    nan = torch.isnan(m)
    return torch.where(nan, m, s), torch.where(nan, m, s_inv)


def _fixed27(v: torch.Tensor, s_inv: torch.Tensor) -> torch.Tensor:
    """rint(v·s_inv·2^27) as int32, half to even; NaN -> 0 and ±inf
    saturating, as the card's float-to-int conversion does."""
    r = torch.round(v * s_inv * 2.0 ** _SLICE_TOP)
    r = torch.nan_to_num(r, nan=0.0).clamp(-2.0 ** 31, 2.0 ** 31 - 128)
    return r.to(torch.int32)


def _digits(i: torch.Tensor) -> list[torch.Tensor]:
    """The 4 offset-binary digit fields of the fixed-point words, as f64."""
    u = i + _SLICE_BIAS
    return [(((u >> (_SLICE_TOP - FIRST_SHIFT - DIGIT_BITS * k)) & 127) - 64)
            .to(torch.float64) for k in range(N_DIGITS)]


def _recombine(dots: list[torch.Tensor], s: torch.Tensor) -> torch.Tensor:
    """Exact integer class sums -> f32: ((w0 + w1) + w2) + w3 with
    w_t = S_t · (2^-(12+7t) · s)."""
    v = None
    for t, d in enumerate(dots):
        w = d.to(torch.float32) * (s * 2.0 ** -(2 * FIRST_SHIFT
                                                + DIGIT_BITS * t))
        v = w if v is None else v + w
    return v


def rfft_pair_mag_ref(x: torch.Tensor, window=None):
    """Plain PyTorch twin of the kernel: ``x`` [S, 2, N] f32 ->
    ``(mag [S, 2, N/2] f32, nzcount [S, 2] f32)``, bins in natural order.

    ``window`` is a (w_hi, w_lo) df32 pair of [N] tensors or None.
    """
    S, _, n = x.shape
    n1, n2 = n // LANES, LANES
    keep = n2 // 2
    c = _consts(n, x.device)
    nz = (x != 0).sum(-1).to(torch.float32)
    w_hi, w_lo = _window_pair(window, n, x.device)
    xb = x.reshape(S, 2, n1, n2)
    hi, lo = _windowed_df(xb, w_hi.reshape(n1, n2), w_lo.reshape(n1, n2))

    # stage 1: per-channel real DFT over j1, one pow2 scale per (s, j2)
    # column taken over both channels
    s, s_inv = _pow2_scale(hi.abs().amax(dim=(1, 2), keepdim=True))
    d = _digits(_fixed27(hi, s_inv) + _fixed27(lo, s_inv))
    a = _recombine([sum(c["f1"][i] @ d[t - i] for i in range(t + 1))
                    for t in range(N_DIGITS)], s)          # [S, 2, 2n1, n2]
    ar, ai = a[..., :n1, :], a[..., n1:, :]

    # f32 twiddle: every product rounded on its own
    br = ar * c["twr"] - ai * c["twi"]
    bi = ar * c["twi"] + ai * c["twr"]

    # stage 2: one pow2 scale per (s, c, k1) row of [br | bi]
    b = torch.cat([br, bi], dim=-1)                        # [S, 2, n1, 2n2]
    s2, s2_inv = _pow2_scale(b.abs().amax(dim=-1, keepdim=True))
    d2 = _digits(_fixed27(b, s2_inv))
    cc = _recombine([sum(d2[t - i] @ c["f2"][i] for i in range(t + 1))
                     for t in range(N_DIGITS)], s2)        # [S, 2, n1, n2]
    cr = torch.clamp(cc[..., :keep], -_CLAMP, _CLAMP)
    ci = torch.clamp(cc[..., keep:], -_CLAMP, _CLAMP)
    mag = torch.sqrt(cr * cr + ci * ci)                    # [S, 2, k1, k2]
    return mag.transpose(-1, -2).reshape(S, 2, n // 2), nz


def _window_pair(window, n: int, device: torch.device):
    if window is None:
        return (torch.ones(n, dtype=torch.float32, device=device),
                torch.zeros(n, dtype=torch.float32, device=device))
    return window


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "waveform_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_lib = None
build_info: dict = {}    # "library": the .so path; "log": nvcc's output


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def build() -> ctypes.CDLL:
    """Compile ``csrc/*.cu`` into a shared library (once per source hash)
    and bind it.  Raises on a failed build."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    out = _BUILD / f"libwf_exact_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, out)
        build_info["log"] = r.stderr
    build_info["library"] = str(out)
    lib = ctypes.CDLL(str(out))
    lib.wf_exact_mag.restype = ctypes.c_int
    lib.wf_exact_mag.argtypes = ([ctypes.c_void_p] * 9
                                 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p])
    _lib = lib
    return lib


def rfft_pair_mag(x: torch.Tensor, window=None):
    """|rFFT| and raw nonzero counts of [S, 2, N] f32 channel pairs.

    Returns ``(mag [S, 2, N/2] f32, nzcount [S, 2] f32)`` in natural bin
    order.  ``window`` is a (w_hi, w_lo) df32 pair of [N] f32 tensors on
    ``x``'s device, or None for no window.  A CUDA tensor launches the
    kernel, a CPU tensor takes :func:`rfft_pair_mag_ref`.
    """
    global launches
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[1] != 2:
        raise ValueError(f"expected [S, 2, N] float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    n = x.shape[-1]
    if n not in SIZES:
        raise NotImplementedError(
            f"exact |rFFT| kernel covers N in {SIZES}, got N={n}; other sizes "
            "wait for the 3-factor kernel and the exactfft lowering "
            "(ROADMAP B2, B4)")
    w_hi, w_lo = _window_pair(window, n, x.device)
    for w in (w_hi, w_lo):
        if (w.shape != (n,) or w.dtype != torch.float32
                or w.device != x.device or not w.is_contiguous()):
            raise ValueError("window must be a pair of contiguous [N] float32 "
                             "tensors on the input's device")
    if x.device.type == "cpu":
        return rfft_pair_mag_ref(x, (w_hi, w_lo))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    lib = build()
    S = x.shape[0]
    mag = torch.empty((S, 2, n // 2), dtype=torch.float32, device=x.device)
    nz = torch.empty((S, 2), dtype=torch.float32, device=x.device)
    c = _consts(n, x.device)
    with torch.cuda.device(x.device):
        err = lib.wf_exact_mag(
            x.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
            c["f1w"].data_ptr(), c["f2w"].data_ptr(), c["twr"].data_ptr(),
            c["twi"].data_ptr(), mag.data_ptr(), nz.data_ptr(), S, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"exact_mag kernel launch failed: cudaError {err}")
    launches += 1
    return mag, nz
