"""The port's CUDA library: the build of ``csrc/``, its bound entry
points, and the count of kernel launches.

Every ``csrc/*.cu`` source (the exact FFT kernels K1-gen, K1-df, K2,
K2-df and K3, the spectrum tail's pair, the rotating ring's push, the
rebin's interp and filter, the served tick's upload) goes
into one shared library, built with ``nvcc`` at first use into
``build/waveform_tpu_torch/`` (once per hash of the flags and the
sources) and bound with ``ctypes`` here, every exported entry's
signature in one place (:func:`build`).  The modules that launch the
kernels (``kernels/exact_cuda.py``, ``kernels/tail_cuda.py``,
``kernels/ring_cuda.py``, ``kernels/rebin_cuda.py``) and the
served tick's upload (``runtime/serving.py``) call :func:`build` and the
entry they need.

:data:`LAUNCHES` counts kernel launches (not calls of the CPU twins) by
the names of the kernel table: ``K1-gen``, ``K1-df``, ``K2``, ``K2-df``
and ``K3`` (the values of ``exact_cuda.KERNELS``), ``tail`` (the
spectrum tail's pair, two a step), ``ring`` (the rotating ring's
push, one a push) and ``rebin`` (the rebin's interp, and its filter
where the look filters: one or two a rebin).  Each launcher calls
:func:`launched`; a captured tick (``runtime/graphs.GraphTick``) adds
what its capture
recorded at every replay.  A run reads the table to show that its main
path went through the kernels it expects.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from ..runtime import profiler

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "waveform_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_lib = None
build_info: dict = {}    # "library": the .so path; "log": nvcc's output

# kernel launches by kernel name
LAUNCHES: collections.Counter = collections.Counter()


def launched(name: str, n: int = 1) -> None:
    """Count ``n`` launches of the kernel ``name`` in :data:`LAUNCHES`."""
    LAUNCHES[name] += n


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
    and bind it: one ``nvcc`` per source, all started together, then one
    link.  Raises on a failed build.  Timed as the profiler's set-up
    phase ``library.exact_cuda``."""
    global _lib
    if _lib is None:
        with profiler.setup("library.exact_cuda"):
            _lib = _build()
    return _lib


def _build() -> ctypes.CDLL:
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    out = _BUILD / f"libwf_exact_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        try:
            for src, proc, log in zip(sources, procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
            r = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                                str(tmp), *map(str, objs)],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                                   f"{r.stderr}")
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, out)
        build_info["log"] = "".join(logs)
    build_info["library"] = str(out)
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    return lib


def _sig(fn, *argtypes) -> None:
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)


def _bind(lib: ctypes.CDLL) -> None:
    """Every exported entry's signature; each returns a cudaError."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # the exact FFT kernels (kernels/exact_cuda.py): pointers (the pair
    # kernels' second the rows' heads, null for none), then (S, n,
    # stream); K1-gen and K1-df, K2 and K2-df one signature a pair
    _sig(lib.wf_exact_mag3, *[ptr] * 13, i32, i32, ptr)
    _sig(lib.wf_exact_mag3_df, *lib.wf_exact_mag3.argtypes)
    _sig(lib.wf_exact_cfft, *[ptr] * 9, i32, i32, ptr)
    for fn in (lib.wf_exact_mag_gen, lib.wf_exact_mag_gen_df):
        _sig(fn, *[ptr] * 12, i32, i32, ptr)
    # one stage alone (chip_smoke times the stages apart): (stage, df, ...)
    # for the pair kernels, (stage, ...) for K3
    for fn, whole, ints in ((lib.wf_exact_mag3_stage, lib.wf_exact_mag3, 2),
                            (lib.wf_exact_mag_gen_stage, lib.wf_exact_mag_gen,
                             2),
                            (lib.wf_exact_cfft_stage, lib.wf_exact_cfft, 1)):
        _sig(fn, *[i32] * ints, *whole.argtypes)
    # the spectrum tail's pair (csrc/spectrum_tail.cu, kernels/tail_cuda.py)
    _sig(lib.wf_spectrum_tail, *[ptr] * 16, *[i32] * 8,
         *[ctypes.c_float] * 6, i32, ptr)
    # the rotating ring's push (csrc/ring_push.cu, kernels/ring_cuda.py)
    i64 = ctypes.c_longlong
    _sig(lib.wf_ring_push, ptr, ptr, ptr, i64, i64, ptr, i64, *[i32] * 5,
         ptr)
    # the rebin's interp and Gaussian filter (csrc/rebin.cu,
    # kernels/rebin_cuda.py)
    _sig(lib.wf_rebin_interp, ptr, i64, i64, i32, i32, ptr, ptr, i32, i32,
         ptr, i32, ptr)
    _sig(lib.wf_rebin_gauss, ptr, ptr, i32, ptr, ptr, i32, i32, ptr)
    # the served tick's upload (csrc/tick_host.cu, runtime/serving.py)
    _sig(lib.wf_tick_upload, ptr, ptr, ctypes.c_longlong, ptr, ptr, i32)


def sass_counts(ops=("IMMA", "IGMMA", "IDP.4A")) -> dict:
    """Instruction counts of each kernel in the built library, read from
    its SASS (``cuobjdump -sass``, beside ``nvcc``): ``{mangled kernel
    name: {op: count}}``, an instruction counting for ``op`` when its
    opcode is ``op`` or starts with ``op.`` (``IGMMA``: the int8
    ``wgmma``; ``IMMA.16832.S8.S8``: the int8 ``mma.sync``;
    ``IDP.4A.S8.S8``: ``__dp4a``)."""
    build()
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", build_info["library"]],
                          capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    fn = None
    for line in sass.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
            continue
        ins = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn is not None and ins:
            opcode = ins.group(1)
            for op in ops:
                if opcode == op or opcode.startswith(op + "."):
                    counts[fn][op] += 1
    return counts
