"""Build and load the hand-written Hopper kernels under ``st3d_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes``; no PyTorch header is
compiled, so a build takes seconds. Libraries land in ``build/st3d_torch/``
at the repository root, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused.

Nothing here runs at import: the first CUDA launch of a kernel builds it,
and ``build_all`` builds every source at once, one nvcc process each. A
missing ``nvcc`` or a failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, List

import torch

from st3d_torch.utils import trace

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "st3d_torch")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
# Per-source extra flags: the rasterizers' edge tests must not be contracted
# into FMAs (see raster_hard.cu).
RASTER_SOURCES = ("raster_hard", "raster_soft", "raster_stream", "raster_topk",
                  "raster_2d")
EXTRA_FLAGS: Dict[str, List[str]] = {n: ["-fmad=false"]
                                     for n in RASTER_SOURCES}
# The tensor-core kernels (wgmma, TMA) encode their TMA descriptors on the
# host with cuTensorMapEncodeTiled, which lives in libcuda, so they link it
# (nvcc finds the toolkit's stub library; the installed libcuda.so.1 is
# loaded at run time), given after the source. ptxas reports their
# registers, shared memory and spills (``-v``), kept in ``BUILD_LOGS``.
WGMMA_SOURCES = ("conv3x3_wgmma", "conv3x3_tf32x3", "gram_wgmma",
                 "gram_tf32x3", "pool_route_wgmma", "pool_route_tf32x3",
                 "conv1_1_stats_wgmma", "conv1_1_bwd_wgmma",
                 "conv1_1_stats_tf32x3", "conv1_1_bwd_tf32x3",
                 "conv3x3_narrow_wgmma", "conv3x3_narrow_tf32x3",
                 "conv1_1_gram_wgmma", "conv1_1_gram_bwd_wgmma",
                 "conv1_1_gram_tf32x3", "conv1_1_gram_bwd_tf32x3",
                 "nnfm_match_tf32x3")
# The narrow K3 takes mma.sync, not wgmma, but shares hopper.cuh with them
# (cp.async, the Grams' second pass), so it links and reports as they do.
TENSOR_CORE_SOURCES = WGMMA_SOURCES + ("gram_narrow",)
# The five rasterizers with per-warp face lists report theirs too: their
# register cap trades spills for occupancy.
REPORT_SOURCES = TENSOR_CORE_SOURCES + ("raster_hard", "raster_soft",
                                        "raster_stream", "raster_topk",
                                        "raster_2d")
EXTRA_FLAGS.update({n: EXTRA_FLAGS.get(n, []) + ["-Xptxas", "-v"]
                    for n in REPORT_SOURCES})
LINK_FLAGS: Dict[str, List[str]] = {n: ["-lcuda"]
                                    for n in TENSOR_CORE_SOURCES}

KERNEL_SOURCES = RASTER_SOURCES + (
    "conv3x3_nhwc", "gram_nhwc", "conv1_1_stats", "conv1_1_bwd",
    "conv3x3_relu_pool", "pool_route_conv3x3_bwd", "conv1_1_gram",
    "conv1_1_gram_bwd") + TENSOR_CORE_SOURCES
DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_LIBS: Dict[str, ctypes.CDLL] = {}
_SYMBOLS: Dict[str, object] = {}
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH; raises when absent."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the st3d_torch CUDA kernels are "
        "built from source at first use")


def _flags(name: str) -> List[str]:
    return ARCH_FLAGS + BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    # Shared headers (csrc/*.cuh) count for every source.
    for header in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(header, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(_flags(name) + LINK_FLAGS.get(name, [])).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns None or (process, temporary output, library path, command,
    start time)."""
    out = library_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path()] + _flags(name) + [
        "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")] + LINK_FLAGS.get(
            name, [])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out, cmd, time.perf_counter()


def _finish(name: str, started) -> str:
    """Wait for a build from ``_start``; returns the library path. Raises
    ``RuntimeError`` with nvcc's output on failure."""
    proc, tmp, out, cmd, t0 = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({proc.returncode}):\n"
            f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOGS[name] = stdout + stderr
    return out


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library path. Raises ``RuntimeError`` with nvcc's output on
    failure."""
    started = _start(name)
    return library_path(name) if started is None else _finish(name, started)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use (the
    source hashed, nvcc if needed, dlopen: the span ``st3d.kernels.load``)."""
    lib = _LIBS.get(name)
    if lib is None:
        with trace.span("kernels.load"):
            lib = _LIBS[name] = ctypes.CDLL(build(name))
    return lib


def build_all() -> Dict[str, float]:
    """Build and load every kernel library, one nvcc process per source, all
    started together; returns seconds per build (0 for a library that was
    already built). Every build is waited for before a failure raises."""
    started = {n: _start(n) for n in KERNEL_SOURCES}
    errors = []
    for name, st in started.items():
        if st is not None:
            try:
                _finish(name, st)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in KERNEL_SOURCES:
        load(name)
    return {n: BUILD_SECONDS.get(n, 0.0) for n in KERNEL_SOURCES}


def ptxas_report(name: str) -> List[str]:
    """ptxas's lines on registers, shared memory and spills for the kernels
    of ``csrc/<name>.cu``, from its build in this process (empty if it was
    built earlier or without ``-v``); its notes on the warpgroup arrives
    it injects around register-A ``wgmma`` are left out."""
    return [l.strip() for l in BUILD_LOGS.get(name, "").splitlines()
            if ("Compiling entry" in l or "registers" in l or "spill" in l)
            and "warpgroup.arrive" not in l]


def symbol(lib: str, name: str, n_ptr: int, n_int: int, n_float: int = 0):
    """``name`` of ``csrc/<lib>.cu`` with its C signature: ``n_ptr``
    pointers, ``n_int`` ints, ``n_float`` floats, then the stream; returns
    the cudaError_t."""
    key = f"{lib}:{name}"
    fn = _SYMBOLS.get(key)
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _SYMBOLS[key] = fn
    return fn


def check_operands(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is on one CUDA device with one dtype the
    kernels take (float32 or bfloat16)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expected CPU or CUDA tensors, got {dev}")
    dt = tensors[0].dtype
    if dt not in DTYPE_SUFFIX:
        raise TypeError(f"{name}: dtype {dt} not supported (float32, bfloat16)")
    for t in tensors[1:]:
        if t.device != dev or t.dtype != dt:
            raise ValueError(
                f"{name}: all operands must share device {dev} and dtype "
                f"{dt}; got {t.device} {t.dtype}")


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
