"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library at first
use, then loaded with :mod:`ctypes`. The library name carries a hash of
the sources and flags, so an edited kernel is never served from a stale
build. Builds go to ``kernels/build/`` (git-ignored) through a
per-process temporary file and an atomic rename, so concurrent
processes cannot load a half-written library. Every failure raises:
there is no fallback to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("rmsnorm", "flash_attention", "decode_attention",
           "prefill_attention", "prefill_attention_wide", "quant_gemv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# taken around every wrapper's ``launches += 1``: the ranks of a mesh
# launch from several threads at once, and a count must not lose one
COUNTING = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (hash of sources + flags: the
    headers, the source and a ``.cu`` it includes)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    src = (CSRC / f"{name}.cu").read_bytes()
    h.update(src)
    for inc in re.findall(rb'#include "([^"]+\.cu)"', src):
        h.update((CSRC / inc.decode()).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


NVCC_SECONDS = "# nvcc seconds: "   # the last line of a build's log


def build_seconds(log_text: str) -> float | None:
    """The wall seconds of the ``nvcc`` whose log this is (None for a
    log without the line)."""
    for line in reversed(log_text.splitlines()):
        if line.startswith(NVCC_SECONDS):
            return float(line[len(NVCC_SECONDS):])
    return None


def build_all(names=SOURCES) -> None:
    """Compile every named source that has no current build: one
    ``nvcc`` per source, all started together, all waited for (each
    one's output and wall seconds in its library's ``.log``). Raises
    with the compiler's output if any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        done = {}
        # a thread a compiler drains its pipe and stamps its end
        waiter = threading.Thread(target=lambda p=proc, d=done: d.update(
            out=p.communicate()[0], end=time.perf_counter()))
        waiter.start()
        jobs.append((name, proc, tmp, so, waiter, done, time.perf_counter()))
    errors = []
    for name, proc, tmp, so, waiter, done, t0 in jobs:
        waiter.join()
        out = done["out"]
        so.with_suffix(".log").write_text(
            f"{out}{NVCC_SECONDS}{done['end'] - t0:.1f}\n")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each exported function to its ctypes
    ``argtypes``; every function returns a ``cudaError_t`` as int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def launch(lib: ctypes.CDLL, fn: str, what: str, device: torch.device,
           *args) -> None:
    """Call ``lib.<fn>(*args)`` with ``device`` the current CUDA device —
    the runtime launches there and sets a kernel's shared-memory limit
    per device — and raise if it returned a CUDA error. The stream among
    ``args`` is already ``device``'s (:func:`stream_handle`). When
    ``device`` is current already, no context is entered: entering one
    costs each launch a few microseconds of host time."""
    if device.index == torch.cuda.current_device():
        err = getattr(lib, fn)(*args)
    else:
        with torch.cuda.device(device):
            err = getattr(lib, fn)(*args)
    check(lib, err, what)


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def same_device(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one device every operand of a launch lies on; raises naming
    both devices where two differ."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{what}: operands on {dev} and {t.device}; "
                             "one launch takes operands of one device")
    return dev


def check_operand(what: str, t: torch.Tensor, dtype: torch.dtype, *,
                  align: int = 16) -> None:
    """Validate one kernel operand: ``dtype``, on a CUDA device,
    contiguous, ``align``-byte aligned (16 for the kernels' vector
    loads)."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: operand dtype {t.dtype}, the kernel "
                        f"takes {dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{what}: operand on {t.device}, the kernel "
                         "runs on a CUDA device")
    if not t.is_contiguous():
        raise ValueError(f"{what}: operand of shape {tuple(t.shape)} "
                         "is not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{what}: operand is not {align}-byte aligned")


def launch_dtype(what: str, *tensors: torch.Tensor) -> int:
    """Validate kernel operands of one element type the kernels take, on
    one device (:func:`same_device`, then each as
    :func:`check_operand`), and return that type's code."""
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dt} unsupported "
                        "(float32 or bfloat16)")
    for t in tensors:
        if t.dtype != dt:
            raise TypeError(f"{what}: mixed dtypes {dt} and {t.dtype}")
    same_device(what, *tensors)
    for t in tensors:
        check_operand(what, t, dt)
    return DTYPE_CODES[dt]


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
