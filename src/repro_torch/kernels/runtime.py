"""Device resolution, hand-written CUDA kernel builds, and launch counts.

The JAX reference resolves interpret/compiled Pallas per backend; the port
has two devices instead: ``cuda`` (kernels launch) and ``cpu`` (each kernel
wrapper runs its plain PyTorch version, which is what the CPU tests use).

Kernels are CUDA C++ under ``src/repro_torch/csrc``, compiled by ``nvcc`` at
first use into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries land
in ``build/kernels`` at the repository root, named by a hash of their
source, so an edited kernel is never served from a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("fused_kv_attn", "pack_encode")

# Launches of each hand-written kernel since the last reset: each wrapper
# adds one where it launches its kernel, and nowhere else.
launches = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # ptxas register / shared-memory report


def resolve_device(device) -> torch.device:
    """``cuda`` or ``cpu``; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to run "
                "the port's plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS) -> dict[str, float]:
    """Compile every named kernel that has no current build, one ``nvcc``
    per source, all started together.  Returns each build's seconds
    (0.0 where a current library already existed)."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    t0 = time.monotonic()
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            secs[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        build_log[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed)."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)[1]))
        launch = getattr(lib, f"{name}_launch")
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def launch(name: str, argtypes, *args) -> None:
    """Call ``<name>_launch(*args)`` of the kernel library, raise if the CUDA
    runtime refused the launch (the C side returns cudaGetLastError), and
    count the launch."""
    fn = getattr(library(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
    rc = fn(*args)
    if rc != 0:
        msg = getattr(library(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    launches[name] += 1


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_tensor(kernel: str, name: str, t: torch.Tensor, dtype, shape,
                 device: torch.device) -> None:
    """Wrapper input check: device, dtype, shape and contiguity."""
    if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} {shape} tensor on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def require(cond: bool, msg: str) -> None:
    """Wrapper input check on scalars."""
    if not cond:
        raise ValueError(msg)
