"""Device resolution, hand-written CUDA kernel builds, and launch counts.

The JAX reference resolves interpret/compiled Pallas per backend; the port
has two devices instead: ``cuda`` (kernels launch) and ``cpu`` (each kernel
wrapper runs its plain PyTorch version, which is what the CPU tests use).

Kernels are CUDA C++ under ``src/repro_torch/csrc``, compiled by ``nvcc`` at
first use into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries land
in ``build/kernels`` at the repository root, named by a hash of their
source and of every ``csrc`` header it includes, so an edited kernel or
header is never served from a stale build.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("fused_kv_attn", "pack_encode", "huffman_decode")

# Launches of each hand-written kernel since the last reset: each wrapper
# adds one where it launches its kernel, and nowhere else.  The Fetch
# kernel's variants (same library: a page table given, huffman tiles) count
# under keys of their own, so a run shows which path went through the
# kernel; the huffman_decode library holds three kernels, counted apart.
launches = {name: 0 for name in (
    "fused_kv_attn", "fused_kv_attn_paged", "fused_kv_attn_huffman",
    "fused_kv_attn_huffman_paged", "pack_encode", "huffman_decode",
    "huffman_attn_scores", "huffman_lut_decode")}

# The dry run's op count (``launch.dryrun.OpCount``) while one is active:
# each kernel wrapper then charges it the work its kernel would do on these
# shapes and returns an empty output, launching nothing, whatever device
# the tensors are on.  Outside a count a wrapper never looks at it.
_charge_to = None

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # ptxas register / shared-memory report


def resolve_device(device) -> torch.device:
    """``cuda`` or ``cpu`` (or ``meta``: shapes alone); raises if CUDA is
    asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to run "
                "the port's plain PyTorch path")
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def charging() -> bool:
    """Is an op count active (kernel wrappers charge it and launch nothing)?"""
    return _charge_to is not None


def charge(name: str, nbytes: float, flops: float, rate: str = "float32",
           passes: int = 1) -> None:
    """Charge the active count one call of kernel ``name``: ``nbytes`` moved
    and ``flops`` operations, run ``passes`` times on the units of ``rate``
    (``"float32"`` or ``"tf32"``; the Fetch runs each product as two TF32
    products)."""
    _charge_to.kernel(name, nbytes, flops, rate, passes)


@contextlib.contextmanager
def charging_to(counter):
    """Within the block, kernel wrappers charge ``counter`` and launch
    nothing; the previous state comes back on exit, also on an exception."""
    global _charge_to
    saved, _charge_to = _charge_to, counter
    try:
        yield counter
    finally:
        _charge_to = saved


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _target(name: str, defines: tuple = (), csrc: Path | None = None) -> tuple[Path, Path]:
    """The source of kernel ``name`` in ``csrc`` (default ``CSRC``) and its
    library's path, named by a hash of the source, of each header it
    includes (recursively) and of the preprocessor ``defines`` ((NAME,
    value) pairs) it is built with."""
    csrc = CSRC if csrc is None else Path(csrc)
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(repr(defines).encode())
    todo, seen = [src], set()
    while todo:
        path = todo.pop(0)
        if path in seen or not path.exists():
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo += [csrc / inc.decode() for inc in _INCLUDE.findall(text)]
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS, defines: tuple = (), csrc: Path | None = None) -> dict[str, float]:
    """Compile every named kernel of ``csrc`` (default ``CSRC``) that has no
    current build, one ``nvcc`` per source, all started together, each with
    ``-D`` of the ``defines``.  Returns each build's seconds (0.0 where a
    current library already existed)."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    t0 = time.monotonic()
    for name in names:
        src, lib = _target(name, defines, csrc)
        if lib.exists():
            secs[name] = 0.0
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defines), "-o", str(tmp),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        secs[name] = time.monotonic() - t0
        build_log[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, lib)
    return secs


def library_path(name: str) -> Path:
    """Where the current build of kernel ``name`` lives."""
    return _target(name)[1]


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed)."""
    lib = _libs.get(name)
    if lib is None:
        lib = _load(name)
        _libs[name] = lib
    return lib


def _load(name: str, defines: tuple = (), csrc: Path | None = None) -> ctypes.CDLL:
    build((name,), defines, csrc)
    lib = ctypes.CDLL(str(_target(name, defines, csrc)[1]))
    launch = getattr(lib, f"{name}_launch")
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [ctypes.c_int]
    return lib


@contextlib.contextmanager
def variant(name: str, csrc: Path | None = None, **defines):
    """Within the block, kernel ``name`` launches from a build of its source
    in ``csrc`` (another checkout's, say) with these preprocessor defines: a
    way to measure a kernel's compile-time constant at other values, or an
    earlier version of the kernel.  The package itself never sets one."""
    saved = _libs.get(name)
    _libs[name] = _load(name, tuple(sorted(defines.items())), csrc)
    try:
        yield _libs[name]
    finally:
        if saved is None:
            _libs.pop(name)
        else:
            _libs[name] = saved


def launch(name: str, argtypes, *args, count: str | None = None,
           entry: str | None = None) -> None:
    """Call ``<entry>(*args)`` (default ``<name>_launch``) of the kernel
    library ``name``, raise if the CUDA runtime refused the launch (the C
    side returns cudaGetLastError), and count the launch under ``count``
    (default: ``name``)."""
    fn = getattr(library(name), entry or f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        msg = getattr(library(name), f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{entry or name} launch failed: CUDA error {rc} ({msg})")
    launches[count or name] += 1


def stream_args(device: torch.device) -> tuple[int, int]:
    """(card ordinal, current stream) of ``device``, the last two arguments
    of every launch entry: the libraries link CUDA's runtime statically, so
    ``torch.cuda.set_device`` does not reach them, and each launch selects
    the card that holds its tensors itself."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch.cuda.current_stream(device).cuda_stream


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
