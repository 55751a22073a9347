"""Meshes (the port of ``repro.launch.mesh``).

A mesh here is a grid of ``torch.device``\\ s with named axes, the counterpart
of a ``jax.sharding.Mesh``: ``axis_names``, ``shape`` (axis name -> extent)
and ``devices`` (an object array, one axis a name).  The serving mesh has
the axes ``("data", "model")`` (DESIGN.md §12); a training mesh may add an
outer ``"pod"`` axis, ``("pod", "data", "model")``.

The device grid may repeat a device: ``make_serve_mesh("2,2",
devices=["cpu"] * 4)`` is four logical shards on one CPU, the counterpart of
the reference's ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, and
``devices=["cuda:0"] * 4`` four shards on one card.  Every part of the
sharded path runs on such a mesh (a cache, a pool and an index a shard,
kernel launches a shard); only copies between cards need distinct cards.

``make_production_mesh`` is the reference's 16x16 (or 2x16x16) training
mesh; it raises, naming the count, where fewer devices are given or exist.
``abstract_mesh`` (``distributed.sharding``) builds a mesh on the meta device
for spec construction alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over a grid of torch devices."""

    devices: np.ndarray            # object array of torch.device, one axis a name
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device grid for axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def positions(self) -> list[tuple[int, ...]]:
        """Every position of the grid, in row-major order."""
        return [tuple(int(i) for i in p) for p in np.ndindex(self.devices.shape)]

    @property
    def home(self) -> torch.device:
        """The first device: where unsharded work runs."""
        return self.devices.flat[0]


def _grid(devices, shape) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return grid.reshape(shape)


def _cards() -> list[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_host_mesh(max_devices: int | None = None, devices=None, pods: int = 1) -> Mesh:
    """A small ``("data", "model")`` mesh over the given devices (default:
    every card), the model axis the largest of 8, 4, 2, 1 that divides
    their count (per pod); ``pods`` > 1 adds an outer ``"pod"`` axis."""
    devs = list(devices) if devices is not None else _cards()
    if max_devices is not None:
        devs = devs[:max_devices]
    n = len(devs)
    if n == 0:
        raise RuntimeError("no devices")
    if n % pods:
        raise ValueError(f"{pods} pods do not divide {n} devices")
    per = n // pods
    m = next(m for m in (8, 4, 2, 1) if per % m == 0)
    if pods == 1:
        return Mesh(_grid(devs, (per // m, m)), ("data", "model"))
    return Mesh(_grid(devs, (pods, per // m, m)), ("pod", "data", "model"))


PRODUCTION_SHAPE = {False: (16, 16), True: (2, 16, 16)}


def _sized_mesh(shape, names, devices, what: str) -> Mesh:
    devs = list(devices) if devices is not None else _cards()
    n = int(np.prod(shape))
    if n > len(devs):
        raise RuntimeError(
            f"{what} needs {n} devices but only {len(devs)} "
            f"{'were given' if devices is not None else 'exist'}; pass devices= with "
            f"{n} entries (a device may repeat, e.g. ['cpu'] * {n})")
    return Mesh(_grid(devs[:n], shape), names)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """Single pod: 16x16 = 256 devices ``("data", "model")``.  Multi-pod:
    2x16x16 = 512 ``("pod", "data", "model")``; the pod axis is pure data
    parallelism (the compressed cross-pod gradient).  Over the first
    devices of ``devices`` (default: the cards); raises, naming the count,
    when there are fewer."""
    shape = PRODUCTION_SHAPE[multi_pod]
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _sized_mesh(shape, names, devices,
                       f"the {'x'.join(map(str, shape))} production mesh")


def parse_train_mesh(spec: str) -> tuple[int, ...]:
    """``"data,model"`` or ``"pod,data,model"`` -> the mesh's shape."""
    try:
        shape = tuple(int(p) for p in spec.split(","))
    except ValueError:
        shape = ()
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"--mesh wants 'data,model' or 'pod,data,model' (integers >= 1), "
                         f"got {spec!r}")
    return shape


def make_train_mesh(spec: str, devices=None) -> Mesh:
    """A training mesh from ``"data,model"`` or ``"pod,data,model"``
    (``--mesh`` of ``launch.train``) over the first devices of ``devices``
    (default: the cards; a list may repeat a device)."""
    shape = parse_train_mesh(spec)
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return _sized_mesh(shape, names, devices, f"--mesh {spec}")


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """``"dp,tp"`` -> (dp, tp), both >= 1."""
    try:
        dp, tp = (int(p) for p in spec.split(","))
    except ValueError:
        raise ValueError(f"--mesh wants 'dp,tp' (two integers), got {spec!r}") from None
    if dp < 1 or tp < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {spec!r}")
    return dp, tp


def make_serve_mesh(spec: str | None, devices=None) -> Mesh | None:
    """Build the serving mesh from a ``--mesh dp,tp`` spec.

    ``dp`` shards decode slots, page tables and the paged arena's page axis
    ("data"); ``tp`` shards KV heads inside attention ("model").  Returns
    None for an empty spec or a 1x1 mesh: one device serves exactly as the
    unsharded path (DESIGN.md §12).  The mesh takes the first ``dp * tp``
    of ``devices`` (default: the cards, in order); a list may repeat a
    device.  Raises when fewer devices are given or exist."""
    if not spec:
        return None
    dp, tp = parse_mesh_spec(spec)
    if dp * tp == 1:
        return None
    devs = list(devices) if devices is not None else _cards()
    if dp * tp > len(devs):
        raise RuntimeError(
            f"--mesh {spec} needs {dp * tp} devices but only {len(devs)} exist; "
            f"pass devices= with {dp * tp} entries (a device may repeat, e.g. "
            f"['cpu'] * {dp * tp}, or --device cpu on the CLI)")
    return Mesh(_grid(devs[:dp * tp], (dp, tp)), ("data", "model"))
