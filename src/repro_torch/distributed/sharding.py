"""Logical-axis sharding rules and sharded tensors (the port of
``repro.distributed.sharding``).

Model code names every parameter dimension with a logical axis
(``models.model.param_axes``).  This module turns those names into
placements on a ``launch.mesh.Mesh``, as the reference does for pjit:

* per-mode rule tables: train = FSDP(data) x TP(model), serve = TP, and
  pure data parallelism across pods;
* the MoE switch: experts >= |model| shard the experts (expert
  parallelism), otherwise the experts' FFN width (TP inside each expert);
* conflict sanitation (a mesh axis is used at most once a spec; later uses
  are dropped) and the divisibility fallback (a dimension shards only where
  the mesh axes divide it).

``P`` and ``NamedSharding`` are the port's own: a spec in the reference's
normal form (a one-axis entry unwrapped, trailing ``None`` dropped) and a
mesh with a spec.  Where the reference hands placement to GSPMD, the port
holds a sharded array itself: a ``Sharded`` is a global tensor as pieces,
one a mesh position, each of ``NamedSharding.shard_shape`` on its
position's device (``place``).  Positions on the same device that hold the
same slice (replicas on one card or one CPU) share one tensor, so a
shard-local update runs once a distinct piece.  ``gather`` is the
all-gather, ``accumulate`` the reduce-scatter of full tensors into the
pieces, in the order the caller adds them.

Not ported, having no role here: the reference's ``make_mesh`` /
``HAS_AXIS_TYPES`` (jax-version shims) and ``set_ambient_mesh`` /
``constrain`` (GSPMD placement hints; the port's sharded step places every
tensor itself).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.launch.mesh import Mesh
from repro_torch.models.config import ModelConfig

MeshAxes = tuple[str, ...] | str | None


def abstract_mesh(axis_shapes, axis_names) -> Mesh:
    """A mesh on the meta device: axis names and sizes for spec
    construction, touching no card."""
    grid = np.empty(int(np.prod(axis_shapes)), dtype=object)
    grid[:] = [torch.device("meta")] * grid.size
    return Mesh(grid.reshape(tuple(axis_shapes)), tuple(axis_names))


def _mesh_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name]


class P:
    """A partition spec: an entry a dimension (``None``, a mesh axis name or
    a tuple of names), in the reference's normal form."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        norm = []
        for e in entries:
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                e = e[0] if len(e) == 1 else (e or None)
            norm.append(e)
        while norm and norm[-1] is None:
            norm.pop()
        object.__setattr__(self, "entries", tuple(norm))

    def __setattr__(self, name, value):
        raise AttributeError("P is immutable")

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def axes(self, dim: int) -> tuple[str, ...]:
        """The mesh axes that split dimension ``dim`` (outermost first)."""
        e = self.entries[dim] if dim < len(self.entries) else None
        return () if e is None else (e,) if isinstance(e, str) else e


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec over a mesh."""

    mesh: Mesh
    spec: P

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and self.mesh is other.mesh
                and self.spec == other.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def _splits(self, dim: int) -> int:
        return int(np.prod([_mesh_size(self.mesh, a) for a in self.spec.axes(dim)]))

    def shard_shape(self, shape) -> tuple[int, ...]:
        """Each position's piece of a global array of ``shape``."""
        out = []
        for dim, n in enumerate(shape):
            k = self._splits(dim)
            if n % k:
                raise ValueError(f"{self.spec} splits dimension {dim} of {tuple(shape)} "
                                 f"{k} ways")
            out.append(n // k)
        return tuple(out)

    def region(self, shape, pos) -> tuple[slice, ...]:
        """The slice of the global array the mesh position ``pos`` holds:
        along a dimension split by axes (a, b, ...) its index is the
        position's row-major index over them, as in the reference."""
        names = self.mesh.axis_names
        piece = self.shard_shape(shape)
        out = []
        for dim, n in enumerate(piece):
            idx = 0
            for a in self.spec.axes(dim):
                idx = idx * _mesh_size(self.mesh, a) + pos[names.index(a)]
            out.append(slice(idx * n, (idx + 1) * n))
        return tuple(out)


# ---------------------------------------------------------------------------
# rule tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis name -> mesh axes (None = replicated)."""

    table: Mapping[str, MeshAxes]

    def get(self, logical: str) -> MeshAxes:
        return self.table.get(logical)


def train_rules(cfg: ModelConfig, mesh: Mesh) -> Rules:
    """FSDP(data) x TP(model); the pod axis stays pure data parallelism
    (gradients cross pods once a step)."""
    ep = cfg.n_experts >= _mesh_size(mesh, "model")  # expert parallelism vs TP-in-expert
    return Rules({
        "vocab": "model", "embed": "data",          # embeddings: vocab TP, d_model FSDP
        "heads": "model", "kv_heads": None, "head_dim": None,
        "mlp": "model",
        "experts": "model" if ep else None, "expert_mlp": None if ep else "model",
        "experts_r": None,
        "ssm_proj": "model", "ssm_conv_ch": "model", "ssm_inner": "model",
        "ssm_heads": None, "conv_k": None,
        "layers": None, "periods": None,
    })


def serve_rules(cfg: ModelConfig, mesh: Mesh) -> Rules:
    """Pure TP for weights (replicated over data and pod)."""
    table = dict(train_rules(cfg, mesh).table)
    table["embed"] = None
    return Rules(table)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The batch-parallel mesh axes: ("pod", "data") on multi-pod meshes."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _data_size(mesh: Mesh) -> int:
    return int(np.prod([_mesh_size(mesh, a) for a in data_axes(mesh)]))


# ---------------------------------------------------------------------------
# spec construction
# ---------------------------------------------------------------------------


def spec_for_axes(axes: tuple[str, ...], shape, rules: Rules, mesh: Mesh) -> P:
    """A sanitized spec for one array: a mesh axis already used, or one that
    does not divide the dimension, is dropped."""
    used: set[str] = set()
    entries: list[MeshAxes] = []
    for dim, logical in enumerate(axes):
        target = rules.get(logical)
        if target is None:
            entries.append(None)
            continue
        kept, size = [], 1
        for a in (target,) if isinstance(target, str) else tuple(target):
            n = _mesh_size(mesh, a)
            if a in used or shape[dim] % (size * n) != 0:
                continue
            kept.append(a)
            size *= n
        used.update(kept)
        entries.append(tuple(kept) or None)
    return P(*entries)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, str) for e in x)


def _zip_axes(fn, axes, other):
    """``fn(axes leaf, other leaf)`` over an axes tree (dicts and lists; a
    leaf is a tuple of names) and a tree of its structure."""
    if isinstance(axes, dict):
        return {k: _zip_axes(fn, axes[k], other[k]) for k in axes}
    if isinstance(axes, list):
        return [_zip_axes(fn, a, o) for a, o in zip(axes, other)]
    if not _is_axes(axes):
        raise TypeError(f"not a logical-axes leaf: {axes!r}")
    return fn(axes, other)


def make_param_shardings(axes_tree, shapes_tree, rules: Rules, mesh: Mesh):
    """``axes_tree`` mirrors the parameter tree with logical-axis tuples as
    leaves; ``shapes_tree`` gives the matching shapes (anything with
    ``.shape``: meta tensors from ``train.step.shapes_and_axes``)."""
    return _zip_axes(lambda axes, x: NamedSharding(
        mesh, spec_for_axes(axes, tuple(x.shape), rules, mesh)), axes_tree, shapes_tree)


def batch_sharding(mesh: Mesh, x) -> NamedSharding:
    """[B, ...] inputs: the batch over ("pod", "data") where that divides it
    (a batch of 1 stays replicated)."""
    da = data_axes(mesh)
    shape = tuple(getattr(x, "shape", ()))
    if not shape or shape[0] % _data_size(mesh) != 0:
        return NamedSharding(mesh, P())
    return NamedSharding(mesh, P(da, *([None] * (len(shape) - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


_STORE = {"k_store", "v_store", "k_min", "k_step", "v_min", "v_step"}
_BUF = {"k_buf", "v_buf"}


def _cache_spec(name: str, shp, da, da_n: int, model_n: int) -> P:
    nd = len(shp)
    spec = [None] * nd

    def set_if(idx, axes, div):
        if 0 <= idx < nd and shp[idx] % div == 0 and shp[idx] >= div:
            spec[idx] = axes

    if name in _STORE and nd >= 3:
        set_if(0, da, da_n)
        set_if(2, "model", model_n)  # NB: the compression blocks (sequence parallelism)
    elif name in _BUF and nd >= 3:
        set_if(0, da, da_n)
    elif name == "conv" and nd >= 3:
        set_if(nd - 3, da, da_n)
        set_if(nd - 1, "model", model_n)
    elif name == "ssm" and nd >= 4:
        set_if(nd - 4, da, da_n)
        set_if(nd - 3, "model", model_n)
    return P(*spec)


def cache_shardings(state, mesh: Mesh):
    """Decode-state shardings by leaf name, for the port's per-layer state
    (the reference's rules with its stacking axis dropped):

      kv k/v_store + scales : [B, Hkv, NB, ...] -> batch on the data axes,
                              NB on "model" (the compression blocks are the
                              sequence-parallel unit)
      kv k/v_buf            : [B, Hkv, T, D]    -> batch on the data axes
      kv lengths, page_tab  : replicated
      ssm "conv"            : [B, K-1, C]       -> batch, C on "model"
      ssm "ssm"             : [B, H, N, P]      -> batch, H on "model"

    An axis that does not divide falls back to replication (a paged
    arena's batch extent of 1 stays replicated, its pages still shard on
    "model").  A ``LayerKVCache`` maps to a dict of its fields."""
    da = data_axes(mesh)
    da_n, model_n = _data_size(mesh), _mesh_size(mesh, "model")

    def walk(x, name=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [walk(v, name) for v in x]
        if hasattr(x, "FIELDS"):  # a LayerKVCache
            return {f: walk(getattr(x, f), f) for f in x.FIELDS}
        return NamedSharding(mesh, _cache_spec(name, tuple(x.shape), da, da_n, model_n))

    return walk(state)


# ---------------------------------------------------------------------------
# sharded tensors
# ---------------------------------------------------------------------------


class Sharded:
    """A global tensor of ``shape`` held as pieces: ``blocks`` are the
    distinct pieces (``regions[i]`` the slice block i holds, on its own
    device), ``slots`` (an int array of the mesh's shape) the block each
    mesh position holds."""

    def __init__(self, sharding: NamedSharding, shape, dtype, blocks, regions, slots):
        self.sharding, self.shape, self.dtype = sharding, tuple(shape), dtype
        self.blocks, self.regions, self.slots = blocks, regions, slots

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def piece(self, pos) -> torch.Tensor:
        """The piece mesh position ``pos`` holds."""
        return self.blocks[self.slots[tuple(pos)]]

    def distinct(self) -> list[tuple[torch.Tensor, tuple]]:
        """(block, region) for each distinct slice (each element once), in
        block order."""
        seen, out = set(), []
        for blk, reg in zip(self.blocks, self.regions):
            key = tuple((s.start, s.stop) for s in reg)
            if key not in seen:
                seen.add(key)
                out.append((blk, reg))
        return out

    def __repr__(self) -> str:
        return (f"Sharded({self.shape}, {self.dtype}, {self.sharding.spec}, "
                f"{len(self.blocks)} pieces)")


def _layout(sharding: NamedSharding, shape):
    """[(position, device, region)], and for each position the index of the
    first position with the same device and region."""
    mesh = sharding.mesh
    keys, first, out = {}, [], []
    for pos in mesh.positions():
        dev = mesh.devices[pos]
        reg = sharding.region(shape, pos)
        key = (str(dev), tuple((s.start, s.stop) for s in reg))
        first.append(keys.setdefault(key, len(keys)))
        out.append((pos, dev, reg))
    return out, first


def _build(sharding: NamedSharding, shape, dtype, make) -> Sharded:
    layout, first = _layout(sharding, shape)
    blocks, regions = [], []
    slots = np.empty(sharding.mesh.devices.shape, dtype=np.int64)
    for (pos, dev, reg), k in zip(layout, first):
        if k == len(blocks):
            blocks.append(make(dev, reg))
            regions.append(reg)
        slots[pos] = k
    return Sharded(sharding, shape, dtype, blocks, regions, slots)


def place(x: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``x`` as pieces on the mesh (a piece that is the whole of ``x`` on
    ``x``'s own device is ``x`` itself; every other piece a copy)."""
    shape = tuple(x.shape)

    def make(dev, reg):
        if all(s.start == 0 and s.stop == n for s, n in zip(reg, shape)) and x.device == dev:
            return x
        return x[reg].to(dev, copy=True).contiguous()

    return _build(sharding, shape, x.dtype, make)


def zeros(sharding: NamedSharding, shape, dtype) -> Sharded:
    """Zero pieces of a global array of ``shape``."""
    piece = sharding.shard_shape(shape)
    return _build(sharding, shape, dtype,
                  lambda dev, reg: torch.zeros(piece, dtype=dtype, device=dev))


def like(s: Sharded, blocks) -> Sharded:
    """A ``Sharded`` of ``s``'s layout holding ``blocks`` (one a block of
    ``s``)."""
    return Sharded(s.sharding, s.shape, blocks[0].dtype, list(blocks), s.regions, s.slots)


def gather(s: Sharded, device) -> torch.Tensor:
    """The global tensor on ``device`` (the all-gather); a piece that is the
    whole tensor and lies on ``device`` is returned itself."""
    device = torch.device(device)
    for blk, reg in zip(s.blocks, s.regions):
        if blk.device == device and tuple(blk.shape) == s.shape:
            return blk
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    for blk, reg in s.distinct():
        out[reg].copy_(blk)
    return out


def accumulate(s: Sharded | None, full: torch.Tensor, sharding: NamedSharding,
               dtype=None) -> Sharded:
    """Add the slices of the global tensor ``full`` into the pieces of ``s``
    (``None``: pieces of ``sharding`` made from ``full``, in ``dtype``):
    one shard's term of the reduce-scatter.  Terms added in a fixed order
    give the same bits wherever they run."""
    if s is None:
        dt = full.dtype if dtype is None else dtype
        return _build(sharding, tuple(full.shape), dt,
                      lambda dev, reg: full[reg].to(dev, dt, copy=True).contiguous())
    for blk, reg in zip(s.blocks, s.regions):
        blk.add_(full[reg].to(blk.device, blk.dtype))
    return s


def place_tree(tree, shardings):
    """Every leaf of ``tree`` placed by the matching leaf of ``shardings``;
    a ``Sharded`` leaf already on that sharding is kept, one on another is
    gathered and placed again."""
    def one(x, sh):
        if isinstance(x, Sharded):
            if x.sharding == sh:
                return x
            x = gather(x, sh.mesh.home)
        return place(x, sh)

    return tree_lib.map_(one, tree, shardings)


def gather_tree(tree, device):
    """Every ``Sharded`` leaf of ``tree`` gathered to ``device``."""
    return tree_lib.map_(lambda x: gather(x, device) if isinstance(x, Sharded) else x, tree)


def data_shards(mesh: Mesh) -> list[tuple[int, ...]]:
    """One position a batch shard (the first along the other axes), in the
    order of the batch's shard index over ("pod", "data")."""
    names, da = mesh.axis_names, data_axes(mesh)
    out = {}
    for pos in mesh.positions():
        k = 0
        for a in da:
            k = k * _mesh_size(mesh, a) + pos[names.index(a)]
        out.setdefault(k, pos)
    return [out[k] for k in sorted(out)]


def shard_nbytes(tree, pos) -> int:
    """Bytes of the pieces the mesh position ``pos`` holds across ``tree``."""
    return sum(x.piece(pos).numel() * x.piece(pos).element_size()
               for x in tree_lib.leaves(tree) if isinstance(x, Sharded))


def spec_nbytes(tree) -> int:
    """The bytes the specs give a position across ``tree``: each leaf's
    shard shape times its element size."""
    return sum(int(np.prod(x.sharding.shard_shape(x.shape))) * x.dtype.itemsize
               for x in tree_lib.leaves(tree) if isinstance(x, Sharded))
