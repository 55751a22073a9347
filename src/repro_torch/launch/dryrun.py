"""Multi-pod dry run (the port of ``repro.launch.dryrun``): every
(architecture x input shape) cell on the production meshes, and its roofline
terms, without a card.

The reference lowers and compiles each cell with XLA and reads
``cost_analysis()``, ``memory_analysis()`` and the HLO text.  The port has
no compiler: it COUNTS the cell.  ``OpCount`` is a ``TorchDispatchMode``
under which the port's own step runs, on the ``meta`` device (shapes, no
storage), over the local shapes of one shard:

* FLOPs of every matrix product by ``torch.utils.flop_counter``'s formulas,
  each at the rate of its operands' dtype;
* bytes read and written, op by op (every input and output once; a view
  moves nothing): the naive per-op sum the reference's ``bytes accessed``
  also is;
* memory: ``argument_bytes`` from the specs (``NamedSharding.shard_shape``,
  never from storages: replicas on one device share one tensor),
  ``output_bytes`` of what the pass returns, ``temp_bytes`` the peak of the
  storages the pass allocates while they live, ``alias_bytes`` the state
  it updates in place;
* copies between devices, in place of HLO collectives: each
  ``Sharded.gather`` (``"all-gather"``), each ``accumulate``
  (``"reduce-scatter"``) and the cross-pod compressed gradient
  (``"all-reduce"``), by kind and shape, at the bytes the counted
  position's card sends or receives, whichever is more, as if every mesh
  position were a card of its own; copies of scalars are not recorded;
* the kernels: under a count each kernel wrapper launches nothing and
  charges the work its kernel does on those shapes (``runtime.charging``);
  the Fetch reads every slot of the store, the Store writes a block of
  every row.  The backend resolves as on a card.  The count is the same
  over ``meta``, CPU or CUDA tensors.

One shard: every (pod, data) shard has the same shapes, so the count is
one position's pass (the mesh's first, the first batch shard's card), and
every number is per device, as the reference's ``cost_analysis`` is.

* train: each microbatch gathers the parameters (FSDP x TP pieces of
  ``train_rules``) and the batch part onto the shard's card, runs
  ``lm_loss`` and autograd on the shard's rows, and adds the gradient's
  slices into the pieces (its own piece, and the other shards' terms into
  it); then the cross-pod compressed gradient (multi-pod meshes), and the
  shard-local AdamW update of the position's pieces.  MoE runs the whole
  batch on the first card, as the port's step does.  The "model" axis
  shards storage, not the matmuls (``ROADMAP.md``): a shard's pass runs
  whole matmuls on one card.
* prefill / decode: the parameters by ``serve_rules`` gathered onto the
  card, then ``model.prefill`` (``forward`` for an encoder) or
  ``model.decode_step`` on the shard's rows; the decode state at its local
  shape by ``cache_shardings`` (the batch on the data axes, the compression
  blocks on "model").

Per cell, as in the reference: ``full`` counts the cell at full depth
(train: remat, 8 microbatches) for ``memory`` and ``cost_raw`` (a count has
no loop bodies counted once: it is the whole pass); ``analysis`` counts two
reduced depths (1 microbatch) and extrapolates linearly,
``per_unit = c(d2) - c(d1); total = c(d1) + (L - d1) * per_unit``.  The
record keeps the reference's keys: ``lower_s`` is the seconds of building
the cell, ``compile_s`` those of its count, ``hlo_flops_global`` the
counted FLOPs times the chips.

``HW`` holds the H100 SXM's datasheet figures; they are not measurements.

Usage (the CPU suffices):
    python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k --mesh pod
    python -m repro_torch.launch.dryrun --all --mesh both
Records go to ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import json
import time
import traceback
import weakref
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import tree
from repro_torch.core import layouts as cache_layouts
from repro_torch.core.cache import LayerKVCache
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import runtime
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, grad_compress
from repro_torch.train import step as step_lib

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# H100 SXM, per card.  Sources: the NVIDIA H100 Tensor Core GPU datasheet
# (SXM column: FP32 67 TFLOP/s; TF32 989 with sparsity, 495 dense; BF16 /
# FP16 1979 with sparsity, 989 dense; HBM3 3.35 TB/s; NVLink 900 GB/s, 450
# each way) and the NVIDIA DGX H100 datasheet (8 cards a node, one 400 Gb/s
# ConnectX-7 port a card: 50 GB/s each way between nodes).
HW = {
    "flops": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "float16": 989e12},
    "hbm_bw": 3.35e12,
    "link_bw": {"nvlink": 450e9, "node": 50e9},
}
CARDS_PER_NODE = 8

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_RATE = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16"}


def skip_reason(cfg: ModelConfig, shape_name: str) -> str | None:
    info = SHAPES[shape_name]
    if info["kind"] == "decode" and cfg.encoder_only:
        return "encoder-only: no autoregressive decode"
    if shape_name == "long_500k":
        if cfg.encoder_only:
            return "encoder-only: no decode"
        if not cfg.supports_long_context_decode:
            return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None


# ---------------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if info["kind"] in ("train", "prefill"):
        if cfg.input_mode == "tokens":
            specs = {"tokens": meta((B, S), torch.int32)}
        else:
            specs = {"embeddings": meta((B, S, cfg.d_model), torch.bfloat16)}
        if info["kind"] == "train":
            specs["labels"] = meta((B, S), torch.int32)
        return specs
    # decode: one new token against a seq-long cache
    if cfg.input_mode == "tokens":
        return {"tokens": meta((B,), torch.int32)}
    return {"tokens": meta((B, cfg.d_model), torch.bfloat16)}


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(xs, out: list) -> list:
    """The tensors among ``xs``, lists and tuples searched (an op's
    arguments and results)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
    return out


class OpCount(TorchDispatchMode):
    """Counts every op dispatched inside it (see the module docstring), and
    while active has the kernel wrappers charge it (``runtime.charging_to``).
    ``with OpCount() as c: ...``; leaving restores the dispatch modes and the
    wrappers, also on an exception."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0                     # matmul formulas + kernel charges
        self.ops = collections.Counter()     # operations by units' rate (kernel passes included)
        self.bytes = 0.0
        self.rows: list[tuple[str, float, int]] = []  # (op, flops, bytes), op by op
        self.matmuls = collections.Counter()  # "op dtype shapes" -> flops
        self.kernels: dict[str, dict] = {}
        self.copies: list[dict] = []
        self.live = self.peak = 0
        self._alive: dict[int, int] = {}     # storage key -> bytes, allocated in the count
        self._stack = None

    # -- the mode --------------------------------------------------------
    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(runtime.charging_to(self))
        try:
            super().__enter__()
        except BaseException:
            self._stack.close()
            raise
        return self

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(args, _tensors(kwargs.values(), []))
        outs = _tensors((out,), [])
        in_keys = {_key(t) for t in ins}
        name = str(func.overloadpacket)
        fresh = [t for t in outs if _key(t) not in in_keys]
        for t in fresh:
            self._track(t)
        if name.startswith("aten.empty") or name == "aten.new_empty":
            nbytes = 0  # an allocation moves nothing
        elif not fresh and not func._schema.is_mutable:
            nbytes = 0  # a view
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        flops = 0
        if func.overloadpacket in flop_registry:
            flops = int(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
            rate = _RATE.get(ins[0].dtype, "float32")
            self.ops[rate] += flops
            shapes = "x".join(str(list(t.shape)) for t in ins)
            self.matmuls[f"{name.removeprefix('aten.')} {ins[0].dtype} {shapes}"] += flops
        self.flops += flops
        self.bytes += nbytes
        self.rows.append((name, flops, nbytes))
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        k = storage._cdata
        if k in self._alive:
            return
        nb = storage.nbytes()
        self._alive[k] = nb
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, k)

    def _free(self, k: int) -> None:
        self.live -= self._alive.pop(k, 0)

    # -- what the kernels and the copies charge ---------------------------
    def kernel(self, name: str, nbytes: float, flops: float, rate: str, passes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0, "flops": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["flops"] += flops
        self.flops += flops
        self.ops[rate] += flops * passes
        self.bytes += nbytes
        self.rows.append((f"kernel:{name}", flops, nbytes))

    def copy(self, kind: str, shape, dtype, nbytes: int, link: str) -> None:
        if nbytes:
            self.copies.append({"kind": kind, "shape": tuple(shape), "dtype": str(dtype),
                                "bytes": int(nbytes), "link": link})

    # -- summaries --------------------------------------------------------
    def collectives(self) -> dict:
        out = {c: 0.0 for c in COLLECTIVES}
        links = {k: 0.0 for k in HW["link_bw"]}
        for c in self.copies:
            out[c["kind"]] += c["bytes"]
            links[c["link"]] += c["bytes"]
        out["total"] = sum(out[c] for c in COLLECTIVES)
        out["by_link"] = links
        return out

    def copy_groups(self) -> collections.Counter:
        """(kind, dtype[shape]) -> bytes over the count's copies."""
        g = collections.Counter()
        for c in self.copies:
            g[c["kind"], f"{c['dtype']}{list(c['shape'])}"] += c["bytes"]
        return g

    def numbers(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "ops": {k: float(v) for k, v in sorted(self.ops.items())},
                "collectives": self.collectives(),
                "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())}}


# ---------------------------------------------------------------------------
# copies between devices (one card a mesh position)
# ---------------------------------------------------------------------------


def _flat(mesh, pos) -> int:
    return int(np.ravel_multi_index(pos, mesh.devices.shape))


def _link(mesh, pos, peers) -> str:
    node = _flat(mesh, pos) // CARDS_PER_NODE
    return ("nvlink" if all(_flat(mesh, q) // CARDS_PER_NODE == node for q in peers)
            else "node")


def axis_links(mesh) -> dict[str, str]:
    """The link each mesh axis crosses with one card a position in
    row-major order and ``CARDS_PER_NODE`` cards a node: an axis whose
    positions span more than a node crosses the link between nodes (on
    (16, 16), "model" spans 16 cards, two nodes, and "data" steps 16)."""
    shape = mesh.devices.shape
    out = {}
    for i, name in enumerate(mesh.axis_names):
        stride = int(np.prod(shape[i + 1:]))
        out[name] = "nvlink" if stride * shape[i] <= CARDS_PER_NODE else "node"
    return out


def _piece_bytes(sh, shape, itemsize: int) -> int:
    return int(np.prod(sh.shard_shape(shape))) * itemsize


def _region_key(sh, shape, pos):
    return tuple((s.start, s.stop) for s in sh.region(shape, pos))


@functools.lru_cache(maxsize=4096)
def _gather_terms(sh, shape, itemsize: int, pos, n_shards: int) -> tuple[int, str]:
    own = _region_key(sh, shape, pos)
    peers = [q for q in sh.mesh.positions() if _region_key(sh, shape, q) != own]
    piece = _piece_bytes(sh, shape, itemsize)
    recv = int(np.prod(shape)) * itemsize - piece if peers else 0
    return max(recv, (n_shards - 1) * piece), _link(sh.mesh, pos, peers or [pos])


def _gather_copy(counter, sh, shape, dtype, pos, n_shards: int) -> None:
    """The all-gather of one leaf onto ``pos``'s card: it receives every
    region but its own; its piece goes to the other shards' cards."""
    counter.copy("all-gather", shape, dtype,
                 *_gather_terms(sh, tuple(shape), dtype.itemsize, tuple(pos), n_shards))


@functools.lru_cache(maxsize=4096)
def _reduce_terms(sh, shape, itemsize: int, pos, n_shards: int) -> tuple[int, str]:
    peers = [q for q in sh.mesh.positions() if q != pos]
    piece = _piece_bytes(sh, shape, itemsize)
    return max(len(peers) * piece, (n_shards - 1) * piece), _link(sh.mesh, pos, peers or [pos])


def _reduce_copy(counter, sh, shape, dtype, pos, n_shards: int) -> None:
    """One shard's term of the reduce-scatter: its gradient's slice to every
    other position's piece; the other shards' terms into its own piece."""
    counter.copy("reduce-scatter", shape, dtype,
                 *_reduce_terms(sh, tuple(shape), dtype.itemsize, tuple(pos), n_shards))


# ---------------------------------------------------------------------------
# cells: a pass over one position's local shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """One position's pass of a cell: ``run(counter) -> outputs`` over the
    ``args`` (local pieces; ``argument_bytes`` their specs' bytes)."""

    run: object
    args: tuple
    argument_bytes: int
    parts: dict = dataclasses.field(default_factory=dict)  # argument bytes by part


def _spec_bytes(shapes, shardings) -> int:
    return sum(_piece_bytes(sh, tuple(x.shape), x.dtype.itemsize)
               for x, sh in zip(_leaves(shapes), _leaves(shardings)))


def _leaves(t) -> list:
    """Leaves of a tree whose nodes may be ``LayerKVCache``s (their fields
    in ``FIELDS`` order) and ``NamedSharding`` leaves."""
    if isinstance(t, LayerKVCache):
        return [getattr(t, f) for f in t.FIELDS]
    if isinstance(t, dict) and t and set(t) == set(LayerKVCache.FIELDS):
        return [t[f] for f in LayerKVCache.FIELDS]
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, (list, tuple)):
        return [x for v in t for x in _leaves(v)]
    return [] if t is None else [t]


def _local(shapes, shardings, device):
    """Each leaf's piece at one position: an empty tensor of its shard shape
    (a ``LayerKVCache`` keeps its spec)."""
    if isinstance(shapes, LayerKVCache):
        return LayerKVCache(**{f: _local(getattr(shapes, f), shardings[f], device)
                               for f in shapes.FIELDS}, spec=shapes.spec)
    if isinstance(shapes, dict):
        return {k: _local(v, shardings[k], device) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        out = [_local(v, s, device) for v, s in zip(shapes, shardings)]
        return type(shapes)(*out) if hasattr(shapes, "_fields") else type(shapes)(out)
    if shapes is None:
        return None
    # zeros off the meta device: a CPU or CUDA pass reads valid token ids
    make = torch.empty if device.type == "meta" else torch.zeros
    return make(shardings.shard_shape(tuple(shapes.shape)), dtype=shapes.dtype, device=device)


def _gathered(counter, pieces, shapes, shardings, pos, n_shards, device):
    """The parameters whole on ``pos``'s card: the all-gather of each leaf
    (its own piece copied into place, the rest arriving as copies)."""
    def one(piece, x, sh):
        shape = tuple(x.shape)
        _gather_copy(counter, sh, shape, x.dtype, pos, n_shards)
        if tuple(piece.shape) == shape:
            return piece
        full = torch.empty(shape, dtype=x.dtype, device=device)
        full[sh.region(shape, pos)].copy_(piece)
        return full

    return tree.map_(one, pieces, shapes, shardings)


def _train_pass(cfg, scfg, mesh, pos, pshapes, pshard, bshard, bspecs, device):
    B = next(iter(bspecs.values())).shape[0]
    n = step_lib.n_batch_shards(cfg, scfg, mesh, B)
    mb = max(scfg.microbatches, 1)
    bp = B // mb
    pl, sl = tree.leaves(pshapes), tree.leaves(pshard)

    def run(counter, params, opt_state, err, batch):
        if n == 1:  # the whole batch on the first card
            full = _gathered(counter, params, pshapes, pshard, pos, 1, device)
            whole = {k: _batch_rows(counter, v, bspecs[k], bshard[k], pos, 0, B, device)
                     for k, v in batch.items()}
            loss, parts, g = step_lib.loss_and_grads(cfg, scfg, full, whole)
            del full
            acc = [_accumulate(counter, None, x, s, y, pos, 1) for x, s, y in zip(g, sl, pl)]
        else:
            b = bp // n
            acc = [None] * len(pl)
            for i in range(mb):
                part = {k: _batch_rows(counter, v, bspecs[k], bshard[k], pos, i * bp,
                                       (i + 1) * bp, device) for k, v in batch.items()}
                count = step_lib._count(part)
                full = _gathered(counter, params, pshapes, pshard, pos, n, device)
                rows = {k: v[:b] for k, v in part.items()}
                loss, parts, g = step_lib.value_and_grad(cfg, scfg, full, rows, count=count)
                del full
                acc = [_accumulate(counter, a, x, s, y, pos, n, torch.float32 if mb > 1 else None)
                       for a, x, s, y in zip(acc, g, sl, pl)]
                del g
            if mb > 1:
                for a in acc:
                    a.div_(mb)
        grads = tree.unflatten(params, acc)
        if err is not None:
            payload = grad_compress.payload_bytes(grads)
            counter.copy("all-reduce", (payload,), torch.int8, payload,
                         _link(mesh, pos, [q for q in mesh.positions() if q != tuple(pos)]))
            grads, err = step_lib._cross_pod_compressed_allreduce(grads, err)
        params, opt_state, metrics = adamw.update(scfg.opt, grads, opt_state, params)
        return (params, opt_state, err), metrics

    return run


def _batch_rows(counter, piece, spec, sh, pos, start, stop, device):
    """Rows [start, stop) of a batch field on ``pos``'s card: the rows of
    its own piece are there, the rest arrive (the port gathers a microbatch
    part on the first card)."""
    shape = tuple(spec.shape)
    own = sh.region(shape, pos)[0]
    lo, hi = max(own.start, start), min(own.stop, stop)
    row = int(np.prod(shape[1:])) * spec.dtype.itemsize
    peers = [q for q in sh.mesh.positions() if sh.region(shape, q)[0] != own]
    counter.copy("all-gather", (stop - start, *shape[1:]), spec.dtype,
                 (stop - start - max(hi - lo, 0)) * row, _link(sh.mesh, pos, peers or [pos]))
    if tuple(piece.shape) == shape:
        return piece[start:stop]
    # the arriving rows written (and valid token ids off the meta device)
    part = torch.zeros((stop - start, *shape[1:]), dtype=spec.dtype, device=device)
    if hi > lo:
        part[lo - start:hi - start].copy_(piece[lo - own.start:hi - own.start])
    return part


def _accumulate(counter, acc, full, sh, x, pos, n_shards, dtype=None):
    """``sharding.accumulate`` at one position: the shard's own slice into
    its piece, and the other shards' terms arriving into it."""
    shape = tuple(x.shape)
    _reduce_copy(counter, sh, shape, full.dtype, pos, n_shards)
    own = full[sh.region(shape, pos)]
    if acc is None:
        acc = own.to(full.dtype if dtype is None else dtype, copy=True).contiguous()
    else:
        acc.add_(own.to(acc.dtype))
    for _ in range(n_shards - 1):
        acc.add_(torch.empty(acc.shape, dtype=full.dtype, device=acc.device).to(acc.dtype))
    return acc


def build_train_cell(cfg: ModelConfig, shape_name: str, mesh, *, q_chunk=2048,
                     kv_chunk=2048, microbatches=8, grad_compress=False,
                     device="meta") -> Cell:
    scfg = step_lib.TrainStepConfig(remat=True, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                    microbatches=microbatches,
                                    cross_pod_grad_compress=grad_compress)
    bspecs = input_specs(cfg, shape_name)
    _, state_shapes, in_sh, _ = step_lib.build_train_artifacts(cfg, mesh, scfg, bspecs)
    dev = torch.device(device)
    state = _local(state_shapes, in_sh[0], dev)
    batch = {k: _local(v, in_sh[1][k], dev) for k, v in bspecs.items()}
    parts = {name: _spec_bytes(x, sh) for name, x, sh in zip(
        ("params", "moments", "err"), state_shapes, in_sh[0])}
    parts["batch"] = _spec_bytes([bspecs[k] for k in sorted(bspecs)],
                                 [in_sh[1][k] for k in sorted(bspecs)])
    run = _train_pass(cfg, scfg, mesh, mesh.positions()[0], state_shapes[0], in_sh[0][0],
                      in_sh[1], bspecs, dev)
    return Cell(run=run, args=(*state, batch), argument_bytes=sum(parts.values()), parts=parts)


def _serve_parts(cfg, shape_name, mesh, device):
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    art = step_lib.build_serve_artifacts(cfg, mesh, batch=B, prompt_len=S, max_seq=S)
    pos = mesh.positions()[0]
    params = _local(art["pshapes"], art["pshard"], device)
    bspecs = input_specs(cfg, shape_name)
    bshard = {k: shd.batch_sharding(mesh, v) for k, v in bspecs.items()}
    batch = {k: _local(v, bshard[k], device) for k, v in bspecs.items()}
    arg_bytes = (_spec_bytes(art["pshapes"], art["pshard"])
                 + sum(_piece_bytes(bshard[k], tuple(v.shape), v.dtype.itemsize)
                       for k, v in bspecs.items()))
    n = shd._data_size(mesh) if B % shd._data_size(mesh) == 0 else 1
    return art, pos, params, batch, arg_bytes, n


def build_prefill_cell(cfg: ModelConfig, shape_name: str, mesh, *, q_chunk=2048,
                       kv_chunk=2048, device="meta") -> Cell:
    S = SHAPES[shape_name]["seq"]
    dev = torch.device(device)
    art, pos, params, batch, arg_bytes, n = _serve_parts(cfg, shape_name, mesh, dev)

    def run(counter, params, batch):
        full = _gathered(counter, params, art["pshapes"], art["pshard"], pos, n, dev)
        if cfg.encoder_only:
            logits, _ = M.forward(full, cfg, batch, q_chunk=q_chunk, kv_chunk=kv_chunk)
            return logits
        logits, state = M.prefill(full, cfg, batch, S, q_chunk=q_chunk)
        return logits[:, -1], state

    return Cell(run=run, args=(params, batch), argument_bytes=arg_bytes)


def build_decode_cell(cfg: ModelConfig, shape_name: str, mesh, *, device="meta",
                      **_chunks) -> Cell:
    """One decode step over the shard's local state; the chunk knobs
    ``run_analysis`` passes every cell are taken and ignored."""
    dev = torch.device(device)
    art, pos, params, batch, arg_bytes, n = _serve_parts(cfg, shape_name, mesh, dev)
    state = _local(art["state_shapes"], art["sshard"], dev)
    position = torch.zeros((), dtype=torch.int32, device=dev)
    arg_bytes += 4 + _spec_bytes(art["state_shapes"], art["sshard"])

    def run(counter, params, tokens, position, state):
        full = _gathered(counter, params, art["pshapes"], art["pshard"], pos, n, dev)
        work, back = _widened(counter, state, art["state_shapes"], art["sshard"], pos, dev)
        logits, _ = M.decode_step(full, cfg, tokens, position, work)
        for piece, wide, reg, nbytes, link in back:
            counter.copy("collective-permute", wide.shape, wide.dtype, nbytes, link)
            piece.copy_(wide[reg])
        return logits, state

    return Cell(run=run, args=(params, batch["tokens"], position, state),
                argument_bytes=arg_bytes)


def _widened(counter, state, shapes, shardings, pos, device):
    """The decode state as the pass reads it: ``cache_shardings`` splits a
    Mamba2 state's conv channels and heads on "model", while the pass runs
    whole matmuls, so each such piece is gathered to the shard's full width
    (its rows only) and its slice written back after the step.  KV caches
    stay local: attention runs over the local compression blocks.  Returns
    (the state to run on, [(piece, widened, region, bytes, link)]).  The
    specs replicate a cache's two length vectors; the pass reads its rows'
    (a view)."""
    work, back = dict(state), []
    if "kv" in state:
        kv = []
        for c, x, sh in zip(state["kv"], shapes["kv"], shardings["kv"]):
            if c.n_flushed.shape[0] != c.k_buf.shape[0]:
                r = sh["k_buf"].region(tuple(x.k_buf.shape), pos)[0]
                c = dataclasses.replace(c, n_flushed=c.n_flushed[r], buf_len=c.buf_len[r])
            kv.append(c)
        work["kv"] = kv
    for key in ("ssm", "ssm_tail"):
        if key not in state:
            continue

        def one(piece, x, sh):
            shape = tuple(x.shape)
            reg = sh.region(shape, pos)
            rows = (reg[0].stop - reg[0].start,)
            wide_shape = rows + shape[1:]
            if tuple(piece.shape) == wide_shape:
                return piece
            nbytes = (int(np.prod(wide_shape)) - piece.numel()) * piece.element_size()
            peers = [q for q in sh.mesh.positions()
                     if sh.region(shape, q)[0] == reg[0] and sh.region(shape, q) != reg]
            link = _link(sh.mesh, pos, peers or [pos])
            counter.copy("all-gather", wide_shape, piece.dtype, nbytes, link)
            wide = torch.empty(wide_shape, dtype=piece.dtype, device=device)
            inner = (slice(0, rows[0]),) + reg[1:]
            wide[inner].copy_(piece)
            back.append((piece, wide, inner, nbytes, link))
            return wide

        work[key] = tree.map_(one, state[key], shapes[key], shardings[key])
    return work, back


def build_cell(cfg, shape_name, mesh, **kw) -> Cell:
    kind = SHAPES[shape_name]["kind"]
    build = {"train": build_train_cell, "prefill": build_prefill_cell,
             "decode": build_decode_cell}[kind]
    return build(cfg, shape_name, mesh, **kw)


# ---------------------------------------------------------------------------
# counting a cell
# ---------------------------------------------------------------------------


def _storages(t) -> dict[int, int]:
    return {_key(x): _nbytes(x) for x in _leaves(t) if isinstance(x, torch.Tensor)}


def count_cell(cell: Cell) -> tuple[OpCount, dict]:
    """Run the cell's pass under an ``OpCount``; returns (the counter, the
    ``memory`` fields)."""
    args = _storages(cell.args)
    with OpCount() as counter:
        out = cell.run(counter, *cell.args)
    outs = _storages(out)
    memory = {"argument_bytes": int(cell.argument_bytes),
              "output_bytes": int(sum(outs.values())),
              "temp_bytes": int(counter.peak),
              "alias_bytes": int(sum(v for k, v in outs.items() if k in args))}
    return counter, memory


def analysis_depths(cfg: ModelConfig) -> tuple[ModelConfig, ModelConfig, int, int]:
    """Two reduced-depth configs + their depths in 'units' (layers/periods)."""
    if cfg.family == "hybrid":
        p = cfg.hybrid_period
        c1 = dataclasses.replace(cfg, n_layers=1 * p)
        c2 = dataclasses.replace(cfg, n_layers=2 * p)
        return c1, c2, 1, 2
    c1 = dataclasses.replace(cfg, n_layers=1)
    c2 = dataclasses.replace(cfg, n_layers=2)
    return c1, c2, 1, 2


def full_units(cfg: ModelConfig) -> float:
    """Depth in the units used by analysis_depths (layers, or periods with
    the tail counted as a mamba-share fraction of a period)."""
    if cfg.family == "hybrid":
        n_periods, ppm, tail = M._hybrid_counts(cfg)
        return n_periods + (tail / ppm) * (ppm / cfg.hybrid_period)  # ≈ mamba share
    return float(cfg.n_layers)


def _extrap(a, b, L: float, d1: int, d2: int):
    if isinstance(a, dict):
        return {k: _extrap(a[k], b[k], L, d1, d2) for k in a}
    per = (b - a) / (d2 - d1)
    return max(a + (L - d1) * per, 0.0)


def run_analysis(cfg: ModelConfig, shape_name: str, mesh, device="meta") -> dict:
    """Reduced-depth counts -> extrapolated flops / bytes / ops / copies."""
    kind = SHAPES[shape_name]["kind"]
    c1, c2, d1, d2 = analysis_depths(cfg)
    ck = 2048 if SHAPES[shape_name]["seq"] <= 4096 else 8192
    kw = dict(q_chunk=ck, kv_chunk=ck, device=device)
    if kind == "train":
        kw["microbatches"] = 1
    if cfg.ssm_state:
        c1 = dataclasses.replace(c1, ssm_chunk=2048)
        c2 = dataclasses.replace(c2, ssm_chunk=2048)

    def one(c):
        counter, _ = count_cell(build_cell(c, shape_name, mesh, **kw))
        nums = counter.numbers()
        nums.pop("kernels")
        return nums

    n1, n2 = one(c1), one(c2)
    L = full_units(cfg)
    out = _extrap({k: n1[k] for k in ("flops", "bytes", "ops", "collectives")},
                  {k: n2[k] for k in ("flops", "bytes", "ops", "collectives")}, L, d1, d2)
    out["depth_points"] = {str(d1): n1, str(d2): n2}
    return out


# ---------------------------------------------------------------------------
# analytic terms (the reference's, to the float)
# ---------------------------------------------------------------------------


def _serve_shards(chips: int, batch: int) -> tuple[int, int, int]:
    """(model_n, data_n, batch_shards) of the serve mesh: TP over a 16-wide
    model axis, batch sharded over the data axes when it divides evenly."""
    model_n = 16  # single-pod mesh model axis
    data_n = max(chips // model_n, 1)
    batch_shards = data_n if batch % data_n == 0 else 1
    return model_n, data_n, batch_shards


def analytic_memory_bytes(cfg: ModelConfig, shape_name: str, chips: int) -> float:
    """Principled minimum device traffic per device per step, the
    reference's model term for term.

    train  : params (fwd read + bwd read + update write, bf16) + optimizer
             moments (read+write, f32) + remat-saved layer inputs (r+w).
    prefill: params read + KV-cache write (layout-aware compressed bytes)
             + 2x activations stream.
    decode : params read (one read per step, batch-amortized) + compressed
             KV-cache read.
    """
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq"]
    model_n, data_n, batch_shards = _serve_shards(chips, B)
    n_local_train = cfg.param_count() / chips
    n_local_serve = cfg.param_count() / model_n
    d = cfg.d_model

    def kv_bytes_per_token_layer() -> float:
        if not cfg.has_attention:
            return 0.0
        Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
        specs = M.cache_specs(cfg, S)
        if not specs:
            return 0.0
        per_layer = [cache_layouts.get_layout(sp.layout).bytes_per_token(sp, Hkv, Dh)
                     for sp in specs]
        return sum(per_layer) / len(per_layer)

    def n_attn_layers() -> int:
        if cfg.family == "hybrid":
            return cfg.n_layers // cfg.hybrid_period
        return cfg.n_layers if cfg.has_attention else 0

    kv_pt = kv_bytes_per_token_layer()
    ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S

    if info["kind"] == "train":
        tokens_local = B * S / data_n  # batch sharded on data axes
        mb_tokens = tokens_local / 8  # default microbatches=8
        act = cfg.n_layers * mb_tokens * d * 2 * 2  # saved inputs r+w
        return 3 * 2 * n_local_train + 2 * 8 * n_local_train + act
    if info["kind"] == "prefill":
        tokens_local = B * S / batch_shards
        kv_w = B * ctx * kv_pt * n_attn_layers() / (batch_shards * model_n)
        act = 2 * cfg.n_layers * tokens_local * d * 2 / model_n
        return 2 * n_local_serve + kv_w + act
    kv_r = B * ctx * kv_pt * n_attn_layers() / (batch_shards * model_n)
    ssm_state = 0.0
    if cfg.ssm_state:
        n_mamba = cfg.n_layers - (cfg.n_layers // cfg.hybrid_period
                                  if cfg.hybrid_period else 0)
        ssm_state = (2 * B * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
                     * 4 * n_mamba / (batch_shards * model_n))
    return 2 * n_local_serve + kv_r + ssm_state


def decode_kv_traffic(cfg: ModelConfig, shape_name: str, chips: int) -> dict | None:
    """Per-device decode-step KV traffic, fused vs materializing: the Fetch
    streams each layer's compressed bytes once a step
    (``CacheLayout.bytes_per_token``); a materializing attend would also
    write and read back the dequantized bf16 K/V, 2x the raw cache bytes."""
    info = SHAPES[shape_name]
    if info["kind"] != "decode" or not cfg.has_attention:
        return None
    B, S = info["batch"], info["seq"]
    model_n, _, batch_shards = _serve_shards(chips, B)
    Hkv, Dh = cfg.n_kv_heads, cfg.resolved_head_dim
    specs = M.cache_specs(cfg, S)
    if not specs:
        return None
    ctx = min(S, cfg.sliding_window) if cfg.sliding_window else S
    shard = batch_shards * model_n
    comp_pt = sum(cache_layouts.get_layout(sp.layout).bytes_per_token(sp, Hkv, Dh)
                  for sp in specs) / len(specs)
    raw_pt = 2.0 * Hkv * Dh * 2  # K+V bf16: the dequantized intermediate
    n_layers = len(specs)
    fused = B * ctx * comp_pt * n_layers / shard
    materialized = fused + 2.0 * B * ctx * raw_pt * n_layers / shard
    return {
        "fused_bytes": fused,
        "materialized_bytes": materialized,
        "traffic_ratio": materialized / max(fused, 1.0),
        "fused_s": fused / HW["hbm_bw"],
        "materialized_s": materialized / HW["hbm_bw"],
    }


def roofline_terms(analysis: dict, chips: int,
                   analytic_bytes: float | None = None) -> dict:
    """Per-device times: each unit's operations over its rate (a matmul at
    its operands' dtype, the Fetch's TF32 passes), bytes over HBM, each
    copy over the link it crosses; the counts are per device already."""
    comp = sum(n / HW["flops"][rate] for rate, n in analysis["ops"].items())
    mem = analysis["bytes"] / HW["hbm_bw"]
    coll = sum(b / HW["link_bw"][link]
               for link, b in analysis["collectives"]["by_link"].items())
    out = {"compute_s": comp, "memory_s": mem, "collective_s": coll}
    if analytic_bytes is not None:
        out["memory_analytic_s"] = analytic_bytes / HW["hbm_bw"]
        dom = max(("compute", comp), ("memory", out["memory_analytic_s"]),
                  ("collective", coll), key=lambda kv: kv[1])
    else:
        dom = max(("compute", comp), ("memory", mem), ("collective", coll),
                  key=lambda kv: kv[1])
    out["bottleneck"] = dom[0]
    return out


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    info = SHAPES[shape_name]
    D = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
    n = cfg.active_param_count()
    mult = 6 if info["kind"] == "train" else 2
    return float(mult * n * D)


# ---------------------------------------------------------------------------
# running a cell and the CLI
# ---------------------------------------------------------------------------


def meta_mesh(multi_pod: bool):
    """The production mesh over meta devices (a mesh may repeat a device)."""
    n = int(np.prod((2, 16, 16) if multi_pod else (16, 16)))
    return make_production_mesh(multi_pod=multi_pod, devices=["meta"] * n)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             analysis: bool = True, force: bool = False) -> dict:
    cfg = registry.get_config(arch)
    out_path = ARTIFACTS / mesh_kind / f"{arch}__{shape_name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    out_path.parent.mkdir(parents=True, exist_ok=True)

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "pending", "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    reason = skip_reason(cfg, shape_name)
    if reason:
        rec["status"] = "skipped"
        rec["reason"] = reason
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    mesh = meta_mesh(mesh_kind == "multipod")
    chips = mesh.size
    try:
        t0 = time.time()
        cell = build_cell(cfg, shape_name, mesh)
        t1 = time.time()
        counter, memory = count_cell(cell)
        rec["lower_s"], rec["compile_s"] = t1 - t0, time.time() - t1
        rec["memory"] = memory
        rec["cost_raw"] = counter.numbers()
        rec["links"] = axis_links(mesh)
        rec["status"] = "ok"
        del cell, counter
        if analysis and mesh_kind == "pod":
            rec["analysis"] = run_analysis(cfg, shape_name, mesh)
            rec["analytic_memory_bytes"] = analytic_memory_bytes(cfg, shape_name, chips)
            rec["roofline"] = roofline_terms(rec["analysis"], chips,
                                             rec["analytic_memory_bytes"])
            traffic = decode_kv_traffic(cfg, shape_name, chips)
            if traffic is not None:
                rec["decode_kv_traffic"] = traffic
            rec["model_flops"] = model_flops(cfg, shape_name)
            counted_global = rec["analysis"]["flops"] * chips  # the count is per device
            rec["hlo_flops_global"] = counted_global
            rec["useful_flops_ratio"] = (rec["model_flops"] / counted_global
                                         if counted_global else None)
    except Exception as e:  # noqa: BLE001 — record the failure, don't hide it
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-analysis", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = registry.ASSIGNED if (args.all or not args.arch) else [registry.canonical(args.arch)]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    n_ok = n_skip = n_fail = 0
    t_all = time.time()
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                t0 = time.time()
                rec = run_cell(arch, shape_name, mesh_kind,
                               analysis=not args.no_analysis, force=args.force)
                dt = time.time() - t0
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_fail += rec["status"] == "failed"
                extra = ""
                if rec["status"] == "ok" and "roofline" in rec:
                    r = rec["roofline"]
                    extra = (f" bottleneck={r['bottleneck']}"
                             f" c={r['compute_s']:.3f}s m={r['memory_s']:.3f}s"
                             f" ma={r.get('memory_analytic_s', 0):.3f}s"
                             f" x={r['collective_s']:.3f}s")
                    if "decode_kv_traffic" in rec:
                        extra += (" kv_fused/mat="
                                  f"1/{rec['decode_kv_traffic']['traffic_ratio']:.1f}x")
                if rec["status"] == "failed":
                    extra = " " + rec["error"][:120]
                print(f"[{mesh_kind}] {arch:22s} {shape_name:12s} "
                      f"{rec['status']:8s} ({dt:.1f}s){extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} failed={n_fail} ({time.time() - t_all:.1f} s)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
