"""Atomic, asynchronous checkpoints (the port of ``repro.checkpoint.store``).

Layout (one directory a step)::

    ckpt_dir/
      step_000120.tmp/        # written first
        manifest.json         # leaf paths, shapes, dtypes, step, meta
        arrays/<leaf-id>.bin  # raw little-endian bytes a leaf (bf16 as u16)
      step_000120/            # renamed when complete: the commit marker

* A crash mid-write leaves only a ``.tmp`` directory, which ``restore`` and
  ``latest_step`` ignore and ``gc_old`` removes.
* ``restore`` loads on the host and moves each leaf to the device of the
  template's leaf (or to ``device``); given ``shardings`` (a tree of
  ``distributed.sharding.NamedSharding``) it places each leaf as pieces on
  that mesh: the elastic restart, onto any mesh.  ``save`` of a sharded
  state gathers each leaf and writes the full array, so the files do not
  depend on the mesh.
* ``AsyncCheckpointer`` snapshots the tree to host memory synchronously
  and writes it from a background thread, overlapping the I/O with the next
  steps.

A deliberate departure: the reference writes ``manifest.msgpack``; the port
writes the same fields as ``manifest.json`` (the card machine has no
msgpack).  The arrays are the same bytes.  The two packages keep their
checkpoints apart and never read each other's.
"""

from __future__ import annotations

import json
import re
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.distributed.sharding import Sharded, gather, place

_STEP_RE = re.compile(r"step_(\d+)$")
MANIFEST = "manifest.json"


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _to_host(x) -> torch.Tensor:
    """A leaf as one tensor on the host (a sharded leaf gathered)."""
    if isinstance(x, Sharded):
        t = gather(x, "cpu")
        return t.clone() if any(t is b for b in x.blocks) else t  # a snapshot, never a piece
    return x.detach().to("cpu", copy=True)


def _host_bytes(x) -> tuple[bytes, str]:
    """Little-endian bytes of ``x`` and its dtype name (bf16 through u16)."""
    x = (gather(x, "cpu") if isinstance(x, Sharded) else x.detach().cpu()).contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16).tobytes(), "bfloat16"
    arr = x.numpy()
    return arr.tobytes(), str(arr.dtype)


def _from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, np.uint16).reshape(shape).view(np.int16)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(dtype)).reshape(shape).copy())


def save(ckpt_dir: str | Path, step: int, tree, meta: dict | None = None) -> Path:
    """Synchronous save with an atomic commit (``.tmp`` then rename)."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"step_{step:06d}.tmp"
    final = ckpt_dir / f"step_{step:06d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": []}
    for i, (path, leaf) in enumerate(tree_lib.leaves_with_paths(tree)):
        raw, dt = _host_bytes(leaf)
        fname = f"{i:05d}.bin"
        (tmp / "arrays" / fname).write_bytes(raw)
        manifest["leaves"].append({"path": _path_str(path), "file": fname,
                                   "shape": list(leaf.shape), "dtype": dt})
    (tmp / MANIFEST).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic commit
    return final


def _committed(ckpt_dir: Path) -> list[Path]:
    return [p for p in ckpt_dir.iterdir()
            if _STEP_RE.search(p.name) and not p.name.endswith(".tmp")]


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(_STEP_RE.search(p.name).group(1)) for p in _committed(ckpt_dir)]
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, tree_like, step: int | None = None, device=None,
            shardings=None):
    """Restore into the structure of ``tree_like`` (the latest committed
    step unless ``step`` is given); each leaf is placed by the matching leaf
    of ``shardings`` when given, else goes to ``device``, else to its
    template leaf's device (a sharded template leaf: its own sharding).
    Returns (tree, manifest)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:06d}"
    manifest = json.loads((d / MANIFEST).read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    targets = (tree_lib.leaves(shardings) if shardings is not None
               else [x.sharding if isinstance(x, Sharded) and device is None else None
                     for x in tree_lib.leaves(tree_like)])
    out = []
    for (path, leaf), sh in zip(tree_lib.leaves_with_paths(tree_like), targets):
        ent = by_path[_path_str(path)]
        x = _from_bytes((d / "arrays" / ent["file"]).read_bytes(), ent["dtype"], ent["shape"])
        if sh is not None:
            out.append(place(x.to(sh.mesh.home), sh))
        else:
            out.append(x.to(device if device is not None else leaf.device))
    return tree_lib.unflatten(tree_like, out), manifest


def gc_old(ckpt_dir: str | Path, keep: int = 3) -> None:
    """Keep the newest ``keep`` committed checkpoints; drop stale .tmp dirs."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return
    committed = sorted(_committed(ckpt_dir),
                       key=lambda p: int(_STEP_RE.search(p.name).group(1)))
    for p in committed[:-keep] if keep else committed:
        shutil.rmtree(p)
    for p in ckpt_dir.iterdir():
        if p.name.endswith(".tmp"):
            shutil.rmtree(p)


class AsyncCheckpointer:
    """Snapshot to the host synchronously, write in a daemon thread (one write
    in flight at a time); a write's error is raised by the next ``wait``."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def save(self, step: int, tree, meta: dict | None = None):
        self.wait()
        host_tree = tree_lib.map_(_to_host, tree)

        def _write():
            try:
                save(self.ckpt_dir, step, host_tree, meta)
                gc_old(self.ckpt_dir, self.keep)
            except Exception as e:  # noqa: BLE001  (surfaced by wait)
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
