"""Deterministic, resumable data pipeline (the port of
``repro.data.pipeline``).

* ``TextCorpus``: byte-level LM data harvested from on-disk text (the
  installed Python sources), so KV statistics come from a real language
  distribution, not noise.
* ``SyntheticCorpus``: Zipfian token streams of any vocab, for throughput
  runs and smoke tests.

``batch_at(step)`` is a pure function of (seed, step): a restarted job
reading step k gets bit-identical batches, with no iterator state to
checkpoint.  Batches are numpy arrays; the trainer moves them to its device.
"""

from __future__ import annotations

import dataclasses
import hashlib
from pathlib import Path

import numpy as np


def harvest_text(max_bytes: int = 4 << 20) -> bytes:
    """Deterministically harvest real text from the installed Python tree:
    the ``email`` and ``json`` packages' sources, then ``torch``'s, each
    tree's ``*.py`` files in sorted order, up to ``max_bytes``.

    A deliberate departure from the reference, which reads ``jax/_src``
    third: the port runs where JAX is not installed.  Given the same bytes,
    ``TextCorpus`` batches equal the reference's."""
    import email
    import json as _json

    import torch

    roots = [Path(mod.__file__).parent for mod in (email, _json, torch)]
    buf = bytearray()
    for root in roots:
        for f in sorted(root.rglob("*.py")):
            try:
                buf.extend(f.read_bytes())
            except OSError:
                continue
            if len(buf) >= max_bytes:
                return bytes(buf[:max_bytes])
    return bytes(buf[:max_bytes])


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        int.from_bytes(hashlib.sha256(f"{seed}:{step}".encode()).digest()[:8], "little"))


@dataclasses.dataclass
class TextCorpus:
    """Byte-level corpus: vocab = 256."""

    seq_len: int
    global_batch: int
    seed: int = 0
    max_bytes: int = 4 << 20
    vocab_size: int = 256

    def __post_init__(self):
        data = np.frombuffer(harvest_text(self.max_bytes), np.uint8)
        self._data = data
        self._n_windows = (len(data) - 1) // self.seq_len

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step): stateless resume."""
        idx = _rng(self.seed, step).integers(0, self._n_windows, size=self.global_batch)
        starts = idx * self.seq_len
        tok = np.stack([self._data[s:s + self.seq_len] for s in starts]).astype(np.int32)
        lab = np.stack([self._data[s + 1:s + 1 + self.seq_len] for s in starts]).astype(np.int32)
        return {"tokens": tok, "labels": lab}

    def host_shard(self, batch: dict, host_id: int, n_hosts: int) -> dict:
        """Host ``host_id``'s contiguous share of a global batch."""
        per = self.global_batch // n_hosts
        sl = slice(host_id * per, (host_id + 1) * per)
        return {k: v[sl] for k, v in batch.items()}


@dataclasses.dataclass
class SyntheticCorpus:
    """Zipfian ids for arbitrary vocab sizes (benchmarks and smokes)."""

    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2

    def batch_at(self, step: int) -> dict:
        raw = _rng(self.seed, step).zipf(self.zipf_a, size=(self.global_batch,
                                                            self.seq_len + 1))
        ids = (raw % self.vocab_size).astype(np.int32)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
