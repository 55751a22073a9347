"""Serving engines over the compressed KV cache (the port of
``repro.serve.engine``).

``Engine`` is a thin wrapper over the continuous-batching ``Server``:
``generate(reqs)`` submits every request and drains the slot scheduler, so
heterogeneous prompt lengths and budgets decode side by side, results carry
per-request timing, and tokens are truncated at ``eos_id``.

``LockstepEngine`` keeps the pre-scheduler behaviour, the baseline the
reference's ``serve_throughput`` benchmark measures the Server against:
requests are grouped into length buckets, each group left-padded onto the
bucket grid, prefilled in ONE batched full-length ``model.prefill`` (every
attention layer's whole blocks of all the group's rows in one Store call)
and decoded in lockstep at one shared position until the whole group has
finished (finished rows keep burning steps), and nobody joins a running
group.  Tokens are not truncated at EOS.  Do not use it for new code.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.serve.scheduler import (Request, Result, Server, ServerConfig,
                                         cache_memory_report)

__all__ = ["EngineConfig", "Engine", "LockstepEngine", "Request", "Result", "Server",
           "ServerConfig", "cache_memory_report"]


@dataclasses.dataclass
class EngineConfig:
    bucket: int = 64          # LockstepEngine's prompt-length grid
    max_batch: int = 8        # concurrent slots (Server) / group size (lockstep)
    max_seq: int = 4096
    greedy: bool = True
    pad_id: int = 0
    # Decode-attention backend override for the Server (None = the config's
    # attn_backend); the lockstep baseline runs the config's own, as the
    # reference's does.
    attn_backend: str | None = None


class Engine:
    """``generate(list[Request]) -> list[Result]`` on top of the Server:
    requests join and leave decode slots mid-flight; ``ecfg.bucket`` is
    accepted and unused."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, q_chunk: int = 512,
                 device="cuda"):
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.server = Server(
            cfg, params,
            ServerConfig(max_slots=ecfg.max_batch, max_seq=ecfg.max_seq,
                         greedy=ecfg.greedy, pad_id=ecfg.pad_id,
                         attn_backend=ecfg.attn_backend),
            device=device, q_chunk=q_chunk)

    def generate(self, reqs: list[Request]) -> list[Result]:
        handles = [self.server.submit(r) for r in reqs]
        return [h.result() for h in handles]


class LockstepEngine:
    """The legacy bucket batcher (the benchmark baseline only)."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig, q_chunk: int = 512,
                 device="cuda"):
        self.cfg, self.params, self.ecfg = cfg, params, ecfg
        self.device = resolve_device(device)
        self._q_chunk = q_chunk

    def _buckets(self, reqs: list[Request]) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for i, r in enumerate(reqs):
            b = -(-len(r.prompt) // self.ecfg.bucket) * self.ecfg.bucket
            out.setdefault(b, []).append(i)
        return out

    def generate(self, reqs: list[Request]) -> list[Result]:
        results: list[Result | None] = [None] * len(reqs)
        for blen, idxs in self._buckets(reqs).items():
            for off in range(0, len(idxs), self.ecfg.max_batch):
                self._run_group(reqs, idxs[off:off + self.ecfg.max_batch], blen, results)
        return results  # type: ignore[return-value]

    def _run_group(self, reqs, group, blen, results):
        B = len(group)
        prompts = np.full((B, blen), self.ecfg.pad_id, np.int64)
        lens = np.zeros(B, np.int64)
        for j, i in enumerate(group):
            p = reqs[i].prompt
            prompts[j, blen - len(p):] = p  # left-pad into the bucket
            lens[j] = len(p)
        t0 = time.monotonic()
        logits, state = M.prefill(self.params, self.cfg,
                                  {"tokens": torch.as_tensor(prompts, device=self.device)},
                                  self.ecfg.max_seq, q_chunk=self._q_chunk)
        cur = torch.argmax(logits[:, -1], dim=-1)
        cur_host = cur.cpu().numpy()  # waits for the prefill
        t1 = time.monotonic()
        max_new = max(reqs[i].max_new_tokens for i in group)
        toks = np.zeros((B, max_new), np.int32)
        done = np.zeros(B, bool)
        pos = blen
        for t in range(max_new):
            toks[:, t] = cur_host
            for j, i in enumerate(group):
                if reqs[i].eos_id is not None and toks[j, t] == reqs[i].eos_id:
                    done[j] = True
                if t + 1 >= reqs[i].max_new_tokens:
                    done[j] = True
            if done.all():
                break
            logits, state = M.decode_step(self.params, self.cfg, cur, pos, state)
            cur = torch.argmax(logits, dim=-1)
            cur_host = cur.cpu().numpy()
            pos += 1
        t2 = time.monotonic()
        for j, i in enumerate(group):
            n = reqs[i].max_new_tokens
            results[i] = Result(tokens=toks[j, :n], prompt_len=int(lens[j]),
                                gen_s=t2 - t1, prefill_s=t1 - t0)
