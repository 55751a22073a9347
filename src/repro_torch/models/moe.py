"""Mixture-of-Experts layer: top-k router and sort-based grouped expert
matmul (the port of ``repro.models.moe``).

Dispatch is the reference's: the (token, k) pairs are sorted by expert id
(stable), ranked within their expert's run (a cumulative max of the run
starts), and written into a dense ``[E, C, d]`` buffer that the per-expert
SwiGLU consumes as three batched matmuls.  The capacity ``C`` comes from
the shapes alone, so a pair ranked past it is dropped (capacity-factor
semantics): its combine weight contributes nothing.  Because the ranking
runs over the whole batch in row order, one row's routing can drop another
row's pair; MoE serving is not batched == solo, in the reference as here.

Two departures in how, not what:

* Dropped pairs land in a sentinel expert row ``E`` of an ``[E+1, C, d]``
  buffer that is sliced off, so nothing branches on device values and the
  step keeps no host sync.
* The combine gathers each (token, k) pair's slot output and sums over k,
  where the reference scatter-adds slots into tokens.  A scatter-add on the
  card uses atomics, whose order varies from run to run; the gather keeps
  every run, and paged against dense, bit-identical.  Only the float32
  summation order differs from the reference's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.obs.profiling import annotate


def init_moe(gen, cfg: ModelConfig, *, device, dtype=torch.float32):
    """Router ``[d, E]`` and the experts' SwiGLU weights ``[E, d, F]`` /
    ``[E, F, d]``, with the reference's init scales (fan-in = the leading
    axis)."""
    d, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    kw = dict(device=device, dtype=dtype)
    return {"router": layers.dense_init(gen, (d, E), **kw),
            "w_gate": layers.dense_init(gen, (E, d, Fe), **kw),
            "w_up": layers.dense_init(gen, (E, d, Fe), **kw),
            "w_down": layers.dense_init(gen, (E, Fe, d), **kw)}


def moe_axes() -> dict:
    """The logical axes of ``init_moe``'s leaves."""
    return {"router": ("embed", "experts_r"), "w_gate": ("experts", "embed", "expert_mlp"),
            "w_up": ("experts", "embed", "expert_mlp"),
            "w_down": ("experts", "expert_mlp", "embed")}


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: the reference's expression,
    on host ints."""
    return int(max(1, -(-n_tokens * cfg.top_k // cfg.n_experts) * cfg.capacity_factor))


def route(params, cfg: ModelConfig, xf: torch.Tensor):
    """Router and dispatch plan for ``xf`` [N, d]: the top-k experts and
    renormalised weights (float32), and for every (token, k) pair its slot
    ``(dest_e, dest_c)`` in the ``[E+1, C]`` buffer (``dest_e == E`` when
    dropped) and whether it was kept.  Also the load-balance loss."""
    N = xf.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = xf.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # [N, E]
    top_p, top_e = torch.topk(probs, K, dim=-1)  # [N, K]
    top_p = top_p / top_p.sum(-1, keepdim=True)  # renormalise the top-k

    # Switch-style load-balance loss: E * sum(mean prob_e * frac routed_e).
    me = probs.mean(0)
    ce = F.one_hot(top_e, E).to(torch.float32).sum(1).mean(0) / K
    aux = E * (me * ce).sum() * cfg.router_aux_coef

    C = capacity(cfg, N)
    dev = xf.device
    flat_e = top_e.reshape(-1)  # [N*K], pair j = token j // K, choice j % K
    se, order = torch.sort(flat_e, stable=True)
    idx = torch.arange(N * K, device=dev)
    is_start = torch.ones_like(se, dtype=torch.bool)
    is_start[1:] = se[1:] != se[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)), 0).values
    rank = idx - seg_start  # position within the expert's run
    keep_s = rank < C
    # Back from sorted order to pair order: pair order[i] sits at sorted i.
    inv = torch.empty_like(order)
    inv[order] = idx
    keep = keep_s[inv]
    dest_e = torch.where(keep, flat_e, torch.full_like(flat_e, E))
    dest_c = torch.where(keep, rank[inv], torch.zeros_like(rank))
    return top_p, top_e, dest_e, dest_c, keep, C, aux


def moe_apply(params, cfg: ModelConfig, x: torch.Tensor):
    """x: [B, S, d] -> (y [B, S, d], aux_loss scalar)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * S
    xf = x.reshape(N, d)
    top_p, _, dest_e, dest_c, keep, C, aux = route(params, cfg, xf)

    tok = torch.arange(N, device=x.device).repeat_interleave(K)
    buf = xf.new_zeros((E + 1, C, d))
    buf[dest_e, dest_c] = xf[tok]  # kept slots are distinct; drops hit row E
    xe = buf[:E]

    # Per-expert SwiGLU: three batched products over the expert axis (a
    # profiler scope of its own: they read every expert's weights).
    w_gate, w_up, w_down = (params[n].to(xf.dtype) for n in ("w_gate", "w_up", "w_down"))
    with annotate("moe_experts"):
        h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
        yb = torch.bmm(h, w_down)
    yb = torch.cat([yb, xf.new_zeros((1, C, d))])  # row E: the drops' zeros

    # Combine by gather, summed over k in a fixed order (no atomics).
    w = (top_p.reshape(-1) * keep).to(xf.dtype)
    contrib = (yb[dest_e, dest_c] * w[:, None]).reshape(N, K, d)
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    return y.reshape(B, S, d), aux


def init_moe_block(gen, cfg: ModelConfig, *, device, dtype=torch.float32):
    """Pre-norm attention + MoE FFN block parameters."""
    kw = dict(device=device, dtype=dtype)
    return {"ln_attn": torch.ones((cfg.d_model,), **kw),
            "attn": attention.init_attention(gen, cfg, **kw),
            "ln_moe": torch.ones((cfg.d_model,), **kw),
            "moe": init_moe(gen, cfg, **kw)}


def moe_block_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``init_moe_block``'s leaves."""
    return {"ln_attn": ("embed",), "attn": attention.attention_axes(cfg),
            "ln_moe": ("embed",), "moe": moe_axes()}
