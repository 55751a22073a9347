"""Mamba2 (state-space duality) mixer: chunked SSD for training and the
full-length prefill, and the constant-state recurrence for decode (the port
of ``repro.models.ssm``).

Plain PyTorch throughout: the reference computes all of this outside any
Pallas kernel, as einsums and a ``lax.scan``.  Decode keeps a fixed
[B, H, N, P] state and a small causal-conv window and no KV cache at all,
so an ssm model runs none of the compression kernels.

Shapes: d_inner = expand·d_model, P = ssm_head_dim, H = d_inner/P heads,
N = ssm_state, G = ssm_groups (B/C shared per group).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.obs.profiling import annotate


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    P = cfg.ssm_head_dim
    H = di // P
    N = cfg.ssm_state
    G = cfg.ssm_groups
    conv_ch = di + 2 * G * N
    return di, P, H, N, G, conv_ch


def init_mamba_block(gen, cfg: ModelConfig, *, device, dtype=torch.float32):
    """The reference's parameter names and shapes, with its init scales."""
    d = cfg.d_model
    di, P, H, N, G, conv_ch = _dims(cfg)
    kw = dict(device=device, dtype=dtype)
    return {
        "ln": torch.ones((d,), **kw),
        "in_proj": layers.dense_init(gen, (d, 2 * di + 2 * G * N + H), **kw),
        "conv_w": layers.dense_init(gen, (cfg.ssm_conv, conv_ch), scale=0.5, **kw),
        "conv_b": torch.zeros((conv_ch,), **kw),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)).to(dtype),
        "dt_bias": torch.zeros((H,), **kw),
        "D": torch.ones((H,), **kw),
        "norm": torch.ones((di,), **kw),
        "out_proj": layers.dense_init(gen, (di, d), **kw),
    }


def mamba_block_axes() -> dict:
    """The logical axes of ``init_mamba_block``'s leaves."""
    heads = ("ssm_heads",)
    return {"ln": ("embed",), "in_proj": ("embed", "ssm_proj"),
            "conv_w": ("conv_k", "ssm_conv_ch"), "conv_b": ("ssm_conv_ch",),
            "A_log": heads, "dt_bias": heads, "D": heads, "norm": ("ssm_inner",),
            "out_proj": ("ssm_inner", "embed")}


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, P, H, N, G, _ = _dims(cfg)
    return torch.split(proj, [di, di + 2 * G * N, H], dim=-1)  # z, xBC, dt


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S.  xBC: [B, S, C]; w: [K, C]."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


@annotate("ssd_scan")
def ssd_scan(x, a, dt, B, C, chunk: int, h0=None):
    """Core SSD: h_s = exp(a_s)·h_{s-1} + dt_s·B_s⊗x_s ;  y_s = C_s·h_s.

    x : [b, S, H, P]      a : [b, S, H] (log decay = dt·A, negative)
    dt: [b, S, H]         B, C : [b, S, G, N]
    h0: optional [b, H, N, P] initial state.
    Returns (y [b, S, H, P], h_final [b, H, N, P] float32).

    The same chunked algorithm as the reference, in a fixed number of
    batched products whatever S is.  Where the reference snaps the chunk
    down to a divisor of S (a prime S runs chunks of one token, S
    sequential steps), this pads S up to whole chunks of ``min(chunk, S)``
    with x = dt = a = 0 and B = C = 0: a padded step multiplies the state
    by exp(0) = 1 and adds nothing, so the state and the real outputs are
    unchanged.  The inter-chunk recurrence is one masked product over
    cumulative chunk decays instead of a scan.  The result equals the
    reference's within float32 rounding (tests/test_torch_ssm.py states
    the tolerance)."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    hpg = H // G
    Q = min(chunk, S)
    NC = -(-S // Q)
    pad = NC * Q - S
    f32 = torch.float32
    xf, af, dtf, Bf, Cf = (t.to(f32) for t in (x, a, dt, B, C))
    if pad:
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bf, Cf))
        af, dtf = (F.pad(t, (0, 0, 0, pad)) for t in (af, dtf))
    xc = xf.reshape(b, NC, Q, H, P)
    ac = af.reshape(b, NC, Q, H)
    dtc = dtf.reshape(b, NC, Q, H)
    Bc = Bf.reshape(b, NC, Q, G, N)
    Cc = Cf.reshape(b, NC, Q, G, N)

    cum = torch.cumsum(ac, dim=2)  # [b, NC, Q, H]
    # --- intra-chunk (diagonal blocks) ---
    Gmat = torch.einsum("bcign,bcjgn->bcijg", Cc, Bc)  # C_i · B_j per group
    # L[b,c,i,j,h] = exp(cum_i - cum_j) for i >= j, else 0; the mask sits
    # inside the exponent, where a masked entry would overflow.
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [b, c, i, j, h]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                              torch.tensor(-1e30, dtype=f32, device=x.device)))
    W = (L * dtc[:, :, None, :, :]).reshape(b, NC, Q, Q, G, hpg) * Gmat[..., None]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", W.reshape(b, NC, Q, Q, H), xc)

    # --- per-chunk states: S_c = Σ_j exp(cum_Q - cum_j)·dt_j·B_j⊗x_j ---
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [b, c, Q, h]
    Bh = Bc.repeat_interleave(hpg, dim=3)  # [b, c, Q, H, N]
    S_c = torch.einsum("bcjhn,bcjhp->bchnp", Bh, xc * (dtc * decay_to_end)[..., None])

    # --- inter-chunk recurrence, batched ---
    # h_in[c] (the state entering chunk c, c = 0 .. NC) =
    #   exp(Λ_c)·h0 + Σ_{j<c} exp(Λ_c - Λ_{j+1})·S_j,  Λ_c = Σ_{k<c} log decay_k.
    lam = F.pad(torch.cumsum(cum[:, :, -1, :], dim=1), (0, 0, 1, 0))  # [b, NC+1, H]
    ci = torch.arange(NC + 1, device=x.device)
    below = (ci[None, :NC] < ci[:, None])  # [NC+1, NC]: j < c
    expo = lam[:, :, None, :] - lam[:, None, 1:, :]  # [b, NC+1, NC, H]
    dec = torch.exp(torch.where(below[None, :, :, None], expo,
                                torch.tensor(-1e30, dtype=f32, device=x.device)))
    h_in = torch.einsum("bcjh,bjhnp->bchnp", dec, S_c)  # [b, NC+1, H, N, P]
    if h0 is not None:
        h_in = h_in + torch.exp(lam)[..., None, None] * h0.to(f32)[:, None]
    h_prev, h_final = h_in[:, :NC], h_in[:, NC]

    # --- inter-chunk contribution ---
    Ch = Cc.repeat_interleave(hpg, dim=3)  # [b, c, Q, H, N]
    y_off = torch.einsum("bcihn,bchnp->bcihp", Ch * torch.exp(cum)[..., None], h_prev)

    y = (y_diag + y_off).reshape(b, NC * Q, H, P)[:, :S]
    return y.to(x.dtype), h_final


def ssd_reference(x, a, dt, B, C, h0=None):
    """O(S) sequential oracle for ssd_scan (tests)."""
    b, S, H, P = x.shape
    G = B.shape[2]
    hpg = H // G
    f32 = torch.float32
    Bh = B.repeat_interleave(hpg, dim=2).to(f32)
    Ch = C.repeat_interleave(hpg, dim=2).to(f32)
    h = (torch.zeros((b, H, B.shape[3], P), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    ys = []
    for s in range(S):
        h = h * torch.exp(a[:, s].to(f32))[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh[:, s], x[:, s].to(f32) * dt[:, s].to(f32)[..., None])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, s], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def init_mamba_state(cfg: ModelConfig, batch: int, *, device, dtype=torch.float32):
    di, P, H, N, G, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
    }


def _dt_a(params, dt_raw: torch.Tensor):
    dt = F.softplus(dt_raw.to(torch.float32) + params["dt_bias"].to(torch.float32))
    A = -torch.exp(params["A_log"].to(torch.float32))  # [H]
    return dt, dt * A


def _gated_out(params, cfg: ModelConfig, u, y, z):
    y = layers.rms_norm_gated(y.to(u.dtype), z, params["norm"], cfg.norm_eps)
    return u + y @ params["out_proj"].to(u.dtype)


def _mixer(params, cfg: ModelConfig, u: torch.Tensor):
    """The block over a whole sequence u [B, S, d]: (out [B, S, d] with the
    residual, the pre-conv xBC [B, S, C], the final SSM state)."""
    di, P, H, N, G, conv_ch = _dims(cfg)
    x_in = layers.rms_norm(u, params["ln"], cfg.norm_eps)
    z, xBC, dt_raw = _split_proj(cfg, x_in @ params["in_proj"].to(x_in.dtype))
    xBC_conv = F.silu(_causal_conv(xBC, params["conv_w"].to(xBC.dtype),
                                   params["conv_b"].to(xBC.dtype)))
    xs, Bs, Cs = torch.split(xBC_conv, [di, G * N, G * N], dim=-1)
    b, S = u.shape[0], u.shape[1]
    xh = xs.reshape(b, S, H, P)
    dt, a = _dt_a(params, dt_raw)
    y, h_final = ssd_scan(xh, a, dt, Bs.reshape(b, S, G, N), Cs.reshape(b, S, G, N),
                          cfg.ssm_chunk)
    y = y + params["D"].to(torch.float32)[:, None] * xh.to(torch.float32)
    return _gated_out(params, cfg, u, y.reshape(b, S, di), z), xBC, h_final


@annotate("mamba")
def mamba_block_train(params, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """u: [B, S, d] -> [B, S, d] (residual included): the prefill's block
    without its decode state."""
    return _mixer(params, cfg, u)[0]


@annotate("mamba")
def mamba_block_prefill(params, cfg: ModelConfig, u: torch.Tensor):
    """Forward over the prompt u [B, S, d]; returns (out [B, S, d], the
    decode state {conv, ssm})."""
    out, xBC, h_final = _mixer(params, cfg, u)
    K, S = cfg.ssm_conv, u.shape[1]
    conv = (xBC[:, S - (K - 1):] if S >= K - 1 else F.pad(xBC, (0, 0, K - 1 - S, 0)))
    return out, {"conv": conv, "ssm": h_final}


@annotate("mamba")
def mamba_block_decode(params, cfg: ModelConfig, u: torch.Tensor, state: dict):
    """One-token decode.  u: [B, 1, d]; ``state`` from init/prefill, updated
    in place (the conv window shifts by one, the ssm state advances)."""
    di, P, H, N, G, conv_ch = _dims(cfg)
    x_in = layers.rms_norm(u, params["ln"], cfg.norm_eps)
    z, xBC, dt_raw = _split_proj(cfg, x_in @ params["in_proj"].to(x_in.dtype))
    # conv over the stored window + this token
    window = torch.cat([state["conv"].to(xBC.dtype), xBC], dim=1)  # [B, K, C]
    conv_out = (torch.einsum("bkc,kc->bc", window, params["conv_w"].to(xBC.dtype))
                + params["conv_b"].to(xBC.dtype))
    xs, Bs, Cs = torch.split(F.silu(conv_out), [di, G * N, G * N], dim=-1)
    b = u.shape[0]
    xh = xs.reshape(b, H, P).to(torch.float32)
    Bh = Bs.reshape(b, G, N).repeat_interleave(H // G, dim=1).to(torch.float32)
    Ch = Cs.reshape(b, G, N).repeat_interleave(H // G, dim=1).to(torch.float32)
    dt, a = _dt_a(params, dt_raw[:, 0])
    h = state["ssm"] * torch.exp(a)[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhnp", Bh, xh * dt[..., None])
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    y = y + params["D"].to(torch.float32)[:, None] * xh
    out = _gated_out(params, cfg, u, y.reshape(b, 1, di), z)
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(h)
    return out, state
