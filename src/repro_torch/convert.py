"""Map the reference's parameter pytree onto the port's parameters, so both
compute the same function (the tests' bridge between the two packages).

The input is the reference's ``init_params`` tree with every leaf already
turned into a numpy array (the caller does ``jax.tree.map(np.asarray,
params)``; this module imports no JAX).  Layer-stacked leaves ``[L, ...]``
become one dict per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.config import ModelConfig


def params_from_jax(tree, cfg: ModelConfig, device):
    """Reference tree (numpy leaves) -> the port's parameter dict.

    ``{emb: {embed, unembed}, ln_f}`` plus, by family:

    * dense / MoE: ``blocks: {ln_attn, attn: {wq, wk, wv, wo}, <ffn>}``
      stacked on a leading layer axis, ``<ffn>`` being ``ln_mlp, mlp:
      {w_gate, w_up, w_down}`` (dense) or ``ln_moe, moe: {router [d, E],
      w_gate / w_up [E, d, F], w_down [E, F, d]}`` (MoE);
    * ssm: ``blocks``, the Mamba2 leaves (``ln, in_proj, conv_w, conv_b,
      A_log, dt_bias, D, norm, out_proj``) stacked on the layer axis;
    * hybrid: ``mamba`` (the Mamba2 leaves stacked [periods, ppm, ...]),
      ``mamba_tail`` ([tail, ...], when there is a tail) and one unstacked
      dense block ``attn_shared``.
    """
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)  # a writable copy

    def tree_at(sub, *idx):
        return {k: tree_at(v, *idx) if isinstance(v, dict) else t(v[idx])
                for k, v in sub.items()}

    out = {"emb": {k: t(v) for k, v in tree["emb"].items()}, "ln_f": t(tree["ln_f"])}
    if cfg.family in ("dense", "moe", "ssm"):
        out["blocks"] = [tree_at(tree["blocks"], i) for i in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        n_periods, ppm = tree["mamba"]["ln"].shape[:2]
        out["mamba"] = [[tree_at(tree["mamba"], i, j) for j in range(ppm)]
                        for i in range(n_periods)]
        if "mamba_tail" in tree:
            out["mamba_tail"] = [tree_at(tree["mamba_tail"], i)
                                 for i in range(tree["mamba_tail"]["ln"].shape[0])]
        out["attn_shared"] = tree_at(tree["attn_shared"])
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return out
