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
    """Reference tree ``{emb: {embed, unembed}, ln_f, blocks: {ln_attn,
    attn: {wq, wk, wv, wo}, ln_mlp, mlp: {w_gate, w_up, w_down}}}`` (numpy,
    blocks stacked on a leading layer axis) -> the port's parameter dict."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)  # a writable copy

    blocks = tree["blocks"]
    return {
        "emb": {k: t(v) for k, v in tree["emb"].items()},
        "ln_f": t(tree["ln_f"]),
        "blocks": [{
            "ln_attn": t(blocks["ln_attn"][i]),
            "attn": {k: t(v[i]) for k, v in blocks["attn"].items()},
            "ln_mlp": t(blocks["ln_mlp"][i]),
            "mlp": {k: t(v[i]) for k, v in blocks["mlp"].items()},
        } for i in range(cfg.n_layers)],
    }
