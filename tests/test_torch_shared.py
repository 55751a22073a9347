"""Process-wide caches for the port's CPU tests: the reference's smoke-model
weights and their port twins, built once a test process.

The reference's ``init_params`` runs its random init op by op, each op
compiled on first use: about 12 s a config on an idle CPU, and the suite's
conftest drops JAX's compiled ops after every module.  pytest-xdist hands
each worker the port's modules in several runs of tests, so without this
cache a worker paid that compile again in every module, and in every test
that built its own pair.  The cached values are the weights ``init_params``
gives, bit for bit; the cache only keeps them.  ``np_params`` fills the
reference's parameter tree from a numpy seed instead, without running the
reference's init at all.  Nothing here is a test.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")

from repro.models import model as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402

# The fields that change a model's weights: every field but the cache
# policy's and the name's.
_CACHE_FIELDS = {f.name for f in dataclasses.fields(JR.get_smoke_config("yi_6b"))
                 if f.name.startswith("cache_") or f.name in (
                     "name", "rel_scale_k", "rel_scale_v", "kivi_bits", "attn_backend")}


def _weights_key(cfg) -> tuple:
    return tuple((f.name, getattr(cfg, f.name)) for f in dataclasses.fields(cfg)
                 if f.name not in _CACHE_FIELDS)


@functools.lru_cache(maxsize=None)
def _weights(key: tuple):
    jcfg = dataclasses.replace(JR.get_smoke_config("yi_6b"), **dict(key))
    jp, _ = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), jcfg, "cpu")


def params(jcfg):
    """(reference params, the port's params) of ``jcfg``'s model, from
    ``JM.init_params(jcfg, PRNGKey(0))``; shared by every caller with the
    same weight fields (the cache policy may differ).  Callers must not
    change them in place."""
    return _weights(_weights_key(jcfg))


_ONES = ("ln", "ln_attn", "ln_mlp", "ln_moe", "ln_f", "norm", "q_norm", "k_norm", "D")


def np_params(jcfg, seed: int):
    """The reference's parameter tree for ``jcfg`` (shapes from an abstract
    ``init_params``) filled from a numpy seed: norms near 1, A_log as the
    reference initialises it, the rest normal over sqrt(fan-in)."""
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k)[0], jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(path[-1].key)
        if name in _ONES:
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "A_log":
            return np.broadcast_to(np.log(np.linspace(1, 16, s.shape[-1])),
                                   s.shape).astype(np.float32).copy()
        if name in ("dt_bias", "conv_b"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        fan = s.shape[-2] if len(s.shape) >= 2 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)
