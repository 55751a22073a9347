"""The port's model vs the reference's on the smoke config, through
``params_from_jax`` (identical weights): block-chunked prefill and decode
logits, teacher-forced, raw and packed (kivi differs from packed only in
its Store step, held bit-exact in test_torch_cache.py), and packed with
the dense family's qk-norm and tied-embedding options.

Tolerance: 1e-3 absolute on the logits.  Both sides compute in float32 but
sum in other orders; the raw layout stores bf16 K/V, where a last-bit
difference can flip a bf16 rounding (measured here: ~1e-4 raw, ~1e-5
packed)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import policy as JP  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch.core import policy as TP  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
import test_torch_shared as cached  # noqa: E402

ATOL = 1e-3


# Per-layer policy overrides: layer 0 gets its own K error bound and 2-bit
# V, layer 1 the kivi layout.  Each side builds them from its own classes.
OVERRIDES = (dict(layers=(0,), k=dict(rel_scale=0.02), v=dict(bits=2)),
             dict(layers=(1,), layout="kivi"))


def _overrides(policy):
    return tuple(policy.LayerOverride(**{**o, **{t: policy.TensorPolicy(**o[t])
                                                  for t in ("k", "v") if t in o}})
                 for o in OVERRIDES)


@pytest.mark.parametrize("layout,extra", [
    ("raw", {}), ("packed", {}),
    ("packed", {"qk_norm": True, "tie_embeddings": True}),  # the qwen3 options
    ("packed", {"cache_overrides": "per-layer"}),
], ids=["raw", "packed", "packed-qknorm-tied", "packed-layer-overrides"])
def test_prefill_chunk_and_decode_step_match_reference(layout, extra):
    jextra, textra = dict(extra), dict(extra)
    if "cache_overrides" in extra:
        jextra["cache_overrides"] = _overrides(JP)
        textra["cache_overrides"] = _overrides(TP)
    jcfg = dataclasses.replace(JR.get_smoke_config("yi_6b"), cache_layout=layout, **jextra)
    tcfg = dataclasses.replace(TR.get_smoke_config("yi_6b"), cache_layout=layout, **textra)
    jp, tp = cached.params(jcfg)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, 44).astype(np.int32)
    js = JM.init_decode_state(jcfg, 1, 128)
    ts = TM.init_decode_state(tcfg, 1, 128, device="cpu")
    jchunk = jax.jit(lambda p, t, pos, s: JM.prefill_chunk(p, jcfg, t, pos, s))
    jdecode = jax.jit(lambda p, t, pos, s: JM.decode_step(p, jcfg, t, pos, s))
    T = tcfg.cache_block
    for pos in range(0, 28, T):  # three full chunks and a partial one
        C = min(T, 28 - pos)
        lj, js = jchunk(jp, jnp.asarray(toks[None, pos:pos + C]), jnp.int32(pos), js)
        lt, _ = TM.prefill_chunk(tp, tcfg, torch.as_tensor(toks[None, pos:pos + C]), pos, ts)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    for pos in range(28, 44):  # decode across two flush boundaries
        lj, js = jdecode(jp, jnp.asarray(toks[pos:pos + 1]), jnp.int32(pos), js)
        lt, _ = TM.decode_step(tp, tcfg, torch.as_tensor(toks[pos:pos + 1]), pos, ts)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    assert [int(c.n_flushed[0]) for c in ts["kv"]] == [43 // T] * tcfg.n_layers
    assert ([(c.spec.layout, c.spec.bits_k, c.spec.bits_v) for c in ts["kv"]]
            == [(s.layout, s.bits_k, s.bits_v) for s in JM.cache_specs(jcfg, 128)])


def test_params_from_jax_shapes_and_count():
    jcfg = JR.get_smoke_config("yi_6b")
    tcfg = TR.get_smoke_config("yi_6b")
    jp, tp = cached.params(jcfg)
    fresh = TM.init_params(tcfg, seed=0, device="cpu")

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]

    assert [x.shape for x in leaves(tp)] == [x.shape for x in leaves(fresh)]
    assert sum(x.numel() for x in leaves(tp)) == tcfg.param_count()
    assert sum(x.numel() for x in leaves(fresh)) == sum(x.size for x in jax.tree.leaves(jp))
