"""The port's public facade (``repro_torch.api``) and the layouts' bulk
Fetch, held against the reference on the CPU:

* the counterparts of ``tests/test_api.py``: round trip, ``make_cache``
  serving every layout, huffman decode agreement with packed, unknown
  layouts, ``register_layout``, per-layer policies;
* ``decompress`` within 1e-6 of the reference's on the same cache state,
  and raising where the reference raises;
* ``api.serve``: the reference's keywords, ``mesh`` served (a bad one refused).

The offline quantizers and ``estimate_ratio`` are in
``tests/test_torch_quant.py``.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import cache as JC  # noqa: E402
from repro.core import policy as JP  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import layouts  # noqa: E402
from repro_torch.core import policy as TPOL  # noqa: E402
from repro_torch.core.policy import CompressionPolicy, LayerOverride, TensorPolicy  # noqa: E402

LAYOUTS = ["raw", "packed", "kivi", "huffman"]


def _kvq(rng, B=2, Hkv=2, S=96, D=16):
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    q = rng.normal(size=(B, Hkv * 2, D)).astype(np.float32)
    return k, v, q


def _policy(layout, m=TPOL):
    """The same policy from the port's policy module, or the reference's."""
    return m.CompressionPolicy(layout=layout, block_size=16,
                               k=m.TensorPolicy(rel_scale=0.02),
                               v=m.TensorPolicy(rel_scale=0.05))


def _exact(k, v, q):
    """Exact GQA attention over raw [B, Hkv, S, D] (numpy float64)."""
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).astype(np.float64)
    s = np.einsum("bhgd,bhsd->bhgs", qg, k) / math.sqrt(D)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return np.einsum("bhgs,bhsd->bhgd", w, v).reshape(B, Hq, D)


def _ref_compress(k, v, layout, max_seq=256, window=None):
    """The reference's cache state for the same inputs, from its compiled
    prefill (the Store the port follows; see core/layouts.py)."""
    spec = japi.make_spec(_policy(layout, JP), max_seq=max_seq, window=window)
    return jax.jit(JC.prefill, static_argnums=0)(spec, jnp.asarray(k), jnp.asarray(v))


def test_available_layouts_and_backends():
    assert set(api.available_layouts()) == set(japi.available_layouts()) == set(LAYOUTS)
    assert {"fused", "xla"} <= set(api.available_backends())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_roundtrip_parity_and_decompress_equals_reference(layout, rng):
    """compress -> decompress reconstructs within each layout's error bound
    and within 1e-6 of the reference's decompress on the same cache state;
    attend tracks exact attention and the reference's attend."""
    k, v, q = _kvq(rng)
    cache = api.compress(k, v, policy=_policy(layout), max_seq=256, device="cpu")
    kd, vd = api.decompress(cache)
    assert kd.shape == k.shape and vd.shape == v.shape and kd.dtype == torch.bfloat16
    lay = cache.spec.impl
    for a, b in zip((lay.decompress_k(cache.spec, cache), lay.decompress_v(cache.spec, cache)),
                    lay.fetch(cache.spec, cache)):
        assert torch.equal(a, b)
    k_err = float((kd.float() - torch.from_numpy(k)).abs().max())
    v_err = float((vd.float() - torch.from_numpy(v)).abs().max())
    bound = {"raw": 0.02, "kivi": 2.0}.get(layout, None)
    if bound is not None:
        assert k_err < bound and v_err < bound
    else:
        assert k_err < 0.1 and v_err < 0.2  # |x - x̂| <= step/2
    jcache = _ref_compress(k, v, layout)
    jk, jv = japi.decompress(jcache)
    np.testing.assert_allclose(kd.float().numpy(), np.asarray(jk, np.float32), atol=1e-6, rtol=0)
    np.testing.assert_allclose(vd.float().numpy(), np.asarray(jv, np.float32), atol=1e-6, rtol=0)
    out = api.attend(cache, torch.from_numpy(q)).numpy()
    tol = 0.3 if layout == "kivi" else 0.05
    assert np.abs(out - _exact(k, v, q)).max() < tol
    ref = np.asarray(japi.attend(jcache, jnp.asarray(q), backend="xla"))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_decompress_raises_where_the_reference_raises(rng):
    k, v, _ = _kvq(rng)
    # A sliding window of 32 tokens keeps 2 of the 6 flushed blocks.
    cache = api.compress(k, v, policy=_policy("packed"), max_seq=256, window=32, device="cpu")
    jcache = _ref_compress(k, v, "packed", window=32)
    for fn, c in ((api.decompress, cache), (japi.decompress, jcache)):
        with pytest.raises(ValueError, match="evicted blocks"):
            fn(c)
    cache = api.compress(k, v, policy=_policy("packed"), max_seq=256, device="cpu")
    cache.buf_len[1] = 3
    jcache = _ref_compress(k, v, "packed")
    jcache = dataclasses.replace(jcache, buf_len=jcache.buf_len.at[1].set(3))
    for fn, c in ((api.decompress, cache), (japi.decompress, jcache)):
        with pytest.raises(ValueError, match="uniform per-row lengths"):
            fn(c)


def test_decompress_of_a_paged_cache(rng):
    from repro_torch.core import pool

    k, v, _ = _kvq(rng)
    dense = api.compress(k, v, policy=_policy("packed"), max_seq=256, device="cpu")
    paged = pool.from_dense(dense, 64)
    for a, b in zip(api.decompress(paged), api.decompress(dense)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_make_cache_serves_all_layouts(layout, rng):
    """An empty make_cache accepts appends (a flush included) and serves
    attention close to exact attention."""
    B, Hkv, D = 2, 2, 16
    cache = api.make_cache(B, Hkv, D, policy=_policy(layout), max_seq=64, device="cpu")
    rows = 20  # > block_size: one compressed flush
    ks = rng.normal(size=(rows, B, Hkv, D)).astype(np.float32)
    vs = rng.normal(size=(rows, B, Hkv, D)).astype(np.float32)
    for t in range(rows):
        cache = api.append(cache, torch.from_numpy(ks[t]), torch.from_numpy(vs[t]))
    assert ((cache.n_flushed * 16 + cache.buf_len) == rows).all()
    q = rng.normal(size=(B, Hkv * 2, D)).astype(np.float32)
    out = api.attend(cache, torch.from_numpy(q)).numpy()
    tol = 0.5 if layout == "kivi" else 0.05  # 2 bits over a 16-token block
    assert np.abs(out - _exact(ks.transpose(1, 2, 0, 3), vs.transpose(1, 2, 0, 3), q)).max() < tol


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is served")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.make_cache(1, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.compress(np.zeros((1, 1, 16, 8), np.float32), np.zeros((1, 1, 16, 8), np.float32))


def test_huffman_end_to_end_decode_agreement(rng):
    """Huffman entropy-codes the packed layout's codes: decoded blocks agree
    bit for bit with packed's through prefill and appends, and attention
    through the same backend is identical."""
    k, v, q = _kvq(rng)
    cp = api.compress(k, v, policy=_policy("packed"), max_seq=256, device="cpu")
    ch = api.compress(k, v, policy=_policy("huffman"), max_seq=256, device="cpu")
    for a, b in zip(cp.spec.impl.fetch(cp.spec, cp), ch.spec.impl.fetch(ch.spec, ch)):
        assert torch.equal(a, b)
    qt = torch.from_numpy(q)
    assert torch.equal(api.attend(cp, qt, backend="xla"), api.attend(ch, qt, backend="xla"))
    for _ in range(16):
        kn = torch.from_numpy(rng.normal(size=(2, 2, 16)).astype(np.float32))
        vn = torch.from_numpy(rng.normal(size=(2, 2, 16)).astype(np.float32))
        cp, ch = api.append(cp, kn, vn), api.append(ch, kn, vn)
    assert (cp.n_flushed == 7).all() and (ch.n_flushed == 7).all()
    for a, b in zip(cp.spec.impl.fetch(cp.spec, cp), ch.spec.impl.fetch(ch.spec, ch)):
        assert torch.equal(a, b)


def test_unknown_layout_name_errors():
    with pytest.raises(ValueError, match="unknown cache layout"):
        layouts.get_layout("nope")
    with pytest.raises(ValueError, match="unknown cache layout"):
        CompressionPolicy(layout="nope")
    with pytest.raises(ValueError, match="unknown cache layout"):
        api.make_cache(1, 1, 8, policy=dataclasses.replace(
            CompressionPolicy(), overrides=(LayerOverride(layers=(0,), layout="nope"),)),
            device="cpu")


def test_register_layout_extends_registry():
    @api.register_layout("test-alias-raw")
    class AliasRaw(layouts.RawLayout):
        pass

    try:
        assert "test-alias-raw" in api.available_layouts()
        cache = api.make_cache(1, 1, 8, policy=CompressionPolicy(
            layout="test-alias-raw", block_size=8), max_seq=32, device="cpu")
        assert cache.spec.impl.name == "test-alias-raw"
    finally:
        layouts._REGISTRY.pop("test-alias-raw", None)


def test_policy_resolves_per_layer_like_the_reference():
    def pol(m):
        return m.CompressionPolicy(
            layout="packed", block_size=16,
            k=m.TensorPolicy(rel_scale=0.05), v=m.TensorPolicy(rel_scale=0.15),
            overrides=(
                m.LayerOverride(layers=(1, 3), k=m.TensorPolicy(rel_scale=0.02)),
                m.LayerOverride(layers=(3,), layout="kivi", v=m.TensorPolicy(bits=4)),
            ))

    specs = pol(TPOL).layer_specs(4, max_seq=128)
    jspecs = pol(JP).layer_specs(4, max_seq=128)
    assert [s.layout for s in specs] == ["packed", "packed", "packed", "kivi"]
    assert specs[3].rel_scale_k == 0.02 and specs[3].bits_v == 4
    for s, j in zip(specs, jspecs):
        assert (s.layout, s.rel_scale_k, s.rel_scale_v, s.bits_k, s.bits_v, s.block_size) == \
            (j.layout, j.rel_scale_k, j.rel_scale_v, j.bits_k, j.bits_v, j.block_size)
    spec = api.make_spec(pol(TPOL), layer=3, max_seq=128)
    assert spec.layout == "kivi" and spec.bits_v == 4


def test_per_layer_overrides_reach_model_state(rng):
    """A dense model under a non-uniform policy holds per-layer caches with
    the right specs, and chunked prefill + decode run end to end."""
    from repro_torch.models import model as M
    from repro_torch.models import registry

    cfg = dataclasses.replace(
        registry.get_smoke_config("yi_6b"), rel_scale_k=0.05,
        cache_overrides=(LayerOverride(layers=(1,), k=TensorPolicy(rel_scale=0.02)),))
    params = M.init_params(cfg, seed=0, device="cpu")
    st = M.init_decode_state(cfg, 1, 64, device="cpu")
    caches = st["kv"]
    assert len(caches) == cfg.n_layers
    assert caches[0].spec.rel_scale_k == 0.05 and caches[1].spec.rel_scale_k == 0.02
    assert caches[0].spec.bits_k != caches[1].spec.bits_k
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 16)))
    for pos in range(0, 16, cfg.cache_block):
        M.prefill_chunk(params, cfg, toks[:, pos:pos + cfg.cache_block], pos, st)
    lg, _ = M.decode_step(params, cfg, toks[:, -1], 16, st)
    assert bool(torch.isfinite(lg).all())


# ---------------------------------------------------------------------------
# api.serve
# ---------------------------------------------------------------------------


def test_serve_takes_the_reference_keywords_and_refuses_a_mesh():
    import inspect

    from repro_torch.models import model as M
    from repro_torch.models import registry

    ref = set(inspect.signature(japi.serve).parameters)
    assert ref <= set(inspect.signature(api.serve).parameters)
    cfg = registry.get_smoke_config("yi_6b")
    params = M.init_params(cfg, seed=0, device="cpu")
    server = api.serve(cfg, params, max_slots=2, max_seq=64, trace="events", device="cpu")
    assert isinstance(server, api.Server) and server.trace.level == "events"
    h = server.submit(api.Request(prompt=np.arange(9, dtype=np.int32), max_new_tokens=2))
    assert len(h.result().tokens) == 2
    # A mesh serves (four logical shards on the CPU), with the unsharded
    # tokens; a mesh the model cannot split raises the reference's error.
    from repro_torch.launch.mesh import make_serve_mesh

    prompt = np.arange(9, dtype=np.int32)
    sharded = api.serve(cfg, params, max_slots=2, max_seq=64, device="cpu",
                        mesh=make_serve_mesh("2,2", devices=["cpu"] * 4))
    assert sharded.stats()["shards"]["n_data"] == 2
    assert (sharded.submit(api.Request(prompt=prompt, max_new_tokens=2)).result().tokens
            .tolist() == h.result().tokens.tolist())
    with pytest.raises(ValueError, match="must divide n_kv_heads"):
        api.serve(cfg, params, mesh=make_serve_mesh("1,4", devices=["cpu"] * 4),
                  device="cpu")
    with pytest.raises(ValueError, match="trace must be"):
        api.serve(cfg, params, trace="verbose", device="cpu")
