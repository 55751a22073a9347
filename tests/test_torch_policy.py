"""The port's per-layer cache policy against the reference's on the CPU:

* ``LayerOverride`` / ``CompressionPolicy`` resolution: every spec field of
  every layer equal to the reference's, for block size, layout, K/V
  quantizer, backend, span and unroll overrides, through ``ModelConfig``;
  a paged policy refuses a ``block_size`` override with the reference's
  ``ValueError``;
* ``blockwise_knobs``: the spec field, then ``REPRO_BLOCKWISE_*``, then the
  module default, with the reference's errors;
* the blockwise scan's output across spans (within 1e-5 absolute: float32
  sums in other orders), and across spans against the reference's;
* a ``Server`` on the yi_6b smoke model with two block sizes and a
  per-layer backend and span, dense: greedy tokens and
  ``stats()["prefill"]`` equal to the reference ``Server``'s (both admit
  through the full-length prefill); a paged server refuses the policy as
  the reference does.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")

from repro.core import cache as JC  # noqa: E402
from repro.core import policy as JP  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.core import policy as TP  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402
from test_torch_shared import np_params  # noqa: E402


def _overrides(P):
    return (P.LayerOverride(layers=(1, 3), block_size=16, attn_backend="xla", span_tokens=32),
            P.LayerOverride(layers=(2,), layout="kivi", k=P.TensorPolicy(rel_scale=0.1),
                            v=P.TensorPolicy(bits=3), unroll_max=1),
            P.LayerOverride(layers=(3,), layout="huffman", block_size=32))


def test_override_resolution_matches_reference():
    kw = dict(name="t", family="dense", n_layers=4, d_model=32, vocab_size=64, n_heads=2,
              n_kv_heads=2, attn_backend="fused", cache_span_tokens=256, cache_unroll_max=4)
    from repro.models.config import ModelConfig as JMC
    from repro_torch.models.config import ModelConfig as TMC

    jcfg = JMC(**kw, cache_overrides=_overrides(JP))
    tcfg = TMC(**kw, cache_overrides=_overrides(TP))
    jpol, tpol = jcfg.compression_policy(), tcfg.compression_policy()
    for layer in range(4):
        j = jpol.spec_for_layer(layer, max_seq=128, window=64)
        t = tpol.spec_for_layer(layer, max_seq=128, window=64)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), layer
        assert (t.n_blocks, t.bits_k, t.bits_v) == (j.n_blocks, j.bits_k, j.bits_v)
    s1, s3 = tpol.spec_for_layer(1, max_seq=128), tpol.spec_for_layer(3, max_seq=128)
    assert (s1.block_size, s1.attn_backend, s1.span_tokens, s1.unroll_max) == (16, "xla", 32, 4)
    assert (s3.layout, s3.block_size, s3.span_tokens) == ("huffman", 32, 32)
    with pytest.raises(ValueError) as jerr:
        dataclasses.replace(jcfg, cache_mode="paged").compression_policy()
    with pytest.raises(ValueError) as terr:
        dataclasses.replace(tcfg, cache_mode="paged").compression_policy()
    assert str(terr.value) == str(jerr.value)


def test_blockwise_knobs_precedence(monkeypatch):
    """Spec field > REPRO_BLOCKWISE_* env var > module default."""
    monkeypatch.delenv(TC.ENV_SPAN_TOKENS, raising=False)
    monkeypatch.delenv(TC.ENV_UNROLL_MAX, raising=False)
    assert (TC.ENV_SPAN_TOKENS, TC.ENV_UNROLL_MAX) == (JC.ENV_SPAN_TOKENS, JC.ENV_UNROLL_MAX)
    spec = TC.CacheSpec(layout="packed", block_size=16, max_seq=64)
    assert TC.blockwise_knobs(spec) == (TC.BLOCKWISE_SPAN_TOKENS, TC.BLOCKWISE_UNROLL_MAX) == (
        JC.BLOCKWISE_SPAN_TOKENS, JC.BLOCKWISE_UNROLL_MAX)
    monkeypatch.setenv(TC.ENV_SPAN_TOKENS, "128")
    monkeypatch.setenv(TC.ENV_UNROLL_MAX, "3")
    assert TC.blockwise_knobs(spec) == (128, 3)
    pinned = TC.CacheSpec(layout="packed", block_size=16, max_seq=64, span_tokens=32,
                          unroll_max=7)
    assert TC.blockwise_knobs(pinned) == (32, 7)  # the explicit spec wins
    with pytest.raises(ValueError, match="span_tokens"):
        TC.CacheSpec(layout="packed", span_tokens=0)
    with pytest.raises(ValueError, match="unroll_max"):
        TC.CacheSpec(layout="packed", unroll_max=0)
    monkeypatch.setenv(TC.ENV_UNROLL_MAX, "0")
    with pytest.raises(ValueError, match=TC.ENV_UNROLL_MAX):
        TC.blockwise_knobs(spec)
    monkeypatch.setenv(TC.ENV_UNROLL_MAX, "3")
    monkeypatch.setenv(TC.ENV_SPAN_TOKENS, "1k")
    with pytest.raises(ValueError, match="not an integer"):
        TC.blockwise_knobs(spec)


@pytest.mark.parametrize("layout", ["packed", "huffman"])
def test_store_scan_invariant_to_span(layout, monkeypatch):
    """The span only re-tiles the scan: the same attention at every span,
    from the spec field and from the environment, equal to the reference's
    blockwise attention within 1e-5."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 2, 100, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 100, 16)).astype(np.float32)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    base = dict(layout=layout, block_size=16, max_seq=128)
    want = np.asarray(jax.jit(lambda k, v, q: JC.attend_blockwise(
        JC.prefill(JC.CacheSpec(**base), k, v), q))(k, v, q))
    tk, tv, tq = (torch.as_tensor(x) for x in (k, v, q))
    outs = []
    for span in (16, 48, 1024):
        spec = TC.CacheSpec(**base, span_tokens=span, unroll_max=1)
        outs.append(TC.attend_blockwise(TC.prefill(spec, tk, tv), tq))
    monkeypatch.setenv(TC.ENV_SPAN_TOKENS, "32")
    outs.append(TC.attend_blockwise(TC.prefill(TC.CacheSpec(**base), tk, tv), tq))
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
        np.testing.assert_allclose(out.numpy(), outs[0].numpy(), atol=1e-5)


def _mixed(P, cfg, **kw):
    """Layer 0 at the config's block (8), layer 1 at 16 through the plain
    blockwise scan with a 32-token span."""
    ov = P.LayerOverride(layers=(1,), block_size=16, attn_backend="xla", span_tokens=32)
    return dataclasses.replace(cfg, cache_overrides=(ov,), **kw)


def test_mixed_block_server_matches_reference():
    jcfg = _mixed(JP, JR.get_smoke_config("yi_6b"))
    tcfg = _mixed(TP, TR.get_smoke_config("yi_6b"))
    jp = np_params(jcfg, 4)
    tp = params_from_jax(jp, tcfg, "cpu")
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(0, tcfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((21, 6), (40, 5), (33, 9))]
    scfg = dict(max_slots=2, max_seq=128)
    jsrv = JS.Server(jcfg, jp, JS.ServerConfig(**scfg))
    tsrv = TS.Server(tcfg, tp, TS.ServerConfig(**scfg), device="cpu")
    assert not tsrv.prefill_unified and not tsrv.prefill_chunked
    assert [s.block_size for s in (c.spec for c in tsrv.state["kv"])] == [8, 16]
    out = {}
    for name, srv, Req in (("ref", jsrv, JS.Request), ("port", tsrv, TS.Request)):
        hs = [srv.submit(Req(prompt=p, max_new_tokens=m)) for p, m in reqs]
        out[name] = ([h.result().tokens.tolist() for h in hs], srv.stats()["prefill"])
    assert out["port"] == out["ref"]
    assert [len(t) for t in out["port"][0]] == [m for _, m in reqs]
    assert out["port"][1]["stalled_decode_steps"] > 0  # full-length admissions

    for Srv, Cfg, cfg, p, kw in ((JS.Server, JS.ServerConfig, jcfg, jp, {}),
                                 (TS.Server, TS.ServerConfig, tcfg, tp, {"device": "cpu"})):
        with pytest.raises(ValueError, match="uniform block_size"):
            Srv(dataclasses.replace(cfg, cache_mode="paged"), p, Cfg(**scfg), **kw)
