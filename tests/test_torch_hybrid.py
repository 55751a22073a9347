"""The full-length prefill and the ssm and hybrid families against the
reference on the CPU, through ``params_from_jax`` (identical weights):

* ``model.prefill`` against ``jax.jit(M.prefill)``: logits, every attention
  layer's compressed cache (integer words, lengths bit-exact; bf16 scales,
  buffers and raw blocks within one bf16 step) and every Mamba2 state, for
  the dense, MoE and hybrid smoke configs (the ssm one is in
  tests/test_torch_ssm.py);
* the ``Server``: greedy tokens, ``stats()["prefill"]`` and the lifecycle
  counters equal the reference Server's for zamba2 smoke dense, paged, and
  paged in a pool that preempts (replay through the full-length prefill),
  and for mamba2 smoke dense; each reference run happens once a process,
  and the reference's dense run also holds the paged run with an ample
  pool, which never preempts;
* ``serve.engine.LockstepEngine``'s tokens equal the reference's (a
  batched, left-padded full-length prefill, then lockstep decode);
* ``params_from_jax`` shapes and ``param_count`` for the three configs the
  slice adds, and the reference's refusals (paged mode without KV caches,
  the prefix cache on a hybrid, the encoder-only hubert_xlarge).

Tolerances: logits within 1e-3 absolute (tests/test_torch_model.py); the
bf16 cache values within one bf16 step of their magnitude (the K/V come
from float32 projections summed in other orders, so a value can round to
the neighbouring bf16); Mamba2 states within 1e-4 absolute.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import pool as JPool  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch.core import cache as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402
import test_torch_shared as cached  # noqa: E402

LOGIT_ATOL = 1e-3
STATE_ATOL = 1e-4
BF16_STEP = 2.0 ** -7  # one bf16 step, relative


def _pair(arch, **kw):
    jcfg = dataclasses.replace(JR.get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(TR.get_smoke_config(arch), **kw)
    return (jcfg, tcfg, *cached.params(jcfg))


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype in (np.int32, np.uint32) else x


def _same_cache(jc, tc, what):
    """One layer's cache: integer state exact, bf16 state within a step."""
    for f in TC.LayerKVCache.FIELDS:
        a, b = getattr(jc, f), getattr(tc, f)
        if b.dtype == torch.bfloat16:
            np.testing.assert_allclose(b.float().numpy(), np.asarray(a).astype(np.float32),
                                       rtol=BF16_STEP, atol=1e-6, err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(_bits(b.numpy()), _bits(a), err_msg=f"{what} {f}")


def _same_ssm(jtree, tstates, what):
    """Per-block Mamba2 states against the reference's stacked leaves
    (block indices leading, then [B, ...])."""
    flat = _leaves(tstates)  # conv, ssm of block 0, then of block 1, ...
    for k, off, nd in (("conv", 0, 3), ("ssm", 1, 4)):
        want = np.asarray(jtree[k])
        want = want.reshape(-1, *want.shape[-nd:])
        got = np.stack([flat[i].numpy() for i in range(off, len(flat), 2)])
        np.testing.assert_allclose(got, want, atol=STATE_ATOL, rtol=0, err_msg=f"{what} {k}")


@pytest.mark.parametrize("arch,layout,S", [
    ("yi_6b", "packed", 61), ("yi_6b", "kivi", 40), ("qwen3_moe_30b_a3b", "packed", 37),
    ("zamba2_7b", "packed", 53), ("zamba2_7b", "huffman", 29), ("zamba2_7b", "raw", 41),
])
def test_prefill_logits_and_state_match_reference(arch, layout, S):
    jcfg, tcfg, jp, tp = _pair(arch, cache_layout=layout)
    toks = np.random.default_rng(S).integers(0, tcfg.vocab_size, (2, S)).astype(np.int32)
    lj, sj = jax.jit(lambda p, t: JM.prefill(p, jcfg, {"tokens": t}, 128))(
        jp, jnp.asarray(toks))
    lt, st = TM.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks)}, 128)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL, rtol=0)
    assert set(st) == set(sj)
    assert len(st["kv"]) == TM.n_cache_layers(tcfg)
    for i, tc in enumerate(st["kv"]):
        _same_cache(jax.tree.map(lambda x: x[i], sj["kv"]), tc, f"cache {i}")
        assert int(tc.n_flushed[0]) == S // tcfg.cache_block
    if tcfg.family == "hybrid":
        _same_ssm(sj["ssm"], st["ssm"], "periods")
        _same_ssm(sj["ssm_tail"], st["ssm_tail"], "tail")


def _page_bytes(cfg, max_seq):
    return sum(JPool.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim)
               for s in JM.cache_specs(cfg, max_seq))


# (arch, prompt lengths, new tokens, server options, the reference run it is
# held against); the tight pool of 10 pages preempts once on these requests
# (the reference's count is asserted).  The ample pool never preempts, so its
# tokens and prefill/lifecycle counters are the reference's dense run's, and
# that run serves both cases.
SERVES = {
    "zamba2-dense": ("zamba2_7b", (37, 21, 53, 16), (10, 14, 6, 9), {}, "zamba2-dense"),
    "zamba2-paged": ("zamba2_7b", (37, 21, 53, 16), (10, 14, 6, 9),
                     {"cache_mode": "paged"}, "zamba2-dense"),
    "zamba2-paged-preempts": ("zamba2_7b", (37, 21, 53, 16), (10, 14, 6, 9),
                              {"cache_mode": "paged", "pool_pages": 10},
                              "zamba2-paged-preempts"),
    "mamba2-dense": ("mamba2_1_3b", (37, 21, 53), (10, 14, 6), {}, "mamba2-dense"),
}


def _prompts(case):
    arch, lens, news, opts, _ = SERVES[case]
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, TR.get_smoke_config(arch).vocab_size, n).astype(np.int32)
               for n in lens]
    opts = dict(opts)
    if "pool_pages" in opts:
        opts["pool_hbm_bytes"] = opts.pop("pool_pages") * _page_bytes(
            JR.get_smoke_config(arch), 128)
    return arch, prompts, news, opts


@functools.lru_cache(maxsize=None)
def _reference_serve(case):
    """The reference Server's tokens, stats and preemptions on ``case``'s
    requests, once a process."""
    arch, prompts, news, opts = _prompts(case)
    jcfg, _, jp, _ = _pair(arch)
    jsrv = JS.Server(jcfg, jp, JS.ServerConfig(max_slots=2, max_seq=128, **opts))
    rj = [h.result() for h in [jsrv.submit(JS.Request(prompt=p, max_new_tokens=n))
                               for p, n in zip(prompts, news)]]
    return [r.tokens.tolist() for r in rj], jsrv.stats(), jsrv.preemptions


@pytest.mark.parametrize("case", list(SERVES))
def test_server_matches_reference_server(case):
    arch, prompts, news, opts = _prompts(case)
    _, tcfg, _, tp = _pair(arch)
    tokens, sj, preemptions = _reference_serve(SERVES[case][4])
    tsrv = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=128, **opts), device="cpu")
    rt = [h.result() for h in [tsrv.submit(TS.Request(prompt=p, max_new_tokens=n))
                               for p, n in zip(prompts, news)]]
    assert [r.tokens.tolist() for r in rt] == tokens
    assert [len(r.tokens) for r in rt] == list(news)
    st = tsrv.stats()
    assert st["prefill"] == sj["prefill"]
    assert st["prefill"]["mode"] == "solo" and st["prefill"]["stalled_decode_steps"] > 0
    assert st["lifecycle"] == sj["lifecycle"]
    assert tsrv.preemptions == preemptions
    if case.endswith("preempts"):
        assert tsrv.preemptions > 0
    if "pool" in st:
        pool = {k: st["pool"][k] for k in ("alloc_pages", "freed_pages", "high_water_pages")}
        assert pool["alloc_pages"] == pool["freed_pages"] > 0  # every page back after the drain
        if "pool" in sj:
            assert pool == {k: sj["pool"][k] for k in pool}
    mem = tsrv.memory_report()
    assert mem["total_bytes"] > mem["kv_bytes"] >= 0


@pytest.mark.parametrize("arch", ["zamba2_7b", "yi_6b"])
def test_lockstep_engine_matches_reference(arch):
    """Two length buckets, one of three rows left-padded into it: a batched
    full-length prefill (every whole block of three rows in one Store call)
    and lockstep decode."""
    jcfg, tcfg, jp, tp = _pair(arch)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, tcfg.vocab_size, n).astype(np.int32), k)
            for n, k in ((37, 6), (21, 9), (45, 5), (40, 7))]
    ecfg = dict(bucket=16, max_batch=4, max_seq=128)
    rj = JE.LockstepEngine(jcfg, jp, JE.EngineConfig(**ecfg)).generate(
        [JE.Request(prompt=p, max_new_tokens=k) for p, k in reqs])
    rt = TE.LockstepEngine(tcfg, tp, TE.EngineConfig(**ecfg), device="cpu").generate(
        [TE.Request(prompt=p, max_new_tokens=k) for p, k in reqs])
    assert [r.tokens.tolist() for r in rt] == [r.tokens.tolist() for r in rj]
    assert [r.prompt_len for r in rt] == [len(p) for p, _ in reqs]


def test_engine_wraps_the_server():
    _, tcfg, _, tp = _pair("mamba2_1_3b")
    eng = TE.Engine(tcfg, tp, TE.EngineConfig(max_batch=2, max_seq=64), device="cpu")
    prompts = [np.arange(5, 5 + n, dtype=np.int32) for n in (9, 14, 6)]
    res = eng.generate([TE.Request(prompt=p, max_new_tokens=4) for p in prompts])
    assert [len(r.tokens) for r in res] == [4, 4, 4]
    assert eng.server.stats()["lifecycle"]["submitted"] == 3


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_7b", "hubert_xlarge"])
def test_params_from_jax_shapes_and_count(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    fresh = TM.init_params(tcfg, seed=0, device="cpu")
    assert [x.shape for x in _leaves(tp)] == [x.shape for x in _leaves(fresh)]
    assert sum(x.numel() for x in _leaves(tp)) == sum(x.size for x in jax.tree.leaves(jp))
    full_t, full_j = TR.get_config(arch), JR.get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert full_t.param_count() == full_j.param_count()
    if tcfg.family == "hybrid":
        n_periods, ppm, tail = TM._hybrid_counts(full_t)
        assert (n_periods, ppm, tail, TM.n_cache_layers(full_t)) == (13, 5, 3, 13)
        assert (len(tp["mamba"]), len(tp["mamba"][0]), len(tp["mamba_tail"])) == (2, 2, 1)


def test_reference_refusals():
    """Paged mode needs KV caches; the prefix cache needs a pure-KV state;
    hubert_xlarge (encoder-only, embeddings in) fails the reference Server's
    first decode step with an IndexError, and the port's Server refuses it
    up front with the same type."""
    jcfg, tcfg, jp, tp = _pair("mamba2_1_3b")
    for Srv, Cfg, cfg, p, kw in ((JS.Server, JS.ServerConfig, jcfg, jp, {}),
                                 (TS.Server, TS.ServerConfig, tcfg, tp, {"device": "cpu"})):
        with pytest.raises(ValueError, match="paged cache mode needs attention KV caches"):
            Srv(cfg, p, Cfg(max_slots=2, max_seq=64, cache_mode="paged"), **kw)
    zc = TR.get_smoke_config("zamba2_7b")
    zp = TM.init_params(zc, seed=0, device="cpu")
    with pytest.raises(ValueError, match="pure-KV"):
        TS.Server(zc, zp, TS.ServerConfig(max_slots=2, max_seq=64, cache_mode="paged",
                                          prefix_cache="on"), device="cpu")
    jcfg, tcfg, jp, tp = _pair("hubert_xlarge")
    prompt = np.arange(3, 12, dtype=np.int32)
    with pytest.raises(IndexError):
        JS.Server(jcfg, jp, JS.ServerConfig(max_slots=2, max_seq=64)).submit(
            JS.Request(prompt=prompt, max_new_tokens=3)).result()
    with pytest.raises(IndexError, match="encoder-only"):
        TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=64), device="cpu")
