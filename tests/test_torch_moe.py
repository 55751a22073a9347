"""The port's MoE family against the reference on the CPU, through
``params_from_jax`` (identical weights):

* ``moe.moe_apply`` on the same inputs: the routing (each token's top-k
  experts) and the capacity keep mask exactly, ``y`` and the load-balance loss within float32
  noise, with at least one dropped (token, k) pair in every case;
* ``prefill_chunk`` / ``decode_step`` logits, teacher-forced, for the
  qwen3_moe and mixtral smoke configs (mixtral past its 64-token window);
* the ``Server``'s greedy tokens, exactly, with the idle rows' inputs (last
  token, position, per-row cache lengths) equal to the reference Server's at
  every step: MoE couples the rows of a batch through the expert capacity,
  so a retired row's inputs reach the live rows' tokens;
* the idle-row repair on the dense smoke config: after a retire and a
  cancel, in dense and in paged mode, the same idle-row inputs as the
  reference Server at every step.

Tolerances: the routing and keep masks exactly; ``y`` within 1e-5 of the
largest |y| (both sides sum float32 products in other orders, and the terms
reach that size); ``aux`` within 1e-6; logits within 1e-3 absolute, as in
tests/test_torch_model.py.

The comparison of two float32 implementations through discrete decisions
(top-k routing, capacity drops, quantization codes) is exact only while no
decision sits within the float noise.  On the qwen3_moe smoke model a
single bf16 rounding difference of a stored K/V value (a last-bit
difference of a projection) has been seen to move a packed block's scale
and then a router's top-k choice; ``moe_apply`` itself agrees on identical
inputs (the first test).  The workloads below are fixed; a divergence on
them is a failure.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMo  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMo  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402
import test_torch_shared as cached  # noqa: E402

ATOL = 1e-3
MARGIN = 1e-5


def _pair(arch, **kw):
    jcfg = dataclasses.replace(JR.get_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(TR.get_smoke_config(arch), **kw)
    return (jcfg, tcfg, *cached.params(jcfg))


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _ref_route(p, cfg, xf):
    """The reference's routing and keep mask (src/repro/models/moe.py:
    51-72), in pair order (token-major, k minor)."""
    E, K = cfg.n_experts, cfg.top_k
    N = xf.shape[0]
    probs = jax.nn.softmax(xf @ p["router"], axis=-1)
    top_p, top_e = jax.lax.top_k(probs, K)
    C = int(max(1, -(-N * K // E) * cfg.capacity_factor))
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    idx = jnp.arange(N * K)
    is_start = jnp.concatenate([jnp.ones(1, bool), se[1:] != se[:-1]])
    rank = idx - jax.lax.cummax(jnp.where(is_start, idx, 0))
    keep = jnp.zeros(N * K, bool).at[order].set(rank < C)
    return np.asarray(probs), np.asarray(top_e), np.asarray(keep), C


MOE_CASES = {
    # the smoke config's routing (E 4, K 2) at N = 16
    "smoke-N16": (dict(), (2, 8)),
    # Qwen3-30B-A3B's routing shape at a decode step of 8 rows: C = 1
    "qwen3-routing-decode-N8": (dict(n_experts=128, top_k=8, d_model=16, d_ff_expert=8), (8, 1)),
    # a 64-token chunk
    "chunk-N64": (dict(), (1, 64)),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    over, shape = MOE_CASES[case]
    jcfg = dataclasses.replace(JR.get_smoke_config("qwen3_moe_30b_a3b"), **over)
    tcfg = dataclasses.replace(TR.get_smoke_config("qwen3_moe_30b_a3b"), **over)
    jp, _ = JMo.init_moe(jax.random.PRNGKey(3), jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(5)
    d = tcfg.d_model
    # Tokens share a component, as a context's tokens do, so the router
    # favours some experts and their capacity overflows.
    x = (rng.standard_normal(d) + 0.5 * rng.standard_normal((*shape, d))).astype(np.float32)
    xf = x.reshape(-1, d)

    K = tcfg.top_k
    probs, top_e, keep, C = _ref_route(jp, jcfg, jnp.asarray(xf))
    srt = -np.sort(-probs, axis=-1)
    margin = float((srt[:, K - 1] - srt[:, K]).min())
    assert margin > MARGIN, f"top-k margin {margin}: a flip would not show"
    assert not keep.all(), "no pair dropped: the capacity is not exercised"

    _, t_e, dest_e, dest_c, t_keep, t_C, _ = TMo.route(tp, tcfg, torch.as_tensor(xf))
    assert t_C == C == TMo.capacity(tcfg, xf.shape[0])

    def routed(e, kept):
        """[N, E]: 1 routed and kept, -1 routed and dropped, 0 not routed
        (the order of a token's k choices only orders its sum)."""
        m = np.zeros((xf.shape[0], tcfg.n_experts), np.int8)
        rows = np.repeat(np.arange(xf.shape[0]), K)
        m[rows, np.asarray(e).reshape(-1)] = np.where(np.asarray(kept), 1, -1)
        return m

    np.testing.assert_array_equal(routed(t_e.numpy(), t_keep.numpy()), routed(top_e, keep))
    # Kept pairs fill distinct slots; dropped ones all go to the sentinel.
    kept = np.stack([dest_e.numpy(), dest_c.numpy()], 1)[keep]
    assert len({tuple(r) for r in kept}) == len(kept) and (kept[:, 1] < C).all()
    assert (dest_e.numpy()[~keep] == tcfg.n_experts).all()

    yj, aj = JMo.moe_apply(jp, jcfg, jnp.asarray(x))
    yt, at = TMo.moe_apply(tp, tcfg, torch.as_tensor(x))
    yj = np.asarray(yj)
    assert yt.shape == yj.shape
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-5 * np.abs(yj).max())
    assert abs(float(at) - float(aj)) <= 1e-6


# ---------------------------------------------------------------------------
# prefill_chunk / decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,layout,n_prompt,n_total", [
    ("qwen3_moe_30b_a3b", "raw", 28, 44), ("qwen3_moe_30b_a3b", "packed", 28, 44),
    ("mixtral_8x22b", "raw", 72, 92), ("mixtral_8x22b", "packed", 72, 92),
])
def test_prefill_chunk_and_decode_step_match_reference(arch, layout, n_prompt, n_total):
    """Teacher-forced logits along one sequence: the prompt by block
    chunks, then decode across flush boundaries (mixtral: past its
    64-token window, so its ring wraps)."""
    jcfg, tcfg, jp, tp = _pair(arch, cache_layout=layout)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, n_total).astype(np.int32)
    js = JM.init_decode_state(jcfg, 1, 128)
    ts = TM.init_decode_state(tcfg, 1, 128, device="cpu")
    jchunk = jax.jit(lambda p, t, pos, s: JM.prefill_chunk(p, jcfg, t, pos, s))
    jdecode = jax.jit(lambda p, t, pos, s: JM.decode_step(p, jcfg, t, pos, s))
    T = tcfg.cache_block
    for pos in range(0, n_prompt, T):
        C = min(T, n_prompt - pos)
        lj, js = jchunk(jp, jnp.asarray(toks[None, pos:pos + C]), jnp.int32(pos), js)
        lt, _ = TM.prefill_chunk(tp, tcfg, torch.as_tensor(toks[None, pos:pos + C]), pos, ts)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    for pos in range(n_prompt, n_total):
        lj, js = jdecode(jp, jnp.asarray(toks[pos:pos + 1]), jnp.int32(pos), js)
        lt, _ = TM.decode_step(tp, tcfg, torch.as_tensor(toks[pos:pos + 1]), pos, ts)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL, rtol=0)
    nb = ts["kv"][0].spec.n_blocks
    assert [int(c.n_flushed[0]) for c in ts["kv"]] == [(n_total - 1) // T] * tcfg.n_layers
    if tcfg.sliding_window:
        assert (n_total - 1) // T > nb  # the ring wrapped


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mixtral_8x22b"])
def test_params_from_jax_moe_shapes_and_count(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    fresh = TM.init_params(tcfg, seed=0, device="cpu")

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, list):
            return [x for v in t for x in leaves(v)]
        return [t]

    assert [x.shape for x in leaves(tp)] == [x.shape for x in leaves(fresh)]
    blk = tp["blocks"][0]
    E, d, F = tcfg.n_experts, tcfg.d_model, tcfg.d_ff_expert
    assert (blk["moe"]["router"].shape, blk["moe"]["w_gate"].shape,
            blk["moe"]["w_down"].shape) == ((d, E), (E, d, F), (E, F, d))
    qk = 2 * tcfg.resolved_head_dim * tcfg.n_layers if tcfg.qk_norm else 0  # not in the count
    assert sum(x.numel() for x in leaves(tp)) == tcfg.param_count() + qk
    assert sum(x.numel() for x in leaves(tp)) == sum(x.size for x in jax.tree.leaves(jp))
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


# ---------------------------------------------------------------------------
# Server: tokens and idle-row inputs in lockstep with the reference
# ---------------------------------------------------------------------------


def _lengths(srv):
    """[L, B] n_flushed and buf_len of either package's live state."""
    kv = srv.state["kv"]
    if isinstance(kv, list):  # the port: one cache a layer
        return tuple(np.stack([getattr(c, f).numpy() for c in kv])
                     for f in ("n_flushed", "buf_len"))
    B = srv.scfg.max_slots
    return tuple(np.asarray(getattr(kv, f)).reshape(-1, B) for f in ("n_flushed", "buf_len"))


def _lockstep(jcfg, tcfg, jp, tp, prompts, news, cancel=None, **scfg):
    """Run both servers a step at a time on the same requests; after every
    step their idle and live rows' inputs (last token, position, per-row
    cache lengths) must be equal.  ``cancel=(i, step)`` cancels request i
    before that step on both.  Returns both servers' results."""
    kw = dict(max_slots=3, max_seq=256, prefill_chunk_tokens=32, **scfg)
    jsrv = JS.Server(jcfg, jp, JS.ServerConfig(**kw), q_chunk=32, kv_chunk=32)
    tsrv = TS.Server(tcfg, tp, TS.ServerConfig(**kw), device="cpu")
    hj = [jsrv.submit(JS.Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, news)]
    ht = [tsrv.submit(TS.Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, news)]
    step, idle_steps = 0, 0
    while True:
        if cancel is not None and step == cancel[1]:
            assert hj[cancel[0]].cancel() and ht[cancel[0]].cancel()
        more_j, more_t = jsrv.step(), tsrv.step()
        step += 1
        assert more_j == more_t, step
        np.testing.assert_array_equal(tsrv._cur, jsrv._cur, err_msg=f"_cur, step {step}")
        np.testing.assert_array_equal(tsrv._pos, jsrv._pos, err_msg=f"_pos, step {step}")
        for name, a, b in zip(("n_flushed", "buf_len"), _lengths(tsrv), _lengths(jsrv)):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}, step {step}")
        busy = sum(h is not None for h in tsrv._slots) + len(tsrv._prefill_tasks)
        idle_steps += int(0 < tsrv.active and busy < kw["max_slots"])
        if not more_t:
            break
    assert idle_steps > 0  # some step decoded with a vacated row beside a live one
    return [h.result() for h in hj], [h.result() for h in ht]


def _prompts(seed, lens, vocab, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, L).astype(np.int32)]) for L in lens]


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_idle_rows_follow_reference(mode):
    """The dense smoke config: after a request retires and after a cancel,
    the vacated row's last token, position and cache lengths stay what the
    reference leaves them (it clears only a paged row's page table)."""
    jcfg, tcfg, jp, tp = _pair("yi_6b")
    prompts = _prompts(2, (13, 24, 9, 30, 17), tcfg.vocab_size)
    rj, rt = _lockstep(jcfg, tcfg, jp, tp, prompts, (3, 8, 5, 6, 4), cancel=(1, 6),
                       cache_mode=mode)
    assert [r.finish_reason for r in rt] == [r.finish_reason for r in rj]
    assert rt[1].finish_reason == "cancelled"
    assert [r.tokens.tolist() for r in rt] == [r.tokens.tolist() for r in rj]


MOE_SERVES = {
    # requests retiring at different steps, slots reused
    "qwen3_moe-dense": ("qwen3_moe_30b_a3b", (21, 45, 70, 33, 58), (9, 4, 12, 6, 8), 0,
                        dict(cache_mode="dense")),
    # prompts behind a shared 32-token prefix, served from shared pages
    "qwen3_moe-paged-prefix-on": ("qwen3_moe_30b_a3b", (7, 19, 30, 12), (6, 9, 4, 7), 32,
                                  dict(cache_mode="paged", prefix_cache="on")),
    # prompts past the 64-token window: the ring wraps in prefill and decode
    "mixtral-dense-past-window": ("mixtral_8x22b", (90, 30, 75), (20, 8, 12), 0,
                                  dict(cache_mode="dense")),
}


@pytest.mark.parametrize("case", list(MOE_SERVES))
def test_moe_server_matches_reference_server(case):
    arch, lens, news, shared, scfg = MOE_SERVES[case]
    jcfg, tcfg, jp, tp = _pair(arch)
    prompts = _prompts(11, lens, tcfg.vocab_size, shared)
    rj, rt = _lockstep(jcfg, tcfg, jp, tp, prompts, news, **scfg)
    assert [r.tokens.tolist() for r in rt] == [r.tokens.tolist() for r in rj]
    assert all(len(r.tokens) == n for r, n in zip(rt, news))
