"""The port's Mamba2 mixer and full-length attention against the
reference's on the CPU, on inputs from a numpy seed:

* ``ssm.ssd_scan`` against the reference's ``ssd_scan`` and its sequential
  oracle ``ssd_reference``, at prime and composite S, with and without an
  initial state: the port pads S up to whole chunks where the reference
  snaps the chunk to a divisor of S, so both compute the same recurrence
  in other orders;
* a Mamba2 block's prefill (output and decode state) and a decode chain
  after it, through ``params_from_jax``-identical weights;
* ``attention.flash_attention`` against the reference's (causal, sliding
  window, GQA, bidirectional), at prime S, where the reference's chunks
  snap to one token;
* the full-length ``model.prefill`` of the mamba2 smoke config: logits and
  every layer's conv window and SSM state.

Tolerances: ``ssd_scan`` outputs within 2e-5 of the largest |y| and states
within 2e-5 of the largest |h| (float32 sums of up to S products in other
orders, the state's decay taken in log space as a cumulative sum of chunk
decays); attention within 1e-5 absolute (softmax weights below 1, values of
order 1); block and model outputs within 1e-4 absolute, logits within 1e-3
as in tests/test_torch_model.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import ssm as JSm  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import ssm as TSm  # noqa: E402
import test_torch_shared as cached  # noqa: E402

SCAN_RTOL = 2e-5
ATTN_ATOL = 1e-5
BLOCK_ATOL = 1e-4
LOGIT_ATOL = 1e-3


def _scan_inputs(seed, b, S, H, P, G, N, h0, dt_range=None):
    """dt = softplus(N(0, 1)) (about 0.7: a chunk of 16 decays by e^-11 or
    more), or log-uniform in ``dt_range``; A as ``init_mamba_block``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)  # softplus
    if dt_range is not None:
        dt = np.exp(rng.uniform(*np.log(dt_range), (b, S, H))).astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32)
    a = (dt * A).astype(np.float32)
    Bm = rng.standard_normal((b, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((b, S, G, N)).astype(np.float32)
    h = rng.standard_normal((b, H, N, P)).astype(np.float32) if h0 else None
    return x, a, dt, Bm, Cm, h


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1.0), (err, np.abs(want).max())


@pytest.mark.parametrize("S,chunk,h0", [
    (97, 16, False),   # prime: the reference runs 97 chunks of one token
    (97, 16, True),
    (96, 16, False),   # composite, whole chunks on both sides
    (96, 16, True),
    (60, 16, True),    # the reference snaps to 15, the port pads to 64
    (5, 16, False),    # shorter than one chunk
])
def test_ssd_scan_matches_reference(S, chunk, h0):
    x, a, dt, Bm, Cm, h = _scan_inputs(S + 2 * h0, 2, S, 4, 8, 2, 16, h0)
    jx = [jnp.asarray(t) for t in (x, a, dt, Bm, Cm)]
    jh = None if h is None else jnp.asarray(h)
    yj, hj = jax.jit(JSm.ssd_scan, static_argnums=5)(*jx, chunk, jh)
    yr, hr = JSm.ssd_reference(*jx, h0=jh)
    yt, ht = TSm.ssd_scan(*(torch.as_tensor(t) for t in (x, a, dt, Bm, Cm)), chunk,
                          h0=None if h is None else torch.as_tensor(h))
    for want_y, want_h in ((yj, hj), (yr, hr)):
        _close(yt.numpy(), want_y, SCAN_RTOL)
        _close(ht.numpy(), want_h, SCAN_RTOL)
    # the port's own oracle equals the reference's
    yo, ho = TSm.ssd_reference(*(torch.as_tensor(t) for t in (x, a, dt, Bm, Cm)),
                               h0=None if h is None else torch.as_tensor(h))
    _close(yo.numpy(), yr, SCAN_RTOL)
    _close(ho.numpy(), hr, SCAN_RTOL)


@pytest.mark.parametrize("S,h0,impulse", [
    (4096, False, True),   # x only in the first chunk: every later output is carried state
    (4096, True, False),
    (1000, True, True),    # the reference snaps the chunk to 250, the port pads to 1024
    (1009, False, False),  # prime: the reference runs 1009 chunks of one token
])
def test_ssd_scan_slow_decay_long_range_matches_reference(S, h0, impulse):
    """A trained Mamba2's regime: dt of 0.001 to 0.01 and chunks of 256, so a
    chunk decays by e^-0.3 to e^-40 and the state carried across many
    chunks dominates the outputs.  Checked over the whole output and, apart,
    over everything after the first chunk at that part's own scale (with
    ``impulse``, only the carried state makes it), and the final state at
    its own scale."""
    chunk = 256
    x, a, dt, Bm, Cm, h = _scan_inputs(S + h0, 1, S, 4, 8, 1, 16, h0, dt_range=(1e-3, 1e-2))
    if impulse:
        x[:, chunk:] = 0
    jx = [jnp.asarray(t) for t in (x, a, dt, Bm, Cm)]
    jh = None if h is None else jnp.asarray(h)
    yj, hj = jax.jit(JSm.ssd_scan, static_argnums=5)(*jx, chunk, jh)
    yr, hr = jax.jit(JSm.ssd_reference)(*jx, h0=jh)
    yt, ht = TSm.ssd_scan(*(torch.as_tensor(t) for t in (x, a, dt, Bm, Cm)), chunk,
                          h0=None if h is None else torch.as_tensor(h))
    yt, ht = yt.numpy(), ht.numpy()
    for want_y, want_h in ((yj, hj), (yr, hr)):
        want_y, want_h = np.asarray(want_y), np.asarray(want_h)
        _close(yt, want_y, SCAN_RTOL)
        tail = want_y[:, chunk:]
        assert np.abs(tail).max() > 1e-3 * np.abs(want_y).max()  # the carried state shows
        err = np.abs(yt[:, chunk:] - tail).max()
        assert err <= SCAN_RTOL * np.abs(tail).max(), (err, np.abs(tail).max())
        err = np.abs(ht - want_h).max()
        assert err <= SCAN_RTOL * np.abs(want_h).max(), (err, np.abs(want_h).max())


def _mamba_pair():
    jcfg = JR.get_smoke_config("mamba2_1_3b")
    tcfg = TR.get_smoke_config("mamba2_1_3b")
    return (jcfg, tcfg, *cached.params(jcfg))


@pytest.mark.parametrize("S", [2, 37, 64])
def test_mamba_block_prefill_and_decode_chain_match_reference(S):
    """One block: the prompt's output and decode state, then 6 decode steps
    from that state (S = 2 is shorter than the conv window)."""
    jcfg, tcfg, jp, tp = _mamba_pair()
    jb = jax.tree.map(lambda v: v[0], jp["blocks"])
    tb = tp["blocks"][0]
    u = np.random.default_rng(S).standard_normal((2, S + 6, tcfg.d_model)).astype(np.float32)
    oj, sj = jax.jit(lambda p, x: JSm.mamba_block_prefill(p, jcfg, x))(jb, jnp.asarray(u[:, :S]))
    ot, st = TSm.mamba_block_prefill(tb, tcfg, torch.as_tensor(u[:, :S]))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=BLOCK_ATOL, rtol=0)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), atol=BLOCK_ATOL, rtol=0)
    dec = jax.jit(lambda p, x, s: JSm.mamba_block_decode(p, jcfg, x, s))
    for i in range(S, S + 6):
        oj, sj = dec(jb, jnp.asarray(u[:, i:i + 1]), sj)
        ot, _ = TSm.mamba_block_decode(tb, tcfg, torch.as_tensor(u[:, i:i + 1]), st)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=BLOCK_ATOL, rtol=0)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), atol=BLOCK_ATOL, rtol=0)


@pytest.mark.parametrize("S,H,Hkv,causal,window,q_chunk", [
    (41, 4, 2, True, None, 16),    # prime S, GQA: the reference's chunks snap to 1
    (41, 4, 4, True, 12, 16),      # sliding window shorter than a query block
    (64, 8, 2, True, None, 512),   # one query block
    (53, 4, 1, False, None, 16),   # bidirectional (the encoder-only option)
    (53, 4, 2, False, 9, 16),      # bidirectional with a window
])
def test_flash_attention_matches_reference(S, H, Hkv, causal, window, q_chunk):
    rng = np.random.default_rng(S + H)
    q = rng.standard_normal((2, S, H, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, Hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, Hkv, 16)).astype(np.float32)
    fj = jax.jit(lambda q, k, v: JA.flash_attention(q, k, v, causal=causal, window=window,
                                                    q_chunk=q_chunk, kv_chunk=q_chunk))
    want = np.asarray(fj(*(jnp.asarray(t) for t in (q, k, v))))
    got = TA.flash_attention(*(torch.as_tensor(t) for t in (q, k, v)), causal=causal,
                             window=window, q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("S", [29, 61])
def test_ssm_prefill_logits_and_state_match_reference(S):
    """The mamba2 smoke model's full-length prefill: logits and every layer's
    conv window and SSM state, then the next token's decode logits."""
    jcfg, tcfg, jp, tp = _mamba_pair()
    toks = np.random.default_rng(S).integers(0, tcfg.vocab_size, (1, S + 1)).astype(np.int32)
    lj, sj = jax.jit(lambda p, t: JM.prefill(p, jcfg, {"tokens": t}, 128))(
        jp, jnp.asarray(toks[:, :S]))
    lt, st = TM.prefill(tp, tcfg, {"tokens": torch.as_tensor(toks[:, :S])}, 128)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL, rtol=0)
    assert set(st) == set(sj) == {"ssm"}
    for i, layer in enumerate(st["ssm"]):
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(layer[k].numpy(), np.asarray(sj["ssm"][k][i]),
                                       atol=BLOCK_ATOL, rtol=0)
    lj, _ = jax.jit(lambda p, t, s: JM.decode_step(p, jcfg, t, S, s))(
        jp, jnp.asarray(toks[:, S]), sj)
    lt, _ = TM.decode_step(tp, tcfg, torch.as_tensor(toks[:, S]), S, st)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGIT_ATOL, rtol=0)


def test_ssm_state_layout_and_prefill_chunk_refused():
    cfg = dataclasses.replace(TR.get_smoke_config("mamba2_1_3b"))
    st = TM.init_decode_state(cfg, 3, 64, device="cpu")
    assert TM.n_cache_layers(cfg) == 0 and set(st) == {"ssm"}
    assert len(st["ssm"]) == cfg.n_layers
    assert st["ssm"][0]["conv"].shape == (3, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state)
    assert st["ssm"][0]["ssm"].shape == (3, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim)
    params = TM.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="pure-KV"):
        TM.prefill_chunk(params, cfg, torch.zeros((1, 8), dtype=torch.int64), 0, st)
