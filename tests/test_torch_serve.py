"""The port's Server: against the reference's Server on the same requests
(greedy tokens equal, under the decided-margin rule of
tests/test_models.py::test_compressed_cache_decode_tracks_raw), and its own
exactness contracts on the CPU: batched == solo and chunked == solo
admission, bit-exact.  Also: entry points need CUDA unless told otherwise,
and options of later slices raise.  The paged mode is held in
tests/test_torch_pool.py, the prefix cache in tests/test_torch_prefix.py and
the request lifecycle in tests/test_torch_faults.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serve import scheduler as JS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve import scheduler as TS  # noqa: E402
import test_torch_shared as cached  # noqa: E402

LENS = (7, 13, 16, 24, 33)
NEWS = (3, 9, 5, 2, 7)


@pytest.fixture(scope="module")
def setup():
    jcfg = JR.get_smoke_config("yi_6b")
    tcfg = TR.get_smoke_config("yi_6b")
    jp, tp = cached.params(jcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, L).astype(np.int32) for L in LENS]
    return jcfg, tcfg, jp, tp, prompts


def _serve_port(tcfg, tp, prompts, news, **scfg):
    srv = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=256, **scfg),
                    device="cpu")
    hs = [srv.submit(TS.Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, news)]
    srv.run()
    assert srv.active == 0 and srv.pending == 0 and srv.prefilling == 0
    return [h.result().tokens.tolist() for h in hs]


def _forced_logits(jcfg, tcfg, jp, tp, seq, n_prompt):
    """Both models' logits along one token sequence (B=1): the prompt by
    block-chunked prefill, then teacher-forced decode.  Row i predicts
    seq[n_prompt + i]."""
    T = tcfg.cache_block
    js = JM.init_decode_state(jcfg, 1, 256)
    ts = TM.init_decode_state(tcfg, 1, 256, device="cpu")
    out_j, out_t = [], []
    for pos in range(0, n_prompt, T):
        t = seq[None, pos:min(pos + T, n_prompt)]
        lj, js = JM.prefill_chunk(jp, jcfg, jnp.asarray(t), jnp.int32(pos), js)
        lt, _ = TM.prefill_chunk(tp, tcfg, torch.as_tensor(t), pos, ts)
    out_j.append(np.asarray(lj)[0])
    out_t.append(lt.numpy()[0])
    for pos in range(n_prompt, len(seq) - 1):
        lj, js = JM.decode_step(jp, jcfg, jnp.asarray(seq[pos:pos + 1]), jnp.int32(pos), js)
        lt, _ = TM.decode_step(tp, tcfg, torch.as_tensor(seq[pos:pos + 1]), pos, ts)
        out_j.append(np.asarray(lj)[0])
        out_t.append(lt.numpy()[0])
    return np.stack(out_j), np.stack(out_t)


def test_server_matches_reference_server(setup):
    """5 requests through 2 slots on both servers: the port's greedy tokens
    equal the reference's.  A divergence is accepted only from a step whose
    reference top-2 margin is below 2x the measured logit noise between the
    two models on that request (teacher-forced along the reference tokens)."""
    jcfg, tcfg, jp, tp, prompts = setup
    jsrv = JS.Server(jcfg, jp, JS.ServerConfig(max_slots=2, max_seq=256),
                     q_chunk=32, kv_chunk=32)
    jh = [jsrv.submit(JS.Request(prompt=p, max_new_tokens=n)) for p, n in zip(prompts, NEWS)]
    jsrv.run()
    want = [h.result().tokens.tolist() for h in jh]
    got = _serve_port(tcfg, tp, prompts, NEWS)
    for p, w, g in zip(prompts, want, got):
        if w == g:
            continue
        i = next(i for i, (a, b) in enumerate(zip(w, g)) if a != b)
        lj, lt = _forced_logits(jcfg, tcfg, jp, tp,
                                np.concatenate([p, np.asarray(w, np.int32)]), len(p))
        noise = float(np.abs(lj - lt).max())
        top2 = np.sort(lj[i])[-2:]
        assert top2[1] - top2[0] < 2 * noise, (len(p), i, top2, noise)


def _solo_greedy(tcfg, tp, prompt, n_new):
    """Independent oracle inside the port: B=1 chunked prefill, then
    step-by-step greedy decode."""
    T = tcfg.cache_block
    st = TM.init_decode_state(tcfg, 1, 256, device="cpu")
    for pos in range(0, len(prompt), T):
        lg, _ = TM.prefill_chunk(tp, tcfg, torch.as_tensor(prompt[None, pos:pos + T]), pos, st)
    out = [int(torch.argmax(lg[0]))]
    pos = len(prompt)
    while len(out) < n_new:
        lg, _ = TM.decode_step(tp, tcfg, torch.tensor([out[-1]]), pos, st)
        out.append(int(torch.argmax(lg[0])))
        pos += 1
    return out


@pytest.mark.parametrize("layout", ["raw", "packed", "kivi", "huffman"])
def test_batched_and_chunked_equal_solo(setup, layout):
    """Mid-flight joins and leaves through 2 slots, chunked and solo
    admission: every request's tokens equal its B=1 solo run bit for bit."""
    _, tcfg, _, tp, prompts = setup
    tcfg = dataclasses.replace(tcfg, cache_layout=layout)
    chunked = _serve_port(tcfg, tp, prompts, NEWS)
    solo_admission = _serve_port(tcfg, tp, prompts, NEWS, prefill_mode="solo",
                                 policy="ljf")
    for p, n, a, b in zip(prompts, NEWS, chunked, solo_admission):
        want = _solo_greedy(tcfg, tp, p, n)
        assert a == want and b == want, (layout, len(p))


def test_eos_streaming_and_stats(setup):
    _, tcfg, _, tp, prompts = setup
    solo = _solo_greedy(tcfg, tp, prompts[1], 8)
    cut = next(i for i in range(1, len(solo)) if solo[i] not in solo[:i])
    srv = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=2, max_seq=256), device="cpu")
    h_eos = srv.submit(TS.Request(prompt=prompts[1], max_new_tokens=8, eos_id=solo[cut]))
    h_len = srv.submit(TS.Request(prompt=prompts[2], max_new_tokens=4))
    assert list(h_eos.tokens()) == solo[:cut + 1]
    r_eos, r_len = h_eos.result(), h_len.result()
    assert r_eos.finish_reason == "eos" and r_len.finish_reason == "length"
    assert len(r_len.tokens) == 4 and r_len.ttft_s > 0 and r_len.gen_s >= 0
    srv.run()
    st = srv.stats()
    assert st["lifecycle"]["submitted"] == 2 and st["prefill"]["prefill_tokens"] == 13 + 16
    assert srv.memory_report()["kv_bytes"] > 0


def test_entry_points_need_cuda_unless_told(setup, monkeypatch):
    _, tcfg, _, tp, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TM.init_params(tcfg),
                 lambda: TM.init_decode_state(tcfg, 1, 64),
                 lambda: TS.Server(tcfg, tp)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("field,value", [
    ("prefix_cache", "on"), ("mesh", object()),
    ("trace", "events"), ("faults", object()), ("audit_every", 2),
    ("max_pending", 4), ("default_deadline_s", 1.0)])
def test_later_slice_options_raise(field, value):
    """Options once refused here as those of later slices are all served
    now: the prefix cache, the lifecycle options, the event trace and the
    mesh (the Server checks a mesh against the model)."""
    assert getattr(TS.ServerConfig(**{field: value}), field) is value
    assert not hasattr(TS, "_LATER")


def test_request_deadline_raises(setup):
    """A deadline is served now; a non-positive one raises at submit."""
    _, tcfg, _, tp, prompts = setup
    srv = TS.Server(tcfg, tp, TS.ServerConfig(max_slots=1, max_seq=64), device="cpu")
    with pytest.raises(ValueError, match="deadline_s"):
        srv.submit(TS.Request(prompt=prompts[0], deadline_s=0.0))
    h = srv.submit(TS.Request(prompt=prompts[0], max_new_tokens=2, deadline_s=600.0))
    assert h.result().finish_reason == "length"
