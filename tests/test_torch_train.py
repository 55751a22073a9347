"""The port's training path against the reference's on the CPU, on inputs
from a numpy seed:

* ``model.lm_loss`` and its gradients against
  ``jax.jit(jax.value_and_grad(M.lm_loss, has_aux=True))`` on the yi_6b,
  qwen3_moe, mamba2, zamba2 and hubert smoke configs (every leaf's gradient
  carried back through ``params_from_jax``), with remat on == off and
  ``microbatches`` 2 == 1 in the port;
* the gradients of ``ssd_scan`` at slow decays, and of ``moe_apply`` on a
  workload with capacity drops;
* one ``adamw.update``, ``schedule`` and ``clip_by_global_norm``; the int8
  error-feedback codes; the data pipeline;
* the checkpoint store, the straggler monitor, preempt -> final checkpoint
  -> resume, and the ``Trainer`` against the reference ``Trainer`` over 5
  steps from the same parameters and batches; the launcher and the examples'
  training on the CPU.

Tolerances.  Losses: within 1e-5 of the reference's (float32 sums in other
orders).  Gradients: each leaf within ``GRAD_RTOL`` of its largest
reference value, 2e-4, and 2e-3 on zamba2, whose 7 blocks are ill
conditioned: perturbing the reference's own parameters by 1e-7 moves its
gradients by 3e-4 of their largest value.  Optimizer states: 1e-6 relative.
The trainers' loss curves: within 1e-5 relative, their gradient norms
within 1e-3 (Adam's first steps move small gradients by their sign, which
float32 noise can flip).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoe  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import ssm as JSsm  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim import grad_compress as JG  # noqa: E402
from repro.train import trainer as JT  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import store as TS  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.models import moe as TMoe  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import ssm as TSsm  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import grad_compress as TG  # noqa: E402
from repro_torch.train import step as TStep  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402
from test_torch_shared import np_params  # noqa: E402

ARCHS = ("yi_6b", "qwen3_moe_30b_a3b", "mamba2_1_3b", "zamba2_7b", "hubert_xlarge")
GRAD_RTOL = {"zamba2_7b": 2e-3}
B, S = 2, 37  # a prime S: the reference snaps its chunks to one token, the port pads
def np_batch(jcfg, seed: int, b: int = B, s: int = S) -> dict:
    rng = np.random.default_rng(seed)
    if jcfg.input_mode == "tokens":
        batch = {"tokens": rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)}
    else:
        batch = {"embeddings": rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)}
    batch["labels"] = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    return batch


def _port_grads(tcfg, tp, batch, **kw):
    scfg = TStep.TrainStepConfig(remat=kw.pop("remat", False), q_chunk=16, kv_chunk=16)
    loss, parts, g = TStep.value_and_grad(tcfg, scfg, tp, TStep.to_device(batch, "cpu"))
    return loss, parts, tree.unflatten(tp, g)


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    jp = np_params(jcfg, 0)
    tp = params_from_jax(jp, tcfg, "cpu")
    batch = np_batch(jcfg, 1)
    fn = jax.jit(jax.value_and_grad(JM.lm_loss, has_aux=True), static_argnums=1)
    (jl, jparts), jg = fn(jp, jcfg, batch)
    loss, parts, grads = _port_grads(tcfg, tp, batch)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("ce", "aux_loss"):
        assert abs(float(parts[k]) - float(jparts[k])) <= 1e-5 * max(abs(float(jparts[k])), 1)
    if jcfg.family == "moe":
        assert float(parts["aux_loss"]) > 0
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg, "cpu")
    tol = GRAD_RTOL.get(arch, 2e-4)
    worst = {path: _rel_err(g, w) for (path, g), w in
             zip(tree.leaves_with_paths(grads), tree.leaves(want))}
    bad = {p: e for p, e in worst.items() if not e <= tol}
    assert not bad, bad


@pytest.mark.parametrize("arch", ("yi_6b", "mamba2_1_3b", "qwen3_moe_30b_a3b"))
def test_remat_and_microbatches_keep_the_gradients(arch):
    """Remat recomputes the same forward: loss and gradients equal.  Two
    microbatches of one row each average to the batch's gradient (not under
    MoE, whose capacity depends on the batch: there only remat)."""
    jcfg, tcfg = JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    tp = params_from_jax(np_params(jcfg, 2), tcfg, "cpu")
    batch = np_batch(jcfg, 3)
    loss, _, g = _port_grads(tcfg, tp, batch)
    loss_r, _, g_r = _port_grads(tcfg, tp, batch, remat=True)
    assert float(loss_r) == float(loss)
    for a, b in zip(tree.leaves(g_r), tree.leaves(g)):
        assert _rel_err(a, b) <= 1e-6
    if jcfg.family == "moe":
        return
    # microbatches through the whole step: one update from the same state
    scfg = TStep.TrainStepConfig(remat=False, q_chunk=16, kv_chunk=16)
    metrics = []
    outs = []
    for mb in (1, 2):
        p = tree.map_(lambda x: x.clone(), tp)
        step = TStep.build_train_step(tcfg, dataclasses.replace(scfg, microbatches=mb), "cpu")
        (p, _, _), m = step((p, TA.init(p), None), batch)
        metrics.append({k: float(v) for k, v in m.items()})
        outs.append(p)
    assert abs(metrics[1]["loss"] - metrics[0]["loss"]) <= 1e-6 * metrics[0]["loss"]
    assert abs(metrics[1]["grad_norm"] - metrics[0]["grad_norm"]) <= 1e-5 * metrics[0]["grad_norm"]
    for a, b in zip(tree.leaves(outs[1]), tree.leaves(outs[0])):
        assert float((a - b).abs().max()) <= 1e-6


def test_ssd_scan_gradients_at_slow_decay():
    """Gradients of ``ssd_scan`` (y and the final state) against the
    reference's, dt 0.001 to 0.01, where the masked exponent's entries sit
    next to decays close to 1: finite, and within 2e-5 of each input's
    largest reference gradient."""
    rng = np.random.default_rng(5)
    b, s, H, P, G, N = 2, 100, 4, 8, 2, 8
    x = rng.standard_normal((b, s, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.01, (b, s, H)).astype(np.float32)
    a = (-dt * np.linspace(1, 16, H)[None, None]).astype(np.float32)
    Bm = rng.standard_normal((b, s, G, N)).astype(np.float32)
    Cm = rng.standard_normal((b, s, G, N)).astype(np.float32)
    wy = rng.standard_normal((b, s, H, P)).astype(np.float32)
    wh = rng.standard_normal((b, H, N, P)).astype(np.float32)

    def jloss(*args):
        y, h = JSsm.ssd_scan(*args, 32)
        return jnp.sum(y * wy) + jnp.sum(h * wh)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(x, a, dt, Bm, Cm)
    targs = [torch.tensor(t, requires_grad=True) for t in (x, a, dt, Bm, Cm)]
    y, h = TSsm.ssd_scan(*targs, 32)
    tgrads = torch.autograd.grad((y * torch.as_tensor(wy)).sum() + (h * torch.as_tensor(wh)).sum(),
                                 targs)
    for name, jg, tg in zip(("x", "a", "dt", "B", "C"), jgrads, tgrads):
        assert torch.isfinite(tg).all(), name
        assert _rel_err(tg, torch.as_tensor(np.array(jg))) <= 2e-5, name


def test_moe_gradients_with_capacity_drops():
    """``moe_apply``'s gradients against the reference's on a workload that
    drops pairs (capacity factor 0.5).  The routing has no near-tie (the
    gap between each token's k-th and next router probability is far above
    float32 noise), so both drop the same pairs; a token whose every pair
    dropped gets only the router's gradient, as in the reference."""
    jcfg = dataclasses.replace(JR.get_smoke_config("qwen3_moe_30b_a3b"), capacity_factor=0.5)
    tcfg = dataclasses.replace(TR.get_smoke_config("qwen3_moe_30b_a3b"), capacity_factor=0.5)
    jp = np_params(jcfg, 7)["blocks"]["moe"]
    jp = jax.tree.map(lambda x: x[0], jp)
    tp = {k: torch.as_tensor(np.asarray(v)) for k, v in jp.items()}
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = JMoe.moe_apply(p, jcfg, x)
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, x)
    tx = torch.tensor(x, requires_grad=True)
    for v in tp.values():
        v.requires_grad_(True)
    y, aux = TMoe.moe_apply(tp, tcfg, tx)
    grads = torch.autograd.grad((y * torch.as_tensor(w)).sum() + aux, [tx, *tp.values()])
    xf = tx.detach().reshape(-1, tcfg.d_model)
    _, _, _, _, keep, _, _ = TMoe.route(tp, tcfg, xf)
    probs = torch.softmax(xf @ tp["router"].detach(), -1).sort(-1, descending=True).values
    assert float((probs[:, tcfg.top_k - 1] - probs[:, tcfg.top_k]).min()) > 1e-4
    keep = keep.reshape(-1, tcfg.top_k)
    assert (~keep).any(), "the workload must drop pairs"
    all_dropped = ~keep.any(-1)
    gx = grads[0].reshape(-1, tcfg.d_model)
    assert _rel_err(gx, torch.as_tensor(np.array(jgx)).reshape(-1, tcfg.d_model)) <= 2e-5
    if all_dropped.any():
        jx = np.asarray(jgx).reshape(-1, tcfg.d_model)[all_dropped.numpy()]
        assert np.abs(gx[all_dropped].numpy() - jx).max() <= 2e-5 * np.abs(jx).max() + 1e-12
    for name, g in zip(tp, grads[1:]):
        assert _rel_err(g, torch.as_tensor(np.array(jgp[name]))) <= 2e-5, name


def test_adamw_matches_reference():
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": [rng.standard_normal((3,)).astype(np.float32)]}
    grads = {"a": 3 * rng.standard_normal((5, 7)).astype(np.float32),
             "b": [rng.standard_normal((3,)).astype(np.float32)]}
    cfg = TA.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    jcfg = JA.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    for step in (0, 1, 3, 11, 20, 25):
        assert abs(float(TA.schedule(cfg, torch.tensor(step)))
                   - float(JA.schedule(jcfg, jnp.asarray(step)))) <= 1e-9
    for max_norm in (0.5, 100.0):
        jc, jn = JA.clip_by_global_norm(grads, max_norm)
        tc, tn = TA.clip_by_global_norm(tree.map_(torch.as_tensor, grads), max_norm)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        for a, b in zip(tree.leaves(tc), jax.tree.leaves(jc)):
            assert _rel_err(a, torch.as_tensor(np.array(b))) <= 1e-6
    jstate = JA.init(params)._replace(step=jnp.asarray(10, jnp.int32))
    jstate = jstate._replace(mu=jax.tree.map(lambda g: 0.3 * g, grads),
                             nu=jax.tree.map(lambda g: 0.2 * g * g, grads))
    jp, js, jm = JA.update(jcfg, grads, jstate, params)
    tp = tree.map_(lambda x: torch.tensor(x), params)
    ts = TA.AdamWState(step=torch.tensor(10, dtype=torch.int32),
                       mu=tree.map_(lambda g: torch.tensor(0.3 * g), grads),
                       nu=tree.map_(lambda g: torch.tensor(0.2 * g * g), grads))
    tp2, ts2, tm = TA.update(cfg, tree.map_(torch.as_tensor, grads), ts, tp)
    assert tp2 is tp and int(ts2.step) == int(js.step) == 11
    for k in ("grad_norm", "lr"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(float(jm[k]))
    for t, j in ((tp2, jp), (ts2.mu, js.mu), (ts2.nu, js.nu)):
        for a, b in zip(tree.leaves(t), jax.tree.leaves(j)):
            assert _rel_err(a, torch.as_tensor(np.array(b))) <= 1e-6


def test_grad_compress_is_bit_exact():
    rng = np.random.default_rng(10)
    g = {"w": (rng.standard_normal((33, 17)) * 1e-3).astype(np.float32),
         "z": np.zeros((4,), np.float32)}
    err = {"w": (rng.standard_normal((33, 17)) * 1e-5).astype(np.float32),
           "z": np.zeros((4,), np.float32)}
    jq, js = JG.quantize_int8(jnp.asarray(g["w"]))
    tq, ts = TG.quantize_int8(torch.as_tensor(g["w"]))
    assert np.array_equal(np.asarray(jq), tq.numpy()) and float(js) == float(ts)
    jd, je = JG.tree_compress_decompress(g, err)
    td, te = TG.tree_compress_decompress(tree.map_(torch.as_tensor, g),
                                         tree.map_(torch.as_tensor, err))
    for a, b in zip(tree.leaves(td) + tree.leaves(te), jax.tree.leaves(jd) + jax.tree.leaves(je)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert TG.payload_bytes(tree.map_(torch.as_tensor, g)) == JG.payload_bytes(g)
    zero = TG.init_error_state(tree.map_(torch.as_tensor, g))
    assert all(float(z.abs().max()) == 0 for z in tree.leaves(zero))


def test_corpora_match_reference(monkeypatch):
    """SyntheticCorpus is bit-identical; TextCorpus too once both harvests
    read the same bytes (the port reads torch's sources where the reference
    reads jax's)."""
    for step in (0, 7):
        a = TD.SyntheticCorpus(seq_len=16, global_batch=3, vocab_size=300, seed=4).batch_at(step)
        b = JD.SyntheticCorpus(seq_len=16, global_batch=3, vocab_size=300, seed=4).batch_at(step)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))
    text = bytes(np.random.default_rng(11).integers(0, 256, 50_000, dtype=np.uint8))
    monkeypatch.setattr(TD, "harvest_text", lambda max_bytes=0: text)
    monkeypatch.setattr(JD, "harvest_text", lambda max_bytes=0: text)
    tc, jc = TD.TextCorpus(seq_len=32, global_batch=4), JD.TextCorpus(seq_len=32, global_batch=4)
    for step in (0, 3, 1000):
        a, b = tc.batch_at(step), jc.batch_at(step)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))
    monkeypatch.undo()
    real = TD.harvest_text(1 << 16)
    assert len(real) == 1 << 16 and real == TD.harvest_text(1 << 16)


def _state(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    params = {"emb": {"embed": torch.randn(5, 3, generator=g)},
              "blocks": [{"w": torch.randn(2, 2, generator=g).to(torch.bfloat16)}
                         for _ in range(2)]}
    return (params, TA.init(params), None)


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_round_trip_gc_and_async(tmp_path):
    state = _state(1)
    TS.save(tmp_path, 3, state, {"note": "x"})
    (tmp_path / "step_000009.tmp").mkdir()  # a crashed write: ignored
    assert TS.latest_step(tmp_path) == 3
    got, manifest = TS.restore(tmp_path, _state(2))
    assert _equal(got, state) and manifest["step"] == 3 and manifest["meta"] == {"note": "x"}
    assert (tmp_path / "step_000003" / "manifest.json").exists()
    ck = TS.AsyncCheckpointer(tmp_path, keep=2)
    for step in (4, 5, 6):
        ck.save(step, state)
    ck.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000005", "step_000006"]
    with pytest.raises(FileNotFoundError):
        TS.restore(tmp_path / "none", state)
    bad = TS.AsyncCheckpointer(tmp_path / "f")
    (tmp_path / "f").write_text("a file, not a directory")
    bad.save(1, state)
    with pytest.raises(OSError):
        bad.wait()


def test_straggler_monitor_with_injected_clock():
    ticks = [0, 1, 1, 2.1, 2.1, 5.0, 5.0, 6.0, 6.0, 30.0]
    mons = [M(2.0, 0.5, clock=iter(ticks).__next__)
            for M in (TT.StragglerMonitor, JT.StragglerMonitor)]
    for mon in mons:
        for step in range(5):
            mon.start()
            mon.stop(step)
    assert mons[0].events == mons[1].events and [e[0] for e in mons[0].events] == [2, 4]
    assert mons[0].ewma == mons[1].ewma


def _yi32():
    return (dataclasses.replace(TR.get_smoke_config("yi_6b"), dtype="float32"),
            dataclasses.replace(JR.get_smoke_config("yi_6b"), dtype="float32"))


def _scfg(mod, steps=5):
    return mod.TrainStepConfig(remat=False, q_chunk=16, kv_chunk=16,
                               opt=mod.adamw.AdamWConfig(lr=1e-3, warmup_steps=2,
                                                         total_steps=steps))


def test_preempt_then_resume_gives_the_same_next_loss(tmp_path):
    """A trainer preempted after 2 steps writes its final checkpoint; a new
    trainer resumes at step 2 and its step-2 loss equals an uninterrupted
    run's exactly."""
    tcfg, _ = _yi32()
    data = TD.SyntheticCorpus(seq_len=16, global_batch=2, vocab_size=tcfg.vocab_size)

    class Stop:
        def __init__(self, trainer, at):
            self.trainer, self.at = trainer, at

        def batch_at(self, step):
            if step == self.at:
                self.trainer.request_preempt()
            return data.batch_at(step)

    conf = TT.TrainerConfig(total_steps=4, ckpt_every=0, ckpt_dir=str(tmp_path / "a"),
                            log_every=0)
    full = TT.Trainer(tcfg, _scfg(TStep), dataclasses.replace(
        conf, ckpt_dir=str(tmp_path / "b")), data, device="cpu")
    full.run()
    first = TT.Trainer(tcfg, _scfg(TStep), conf, data, device="cpu")
    first.data = Stop(first, 1)
    out = first.run()
    assert out["preempted"] and out["final_step"] == 2
    assert TS.latest_step(conf.ckpt_dir) == 2
    again = TT.Trainer(tcfg, _scfg(TStep), conf, data, device="cpu")
    assert again.maybe_resume() and again.start_step == 2
    out = again.run()
    assert out["final_step"] == 4 and not out["preempted"]
    assert [m["loss"] for m in again.metrics_log] == [m["loss"] for m in full.metrics_log[2:]]


def test_trainer_matches_reference_trainer(tmp_path):
    """Five steps of the port's Trainer and the reference's from the same
    float32 parameters on the same batches: the loss curves agree."""
    from repro.launch.mesh import make_host_mesh
    from repro.train import step as JStep

    tcfg, jcfg = _yi32()
    data = TD.SyntheticCorpus(seq_len=16, global_batch=4, vocab_size=tcfg.vocab_size)
    jp = np_params(jcfg, 12)
    conf = dict(total_steps=5, ckpt_every=0, log_every=0)
    jt = JT.Trainer(jcfg, make_host_mesh(), _scfg(JStep),
                    JT.TrainerConfig(ckpt_dir=str(tmp_path / "j"), **conf), data)
    jt.state = (jax.tree.map(jnp.asarray, jp), JA.init(jp), None)
    jt.run()
    tt = TT.Trainer(tcfg, _scfg(TStep), TT.TrainerConfig(ckpt_dir=str(tmp_path / "t"), **conf),
                    data, device="cpu")
    tp = params_from_jax(jp, tcfg, "cpu")
    tt.state = (tp, TA.init(tp), None)
    tt.run()
    for key, rtol in (("loss", 1e-5), ("lr", 1e-6), ("grad_norm", 1e-3)):
        a = np.array([m[key] for m in tt.metrics_log])
        b = np.array([m[key] for m in jt.metrics_log])
        np.testing.assert_allclose(a, b, rtol=rtol, err_msg=key)


def test_train_cli_and_examples_on_the_cpu(tmp_path, capsys, monkeypatch):
    import importlib.util
    from pathlib import Path

    from repro_torch.launch import tiny_lm
    from repro_torch.launch import train as launch

    monkeypatch.setattr(TD, "harvest_text", lambda max_bytes=0: bytes(range(256)) * 400)
    out = launch.main(["--arch", "yi_6b", "--steps", "3", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path / "c"), "--ckpt-every", "2",
                       "--device", "cpu"])
    assert out["final_step"] == 3 and TS.latest_step(tmp_path / "c") == 3
    out = launch.main(["--arch", "yi_6b", "--steps", "4", "--batch", "2", "--seq", "16",
                       "--ckpt-dir", str(tmp_path / "c"), "--resume", "--data", "synthetic",
                       "--device", "cpu"])
    assert out["final_step"] == 4 and "resume: ok, from step 3" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:  # the 2x16x16 mesh wants 512 devices
        launch.main(["--production", "--multi-pod", "--device", "cpu"])
    assert e.value.code == 2 and "needs 512 devices" in capsys.readouterr().err

    path = Path(__file__).resolve().parents[1] / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    first, second = mod.main(["--steps", "4", "--device", "cpu",
                              "--ckpt-dir", str(tmp_path / "e")])
    assert first["final_step"] == 4 and second["final_step"] == 24

    monkeypatch.setattr(tiny_lm, "CKPT", tmp_path / "tiny")
    cfg, params, _ = tiny_lm.get_tiny_lm(steps=2, device="cpu")
    _, again, _ = tiny_lm.get_tiny_lm(steps=2, device="cpu")  # from the cache now
    assert cfg == tiny_lm.TINY and _equal(params, again)
    assert tree.leaves(params)[0].dtype == torch.bfloat16  # TINY.dtype, as the reference
