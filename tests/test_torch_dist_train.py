"""Sharded training (``train.step.build_train_artifacts`` over a
``launch.mesh.Mesh``) on the CPU, the port against the reference and
against itself.

Against the reference's sharded step (ONE subprocess a test run with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``; the xdist workers
share its results through a file lock in the run's temp root), weights
from ``test_torch_shared.np_params`` on both sides, the port on
``devices=["cpu"] * 8``:

* (a) yi_6b smoke on a (4, 2) ("data", "model") mesh, 3 steps: losses
  within 1e-5 (relative), gradient norms within 1e-4 (the first step's is
  within 6e-6; Adam's first steps move small gradients by their sign, which
  float32 noise can flip, as ``tests/test_torch_train.py`` says of its
  trainers' curves), every parameter leaf within 2e-4 of its largest value
  after the steps but for at most 0.1% of its elements, which Adam's
  sign-driven first steps may move by up to 2 lr a step (seen: one element
  of 8192 at 3.1e-4, the same in the port's unsharded step);
* (b) qwen3_1_7b smoke on (2, 2, 2) ("pod", "data", "model") with
  ``cross_pod_grad_compress``, 2 steps: losses within 1e-5, and every
  ``err`` leaf after each step within 1e-3 of its largest value (seen:
  2.0e-4 after the first step, 4.1e-4 after the second).  ``err`` is the
  residual of ``g + err`` against its int8 code, at most half a code step
  (1/254 of the gradient's largest magnitude), so the gradients' float32
  differences weigh far more in it than in the gradient.  An element whose
  value sits at a code boundary may round the other way and move by one
  step: at most 0.1% of a leaf's elements may (seen: none).

Inside the port: sharded == unsharded (``build_train_step``) for dense,
MoE, mamba2 and zamba2 smoke (MoE's loss and gradient pieces bit-exact: it
runs the whole batch on the first device), a padded batch's global masked
mean, the gradient norm counting replicated leaves once, a 1x1 mesh equal
to ``build_train_step`` op for op, each piece's shape, elastic resume
across meshes, the ``Trainer`` on a mesh against the unsharded
``Trainer``, preempt and resume on another mesh, and the CLI.
"""

import dataclasses
import fcntl
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")

from repro.models import registry as JR  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import store as TStore  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.distributed import sharding as TSh  # noqa: E402
from repro_torch.launch.mesh import make_train_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.train import trainer as TT  # noqa: E402
from test_torch_shared import np_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL, GNORM_RTOL, LEAF_RTOL, ERR_RTOL = 1e-5, 1e-4, 2e-4, 1e-3
GRAD_RTOL = {"zamba2_7b": 2e-3}  # ill conditioned (tests/test_torch_train.py)
OFF_SHARE = 1e-3  # elements of a leaf an Adam sign or an int8 code boundary may move
CASES = {  # name: (arch, mesh, steps, compress)
    "a": ("yi_6b", (4, 2), 3, False),
    "b": ("qwen3_1_7b", (2, 2, 2), 2, True),
}
SEQ, BATCH = 16, 8

_REF_PROG = """
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.data.pipeline import SyntheticCorpus
from repro.distributed.sharding import make_mesh
from repro.models import model as M, registry
from repro.optim import adamw, grad_compress
from repro.train import step as step_lib

cases, root, out_path = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
out = {}
for name, (arch, shape, steps, compress) in cases.items():
    cfg = dataclasses.replace(registry.get_smoke_config(arch), dtype="float32")
    npz = np.load(f"{root}/torch_dist_train_{name}.npz")
    shapes = jax.eval_shape(lambda k: M.init_params(cfg, k)[0], jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: jnp.asarray(npz[jax.tree_util.keystr(path)]), shapes)
    data = SyntheticCorpus(seq_len=%(seq)d, global_batch=%(batch)d, vocab_size=cfg.vocab_size)
    bspecs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in data.batch_at(0).items()}
    scfg = step_lib.TrainStepConfig(
        remat=False, q_chunk=%(seq)d, kv_chunk=%(seq)d, cross_pod_grad_compress=compress,
        opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    n = int(np.prod(shape))
    mesh = make_mesh(tuple(shape), axes, devices=jax.devices()[:n])
    step, _, in_sh, out_sh = step_lib.build_train_artifacts(cfg, mesh, scfg, bspecs)
    with mesh:
        params = jax.device_put(params, in_sh[0][0])
        opt = jax.jit(adamw.init, out_shardings=in_sh[0][1])(params)
        err = (jax.jit(grad_compress.init_error_state, out_shardings=in_sh[0][2])(params)
               if compress else None)
        state = (params, opt, err)
        fn = jax.jit(step, in_shardings=in_sh, out_shardings=out_sh)
        for i in range(steps):
            batch = {k: jax.device_put(v, in_sh[1][k]) for k, v in data.batch_at(i).items()}
            state, metrics = fn(state, batch)
            out[f"{name}/loss/{i}"] = np.float32(metrics["loss"])
            out[f"{name}/gnorm/{i}"] = np.float32(metrics["grad_norm"])
            for path, x in (jax.tree_util.tree_flatten_with_path(state[2])[0]
                            if compress else []):
                out[f"{name}/err{i}/{jax.tree_util.keystr(path)}"] = np.asarray(x)
    for path, x in jax.tree_util.tree_flatten_with_path(state[0])[0]:
        out[f"{name}/param/{jax.tree_util.keystr(path)}"] = np.asarray(x)
np.savez(out_path, **out)
print("ok")
""" % dict(seq=SEQ, batch=BATCH)


def _ref_root(tmp_path_factory) -> Path:
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def _weights(name: str):
    arch = CASES[name][0]
    jcfg = JR.get_smoke_config(arch)
    return jcfg, np_params(jcfg, 3)


def _ref_tree(npz, prefix: str, like):
    """The reference's tree of ``like``'s structure from ``prefix/<keystr>``
    entries."""
    return jax.tree_util.tree_map_with_path(
        lambda path, s: npz[f"{prefix}/{jax.tree_util.keystr(path)}"], like)


def _port_run(name: str, jp):
    arch, shape, steps, compress = CASES[name]
    tcfg = dataclasses.replace(TR.get_smoke_config(arch), dtype="float32")
    data = TD.SyntheticCorpus(seq_len=SEQ, global_batch=BATCH, vocab_size=tcfg.vocab_size)
    scfg = TS.TrainStepConfig(remat=False, q_chunk=SEQ, kv_chunk=SEQ,
                              cross_pod_grad_compress=compress,
                              opt=TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10))
    mesh = make_train_mesh(",".join(map(str, shape)), ["cpu"] * int(np.prod(shape)))
    step, _, in_sh, _ = TS.build_train_artifacts(tcfg, mesh, scfg, data.batch_at(0))
    state = TS.place_state((params_from_jax(jp, tcfg, "cpu"), None, None), in_sh[0])
    losses, gnorms, errs = [], [], []
    for i in range(steps):
        batch = {k: TSh.place(torch.as_tensor(v), in_sh[1][k])
                 for k, v in data.batch_at(i).items()}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if state[2] is not None:
            errs.append(TSh.gather_tree(state[2], "cpu"))
    return tcfg, losses, gnorms, errs if compress else state


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """The reference's results (one subprocess a test run) and the port's,
    which runs while the subprocess does."""
    root = _ref_root(tmp_path_factory)
    out = root / "torch_dist_train_reference.npz"
    with open(root / "torch_dist_train.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = None
        if not out.exists():
            for name in CASES:
                _, jp = _weights(name)
                flat = jax.tree_util.tree_flatten_with_path(jp)[0]
                np.savez(root / f"torch_dist_train_{name}.npz",
                         **{jax.tree_util.keystr(k): v for k, v in flat})
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                       XLA_FLAGS="--xla_force_host_platform_device_count=8")
            partial = root / "torch_dist_train_partial.npz"
            proc = subprocess.Popen(
                [sys.executable, "-c", _REF_PROG,
                 json.dumps({k: list(v) for k, v in CASES.items()}),
                 str(root), str(partial)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        try:
            port = {name: _port_run(name, _weights(name)[1]) for name in CASES}
            if proc is not None:
                _, stderr = proc.communicate(timeout=900)
                assert proc.returncode == 0, stderr[-3000:]
                partial.rename(out)
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return np.load(out), port


def test_sharded_step_equals_reference_dense_4x2(dist_runs):
    npz, port = dist_runs
    tcfg, losses, gnorms, state = port["a"]
    steps = CASES["a"][2]
    np.testing.assert_allclose(losses, [npz[f"a/loss/{i}"] for i in range(steps)],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(gnorms, [npz[f"a/gnorm/{i}"] for i in range(steps)],
                               rtol=GNORM_RTOL)
    jcfg, jp = _weights("a")
    want = params_from_jax(_ref_tree(npz, "a/param", jp), tcfg, "cpu")
    got = TSh.gather_tree(state[0], "cpu")
    lr, steps = 1e-3, CASES["a"][2]
    for (path, g), w in zip(tree.leaves_with_paths(got), tree.leaves(want)):
        d = (g - w).abs()
        off = d > LEAF_RTOL * float(w.abs().max())
        assert float(off.float().mean()) <= OFF_SHARE, (path, int(off.sum()))
        assert float(d.max()) <= 2 * lr * steps, path


def test_cross_pod_compressed_step_equals_reference_2x2x2(dist_runs):
    npz, port = dist_runs
    tcfg, losses, _, errs = port["b"]
    steps = CASES["b"][2]
    np.testing.assert_allclose(losses, [npz[f"b/loss/{i}"] for i in range(steps)],
                               rtol=LOSS_RTOL)
    assert len(errs) == steps
    jcfg, jp = _weights("b")
    for i, got in enumerate(errs):
        want = params_from_jax(_ref_tree(npz, f"b/err{i}", jp), tcfg, "cpu")
        for (path, g), w in zip(tree.leaves_with_paths(got), tree.leaves(want)):
            top = float(w.abs().max())
            off = (g - w).abs() > ERR_RTOL * top
            assert float(off.float().mean()) <= OFF_SHARE, (i, path, int(off.sum()))
            assert float((g - w).abs().max()) <= 2.5 * top, (i, path)  # at most one code step


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------


def _f32(arch: str):
    return dataclasses.replace(TR.get_smoke_config(arch), dtype="float32")


def _batch(cfg, seed: int, b: int = BATCH, s: int = SEQ) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    else:
        out = {"embeddings": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return out


def _scfg(**kw):
    return TS.TrainStepConfig(remat=False, q_chunk=SEQ, kv_chunk=SEQ,
                              opt=TA.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10), **kw)


def _sharded(cfg, scfg, spec: str, params, batch0):
    mesh = make_train_mesh(spec, ["cpu"] * int(np.prod([int(x) for x in spec.split(",")])))
    step, _, in_sh, _ = TS.build_train_artifacts(cfg, mesh, scfg, batch0)
    state = TS.place_state((params, None, None), in_sh[0])
    place = lambda b: {k: TSh.place(torch.as_tensor(v), in_sh[1][k])  # noqa: E731
                       for k, v in b.items()}
    return step, state, place, in_sh


def _copy(params):
    return tree.map_(lambda x: x.clone(), params)


@pytest.mark.parametrize("arch", ["yi_6b", "qwen3_moe_30b_a3b", "mamba2_1_3b", "zamba2_7b"])
def test_sharded_equals_unsharded(arch):
    cfg = _f32(arch)
    params = TM.init_params(cfg, seed=1, device="cpu")
    scfg = _scfg()
    plain = TS.build_train_step(cfg, scfg, "cpu")
    ref = _copy(params)
    ref_state = (ref, TA.init(ref), None)
    step, state, place, _ = _sharded(cfg, scfg, "2,2", params, _batch(cfg, 0))
    for i in range(2):
        b = _batch(cfg, i)
        if cfg.family == "moe" and i == 0:  # bit-exact: the whole batch on the first device
            mesh = state[0]["ln_f"].mesh
            pshard = tree.map_(lambda x: x.sharding, state[0])
            l0, _, g0 = TS.loss_and_grads(cfg, scfg, TSh.gather_tree(state[0], "cpu"),
                                          TS.to_device(b, "cpu"))
            l1, _, g1 = TS._sharded_loss_and_grads(cfg, scfg, mesh, TSh.data_shards(mesh),
                                                   state[0], place(b), pshard)
            assert float(l1) == float(l0)
            for g, piece in zip(g0, g1):  # the pieces are the gradient's slices, bit for bit
                for pos in mesh.positions():
                    assert torch.equal(piece.piece(pos),
                                       g[piece.sharding.region(g.shape, pos)])
        ref_state, m1 = plain(ref_state, b)
        state, m2 = step(state, place(b))
        if cfg.family == "moe":
            assert float(m2["loss"]) == float(m1["loss"])
        np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    tol = GRAD_RTOL.get(arch, LEAF_RTOL)
    for a, w in zip(tree.leaves(TSh.gather_tree(state[0], "cpu")), tree.leaves(ref_state[0])):
        assert float((a - w).abs().max()) <= tol * float(w.abs().max())


def test_microbatches_split_the_global_batch():
    """Two microbatches on a (2, 2) mesh: each part of the global batch over
    the shards; the loss and the parameters as the unsharded step's."""
    cfg = _f32("yi_6b")
    params = TM.init_params(cfg, seed=2, device="cpu")
    scfg = _scfg(microbatches=2)
    ref = _copy(params)
    ref_state, m1 = TS.build_train_step(cfg, scfg, "cpu")((ref, TA.init(ref), None),
                                                         _batch(cfg, 5))
    step, state, place, _ = _sharded(cfg, scfg, "2,2", params, _batch(cfg, 5))
    state, m2 = step(state, place(_batch(cfg, 5)))
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=LOSS_RTOL)
    assert float(m2["aux_loss"]) == 0.0 and float(m2["ce"]) == float(m2["loss"])
    for a, w in zip(tree.leaves(TSh.gather_tree(state[0], "cpu")), tree.leaves(ref_state[0])):
        assert float((a - w).abs().max()) <= LEAF_RTOL * float(w.abs().max())


def test_padded_batch_gives_the_global_masked_mean():
    """A mask with unequal counts on the two data shards: the sharded loss
    is the global masked mean, not the mean of the shards' means."""
    cfg = _f32("yi_6b")
    params = TM.init_params(cfg, seed=3, device="cpu")
    b = _batch(cfg, 7)
    mask = np.zeros((BATCH, SEQ), np.float32)
    mask[:BATCH // 2, :3] = 1  # shard 0: 12 tokens
    mask[BATCH // 2:, :] = 1   # shard 1: 64 tokens
    b["mask"] = mask
    want, _ = TM.lm_loss(_copy(params), cfg, TS.to_device(b, "cpu"))
    halves = [TM.lm_loss(_copy(params), cfg, TS.to_device(
        {k: v[i * 4:(i + 1) * 4] for k, v in b.items()}, "cpu"))[0] for i in range(2)]
    step, state, place, _ = _sharded(cfg, _scfg(), "2,2", params, b)
    _, m = step(state, place(b))
    np.testing.assert_allclose(float(m["loss"]), float(want), rtol=1e-6)
    assert abs(float(m["loss"]) - float(sum(halves) / 2)) > 1e-3


def test_grad_norm_counts_replicated_leaves_once():
    mesh = make_train_mesh("2,2", ["cpu"] * 4)
    g = {"rep": torch.ones(6), "row": torch.arange(8.0).reshape(4, 2),
         "half": torch.full((4,), 2.0)}
    sh = {"rep": TSh.replicated(mesh), "row": TSh.NamedSharding(mesh, TSh.P("data", "model")),
          "half": TSh.NamedSharding(mesh, TSh.P("model"))}
    placed = TSh.place_tree(g, sh)
    assert len(placed["rep"].blocks) == 1  # four positions, one device, one tensor
    want = float(TA.global_norm(g))
    assert abs(float(TA.global_norm(placed)) - want) <= 1e-6 * want
    # replicas on distinct devices count once too: pieces of the same slice
    rep = placed["rep"]
    two = TSh.Sharded(rep.sharding, rep.shape, rep.dtype, [rep.blocks[0], rep.blocks[0].clone()],
                      rep.regions * 2, rep.slots)
    assert len(two.distinct()) == 1
    assert float(TA.global_norm({"rep": two})) == float(TA.global_norm({"rep": g["rep"]}))


def test_one_by_one_mesh_equals_build_train_step_op_for_op():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    cfg = _f32("yi_6b")
    params = TM.init_params(cfg, seed=4, device="cpu")
    scfg = _scfg()
    b = _batch(cfg, 1)
    ref = _copy(params)
    plain, ref_state = TS.build_train_step(cfg, scfg, "cpu"), (ref, TA.init(ref), None)
    step, state, place, _ = _sharded(cfg, scfg, "1,1", params, b)
    tb = TS.to_device(b, "cpu")
    pb = place(b)
    with Ops() as a:
        ref_state, m1 = plain(ref_state, tb)
    with Ops() as o:
        state, m2 = step(state, pb)
    assert a.ops == o.ops and len(a.ops) > 100
    assert float(m1["loss"]) == float(m2["loss"])
    for x, y in zip(tree.leaves(TSh.gather_tree(state[0], "cpu")), tree.leaves(ref_state[0])):
        assert torch.equal(x, y)


def test_pieces_have_the_reference_shard_shapes():
    from repro.distributed import sharding as JSh
    from repro.train import step as JS

    cfg = _f32("qwen3_1_7b")
    jcfg = dataclasses.replace(JR.get_smoke_config("qwen3_1_7b"), dtype="float32")
    params = TM.init_params(cfg, seed=0, device="cpu")
    _, state, _, in_sh = _sharded(cfg, _scfg(cross_pod_grad_compress=True), "2,2,2", params,
                                  _batch(cfg, 0))
    jm = JSh.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    jshapes, jaxes = JS.shapes_and_axes(jcfg)
    jsh = JSh.make_param_shardings(jaxes, jshapes, JSh.train_rules(jcfg, jm), jm)
    jflat = {tuple(str(p.key) for p in path): (s, x) for (path, s), x in zip(
        jax.tree_util.tree_flatten_with_path(jsh)[0], jax.tree.leaves(jshapes))}
    mesh = in_sh[0][0]["ln_f"].mesh
    for part in (state[0], state[1].mu, state[1].nu, state[2]):
        for path, x in tree.leaves_with_paths(part):
            key = tuple(p for p in path if isinstance(p, str))
            k = len(path) - len(key)
            js, jx = jflat[key]
            want = js.shard_shape(jx.shape)[k:]
            for pos in mesh.positions():
                assert tuple(x.piece(pos).shape) == want, path
                assert x.piece(pos).device == mesh.devices[pos]
    assert TSh.shard_nbytes(state[0], (1, 1, 1)) == TSh.spec_nbytes(state[0])


def _save_restore_next_loss(tmp_path, src: str, dsts):
    cfg = _f32("yi_6b")
    params = TM.init_params(cfg, seed=5, device="cpu")
    step, state, place, _ = _sharded(cfg, _scfg(), src, params, _batch(cfg, 0))
    state, _ = step(state, place(_batch(cfg, 0)))
    TStore.save(tmp_path / src, 1, state)
    full = TSh.gather_tree(state, "cpu")
    ref_state, want = TS.build_train_step(cfg, _scfg(), "cpu")(
        tree.map_(lambda x: x.clone(), full), _batch(cfg, 1))
    out = {}
    for dst in dsts:
        mesh = make_train_mesh(dst, ["cpu"] * int(np.prod([int(x) for x in dst.split(",")])))
        step2, shapes, in_sh, _ = TS.build_train_artifacts(cfg, mesh, _scfg(), _batch(cfg, 0))
        got, manifest = TStore.restore(tmp_path / src, shapes, shardings=in_sh[0])
        assert manifest["step"] == 1
        for a, b in zip(tree.leaves(TSh.gather_tree(got, "cpu")), tree.leaves(full)):
            assert torch.equal(a, b)  # the files hold the full arrays, bit for bit
        bb = {k: TSh.place(torch.as_tensor(v), in_sh[1][k]) for k, v in _batch(cfg, 1).items()}
        _, m = step2(got, bb)
        out[dst] = float(m["loss"])
    return float(want["loss"]), out


def test_elastic_resume_across_meshes(tmp_path):
    """Saved on (2, 2), restored on 1x1 and (4, 1); saved on 1x1, restored
    on (2, 2): the restored state is the saved one bit for bit, and the
    next loss equals the unsharded step's from it (1x1: exactly)."""
    want, got = _save_restore_next_loss(tmp_path, "2,2", ["1,1", "4,1"])
    assert got["1,1"] == want
    np.testing.assert_allclose(got["4,1"], want, rtol=1e-6)
    want, got = _save_restore_next_loss(tmp_path, "1,1", ["2,2"])
    np.testing.assert_allclose(got["2,2"], want, rtol=1e-6)


def _trainer(tmp, cfg, data, mesh_spec=None, total=5):
    conf = TT.TrainerConfig(total_steps=total, ckpt_every=0, ckpt_dir=str(tmp), log_every=0)
    scfg = TS.TrainStepConfig(remat=False, q_chunk=SEQ, kv_chunk=SEQ,
                              opt=TA.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=total))
    if mesh_spec is None:
        return TT.Trainer(cfg, scfg, conf, data, device="cpu")
    n = int(np.prod([int(x) for x in mesh_spec.split(",")]))
    return TT.Trainer(cfg, scfg, conf, data, mesh=make_train_mesh(mesh_spec, ["cpu"] * n))


def test_mesh_trainer_curve_and_resume_on_another_mesh(tmp_path):
    """The Trainer on a (2, 2) mesh: its 5-step curve equals the unsharded
    Trainer's.  Preempted after 2 steps on (2, 2), it resumes on (4, 1) and
    its later losses equal the uninterrupted run's."""
    cfg = _f32("yi_6b")
    data = TD.SyntheticCorpus(seq_len=SEQ, global_batch=BATCH, vocab_size=cfg.vocab_size)
    params = TM.init_params(cfg, seed=6, device="cpu")
    plain = _trainer(tmp_path / "p", cfg, data)
    plain.state = (_copy(params), None, None)
    plain.state = (plain.state[0], TA.init(plain.state[0]), None)
    plain.run()
    full = _trainer(tmp_path / "f", cfg, data, "2,2")
    full.state = (_copy(params), None, None)
    full.run()
    for key, rtol in (("loss", 1e-5), ("lr", 1e-6), ("grad_norm", 1e-3)):
        np.testing.assert_allclose([m[key] for m in full.metrics_log],
                                   [m[key] for m in plain.metrics_log], rtol=rtol, err_msg=key)

    class Stop:
        def __init__(self, trainer, at):
            self.trainer, self.at = trainer, at

        def batch_at(self, step):
            if step == self.at:
                self.trainer.request_preempt()
            return data.batch_at(step)

    first = _trainer(tmp_path / "r", cfg, data, "2,2")
    first.state = (_copy(params), None, None)
    first.data = Stop(first, 1)
    out = first.run()
    assert out["preempted"] and out["final_step"] == 2
    again = _trainer(tmp_path / "r", cfg, data, "4,1")
    assert again.maybe_resume() and again.start_step == 2
    assert again.run()["final_step"] == 5
    np.testing.assert_allclose([m["loss"] for m in again.metrics_log],
                               [m["loss"] for m in full.metrics_log[2:]], rtol=1e-6)


def test_train_cli_meshes(tmp_path, capsys):
    from repro_torch.launch import train as launch

    out = launch.main(["--arch", "qwen3_1_7b", "--steps", "2", "--batch", "8", "--seq", "16",
                       "--data", "synthetic", "--ckpt-dir", str(tmp_path / "c"),
                       "--device", "cpu", "--mesh", "2,1,2", "--grad-compress"])
    assert out["final_step"] == 2
    manifest = json.loads(
        (tmp_path / "c" / "step_000002" / "manifest.json").read_text())
    paths = [e["path"] for e in manifest["leaves"]]
    assert any(p.startswith("2/") for p in paths)  # the err state: the pod axis compresses
    out = launch.main(["--arch", "qwen3_1_7b", "--steps", "3", "--batch", "8", "--seq", "16",
                       "--data", "synthetic", "--ckpt-dir", str(tmp_path / "c"), "--resume",
                       "--device", "cpu", "--mesh", "2,1,2", "--grad-compress"])
    assert out["final_step"] == 3 and "resume: ok, from step 2" in capsys.readouterr().out
    out = launch.main(["--arch", "yi_6b", "--steps", "1", "--batch", "2", "--seq", "16",
                       "--data", "synthetic", "--ckpt-dir", str(tmp_path / "m"),
                       "--device", "cpu", "--multi-pod"])
    assert out["final_step"] == 1  # no longer refused: it shapes --production's mesh
    for argv, text in ((["--production", "--multi-pod"], "needs 512 devices but only 1"),
                       (["--production"], "needs 256 devices but only 1"),
                       (["--mesh", "2,x"], "--mesh wants")):
        with pytest.raises(SystemExit) as e:
            launch.main(argv + ["--device", "cpu"])
        assert e.value.code == 2 and text in capsys.readouterr().err
