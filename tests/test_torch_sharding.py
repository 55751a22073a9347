"""The port's sharding rules and spec builders (``distributed.sharding``)
against the reference's, in process, on abstract meshes (no device on
either side: spec construction needs only axis names and sizes).

* ``train_rules`` / ``serve_rules`` through ``spec_for_axes`` give the
  reference's spec for every parameter leaf of every config in
  ``registry.ARCHS`` (smoke size) and of the full Yi-6B, Qwen3-30B-A3B and
  Zamba2-7B (shapes only), on (2, 4), (16, 16) and (2, 16, 16) meshes.  A
  port leaf is one layer's: it maps to the reference's stacked leaf with
  the stacking axes (``layers``, ``periods``) dropped, its shape and spec
  likewise; the shard shapes agree too.
* the MoE switch between expert parallelism and TP inside the experts,
  ``batch_sharding``'s divisibility, and ``cache_shardings`` field by field
  on ``init_decode_state`` shapes (dense, paged, ssm and hybrid);
* every assertion of ``tests/test_sharding.py`` but the ambient
  ``constrain``, which the port does not have (its step places every
  tensor itself).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402

from repro.distributed import sharding as JSh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.distributed import sharding as TSh  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CONFIGS = [(a, "smoke") for a in JR.ARCHS] + [
    (a, "full") for a in ("yi_6b", "qwen3_moe_30b_a3b", "zamba2_7b")]


def _cfgs(arch: str, size: str):
    if size == "smoke":
        return JR.get_smoke_config(arch), TR.get_smoke_config(arch)
    return JR.get_config(arch), TR.get_config(arch)


@functools.lru_cache(maxsize=None)
def _ref_shapes_and_axes(arch: str, size: str):
    return JS.shapes_and_axes(_cfgs(arch, size)[0])


def _ref_leaves(tree_):
    """{path without indices: leaf} of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree_, is_leaf=lambda x: isinstance(x, (tuple, JNamedSharding)) and not hasattr(x, "_fields"))[0]
    return {tuple(str(p.key) for p in path): leaf for path, leaf in flat}


def _port_leaves(tree_, prefix=()):
    """[(path, leaf)] of a port tree whose leaves are tensors, logical-axes
    tuples or shardings; a path holds the layer indices."""
    if isinstance(tree_, dict):
        return [x for k in sorted(tree_) for x in _port_leaves(tree_[k], prefix + (k,))]
    if isinstance(tree_, list):
        return [x for i, v in enumerate(tree_) for x in _port_leaves(v, prefix + (i,))]
    return [(prefix, tree_)]


def _ref_key(path):
    """(the reference's path, the number of stacking axes) of a port path."""
    return tuple(p for p in path if isinstance(p, str)), sum(isinstance(p, int) for p in path)


def _port_spec(jspec, k: int) -> P:
    return P(*tuple(jspec)[k:])


@pytest.mark.parametrize("mesh_shape,names", MESHES, ids=lambda x: "x".join(map(str, x))
                         if isinstance(x[0], int) else None)
@pytest.mark.parametrize("arch,size", CONFIGS, ids=lambda x: x)
def test_param_specs_equal_reference(arch, size, mesh_shape, names):
    jcfg, tcfg = _cfgs(arch, size)
    jshapes, jaxes = _ref_shapes_and_axes(arch, size)
    tshapes, taxes = TS.shapes_and_axes(tcfg)
    jm, tm = JSh.abstract_mesh(mesh_shape, names), TSh.abstract_mesh(mesh_shape, names)
    jl = _ref_leaves(jshapes)
    jax_axes = _ref_leaves(jaxes)
    tl = dict(_port_leaves(tshapes))
    ta = dict(_port_leaves(taxes))
    assert set(tl) == set(ta)
    assert {_ref_key(p)[0] for p in tl} == set(jl)
    for rules_of in ("train_rules", "serve_rules"):
        jr, tr = getattr(JSh, rules_of)(jcfg, jm), getattr(TSh, rules_of)(tcfg, tm)
        assert dict(tr.table) == dict(jr.table)
        jsh = _ref_leaves(JSh.make_param_shardings(jaxes, jshapes, jr, jm))
        tsh = dict(_port_leaves(TSh.make_param_shardings(taxes, tshapes, tr, tm)))
        for path, t in tl.items():
            key, k = _ref_key(path)
            assert tuple(t.shape) == tuple(jl[key].shape)[k:], path
            assert ta[path] == jax_axes[key][k:], path
            spec = TSh.spec_for_axes(ta[path], tuple(t.shape), tr, tm)
            want = _port_spec(jsh[key].spec, k)
            assert spec == want == tsh[path].spec, (rules_of, path, spec, jsh[key].spec)
            assert tsh[path].shard_shape(t.shape) == jsh[key].shard_shape(
                jl[key].shape)[k:], path


def test_moe_rules_switch_on_expert_count():
    mesh = TSh.abstract_mesh((2, 4), ("data", "model"))
    few = TR.get_smoke_config("mixtral_8x22b")  # E=4 == |model| -> expert parallelism
    assert TSh.train_rules(few, mesh).get("experts") == "model"
    assert TSh.train_rules(few, mesh).get("expert_mlp") is None
    few2 = dataclasses.replace(few, n_experts=2)  # E=2 < |model| -> TP in each expert
    assert TSh.train_rules(few2, mesh).get("experts") is None
    assert TSh.train_rules(few2, mesh).get("expert_mlp") == "model"
    jm = JSh.abstract_mesh((2, 4), ("data", "model"))
    jfew2 = dataclasses.replace(JR.get_smoke_config("mixtral_8x22b"), n_experts=2)
    for rules in ("train_rules", "serve_rules"):
        assert (dict(getattr(TSh, rules)(few2, mesh).table)
                == dict(getattr(JSh, rules)(jfew2, jm).table))


def test_spec_conflict_sanitation():
    mesh = TSh.abstract_mesh((1, 1), ("data", "model"))
    rules = TSh.Rules({"x": "model", "y": "model"})
    spec = TSh.spec_for_axes(("x", "y"), (16, 16), rules, mesh)
    assert spec == P("model") == P("model", None)  # the second use of "model" is dropped
    jm = JSh.abstract_mesh((1, 1), ("data", "model"))
    assert spec == P(*JSh.spec_for_axes(("x", "y"), (16, 16), JSh.Rules(rules.table), jm))


def test_spec_divisibility():
    rules = TSh.Rules({"v": "model", "w": ("pod", "data")})
    one = TSh.abstract_mesh((1, 1), ("data", "model"))
    assert TSh.spec_for_axes(("v",), (17,), rules, one) == P("model")  # 17 % 1 == 0
    mesh = TSh.abstract_mesh((2, 4), ("data", "model"))
    assert TSh.spec_for_axes(("v",), (10,), rules, mesh) == P()  # 10 % 4 != 0
    assert TSh.spec_for_axes(("v",), (12,), rules, mesh) == P("model")
    pods = TSh.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    jpods = JSh.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    for shape in ((8,), (6,), (2,), (3,)):  # both axes, "pod" alone, "pod" alone, neither
        got = TSh.spec_for_axes(("w",), shape, rules, pods)
        assert got == P(*JSh.spec_for_axes(("w",), shape, JSh.Rules(rules.table), jpods))
    assert TSh.spec_for_axes(("w",), (8,), rules, pods) == P(("pod", "data"))
    assert TSh.spec_for_axes(("w",), (6,), rules, pods) == P("pod")


def test_param_shardings_cover_tree():
    mesh = TSh.abstract_mesh((2, 4), ("data", "model"))
    cfg = TR.get_smoke_config("yi_6b")
    pshapes, axes = TS.shapes_and_axes(cfg)
    pshard = TSh.make_param_shardings(axes, pshapes, TSh.train_rules(cfg, mesh), mesh)
    leaves = tree.leaves(pshard)
    assert len(tree.leaves(pshapes)) == len(leaves)
    assert all(isinstance(s, TSh.NamedSharding) for s in leaves)
    assert all(x.device.type == "meta" for x in tree.leaves(pshapes))  # no storage


def test_batch_sharding_divisibility():
    for shape, names in MESHES + [((1, 1), ("data", "model")), ((4, 2), ("data", "model"))]:
        tm, jm = TSh.abstract_mesh(shape, names), JSh.abstract_mesh(shape, names)
        for bshape in ((8, 16), (1,), (32, 5), (64, 3, 2), (512, 4), ()):
            got = TSh.batch_sharding(tm, np.zeros(bshape, np.int32)).spec
            want = JSh.batch_sharding(jm, jax.ShapeDtypeStruct(bshape, jnp.int32)).spec
            assert got == P(*want), (shape, bshape)
    mesh = TSh.abstract_mesh((2, 4), ("data", "model"))
    assert TSh.batch_sharding(mesh, np.zeros((8, 16))).spec == P(("data",), None) == P("data")
    assert TSh.batch_sharding(mesh, np.zeros((1,))).spec == P()
    pods = TSh.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    assert TSh.batch_sharding(pods, np.zeros((8, 4))).spec == P(("pod", "data"))
    assert TSh.replicated(mesh).spec == P()


CACHE_CASES = {
    "dense": ("yi_6b", dict(n_kv_heads=2, cache_block=8), 0),
    "paged": ("yi_6b", dict(n_kv_heads=2, cache_block=8, cache_mode="paged"), 24),
    "ssm": ("mamba2_1_3b", {}, 0),
    "hybrid": ("zamba2_7b", dict(cache_block=8), 0),
}


@pytest.mark.parametrize("mesh_shape,names", [MESHES[0], ((2, 2, 2), ("pod", "data", "model"))],
                         ids=["2x4", "2x2x2"])
@pytest.mark.parametrize("case", list(CACHE_CASES))
def test_cache_shardings_equal_reference(case, mesh_shape, names):
    arch, over, pages = CACHE_CASES[case]
    jcfg = dataclasses.replace(JR.get_smoke_config(arch), **over)
    tcfg = dataclasses.replace(TR.get_smoke_config(arch), **over)
    jstate = jax.eval_shape(lambda: JM.init_decode_state(jcfg, 8, 256, pool_pages=pages))
    tstate = TM.init_decode_state(tcfg, 8, 256, device="meta", pool_pages=pages)
    jm, tm = JSh.abstract_mesh(mesh_shape, names), TSh.abstract_mesh(mesh_shape, names)
    jsh = jax.tree_util.tree_flatten_with_path(JSh.cache_shardings(jstate, jm))[0]
    want = {}
    for path, s in jsh:
        keys = [getattr(p, "key", getattr(p, "name", None)) for p in path]
        want[(keys[0], keys[-1])] = s.spec
    tsh = TSh.cache_shardings(tstate, tm)
    n = 0
    for group, layers_ in tsh.items():
        stack = 2 if (group == "ssm" and tcfg.family == "hybrid") else 1
        for path, s in _port_leaves(layers_):
            field = path[-1]
            assert s.spec == _port_spec(want[(group, field)], stack), (group, path)
            n += 1
    n_leaves = sum(len(c.FIELDS) if hasattr(c, "FIELDS") else 1
                   for c in tree.leaves(tstate))
    assert n == n_leaves  # every leaf mapped
    if case == "dense" and names == ("data", "model"):  # the reference test's three fields
        for layer in tsh["kv"]:
            assert layer["k_store"].spec == P(("data",), None, "model")
            assert layer["k_buf"].spec == P(("data",))
            assert layer["n_flushed"].spec == P()
    if case == "paged":  # the arena's batch of 1 stays replicated, its pages shard
        assert tsh["kv"][0]["k_store"].spec == P(None, None, "model")


def test_shard_shapes_and_pieces():
    """Each position's piece has the spec's shard shape and the slice the
    reference assigns it (row-major over the axes of a dimension), on its
    position's device; replicas on one device share a tensor."""
    from repro_torch.launch.mesh import make_train_mesh

    mesh = make_train_mesh("2,2,2", ["cpu"] * 8)
    x = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    for entries in ((("pod", "data"), "model"), ("model", None, "pod"), (), ("data",)):
        sh = TSh.NamedSharding(mesh, P(*entries))
        s = TSh.place(x, sh)
        for pos in mesh.positions():
            piece = s.piece(pos)
            assert tuple(piece.shape) == sh.shard_shape(x.shape)
            assert torch.equal(piece, x[sh.region(x.shape, pos)])
        assert len(s.blocks) == len({tuple((r.start, r.stop) for r in reg) for reg in s.regions})
        assert torch.equal(TSh.gather(s, "cpu"), x)
    sh = TSh.NamedSharding(mesh, P(("pod", "data"), "model"))
    assert sh.region(x.shape, (1, 0, 1)) == (slice(4, 6), slice(3, 6), slice(0, 4))
    jsh = JNamedSharding(JSh.abstract_mesh((2, 2, 2), mesh.axis_names),
                         jax.sharding.PartitionSpec(("pod", "data"), "model"))
    assert sh.shard_shape(x.shape) == jsh.shard_shape(x.shape)
