"""The port's dry run (``repro_torch.launch.dryrun`` / ``hlo_profile``)
against the reference's, on the CPU.

* The analytic terms (``skip_reason``, ``analytic_memory_bytes``,
  ``decode_kv_traffic``'s bytes and ratio, ``model_flops``, ``full_units``,
  ``analysis_depths``, the layouts' ``bytes_per_token``,
  ``supports_long_context_decode``, ``ASSIGNED``) equal the reference's
  exactly for every arch, shape and production chip count.
* The reference's compile of ``tests/test_dryrun.py``'s ``TINY`` on a
  one-device host mesh against the port's count of the same cells: the
  argument bytes equal, the FLOPs in a stated ratio.
* The count: depth-1/2 extrapolation == a direct count at depth 4; CPU ==
  meta op for op; the decode's charged Fetch bytes against
  ``decode_kv_traffic``; the wrappers charge under a count and raise on
  meta outside it; ``profile_cell``'s groups add up; ``run_cell`` writes
  where ``ARTIFACTS`` points; no mode, env var or default left behind.

The reference's ``dryrun`` / ``hlo_profile`` set ``XLA_FLAGS`` when
imported: every test that imports them does so through ``ref``, which starts
JAX first and restores the variable after the test.
"""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")

from repro.models import registry as JR  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.core import layouts as TL  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_profile as HP  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_train_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

CHIPS = {"pod": 256, "multipod": 512}
LAYOUTS = ("raw", "packed", "kivi", "huffman")

# tests/test_dryrun.py's TINY, in both packages
TINY_KW = dict(name="tiny-dryrun", family="dense", n_layers=2, d_model=32, vocab_size=64,
               n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, cache_block=8)
TINY = ModelConfig(**TINY_KW)
TINY_SHAPES = {"train_4k": dict(kind="train", seq=32, batch=8),
               "prefill_32k": dict(kind="prefill", seq=64, batch=2),
               "decode_32k": dict(kind="decode", seq=64, batch=2)}


@pytest.fixture
def ref(monkeypatch):
    """The reference's dryrun module, imported with JAX already started and
    ``XLA_FLAGS`` restored after the test."""
    jax.devices()
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun, hlo_profile  # noqa: F401

    return dryrun


@pytest.fixture
def tiny_shapes(monkeypatch):
    for name, info in TINY_SHAPES.items():
        monkeypatch.setitem(D.SHAPES, name, info)


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", TR.ARCHS)
def test_depth_terms_equal_reference(ref, arch):
    t, j = TR.get_config(arch), JR.get_config(arch)
    assert t.supports_long_context_decode == j.supports_long_context_decode
    assert D.full_units(t) == ref.full_units(j)
    for tc, jc in zip(D.analysis_depths(t)[:2], ref.analysis_depths(j)[:2]):
        jf = _fields(jc)
        assert {k: v for k, v in _fields(tc).items()} == {k: jf[k] for k in _fields(tc)}
    assert D.analysis_depths(t)[2:] == ref.analysis_depths(j)[2:]


@pytest.mark.parametrize("shape", list(D.SHAPES))
@pytest.mark.parametrize("arch", TR.ARCHS)
def test_analytic_terms_equal_reference(ref, arch, shape):
    t, j = TR.get_config(arch), JR.get_config(arch)
    from repro.core import layouts as JL
    from repro.models import model as JM

    assert D.skip_reason(t, shape) == ref.skip_reason(j, shape)
    assert D.model_flops(t, shape) == ref.model_flops(j, shape)
    S = D.SHAPES[shape]["seq"]
    if t.has_attention:
        for tsp, jsp in zip(TM.cache_specs(t, S), JM.cache_specs(j, S)):
            for lay in LAYOUTS:
                got = TL.get_layout(lay).bytes_per_token(tsp, t.n_kv_heads,
                                                         t.resolved_head_dim)
                assert got == JL.get_layout(lay).bytes_per_token(
                    jsp, j.n_kv_heads, j.resolved_head_dim), lay
    for chips in CHIPS.values():
        assert D._serve_shards(chips, D.SHAPES[shape]["batch"]) == ref._serve_shards(
            chips, ref.SHAPES[shape]["batch"])
        assert D.analytic_memory_bytes(t, shape, chips) == ref.analytic_memory_bytes(
            j, shape, chips)
        tt, jt = D.decode_kv_traffic(t, shape, chips), ref.decode_kv_traffic(j, shape, chips)
        assert (tt is None) == (jt is None)
        if tt is not None:
            for k in ("fused_bytes", "materialized_bytes", "traffic_ratio"):
                assert tt[k] == jt[k], k


def test_assigned_and_shapes_are_the_reference(ref):
    assert TR.ASSIGNED == JR.ASSIGNED
    assert D.SHAPES == ref.SHAPES
    assert D.COLLECTIVES == ref.COLLECTIVES


@pytest.mark.parametrize("shape", list(D.SHAPES))
def test_input_specs_equal_reference(ref, shape):
    for arch in TR.ARCHS:
        t = D.input_specs(TR.get_config(arch), shape)
        j = ref.input_specs(JR.get_config(arch), shape)
        assert list(t) == list(j), arch
        for name, spec in t.items():
            assert spec.device.type == "meta"
            assert tuple(spec.shape) == tuple(j[name].shape), (arch, name)
            assert str(spec.dtype).removeprefix("torch.") == j[name].dtype.name, (arch, name)


@pytest.mark.parametrize("analytic", [False, True])
def test_roofline_terms_by_hand(analytic):
    hw = D.HW
    analysis = {"ops": {"bfloat16": hw["flops"]["bfloat16"],
                        "tf32": 2 * hw["flops"]["tf32"]},
                "bytes": 2 * hw["hbm_bw"],
                "collectives": {"by_link": {"nvlink": 0.5 * hw["link_bw"]["nvlink"],
                                            "node": hw["link_bw"]["node"]}}}
    got = D.roofline_terms(analysis, 256, 4 * hw["hbm_bw"] if analytic else None)
    assert got["compute_s"] == pytest.approx(3.0)
    assert got["memory_s"] == pytest.approx(2.0)
    assert got["collective_s"] == pytest.approx(1.5)
    if analytic:
        # the analytic bytes, not the counted ones, decide against compute
        assert got["memory_analytic_s"] == pytest.approx(4.0)
        assert got["bottleneck"] == "memory"
    else:
        assert "memory_analytic_s" not in got
        assert got["bottleneck"] == "compute"


# (mesh, each axis's link) with 8 cards a node in row-major order
AXIS_LINKS = [("16,16", {"data": "node", "model": "node"}),
              ("2,16,16", {"pod": "node", "data": "node", "model": "node"}),
              ("2,8", {"data": "node", "model": "nvlink"}),
              ("2,2,2", {"pod": "nvlink", "data": "nvlink", "model": "nvlink"})]


@pytest.mark.parametrize("spec,links", AXIS_LINKS, ids=[m for m, _ in AXIS_LINKS])
def test_axis_links(spec, links):
    shape = tuple(int(n) for n in spec.split(","))
    mesh = make_train_mesh(spec, devices=["meta"] * int(np.prod(shape)))
    assert D.axis_links(mesh) == links
    # the link each copy is charged to agrees with its axis, at every position
    for i, name in enumerate(mesh.axis_names):
        for pos in mesh.positions():
            peers = [pos[:i] + (k,) + pos[i + 1:] for k in range(shape[i])]
            assert D._link(mesh, pos, peers) == links[name], (name, pos)


def _ref_cell(ref, kind: str, monkeypatch):
    """The reference's compile of TINY's cell on a one-device host mesh:
    (memory numbers, cost numbers)."""
    from repro.launch.mesh import make_host_mesh as jmesh

    for name, info in TINY_SHAPES.items():
        monkeypatch.setitem(ref.SHAPES, name, info)
    shape = next(n for n, i in TINY_SHAPES.items() if i["kind"] == kind)
    fn, args, (in_sh, out_sh) = ref.build_cell(JConfig(**TINY_KW), shape, jmesh(1))
    donate = (0,) if kind == "train" else ((3,) if kind == "decode" else None)
    compiled, _ = ref.lower_compile(fn, args if isinstance(args, tuple) else (args,), in_sh,
                                    out_sh, donate=donate)
    return ref.memory_numbers(compiled), ref.cost_numbers(compiled), shape


# Counted FLOPs over the reference compile's ``cost_analysis`` flops.  XLA
# counts elementwise work too (the count has the matmul formulas and the
# kernels' charged operations) and counts each loop body once: the scan
# over TINY's 2 layers, and in train the 8 microbatches and remat's
# recompute.  Decode 0.735, prefill 1.576, train 10.282 (CHANGES.md).
FLOP_RATIO = {"decode": (0.6, 0.9), "prefill": (1.3, 1.9), "train": (8.0, 13.0)}


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_tiny_counts_against_reference_compile(ref, tiny_shapes, monkeypatch, kind):
    jmem, jcost, shape = _ref_cell(ref, kind, monkeypatch)
    counter, mem = D.count_cell(D.build_cell(TINY, shape, make_host_mesh(devices=["meta"])))
    assert mem["argument_bytes"] == jmem["argument_bytes"], (mem, jmem)
    ratio = counter.flops / jcost["flops"]
    print(f"{kind}: argument bytes {mem['argument_bytes']} (reference {jmem['argument_bytes']}),"
          f" FLOPs {counter.flops:.0f} / reference {jcost['flops']:.0f} = {ratio:.3f}")
    lo, hi = FLOP_RATIO[kind]
    assert lo <= ratio <= hi
    assert mem["temp_bytes"] > 0 and mem["output_bytes"] > 0


def _mesh22():
    return make_train_mesh("2,2", devices=["meta"] * 4)


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_extrapolation_equals_direct_count(tiny_shapes, kind):
    shape = next(n for n, i in TINY_SHAPES.items() if i["kind"] == kind)
    cfg = dataclasses.replace(TINY, n_layers=4)
    mesh = _mesh22()
    got = D.run_analysis(cfg, shape, mesh)
    kw = dict(q_chunk=2048, kv_chunk=2048)
    if kind == "train":
        kw["microbatches"] = 1
    counter, _ = D.count_cell(D.build_cell(cfg, shape, mesh, **kw))
    want = counter.numbers()
    assert got["flops"] == want["flops"] and got["bytes"] == want["bytes"]
    assert got["ops"] == want["ops"]
    assert got["collectives"] == want["collectives"]
    assert want["collectives"]["total"] > 0


def test_cross_pod_compressed_gradient_is_counted(tiny_shapes):
    """On a (pod, data, model) mesh with the compressed cross-pod gradient,
    the count holds one int8 all-reduce of the position's gradient pieces
    (a byte an element and a scale a stacked group) and the err pieces in
    the arguments; without it, neither."""
    from repro_torch.optim import grad_compress

    mesh = make_train_mesh("2,1,2", devices=["meta"] * 4)
    got = {}
    for compress in (False, True):
        cell = D.build_train_cell(TINY, "train_4k", mesh, microbatches=1,
                                  grad_compress=compress)
        counter, _ = D.count_cell(cell)
        got[compress] = (counter.collectives()["all-reduce"], cell.parts["err"])
    pieces = cell.args[0]  # the position's parameter pieces
    assert got[False] == (0, 0)
    assert got[True] == (grad_compress.payload_bytes(pieces), cell.parts["params"] * 2)


@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_cpu_count_equals_meta_count(tiny_shapes, kind):
    shape = next(n for n, i in TINY_SHAPES.items() if i["kind"] == kind)
    counts = {}
    for dev in ("meta", "cpu"):
        mesh = make_train_mesh("2,2", devices=[dev] * 4)
        counts[dev] = D.count_cell(D.build_cell(TINY, shape, mesh, device=dev))
    (cm, mm), (cc, mc) = counts["meta"], counts["cpu"]
    assert cm.rows == cc.rows
    assert cm.copies == cc.copies and cm.kernels == cc.kernels
    assert mm == mc


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_fetch_charge_against_kv_traffic(layout):
    """yi_6b's decode_32k (4 of its layers) on the (16, 16) meta mesh: the
    charged Fetch bytes are ``decode_kv_traffic``'s ``fused_bytes`` plus q,
    the output and the two lengths; for packed and kivi also the words'
    no-straddle padding and less the K scales the reference's model counts
    twice; for huffman less those K scales and plus the two LUTs."""
    cfg = dataclasses.replace(TR.get_config("yi_6b"), cache_layout=layout, n_layers=4)
    shape, chips = "decode_32k", 256
    counter, _ = D.count_cell(D.build_cell(cfg, shape, D.meta_mesh(False)))
    charged = sum(v["bytes"] for k, v in counter.kernels.items() if k.startswith("fused_kv_attn"))
    B = D.SHAPES[shape]["batch"] // 16
    H, Dh, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    G = cfg.n_heads // H
    spec = TM.cache_spec(cfg, D.SHAPES[shape]["seq"])
    T, NB = spec.block_size, spec.n_blocks // 16
    terms = L * (2 * B * H * G * Dh * 4 + 2 * B * 4)
    fused = D.decode_kv_traffic(cfg, shape, chips)["fused_bytes"]
    extra = 0
    if layout in ("packed", "kivi"):
        pad = 4 * (spec.words_k(Dh) + spec.words_v(Dh)) - T * Dh * (spec.bits_k + spec.bits_v) / 8
        extra = L * B * H * NB * (pad - 4 * Dh)
        assert layout == "packed" or pad == 0  # 2-bit codes fill their words
    elif layout == "huffman":
        tile = spec.impl.tile_decode(spec, Dh)
        extra = L * (4 * (tile.book_k.decode_lut().size + tile.book_v.decode_lut().size)
                     - B * H * NB * 4 * Dh)
    assert charged == fused + terms + extra
    assert counter.kernels[next(iter(counter.kernels))]["calls"] == L


def _wrapper_calls(dev):
    """Each kernel wrapper called on small tensors on ``dev``."""
    from repro_torch.core import cache as kvcache
    from repro_torch.kernels import fused_kv_attn, huffman_decode, pack_encode

    cfg = dataclasses.replace(TR.get_smoke_config("yi_6b"), cache_layout="huffman")
    spec = TM.cache_spec(cfg, 64)
    c = kvcache.init_layer_cache(spec, 2, 2, 16, device=dev)
    tile = spec.impl.tile_decode(spec, 16)
    i32 = dict(dtype=torch.int32, device=dev)
    q = torch.zeros((2, 4, 16), device=dev)
    lens = torch.zeros((2,), **i32)
    slots = c.k_store.reshape(-1, c.k_store.shape[-1])
    lut = torch.zeros((256,), **i32)
    walk = (torch.zeros((3, 4), **i32), torch.zeros((3, 8), **i32), torch.zeros((5, 2), **i32),
            torch.zeros((5,), **i32), torch.zeros((5,), **i32))
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "fused_cache_attention": lambda: fused_kv_attn.fused_cache_attention(
            q, c.k_store, c.k_min, c.k_step, c.v_store, c.v_min, c.v_step, c.k_buf, c.v_buf,
            lens, lens, tile=tile, block_size=8),
        "pack_encode": lambda: pack_encode.pack_encode(
            c.k_buf[:, :, None], c.v_buf[:, :, None], lens[:, None], c.k_store, c.k_min,
            c.k_step, c.v_store, c.v_min, c.v_step, bits_k=4, bits_v=4, rel_scale_k=0.1,
            rel_scale_v=0.1, kivi=False),
        "quant_pack": lambda: pack_encode.quant_pack(torch.zeros((3, 8, 16), **f32),
                                                     rel_scale=0.1, bits=4, token_wise=False),
        "huffman_decode": lambda: huffman_decode.huffman_decode(*walk, 2, 8),
        "huffman_attn_scores": lambda: huffman_decode.huffman_attn_scores(
            *walk, torch.zeros((3, 16), **f32), torch.zeros((3, 16), **f32),
            torch.zeros((16,), **f32), 8),
        "huffman_lut_decode": lambda: huffman_decode.huffman_lut_decode(
            slots, lut, block_size=8, head_dim=16, hdr_words=4, probes=1),
        "huffman_lut_decode_kv": lambda: huffman_decode.huffman_lut_decode_kv(
            (slots, lut, None, 4, 1), (slots, lut, None, 4, 1), block_size=8, head_dim=16),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls("meta")))
def test_wrappers_charge_only_under_a_count(name):
    call = _wrapper_calls("meta")[name]
    with pytest.raises(ValueError):
        call()  # a meta tensor outside a count: no launch, no plain version
    before = dict(runtime.launches)
    with D.OpCount() as counter:
        out = call()
    assert runtime.launches == before
    assert sum(k["calls"] for k in counter.kernels.values()) == 1
    assert all(k["bytes"] > 0 for k in counter.kernels.values())
    outs = out if isinstance(out, tuple) else (out,)
    assert all(t is None or t.device.type == "meta" for t in outs)
    with pytest.raises(ValueError):
        call()


def test_count_leaves_nothing_behind(monkeypatch):
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    env = dict(os.environ)
    importlib.reload(D)
    importlib.reload(HP)
    assert dict(os.environ) == env
    monkeypatch.setitem(D.SHAPES, "decode_32k", TINY_SHAPES["decode_32k"])
    cell = D.build_cell(TINY, "decode_32k", _mesh22())

    def boom(counter, *args):
        torch.zeros(3).sum()
        raise RuntimeError("inside the count")

    with pytest.raises(RuntimeError, match="inside the count"):
        D.count_cell(dataclasses.replace(cell, run=boom))
    D.count_cell(cell)
    assert _get_current_dispatch_mode() is None and not runtime.charging()
    assert torch.get_default_dtype() == torch.float32
    assert torch.empty(1).device.type == "cpu"
    assert dict(os.environ) == env


def test_profile_cell_rows_add_up(tiny_shapes, monkeypatch, capsys):
    monkeypatch.setattr(HP.registry, "get_config", lambda name: TINY)
    counter = HP.profile_cell("tiny", "train_4k", top=4)
    out = capsys.readouterr().out
    assert "top copies" in out and "top matmuls" in out
    coll = counter.collectives()
    assert sum(counter.copy_groups().values()) == coll["total"] > 0
    kernel_flops = sum(k["flops"] for k in counter.kernels.values())
    assert sum(counter.matmuls.values()) + kernel_flops == counter.flops > 0


@pytest.mark.parametrize("status", ["ok", "skipped", "failed"])
def test_main_counts_each_status(tiny_shapes, monkeypatch, tmp_path, capsys, status):
    monkeypatch.setattr(D, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(D.registry, "get_config", lambda name: TINY)
    monkeypatch.setattr(D.registry, "canonical", lambda name: name)
    monkeypatch.setattr(D, "meta_mesh", lambda multi_pod: _mesh22())
    if status == "failed":
        def boom(*args, **kw):
            raise RuntimeError("cannot build")

        monkeypatch.setattr(D, "build_cell", boom)
    shape = "long_500k" if status == "skipped" else "decode_32k"
    rc = D.main(["--arch", "tiny", "--shape", shape, "--no-analysis"])
    out = capsys.readouterr().out
    assert rc == (1 if status == "failed" else 0)
    n = {k: int(status == k) for k in ("ok", "skipped", "failed")}
    assert f"done: ok={n['ok']} skipped={n['skipped']} failed={n['failed']}" in out
    rec = json.loads((tmp_path / "pod" / f"tiny__{shape}.json").read_text())
    assert rec["status"] == status
    if status == "failed":
        assert rec["error"] == "RuntimeError: cannot build" and "cannot build" in out
    if status == "ok":
        assert "analysis" not in rec and rec["cost_raw"]["flops"] > 0


def test_run_cell_writes_where_artifacts_points(tiny_shapes, monkeypatch, tmp_path):
    monkeypatch.setattr(D, "ARTIFACTS", tmp_path)
    monkeypatch.setattr(D.registry, "get_config", lambda name: TINY)
    monkeypatch.setattr(D, "meta_mesh", lambda multi_pod: _mesh22())
    before = set(D.Path(D.__file__).resolve().parents[3].joinpath("artifacts").glob(
        "dryrun_torch/**/*tiny*"))
    rec = D.run_cell("tiny", "decode_32k", "pod", force=True)
    assert rec["status"] == "ok", rec.get("error")
    ref_keys = {"arch", "shape", "mesh", "status", "params", "active_params", "lower_s",
                "compile_s", "memory", "cost_raw", "analysis", "analytic_memory_bytes",
                "roofline", "decode_kv_traffic", "model_flops", "hlo_flops_global",
                "useful_flops_ratio"}
    assert ref_keys <= set(rec)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
    assert (tmp_path / "pod" / "tiny__decode_32k.json").exists()
    assert set(D.Path(D.__file__).resolve().parents[3].joinpath("artifacts").glob(
        "dryrun_torch/**/*tiny*")) == before
    skipped = D.run_cell("tiny", "long_500k", "pod", force=True)
    assert skipped["status"] == "skipped" and skipped["reason"].startswith("pure full-attention")
