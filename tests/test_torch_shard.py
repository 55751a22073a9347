"""Sharded serving of the port (``repro_torch.distributed.serve_shard`` and
``repro_torch.launch.mesh``; DESIGN.md §12), held against the reference on
the CPU:

* ``PagedBlockPool(offset=)`` and ``ShardedPagedPool`` op for op against the
  reference's (pure host code, in process); ``validate_serve_mesh`` raises
  the reference's exception for each bad mesh; ``cache_partition_specs``
  names the reference's split axes for every field of the yi_6b smoke
  decode state, dense and paged.
* The slice as a whole: the port's sharded Server on four logical CPU
  shards (``make_serve_mesh(spec, devices=["cpu"] * 4)``) against the
  reference's sharded Server, which runs in a subprocess with four forced
  host devices.  jax 0.9's ``shard_map`` has no ``check_rep``: the
  subprocess wraps the reference module's ``shard_map`` name with one that
  passes it on as ``check_vma`` (nothing under ``src/repro`` changes).
  Four cases, each equal in tokens, ``stats()`` shards / pool / prefix /
  lifecycle, the event stream without stamps, and the bytes of every
  layer's six store tensors (the port's shards gathered along rows, heads
  and pages).
* Inside the port: sharded == unsharded tokens in all four layouts, dense
  and paged with the prefix cache (and the MoE family under a (2, 1) mesh);
  every row's pages stay in its shard through chunked admission and
  preempt-resume; a 1x1 mesh is the unsharded run, event for event and
  launch for launch, while a (2, 2) mesh launches the Fetch and the Store
  once a shard and a layer; the auditor flags a page of the wrong shard;
  ``--mesh 2,2 --device cpu`` through the CLI; every CUDA launch entry
  takes the card's ordinal.
"""

import dataclasses
import fcntl
import hashlib
import json
import os
import random
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them
jax = pytest.importorskip("jax")

from repro.core import pool as JP  # noqa: E402
from repro.distributed import serve_shard as JSS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import pool as TP  # noqa: E402
from repro_torch.distributed import serve_shard as TSS  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels import pack_encode  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.serve.faults import InvariantAuditor  # noqa: E402
from repro_torch.serve.scheduler import Request, Server, ServerConfig  # noqa: E402
import test_torch_shared as cached  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU4 = ["cpu"] * 4
MAX_SEQ = 96


def _mesh(spec):
    return TMESH.make_serve_mesh(spec, devices=CPU4)


# ---------------------------------------------------------------------------
# The pools, op for op
# ---------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001  (the exception's type is the outcome)
        return ("raise", type(e).__name__)


def test_offset_pool_equals_reference():
    ref, port = JP.PagedBlockPool(5, (16, 8), offset=10), TP.PagedBlockPool(5, (16, 8), offset=10)
    for pool in (ref, port):
        assert [pool.owns(p) for p in (9, 10, 14, 15)] == [False, True, True, False]
    a, b = ref.alloc(3), port.alloc(3)
    assert a == b and all(10 <= p < 15 for p in a)
    ref.retain(a[:1]), port.retain(b[:1])
    assert ref.release(a) == port.release(b)
    assert ref.stats() == port.stats()
    assert _outcome(lambda: ref.alloc(6)) == _outcome(lambda: port.alloc(6)) == (
        "raise", "PoolExhausted")
    for make in (JP.PagedBlockPool, TP.PagedBlockPool):
        with pytest.raises(ValueError, match="offset"):
            make(4, (8,), offset=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_pool_equals_reference_op_for_op(seed):
    """A seeded run of alloc by shard, retain, release and alloc past one
    shard's end: every result, exception and count equal."""
    rng = random.Random(seed)
    ref = JSS.ShardedPagedPool(12, (8, 4), n_shards=3)
    port = TSS.ShardedPagedPool(12, (8, 4), n_shards=3)
    live: list[int] = []
    exhausted = 0
    for _ in range(300):
        op = rng.random()
        if op < 0.45:
            shard, n = rng.randrange(3), rng.randrange(1, 3)
            got = _outcome(lambda: port.alloc(n, shard=shard))
            assert got == _outcome(lambda: ref.alloc(n, shard=shard))
            if got[0] == "ok":
                live += got[1]
            else:
                exhausted += 1
        elif op < 0.65 and live:
            p = rng.choice(live)
            ref.retain([p]), port.retain([p])
            live.append(p)
        elif live:
            p = live.pop(rng.randrange(len(live)))
            assert port.release([p]) == ref.release([p])
        assert port.free_pages == ref.free_pages == sum(s.free_pages for s in port.shards)
        assert port.live_pages == ref.live_pages and port.high_water == ref.high_water
        assert port.stats() == ref.stats() and port.shard_stats() == ref.shard_stats()
        assert [port.shard_of(p) for p in live] == [ref.shard_of(p) for p in live]
        assert [port.refcount(p) for p in live] == [ref.refcount(p) for p in live]
    assert exhausted > 0
    for make in (JSS.ShardedPagedPool, TSS.ShardedPagedPool):
        with pytest.raises(ValueError):
            make(7, (8,), n_shards=2)


# ---------------------------------------------------------------------------
# Mesh validation and partition specs
# ---------------------------------------------------------------------------


def test_make_serve_mesh():
    assert TMESH.make_serve_mesh(None) is None and TMESH.make_serve_mesh("1,1") is None
    m = TMESH.make_serve_mesh("2,2", devices=CPU4)
    assert m.axis_names == ("data", "model") and m.shape == {"data": 2, "model": 2}
    assert m.devices.shape == (2, 2) and all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(ValueError, match="two integers"):
        TMESH.make_serve_mesh("2", devices=CPU4)
    with pytest.raises(ValueError, match=">= 1"):
        TMESH.make_serve_mesh("0,2", devices=CPU4)
    with pytest.raises(RuntimeError, match="needs 4 devices but only 3 exist"):
        TMESH.make_serve_mesh("2,2", devices=CPU4[:3])
    assert TMESH.make_host_mesh(devices=CPU4).shape == {"data": 1, "model": 4}
    assert TMESH.make_host_mesh(devices=["cpu"] * 6).shape == {"data": 3, "model": 2}


def _cfgs():
    yi = TR.get_smoke_config("yi_6b")
    return {"yi": (JR.get_smoke_config("yi_6b"), yi),
            "mamba2": (JR.get_smoke_config("mamba2_1_3b"), TR.get_smoke_config("mamba2_1_3b"))}


@pytest.mark.parametrize("case", [
    ("yi", "1,4", 4), ("yi", "2,2", 3), ("yi", "pod", 4), ("mamba2", "2,1", 4),
    ("yi", "2,2", 4), ("yi", "4,1", 4), ("yi", "2,1", 2)])
def test_validate_serve_mesh_equals_reference(case):
    """The same exception type, and the same message but for the name of the
    module that builds meshes, for each bad mesh; the same counts for a good
    one."""
    name, spec, slots = case
    jcfg, tcfg = _cfgs()[name]
    mesh = (TMESH.Mesh(np.array([torch.device("cpu")] * 4, dtype=object), ("pod",))
            if spec == "pod" else _mesh(spec))
    ref = _outcome(lambda: JSS.validate_serve_mesh(mesh, jcfg, slots))
    got = _outcome(lambda: TSS.validate_serve_mesh(mesh, tcfg, slots))
    assert got == ref
    if ref[0] == "raise":
        msgs = []
        for fn, cfg in ((JSS.validate_serve_mesh, jcfg), (TSS.validate_serve_mesh, tcfg)):
            with pytest.raises(ValueError) as e:
                fn(mesh, cfg, slots)
            msgs.append(str(e.value).replace("repro_torch.", "repro."))
        assert msgs[0] == msgs[1]


def _ref_axes(p, lead: int) -> dict:
    entries = list(p) + [None] * 8
    ax = {"data": None, "model": None}
    for i, e in enumerate(entries):
        e = e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e
        if e in ax:
            ax[e] = i - lead
    return ax


@pytest.mark.parametrize("mode,pages", [("dense", 0), ("paged", 24), ("paged", 25)])
@pytest.mark.parametrize("spec", ["2,2", "4,1", "1,2"])
def test_partition_specs_equal_reference(mode, pages, spec):
    """For every field of the yi_6b smoke decode state: the axis "data" and
    "model" split, or none, as the reference's ``cache_partition_specs``
    (read through a mesh of the port's: it reads only the axis names and
    the shape)."""
    jcfg = dataclasses.replace(JR.get_smoke_config("yi_6b"), cache_mode=mode)
    tcfg = dataclasses.replace(TR.get_smoke_config("yi_6b"), cache_mode=mode)
    mesh = _mesh(spec)
    jc = JM.init_decode_state(jcfg, 4, MAX_SEQ, pool_pages=pages)["kv"]
    tc = TM.init_decode_state(tcfg, 4, MAX_SEQ, device="cpu", pool_pages=pages)["kv"][0]
    ref = JSS.cache_partition_specs(jc, mesh)
    got = TSS.cache_partition_specs(tc, mesh)
    want = {f: _ref_axes(getattr(ref, f), jc.n_flushed.ndim - 1) for f in jc._FIELDS}
    assert got == want
    if mode == "paged" and pages % mesh.shape["data"] == 0:
        assert got["k_store"]["data"] == 2 and got["page_tab"]["data"] == 0


# ---------------------------------------------------------------------------
# The slice as a whole, against the reference's sharded Server
# ---------------------------------------------------------------------------

# The workload of the reference's sharded parity tests: prompts of 36, 28,
# 22 and 18 tokens with a 16-token shared prefix, budgets 7, 6, 4 and 3.
LENS_NEWS = ((36, 7), (28, 6), (22, 4), (18, 3))

# case -> (mesh, layout, Server keywords); "pool_pages" sizes the pool in
# pages (12 pages, 6 a shard: shard 1 preempts once, shard 0 never).
CASES = {
    "dense packed": ("2,2", "packed", {}),
    "paged prefix": ("2,2", "packed", {"cache_mode": "paged", "prefix_cache": "on"}),
    "paged preempt": ("2,1", "packed", {"cache_mode": "paged", "pool_pages": 12}),
    "dense huffman": ("2,2", "huffman", {}),
}

_REF_PROG = """
import dataclasses, hashlib, json, sys
import numpy as np
import jax
import repro.distributed.serve_shard as serve_shard
from repro import api
from repro.core import pool as JP
from repro.models import model as M, registry
from repro.launch.mesh import make_serve_mesh


def _shard_map(f, *args, check_rep=None, **kw):
    # jax 0.9 renamed shard_map's check_rep to check_vma.
    if check_rep is not None:
        kw["check_vma"] = check_rep
    return jax.shard_map(f, *args, **kw)


serve_shard.shard_map = _shard_map
weights, cases, work = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
cfg0 = registry.get_smoke_config("yi_6b")
npz = np.load(weights)
params = jax.tree_util.tree_map_with_path(
    lambda path, s: jax.numpy.asarray(npz[jax.tree_util.keystr(path)]),
    jax.eval_shape(lambda k: M.init_params(cfg0, k)[0], jax.random.PRNGKey(0)))
work = [(np.asarray(p, np.int32), n) for p, n in work]
out = {}
for name, (spec, layout, extra) in cases.items():
    cfg = dataclasses.replace(cfg0, cache_layout=layout)
    extra = dict(extra)
    if "pool_pages" in extra:
        page_b = sum(JP.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim)
                     for s in M.cache_specs(cfg, 96))
        extra["pool_hbm_bytes"] = extra.pop("pool_pages") * page_b
    server = api.serve(cfg, params, max_slots=4, max_seq=96, q_chunk=32, kv_chunk=32,
                       mesh=make_serve_mesh(spec), trace="events", **extra)
    hs = [server.submit(api.Request(prompt=p, max_new_tokens=n)) for p, n in work]
    server.run()
    st = server.stats()
    kv = server.state["kv"]
    out[name] = {
        "tokens": [h.result().tokens.tolist() for h in hs],
        "stats": {k: st.get(k) for k in ("shards", "pool", "prefix", "lifecycle")},
        "events": [[e.kind, e.req, e.step, {k: v for k, v in e.data.items() if k != "dur"}]
                   for e in server.trace.events],
        "arena": {f: [hashlib.sha256(np.asarray(a).tobytes()).hexdigest()
                      for a in np.asarray(getattr(kv, f))]
                  for f in ("k_store", "k_min", "k_step", "v_store", "v_min", "v_step")},
    }
print(json.dumps(out, default=lambda o: o.item() if hasattr(o, "item") else list(o)))
"""


def _workload(vocab: int):
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, 16).astype(np.int32)
    return [(np.concatenate([shared, rng.integers(0, vocab, n - 16).astype(np.int32)]), k)
            for n, k in LENS_NEWS]


def _jsonable(x):
    return json.loads(json.dumps(x, default=lambda o: o.item() if hasattr(o, "item") else list(o)))


def _serve(tcfg, tp, layout, extra, mesh, work, step_hook=None):
    """The port's Server on one case's workload, trace "events", auditing
    every step."""
    cfg = dataclasses.replace(tcfg, cache_layout=layout)
    extra = dict(extra)
    if "pool_pages" in extra:
        page_b = sum(TP.page_nbytes(s, cfg.n_kv_heads, cfg.resolved_head_dim)
                     for s in TM.cache_specs(cfg, MAX_SEQ))
        extra["pool_hbm_bytes"] = extra.pop("pool_pages") * page_b
    server = Server(cfg, tp, ServerConfig(max_slots=4, max_seq=MAX_SEQ, mesh=mesh,
                                          trace="events", audit_every=1, **extra),
                    device="cpu", q_chunk=32)
    hs = [server.submit(Request(prompt=p, max_new_tokens=n)) for p, n in work]
    while server.step():
        if step_hook is not None:
            step_hook(server)
    return server, [h.result().tokens.tolist() for h in hs]


def _summary(server, tokens) -> dict:
    st = server.stats()
    kv = (TSS.gather_state(server.state) if server.mesh is not None else server.state)["kv"]

    def digest(t):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return hashlib.sha256(t.numpy().tobytes()).hexdigest()

    return _jsonable({
        "tokens": tokens,
        "stats": {k: st.get(k) for k in ("shards", "pool", "prefix", "lifecycle")},
        "events": [[e.kind, e.req, e.step, {k: v for k, v in e.data.items() if k != "dur"}]
                   for e in server.trace.events],
        "arena": {f: [digest(getattr(c, f)) for c in kv] for f in TP.STORE_FIELDS},
    })


@pytest.fixture(scope="module")
def model():
    """The yi_6b smoke model's weights, numpy-filled (``np_params``): the
    reference's tree and the port's."""
    jcfg = JR.get_smoke_config("yi_6b")
    jp = cached.np_params(jcfg, 0)
    return jp, TR.get_smoke_config("yi_6b"), params_from_jax(jp, jcfg, "cpu")


def _ref_root(tmp_path_factory) -> Path:
    """One directory per test run: the xdist workers' shared parent, or the
    run's own base directory."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


@pytest.fixture(scope="module")
def shard_runs(model, tmp_path_factory):
    """Per case: the reference's sharded Server (one subprocess a test run,
    shared by the xdist workers through a file lock) and the port's, which
    runs while the subprocess does."""
    jp, tcfg, tp = model
    work = _workload(tcfg.vocab_size)
    root = _ref_root(tmp_path_factory)
    out = root / "torch_shard_reference.json"
    with open(root / "torch_shard_reference.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = None
        if not out.exists():
            weights = root / "torch_shard_weights.npz"
            flat = jax.tree_util.tree_flatten_with_path(jp)[0]
            np.savez(weights, **{jax.tree_util.keystr(k): v for k, v in flat})
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                       XLA_FLAGS="--xla_force_host_platform_device_count=4")
            proc = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(_REF_PROG), str(weights),
                 json.dumps(CASES), json.dumps([(p.tolist(), n) for p, n in work])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        try:
            port = {name: _summary(*_serve(tcfg, tp, layout, extra, _mesh(spec), work))
                    for name, (spec, layout, extra) in CASES.items()}
            if proc is not None:
                stdout, stderr = proc.communicate(timeout=900)
                assert proc.returncode == 0, stderr[-3000:]
                out.write_text(stdout.strip().splitlines()[-1])
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return json.loads(out.read_text()), port


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_server_equals_reference(shard_runs, name):
    ref, port = shard_runs[0][name], shard_runs[1][name]
    assert port["tokens"] == ref["tokens"]
    assert port["stats"] == ref["stats"]
    assert port["events"] == ref["events"]
    assert port["arena"] == ref["arena"]
    shards = port["stats"]["shards"]
    assert (shards["n_data"], shards["n_model"]) == tuple(
        int(x) for x in CASES[name][0].split(","))
    if name == "paged prefix":
        assert port["stats"]["prefix"]["hits"] > 0
    if name == "paged preempt":
        assert [s["preemptions"] for s in shards["per_shard"]] == [0, 1]


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "paged prefix"])
@pytest.mark.parametrize("layout", ["raw", "packed", "kivi", "huffman"])
def test_sharded_equals_unsharded(model, layout, mode):
    _, tcfg, tp = model
    work = _workload(tcfg.vocab_size)
    extra = {"cache_mode": "paged", "prefix_cache": "on"} if mode != "dense" else {}
    _, base = _serve(tcfg, tp, layout, extra, None, work)
    server, got = _serve(tcfg, tp, layout, extra, _mesh("2,2"), work)
    assert got == base
    assert len(server.state["kv"][0].caches()) == 4


def test_moe_sharded_equals_unsharded():
    """qwen3_moe under a (2, 1) mesh: its routing runs over the whole batch
    on the home device, so the tokens are the unsharded port's."""
    cfg = TR.get_smoke_config("qwen3_moe_30b_a3b")
    tp = TM.init_params(cfg, seed=0, device="cpu")
    work = _workload(cfg.vocab_size)
    _, base = _serve(cfg, tp, "packed", {}, None, work)
    _, got = _serve(cfg, tp, "packed", {}, _mesh("2,1"), work)
    assert got == base


def test_pages_stay_in_their_shard(model):
    """Chunked admission one block a step in a pool that preempts: at every
    step each row's pages (host mirror) lie in its data shard's range and
    each shard's device tables, read in global ids, mirror the host (the
    auditor, every step), through a preemption and the resume."""
    _, tcfg, tp = model
    work = _workload(tcfg.vocab_size)
    seen = {"prefilling": 0, "pages": 0}

    def hook(server):
        seen["prefilling"] += server.prefilling
        for row in range(4):
            own = server.pool.shards[server._row_shard(row)]
            pages = [int(p) for p in server._pt_host[row] if p >= 0]
            seen["pages"] += len(pages)
            assert all(own.owns(p) for p in pages), (row, pages)

    extra = {"cache_mode": "paged", "pool_pages": 12, "prefill_chunk_tokens": 8}
    server, got = _serve(tcfg, tp, "packed", extra, _mesh("2,1"), work, hook)
    _, base = _serve(tcfg, tp, "packed", extra, None, work)
    assert got == base
    assert server.preemptions >= 1 and server.stats()["lifecycle"]["requeues"] >= 1
    assert seen["prefilling"] > 0 and seen["pages"] > 0
    assert server.auditor.report()["clean"] and server.auditor.audits > 0


def _count_launches(monkeypatch) -> dict:
    """Count the Fetch and Store wrapper calls (their plain versions on the
    CPU)."""
    n = {"fetch": 0, "store": 0}
    fetch, store = kernel_ops.fused_cache_attention, pack_encode.pack_encode

    def counted_fetch(*a, **k):
        n["fetch"] += 1
        return fetch(*a, **k)

    def counted_store(*a, **k):
        n["store"] += 1
        return store(*a, **k)

    monkeypatch.setattr(kernel_ops, "fused_cache_attention", counted_fetch)
    monkeypatch.setattr(pack_encode, "pack_encode", counted_store)
    return n


def test_trivial_mesh_is_the_unsharded_run(model, monkeypatch):
    """A 1x1 mesh serves as no mesh: the same events and the same Fetch and
    Store calls.  A (2, 2) mesh makes each layer's pure decode step call
    each once a shard."""
    _, tcfg, tp = model
    n = _count_launches(monkeypatch)
    work = _workload(tcfg.vocab_size)
    runs = []
    for mesh in (None, TMESH.make_host_mesh(devices=["cpu"])):
        n.update(fetch=0, store=0)
        server, toks = _serve(dataclasses.replace(tcfg, attn_backend="fused"), tp, "packed",
                              {}, mesh, work)
        assert server.mesh is None
        runs.append((_summary(server, toks), dict(n)))
    assert runs[0] == runs[1] and runs[0][1]["fetch"] > 0

    cfg = dataclasses.replace(tcfg, attn_backend="fused")
    server = Server(cfg, tp, ServerConfig(max_slots=4, max_seq=MAX_SEQ, mesh=_mesh("2,2")),
                    device="cpu")
    for p, k in work:
        server.submit(Request(prompt=p, max_new_tokens=k))
    while server.prefilling or server.pending or not server.active:
        server.step()
    n.update(fetch=0, store=0)
    server.step()  # a pure decode step: no admission, no chunk
    assert n == {"fetch": 4 * cfg.n_layers, "store": 4 * cfg.n_layers}


def test_auditor_flags_a_page_of_the_wrong_shard(model):
    _, tcfg, tp = model
    cfg = dataclasses.replace(tcfg, cache_mode="paged")
    server = Server(cfg, tp, ServerConfig(max_slots=4, max_seq=MAX_SEQ, mesh=_mesh("2,1")),
                    device="cpu")
    for p, k in _workload(cfg.vocab_size):
        server.submit(Request(prompt=p, max_new_tokens=k))
    while not server.active:
        server.step()
    auditor = InvariantAuditor(server)
    assert auditor.audit() == []
    row = next(r for r in range(2) if server._slots[r] is not None)
    slot = int(np.flatnonzero(server._pt_host[row] >= 0)[0])
    server.pool.release([int(server._pt_host[row, slot])])
    server._pt_host[row, slot] = server.pool.alloc(1, shard=1)[0]
    bad = auditor.audit()
    assert any(f"row {row} (shard 0) references foreign page" in v for v in bad), bad
    assert not auditor.report()["clean"]


def test_cli_serves_a_mesh_on_the_cpu(capsys):
    """``--mesh 2,2 --device cpu``: four CPU shards, the unsharded tokens."""
    base = ["--arch", "yi_6b", "--requests", "4", "--max-slots", "4", "--prompt-len", "32",
            "--new-tokens", "4", "--max-seq", "64", "--device", "cpu",
            "--cache-mode", "paged"]
    unsharded = [r.tokens.tolist() for r in launch.main(base)]
    first = capsys.readouterr().out
    sharded = [r.tokens.tolist() for r in launch.main(base + ["--mesh", "2,2"])]
    out = capsys.readouterr().out
    assert sharded == unsharded
    assert "shards: data=2 model=2 s0:" in out and "shards: data=1 model=1" in first
    kv_bytes = [re.search(r"kv_cache_bytes=([\d,]+)", o).group(1) for o in (first, out)]
    assert kv_bytes[0] == kv_bytes[1]


def test_every_launch_entry_takes_the_card():
    """Each ``extern "C"`` launch entry of the kernel libraries ends with
    ``int device, void* stream`` and selects the card before anything else,
    and its wrapper declares as many ctypes arguments as the entry has."""
    from repro_torch.kernels import fused_kv_attn, huffman_decode

    declared = {"fused_kv_attn_launch": fused_kv_attn._ARGTYPES,
                "pack_encode_launch": pack_encode._ARGTYPES,
                "huffman_decode_launch": huffman_decode._WALK_ARGTYPES,
                "huffman_attn_scores_launch": huffman_decode._SCORES_ARGTYPES,
                "huffman_lut_decode_launch": huffman_decode._LUT_ARGTYPES}
    found = {}
    for src in sorted((ROOT / "src/repro_torch/csrc").glob("*.cu")):
        text = src.read_text().split('extern "C" {', 1)[1]
        for m in re.finditer(r"\nint (\w+_launch)\(([^)]*)\)\s*\{\s*\n\s*(.*)\n", text):
            name, params, first = m.groups()
            params = [p.strip() for p in params.split(",")]
            assert params[-2:] == ["int device", "void* stream"], (name, params[-2:])
            assert first.startswith("const cudaError_t dev_err = cudaSetDevice(device);"), name
            found[name] = len(params)
    assert found == {k: len(v) for k, v in declared.items()}
