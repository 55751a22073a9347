"""The port's serving CLI (``python -m repro_torch.launch.serve``), run in
process on the CPU at smoke width: the reference's flags and workload
generator, the throughput line and the stats snapshot, the telemetry files
``--trace-out`` / ``--metrics-out`` write, tokens equal to ``api.serve``
with the same arguments, the blockwise-scan knobs taken, and the options of
later slices refused."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them

from repro_torch import api  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import registry  # noqa: E402

BASE = ["--arch", "yi_6b", "--requests", "3", "--max-slots", "2", "--prompt-len", "32",
        "--new-tokens", "5", "--max-seq", "64", "--device", "cpu"]


def _expected_tokens(layout, prefix_cache, serve_kw, n=3, prompt_len=32, new_tokens=5,
                     arch="yi_6b"):
    """The reference launcher's workload through ``api.serve``."""
    cfg = dataclasses.replace(registry.get_smoke_config(arch), cache_layout=layout)
    params = M.init_params(cfg, seed=0, device="cpu")
    server = api.serve(cfg, params, max_slots=2, max_seq=64, prefix_cache=prefix_cache,
                       device="cpu", **serve_kw)
    rng = np.random.default_rng(0)
    shared = (rng.integers(0, cfg.vocab_size, prompt_len // 2).astype(np.int32)
              if prefix_cache != "off" else np.zeros(0, np.int32))
    handles = []
    for i in range(n):
        plen = max(4, prompt_len - (i * prompt_len // 2) // max(n - 1, 1))
        n_new = max(2, new_tokens - (i * new_tokens // 2) // max(n - 1, 1))
        tail = rng.integers(0, cfg.vocab_size, max(plen - len(shared), 1)).astype(np.int32)
        handles.append(server.submit(api.Request(prompt=np.concatenate([shared, tail]),
                                                 max_new_tokens=n_new)))
    server.run()
    return [h.result().tokens.tolist() for h in handles]


RUNS = {
    "dense": ([], "packed", "off", {"cache_mode": "dense"}),
    "paged prefix traced": (["--layout", "huffman", "--cache-mode", "paged",
                             "--prefix-cache", "on", "--trace", "full"],
                            "huffman", "on", {"cache_mode": "paged"}),
    "faults audited": (["--cache-mode", "paged", "--fault", "reclaim_sweep:0.05",
                        "--audit-every", "2"], "packed", "off", {"cache_mode": "paged"}),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_serves_and_exports(name, tmp_path, capsys):
    argv, layout, pfx, kw = RUNS[name]
    files = []
    if name != "dense":
        files = [tmp_path / "trace.json", tmp_path / "metrics.json"]
        argv = argv + ["--trace-out", str(files[0]), "--metrics-out", str(files[1])]
    results = launch.main(BASE + argv)
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("layout=")]
    assert len(line) == 1 and f"layout={layout}" in line[0]
    assert "throughput=" in line[0] and "tok/s" in line[0] and "kv_cache_bytes=" in line[0]
    assert f"serve[{kw['cache_mode']}]" in out and "req0:" in out
    assert [r.tokens.tolist() for r in results] == _expected_tokens(layout, pfx, kw)
    if name == "paged prefix traced":
        assert "prefix[on]" in out and "trace[full]" in out
        doc = json.loads(files[0].read_text())
        tracks = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
        assert tracks == {"scheduler", "req 0", "req 1", "req 2"}
        assert any(e["name"] == "decode_step" for e in doc["traceEvents"])
    if name == "faults audited":
        snap = json.loads(files[1].read_text())
        assert set(snap) == {"stats", "metrics", "audit", "faults"}
        assert snap["audit"]["clean"] and snap["audit"]["audits"] > 0
        assert snap["faults"]["seed"] == 0 and "reclaim_sweep" in snap["faults"]["visits"]
        # no trace: the trace file is not written
        assert not files[0].exists()
    for f in files[1:]:
        assert f.exists() and f.with_suffix(".prom").read_text().startswith("# TYPE kvcomp_")


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "mixtral_8x22b", "zamba2_7b"])
def test_cli_serves_the_moe_archs(arch, capsys):
    """``--arch`` of the MoE and hybrid families serves at smoke width, with
    the tokens ``api.serve`` gives on the same workload (the hybrid through
    the full-length admission)."""
    argv = [a if a != "yi_6b" else arch for a in BASE]
    results = launch.main(argv)
    out = capsys.readouterr().out
    assert "serve[dense]" in out
    assert ("prefill[solo]" in out) == (arch == "zamba2_7b")
    assert [r.tokens.tolist() for r in results] == _expected_tokens(
        "packed", "off", {"cache_mode": "dense"}, arch=arch)


def test_cli_refuses_the_encoder_only_arch(capsys):
    """``--arch hubert_xlarge`` (encoder-only) is refused before anything is
    served, with the IndexError its first decode step raises in the
    reference."""
    argv = [a if a != "yi_6b" else "hubert_xlarge" for a in BASE]
    with pytest.raises(IndexError, match="encoder-only"):
        launch.main(argv)
    assert "serve[" not in capsys.readouterr().out


@pytest.mark.parametrize("argv,what", [
    (["--mesh", "1,1"], None),
    (["--mesh", "2"], "--mesh wants 'dp,tp' (two integers)"),
])
def test_cli_refuses_options_of_later_slices(argv, what, capsys):
    """``--mesh`` is served now: ``1,1`` is the unsharded path (the dense
    run's tokens, one shard in the stats), and only a malformed spec exits
    2."""
    if what is None:
        results = launch.main(BASE + argv)
        assert "shards: data=1 model=1" in capsys.readouterr().out
        assert [r.tokens.tolist() for r in results] == _expected_tokens(
            "packed", "off", {"cache_mode": "dense"})
        return
    with pytest.raises(SystemExit) as e:
        launch.main(BASE + argv)
    assert e.value.code == 2
    assert what in capsys.readouterr().err


@pytest.mark.parametrize("argv,field,value", [
    (["--span-tokens", "16"], "cache_span_tokens", 16),
    (["--unroll-max", "4"], "cache_unroll_max", 4),
])
def test_cli_takes_the_scan_knobs(argv, field, value, monkeypatch, capsys):
    """``--span-tokens`` and ``--unroll-max`` reach the served config, as in
    the reference's launcher; the span only re-tiles the scan, so the tokens
    are those of the default span."""
    seen = []
    inner = api.serve

    def serve(cfg, *a, **kw):
        seen.append(getattr(cfg, field))
        return inner(cfg, *a, **kw)

    monkeypatch.setattr(launch.api, "serve", serve)
    argv = BASE[:1] + ["yi_6b", "--requests", "2", "--prompt-len", "24", "--new-tokens", "3",
                       "--max-slots", "2", "--max-seq", "64", "--device", "cpu",
                       "--backend", "xla"] + argv
    got = [r.tokens.tolist() for r in launch.main(argv)]
    monkeypatch.setattr(launch.api, "serve", inner)
    assert seen == [value]
    assert got == [r.tokens.tolist() for r in launch.main(argv[:-2])]


def test_quickstart_example_runs_on_the_cpu(capsys):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("done.")
    for layout in ("raw", "packed", "kivi", "huffman"):
        assert f"[{layout:8s}] total_len=203" in out
    # section 3: the Fetch's plain version against the decompress-then-attend
    # baseline, within the bound the reference holds between its backends
    line = next(s for s in out.splitlines() if "fetch plain-vs-materialized max diff:" in s)
    assert float(line.rsplit(":", 1)[1]) <= 5e-3
