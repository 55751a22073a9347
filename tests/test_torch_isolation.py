"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the reference package, and nothing beyond the
standard library and the packages the card machine has (torch, numpy,
scipy, einops; triton inside the functions that launch a kernel);
importing every module of the port leaves ``jax`` out of ``sys.modules``,
and ``chip_smoke.py`` fails without a card (and in a directory holding
nothing else of the repo)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the cores; intra-op threads only oversubscribe them

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


# What the card machine has besides the standard library, and the port itself.
CARD_PACKAGES = {"torch", "numpy", "scipy", "einops", "triton", "repro_torch"}


def _imports(tree):
    """(top-level module name, at module level?) of every absolute import."""
    top = set(id(n) for n in tree.body)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], id(node) in top


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_only_what_the_card_machine_has(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for name, at_top in _imports(tree):
        if name in sys.stdlib_module_names or name == "__future__":
            continue
        if name not in CARD_PACKAGES or (name == "triton" and at_top):
            bad.append(name)
    assert not bad, f"{path}: imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  for p in PORT.rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card here: the script exits non-zero and prints no result; alone
    in a directory it fails too."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for script, cwd in ((ROOT / "chip_smoke.py", ROOT), (lone, tmp_path)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120, env=_env() if cwd == ROOT else None)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# The sharded-training slice's modules and names: each lives in a file the
# two checks above parse, and importing it loads no JAX (the subprocess
# above imports every module of the port).
SHARDED_TRAINING = [
    ("repro_torch.distributed.sharding", ("Rules", "train_rules", "serve_rules", "data_axes",
                                          "spec_for_axes", "make_param_shardings",
                                          "batch_sharding", "replicated", "cache_shardings",
                                          "P", "NamedSharding", "abstract_mesh", "Sharded",
                                          "place", "gather", "accumulate")),
    ("repro_torch.launch.mesh", ("make_production_mesh", "make_host_mesh", "make_train_mesh")),
    ("repro_torch.train.step", ("shapes_and_axes", "build_train_artifacts",
                                "_cross_pod_compressed_allreduce", "build_serve_artifacts")),
    ("repro_torch.models.model", ("param_axes",)),
]


@pytest.mark.parametrize("module,names", SHARDED_TRAINING, ids=lambda x: x if isinstance(x, str)
                         else None)
def test_sharded_training_names_are_covered(module, names):
    import importlib

    mod = importlib.import_module(module)
    assert Path(mod.__file__).resolve() in {p.resolve() for p in SOURCES}
    assert all(callable(getattr(mod, n)) for n in names)


# The reference's public surface, name for name.  Every public name of every
# module of src/repro (top-level functions, classes and assigned names, and
# the public methods and properties of its public classes) is in the port's
# module of the same path, or mapped here to the port name that does its
# work, or listed as JAX-only with the reason.  Both packages are read with
# ``ast``: importing the reference's modules could change XLA's flags.
REF = ROOT / "src" / "repro"

SURFACE_MAP = {  # (reference module, name) -> (port module, name)
    ("core/huffman.py", "decode_block_jax"): ("core/huffman.py", "decode_block_torch"),
    ("core/huffman.py", "decode_block_lut_jax"): ("core/huffman.py", "decode_block_lut_torch"),
    ("core/huffman.py", "encode_block_jax"): ("core/huffman.py", "encode_block_torch"),
    ("core/huffman.py", "walk_decode_jax"): ("core/huffman.py", "walk_decode_torch"),
    ("kernels/ops.py", "fused_cache_attention"): ("kernels/fused_kv_attn.py",
                                                  "fused_cache_attention"),
    ("kernels/ops.py", "quant_pack"): ("kernels/pack_encode.py", "quant_pack"),
    # a Pallas kernel's entry point -> the wrapper of its CUDA kernel
    ("kernels/fused_kv_attn.py", "fused_cache_attention_pallas"): ("kernels/fused_kv_attn.py",
                                                                   "fused_cache_attention"),
    ("kernels/pack_encode.py", "quant_pack_pallas"): ("kernels/pack_encode.py", "quant_pack"),
    ("kernels/huffman_decode.py", "huffman_decode_pallas"): ("kernels/huffman_decode.py",
                                                             "huffman_decode"),
    ("kernels/huffman_decode.py", "huffman_attn_scores_pallas"): ("kernels/huffman_decode.py",
                                                                  "huffman_attn_scores"),
}

_PYTREE = "a JAX pytree hook; the port's containers are plain dataclasses"
_XLA = "an analysis of XLA's compiled HLO; the port's dry run counts on the meta device"
JAX_ONLY = {  # (reference module or "*", name or "*.method") -> why the port has none
    ("*", "Array"): "the jax.Array alias; the port annotates torch.Tensor",
    ("*", "*.tree_flatten"): _PYTREE,
    ("*", "*.tree_flatten_with_keys"): _PYTREE,
    ("*", "*.tree_unflatten"): _PYTREE,
    ("core/cache.py", "LayerKVCache.with_spec"): "rewrites the static spec of a pytree's views "
                                                 "for GSPMD shards; the port's serve_shard "
                                                 "builds each shard's cache itself",
    ("kernels/runtime.py", "on_tpu"): "asks JAX for its backend; the port goes by the "
                                      "tensor's device",
    ("kernels/runtime.py", "resolve_impl"): "picks Pallas or XLA for impl=; the port's "
                                            "wrappers pick by device and take no impl",
    ("kernels/runtime.py", "resolve_interpret"): "Pallas interpret mode; a CUDA kernel has "
                                                 "none, the CPU runs its plain version",
    ("launch/dryrun.py", "lower_compile"): _XLA,
    ("launch/dryrun.py", "cost_numbers"): _XLA,
    ("launch/dryrun.py", "memory_numbers"): _XLA,
    ("launch/dryrun.py", "parse_collective_bytes"): _XLA,
    ("launch/dryrun.py", "DTYPE_BYTES"): _XLA,
    ("distributed/sharding.py", "HAS_AXIS_TYPES"): "probes jax.sharding for AxisType",
    ("distributed/sharding.py", "constrain"): "a GSPMD sharding constraint; the port places "
                                              "its Sharded pieces itself",
    ("distributed/sharding.py", "make_mesh"): "jax.make_mesh; the port's meshes come from "
                                              "launch/mesh.py",
    ("distributed/sharding.py", "set_ambient_mesh"): "the ambient mesh that constrain reads",
    ("distributed/serve_shard.py", "constrain_state"): "GSPMD constraints on a state tree "
                                                       "inside jit",
    ("distributed/serve_shard.py", "decode_state_shardings"): "NamedShardings to device_put a "
                                                              "state; the port's "
                                                              "ShardedLayerCache holds the "
                                                              "shards",
    ("distributed/serve_shard.py", "override_backend"): "rewrites the static spec of a jitted "
                                                        "state; a ShardedLayerCache keeps its "
                                                        "inner backend",
    ("train/step.py", "shape_of"): "jax.ShapeDtypeStruct trees; the port's shapes are meta "
                                   "tensors",
    ("models/attention.py", "init_attn_block"): "splits JAX PRNG keys; the port draws every "
                                                "weight from one torch.Generator, whose order "
                                                "fixes the seeded weights",
}


def _public_names(path: Path) -> set:
    """Public top-level names of a module, and ``Class.member`` for the
    public methods and properties of its public classes, members inherited
    from a class of the same module included."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            found = [node.name]
        elif isinstance(node, ast.Assign):
            found = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            found = [node.target.id]
        else:
            found = []
        names.update(n for n in found if not n.startswith("_"))
        if isinstance(node, ast.ClassDef):
            classes[node.name] = node

    def members(cls) -> set:
        own = {m.name for m in cls.body if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
               and not m.name.startswith("_")}
        for base in cls.bases:
            if isinstance(base, ast.Name) and base.id in classes:
                own |= members(classes[base.id])
        return own

    for name, cls in classes.items():
        if not name.startswith("_"):
            names |= {f"{name}.{m}" for m in members(cls)}
    return names


def _jax_only(module: str, name: str) -> bool:
    method = "*." + name.split(".")[-1] if "." in name else None
    return any(key in JAX_ONLY for key in ((module, name), ("*", name), ("*", method)))


def test_reference_public_surface_is_covered():
    missing, stale = [], []
    for path in sorted(REF.rglob("*.py")):
        module = path.relative_to(REF).as_posix()
        port = PORT / module
        have = _public_names(port) if port.exists() else set()
        for name in sorted(_public_names(path)):
            if name in have or _jax_only(module, name):
                continue
            target = SURFACE_MAP.get((module, name))
            if target is None:
                missing.append(f"{module}:{name}")
            elif target[1] not in _public_names(PORT / target[0]):
                stale.append(f"{module}:{name} -> {target} (not in the port)")
    # every specific entry still names a reference name the port lacks
    for module, name in [*SURFACE_MAP, *(k for k in JAX_ONLY if k[0] != "*")]:
        if name not in _public_names(REF / module):
            stale.append(f"{module}:{name} (not in the reference)")
        elif name in _public_names(PORT / module):
            stale.append(f"{module}:{name} (the port has it under its own name)")
    assert not missing, f"reference names the port lacks: {missing}"
    assert not stale, stale
