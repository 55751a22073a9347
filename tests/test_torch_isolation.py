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
