"""Architecture registry: ``--arch <id>`` -> ModelConfig (+ the reduced smoke
variant), from the port's own ``repro_torch.configs.<id>`` modules."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

# The reference's archs, in its order.  hubert_xlarge (encoder-only) is
# registered with its config; its forward comes with the training slice, and
# the Server refuses it.
ARCHS = [
    "mixtral_8x22b",
    "qwen3_moe_30b_a3b",
    "yi_6b",
    "qwen3_1_7b",
    "command_r_35b",
    "stablelm_12b",
    "chameleon_34b",
    "hubert_xlarge",
    "mamba2_1_3b",
    "zamba2_7b",
    # the paper's own evaluation models
    "llama2_7b",
    "llama2_13b",
    "ministral_8b",
]

# The archs of the production dry run (``launch.dryrun --all``).
ASSIGNED = ARCHS[:10]


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name in ARCHS:
        return name
    raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")


def get_config(name: str) -> ModelConfig:
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}").CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return getattr(mod, "SMOKE", None) or reduced(mod.CONFIG)
