"""Architecture registry: ``--arch <id>`` -> ModelConfig (+ the reduced smoke
variant), from the port's own ``repro_torch.configs.<id>`` modules."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

ARCHS = ["yi_6b"]


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
