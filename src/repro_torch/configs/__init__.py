"""Architecture config registry of the port: ``get(arch_id)`` / ``smoke(arch_id)``.

The port serves the dense family. It carries the paper's three models
(OPT-30B, OPT-66B, OPT-175B), so that the HBM planner
(``serving.budget``) can size each of them, and tinyllama, whose GQA and
SwiGLU cover the grouped ``silu_mul`` path. Every file is the port's own
copy of the JAX package's config.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["opt_30b", "opt_66b", "opt_175b", "tinyllama_1_1b"]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(arch: str):
    arch = _ALIAS.get(arch, arch)
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
