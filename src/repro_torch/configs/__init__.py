"""Architecture config registry of the port: ``get(arch_id)`` / ``smoke(arch_id)``.

The port serves the dense family; it carries the paper's own model
(OPT-30B) and tinyllama, whose GQA and SwiGLU cover the grouped
``silu_mul`` path. Both files are the port's own copies of the JAX
package's configs.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["opt_30b", "tinyllama_1_1b"]

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
