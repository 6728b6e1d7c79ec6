"""Architecture config registry of the port: ``get(arch_id)`` / ``smoke(arch_id)``.

The port serves every family of the JAX package: dense,
Mixture-of-Experts, hybrid, SSM, the vision-language backbone and the
codebook audio decoder. It carries the paper's three models (OPT-30B,
OPT-66B, OPT-175B), so that
the HBM planner (``serving.budget``) can size each of them; tinyllama,
whose GQA and SwiGLU cover the grouped ``silu_mul`` path; deepseek-coder
33B and qwen2 1.5B, dense GQA models (qwen2 with the q/k/v bias and a
tied embedding); minicpm3, whose Multi-head Latent Attention
(``models/mla.py``) caches a 288-wide latent a token a layer instead of
K/V heads; and the two MoE models (``models/moe.py``): qwen2-moe-a2.7b
(60 routed experts top-4 and a shared expert) and qwen3-moe-30b-a3b (128
routed experts top-8); and recurrentgemma-9b, the hybrid family: RG-LRU
recurrent blocks (``models/rglru.py``) and local attention over a
2048-position sliding-window ring, two to one; mamba2-130m, the
attention-free SSM family (Mamba2 SSD blocks, ``models/ssm.py``);
qwen2-vl-2b, qwen2-1.5b's GQA block with M-RoPE over (t, h, w) position
ids and an ``embeds`` input for its stubbed vision frontend; and
musicgen-large, whose 4 parallel codebooks are summed embeddings in and
a [B, S, 4, V] head out. Every file is the port's own copy of the JAX
package's config.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["opt_30b", "opt_66b", "opt_175b", "tinyllama_1_1b",
                       "minicpm3_4b", "deepseek_coder_33b", "qwen2_1_5b",
                       "qwen2_moe_a2_7b", "qwen3_moe_30b_a3b",
                       "recurrentgemma_9b", "mamba2_130m", "qwen2_vl_2b",
                       "musicgen_large"]

# Archs whose stacks handle very long contexts sub-quadratically (the
# reference's long_500k rule: the SSM and the hybrid).
LONG_CTX_ARCHS = {"recurrentgemma_9b", "mamba2_130m"}

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
