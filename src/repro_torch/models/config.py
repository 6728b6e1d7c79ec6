"""Generic model configuration covering all assigned architecture families.

One dataclass; each ``repro/configs/<arch>.py`` instantiates it with the
published numbers. Family selects the block assembly in ``transformer.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | hybrid | ssm | moe | vlm | audio
    n_layers: int
    d_model: int
    vocab: int

    # attention
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_kind: str = "gqa"           # gqa | mla | none
    local_window: Optional[int] = None   # sliding-window size (local attn)
    # hybrid pattern: block types per layer, cycled (e.g. ("rglru","rglru","attn"))
    layer_pattern: Optional[Tuple[str, ...]] = None

    # MLP
    d_ff: int = 0
    mlp_kind: str = "swiglu"         # swiglu | gelu
    mlp_bias: bool = False

    # MLA (minicpm3 / deepseek-v2 style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_routed_experts: int = 0
    top_k: int = 0
    d_expert: int = 0                # per-expert FFN hidden
    n_shared_experts: int = 0
    d_shared_expert: int = 0
    capacity_factor: float = 1.25
    moe_subgroup: int = 256          # tokens per dispatch subgroup

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # RG-LRU (recurrentgemma)
    rnn_width: int = 0               # d_rnn (lru width); 0 -> d_model
    rglru_conv: int = 4

    # VLM / audio frontends (stubs per assignment)
    mrope_sections: Optional[Tuple[int, int, int]] = None
    n_codebooks: int = 0             # musicgen: parallel EnCodec streams

    # head / embedding
    tie_embeddings: bool = False
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm

    # execution
    dtype: str = "bfloat16"
    remat: str = "none"              # none | full | dots
    scan_layers: bool = True
    # flash-style q-chunked attention: bounds the materialized score block
    # to [B, H, attn_q_chunk, S] per scan step (recomputed in backward);
    # 0 disables (full S x S scores — the naive baseline).
    attn_q_chunk: int = 512

    # sparsity (the paper's technique; None = dense baseline)
    sparsity: Optional[float] = None
    sparsity_balanced: bool = False  # tile-balanced pruning (beyond-paper)

    # ---- derived ------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def rnn_dim(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def layer_kind(self, i: int) -> str:
        """Block type of layer i (family default or explicit pattern)."""
        if self.layer_pattern:
            return self.layer_pattern[i % len(self.layer_pattern)]
        if self.family == "ssm":
            return "ssm"
        return "attn"

    @property
    def uniform_layers(self) -> bool:
        return self.layer_pattern is None or len(set(self.layer_pattern)) == 1

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d = self.d_model
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.n_codebooks:
            emb = self.n_codebooks * self.vocab * d * 2
        per_layer = 0
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.attn_kind == "mla":
                    hd = self.qk_nope_dim + self.qk_rope_dim
                    per = (d * self.q_lora_rank
                           + self.q_lora_rank * self.n_heads * hd
                           + d * (self.kv_lora_rank + self.qk_rope_dim)
                           + self.kv_lora_rank * self.n_heads
                           * (self.qk_nope_dim + self.v_head_dim)
                           + self.n_heads * self.v_head_dim * d)
                else:
                    per = d * self.head_dim * (self.n_heads + 2 * self.n_kv) \
                        + self.n_heads * self.head_dim * d
                per_layer += per
            elif kind == "ssm":
                din = self.ssm_inner
                h = self.ssm_heads
                per_layer += (d * (2 * din + 2 * self.ssm_state + h)  # in_proj
                              + din * d)                               # out_proj
            elif kind == "rglru":
                r = self.rnn_dim
                per_layer += 2 * d * r + r * d + 3 * r  # x/gate proj, out, gates
            # MLP part
            if self.n_routed_experts and kind != "rglru":
                per_layer += self.n_routed_experts * 3 * d * self.d_expert
                per_layer += d * self.n_routed_experts  # router
                if self.n_shared_experts:
                    per_layer += (3 * d * self.d_shared_expert
                                  * self.n_shared_experts)
            elif kind in ("attn",) or (kind == "ssm" and self.d_ff):
                mult = 3 if self.mlp_kind == "swiglu" else 2
                per_layer += mult * d * self.d_ff
            elif kind == "rglru" and self.d_ff:
                mult = 3 if self.mlp_kind == "swiglu" else 2
                per_layer += mult * d * self.d_ff
        return emb + per_layer

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k experts)."""
        if not self.n_routed_experts:
            return self.param_count()
        full = self.param_count()
        routed_all = self.n_layers * self.n_routed_experts * 3 * self.d_model * self.d_expert
        routed_active = self.n_layers * self.top_k * 3 * self.d_model * self.d_expert
        return full - routed_all + routed_active

    def matmul_param_count(self) -> int:
        """Active params that participate in matmuls (MODEL_FLOPS basis):
        excludes the embedding-gather side (no FLOPs), keeps the lm-head
        matmul. Tied embeddings are counted once in param_count and that
        instance IS the head matmul, so nothing is subtracted."""
        if self.tie_embeddings:
            return self.active_param_count()
        gather_side = self.vocab * self.d_model * max(self.n_codebooks, 1)
        return self.active_param_count() - gather_side


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str                        # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int
