"""HBM budget planner: turn Tiled-CSL weight-byte savings into KV blocks.

The port's counterpart of ``repro.serving.budget``. The paper's claim is
that compressed weights free HBM, and that the freed memory becomes a
larger batch. The planner computes that trade:

    n_blocks = (hbm_budget − weight_bytes(mode, sparsity) − workspace)
               // block_bytes(cfg, block)  − 1 (the pool's trash block)

so at one budget the sparse weight modes buy a larger block pool than
``dense``, which the paged scheduler then spends on admitted requests.

The weight term is counted from the config's shapes, with no tensor
made: dense leaves at 2 B (bf16), Tiled-CSL leaves at 4 B a word plus
4 B a nnz counter, with the analytic ``max_nnz`` =
ceil(128·128·(1 − s)·IMBALANCE) rounded up to ``PAD_QUANTUM``. The
leaves picked are those the reference's ``launch.specs.
default_should_sparsify`` picks, ``lm_head`` included, so every number
equals the reference's byte for byte. The serving launchers keep
``lm_head`` dense, so for a sparse deployment the plan counts less for
it than the built model holds. ``sparse_pallas`` and ``sparse_xla`` name
the reference's kernels, not the format: both count the same encoded
bytes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

from repro_torch.core import tiled_csl
from repro_torch.models.config import ModelConfig

WEIGHT_MODES = ("dense", "sparse_pallas", "sparse_xla")

# Decode-step workspace floor when the caller does not override it:
# activations, logits, scratch prefill cache and allocator slack.
DEFAULT_WORKSPACE_FRAC = 0.03

# Typical per-tile nnz imbalance of random unstructured sparsity (max tile
# nnz over the mean) at 128x128 tiles, as the reference's launch specs
# take it; tile-balanced pruning makes it 1.0.
IMBALANCE = 1.15

# The weights the reference's launch specs encode as Tiled-CSL in the
# dense family: its ``default_should_sparsify`` list, ``lm_head`` included.
SPARSE_NAMES = ("wq", "wk", "wv", "wo", "gate", "up", "down", "lm_head")

BF16_BYTES = 2


def _dense_family_leaves(cfg: ModelConfig) -> Iterator[Tuple[str, Tuple[int, ...], int]]:
    """(name, shape, count) of every parameter leaf of the dense family,
    ``count`` being how many copies the stack holds (one per layer)."""
    if cfg.family != "dense" or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: the port's planner counts the dense GQA family only")
    d, L = cfg.d_model, cfg.n_layers
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    norm = (("scale",) if cfg.norm_kind == "rmsnorm" else ("scale", "bias"))
    yield "embed", (cfg.vocab, d), 1
    for part in ("pre_norm", "mlp_norm"):
        for leaf in norm:
            yield f"{part}.{leaf}", (d,), L
    for name, out in (("wq", h * hd), ("wk", kv * hd), ("wv", kv * hd)):
        yield f"{name}.w", (out, d), L
        if cfg.qkv_bias:
            yield f"{name}.b", (out,), L
    yield "wo.w", (d, h * hd), L
    if cfg.mlp_kind == "swiglu":
        mlp = (("gate", cfg.d_ff, d), ("up", cfg.d_ff, d),
               ("down", d, cfg.d_ff))
        bias = False
    else:
        mlp = (("up", cfg.d_ff, d), ("down", d, cfg.d_ff))
        bias = cfg.mlp_bias
    for name, out, inp in mlp:
        yield f"{name}.w", (out, inp), L
        if bias:
            yield f"{name}.b", (out,), L
    for leaf in norm:
        yield f"final_norm.{leaf}", (d,), 1
    if not cfg.tie_embeddings:
        yield "lm_head.w", (cfg.vocab, d), 1


def analytic_max_nnz(sparsity: float) -> int:
    """Words a 128x128 tile is padded to at ``sparsity``: the mean tile
    nnz times ``IMBALANCE``, rounded up to ``PAD_QUANTUM``."""
    m_tb, k_tb = tiled_csl.DEFAULT_M_TB, tiled_csl.DEFAULT_K_TB
    nnz = m_tb * k_tb * (1.0 - sparsity) * IMBALANCE
    q = tiled_csl.PAD_QUANTUM
    return -(-math.ceil(nnz) // q) * q


def csl_bytes(out_dim: int, in_dim: int, sparsity: float) -> int:
    """Encoded bytes of one [out, in] weight in Tiled-CSL at ``sparsity``
    (analytic ``max_nnz``): 4 B a word, 4 B a tile's nnz counter."""
    m_tb, k_tb = tiled_csl.DEFAULT_M_TB, tiled_csl.DEFAULT_K_TB
    tiles = -(-out_dim // m_tb) * -(-in_dim // k_tb)
    return tiles * analytic_max_nnz(sparsity) * 4 + tiles * 4


def weight_bytes(cfg: ModelConfig, mode: str = "dense",
                 sparsity: float = 0.8) -> int:
    """Serving weight bytes for one (arch × weight-mode) deployment."""
    if mode not in WEIGHT_MODES:
        raise ValueError(f"weight mode {mode!r} not in {WEIGHT_MODES}")
    total = 0
    for name, shape, count in _dense_family_leaves(cfg):
        leaf = name.split(".")[0]
        if mode != "dense" and len(shape) == 2 and name.endswith(".w") \
                and leaf in SPARSE_NAMES:
            total += count * csl_bytes(shape[0], shape[1], sparsity)
        else:
            total += count * math.prod(shape) * BF16_BYTES
    return total


def block_bytes(cfg: ModelConfig, block: int, dtype_bytes: int = 2) -> int:
    """HBM bytes of ONE KV block (``block`` token positions, all layers).

    MLA layers store (c_kv, k_rope) latents; GQA layers store K + V heads.
    The sliding window does not change block bytes — it caps how many
    blocks a request can hold, not what a block costs.
    """
    per_tok = 0
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) != "attn":
            raise ValueError(
                "paged KV blocks require a pure-attention stack "
                f"(layer {i} is {cfg.layer_kind(i)!r})")
        if cfg.attn_kind == "mla":
            per_tok += (cfg.kv_lora_rank + cfg.qk_rope_dim) * dtype_bytes
        else:
            per_tok += 2 * cfg.n_kv * cfg.head_dim * dtype_bytes
    return per_tok * block


@dataclasses.dataclass(frozen=True)
class Plan:
    """One planned deployment: where every HBM byte goes."""

    arch: str
    weight_mode: str
    sparsity: float
    hbm_budget: int
    weight_bytes: int
    workspace_bytes: int
    block: int
    block_bytes: int
    n_blocks: int                 # usable KV blocks the budget affords
    kv_bytes: int                 # (n_blocks + 1) * block_bytes, incl. the
                                  # reserved trash block the device pool
                                  # physically carries (paged_cache)

    @property
    def kv_positions(self) -> int:
        return self.n_blocks * self.block

    def n_dense_slots(self, max_len: int) -> int:
        """The dense-cache baseline the same KV budget affords: slots of
        ``max_len`` pre-reserved positions — the number the paged pool's
        admitted concurrency is measured against."""
        per_slot = max_len * (self.block_bytes // self.block)
        return self.kv_bytes // max(per_slot, 1)

    def worst_case_blocks(self, prompt_len: int, max_new_tokens: int,
                          max_len: int,
                          ring_len: Optional[int] = None) -> int:
        """KV blocks a request can grow to before it completes — the same
        bound the scheduler's ``validate_request`` enforces at submit: K/V
        positions reach prompt + (max_new − 1) generated (the last sampled
        token is never written back), capped by ``max_len`` and the
        sliding-window ring."""
        n_pos = min(prompt_len + max(max_new_tokens - 1, 0), max_len)
        if ring_len is not None:
            n_pos = min(n_pos, ring_len)
        return -(-n_pos // self.block)          # ceil div

    def can_serve(self, prompt_len: int, max_new_tokens: int,
                  max_len: int, ring_len: Optional[int] = None) -> bool:
        """Whether this plan's pool can ever run such a request to
        completion — the deploy-time twin of the server's submit-time
        ``RequestRejected`` check."""
        return self.worst_case_blocks(prompt_len, max_new_tokens, max_len,
                                      ring_len) <= self.n_blocks

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["kv_positions"] = self.kv_positions
        return d


def plan(cfg: ModelConfig, *, hbm_budget: int, weight_mode: str = "dense",
         sparsity: float = 0.8, block: int = 128,
         workspace_bytes: Optional[int] = None) -> Plan:
    """Size the KV block pool for one deployment.

    Raises ValueError when the budget cannot hold the weights plus one
    block: that deployment needs more cards, not a scheduler.
    """
    wb = weight_bytes(cfg, weight_mode, sparsity)
    ws = (int(hbm_budget * DEFAULT_WORKSPACE_FRAC)
          if workspace_bytes is None else workspace_bytes)
    bb = block_bytes(cfg, block)
    usable = hbm_budget - wb - ws
    # The device pool physically carries one extra row — the reserved
    # trash block (paged_cache.BlockPool.physical_blocks) — so it is
    # charged here too: n_blocks counts only usable blocks.
    physical = usable // bb if usable > 0 else 0
    n_blocks = physical - 1
    if n_blocks < 1:
        raise ValueError(
            f"{cfg.name}/{weight_mode}: budget {hbm_budget / 1e9:.1f} GB "
            f"cannot hold weights ({wb / 1e9:.1f} GB) + workspace "
            f"({ws / 1e9:.1f} GB) + trash block + one usable "
            f"{bb / 1e6:.1f} MB KV block")
    return Plan(arch=cfg.name, weight_mode=weight_mode, sparsity=sparsity,
                hbm_budget=int(hbm_budget), weight_bytes=wb,
                workspace_bytes=ws, block=block, block_bytes=bb,
                n_blocks=int(n_blocks), kv_bytes=int(physical * bb))
