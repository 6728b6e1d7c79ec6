"""Rotary position embeddings: standard 1-D RoPE and Qwen2-VL's M-RoPE.

M-RoPE (arXiv:2409.12191) splits the rotary half into three sections
driven by (temporal, height, width) position ids. For text tokens the
three ids are equal, which is exactly 1-D RoPE; vision patches get
distinct h/w ids. Both rotate in f32 and return x's dtype.
"""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, D]; angles: [B, S, D // 2] f32."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, D]; positions: [B, S] integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * freqs)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor,
                sections: tuple, theta: float = 1e6) -> torch.Tensor:
    """x: [B, S, H, D]; positions_thw: [3, B, S] integer. ``sections``
    are the per-axis shares of the rotary half, e.g. (16, 24, 24) with
    head_dim 128; section i's frequency slots take positions_thw[i]."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to the "
                         f"rotary half {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    pos = torch.cat([positions_thw[i][..., None].to(torch.float32)
                     .expand(-1, -1, sec) for i, sec in enumerate(sections)],
                    dim=-1)                                   # [B, S, half]
    return _rotate(x, pos * freqs)
