"""Shared set-up of the verify-window parity tests (speculative verify and
the chunked-prefill mixed step): one random bf16 block pool laid out for
both packages (the port's list of per-layer ``{"k", "v"}`` pools, or
``{"ckv", "krope"}`` latent pools for MLA, the reference's scan-stacked
``[L, P, block, ...]`` leaves), and the
check of a committed window: committed positions hold the reference's
bits within one bf16 ulp (each side rounds its own f32 K/V), every other
position of every real block keeps its bits exactly. Physical block 0 is
the trash block, whose content is never read unmasked.
"""

import jax.numpy as jnp
import numpy as np
import torch

BF16_ULP = 2.0 ** -7                    # relative spacing of bf16


def leaf_shapes(cfg):
    """{leaf name: per-position shape} of one layer's cache."""
    if cfg.attn_kind == "mla":
        return {"ckv": (cfg.kv_lora_rank,), "krope": (cfg.qk_rope_dim,)}
    return {name: (cfg.n_kv, cfg.head_dim) for name in ("k", "v")}


def random_pools(cfg, n_phys, block, seed=0):
    """[L] dicts {leaf name: f32 array [n_phys, block, ...]}, already bf16
    values, so both packages hold the same bits."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(cfg.n_layers):
        out.append({name: torch.from_numpy(rng.standard_normal(
            (n_phys, block) + shape).astype(np.float32)).to(
                torch.bfloat16).float().numpy()
            for name, shape in leaf_shapes(cfg).items()})
    return out


def port_cache(pools):
    return [{name: torch.from_numpy(x).to(torch.bfloat16)
             for name, x in layer.items()} for layer in pools]


def ref_cache(pools):
    return {name: jnp.asarray(np.stack([p[name] for p in pools]),
                              jnp.bfloat16) for name in pools[0]}


def port_np(cache):
    """{name: f32 [L, P, block, ...]} of the port's pools."""
    return {name: np.stack([layer[name].float().numpy() for layer in cache])
            for name in cache[0]}


def ref_np(cache):
    return {name: np.asarray(cache[name].astype(jnp.float32))
            for name in cache}


def committed_positions(tables, pos, commit, block):
    """(phys, off) pairs a window commit writes to real blocks."""
    out = set()
    nblk = tables.shape[1]
    for b in range(commit.shape[0]):
        for j in range(commit.shape[1]):
            p = int(pos[b]) + j
            if commit[b, j] and p // block < nblk:
                out.add((int(tables[b, p // block]), p % block))
    return out


def assert_window_committed(got, want, before, committed):
    """``got``/``want``/``before``: {name: [L, P, block, ...]} f32 pools of
    the port after, the reference after, and both before the commit."""
    keep = np.ones(next(iter(before.values())).shape[1:3], bool)  # [P, block]
    keep[0] = False                                       # the trash block
    for phys, off in committed:
        keep[phys, off] = False
    for name in before:
        g, w, b = got[name], want[name], before[name]
        np.testing.assert_array_equal(g[:, keep], b[:, keep])
        np.testing.assert_array_equal(w[:, keep], b[:, keep])
        for phys, off in committed:
            np.testing.assert_allclose(g[:, phys, off], w[:, phys, off],
                                       rtol=BF16_ULP, atol=1e-6)
            assert not np.array_equal(g[:, phys, off], b[:, phys, off])
