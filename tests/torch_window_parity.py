"""Shared set-up of the verify-window parity tests (speculative verify and
the chunked-prefill mixed step): one random bf16 block pool laid out for
both packages (the port's list of per-layer ``{"k", "v"}`` pools, the
reference's scan-stacked ``[L, P, block, kv, hd]`` leaves), and the
check of a committed window: committed positions hold the reference's
bits within one bf16 ulp (each side rounds its own f32 K/V), every other
position of every real block keeps its bits exactly. Physical block 0 is
the trash block, whose content is never read unmasked.
"""

import jax.numpy as jnp
import numpy as np
import torch

BF16_ULP = 2.0 ** -7                    # relative spacing of bf16


def random_pools(cfg, n_phys, block, seed=0):
    """[L] pairs of f32 arrays [n_phys, block, kv, hd], already bf16
    values, so both packages hold the same bits."""
    rng = np.random.default_rng(seed)
    shape = (n_phys, block, cfg.n_kv, cfg.head_dim)
    out = []
    for _ in range(cfg.n_layers):
        pair = [rng.standard_normal(shape).astype(np.float32)
                for _ in range(2)]
        out.append([torch.from_numpy(x).to(torch.bfloat16).float().numpy()
                    for x in pair])
    return out


def port_cache(pools):
    return [{"k": torch.from_numpy(k).to(torch.bfloat16),
             "v": torch.from_numpy(v).to(torch.bfloat16)} for k, v in pools]


def ref_cache(pools):
    return {name: jnp.asarray(np.stack([p[i] for p in pools]), jnp.bfloat16)
            for i, name in enumerate(("k", "v"))}


def port_np(cache):
    """{name: f32 [L, P, block, kv, hd]} of the port's pools."""
    return {name: np.stack([layer[name].float().numpy() for layer in cache])
            for name in ("k", "v")}


def ref_np(cache):
    return {name: np.asarray(cache[name].astype(jnp.float32))
            for name in ("k", "v")}


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
    keep = np.ones(before["k"].shape[1:3], bool)          # [P, block]
    keep[0] = False                                       # the trash block
    for phys, off in committed:
        keep[phys, off] = False
    for name in ("k", "v"):
        g, w, b = got[name], want[name], before[name]
        np.testing.assert_array_equal(g[:, keep], b[:, keep])
        np.testing.assert_array_equal(w[:, keep], b[:, keep])
        for phys, off in committed:
            np.testing.assert_allclose(g[:, phys, off], w[:, phys, off],
                                       rtol=BF16_ULP, atol=1e-6)
            assert not np.array_equal(g[:, phys, off], b[:, phys, off])
