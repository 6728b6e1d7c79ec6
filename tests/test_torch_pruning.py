"""Pruning and reformatting parity: same masks, same grouping decisions,
byte-equal Tiled-CSL encodings (``wqkv``/``gate_up`` included) from the
port's ``sparsify_params`` + ``group_projections`` and the reference's,
on the smoke configs. The reference's params reach the port through
``convert.params_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import pruning as ref_pruning
from repro.core import sparse_linear as ref_sl
from repro.core import tiled_csl as ref_csl
from repro.models import transformer as ref_tf
from repro_torch import convert
from repro_torch.core import pruning, sparse_linear, tiled_csl

SPARSE = ("'wq'", "'wk'", "'wv'", "'wo'", "'gate'", "'up'", "'down'")


def _should(name):
    # Weights only: the reference's filter alone would also encode its
    # scan-stacked [L, d] biases, which its scan then cannot slice.
    return name.endswith("['w']") and any(k in name for k in SPARSE)


@pytest.mark.parametrize("sparsity", [0.5, 0.8, 0.95])
def test_unstructured_mask_matches(sparsity):
    rng = np.random.default_rng(int(sparsity * 100))
    s = np.abs(rng.standard_normal((256, 384))).astype(np.float32)
    s[:4, :4] = 0.5                                  # ties at the threshold
    want = np.asarray(ref_pruning.unstructured_mask(jnp.asarray(s), sparsity))
    got = pruning.unstructured_mask(torch.from_numpy(s), sparsity).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sparsity", [0.5, 0.8])
def test_tile_balanced_mask_matches(sparsity):
    rng = np.random.default_rng(7)
    s = np.abs(rng.standard_normal((256, 256))).astype(np.float32)
    want = np.asarray(ref_pruning.tile_balanced_mask(jnp.asarray(s), sparsity))
    got = pruning.tile_balanced_mask(torch.from_numpy(s), sparsity).numpy()
    np.testing.assert_array_equal(got, want)


def test_sparsify_matrix_byte_equal_with_padding():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((200, 300)).astype(np.float32)   # ragged dims
    ref = ref_pruning.sparsify_matrix(jnp.asarray(w), 0.8, max_nnz=4096)
    got = pruning.sparsify_matrix(torch.from_numpy(w), 0.8, max_nnz=4096)
    np.testing.assert_array_equal(got.words.numpy(),
                                  np.asarray(ref.words).view(np.int32))
    np.testing.assert_array_equal(got.nnz.numpy(), np.asarray(ref.nnz))


def _leaves(tree, path=""):
    if isinstance(tree, tiled_csl.TiledCSL) or isinstance(tree, torch.Tensor):
        return {path: tree}
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        out.update(_leaves(v, f"{path}/{k}"))
    return out


@pytest.mark.parametrize("sparsity", [0.8, 0.95])
@pytest.mark.parametrize("arch", ["opt_30b", "tinyllama_1_1b"])
def test_sparsify_and_group_byte_equal(arch, sparsity):
    cfg = ref_configs.smoke(arch)
    jparams = ref_tf.init_model(jax.random.PRNGKey(3), cfg)
    jsparse = ref_pruning.group_projections(ref_pruning.sparsify_params(
        jparams, sparsity, should_sparsify=_should))
    want = convert.params_from_numpy(jax.tree.map(np.asarray, jsparse),
                                     device="cpu")
    dense = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    got = pruning.group_projections(pruning.sparsify_params(
        dense, sparsity, should_sparsify=_should))
    lw, lg = _leaves(want), _leaves(got)
    assert sorted(lw) == sorted(lg)
    grouped = [p for p in lg if "wqkv" in p or "gate_up" in p]
    if arch == "opt_30b":
        assert any("wqkv" in p for p in grouped)
    for path, w in lw.items():
        g = lg[path]
        if isinstance(w, tiled_csl.TiledCSL):
            assert isinstance(g, tiled_csl.TiledCSL), path
            assert (g.shape, g.m_tb, g.k_tb, g.group) == \
                (w.shape, w.m_tb, w.k_tb, w.group), path
            assert torch.equal(g.words, w.words), path
            assert torch.equal(g.nnz, w.nnz), path
        else:
            assert torch.equal(g, w), path


@pytest.mark.parametrize("arch", ["opt_30b", "tinyllama_1_1b"])
def test_grouping_decisions_match(arch):
    """groupable / _pregroupable agree on every projection set of a layer,
    including GQA's uneven q vs k/v streams."""
    cfg = ref_configs.smoke(arch)
    jparams = ref_tf.init_model(jax.random.PRNGKey(5), cfg)
    jsparse = ref_pruning.sparsify_params(jparams, 0.8,
                                          should_sparsify=_should)
    psparse = convert.params_from_numpy(jax.tree.map(np.asarray, jsparse),
                                        device="cpu")
    for i in range(cfg.n_layers):
        pl = psparse["layers"][i]
        for names in (("wq", "wk", "wv"), ("wk", "wv")):
            jws = [ref_csl.TiledCSL(
                words=jsparse["layers"]["attn"][n]["w"].words[i],
                nnz=jsparse["layers"]["attn"][n]["w"].nnz[i],
                shape=jsparse["layers"]["attn"][n]["w"].shape, m_tb=128,
                k_tb=128, dtype=jnp.float32) for n in names]
            pws = [pl["attn"][n]["w"] for n in names]
            assert sparse_linear.groupable(pws) == ref_sl.groupable(jws)
            assert pruning._pregroupable(pws) == \
                ref_pruning._pregroupable(jws)
