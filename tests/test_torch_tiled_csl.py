"""Tiled-CSL parity: the port's encoding is byte-equal to the reference's.

The same seeded numpy matrices go through ``repro.core.tiled_csl`` and
``repro_torch.core.tiled_csl``; ``words`` (uint32 there, int32 with the
same bits here), ``nnz`` and ``max_nnz`` must match exactly, and
``decode`` must round-trip exactly (bf16-rounded values).
"""

import numpy as np
import pytest
import torch

from repro.core import tiled_csl as ref_csl
from repro_torch.core import tiled_csl

SHAPES = [(128, 128), (256, 384), (384, 256)]
SPARSITIES = [0.0, 0.5, 0.8, 0.95]
GEOMS = [(128, 128), (64, 128), (128, 64)]


def _matrix(rng, shape, sparsity, empty_tiles=False, m_tb=128, k_tb=128):
    a = rng.standard_normal(shape).astype(np.float32)
    a[rng.random(shape) < sparsity] = 0.0
    if empty_tiles:
        a[:m_tb, :k_tb] = 0.0                 # first tile all-empty
        a[-m_tb:, k_tb:2 * k_tb] = 0.0
    return a


def _same(ref, port):
    words = np.asarray(ref.words).view(np.int32)
    np.testing.assert_array_equal(port.words.numpy(), words)
    np.testing.assert_array_equal(port.nnz.numpy(), np.asarray(ref.nnz))
    assert port.max_nnz == ref.max_nnz
    assert port.shape == tuple(ref.shape)


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("sparsity", SPARSITIES)
@pytest.mark.parametrize("shape", SHAPES)
def test_encode_byte_equal(shape, sparsity, geom):
    m_tb, k_tb = geom
    rng = np.random.default_rng(hash((shape, sparsity, geom)) % 2 ** 31)
    a = _matrix(rng, shape, sparsity, empty_tiles=True, m_tb=m_tb, k_tb=k_tb)
    ref = ref_csl.encode(a, m_tb=m_tb, k_tb=k_tb)
    port = tiled_csl.encode(torch.from_numpy(a), m_tb=m_tb, k_tb=k_tb)
    _same(ref, port)
    assert int(port.nnz[0, 0]) == 0
    dense = tiled_csl.decode(port).numpy()
    np.testing.assert_array_equal(dense, ref_csl.decode(ref))
    bf16 = torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()
    np.testing.assert_array_equal(dense, bf16)


def test_all_zero_matrix():
    a = np.zeros((128, 256), np.float32)
    _same(ref_csl.encode(a), tiled_csl.encode(torch.from_numpy(a)))


def test_pack_unpack_match_reference():
    rng = np.random.default_rng(3)
    vals = (rng.standard_normal(4096) * 1e3).astype(np.float32)
    vals[:8] = [-0.0, 0.0, -1.0, 3.4e38, -3.4e38, 1e-40, -2.5, 65504.0]
    locs = rng.integers(0, 65536, 4096)
    ref = ref_csl.pack_words(vals, locs)
    port = tiled_csl.pack_words(torch.from_numpy(vals), torch.from_numpy(locs))
    np.testing.assert_array_equal(port.numpy(), ref.view(np.int32))
    rv, rl = ref_csl.unpack_words(ref)
    pv, pl = tiled_csl.unpack_words(port)
    np.testing.assert_array_equal(pv.numpy(), rv)
    np.testing.assert_array_equal(pl.numpy(), rl)   # no sign extension
    assert int(pl.max()) > 32767


@pytest.mark.parametrize("g", [2, 3])
def test_encode_group_byte_equal(g):
    rng = np.random.default_rng(40 + g)
    mats = [_matrix(rng, (256, 384), s) for s in (0.5, 0.8, 0.95)[:g]]
    ref = ref_csl.encode_group(mats)
    port = tiled_csl.encode_group([torch.from_numpy(m) for m in mats])
    _same(ref, port)
    assert port.group == g
    np.testing.assert_array_equal(tiled_csl.decode(port).numpy(),
                                  ref_csl.decode(ref))
    one = tiled_csl.group_slice(port, 1)
    _same(ref_csl.group_slice(ref, 1), one)


def test_tile_loc_guard():
    with pytest.raises(ValueError, match="16-bit"):
        tiled_csl.encode(torch.ones(512, 256), m_tb=512, k_tb=256)


@pytest.mark.parametrize("chunk", [1, 128 * 384 * 2])
@pytest.mark.parametrize("geom", GEOMS)
def test_encode_in_tile_row_runs_byte_equal(monkeypatch, geom, chunk):
    """A weight encoded in runs of tile rows (one row a run, or two) is the
    reference's one-pass encoding byte for byte, empty tiles included."""
    m_tb, k_tb = geom
    monkeypatch.setattr(tiled_csl, "ENCODE_CHUNK_ELEMS", chunk)
    rng = np.random.default_rng(11)
    a = _matrix(rng, (640, 384), 0.8, empty_tiles=True, m_tb=m_tb, k_tb=k_tb)
    a[m_tb:2 * m_tb] = 0.0                    # a whole empty tile row
    _same(ref_csl.encode(a, m_tb=m_tb, k_tb=k_tb),
          tiled_csl.encode(torch.from_numpy(a), m_tb=m_tb, k_tb=k_tb))


# --- the reorder modes (paper Alg. 3) -----------------------------------

REORDERS = ("interleave", "greedy", "none")
# Square default tiles, and a ragged tile geometry (64 x 32 tiles of a
# 192 x 96 matrix, neither side a power of the other).
REORDER_CASES = [((128, 128), (128, 128)), ((192, 96), (64, 32))]


def _same_stats(ref, port):
    """``n_nonzero``, ``pad_overhead`` and every tile's sublane score
    exactly equal; no nonzero word past any tile's ``nnz``."""
    assert port.n_nonzero == ref.n_nonzero
    assert port.pad_overhead == ref.pad_overhead
    words = np.asarray(ref.words)
    nnz = np.asarray(ref.nnz)
    for idx in np.ndindex(*nnz.shape):
        n = int(nnz[idx])
        assert tiled_csl.sublane_conflict_score(
            port.words[idx], n, port.k_tb) == ref_csl.sublane_conflict_score(
            words[idx], n, ref.k_tb), idx
    slot = torch.arange(port.max_nnz)
    past = slot >= port.nnz[..., None].to(torch.int64)
    assert int(port.words[past].abs().sum()) == 0    # (+0.0 | loc 0)


@pytest.mark.parametrize("sparsity", [0.5, 0.8, 0.95])
@pytest.mark.parametrize("case", REORDER_CASES, ids=["128x128", "ragged"])
@pytest.mark.parametrize("reorder", REORDERS)
def test_encode_reorder_byte_equal(reorder, case, sparsity):
    shape, (m_tb, k_tb) = case
    rng = np.random.default_rng(hash((reorder, shape, sparsity)) % 2 ** 31)
    a = _matrix(rng, shape, sparsity, empty_tiles=True, m_tb=m_tb, k_tb=k_tb)
    ref = ref_csl.encode(a, m_tb=m_tb, k_tb=k_tb, reorder=reorder)
    port = tiled_csl.encode(torch.from_numpy(a), m_tb=m_tb, k_tb=k_tb,
                            reorder=reorder)
    _same(ref, port)
    _same_stats(ref, port)
    np.testing.assert_array_equal(tiled_csl.decode(port).numpy(),
                                  ref_csl.decode(ref))


def test_reorder_scores_at_128x128():
    """One 128 x 128 matrix pruned by magnitude at 0.8 (seed 0): the
    reorders' sublane scores, the reference's figures."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((128, 128)).astype(np.float32)
    a = np.where(np.abs(w) >= np.sort(np.abs(w).ravel())[-3277], w, 0.0)
    n = int(np.count_nonzero(a))
    got = {r: tiled_csl.sublane_conflict_score(
        tiled_csl.encode(torch.from_numpy(a), reorder=r).words[0, 0], n, 128)
        for r in REORDERS}
    assert round(got["interleave"], 2) == 7.75
    assert round(got["greedy"], 2) == 7.76
    assert round(got["none"], 2) == 1.24


@pytest.mark.parametrize("sparsities", [(0.5, 0.8, 0.95), (0.95, 0.0, 0.8),
                                        (0.8, 0.8, 0.8)])
def test_encode_group_and_stack_byte_equal(sparsities):
    """The grouped and stacked encoders, which take the default
    ``interleave`` reorder, with ``n_nonzero``, ``pad_overhead`` and the
    sublane scores of each member, against the reference's."""
    rng = np.random.default_rng(7)
    mats = [_matrix(rng, (128, 256), s) for s in sparsities]
    ref = ref_csl.encode_group(mats)
    port = tiled_csl.encode_group([torch.from_numpy(m) for m in mats])
    _same(ref, port)
    _same_stats(ref, port)
    # An expert stack: the reference's per-expert encodings padded to the
    # stack's largest max_nnz, as its sparsify_params stacks them.
    stack = tiled_csl.encode_stack(torch.from_numpy(np.stack(mats)))
    per = [ref_csl.encode(m) for m in mats]
    mx = max(t.max_nnz for t in per)
    words = np.stack([np.pad(np.asarray(t.words),
                             ((0, 0), (0, 0), (0, mx - t.max_nnz)))
                      for t in per])
    np.testing.assert_array_equal(stack.words.numpy(), words.view(np.int32))
    np.testing.assert_array_equal(stack.nnz.numpy(),
                                  np.stack([np.asarray(t.nnz) for t in per]))
    assert stack.n_nonzero == sum(t.n_nonzero for t in per)


def test_unknown_reorder_raises():
    with pytest.raises(ValueError, match="unknown reorder"):
        tiled_csl.encode(torch.ones(128, 128), reorder="bogus")
