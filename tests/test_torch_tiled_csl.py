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
