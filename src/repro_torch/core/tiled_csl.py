"""Tiled-CSL sparse format (Flash-LLM §4.3), on torch tensors.

The port's counterpart of ``repro.core.tiled_csl``. Each (m_tb x k_tb)
weight tile stores a list of 32-bit words, each packing a bf16 value
(bits 31..16) with a 16-bit intra-tile location ``row * k_tb + col``
(bits 15..0), padded with zero words to a per-matrix ``max_nnz`` (a
multiple of ``PAD_QUANTUM``). ``nnz[mt, kt]`` holds each tile's true
count; a kernel reads only the first ``nnz`` words of a tile.

``words`` is an int32 tensor carrying the same bits as the reference's
uint32 array (torch has no arithmetic uint32). Encoding is written on
tensors with stable sorts so it runs on the card: full-width OPT-30B
matrices have 205M and 411M elements. Its output is byte-equal to the
reference's default ``interleave`` reorder.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.analysis import contracts

DEFAULT_M_TB = 128
DEFAULT_K_TB = 128
PAD_QUANTUM = 128
# Reorder buckets: consecutive words cycle through distinct row residues.
N_SUBLANES = 8


@dataclasses.dataclass(frozen=True)
class TiledCSL:
    """A sparse matrix of logical shape ``(m, k)`` in padded Tiled-CSL.

    words: int32[mt, kt, max_nnz], or int32[G, mt, kt, max_nnz] for a
           grouped encoding of G same-shape matrices sharing one max_nnz.
    nnz:   int32[mt, kt] (or [G, mt, kt]) true non-zeros per tile.
    shape: logical dense shape (m, k) of each matrix, tile-aligned.
    dtype: dtype of the dense source.
    """

    words: torch.Tensor
    nnz: torch.Tensor
    shape: Tuple[int, int]
    m_tb: int
    k_tb: int
    dtype: torch.dtype = torch.float32

    @property
    def max_nnz(self) -> int:
        return int(self.words.shape[-1])

    @property
    def group(self):
        """Number of grouped matrices, or None for a plain 2-D encoding."""
        return int(self.words.shape[0]) if self.words.dim() == 4 else None

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.shape[0] // self.m_tb, self.shape[1] // self.k_tb)

    @property
    def nbytes_sparse(self) -> int:
        """Bytes the LSCD kernel streams for A (words incl. padding + nnz)."""
        return self.words.numel() * 4 + self.nnz.numel() * 4

    @property
    def nbytes_dense(self) -> int:
        """Bytes of the dense bf16 counterpart of every matrix held."""
        n_mats = 1
        for d in self.words.shape[:-3]:
            n_mats *= int(d)
        return self.shape[0] * self.shape[1] * 2 * n_mats


# ---------------------------------------------------------------------------
# packing helpers
# ---------------------------------------------------------------------------

_U32 = 1 << 32


def _as_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= (1 << 31), x - _U32, x).to(torch.int32)


def pack_words(values: torch.Tensor, locs: torch.Tensor) -> torch.Tensor:
    """word = (bf16_bits(value) << 16) | loc, bf16 rounded to nearest even."""
    bits32 = values.to(torch.float32).contiguous().view(torch.int32)
    bits32 = bits32.to(torch.int64) & 0xFFFFFFFF
    rounded = bits32 + 0x7FFF + ((bits32 >> 16) & 1)
    bf16_bits = (rounded >> 16) & 0xFFFF
    loc = locs.to(torch.int64) & 0xFFFF
    return _as_int32_bits((bf16_bits << 16) | loc)


def unpack_words(words: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_words` -> (f32 values, int64 locations)."""
    w = words.to(torch.int32)
    vals = (w & -65536).view(torch.float32)        # keep bits 31..16
    locs = w.to(torch.int64) & 0xFFFF               # no sign extension
    return vals, locs


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

def _dtype_of(dense) -> torch.dtype:
    return dense.dtype if isinstance(dense, torch.Tensor) else torch.float32


# Elements of the dense matrix one pass of ``encode`` turns into words: a
# weight is encoded in runs of whole tile rows of about this size, which
# bounds the index arrays of a pass (about 190 B a non-zero).
ENCODE_CHUNK_ELEMS = 1 << 24


def encode(dense: torch.Tensor, m_tb: int = DEFAULT_M_TB,
           k_tb: int = DEFAULT_K_TB,
           pad_quantum: int = PAD_QUANTUM) -> TiledCSL:
    """Encode a dense (m, k) matrix as padded Tiled-CSL, on its device.

    Zero elements are dropped; the rest keep bf16-rounded values, ordered
    within each tile by the reference's ``interleave`` reorder: rank
    within (tile, row % 8) bucket, then (tile, rank, bucket). A tile's
    words depend on that tile alone, so the matrix is encoded in runs of
    whole tile rows (``ENCODE_CHUNK_ELEMS``) into one padded array whose
    ``max_nnz`` is known up front from the per-tile counts.
    """
    orig_dtype = _dtype_of(dense)
    a = torch.as_tensor(dense).to(torch.float32)
    m, k = a.shape
    if m % m_tb or k % k_tb:
        raise ValueError(f"shape {(m, k)} not tile-aligned to ({m_tb},{k_tb})")
    contracts.require_tile_loc(m_tb, k_tb)
    mt, kt = m // m_tb, k // k_tb
    counts = (a != 0).reshape(mt, m_tb, kt, k_tb).sum(dim=(1, 3),
                                                      dtype=torch.int64)
    max_nnz = max(int(counts.max().item()) if counts.numel() else 1, 1)
    max_nnz = -(-max_nnz // pad_quantum) * pad_quantum
    words = torch.zeros((mt, kt, max_nnz), dtype=torch.int32,
                        device=a.device)
    rows = max(1, ENCODE_CHUNK_ELEMS // (m_tb * k))
    for r0 in range(0, mt, rows):
        r1 = min(mt, r0 + rows)
        _encode_rows(a[r0 * m_tb:r1 * m_tb], counts[r0:r1],
                     words[r0:r1], m_tb, k_tb)
    return TiledCSL(words=words, nnz=counts.to(torch.int32), shape=(m, k),
                    m_tb=m_tb, k_tb=k_tb, dtype=orig_dtype)


def _encode_rows(a: torch.Tensor, counts: torch.Tensor, out: torch.Tensor,
                 m_tb: int, k_tb: int) -> None:
    """Write the words of the tile rows ``a`` ([rows·m_tb, k]) into ``out``
    ([rows, kt, max_nnz]); ``counts`` [rows, kt] are their tiles' nnz."""
    kt = a.shape[1] // k_tb
    n_tiles = counts.numel()
    dev = a.device
    rr, cc = torch.nonzero(a, as_tuple=True)            # row-major order
    n = rr.numel()
    if not n:
        return
    vv = a[rr, cc]
    tile_id = (rr // m_tb) * kt + (cc // k_tb)
    in_r, in_c = rr % m_tb, cc % k_tb
    del rr, cc
    bucket = in_r % N_SUBLANES
    grp = tile_id * N_SUBLANES + bucket
    order0 = torch.sort(grp, stable=True).indices
    grp_sorted = grp[order0]
    del grp
    grp_counts = torch.bincount(grp_sorted, minlength=n_tiles * N_SUBLANES)
    grp_start = torch.cumsum(grp_counts, 0) - grp_counts
    rank_key = torch.empty(n, dtype=torch.int64, device=dev)
    rank_key[order0] = torch.arange(n, device=dev) - grp_start[grp_sorted]
    del order0, grp_sorted
    # (tile, rank, bucket) is unique per non-zero, so one sort of the
    # combined key equals the reference's three-key lexsort.
    key = (tile_id * (m_tb * k_tb) + rank_key) * N_SUBLANES + bucket
    del rank_key, bucket
    perm = torch.sort(key, stable=True).indices
    del key
    tgt_tile = tile_id[perm]
    del tile_id
    flat = counts.reshape(-1)
    starts = torch.cumsum(flat, 0) - flat
    rank = torch.arange(n, device=dev) - starts[tgt_tile]
    locs = in_r[perm] * k_tb + in_c[perm]
    del in_r, in_c
    out.view(n_tiles, -1)[tgt_tile, rank] = pack_words(vv[perm], locs)


def pad_max_nnz(t: TiledCSL, max_nnz: int) -> TiledCSL:
    """Re-pad the word streams to ``max_nnz`` with zero (no-op) words."""
    if max_nnz == t.max_nnz:
        return t
    if max_nnz < t.max_nnz:
        raise ValueError(f"max_nnz {max_nnz} < required {t.max_nnz}")
    return dataclasses.replace(
        t, words=F.pad(t.words, (0, max_nnz - t.max_nnz)))


def encode_group(weights: Sequence[torch.Tensor], m_tb: int = DEFAULT_M_TB,
                 k_tb: int = DEFAULT_K_TB,
                 pad_quantum: int = PAD_QUANTUM) -> TiledCSL:
    """Encode G same-shape (m, k) matrices as one grouped Tiled-CSL."""
    if not weights:
        raise ValueError("encode_group needs at least one weight")
    ts = [encode(w, m_tb=m_tb, k_tb=k_tb, pad_quantum=pad_quantum)
          for w in weights]
    shapes = {t.shape for t in ts}
    if len(shapes) != 1:
        raise ValueError(f"grouped weights must share one shape, got {shapes}")
    return group_stack(ts)


def group_stack(ts: Sequence[TiledCSL]) -> TiledCSL:
    """Stack same-shape plain TiledCSLs into a grouped one, padding every
    member to the group's largest ``max_nnz``."""
    ts = list(ts)
    if not ts:
        raise ValueError("group_stack needs at least one TiledCSL")
    for t in ts:
        if t.words.dim() != 3:
            raise ValueError("group_stack members must be plain encodings, "
                             f"got words rank {t.words.dim()}")
        if (t.shape, t.m_tb, t.k_tb) != (ts[0].shape, ts[0].m_tb, ts[0].k_tb):
            raise ValueError("group_stack members must share shape and tile "
                             f"geometry, got {[(t.shape, t.m_tb, t.k_tb) for t in ts]}")
    mx = max(t.max_nnz for t in ts)
    words = torch.stack([pad_max_nnz(t, mx).words for t in ts])
    nnz = torch.stack([t.nnz for t in ts])
    return TiledCSL(words=words, nnz=nnz, shape=ts[0].shape, m_tb=ts[0].m_tb,
                    k_tb=ts[0].k_tb, dtype=ts[0].dtype)


def group_slice(t: TiledCSL, g: int) -> TiledCSL:
    """Member ``g`` of a grouped TiledCSL as a plain 2-D encoding."""
    if t.group is None:
        raise ValueError("group_slice needs a grouped TiledCSL")
    return dataclasses.replace(t, words=t.words[g], nnz=t.nnz[g])


def decode(t: TiledCSL) -> torch.Tensor:
    """Dense f32 reconstruction (``[G, m, k]`` for grouped encodings).

    Only the first ``nnz`` words of each tile are placed, so padding
    words never touch element (0, 0)."""
    if t.group is not None:
        return torch.stack([decode(group_slice(t, g)) for g in range(t.group)])
    m, k = t.shape
    mt, kt = t.grid
    dev = t.words.device
    vals, locs = unpack_words(t.words)                  # [mt, kt, w]
    slot = torch.arange(t.max_nnz, device=dev)
    live = slot[None, None, :] < t.nnz[:, :, None].to(torch.int64)
    ti = torch.arange(mt, device=dev)[:, None, None]
    tj = torch.arange(kt, device=dev)[None, :, None]
    rows = ti * t.m_tb + locs // t.k_tb
    cols = tj * t.k_tb + locs % t.k_tb
    out = torch.zeros(m * k, dtype=torch.float32, device=dev)
    out.index_put_((rows[live] * k + cols[live],), vals[live], accumulate=True)
    return out.reshape(m, k)
