"""Kernel launch contracts of the port's LSCD SpMM kernels.

The port keeps two of the JAX package's rules (``repro.analysis.contracts``):

KC-LOC     ``m_tb * k_tb <= 65536``: the packed Tiled-CSL word holds the
           intra-tile location in 16 bits; a larger tile would wrap
           ``loc & 0xFFFF`` and corrupt the weight placement.
KC-LAUNCH  what the CUDA kernels in ``kernels/csrc`` accept: ``m_tb`` in
           {64, 128}, ``k_tb`` in {64, 128}, ``n_tb`` in the N ladder,
           ``1 <= split_k <= Kt``, dense dims that tile evenly, a shared
           memory footprint within the H100's 227 KB per block (in place
           of the TPU's VMEM budget), and at most
           ``MAX_ACC_PER_THREAD`` f32 accumulators per thread.
"""

from __future__ import annotations

from typing import List

#: 16-bit intra-tile location capacity of the packed Tiled-CSL word.
MAX_TILE_ELEMS = 65536

#: Shared memory one block may use on an H100 (232,448 bytes).
SMEM_BYTES_PER_BLOCK = 232448

#: Threads per block of every LSCD kernel (csrc/lscd_common.cuh).
THREADS = 256

#: f32 accumulators a thread may hold: G * m_tb * n_tb / THREADS.
MAX_ACC_PER_THREAD = 64

#: Tile sizes the kernels are instantiated for.
M_TB_OPTIONS = (64, 128)
K_TB_OPTIONS = (64, 128)
N_TB_OPTIONS = (8, 16, 32, 64, 128)
GROUP_OPTIONS = (1, 2, 3)


class ScheduleContractError(ValueError):
    """A launch the kernels cannot take, raised before any launch."""


def tile_loc_ok(m_tb: int, k_tb: int) -> bool:
    """KC-LOC predicate: tile fits the 16-bit intra-tile loc field."""
    return m_tb * k_tb <= MAX_TILE_ELEMS


def require_tile_loc(m_tb: int, k_tb: int) -> None:
    """Raise ``ValueError`` on a KC-LOC violation."""
    if not tile_loc_ok(m_tb, k_tb):
        raise ValueError(
            f"tile geometry ({m_tb},{k_tb}) needs {m_tb * k_tb} intra-tile "
            f"locations but the 16-bit loc field holds at most "
            f"{MAX_TILE_ELEMS}")


def smem_bytes(m_tb: int, k_tb: int, n_tb: int) -> int:
    """Dynamic shared memory of one block, the larger of the kernels' two
    layouts: f32 A and B tiles for f32 inputs (A rows padded by one word),
    bf16 A and transposed B tiles for bf16 ones (rows padded by 8)."""
    return max(4 * (m_tb * (k_tb + 1) + k_tb * n_tb),
               2 * (m_tb + n_tb) * (k_tb + 8))


def check_launch(m: int, k: int, n: int, *, m_tb: int, k_tb: int, n_tb: int,
                 split_k: int, group: int = 1) -> List[str]:
    """Problems with one launch (empty == the kernels take it)."""
    out: List[str] = []
    if not tile_loc_ok(m_tb, k_tb):
        out.append(f"KC-LOC: tile ({m_tb},{k_tb}) exceeds {MAX_TILE_ELEMS} "
                   "intra-tile locations")
    if m_tb not in M_TB_OPTIONS or k_tb not in K_TB_OPTIONS:
        out.append(f"KC-LAUNCH: tile ({m_tb},{k_tb}) not in "
                   f"{M_TB_OPTIONS}x{K_TB_OPTIONS}")
    elif m % m_tb or k % k_tb:
        out.append(f"KC-LAUNCH: dims (M={m}, K={k}) not tiled evenly by "
                   f"({m_tb},{k_tb})")
    if n_tb not in N_TB_OPTIONS:
        out.append(f"KC-LAUNCH: n_tb={n_tb} not in {N_TB_OPTIONS}")
    if group not in GROUP_OPTIONS:
        out.append(f"KC-LAUNCH: group size {group} not in {GROUP_OPTIONS}")
    kt = -(-k // k_tb) if k_tb >= 1 else 0
    if split_k < 1 or (kt and split_k > kt):
        out.append(f"KC-LAUNCH: split_k={split_k} outside [1, Kt={kt}]")
    if not out:
        smem = smem_bytes(m_tb, k_tb, n_tb)
        if smem > SMEM_BYTES_PER_BLOCK:
            out.append(f"KC-LAUNCH: {smem} B of shared memory exceeds the "
                       f"{SMEM_BYTES_PER_BLOCK} B a block may use")
        acc = group * m_tb * n_tb // THREADS
        if acc > MAX_ACC_PER_THREAD:
            out.append(f"KC-LAUNCH: {acc} accumulators per thread exceed "
                       f"{MAX_ACC_PER_THREAD} (group={group}, m_tb={m_tb}, "
                       f"n_tb={n_tb})")
    return out


def require_launch(m: int, k: int, n: int, **kw) -> None:
    """Raise :class:`ScheduleContractError` if the launch is invalid."""
    found = check_launch(m, k, n, **kw)
    if found:
        raise ScheduleContractError("; ".join(found))
