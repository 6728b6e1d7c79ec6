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
           ``MAX_ACC_PER_THREAD`` f32 accumulators per thread. An
           expert-batched launch (``experts`` E > 1: the MoE stacks'
           ``lscd_spmm_batched`` / ``lscd_spmm_splitk_batched``) takes one
           weight a stack and no binary epilogue, its grid's z extent
           (split x weights x experts) stays within ``MAX_GRID_Z``, and a
           split-K launch's f32 workspace ``[S, E, G, M, N]`` within
           ``MAX_SPLITK_WORKSPACE_BYTES``.

The LSCD kernels have three bodies, chosen by dtype and N tile: bf16 B
with ``n_tb <= DECODE_MAX_N_TB`` runs the decode body
(``csrc/lscd_decode.cuh``, :func:`decode_body`), whose shared memory
holds one dense A tile and a ring of word slots sized at launch from
``max_nnz`` (:func:`decode_ring_depth`, :func:`decode_smem_bytes`); bf16
B with ``n_tb >= 64`` runs the pipelined mainloop
(``csrc/hopper_pipe.cuh``, :func:`pipelined`), where two consumer
warpgroups hold the wgmma accumulators (:func:`pipe_acc_per_thread`).
In both bf16 bodies a block holds one weight, or the pair of a binary
epilogue, and walks at most ``MAX_PIPE_STEPS`` (K tile, weight) steps.
f32 launches run the first body, where a block holds all G weights.
:func:`launch_resident` is the occupancy the schedule's cost model
reads. The dense GEMM baseline (``csrc/dense_gemm.cu``) takes
``n_tb`` in ``GEMM_N_TB_OPTIONS`` and dims that tile evenly; its bf16
kernel runs the pipelined mainloop with A by TMA, a ring of
``GEMM_K_STAGE``-deep stages as deep as shared memory allows
(:func:`gemm_stages`) and up to ``GEMM_MAX_ACC`` accumulators a consumer
thread (:func:`check_gemm`, the counterpart of the JAX kernel's KC-VMEM
check).
"""

from __future__ import annotations

from typing import List, Optional

#: 16-bit intra-tile location capacity of the packed Tiled-CSL word.
MAX_TILE_ELEMS = 65536

#: Shared memory one block may use on an H100 (232,448 bytes).
SMEM_BYTES_PER_BLOCK = 232448

#: Threads per block of the first body and the split-K reduce
#: (csrc/lscd_common.cuh).
THREADS = 256

#: f32 accumulators a thread may hold (:func:`acc_per_thread`).
MAX_ACC_PER_THREAD = 64

#: Tile sizes the kernels are instantiated for.
M_TB_OPTIONS = (64, 128)
K_TB_OPTIONS = (64, 128)
N_TB_OPTIONS = (8, 16, 32, 64, 128)
GROUP_OPTIONS = (1, 2, 3)

#: Smallest N tile of the pipelined body (bf16 only).
PIPE_MIN_N_TB = 64
#: Ring slots, live-step list entries and shared-memory alignment (the
#: 128-byte swizzle's 1 KB period) of the pipelined body; each slot has a
#: full and an empty mbarrier of 8 bytes.
PIPE_STAGES = 3
MAX_PIPE_STEPS = 2048
PIPE_SMEM_ALIGN = 1024
PIPE_BAR_BYTES = 16
#: N tiles of the dense GEMM baseline.
GEMM_N_TB_OPTIONS = (64, 128, 256)
#: The dense GEMM's bf16 ring: stages 64 deep in K, at most 8 of them,
#: beside 32 KB that stage the epilogue's TMA stores; its consumer threads
#: hold up to 128 f32 accumulators (setmaxnreg gives them 232 registers);
#: its f32 tile, on CUDA cores, at most MAX_ACC_PER_THREAD.
GEMM_K_STAGE = 64
GEMM_MAX_STAGES = 8
GEMM_EPI_BYTES = 32768
GEMM_MAX_ACC = 128

#: Shared memory of one SM on an H100 (228 KB), the part the runtime keeps
#: per resident block, and the threads an SM holds.
SM_SMEM_BYTES = 233472
SMEM_RESERVED_PER_BLOCK = 1024
SM_THREADS = 2048
#: Threads per block of the pipelined LSCD body (four warpgroups; the
#: dense GEMM's block has three, since TMA brings its A).
PIPE_THREADS = 512

#: The decode body (bf16, n_tb <= 32): threads per block, static shared
#: memory (the live-step counts per warp, as ptxas reports it), the blocks
#: per SM its launch bounds leave registers for (``Geom::MIN_BLOCKS``) and
#: the deepest ring it takes.
DECODE_MAX_N_TB = 32
DECODE_THREADS = 256
DECODE_STATIC_SMEM = 128
DECODE_REG_BLOCKS = {8: 4, 16: 4, 32: 2}
DECODE_MAX_RING = 4

#: A grid's z extent on CUDA (the LSCD kernels put split x weights x
#: experts there).
MAX_GRID_Z = 65535
#: The split-K f32 workspace one launch may allocate.
MAX_SPLITK_WORKSPACE_BYTES = 1 << 30


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


def pipelined(n_tb: int, b_dtype_bytes: int = 2) -> bool:
    """Whether a launch runs the pipelined body (bf16 B, wide N tile)."""
    return b_dtype_bytes == 2 and n_tb >= PIPE_MIN_N_TB


def decode_body(n_tb: int, b_dtype_bytes: int = 2) -> bool:
    """Whether a launch runs the decode body (bf16 B, n_tb <= 32)."""
    return b_dtype_bytes == 2 and n_tb <= DECODE_MAX_N_TB


def body(n_tb: int, b_dtype_bytes: int = 2) -> str:
    """The body a launch runs: "decode", "pipelined" or "first" (f32)."""
    if decode_body(n_tb, b_dtype_bytes):
        return "decode"
    return "pipelined" if pipelined(n_tb, b_dtype_bytes) else "first"


def pipe_ring_bytes(m_tb: int, k_tb: int, n_tb: int) -> int:
    """The pipelined body's ring, PIPE_STAGES bf16 A and B tiles, and the
    slack that aligns it."""
    return PIPE_SMEM_ALIGN + PIPE_STAGES * 2 * (m_tb * k_tb + k_tb * n_tb)


def pipe_acc_per_thread(m_tb: int, n_tb: int, weights: int = 1) -> int:
    """f32 accumulators a consumer thread holds in the pipelined body: two
    consumer warpgroups split the tile into 64-row, then 64-column parts
    (one multiplies a 64 x 64 tile), and a wgmma of N columns keeps N / 2
    per thread and weight."""
    wg_m = m_tb // 64
    wg_n = min(2 // wg_m, n_tb // 64)
    return weights * (n_tb // wg_n) // 2


def decode_smem_bytes(m_tb: int, k_tb: int, n_tb: int, max_nnz: int,
                      depth: int, steps: int) -> int:
    """Shared memory of one decode-body block (``ldec::Layout``): one bf16
    A tile, ``depth + 1`` B slots, ``depth`` word slots of ``max_nnz``
    words with an 8-byte mbarrier each, the live-step list (4 bytes a
    step) and the static per-warp counts. A dense tile (``max_nnz ==
    m_tb * k_tb``) needs 64 KB a word slot at 128 x 128."""
    return (2 * m_tb * k_tb + 2 * (depth + 1) * k_tb * n_tb
            + depth * (4 * max_nnz + 8) + 4 * steps + DECODE_STATIC_SMEM)


def resident_blocks(smem: int, threads: int) -> int:
    """Blocks of ``smem`` bytes and ``threads`` threads one SM holds at once
    by shared memory and threads."""
    return min(SM_SMEM_BYTES // (smem + SMEM_RESERVED_PER_BLOCK),
               SM_THREADS // threads)


def decode_resident(m_tb: int, k_tb: int, n_tb: int, max_nnz: int,
                    depth: int, steps: int) -> int:
    """Decode-body blocks an SM holds with a ``depth``-slot ring: shared
    memory, threads and the registers the launch bounds leave."""
    smem = decode_smem_bytes(m_tb, k_tb, n_tb, max_nnz, depth, steps)
    return min(resident_blocks(smem, DECODE_THREADS),
               DECODE_REG_BLOCKS[n_tb])


def decode_ring_depth(m_tb: int, k_tb: int, n_tb: int, max_nnz: int,
                      steps: int) -> int:
    """Word slots of the decode body's ring: the deepest ring, up to
    ``DECODE_MAX_RING``, that keeps as many blocks on an SM as one slot
    does (one slot and four blocks at 0.8 sparsity and n_tb <= 16; one slot
    and two blocks for a dense tile). Resident blocks hide more than depth
    does (PERF.md, PR 13). 0 if not even one slot fits a block."""
    fits = [d for d in range(1, DECODE_MAX_RING + 1)
            if decode_smem_bytes(m_tb, k_tb, n_tb, max_nnz, d, steps)
            <= SMEM_BYTES_PER_BLOCK]
    if not fits:
        return 0
    most = decode_resident(m_tb, k_tb, n_tb, max_nnz, 1, steps)
    return max(d for d in fits
               if decode_resident(m_tb, k_tb, n_tb, max_nnz, d, steps) == most)


def smem_bytes(m_tb: int, k_tb: int, n_tb: int, b_dtype_bytes: int = 2,
               max_nnz: Optional[int] = None,
               steps: int = MAX_PIPE_STEPS) -> int:
    """Dynamic shared memory of one LSCD block. Decode body: its ring at
    the depth :func:`decode_ring_depth` picks for ``max_nnz`` (a dense
    tile where it is not given) and ``steps``. Pipelined: the ring plus
    the live-step list (4 bytes a step). First body: f32 A and B tiles (A
    rows padded by one word)."""
    if decode_body(n_tb, b_dtype_bytes):
        mnz = m_tb * k_tb if max_nnz is None else max_nnz
        depth = max(1, decode_ring_depth(m_tb, k_tb, n_tb, mnz, steps))
        return decode_smem_bytes(m_tb, k_tb, n_tb, mnz, depth, steps)
    if pipelined(n_tb, b_dtype_bytes):
        return (pipe_ring_bytes(m_tb, k_tb, n_tb)
                + PIPE_BAR_BYTES * PIPE_STAGES + 4 * MAX_PIPE_STEPS)
    return 4 * (m_tb * (k_tb + 1) + k_tb * n_tb)


def block_groups(group: int, n_tb: int, b_dtype_bytes: int = 2,
                 binary: bool = False) -> int:
    """Weights one block accumulates: all G in the first body (f32); one,
    or the pair of a binary epilogue, in the bf16 bodies."""
    if b_dtype_bytes == 2:
        return 2 if binary else 1
    return group


def acc_per_thread(m_tb: int, n_tb: int, weights: int,
                   b_dtype_bytes: int = 2) -> int:
    """f32 accumulators a thread holds: 4 per n8 tile and weight in the
    decode body (a warp owns a 16-row strip and all N_TB columns);
    :func:`pipe_acc_per_thread` in the pipelined one; the block's share of
    the tile in the first body."""
    if decode_body(n_tb, b_dtype_bytes):
        return weights * 4 * (n_tb // 8)
    if pipelined(n_tb, b_dtype_bytes):
        return pipe_acc_per_thread(m_tb, n_tb, weights)
    return weights * m_tb * n_tb // THREADS


def splitk_workspace_bytes(m: int, n: int, *, n_tb: int, split_k: int,
                           group: int = 1, experts: int = 1) -> int:
    """The f32 partials ``[S, E, G, M, N]`` (N padded to the N tile) of a
    split-K launch; 0 for a single-pass one."""
    if split_k <= 1:
        return 0
    return 4 * split_k * experts * group * m * (-(-n // n_tb) * n_tb)


def check_launch(m: int, k: int, n: int, *, m_tb: int, k_tb: int, n_tb: int,
                 split_k: int, group: int = 1, binary: bool = False,
                 b_dtype_bytes: int = 2,
                 max_nnz: Optional[int] = None,
                 experts: int = 1) -> List[str]:
    """Problems with one launch (empty == the kernels take it).
    ``binary``: a silu_mul/gelu_mul epilogue combining a G=2 pair;
    ``b_dtype_bytes``: 2 for bf16 B and C, 4 for f32; ``max_nnz``: the
    encoding's word slots per tile (the decode body copies whole 16-byte
    chunks of them and sizes its ring from them; a dense tile if not
    given); ``experts``: the stacks of an expert-batched launch."""
    out: List[str] = []
    if experts < 1:
        out.append(f"KC-LAUNCH: {experts} experts")
    elif experts > 1 and (group != 1 or binary):
        out.append(f"KC-LAUNCH: an expert-batched launch takes one weight a "
                   f"stack and no binary epilogue (group {group})")
    elif split_k * group * experts > MAX_GRID_Z:
        out.append(f"KC-LAUNCH: grid z = split {split_k} x {group} weights x "
                   f"{experts} experts exceeds {MAX_GRID_Z}")
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
    if binary and group != 2:
        out.append(f"KC-LAUNCH: a binary epilogue needs group 2, got {group}")
    if b_dtype_bytes not in (2, 4):
        out.append(f"KC-LAUNCH: B of {b_dtype_bytes}-byte elements; the "
                   "kernels take bf16 (2) and f32 (4)")
    kt = -(-k // k_tb) if k_tb >= 1 else 0
    if split_k < 1 or (kt and split_k > kt):
        out.append(f"KC-LAUNCH: split_k={split_k} outside [1, Kt={kt}]")
    decode = decode_body(n_tb, b_dtype_bytes)
    if decode and max_nnz is not None and (max_nnz < 1 or max_nnz % 4):
        out.append(f"KC-LAUNCH: max_nnz={max_nnz} is not a positive multiple "
                   "of 4; the decode body copies 16-byte chunks of words")
    if not out:
        gb = block_groups(group, n_tb, b_dtype_bytes, binary)
        steps = -(-kt // split_k) * gb
        smem = smem_bytes(m_tb, k_tb, n_tb, b_dtype_bytes, max_nnz, steps)
        if smem > SMEM_BYTES_PER_BLOCK:
            out.append(f"KC-LAUNCH: {smem} B of shared memory exceeds the "
                       f"{SMEM_BYTES_PER_BLOCK} B a block may use")
        acc = acc_per_thread(m_tb, n_tb, gb, b_dtype_bytes)
        if acc > MAX_ACC_PER_THREAD:
            out.append(f"KC-LAUNCH: {acc} accumulators per thread exceed "
                       f"{MAX_ACC_PER_THREAD} ({gb} weights per block, "
                       f"m_tb={m_tb}, n_tb={n_tb})")
        if b_dtype_bytes == 2 and steps > MAX_PIPE_STEPS:
            out.append(f"KC-LAUNCH: {steps} (K tile, weight) steps per "
                       f"block exceed the {MAX_PIPE_STEPS} of the bf16 "
                       "bodies' step list")
        ws = splitk_workspace_bytes(m, n, n_tb=n_tb, split_k=split_k,
                                    group=group, experts=experts)
        if ws > MAX_SPLITK_WORKSPACE_BYTES:
            out.append(f"KC-LAUNCH: a {ws} B split-K workspace exceeds "
                       f"{MAX_SPLITK_WORKSPACE_BYTES} B")
    return out


def launch_resident(k: int, *, m_tb: int, k_tb: int, n_tb: int,
                    split_k: int, group: int = 1, binary: bool = False,
                    b_dtype_bytes: int = 2,
                    max_nnz: Optional[int] = None) -> int:
    """Blocks of one launch that an SM holds at once (the schedule's
    occupancy term): the decode body's from its ring
    (:func:`decode_resident`), the other bodies' from shared memory and
    threads."""
    kt = -(-k // k_tb)
    steps = -(-kt // split_k) * block_groups(group, n_tb, b_dtype_bytes,
                                             binary)
    if decode_body(n_tb, b_dtype_bytes):
        mnz = m_tb * k_tb if max_nnz is None else max_nnz
        depth = decode_ring_depth(m_tb, k_tb, n_tb, mnz, steps)
        return decode_resident(m_tb, k_tb, n_tb, mnz, max(depth, 1), steps)
    threads = PIPE_THREADS if pipelined(n_tb, b_dtype_bytes) else THREADS
    return resident_blocks(smem_bytes(m_tb, k_tb, n_tb, b_dtype_bytes),
                           threads)


def require_launch(m: int, k: int, n: int, **kw) -> None:
    """Raise :class:`ScheduleContractError` if the launch is invalid."""
    found = check_launch(m, k, n, **kw)
    if found:
        raise ScheduleContractError("; ".join(found))


def gemm_stages(m_tb: int, n_tb: int) -> int:
    """Stages of the dense GEMM's bf16 ring (``hpipe::DenseRing``): as
    many ``GEMM_K_STAGE``-deep stages, each an A and a B tile and two
    mbarriers, as one block's shared memory holds after the alignment
    slack and the epilogue's staging, at most ``GEMM_MAX_STAGES``: 4 at
    128 x 256, 6 at 128 x 128."""
    stage = 2 * GEMM_K_STAGE * (m_tb + n_tb) + PIPE_BAR_BYTES
    return min(GEMM_MAX_STAGES, (SMEM_BYTES_PER_BLOCK - PIPE_SMEM_ALIGN
                                 - GEMM_EPI_BYTES) // stage)


def gemm_smem_bytes(m_tb: int, k_tb: int, n_tb: int,
                    dtype_bytes: int = 2) -> int:
    """Dynamic shared memory of one dense GEMM block: the bf16 ring
    (:func:`gemm_stages`, whatever ``k_tb``) and the epilogue's staging,
    or the f32 A and B tiles."""
    if dtype_bytes == 2:
        stages = gemm_stages(m_tb, n_tb)
        return (PIPE_SMEM_ALIGN + GEMM_EPI_BYTES
                + stages * (2 * GEMM_K_STAGE * (m_tb + n_tb) + PIPE_BAR_BYTES))
    return 4 * (m_tb * (k_tb + 1) + k_tb * n_tb)


def gemm_acc_per_thread(m_tb: int, n_tb: int, dtype_bytes: int = 2) -> int:
    """f32 accumulators a dense GEMM thread holds: a consumer's wgmma part
    for bf16 (:func:`pipe_acc_per_thread`; 128 at 128 x 256), the block's
    share of the tile on CUDA cores for f32."""
    if dtype_bytes == 2:
        return pipe_acc_per_thread(m_tb, n_tb)
    return m_tb * n_tb // THREADS


def check_gemm(m: int, k: int, n: int, *, m_tb: int, k_tb: int, n_tb: int,
               dtype_bytes: int = 2) -> List[str]:
    """Problems with one dense GEMM launch (empty == the kernel takes it)."""
    out: List[str] = []
    if (m_tb not in M_TB_OPTIONS or k_tb not in K_TB_OPTIONS
            or n_tb not in GEMM_N_TB_OPTIONS):
        out.append(f"KC-LAUNCH: dense_gemm tile ({m_tb},{k_tb},{n_tb}) not "
                   f"in {M_TB_OPTIONS}x{K_TB_OPTIONS}x{GEMM_N_TB_OPTIONS}")
        return out
    if m % m_tb or k % k_tb or n % n_tb:
        out.append(f"KC-LAUNCH: dense_gemm shape {(m, k, n)} not tile-aligned "
                   f"to ({m_tb},{k_tb},{n_tb})")
    smem = gemm_smem_bytes(m_tb, k_tb, n_tb, dtype_bytes)
    if smem > SMEM_BYTES_PER_BLOCK:
        out.append(f"KC-LAUNCH: dense_gemm tile ({m_tb},{k_tb},{n_tb}) needs "
                   f"{smem} B of shared memory, more than "
                   f"{SMEM_BYTES_PER_BLOCK} B")
    acc = gemm_acc_per_thread(m_tb, n_tb, dtype_bytes)
    most = GEMM_MAX_ACC if dtype_bytes == 2 else MAX_ACC_PER_THREAD
    if acc > most:
        out.append(f"KC-LAUNCH: dense_gemm tile ({m_tb},{k_tb},{n_tb}) holds "
                   f"{acc} accumulators a thread for {dtype_bytes}-byte "
                   f"inputs, more than {most}")
    return out


def require_gemm(m: int, k: int, n: int, **kw) -> None:
    """Raise :class:`ScheduleContractError` (a ``ValueError``) if the dense
    GEMM launch is invalid."""
    found = check_gemm(m, k, n, **kw)
    if found:
        raise ScheduleContractError("; ".join(found))
