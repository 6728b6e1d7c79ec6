"""Flash-LLM LSCD SpMM on Hopper: wrappers around the CUDA kernels.

The port's counterpart of ``repro.kernels.spmm``. Four raw kernel
entries, each a hand-written CUDA C++ kernel in ``csrc/`` (built by
``kernels/build.py``):

* :func:`lscd_spmm` — ``C = epi(decode(A) @ B + bias)``, one pass;
* :func:`lscd_spmm_grouped` — G same-shape weights against one B, unary
  epilogues per group or a binary one (``silu_mul``/``gelu_mul``)
  combining the G=2 pair;
* :func:`lscd_spmm_splitk` / :func:`lscd_spmm_splitk_grouped` — K split
  over S slices into f32 partials, then a reduce that sums the slices in
  order and applies bias + epilogue with one cast;
* :func:`lscd_spmm_batched` / :func:`lscd_spmm_splitk_batched` — the MoE
  expert stacks: ``C[e] = decode(A[e]) @ B[e]`` for the E experts of a
  stacked Tiled-CSL weight in one launch (one partials launch and one
  reduce for split-K), the counterpart of ``jax.vmap`` over the first and
  third in ``repro.models.moe``; no bias, no epilogue.

Every entry takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates its outputs (and the split-K workspace) with
``torch.empty``, launches on the current stream, raises if the launch
returns a CUDA error, and adds one to its entry in :data:`LAUNCHES`.
Their plain PyTorch versions live in ``kernels/ref.py``; ``kernels/ops``
picks between the two by the tensor's device.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.analysis import contracts

# ---------------------------------------------------------------------------
# epilogue registry (shared by the kernels, the plain versions and models)
# ---------------------------------------------------------------------------

# "gelu" is the tanh form: jax.nn.gelu defaults to approximate=True.
_EPILOGUES = {
    "none": lambda x: x,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
}

# Binary epilogues combine the (group 0, group 1) accumulators of a G=2
# grouped call into one output.
_BINARY_EPILOGUES = {
    "silu_mul": lambda a, b: F.silu(a) * b,
    "gelu_mul": lambda a, b: F.gelu(a, approximate="tanh") * b,
}

# Codes the CUDA kernels switch on (csrc/lscd_common.cuh: enum Epilogue).
EPILOGUE_CODES = {"none": 0, "silu": 1, "gelu": 2, "relu": 3,
                  "silu_mul": 4, "gelu_mul": 5}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def apply_epilogue(name: str, *accs: torch.Tensor) -> torch.Tensor:
    """One accumulator for unary names, the (group 0, group 1) pair for
    binary names."""
    if name in _BINARY_EPILOGUES:
        a, b = accs
        return _BINARY_EPILOGUES[name](a, b)
    return _EPILOGUES[name](*accs)


def epilogue_kind(name: str, *, groups: int = 1) -> str:
    """Validate ``name`` -> "unary" | "binary"; binary needs groups == 2."""
    if name in _EPILOGUES:
        return "unary"
    if name in _BINARY_EPILOGUES:
        if groups != 2:
            raise ValueError(
                f"binary epilogue {name!r} combines exactly 2 grouped "
                f"outputs, got group size {groups}")
        return "binary"
    known = sorted(_EPILOGUES) + sorted(_BINARY_EPILOGUES)
    raise ValueError(f"unknown epilogue {name!r}; known: {known}")


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------

# One weight (or projection group) against one B; expert stacks, each
# expert against its own B.
WEIGHT_KERNELS = ("lscd_spmm", "lscd_spmm_grouped", "lscd_spmm_splitk",
                  "lscd_spmm_splitk_grouped")
BATCHED_KERNELS = ("lscd_spmm_batched", "lscd_spmm_splitk_batched")
KERNELS = WEIGHT_KERNELS + BATCHED_KERNELS
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


# ---------------------------------------------------------------------------
# raw kernel entries
# ---------------------------------------------------------------------------

def _check_operands(t, b: torch.Tensor, out_dtype) -> None:
    """Device, contiguity and dtypes of the words, counts and B."""
    for name, x in (("words", t.words), ("nnz", t.nnz), ("B", b)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.device != b.device:
            raise ValueError(f"{name} on {x.device}, B on {b.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t.words.dtype != torch.int32 or t.nnz.dtype != torch.int32:
        raise ValueError("words and nnz must be int32")
    if b.dtype not in _DTYPE_CODES:
        raise ValueError(f"B dtype {b.dtype} not in {list(_DTYPE_CODES)}")
    if out_dtype != b.dtype:
        raise ValueError(f"out dtype {out_dtype} must equal B dtype {b.dtype}")


def _check_alignment(t, b: torch.Tensor, n_tb: int) -> None:
    body = contracts.body(n_tb, b.element_size())
    if body != "first" and b.data_ptr() % 16:
        raise ValueError(f"B must be 16-byte aligned for the {body} body")
    if body == "decode" and t.words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned for the decode body")


def _check(t, b: torch.Tensor, n_tb: int, split_k: int, out_dtype,
           bias: Optional[torch.Tensor], groups: int,
           epilogue: str) -> Optional[torch.Tensor]:
    """Raise on anything the kernels do not take; returns the f32 bias."""
    if t.stack:
        raise ValueError("an expert stack: use lscd_spmm_batched / "
                         "lscd_spmm_splitk_batched")
    _check_operands(t, b, out_dtype)
    m, k = t.shape
    if b.dim() != 2 or b.shape[0] != k:
        raise ValueError(f"B shape {tuple(b.shape)} does not match K={k}")
    n = b.shape[1]
    if n % n_tb:
        raise ValueError(f"N={n} not a multiple of n_tb={n_tb}")
    mt, kt = t.grid
    lead = (groups,) if t.group is not None else ()
    if tuple(t.nnz.shape) != lead + (mt, kt) or \
            tuple(t.words.shape[:-1]) != lead + (mt, kt):
        raise ValueError("words/nnz shapes do not match the tile grid")
    binary = epilogue in _BINARY_EPILOGUES
    contracts.require_launch(m, k, n, m_tb=t.m_tb, k_tb=t.k_tb, n_tb=n_tb,
                             split_k=split_k, group=groups, binary=binary,
                             b_dtype_bytes=b.element_size(),
                             max_nnz=t.max_nnz)
    _check_alignment(t, b, n_tb)
    if bias is None:
        return None
    if bias.device != b.device:
        raise ValueError(f"bias on {bias.device}, B on {b.device}")
    want = lead + (m,)
    if tuple(bias.shape) != want:
        raise ValueError(f"bias shape {tuple(bias.shape)} != {want}")
    return bias.to(torch.float32).contiguous()


def ring_depth(t, n_tb: int, split_k: int, groups: int, epilogue: str,
               b_dtype_bytes: int = 2) -> int:
    """Word slots of the decode body's ring for this launch (0 for the
    other bodies)."""
    if not contracts.decode_body(n_tb, b_dtype_bytes):
        return 0
    gb = contracts.block_groups(groups, n_tb, b_dtype_bytes,
                                epilogue in _BINARY_EPILOGUES)
    steps = -(-t.grid[1] // split_k) * gb
    return contracts.decode_ring_depth(t.m_tb, t.k_tb, n_tb, t.max_nnz, steps)


def _launch(name: str, t, b, *, n_tb: int, split_k: int, out_dtype,
            epilogue: str, bias, groups: int, out_shape) -> torch.Tensor:
    from repro_torch.kernels import build   # builds with nvcc at first use
    bias = _check(t, b, n_tb, split_k, out_dtype, bias, groups, epilogue)
    m, k = t.shape
    n = b.shape[1]
    out = torch.empty(out_shape, dtype=out_dtype, device=b.device)
    partials = None
    if name.startswith("lscd_spmm_splitk"):
        partials = torch.empty((split_k, groups, m, n), dtype=torch.float32,
                               device=b.device)
    fn = build.entry(name)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    rc = fn(t.words.data_ptr(), t.nnz.data_ptr(), b.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if partials is None else partials.data_ptr(),
            out.data_ptr(), groups, m, k, n, t.m_tb, t.k_tb, n_tb,
            t.max_nnz, split_k, _DTYPE_CODES[b.dtype],
            EPILOGUE_CODES[epilogue],
            ring_depth(t, n_tb, split_k, groups, epilogue, b.element_size()),
            stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def lscd_spmm(t, b: torch.Tensor, *, n_tb: int = 128, out_dtype=None,
              epilogue: str = "none",
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw single-pass kernel: C[M, N]. Requires N % n_tb == 0."""
    if t.group is not None:
        raise ValueError("grouped TiledCSL: use lscd_spmm_grouped")
    epilogue_kind(epilogue)
    return _launch("lscd_spmm", t, b, n_tb=n_tb, split_k=1,
                   out_dtype=out_dtype or b.dtype, epilogue=epilogue,
                   bias=bias, groups=1, out_shape=(t.shape[0], b.shape[1]))


def _grouped_shape(t, b, epilogue: str):
    kind = epilogue_kind(epilogue, groups=t.group)
    m, n = t.shape[0], b.shape[1]
    return (m, n) if kind == "binary" else (t.group, m, n)


def lscd_spmm_grouped(t, b: torch.Tensor, *, n_tb: int = 128,
                      out_dtype=None, epilogue: str = "none",
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw grouped kernel: C[G, M, N] (unary) or C[M, N] (binary)."""
    if t.group is None:
        raise ValueError("ungrouped TiledCSL: use lscd_spmm")
    return _launch("lscd_spmm_grouped", t, b, n_tb=n_tb, split_k=1,
                   out_dtype=out_dtype or b.dtype, epilogue=epilogue,
                   bias=bias, groups=t.group,
                   out_shape=_grouped_shape(t, b, epilogue))


def lscd_spmm_splitk(t, b: torch.Tensor, *, n_tb: int = 128,
                     split_k: int = 2, out_dtype=None,
                     epilogue: str = "none",
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw split-K pair (partials + reduce): C[M, N]."""
    if t.group is not None:
        raise ValueError("grouped TiledCSL: use lscd_spmm_splitk_grouped")
    epilogue_kind(epilogue)
    return _launch("lscd_spmm_splitk", t, b, n_tb=n_tb, split_k=split_k,
                   out_dtype=out_dtype or b.dtype, epilogue=epilogue,
                   bias=bias, groups=1, out_shape=(t.shape[0], b.shape[1]))


def lscd_spmm_splitk_grouped(t, b: torch.Tensor, *, n_tb: int = 128,
                             split_k: int = 2, out_dtype=None,
                             epilogue: str = "none",
                             bias: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Raw grouped split-K pair: C[G, M, N] (unary) or C[M, N] (binary)."""
    if t.group is None:
        raise ValueError("ungrouped TiledCSL: use lscd_spmm_splitk")
    return _launch("lscd_spmm_splitk_grouped", t, b, n_tb=n_tb,
                   split_k=split_k, out_dtype=out_dtype or b.dtype,
                   epilogue=epilogue, bias=bias, groups=t.group,
                   out_shape=_grouped_shape(t, b, epilogue))


def _check_batched(t, b: torch.Tensor, n_tb: int, split_k: int,
                   out_dtype) -> None:
    """Raise on an expert-batched launch the kernels do not take."""
    if not t.stack:
        raise ValueError("lscd_spmm_batched needs an expert stack "
                         "(tiled_csl.encode_stack)")
    _check_operands(t, b, out_dtype)
    e, (m, k), (mt, kt) = t.experts, t.shape, t.grid
    if b.dim() != 3 or b.shape[0] != e or b.shape[1] != k:
        raise ValueError(f"B shape {tuple(b.shape)} is not [E={e}, K={k}, N]")
    n = b.shape[2]
    if n % n_tb:
        raise ValueError(f"N={n} not a multiple of n_tb={n_tb}")
    if tuple(t.nnz.shape) != (e, mt, kt) or \
            tuple(t.words.shape[:-1]) != (e, mt, kt):
        raise ValueError("words/nnz shapes do not match the tile grid")
    contracts.require_launch(m, k, n, m_tb=t.m_tb, k_tb=t.k_tb, n_tb=n_tb,
                             split_k=split_k, b_dtype_bytes=b.element_size(),
                             max_nnz=t.max_nnz, experts=e)
    _check_alignment(t, b, n_tb)


def _launch_batched(name: str, t, b, *, n_tb: int, split_k: int,
                    out_dtype) -> torch.Tensor:
    from repro_torch.kernels import build   # builds with nvcc at first use
    _check_batched(t, b, n_tb, split_k, out_dtype)
    e, (m, k), n = t.experts, t.shape, b.shape[2]
    out = torch.empty((e, m, n), dtype=out_dtype, device=b.device)
    partials = None
    if split_k > 1:
        partials = torch.empty((split_k, e, m, n), dtype=torch.float32,
                               device=b.device)
    fn = build.entry(name)
    stream = torch.cuda.current_stream(b.device).cuda_stream
    rc = fn(t.words.data_ptr(), t.nnz.data_ptr(), b.data_ptr(),
            None if partials is None else partials.data_ptr(),
            out.data_ptr(), e, m, k, n, t.m_tb, t.k_tb, n_tb, t.max_nnz,
            split_k, _DTYPE_CODES[b.dtype],
            ring_depth(t, n_tb, split_k, 1, "none", b.element_size()),
            stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1
    return out


def lscd_spmm_batched(t, b: torch.Tensor, *, n_tb: int = 128,
                      out_dtype=None) -> torch.Tensor:
    """Raw expert-batched kernel: C[E, M, N], C[e] = decode(A[e]) @ B[e],
    for an expert stack ``t`` and B ``[E, K, N]``, in one launch.
    Requires N % n_tb == 0."""
    return _launch_batched("lscd_spmm_batched", t, b, n_tb=n_tb, split_k=1,
                           out_dtype=out_dtype or b.dtype)


def lscd_spmm_splitk_batched(t, b: torch.Tensor, *, n_tb: int = 128,
                             split_k: int = 2,
                             out_dtype=None) -> torch.Tensor:
    """Raw expert-batched split-K pair: f32 partials [S, E, M, N] in one
    launch, then one reduce into C[E, M, N]."""
    return _launch_batched("lscd_spmm_splitk_batched", t, b, n_tb=n_tb,
                           split_k=split_k, out_dtype=out_dtype or b.dtype)
