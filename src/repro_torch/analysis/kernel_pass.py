"""Kernel contract pass: selector sweep, CUDA-source and call-site checks.

The counterpart of ``repro.analysis.kernel_pass``, in three parts:

* **Selector audit** (:func:`audit_selector`) — the reference's six
  canonical serving shapes through ``schedule.select`` and
  ``contracts.check_launch`` (rules KC-LOC / KC-LAUNCH): selection must
  only ever emit launches the CUDA kernels take. The candidate ladder is
  swept too; the candidates the contract drops are expected (the ladder
  over-generates, ``select`` filters) and are counted as stats. On the
  card, :func:`audit_schedules` also holds the live schedule cache
  (``ops.SCHEDULES``, what the served model picked) against the contract
  at each weight's own ``max_nnz``.

* **KC-ACC over the CUDA sources** (:func:`check_cuda_source`, every
  ``kernels/csrc/*.cu`` and ``*.cuh``) — every ``wgmma.mma_async`` and
  ``mma.sync`` PTX string names an f32 D type (and C type), every output
  operand of its ``asm`` statement is an f32 register (``"+f"``), and
  every accumulator array (``acc``) is declared ``float``: the tensor
  cores must accumulate in f32 (the reference's f32 VMEM scratch and
  ``preferred_element_type``).

* **KC-OUT over the model files** (:func:`check_declared_out`) — every
  ``sparse_linear.linear`` / ``linear_grouped`` call site declares its
  out dim, so the encode-time M padding is sliced off.
"""

from __future__ import annotations

import ast
import glob
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import budgets, contracts
from repro_torch.analysis.findings import Finding, apply_inline_ignores
from repro_torch.analysis.lint import _dotted
from repro_torch.core import tiled_csl

#: (label, m, k, n, sparsity, group): the reference's decode, verify,
#: prefill and SwiGLU cells (``repro.analysis.kernel_pass``), covering
#: every LSCD entry family the engine dispatches.
CANONICAL_SHAPES: Tuple[Tuple[str, int, int, int, float, int], ...] = (
    ("decode", 8192, 8192, 8, 0.8, 1),
    ("verify", 8192, 8192, 32, 0.8, 1),
    ("prefill", 8192, 8192, 2048, 0.8, 1),
    ("swiglu_decode", 8192, 8192, 8, 0.8, 2),
    ("swiglu_prefill", 8192, 8192, 2048, 0.8, 2),
    ("skinny_90", 4096, 4096, 8, 0.9, 1),
)

_TILE = (tiled_csl.DEFAULT_M_TB, tiled_csl.DEFAULT_K_TB)
_BF16 = 2                                # bytes of a B element


def _repo_root() -> str:
    # src/repro_torch/analysis/kernel_pass.py -> the repo is 3 dirs up
    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "..", ".."))


def canonical_max_nnz(sparsity: float, m_tb: int = _TILE[0],
                      k_tb: int = _TILE[1]) -> int:
    """Word slots of a tile at ``sparsity``, padded as ``tiled_csl.encode``
    pads them (a multiple of ``PAD_QUANTUM``)."""
    q = tiled_csl.PAD_QUANTUM
    return max(q, -(-round(m_tb * k_tb * (1.0 - sparsity)) // q) * q)


def contract_findings(problems: Sequence[str], path: str) -> List[Finding]:
    """``contracts.check_launch``'s strings ("KC-LAUNCH: ...") as
    findings under their prefix's rule."""
    out = []
    for p in problems:
        rule, _, msg = p.partition(": ")
        out.append(Finding(rule, path, 0, msg,
                           hint="select must only pick launches the CUDA "
                                "kernels take; see contracts.check_launch"))
    return out


def audit_selector(shapes: Sequence[Tuple[str, int, int, int, float, int]]
                   = CANONICAL_SHAPES
                   ) -> Tuple[List[Finding], Dict[str, int]]:
    """Validate the analytic selector's picks for bf16 B, the serving
    dtype; returns (findings, stats). A SwiGLU cell (group 2) is the
    binary ``silu_mul`` launch of the fused ``gate_up`` pair."""
    from repro_torch.kernels import schedule

    m_tb, k_tb = _TILE
    findings: List[Finding] = []
    stats = {"cells": 0, "candidates": 0, "filtered": 0,
             "smem_budget": budgets.smem_budget("cuda"), "max_smem": 0}
    for label, m, k, n, sparsity, group in shapes:
        stats["cells"] += 1
        kw = dict(group=group, binary=group == 2, b_dtype_bytes=_BF16,
                  max_nnz=canonical_max_nnz(sparsity, m_tb, k_tb))
        path = f"select:{label}(m={m},k={k},n={n},g={group})"
        try:
            sel = schedule.select(m, k, n, m_tb=m_tb, k_tb=k_tb,
                                  cache=False, **kw)
        except contracts.ScheduleContractError as e:
            findings.append(Finding("KC-LAUNCH", path, 0, str(e)))
            continue
        findings.extend(contract_findings(contracts.check_launch(
            m, k, n, m_tb=sel.m_tb, k_tb=sel.k_tb, n_tb=sel.n_tb,
            split_k=sel.split_k, **kw), path))
        gb = contracts.block_groups(group, sel.n_tb, _BF16, kw["binary"])
        kt = -(-k // k_tb)
        steps = -(-kt // sel.split_k) * gb
        stats["max_smem"] = max(stats["max_smem"], contracts.smem_bytes(
            m_tb, k_tb, sel.n_tb, _BF16, kw["max_nnz"], steps))
        for cand in schedule.candidates(m, k, n, m_tb=m_tb, k_tb=k_tb):
            stats["candidates"] += 1
            if contracts.check_launch(
                    m, k, n, m_tb=cand.m_tb, k_tb=cand.k_tb, n_tb=cand.n_tb,
                    split_k=cand.split_k, **kw):
                stats["filtered"] += 1
    return findings, stats


def encoded_weights(params, path: str = "") -> List[Tuple[str, object]]:
    """(path, Tiled-CSL leaf) of every encoded weight in a params tree."""
    if isinstance(params, tiled_csl.TiledCSL):
        return [(path, params)]
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = enumerate(params)
    else:
        return []
    return [w for key, sub in items
            for w in encoded_weights(sub, f"{path}/{key}")]


def audit_schedules(schedules: Dict[tuple, object], params
                    ) -> Tuple[List[Finding], Dict[str, object]]:
    """The live schedule cache (``ops.SCHEDULES``: (kind, M, K, N, group or
    experts) -> Schedule) against the launch contract at the ``max_nnz``
    of every weight of ``params`` with that (M, K), for bf16 B: the shared
    memory of the decode body's ring and its word copies depend on it. A
    pair pre-grouped as ``gate_up`` is a binary launch."""
    by_shape: Dict[Tuple[int, int], set] = {}
    for path, t in encoded_weights(params):
        by_shape.setdefault(tuple(t.shape), set()).add(
            (t.max_nnz, "/gate_up/" in path + "/"))
    findings: List[Finding] = []
    stats = {"schedules": 0, "weights_checked": 0, "targets": []}
    for (kind, m, k, n, g), sched in sorted(schedules.items(),
                                            key=lambda kv: str(kv[0])):
        stats["schedules"] += 1
        path = f"schedules:{kind}(m={m},k={k},n={n},g={g})"
        stats["targets"].append(path)
        batched = kind == "spmm_batched"
        for max_nnz, binary in sorted(by_shape.get((m, k), {(None, False)})):
            stats["weights_checked"] += 1
            findings.extend(contract_findings(contracts.check_launch(
                m, k, n, m_tb=sched.m_tb, k_tb=sched.k_tb, n_tb=sched.n_tb,
                split_k=sched.split_k, group=1 if batched else g,
                binary=binary and g == 2 and kind == "spmm_grouped",
                b_dtype_bytes=_BF16, max_nnz=max_nnz,
                experts=g if batched else 1), path))
    return findings, stats


# ---------------------------------------------------------------------------
# KC-ACC over the CUDA sources
# ---------------------------------------------------------------------------

#: a tensor-core instruction inside a PTX string.
_MMA_RE = re.compile(r"\b(wgmma\.mma_async|mma\.sync)((?:\.\w+)+)")
_PTX_TYPES = {"f16", "bf16", "f32", "f64", "tf32", "e4m3", "e5m2", "s32",
              "s8", "u8", "s4", "u4", "b1"}
#: an output operand of an asm statement: "+f"(...) / "=r"(...).
_ASM_OUT_RE = re.compile(r'"([+=])&?([a-zA-Z])"\s*\(')
#: a declaration of an accumulator array or reference named ``acc``.
_ACC_DECL_RE = re.compile(
    r"\b([A-Za-z_][\w:]*)\s*(?:\*\s*|\(\s*&\s*)?\bacc\b\s*[\[\),;]")
_NOT_TYPES = {"return", "sizeof", "case", "else", "do", "throw"}


def _strip_comments(src: str) -> str:
    """``src`` with C/C++ comments blanked (newlines kept, so offsets and
    line numbers hold); string and character literals are kept."""
    out, i, n = [], 0, len(src)
    while i < n:
        c = src[i]
        if c in "\"'":
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == "\\" else 1
            out.append(src[i:j + 1])
            i = j + 1
        elif src.startswith("//", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", src[i:j]))
            i = j
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _asm_block(code: str, pos: int) -> Tuple[int, int]:
    """[start, end) of the ``asm(...)`` statement holding offset ``pos``."""
    start = code.rfind("asm", 0, pos)
    open_ = code.find("(", start)
    depth, j = 0, open_
    while j < len(code):
        if code[j] == "(":
            depth += 1
        elif code[j] == ")":
            depth -= 1
            if depth == 0:
                return start, j + 1
        elif code[j] == '"':
            j = code.find('"', j + 1)
        j += 1
    return start, len(code)


def check_cuda_source(path: str, source: Optional[str] = None
                      ) -> Tuple[List[Finding], Dict[str, int]]:
    """KC-ACC over one CUDA source; returns (findings, sites checked by
    kind: ``ptx`` instructions, ``asm`` statements, ``acc``
    declarations)."""
    if source is None:
        with open(path) as f:
            source = f.read()
    rel = os.path.relpath(path, _repo_root()) if os.path.isabs(path) \
        else path
    code = _strip_comments(source)

    def line(pos: int) -> int:
        return code.count("\n", 0, pos) + 1

    findings: List[Finding] = []
    sites = {"ptx": 0, "asm": 0, "acc": 0}
    blocks = set()
    hint = "accumulate in f32 on the tensor cores; cast at the flush"
    for m in _MMA_RE.finditer(code):
        sites["ptx"] += 1
        instr = m.group(0)
        types = [t for t in m.group(2).split(".") if t in _PTX_TYPES]
        want = [types[0]] if types else []
        if m.group(1) == "mma.sync" and len(types) >= 4:
            want.append(types[-1])          # D, A, B, C: C too
        bad = [t for t in want if t != "f32"] or ([] if types else ["none"])
        if bad:
            findings.append(Finding(
                "KC-ACC", rel, line(m.start()),
                f"{instr} accumulates in {'/'.join(bad)}, not f32", hint))
        blocks.add(_asm_block(code, m.start()))
    for start, end in sorted(blocks):
        sites["asm"] += 1
        for o in _ASM_OUT_RE.finditer(code, start, end):
            if o.group(2) != "f":
                findings.append(Finding(
                    "KC-ACC", rel, line(o.start()),
                    f'tensor-core asm output operand "{o.group(1)}'
                    f'{o.group(2)}" is not an f32 register ("+f")', hint))
    for m in _ACC_DECL_RE.finditer(code):
        if m.group(1) in _NOT_TYPES:
            continue
        sites["acc"] += 1
        if m.group(1) != "float":
            findings.append(Finding(
                "KC-ACC", rel, line(m.start()),
                f"accumulator acc declared {m.group(1)}, not float", hint))
    return findings, sites


def cuda_source_files(repo_root: Optional[str] = None) -> List[str]:
    root = repo_root or _repo_root()
    csrc = os.path.join(root, "src", "repro_torch", "kernels", "csrc")
    return sorted(glob.glob(os.path.join(csrc, "*.cu"))
                  + glob.glob(os.path.join(csrc, "*.cuh")))


# ---------------------------------------------------------------------------
# KC-OUT over the model files
# ---------------------------------------------------------------------------

#: sparse_linear entry -> the declared-out keyword it requires.
_DECLARED_OUT_KW = {"linear": "declared_out",
                    "linear_grouped": "declared_outs"}


def check_declared_out(path: str, source: Optional[str] = None
                       ) -> List[Finding]:
    """KC-OUT over one model file (the reference's rule as it is)."""
    if source is None:
        with open(path) as f:
            source = f.read()
    rel = os.path.relpath(path, _repo_root()) if os.path.isabs(path) \
        else path
    out: List[Finding] = []
    for node in ast.walk(ast.parse(source, filename=path)):
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func)
        base = callee.rsplit(".", 1)[-1]
        if base not in _DECLARED_OUT_KW or "sparse_linear" not in callee:
            continue
        want = _DECLARED_OUT_KW[base]
        kws = {kw.arg for kw in node.keywords}
        if want not in kws and None not in kws:   # None == **kwargs splat
            out.append(Finding(
                "KC-OUT", rel, node.lineno,
                f"{callee}(...) call without {want}=",
                hint=f"pass {want} so the padded out dim is sliced to the "
                     f"true feature size"))
    return out


def model_files(repo_root: Optional[str] = None) -> List[str]:
    root = repo_root or _repo_root()
    return sorted(glob.glob(os.path.join(root, "src", "repro_torch",
                                         "models", "*.py")))


def audit_sources(repo_root: Optional[str] = None
                  ) -> Tuple[List[Finding], Dict[str, int]]:
    """KC-ACC over the CUDA sources, KC-OUT over the model files; returns
    (findings, sites checked)."""
    findings: List[Finding] = []
    sources: Dict[str, str] = {}
    sites = {"ptx": 0, "asm": 0, "acc": 0, "model_files": 0}
    for path in cuda_source_files(repo_root):
        with open(path) as f:
            src = f.read()
        found, n = check_cuda_source(path, src)
        for key, v in n.items():
            sites[key] += v
        findings.extend(found)
        if found:
            sources[found[0].path] = src
    for path in model_files(repo_root):
        with open(path) as f:
            src = f.read()
        sites["model_files"] += 1
        found = check_declared_out(path, src)
        findings.extend(found)
        if found:
            sources[found[0].path] = src
    return apply_inline_ignores(findings, sources), sites


def run_kernel_pass(repo_root: Optional[str] = None
                    ) -> Tuple[List[Finding], Dict[str, object]]:
    """The selector audit and the source checks; stats carry the
    ``targets`` audited (for the allowlist's staleness rule)."""
    root = repo_root or _repo_root()
    sel, stats = audit_selector()
    src, sites = audit_sources(root)
    stats.update(sites)
    stats["targets"] = (
        [f"select:{label}(m={m},k={k},n={n},g={g})"
         for label, m, k, n, _, g in CANONICAL_SHAPES]
        + [os.path.relpath(p, root) for p in cuda_source_files(root)
           + model_files(root)])
    return sel + src, stats
