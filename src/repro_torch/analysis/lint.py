"""AST lint over the port's ``serving/`` and ``models/``: sampling-noise
discipline, host-synchronising branches, batcher state-machine hazards
and step hot-path syncs.

The counterpart of ``repro.analysis.lint``. The serving noise contract is
the reference's key contract: a sampled token's noise is a pure function
of ``(seed, request uid, token index)`` — ``engine._slot_noise`` hashes
the three on the device — so streams replay bit for bit across admission
order, slot assignment, preemption and CUDA-graph replay. Two patterns
break it:

PK-FRESH  ``torch.Generator(...)`` or ``torch.manual_seed(...)`` inside a
          loop body in ``serving/``: a generator made a step is either
          constant or wall-clock seeded, and reseeding the global one
          resets every other draw.
PK-SPLIT  a draw from a stateful or global generator (``torch.rand*``,
          ``torch.multinomial``, ``torch.bernoulli``, ``Tensor.uniform_``
          / ``normal_`` / ``exponential_`` ...) inside a loop body in
          ``serving/``: token i then depends on every draw before it, the
          scheduling history, so a preempted and resumed request draws
          other tokens. Fold by ``(uid, token index)`` instead.
PK-REUSE  one seed name seeding two generators, or one (seed, uid, count)
          triple feeding two ``_slot_noise`` draws, without being rebound
          between them: the draws are perfectly correlated. (Everywhere.)

Generic hygiene (both trees):

PY-TRACED-BRANCH  an ``if``/``while`` test that calls a ``torch.*``
          function (``torch.any(x)``): on the card the branch waits for
          the device every step, and under CUDA-graph capture it raises.
          Static predicates are exempt: ``isinstance``,
          ``torch.is_tensor``, ``torch.cuda.is_available``, and dtype or
          device comparisons that only read attributes (``x.dtype ==
          torch.bfloat16``).
PY-MUT-DEFAULT    mutable default argument (shared across calls).
PY-DICT-MUT       a dict/list mutated (``del``/``pop``/item-assign) inside
          a ``for`` iterating it directly — RuntimeError at runtime.

Serving-only fault hygiene:

PY-SWALLOW  a bare ``except:`` or ``except Exception/BaseException`` in
          ``serving/`` whose handler neither re-raises nor references the
          bound exception (the reference's rule as it is).

Step hot-path sync discipline:

OB-SYNC   a host-synchronising call in ``serving/step.py``: ``.item()``
          and ``torch.cuda.synchronize`` anywhere in the file, and
          ``.cpu()`` / ``.numpy()`` / ``.tolist()`` inside a function
          named ``_*_step`` (the captured step bodies; the host wrappers
          bring results back on purpose). A deliberate measurement fence
          is annotated ``# repro: profiling-fence`` on the flagged line.

Suppression: inline ``# repro: ignore[RULE]`` on (or directly above) the
flagged line; OB-SYNC also honours ``# repro: profiling-fence``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.findings import Finding, apply_inline_ignores

#: torch functions that draw from the global (or a passed stateful)
#: generator.
DRAW_FNS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "multinomial", "bernoulli", "normal", "poisson",
}
#: Tensor methods that fill in place from a generator.
DRAW_METHODS = {
    "uniform_", "normal_", "exponential_", "bernoulli_", "random_",
    "geometric_", "log_normal_", "cauchy_",
}
#: torch calls whose result is known on the host without the device.
STATIC_TORCH = {
    "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
    "torch.is_grad_enabled", "torch.is_inference_mode_enabled",
    "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.cuda.is_available", "torch.cuda.is_current_stream_capturing",
    "torch.distributed.is_available", "torch.distributed.is_initialized",
}
#: The port's counter-based noise: (seed, uids, counts, ...).
NOISE_FNS = {"_slot_noise"}


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _iter_target_name(it: ast.AST) -> Optional[str]:
    """Name of the container a ``for`` iterates: ``for x in d`` /
    ``d.keys()`` / ``d.items()`` / ``d.values()`` -> "d"."""
    if isinstance(it, ast.Name):
        return it.id
    if (isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
            and it.func.attr in ("keys", "items", "values")
            and isinstance(it.func.value, ast.Name)):
        return it.func.value.id
    return None


def _is_draw(node: ast.Call) -> bool:
    callee = _dotted(node.func)
    if callee.startswith("torch.") and callee[6:] in DRAW_FNS:
        return True
    return (isinstance(node.func, ast.Attribute)
            and node.func.attr in DRAW_METHODS)


def _seed_uses(node: ast.Call) -> Optional[Tuple[str, ...]]:
    """The seed a call consumes, as a key of names: ``X.manual_seed(s)`` /
    ``torch.manual_seed(s)`` -> ("seed", "s"); ``_slot_noise(s, u, c)``
    -> ("noise", "s", "u", "c"). None for other calls or non-name
    arguments."""
    callee = _dotted(node.func)
    base = callee.rsplit(".", 1)[-1] if callee else (
        node.func.attr if isinstance(node.func, ast.Attribute) else "")
    if base == "manual_seed" and node.args and isinstance(node.args[0],
                                                          ast.Name):
        return ("seed", node.args[0].id)
    if base in NOISE_FNS and len(node.args) >= 3 and all(
            isinstance(a, ast.Name) for a in node.args[:3]):
        return ("noise",) + tuple(a.id for a in node.args[:3])
    return None


class _FileLinter(ast.NodeVisitor):
    def __init__(self, rel_path: str, serving: bool):
        self.rel = rel_path
        self.serving = serving
        self.step_file = serving and os.path.basename(rel_path) == "step.py"
        self.findings: List[Finding] = []
        self._loop_depth = 0
        self._iter_stack: List[str] = []   # containers under iteration
        self._fn_stack: List[str] = []     # enclosing function names

    def _add(self, rule: str, node: ast.AST, msg: str, hint: str) -> None:
        self.findings.append(Finding(rule, self.rel, node.lineno, msg, hint))

    # -- function-scope rules --------------------------------------------
    def _visit_function(self, node) -> None:
        for default in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(default, ast.Call)
                    and _dotted(default.func) in ("list", "dict", "set")):
                self._add("PY-MUT-DEFAULT", default,
                          f"mutable default in {node.name}()",
                          "default to None; create the container inside")
        self._check_seed_reuse(node)
        self._fn_stack.append(node.name)
        self.generic_visit(node)
        self._fn_stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def _check_seed_reuse(self, fn) -> None:
        """PK-REUSE: one seed key consumed twice with none of its names
        rebound anywhere in the function (conservative, as the
        reference's key rule: loops rebind per iteration)."""
        uses: Dict[Tuple[str, ...], List[ast.Call]] = {}
        rebound = set()

        def _scope_nodes(node):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                yield child
                yield from _scope_nodes(child)

        for sub in _scope_nodes(fn):
            if isinstance(sub, ast.Call):
                key = _seed_uses(sub)
                if key is not None:
                    uses.setdefault(key, []).append(sub)
            for tgt in getattr(sub, "targets", []) or (
                    [sub.target] if isinstance(
                        sub, (ast.AugAssign, ast.AnnAssign, ast.For)) else []):
                for leaf in ast.walk(tgt):
                    if isinstance(leaf, ast.Name):
                        rebound.add(leaf.id)
        for key, calls in uses.items():
            if len(calls) >= 2 and not rebound.intersection(key[1:]):
                what = ("seeds" if key[0] == "seed"
                        else "(seed, uid, count) fold feeds")
                self._add("PK-REUSE", calls[1],
                          f"{', '.join(key[1:])} {what} {len(calls)} "
                          f"generators/draws without rebinding — the draws "
                          f"are correlated",
                          "derive each draw's noise from its own (seed, uid, "
                          "token index) fold")

    # -- loop rules -------------------------------------------------------
    def visit_For(self, node: ast.For) -> None:
        self._iter_stack.append(_iter_target_name(node.iter) or "")
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1
        self._iter_stack.pop()

    def visit_While(self, node: ast.While) -> None:
        self._check_torch_branch(node, "while")
        self._loop_depth += 1
        self._iter_stack.append("")
        self.generic_visit(node)
        self._iter_stack.pop()
        self._loop_depth -= 1

    def visit_If(self, node: ast.If) -> None:
        self._check_torch_branch(node, "if")
        self.generic_visit(node)

    def _check_torch_branch(self, node, kw: str) -> None:
        static_ok = set()
        for sub in ast.walk(node.test):
            if isinstance(sub, ast.Call) and _dotted(sub.func) == "isinstance":
                for arg in sub.args:
                    static_ok.update(id(x) for x in ast.walk(arg))
        for sub in ast.walk(node.test):
            if id(sub) in static_ok or not isinstance(sub, ast.Call):
                continue
            d = _dotted(sub.func)
            if d.startswith("torch.") and d not in STATIC_TORCH:
                self._add("PY-TRACED-BRANCH", node,
                          f"`{kw}` test calls {d}() — the branch waits for "
                          f"the device, and breaks a CUDA-graph capture",
                          "keep the decision on the device (torch.where, "
                          "masked_fill) or on host values the caller "
                          "already has")
                return

    # -- call rules -------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        callee = _dotted(node.func)
        if self.serving and self._loop_depth:
            base = callee.rsplit(".", 1)[-1]
            if (callee.startswith("torch.") and base == "Generator") or \
                    callee in ("torch.manual_seed", "torch.cuda.manual_seed",
                               "torch.cuda.manual_seed_all"):
                self._add("PK-FRESH", node,
                          f"{callee}() inside a loop body",
                          "seed once (__init__ / API boundary); derive each "
                          "token's noise from (seed, uid, token index)")
            if _is_draw(node):
                self._add("PK-SPLIT", node,
                          f"{callee or node.func.attr}() draws from a "
                          f"stateful generator inside a serving loop — the "
                          f"stream depends on scheduling history",
                          "fold (seed, uid, token index): "
                          "engine._slot_noise / engine.sample_per_slot")
        if self.step_file:
            self._check_host_sync(node, callee)
        self.generic_visit(node)

    def _check_host_sync(self, node: ast.Call, callee: str) -> None:
        """OB-SYNC: host-synchronising calls in the engine step module."""
        hint = ("keep the step path async; a deliberate measurement fence "
                "is annotated `# repro: profiling-fence`")
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        if callee.endswith("cuda.synchronize"):
            self._add("OB-SYNC", node,
                      "torch.cuda.synchronize in the step module blocks the "
                      "host on the device", hint)
        elif attr == "item" and not node.args and not node.keywords:
            self._add("OB-SYNC", node,
                      ".item() forces a device->host transfer in the step "
                      "hot path", hint)
        elif (attr in ("cpu", "numpy", "tolist") and self._fn_stack
                and self._fn_stack[-1].startswith("_")
                and self._fn_stack[-1].endswith("_step")):
            self._add("OB-SYNC", node,
                      f".{attr}() inside step body {self._fn_stack[-1]}() "
                      f"— a device->host copy inside the captured step",
                      hint)

    # -- exception swallowing (serving fault doctrine) --------------------
    @staticmethod
    def _broad_handler(h: ast.ExceptHandler) -> bool:
        if h.type is None:
            return True
        types = (h.type.elts if isinstance(h.type, ast.Tuple)
                 else [h.type])
        return any(_dotted(t).rsplit(".", 1)[-1]
                   in ("Exception", "BaseException") for t in types)

    @staticmethod
    def _handler_swallows(h: ast.ExceptHandler) -> bool:
        for stmt in h.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Raise):
                    return False
                if (h.name and isinstance(sub, ast.Name)
                        and sub.id == h.name):
                    return False
        return True

    def visit_Try(self, node: ast.Try) -> None:
        if self.serving:
            for h in node.handlers:
                if self._broad_handler(h) and self._handler_swallows(h):
                    what = ("bare `except:`" if h.type is None else
                            f"`except {_dotted(h.type) or '...'}`")
                    self._add("PY-SWALLOW", h,
                              f"{what} drops the exception — serving "
                              f"faults must be contained and recorded, "
                              f"never silently swallowed",
                              "narrow the exception type, re-raise, or "
                              "bind it (`except Exception as e`) and "
                              "record it (metrics / logs)")
        self.generic_visit(node)

    # -- dict-iteration mutation -----------------------------------------
    def _mutated_name(self, node) -> Optional[str]:
        if isinstance(node, (ast.Delete, ast.Assign)):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and isinstance(
                        t.value, ast.Name):
                    return t.value.id
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            f = node.value.func
            if isinstance(f, ast.Attribute) and f.attr in (
                    "pop", "popitem", "clear", "remove", "append") \
                    and isinstance(f.value, ast.Name):
                return f.value.id
        return None

    def _flag_iter_mutation(self, node) -> None:
        name = self._mutated_name(node)
        if name and name in self._iter_stack:
            self._add("PY-DICT-MUT", node,
                      f"{name!r} mutated while being iterated",
                      "iterate over list(...) / collect keys first")

    def visit_Delete(self, node):
        self._flag_iter_mutation(node)
        self.generic_visit(node)

    visit_Assign = visit_Expr = visit_Delete


#: lines carrying this annotation declare a deliberate measurement fence
#: (OB-SYNC).
_FENCE_RE = re.compile(r"#\s*repro:\s*profiling-fence\b")


def _apply_fence_annotations(findings: List[Finding],
                             source: str) -> List[Finding]:
    fenced = set()
    for i, text in enumerate(source.splitlines(), start=1):
        if _FENCE_RE.search(text):
            fenced.update((i, i + 1))   # own line + the statement below
    for f in findings:
        if f.rule == "OB-SYNC" and f.line in fenced and not f.suppressed:
            f.suppressed = True
            f.justification = "profiling-fence annotation"
    return findings


def lint_file(path: str, *, serving: bool, source: Optional[str] = None,
              root: Optional[str] = None) -> List[Finding]:
    """Lint one file; findings name it relative to ``root`` (else to the
    working directory when ``path`` is absolute)."""
    if source is None:
        with open(path) as f:
            source = f.read()
    if root is not None:
        rel = os.path.relpath(path, root)
    else:
        rel = os.path.relpath(path) if os.path.isabs(path) else path
    linter = _FileLinter(rel, serving)
    linter.visit(ast.parse(source, filename=path))
    out = apply_inline_ignores(linter.findings, {rel: source})
    return _apply_fence_annotations(out, source)


#: the trees the lint sweeps, relative to the repo root.
ROOTS = ("src/repro_torch/serving", "src/repro_torch/models")


def tree_files(repo_root: str,
               roots: Sequence[str] = ROOTS) -> List[Tuple[str, bool]]:
    """(path, serving) of every .py file under ``roots``; the PK loop
    rules, PY-SWALLOW and OB-SYNC apply under a root naming ``serving``."""
    out = []
    for root in roots:
        for dirpath, _, files in os.walk(os.path.join(repo_root, root)):
            out.extend((os.path.join(dirpath, f), "serving" in root)
                       for f in sorted(files) if f.endswith(".py"))
    return out


def lint_tree(repo_root: str,
              roots: Sequence[str] = ROOTS) -> List[Finding]:
    """Lint every .py file under ``roots``."""
    return [f for path, serving in tree_files(repo_root, roots)
            for f in lint_file(path, serving=serving, root=repo_root)]
