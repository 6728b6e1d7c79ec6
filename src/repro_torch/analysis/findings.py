"""Finding model of the port's static checkers.

The counterpart of ``repro.analysis.findings``. Every check in the
analysis subsystem (launch contracts and CUDA sources, the dispatch-level
trace auditor, the AST lint, the metrics/trace cross-check) reports one
shape: a :class:`Finding` with a rule id, a ``path:line`` anchor, a
message and a fix hint. Suppression is two-tier, with the reference's
syntax:

* an inline ``# repro: ignore[RULE]`` on the flagged line (or the line
  above) silences one occurrence at the source;
* an allowlist JSON file (``tools/torch_check_allowlist.json``) for
  findings with no source line to annotate (trace-audit findings anchor
  to an audited entry point): every entry must carry a ``reason``, and an
  entry that matches nothing is reported as stale, so the list can only
  shrink. Staleness is judged against what the run audited: an entry
  whose ``path`` glob names no target of this run (the card's
  ``trace:cuda:opt-30b:*`` entries in a run on the CPU) is not stale.

``tools/torch_check.py`` renders the live findings and exits non-zero
when any remain.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: rule id -> what it means for the port. The reference's KC-VMEM,
#: KC-GRID, KC-SPLIT and KC-NTB are folded into KC-LAUNCH, the contract
#: the CUDA kernels check at every launch (``analysis.contracts``).
RULES: Dict[str, str] = {
    # launch contracts and kernel sources (contracts.py / kernel_pass.py)
    "KC-LOC": "tile geometry overflows the 16-bit intra-tile loc field",
    "KC-LAUNCH": "a launch the CUDA kernels do not take: tile or N tile "
                 "outside the built set, dims that do not tile, split_k "
                 "outside [1, Kt], shared memory over the H100's 227 KB a "
                 "block, too many accumulators a thread, grid z or split-K "
                 "workspace over their limits",
    "KC-ACC": "a wgmma/mma.sync PTX string, or the accumulator it feeds, "
              "is not f32",
    "KC-OUT": "sparse_linear call site missing declared_out",
    # dispatch-level trace auditor (trace_audit.py)
    "TA-UPCAST": "large bf16->f32 aten._to_copy/copy_ in a step, outside "
                 "the kernel wrappers",
    "TA-CALLBACK": "host sync inside a step: .item() "
                   "(aten._local_scalar_dense), a data-dependent shape "
                   "(nonzero, boolean indexing), a device->CPU copy, or a "
                   "sync raised under torch.cuda.set_sync_debug_mode",
    "TA-RETRACE": "an entry captured more CUDA graphs, prefill shapes or "
                  "schedules than its budget, or a replay's LSCD launches "
                  "are not the ones its layers imply",
    # AST lint (lint.py)
    "PK-FRESH": "torch.Generator/torch.manual_seed inside a serving loop "
                "body",
    "PK-SPLIT": "draw from a stateful or global generator in a serving loop "
                "(use the (seed, uid, token index) fold of "
                "engine._slot_noise)",
    "PK-REUSE": "one seed seeds two generators, or one (seed, uid, count) "
                "fold feeds two noise draws",
    "PY-TRACED-BRANCH": "Python if/while branches on a torch.* call "
                        "(a host sync on the card, a break in capture)",
    "PY-MUT-DEFAULT": "mutable default argument",
    "PY-DICT-MUT": "dict/list mutated while being iterated",
    "PY-SWALLOW": "bare/over-broad except in serving/ drops the exception",
    # observability plane (lint.py OB-SYNC; obs_pass.py OB-EVENT)
    "OB-SYNC": "host sync (.item(), torch.cuda.synchronize, .cpu()/.numpy()"
               "/.tolist() in a _*_step body) in serving/step.py without a "
               "profiling-fence annotation",
    "OB-EVENT": "metrics counters and the trace event stream disagree",
}

_IGNORE_RE = re.compile(r"#\s*repro:\s*ignore\[([A-Z0-9,\- ]+)\]")


@dataclasses.dataclass
class Finding:
    """One rule violation.

    ``path`` is a repo-relative file path for source-anchored rules, or a
    pseudo-path like ``trace:engine_decode_step`` (``trace:cuda:...`` on
    the card) for trace-audit findings. ``line`` is 0 when no source line
    applies.
    """

    rule: str
    path: str
    line: int
    message: str
    hint: str = ""
    suppressed: bool = False
    justification: str = ""

    def __post_init__(self) -> None:
        if self.rule not in RULES:
            raise ValueError(f"unregistered rule id {self.rule!r}")

    def anchor(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def render(self) -> str:
        tail = f"\n      hint: {self.hint}" if self.hint else ""
        if self.suppressed:
            tail += f"\n      suppressed: {self.justification}"
        return f"{self.anchor()}: {self.rule}: {self.message}{tail}"


def parse_inline_ignores(source: str) -> Dict[int, Tuple[str, ...]]:
    """Map 1-based line number -> rule ids ignored on that line. A
    ``# repro: ignore[RULE]`` comment applies to its own line and to the
    line below it."""
    out: Dict[int, Tuple[str, ...]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _IGNORE_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        out[i] = out.get(i, ()) + rules
        out[i + 1] = out.get(i + 1, ()) + rules
    return out


def apply_inline_ignores(findings: Iterable[Finding],
                         source_by_path: Dict[str, str]) -> List[Finding]:
    """Mark findings whose line carries a matching inline ignore."""
    cache: Dict[str, Dict[int, Tuple[str, ...]]] = {}
    out = []
    for f in findings:
        src = source_by_path.get(f.path)
        if src is not None and f.line:
            if f.path not in cache:
                cache[f.path] = parse_inline_ignores(src)
            if f.rule in cache[f.path].get(f.line, ()):
                f.suppressed = True
                f.justification = f.justification or "inline ignore"
        out.append(f)
    return out


class Allowlist:
    """Burn-down allowlist: JSON entries suppressing known findings.

    Format::

        {"entries": [{"rule": "TA-UPCAST",
                      "path": "trace:cuda:opt-30b:*",
                      "match": "models/attention.py:264",   # optional
                      "reason": "..."}]}

    ``path`` is matched with fnmatch (globs allowed); ``match`` is a
    substring of the finding message; ``reason`` is mandatory: an entry
    without one is invalid and ignored (reported by :meth:`problems`).
    """

    def __init__(self, entries: Sequence[dict]):
        self.entries = list(entries)
        self._used = [False] * len(self.entries)
        self._invalid = [not (e.get("rule") and e.get("path")
                              and e.get("reason"))
                         for e in self.entries]

    @classmethod
    def load(cls, path: Optional[str]) -> "Allowlist":
        if not path or not os.path.exists(path):
            return cls([])
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("entries", []))

    def suppress(self, findings: Iterable[Finding]) -> List[Finding]:
        out = []
        for f in findings:
            for i, e in enumerate(self.entries):
                if self._invalid[i] or f.suppressed:
                    continue
                if e["rule"] != f.rule:
                    continue
                if not fnmatch.fnmatch(f.path, e["path"]):
                    continue
                if e.get("match") and e["match"] not in f.message:
                    continue
                f.suppressed = True
                f.justification = e["reason"]
                self._used[i] = True
            out.append(f)
        return out

    def problems(self, audited: Optional[Iterable[str]] = None
                 ) -> List[str]:
        """Stale or invalid entries. ``audited``: the paths and
        pseudo-paths this run audited; an unused entry whose ``path``
        glob matches none of them is not stale (None: every target was
        audited, the reference's rule)."""
        targets = None if audited is None else list(audited)
        out = []
        for i, e in enumerate(self.entries):
            label = f"{e.get('rule')}@{e.get('path')}"
            if self._invalid[i]:
                out.append(f"allowlist entry {label} missing "
                           f"rule/path/reason")
            elif not self._used[i] and (targets is None or any(
                    fnmatch.fnmatch(t, e["path"]) for t in targets)):
                out.append(f"allowlist entry {label} is stale "
                           f"(matched nothing); remove it")
        return out


def render_report(findings: Sequence[Finding], *,
                  show_suppressed: bool = False) -> str:
    live = [f for f in findings if not f.suppressed]
    sup = [f for f in findings if f.suppressed]
    lines = [f.render() for f in live]
    if show_suppressed and sup:
        lines.append(f"-- {len(sup)} suppressed --")
        lines.extend(f.render() for f in sup)
    lines.append(f"{len(live)} finding(s), {len(sup)} suppressed")
    return "\n".join(lines)
