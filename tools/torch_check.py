#!/usr/bin/env python
"""Static checker of the PyTorch/CUDA port (``src/repro_torch``).

Runs the port's analysis passes and exits non-zero when any unsuppressed
finding or stale allowlist entry remains:

    PYTHONPATH=src python tools/torch_check.py --all --device cpu
    PYTHONPATH=src python tools/torch_check.py --kernels --lint
    PYTHONPATH=src python tools/torch_check.py --all            # on a card
    PYTHONPATH=src python tools/torch_check.py --list-rules

``--device`` (default ``cuda``, as every entry point of the port) places
the trace audit's steppers and the observability replay; on the card the
steps are CUDA graphs and run under ``set_sync_debug_mode("error")``.
Suppression: an inline ``# repro: ignore[RULE]`` next to the flagged
source line, or an entry with a mandatory ``reason`` in
``tools/torch_check_allowlist.json``. An entry that matches nothing among
the targets the run audited fails the run, so the list can only shrink.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO_ROOT, "src"))

from repro_torch.analysis import findings as findings_mod  # noqa: E402

DEFAULT_ALLOWLIST = os.path.join(REPO_ROOT, "tools",
                                 "torch_check_allowlist.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="run every pass (default when none selected)")
    ap.add_argument("--kernels", action="store_true",
                    help="launch contracts and CUDA sources (KC-*)")
    ap.add_argument("--trace", action="store_true",
                    help="dispatch-level step audit (TA-*; runs the "
                         "tinyllama smoke steps)")
    ap.add_argument("--lint", action="store_true",
                    help="AST lint over serving/ and models/ "
                         "(PK-*/PY-*/OB-SYNC)")
    ap.add_argument("--obs", action="store_true",
                    help="observability cross-check (OB-EVENT; replays a "
                         "tiny fault-laden trace and diffs metrics "
                         "counters against trace events)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the trace audit and the replay run "
                         "(default: %(default)s)")
    ap.add_argument("--allowlist", default=DEFAULT_ALLOWLIST,
                    help="burn-down allowlist JSON (default: %(default)s)")
    ap.add_argument("--show-suppressed", action="store_true")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(findings_mod.RULES.items()):
            print(f"{rule:18s} {desc}")
        return 0

    run_all = args.all or not (args.kernels or args.trace or args.lint
                               or args.obs)
    found, audited = [], []

    if run_all or args.kernels:
        from repro_torch.analysis import kernel_pass
        kf, stats = kernel_pass.run_kernel_pass(REPO_ROOT)
        found.extend(kf)
        audited.extend(stats["targets"])
        print(f"[kernels] {stats['cells']} cells audited; "
              f"{stats['filtered']}/{stats['candidates']} ladder candidates "
              f"contract-filtered; KC-ACC over {stats['ptx']} PTX strings, "
              f"{stats['asm']} asm statements and {stats['acc']} "
              f"accumulator declarations; KC-OUT over "
              f"{stats['model_files']} model files; {len(kf)} finding(s)")

    if run_all or args.lint:
        from repro_torch.analysis import lint
        files = lint.tree_files(REPO_ROOT)
        lf = lint.lint_tree(REPO_ROOT)
        found.extend(lf)
        audited.extend(os.path.relpath(p, REPO_ROOT) for p, _ in files)
        print(f"[lint] {len(files)} files of serving/ + models/ swept; "
              f"{len(lf)} finding(s)")

    if run_all or args.trace:
        from repro_torch.analysis import trace_audit
        tf, stats = trace_audit.run_trace_audit(device=args.device)
        found.extend(tf)
        audited.extend(stats["targets"])
        print(f"[trace] {len(stats['entries'])} entry points audited on "
              f"{args.device}; {len(tf)} finding(s)")

    if run_all or args.obs:
        from repro_torch.analysis import obs_pass
        of, stats = obs_pass.run_obs_pass(device=args.device)
        found.extend(of)
        audited.extend(stats["targets"])
        print(f"[obs] {stats['records']} trace records vs "
              f"{stats['checks']} paired series "
              f"({stats['nonzero_series']} nonzero); {len(of)} finding(s)")

    allow = findings_mod.Allowlist.load(args.allowlist)
    found = allow.suppress(found)
    print()
    print(findings_mod.render_report(found,
                                     show_suppressed=args.show_suppressed))
    problems = allow.problems(audited)
    for p in problems:
        print(f"ALLOWLIST: {p}")
    live = [f for f in found if not f.suppressed]
    return 1 if live or problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
