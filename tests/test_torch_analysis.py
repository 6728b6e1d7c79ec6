"""The port's static-analysis subsystem (``repro_torch.analysis``) on the
CPU: parity with the reference's findings model, budget table and
observability pass, and a caught and a clean case for each port rule of
the kernel pass and the trace auditor (the lint's are in
``test_torch_lint.py``); the live tree is clean under ``--device cpu``.

The reference's trace auditor is not an oracle here (its jaxpr walk reads
``jax.core.ClosedJaxpr``, gone from this jax; ROADMAP.md queue 3 item
16): the port's is held to the reference's rule table, budget table and
entry names, and to its own fixtures.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.analysis import budgets as ref_budgets
from repro.analysis import findings as ref_findings
from repro.analysis import obs_pass as ref_obs
from repro.models import transformer as ref_tf
from repro_torch import convert
from repro_torch.analysis import (budgets, contracts, findings, kernel_pass,
                                  obs_pass, trace_audit)
from repro_torch.core import tiled_csl

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _rules(fs, suppressed=False):
    return sorted(f.rule for f in fs if f.suppressed == suppressed)


# ---------------------------------------------------------------------------
# findings: suppression and staleness against the reference
# ---------------------------------------------------------------------------

SOURCES = {
    "src/a.py": "x = 1\n# repro: ignore[PK-REUSE]\ny = 2\n"
                "z = 3  # repro: ignore[OB-SYNC, PY-SWALLOW]\n",
    "src/b.py": "a = 1\nb = 2  # repro: ignore[PY-MUT-DEFAULT]\n",
}
FINDINGS = [
    ("PK-REUSE", "src/a.py", 3, "key k consumed twice"),
    ("OB-SYNC", "src/a.py", 4, ".item() in the step"),
    ("PY-SWALLOW", "src/a.py", 5, "bare except"),
    ("PY-MUT-DEFAULT", "src/b.py", 2, "mutable default"),
    ("PY-MUT-DEFAULT", "src/b.py", 1, "mutable default"),
    ("TA-UPCAST", "trace:engine_decode_step", 0, "copy of shape (2, 3)"),
    ("TA-UPCAST", "trace:engine_verify_step", 0, "softmax upcast"),
    ("TA-CALLBACK", "trace:engine_mixed_step", 0, "host sync"),
    ("KC-ACC", "src/k.cuh", 7, "accumulates in f16"),
]
ALLOW = [
    {"rule": "TA-UPCAST", "path": "trace:*", "match": "softmax",
     "reason": "f32 softmax"},
    {"rule": "TA-CALLBACK", "path": "trace:engine_mixed_step",
     "reason": "known"},
    {"rule": "KC-ACC", "path": "src/*.cuh", "match": "nothing like it",
     "reason": "stale"},
    {"rule": "TA-RETRACE", "path": "trace:*"},        # no reason: invalid
    {"rule": "OB-EVENT", "path": "obs:*", "reason": "never audited"},
]


def _run_findings(mod):
    fs = [mod.Finding(*f) for f in FINDINGS]
    fs = mod.apply_inline_ignores(fs, SOURCES)
    allow = mod.Allowlist(ALLOW)
    fs = allow.suppress(fs)
    return ([(f.rule, f.path, f.line, f.suppressed, f.justification,
              f.render()) for f in fs],
            allow.problems(),
            mod.render_report(fs, show_suppressed=True),
            [mod.parse_inline_ignores(s) for s in SOURCES.values()])


def test_findings_suppression_and_staleness_match_reference():
    assert _run_findings(findings) == _run_findings(ref_findings)


def test_allowlist_judges_only_targets_the_run_audited():
    allow = findings.Allowlist([
        {"rule": "TA-UPCAST", "path": "trace:cuda:*", "reason": "card"},
        {"rule": "TA-UPCAST", "path": "trace:engine_*", "reason": "cpu"}])
    allow.suppress([])
    cpu = ["trace:engine_decode_step", "src/repro_torch/serving/step.py"]
    stale = allow.problems(cpu)
    assert len(stale) == 1 and "trace:engine_*" in stale[0]
    assert len(allow.problems(cpu + ["trace:cuda:engine_decode_step"])) == 2
    assert len(allow.problems()) == 2          # None: everything audited
    with pytest.raises(ValueError, match="unregistered"):
        findings.Finding("KC-VMEM", "x", 0, "folded into KC-LAUNCH")


def test_rule_table_keeps_every_reference_rule_with_a_counterpart():
    folded = {"KC-VMEM", "KC-GRID", "KC-SPLIT", "KC-NTB"}
    assert set(ref_findings.RULES) - folded <= set(findings.RULES)
    assert set(findings.RULES) - set(ref_findings.RULES) == {"KC-LAUNCH"}


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------

def test_capture_budgets_equal_reference_compile_budgets():
    assert set(budgets.CAPTURE_BUDGETS) == set(ref_budgets.COMPILE_BUDGETS)
    for entry, b in budgets.CAPTURE_BUDGETS.items():
        for max_len in range(1, 4097):
            kw = {"max_len": max_len} if callable(b) else {}
            assert budgets.capture_budget(entry, **kw) == \
                ref_budgets.compile_budget(entry, **kw), (entry, max_len)
    with pytest.raises(ValueError):
        budgets.prefill_shape_budget(0)
    with pytest.raises(KeyError):
        budgets.capture_budget("no_such_entry")
    assert budgets.smem_budget("cuda") == contracts.SMEM_BYTES_PER_BLOCK
    assert budgets.smem_budget("torch") is None


# ---------------------------------------------------------------------------
# kernel pass: selector, live schedules, KC-ACC, KC-OUT
# ---------------------------------------------------------------------------

def test_selector_audit_is_clean_and_filters_the_ladder():
    fs, stats = kernel_pass.audit_selector()
    assert fs == []
    assert stats["cells"] == len(kernel_pass.CANONICAL_SHAPES) == 6
    assert 0 < stats["filtered"] < stats["candidates"]
    assert 0 < stats["max_smem"] <= stats["smem_budget"]


def test_contract_strings_become_findings_under_their_rule():
    got = kernel_pass.contract_findings(contracts.check_launch(
        256, 512, 8, m_tb=256, k_tb=512, n_tb=8, split_k=1), "select:x")
    assert _rules(got) == ["KC-LAUNCH", "KC-LOC"]
    assert all(f.path == "select:x" for f in got)


def _small_params():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 512)).astype(np.float32)
    a[rng.random(a.shape) < 0.8] = 0.0
    t = tiled_csl.encode(torch.from_numpy(a))
    g = tiled_csl.group_stack([t, t])
    return {"layers": [{"mlp": {"up": {"w": t}, "gate_up": {"w": g}}}]}


def test_live_schedules_caught_and_clean():
    from repro_torch.kernels import schedule
    params = _small_params()
    t = params["layers"][0]["mlp"]["up"]["w"]
    good = schedule.select(256, 512, 8, m_tb=128, k_tb=128,
                           max_nnz=t.max_nnz)
    fs, stats = kernel_pass.audit_schedules(
        {("spmm", 256, 512, 8, 1): good,
         ("spmm_grouped", 256, 512, 8, 2): good}, params)
    assert fs == [] and stats["schedules"] == 2
    bad = schedule.Schedule(128, 128, 8, 5)          # split_k > Kt = 4
    fs, _ = kernel_pass.audit_schedules({("spmm", 256, 512, 8, 1): bad},
                                        params)
    # held at each weight of that shape: up, and gate_up's binary pair
    assert _rules(fs) == ["KC-LAUNCH"] * 2
    assert "split_k=5" in fs[0].message
    assert fs[0].path == "schedules:spmm(m=256,k=512,n=8,g=1)"


WGMMA_OK = '''
__device__ void f(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1}, %2, %3, 1, 1, 1, 0, 1;\\n"
      : "+f"(d[0]), "+f"(d[1])
      : "l"(a), "l"(b));
}
// a comment naming wgmma.mma_async.sync.aligned.m64n8k16.f16 is no site
__global__ void k() { float acc[4]; }
'''


def test_kc_acc_caught_on_an_f16_accumulator_and_clean_on_f32():
    fs, sites = kernel_pass.check_cuda_source("k.cuh", WGMMA_OK)
    assert fs == [] and sites == {"ptx": 1, "asm": 1, "acc": 1}
    bad = WGMMA_OK.replace("m64n8k16.f32.bf16", "m64n8k16.f16.bf16", 1)
    fs, _ = kernel_pass.check_cuda_source("k.cuh", bad)
    assert _rules(fs) == ["KC-ACC"] and fs[0].line == 4
    assert "f16" in fs[0].message
    bad = WGMMA_OK.replace('"+f"(d[1])', '"+h"(d[1])').replace(
        "float acc[4]", "__half acc[4]")
    fs, _ = kernel_pass.check_cuda_source("k.cuh", bad)
    assert _rules(fs) == ["KC-ACC", "KC-ACC"]
    assert [f.line for f in fs] == [6, 10]
    mma = ('asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f16 '
           '{%0}" : "+f"(d[0]));')
    fs, _ = kernel_pass.check_cuda_source("k.cuh", mma)
    assert _rules(fs) == ["KC-ACC"] and "f16" in fs[0].message


def test_kc_acc_caught_in_a_copy_of_the_pipelined_mainloop():
    path = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                        "hopper_pipe.cuh")
    src = open(path).read()
    fs, sites = kernel_pass.check_cuda_source(path, src)
    assert fs == [] and sites["ptx"] == 3 and sites["acc"] >= 4
    fs, _ = kernel_pass.check_cuda_source(
        path, src.replace("m64n128k16.f32.bf16", "m64n128k16.f16.bf16"))
    line = src[:src.index("m64n128k16.f32")].count("\n") + 1
    assert [(f.rule, f.line) for f in fs] == [("KC-ACC", line)]


def test_kc_out_caught_and_clean():
    src = ("from repro_torch.core import sparse_linear\n"
           "def f(w, x):\n"
           "    a = sparse_linear.linear(w, x, declared_out=4)\n"
           "    b = sparse_linear.linear(w, x)\n"
           "    c = sparse_linear.linear_grouped(w, x, declared_outs=(4,))\n"
           "    d = sparse_linear.linear_grouped(w, x)\n"
           "    return sparse_linear.linear(w, x, **kw)\n")
    fs = kernel_pass.check_declared_out("m.py", src)
    assert [(f.rule, f.line) for f in fs] == [("KC-OUT", 4), ("KC-OUT", 6)]


def test_kernel_pass_over_the_tree_is_clean():
    fs, stats = kernel_pass.run_kernel_pass(ROOT)
    assert fs == []
    assert stats["ptx"] == 4 and stats["model_files"] >= 10
    assert "src/repro_torch/kernels/csrc/hopper_pipe.cuh" in stats["targets"]


# ---------------------------------------------------------------------------
# trace audit: TA-UPCAST, TA-CALLBACK, TA-RETRACE
# ---------------------------------------------------------------------------

def _entry(step, count=lambda: 0, name="engine_decode_step", **budget):
    def build():
        return trace_audit.Built(step=step, host=lambda: None, count=count)
    return trace_audit.EntryPoint(name, build, budget)


def test_large_upcast_caught_small_ignored():
    big = torch.ones(trace_audit.UPCAST_MIN_ELEMS, dtype=torch.bfloat16)
    small = big[:-1]
    fs, report = trace_audit.audit_entry(_entry(lambda: big.float()))
    assert _rules(fs) == ["TA-UPCAST"]
    assert "(65536,)" in fs[0].message and "262144 B" in fs[0].message
    assert report["upcast_bytes"] == 4 * big.numel()
    f32 = torch.empty(big.shape, dtype=torch.float32)
    fs, _ = trace_audit.audit_entry(_entry(lambda: f32.copy_(big)))
    assert _rules(fs) == ["TA-UPCAST"]
    fs, _ = trace_audit.audit_entry(_entry(lambda: small.to(torch.float32)))
    assert fs == []
    fs, _ = trace_audit.audit_entry(_entry(lambda: big.to(torch.float16)))
    assert fs == []


def test_kernel_wrapper_bodies_not_audited():
    """The plain version upcasts a bf16 B of 131072 elements inside
    ``kernels/ref.py``: skipped, as the reference skips pallas_call
    bodies; the same upcast in the step itself is caught."""
    from repro_torch.kernels import ops
    t = _small_params()["layers"][0]["mlp"]["up"]["w"]
    b = torch.ones(512, 256, dtype=torch.bfloat16)
    census = trace_audit.Census()
    with census:
        ops.spmm(t, b)
    assert census.ops > 0 and census.upcasts == {}
    fs, _ = trace_audit.audit_entry(_entry(lambda: b.float()))
    assert _rules(fs) == ["TA-UPCAST"]


def test_host_sync_caught():
    x = torch.arange(8.0)
    fs, report = trace_audit.audit_entry(_entry(lambda: x.sum().item()))
    assert _rules(fs) == ["TA-CALLBACK"] and report["syncs"] == 1
    fs, _ = trace_audit.audit_entry(_entry(lambda: x[x > 3]))
    assert _rules(fs) == ["TA-CALLBACK"] and "boolean mask" in fs[0].message
    fs, _ = trace_audit.audit_entry(_entry(lambda: torch.nonzero(x)))
    assert _rules(fs) == ["TA-CALLBACK"]
    fs, _ = trace_audit.audit_entry(_entry(lambda: torch.where(x > 3, x, 0)))
    assert fs == []


def test_retrace_over_budget_caught():
    fs, _ = trace_audit.audit_entry(_entry(lambda: None, count=lambda: 2))
    assert _rules(fs) == ["TA-RETRACE"] and "budget of 1" in fs[0].message
    fs, _ = trace_audit.audit_entry(_entry(lambda: None, count=lambda: 1))
    assert fs == []
    for shapes, want in ((5, []), (6, ["TA-RETRACE"])):
        fs, report = trace_audit.audit_entry(_entry(
            lambda: None, count=lambda: shapes,
            name="engine_prefill_buckets", max_len=32))
        assert report["budget"] == 5 and _rules(fs) == want


def test_trace_audit_of_the_reference_entries_is_clean():
    fs, stats = trace_audit.run_trace_audit(device="cpu")
    assert fs == []
    names = [r["path"] for r in stats["entries"]]
    assert names == ["trace:" + n for n in (
        "engine_prefill_buckets", "engine_decode_step", "engine_verify_step",
        "engine_mixed_step", "spmm_dispatch")]
    by = {r["path"]: r for r in stats["entries"]}
    # buckets 8, 16, 32 of max_len 32; one schedule for the SpMM shape
    assert by["trace:engine_prefill_buckets"]["captures"] == 3
    assert by["trace:spmm_dispatch"]["captures"] == 1
    assert all(r["ops"] > 0 and r["syncs"] == 0 for r in stats["entries"])


def test_implied_launches_count_each_weight_once():
    assert trace_audit.implied_launches(_small_params()) == (2, 1)


# ---------------------------------------------------------------------------
# observability pass against the reference's replay
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_replay():
    records, metrics, injector, n = ref_obs._scenario(0)
    cfg = ref_configs.smoke("tinyllama_1_1b")
    jparams = ref_tf.init_model(jax.random.PRNGKey(0), cfg)
    params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")
    return records, metrics, injector, n, params


def test_obs_counters_equal_reference(reference_replay):
    rrec, rmet, rinj, rn, params = reference_replay
    precs, pmet, pinj, pn = obs_pass._scenario(0, params=params,
                                               device="cpu")
    for attr, key in obs_pass.PAIRED_SERIES:
        assert getattr(pmet, attr) == getattr(rmet, attr), attr
    assert obs_pass.event_counts(precs) == obs_pass.event_counts(rrec)
    assert len(pinj.fired) == len(rinj.fired) and pn == rn
    found, stats = obs_pass.run_obs_pass(0, params=params)
    assert found == [] and stats["targets"] == ["obs:chaos_replay(seed=0)"]
    assert stats["counters"] == {a: getattr(rmet, a)
                                 for a, _ in obs_pass.PAIRED_SERIES}
    assert stats["nonzero_series"] >= 3 and stats["fired"] == 4


def test_obs_event_caught_when_an_event_goes_missing(monkeypatch,
                                                     reference_replay):
    params = reference_replay[-1]
    real = obs_pass._scenario

    def drop_admits(seed, **kw):
        records, metrics, injector, n = real(seed, **kw)
        kept = [r for r in records if not (r.kind == "event"
                                           and r.name == "admit")]
        return kept, metrics, injector, n
    monkeypatch.setattr(obs_pass, "_scenario", drop_admits)
    found, _ = obs_pass.run_obs_pass(0, params=params)
    assert _rules(found) == ["OB-EVENT"]
    assert "metrics.admitted" in found[0].message


# ---------------------------------------------------------------------------
# the CLI on the live tree
# ---------------------------------------------------------------------------

def test_cli_all_passes_clean_on_the_cpu(capsys, tmp_path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_check", os.path.join(ROOT, "tools", "torch_check.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    assert cli.main(["--all", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s)" in out and "ALLOWLIST" not in out
    assert cli.main(["--list-rules"]) == 0
    assert "KC-LAUNCH" in capsys.readouterr().out
    stale = tmp_path / "allowlist.json"
    stale.write_text(json.dumps({"entries": [
        {"rule": "OB-SYNC", "path": "src/*", "reason": "matches nothing"}]}))
    assert cli.main(["--lint", "--device", "cpu",
                     "--allowlist", str(stale)]) == 1
    assert "stale" in capsys.readouterr().out


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trace_audit.default_entries()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obs_pass.run_obs_pass()
    assert trace_audit.prefix_of("cuda") == "trace:cuda"
    assert obs_pass.scenario_path(0, "cuda") == "obs:cuda:chaos_replay(seed=0)"
