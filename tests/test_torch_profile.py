"""The kernel profiler, the dispatch hook and ``schedule.predicted`` in
the port, on the CPU.

* The profiler and kernel-trace cases of ``tests/test_obs.py`` on the
  port's ``obs.profile`` and ``kernels.ops``: one record per unique
  launch with its dispatch count, a measured drift row, no records once
  inactive, the staleness pass on a poisoned autotune cache (and a fresh
  entry kept), and a ``"kernel"`` tracer event with the schedule and the
  predicted time. On the CPU a launch is the plain version's, noted with
  the schedule the kernel would run (``backend="torch"``) and timed with
  the host clock.
* The port-only expert-batched kind, recorded and measured on a
  synthetic per-expert stack.
* The tracer's bounded ring: eager serving dispatches on every call,
  more often than the ring holds, and one event per distinct launch
  leaves every scheduler record in it.
* ``schedule.predicted`` is ``select_analytic``'s ranking term: the
  picked candidate's ``effective_s`` is the least of every candidate's.
* The serving CLI's ``--profile-kernels``.
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis import contracts
from repro_torch.core import tiled_csl
from repro_torch.kernels import ops, schedule
from repro_torch.launch import serve
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import api
from torch_serving_parity import f32_models, prompts_of


def _small_csl(seed=0, m=128, k=256, sparsity=0.8):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((m, k)).astype(np.float32)
    dense[rng.random(dense.shape) < sparsity] = 0.0
    return tiled_csl.encode(torch.from_numpy(dense))


def test_profiler_records_and_measures():
    t = _small_csl()
    b = torch.ones(256, 8)
    with obs_profile.profiled(obs_profile.KernelProfiler()) as prof:
        ops.spmm(t, b)
        ops.spmm(t, b)                           # same shape: one launch
    assert len(prof.launches) == 1
    (key, launch), = prof.launches.items()
    assert prof.dispatch_counts[key] == 2
    assert launch.kind == "spmm" and launch.predicted_s > 0
    assert launch.backend == "torch" and launch.dtype == "float32"
    assert launch.schedule == schedule.select(
        128, 256, 8, m_tb=t.m_tb, k_tb=t.k_tb, max_nnz=t.max_nnz,
        b_dtype_bytes=4)
    rows = prof.measure(reps=1)
    assert len(rows) == 1
    r = rows[0]
    assert r["dispatches"] == 2 and r["timing"] == "host_clock"
    assert r["measured_us"] > 0 and r["predicted_us"] > 0
    assert r["drift"] == pytest.approx(r["measured_us"] / r["predicted_us"])
    assert prof.dispatch_counts[key] == 2        # measure is not recorded
    ops.spmm(t, b)                               # off again
    assert prof.dispatch_counts[key] == 2
    table = obs_profile.render_drift_table(rows)
    assert "spmm" in table and "drift" in table
    assert obs_profile.render_drift_table([]).startswith("(no ")
    assert obs_profile.active() is None


def test_staleness_invalidates_poisoned_cache(tmp_path):
    t = _small_csl()
    b = torch.ones(256, 8)
    with obs_profile.profiled(obs_profile.KernelProfiler()) as prof:
        ops.spmm(t, b)
    (key, launch), = prof.launches.items()
    cache = schedule.ScheduleCache(str(tmp_path / "tuned.json"))
    cache.put(launch.cache_key, launch.schedule, measured_us=1e-3)
    cache.save()
    rows = prof.measure(reps=1)
    dropped = prof.apply_staleness(cache, rows, tol=0.5)
    assert dropped == [launch.cache_key]
    assert rows[0]["stale_cache_entry"]["key"] == launch.cache_key
    assert cache.entry(launch.cache_key) is None
    cache.save()                    # the drop survives the merge-on-save
    assert schedule.ScheduleCache(cache.path).entry(launch.cache_key) is None
    cache.put(launch.cache_key, launch.schedule,
              measured_us=rows[0]["measured_us"])
    cache.save()
    assert schedule.ScheduleCache(cache.path).entry(
        launch.cache_key) is not None
    with obs_profile.profiled(obs_profile.KernelProfiler()) as prof2:
        ops.spmm(t, b)
    rep = prof2.drift_report(reps=1)
    assert rep["n_unique_launches"] == 1 and rep["stale_keys"] == []


def test_fresh_measurement_within_tol_keeps_entry(tmp_path):
    t = _small_csl()
    b = torch.ones(256, 8)
    with obs_profile.profiled(obs_profile.KernelProfiler()) as prof:
        ops.spmm(t, b)
    (key, launch), = prof.launches.items()
    rows = prof.measure(reps=1)
    cache = schedule.ScheduleCache(str(tmp_path / "tuned.json"))
    cache.put(launch.cache_key, launch.schedule,
              measured_us=rows[0]["measured_us"])
    assert prof.apply_staleness(cache, rows, tol=10.0) == []
    assert cache.entry(launch.cache_key) is not None


@pytest.fixture
def tracer():
    tr = obs_trace.Tracer().enable()
    prev = obs_trace.set_tracer(tr)
    yield tr
    obs_trace.set_tracer(prev)


def test_kernel_launches_traced_once_each(tracer):
    t = _small_csl()
    b = torch.ones(256, 8)
    ops.spmm(t, b)
    ops.spmm(t, b)                   # the same launch: no second event
    kernel = [r for r in tracer.records() if r.cat == "kernel"]
    assert len(kernel) == 1
    ev = kernel[0]
    assert ev.track == "kernel" and ev.name == "spmm 128x256x8"
    assert ev.args["backend"] == "torch"
    assert set(ev.args["schedule"]) == {"m_tb", "k_tb", "n_tb", "split_k"}
    assert ev.args["predicted_us"] > 0
    ops.spmm(t, torch.ones(256, 16))            # another launch: an event
    assert sum(r.cat == "kernel" for r in tracer.records()) == 2
    tracer.clear()                               # clear forgets the keys
    ops.spmm(t, b)
    assert sum(r.cat == "kernel" for r in tracer.records()) == 1


def test_grouped_and_batched_kinds_are_recorded_and_measured():
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((4, 128, 256)).astype(np.float32)
    dense[rng.random(dense.shape) < 0.8] = 0.0
    stack = tiled_csl.encode_stack(torch.from_numpy(dense))
    pair = tiled_csl.encode_group([torch.from_numpy(dense[0]),
                                   torch.from_numpy(dense[1])])
    with obs_profile.profiled(obs_profile.KernelProfiler()) as prof:
        ops.spmm_batched(stack, torch.ones(4, 256, 2, dtype=torch.bfloat16))
        ops.spmm_grouped(pair, torch.ones(256, 8, dtype=torch.bfloat16),
                         epilogue="silu_mul")
    recs = {r.kind: r for r in prof.launches.values()}
    assert recs["spmm_batched"].experts == 4
    assert recs["spmm_batched"].dtype == "bfloat16"
    assert recs["spmm_grouped"].group == 2
    assert recs["spmm_grouped"].epilogue == "silu_mul"
    assert recs["spmm_batched"].cache_key.endswith("_e4")
    rows = {r["kind"]: r for r in prof.measure(reps=1)}
    assert rows["spmm_batched"]["experts"] == 4
    assert all(r["measured_us"] > 0 for r in rows.values())


def test_eager_serving_keeps_the_schedulers_records_in_the_ring():
    """An eager (CPU) server dispatches on every call, far more often
    than the ring holds; the tracer keeps one kernel event per distinct
    launch, so nothing is evicted."""
    _, _, pcfg, pparams = f32_models("tinyllama_1_1b", 0.8)
    tr = obs_trace.Tracer(capacity=192).enable()
    prev = obs_trace.set_tracer(tr)
    try:
        with obs_profile.profiled(obs_profile.KernelProfiler()) as prof:
            server = api.StreamingServer(pparams, pcfg, n_slots=2,
                                         max_len=48, cache_kind="paged",
                                         block_size=4, n_blocks=32)
            for i, p in enumerate(prompts_of(pcfg, [5, 9, 7, 4])):
                server.submit(api.GenerationRequest(p, 12,
                                                    session_id=f"s{i}"))
            server.run_until_drained()
    finally:
        obs_trace.set_tracer(prev)
    kernel = [r for r in tr.records() if r.cat == "kernel"]
    others = len(tr) - len(kernel)
    # an event a dispatch would have overflowed the ring
    assert sum(prof.dispatch_counts.values()) + others > tr.capacity
    assert tr.dropped == 0
    assert len(kernel) == len({(r.name, str(r.args["schedule"]))
                               for r in kernel}) <= len(prof.launches)
    sched = [r for r in tr.records() if r.cat == "sched"]
    assert {r.name for r in sched} >= {"admit", "finish"}


@pytest.mark.parametrize("m,k,n,group,binary,experts", [
    (2048, 2048, 8, 1, False, 1), (5632, 2048, 1024, 2, True, 1),
    (2048, 5632, 32, 1, False, 1), (256, 2048, 8, 3, False, 1),
    (768, 2048, 2, 1, False, 8)])
def test_predicted_is_select_analytics_term(m, k, n, group, binary,
                                            experts):
    max_nnz = 3328
    sparsity = schedule.sparsity_from_max_nnz(max_nnz, 128, 128)
    pick = schedule.select_analytic(m, k, n, m_tb=128, k_tb=128,
                                    max_nnz=max_nnz, group=group,
                                    binary=binary, experts=experts)
    got = schedule.predicted(m, k, n, sparsity, pick, group=group,
                             max_nnz=max_nnz, binary=binary,
                             experts=experts)
    costs = [schedule.predicted(m, k, n, sparsity, c, group=group,
                                max_nnz=max_nnz, binary=binary,
                                experts=experts).effective_s
             for c in schedule.candidates(m, k, n, m_tb=128, k_tb=128)
             if not contracts.check_launch(
                 m, k, n, m_tb=c.m_tb, k_tb=c.k_tb, n_tb=c.n_tb,
                 split_k=c.split_k, group=group, binary=binary,
                 experts=experts)]
    assert got.effective_s == min(costs) > 0
    # without max_nnz each tile is charged (1 - sparsity) of its positions
    est = schedule.predicted(m, k, n, 0.8, pick, group=group,
                             binary=binary, experts=experts)
    assert est.hbm_bytes == schedule.predicted(
        m, k, n, 0.8, pick, group=group, max_nnz=3277, binary=binary,
        experts=experts).hbm_bytes


@pytest.mark.parametrize("arch", ["tinyllama_1_1b", "qwen2_moe_a2_7b"])
def test_cli_profile_kernels_prints_the_drift_table(arch, capsys):
    rep = serve.main(["--arch", arch, "--smoke", "--sparsity", "0.8",
                      "--requests", "2", "--slots", "2", "--max-new", "3",
                      "--profile-kernels"], device="cpu")
    out = capsys.readouterr().out
    rows = rep["drift"]["rows"]
    assert rows and rep["drift"]["n_unique_launches"] == len(rows)
    assert all(r["timing"] == "host_clock" and r["measured_us"] > 0
               for r in rows)
    kinds = {r["kind"] for r in rows}
    assert ("spmm_batched" in kinds) == (arch == "qwen2_moe_a2_7b")
    assert "kernel drift" in out and "pred_us" in out
    assert obs_profile.active() is None
