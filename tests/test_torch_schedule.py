"""The port's schedule cache and measured autotune
(``repro_torch.kernels.schedule``), on the reference's cases in
``tests/test_schedule.py``, ``tests/test_analysis.py`` and
``tests/test_obs.py``: a missing or corrupt cache file, merge-on-save,
``invalidate`` surviving a save, a hit that disagrees with a pin or that
the launch contract refuses falling back to the analytic pick, the
``REPRO_SCHEDULE_CACHE`` file, and ``autotune`` on the CPU's plain
versions persisting a contract-valid winner. The cache keys and the
sparsity they name equal the reference's.
"""

import json

import numpy as np
import pytest
import torch

from repro.kernels import schedule as ref_schedule
from repro_torch.analysis import contracts
from repro_torch.core import tiled_csl
from repro_torch.kernels import schedule


def _csl(m=128, k=256, sparsity=0.8, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, k)).astype(np.float32)
    a[rng.random((m, k)) < sparsity] = 0.0
    return tiled_csl.encode(torch.from_numpy(a))


@pytest.fixture(autouse=True)
def _no_env_cache(monkeypatch):
    monkeypatch.delenv("REPRO_SCHEDULE_CACHE", raising=False)


@pytest.mark.parametrize("args", [
    (128, 256, 8, 0.8, {}),
    (7168, 28672, 16, 0.7890625, dict(group=1, m_tb=128, k_tb=128)),
    (7168, 7168, 32, 0.765625, dict(group=3, m_tb=128, k_tb=128)),
    (4096, 4096, 1024, 0.8, dict(m_tb=64, k_tb=None)),
])
def test_cache_key_equals_reference(args):
    m, k, n, s, kw = args
    assert schedule.cache_key(m, k, n, s, backend="cuda", **kw) == \
        ref_schedule.cache_key(m, k, n, s, backend="cuda", **kw)


@pytest.mark.parametrize("max_nnz", [128, 3456, 3840, 16384, 20000])
def test_sparsity_from_max_nnz_equals_reference(max_nnz):
    assert schedule.sparsity_from_max_nnz(max_nnz, 128, 128) == \
        ref_schedule.sparsity_from_max_nnz(max_nnz, 128, 128)


def test_cache_roundtrip_missing_and_corrupt(tmp_path):
    path = str(tmp_path / "sched.json")
    cache = schedule.ScheduleCache(path)          # missing file: empty
    assert len(cache) == 0
    key = schedule.cache_key(128, 256, 8, 0.8, m_tb=128, k_tb=128)
    cache.put(key, schedule.Schedule(128, 128, 8, 2), measured_us=42.0)
    cache.save()
    reloaded = schedule.ScheduleCache(path)
    assert reloaded.get(key) == schedule.Schedule(128, 128, 8, 2)
    with open(path) as f:
        assert json.load(f)[key]["measured_us"] == 42.0
    assert reloaded.entry(key)["measured_us"] == 42.0
    cache._data["bad"] = {"n_tb": 8}              # schema drift: skipped
    assert cache.get("bad") is None
    with open(path, "w") as f:
        f.write("not json")
    assert len(schedule.ScheduleCache(path)) == 0


def test_save_merges_concurrent_writers(tmp_path):
    path = str(tmp_path / "shared.json")
    a = schedule.ScheduleCache(path)
    b = schedule.ScheduleCache(path)              # loaded before a saves
    a.put("shape_a", schedule.Schedule(128, 128, 8, 2))
    a.save()
    b.put("shape_b", schedule.Schedule(128, 128, 16, 1))
    b.save()
    reloaded = schedule.ScheduleCache(path)
    assert reloaded.get("shape_a") == schedule.Schedule(128, 128, 8, 2)
    assert reloaded.get("shape_b") == schedule.Schedule(128, 128, 16, 1)
    assert not (tmp_path / "shared.json.tmp").exists()


def test_invalidate_survives_save(tmp_path):
    path = str(tmp_path / "tuned.json")
    cache = schedule.ScheduleCache(path)
    cache.put("k", schedule.Schedule(128, 128, 8, 2), measured_us=1e-3)
    cache.save()
    other = schedule.ScheduleCache(path)          # still has "k" on disk
    assert cache.invalidate("k") and cache.entry("k") is None
    cache.save()
    assert schedule.ScheduleCache(path).entry("k") is None
    other.put("j", schedule.Schedule(128, 128, 16, 1))
    cache.save()                                  # disk copy loses to drop
    assert schedule.ScheduleCache(path).entry("k") is None
    cache.put("k", schedule.Schedule(128, 128, 8, 4), measured_us=5.0)
    cache.save()                                  # a fresh put un-drops
    assert schedule.ScheduleCache(path).get("k") == \
        schedule.Schedule(128, 128, 8, 4)


KW = dict(m_tb=128, k_tb=128, max_nnz=3456)


def _key(m, k, n, group=1, backend="cuda"):
    s = schedule.sparsity_from_max_nnz(3456, 128, 128)
    return schedule.cache_key(m, k, n, s, group=group, backend=backend,
                              m_tb=128, k_tb=128)


def test_select_consults_cache_first(tmp_path):
    cache = schedule.ScheduleCache(str(tmp_path / "s.json"))
    analytic = schedule.select(7168, 7168, 16, cache=False, **KW)
    planted = schedule.Schedule(128, 128, 64, 2)  # not the analytic pick
    assert planted != analytic
    cache.put(_key(7168, 7168, 16), planted)
    assert schedule.select(7168, 7168, 16, cache=cache, **KW) == planted
    # a hit that disagrees with a pin falls through to the analytic pick
    got = schedule.select(7168, 7168, 16, n_tb=16, cache=cache, **KW)
    assert got.n_tb == 16
    assert got == schedule.select(7168, 7168, 16, n_tb=16, cache=False,
                                  **KW)
    # another backend's entry is not this backend's
    assert schedule.select(7168, 7168, 16, cache=cache, backend="torch",
                           **KW) == analytic
    # cache=True means the default (environment) cache, here none
    assert schedule.select(7168, 7168, 16, cache=True, **KW) == analytic


def test_contract_refused_hit_falls_back(tmp_path):
    """A cached winner the launch contract refuses (an N tile the kernels
    are not built for; a split beyond Kt) never launches: the analytic
    pick decides."""
    cache = schedule.ScheduleCache(str(tmp_path / "poison.json"))
    for m, k, n, g, bad in (
            (7168, 7168, 16, 1, schedule.Schedule(128, 128, 24, 1)),
            (256, 256, 16, 1, schedule.Schedule(128, 128, 16, 4)),
            (7168, 7168, 16, 3, schedule.Schedule(128, 128, 16, 64))):
        assert contracts.check_launch(
            m, k, n, m_tb=128, k_tb=128, n_tb=bad.n_tb, split_k=bad.split_k,
            group=g, max_nnz=3456)
        cache.put(_key(m, k, n, group=g), bad)
        got = schedule.select(m, k, n, group=g, cache=cache, **KW)
        assert got != bad
        assert got == schedule.select(m, k, n, group=g, cache=False, **KW)
        assert not contracts.check_launch(
            m, k, n, m_tb=128, k_tb=128, n_tb=got.n_tb,
            split_k=got.split_k, group=g)


def test_env_cache_pickup(tmp_path, monkeypatch):
    path = str(tmp_path / "env.json")
    cache = schedule.ScheduleCache(path)
    planted = schedule.Schedule(128, 128, 128, 4)
    cache.put(_key(7168, 7168, 16), planted)
    cache.save()
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", path)
    assert schedule.select(7168, 7168, 16, **KW) == planted
    analytic = schedule.select(7168, 7168, 16, cache=False, **KW)
    assert analytic != planted and analytic.n_tb == 16


def test_pinned_launch_skips_the_cache(tmp_path):
    cache = schedule.ScheduleCache(str(tmp_path / "s.json"))
    cache.put(_key(7168, 7168, 16), schedule.Schedule(128, 128, 64, 2))
    got = schedule.select(7168, 7168, 16, n_tb=16, split_k=4, cache=cache,
                          **KW)
    assert got == schedule.Schedule(128, 128, 16, 4)


def test_autotune_torch_backend_persists_winner(tmp_path):
    t = _csl()                                    # Kt = 2
    cache = schedule.ScheduleCache(str(tmp_path / "tuned.json"))
    best, timings = schedule.autotune(t, 8, backend="torch", cache=cache,
                                      reps=1, n_tbs=(8, 16),
                                      splits=(1, 2, 4))
    # split 4 > Kt = 2 is refused by the contract: never timed or stored
    assert set(timings) == {schedule.Schedule(128, 128, n, s)
                            for n in (8, 16) for s in (1, 2)}
    assert all(us > 0 for us in timings.values())
    assert best == min(timings, key=timings.get)
    assert not contracts.check_launch(
        128, 256, 8, m_tb=128, k_tb=128, n_tb=best.n_tb,
        split_k=best.split_k, max_nnz=t.max_nnz)
    reloaded = schedule.ScheduleCache(cache.path)
    assert len(reloaded) == 1
    (key,) = reloaded._data
    assert key.startswith("torch_m128_k256_n8_")
    assert reloaded.entry(key)["measured_us"] == pytest.approx(
        timings[best])
    got = schedule.select(128, 256, 8, m_tb=128, k_tb=128,
                          max_nnz=t.max_nnz, backend="torch",
                          cache=reloaded)
    assert got == best


def test_autotune_grouped_binary_and_env_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "env.json")
    monkeypatch.setenv("REPRO_SCHEDULE_CACHE", path)
    g = tiled_csl.group_stack([_csl(seed=1), _csl(seed=2)])
    best, timings = schedule.autotune(g, 16, backend="torch", reps=1,
                                      epilogue="silu_mul", n_tbs=(16,))
    assert best in timings and len(schedule.ScheduleCache(path)) == 1
    with pytest.raises(ValueError, match="binary epilogue"):
        schedule.autotune(_csl(), 16, backend="torch", reps=1,
                          epilogue="silu_mul", cache=schedule.ScheduleCache(
                              str(tmp_path / "x.json")))


def test_autotune_never_skips_a_failed_launch(tmp_path):
    """On the kernels' backend a tensor that is not on a card fails at
    the first launch, and autotune raises instead of moving on."""
    cache = schedule.ScheduleCache(str(tmp_path / "t.json"))
    with pytest.raises(ValueError, match="CUDA"):
        schedule.autotune(_csl(), 8, backend="cuda", cache=cache, reps=1)
    assert len(cache) == 0
    with pytest.raises(contracts.ScheduleContractError):
        schedule.autotune(_csl(), 8, backend="torch", cache=cache, reps=1,
                          n_tbs=(24,))
    with pytest.raises(ValueError, match="backend"):
        schedule.autotune(_csl(), 8, backend="pallas", cache=cache)
