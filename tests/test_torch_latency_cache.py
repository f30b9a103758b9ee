"""The port's persistent latency cache (``core/latency_cache.py``) and
``build_table(cache_dir=, refresh=)`` on the CPU: the contracts of the
JAX package's tests/test_latency_cache.py (round trip; a hit times
nothing; the key changes with cfg, env, the measure arguments, the
device and the torch version, and folds the defaults in; corrupt and
foreign files are counted misses; directory resolution; a cached table
drives the search to the fresh table's assignments), and a gradual
family priced by a measured table, killed and resumed against its
cached table, bit-equal to an uninterrupted run.
"""
import dataclasses
import glob
import inspect
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import ModelConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.core import latency, spdy
from repro_torch.core.database import build_database
from repro_torch.core.hessian import collect_hessians
from repro_torch.core.latency import build_measured_table, build_table
from repro_torch.core.latency_cache import (FORMAT_VERSION, LatencyCache,
                                            cache_key, default_cache_dir)
from repro_torch.core.pipeline import (FamilyPreempted, family_run_dir,
                                       gradual_prune)
from repro_torch.data import calibration_batches, synthetic_stream
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.costmodel import InferenceEnv

JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
ENV = InferenceEnv(batch=4, seq=32, mode="prefill", hw=None)
KW = dict(grid_subsample=8, reps=1)
# a table that a search runs on: the CPU prices each point by the
# fastest of its calls, and one call cannot outrun a wait for a core
SEARCH_KW = dict(grid_subsample=8, reps=5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cfg(tiny_cfg):
    """The port's config of the reference's tiny GPT-2 (conftest)."""
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(tiny_cfg)
                          .items() if k not in JAX_EXECUTION})


@pytest.fixture(scope="module")
def params(tiny_params):
    return params_from_numpy(jax.tree.map(np.asarray, tiny_params),
                             device="cpu")


def _reps():
    return latency.TIMING_STATS["reps"]


def _measure(cfg, d, env=ENV, **kw):
    return build_table(cfg, env, backend="measure", device="cpu",
                       cache_dir=d, **(kw or KW))


def _tables_equal(a, b):
    assert sorted(a.grids) == sorted(b.grids)
    for k in a.grids:
        np.testing.assert_array_equal(a.grids[k], b.grids[k])
        np.testing.assert_array_equal(a.times[k], b.times[k])
        assert a.times[k].dtype == b.times[k].dtype
    assert a.base == b.base


def test_roundtrip_hit_and_miss(cfg, tmp_path):
    lc = LatencyCache(str(tmp_path))
    assert lc.get(cfg, ENV, CPU, **KW) is None          # cold miss
    tab = build_measured_table(cfg, ENV, CPU, **KW)
    path = lc.put(cfg, ENV, tab, CPU, **KW)
    assert os.path.dirname(path) == str(tmp_path)
    got = lc.get(cfg, ENV, CPU, **KW)
    assert got is not None and got.env == ENV
    _tables_equal(tab, got)


def test_build_table_hit_performs_zero_timing_reps(cfg, tmp_path):
    d = str(tmp_path)
    calls = latency.TIMING_STATS["calls"]
    t1 = _measure(cfg, d)
    assert latency.TIMING_STATS["calls"] > calls
    before = _reps()
    t2 = _measure(cfg, d)
    assert _reps() == before                            # nothing timed
    _tables_equal(t1, t2)
    # refresh measures again, even on a warm cache, and overwrites it
    t3 = _measure(cfg, d, refresh=True, **KW)
    assert _reps() > before
    _tables_equal(t3, _measure(cfg, d))
    # the cost-model table is never cached
    build_table(cfg, ENV.replace(hw=latency.cm.H100_SXM), device="cpu",
                cache_dir=d)
    assert len(glob.glob(os.path.join(d, "lat_*.json"))) == 1


def test_invalidation_on_cfg_env_and_measure_change(cfg, tmp_path):
    d = str(tmp_path)
    _measure(cfg, d)
    for other_cfg, other_env, kw in [
        (cfg.replace(d_ff=192), ENV, KW),                    # cfg
        (cfg, ENV.replace(batch=8), KW),                     # env
        (cfg, ENV, dict(grid_subsample=4, reps=1)),          # measure kw
        (cfg, ENV, dict(KW, warmup=0)),                      # measure kw
    ]:
        before = _reps()
        _measure(other_cfg, d, env=other_env, **kw)
        assert _reps() > before, (other_cfg.name, other_env, kw)
    assert len(glob.glob(os.path.join(d, "lat_*.json"))) == 5


def test_cpu_timing_takes_the_fastest_call():
    """A call that waits for a core (here: sleeps 50 ms) does not price
    the module: the CPU's time is the fastest of the timed calls. A mean
    of one such call priced a family's logits head above every target's
    budget on a loaded host."""
    calls = []

    def fn():
        calls.append(None)
        if len(calls) == 2:                  # the first timed call
            time.sleep(0.05)

    before = _reps()
    t = latency._time_fn(fn, reps=5, warmup=1, dev=CPU)
    assert len(calls) == 6 and _reps() == before + 5
    assert 0.0 <= t < 0.01


def test_key_names_the_device_and_the_torch_version(cfg, monkeypatch):
    key = cache_key(cfg, ENV, KW, "cpu")
    assert key["device"] == {"type": "cpu",
                             "torch_version": torch.__version__,
                             "cuda_version": torch.version.cuda}
    assert key["cfg"]["d_ff"] == cfg.d_ff and key["env"]["batch"] == 4
    assert key["format_version"] == FORMAT_VERSION
    assert key["measure"] == {"grid_subsample": 8, "reps": 1, "warmup": 1}
    # another torch version, or a card, keys another table
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert cache_key(cfg, ENV, KW, "cpu") != key
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda dev=None: (9, 0))
    card = cache_key(cfg, ENV, KW, "cuda")
    assert card["device"]["name"] == "NVIDIA H100 80GB HBM3"
    assert card["device"]["capability"] == [9, 0]
    assert card != key
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA A100-SXM4-80GB")
    assert cache_key(cfg, ENV, KW, "cuda") != card


def test_a_table_from_another_device_is_a_miss(cfg, tmp_path, monkeypatch):
    d = str(tmp_path)
    _measure(cfg, d)
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    before = _reps()
    _measure(cfg, d)
    assert _reps() > before
    assert len(glob.glob(os.path.join(d, "lat_*.json"))) == 2


def test_key_resolves_measure_defaults(cfg):
    """An implicit-default call and an explicit call with the same values
    key alike (the defaults are folded in, so a changed default also
    invalidates the old tables)."""
    defaults = {n: p.default for n, p in
                inspect.signature(build_measured_table).parameters.items()
                if p.default is not inspect.Parameter.empty}
    assert defaults == {"grid_subsample": 4, "reps": 5, "warmup": 1}
    assert cache_key(cfg, ENV, {}, "cpu") == cache_key(cfg, ENV, defaults,
                                                       "cpu")
    assert cache_key(cfg, ENV, {}, "cpu") != cache_key(cfg, ENV, KW, "cpu")


def test_corrupt_and_foreign_files_are_counted_misses(cfg, tmp_path):
    """Unparseable and payload-hash failures count as ``cache_corrupt``,
    a wrong format version or key as ``cache_foreign``; each names the
    file in ``cache_flagged`` and leaves it in place, and the next
    ``build_table`` measures again and overwrites it."""
    d = str(tmp_path)
    stats = latency.TIMING_STATS
    c0, f0 = stats["cache_corrupt"], stats["cache_foreign"]
    n0 = len(stats["cache_flagged"])
    lc = LatencyCache(d)
    assert lc.get(cfg, ENV, CPU, **KW) is None          # a cold miss
    assert (stats["cache_corrupt"], stats["cache_foreign"]) == (c0, f0)
    _measure(cfg, d)
    (path,) = glob.glob(os.path.join(d, "lat_*.json"))

    def rewrite(edit):
        with open(path) as f:
            rec = json.load(f)
        edit(rec)
        with open(path, "w") as f:
            json.dump(rec, f)

    def flags():
        return (stats["cache_corrupt"] - c0, stats["cache_foreign"] - f0,
                len(stats["cache_flagged"]) - n0)

    with open(path, "w") as f:                         # not JSON at all
        f.write("{broken")
    assert lc.get(cfg, ENV, CPU, **KW) is None
    assert flags() == (1, 0, 1)
    assert stats["cache_flagged"][-1] == os.path.basename(path)
    before = _reps()
    tab = _measure(cfg, d)             # a miss again: measured and stored
    assert _reps() > before and flags() == (2, 0, 2)
    _tables_equal(tab, lc.get(cfg, ENV, CPU, **KW))

    rewrite(lambda rec: rec["payload"].update(base=123.0))   # tampered
    assert lc.get(cfg, ENV, CPU, **KW) is None
    assert flags() == (3, 0, 3)
    assert _measure(cfg, d).base != 123.0

    rewrite(lambda rec: rec.update(format_version=FORMAT_VERSION + 1))
    assert lc.get(cfg, ENV, CPU, **KW) is None
    assert flags() == (4, 1, 5)
    _measure(cfg, d)

    rewrite(lambda rec: rec["key"]["cfg"].update(d_ff=1))  # copied key
    assert lc.get(cfg, ENV, CPU, **KW) is None
    assert flags() == (4, 3, 7)
    assert os.path.exists(path)                        # never renamed


def test_default_dir_resolution(cfg, monkeypatch, tmp_path):
    monkeypatch.delenv("ZIPLM_LATENCY_CACHE", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert default_cache_dir() == str(tmp_path / "home" / ".cache" /
                                      "ziplm" / "latency")
    assert LatencyCache().dir == default_cache_dir()
    assert LatencyCache(str(tmp_path / "x")).dir == str(tmp_path / "x")
    # a bare measured build_table stays hermetic: no cache, no file
    build_table(cfg, ENV, backend="measure", device="cpu", **KW)
    assert not os.path.exists(tmp_path / "home")
    # the variable opts in
    monkeypatch.setenv("ZIPLM_LATENCY_CACHE", str(tmp_path / "lc"))
    assert default_cache_dir() == str(tmp_path / "lc")
    build_table(cfg, ENV, backend="measure", device="cpu", **KW)
    assert glob.glob(str(tmp_path / "lc" / "lat_*.json"))
    before = _reps()
    build_table(cfg, ENV, backend="measure", device="cpu", **KW)
    assert _reps() == before
    # an explicit cache_dir comes first
    build_table(cfg, ENV, backend="measure", device="cpu",
                cache_dir=str(tmp_path / "mine"), **KW)
    assert glob.glob(str(tmp_path / "mine" / "lat_*.json"))


def test_cache_hit_gives_identical_spdy_assignments(cfg, params, tmp_path):
    """A cached table drives the search to the assignments of the fresh
    table it stores."""
    env = InferenceEnv(batch=8, seq=64, mode="prefill", hw=None)
    fresh = _measure(cfg, str(tmp_path), env=env, **SEARCH_KW)
    before = _reps()
    hit = _measure(cfg, str(tmp_path), env=env, **SEARCH_KW)
    assert _reps() == before
    _tables_equal(fresh, hit)
    calib = calibration_batches(cfg, 16, 64, batch=8)
    hess = collect_hessians(cfg, params, calib, device="cpu")
    db = build_database(cfg, params, hess, device="cpu")
    for batched in (True, False):
        a = spdy.search(db, fresh, 2.0, steps=30, seed=0, batched=batched)
        b = spdy.search(db, hit, 2.0, steps=30, seed=0, batched=batched)
        assert a.assignment == b.assignment
        assert a.runtime == b.runtime and a.score == b.score


# ---------------------------------------------------------------------------
# a measured-table family, killed and resumed against its cached table
# ---------------------------------------------------------------------------

FT_STEPS = 8
TARGETS = [1.5, 2.0]
FAMILY_ENV = InferenceEnv(batch=8, seq=64, mode="prefill", hw=None)


def _family(cfg, params, base, cache, **extra):
    return gradual_prune(
        cfg, params, FAMILY_ENV, TARGETS,
        lambda step: synthetic_stream(cfg, 16, 64, seed=99,
                                      start_step=step),
        calibration_batches(cfg, 16, 64, batch=8), ckpt_dir=str(base),
        tcfg=TrainConfig(learning_rate=5e-4, warmup_steps=2,
                         total_steps=FT_STEPS, distill_logit=1.0,
                         distill_token=0.5),
        finetune_steps=FT_STEPS, search_steps=4, search_pop=4,
        ckpt_every=4, latency_backend="measure",
        latency_kw=dict(SEARCH_KW, cache_dir=str(cache)), device="cpu",
        **extra)


def _same_family(want, got):
    assert [v.target for v in got] == [v.target for v in want]
    for vw, vg in zip(want, got):
        assert vw.assignment == vg.assignment
        assert vw.achieved == vg.achieved
        assert vw.loss_before_ft == vg.loss_before_ft
        assert vw.loss_after_ft == vg.loss_after_ft
        lw, lg = tree_leaves(vw.params), tree_leaves(vg.params)
        assert len(lw) == len(lg) and all(torch.equal(x, y)
                                          for x, y in zip(lw, lg))


@pytest.mark.parametrize("search_batched", [True, False])
def test_measured_family_resumes_bit_equal_on_its_cached_table(
        cfg, params, tmp_path, search_batched):
    """Run A measures the table and stores it; run B, in another run
    directory, reads it, is killed mid-finetune of its second target and
    resumed, and equals A bit for bit. The cache's location is not in
    the resume header."""
    cache = tmp_path / "cache"
    before = _reps()
    want = _family(cfg, params, tmp_path / "a", cache,
                   search_batched=search_batched)
    assert _reps() > before
    assert len(glob.glob(str(cache / "lat_*.json"))) == 1
    before = _reps()
    with pytest.raises(FamilyPreempted):
        _family(cfg, params, tmp_path / "b", cache,
                search_batched=search_batched,
                stop_after=(1, "finetune", 6))
    got = _family(cfg, params, tmp_path / "b", cache,
                  search_batched=search_batched)
    assert _reps() == before                      # nothing timed again
    _same_family(want, got)
    path = os.path.join(family_run_dir(cfg, TARGETS, 0, str(tmp_path / "b")),
                        "family.json")
    with open(path) as f:
        header = json.load(f)["header"]
    assert header["search_batched"] is search_batched
    assert header["inputs"]["latency"] == [
        "measure", {k: repr(v) for k, v in sorted(SEARCH_KW.items())}]
