"""The port's gradual family engine (``core/pipeline.py`` ``gradual_prune``)
on the CPU: the ten resume contracts of tests/test_family_resume.py run
in the port, then the port's family held against the JAX package's on
the same weights (moved over by the weight bridge), calibration batches,
token stream and cost-model table, and its database stage fed the
reference run's own target-1 params; last the manifest's helpers,
artifact integrity and the arguments that are not ported (and those
ported since: the serial search and the latency cache).

Tolerances: assignments and achieved speedups equal (the two tables
are equal number for number, tests/test_torch_core.py); per-target
losses 1e-4 relative and final params 1e-5 absolute, the trainer's
parity tolerances (tests/test_torch_train.py
``test_train_steps_match_reference_from_a_jax_state``: 8 steps a target
here at lr 5e-4, where the trainer test takes 5 at 1e-3); removal
orders equal. Within the port a resumed run equals an uninterrupted one
bit for bit.
"""
import dataclasses
import json
import os
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core.pipeline import family_run_dir as ref_family_run_dir
from repro.core.pipeline import family_run_key as ref_family_run_key
from repro.core.pipeline import gradual_prune as ref_gradual_prune
from repro.data import calibration_batches as ref_calibration_batches
from repro.data import synthetic_stream as ref_synthetic_stream
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro_torch.checkpoint.manager import file_sha256, restore_pytree
from repro_torch.configs import ModelConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.core import spdy
from repro_torch.core.database import build_database
from repro_torch.core.hessian import collect_hessians
from repro_torch.core.latency import build_table
from repro_torch.core.pipeline import (FamilyPreempted, FamilyRunState,
                                       _db_arrays, _load_db, _load_hessians,
                                       _save_artifact, _save_db,
                                       _save_hessians, _tree_digest,
                                       family_run_dir, family_run_key,
                                       gradual_prune)
from repro_torch.core.structures import registry
from repro_torch.data import calibration_batches, synthetic_stream
from repro_torch.models import forward, model_init
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.pruned import forward_pruned
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.robustness import (checked_npz_load, current_report,
                                    report_scope)
from repro_torch.robustness.report import RobustnessReport
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv

# the JAX package's tracing and tiling options, which the port's config
# does not carry
JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
ENV_KW = dict(batch=8, seq=64, mode="prefill")
ENV = InferenceEnv(hw=HardwareSpec(**dataclasses.asdict(TPU_V5E)), **ENV_KW)
FT_STEPS = 8
TARGETS = [1.5, 2.0]
TCFG_KW = dict(learning_rate=5e-4, warmup_steps=2, total_steps=FT_STEPS,
               distill_logit=1.0, distill_token=0.5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(ref_cfg):
    """The port's config of a reference config, field for field."""
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(ref_cfg).items()
                          if k not in JAX_EXECUTION})


def _kw():
    return dict(tcfg=TrainConfig(**TCFG_KW), finetune_steps=FT_STEPS,
                search_steps=4, search_pop=4, ckpt_every=4)


def _data(cfg):
    return lambda step: synthetic_stream(cfg, 16, 64, seed=99,
                                         start_step=step)


@pytest.fixture(scope="module")
def cfg(tiny_cfg):
    return port_cfg(tiny_cfg)


@pytest.fixture(scope="module")
def params(tiny_params):
    return params_from_numpy(jax.tree.map(np.asarray, tiny_params),
                             device="cpu")


@pytest.fixture(scope="module")
def calib(cfg):
    return calibration_batches(cfg, 16, 64, batch=8)


@pytest.fixture(scope="module")
def run(cfg, params, calib):
    def go(base, seed=0, p=None, **extra):
        return gradual_prune(cfg, params if p is None else p, ENV, TARGETS,
                             _data(cfg), calib, ckpt_dir=str(base),
                             seed=seed, device="cpu", **_kw(), **extra)
    return go


def _manifest(cfg, base, seed=0):
    path = os.path.join(family_run_dir(cfg, TARGETS, seed, str(base)),
                        "family.json")
    with open(path) as f:
        return json.load(f)


def _executed(man, run):
    return [(e["target"], e["stage"]) for e in man["executed"]
            if e["run"] == run]


def _tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _same_family(want, got, losses=True):
    assert [v.target for v in got] == [v.target for v in want]
    for vw, vg in zip(want, got):
        assert vw.assignment == vg.assignment
        assert vw.achieved == vg.achieved
        assert _tree_equal(vw.params, vg.params)
        if losses:
            assert vw.loss_before_ft == vg.loss_before_ft
            assert vw.loss_after_ft == vg.loss_after_ft


@pytest.fixture(scope="module")
def uninterrupted(run, tmp_path_factory):
    base = tmp_path_factory.mktemp("port_family_full")
    return base, run(base)


# ---------------------------------------------------------------------------
# the ten resume contracts of tests/test_family_resume.py, in the port
# ---------------------------------------------------------------------------

def test_kill_mid_finetune_resume_bit_identical(cfg, run, tmp_path,
                                                uninterrupted):
    """Kill target #2 mid-finetune (after 6 of 8 steps, last checkpoint
    at 4), resume, and compare against the uninterrupted run."""
    with pytest.raises(FamilyPreempted):
        run(tmp_path, stop_after=(1, "finetune", 6))
    resumed = run(tmp_path)
    _same_family(uninterrupted[1], resumed)
    man = _manifest(cfg, tmp_path)
    assert _executed(man, 2) == [("2", "finetune")]
    assert _executed(man, 1) == [
        ("1.5", "hessians"), ("1.5", "db"), ("1.5", "search"),
        ("1.5", "finetune"), ("2", "hessians"), ("2", "db"),
        ("2", "search"), ("2", "finetune")]


def test_kill_between_stages_resumes_next_stage(cfg, run, tmp_path,
                                                uninterrupted):
    """Killed right after target #2's database is persisted, the resume
    loads the Hessians and database and runs only search and finetune."""
    with pytest.raises(FamilyPreempted):
        run(tmp_path, stop_after=(1, "db"))
    resumed = run(tmp_path)
    _same_family(uninterrupted[1], resumed)
    assert _executed(_manifest(cfg, tmp_path), 2) == [("2", "search"),
                                                      ("2", "finetune")]


def test_interleaved_runs_never_cross_restore(cfg, run, tmp_path,
                                              uninterrupted):
    """Two interleaved family runs with different seeds in one base
    directory keep separate state: each preempted run resumes its own
    manifest and trainer checkpoints and finishes equal to its solo run
    (seed 0's solo run is the uninterrupted fixture)."""
    solo = {0: uninterrupted[1], 1: run(tmp_path / "solo1", seed=1)}
    base = tmp_path / "shared"
    for seed in (0, 1):
        with pytest.raises(FamilyPreempted):
            run(base, seed=seed, stop_after=(1, "finetune", 6))
    for seed in (0, 1):
        _same_family(solo[seed], run(base, seed=seed))
    d0 = family_run_dir(cfg, TARGETS, 0, str(base))
    d1 = family_run_dir(cfg, TARGETS, 1, str(base))
    assert d0 != d1 and os.path.isdir(d0) and os.path.isdir(d1)


def test_overlap_schedule_bit_identical_to_serial(cfg, run, tmp_path,
                                                  uninterrupted):
    """The overlapped schedule (the default; the uninterrupted fixture)
    equals the serial one bit for bit, and every target's record carries
    the seconds of each stage."""
    serial = run(tmp_path, overlap=False)
    _same_family(uninterrupted[1], serial)
    for man in (_manifest(cfg, tmp_path), _manifest(cfg, uninterrupted[0])):
        for t in ("1.5", "2"):
            st = man["targets"][t]["stage_times"]
            assert set(st) == {"hessians", "db", "search", "finetune",
                               "export"}
            assert all(v >= 0.0 for v in st.values())


def test_overlap_kill_during_export_window_resumes(cfg, run, tmp_path,
                                                   uninterrupted):
    """Killed right after target #2's Hessians, while target #1's export
    may still be in flight: the barrier before the raise leaves a serial
    run's state (target #1 done, its params.npz durable and matching its
    sha), and the resume runs only target #2's db, search and finetune."""
    with pytest.raises(FamilyPreempted):
        run(tmp_path, stop_after=(1, "hessians"))
    man = _manifest(cfg, tmp_path)
    assert man["targets"]["1.5"]["stage"] == "done"
    ppath = os.path.join(family_run_dir(cfg, TARGETS, 0, str(tmp_path)),
                         "t1.5", "params.npz")
    assert file_sha256(ppath) == man["targets"]["1.5"]["params_sha256"]
    _same_family(uninterrupted[1], run(tmp_path))
    assert _executed(_manifest(cfg, tmp_path), 2) == [
        ("2", "db"), ("2", "search"), ("2", "finetune")]


def test_done_without_params_artifact_rolls_back_to_search(cfg, run,
                                                           tmp_path,
                                                           uninterrupted):
    """The manifest says "done" but params.npz never reached the disk:
    the done-restore path rolls the target back to its search stage and
    repairs it from the search result and the trainer's checkpoints."""
    run(tmp_path)
    run_dir = family_run_dir(cfg, TARGETS, 0, str(tmp_path))
    os.remove(os.path.join(run_dir, "t2", "params.npz"))
    _same_family(uninterrupted[1], run(tmp_path))
    assert os.path.exists(os.path.join(run_dir, "t2", "params.npz"))
    # the trainer's step-8 checkpoint holds the final params: no stage runs
    assert _executed(_manifest(cfg, tmp_path), 2) == []


@pytest.mark.parametrize("lost_params", [False, True],
                         ids=["killed-mid-finetune", "params-lost"])
def test_dropped_checkpoints_keep_the_family_and_its_resume(
        cfg, run, tmp_path, uninterrupted, lost_params):
    """``keep_checkpoints=False`` removes each target's trainer
    checkpoints once its finetune has returned, and the family keeps its
    bits: killed mid-finetune (the in-flight target's checkpoints stay
    until it returns) and resumed; or done, its params.npz lost, and
    finetuned again from step 0 on the resume."""
    run_dir = family_run_dir(cfg, TARGETS, 0, str(tmp_path))
    if lost_params:
        _same_family(uninterrupted[1], run(tmp_path,
                                           keep_checkpoints=False))
        os.remove(os.path.join(run_dir, "t2", "params.npz"))
        expect = [("2", "finetune")]
    else:
        with pytest.raises(FamilyPreempted):
            run(tmp_path, stop_after=(1, "finetune", 6),
                keep_checkpoints=False)
        assert not os.path.exists(os.path.join(run_dir, "t1.5", "ckpt"))
        assert os.path.isdir(os.path.join(run_dir, "t2", "ckpt"))
        expect = [("2", "finetune")]
    _same_family(uninterrupted[1], run(tmp_path, keep_checkpoints=False))
    man = _manifest(cfg, tmp_path)
    assert _executed(man, man["runs"]) == expect
    for t in ("t1.5", "t2"):
        assert not os.path.exists(os.path.join(run_dir, t, "ckpt"))
        assert os.path.exists(os.path.join(run_dir, t, "params.npz"))


def test_run_dir_unique_per_family(cfg):
    dirs = {family_run_dir(cfg, [1.5, 2.0], 0),
            family_run_dir(cfg, [1.5, 2.0], 1),
            family_run_dir(cfg, [1.5, 3.0], 0),
            family_run_dir(cfg.replace(name="other"), [1.5, 2.0], 0)}
    assert len(dirs) == 4
    assert family_run_key(cfg, [2.0, 1.5], 0) == \
        family_run_key(cfg, [1.5, 2.0], 0)


def test_bad_stop_after_rejected(run, tmp_path):
    with pytest.raises(ValueError, match="step"):
        run(tmp_path, stop_after=(1, "finetune"))
    with pytest.raises(ValueError, match="stage"):
        run(tmp_path, stop_after=(0, "spdy"))
    assert not any(tmp_path.iterdir())


def test_resume_with_changed_inputs_raises(params, run, tmp_path):
    """Same (cfg, targets, seed) but other params: the input fingerprints
    in the manifest header make the resume fail loudly."""
    with pytest.raises(FamilyPreempted):
        run(tmp_path, stop_after=(0, "hessians"))
    other = tree_map(lambda p: p + 1e-3, params)
    with pytest.raises(ValueError, match="different run"):
        run(tmp_path, p=other)


def test_header_mismatch_raises(cfg, tmp_path):
    run_dir = str(tmp_path / "run")
    FamilyRunState(run_dir, {"cfg": cfg.name, "x": 1})
    with pytest.raises(ValueError, match="different run"):
        FamilyRunState(run_dir, {"cfg": cfg.name, "x": 2})


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_family(tiny_cfg, tiny_params, tmp_path_factory):
    """The reference's uninterrupted family on the same weights, batches,
    stream and table, with tests/test_family_resume.py's settings."""
    base = str(tmp_path_factory.mktemp("ref_family"))
    fam = ref_gradual_prune(
        tiny_cfg, tiny_params, RefEnv(hw=TPU_V5E, **ENV_KW), TARGETS,
        lambda step: ref_synthetic_stream(tiny_cfg, 16, 64, seed=99,
                                          start_step=step),
        ref_calibration_batches(tiny_cfg, 16, 64, batch=8),
        tcfg=RefTrainConfig(**TCFG_KW), finetune_steps=FT_STEPS,
        search_steps=4, search_pop=4, ckpt_every=4, ckpt_dir=base, seed=0)
    return ref_family_run_dir(tiny_cfg, TARGETS, 0, base), fam


def test_family_matches_the_reference(ref_family, uninterrupted):
    _, want = ref_family
    got = uninterrupted[1]
    assert [v.target for v in got] == [v.target for v in want] == TARGETS
    for vw, vg in zip(want, got):
        assert vg.assignment == {k: int(v) for k, v in vw.assignment.items()}
        assert vg.achieved == vw.achieved
        assert vg.achieved >= vg.target
        np.testing.assert_allclose(vg.loss_before_ft, vw.loss_before_ft,
                                   rtol=1e-4)
        np.testing.assert_allclose(vg.loss_after_ft, vw.loss_after_ft,
                                   rtol=1e-4)
        ref_leaves = jax.tree.leaves(vw.params)
        port_leaves = tree_leaves(vg.params)
        assert len(ref_leaves) == len(port_leaves)
        for r, p in zip(ref_leaves, port_leaves):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-5)
        # the shrunk members keep the same structures; an FFN dropped
        # whole keeps its output bias in the port (the reference's shrink
        # drops it), d_model parameters each
        emptied = sum(1 for l in vg.pruned.layers
                      if l.d_ff == 0 and "ffn" in l.params)
        assert vg.pruned.num_params() == (vw.pruned.num_params()
                                          + emptied * vg.pruned.cfg.d_model)


def _keys(node):
    """The key structure of a JSON document: dicts by key, lists by the
    union of their elements' structures."""
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    if isinstance(node, list):
        return [k for k in {json.dumps(_keys(v), sort_keys=True): None
                            for v in node}]
    return None


def test_manifest_has_the_reference_keys_and_run_key(cfg, tiny_cfg,
                                                     ref_family,
                                                     uninterrupted):
    with open(os.path.join(ref_family[0], "family.json")) as f:
        want = json.load(f)
    got = _manifest(cfg, uninterrupted[0])
    assert _keys(got) == _keys(want)
    assert got["executed"] == want["executed"]
    assert got["header"]["run_key"] == want["header"]["run_key"] == \
        ref_family_run_key(tiny_cfg, TARGETS, 0) == \
        family_run_key(cfg, TARGETS, 0)
    for t in ("1.5", "2"):
        assert got["targets"][t]["stage"] == want["targets"][t]["stage"] \
            == "done"
        assert got["targets"][t]["assignment"] == \
            want["targets"][t]["assignment"]


def test_database_fed_the_reference_params_keeps_its_orders(cfg, params,
                                                            calib,
                                                            ref_family):
    """The port's calibration and database stages on the reference run's
    finetuned target-1 params give the removal orders of the reference's
    target-2 database."""
    run_dir = ref_family[0]
    member = restore_pytree(params, os.path.join(run_dir, "t1.5",
                                                 "params.npz"))
    db = build_database(cfg, member, collect_hessians(cfg, member, calib,
                                                      device="cpu"),
                        device="cpu")
    with np.load(os.path.join(run_dir, "t2", "db.npz")) as ref_db:
        for name, mdb in db.items():
            np.testing.assert_array_equal(mdb.order,
                                          ref_db[f"{name}::order"],
                                          err_msg=name)


def test_variant_is_the_shrunk_finetuned_model(cfg, calib, uninterrupted):
    """A variant's ``pruned`` model is shrunk from its finetuned params
    (the reference's takes the out-side matrices from the database's
    pre-finetune snapshots). The masks pin the removed rows only, so the
    finetune also trains the out-side bias of an FFN it drops whole; the
    shrunk model keeps that bias (the reference's drops it with the
    module), so the two give the same logits."""
    tokens = calib[0]["tokens"]
    mods = {m.name: m for m in registry(cfg)}
    dropped = 0
    for v in uninterrupted[1]:
        for name, removed in v.assignment.items():
            if mods[name].kind == "ffn" and removed == mods[name].n_structures:
                assert float(v.params["layers"]["ffn"]["bd"][
                    mods[name].layer].abs().max()) > 0
                dropped += 1
        with torch.no_grad():
            want = forward(cfg, v.params, tokens)["logits"]
            got = forward_pruned(v.pruned, tokens)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert dropped  # this family drops an FFN whole, so the case is seen


# ---------------------------------------------------------------------------
# helpers, integrity, arguments not ported
# ---------------------------------------------------------------------------

def test_stage_artifacts_round_trip_in_registry_order(cfg, tmp_path):
    """The Hessians and the database through their npz artifacts, on 12
    layers: "L10.attn" sorts before "L2.attn", and the loaded database
    must keep the registry's order (SPDY's RNG streams follow it)."""
    deep = cfg.replace(num_layers=12, d_model=32, d_ff=64, num_heads=2,
                       num_kv_heads=2, vocab_size=64)
    p = model_init(deep, torch.Generator().manual_seed(0), device="cpu")
    hessians = collect_hessians(deep, p, calibration_batches(deep, 8, 32,
                                                             batch=8),
                                device="cpu")
    hpath = str(tmp_path / "hessians.npz")
    loaded = _load_hessians(hpath, expected_sha=_save_hessians(hpath,
                                                               hessians))
    assert list(loaded) == list(hessians)
    assert all(torch.equal(loaded[k], hessians[k]) for k in hessians)
    db = build_database(deep, p, loaded, device="cpu")
    names = [m.name for m in registry(deep)]
    assert list(db) == names != sorted(names)
    path = str(tmp_path / "db.npz")
    sha = _save_db(path, db)
    assert sha == file_sha256(path)
    got = _load_db(deep, path, expected_sha=sha)
    assert list(got) == names
    arrs = _db_arrays(got)
    for k, v in _db_arrays(db).items():
        assert arrs[k].dtype == v.dtype
        np.testing.assert_array_equal(arrs[k], v, err_msg=k)
    assert all(got[n].mod == db[n].mod for n in names)


def test_checked_npz_load_quarantines_corrupt_files(tmp_path):
    path = str(tmp_path / "a.npz")
    arrays = {"x": np.arange(1000, dtype=np.float32)}
    with report_scope() as rep:
        sha = _save_artifact(path, arrays)
        np.testing.assert_array_equal(checked_npz_load(path, sha)["x"],
                                      arrays["x"])
        with open(path, "r+b") as f:       # flip one byte of the payload
            f.seek(200)
            b = f.read(1)
            f.seek(200)
            f.write(bytes([b[0] ^ 0xFF]))
        assert checked_npz_load(path, sha) is None
        assert not os.path.exists(path)
        assert os.path.exists(path + ".corrupt")
        _save_artifact(path, arrays)
        with open(path, "r+b") as f:       # truncate: no longer a zip
            f.truncate(100)
        assert checked_npz_load(path) is None
        assert os.path.exists(path + ".corrupt.1")
        assert checked_npz_load(str(tmp_path / "missing.npz")) is None
    assert rep.quarantined == [path + ".corrupt", path + ".corrupt.1"]
    assert rep.total("detected") == 2
    assert len(rep.as_dict()["notes"]) == 2


def test_report_scope_nests_and_restores():
    outer = current_report()
    mine = RobustnessReport()
    with report_scope(mine) as a:
        assert a is mine and current_report() is mine
        with report_scope() as b:
            assert current_report() is b and b is not mine
            b.count("retries", "site")
        assert current_report() is mine
    assert current_report() is outer
    assert mine.total("retries") == 0 and b.total("retries") == 1


def test_report_counts_from_many_threads():
    """The checkpoint worker and the export thread count into one report:
    no count or quarantine entry is lost between threads."""
    rep = RobustnessReport()
    n_threads, n = 16, 500

    def work(k):
        for i in range(n):
            rep.count("retries", f"site{i % 3}")
            rep.quarantine(f"{k}.{i}")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert rep.total("retries") == rep.total("detected") == n_threads * n
    assert len(rep.as_dict()["quarantined"]) == n_threads * n


def test_tree_digest_is_stable_and_sees_one_element():
    g = torch.Generator().manual_seed(0)

    def tree(bump=None):
        t = {"small": torch.randn(10, generator=g.manual_seed(0)),
             "large": torch.randn(100, 100, generator=g.manual_seed(1)),
             "half": torch.randn(50, 200,
                                 generator=g.manual_seed(2)).bfloat16(),
             "batches": [{"tokens": torch.arange(64).reshape(2, 32)}]}
        if bump is not None:
            leaf = t["batches"][0]["tokens"] if bump == "tokens" \
                else t[bump]
            leaf.view(-1)[0] += 1
        return t

    d = _tree_digest(tree())
    assert d == _tree_digest(tree())
    for bump in ("small", "large", "half", "tokens"):
        assert _tree_digest(tree(bump)) != d, bump


def test_arguments_not_ported_raise(run, tmp_path):
    """The mesh trainer's arguments without a mesh raise before the run
    writes anything (the mesh family runs in
    ``test_mesh_family_on_one_rank_is_the_single_process_family`` and in
    tests/test_torch_mesh_train.py). The serial search and the latency
    cache (item 4) are ported: each runs through its first search (on the
    cost-model table, which is never cached)."""
    from repro_torch.configs.base import MeshConfig
    for kw in ({"specs": {}}, {"mc": MeshConfig()}):
        with pytest.raises(ValueError, match="need a mesh"):
            run(tmp_path, **kw)
    assert not any(tmp_path.iterdir())
    cache = tmp_path / "cache"
    for i, kw in enumerate(({"search_batched": False},
                            {"latency_kw": {"cache_dir": str(cache)}})):
        with pytest.raises(FamilyPreempted):
            run(tmp_path / str(i), stop_after=(0, "search"), **kw)
    assert not cache.exists()


def test_search_arguments_not_ported_raise(ref_family, cfg):
    """``spdy.search`` is a one-target ``search_family``; its
    multi-device path (ported with item 6b) and its serial path (ported
    with item 4) give the batched path's result."""
    db = _load_db(cfg, os.path.join(ref_family[0], "t1.5", "db.npz"))
    table = build_table(cfg, ENV, device="cpu")

    def placeable(al, device=None):
        return np.asarray([float(sum(a.values())) for a in al])

    placeable.supports_device = True
    kw = dict(steps=8, pop=4, seed=5, eval_batched=placeable)
    on_two = spdy.search(db, table, 1.5, devices=["cpu", "cpu"], **kw)
    unplaced = spdy.search(db, table, 1.5, **kw)
    assert on_two.assignment == unplaced.assignment
    assert on_two.score == unplaced.score
    assert on_two.history == unplaced.history
    one = spdy.search(db, table, 1.5, steps=8, pop=4, seed=5)
    fam = spdy.search_family(db, table, [1.5], steps=8, pop=4, seed=5)[1.5]
    assert one.assignment == fam.assignment and one.score == fam.score
    serial = spdy.search(db, table, 1.5, steps=8, pop=4, seed=5,
                         batched=False)
    assert serial.assignment == one.assignment
    assert serial.score == one.score and serial.history == one.history
    # eval_fn alone scores the candidates one by one, as the reference's
    # batched path does without eval_batched
    by_fn = spdy.search(db, table, 1.5, steps=8, pop=4, seed=5,
                        eval_fn=lambda a: float(sum(a.values())))
    by_batch = spdy.search(
        db, table, 1.5, steps=8, pop=4, seed=5,
        eval_batched=lambda al: np.asarray([float(sum(a.values()))
                                            for a in al]))
    assert by_fn.assignment == by_batch.assignment
    assert by_fn.score == by_batch.score


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo process group of this process alone (a file rendezvous in a
    temporary directory), destroyed afterwards."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "rendezvous"), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("with_specs", [False, True],
                         ids=["calibration_only", "mesh_trainer"])
def test_mesh_family_on_one_rank_is_the_single_process_family(
        cfg, run, tmp_path, uninterrupted, one_rank_group, with_specs):
    """``gradual_prune(mesh=)`` runs, here over a mesh of one rank: its
    calibration, database, search and (with ``specs``) mesh trainer take
    their mesh routes, and the family is the single-process family bit
    for bit."""
    from repro_torch.distributed import make_mesh
    from repro_torch.models import model_specs
    mesh = make_mesh((1,), ("data",))
    fam = run(tmp_path, mesh=mesh,
              **({"specs": model_specs(cfg)} if with_specs else {}))
    _same_family(uninterrupted[1], fam)
    man = _manifest(cfg, tmp_path)
    want = _manifest(cfg, uninterrupted[0])
    for t in ("1.5", "2"):
        for k in ("hessians_sha256", "db_sha256", "params_sha256"):
            assert man["targets"][t][k] == want["targets"][t][k], (t, k)
