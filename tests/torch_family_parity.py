"""Shared pieces of the gradual-family parity tests of the port against the
JAX package (``tests/test_torch_moe_train.py``,
``tests/test_torch_gqa_train.py``): masked train steps from one JAX
``TrainState`` on both sides, and ``gradual_prune`` at the reference's
smoke settings (``benchmarks/run.py`` ``_gradual_family_arch`` under
``_SMOKE``) on both packages from the same numpy weights.

Tolerances are the trainer's and the family engine's parity tolerances
(tests/test_torch_train.py, tests/test_torch_ssm_train.py): each train
metric 1e-4 relative at every step, final params 1e-5 absolute; family
assignments, achieved speedups and shrunk sizes equal, losses 1e-4
relative, params 1e-5 absolute where both packages' stages take the
same database, and the fp16 snapshots' 2e-3 where each builds its own
(``assert_params_match``). Within the port a resumed run equals an
uninterrupted one bit for bit.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import database as ref_database
from repro.core import obs as ref_obs
from repro.core.pipeline import family_run_dir as ref_family_run_dir
from repro.core.pipeline import gradual_prune as ref_gradual_prune
from repro.core.pipeline import masks_from_assignment as ref_masks
from repro.core.shrink import layer_drop_plan as ref_layer_drop_plan
from repro.core.structures import PrunableModule as RefPrunableModule
from repro.data import calibration_batches as ref_calibration_batches
from repro.data import synthetic_stream as ref_synthetic_stream
from repro.data.synthetic import make_batch_np as ref_make_batch
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro.train.train_step import make_train_state as ref_make_train_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.checkpoint.manager import (atomic_write_json, file_sha256,
                                            load_json, restore_pytree)
from repro_torch.configs import ModelConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.core.database import build_database
from repro_torch.core.hessian import collect_hessians
from repro_torch.core.obs import prune_structured
from repro_torch.core.pipeline import (FamilyPreempted, family_run_dir,
                                       gradual_prune, masks_from_assignment)
from repro_torch.core.shrink import layer_drop_plan
from repro_torch.core.structures import UNITS
from repro_torch.data import (calibration_batches, make_batch_np,
                              synthetic_stream)
from repro_torch.models import forward
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv
from repro_torch.train import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
# benchmarks/run.py _gradual_family_arch in smoke mode, priced on the TPU
# table (benchmarks/run.py ENV) copied number for number into the port's
# spec
TARGETS = [1.3, 1.6]
ENV_KW = dict(batch=16, seq=128, mode="prefill")
ENV = InferenceEnv(hw=HardwareSpec(**dataclasses.asdict(TPU_V5E)), **ENV_KW)
FT_STEPS = 4
TCFG_KW = dict(learning_rate=5e-4, warmup_steps=2, total_steps=FT_STEPS,
               distill_logit=1.0, distill_token=0.5)
FAMILY_KW = dict(finetune_steps=FT_STEPS, search_steps=3, search_pop=4,
                 ckpt_every=2, seed=0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_cfg(ref_cfg) -> ModelConfig:
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(ref_cfg).items()
                          if k not in JAX_EXECUTION})


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def bridge(ref_tree):
    return params_from_numpy(to_np(ref_tree), device="cpu")


def _node(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def assert_params_match(cfg, got, want, fp16_input=False):
    """The port's params ``got`` against the reference's ``want`` (numpy),
    every leaf within 1e-5 absolute, with two exceptions.

    The key bias ``bk``: the loss does not depend on it in exact
    arithmetic (``q . bk`` shifts every score of a query alike, and the
    softmax cancels it), so its gradient is rounding noise, which Adam's
    normalisation scales up towards the step size, and each package's
    ``bk`` drifts by its own noise. It is held by the function instead:
    the port's logits with either package's ``bk`` agree within 1e-5 of
    their scale.

    ``fp16_input``: the two packages' stitches (their database snapshots
    are stored in fp16) differ where their OBS updates round a weight to
    neighbouring fp16 values, and a finetune carries that input
    difference into every leaf it trains. The params are then held as
    the fp16 snapshots are (2e-3 absolute and relative,
    tests/test_batched_db.py); a run fed the reference's databases holds
    every leaf to 1e-5."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(tree_leaves(got))
    for path, r in flat:
        what = jax.tree_util.keystr(path)
        if path[-1].key == "bk":
            continue
        tol = 2e-3 if fp16_input else 0.0
        np.testing.assert_allclose(_node(got, path).detach().numpy(), r,
                                   atol=tol or 1e-5, rtol=tol, err_msg=what)
    if cfg.qkv_bias:
        tokens = make_batch_np(cfg, 2, 32, seed=3)["tokens"]
        swapped = dict(got, layers=dict(got["layers"], attn=dict(
            got["layers"]["attn"],
            bk=torch.tensor(np.asarray(want["layers"]["attn"]["bk"])))))
        with torch.no_grad():
            a = forward(cfg, got, tokens)["logits"]
            b = forward(cfg, swapped, tokens)["logits"]
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


# ----------------------------------------------------------------------
# masks and train steps
# ----------------------------------------------------------------------

def masked_member(ref_cfg, ref_params, assignment):
    """The port's database of the dense params (its own Hessians), the
    same arrays as reference ModuleDBs, the reference's stitched member
    and the masks of both packages from it."""
    cfg = port_cfg(ref_cfg)
    p = bridge(ref_params)
    calib = calibration_batches(cfg, 8, 48, batch=8)
    port_db = build_database(cfg, p, collect_hessians(cfg, p, calib,
                                                      device="cpu"),
                             device="cpu")
    db = {name: ref_database.ModuleDB(
        mod=RefPrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for name, m in port_db.items()}
    member = ref_database.apply_assignment(ref_cfg, ref_params, db,
                                           assignment)
    return {"member": member, "port_db": port_db,
            "ref_masks": ref_masks(ref_cfg, member, db, assignment),
            "masks": masks_from_assignment(cfg, bridge(member), port_db,
                                           assignment)}


def assert_masks_equal(got, want):
    want = to_np(want)
    assert len(tree_leaves(got)) == len(jax.tree.leaves(want))
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = _node(got, path)
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), w), jax.tree_util.keystr(path)


def masked_rows(params, masks):
    """The largest |weight| where the mask is 0, over every leaf."""
    return max(float((w.detach().abs() * (m == 0)).max())
               for w, m in zip(tree_leaves(params), tree_leaves(masks)))


def train_steps_match(ref_cfg, member, teacher):
    """Five distillation steps with the member's masks and 2 microbatches
    from the same JAX TrainState on both sides; returns the port's
    final state."""
    cfg = port_cfg(ref_cfg)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5,
              microbatches=2, distill_logit=1.0, distill_token=0.5)
    ref_step = jax.jit(ref_make_train_step(
        ref_cfg, RefTrainConfig(**kw), teacher_params=teacher,
        masks=member["ref_masks"]))
    ref_state = ref_make_train_state(ref_cfg, member["member"],
                                     RefTrainConfig(**kw))
    state = train_state_from_numpy(to_np(ref_state), device="cpu")
    step = make_train_step(cfg, TrainConfig(**kw), teacher_params=bridge(
        teacher), masks=member["masks"], device="cpu")
    for i in range(5):
        ref_state, want = ref_step(ref_state, ref_make_batch(
            ref_cfg, 8, 48, seed=11, step=i))
        state, got = step(state, make_batch_np(cfg, 8, 48, seed=11, step=i))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert int(state.step) == int(ref_state.step) == 5
    assert_params_match(cfg, state.params, to_np(ref_state.params))
    assert masked_rows(state.params, member["masks"]) == 0.0
    assert masked_rows(bridge(ref_state.params), member["masks"]) == 0.0
    return state


# ----------------------------------------------------------------------
# the family engine
# ----------------------------------------------------------------------

def port_family(cfg, params, base, **extra):
    return gradual_prune(
        cfg, params, ENV, TARGETS,
        lambda step: synthetic_stream(cfg, 8, 48, seed=21, start_step=step),
        calibration_batches(cfg, 8, 48, batch=8), ckpt_dir=str(base),
        tcfg=TrainConfig(**TCFG_KW), device="cpu", **FAMILY_KW, **extra)


def port_family_on_ref_databases(cfg, params, base, ref_run_dir):
    """The port's family with each target's database stage replaced by
    the reference run's output: stopped after each target's db stage, the
    reference's ``db.npz`` put in its place (its sha in the manifest), and
    resumed. Search, stitch and finetune then start from the reference's
    snapshots."""
    run_dir = family_run_dir(cfg, TARGETS, 0, str(base))
    for i, target in enumerate(TARGETS):
        with pytest.raises(FamilyPreempted):
            port_family(cfg, params, base, stop_after=(i, "db"))
        dst = os.path.join(run_dir, f"t{target:g}", "db.npz")
        shutil.copyfile(os.path.join(ref_run_dir, f"t{target:g}", "db.npz"),
                        dst)
        man_path = os.path.join(run_dir, "family.json")
        man = load_json(man_path)
        man["targets"][f"{target:g}"]["db_sha256"] = file_sha256(dst)
        atomic_write_json(man_path, man)
    return port_family(cfg, params, base)


def ref_family(ref_cfg, ref_params, base):
    """The reference's family with the bench's smoke settings; returns its
    run directory and its variants."""
    fam = ref_gradual_prune(
        ref_cfg, ref_params, RefEnv(hw=TPU_V5E, **ENV_KW), TARGETS,
        lambda step: ref_synthetic_stream(ref_cfg, 8, 48, seed=21,
                                          start_step=step),
        ref_calibration_batches(ref_cfg, 8, 48, batch=8),
        tcfg=RefTrainConfig(**TCFG_KW), ckpt_dir=str(base), **FAMILY_KW)
    return ref_family_run_dir(ref_cfg, TARGETS, 0, str(base)), fam


def assert_family_matches(cfg, ref_cfg, want, got, fp16_input=True):
    assert [v.target for v in got] == [v.target for v in want] == TARGETS
    for vw, vg in zip(want, got):
        assert vg.assignment == {k: int(v) for k, v in vw.assignment.items()}
        assert vg.achieved == vw.achieved >= vg.target
        np.testing.assert_allclose(vg.loss_before_ft, vw.loss_before_ft,
                                   rtol=1e-4)
        np.testing.assert_allclose(vg.loss_after_ft, vw.loss_after_ft,
                                   rtol=1e-4)
        assert_params_match(cfg, vg.params, to_np(vw.params),
                            fp16_input=fp16_input)
        assert vg.pruned.num_params() == vw.pruned.num_params()
        assert layer_drop_plan(cfg, vg.assignment) == \
            list(ref_layer_drop_plan(ref_cfg, vw.assignment))


def assert_bench_sizes(key, cfg, fam, dense_params):
    """The members have ``BENCH_db.json``'s sizes and speedups for
    ``key``, and no layer dropped."""
    with open(os.path.join(ROOT, "BENCH_db.json")) as f:
        bench = json.load(f)[key]
    assert bench["targets"] == TARGETS and bench["smoke"]
    assert dense_params == bench["dense_params"]
    for v in fam:
        rec = bench["members"][f"{v.target:g}x"]
        assert v.pruned.num_params() == rec["pruned_params"]
        assert v.achieved == rec["achieved_speedup"]
        assert sum(layer_drop_plan(cfg, v.assignment)) == \
            rec["layers_dropped"] == 0


def _port_stage_on_ref_member(cfg, params, run_dir, n_seq, seq):
    """The reference run's finetuned target-1 params, and the port's
    calibration and database stages on them."""
    member = restore_pytree(params, os.path.join(run_dir, "t1.3",
                                                 "params.npz"))
    calib = calibration_batches(cfg, n_seq, seq, batch=8)
    return member, build_database(cfg, member, collect_hessians(
        cfg, member, calib, device="cpu"), device="cpu")


def assert_db_keeps_the_reference_orders(cfg, params, run_dir, names):
    """The reference run's target-2 database was built on its finetuned
    target-1 params. On those params the port's calibration and database
    stages give the stored removal orders of every attention module (KV
    groups; their Hessians are well conditioned). For each module of
    ``names`` the port's Algorithm 1, started from the reference's fp32
    inverse of the stored Hessian, gives the stored order with snapshots
    at the database tolerance: where the two packages' own stages part on
    a worse-conditioned Hessian, it is the port's fp64 starting inverse
    that parts them, not the steps (tests/test_torch_core.py). Returns
    the port's database."""
    member, db = _port_stage_on_ref_member(cfg, params, run_dir, 8, 48)
    tdir = os.path.join(run_dir, "t1.6")
    with np.load(os.path.join(tdir, "db.npz")) as ref_db, \
            np.load(os.path.join(tdir, "hessians.npz")) as ref_h:
        assert sorted(f"{name}::order" for name in db) == sorted(
            k for k in ref_db.files if k.endswith("::order"))
        for name, mdb in db.items():
            if mdb.mod.kind == "attn":
                np.testing.assert_array_equal(
                    mdb.order, ref_db[f"{name}::order"], err_msg=name)
        for name in names:
            mod = db[name].mod
            lv = tuple(int(x) for x in db[name].levels)
            hinv = jnp.linalg.inv(ref_obs.build_hessian(
                jnp.asarray(ref_h[name])))
            got = prune_structured(
                UNITS[mod.kind].get_matrix(member, mod),
                torch.from_numpy(np.array(hinv)),
                group_size=mod.group_size, n_remove=max(lv), levels=lv)
            np.testing.assert_array_equal(
                got.order.numpy(), ref_db[f"{name}::order"], err_msg=name)
            np.testing.assert_allclose(
                got.snapshots.float().numpy(),
                ref_db[f"{name}::snapshots"].astype(np.float32),
                atol=2e-3, rtol=2e-3, err_msg=name)
    return db


def assert_resume_bit_identical(cfg, params, uninterrupted, base):
    """Kill target 2's finetune after 3 of 4 steps (its last checkpoint
    at step 2), resume, and compare with the uninterrupted run."""
    with pytest.raises(FamilyPreempted):
        port_family(cfg, params, base, stop_after=(1, "finetune", 3))
    resumed = port_family(cfg, params, base)
    with open(os.path.join(family_run_dir(cfg, TARGETS, 0, str(base)),
                           "family.json")) as f:
        man = json.load(f)
    assert [(e["target"], e["stage"]) for e in man["executed"]
            if e["run"] == 2] == [("1.6", "finetune")]
    for vw, vg in zip(uninterrupted, resumed):
        assert vw.assignment == vg.assignment
        assert vw.achieved == vg.achieved
        assert vw.loss_before_ft == vg.loss_before_ft
        assert vw.loss_after_ft == vg.loss_after_ft
        lw, lg = tree_leaves(vw.params), tree_leaves(vg.params)
        assert len(lw) == len(lg) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(lw, lg))
