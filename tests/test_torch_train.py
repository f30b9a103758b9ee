"""The port's training side against the JAX package: the LR schedule,
AdamW and clipping, the distillation losses, the finetuning masks, and
``make_train_step`` started from a JAX ``TrainState`` moved over by the
weight bridge; then the port's own checkpoint manager, trainer (resume,
loss guard, kill and resume bit for bit) and training CLI, on the CPU.

Tolerances (fp32 on both sides; the two frameworks sum in other orders):
the schedule 1e-7 relative (the same fp32 formula; ``cos`` may differ in
the last bit); one AdamW update and the clip 1e-6; the distillation loss
and its metrics 1e-5 relative (the forward's own 1e-5 loss tolerance,
tests/test_torch_model.py); five train steps' metrics 1e-4 relative at
every step (Adam divides by sqrt(v), which amplifies the gradients'
rounding), the final params 1e-5 absolute (five steps of at most
lr = 1e-3 each; on a CPU they differ by about 2e-7); masks and
masked rows exactly.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import GPT2_SMALL as REF_GPT2
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core import database as ref_database
from repro.core.pipeline import masks_from_assignment as ref_masks
from repro.core.structures import PrunableModule as RefPrunableModule
from repro.data.synthetic import make_batch_np as ref_make_batch
from repro.distill.losses import distillation_loss as ref_distillation_loss
from repro.models import model_init as ref_model_init
from repro.models.transformer import forward as ref_forward
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.adamw import clip_by_global_norm as ref_clip
from repro.optim.schedule import make_schedule as ref_make_schedule
from repro.train.train_step import make_train_state as ref_make_train_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CheckpointWriteError,
                                            file_sha256, load_json,
                                            npz_bytes, restore_pytree,
                                            save_pytree)
from repro_torch.configs import ModelConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.core.database import apply_assignment, build_database
from repro_torch.core.hessian import collect_hessians
from repro_torch.core.oneshot import calib_loss_fn
from repro_torch.core.pipeline import masks_from_assignment
from repro_torch.core.structures import registry
from repro_torch.data import (calibration_batches, make_batch_np,
                              synthetic_stream)
from repro_torch.distill.losses import (distillation_loss, logit_kl,
                                        token_distill)
from repro_torch.launch import train as train_cli
from repro_torch.models import forward, model_init
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.optim import (adamw_init, adamw_update,
                               clip_by_global_norm, make_schedule)
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import (StragglerWatchdog, Trainer, TrainState,
                               make_eval_step, make_train_state,
                               make_train_step)

JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
# tests/conftest.py's TINY
REF_TINY = REF_GPT2.replace(
    name="gpt2-tiny", num_layers=2, d_model=64, d_ff=128, num_heads=4,
    num_kv_heads=4, head_dim=16, vocab_size=256, dtype="float32")
REF_BERT = REF_TINY.replace(name="bert-tiny", causal=False)


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
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(ref_cfg).items()
                          if k not in JAX_EXECUTION})


CFG = port_cfg(REF_TINY)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def bridge(ref_tree):
    return params_from_numpy(to_np(ref_tree), device="cpu")


def assert_tree_close(got, want, atol, rtol, what=""):
    want = to_np(want)
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.detach().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=f"{what}{path}")


def assert_tree_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def assert_states_equal(a: TrainState, b: TrainState):
    assert_tree_equal(a.params, b.params)
    assert_tree_equal(a.opt["m"], b.opt["m"])
    assert_tree_equal(a.opt["v"], b.opt["v"])
    assert torch.equal(a.opt["count"], b.opt["count"])
    assert torch.equal(a.step, b.step)


# ----------------------------------------------------------------------
# optimizer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["linear", "cosine", "constant"])
def test_schedule_matches_reference(kind):
    ref = ref_make_schedule(3e-4, 10, 100, kind=kind, min_frac=0.05)
    port = make_schedule(3e-4, 10, 100, kind=kind, min_frac=0.05)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        want = np.float32(ref(step))
        got = port(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-7, atol=0,
                                   err_msg=f"step {step}")


def _random_tree(rng, scale=1.0):
    return {"a": (scale * rng.standard_normal((6, 5))).astype(np.float32),
            "b": {"c": (scale * rng.standard_normal((7,))).astype(np.float32),
                  "d": (scale * rng.standard_normal((3, 2, 4))
                        ).astype(np.float32)}}


def test_adamw_update_and_clip_match_reference():
    rng = np.random.default_rng(0)
    params, grads = _random_tree(rng), _random_tree(rng, 3.0)
    m, v = _random_tree(rng, 0.1), tree_map(np.abs, _random_tree(rng, 0.01))
    ref_state = {"m": m, "v": v, "count": jnp.asarray(3, jnp.int32)}
    port_state = {"m": params_from_numpy(m, "cpu"),
                  "v": params_from_numpy(v, "cpu"),
                  "count": torch.tensor(3, dtype=torch.int32)}

    want_g, want_norm = ref_clip(grads, 1.0)
    got_g, got_norm = clip_by_global_norm(params_from_numpy(grads, "cpu"),
                                          1.0)
    np.testing.assert_allclose(float(got_norm), float(want_norm), rtol=1e-6)
    assert_tree_close(got_g, want_g, atol=1e-6, rtol=1e-6, what="clip")

    lr = np.float32(2e-3)
    want_p, want_opt = ref_adamw_update(want_g, ref_state, params, lr=lr,
                                        weight_decay=0.03)
    got_p, got_opt = adamw_update(got_g, port_state,
                                  params_from_numpy(params, "cpu"),
                                  lr=torch.tensor(lr), weight_decay=0.03)
    assert_tree_close(got_p, want_p, atol=1e-6, rtol=1e-6, what="params")
    assert_tree_close(got_opt["m"], want_opt["m"], atol=1e-6, rtol=1e-6)
    assert_tree_close(got_opt["v"], want_opt["v"], atol=1e-6, rtol=1e-6)
    assert int(got_opt["count"]) == int(want_opt["count"]) == 4
    # the update is a function: its inputs are left as they were
    assert np.array_equal(port_state["m"]["a"].numpy(), m["a"])


def test_adamw_init_is_the_references_dict():
    p = params_from_numpy(_random_tree(np.random.default_rng(1)), "cpu")
    opt = adamw_init(p)
    assert set(opt) == {"m", "v", "count"}
    assert opt["count"].dtype == torch.int32 and int(opt["count"]) == 0
    assert all(x.dtype == torch.float32 and not x.any()
               for x in tree_leaves(opt["m"]) + tree_leaves(opt["v"]))


# ----------------------------------------------------------------------
# distillation
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_pair():
    """Reference student (key 0) and teacher (key 1) of the tiny GPT-2."""
    return (ref_model_init(REF_TINY, jax.random.key(0))[0],
            ref_model_init(REF_TINY, jax.random.key(1))[0])


def test_forward_hiddens_match_reference(ref_pair):
    batch = make_batch_np(CFG, 2, 24, seed=5)
    want = ref_forward(REF_TINY, ref_pair[0],
                       jnp.asarray(batch["tokens"].numpy()),
                       collect_hiddens=True)["hiddens"]
    got = forward(CFG, bridge(ref_pair[0]), batch["tokens"],
                  collect_hiddens=True)["hiddens"]
    assert got.shape == (CFG.num_layers, 2, 24, CFG.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("case", ["causal", "causal-masked", "bert",
                                  "bert-unmasked"])
def test_distillation_loss_matches_reference(case, ref_pair):
    ref_cfg = REF_BERT if case.startswith("bert") else REF_TINY
    cfg = port_cfg(ref_cfg)
    ref_s = ref_model_init(ref_cfg, jax.random.key(0))[0]
    ref_t = ref_model_init(ref_cfg, jax.random.key(1))[0]
    ref_batch = ref_make_batch(ref_cfg, 4, 24, seed=7)
    batch = make_batch_np(cfg, 4, 24, seed=7)
    if case == "causal-masked":  # padding: the last rows' tails
        pad = np.ones((4, 24), bool)
        pad[2:, 15:] = False
        ref_batch["mask"], batch["mask"] = jnp.asarray(pad), \
            torch.from_numpy(pad)
    if case == "bert-unmasked":
        del ref_batch["mask"], batch["mask"]
    kw = dict(l_task=1.0, l_logit=1.0, l_token=0.5)
    want_total, want = ref_distillation_loss(ref_cfg, ref_s, ref_t,
                                             ref_batch, **kw)
    got_total, got = distillation_loss(cfg, bridge(ref_s), bridge(ref_t),
                                       batch, **kw)
    assert set(got) == set(want) == {"loss", "task_loss", "logit_kl",
                                     "token_l2"}
    np.testing.assert_allclose(float(got_total), float(want_total),
                               rtol=1e-5)
    for k in want:
        assert float(want[k]) > 0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_inactive_distillation_terms_are_zero(ref_pair):
    batch = make_batch_np(CFG, 2, 16, seed=1)
    total, m = distillation_loss(CFG, bridge(ref_pair[0]),
                                 bridge(ref_pair[1]), batch)
    assert float(m["logit_kl"]) == 0.0 and float(m["token_l2"]) == 0.0
    assert float(total) == float(m["task_loss"]) == float(m["loss"])


def test_self_distillation_is_zero(ref_pair):
    p = bridge(ref_pair[0])
    batch = make_batch_np(CFG, 2, 32, seed=5)
    _, m = distillation_loss(CFG, p, p, batch, l_task=0.0, l_logit=1.0,
                             l_token=1.0)
    assert float(m["logit_kl"]) < 1e-5
    assert float(m["token_l2"]) < 1e-8


def test_token_loss_masks_padding():
    h_s = torch.ones((2, 1, 4, 8))
    h_t = torch.zeros((2, 1, 4, 8))
    mask = torch.tensor([[1, 1, 0, 0]])
    assert np.isclose(float(token_distill(h_s, h_t)), 8.0)
    assert np.isclose(float(token_distill(h_s, h_t, mask)), 8.0)
    # a mask selecting only zero-distance tokens gives 0
    h_s2 = h_s.clone()
    h_s2[:, :, :2] = 0.0
    assert float(token_distill(h_s2, h_t, mask)) == 0.0


def test_logit_kl_nonnegative_and_directional():
    g = torch.Generator().manual_seed(0)
    t = torch.randn((2, 4, 16), generator=g)
    s = torch.randn((2, 4, 16), generator=g)
    assert float(logit_kl(s, t)) > 0
    assert float(logit_kl(t, t)) < 1e-6
    # KL(teacher || student): the teacher's probabilities weigh the terms
    tp = torch.softmax(t, -1)
    want = (tp * (torch.log_softmax(t, -1) - torch.log_softmax(s, -1))
            ).sum(-1).mean()
    assert float(logit_kl(s, t)) == pytest.approx(float(want), rel=1e-6)
    assert float(logit_kl(s, t)) != pytest.approx(float(logit_kl(t, s)))


# ----------------------------------------------------------------------
# masks and the train step against the reference
# ----------------------------------------------------------------------

ASSIGNMENT = {"L0.attn": 2, "L0.ffn": 96, "L1.attn": 1, "L1.ffn": 50}


@pytest.fixture(scope="module")
def ref_member(ref_pair):
    """The port's database of the tiny student, the same database as
    reference ModuleDBs (same arrays), and the reference's stitched member
    and masks from it."""
    student = ref_pair[0]
    p = bridge(student)
    calib = calibration_batches(CFG, 16, 64, batch=8)
    port_db = build_database(CFG, p, collect_hessians(CFG, p, calib,
                                                      device="cpu"),
                             device="cpu")
    db = {name: ref_database.ModuleDB(
        mod=RefPrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for name, m in port_db.items()}
    member = ref_database.apply_assignment(REF_TINY, student, db, ASSIGNMENT)
    return {"member": member, "port_db": port_db,
            "masks": ref_masks(REF_TINY, member, db, ASSIGNMENT)}


def _masked_rows_zero(params, db, assignment):
    """Every removed structure's out-side rows are exactly 0."""
    for name, removed in assignment.items():
        mdb = db[name]
        gs = mdb.mod.group_size
        grp, leaf = ("attn", "wo") if mdb.mod.kind == "attn" else ("ffn",
                                                                   "wd")
        w = params["layers"][grp][leaf][mdb.mod.layer]
        for g in mdb.order[:removed]:
            if bool(w[g * gs:(g + 1) * gs].any()):
                return False
    return True


def test_masks_from_assignment_matches_reference(ref_member):
    got = masks_from_assignment(CFG, bridge(ref_member["member"]),
                                ref_member["port_db"], ASSIGNMENT)
    want = to_np(ref_member["masks"])
    assert len(tree_leaves(got)) == len(jax.tree.leaves(want))
    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for p in path:
            node = node[p.key]
        assert node.dtype == torch.float32
        assert np.array_equal(node.numpy(), w), path
    assert float(got["layers"]["ffn"]["wd"][0].sum()) == (128 - 96) * 64


def test_train_steps_match_reference_from_a_jax_state(ref_pair, ref_member):
    """Five steps with a teacher, masks and two microbatches, from the
    same JAX TrainState on both sides."""
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5,
              microbatches=2, distill_logit=1.0, distill_token=0.5)
    ref_tcfg, tcfg = RefTrainConfig(**kw), TrainConfig(**kw)
    teacher = ref_pair[1]
    ref_step = jax.jit(ref_make_train_step(REF_TINY, ref_tcfg,
                                           teacher_params=teacher,
                                           masks=ref_member["masks"]))
    ref_state = ref_make_train_state(REF_TINY, ref_member["member"],
                                     ref_tcfg)
    state = train_state_from_numpy(to_np(ref_state), device="cpu")
    step = make_train_step(CFG, tcfg, teacher_params=bridge(teacher),
                           masks=bridge(ref_member["masks"]), device="cpu")
    for i in range(5):
        batch = make_batch_np(CFG, 8, 32, seed=11, step=i)
        ref_state, want = ref_step(ref_state, ref_make_batch(
            REF_TINY, 8, 32, seed=11, step=i))
        state, got = step(state, batch)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert int(state.step) == int(ref_state.step) == 5
    assert int(state.opt["count"]) == 5
    assert_tree_close(state.params, ref_state.params, atol=1e-5, rtol=0)
    assert _masked_rows_zero(state.params, ref_member["port_db"], ASSIGNMENT)
    assert _masked_rows_zero(bridge(ref_state.params),
                             ref_member["port_db"], ASSIGNMENT)


def test_train_state_crosses_over_from_numpy(ref_pair):
    ref_state = ref_make_train_state(REF_TINY, ref_pair[0], RefTrainConfig())
    state = train_state_from_numpy(to_np(ref_state), device="cpu")
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    assert_tree_close(state.params, ref_state.params, atol=0, rtol=0)
    assert_tree_close(state.opt["m"], ref_state.opt["m"], atol=0, rtol=0)
    assert state.ef_err is None


def test_int8_ef_raises_on_one_device():
    tcfg = TrainConfig(grad_compression="int8_ef")
    with pytest.raises(ValueError, match="int8_ef"):
        make_train_step(CFG, tcfg, device="cpu")
    with pytest.raises(ValueError, match="int8_ef"):
        make_train_state(CFG, model_init(CFG, device="cpu"), tcfg)


def test_eval_step_is_the_loss_without_grad(ref_pair):
    p = bridge(ref_pair[0])
    batch = make_batch_np(CFG, 2, 16, seed=3)
    loss = make_eval_step(CFG)(p, batch)
    assert not loss.requires_grad
    assert float(loss) == float(distillation_loss(CFG, p, None, batch)[0])


def test_trainer_refuses_a_mesh(tmp_path):
    """A mesh without the logical axis specs raises the reference's
    ValueError; a "model" axis of more than one rank (tensor
    parallelism, ROADMAP Queue 1 item 6d) raises NotImplementedError.
    The mesh trainer itself runs in tests/test_torch_mesh_train.py."""
    from repro_torch.distributed import Mesh
    from repro_torch.models import model_specs
    with pytest.raises(ValueError, match="specs"):
        Trainer(CFG, TrainConfig(), ckpt_dir=str(tmp_path),
                mesh=Mesh((2,), ("data",)), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6d"):
        Trainer(CFG, TrainConfig(), ckpt_dir=str(tmp_path),
                mesh=Mesh((2, 2), ("data", "model")),
                specs=model_specs(CFG), device="cpu")


# ----------------------------------------------------------------------
# the port's trainer on a pruned member of its own trained model
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def member():
    """A tiny GPT-2 trained by the port, its database, and a 2-of-4-heads
    / 96-of-128-rows member with its masks (the reference's
    test_distillation_improves_student_recovery setup)."""
    params = model_init(CFG, device="cpu")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=10, total_steps=120)
    step = make_train_step(CFG, tcfg, device="cpu")
    state = make_train_state(CFG, params, tcfg)
    data = synthetic_stream(CFG, 16, 64, seed=7)
    losses = []
    for _ in range(120):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, "tiny model failed to train"
    teacher = state.params
    calib = calibration_batches(CFG, 16, 64, batch=8)
    db = build_database(CFG, teacher,
                        collect_hessians(CFG, teacher, calib, device="cpu"),
                        device="cpu")
    assignment = {m.name: (2 if m.kind == "attn" else 96)
                  for m in registry(CFG)}
    student0 = apply_assignment(CFG, teacher, db, assignment)
    return {"teacher": teacher, "calib": calib, "db": db,
            "assignment": assignment, "student0": student0,
            "masks": masks_from_assignment(CFG, student0, db, assignment)}


DISTILL = dict(learning_rate=1e-3, warmup_steps=2, distill_logit=1.0,
               distill_token=0.5)


def _trainer(member, tmp, tcfg, **kw):
    return Trainer(CFG, tcfg, ckpt_dir=str(tmp), device="cpu",
                   teacher_params=member["teacher"], masks=member["masks"],
                   **kw)


def test_distillation_improves_student_recovery(member):
    """Finetuning the pruned student with token+logit distillation
    recovers at least as well as task loss alone (paper Appendix B)."""
    loss_eval = calib_loss_fn(CFG, member["calib"][:1], device="cpu")

    def finetune(l_logit, l_token, steps=40):
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2,
                           total_steps=steps, distill_logit=l_logit,
                           distill_token=l_token)
        step = make_train_step(CFG, tcfg, teacher_params=member["teacher"],
                               masks=member["masks"], device="cpu")
        state = make_train_state(CFG, member["student0"], tcfg)
        data = synthetic_stream(CFG, 16, 64, seed=99)
        for _ in range(steps):
            state, _ = step(state, next(data))
        return state.params

    p_task, p_dist = finetune(0.0, 0.0), finetune(1.0, 0.5)
    l_task, l_dist = loss_eval(p_task), loss_eval(p_dist)
    assert l_dist <= l_task + 0.3, (l_dist, l_task)
    wd = p_dist["layers"]["ffn"]["wd"][0]
    kept = member["db"]["L0.ffn"].kept_structures(96)
    gone = np.setdiff1d(np.arange(CFG.d_ff), kept)
    assert float(wd[gone].abs().max()) == 0.0  # pruned rows stayed zero


def test_trainer_logs_distill_metrics(member, tmp_path):
    tcfg = TrainConfig(total_steps=4, **DISTILL)
    tr = _trainer(member, tmp_path, tcfg, ckpt_every=100, log_every=1)
    tr.fit(tr.init_or_restore(member["student0"]),
           synthetic_stream(CFG, 8, 32, seed=5), steps=4)
    tr.ckpt.close()
    assert [m["step"] for m in tr.metrics_log] == [1, 2, 3, 4]
    for m in tr.metrics_log:
        assert m["logit_kl"] > 0.0 and m["token_l2"] > 0.0
        assert m["task_loss"] > 0.0
        assert m["loss"] > m["task_loss"] * tcfg.distill_task
        assert {"grad_norm", "lr", "step_time"} <= set(m)


def _masks_with(masks, change):
    """A copy of a mask tree with one leaf removed or one leaf added."""
    out = tree_map(lambda m: m, masks)
    if change == "missing":
        del out["layers"]["attn"]["wo"]
    else:
        out["layers"]["attn"]["extra"] = torch.ones(1)
    return out


@pytest.mark.parametrize("change", ["missing", "extra"])
def test_a_mask_tree_without_the_params_keys_raises(member, tmp_path,
                                                    change):
    """A mask tree whose key paths are not the params' raises, as the
    reference's ``jax.tree.map(..., new_params, masks)`` does, in the
    train step and through the trainer; the step pairs mask and weight
    by their position in ``tree_leaves``, so without the check a missing
    leaf would mask the wrong weight and leave another unmasked."""
    masks = _masks_with(member["masks"], change)
    tcfg = TrainConfig(total_steps=2, **DISTILL)
    step = make_train_step(CFG, tcfg, masks=masks, device="cpu")
    state = make_train_state(CFG, member["student0"], tcfg)
    batch = next(synthetic_stream(CFG, 8, 32, seed=5))
    with pytest.raises(ValueError, match="attn/(wo|extra)"):
        step(state, batch)
    tr = Trainer(CFG, tcfg, ckpt_dir=str(tmp_path), device="cpu",
                 masks=masks, ckpt_every=100)
    with pytest.raises(ValueError, match="params' structure"):
        tr.fit(tr.init_or_restore(member["student0"]),
               synthetic_stream(CFG, 8, 32, seed=5), steps=2)
    tr.ckpt.close()
    # the same tree with the params' keys trains
    state, _ = make_train_step(CFG, tcfg, masks=member["masks"],
                               device="cpu")(state, batch)
    assert int(state.step) == 1


def test_trainer_resume_after_preemption(tmp_path):
    """The kill point is a fixed step count (stop_after), and fit()'s
    final wait() joins the async queue, so the step-10 checkpoint is on
    disk when fit returns."""
    params = model_init(CFG, device="cpu")
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=40, warmup_steps=2)
    t1 = Trainer(CFG, tcfg, ckpt_dir=str(tmp_path), ckpt_every=5,
                 device="cpu")
    state = t1.fit(t1.init_or_restore(params),
                   synthetic_stream(CFG, 8, 32, seed=3), steps=40,
                   stop_after=12)
    assert int(state.step) == 12
    killed_at = t1.ckpt.latest_step()
    assert killed_at == 10  # saves at 5 and 10; wait() makes 10 visible
    t1.ckpt.close()

    t2 = Trainer(CFG, tcfg, ckpt_dir=str(tmp_path), ckpt_every=5,
                 device="cpu")
    state2 = t2.init_or_restore(params)
    assert int(state2.step) == 10
    state2 = t2.fit(state2, synthetic_stream(CFG, 8, 32, seed=3,
                                             start_step=killed_at), steps=25)
    assert int(state2.step) == 25
    t2.ckpt.close()


@pytest.mark.parametrize("save_last", [True, False])
def test_fit_writes_the_last_checkpoint_only_if_asked(tmp_path, save_last):
    """``save_last=False`` leaves out the checkpoint at the fit's last
    step and keeps those at ``ckpt_every`` multiples before it, with the
    same final state."""
    params = model_init(CFG, device="cpu")
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=6, warmup_steps=2)
    tr = Trainer(CFG, tcfg, ckpt_dir=str(tmp_path), ckpt_every=2,
                 device="cpu")
    state = tr.fit(tr.init_or_restore(params),
                   synthetic_stream(CFG, 8, 32, seed=3), steps=5,
                   save_last=save_last)
    tr.ckpt.close()
    assert int(state.step) == 5
    steps = [c["step"] for c in
             load_json(os.path.join(str(tmp_path), "manifest.json"))
             ["checkpoints"]]
    assert steps == ([2, 4, 5] if save_last else [2, 4])


def test_kill_and_resume_is_bit_identical(member, tmp_path):
    """A run stopped at 14 and resumed from its step-8 checkpoint by a new
    trainer ends with the bits of an uninterrupted run: params, m, v,
    count and step; the masked rows stay exactly 0, in the restored
    checkpoint too."""
    tcfg = TrainConfig(total_steps=16, microbatches=2, **DISTILL)
    stream = dict(batch=8, seq=32, seed=0)

    ta = _trainer(member, tmp_path / "a", tcfg, ckpt_every=8)
    a = ta.fit(ta.init_or_restore(member["student0"]),
               synthetic_stream(CFG, **stream), steps=16)
    ta.ckpt.close()

    tb = _trainer(member, tmp_path / "b", tcfg, ckpt_every=8)
    b = tb.fit(tb.init_or_restore(member["student0"]),
               synthetic_stream(CFG, **stream), steps=16, stop_after=14)
    assert int(b.step) == 14 and tb.ckpt.latest_step() == 8
    tb.ckpt.close()
    tc = _trainer(member, tmp_path / "b", tcfg, ckpt_every=8)
    c = tc.init_or_restore(member["student0"])
    assert int(c.step) == 8
    assert _masked_rows_zero(c.params, member["db"], member["assignment"])
    c = tc.fit(c, synthetic_stream(CFG, start_step=8, **stream), steps=16)
    tc.ckpt.close()
    assert_states_equal(a, c)
    assert _masked_rows_zero(a.params, member["db"], member["assignment"])


def _nan_batch():
    """A causal batch whose loss mask is NaN: every loss it gives is."""
    b = make_batch_np(CFG, 8, 32, seed=0, step=99)
    b["mask"] = torch.full((8, 32), float("nan"))
    return b


def test_guard_skips_a_nan_batch_and_leaves_the_state_untouched(member,
                                                                tmp_path):
    tcfg = TrainConfig(total_steps=3, **DISTILL)
    good = [make_batch_np(CFG, 8, 32, seed=0, step=i) for i in range(3)]

    t1 = _trainer(member, tmp_path / "g", tcfg, ckpt_every=100)
    s0 = t1.init_or_restore(member["student0"])
    before = t1.fit(s0, iter(good[:1]), steps=1)
    after = t1.fit(before, iter([_nan_batch()] + good[1:]), steps=3)
    t1.ckpt.close()
    assert t1.guard == {"skipped": [2], "reloads": 0}
    assert int(after.step) == 3

    # the bad step is skipped: the result equals a run without it
    t2 = _trainer(member, tmp_path / "c", tcfg, ckpt_every=100)
    clean = t2.fit(t2.init_or_restore(member["student0"]), iter(good),
                   steps=3)
    t2.ckpt.close()
    assert_states_equal(after, clean)

    # and the state the bad step was given is left bit for bit as it was
    copy = TrainState(params=tree_map(torch.clone, before.params),
                      opt=tree_map(torch.clone, before.opt),
                      step=before.step.clone())
    _, metrics = t1.step_fn(before, _nan_batch())
    assert not np.isfinite(float(metrics["loss"]))
    assert_states_equal(before, copy)


def test_guard_reloads_then_raises_without_progress(member, tmp_path):
    tcfg = TrainConfig(total_steps=10, **DISTILL)
    tr = _trainer(member, tmp_path, tcfg, ckpt_every=2, max_bad_steps=2)
    state = tr.fit(tr.init_or_restore(member["student0"]),
                   synthetic_stream(CFG, 8, 32, seed=1), steps=3)
    assert tr.ckpt.latest_step() == 3

    def bad():
        while True:
            yield _nan_batch()

    with pytest.raises(RuntimeError, match="cannot progress past step 3"):
        tr.fit(state, bad(), steps=10)
    assert tr.guard["reloads"] == 1 and tr.guard["skipped"] == [4] * 4
    tr.ckpt.close()


def test_guard_skips_a_loss_spike(tmp_path):
    """With ``spike_factor`` a loss above that many times the running
    median (after 5 good steps) is skipped like a non-finite one; a custom
    ``step_fn`` stands in for the model."""
    losses = iter([2.0, 2.1, 1.9, 2.0, 2.2, 9.0, 2.0])

    def step_fn(state, batch):
        return state._replace(step=state.step + 1), \
            {"loss": torch.tensor(next(losses))}

    tr = Trainer(CFG, TrainConfig(), ckpt_dir=str(tmp_path), device="cpu",
                 step_fn=step_fn, spike_factor=3.0, ckpt_every=100,
                 log_every=1)
    state = tr.fit(tr.init_or_restore(model_init(CFG, device="cpu")),
                   iter(range(100)), steps=6)
    tr.ckpt.close()
    assert int(state.step) == 6 and tr.guard["skipped"] == [6]
    assert [m["loss"] for m in tr.metrics_log] == pytest.approx(
        [2.0, 2.1, 1.9, 2.0, 2.2, 2.0])


def test_train_cli_runs_the_smoke_config_on_the_cpu(tmp_path, capsys):
    rc = train_cli.main(["--arch", "gpt2-small", "--smoke", "--device",
                         "cpu", "--steps", "3", "--batch", "2", "--seq",
                         "16", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "done at step 3" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    # a second run resumes from the checkpoint and has nothing left to do
    assert train_cli.main(["--arch", "gpt2-small", "--smoke", "--device",
                           "cpu", "--steps", "3", "--batch", "2", "--seq",
                           "16", "--ckpt-dir", str(tmp_path)]) == 0
    assert "resumed from step 3" in capsys.readouterr().out


def test_train_cli_refuses_int8_ef_on_one_device(tmp_path):
    with pytest.raises(ValueError, match="int8_ef"):
        train_cli.main(["--arch", "gpt2-small", "--smoke", "--device", "cpu",
                        "--steps", "1", "--ckpt-dir", str(tmp_path),
                        "--grad-compression", "int8_ef"])


# ----------------------------------------------------------------------
# checkpoints (the port's counterparts of tests/test_checkpoint.py)
# ----------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32)},
            "d": torch.zeros((), dtype=torch.float32),
            "e": torch.linspace(-3, 3, 5).to(torch.bfloat16)}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    p = str(tmp_path / "ck.npz")
    digest = save_pytree(t, p)
    assert digest == file_sha256(p)
    assert sorted(np.load(p).files) == ["a", "b/c", "d", "e"]
    r = restore_pytree(tree_map(torch.zeros_like, t), p)
    assert_tree_equal(t, r)


def test_train_state_roundtrip(tmp_path):
    params = model_init(CFG, device="cpu")
    state = make_train_state(CFG, params, TrainConfig())
    state = state._replace(step=state.step + 7)
    p = str(tmp_path / "s.npz")
    save_pytree(state, p)
    assert "params/embed/table" in np.load(p).files
    r = restore_pytree(make_train_state(CFG, params, TrainConfig()), p)
    assert isinstance(r, TrainState) and r.ef_err is None
    assert_states_equal(state, r)


def test_manager_retention_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in [10, 20, 30]:
        m.save(s, _tree())
    assert m.latest_step() == 30
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(files) == 2  # retention dropped step 10


def test_corruption_detected(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    m.save(1, _tree())
    m.save(2, _tree())
    with open(tmp_path / "step_00000002.npz", "r+b") as f:
        f.seek(10)
        f.write(b"\x00" * 32)
    assert m.latest_step() == 1  # falls back to the last valid one
    r = m.restore(_tree())
    assert_tree_equal(r, _tree())


def test_save_copies_to_the_host_before_it_returns(tmp_path):
    """An in-place write after ``save`` must not reach the queued file."""
    t = _tree()
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(5, t)
    t["a"].add_(100.0)
    m.wait()
    assert_tree_equal(m.restore(_tree()), _tree())
    m.close()


def test_async_write_failure_surfaces_at_wait(tmp_path, monkeypatch):
    import repro_torch.checkpoint.manager as M
    real = M.atomic_save_npz
    fail = {"on": True}

    def _maybe_fail(path, arrays):
        if fail["on"]:
            raise OSError(28, "No space left on device", path)
        return real(path, arrays)

    monkeypatch.setattr(M, "atomic_save_npz", _maybe_fail)
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(1, _tree())
    with pytest.raises(CheckpointWriteError) as ei:
        m.wait()
    assert any(isinstance(e, OSError) for e in ei.value.errors)
    m.wait()  # errors drained on raise: the manager is reusable
    fail["on"] = False
    m.save(2, _tree())
    m.wait()
    assert m.latest_step() == 2
    m.close()


def test_async_write_failure_surfaces_at_close(tmp_path, monkeypatch):
    import repro_torch.checkpoint.manager as M

    def _fail(*a, **k):
        raise OSError(5, "I/O error")

    monkeypatch.setattr(M, "atomic_save_npz", _fail)
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(7, _tree())
    with pytest.raises(CheckpointWriteError):
        m.close()


def test_streamed_blob_roundtrip_sha_and_backpressure(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3, max_queue=1)
    shas = {}
    for i in range(8):
        data, sha = npz_bytes({"x": np.full((64, 64), float(i), np.float32)})
        path = os.path.join(str(tmp_path), f"blob{i}.npz")
        m.submit_blob(path, data)
        shas[path] = sha
    m.wait()
    for path, sha in shas.items():
        assert file_sha256(path) == sha
    got = np.load(os.path.join(str(tmp_path), "blob3.npz"))
    assert np.array_equal(got["x"], np.full((64, 64), 3.0, np.float32))
    m.close()


def test_streamed_blob_failure_surfaces_at_wait(tmp_path, monkeypatch):
    import repro_torch.checkpoint.manager as M
    real = M.atomic_write_bytes
    fail = {"on": True}

    def _maybe_fail(path, data):
        if fail["on"]:
            raise OSError(28, "No space left on device", path)
        return real(path, data)

    monkeypatch.setattr(M, "atomic_write_bytes", _maybe_fail)
    m = CheckpointManager(str(tmp_path), keep=3)
    data, _ = npz_bytes({"x": np.ones((4,), np.float32)})
    path = os.path.join(str(tmp_path), "blob.npz")
    m.submit_blob(path, data)
    with pytest.raises(CheckpointWriteError) as ei:
        m.wait()
    assert any(isinstance(e, OSError) for e in ei.value.errors)
    m.wait()
    fail["on"] = False
    m.submit_blob(path, data)
    m.wait()
    assert os.path.exists(path)
    m.close()


def test_transient_write_error_heals(tmp_path, monkeypatch):
    import repro_torch.checkpoint.manager as M
    real = M.atomic_save_npz
    calls = {"n": 0}

    def _flaky(path, arrays):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(11, "Resource temporarily unavailable")
        return real(path, arrays)

    monkeypatch.setattr(M, "atomic_save_npz", _flaky)
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save(3, _tree())
    m.wait()  # must not raise
    assert calls["n"] == 2
    assert m.latest_step() == 3
    m.close()


def test_straggler_watchdog():
    wd = StragglerWatchdog(factor=3.0)
    for i in range(20):
        wd.observe(i, 0.1)
    assert not wd.flagged
    wd.observe(20, 0.55)          # 5.5x median -> straggler
    assert wd.flagged == [20]
    wd.observe(21, 0.12)
    assert wd.flagged == [20]
