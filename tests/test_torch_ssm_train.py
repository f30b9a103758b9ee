"""Training through the port's SSD pass, on the CPU, against the JAX
package: the intra-chunk pass's plain backward (the formula of the
backward kernel, ``csrc/ssd_scan_bwd.cu``), the chunked scan's gradients,
train steps of the smoke Mamba-2 and gradual ZipLM on it
(``gradual_prune``), killed and resumed.

The reference has no backward kernel: it differentiates its jnp twin
(``repro.models.ssm.ssd_chunked``). The port's ``SsdIntraChunk`` takes the
gradient with the backward kernel on the card and with
``ssd_intra_chunk_backward_plain`` on the CPU, so these tests run the
kernel's formula end to end.

Tolerances: the plain backward against autograd of the plain forward 1e-5
of each output's scale (the same fp32 function, summed in another order);
the chunked scan's gradients against ``jax.vjp`` 2e-3 (atol = rtol, the
reference's SSD tolerance, tests/test_kernels.py); train steps the
trainer's parity tolerances (tests/test_torch_train.py: each metric 1e-4
relative, the final params 1e-5 absolute); the family as
tests/test_torch_family.py holds it (assignments, achieved speedups,
shrunk sizes and dropped layers equal, losses 1e-4 relative, params 1e-5
absolute), except that a database snapshot is stored in fp16: where the
two packages' OBS updates round one stitched weight to neighbouring fp16
values, that weight differs by one fp16 step (of its own magnitude) on
top of the 1e-5. Within the port a resumed run equals an uninterrupted
one bit for bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.core.pipeline import family_run_dir as ref_family_run_dir
from repro.core.pipeline import gradual_prune as ref_gradual_prune
from repro.core.shrink import layer_drop_plan as ref_layer_drop_plan
from repro.data import calibration_batches as ref_calibration_batches
from repro.data import synthetic_stream as ref_synthetic_stream
from repro.data.synthetic import make_batch_np as ref_make_batch
from repro.models import model_init as ref_model_init
from repro.models import ssm as ref_ssm
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro.train.train_step import make_train_state as ref_make_train_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.checkpoint.manager import restore_pytree
from repro_torch.configs import ModelConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.core.database import build_database
from repro_torch.core.hessian import collect_hessians
from repro_torch.core.pipeline import (FamilyPreempted, family_run_dir,
                                       gradual_prune)
from repro_torch.core.shrink import layer_drop_plan
from repro_torch.data import (calibration_batches, make_batch_np,
                              synthetic_stream)
from repro_torch.kernels import (reset_launch_counts, ssd_intra_chunk,
                                 ssd_intra_chunk_backward,
                                 ssd_intra_chunk_backward_plain,
                                 ssd_intra_chunk_plain)
from repro_torch.kernels.ssd_scan import intra_chunk_inputs, ssd_chunked
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv
from repro_torch.train import make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
REF_SSM = smoke_config("mamba2-2.7b").replace(dtype="float32")
CFG = ModelConfig(**{k: v for k, v in dataclasses.asdict(REF_SSM).items()
                     if k not in JAX_EXECUTION})
# b, s, h, p, n, chunk: the reference's SSD_CASES (tests/test_kernels.py;
# s = 50 with chunk 16 is ragged)
SSD_CASES = [(2, 64, 4, 32, 16, 32), (1, 96, 8, 16, 8, 32),
             (2, 50, 2, 64, 32, 16), (1, 128, 6, 32, 16, 64)]
SSD_TOL = 2e-3
# benchmarks/run.py _gradual_family_arch in smoke mode, on
# bench_gradual_family_ssm's config and targets, priced on the TPU table
# (benchmarks/run.py ENV) copied number for number into the port's spec
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
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ssd_inputs(b, s, h, p, n, seed):
    """x, dt (softplus'ed), A, B, C and a state (b, h, p, n), numpy fp32
    drawn from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    A = -np.exp(rng.standard_normal(h) * 0.3)
    B = rng.standard_normal((b, s, n)) * 0.5
    C = rng.standard_normal((b, s, n)) * 0.5
    init = rng.standard_normal((b, h, p, n)) * 0.1
    return [a.astype(np.float32) for a in (x, dt, A, B, C, init)]


# ----------------------------------------------------------------------
# the intra-chunk pass's backward and the chunked scan's gradients
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_backward_plain_matches_autograd_of_the_plain_pass(case):
    b, s, h, p, n, chunk = case
    x, dt, A, B, C, _ = (torch.from_numpy(a)
                         for a in _ssd_inputs(b, s, h, p, n, 0))
    ins = [t.requires_grad_(True)
           for t in intra_chunk_inputs(x, dt, A, B, C, chunk)]
    y, st = ssd_intra_chunk_plain(*ins)
    rng = np.random.default_rng(1)
    dy, dst = (torch.from_numpy(rng.standard_normal(t.shape)
                                .astype(np.float32)) for t in (y, st))
    want = torch.autograd.grad((y * dy).sum() + (st * dst).sum(), ins)
    reset_launch_counts()
    got = ssd_intra_chunk_backward(*[t.detach() for t in ins], dy, dst)
    assert ssd_intra_chunk_backward.launches == 0
    for name, g, w in zip(("dxdt", "ddacs", "dB", "dC"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)
    # the autograd Function on the CPU is the plain pass and this formula
    y2, st2 = ssd_intra_chunk(*ins)
    assert torch.equal(y2, y) and torch.equal(st2, st)
    for g, w in zip(torch.autograd.grad((y2 * dy).sum() + (st2 * dst).sum(),
                                        ins), got):
        assert torch.equal(g, w)


def test_backward_takes_an_unused_output_as_zeros():
    """A loss of y_diag alone hands the Function no cotangent for the
    states; that is the gradient with zero state cotangents."""
    x, dt, A, B, C, _ = (torch.from_numpy(a)
                         for a in _ssd_inputs(1, 64, 2, 16, 8, 3))
    ins = [t.requires_grad_(True)
           for t in intra_chunk_inputs(x, dt, A, B, C, 32)]
    y, st = ssd_intra_chunk(*ins)
    got = torch.autograd.grad(y.square().sum(), ins)
    want = ssd_intra_chunk_backward_plain(
        *[t.detach() for t in ins], 2 * y.detach(), torch.zeros_like(st))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", SSD_CASES, ids=[str(c) for c in SSD_CASES])
def test_ssd_chunked_gradients_match_the_reference_vjp(case):
    """The port's chunked scan (its intra-chunk pass through
    ``SsdIntraChunk``) against ``jax.vjp`` of the reference's model twin,
    in x, dt, A, B, C and the initial state, on numpy-seeded inputs and
    cotangents for both outputs."""
    b, s, h, p, n, chunk = case
    arrays = _ssd_inputs(b, s, h, p, n, 7)
    rng = np.random.default_rng(8)
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gst = rng.standard_normal((b, h, p, n)).astype(np.float32)

    def ref_fn(x, dt, A, B, C, init):
        return ref_ssm.ssd_chunked(x, dt, A, B, C, chunk, initial_state=init)

    want = jax.jit(lambda *a: jax.vjp(ref_fn, *a)[1](
        (jnp.asarray(gy), jnp.asarray(gst))))(*map(jnp.asarray, arrays))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, st = ssd_chunked(*ins[:5], chunk, initial_state=ins[5])
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gst)).sum(),
        ins)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "initial_state"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SSD_TOL,
                                   rtol=SSD_TOL, err_msg=name)


# ----------------------------------------------------------------------
# train steps
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_params():
    return ref_model_init(REF_SSM, jax.random.key(0))[0]


@pytest.fixture(scope="module")
def params(ref_params):
    return params_from_numpy(jax.tree.map(np.asarray, ref_params),
                             device="cpu")


def test_train_steps_match_reference_from_a_jax_state(ref_params):
    """Five distillation steps of the smoke Mamba-2 (a teacher of another
    seed, 2 microbatches, 48 tokens: a chunk of 32 and a padded one) from
    the same JAX TrainState on both sides."""
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=5,
              microbatches=2, distill_logit=1.0, distill_token=0.5)
    teacher = ref_model_init(REF_SSM, jax.random.key(1))[0]
    ref_step = jax.jit(ref_make_train_step(REF_SSM, RefTrainConfig(**kw),
                                           teacher_params=teacher))
    ref_state = ref_make_train_state(REF_SSM, ref_params,
                                     RefTrainConfig(**kw))
    state = train_state_from_numpy(jax.tree.map(np.asarray, ref_state),
                                   device="cpu")
    step = make_train_step(CFG, TrainConfig(**kw), teacher_params=(
        params_from_numpy(jax.tree.map(np.asarray, teacher), device="cpu")),
        device="cpu")
    for i in range(5):
        ref_state, want = ref_step(ref_state, ref_make_batch(
            REF_SSM, 8, 48, seed=11, step=i))
        state, got = step(state, make_batch_np(CFG, 8, 48, seed=11, step=i))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, err_msg=f"step {i} {k}")
    assert int(state.step) == int(ref_state.step) == 5
    for path, w in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, ref_state.params))[0]:
        node = state.params
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), w, atol=1e-5, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


# ----------------------------------------------------------------------
# the family engine on Mamba-2
# ----------------------------------------------------------------------

def _port_run(params, base, **extra):
    return gradual_prune(
        CFG, params, ENV, TARGETS,
        lambda step: synthetic_stream(CFG, 8, 48, seed=21, start_step=step),
        calibration_batches(CFG, 8, 48, batch=8), ckpt_dir=str(base),
        tcfg=TrainConfig(**TCFG_KW), device="cpu", **FAMILY_KW, **extra)


@pytest.fixture(scope="module")
def port_family(params, tmp_path_factory):
    base = tmp_path_factory.mktemp("port_ssm_family")
    return base, _port_run(params, base)


@pytest.fixture(scope="module")
def ref_family(ref_params, tmp_path_factory):
    """The reference's family with bench_gradual_family_ssm's smoke
    settings, on the same weights."""
    base = str(tmp_path_factory.mktemp("ref_ssm_family"))
    fam = ref_gradual_prune(
        REF_SSM, ref_params, RefEnv(hw=TPU_V5E, **ENV_KW), TARGETS,
        lambda step: ref_synthetic_stream(REF_SSM, 8, 48, seed=21,
                                          start_step=step),
        ref_calibration_batches(REF_SSM, 8, 48, batch=8),
        tcfg=RefTrainConfig(**TCFG_KW), ckpt_dir=base, **FAMILY_KW)
    return ref_family_run_dir(REF_SSM, TARGETS, 0, base), fam


def _fp16_step(a):
    """The distance from |a| to the next fp16 value, as fp32."""
    return np.spacing(np.abs(a).astype(np.float16)).astype(np.float32)


def test_ssm_family_matches_the_reference(ref_family, port_family):
    _, want = ref_family
    got = port_family[1]
    assert [v.target for v in got] == [v.target for v in want] == TARGETS
    for vw, vg in zip(want, got):
        assert vg.assignment == {k: int(v) for k, v in vw.assignment.items()}
        assert vg.achieved == vw.achieved >= vg.target
        np.testing.assert_allclose(vg.loss_before_ft, vw.loss_before_ft,
                                   rtol=1e-4)
        np.testing.assert_allclose(vg.loss_after_ft, vw.loss_after_ft,
                                   rtol=1e-4)
        flat = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, vw.params))[0]
        assert len(flat) == len(tree_leaves(vg.params))
        for path, r in flat:
            node = vg.params
            for k in path:
                node = node[k.key]
            d = np.abs(node.numpy() - r)
            past = d > 1e-5
            # only the stitched out-side matrix carries fp16 snapshots, and
            # a weight rounded the other way is rare (24 of 65536 here)
            if path[-1].key != "out_proj":
                assert not past.any(), jax.tree_util.keystr(path)
            assert past.sum() <= past.size // 1000, \
                jax.tree_util.keystr(path)
            assert (d <= 1e-5 + _fp16_step(r)).all(), \
                jax.tree_util.keystr(path)
        assert vg.pruned.num_params() == vw.pruned.num_params()
        assert layer_drop_plan(CFG, vg.assignment) == \
            list(ref_layer_drop_plan(REF_SSM, vw.assignment))


def test_ssm_family_reaches_the_reference_bench_sizes(port_family):
    """The port's members have ``BENCH_db.json``'s
    ``gradual_family_smoke_ssm`` sizes, speedups and dropped layers."""
    with open(os.path.join(ROOT, "BENCH_db.json")) as f:
        bench = json.load(f)["gradual_family_smoke_ssm"]
    assert bench["targets"] == TARGETS and bench["smoke"]
    for v in port_family[1]:
        rec = bench["members"][f"{v.target:g}x"]
        assert v.pruned.num_params() == rec["pruned_params"]
        assert v.achieved == rec["achieved_speedup"]
        assert sum(layer_drop_plan(CFG, v.assignment)) == \
            rec["layers_dropped"] == 1


def test_ssm_database_fed_the_reference_params_keeps_its_orders(
        params, ref_family):
    """The port's calibration and database stages on the reference run's
    finetuned target-1 params give the removal orders of the reference's
    target-2 database."""
    run_dir = ref_family[0]
    member = restore_pytree(params, os.path.join(run_dir, "t1.3",
                                                 "params.npz"))
    calib = calibration_batches(CFG, 8, 48, batch=8)
    db = build_database(CFG, member, collect_hessians(CFG, member, calib,
                                                      device="cpu"),
                        device="cpu")
    with np.load(os.path.join(run_dir, "t1.6", "db.npz")) as ref_db:
        for name, mdb in db.items():
            np.testing.assert_array_equal(mdb.order,
                                          ref_db[f"{name}::order"],
                                          err_msg=name)


def test_ssm_family_killed_mid_finetune_resumes_bit_identical(
        params, port_family, tmp_path):
    """Kill target 2's finetune after 3 of 4 steps (its last checkpoint
    at step 2), resume, and compare with the uninterrupted run."""
    with pytest.raises(FamilyPreempted):
        _port_run(params, tmp_path, stop_after=(1, "finetune", 3))
    resumed = _port_run(params, tmp_path)
    with open(os.path.join(family_run_dir(CFG, TARGETS, 0, str(tmp_path)),
                           "family.json")) as f:
        man = json.load(f)
    assert [(e["target"], e["stage"]) for e in man["executed"]
            if e["run"] == 2] == [("1.6", "finetune")]
    for vw, vg in zip(port_family[1], resumed):
        assert vw.assignment == vg.assignment
        assert vw.achieved == vg.achieved
        assert vw.loss_before_ft == vg.loss_before_ft
        assert vw.loss_after_ft == vg.loss_after_ft
        lw, lg = tree_leaves(vw.params), tree_leaves(vg.params)
        assert len(lw) == len(lg) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(lw, lg))
