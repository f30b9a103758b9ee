"""Gradual ZipLM on the mixture-of-experts family, on the CPU, against the
JAX package: the smoke Phi-3.5-MoE (``smoke_config("phi3.5-moe-42b-a6.6b")``:
2 layers, d_model 128, 4 query heads on 1 KV head, 4 experts top-2 of
d_ff 256, vocab 512) in fp32 and in expert mode (``moe_prune_unit``
"expert": each expert kept or dropped whole), the reference's
``gradual_family_smoke_moe`` (``benchmarks/run.py``).

Each stage is fed the reference's inputs: the masks of a stitched member
with dropped experts, five masked train steps from a JAX ``TrainState``
with an expert over its capacity (the dispatch's dropped slot), the family
at the bench's smoke settings on both packages from the same weights, the
port's database on the reference's finetuned params, and a kill and
resume within the port. Tolerances are in ``tests/torch_family_parity.py``.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config
from repro.models import model_init as ref_model_init
from repro_torch.models import moe as moe_mod
from repro_torch.optim.adamw import tree_leaves
from torch_family_parity import (  # noqa: F401  (the fixture)
    assert_bench_sizes, assert_db_keeps_the_reference_orders,
    assert_family_matches, assert_masks_equal, assert_resume_bit_identical,
    bridge, masked_member, masked_rows, one_torch_thread, port_cfg,
    port_family, port_family_on_ref_databases, ref_family,
    train_steps_match)

REF_MOE = smoke_config("phi3.5-moe-42b-a6.6b").replace(
    dtype="float32", moe_prune_unit="expert")
CFG = port_cfg(REF_MOE)
D_FF = CFG.d_ff
# one expert of each layer dropped whole, and layer 1's attention (its one
# KV group)
ASSIGNMENT = {"L0.expert1": D_FF, "L0.expert2": 0, "L1.expert3": D_FF,
              "L1.attn": 1}


@pytest.fixture(scope="module")
def ref_params():
    return ref_model_init(REF_MOE, jax.random.key(0))[0]


@pytest.fixture(scope="module")
def params(ref_params):
    return bridge(ref_params)


@pytest.fixture(scope="module")
def member(ref_params):
    return masked_member(REF_MOE, ref_params, ASSIGNMENT)


def test_expert_masks_match_the_reference(member):
    assert_masks_equal(member["masks"], member["ref_masks"])
    wd = member["masks"]["layers"]["moe"]["wd"]
    # a dropped expert's wd rows are all pinned; the others none
    assert float(wd[0, 1].sum()) == float(wd[1, 3].sum()) == 0.0
    assert bool((wd[0, [0, 2, 3]] == 1).all())
    assert bool((wd[1, [0, 1, 2]] == 1).all())
    assert float(member["masks"]["layers"]["attn"]["wo"][1].sum()) == 0.0
    assert masked_rows(bridge(member["member"]), member["masks"]) == 0.0


def test_masked_moe_train_steps_match_the_reference(ref_params, member,
                                                    monkeypatch):
    """The dispatch overflows: at these 192 tokens a microbatch an expert
    gets more than its capacity of top-2 assignments, so the overflow
    slot takes writes and the dropped tokens get no expert output."""
    routes = []
    route = moe_mod.route

    def recording_route(router, xf, k):
        out = route(router, xf, k)
        routes.append((xf.shape[0], out[2].detach()))
        return out

    monkeypatch.setattr(moe_mod, "route", recording_route)
    train_steps_match(REF_MOE, member, ref_params)
    over = [int((torch.bincount(topi.reshape(-1), minlength=CFG.num_experts)
                 - moe_mod.capacity(t, CFG)).clamp_min(0).sum())
            for t, topi in routes]
    assert max(over) > 0, over


@pytest.fixture(scope="module")
def port_moe_family(params, tmp_path_factory):
    base = tmp_path_factory.mktemp("port_moe_family")
    return base, port_family(CFG, params, base)


@pytest.fixture(scope="module")
def ref_moe_family(ref_params, tmp_path_factory):
    return ref_family(REF_MOE, ref_params,
                      tmp_path_factory.mktemp("ref_moe_family"))


def test_moe_family_matches_the_reference(ref_moe_family, port_moe_family):
    assert_family_matches(CFG, REF_MOE, ref_moe_family[1],
                          port_moe_family[1])


def test_moe_family_fed_the_reference_databases_matches_it(
        params, ref_moe_family, tmp_path):
    """Each target's search, stitch and finetune fed the reference run's
    database: the same members, and every finetuned leaf within 1e-5 of
    the reference's (the end-to-end run above differs from it only by
    the fp16 stitch)."""
    got = port_family_on_ref_databases(CFG, params, tmp_path,
                                       ref_moe_family[0])
    assert_family_matches(CFG, REF_MOE, ref_moe_family[1], got,
                          fp16_input=False)


def test_moe_family_reaches_the_reference_bench_sizes(params,
                                                      port_moe_family):
    """``BENCH_db.json``'s ``gradual_family_smoke_moe``: 935552 ->
    853376 / 656768 parameters, no layer dropped."""
    assert_bench_sizes("gradual_family_smoke_moe", CFG, port_moe_family[1],
                       sum(t.numel() for t in tree_leaves(params)))


def test_moe_family_drops_whole_experts_and_pins_them(port_moe_family):
    """Expert mode removes each expert whole or not at all, and the
    finetuned params keep a dropped expert's ``wd`` rows at 0."""
    dropped = 0
    for v in port_moe_family[1]:
        wd = v.params["layers"]["moe"]["wd"]
        for name, removed in v.assignment.items():
            if ".expert" not in name:
                continue
            assert removed in (0, D_FF), name
            if removed:
                dropped += 1
                layer, e = name[1:].split(".expert")
                assert not bool(wd[int(layer), int(e)].any()), name
    assert dropped > 0


def test_moe_database_fed_the_reference_params_keeps_its_orders(
        params, ref_moe_family):
    """The attention modules keep the reference's orders (the shared
    helper). An expert's Hessian is ill conditioned here (condition
    6e4-1.3e5 after damping, at these 8 x 48 calibration tokens and at
    24 x 64 alike): late in Algorithm 1 its near-tied removals part the
    two packages' orders even when both start from the reference's own
    inverse (after about 150 of 256 steps). Expert mode reads only the
    keep and the drop level of an expert, so each expert's database is
    held there: levels, snapshots, errors and priors."""
    run_dir = ref_moe_family[0]
    attn = [f"L{i}.attn" for i in range(CFG.num_layers)]
    db = assert_db_keeps_the_reference_orders(CFG, params, run_dir, attn)
    with np.load(os.path.join(run_dir, "t1.6", "db.npz")) as ref_db:
        for name, mdb in db.items():
            if mdb.mod.kind != "moe":
                continue
            np.testing.assert_array_equal(mdb.levels, [0, D_FF])
            np.testing.assert_array_equal(ref_db[f"{name}::levels"],
                                          mdb.levels)
            np.testing.assert_allclose(
                mdb.snapshots.astype(np.float32),
                ref_db[f"{name}::snapshots"].astype(np.float32),
                atol=2e-3, rtol=2e-3, err_msg=name)
            np.testing.assert_allclose(mdb.errors, ref_db[f"{name}::errors"],
                                       rtol=1e-3, atol=1e-6, err_msg=name)
            np.testing.assert_array_equal(mdb.priors,
                                          ref_db[f"{name}::priors"])


def test_moe_family_killed_mid_finetune_resumes_bit_identical(
        params, port_moe_family, tmp_path):
    assert_resume_bit_identical(CFG, params, port_moe_family[1], tmp_path)
