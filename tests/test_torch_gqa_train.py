"""Gradual ZipLM on a GQA model, on the CPU, against the JAX package: the
smoke Qwen2 with two KV heads (``smoke_config("qwen2-72b")`` with
``num_kv_heads=2``: 2 layers, d_model 128, 4 query heads of 32 in 2 KV
groups, SwiGLU d_ff 256, QKV biases, vocab 512) in fp32, the reference's
``gradual_family_smoke_gqa`` (``benchmarks/run.py``). An attention unit
is one KV head with its group of query heads; removing it zeroes the
``wo`` rows of every query head in the group.

Each stage is fed the reference's inputs: the masks of a stitched member
with a KV group removed, five masked train steps from a JAX
``TrainState``, the family at the bench's smoke settings on both packages
from the same weights, the port's database on the reference's finetuned
params, and a kill and resume within the port. Tolerances are in
``tests/torch_family_parity.py``.
"""
import os

import jax
import numpy as np
import pytest

from repro.configs import smoke_config
from repro.models import model_init as ref_model_init
from repro_torch.core.pipeline import family_run_dir
from repro_torch.optim.adamw import tree_leaves
from torch_family_parity import (  # noqa: F401  (the fixture)
    TARGETS, assert_bench_sizes, assert_db_keeps_the_reference_orders,
    assert_family_matches, assert_masks_equal, assert_resume_bit_identical,
    bridge, masked_member, masked_rows, one_torch_thread, port_cfg,
    port_family, port_family_on_ref_databases, ref_family,
    train_steps_match)

REF_GQA = smoke_config("qwen2-72b").replace(num_kv_heads=2, dtype="float32")
CFG = port_cfg(REF_GQA)
GROUP_ROWS = CFG.q_per_kv * CFG.resolved_head_dim
# layer 0's second KV group, 104 of its 256 FFN rows (a level of the
# 0.9^i grid) and layer 1's whole FFN
ASSIGNMENT = {"L0.attn": 1, "L1.attn": 0, "L0.ffn": 104, "L1.ffn": 256}


@pytest.fixture(scope="module")
def ref_params():
    return ref_model_init(REF_GQA, jax.random.key(0))[0]


@pytest.fixture(scope="module")
def params(ref_params):
    return bridge(ref_params)


@pytest.fixture(scope="module")
def member(ref_params):
    return masked_member(REF_GQA, ref_params, ASSIGNMENT)


def test_kv_group_masks_match_the_reference(member):
    assert CFG.num_kv_heads == 2 and CFG.q_per_kv == 2
    assert_masks_equal(member["masks"], member["ref_masks"])
    wo = member["masks"]["layers"]["attn"]["wo"]
    gone = int(member["port_db"]["L0.attn"].order[0])
    rows = slice(gone * GROUP_ROWS, (gone + 1) * GROUP_ROWS)
    # the removed group's query heads lose all their wo rows, and only
    # they do
    assert float(wo[0, rows].sum()) == 0.0
    assert float(wo[0].sum()) == float(wo[0].numel() - wo[0, rows].numel())
    assert bool((wo[1] == 1).all())
    assert float(member["masks"]["layers"]["ffn"]["wd"][1].sum()) == 0.0
    assert masked_rows(bridge(member["member"]), member["masks"]) == 0.0


def test_masked_gqa_train_steps_match_the_reference(ref_params, member):
    train_steps_match(REF_GQA, member, ref_params)


@pytest.fixture(scope="module")
def port_gqa_family(params, tmp_path_factory):
    base = tmp_path_factory.mktemp("port_gqa_family")
    return base, port_family(CFG, params, base)


@pytest.fixture(scope="module")
def ref_gqa_family(ref_params, tmp_path_factory):
    return ref_family(REF_GQA, ref_params,
                      tmp_path_factory.mktemp("ref_gqa_family"))


def test_gqa_family_matches_the_reference(ref_gqa_family, port_gqa_family):
    assert_family_matches(CFG, REF_GQA, ref_gqa_family[1],
                          port_gqa_family[1])


def test_gqa_family_fed_the_reference_databases_matches_it(
        params, ref_gqa_family, tmp_path):
    """Each target's search, stitch and finetune fed the reference run's
    database: the same members, and every finetuned leaf within 1e-5 of
    the reference's (the end-to-end run above differs from it only by
    the fp16 stitch)."""
    got = port_family_on_ref_databases(CFG, params, tmp_path,
                                       ref_gqa_family[0])
    assert_family_matches(CFG, REF_GQA, ref_gqa_family[1], got,
                          fp16_input=False)


def test_gqa_family_reaches_the_reference_bench_sizes(params,
                                                      port_gqa_family):
    """``BENCH_db.json``'s ``gradual_family_smoke_gqa``: 361600 ->
    293632 / 244096 parameters, no layer dropped."""
    assert_bench_sizes("gradual_family_smoke_gqa", CFG, port_gqa_family[1],
                       sum(t.numel() for t in tree_leaves(params)))


def test_gqa_family_pins_removed_kv_groups(port_gqa_family):
    """Each member's removed KV groups (the first of its database's order)
    keep their query heads' ``wo`` rows at 0 through the finetune, the
    kept groups' rows are live, and the shrunk model carries only the
    kept KV heads."""
    base, fam = port_gqa_family
    run_dir = family_run_dir(CFG, TARGETS, 0, str(base))
    removed_any = False
    for v in fam:
        wo = v.params["layers"]["attn"]["wo"]
        with np.load(os.path.join(run_dir, f"t{v.target:g}",
                                  "db.npz")) as db:
            for layer, lp in enumerate(v.pruned.layers):
                r = v.assignment[f"L{layer}.attn"]
                gone = set(db[f"L{layer}.attn::order"][:r].tolist())
                removed_any |= bool(gone)
                for g in range(CFG.num_kv_heads):
                    rows = wo[layer, g * GROUP_ROWS:(g + 1) * GROUP_ROWS]
                    assert bool(rows.any()) == (g not in gone), (layer, g)
                assert lp.kv_groups == CFG.num_kv_heads - r
    assert removed_any


def test_gqa_database_fed_the_reference_params_keeps_its_orders(
        params, ref_gqa_family):
    assert_db_keeps_the_reference_orders(
        CFG, params, ref_gqa_family[0],
        [f"L{i}.{k}" for i in range(CFG.num_layers) for k in ("attn", "ffn")])


def test_gqa_family_killed_mid_finetune_resumes_bit_identical(
        params, port_gqa_family, tmp_path):
    assert_resume_bit_identical(CFG, params, port_gqa_family[1], tmp_path)
