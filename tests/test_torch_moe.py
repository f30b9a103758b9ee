"""The port's mixture-of-experts slice and its config registry against the
JAX package, on the reference's smoke Phi-3.5-MoE
(``smoke_config("phi3.5-moe-42b-a6.6b")``: 2 layers, d_model 128, 4 query
heads of 32 on 1 KV head, 4 experts top-2 of d_ff 256, vocab 512) in
fp32, in both MoE prune modes (``moe_prune_unit`` "width": per-expert
FFN rows on the 0.9^i grid; "expert": each expert kept or dropped
whole). The reference's weights cross over through the weight bridge;
tokens are the numpy-seeded streams both packages make. Each stage is fed
the reference's output of the stage before:

* the registry: every ported config field for field, its smoke config
  and that config's forward logits, the names not ported, each smoke
  config through ``oneshot_prune`` and shrink, and the smoke models'
  sizes of ``BENCH_db.json``;
* ``moe_apply``: outputs, the load-balancing ``aux`` and the captures
  ``wd_in``/``wd_valid``, without drops, with the reference's drops and
  with many drops (the capacity factor set through the module constant
  on both sides); top-k ties; forward, prefill and decode logits, greedy
  tokens;
* the ``moe`` unit: registry and level grids, ``moe_expert_time`` and
  the cost tables, the measured table's expert levels; expert Hessians
  (masked rows, ``n`` the valid count) and the non-finite batch skip;
  the database from the reference's Hessians (identical removal orders,
  snapshots within fp16 tolerance); the per-expert stitch of
  ``SnapshotCache`` against the reference's; the family search on the
  reference's database and table; shrink on the reference's
  assignments (parameter counts, ``None`` experts, router columns,
  leaves), the pruned forward, prefill and decode; the serving engine's
  tokens; ``oneshot_prune`` end to end.

Tolerances are the reference's own: logits 1e-4 (tests/test_torch_ssm.py
holds the same), Hessians 1e-5 of their scale, database errors 1e-3 and
snapshots 2e-3 (fp16), shrunk vs masked 2e-2 (tests/test_shrink.py).
Shrunk and masked models are compared with ``CAPACITY_FACTOR`` lifted to
8.0 on both sides, as the reference's decode test does: the dense
model's capacity dispatch drops tokens that the pruned runtime's dense
gather never drops.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import shapes_for as ref_shapes_for
from repro.configs import smoke_config as ref_smoke_config
from repro.core import database as ref_database
from repro.core import spdy as ref_spdy
from repro.core.hessian import collect_hessians as ref_collect_hessians
from repro.core.hessian import xtx as ref_xtx
from repro.core.latency import build_table as ref_build_table
from repro.core.shrink import shrink as ref_shrink
from repro.core.structures import level_grid as ref_level_grid
from repro.core.structures import registry as ref_registry
from repro.data import calibration_batches as ref_calibration_batches
from repro.models import generate as ref_generate
from repro.models import model_init as ref_model_init
from repro.models.pruned import decode_step_pruned as ref_decode_step_pruned
from repro.models.pruned import forward_pruned as ref_forward_pruned
from repro.models.pruned import prefill_pruned as ref_prefill_pruned
from repro.models.transformer import decode_step as ref_decode_step
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_cache as ref_init_cache
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro.runtime.costmodel import moe_expert_time as ref_moe_expert_time
from repro.serve import DenseServeModel as RefDenseServeModel
from repro.serve import PrunedServeModel as RefPrunedServeModel
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import configs
from repro_torch.configs import ModelConfig
from repro_torch.core import database, hessian, spdy
from repro_torch.core.latency import LatencyTable, build_table
from repro_torch.core.oneshot import oneshot_prune
from repro_torch.core.shrink import shrink, shrink_from_stitched
from repro_torch.core.structures import (UNITS, PrunableModule, drop_layer,
                                         get_capture, level_grid, registry)
from repro_torch.data import calibration_batches
from repro_torch.models import (decode_step, forward, generate, init_cache,
                                model_init, moe as moe_mod)
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.pruned import (decode_step_pruned, forward_pruned,
                                       prefill_pruned)
from repro_torch.runtime.costmodel import (HardwareSpec, InferenceEnv,
                                           moe_expert_time)
from repro_torch.serve import (DenseServeModel, PrunedServeModel,
                               ServeEngine, synthetic_requests)

JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
REF_MOE = ref_smoke_config("phi3.5-moe-42b-a6.6b").replace(dtype="float32")
MODES = ["width", "expert"]
REF_CFGS = {m: REF_MOE.replace(moe_prune_unit=m) for m in MODES}
HW = HardwareSpec(**dataclasses.asdict(TPU_V5E))
ENV_KW = dict(batch=8, seq=64, mode="prefill")
TARGETS = [1.2, 1.5, 2.0]
NO_DROPS = 8.0  # the reference's decode test lifts CAPACITY_FACTOR to this
MAX_LEN = 48


def port_cfg(ref_cfg) -> ModelConfig:
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(ref_cfg).items()
                          if k not in JAX_EXECUTION})


CFGS = {m: port_cfg(c) for m, c in REF_CFGS.items()}
CFG = CFGS["width"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (b, s))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def capacity_factor(monkeypatch):
    """Set the MoE capacity factor of both packages (their module
    constants, read at call time)."""
    def set_both(f):
        monkeypatch.setattr(ref_moe, "CAPACITY_FACTOR", f)
        monkeypatch.setattr(moe_mod, "CAPACITY_FACTOR", f)
    return set_both


# ----------------------------------------------------------------------
# the config registry
# ----------------------------------------------------------------------

def test_registry_holds_the_ported_reference_configs():
    assert set(configs.ARCHS) == set(REF_ARCHS) - set(configs.NOT_PORTED)
    assert set(configs.NOT_PORTED) <= set(REF_ARCHS)
    for name in configs.NOT_PORTED:
        with pytest.raises(KeyError, match="not ported yet") as e:
            configs.get_config(name)
        for other in configs.NOT_PORTED:
            assert other in str(e.value)
    with pytest.raises(KeyError):
        configs.get_config("gpt5")
    assert configs.get_config("gpt2-small") is configs.GPT2_SMALL
    assert configs.get_config("mamba2-2.7b") is configs.MAMBA2_2P7B


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_config_and_smoke_forward_match_reference(arch):
    """Each ported config field for field, its smoke config, its shape
    cells, and the smoke config's forward logits (fp32) on the
    reference's weights."""
    want = dataclasses.asdict(port_cfg(ref_get_config(arch)))
    assert dataclasses.asdict(configs.get_config(arch)) == want
    ref_smoke = ref_smoke_config(arch).replace(dtype="float32")
    smoke = configs.smoke_config(arch).replace(dtype="float32")
    assert dataclasses.asdict(smoke) == dataclasses.asdict(port_cfg(ref_smoke))
    assert [dataclasses.asdict(s) for s in configs.shapes_for(arch)] == \
        [dataclasses.asdict(s) for s in ref_shapes_for(arch)]
    params = ref_model_init(ref_smoke, jax.random.key(0))[0]
    tokens = np.random.default_rng(1).integers(0, smoke.vocab_size, (2, 40))
    frames = None  # an encoder/decoder's or a VLM's frame embeddings
    if smoke.frontend != "none":
        frames = np.random.default_rng(2).standard_normal(
            (2, smoke.num_frontend_tokens, smoke.frontend_dim)).astype(
                np.float32)
    got = forward(smoke, params_from_numpy(_np(params), device="cpu"),
                  torch.from_numpy(tokens), frontend_embeds=(
                      None if frames is None else torch.from_numpy(frames)))
    want = ref_forward(ref_smoke, params, tokens, frontend_embeds=frames)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]),
                               rtol=1e-5, atol=1e-6)


def test_port_init_has_the_reference_moe_leaves():
    got = model_init(CFG, device="cpu")
    want = ref_model_init(REF_MOE, jax.random.key(0))[0]
    shapes = jax.tree.map(lambda a: tuple(a.shape), want)
    assert {k: tuple(v.shape) for k, v in got["layers"]["moe"].items()} == \
        shapes["layers"]["moe"]
    assert "ffn" not in got["layers"]
    assert all(t.dtype == torch.float32 for _, t in _leaves(got))


# BENCH_db.json gradual_family_smoke_{moe,ssm,gqa}.dense_params, with the
# config changes benchmarks/run.py makes
BENCH_SMOKE = [("phi3.5-moe-42b-a6.6b", {}, 935552),
               ("mamba2-2.7b", {}, 276208),
               ("qwen2-72b", {"num_kv_heads": 2}, 361600)]


@pytest.mark.parametrize("arch,kw,count", BENCH_SMOKE,
                         ids=[a for a, _, _ in BENCH_SMOKE])
def test_smoke_model_sizes_match_the_reference_bench(arch, kw, count):
    cfg = configs.smoke_config(arch).replace(**kw)
    got = model_init(cfg, device="cpu")
    assert sum(t.numel() for _, t in _leaves(got)) == count


@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_every_registry_config_runs_the_one_shot_path(arch):
    """``ARCHS`` holds the configs the port runs: each smoke config goes
    through ``oneshot_prune`` (costmodel table), meets its target, and
    shrinks to a model with finite logits; a model with cross-attention
    (encoder/decoder or grouped cross layers), which ``shrink`` refuses,
    gives finite logits stitched."""
    cfg = configs.smoke_config(arch).replace(dtype="float32")
    params = model_init(cfg, device="cpu")
    calib = calibration_batches(cfg, 4, 32, batch=4)
    res = oneshot_prune(cfg, params, calib, InferenceEnv(hw=HW, **ENV_KW),
                        [1.5], search_steps=8, search_pop=4, seed=0,
                        device="cpu")
    v = res.variants[1.5]
    assert v.speedup >= 1.5 and np.isfinite(v.calib_loss)
    if cfg.encoder_decoder or cfg.cross_attn_every:
        with pytest.raises(NotImplementedError, match="cross-attention"):
            shrink(cfg, v.params, res.db, v.assignment, device="cpu")
        assert torch.isfinite(forward(
            cfg, v.params, calib[0]["tokens"],
            frontend_embeds=calib[0]["frontend"])["logits"]).all()
        return
    pm = shrink(cfg, v.params, res.db, v.assignment, device="cpu")
    assert torch.isfinite(forward_pruned(pm, calib[0]["tokens"])).all()


# ----------------------------------------------------------------------
# the MoE layer and the model
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """Reference weights, calibration batches, Hessians and the database
    of each mode."""
    params = ref_model_init(REF_MOE, jax.random.key(0))[0]
    # 1536 tokens: each expert sees about 768 rows for its 256 inputs, so
    # its Hessian has full rank (8 x 48 tokens leave it rank-deficient,
    # and the reference's fp32 inverse then sets the removal order)
    calib = ref_calibration_batches(REF_MOE, 24, 64, batch=8)
    hess = ref_collect_hessians(REF_MOE, params, calib)
    db = {m: ref_database.build_database(c, params, hess)
          for m, c in REF_CFGS.items()}
    return {"params": params, "calib": calib, "hess": hess, "db": db}


@pytest.fixture(scope="module")
def params(ref):
    return params_from_numpy(_np(ref["params"]), device="cpu")


@pytest.mark.parametrize("factor,drops", [
    (NO_DROPS, "none"), (moe_mod.CAPACITY_FACTOR, "none"), (1.0, "some"),
    (0.5, "many")])
def test_moe_apply_outputs_aux_and_captures_match_reference(
        ref, params, capacity_factor, factor, drops):
    capacity_factor(factor)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 24, CFG.d_model)) * 0.5).astype(np.float32)
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    rlp = jax.tree.map(lambda a: a[0], ref["params"]["layers"]["moe"])
    caps, rcaps = {}, {}
    out, aux = moe_mod.moe_apply(CFG, lp, torch.from_numpy(x), capture=caps)
    rout, raux = ref_moe.moe_apply(REF_MOE, rlp, jnp.asarray(x),
                                   capture=rcaps)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    np.testing.assert_array_equal(caps["wd_valid"].numpy(),
                                  np.asarray(rcaps["wd_valid"]))
    np.testing.assert_allclose(caps["wd_in"].numpy(),
                               np.asarray(rcaps["wd_in"]), atol=1e-5,
                               rtol=1e-5)
    kept = int(caps["wd_valid"].sum())
    assigned = x.shape[0] * x.shape[1] * CFG.num_experts_per_tok
    assert caps["wd_in"].shape == (CFG.num_experts,
                                   moe_mod.capacity(96, CFG), CFG.d_ff)
    assert {"none": kept == assigned, "some": 0 < assigned - kept < 16,
            "many": kept <= assigned // 2}[drops], (kept, assigned)
    # an unfilled slot holds zeros and counts for no sample
    assert not caps["wd_in"][~caps["wd_valid"]].any()


def test_top_k_takes_the_lower_index_among_ties():
    probs = np.asarray([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                        [0.3, 0.2, 0.3, 0.2]], np.float32)
    vals, idx = moe_mod.top_k(torch.from_numpy(probs), 2)
    rvals, ridx = jax.lax.top_k(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))


def test_forward_logits_aux_and_captures_match_reference(ref, params):
    tokens = _tokens(2, 70, 0)
    want = ref_forward(REF_MOE, ref["params"], tokens, capture=True)
    got = forward(CFG, params, torch.from_numpy(tokens), capture=True)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(got["aux"]), float(want["aux"]),
                               rtol=1e-5)
    for key in ("wd_in", "wd_valid"):
        np.testing.assert_allclose(
            got["captures"]["ffn"][key].numpy().astype(np.float32),
            np.asarray(want["captures"]["ffn"][key]).astype(np.float32),
            atol=1e-5, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["captures"]["attn"]["wo_in"].numpy(),
                               np.asarray(want["captures"]["attn"]["wo_in"]),
                               atol=1e-5, rtol=1e-5)


def test_prefill_and_decode_steps_match_reference(ref, params):
    tokens = _tokens(2, 37, 1)
    want = ref_forward(REF_MOE, ref["params"], tokens, mode="prefill")
    got = forward(CFG, params, torch.from_numpy(tokens), mode="prefill")
    for k in ("k", "v"):
        np.testing.assert_allclose(got["cache"][k].numpy(),
                                   np.asarray(want["cache"][k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    rcache = ref_init_cache(REF_MOE, 2, 64)
    rcache["attn"] = {k: jnp.zeros_like(v).at[:, :, :37].set(want["cache"][k])
                      for k, v in rcache["attn"].items()}
    rcache["pos"] = jnp.asarray(37, jnp.int32)
    cache = init_cache(CFG, 2, 64, device="cpu")
    for k in ("k", "v"):
        cache["attn"][k][:, :, :37] = got["cache"][k]
    cache["pos"].fill_(37)
    for step, nxt in enumerate(([[3], [5]], [[7], [11]], [[2], [2]])):
        nxt = np.asarray(nxt)
        rlog, rcache = ref_decode_step(REF_MOE, ref["params"], rcache, nxt)
        log, cache = decode_step(CFG, params, cache, torch.from_numpy(nxt))
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {step}")
    assert int(cache["pos"]) == 40


def test_generate_greedy_tokens_match_reference(ref, params):
    prompt = _tokens(2, 40, 2)
    want = np.asarray(ref_generate(REF_MOE, ref["params"], prompt, 12))
    got = generate(CFG, params, torch.from_numpy(prompt), 12)
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# the moe unit: registry, grids, latency
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_registry_and_grids_match_reference(mode):
    cfg, rcfg = CFGS[mode], REF_CFGS[mode]
    mods, ref_mods = registry(cfg), ref_registry(rcfg)
    assert [dataclasses.asdict(m) for m in mods] == \
        [dataclasses.asdict(m) for m in ref_mods]
    assert list(UNITS) == ["attn", "ssm", "moe", "ffn"]
    assert [m.name for m in mods[:5]] == \
        ["L0.attn"] + [f"L0.expert{e}" for e in range(4)]
    for m, rm in zip(mods, ref_mods):
        assert level_grid(m) == ref_level_grid(rm)
    experts = [m for m in mods if m.kind == "moe"]
    assert all(m.group_size == 1 and m.n_structures == cfg.d_ff
               for m in experts)
    if mode == "expert":
        assert all(level_grid(m) == [0, cfg.d_ff] for m in experts)
    else:
        assert all(m.levels is None and len(level_grid(m)) > 2
                   for m in experts)
    # the full-width model: 16 experts a layer, 44 levels in width mode
    full = configs.PHI35_MOE.replace(num_layers=1, moe_prune_unit=mode)
    fmods = [m for m in registry(full) if m.kind == "moe"]
    assert len(fmods) == 16 and fmods[0].d_in == 6400
    assert len(level_grid(fmods[0])) == (44 if mode == "width" else 2)


@pytest.mark.parametrize("mode", MODES)
def test_cost_tables_and_moe_expert_time_match_reference(mode):
    cfg, rcfg = CFGS[mode], REF_CFGS[mode]
    for regime in ("prefill", "decode"):
        kw = {**ENV_KW, "mode": regime}
        env, renv = InferenceEnv(hw=HW, **kw), RefEnv(hw=TPU_V5E, **kw)
        for f_live in (0, 1, 100, cfg.d_ff):
            assert moe_expert_time(cfg, env, f_live) == \
                ref_moe_expert_time(rcfg, renv, f_live)
        for tp in (1, 4):
            assert moe_expert_time(cfg, env.replace(tp=tp), 64) == \
                ref_moe_expert_time(rcfg, renv.replace(tp=tp), 64)
        want = ref_build_table(rcfg, renv)
        got = build_table(cfg, env, device="cpu")
        assert list(got.grids) == list(want.grids) == ["attn", "moe"]
        for kind in want.grids:
            np.testing.assert_array_equal(got.grids[kind], want.grids[kind])
            np.testing.assert_array_equal(got.times[kind], want.times[kind])
        assert got.base == want.base
        assert got.times["moe"][-1] == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_measured_table_times_one_expert_at_its_token_share(mode,
                                                            monkeypatch):
    """The measured backend times one expert's SwiGLU at the expected
    per-expert tokens ``max(8, int(tokens * k / E * 1.25))``."""
    from repro_torch.core import latency
    seen = []
    real = latency._ffn_timing_module

    def spy(cfg, tokens, f_live, gen, dt, dev):
        seen.append((tokens, f_live))
        return real(cfg, tokens, f_live, gen, dt, dev)

    monkeypatch.setattr(latency, "_ffn_timing_module", spy)
    cfg = CFGS[mode]
    table = build_table(cfg, InferenceEnv(hw=None, **ENV_KW), "measure",
                        device="cpu", reps=1, warmup=0)
    assert list(table.grids) == ["attn", "moe"]
    assert table.grids["moe"][-1] == cfg.d_ff
    assert table.times["moe"][-1] == 0.0
    assert (table.times["moe"][:-1] > 0).all()
    tokens = max(8, int(8 * 64 * 2 / 4 * 1.25))
    assert {t for t, _ in seen} == {tokens}
    assert sorted(f for _, f in seen) == sorted(
        cfg.d_ff - int(r) for r in table.grids["moe"][:-1])


# ----------------------------------------------------------------------
# expert Hessians
# ----------------------------------------------------------------------

def test_masked_rows_give_the_reference_xtx():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((40, 24)).astype(np.float32)
    valid = rng.random(40) < 0.6
    acc = rng.standard_normal((24, 24)).astype(np.float32)
    got = hessian.xtx(torch.from_numpy(x), torch.from_numpy(valid),
                      acc=torch.from_numpy(acc))
    want = ref_xtx(jnp.asarray(x), jnp.asarray(valid), acc=jnp.asarray(acc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the masked rows are the unmasked product of the valid rows alone
    np.testing.assert_allclose(
        hessian.xtx(torch.from_numpy(x), torch.from_numpy(valid)).numpy(),
        x[valid].T @ x[valid], atol=1e-4, rtol=1e-5)


def test_expert_hessians_match_reference(ref, params):
    calib = calibration_batches(CFG, 24, 64, batch=8)
    got = hessian.collect_hessians(CFG, params, calib, device="cpu")
    assert list(got) == list(ref["hess"]) == [m.name for m in registry(CFG)]
    for name, want in ref["hess"].items():
        want = np.asarray(want)
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    # normalised by each expert's valid count: X^T X / n of its routed rows
    caps = forward(CFG, params, calib[0]["tokens"], capture=True)["captures"]
    mod = registry(CFG)[3]
    x, valid = get_capture(caps, mod)
    assert x.shape == (moe_mod.capacity(8 * 64, CFG), CFG.d_ff)
    one = hessian.collect_hessians(CFG, params, calib[:1], device="cpu")
    xv = x[valid].double()
    torch.testing.assert_close(one[mod.name].double(),
                               xv.T @ xv / int(valid.sum()), atol=1e-5,
                               rtol=1e-5)


def test_non_finite_expert_capture_skips_the_batch(params, monkeypatch,
                                                   capsys):
    """A NaN in one expert's dispatch slots skips the whole batch for
    every module: the result is the clean run over the other batches."""
    calib = calibration_batches(CFG, 24, 48, batch=8)
    clean = hessian.collect_hessians(CFG, params, [calib[0], calib[2]],
                                     device="cpu")
    real_forward = hessian.forward
    calls = []

    def poisoned(cfg, params, tokens, *, capture):
        out = real_forward(cfg, params, tokens, capture=capture)
        calls.append(1)
        if len(calls) == 2:
            out["captures"]["ffn"]["wd_in"][1, 2, 0, 5] = float("nan")
        return out

    monkeypatch.setattr(hessian, "forward", poisoned)
    got = hessian.collect_hessians(CFG, params, calib, device="cpu")
    assert "skipped 1/3" in capsys.readouterr().out
    for name in clean:
        np.testing.assert_array_equal(got[name].numpy(), clean[name].numpy(),
                                      err_msg=name)


# ----------------------------------------------------------------------
# the database and the per-expert stitch
# ----------------------------------------------------------------------

def _port_db(ref_db):
    """The reference's database as the port's ModuleDBs (same arrays)."""
    return {n: database.ModuleDB(
        mod=PrunableModule(**dataclasses.asdict(m.mod)), levels=m.levels,
        snapshots=m.snapshots, errors=m.errors, priors=m.priors,
        base_norm=m.base_norm, order=m.order) for n, m in ref_db.items()}


@pytest.fixture(scope="module")
def port_dbs(ref, params):
    hess = {k: torch.from_numpy(np.asarray(v)) for k, v in ref["hess"].items()}
    return {m: database.build_database(CFGS[m], params, hess, device="cpu")
            for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_database_from_reference_hessians_matches_reference(ref, port_dbs,
                                                            mode):
    got_db, want_db = port_dbs[mode], ref["db"][mode]
    assert list(got_db) == list(want_db)
    for name, w in want_db.items():
        g = got_db[name]
        np.testing.assert_array_equal(g.levels, w.levels)
        np.testing.assert_array_equal(g.order, w.order, err_msg=name)
        np.testing.assert_allclose(g.errors, w.errors, rtol=1e-3, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(g.priors, w.priors, rtol=1e-3, atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(g.snapshots.astype(np.float32),
                                   w.snapshots.astype(np.float32),
                                   atol=2e-3, rtol=2e-3, err_msg=name)


def _assignments(mode, kind):
    """Level assignments over the smoke MoE's modules (levels on each
    mode's grid)."""
    full, grid = CFG.d_ff, level_grid(registry(CFGS[mode])[1])
    mods = registry(CFGS[mode])
    if kind == "mixed":  # expert 0 dropped, the others at other levels
        lv = [full, grid[3], grid[-2], 0] if mode == "width" \
            else [full, 0, full, 0]
        return {m.name: (lv[m.expert] if m.kind == "moe" else 0)
                for m in mods}
    if kind == "module_drop":  # layer 1's whole MoE, layer 0's attention
        return {m.name: (m.n_structures if (m.kind == "moe" and m.layer == 1)
                         or m.name == "L0.attn" else 0) for m in mods}
    a = {m.name: (grid[1] if m.kind == "moe" else 0) for m in mods}
    return drop_layer(a, mods, 0)  # layer_drop


KINDS = ["mixed", "module_drop", "layer_drop"]


@pytest.mark.parametrize("mode", MODES)
def test_snapshot_cache_stitches_experts_as_the_reference(ref, params, mode):
    db = _port_db(ref["db"][mode])
    rcache = ref_database.SnapshotCache(REF_CFGS[mode], ref["db"][mode])
    cache = database.SnapshotCache(CFGS[mode], db, device="cpu")
    assigns = [_assignments(mode, k) for k in KINDS]
    for a in assigns:
        want = rcache.apply(ref["params"], a)["layers"]["moe"]["wd"]
        got = cache.apply(params, a)
        np.testing.assert_array_equal(got["layers"]["moe"]["wd"].numpy(),
                                      np.asarray(want))
        # only the stitched leaf changed, and the input tree is untouched
        assert got["layers"]["moe"]["wg"] is params["layers"]["moe"]["wg"]
        hosted = database.apply_assignment(CFGS[mode], params, db, a)
        assert torch.equal(hosted["layers"]["moe"]["wd"],
                           got["layers"]["moe"]["wd"])
    want = rcache.apply_batched(ref["params"], assigns)
    got = cache.apply_batched(params, assigns)
    for grp, leaf in (("moe", "wd"), ("attn", "wo")):
        np.testing.assert_array_equal(got["layers"][grp][leaf].numpy(),
                                      np.asarray(want["layers"][grp][leaf]))
    assert not torch.equal(params["layers"]["moe"]["wd"],
                           got["layers"]["moe"]["wd"][0])


@pytest.mark.parametrize("mode", MODES)
def test_search_family_matches_reference(ref, mode):
    renv = RefEnv(hw=TPU_V5E, **ENV_KW)
    ref_tab = ref_build_table(REF_CFGS[mode], renv)
    want = ref_spdy.search_family(ref["db"][mode], ref_tab, TARGETS,
                                  steps=48, pop=16, seed=3)
    tab = LatencyTable(env=InferenceEnv(hw=HW, **ENV_KW),
                       grids=dict(ref_tab.grids), times=dict(ref_tab.times),
                       base=ref_tab.base)
    got = spdy.search_family(_port_db(ref["db"][mode]), tab, TARGETS,
                             steps=48, pop=16, seed=3)
    for t in TARGETS:
        assert got[t].assignment == want[t].assignment
        assert got[t].score == want[t].score
        assert got[t].speedup >= t


# ----------------------------------------------------------------------
# shrink and the pruned runtime
# ----------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p, t) for k in sorted(tree)
                for p, t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [(f"{i}/" + p, t) for i, v in enumerate(tree)
                for p, t in _leaves(v)]
    return [("", tree)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", MODES)
def test_shrink_matches_reference_and_the_masked_model(
        ref, params, port_dbs, capacity_factor, mode, kind):
    cfg, rcfg = CFGS[mode], REF_CFGS[mode]
    a = _assignments(mode, kind)
    ref_masked = ref_database.apply_assignment(rcfg, ref["params"],
                                               ref["db"][mode], a)
    want = ref_shrink(rcfg, ref_masked, ref["db"][mode], a)
    # from the reference's own database every leaf is bit-equal
    same_db = _port_db(ref["db"][mode])
    exact = shrink(cfg, params, same_db, a, device="cpu")
    assert exact.num_params() == want.num_params() < \
        sum(t.numel() for _, t in _leaves(params))
    for lg, lw in zip(exact.layers, want.layers):
        assert (lg.kv_groups, lg.d_ff, lg.expert_ff) == \
            (lw.kv_groups, lw.d_ff, lw.expert_ff)
        g, w = _leaves(lg.params), _leaves(_np(lw.params))
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, tg), (_, tw) in zip(g, w):
            if tg is None or tw is None:  # a dropped expert on both sides
                assert tg is None and tw is None, path
                continue
            np.testing.assert_array_equal(tg.numpy(), tw, err_msg=path)
        if lg.expert_ff:  # dropped experts stay routable: full router
            assert lg.params["moe"]["router"].shape == (cfg.d_model,
                                                        cfg.num_experts)
            assert [e is None for e in lg.params["moe"]["experts"]] == \
                [f == 0 for f in lg.expert_ff]
    if kind == "mixed":
        assert exact.layers[0].expert_ff[0] == 0
        assert exact.layers[0].params["moe"]["experts"][0] is None
    if kind == "module_drop":
        assert exact.layers[1].expert_ff == [] and exact.layers[0].kv_groups == 0
    if kind == "layer_drop":
        assert exact.layers[0].params == {}
    # from the port's own database: the same structure, snapshots in fp16
    got = shrink(cfg, params, port_dbs[mode], a, device="cpu")
    assert got.num_params() == want.num_params()
    assert [l.expert_ff for l in got.layers] == \
        [l.expert_ff for l in want.layers]
    # shrink_from_stitched == shrink, bit for bit
    stitched = database.SnapshotCache(cfg, port_dbs[mode],
                                      device="cpu").apply(params, a)
    dev = shrink_from_stitched(cfg, stitched, port_dbs[mode], a)
    for ld, lg in zip(dev.layers, got.layers):
        assert ld.expert_ff == lg.expert_ff
        for (p1, t1), (p2, t2) in zip(_leaves(ld.params), _leaves(lg.params)):
            assert p1 == p2, p1
            assert (t1 is None and t2 is None) or torch.equal(t1, t2), p1
    # the pruned forward against the reference's, and against the masked
    # model once no token is dropped
    tokens = np.asarray(ref["calib"][0]["tokens"])
    np.testing.assert_allclose(
        forward_pruned(exact, torch.from_numpy(tokens)).numpy(),
        np.asarray(ref_forward_pruned(want, tokens)), atol=1e-4, rtol=1e-4)
    capacity_factor(NO_DROPS)
    masked = database.apply_assignment(cfg, params, port_dbs[mode], a)
    out = forward_pruned(got, torch.from_numpy(tokens))
    full = forward(cfg, masked, torch.from_numpy(tokens))["logits"]
    assert torch.isfinite(out).all()
    assert float((out - full).abs().max()) < 2e-2


@pytest.mark.parametrize("mode", MODES)
def test_pruned_prefill_and_decode_match_reference(ref, params, mode):
    cfg, rcfg = CFGS[mode], REF_CFGS[mode]
    a = _assignments(mode, "mixed")
    db = _port_db(ref["db"][mode])
    pm = shrink(cfg, params, db, a, device="cpu")
    rpm = ref_shrink(rcfg, ref["params"], ref["db"][mode], a)
    tokens = _tokens(2, 21, 4)
    log, cache = prefill_pruned(pm, torch.from_numpy(tokens), MAX_LEN)
    rlog, rcache = ref_prefill_pruned(rpm, jnp.asarray(tokens), MAX_LEN)
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), atol=1e-4,
                               rtol=1e-4)
    for step in range(4):
        nxt = log[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(
            nxt.numpy(), np.asarray(jnp.argmax(rlog[:, -1], -1)[:, None]))
        log, cache = decode_step_pruned(pm, cache, nxt)
        rlog, rcache = ref_decode_step_pruned(rpm, rcache,
                                              jnp.asarray(nxt.numpy()))
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog), atol=1e-4,
                                   rtol=1e-4, err_msg=f"step {step}")


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------

def _requests(n=8, seed=3):
    return synthetic_requests(CFG, n, seed=seed, rate=300.0,
                              prompt_lens=(5, 9, 13, 20), steps_range=(3, 8))


def _clock():
    """A scripted clock: every read advances 1 ms, so both packages'
    engines admit and batch the stream alike."""
    t = [0.0]

    def read():
        t[0] += 1e-3
        return t[0]
    return read


def _decode_alone(pm, tokens, steps):
    logits, cache = prefill_pruned(pm, torch.from_numpy(tokens[None]),
                                   MAX_LEN)
    toks = [int(logits[0, -1].argmax())]
    for _ in range(steps - 1):
        logits, cache = decode_step_pruned(pm, cache,
                                           torch.tensor([[toks[-1]]]))
        toks.append(int(logits[0, -1].argmax()))
    return toks


@pytest.mark.parametrize("mode", MODES)
def test_pruned_engine_is_token_exact(ref, params, mode):
    """A shrunk member (experts dropped and narrowed) serves each request
    the tokens it gets alone, and the reference's engine serves the same."""
    cfg, rcfg = CFGS[mode], REF_CFGS[mode]
    a = _assignments(mode, "mixed")
    pm = shrink(cfg, params, _port_db(ref["db"][mode]), a, device="cpu")
    reqs = _requests()
    report = ServeEngine(PrunedServeModel(pm, MAX_LEN), num_slots=4,
                         clock=_clock()).run(reqs)
    rpm = ref_shrink(rcfg, ref["params"], ref["db"][mode], a)
    rreport = RefServeEngine(RefPrunedServeModel(rpm, MAX_LEN), num_slots=4,
                             clock=_clock()).run(reqs)
    assert report.steps > 0
    for req, rec, rrec in zip(reqs, report.records, rreport.records):
        assert rec.tokens == _decode_alone(pm, req.tokens, req.steps)
        assert rec.tokens == rrec.tokens, f"rid={req.rid}"


def test_dense_engine_serves_the_reference_tokens(ref, params):
    """The dense MoE model served: the reference's engine's tokens."""
    reqs = _requests()
    report = ServeEngine(DenseServeModel(CFG, params, MAX_LEN), num_slots=4,
                         clock=_clock()).run(reqs)
    rreport = RefServeEngine(RefDenseServeModel(REF_MOE, ref["params"],
                                                MAX_LEN),
                             num_slots=4, clock=_clock()).run(reqs)
    for req, rec, rrec in zip(reqs, report.records, rreport.records):
        assert rec.tokens == rrec.tokens, f"rid={req.rid}"


def test_dense_engine_matches_per_request_decoding_without_drops(
        params, capacity_factor):
    capacity_factor(NO_DROPS)
    reqs = _requests()
    report = ServeEngine(DenseServeModel(CFG, params, MAX_LEN), num_slots=4,
                         clock=_clock()).run(reqs)
    for req, rec in zip(reqs, report.records):
        want = generate(CFG, params, torch.from_numpy(req.tokens[None]),
                        steps=req.steps, max_len=MAX_LEN)[0].tolist()
        assert rec.tokens == want, f"rid={req.rid}"


def test_dense_prefill_bucket_padding_changes_which_tokens_drop(
        ref, params, capacity_factor):
    """A fact of the reference that the port keeps: the dense engine
    prefills a prompt padded to its power-of-two bucket, and the padding
    raises the expert capacity (``capacity(bucket) >= capacity(s)``; the
    padding sorts after the prompt within an expert, so it never takes a
    prompt token's slot). A 9-token prompt that drops an assignment alone
    (capacity 8) keeps it in its 16-token bucket (capacity 16), so its
    first token's logits differ from per-request decoding's, in both
    packages alike. Without drops the two agree."""
    prompt = _tokens(1, 9, 1)
    padded = np.zeros((1, 16), np.int64)
    padded[0, :9] = prompt
    caps = forward(CFG, params, torch.from_numpy(prompt),
                   capture=True)["captures"]["ffn"]
    assert int(caps["wd_valid"].sum()) < 2 * 2 * 9  # drops alone

    def last_logits():
        alone = forward(CFG, params, torch.from_numpy(prompt))["logits"]
        bucket = forward(CFG, params, torch.from_numpy(padded))["logits"]
        return alone[:, -1], bucket[:, 8]

    alone, bucket = last_logits()
    assert float((alone - bucket).abs().max()) > 1e-3
    for got, toks, pos in ((alone, prompt, -1), (bucket, padded, 8)):
        want = np.asarray(ref_forward(REF_MOE, ref["params"],
                                      toks)["logits"])[:, pos]
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    capacity_factor(NO_DROPS)
    alone, bucket = last_logits()
    torch.testing.assert_close(alone, bucket, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("slots", [2, 4, 8])
def test_idle_slots_take_capacity_but_drop_no_active_token(params, slots):
    """The engine decodes every slot, idle ones too, so their tokens take
    expert capacity. With 8 slots or fewer no expert can overflow:
    capacity is at least 8 slots and a token takes at most one slot of an
    expert. So an active slot's logits do not depend on what the idle
    slots hold (at the full width of Phi-3.5-MoE too: 16 experts, top-2,
    capacity 8 for 8 slots)."""
    assert moe_mod.capacity(slots, CFG) >= slots
    assert moe_mod.capacity(slots, configs.PHI35_MOE) >= slots
    assert moe_mod.capacity(16, configs.PHI35_MOE) == 8  # 16 slots could
    outs = []
    for idle_tok in (0, 7):
        cache = init_cache(CFG, slots, MAX_LEN, per_slot=True, device="cpu")
        cache["pos"][:] = torch.arange(slots) + 3
        toks = torch.full((slots, 1), idle_tok)
        toks[0, 0] = 5
        outs.append(decode_step(CFG, params, cache, toks)[0][0])
    assert torch.equal(outs[0], outs[1])


# ----------------------------------------------------------------------
# one-shot end to end
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_oneshot_prune_end_to_end(params, capacity_factor, mode):
    """The slice on the CPU, as the reference's
    test_oneshot_e2e_new_unit_kinds runs it, in both modes and from one
    set of Hessians: every member meets its target, and its shrunk model
    gives its stitched model's outputs."""
    cfg = CFGS[mode]
    calib = calibration_batches(cfg, 4, 32, batch=4)
    hess = hessian.collect_hessians(cfg, params, calib, device="cpu")
    res = oneshot_prune(cfg, params, calib, InferenceEnv(hw=HW, **ENV_KW),
                        TARGETS, search_steps=20, search_pop=8, seed=0,
                        hessians=hess, device="cpu")
    assert "calibration" not in res.stage_seconds
    assert set(res.db) == {m.name for m in registry(cfg)}
    capacity_factor(NO_DROPS)
    tokens = calib[0]["tokens"]
    for t in TARGETS:
        v = res.variants[t]
        assert v.speedup >= t and np.isfinite(v.calib_loss)
        pm = shrink(cfg, v.params, res.db, v.assignment, device="cpu")
        err = (forward_pruned(pm, tokens)
               - forward(cfg, v.params, tokens)["logits"]).abs().max()
        assert float(err) < 2e-2
