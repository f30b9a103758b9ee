"""The port's shrink-and-serve slice against the JAX package, on gpt2-tiny
in fp32 with the reference's weights carried over by the weight bridge:

* the magnitude baseline database (orders, levels, snapshots);
* shrinking: leaves bit-equal to the reference's ``shrink``, equal
  parameter counts, the device-side ``shrink_from_stitched`` equal to
  ``shrink``, shrunk outputs against the masked model (2e-2, the
  reference's tests/test_shrink.py tolerance) and against the
  reference's pruned forward (1e-4: fp32 sums in different orders); an
  emptied GELU FFN's output bias, which the reference's shrink drops,
  kept (the only leaf the port adds), so that with a nonzero bias the
  shrunk model still gives the masked model's logits (1e-4);
* decode: one step with scalar and per-slot positions against the
  reference's (1e-4), greedy ``generate`` token for token with dense and
  flash attention, sampling seeded by a ``torch.Generator``;
* serving: the dense and pruned engines token-exact against per-request
  decoding, the cache-overflow checks, KV bytes against the reference's
  serve bench (``BENCH_db.json`` ``serve``: 589824, 294912 and 196608 B),
  family routing, metric attribution, and the CLI.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import GPT2_SMALL as REF_GPT2
from repro.core.latency import build_table as ref_build_table
from repro.core.magnitude import baseline_database as ref_baseline_database
from repro.core.magnitude import uniform_assignment as ref_uniform_assignment
from repro.core.shrink import kv_cache_plan as ref_kv_cache_plan
from repro.core.shrink import shrink as ref_shrink
from repro.models import generate as ref_generate
from repro.models import model_init as ref_model_init
from repro.models.pruned import forward_pruned as ref_forward_pruned
from repro.models.transformer import decode_step as ref_decode_step
from repro.models.transformer import init_cache as ref_init_cache
from repro.runtime.costmodel import TPU_V5E
from repro.runtime.costmodel import InferenceEnv as RefEnv
from repro.serve import PrunedServeModel as RefPrunedServeModel
from repro.serve import ServeEngine as RefServeEngine
from repro_torch.configs import ModelConfig
from repro_torch.core.database import SnapshotCache, apply_assignment
from repro_torch.core.latency import build_table
from repro_torch.core.magnitude import baseline_database, uniform_assignment
from repro_torch.core.shrink import (kv_cache_plan, layer_drop_plan, shrink,
                                     shrink_from_stitched)
from repro_torch.core.structures import drop_layer, registry
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as attn_mod
from repro_torch.models import decode_step, forward, generate, init_cache
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.pruned import (decode_step_pruned, forward_pruned,
                                       init_cache_pruned, kv_cache_bytes,
                                       prefill_pruned)
from repro_torch.runtime.costmodel import HardwareSpec, InferenceEnv
from repro_torch.serve import (DENSE_TARGET, DenseServeModel, FamilyServer,
                               PrunedServeModel, Request, ServeEngine,
                               synthetic_requests)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


MAX_LEN = 48
# tests/conftest.py's gpt2-tiny, and a llama-style variant (RoPE,
# RMSNorm, SwiGLU, 2 KV heads for 4 query heads, untied head)
REF_TINY = REF_GPT2.replace(
    name="gpt2-tiny", num_layers=2, d_model=64, d_ff=128, num_heads=4,
    num_kv_heads=4, head_dim=16, vocab_size=256, dtype="float32")
REF_LLAMA = REF_TINY.replace(name="llama-tiny", norm="rmsnorm",
                             pos_emb="rope", ffn_activation="swiglu",
                             num_kv_heads=2, tie_embeddings=False)
# the reference's serve bench model (benchmarks/run.py TINY)
REF_BENCH = REF_GPT2.replace(
    name="gpt2-tiny", num_layers=4, d_model=96, d_ff=384, num_heads=6,
    num_kv_heads=6, head_dim=16, vocab_size=384, dtype="float32")


def port_cfg(ref_cfg) -> ModelConfig:
    """The port's config of a reference config: every field but the JAX
    tracing and tiling options."""
    return ModelConfig(**{k: v for k, v in dataclasses.asdict(ref_cfg).items()
                          if k not in ("remat", "scan_layers", "flash_block_q",
                                       "flash_block_k")})


def bridge(ref_params):
    return params_from_numpy(jax.tree.map(np.asarray, ref_params),
                             device="cpu")


@pytest.fixture(scope="module")
def ref_params():
    return {name: ref_model_init(c, jax.random.key(0))[0]
            for name, c in (("gpt2", REF_TINY), ("llama", REF_LLAMA))}


@pytest.fixture(scope="module")
def tiny(ref_params):
    """(cfg, params, magnitude db) of the port on the reference's gpt2-tiny
    weights."""
    cfg = port_cfg(REF_TINY)
    params = bridge(ref_params["gpt2"])
    return cfg, params, baseline_database(cfg, params)


@pytest.fixture(scope="module")
def ref_db(ref_params):
    return ref_baseline_database(REF_TINY, ref_params["gpt2"])


def _assignment(kind: str):
    """Per-module levels: half the heads, a mixed prune, one module
    dropped, and a whole layer dropped."""
    if kind == "half_heads":
        return {"L0.attn": 2, "L1.attn": 2, "L0.ffn": 0, "L1.ffn": 0}
    if kind == "mixed":
        return {"L0.attn": 1, "L1.attn": 3, "L0.ffn": 40, "L1.ffn": 100}
    if kind == "module_drop":
        return {"L0.attn": 2, "L1.attn": 4, "L0.ffn": 100, "L1.ffn": 100}
    mods = registry(port_cfg(REF_TINY))
    return drop_layer({m.name: 0 for m in mods}, mods, 1)


ASSIGNMENTS = ["half_heads", "mixed", "module_drop", "layer_drop"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p, t) for k in sorted(tree)
                for p, t in _leaves(tree[k])]
    return [("", tree)]


def _prompts(cfg, n, s, seed):
    return synthetic_tokens(cfg.vocab_size, n, s, seed=seed)


# ----------------------------------------------------------------------
# magnitude baseline and shrinking
# ----------------------------------------------------------------------

def test_magnitude_database_matches_reference(tiny, ref_db):
    _, _, db = tiny
    assert list(db) == list(ref_db)
    for name, want in ref_db.items():
        got = db[name]
        np.testing.assert_array_equal(got.levels, want.levels)
        np.testing.assert_array_equal(got.order, want.order)
        np.testing.assert_array_equal(got.snapshots, want.snapshots)
        np.testing.assert_allclose(got.errors, want.errors, rtol=1e-12)
        np.testing.assert_allclose(got.priors, want.priors, rtol=1e-12)


def test_gqa_shrink_matches_reference(ref_params):
    """KV-head pruning on a GQA model: a removed KV group takes its query
    heads with it, and the cache plan follows."""
    cfg = port_cfg(REF_LLAMA)
    params = bridge(ref_params["llama"])
    db = baseline_database(cfg, params)
    ref_db = ref_baseline_database(REF_LLAMA, ref_params["llama"])
    a = {"L0.attn": 1, "L1.attn": 0, "L0.ffn": 40, "L1.ffn": 0}
    want = ref_shrink(REF_LLAMA, ref_params["llama"], ref_db, a)
    got = shrink(cfg, params, db, a, device="cpu")
    assert got.num_params() == want.num_params()
    assert [l.kv_groups for l in got.layers] == [1, 2]
    for lg, lw in zip(got.layers, want.layers):
        for (path, tg), (_, tw) in zip(
                _leaves(lg.params), _leaves(jax.tree.map(np.asarray,
                                                         lw.params))):
            np.testing.assert_array_equal(tg.numpy(), tw, err_msg=path)
    assert kv_cache_plan(cfg, db, a) == ref_kv_cache_plan(REF_LLAMA, ref_db,
                                                          a) == [1, 2]


@pytest.mark.parametrize("kind", ASSIGNMENTS)
def test_shrink_matches_reference(kind, tiny, ref_params, ref_db):
    cfg, params, db = tiny
    a = _assignment(kind)
    want = ref_shrink(REF_TINY, ref_params["gpt2"], ref_db, a)
    got = shrink(cfg, params, db, a, device="cpu")
    # an emptied GELU FFN keeps its output bias, which the reference's
    # shrink drops: the only leaf the port's shrunk model adds
    emptied = [l for l, lg in enumerate(got.layers) if lg.d_ff == 0]
    assert got.num_params() == want.num_params() + cfg.d_model * len(emptied)
    assert got.num_params() < sum(t.numel() for _, t in _leaves(params))
    for l, (lg, lw) in enumerate(zip(got.layers, want.layers)):
        assert (lg.kv_groups, lg.d_ff) == (lw.kv_groups, lw.d_ff)
        g, w = _leaves(lg.params), _leaves(jax.tree.map(np.asarray,
                                                       lw.params))
        if l in emptied:
            assert [p for p, _ in g if p.startswith("ffn")] == ["ffn/bd/"]
            assert torch.equal(lg.params["ffn"]["bd"],
                               params["layers"]["ffn"]["bd"][l])
            g = [(p, t) for p, t in g if p != "ffn/bd/"]
        assert [p for p, _ in g] == [p for p, _ in w]
        for (path, tg), (_, tw) in zip(g, w):
            np.testing.assert_array_equal(tg.numpy(), tw, err_msg=path)
    assert kv_cache_plan(cfg, db, a) == ref_kv_cache_plan(REF_TINY, ref_db, a)
    assert layer_drop_plan(cfg, a) == [kind == "layer_drop" and l == 1
                                       for l in range(cfg.num_layers)]


@pytest.mark.parametrize("kind", ASSIGNMENTS)
def test_shrunk_outputs_match_masked(kind, tiny):
    cfg, params, db = tiny
    a = _assignment(kind)
    masked = apply_assignment(cfg, params, db, a)
    pm = shrink(cfg, masked, db, a, device="cpu")
    tokens = torch.from_numpy(_prompts(cfg, 2, 24, seed=4))
    got = forward_pruned(pm, tokens)
    masked_logits = forward(cfg, masked, tokens)["logits"]
    assert float((got - masked_logits).abs().max()) < 2e-2


@pytest.mark.parametrize("kind", ["ffn_drop", "layer_drop"])
def test_emptied_ffn_keeps_its_output_bias(kind, tiny):
    """A GELU FFN with every row removed still adds its output bias in the
    masked model (its zeroed wd rows leave y = bd), and a finetune makes
    that bias nonzero: the shrunk model, from ``shrink`` and from
    ``shrink_from_stitched``, gives the masked model's logits (1e-4, fp32)
    in its forward, its prefill and each decode step."""
    cfg, params, db = tiny
    a = ({"L0.attn": 1, "L1.attn": 0, "L0.ffn": cfg.d_ff, "L1.ffn": 40}
         if kind == "ffn_drop" else _assignment("layer_drop"))
    rng = np.random.default_rng(7)
    moved = {**params, "layers": {
        **params["layers"], "ffn": {
            **params["layers"]["ffn"],
            "bd": torch.from_numpy(rng.standard_normal(
                tuple(params["layers"]["ffn"]["bd"].shape)).astype(
                    np.float32))}}}
    masked = apply_assignment(cfg, moved, db, a)
    stitched = SnapshotCache(cfg, db, device="cpu").apply(moved, a)
    tokens = torch.from_numpy(_prompts(cfg, 2, 24, seed=4))
    want = forward(cfg, masked, tokens)["logits"]
    for pm in (shrink(cfg, masked, db, a, device="cpu"),
               shrink_from_stitched(cfg, stitched, db, a)):
        assert any(l.d_ff == 0 and "ffn" in l.params for l in pm.layers)
        np.testing.assert_allclose(forward_pruned(pm, tokens).numpy(),
                                   want.numpy(), atol=1e-4, rtol=1e-4)
        s = 16
        logits, cache = prefill_pruned(pm, tokens[:, :s], MAX_LEN)
        for t in range(s, tokens.shape[1]):
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       want[:, t - 1].numpy(), atol=1e-4,
                                       rtol=1e-4)
            logits, cache = decode_step_pruned(pm, cache, tokens[:, t:t + 1])


def test_shrunk_outputs_match_reference(tiny, ref_params, ref_db):
    cfg, params, db = tiny
    a = _assignment("mixed")
    tokens = _prompts(cfg, 2, 24, seed=4)
    got = forward_pruned(shrink(cfg, params, db, a, device="cpu"),
                         torch.from_numpy(tokens))
    want = ref_forward_pruned(ref_shrink(REF_TINY, ref_params["gpt2"],
                                         ref_db, a), jnp.asarray(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_shrink_from_stitched_equals_shrink(tiny):
    cfg, params, db = tiny
    a = _assignment("mixed")
    host = shrink(cfg, params, db, a, device="cpu")
    stitched = SnapshotCache(cfg, db, device="cpu").apply(params, a)
    dev = shrink_from_stitched(cfg, stitched, db, a)
    for lh, ld in zip(host.layers, dev.layers):
        assert (lh.kv_groups, lh.d_ff) == (ld.kv_groups, ld.d_ff)
        for (ph, th), (pd, td) in zip(_leaves(lh.params), _leaves(ld.params)):
            assert ph == pd and torch.equal(th, td), ph
    for (ph, th), (pd, td) in zip(_leaves(host.globals_),
                                  _leaves(dev.globals_)):
        assert ph == pd and torch.equal(th, td), ph


def test_head_pruned_model_runs_when_the_head_dim_is_derived(ref_params):
    """GPT-2 small leaves ``head_dim`` 0 (derived from d_model / heads).
    The reference's pruned runtime derives it again from a layer's shrunk
    head count and cannot run such a model; the port pins it."""
    ref_cfg = REF_TINY.replace(head_dim=0)
    cfg = port_cfg(ref_cfg)
    params = bridge(ref_params["gpt2"])
    db = baseline_database(cfg, params)
    a = _assignment("mixed")
    masked = apply_assignment(cfg, params, db, a)
    pm = shrink(cfg, masked, db, a, device="cpu")
    tokens = _prompts(cfg, 2, 16, seed=6)
    got = forward_pruned(pm, torch.from_numpy(tokens))
    want = forward(cfg, masked, torch.from_numpy(tokens))["logits"]
    assert float((got - want).abs().max()) < 2e-2
    ref_pm = ref_shrink(ref_cfg, ref_params["gpt2"],
                        ref_baseline_database(ref_cfg, ref_params["gpt2"]), a)
    with pytest.raises(TypeError, match="reshape"):
        ref_forward_pruned(ref_pm, jnp.asarray(tokens))


def test_pruned_runtime_rejects_unported_layers(tiny):
    """Pruned MoE and hybrid layers run in ``forward_pruned`` now
    (tests/test_torch_moe.py, tests/test_torch_hybrid.py); the pruned
    *decode* runtime still refuses a hybrid model, as the reference's
    ``_check_decodable`` does."""
    cfg, params, db = tiny
    pm = shrink(cfg, params, db, _assignment("half_heads"), device="cpu")
    pm.cfg = cfg.replace(hybrid=True, ssm_state=16)
    assert forward_pruned(pm, torch.zeros((1, 4), dtype=torch.long)).shape \
        == (1, 4, cfg.vocab_size)
    with pytest.raises(NotImplementedError, match="hybrid"):
        init_cache_pruned(pm, 1, 16)
    with pytest.raises(NotImplementedError, match="hybrid"):
        prefill_pruned(pm, torch.zeros((1, 4), dtype=torch.long), 16)


# ----------------------------------------------------------------------
# decode and generate against the reference
# ----------------------------------------------------------------------

DECODE_CASES = {"gpt2": ("gpt2", {}), "llama": ("llama", {}),
                "llama-window": ("llama", {"attention": "sliding_window",
                                           "window_size": 6})}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_step_matches_reference(case, per_slot, ref_params):
    name, extra = DECODE_CASES[case]
    ref_cfg = (REF_TINY if name == "gpt2" else REF_LLAMA).replace(**extra)
    cfg = port_cfg(ref_cfg)
    rp = ref_params[name]
    b, sc = 3, 8
    rng = np.random.default_rng(1)
    cache_np = {k: rng.standard_normal(
        (cfg.num_layers, b, sc, cfg.num_kv_heads, cfg.head_dim)
    ).astype(np.float32) for k in ("k", "v")}
    pos = np.array([2, 9, 5]) if per_slot else np.array(5)
    toks = rng.integers(0, cfg.vocab_size, (b, 1))
    ref_cache = ref_init_cache(ref_cfg, b, sc, per_slot=per_slot)
    ref_cache["attn"] = {k: jnp.asarray(v) for k, v in cache_np.items()}
    ref_cache["pos"] = jnp.asarray(pos, jnp.int32)
    want, want_cache = ref_decode_step(ref_cfg, rp, ref_cache,
                                       jnp.asarray(toks, jnp.int32))
    cache = init_cache(cfg, b, sc, per_slot=per_slot, device="cpu")
    cache["attn"] = {k: torch.from_numpy(v.copy())
                     for k, v in cache_np.items()}
    cache["pos"] = torch.as_tensor(pos)
    got, got_cache = decode_step(cfg, bridge(rp), cache,
                                 torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(got_cache["attn"][k].numpy(),
                                   np.asarray(want_cache["attn"][k]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got_cache["pos"].numpy(), pos + 1)


def test_decode_step_past_the_position_table_matches_reference(ref_params):
    """A serving slot that sits idle is still decoded, and its position
    runs on past the learned position table. The reference's ``jnp.take``
    then reads NaN for that row; the port must do the same, not fail the
    whole batch (on the card: a device-side assert)."""
    cfg, rp = port_cfg(REF_TINY), ref_params["gpt2"]
    b, sc = 3, 8
    rng = np.random.default_rng(2)
    cache_np = {k: rng.standard_normal(
        (cfg.num_layers, b, sc, cfg.num_kv_heads, cfg.head_dim)
    ).astype(np.float32) for k in ("k", "v")}
    pos = np.array([5, cfg.max_position, cfg.max_position + 7])
    toks = rng.integers(0, cfg.vocab_size, (b, 1))
    ref_cache = ref_init_cache(REF_TINY, b, sc, per_slot=True)
    ref_cache["attn"] = {k: jnp.asarray(v) for k, v in cache_np.items()}
    ref_cache["pos"] = jnp.asarray(pos, jnp.int32)
    want, want_cache = ref_decode_step(REF_TINY, rp, ref_cache,
                                       jnp.asarray(toks, jnp.int32))
    cache = init_cache(cfg, b, sc, per_slot=True, device="cpu")
    cache["attn"] = {k: torch.from_numpy(v.copy())
                     for k, v in cache_np.items()}
    cache["pos"] = torch.as_tensor(pos)
    got, got_cache = decode_step(cfg, bridge(rp), cache,
                                 torch.from_numpy(toks))
    assert np.isfinite(got[0].numpy()).all()
    assert np.isnan(got[1:].numpy()).all() and np.isnan(np.asarray(want[1:])).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(got_cache["attn"][k].numpy(),
                                   np.asarray(want_cache["attn"][k]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["gpt2", "llama"])
@pytest.mark.parametrize("impl", ["auto", "flash_lax"])
def test_greedy_generate_matches_reference(name, impl, ref_params):
    ref_cfg = (REF_TINY if name == "gpt2" else REF_LLAMA).replace(
        attn_impl=impl)
    prompt = _prompts(ref_cfg, 2, 12, seed=7)
    want = ref_generate(ref_cfg, ref_params[name], jnp.asarray(prompt),
                        steps=10)
    got = generate(port_cfg(ref_cfg), bridge(ref_params[name]),
                   torch.from_numpy(prompt), steps=10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_is_deterministic_in_its_generator(tiny):
    cfg, params, _ = tiny
    prompt = torch.from_numpy(_prompts(cfg, 2, 8, seed=2))

    def sample(seed):
        return generate(cfg, params, prompt, steps=8, temperature=2.0,
                        generator=torch.Generator().manual_seed(seed))

    greedy = generate(cfg, params, prompt, steps=8)
    assert torch.equal(sample(0), sample(0))
    assert not torch.equal(sample(0), sample(1))
    assert not torch.equal(sample(0), greedy)


def test_top_k_1_sampling_is_greedy(tiny):
    cfg, params, _ = tiny
    prompt = torch.from_numpy(_prompts(cfg, 2, 8, seed=2))
    greedy = generate(cfg, params, prompt, steps=6)
    topk1 = generate(cfg, params, prompt, steps=6, top_k=1,
                     generator=torch.Generator().manual_seed(7))
    assert torch.equal(greedy, topk1)


# ----------------------------------------------------------------------
# serving engine
# ----------------------------------------------------------------------

def _requests(cfg, n=6, seed=3):
    return synthetic_requests(cfg, n, seed=seed, rate=300.0,
                              prompt_lens=(5, 9, 13), steps_range=(3, 8))


def _decode_alone(pm, tokens, steps):
    """Per-request greedy decoding on the pruned runtime (no engine)."""
    logits, cache = prefill_pruned(pm, torch.from_numpy(tokens[None]),
                                   MAX_LEN)
    toks = [int(logits[0, -1].argmax())]
    for _ in range(steps - 1):
        logits, cache = decode_step_pruned(pm, cache,
                                           torch.tensor([[toks[-1]]]))
        toks.append(int(logits[0, -1].argmax()))
    return toks


@pytest.mark.parametrize("member", ["dense", "pruned"])
def test_engine_is_token_exact_against_per_request_decoding(member, tiny):
    """Staggered arrivals, mixed prompt lengths and slot reuse (6 requests
    through 2 slots) give each request the tokens it gets alone."""
    cfg, params, db = tiny
    reqs = _requests(cfg)
    assert len({r.prompt_len for r in reqs}) > 1
    if member == "dense":
        model = DenseServeModel(cfg, params, MAX_LEN)
        alone = [generate(cfg, params, torch.from_numpy(r.tokens[None]),
                          steps=r.steps, max_len=MAX_LEN)[0].tolist()
                 for r in reqs]
    else:
        pm = shrink(cfg, params, db, _assignment("mixed"), device="cpu")
        model = PrunedServeModel(pm, MAX_LEN)
        alone = [_decode_alone(pm, r.tokens, r.steps) for r in reqs]
    eng = ServeEngine(model, num_slots=2)
    eng.warmup((8, 16))
    report = eng.run(reqs)
    assert report.steps > 0
    for req, rec, want in zip(reqs, report.records, alone):
        assert rec.tokens == want, f"rid={req.rid}"
        assert rec.finish >= rec.arrival


@pytest.mark.parametrize("member", ["dense", "pruned"])
def test_engine_keeps_serving_while_an_idle_slot_runs_past_the_positions(
        member, tiny):
    """Requests far apart reuse slot 0 alone; every decode step still
    decodes slot 1, whose position passes the learned position table
    (here MAX_LEN rows) after 48 steps and whose cache row then takes NaN
    keys and values. Last, two requests arrive together, so slot 1 takes
    the second one after 60 such steps. The served tokens stay those each
    request gets alone."""
    cfg, params, db = tiny
    cfg = cfg.replace(max_position=MAX_LEN)
    params = {**params, "embed": {**params["embed"],
                                  "pos": params["embed"]["pos"][:MAX_LEN]}}
    prompts = _prompts(cfg, 7, 9, seed=11)
    reqs = [Request(rid=i, tokens=prompts[i], steps=13,
                    arrival=10.0 * min(i, 5)) for i in range(7)]
    if member == "dense":
        model = DenseServeModel(cfg, params, MAX_LEN)
        alone = [generate(cfg, params, torch.from_numpy(r.tokens[None]),
                          steps=r.steps, max_len=MAX_LEN)[0].tolist()
                 for r in reqs]
    else:
        pm = shrink(cfg, params, db, _assignment("mixed"), device="cpu")
        model = PrunedServeModel(pm, MAX_LEN)
        alone = [_decode_alone(pm, r.tokens, r.steps) for r in reqs]
    report = ServeEngine(model, num_slots=2).run(reqs)
    assert report.steps == 6 * 12 and 5 * 12 > MAX_LEN
    for req, rec, want in zip(reqs, report.records, alone):
        assert rec.tokens == want, f"rid={req.rid}"


@pytest.mark.parametrize("member", ["dense", "pruned"])
def test_engine_prefill_takes_the_flash_path_whatever_attn_impl(
        member, tiny, monkeypatch):
    """A config left at ``attn_impl="auto"`` (dense below 2048 tokens)
    still prefills through flash in the engine: one chunked flash call per
    attention layer and prompt, the kernel on the card."""
    cfg, params, db = tiny
    assert cfg.attn_impl == "auto"
    calls = []
    real = attn_mod.flash_attention_chunked
    monkeypatch.setattr(attn_mod, "flash_attention_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    if member == "dense":
        model = DenseServeModel(cfg, params, MAX_LEN)
    else:
        model = PrunedServeModel(
            shrink(cfg, params, db, _assignment("mixed"), device="cpu"),
            MAX_LEN)
    logits, _ = model.prefill(_prompts(cfg, 1, 9, seed=0)[0])
    assert model.cfg.attn_impl == "flash_lax"
    assert len(calls) == cfg.num_layers  # "mixed" keeps heads in each layer
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("where", ["generate", "engine", "prefill_pruned"])
def test_cache_overflow_raises(where, tiny):
    cfg, params, db = tiny
    prompt = torch.from_numpy(_prompts(cfg, 1, 40, seed=1))
    if where == "generate":
        with pytest.raises(RuntimeError, match="overflows the KV cache"):
            generate(cfg, params, prompt[:, :4], steps=20, max_len=8)
    elif where == "engine":
        eng = ServeEngine(DenseServeModel(cfg, params, MAX_LEN), num_slots=2)
        bad = Request(rid=0, tokens=prompt[0].numpy(),
                      steps=MAX_LEN - 40 + 1, arrival=0.0)
        with pytest.raises(RuntimeError, match="overflows the KV cache"):
            eng.run([bad])
    else:
        pm = shrink(cfg, params, db, _assignment("mixed"), device="cpu")
        with pytest.raises(RuntimeError, match="exceeds cache max_len"):
            prefill_pruned(pm, prompt, max_len=32)


# KV heads per layer -> bytes of the reference's serve bench (4 slots,
# max_len 48, fp32): the 1x, 1.5x and 2x members
BENCH_KV_BYTES = {6: 589824, 3: 294912, 2: 196608}


@pytest.fixture(scope="module")
def bench():
    """(cfg, params, db, ref params, ref db) of the serve bench model."""
    ref_params = ref_model_init(REF_BENCH, jax.random.key(0))[0]
    cfg = port_cfg(REF_BENCH)
    params = bridge(ref_params)
    return (cfg, params, baseline_database(cfg, params), ref_params,
            ref_baseline_database(REF_BENCH, ref_params))


@pytest.mark.parametrize("heads", sorted(BENCH_KV_BYTES))
def test_kv_cache_bytes_match_the_reference_bench(heads, bench):
    cfg, params, db, ref_params, ref_db = bench
    a = {m.name: (cfg.num_kv_heads - heads if m.kind == "attn" else 0)
         for m in registry(cfg)}
    pm = shrink(cfg, params, db, a, device="cpu")
    eng = ServeEngine(PrunedServeModel(pm, MAX_LEN), num_slots=4)
    ref_eng = RefServeEngine(RefPrunedServeModel(
        ref_shrink(REF_BENCH, ref_params, ref_db, a), MAX_LEN), num_slots=4)
    assert kv_cache_plan(cfg, db, a) == [heads] * cfg.num_layers
    assert eng.kv_cache_bytes == kv_cache_bytes(pm, 4, MAX_LEN) \
        == ref_eng.kv_cache_bytes == BENCH_KV_BYTES[heads]
    if heads == cfg.num_kv_heads:
        dense = ServeEngine(DenseServeModel(cfg, params, MAX_LEN),
                            num_slots=4)
        assert dense.kv_cache_bytes == BENCH_KV_BYTES[heads]


def test_family_routes_to_the_smallest_member_that_meets_the_class(
        tiny, ref_params, ref_db):
    cfg, params, db = tiny
    hw = HardwareSpec(**dataclasses.asdict(TPU_V5E))
    table = build_table(cfg, InferenceEnv(batch=2, seq=32, mode="prefill",
                                          hw=hw), device="cpu")
    ref_table = ref_build_table(REF_TINY, RefEnv(batch=2, seq=32,
                                                 mode="prefill", hw=TPU_V5E),
                                backend="costmodel")
    assignments = {t: uniform_assignment(cfg, table, t) for t in (1.5, 2.0)}
    for t, a in assignments.items():
        assert a == ref_uniform_assignment(REF_TINY, ref_table, t)
    srv = FamilyServer(cfg, params, db, assignments, max_len=32, num_slots=2)
    assert srv.route("relaxed") == DENSE_TARGET  # dense qualifies
    assert srv.route("standard") == 1.5  # the smallest target meeting 1.5x
    assert srv.route("strict") == 2.0
    srv.warmup((8,))
    reqs = synthetic_requests(cfg, 6, seed=2, rate=300.0, prompt_lens=(5, 9),
                              steps_range=(2, 5))
    reports = srv.run(reqs)
    assert sum(len(r.records) for r in reports.values()) == len(reqs)
    for target, rep in reports.items():
        for rec in rep.records:
            assert srv.route(rec.latency_class) == target


def test_metrics_attribute_prefill_and_decode_separately(tiny):
    """With a scripted clock ticking 1 ms per reading, every prefill and
    every decode step accounts exactly one tick."""
    cfg, params, _ = tiny
    ticks = iter(range(10 ** 6))
    eng = ServeEngine(DenseServeModel(cfg, params, MAX_LEN), num_slots=2,
                      clock=lambda: next(ticks) * 1e-3)
    eng.warmup((8, 16))
    report = eng.run(_requests(cfg, n=3, seed=5))
    for rec in report.records:
        assert rec.prefill_ms == pytest.approx(1.0)
        for dms in rec.decode_step_ms:
            assert dms == pytest.approx(1.0)


def test_serve_cli_runs_on_the_cpu_when_asked(monkeypatch, capsys):
    monkeypatch.setitem(serve_cli.ARCHS, "gpt2-tiny", port_cfg(REF_TINY))
    m = serve_cli.main(["--arch", "gpt2-tiny", "--device", "cpu",
                        "--requests", "3", "--slots", "2", "--max-len", "32"])
    assert m["requests"] == 3 and m["total_tokens"] > 0
    assert "[serve] gpt2-tiny on cpu" in capsys.readouterr().out
