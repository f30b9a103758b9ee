"""The port's mesh trainer with int8 error feedback (ROADMAP Queue 1 item
6c) against its single-process trainer and the JAX package, on the CPU.

The reference trains over a mesh with ``jit_train_step`` and
``shard_map`` on forced 2- and 8-device hosts (``tests/test_sharding.py``
and ``tests/test_trainer_sharded.py``, tier 2). The port runs one
process per rank: each multi-process check here is one of three launches
of 2 gloo ranks of one thread (``launch.subproc.run_ranks``) on the
reference tests' ``gpt2-tiny`` (fp32), from a module-scoped fixture, and
each test function reads one check of it. The ranks import neither JAX
nor the JAX package (``tests/test_torch_guards.py`` parses the
``*_SCRIPT`` sources); the reference's weights, its compressed
all-reduce's inputs and outputs and a single-process checkpoint reach
them through files. One more launch runs the reference's own mesh
trainer (fp32 and int8_ef) in a subprocess on 2 forced CPU devices
(``run_forced_devices``, as the reference's tests do), and the port's
2-rank trainers are held against it.

In process: ``model_specs`` against the reference's ``model_init(...)[1]``
for every config, the partition-spec rules against the reference's on
stand-in meshes (the helpers read only ``shape`` and ``axis_names``;
``NamedSharding`` is replaced by its spec), ``MeshConfig``, a rank's
slices, ``train_state_from_numpy`` with residuals, and the refusals.

Bounds, the reference tests' own, unloosened: the fp32 mesh trainer
within 1e-4 of the single-process params and 1e-3 of its losses; the
int8 residual one row a rank, nonzero and changed every step, the last
int8 loss within 0.15 of fp32's and below its first; ``logit_kl`` above
0; ``int8_ef_compress`` bit-equal to the reference's under ``jax.vmap``
over a leading shard axis, and its mean within 5% relative. Checkpoints
cross between 2 ranks and 1 process bit for bit, and a killed and
resumed mesh family equals an uninterrupted one bit for bit with rank 0
its only writer. Against the reference's mesh trainer: losses within
1e-3 at every step, fp32 params within 1e-4, and the update within 1e-3
of the reference's, relative (``UPDATE_GAP`` says why int8_ef's params
are held by that and not by 1e-4).
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import GPT2_SMALL as REF_GPT2
from repro.configs import base as ref_base
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.distributed import sharding as ref_sharding
from repro.launch.subproc import run_forced_devices
from repro.models import model_init as ref_model_init
from repro.optim.compression import int8_ef_compress as ref_int8_ef_compress
from repro.train.train_step import make_train_state as ref_make_train_state
from repro_torch import configs
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            restore_pytree, save_pytree)
from repro_torch.configs import GPT2_SMALL
from repro_torch.configs.base import (MULTI_POD, SINGLE_POD, MeshConfig,
                                      TrainConfig)
from repro_torch.data import synthetic_stream
from repro_torch.distributed import (Mesh, batch_axes, batch_sharding,
                                     cache_shardings, logical_to_pspec,
                                     mesh_config_for, param_shardings,
                                     shard_of)
from repro_torch.launch.subproc import run_ranks
from repro_torch.models import model_init, model_specs, param_shapes
from repro_torch.models.convert import (params_from_numpy,
                                        train_state_from_numpy)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import Trainer, make_train_step
from repro_torch.train.train_step import make_train_state, state_shardings

# the reference tests' TINY
TINY_KW = dict(name="gpt2-tiny", num_layers=2, d_model=64, d_ff=128,
               num_heads=4, num_kv_heads=4, head_dim=16, vocab_size=256,
               dtype="float32")
REF_TINY = REF_GPT2.replace(**TINY_KW)
CFG = GPT2_SMALL.replace(**TINY_KW)
LAUNCH_TIMEOUT = 300
# the reference's trainer test: 12 steps of 8 x 32, 2 microbatches,
# distilled from a second draw
N_STEPS = 12
TCFG_KW = dict(learning_rate=1e-3, total_steps=N_STEPS, warmup_steps=2,
               microbatches=2, distill_logit=1.0, distill_token=0.5)
# the compressed all-reduce's leaves (a leading shard axis of 2 added)
COMPRESS_SHAPES = {"a": (16,), "b": {"c": (3, 5, 7), "d": (64, 33)}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ref_mesh(shape, axes):
    """A stand-in for a JAX mesh of ``shape`` (the test process has one
    device): the spec helpers read only ``shape`` and ``axis_names``."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=tuple(axes))


def _flat(tree, prefix=""):
    """{path: leaf} of a tree of dicts (a tuple is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _entries(pspec):
    """A reference ``PartitionSpec`` as the port's tuple of entries."""
    return tuple(pspec)


# ---------------------------------------------------------------------------
# in process: specs, partition specs, MeshConfig, slices, conversions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_specs():
    """The reference's ``model_init(...)[1]`` of every config at smoke
    size, flattened."""
    return {name: _flat(ref_model_init(ref_configs.smoke_config(name),
                                       jax.random.key(0))[1])
            for name in configs.ARCHS}


@pytest.mark.parametrize("name", sorted(configs.ARCHS))
def test_model_specs_match_the_reference(ref_specs, name):
    cfg = configs.smoke_config(name)
    got = _flat(model_specs(cfg))
    assert got == {k: tuple(v) for k, v in ref_specs[name].items()}
    shapes = _flat(param_shapes(cfg))
    assert shapes == {k: tuple(v.shape) for k, v in
                      _flat(model_init(cfg, device="cpu")).items()}


MESHES = [((2,), ("data",)), ((4, 2), ("data", "model")),
          ((2, 4), ("data", "model"))]
PROFILES = [dict(profile="tp_fsdp"), dict(profile="pure_fsdp"),
            dict(profile="tp_fsdp", fsdp=False),
            dict(profile="pure_fsdp", fsdp=False)]


@pytest.mark.parametrize("shape,axes", MESHES)
def test_partition_specs_match_the_reference(ref_specs, monkeypatch, shape,
                                             axes):
    """``logical_to_pspec`` and ``param_shardings`` over every leaf of
    every config, for each profile; ``NamedSharding`` is replaced by its
    spec so that the reference's helpers run on a stand-in mesh."""
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda m, p: p)
    mesh, ref = Mesh(shape, axes), ref_mesh(shape, axes)
    ref_params, ref_tiny_specs = ref_model_init(REF_TINY, jax.random.key(0))
    ref_params = jax.tree.map(np.asarray, ref_params)
    # tensor parallelism needs a "model" axis (both packages raise a
    # KeyError without one)
    for kw in [k for k in PROFILES
               if "model" in axes or k["profile"] == "pure_fsdp"]:
        mc = MeshConfig(shape=shape, axes=axes, **kw)
        rmc = ref_base.MeshConfig(shape=shape, axes=axes, **kw)
        for name in configs.ARCHS:
            cfg = configs.smoke_config(name)
            specs, shapes = model_specs(cfg), param_shapes(cfg)
            got = _flat(param_shardings(mesh, mc, shapes, specs))
            for path, spec in ref_specs[name].items():
                leaf_shape = _flat(shapes)[path]
                want = _entries(ref_sharding.logical_to_pspec(
                    tuple(spec), leaf_shape, ref, rmc))
                assert logical_to_pspec(spec, leaf_shape, mesh, mc) == want
                assert got[path] == want, (name, path, kw)
        # the reference's param_shardings over arrays, on one config
        want = _flat(jax.tree.map(
            _entries, ref_sharding.param_shardings(
                ref, rmc, ref_params, ref_tiny_specs),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        got = _flat(param_shardings(mesh, mc, params_from_numpy(
            ref_params, device="cpu"), model_specs(CFG)))
        assert got == want


@pytest.mark.parametrize("shape,axes", MESHES)
def test_batch_and_mesh_config_helpers_match_the_reference(monkeypatch,
                                                           shape, axes):
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda m, p: p)
    mesh, ref = Mesh(shape, axes), ref_mesh(shape, axes)
    for kw in PROFILES:
        mc = MeshConfig(shape=shape, axes=axes, **kw)
        rmc = ref_base.MeshConfig(shape=shape, axes=axes, **kw)
        for batch in (1, 2, 3, 4, 6, 8, 12, 16):
            want = ref_sharding.batch_axes(ref, rmc, batch)
            assert batch_axes(mesh, mc, batch) == want
            assert batch_axes(mesh, mc.data_axes, batch) == want
            assert batch_sharding(mesh, mc, batch) == _entries(
                ref_sharding.batch_sharding(ref, rmc, batch))
    got, want = mesh_config_for(mesh), ref_sharding.mesh_config_for(ref)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got = mesh_config_for(mesh, fsdp=False, profile="pure_fsdp")
    want = ref_sharding.mesh_config_for(ref, fsdp=False, profile="pure_fsdp")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data_axes == want.data_axes


# decode caches of several layouts: attention KV (L, B, S, H, D), SSM
# state (L, B, H, P, N), SSM conv (L, B, K-1, C), a position, lists
CACHE = {"attn": {"k": np.zeros((2, 8, 64, 4, 16)),
                  "v": np.zeros((2, 6, 30, 8, 16))},
         "ssm": {"state": np.zeros((2, 4, 6, 16, 8)),
                 "conv": np.zeros((2, 8, 3, 48))},
         "pos": np.zeros((8,), np.int32), "step": np.zeros(()),
         "cross": [np.zeros((1, 2, 100, 2, 64)), np.zeros((3, 1, 7, 5, 3))]}


@pytest.mark.parametrize("shape,axes", MESHES[1:])
@pytest.mark.parametrize("seq_shard_kv", [True, False])
def test_cache_shardings_match_the_reference(monkeypatch, shape, axes,
                                             seq_shard_kv):
    monkeypatch.setattr(ref_sharding, "NamedSharding", lambda m, p: p)
    mesh, ref = Mesh(shape, axes), ref_mesh(shape, axes)
    for profile in ("tp_fsdp", "pure_fsdp"):
        kw = dict(shape=shape, axes=axes, seq_shard_kv=seq_shard_kv,
                  profile=profile)
        want = ref_sharding.cache_shardings(None, ref,
                                            ref_base.MeshConfig(**kw), CACHE)
        got = cache_shardings(None, mesh, MeshConfig(**kw), CACHE)
        want = jax.tree.map(
            _entries, want,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert got == want


def test_mesh_config_matches_the_reference():
    for ours, theirs in ((MeshConfig(), ref_base.MeshConfig()),
                         (SINGLE_POD, ref_base.SINGLE_POD),
                         (MULTI_POD, ref_base.MULTI_POD),
                         (MeshConfig(profile="pure_fsdp"),
                          ref_base.MeshConfig(profile="pure_fsdp"))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.data_axes == theirs.data_axes
        assert ours.num_devices == theirs.num_devices


@pytest.mark.parametrize("shape,axes", MESHES)
def test_each_rank_slice_is_its_part_of_the_whole(shape, axes):
    """``shard_of`` over every rank of a mesh partitions each leaf: the
    slices, laid back by their indices, are the whole."""
    mc = mesh_config_for(Mesh(shape, axes))
    n = int(np.prod(shape))
    params = model_init(CFG, device="cpu")
    specs = _flat(param_shardings(Mesh(shape, axes), mc, params,
                                  model_specs(CFG)))
    for path, whole in _flat(params).items():
        spec = specs[path]
        sharded = {a for e in spec if e is not None
                   for a in ((e,) if isinstance(e, str) else e)}
        copies = n // int(np.prod([shape[axes.index(a)] for a in sharded]))
        seen = torch.zeros(whole.shape, dtype=torch.int64)
        for rank in range(n):
            mesh = Mesh(shape, axes, rank=rank)
            idx = _index(whole, spec, mesh)
            assert torch.equal(shard_of(whole, spec, mesh), whole[idx])
            seen[idx] += 1
        assert bool((seen == copies).all()), (path, spec)


def _index(whole, spec, mesh):
    """The slice of ``whole`` that ``mesh``'s rank holds under
    ``spec``."""
    idx = []
    for d in range(whole.dim()):
        a = spec[d] if d < len(spec) else None
        if a is None:
            idx.append(slice(None))
            continue
        axes = (a,) if isinstance(a, str) else a
        size = whole.shape[d] // int(np.prod([mesh.shape[x] for x in axes]))
        i = mesh.index(a)
        idx.append(slice(i * size, (i + 1) * size))
    return tuple(idx)


def test_train_state_from_numpy_takes_the_residual_row():
    """The reference's state with int8 residuals (made on a stand-in
    2-shard mesh, then filled with draws) comes over whole, or as a
    rank's row."""
    params = ref_model_init(REF_TINY, jax.random.key(0))[0]
    tcfg = RefTrainConfig(grad_compression="int8_ef")
    ref_state = ref_make_train_state(
        REF_TINY, params, tcfg, mesh=ref_mesh((2,), ("data",)),
        mc=ref_base.MeshConfig(shape=(2,), axes=("data",),
                               profile="pure_fsdp"))
    rng = np.random.default_rng(0)
    ef = jax.tree.map(lambda e: rng.standard_normal(e.shape).astype(
        np.float32), ref_state.ef_err)
    state = jax.tree.map(np.asarray, ref_state._replace(ef_err=ef))
    whole = train_state_from_numpy(state, device="cpu")
    for a, b in zip(tree_leaves(whole.ef_err), jax.tree.leaves(ef)):
        assert a.shape[0] == 2 and np.array_equal(a.numpy(), b)
    for rank in range(2):
        row = train_state_from_numpy(state, device="cpu",
                                     mesh=Mesh((2,), ("data",), rank=rank))
        for a, b in zip(tree_leaves(row.ef_err), jax.tree.leaves(ef)):
            assert a.shape[0] == 1 and np.array_equal(a.numpy(),
                                                      b[rank:rank + 1])
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(row.params), tree_leaves(whole.params)))


def test_state_shardings_keep_residual_rows_over_the_data_axes():
    mesh = Mesh((2,), ("data",))
    mc = mesh_config_for(mesh)
    params = model_init(CFG, device="cpu")
    state = make_train_state(CFG, params, TrainConfig(
        grad_compression="int8_ef"), mesh=mesh, mc=mc)
    sh = state_shardings(mesh, mc, state, model_specs(CFG))
    assert all(s == ("data",) for s in _flat(sh.ef_err).values())
    assert sh.opt["m"] == sh.params == sh.opt["v"]
    assert sh.step == () and sh.opt["count"] == ()
    assert all(e.shape[0] == 2 for e in tree_leaves(state.ef_err))


def test_the_mesh_trainer_needs_specs_and_no_model_axis(tmp_path):
    tcfg = TrainConfig()
    with pytest.raises(ValueError, match="specs"):
        make_train_step(CFG, tcfg, mesh=Mesh((2,), ("data",)),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="item 6d"):
        make_train_step(CFG, tcfg, mesh=Mesh((2, 2), ("data", "model")),
                        specs=model_specs(CFG), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6d"):
        Trainer(CFG, tcfg, ckpt_dir=str(tmp_path),
                mesh=Mesh((2, 2), ("data", "model")),
                specs=model_specs(CFG), device="cpu")
    with pytest.raises(ValueError, match="int8_ef"):
        make_train_step(CFG, TrainConfig(grad_compression="int8_ef"),
                        device="cpu")


# ---------------------------------------------------------------------------
# the ranks: inputs, and three launches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's weights and teacher (as port checkpoints), the
    reference's compressed all-reduce on two steps of drawn gradients,
    and a single-process checkpoint after 3 steps."""
    d = tmp_path_factory.mktemp("mesh_train")
    for name, seed in (("params", 0), ("teacher", 1)):
        p = ref_model_init(REF_TINY, jax.random.key(seed))[0]
        save_pytree(params_from_numpy(jax.tree.map(np.asarray, p),
                                      device="cpu"), str(d / f"{name}.npz"))
    rng = np.random.default_rng(0)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.standard_normal((2,) + s)
                * rng.uniform(0.1, 10)).astype(np.float32)

    g1, g2 = draw(COMPRESS_SHAPES), draw(COMPRESS_SHAPES)
    step = jax.vmap(lambda g, e: ref_int8_ef_compress(g, e, ("data",)),
                    axis_name="data")
    a1, e1 = step(g1, jax.tree.map(jnp.zeros_like, g1))
    a2, e2 = step(g2, e1)
    arrays = {}
    for tag, tree in (("g1", g1), ("g2", g2), ("a1", a1), ("e1", e1),
                      ("a2", a2), ("e2", e2)):
        arrays.update({tag + k: np.asarray(v) for k, v in _flat(tree).items()})
    np.savez(d / "compress.npz", **arrays)
    # a single-process checkpoint at step 3, for the ranks to restore
    tr = Trainer(CFG, TrainConfig(**TCFG_KW), ckpt_dir=str(d / "ckpt_one"),
                 ckpt_every=3, teacher_params=restore_pytree(
                     model_init(CFG, device="cpu"), str(d / "teacher.npz")),
                 device="cpu")
    st = tr.init_or_restore(restore_pytree(model_init(CFG, device="cpu"),
                                           str(d / "params.npz")))
    tr.fit(st, synthetic_stream(CFG, 8, 32, seed=3), steps=3)
    tr.ckpt.close()
    return d


# every rank's first lines: the gloo group, the tiny config, the
# reference's weights and teacher, a 2-rank mesh
PRELUDE_SCRIPT = r"""
import dataclasses, json, os, tempfile

import numpy as np
import torch

from repro_torch.checkpoint.manager import restore_pytree, save_pytree
from repro_torch.configs import GPT2_SMALL
from repro_torch.configs.base import TrainConfig
from repro_torch.data import synthetic_stream
from repro_torch.distributed import gather_tree, make_mesh
from repro_torch.launch.subproc import emit_result, init_rank
from repro_torch.models import model_init, model_specs
from repro_torch.optim.adamw import tree_leaves

rank, world, dev = init_rank(timeout=120)
CFG = GPT2_SMALL.replace(**TINY_KW)
params = restore_pytree(model_init(CFG, device="cpu"), DIR + "/params.npz")
teacher = restore_pytree(model_init(CFG, device="cpu"), DIR + "/teacher.npz")
mesh = make_mesh((world,), ("data",))
# a directory every rank shares: the first rank's
shared = mesh.broadcast_object(tempfile.mkdtemp() if rank == 0 else None)
"""

TRAIN_SCRIPT = r"""
from repro_torch.optim.compression import int8_ef_compress
from repro_torch.train import Trainer

out = {"rank": rank}


def trainer(compression, on_mesh, ckpt_dir=None, **kw):
    tcfg = TrainConfig(**TCFG_KW, grad_compression=compression)
    return Trainer(CFG, tcfg, ckpt_dir=ckpt_dir or tempfile.mkdtemp(),
                   log_every=1, teacher_params=teacher,
                   mesh=mesh if on_mesh else None,
                   specs=model_specs(CFG) if on_mesh else None,
                   device="cpu", **kw)


# fp32 over the mesh, writing its last step's checkpoint to a shared dir
fp = trainer("none", True, ckpt_dir=shared + "/fp32", ckpt_every=100)
st = fp.fit(fp.init_or_restore(params), synthetic_stream(CFG, 8, 32, seed=3),
            steps=N_STEPS)
fp.ckpt.close()
whole = gather_tree(st, fp._st_sh, mesh)
if rank == 0:
    save_pytree(whole, DIR + "/mesh_state.npz")
out["fp32"] = [m["loss"] for m in fp.metrics_log]
out["kl"] = [m["logit_kl"] for m in fp.metrics_log]
out["fp32_dir"] = shared + "/fp32"
out["slices"] = sum(p.numel() for p in tree_leaves(st.params)) < sum(
    p.numel() for p in tree_leaves(params))

# the single-process trainer on the same inputs
one = trainer("none", False, ckpt_every=100)
st1 = one.fit(one.init_or_restore(params),
              synthetic_stream(CFG, 8, 32, seed=3), steps=N_STEPS,
              save_last=False)
out["single"] = [m["loss"] for m in one.metrics_log]
out["param_maxdiff"] = max(float((a - b).abs().max()) for a, b in zip(
    tree_leaves(whole.params), tree_leaves(st1.params)))

# int8_ef, one step a fit, the residuals probed after each
c = trainer("int8_ef", True, ckpt_dir=shared + "/int8", ckpt_every=100)
stc = c.init_or_restore(params)
data = synthetic_stream(CFG, 8, 32, seed=3)
rows, nonzero, changed = set(), [], []
for k in range(N_STEPS):
    prev = [e.clone() for e in tree_leaves(stc.ef_err)]
    stc = c.fit(stc, data, steps=k + 1, save_last=k + 1 == N_STEPS)
    now = tree_leaves(stc.ef_err)
    rows |= {int(e.shape[0]) for e in now}
    nonzero.append(any(bool((e != 0).any()) for e in now))
    changed.append(any(not torch.equal(a, b) for a, b in zip(prev, now)))
c.ckpt.close()
whole_c = gather_tree(stc.params, c._st_sh.params, mesh)
if rank == 0:
    save_pytree(whole_c, DIR + "/int8_params.npz")
out["int8"] = [m["loss"] for m in c.metrics_log]
out["rows"], out["nonzero"], out["changed"] = sorted(rows), nonzero, changed
out["int8_dir"] = shared + "/int8"
np.savez(DIR + f"/ef{rank}.npz",
         **{str(i): e.numpy() for i, e in enumerate(tree_leaves(stc.ef_err))})

# the compressed all-reduce on the reference's drawn gradients
z = np.load(DIR + "/compress.npz")


def tree(tag):
    return {"a": torch.from_numpy(z[tag + "/a"][rank]),
            "b": {"c": torch.from_numpy(z[tag + "/b/c"][rank]),
                  "d": torch.from_numpy(z[tag + "/b/d"][rank])}}


err = {"a": torch.zeros(16), "b": {"c": torch.zeros(3, 5, 7),
                                   "d": torch.zeros(64, 33)}}
a1, e1 = int8_ef_compress(tree("g1"), err, mesh, ("data",))
a2, e2 = int8_ef_compress(tree("g2"), e1, mesh, ("data",))
same = True
for tag, got in (("a1", a1), ("e1", e1), ("a2", a2), ("e2", e2)):
    for path, t in (("/a", got["a"]), ("/b/c", got["b"]["c"]),
                    ("/b/d", got["b"]["d"])):
        same = same and np.array_equal(t.numpy(), z[tag + path][rank])
out["compress_bit_equal"] = bool(same)
mean = (z["g1/a"].mean(0), z["g1/b/c"].mean(0), z["g1/b/d"].mean(0))
out["compress_rel"] = max(
    float(np.abs(t.numpy() - m).max() / (np.abs(m).max() + 1e-9))
    for t, m in zip((a1["a"], a1["b"]["c"], a1["b"]["d"]), mean))

# a single-process checkpoint restored on the ranks, each its slices
r = trainer("none", True, ckpt_dir=DIR + "/ckpt_one")
rs = r.init_or_restore(params)
want = restore_pytree(gather_tree(rs, r._st_sh, mesh), DIR + "/ckpt_one/"
                      + "step_00000003.npz")
got = gather_tree(rs, r._st_sh, mesh)
out["restored_step"] = int(rs.step)
out["restored_bit_equal"] = all(
    torch.equal(a, b) for a, b in zip(tree_leaves(got.params)
                                      + tree_leaves(got.opt["m"])
                                      + tree_leaves(got.opt["v"]),
                                      tree_leaves(want.params)
                                      + tree_leaves(want.opt["m"])
                                      + tree_leaves(want.opt["v"])))
out["restored_slices"] = sum(p.numel() for p in tree_leaves(rs.params)) < sum(
    p.numel() for p in tree_leaves(params))
emit_result(out)
"""

FAMILY_SCRIPT = r"""
import builtins, hashlib, io, shutil

from repro_torch.core.pipeline import (FamilyPreempted, family_run_dir,
                                       gradual_prune)
from repro_torch.data import calibration_batches
from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv

calib = calibration_batches(CFG, 16, 64, batch=8)
ENV = InferenceEnv(batch=8, seq=64, mode="prefill", hw=H100_SXM)
TARGETS = [1.5, 2.0]
writes = []


def audit(root):
    # every Python-level write under root, by path
    def note(p):
        p = os.path.abspath(os.fsdecode(p))
        if p.startswith(root):
            writes.append(p)

    real_open = builtins.open

    def opener(f, mode="r", *a, **k):
        if isinstance(f, (str, bytes, os.PathLike)) and any(
                c in mode for c in "wax+"):
            note(f)
        return real_open(f, mode, *a, **k)

    builtins.open = io.open = opener
    for mod, names in ((os, ("replace", "rename", "remove", "unlink",
                             "makedirs", "mkdir", "rmdir")),
                       (shutil, ("rmtree",))):
        for n in names:
            def call(p, *a, _fn=getattr(mod, n), **k):
                note(p)
                return _fn(p, *a, **k)
            setattr(mod, n, call)


def go(base, **kw):
    return gradual_prune(
        CFG, params, ENV, TARGETS,
        lambda step: synthetic_stream(CFG, 8, 64, seed=99, start_step=step),
        calib, tcfg=TrainConfig(learning_rate=5e-4, warmup_steps=2,
                                total_steps=8, distill_logit=1.0,
                                distill_token=0.5),
        finetune_steps=8, search_steps=4, search_pop=4, ckpt_every=4,
        ckpt_dir=base, seed=0, mesh=mesh, device="cpu", **kw)


def digest(fam):
    h = hashlib.sha256()
    for v in fam:
        h.update(json.dumps([v.target, v.achieved, v.assignment,
                             v.loss_before_ft, v.loss_after_ft]).encode())
        for t in tree_leaves(v.params):
            h.update(t.numpy().tobytes())
    return h.hexdigest()


def manifest(base):
    with open(family_run_dir(CFG, TARGETS, 0, base) + "/family.json") as f:
        m = json.load(f)
    return ({t: {k: v for k, v in e.items() if k.endswith("sha256")}
             for t, e in m["targets"].items()},
            [(e["run"], e["target"], e["stage"]) for e in m["executed"]])


audit(os.path.abspath(shared))
specs = model_specs(CFG)
a = go(shared + "/a", specs=specs)
try:
    go(shared + "/b", specs=specs, stop_after=(0, "finetune", 6))
    killed = False
except FamilyPreempted:
    killed = True
b = go(shared + "/b", specs=specs)
# without specs: calibration-only sharding, each rank the same
# single-process finetune, the first rank alone checkpointing
c = go(shared + "/c")
emit_result({"rank": rank, "killed": killed, "a": digest(a),
             "b": digest(b), "c": digest(c),
             "assignments": [v.assignment for v in a],
             "achieved": [v.achieved for v in a],
             "manifest_a": manifest(shared + "/a"),
             "manifest_b": manifest(shared + "/b"),
             "writes": len(writes)})
"""

CLI_SCRIPT = r"""
import contextlib, io

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch import train

ckpt = shared + "/cli"
runs = []
for extra in (["--steps", "4"], ["--steps", "6"],
              ["--steps", "3", "--grad-compression", "int8_ef",
               "--ckpt-dir", shared + "/cli_int8"]):
    args = ["--arch", "gpt2-small", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "16", "--ckpt-every", "2",
            "--ckpt-dir", ckpt] + extra
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(args)
    runs.append({"rc": rc, "out": buf.getvalue()})
emit_result({"rank": rank, "runs": runs,
             "latest": CheckpointManager(ckpt, async_save=False,
                                         mesh=mesh).latest_step(),
             "latest_int8": CheckpointManager(
                 shared + "/cli_int8", async_save=False,
                 mesh=mesh).latest_step()})
"""


def rank_script(body: str, d) -> str:
    """``body`` after the prelude, with the inputs' directory, the tiny
    config's fields and the trainer's settings."""
    return (f"DIR = {str(d)!r}\nTINY_KW = {TINY_KW!r}\n"
            f"TCFG_KW = {TCFG_KW!r}\nN_STEPS = {N_STEPS}\n"
            + PRELUDE_SCRIPT + body)


@pytest.fixture(scope="module")
def train_run(inputs):
    return run_ranks(rank_script(TRAIN_SCRIPT, inputs), 2, device="cpu",
                     timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module")
def family_run(inputs):
    return run_ranks(rank_script(FAMILY_SCRIPT, inputs), 2, device="cpu",
                     timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module")
def cli_run(inputs):
    return run_ranks(rank_script(CLI_SCRIPT, inputs), 2, device="cpu",
                     timeout=LAUNCH_TIMEOUT)


# the reference's mesh trainer (jit_train_step over a (2,) data mesh) on 2
# forced CPU devices, fp32 and int8_ef, with TRAIN_SCRIPT's settings;
# its final params go to files (leaves in the reference's tree order)
REFERENCE_MESH_RUN = r"""
import json, tempfile

import jax
import numpy as np

from repro.configs import GPT2_SMALL
from repro.configs.base import TrainConfig
from repro.data import synthetic_stream
from repro.distributed.sharding import make_mesh, mesh_config_for
from repro.models import model_init
from repro.train.trainer import Trainer

TINY = GPT2_SMALL.replace(**TINY_KW)
params, specs = model_init(TINY, jax.random.key(0))
teacher, _ = model_init(TINY, jax.random.key(1))
mesh = make_mesh((2,), ("data",))
out = {"devices": jax.device_count()}
for compression in ("none", "int8_ef"):
    tr = Trainer(TINY, TrainConfig(**TCFG_KW, grad_compression=compression),
                 ckpt_dir=tempfile.mkdtemp(), ckpt_every=100, log_every=1,
                 teacher_params=teacher, mesh=mesh,
                 mc=mesh_config_for(mesh), specs=specs)
    st = tr.fit(tr.init_or_restore(params),
                synthetic_stream(TINY, 8, 32, seed=3), steps=N_STEPS)
    out[compression] = [m["loss"] for m in tr.metrics_log]
    np.savez(DIR + f"/ref_{compression}.npz",
             **{str(i): np.asarray(x)
                for i, x in enumerate(jax.tree.leaves(st.params))})
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_mesh_run(inputs):
    """The reference's fp32 and int8_ef mesh trainers' losses, and their
    final params as port trees."""
    out = run_forced_devices(
        f"DIR = {str(inputs)!r}\nTINY_KW = {TINY_KW!r}\n"
        f"TCFG_KW = {TCFG_KW!r}\nN_STEPS = {N_STEPS}\n"
        + REFERENCE_MESH_RUN, 2, timeout=LAUNCH_TIMEOUT)
    treedef = jax.tree.structure(ref_model_init(REF_TINY,
                                                jax.random.key(0))[0])
    for compression in ("none", "int8_ef"):
        with np.load(inputs / f"ref_{compression}.npz") as f:
            leaves = [f[str(i)] for i in range(len(f.files))]
        out[compression + "_params"] = params_from_numpy(
            jax.tree.unflatten(treedef, leaves), device="cpu")
    return out


# ---------------------------------------------------------------------------
# the mesh trainer (tests/test_trainer_sharded.py's bounds)
# ---------------------------------------------------------------------------

def test_fp32_mesh_trainer_matches_the_single_process_trainer(train_run):
    for r in train_run:
        assert r["param_maxdiff"] < 1e-4, r["param_maxdiff"]
        assert r["fp32"] == pytest.approx(r["single"], abs=1e-3)
    assert train_run[0]["fp32"] == train_run[1]["fp32"]


def _port_mesh_params(inputs, compression):
    """The port's 2-rank trainer's final params, whole (rank 0's files)."""
    if compression == "none":
        template = make_train_state(CFG, model_init(CFG, device="cpu"),
                                    TrainConfig(**TCFG_KW))
        return restore_pytree(template,
                              str(inputs / "mesh_state.npz")).params
    return restore_pytree(model_init(CFG, device="cpu"),
                          str(inputs / "int8_params.npz"))


# the update's relative gap |d_port - d_ref| / |d_ref| over the 12 steps
# (d: the params' change): fp32 9.5e-7; int8_ef 2.6e-4, where a rounding
# tie that reduction order resolves the other way moves a weight by a
# quantum (65 of 148480 weights more than 1e-5 apart, the largest
# 1.14e-4, above the fp32 params bound)
UPDATE_GAP = 1e-3


@pytest.mark.parametrize("compression,key", [("none", "fp32"),
                                             ("int8_ef", "int8")])
def test_mesh_trainer_matches_the_references_mesh_trainer(
        train_run, reference_mesh_run, inputs, compression, key):
    """The port's 2-rank trainer against the reference's jit_train_step
    over a (2,) data mesh on 2 forced CPU devices, on the same weights,
    teacher and batches: losses within 1e-3 at every step, fp32 params
    within 1e-4 (the reference test's bounds), and the update within
    ``UPDATE_GAP`` of the reference's, relative."""
    ref = reference_mesh_run
    assert ref["devices"] == 2
    for r in train_run:
        assert r[key] == pytest.approx(ref[compression], abs=1e-3)
    got = _flat(_port_mesh_params(inputs, compression))
    want = _flat(ref[compression + "_params"])
    init = _flat(restore_pytree(model_init(CFG, device="cpu"),
                                str(inputs / "params.npz")))
    assert got.keys() == want.keys()
    gap = sum(float(((got[k] - want[k]).double() ** 2).sum()) for k in got)
    update = sum(float(((want[k] - init[k]).double() ** 2).sum())
                 for k in got)
    assert (gap / update) ** 0.5 < UPDATE_GAP, (gap / update) ** 0.5
    if compression == "none":
        diff = max(float((got[k] - want[k]).abs().max()) for k in got)
        assert diff < 1e-4, diff


def _chip_smoke():
    import importlib
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("frac,want", [(1.0, 0.0), (0.0, 1.0), (0.5, 0.5),
                                       (-1.0, 2.0)])
def test_chip_smoke_update_gap_over_a_ranks_slices(rank, frac, want):
    """chip_smoke's phase 18 (f) measure on a stand-in 2-rank mesh: a
    rank that applied ``frac`` of the single-process update is
    ``|1 - frac|`` from it, relative, over its slices."""
    cs = _chip_smoke()
    mesh = Mesh((2,), ("data",), rank=rank)
    g = torch.Generator().manual_seed(0)
    init = {"w": torch.randn(4, 3, generator=g),
            "b": {"c": torch.randn(3, generator=g)}}
    step = {"w": torch.randn(4, 3, generator=g),
            "b": {"c": torch.randn(3, generator=g)}}
    specs = {"w": ("data", None), "b": {"c": (None,)}}
    one = {k: (init_t + step_t).numpy() for (k, init_t), (_, step_t) in
           zip(cs.tree_paths(init), cs.tree_paths(step))}
    got = {"w": shard_of(init["w"] + frac * step["w"], specs["w"], mesh),
           "b": {"c": init["b"]["c"] + frac * step["b"]["c"]}}
    diff, sums = cs.mesh_update_gap(torch, got, one, init, specs, mesh)
    assert cs.update_rel(sums) == pytest.approx(want, abs=1e-6)
    assert diff == pytest.approx(float(max(
        (abs(1 - frac) * shard_of(step["w"], specs["w"], mesh)).abs().max(),
        (abs(1 - frac) * step["b"]["c"]).abs().max())), rel=1e-5)
    assert cs.grad_norm_gaps([2.0, 3.0], [2.0, 4.0]) == [0.0, 0.25]


def test_mesh_trainer_logs_distill_metrics(train_run):
    for r in train_run:
        assert len(r["kl"]) == N_STEPS and all(k > 0 for k in r["kl"])


def test_each_rank_holds_only_its_slices(train_run):
    for r in train_run:
        assert r["slices"] and r["restored_slices"]


def test_int8_ef_residual_is_one_row_a_rank_and_updated_every_step(
        train_run):
    for r in train_run:
        assert r["rows"] == [1]
        assert all(r["nonzero"]) and all(r["changed"])


def test_int8_ef_tracks_fp32_and_converges(train_run):
    for r in train_run:
        assert abs(r["fp32"][-1] - r["int8"][-1]) < 0.15, (r["fp32"][-1],
                                                           r["int8"][-1])
        assert r["int8"][-1] < r["int8"][0]


def test_int8_ef_compress_is_the_references_bit_for_bit(train_run):
    for r in train_run:
        assert r["compress_bit_equal"]


def test_int8_ef_compress_mean_within_five_percent(train_run):
    for r in train_run:
        assert r["compress_rel"] < 0.05, r["compress_rel"]


# ---------------------------------------------------------------------------
# checkpoints across meshes
# ---------------------------------------------------------------------------

def test_a_checkpoint_of_two_ranks_restores_in_one_process(train_run,
                                                          inputs):
    """The first rank's file holds the gathered whole state: one process
    restores it bit for bit (the residual rows have no template there)."""
    d = train_run[0]["fp32_dir"]
    ck = CheckpointManager(d, async_save=False)
    assert ck.latest_step() == N_STEPS
    template = make_train_state(CFG, model_init(CFG, device="cpu"),
                                TrainConfig(**TCFG_KW))
    got = ck.restore(template)
    want = restore_pytree(template, str(inputs / "mesh_state.npz"))
    for part in (lambda s: s.params, lambda s: s.opt["m"],
                 lambda s: s.opt["v"]):
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(part(got)), tree_leaves(part(want))))
    assert int(got.step) == N_STEPS and got.ef_err is None


def test_a_checkpoint_of_two_ranks_keeps_every_residual_row(train_run,
                                                           inputs):
    d = train_run[0]["int8_dir"]
    with np.load(os.path.join(d, f"step_{N_STEPS:08d}.npz")) as f:
        ef = {k: f[k] for k in f.files if k.startswith("ef_err/")}
    rows = [np.load(inputs / f"ef{r}.npz") for r in range(2)]
    assert ef and all(v.shape[0] == 2 for v in ef.values())
    for i, key in enumerate(sorted(ef)):
        for r in range(2):
            assert np.array_equal(ef[key][r:r + 1], rows[r][str(i)])


def test_a_single_process_checkpoint_restores_on_two_ranks(train_run):
    for r in train_run:
        assert r["restored_step"] == 3
        assert r["restored_bit_equal"]


# ---------------------------------------------------------------------------
# gradual_prune(mesh=, specs=)
# ---------------------------------------------------------------------------

def test_mesh_family_killed_and_resumed_is_bit_equal(family_run):
    for r in family_run:
        assert r["killed"]
        assert r["a"] == r["b"]
        assert r["manifest_a"][0] == r["manifest_b"][0]
    assert family_run[0]["a"] == family_run[1]["a"]


def test_mesh_family_resume_runs_only_the_inflight_finetune(family_run):
    executed = family_run[0]["manifest_b"][1]
    assert [tuple(e[1:]) for e in executed if e[0] == 2] == [
        ("1.5", "finetune"), ("2", "hessians"), ("2", "db"),
        ("2", "search"), ("2", "finetune")]


def test_mesh_family_meets_its_targets(family_run):
    r = family_run[0]
    assert all(a >= t for a, t in zip(r["achieved"], [1.5, 2.0]))


def test_rank_zero_is_the_only_writer(family_run):
    assert family_run[0]["writes"] > 0  # the audit sees the writes
    assert family_run[1]["writes"] == 0


def test_mesh_family_without_specs_runs_on_every_rank(family_run):
    assert family_run[0]["c"] == family_run[1]["c"]


# ---------------------------------------------------------------------------
# launch/train.py under run_ranks
# ---------------------------------------------------------------------------

def test_train_cli_runs_over_ranks(cli_run):
    for r in cli_run:
        first, second, int8 = r["runs"]
        assert [x["rc"] for x in r["runs"]] == [0, 0, 0]
        assert "2 ranks" in first["out"]
        assert "done at step 4" in first["out"]
        assert "resumed from step 4" in second["out"]
        assert "done at step 6" in second["out"]
        assert "done at step 3" in int8["out"]
        assert r["latest"] == 6 and r["latest_int8"] == 3
