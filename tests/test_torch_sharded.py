"""The port's sharded calibration, database and one-shot entry point
(ROADMAP Queue 1 item 6a) against its single-process path and the JAX
package, on the CPU.

The reference shards with ``shard_map`` on forced 2-device hosts
(``tests/test_sharded_calibration.py``, ``tests/test_sharded_db.py``,
tier 2). The port runs one process per rank: every multi-process check
here runs 2 gloo ranks of one thread each, through
``launch.subproc.run_ranks``, on the reference tests' ``gpt2-tiny``
(fp32). Each group of checks is one launch from a module-scoped
fixture, and each test function reads one check of it. The ranks import
neither JAX nor the JAX package (``tests/test_torch_guards.py`` parses
the ``*_SCRIPT`` sources); the weights and the reference's Hessians and
orders reach them through ``.npz`` files.

Bounds, the reference tests' own: Hessians within 1e-5 of max |H| of the
single-process path's and of the reference's ``collect_hessians``;
databases from sharded and single-process Hessians with identical orders
and errors within rtol 1e-4, atol 1e-6; the context-discovered mesh
exactly the explicit mesh's Hessians; ragged batches bit-equal to the
single-process path; sharded databases (plain, compacted and ragged)
bit-identical to the single-process build; fed the reference's
Hessians, the reference's removal orders. The fault sites: a
``calib.batch`` fault on one rank skips that batch on both, equal to a
clean run without it; ``db.sharded_group:raise@0`` demotes bit-equal,
with one trip on each rank; ``obs.cholesky:nan@0`` heals at the
single-process build's rung, bit-equal. ``oneshot_prune(mesh=)`` gives
both ranks the single-process assignments.
"""
import dataclasses
import os
import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import GPT2_SMALL as REF_GPT2
from repro.configs.base import MeshConfig
from repro.core.database import build_database as ref_build_database
from repro.core.hessian import collect_hessians as ref_collect_hessians
from repro.core.structures import registry as ref_registry
from repro.data import calibration_batches as ref_calibration_batches
from repro.distributed import sharding as ref_sharding
from repro.models import model_init as ref_model_init
from repro_torch.checkpoint.manager import save_pytree
from repro_torch.configs import GPT2_SMALL, ModelConfig
from repro_torch.data import calibration_batches
from repro_torch.distributed import (Mesh, activation_context, axis_size,
                                     batch_axes, data_axes_for,
                                     get_activation_context, make_mesh,
                                     pad_leading)
from repro_torch.launch import subproc
from repro_torch.launch.subproc import run_ranks
from repro_torch.models.convert import params_from_numpy

# the JAX package's tracing and tiling options, which the port's config
# does not carry
JAX_EXECUTION = ("remat", "scan_layers", "flash_block_q", "flash_block_k")
# the reference tests' TINY
TINY_KW = dict(name="gpt2-tiny", num_layers=2, d_model=64, d_ff=128,
               num_heads=4, num_kv_heads=4, head_dim=16, vocab_size=256,
               dtype="float32")
REF_TINY = REF_GPT2.replace(**TINY_KW)
CFG = GPT2_SMALL.replace(**TINY_KW)
LAUNCH_TIMEOUT = 240


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's torch CPU ops on one thread: its tensors are
    small, and with the test workers sharing the cores each op's thread
    pool otherwise waits on the others (minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# what every rank of the calibration and database groups runs first: the
# gloo group, the tiny config, the reference's weights, a 2-rank mesh
PRELUDE_SCRIPT = r"""
import numpy as np
import torch

from repro_torch.checkpoint.manager import restore_pytree
from repro_torch.configs import GPT2_SMALL
from repro_torch.distributed import make_mesh
from repro_torch.launch.subproc import emit_result, init_rank
from repro_torch.models import model_init

rank, world, dev = init_rank(timeout=120)
CFG = GPT2_SMALL.replace(**TINY_KW)
params = restore_pytree(model_init(CFG, device="cpu"), DIR + "/params.npz")
mesh = make_mesh((world,), ("data",))


def load(name):
    with np.load(DIR + "/" + name) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def same_db(a, b):
    return all(np.array_equal(getattr(a[k], f), getattr(b[k], f))
               for k in a for f in ("snapshots", "errors", "order"))
"""

CALIB_SCRIPT = r"""
import hashlib

from repro_torch.core.database import build_database
from repro_torch.core.hessian import collect_hessians
from repro_torch.data import calibration_batches
from repro_torch.distributed import activation_context, get_activation_context
from repro_torch.robustness import FaultPlan, install, report_scope

calib = calibration_batches(CFG, 16, 64, batch=8)


def rel(h, ref):
    return max(float((h[k] - ref[k]).abs().max() / ref[k].abs().max())
               for k in ref)


def exact(a, b):
    return list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)


out = {}
h_one = collect_hessians(CFG, params, calib, device=dev)
h_sh = collect_hessians(CFG, params, calib, mesh=mesh, device=dev)
out["keys"] = list(h_sh) == list(h_one)
out["rel_single"] = rel(h_sh, h_one)
out["rel_reference"] = rel(h_sh, load("ref_hessians.npz"))
out["digest"] = hashlib.sha256(b"".join(
    h_sh[k].numpy().tobytes() for k in h_sh)).hexdigest()
db_one = build_database(CFG, params, h_one, device=dev)
db_sh = build_database(CFG, params, h_sh, device=dev)
out["orders_equal"] = all(np.array_equal(db_one[k].order, db_sh[k].order)
                          for k in db_one)
out["errors_close"] = all(np.allclose(db_one[k].errors, db_sh[k].errors,
                                      rtol=1e-4, atol=1e-6) for k in db_one)
with activation_context(mesh, ("data",)):
    h_ctx = collect_hessians(CFG, params, calib, device=dev)
    out["context_kept"] = get_activation_context() == (mesh, ("data",))
out["context_restored"] = get_activation_context() == (None, None)
out["context_exact"] = exact(h_ctx, h_sh)
ragged = calibration_batches(CFG, 11, 64, batch=4)  # the last batch of 3
out["ragged_exact"] = exact(
    collect_hessians(CFG, params, ragged, mesh=mesh, device=dev),
    collect_hessians(CFG, params, ragged, device=dev))
# NaN in the second batch's captures on rank 1 only: both ranks skip it
plan = FaultPlan.parse("calib.batch:nan@1") if rank == 1 else None
with install(plan), report_scope() as rep:
    h_fault = collect_hessians(CFG, params, calib, mesh=mesh, device=dev)
out["fault_counts"] = rep.as_dict()["counts"]
out["fault_exact"] = exact(
    h_fault, collect_hessians(CFG, params, calib[:1], mesh=mesh, device=dev))
emit_result(out)
"""

DB_SCRIPT = r"""
from repro_torch.core import spdy
from repro_torch.core.database import build_database
from repro_torch.core.oneshot import oneshot_prune
from repro_torch.data import calibration_batches
from repro_torch.robustness import FaultPlan, install, report_scope
from repro_torch.runtime.costmodel import H100_SXM, InferenceEnv

h = load("db_hessians.npz")
out = {}
for name, kw in (("plain", {}), ("compact", {"compact": True}),
                 ("ragged", {"max_batch": 3})):
    one = build_database(CFG, params, h, device=dev, **kw)
    out[name] = same_db(one, build_database(CFG, params, h, mesh=mesh,
                                            device=dev, **kw))
    if name == "plain":
        db_one = one
sh = build_database(CFG, params, h, mesh=mesh, device=dev)
ref_orders = load("ref_orders.npz")
out["reference_orders"] = all(np.array_equal(sh[k].order, ref_orders[k])
                              for k in sh)
# a fault at the site on rank 1 only: both ranks demote the first chunk,
# and the open breaker keeps the second single-process too
plan = FaultPlan.parse("db.sharded_group:raise@0") if rank == 1 else None
with install(plan), report_scope() as rep:
    demoted = build_database(CFG, params, h, mesh=mesh, device=dev)
out["demoted_exact"] = same_db(demoted, db_one)
out["demotion_counts"] = rep.as_dict()["counts"]
out["breaker_open"] = rep.breaker_open("db.sharded_group")
out["site_hits"] = plan.hits.get("db.sharded_group") if plan else None
healed = {}
for key, m in (("sharded", mesh), ("single", None)):
    with install(FaultPlan.parse("obs.cholesky:nan@0")), \
            report_scope() as rep:
        healed[key] = build_database(CFG, params, h, mesh=m, device=dev)
    out["heal_counts_" + key] = rep.as_dict()["counts"]
out["healed_exact"] = same_db(healed["sharded"], healed["single"])
env = InferenceEnv(batch=1, seq=64, hw=H100_SXM)
calib = calibration_batches(CFG, 16, 64, batch=8)
kw = dict(search_steps=16, search_pop=8, seed=0, device=dev)
res = {key: oneshot_prune(CFG, params, calib, env, [1.5, 2.0], mesh=m,
                          **kw) for key, m in (("sharded", mesh),
                                               ("single", None))}
out["oneshot"] = {key: {str(t): [v.assignment, v.speedup]
                        for t, v in r.variants.items()}
                  for key, r in res.items()}


def searched(r):
    return {str(t): [v.assignment, v.speedup, v.search.score,
                     v.search.history, v.search.n_evals]
            for t, v in r.variants.items()}


# the placed search: 3 targets on the 2 ranks, loss-scored, each rank
# scoring its own targets' candidates; then a scorer fault on rank 0 only.
# Fed the Hessians h, whose sharded database is the single-process one bit
# for bit, so that the scores see only the placement
kw3 = dict(search_steps=24, search_pop=8, seed=3, hessians=h, device=dev)
targets3 = [1.25, 1.5, 2.0]
out["placed_single"] = searched(oneshot_prune(CFG, params, calib, env,
                                              targets3, **kw3))
for key, rule in (("placed", None),
                  ("placed_fault", "spdy.batched_eval:raise@0")):
    plan = FaultPlan.parse(rule) if rule and rank == 0 else None
    spdy.reset_placed_scoring()
    with install(plan), report_scope() as rep:
        got = oneshot_prune(CFG, params, calib, env, targets3, mesh=mesh,
                            **kw3)
    out[key] = {"family": searched(got), "counts": rep.as_dict()["counts"],
                "scoring": dict(spdy.PLACED_SCORING)}
emit_result(out)
"""

MESH_SCRIPT = r"""
import os
import sys

import numpy as np
import torch

from repro_torch.distributed import make_mesh
from repro_torch.launch.subproc import emit_result, init_rank

rank, world, dev = init_rank(timeout=60)
flat = make_mesh((world,), ("data",))
grid = make_mesh((world, 1), ("data", "model"))
emit_result({
    "rank": rank, "world": world, "device": str(dev),
    "threads": torch.get_num_threads(), "omp": os.environ["OMP_NUM_THREADS"],
    "path": os.environ["PYTHONPATH"].split(os.pathsep),
    "index": [flat.index(), grid.index("data"), grid.index("model")],
    "sum": flat.all_reduce(torch.tensor([rank + 1.0])).tolist(),
    "sum_model": grid.all_reduce(torch.tensor([rank + 1.0]), "model").tolist(),
    "any": [flat.any(rank == 1), flat.any(False)],
    "gather": flat.all_gather(
        np.full((1, 2), -0.0 if rank else 1.5, np.float16)).tolist(),
    "signs": np.signbit(flat.all_gather(
        np.full((1,), -0.0 if rank else 0.0, np.float32))).tolist(),
    "broadcast": flat.broadcast_object({"from": rank}),
})
"""

# rank 1 raises while rank 0 waits in a collective for it
HANG_SCRIPT = r"""
import os

import torch
import torch.distributed as dist

from repro_torch.launch.subproc import init_rank

print("PID", os.getpid(), flush=True)
rank, world, dev = init_rank(timeout=600)
if rank == 1:
    raise ValueError("rank one fails on purpose")
dist.all_reduce(torch.ones(1))
"""

EXIT_SCRIPT = r"""
import os
import sys

print("PID", os.getpid(), "says goodbye", flush=True)
print("trouble on stderr", file=sys.stderr, flush=True)
sys.exit(3 if os.environ["RANK"] == "1" else 0)
"""

SLEEP_SCRIPT = r"""
import os
import time

print("PID", os.getpid(), "started", flush=True)
time.sleep(600)
"""


def rank_script(body: str, d) -> str:
    """``body`` after the prelude, with the inputs' directory and the
    tiny config's fields."""
    return (f"DIR = {str(d)!r}\nTINY_KW = {TINY_KW!r}\n" + PRELUDE_SCRIPT
            + body)


def pids_in(msg: str):
    return [int(p) for p in re.findall(r"PID (\d+)", msg)]


def gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The reference's weights (as a port checkpoint), its Hessians of 16
    x 64 calibration tokens, and the synthetic Hessians of its
    ``tests/test_sharded_db.py`` with its database's removal orders."""
    d = tmp_path_factory.mktemp("sharded")
    params = ref_model_init(REF_TINY, jax.random.key(0))[0]
    save_pytree(params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu"), str(d / "params.npz"))
    calib = ref_calibration_batches(REF_TINY, 16, 64, batch=8)
    hess = ref_collect_hessians(REF_TINY, params, calib)
    np.savez(d / "ref_hessians.npz",
             **{k: np.asarray(v) for k, v in hess.items()})
    rng = np.random.default_rng(0)
    h = {}
    for m in ref_registry(REF_TINY):
        X = rng.standard_normal((3 * m.d_in + 16, m.d_in))
        h[m.name] = jnp.asarray(X.T @ X / len(X), jnp.float32)
    np.savez(d / "db_hessians.npz", **{k: np.asarray(v) for k, v in h.items()})
    db = ref_build_database(REF_TINY, params, h)
    np.savez(d / "ref_orders.npz", **{k: v.order for k, v in db.items()})
    return {"dir": d, "calib": calib}


@pytest.fixture(scope="module")
def calib_run(inputs):
    return run_ranks(rank_script(CALIB_SCRIPT, inputs["dir"]), 2,
                     device="cpu", timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module")
def db_run(inputs):
    return run_ranks(rank_script(DB_SCRIPT, inputs["dir"]), 2,
                     device="cpu", timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module")
def mesh_run():
    return run_ranks(MESH_SCRIPT, 2, device="cpu", timeout=LAUNCH_TIMEOUT)


def test_the_ranks_run_the_reference_config_and_tokens(inputs):
    assert dataclasses.asdict(CFG) == {
        k: v for k, v in dataclasses.asdict(REF_TINY).items()
        if k not in JAX_EXECUTION}
    assert isinstance(CFG, ModelConfig)
    for ours, ref in zip(calibration_batches(CFG, 16, 64, batch=8),
                         inputs["calib"]):
        np.testing.assert_array_equal(ours["tokens"].numpy(),
                                      np.asarray(ref["tokens"]))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_returns_each_ranks_result_line(mesh_run):
    assert [r["rank"] for r in mesh_run] == [0, 1]
    assert all(r["world"] == 2 and r["device"] == "cpu" for r in mesh_run)


def test_each_rank_runs_one_thread(mesh_run):
    assert all(r["threads"] == 1 and r["omp"] == "1" for r in mesh_run)


def test_launcher_prepends_the_source_to_pythonpath(mesh_run):
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(subproc.__file__))))
    theirs = os.environ.get("PYTHONPATH")
    for r in mesh_run:
        assert r["path"][0] == src
        if theirs:
            assert r["path"][1:] == theirs.split(os.pathsep)


def test_launcher_raises_with_every_ranks_tails_on_a_non_zero_exit():
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[1\]") as e:
        run_ranks(EXIT_SCRIPT, 2, device="cpu", timeout=60)
    msg = str(e.value)
    assert "says goodbye" in msg and "trouble on stderr" in msg
    assert "--- rank 0 stdout ---" in msg and "--- rank 1 stderr ---" in msg


def test_a_rank_that_raises_frees_its_peer_from_the_collective():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed") as e:
        run_ranks(HANG_SCRIPT, 2, device="cpu", timeout=120)
    # the raising rank ends the launch, not the collective's 600 s
    assert time.monotonic() - t0 < 60
    msg = str(e.value)
    assert "rank one fails on purpose" in msg
    pids = pids_in(msg)
    assert len(pids) == 2 and all(gone(p) for p in pids)


def test_launcher_timeout_kills_the_ranks_and_keeps_their_output():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out") as e:
        run_ranks(SLEEP_SCRIPT, 2, device="cpu", timeout=3)
    assert time.monotonic() - t0 < 30
    msg = str(e.value)
    assert msg.count("started") == 2
    pids = pids_in(msg)
    assert len(pids) == 2 and all(gone(p) for p in pids)


def test_a_cuda_rank_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks(MESH_SCRIPT, 2, device="cuda", timeout=60)


# ---------------------------------------------------------------------------
# the mesh and the helpers
# ---------------------------------------------------------------------------

def test_mesh_indices_and_collectives_across_ranks(mesh_run):
    r0, r1 = mesh_run
    assert r0["index"] == [0, 0, 0] and r1["index"] == [1, 1, 0]
    assert r0["sum"] == r1["sum"] == [3.0]
    # the "model" axis has one rank: each rank sums with itself alone
    assert r0["sum_model"] == [1.0] and r1["sum_model"] == [2.0]
    assert r0["any"] == r1["any"] == [True, False]
    assert r0["gather"] == r1["gather"] == [[1.5, 1.5], [-0.0, -0.0]]
    # a gather moves bits: rank 1's -0.0 keeps its sign
    assert r0["signs"] == r1["signs"] == [False, True]
    assert r0["broadcast"] == r1["broadcast"] == {"from": 0}


MESHES = [((2,), ("data",)), ((4,), ("x",)), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((3, 2), ("model", "data"))]


def ref_mesh(shape, axes):
    """A stand-in for a JAX mesh of ``shape`` (the test process has one
    device): the helpers read only ``shape`` and ``axis_names``."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=tuple(axes))


@pytest.mark.parametrize("shape,axes", MESHES)
def test_helpers_match_the_reference(shape, axes):
    mesh, ref = Mesh(shape, axes), ref_mesh(shape, axes)
    assert data_axes_for(mesh) == ref_sharding.data_axes_for(ref)
    subsets = [None, axes[0], axes, axes[::-1], axes[1:]]
    for sub in subsets:
        assert axis_size(mesh, sub) == ref_sharding.axis_size(ref, sub)
    for profile in ("tp_fsdp", "pure_fsdp"):
        mc = MeshConfig(shape=shape, axes=axes, profile=profile)
        for batch in (1, 2, 3, 4, 6, 8, 12):
            assert batch_axes(mesh, mc.data_axes, batch) == \
                ref_sharding.batch_axes(ref, mc, batch)
    rng = np.random.default_rng(0)
    for n in (1, 3, 5, 8):
        a = rng.standard_normal((n, 3, 2)).astype(np.float32)
        for multiple in (0, 1, 2, 3, 4):
            np.testing.assert_array_equal(
                pad_leading(torch.from_numpy(a), multiple).numpy(),
                np.asarray(ref_sharding.pad_leading(jnp.asarray(a),
                                                    multiple)))


@pytest.mark.parametrize("shape,axes", MESHES)
def test_mesh_index_is_row_major(shape, axes):
    """Each rank's shard over any axes is its row-major place among them,
    and the shards over all axes are the ranks."""
    n = int(np.prod(shape))
    for rank in range(n):
        mesh = Mesh(shape, axes, rank=rank)
        c = np.unravel_index(rank, shape)
        assert mesh.coords() == dict(zip(axes, (int(i) for i in c)))
        assert mesh.index() == rank
        for i, a in enumerate(axes):
            assert mesh.index(a) == c[i]
    with pytest.raises(ValueError, match="not in the mesh"):
        Mesh(shape, axes).index("nope")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh((2,), ("data",))


def test_activation_context_nests_and_restores():
    a, b = Mesh((2,), ("data",)), Mesh((4,), ("data",))
    assert get_activation_context() == (None, None)
    with activation_context(a, ("data",)):
        assert get_activation_context() == (a, ("data",))
        with activation_context(b, None):
            assert get_activation_context() == (b, None)
        assert get_activation_context() == (a, ("data",))
    assert get_activation_context() == (None, None)


# ---------------------------------------------------------------------------
# calibration (tests/test_sharded_calibration.py's bounds)
# ---------------------------------------------------------------------------

def test_sharded_hessians_keep_the_single_process_keys(calib_run):
    assert all(r["keys"] for r in calib_run)


def test_sharded_hessians_match_the_single_process_path(calib_run):
    for r in calib_run:
        assert r["rel_single"] < 1e-5, r["rel_single"]


def test_sharded_hessians_match_the_reference(calib_run):
    for r in calib_run:
        assert r["rel_reference"] < 1e-5, r["rel_reference"]


def test_every_rank_holds_the_same_hessians(calib_run):
    assert calib_run[0]["digest"] == calib_run[1]["digest"]


def test_databases_from_sharded_hessians_keep_the_orders(calib_run):
    for r in calib_run:
        assert r["orders_equal"] and r["errors_close"]


def test_context_mesh_gives_the_explicit_mesh_hessians(calib_run):
    for r in calib_run:
        assert r["context_exact"]
        assert r["context_kept"] and r["context_restored"]


def test_ragged_batches_take_the_single_process_path(calib_run):
    assert all(r["ragged_exact"] for r in calib_run)


def test_a_poisoned_batch_on_one_rank_is_skipped_on_both(calib_run):
    for rank, r in enumerate(calib_run):
        assert r["fault_exact"]
        counts = r["fault_counts"]
        assert counts["detected"] == counts["recovered"] == \
            {"calib.batch": 1}
        assert counts["injected"] == ({"calib.batch": 1} if rank else {})


# ---------------------------------------------------------------------------
# the database (tests/test_sharded_db.py's bounds) and the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["plain", "compact", "ragged"])
def test_sharded_database_is_bit_identical(db_run, route):
    assert all(r[route] for r in db_run)


def test_sharded_database_keeps_the_reference_orders(db_run):
    assert all(r["reference_orders"] for r in db_run)


def test_injected_sharded_group_fault_demotes_bit_equal_once(db_run):
    for rank, r in enumerate(db_run):
        assert r["demoted_exact"] and r["breaker_open"]
        counts = r["demotion_counts"]
        assert counts["demotions"] == {"db.sharded_group": 1}
        assert counts["injected"] == (
            {"db.sharded_group": 1} if rank else {})
    # the open breaker kept the second chunk off the site
    assert db_run[1]["site_hits"] == 1


def test_healed_sharded_database_climbs_with_the_single_process_build(
        db_run):
    for r in db_run:
        assert r["healed_exact"]
        want = {"obs.cholesky": 1}
        assert r["heal_counts_sharded"] == r["heal_counts_single"]
        assert r["heal_counts_sharded"]["recovered"] == want


def test_sharded_oneshot_prune_gives_each_rank_the_single_process_family(
        db_run):
    single = db_run[0]["oneshot"]["single"]
    assert single == db_run[1]["oneshot"]["single"]
    for r in db_run:
        assert r["oneshot"]["sharded"] == single
    assert all(s >= t for t, (_, s) in
               ((float(k), v) for k, v in single.items()))


def test_placed_oneshot_prune_gives_each_rank_the_single_process_search(
        db_run):
    """Loss-scored, 3 targets on 2 ranks: every rank's assignments,
    speedups, scores, histories and ``n_evals`` are the single-process
    search's bit for bit."""
    single = db_run[0]["placed_single"]
    assert single == db_run[1]["placed_single"]
    for r in db_run:
        assert r["placed"]["family"] == single
        assert r["placed"]["counts"]["demotions"] == {}


def test_each_rank_scores_only_its_own_targets_candidates(db_run):
    n_evals = next(iter(db_run[0]["placed_single"].values()))[4]
    total = 0
    for rank, r in enumerate(db_run):
        scoring = r["placed"]["scoring"]
        assert scoring["scored"], f"rank {rank} scored nothing"
        assert all(int(k) % 2 == rank for k in scoring["scored"])
        assert scoring["calls"] >= len(scoring["scored"])
        total += sum(scoring["scored"].values())
    assert total == n_evals
    # one all-gather a round with new keys, on both ranks alike
    gathers = [r["placed"]["scoring"]["all_gathers"] for r in db_run]
    assert gathers[0] == gathers[1] >= 1


def test_a_scorer_fault_on_one_rank_demotes_both_ranks_once(db_run):
    single = db_run[0]["placed_single"]
    for rank, r in enumerate(db_run):
        faulted = r["placed_fault"]
        assert faulted["family"] == single
        counts = faulted["counts"]
        assert counts["demotions"] == {"spdy.batched_eval": 1}
        assert counts["injected"] == (
            {"spdy.batched_eval": 1} if rank == 0 else {})
        # demoted in the first round: no round was gathered
        assert faulted["scoring"]["all_gathers"] == 0
