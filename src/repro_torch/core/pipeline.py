"""Gradual structured pruning (paper §4.1) as a stage-checkpointed
*family engine*: for each speedup target in ascending order, ZipLM-prune
the *current* model to the target, then finetune with layer-wise token
distillation against the dense teacher, and export. One run, one set of
hyper-parameters, a whole model family, each member meeting its runtime
target by construction. ``masks_from_assignment`` gives the finetuning
masks.

Fault tolerance / resume semantics
----------------------------------
A family run owns a unique run directory (derived from (cfg name,
targets, seed); an explicit ``ckpt_dir`` is only the base, and the run
nests under a ``<cfg>-<run_key>`` subdirectory, so two concurrent runs
with different seeds can never cross-restore each other's trainer
checkpoints or manifests). Inside it a ``family.json`` manifest, written
atomically by :func:`checkpoint.manager.atomic_write_json`, records
per-target stage progress through the pipeline

    hessians -> db -> search -> finetune -> done

and each completed stage persists its artifact next to the trainer
checkpoints (``t<target>/hessians.npz``, ``t<target>/db.npz``, the SPDY
result inline in the manifest, ``t<target>/ckpt/`` for finetune steps,
``t<target>/params.npz`` with the finished target's final params). A
preempted run called again with the same arguments resumes at the exact
(target, stage): completed targets are rebuilt from their artifacts (no
Hessian collection, database build or search is redone), the in-flight
target reloads every completed stage's artifact and runs only the
in-flight stage again, and an in-flight finetune resumes from the
trainer's latest checkpoint. With a deterministic data source (``data``
as a callable ``global_step -> iterator``, e.g. a ``synthetic_stream``
factory) a killed-and-resumed family run gives the bits of an
uninterrupted one.

Manifest format (``family.json``)::

    {"version": 1,
     "header": {"cfg": ..., "targets": [...], "seed": ...,
                "finetune_steps": ..., "search_steps": ...,
                "search_pop": ..., "search_batched": ..., "run_key": ...,
                "inputs": {"params": ..., "calib": ..., "env": ...,
                           "tcfg": {...}, "latency": [...]}},
     "runs": <attempt counter>,
     "targets": {"<target>": {"stage": "pending|hessians|db|search|done",
                              "assignment": {...}, "runtime": ...,
                              "speedup": ..., "score": ..., "coeffs": [...],
                              "n_evals": ..., "loss_before_ft": ...,
                              "loss_after_ft": ..., "stage_times": {...},
                              "hessians_sha256": ..., "db_sha256": ...,
                              "params_sha256": ...}},
     "executed": [{"run": n, "target": "<t>", "stage": "<s>"}, ...],
     "robustness": {...}}

``executed`` is append-only stage bookkeeping: every stage that
*computes* (rather than loads its artifact) logs one event tagged with
the attempt counter, so a test can assert that a resume ran only the
in-flight stage. A header mismatch (same directory, other family
parameters or inputs) raises instead of silently mixing state.

``stop_after=(target_idx, stage)`` simulates a preemption right after
that stage's artifact is durably persisted; ``(target_idx, "finetune",
step)`` kills mid-finetune after ``step`` trainer steps (the trainer's
own ``stop_after``), leaving whatever checkpoints ``ckpt_every`` made.
Both raise :class:`FamilyPreempted`.

Artifact integrity
------------------
Every stage artifact's sha256 is recorded in its manifest payload at
write time (``hessians_sha256``, ``db_sha256``, ``params_sha256``;
transient ``OSError``s are retried with backoff). On resume each
artifact is hashed again before use: a corrupt or truncated file is
renamed ``*.corrupt`` (quarantined, never deleted) and the owning stage
runs again from its still-valid inputs; with a deterministic setup the
rebuilt artifact equals the lost one. A missing or corrupt final
``params.npz`` rolls its target back to the ``search`` stage, where the
recorded search result and the trainer's own checkpoints repair it. The
run's :class:`~repro_torch.robustness.report.RobustnessReport` is dumped
into the manifest under ``"robustness"``, preempted runs included.

Overlapped export
-----------------
Per target the stages form a chain, hessians(i) -> db(i) -> search(i)
-> finetune(i), and target i+1 calibrates on target i's finetuned params,
so the stages of consecutive targets cannot be reordered. What overlaps
is target i's **export tail**: the final loss, the ``params.npz`` bytes
and the shrunk member only *read* the finished params. With
``overlap=True`` (the default) the tail runs on a background thread
beside target i+1's stages, at most one in flight. On the card both
threads queue on the default stream, so their kernels serialize; the
tail computes with operations whose bits do not depend on
``torch.use_deterministic_algorithms``, which the train step switches on
and off process-wide. So the variants, payloads and artifacts equal
those of the serial (``overlap=False``) schedule.

Artifacts stream through a :class:`~repro_torch.checkpoint.manager.
CheckpointManager`'s bounded queue: the bytes are serialized and hashed
on the producing thread (:func:`npz_bytes` is deterministic, so the
digest recorded before the enqueue is that of the file the worker later
writes), then written atomically by its worker. Barriers (join the
export, drain the queue) run before every ``FamilyPreempted`` and at the
end of the run, so ``stop_after`` leaves the durable state of a serial
run stopped at the same point. One kill window remains: a hard kill can
durably record "done" while that target's ``params.npz`` is still
queued; the done-restore path finds the missing or corrupt file and
rolls the target back to ``search``. Each target's record carries
``stage_times`` (seconds per stage; ``export`` is the tail).

Every artifact write goes through the ``db.artifact_write`` fault site
(``robustness/faults.py``): an injected transient ``OSError`` is retried,
and the ``corrupt`` mode flips bytes after the write, so the sha256 in
the manifest catches the file on its next load and the stage runs again.

Ranks
-----
``mesh`` (a ``distributed.Mesh``, or the installed activation context's)
runs the family on every rank of the mesh, each rank calling
``gradual_prune`` with the same arguments: the per-target calibration
and database shard over the ranks (``collect_hessians`` and
``build_database`` with ``mesh=``), the first rank builds the latency
table and broadcasts it, and each target's search is placed over the
ranks (``search(mesh=)``, one target: the first rank scores it and
shares the scores). With ``specs`` (``models.model_specs``) the finetune
is the mesh trainer (``Trainer(mesh=, mc=, specs=)``: FSDP slices,
``int8_ef`` if ``tcfg`` asks for it); without them each rank runs the
same single-process finetune (the reference's calibration-only
sharding). The first rank alone writes into the run directory: the
manifest, every artifact and the trainer's checkpoints. Every decision
to read an artifact is the first rank's (it checks the sha256 and
quarantines), shared before any other rank reads, so all ranks take the
same path through the stages and their collectives, and a resume works
on every rank. The other ranks keep the manifest in memory without the
artifacts' digests and read the first rank's on the next call; every
rank returns the same variants.

One deliberate difference from the JAX package: a variant's ``pruned``
model is shrunk from its finetuned params (``shrink_from_stitched``). The
reference's ``shrink`` takes each out-side matrix from the database
snapshot, from before the finetune.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from ..checkpoint.manager import (CheckpointManager, CheckpointWriteError,
                                  _flatten, atomic_save_npz,
                                  atomic_write_json, file_sha256, load_json,
                                  npz_bytes, restore_pytree)
from ..configs.base import TrainConfig
from ..models.pruned import PrunedModel, refuse_cross_attention
from ..models.transformer import tree_to
from ..optim.adamw import tree_leaves, tree_map
from ..robustness import faults
from ..robustness.healing import retry_io
from ..robustness.integrity import checked_npz_load, quarantine_file
from ..distributed.sharding import mesh_config_for
from ..robustness.report import RobustnessReport, report_scope
from ..runtime.device import DeviceLike, resolve_device, to_host
from ..train.trainer import Trainer
from .database import (ModuleDB, SnapshotCache, apply_assignment,
                       build_database)
from .hessian import collect_hessians, resolve_mesh
from .latency import build_table
from .oneshot import calib_loss_fn, make_batched_eval
from .shrink import shrink_from_stitched
from .spdy import SearchResult, search
from .structures import UNITS, registry


def masks_from_assignment(cfg, params, db, assignment):
    """Params-shaped {0,1} fp32 mask tree, on the params' device, pinning
    pruned structures to zero during finetuning (gradients would otherwise
    regrow them). Only the out-side matrix rows of a removed structure are
    masked, as in the reference."""
    dev = tree_leaves(params)[0].device
    masks = tree_map(lambda p: torch.ones(p.shape, dtype=torch.float32,
                                          device=dev), params)
    for name, removed in assignment.items():
        mdb = db[name]
        mod = mdb.mod
        gs = mod.group_size
        row_mask = np.zeros(mod.d_in, np.float32)
        for g in mdb.kept_structures(removed):
            row_mask[g * gs:(g + 1) * gs] = 1.0
        rm = torch.from_numpy(row_mask)[:, None].to(dev)
        UNITS[mod.kind].mask_rows(masks["layers"], mod, rm)
    return masks


@dataclass
class GradualVariant:
    target: float
    achieved: float
    assignment: Dict[str, int]
    params: dict
    pruned: PrunedModel
    loss_before_ft: float
    loss_after_ft: float


class FamilyPreempted(RuntimeError):
    """Raised at a simulated (``stop_after``) preemption point after the
    in-flight stage's state is durably checkpointed; calling
    ``gradual_prune`` again with the same arguments resumes the run."""


# ----------------------------------------------------------------------
# run directory + manifest
# ----------------------------------------------------------------------

STAGES = ("hessians", "db", "search", "done")  # "done" == finetuned


def family_run_key(cfg, targets: Sequence[float], seed: int) -> str:
    """Content key identifying one family run's state: two runs share
    checkpoints iff (cfg name, targets, seed) agree. The JAX package's
    key for the same arguments."""
    doc = {"cfg": cfg.name, "targets": [float(t) for t in sorted(targets)],
           "seed": int(seed)}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()[:12]


def family_run_dir(cfg, targets: Sequence[float], seed: int,
                   base: Optional[str] = None) -> str:
    """Unique per-run directory. ``base=None`` -> a tempdir-rooted default;
    an explicit base still nests per run key, so concurrent families
    sharing a base can never cross-restore."""
    base = base or os.path.join(tempfile.gettempdir(), "ziplm_families")
    return os.path.join(base, f"{cfg.name}-{family_run_key(cfg, targets, seed)}")


def _tkey(target: float) -> str:
    return f"{float(target):g}"


def _leaves_with_path(tree, path: str = ""):
    """(path, leaf) of a tree of dicts (keys sorted), lists and tuples;
    ``None`` leaves are skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _tree_digest(tree, max_elems: int = 4096) -> str:
    """Content fingerprint of a tree of tensors (params, calibration
    batches): resuming against other inputs must raise, not silently
    return the previous inputs' family. A leaf of more than ``max_elems``
    elements hashes a strided sample taken where the leaf lives, so only
    the sample crosses to the host; bfloat16 is hashed by its bits."""
    h = hashlib.sha256()
    for path, leaf in _leaves_with_path(tree):
        t = leaf.detach() if isinstance(leaf, torch.Tensor) \
            else torch.from_numpy(np.asarray(leaf))
        h.update(path.encode())
        h.update(str((tuple(t.shape), str(t.dtype))).encode())
        flat = t.flatten()
        if flat.numel() > max_elems:
            flat = flat[::-(-flat.numel() // max_elems)]
        flat = flat.contiguous()
        if flat.dtype == torch.bfloat16:
            flat = flat.view(torch.int16)
        # sync: the sample's pull, at most max_elems per leaf
        h.update(flat.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


class FamilyRunState:
    """Atomic-JSON manifest of per-target stage progress (format above)."""

    FILE = "family.json"

    def __init__(self, run_dir: str, header: Dict, mesh=None):
        self.path = os.path.join(run_dir, self.FILE)
        # with ranks, the first reads and writes the file; every rank
        # keeps the same document in memory
        self.writer = mesh is None or mesh.index() == 0
        # the overlapped schedule records from two threads (the stage loop
        # and the export tail); atomic_write_json's tmp name is only
        # pid-unique, so mutating and saving the manifest serialize here
        self._lock = threading.RLock()
        doc = load_json(self.path) if self.writer else None
        if mesh is not None:  # the first rank's document and header
            doc, first = mesh.broadcast_object((doc, header))
            if first != header:
                raise ValueError(
                    f"the ranks of one family differ in their inputs: "
                    f"header {header} against the first rank's {first}")
        if doc is not None and doc.get("header") != header:
            raise ValueError(
                f"family manifest at {self.path} belongs to a different "
                f"run (header {doc.get('header')} != {header}); use a "
                f"different ckpt_dir or matching arguments")
        if doc is None:
            doc = {"version": 1, "header": header, "runs": 0,
                   "targets": {}, "executed": []}
        doc["runs"] = int(doc.get("runs", 0)) + 1
        self.doc = doc
        self.run = doc["runs"]
        self._save()

    def _save(self):
        if not self.writer:
            return
        with self._lock:
            atomic_write_json(self.path, self.doc)

    def entry(self, tkey: str) -> Dict:
        with self._lock:
            return self.doc["targets"].setdefault(tkey, {"stage": "pending"})

    def stage_done(self, tkey: str, stage: str) -> bool:
        cur = self.entry(tkey)["stage"]
        if cur == "pending":
            return False
        return STAGES.index(cur) >= STAGES.index(stage)

    def record(self, tkey: str, stage: str, executed: bool = True,
               **payload):
        """Mark ``stage`` complete for ``tkey``; ``executed`` logs a
        stage-execution event (False when an artifact was merely loaded).

        Never moves the stage pointer back: rebuilding an early artifact
        (a quarantined ``db.npz`` under a target already at ``search`` or
        ``done``) refreshes its payload and sha without undoing the later
        stages; a deliberate rollback writes ``entry["stage"]``."""
        with self._lock:
            e = self.entry(tkey)
            if (e["stage"] == "pending"
                    or STAGES.index(stage) >= STAGES.index(e["stage"])):
                e["stage"] = stage
            e.update(payload)
            if executed:
                self.doc["executed"].append(
                    {"run": self.run, "target": tkey, "stage": stage})
            self._save()

    def log_exec(self, tkey: str, stage: str):
        """Log a stage execution without completing it (mid-stage work
        such as an in-flight finetune)."""
        with self._lock:
            self.doc["executed"].append(
                {"run": self.run, "target": tkey, "stage": stage})
            self._save()

    def executed(self, run: Optional[int] = None) -> List[Dict]:
        ev = self.doc["executed"]
        return ev if run is None else [e for e in ev if e["run"] == run]


# ----------------------------------------------------------------------
# stage artifacts
# ----------------------------------------------------------------------

def _save_artifact(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """Atomic npz write through the ``db.artifact_write`` fault site:
    transient ``OSError``s retry with backoff, and a ``corrupt`` rule
    flips bytes after the write, so the recorded sha256 catches the file
    on its next load. Returns the written file's sha256."""
    sha, rule = retry_io(lambda: atomic_save_npz(path, arrays),
                         site="db.artifact_write")
    faults.corrupt_if(rule, path)
    return sha


def _stream_artifact(mgr: CheckpointManager, path: str,
                     arrays: Callable[[], Dict[str, np.ndarray]]
                     ) -> Optional[str]:
    """Streaming twin of `_save_artifact`: serialize and hash on the
    caller's thread, enqueue the bytes on the manager's bounded queue,
    return the digest at once. npz serialization is deterministic, so the
    digest recorded in the manifest before the enqueue is that of the
    bytes the worker later writes, through the same ``db.artifact_write``
    site as ``_save_artifact``; a write that fails after its retries
    surfaces at ``mgr.wait()``, which every preemption point and the end
    of the run call before reporting stages durable. ``arrays`` is
    called only on the writing rank; another rank writes nothing and
    gets None."""
    if not mgr.writer:
        return None
    data, sha = npz_bytes(arrays())
    mgr.submit_blob(path, data)
    return sha


def _hessian_arrays(hessians: Dict[str, torch.Tensor]
                    ) -> Dict[str, np.ndarray]:
    # sync: artifact persistence, one pull per module Hessian
    return {k: to_host(v) for k, v in hessians.items()}


def _save_hessians(path: str, hessians: Dict[str, torch.Tensor]) -> str:
    """Synchronous twin of the engine's streamed Hessian write, for tools
    and tests that persist artifacts outside a running manager."""
    return _save_artifact(path, _hessian_arrays(hessians))


def _checked_load(path: str, expected_sha: Optional[str], mesh=None
                  ) -> Optional[Dict[str, np.ndarray]]:
    """``checked_npz_load`` at the ``db.artifact_write`` site, agreed
    across the ranks of ``mesh``: the first rank checks the file (and
    quarantines it on a mismatch) before any other rank reads it, and a
    file that fails on any rank is a miss on every rank."""
    if mesh is None:
        return checked_npz_load(path, expected_sha, site="db.artifact_write")
    first = mesh.index() == 0
    data = (checked_npz_load(path, expected_sha, site="db.artifact_write")
            if first else None)
    if mesh.any(first and data is None):
        return None
    if not first:
        data = checked_npz_load(path, expected_sha, site="db.artifact_write",
                                quarantine=False)
    return None if mesh.any(data is None) else data


def _load_hessians(path: str, expected_sha: Optional[str] = None,
                   mesh=None) -> Optional[Dict[str, torch.Tensor]]:
    """Host tensors (``build_database`` moves them to its device), or
    None on a miss or a quarantined file."""
    data = _checked_load(path, expected_sha, mesh)
    if data is None:
        return None
    return {k: torch.from_numpy(v) for k, v in data.items()}


_DB_FIELDS = ("snapshots", "errors", "priors", "levels", "order")


def _db_arrays(db: Dict[str, ModuleDB]) -> Dict[str, np.ndarray]:
    arrs = {}
    for name, mdb in db.items():
        for f in _DB_FIELDS:
            arrs[f"{name}::{f}"] = np.asarray(getattr(mdb, f))
        arrs[f"{name}::base_norm"] = np.float64(mdb.base_norm)
    return arrs


def _save_db(path: str, db: Dict[str, ModuleDB]) -> str:
    """Synchronous twin of the engine's streamed database write, for
    tools and tests that persist artifacts outside a running manager."""
    return _save_artifact(path, _db_arrays(db))


def _load_db(cfg, path: str, expected_sha: Optional[str] = None,
             mesh=None) -> Optional[Dict[str, ModuleDB]]:
    data = _checked_load(path, expected_sha, mesh)
    if data is None:
        return None
    present = {k.split("::")[0] for k in data}
    out = {}
    # registry order, not sorted: SPDY's module order (and with it the
    # per-module RNG streams) follows the database's insertion order, and
    # "L10.x" sorts before "L2.x", so a sorted rebuild would break the
    # resume's bits for models of 10 layers or more
    for mod in registry(cfg):
        if mod.name not in present:
            continue
        kw = {f: data[f"{mod.name}::{f}"] for f in _DB_FIELDS}
        out[mod.name] = ModuleDB(
            mod=mod, base_norm=float(data[f"{mod.name}::base_norm"]), **kw)
    return out


def _result_payload(res: SearchResult) -> Dict:
    return {"assignment": {k: int(v) for k, v in res.assignment.items()},
            "runtime": float(res.runtime), "speedup": float(res.speedup),
            "score": float(res.score),
            "coeffs": np.asarray(res.coeffs, np.float64).tolist(),
            "n_evals": int(res.n_evals)}


def _result_from(entry: Dict) -> SearchResult:
    return SearchResult(
        assignment={k: int(v) for k, v in entry["assignment"].items()},
        runtime=float(entry["runtime"]), speedup=float(entry["speedup"]),
        score=float(entry["score"]),
        coeffs=np.asarray(entry["coeffs"], np.float64),
        n_evals=int(entry.get("n_evals", 0)))


# ----------------------------------------------------------------------
# family engine
# ----------------------------------------------------------------------

DataSource = Union[Iterator[Dict], Callable[[int], Iterator[Dict]]]


def gradual_train_config(finetune_steps: int) -> TrainConfig:
    """The finetune's default TrainConfig (the reference's gradual
    defaults): lr 8e-5, 5 warm-up steps, logit 1.0 and token 0.5
    distillation."""
    return TrainConfig(learning_rate=8e-5, warmup_steps=5,
                       total_steps=finetune_steps, distill_logit=1.0,
                       distill_token=0.5)


def gradual_prune(cfg, params, env, targets: Sequence[float],
                  data: DataSource, calib_batches: List[Dict], *,
                  tcfg: Optional[TrainConfig] = None,
                  finetune_steps: int = 50, search_steps: int = 50,
                  search_pop: int = 16, search_batched: bool = True,
                  latency_backend: str = "costmodel",
                  latency_kw: Optional[Dict] = None,
                  mesh=None, data_axes=None, mc=None, specs=None,
                  ckpt_dir: Optional[str] = None,
                  ckpt_every: Optional[int] = None,
                  seed: int = 0, resume: bool = True,
                  stop_after: Optional[tuple] = None,
                  report: Optional[RobustnessReport] = None,
                  overlap: bool = True, keep_checkpoints: bool = True,
                  verbose: bool = False,
                  device: DeviceLike = None) -> List[GradualVariant]:
    """Stage-checkpointed gradual family pruning on ``device`` (the card
    unless the caller asks for the CPU); the module docstring has the
    manifest and resume contract. Params, teacher and calibration batches
    are moved to the device once.

    ``data`` is an iterator (resume then reads on from wherever the
    caller's iterator is) or a callable ``global_step -> iterator``: the
    engine then draws target ``i``'s batches from global steps
    ``[i*finetune_steps, (i+1)*finetune_steps)``, which makes a killed
    and resumed run give the bits of an uninterrupted one.

    Each target's SPDY search scores ``search_pop`` candidates a round by
    calibration loss; every target calibrates again on the model the
    previous target finetuned, so the family cannot share one search
    pass, but the per-target RNG streams are spawned from ``seed``.

    ``report`` supplies the run's :class:`RobustnessReport` (a fresh one
    otherwise); it is the ambient report for the whole run, and its dump
    lands in the manifest under ``"robustness"``, preempted runs
    included.

    ``keep_checkpoints=False`` removes a target's trainer checkpoints
    (``t<target>/ckpt/``) once its finetune has returned, and the trainer
    writes none at the finetune's last step (it would be removed at
    once; those at ``ckpt_every`` multiples before it stay until the
    finetune returns, for a kill in the middle of it): a resume
    restores a done target from its ``params.npz``, and a target whose
    ``params.npz`` was lost finetunes again from step 0, to the same bits
    with a step-indexed data source. At full width the checkpoints are
    most of a target's bytes (17.2 GB of params, m and v against 10.4 GB
    of other artifacts at one Phi-3.5-MoE layer). The results do not
    depend on the flag, so it is not part of the resume header.

    ``overlap`` runs each finished target's export tail on a background
    thread beside the next target's stages; the results are the same
    bits either way, so the flag is not part of the resume header.

    ``search_batched=False`` runs each target's search on the serial
    equivalence-reference path (the scalar DP, candidates scored one by
    one).

    ``latency_kw`` goes to ``build_table`` (the measure backend's
    ``reps`` and ``warmup``, and ``cache_dir``). A measured table is not
    repeatable between builds: without a cache every call measures anew,
    so a run resumed on the measure backend would search its remaining
    targets against another table. With ``{"cache_dir": ...}`` (or
    ``$ZIPLM_LATENCY_CACHE``) the first call stores the table and a
    resumed run reads the same one, so a measured-table family resumes
    bit for bit, as a cost-model one does. The cache's location is not
    part of the resume header; the other latency arguments are.

    ``mesh`` (or the installed activation context's), ``data_axes``,
    ``mc`` and ``specs``: the family over the ranks of a mesh (module
    docstring, "Ranks"); every rank calls ``gradual_prune`` with the same
    arguments and gets the same variants.
    """
    refuse_cross_attention(cfg, "gradual_prune (each target exports a "
                           "shrunk model)")
    dev = resolve_device(device)
    mesh, data_axes = resolve_mesh(mesh, data_axes)
    if mesh is None and (mc is not None or specs is not None):
        raise ValueError("gradual_prune(mc=, specs=) configure the mesh "
                         "trainer and need a mesh")
    if mesh is not None and specs is not None and mc is None:
        mc = mesh_config_for(mesh)
    tcfg = tcfg or gradual_train_config(finetune_steps)
    if stop_after is not None:
        if stop_after[1] not in ("hessians", "db", "search", "finetune"):
            raise ValueError(f"stop_after stage {stop_after[1]!r} is not a "
                             f"pipeline stage")
        if stop_after[1] == "finetune" and len(stop_after) < 3:
            raise ValueError("stop_after=(i, 'finetune') needs a step "
                             "index: (i, 'finetune', step)")
    targets = [float(t) for t in sorted(targets)]
    ckpt_every = ckpt_every or max(1, min(50, finetune_steps))
    params = tree_to(params, dev)
    calib_batches = [tree_to(b, dev) for b in calib_batches]
    run_dir = family_run_dir(cfg, targets, seed, base=ckpt_dir)
    if not resume and (mesh is None or mesh.index() == 0):
        shutil.rmtree(run_dir, ignore_errors=True)
    lat_kw = {k: repr(v) for k, v in sorted((latency_kw or {}).items())
              if k != "cache_dir"}  # the cache's location changes no result
    header = {"cfg": cfg.name, "targets": targets, "seed": int(seed),
              "finetune_steps": int(finetune_steps),
              "search_steps": int(search_steps),
              "search_pop": int(search_pop),
              "search_batched": bool(search_batched),
              "run_key": family_run_key(cfg, targets, seed),
              # every input that changes the results is fingerprinted:
              # resuming a 'done' manifest with a retrained model, another
              # calibration set, env or trainer setting fails loudly
              # instead of handing back stale artifacts
              "inputs": {"params": _tree_digest(params),
                         "calib": _tree_digest(calib_batches),
                         "env": repr(env),
                         "tcfg": dataclasses.asdict(tcfg),
                         "latency": [latency_backend, lat_kw]}}
    frs = FamilyRunState(run_dir, header, mesh=mesh)
    rep = report if report is not None else RobustnessReport()
    try:
        with report_scope(rep):
            return _family_engine(
                cfg, params, env, targets, data, calib_batches, tcfg=tcfg,
                finetune_steps=finetune_steps, search_steps=search_steps,
                search_pop=search_pop, search_batched=search_batched,
                latency_backend=latency_backend,
                latency_kw=latency_kw, mesh=mesh, data_axes=data_axes,
                mc=mc, specs=specs, ckpt_every=ckpt_every, seed=seed,
                stop_after=stop_after, overlap=overlap,
                keep_checkpoints=keep_checkpoints, verbose=verbose,
                run_dir=run_dir, frs=frs, dev=dev)
    finally:
        # the run's robustness counts ride in the manifest even when the
        # run was preempted or crashed mid-stage
        frs.doc["robustness"] = rep.as_dict()
        frs._save()


def _family_engine(cfg, params, env, targets, data, calib_batches, *, tcfg,
                   finetune_steps, search_steps, search_pop, search_batched,
                   latency_backend, latency_kw, mesh, data_axes, mc, specs,
                   ckpt_every, seed, stop_after, overlap, keep_checkpoints,
                   verbose, run_dir, frs, dev) -> List[GradualVariant]:
    """The family loop proper, run under an installed report scope
    (``gradual_prune`` is the argument-checking, manifest-owning
    wrapper)."""
    teacher = params  # the dense teacher; nothing writes its tensors
    first = mesh is None or mesh.index() == 0  # the writing rank
    table = None
    if first:
        table = build_table(cfg, env, backend=latency_backend, device=dev,
                            **(latency_kw or {}))
    if mesh is not None:
        table = mesh.broadcast_object(table)
    loss_eval = calib_loss_fn(cfg, calib_batches[:1], device=dev)

    # the artifact stream: hessians/db/params npz bytes are serialized
    # and hashed on the producing thread, then written by the manager's
    # worker (bounded queue: backpressure); _barrier() is the only place
    # that declares them durable
    mgr = CheckpointManager(run_dir, async_save=True, mesh=mesh)
    exports: List[threading.Thread] = []   # at most one in flight
    export_err: List[BaseException] = []

    def _join_exports(raise_errors: bool = True):
        while exports:
            exports.pop(0).join()
        if export_err and raise_errors:
            raise export_err.pop(0)

    def _barrier():
        """Durability barrier: join the in-flight export tail, then drain
        the artifact queue (raising any persistent write failure as
        CheckpointWriteError). After it returns, every stage the manifest
        calls complete is on disk."""
        _join_exports()
        mgr.wait()

    def preempt_at(i, stage):
        if stop_after is not None and tuple(stop_after[:2]) == (i, stage):
            # "preemption right after that stage's artifact is durably
            # persisted" survives overlap: barrier first, so the manifest
            # and artifacts a resuming run sees are a serial run's
            _barrier()
            raise FamilyPreempted(
                f"simulated preemption after {stage} of target index {i} "
                f"(run dir {run_dir})")

    current = params
    out: Dict[int, GradualVariant] = {}
    seeds = np.random.SeedSequence(seed).spawn(len(targets))

    def load_or_build_db(i, tkey, tdir, entry, stage_t):
        """Sha-checked database load that falls through to a rebuild: a
        corrupt (quarantined) or missing ``db.npz`` runs the db stage
        again from the Hessians artifact; a corrupt Hessians artifact
        likewise falls back to calibrating the current model again, which
        gives the original bits with a deterministic setup. The Hessians
        stay unloaded when the database artifact is valid."""
        dpath = os.path.join(tdir, "db.npz")
        if frs.stage_done(tkey, "db"):
            db = _load_db(cfg, dpath, expected_sha=entry.get("db_sha256"),
                          mesh=mesh)
            if db is not None:
                return db
        hpath = os.path.join(tdir, "hessians.npz")
        hessians = None
        if frs.stage_done(tkey, "hessians"):
            hessians = _load_hessians(
                hpath, expected_sha=entry.get("hessians_sha256"), mesh=mesh)
        if hessians is None:
            t0 = time.perf_counter()
            hessians = collect_hessians(cfg, current, calib_batches,
                                        mesh=mesh, data_axes=data_axes,
                                        device=dev)
            hsha = _stream_artifact(mgr, hpath,
                                    lambda: _hessian_arrays(hessians))
            stage_t["hessians"] = time.perf_counter() - t0
            frs.record(tkey, "hessians", hessians_sha256=hsha,
                       stage_times=dict(stage_t))
            preempt_at(i, "hessians")
        t0 = time.perf_counter()
        db = build_database(cfg, current, hessians, mesh=mesh,
                            shard_axes=data_axes, device=dev)
        del hessians
        dsha = _stream_artifact(mgr, dpath, lambda: _db_arrays(db))
        stage_t["db"] = time.perf_counter() - t0
        frs.record(tkey, "db", db_sha256=dsha, stage_times=dict(stage_t))
        preempt_at(i, "db")
        return db

    def export_tail(i, target, tkey, tdir, db, res, loss_before, cur,
                    stage_t):
        """Target ``i``'s read-only completion work: the final loss, the
        params' bytes (hashed before the enqueue), the shrunk member, the
        "done" record and the variant. Under ``overlap`` it runs on a
        background thread beside target ``i+1``'s stages; it only reads
        ``cur`` (no one writes the finished params' tensors) and computes
        the same bits under either deterministic-algorithms setting."""
        t0 = time.perf_counter()
        loss_after = loss_eval(cur)
        psha = None
        if first:
            data_b, psha = npz_bytes(_flatten(cur))
            mgr.submit_blob(os.path.join(tdir, "params.npz"), data_b)
        pm = shrink_from_stitched(cfg, cur, db, res.assignment)
        stage_t["export"] = time.perf_counter() - t0
        frs.record(tkey, "done", executed=False, loss_after_ft=loss_after,
                   params_sha256=psha, stage_times=dict(stage_t))
        out[i] = GradualVariant(
            target=target, achieved=res.speedup, assignment=res.assignment,
            params=cur, pruned=pm, loss_before_ft=loss_before,
            loss_after_ft=loss_after)
        if verbose:
            print(f"[gradual] {target}x -> {res.speedup:.2f}x  "
                  f"loss {loss_before:.4f} -> {loss_after:.4f}  "
                  f"shrunk params {pm.num_params() / 1e6:.2f}M")

    def export_tail_bg(*args):
        try:
            export_tail(*args)
        except BaseException as e:  # raised again at the next _barrier()
            export_err.append(e)

    try:
        for i, target in enumerate(targets):
            tkey = _tkey(target)
            tdir = os.path.join(run_dir, f"t{tkey}")
            entry = frs.entry(tkey)
            stage_t: Dict[str, float] = dict(entry.get("stage_times", {}))

            if entry["stage"] == "done":
                # a completed target: the variant from its artifacts, with
                # no Hessians, database build, search or finetune. The
                # final params have their own params.npz (written at
                # completion), so this path never restores optimizer state
                ppath = os.path.join(tdir, "params.npz")
                want = entry.get("params_sha256")
                # the first rank's reading of the file, on every rank
                state_of_file = None
                if first:
                    state_of_file = (
                        "missing" if not os.path.exists(ppath) else
                        "corrupt" if want is not None
                        and file_sha256(ppath) != want else "ok")
                if mesh is not None:
                    state_of_file = mesh.broadcast_object(state_of_file)
                if state_of_file == "missing":
                    # a kill can outrun the params stream: "done" was
                    # recorded while params.npz died in the write queue.
                    # Roll back to "search": the recorded search result and
                    # the trainer's checkpoints repair it below (written
                    # directly, because record() never moves back)
                    entry["stage"] = "search"
                    frs._save()
                elif state_of_file == "corrupt":
                    # the final params rotted on disk: quarantine, and the
                    # same rollback to "search"
                    if first:
                        quarantine_file(ppath, site="db.artifact_write")
                    entry["stage"] = "search"
                    frs._save()
                else:
                    db = load_or_build_db(i, tkey, tdir, entry, stage_t)
                    res = _result_from(entry)
                    current = restore_pytree(current, ppath)
                    pm = shrink_from_stitched(cfg, current, db,
                                              res.assignment)
                    out[i] = GradualVariant(
                        target=target, achieved=res.speedup,
                        assignment=res.assignment, params=current,
                        pruned=pm,
                        loss_before_ft=float(entry["loss_before_ft"]),
                        loss_after_ft=float(entry["loss_after_ft"]))
                    if verbose:
                        print(f"[gradual] {target}x restored (stage done)")
                    continue

            # ---- stages: hessians (calibrated again on the *current*
            # model: the Hessians drift as we prune) and database, both
            # sha-checked, quarantined and rebuilt on corruption ----
            db = load_or_build_db(i, tkey, tdir, entry, stage_t)
            cache = SnapshotCache(cfg, db, device=dev)

            # ---- stage: SPDY search ----
            if frs.stage_done(tkey, "search"):
                res = _result_from(entry)
                masked = apply_assignment(cfg, current, db, res.assignment,
                                          cache=cache)
                loss_before = float(entry["loss_before_ft"])
            else:
                t0 = time.perf_counter()
                res = search(db, table, target, steps=search_steps,
                             pop=search_pop, batched=search_batched,
                             seed=seeds[i], mesh=mesh,
                             eval_fn=lambda a: loss_eval(
                                 cache.apply(current, a)),
                             eval_batched=make_batched_eval(
                                 cfg, current, cache, calib_batches[:1],
                                 device=dev))
                masked = apply_assignment(cfg, current, db, res.assignment,
                                          cache=cache)
                loss_before = loss_eval(masked)
                stage_t["search"] = time.perf_counter() - t0
                frs.record(tkey, "search", loss_before_ft=loss_before,
                           stage_times=dict(stage_t),
                           **_result_payload(res))
                preempt_at(i, "search")
            del cache

            # ---- stage: distillation finetune ----
            t0 = time.perf_counter()
            # the step keeps only the masks' leaves with a zero; the full
            # tree of ones is not held through the finetune
            # the mesh trainer with specs; without them each rank runs the
            # single-process finetune, the first alone checkpointing
            use_mesh = mesh if specs is not None else None
            trainer = Trainer(cfg, tcfg, ckpt_dir=os.path.join(tdir, "ckpt"),
                              teacher_params=teacher,
                              masks=masks_from_assignment(
                                  cfg, masked, db, res.assignment),
                              ckpt_every=ckpt_every, device=dev,
                              mesh=use_mesh, mc=mc, specs=specs,
                              ckpt_mesh=mesh)
            try:
                state = trainer.init_or_restore(masked)
                start = int(state.step)
                data_iter = data(i * finetune_steps + start) \
                    if callable(data) else data
                fit_stop = None
                if stop_after is not None and tuple(stop_after[:2]) == \
                        (i, "finetune") and len(stop_after) > 2:
                    fit_stop = int(stop_after[2])
                if start < finetune_steps:
                    frs.log_exec(tkey, "finetune")
                state = trainer.fit(state, data_iter, steps=finetune_steps,
                                    stop_after=fit_stop,
                                    save_last=keep_checkpoints)
            finally:
                trainer.ckpt.close()
            if int(state.step) < finetune_steps:
                # a simulated stop_after kill: the trainer checkpointed,
                # and calling again resumes from that step (barrier: the
                # previous target's export must be as durable as a serial
                # run's before the preemption is reported)
                _barrier()
                raise FamilyPreempted(
                    f"preempted mid-finetune of target {target} at step "
                    f"{int(state.step)} (run dir {run_dir})")
            current = trainer.params_of(state)
            del state, masked, trainer
            if not keep_checkpoints and first:
                shutil.rmtree(os.path.join(tdir, "ckpt"))
            stage_t["finetune"] = time.perf_counter() - t0

            # ---- export tail: beside the next target's stages (it only
            # reads the finished `current`), or inline when serial
            tail_args = (i, target, tkey, tdir, db, res, loss_before,
                         current, stage_t)
            if overlap:
                _join_exports()          # at most one export in flight
                th = threading.Thread(target=export_tail_bg,
                                      args=tail_args, daemon=True)
                exports.append(th)
                th.start()
            else:
                export_tail(*tail_args)
        _barrier()
        return [out[i] for i in range(len(targets))]
    finally:
        _join_exports(raise_errors=False)
        try:
            mgr.close()
        except CheckpointWriteError:
            # on an exception path the original error wins (a preempting
            # _barrier() already surfaced write failures); raise only when
            # nothing else is propagating
            if sys.exc_info()[0] is None:
                raise
