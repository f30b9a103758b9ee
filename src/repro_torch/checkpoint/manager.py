"""Fault-tolerant checkpointing of trees of tensors.

* atomic: write to a pid-unique tmp file, then ``os.replace``, and a
  manifest with each file's sha256 — a killed writer can never corrupt the
  latest checkpoint, and ``latest_step`` skips a file whose hash no longer
  matches;
* async: a background thread drains a *bounded* queue (``max_queue``) of
  host-side copies and pre-serialized blobs (``submit_blob``), so the
  training loop is blocked only for the device->host copy, which ``save``
  makes before it returns (later in-place writes to the tensors cannot
  reach a queued checkpoint) — or on backpressure when the disk falls
  ``max_queue`` items behind;
* retention: keep the last ``keep`` checkpoints;
* surfaced write errors: the worker's failures are drained and raised as
  :class:`CheckpointWriteError` from ``wait()``/``close()`` (a failed
  write must never report success and resume from a stale step);
  transient ``OSError``\\ s are first retried with bounded backoff
  (``robustness.healing.retry_io``) through the ``ckpt.async_write``
  fault site (pre-serialized blobs through ``db.artifact_write``), whose
  ``corrupt`` mode flips bytes after the write.

A tree is nested dicts (and named tuples, such as a ``TrainState``) of
tensors; ``None`` leaves are skipped. It is stored flat, one npz entry per
tensor under its path (``"a/b/c"``, the reference's keys for dict trees),
as host arrays; ``restore_pytree`` puts each back on its template leaf's
device and dtype. bfloat16 tensors are stored as float32 (exact both ways).

Ranks (``mesh=``): the mesh's first rank alone writes (its directory,
files, manifest and retention); ``save(..., shardings=)`` first gathers
each rank's slices into the whole tree (a collective), so a file always
holds the whole state. ``wait`` is a barrier that also shares a failed
write; ``latest_step`` is the first rank's answer, broadcast; and
``restore(..., shardings=)`` gives every rank its slice of each leaf. So
a checkpoint written by any number of ranks restores on any other
number whose slices divide it, one process included (the reference's
restore onto another mesh). The int8 residual rows (``(nshards,
*shape)``) need the same number of data shards.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..distributed.sharding import gather_tree, shard_of
from ..robustness import faults
from ..robustness.healing import retry_io
from ..robustness.integrity import file_sha256
from ..runtime.device import to_host


class CheckpointWriteError(RuntimeError):
    """One or more checkpoint writes failed (after bounded retries).
    ``errors`` carries the drained worker exceptions."""

    def __init__(self, errors):
        self.errors = list(errors)
        super().__init__(
            f"{len(self.errors)} checkpoint write(s) failed: "
            + "; ".join(repr(e) for e in self.errors[:3]))


def atomic_write_json(path: str, obj) -> None:
    """Write JSON via a pid-unique tmp file + ``os.replace``: a killed
    writer never leaves a half-written file, and two processes writing
    one path never share a tmp file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def load_json(path: str) -> Optional[Dict]:
    """Read a JSON file; None (never raises) on a missing, unreadable or
    corrupted file — callers treat that as a manifest miss."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None


def _children(node):
    if isinstance(node, dict):
        return node.items()
    return node._asdict().items()  # a named tuple


def _is_leaf(node) -> bool:
    return not isinstance(node, dict) and not (
        isinstance(node, tuple) and hasattr(node, "_fields"))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cuda":
            return to_host(t)
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Host copies of the tree's leaves under their ``"a/b/c"`` paths."""
    if _is_leaf(tree):
        return {} if tree is None else {prefix: _host(tree)}
    flat = {}
    for k, v in _children(tree):
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _unflatten(template, data, prefix: str = "", specs=None, mesh=None):
    """``template``'s structure from the flat arrays ``data``; with
    ``specs`` (a tree of specs mirroring it) each leaf is this rank's
    slice of the stored whole."""
    if _is_leaf(template):
        if template is None:
            return None
        arr = torch.from_numpy(np.asarray(data[prefix]))
        if specs is not None:
            arr = shard_of(arr, specs, mesh).clone()
        return arr.to(device=template.device, dtype=template.dtype
                      ).reshape(template.shape)
    out = {}
    for k, v in _children(template):
        sub = None if specs is None else (
            specs[k] if isinstance(specs, dict) else getattr(specs, k))
        out[k] = _unflatten(v, data, f"{prefix}/{k}" if prefix else str(k),
                            sub, mesh)
    return out if isinstance(template, dict) else type(template)(**out)


def atomic_save_npz(path: str, arrays: Dict[str, np.ndarray]) -> str:
    """Atomic ``np.savez`` via a pid-unique tmp file + ``os.replace`` (same
    contract as :func:`atomic_write_json`); returns the file's sha256."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:  # a file object: np.savez adds no suffix
        np.savez(f, **arrays)
    digest = file_sha256(tmp)
    os.replace(tmp, path)
    return digest


def npz_bytes(arrays: Dict[str, np.ndarray]) -> tuple:
    """Serialize ``arrays`` to in-memory npz bytes; returns ``(data,
    sha256)``. ``np.savez`` to a BytesIO is deterministic, so the digest
    recorded before an async enqueue is the digest of the bytes that later
    reach the disk (``CheckpointManager.submit_blob``)."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    return data, hashlib.sha256(data).hexdigest()


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write raw bytes via a pid-unique tmp file + ``os.replace``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def save_pytree(tree, path: str) -> str:
    """Atomic synchronous save. Returns the file's sha256."""
    return atomic_save_npz(path, _flatten(tree))


def restore_pytree(template, path: str, shardings=None, mesh=None):
    """Restore into ``template``'s structure, each leaf on its template
    leaf's device and dtype; with ``shardings`` (a spec tree mirroring
    it, on ``mesh``) each leaf is this rank's slice of the stored
    whole."""
    with np.load(path) as data:
        return _unflatten(template, data, specs=shardings, mesh=mesh)


class CheckpointManager:
    """Step checkpoints in ``directory`` with a sha256 manifest.

    ``max_queue`` bounds the async queue depth: a producer streaming
    blobs faster than the disk drains them blocks on ``put``
    (backpressure) instead of accumulating them in host memory.
    """

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True, max_queue: int = 8, mesh=None):
        self.dir = directory
        self.keep = keep
        self.mesh = mesh
        # with ranks, the first one alone writes
        self.writer = mesh is None or mesh.index() == 0
        if self.writer:
            os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._async = async_save
        self._worker: Optional[threading.Thread] = None
        self._errors: list = []
        if async_save and self.writer:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _ckpt_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.npz")

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, "manifest.json")

    def save(self, step: int, tree, blocking: bool = False,
             shardings=None):
        """Checkpoint ``tree`` at ``step``; with ``shardings`` (its spec
        tree) ``tree`` is this rank's slices, gathered whole first (every
        rank of the mesh calls it)."""
        if shardings is not None:
            tree = gather_tree(tree, shardings, self.mesh)
        if not self.writer:
            return
        host = _flatten(tree)  # the device->host copy happens here
        if self._async and not blocking:
            self._q.put(("ckpt", step, host))
        else:
            self._write(step, host)

    def submit_blob(self, path: str, data: bytes):
        """Queue pre-serialized bytes (see :func:`npz_bytes`) for an atomic
        async write to ``path`` through the ``db.artifact_write`` fault
        site (the family engine's stage artifacts stream through here). The caller
        records the sha256 of ``data`` before enqueueing; a write that
        fails after bounded retries surfaces from ``wait()``/``close()``.
        A rank other than the writer writes nothing."""
        if not self.writer:
            return
        if self._async:
            self._q.put(("blob", path, data))
        else:
            self._write_blob(path, data)

    def _drain(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if item[0] == "blob":
                    _, path, data = item
                    self._write_blob(path, data)
                else:
                    _, step, host = item
                    self._write(step, host)
            except Exception as e:  # surfaced by wait()/close()
                self._errors.append(e)
            finally:
                # task_done after the write is on disk: wait() must not
                # return while a checkpoint is in flight
                self._q.task_done()

    @staticmethod
    def _write_blob(path: str, data: bytes):
        _, rule = retry_io(lambda: atomic_write_bytes(path, data),
                           site="db.artifact_write")
        faults.corrupt_if(rule, path)

    def _write(self, step: int, host: Dict[str, np.ndarray]):
        path = self._ckpt_path(step)
        # a persistent failure re-raises into _drain's error list and
        # surfaces at wait(); a corrupt rule leaves a file whose sha256 no
        # longer matches the manifest, which latest_step() then skips
        digest, rule = retry_io(lambda: atomic_save_npz(path, host),
                                site="ckpt.async_write")
        faults.corrupt_if(rule, path)
        manifest = self._read_manifest()
        manifest["checkpoints"] = [c for c in manifest.get("checkpoints", [])
                                   if c["step"] != step]
        manifest["checkpoints"].append(
            {"step": step, "file": os.path.basename(path),
             "sha256": digest, "time": time.time()})
        manifest["checkpoints"].sort(key=lambda c: c["step"])
        while len(manifest["checkpoints"]) > self.keep:  # retention
            old = manifest["checkpoints"].pop(0)
            try:
                os.remove(os.path.join(self.dir, old["file"]))
            except OSError:
                pass
        atomic_write_json(self._manifest_path(), manifest)

    def _read_manifest(self) -> Dict:
        return load_json(self._manifest_path()) or {}

    def wait(self):
        """Block until every queued save is on disk, then raise
        :class:`CheckpointWriteError` if any write failed. ``join()``
        returns only once the worker has called ``task_done`` for each
        item, after its ``os.replace``, so ``latest_step()`` after
        ``wait()`` sees the newest checkpoint. Errors are drained on
        raise, so a caller that handles the failure can keep using the
        manager. With ranks it is a barrier: every rank returns once the
        writer's queue is on disk, and raises if the writer's failed."""
        self._q.join()
        if self.mesh is not None and self.mesh.any(bool(self._errors)) \
                and not self._errors:
            raise CheckpointWriteError(
                [RuntimeError("a checkpoint write of the first rank failed")])
        self._raise_pending_errors()

    def _raise_pending_errors(self):
        if self._errors:
            errs, self._errors = self._errors, []
            raise CheckpointWriteError(errs)

    def latest_step(self) -> Optional[int]:
        """The newest step whose file matches its recorded sha256 (with
        ranks, the writer's answer on every rank)."""
        if self.mesh is not None:
            return self.mesh.broadcast_object(
                self._latest_step() if self.writer else None)
        return self._latest_step()

    def _latest_step(self) -> Optional[int]:
        for c in reversed(self._read_manifest().get("checkpoints", [])):
            path = os.path.join(self.dir, c["file"])
            if os.path.exists(path) and file_sha256(path) == c["sha256"]:
                return c["step"]
        return None

    def restore(self, template, step: Optional[int] = None,
                shardings=None):
        """The checkpoint at ``step`` (the latest valid one by default;
        None if there is none) in ``template``'s structure; with
        ``shardings``, this rank's slices (``template`` holds slices
        too)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return restore_pytree(template, self._ckpt_path(step), shardings,
                              self.mesh)

    def close(self):
        if self._worker is not None:
            self._q.put(None)
            self._worker.join(timeout=10)
            self._worker = None
        self._raise_pending_errors()
