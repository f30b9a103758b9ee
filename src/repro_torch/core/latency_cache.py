"""Persistent cache for measured latency tables.

``build_measured_table`` times every module kind over its (subsampled)
level grid: a CUDA graph captured and replayed for each point on the
card. ZipLM amortizes that cost over a family of compressed models; this
cache amortizes it over *runs*: repeated ``oneshot_prune`` and
``gradual_prune`` calls, and every target of a resumed gradual family,
read one measurement of the environment. A measured table is not
repeatable between builds, so the cache is also what lets a family
priced on the card's own timings resume bit for bit.

Cache key
---------
A table is valid only for the measurement that produced it. The key is
the SHA-256 of the canonical JSON of:

* ``cfg``: every field of the ``ModelConfig`` dataclass;
* ``env``: every field of the ``InferenceEnv``, the nested
  ``HardwareSpec`` included;
* the measuring device: its type, ``torch.__version__`` and
  ``torch.version.cuda``, and for a CUDA device its name and compute
  capability, so a table timed on the CPU never serves the card, nor one
  card another;
* the measurement parameters, with ``build_measured_table``'s defaults
  folded in;
* ``FORMAT_VERSION``.

Invalidation
------------
A lookup is a miss (``None``; the caller measures again) when no file
exists for the key; when the file does not parse or its payload hash
does not match (counted as ``cache_corrupt`` in ``latency.TIMING_STATS``);
or when its ``format_version`` or stored key differ (``cache_foreign``).
Flagged files are named in ``TIMING_STATS["cache_flagged"]`` and left in
place: ``put`` overwrites them atomically after the new measurement
(``checkpoint.manager.atomic_write_json``). So a bad file costs one
measurement, never a crash or a wrong number.

The directory resolves to, in order: the ``cache_dir`` argument,
``$ZIPLM_LATENCY_CACHE``, or ``~/.cache/ziplm/latency``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint.manager import atomic_write_json, load_json
from ..runtime import costmodel as cm
from ..runtime.device import DeviceLike, resolve_device
from .latency import TIMING_STATS, LatencyTable, build_measured_table

FORMAT_VERSION = 1


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def device_fingerprint(device: DeviceLike = None) -> Dict:
    """What the timings depend on besides the model: the device type,
    the torch and CUDA versions, and a CUDA device's name and compute
    capability."""
    dev = resolve_device(device)
    out = {"type": dev.type, "torch_version": torch.__version__,
           "cuda_version": torch.version.cuda}
    if dev.type == "cuda":
        out["name"] = torch.cuda.get_device_name(dev)
        out["capability"] = list(torch.cuda.get_device_capability(dev))
    return out


def _resolved_measure_kw(measure_kw: Dict) -> Dict:
    """Measure kwargs with ``build_measured_table``'s defaults folded in:
    an implicit-default call and an explicit one with the same values
    key alike, and a changed default invalidates the old tables."""
    sig = inspect.signature(build_measured_table)
    out = {name: p.default for name, p in sig.parameters.items()
           if p.default is not inspect.Parameter.empty}
    out.update(measure_kw)
    return out


def cache_key(cfg, env: cm.InferenceEnv, measure_kw: Dict,
              device: DeviceLike = None) -> Dict:
    measure_kw = _resolved_measure_kw(measure_kw)
    key = {"format_version": FORMAT_VERSION,
           "cfg": dataclasses.asdict(cfg),
           "env": dataclasses.asdict(env),   # its HardwareSpec included
           "device": device_fingerprint(device),
           "measure": {k: measure_kw[k] for k in sorted(measure_kw)}}
    return json.loads(_canon(key))  # as stored: tuples become lists


def _key_hash(key: Dict) -> str:
    return hashlib.sha256(_canon(key).encode()).hexdigest()


def _payload_hash(payload: Dict) -> str:
    return hashlib.sha256(_canon(payload).encode()).hexdigest()


def _table_payload(tab: LatencyTable) -> Dict:
    return {"base": float(tab.base),
            "grids": {k: np.asarray(v).tolist()
                      for k, v in tab.grids.items()},
            "times": {k: np.asarray(v).tolist()
                      for k, v in tab.times.items()}}


def default_cache_dir() -> str:
    return os.environ.get("ZIPLM_LATENCY_CACHE") \
        or os.path.expanduser("~/.cache/ziplm/latency")


class LatencyCache:
    """Versioned on-disk store of measured ``LatencyTable``s."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.dir = cache_dir or default_cache_dir()

    def _path(self, key: Dict) -> str:
        return os.path.join(self.dir, f"lat_{_key_hash(key)}.json")

    def get(self, cfg, env: cm.InferenceEnv, device: DeviceLike = None,
            **measure_kw) -> Optional[LatencyTable]:
        """The cached table of exactly this setup, or None (a miss).

        A file that exists but does not parse, or fails its payload hash,
        counts as ``cache_corrupt``; one whose format_version or key does
        not match counts as ``cache_foreign``; both add the file's name to
        ``cache_flagged``. The file is left in place."""
        key = cache_key(cfg, env, measure_kw, device)
        path = self._path(key)
        rec = load_json(path)
        flag = None
        if rec is None:
            if os.path.exists(path):
                flag = "corrupt"
        elif (rec.get("format_version") != FORMAT_VERSION
                or rec.get("key") != key):
            flag = "foreign"
        elif rec.get("payload_sha256") != _payload_hash(
                rec.get("payload", {})):
            flag = "corrupt"
        if rec is None or flag is not None:
            if flag is not None:
                TIMING_STATS[f"cache_{flag}"] += 1
                TIMING_STATS["cache_flagged"].append(os.path.basename(path))
            return None
        payload = rec["payload"]
        tab = LatencyTable(env=env, base=float(payload["base"]))
        for kind in payload["grids"]:
            tab.grids[kind] = np.asarray(payload["grids"][kind])
            tab.times[kind] = np.asarray(payload["times"][kind])
        return tab

    def put(self, cfg, env: cm.InferenceEnv, tab: LatencyTable,
            device: DeviceLike = None, **measure_kw) -> str:
        """Store a measured table; returns the file's path."""
        key = cache_key(cfg, env, measure_kw, device)
        payload = _table_payload(tab)
        rec = {"format_version": FORMAT_VERSION, "key": key,
               "payload": payload, "payload_sha256": _payload_hash(payload)}
        path = self._path(key)
        atomic_write_json(path, rec)
        return path

    def quarantine(self, cfg, env: cm.InferenceEnv,
                   device: DeviceLike = None,
                   **measure_kw) -> Optional[str]:
        """Rename this key's cache file to ``*.corrupt`` and record it in
        the ambient RobustnessReport (the measurement-failure demotion: an
        entry implicated in a failed measurement is not served again).
        Returns the quarantine path, or None when there was no file or
        the rename failed."""
        from ..robustness.integrity import quarantine_file
        path = self._path(cache_key(cfg, env, measure_kw, device))
        if not os.path.exists(path):
            return None
        return quarantine_file(path, site="latency.measure")
