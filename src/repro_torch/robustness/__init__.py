"""The robustness layer: deterministic fault injection, numerical
self-healing, a graceful-degradation ladder, and artifact integrity.

A fault-free run under this layer gives the bits of a run without it:
with no plan installed every site's ``hit`` returns None and nothing
else happens (no sync, no pass over a tensor, no copy), and a plan whose
rules never fire changes only its hit counters.

Fault sites (the JAX package's names, so one ``$ZIPLM_FAULTS`` string
means the same in both packages)
----------------------------------------------------------------------
======================  =================================================
``calib.batch``         NaN/Inf folded into one calibration batch's
                        captures (``core.hessian.collect_hessians``)
``obs.cholesky``        NaN/Inf folded into the inverse Hessian of one
                        damping rung (``core.database``)
``db.artifact_write``   raise / transient OSError / corrupt-after-write
                        on family stage artifacts (``core.pipeline``)
``ckpt.async_write``    the same on checkpoint writes
                        (``checkpoint.manager``)
``latency.measure``     raise / delay in module timing
                        (``core.latency._time_fn``)
``kernel.pallas``       raise at a CUDA kernel wrapper's dispatch
                        (``kernels.build.dispatch``)
``spdy.batched_eval``   raise in the population scorer
                        (``core.oneshot.make_batched_eval``)
``serve.step``          raise / NaN logits in a serving decode step
                        (``serve.engine``)
``db.sharded_group``    raise at a chunk of the sharded database build
                        (``core.database.build_database(mesh=...)``)
======================  =================================================

Configure a plan in code (``with install(FaultPlan.parse(
"obs.cholesky:nan@0")): ...``) or from the environment::

    ZIPLM_FAULTS="site:mode@nth[xCOUNT][~DELAY]" [ZIPLM_FAULT_SEED=s]

Healing and degradation
-----------------------
* poisoned calibration batch -> skipped and counted; the Hessians equal
  a clean run's over the other batches;
* non-finite OBS prune -> the damping ladder ``damp * 10**k``;
* transient write failure -> bounded retry with backoff
  (``healing.retry_io``); a persistent one surfaces as
  ``CheckpointWriteError`` from ``wait()``/``close()``; a corrupted
  artifact is quarantined (``*.corrupt``) on load and its stage runs
  again;
* failed decode step -> recomputed from the same cache, at most
  ``serve.engine._STEP_RETRIES`` times;
* trainer loss NaN/spike -> the step is skipped, and after
  ``max_bad_steps`` the last checkpoint is reloaded;
* measured-latency failure -> the ``latency.measure`` breaker opens, the
  cache entry is quarantined and the cost model prices the table;
* batched SPDY scoring failure -> the ``spdy.batched_eval`` breaker
  opens and the search scores serially (same memo, same acceptances);
* sharded database chunk failure -> the ``db.sharded_group`` breaker
  opens and the chunk, and every later one, is built single-process on
  every rank (bit for bit the sharded result).

Where the port differs from the JAX package: an injected
``kernel.pallas`` failure raises out of the wrapper (no breaker, no
fall-back to the plain version, the launch counter unchanged), and only
a fault injected at the rung's own site or ``torch.cuda.OutOfMemoryError``
demotes ``latency.measure`` or ``spdy.batched_eval``
(``healing.demotable``), and only a fault injected at
``db.sharded_group`` demotes a sharded database chunk: any other error
raises, a ``kernel.pallas``
fault inside the scored or timed forward included, so a failed
CUDA-graph capture or kernel is never hidden behind the cost model or
the serial search. An env without a ``HardwareSpec`` has no
cost model to demote to, so its measurement failure raises a ValueError.

A :class:`RobustnessReport` is ambient via :func:`report_scope`;
``gradual_prune(report=...)`` scopes one per family run and dumps it in
the ``family.json`` manifest.
"""
from .faults import (INJECTED, FaultInjected, FaultIOError, FaultPlan,
                     FaultRule, SITES, active_plan, corrupt_bytes,
                     corrupt_file, hit, install, poison_array, poison_scalar)
from .healing import all_finite, damp_schedule, retry_io
from .integrity import checked_npz_load, file_sha256, quarantine_file
from .report import BUCKETS, RobustnessReport, current_report, report_scope

__all__ = [
    "BUCKETS", "INJECTED", "FaultInjected", "FaultIOError", "FaultPlan",
    "FaultRule", "SITES", "RobustnessReport", "active_plan", "all_finite",
    "checked_npz_load", "corrupt_bytes", "corrupt_file", "current_report",
    "damp_schedule", "file_sha256", "hit", "install", "poison_array",
    "poison_scalar", "quarantine_file", "report_scope", "retry_io",
]
