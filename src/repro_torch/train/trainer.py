"""Training loop with fault tolerance:

* auto-resume from the latest valid checkpoint (hash-verified);
* periodic async checkpoints (at ``ckpt_every`` multiples and at
  ``steps``) and an immediate, blocking one on preemption (SIGTERM with
  ``install_signal_handler``); ``fit`` ends with ``wait()``, so the last
  checkpoint is on disk when it returns;
* straggler watchdog: per-step wall time tracked, steps slower than
  ``factor`` x the running median are recorded;
* loss guard (``nan_guard``, on by default): a non-finite loss — or,
  with ``spike_factor > 0``, a loss above ``spike_factor`` x the running
  median — skips the step and discards its update (the step never writes
  the state it is given, so params, m, v and count stay as they were).
  After ``max_bad_steps`` bad steps in a row the last checkpoint is
  reloaded; a second reload with no progress in between raises. Guard
  events are in ``self.guard``, and each bad step counts as detected
  and (once skipped or reloaded) recovered at ``train.step`` in the
  ambient robustness report. The guard reads the loss value ``fit``
  already syncs on, so a clean run is bit-identical with the guard on or
  off.

The trainer runs on the card unless the caller passes ``device="cpu"``.
The mesh path (FSDP shardings, a sharded teacher, ``int8_ef``) is not
ported: ``mesh=`` raises.
"""
from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..checkpoint.manager import CheckpointManager
from ..configs.base import TrainConfig
from ..models.transformer import tree_to
from ..robustness.report import current_report
from ..runtime.device import DeviceLike, resolve_device
from .train_step import TrainState, make_train_state, make_train_step


@dataclass
class StragglerWatchdog:
    factor: float = 3.0
    window: int = 50
    times: List[float] = field(default_factory=list)
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        slow = len(self.times) >= 5 and dt > self.factor * med
        if slow:
            self.flagged.append(step)
        return slow


class Trainer:
    def __init__(self, cfg, tcfg: TrainConfig, *, ckpt_dir: str,
                 teacher_params=None, masks=None, ckpt_every: int = 50,
                 keep: int = 3, step_fn=None, log_every: int = 10,
                 install_signal_handler: bool = False, mesh=None,
                 nan_guard: bool = True, max_bad_steps: int = 3,
                 spike_factor: float = 0.0, device: DeviceLike = None):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): the port's mesh trainer (FSDP shardings, "
                "int8_ef) is not ported yet (ROADMAP Queue 1 item 6c)")
        self.cfg = cfg
        self.tcfg = tcfg
        if step_fn is None:
            step_fn = make_train_step(cfg, tcfg,
                                      teacher_params=teacher_params,
                                      masks=masks, device=self.device)
        self.step_fn = step_fn
        self.ckpt = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.log_every = log_every
        self.watchdog = StragglerWatchdog()
        self.nan_guard = nan_guard
        self.max_bad_steps = max_bad_steps
        self.spike_factor = spike_factor
        self.guard = {"skipped": [], "reloads": 0}
        self._bad_streak = 0
        self._loss_hist: List[float] = []
        self._reload_marker: Optional[int] = None
        self.preempted = False
        self.metrics_log: List[Dict] = []
        if install_signal_handler:
            signal.signal(signal.SIGTERM, self._on_preempt)

    def _on_preempt(self, *_):
        self.preempted = True

    def _loss_is_bad(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return True
        if self.spike_factor > 0 and len(self._loss_hist) >= 5:
            return loss > self.spike_factor * float(
                np.median(self._loss_hist))
        return False

    def init_or_restore(self, params) -> TrainState:
        """A fresh state for ``params`` (moved to the trainer's device), or
        the latest valid checkpoint restored into its structure."""
        state = make_train_state(self.cfg, tree_to(params, self.device),
                                 self.tcfg)
        latest = self.ckpt.latest_step()
        if latest is not None:
            print(f"[trainer] resumed from step {latest}")
            return self.ckpt.restore(state, latest)
        return state

    def fit(self, state: TrainState, data: Iterator[Dict],
            steps: int, stop_after: Optional[int] = None,
            save_last: bool = True) -> TrainState:
        """Run up to ``steps`` total steps (absolute), resumable;
        ``stop_after`` is a simulated preemption point for tests.
        ``save_last=False`` writes no checkpoint at step ``steps``, for a
        caller that removes the checkpoints once the fit returns; those at
        ``ckpt_every`` multiples before it, and a preemption's, are
        written as always."""
        done = int(state.step)
        while done < steps:
            if stop_after is not None and done >= stop_after:
                break
            batch = next(data)
            t0 = time.perf_counter()
            new_state, metrics = self.step_fn(state, batch)
            # float() waits for the step: the guard reads a value the loop
            # syncs on anyway
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if self.nan_guard and self._loss_is_bad(loss):
                rep = current_report()
                rep.count("detected", "train.step")
                self._bad_streak += 1
                self.guard["skipped"].append(done + 1)
                print(f"[trainer] bad loss {loss!r} at step {done + 1}; "
                      f"skipping (streak {self._bad_streak})")
                if self._bad_streak >= self.max_bad_steps:
                    if self._reload_marker == done:
                        raise RuntimeError(
                            f"training cannot progress past step {done}: "
                            f"{self.max_bad_steps} consecutive bad steps "
                            "again after a checkpoint reload")
                    self._reload_marker = done
                    restored = self.ckpt.restore(state)
                    if restored is not None:
                        state = restored
                    self.guard["reloads"] += 1
                    self._bad_streak = 0
                    done = int(state.step)
                    print(f"[trainer] {self.max_bad_steps} consecutive bad "
                          f"steps; reloaded the checkpoint at step {done}")
                rep.count("recovered", "train.step")
                continue  # the update is discarded
            self._bad_streak = 0
            if self.nan_guard:
                self._loss_hist.append(loss)
                if len(self._loss_hist) > 50:
                    self._loss_hist.pop(0)
            state = new_state
            done = int(state.step)
            self.watchdog.observe(done, dt)
            if done % self.log_every == 0 or done == steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = done
                m["step_time"] = dt
                self.metrics_log.append(m)
            last = done == steps
            if self.preempted or ((last or done % self.ckpt_every == 0)
                                  and (save_last or not last)):
                self.ckpt.save(done, state, blocking=self.preempted)
            if self.preempted:
                print(f"[trainer] preempted at step {done}; checkpointed")
                break
        self.ckpt.wait()
        return state
