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

Mesh path: pass ``mesh`` (a ``distributed.Mesh`` over the ranks of
``launch.subproc.run_ranks`` or ``torchrun``) and ``specs``
(``models.model_specs``; ``mc`` defaults to ``mesh_config_for(mesh)``),
and every rank of the mesh runs the same ``fit`` on the same batches:
each holds its FSDP slice of params, m, v and the teacher
(``train_step.state_shardings``), and ``grad_compression="int8_ef"``
compresses the all-reduce over the data axes, each rank carrying its
residual row. The first rank alone writes checkpoints, each the gathered
whole state (the residuals as ``(nshards, *shape)``), and every rank
restores its slices from them, so a checkpoint crosses between meshes
and one process. Every decision that ends or repeats a step is the same
on every rank: the guard reads the loss averaged over the ranks, and a
preemption or ``stop_after`` is shared through ``Mesh.any``, since a
rank that left the loop would strand the others in a collective.
``ckpt_mesh`` alone (no ``mesh``) keeps the single-process step on each
rank and makes only the checkpoints and the stops rank-aware: the
family engine's finetune without specs, where the reference keeps its
single-device finetune. It is an option of its own because ``mesh``
without ``specs`` must raise the reference's ValueError, and the other
ways in would each cost more: a checkpoint directory a rank breaks the
first rank's being the only writer, and a pipeline that swapped in its
own ``CheckpointManager`` would also have to reach the trainer's stop
agreement. A mesh whose ``"model"`` axis has more than one
rank raises NotImplementedError (ROADMAP Queue 1 item 6d).
"""
from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import MeshConfig, TrainConfig
from ..distributed.sharding import gather_tree, mesh_config_for, shard_tree
from ..models.transformer import tree_to
from ..optim.adamw import tree_map
from ..robustness.report import current_report
from ..runtime.device import DeviceLike, resolve_device
from .train_step import (TrainState, make_train_state, make_train_step,
                         refuse_model_axis, state_shardings)


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
                 mc: Optional[MeshConfig] = None, specs=None,
                 nan_guard: bool = True, max_bad_steps: int = 3,
                 spike_factor: float = 0.0, device: DeviceLike = None,
                 ckpt_mesh=None):
        self.device = resolve_device(device)
        if mesh is not None and specs is None:
            raise ValueError("Trainer(mesh=...) needs the model's logical "
                             "axis specs (models.model_specs, the "
                             "reference's model_init's second return)")
        refuse_model_axis(mesh)
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.mc = mc if mc is not None or mesh is None \
            else mesh_config_for(mesh)
        self.specs = specs
        self._st_sh = None  # the state's specs, set by init_or_restore
        # the ranks that agree on every stop and share the checkpoints
        self._sync = mesh if mesh is not None else ckpt_mesh
        if step_fn is None:
            step_fn = make_train_step(cfg, tcfg,
                                      teacher_params=teacher_params,
                                      masks=masks, mesh=mesh, mc=self.mc,
                                      specs=specs, device=self.device)
        self.step_fn = step_fn
        self.ckpt = CheckpointManager(ckpt_dir, keep=keep, mesh=self._sync)
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

    def _agree(self, flag: bool) -> bool:
        """``flag`` if it holds on any rank (one all-reduce on a mesh)."""
        return self._sync.any(flag) if self._sync is not None else flag

    def _reset_ef(self, state: TrainState) -> TrainState:
        """Zero the int8 error-feedback residual: EF accumulated under a
        corrupted gradient would replay the corruption into later steps."""
        if state.ef_err is None:
            return state
        return state._replace(ef_err=tree_map(torch.zeros_like,
                                              state.ef_err))

    def params_of(self, state: TrainState):
        """The whole params of ``state`` (on a mesh gathered from every
        rank's slices: a collective)."""
        if self.mesh is None:
            return state.params
        return gather_tree(state.params, self._st_sh.params, self.mesh)

    def _loss_is_bad(self, loss: float) -> bool:
        if not math.isfinite(loss):
            return True
        if self.spike_factor > 0 and len(self._loss_hist) >= 5:
            return loss > self.spike_factor * float(
                np.median(self._loss_hist))
        return False

    def init_or_restore(self, params) -> TrainState:
        """A fresh state for ``params`` (moved to the trainer's device), or
        the latest valid checkpoint restored into its structure; on a
        mesh, this rank's slices of it (``params`` whole on every
        rank)."""
        state = make_train_state(self.cfg, tree_to(params, self.device),
                                 self.tcfg, mesh=self.mesh, mc=self.mc)
        if self.mesh is not None:
            self._st_sh = state_shardings(self.mesh, self.mc, state,
                                          self.specs)
            state = shard_tree(state, self._st_sh, self.mesh)
        latest = self.ckpt.latest_step()
        if latest is not None:
            print(f"[trainer] resumed from step {latest}")
            return self.ckpt.restore(state, latest, shardings=self._st_sh)
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
            if self._agree(stop_after is not None and done >= stop_after):
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
                    restored = self.ckpt.restore(state,
                                                 shardings=self._st_sh)
                    state = (restored if restored is not None
                             else self._reset_ef(state))
                    self.guard["reloads"] += 1
                    self._bad_streak = 0
                    done = int(state.step)
                    print(f"[trainer] {self.max_bad_steps} consecutive bad "
                          f"steps; reloaded the checkpoint at step {done}")
                else:
                    # the update is discarded; the prior state goes on with
                    # its EF residual cleared
                    state = self._reset_ef(state)
                rep.count("recovered", "train.step")
                continue
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
            self.preempted = self._agree(self.preempted)
            if self.preempted or ((last or done % self.ckpt_every == 0)
                                  and (save_last or not last)):
                self.ckpt.save(done, state, blocking=self.preempted,
                               shardings=self._st_sh)
            if self.preempted:
                print(f"[trainer] preempted at step {done}; checkpointed")
                break
        self.ckpt.wait()
        return state
