"""Multi-process launcher: the port's counterpart of the JAX package's
``launch/subproc.py``.

The JAX package drives its mesh code in one child interpreter with forced
host-platform devices. The port runs one process per rank over
``torch.distributed`` instead: :func:`run_ranks` starts ``n_ranks`` fresh
interpreters (``subprocess``, never ``fork``: a parent that has touched
CUDA cannot fork a child that uses it), each with ``RANK``,
``WORLD_SIZE``, one CPU thread and a ``file://`` rendezvous in a
temporary directory (no port, so concurrent launches cannot collide).
The rank script calls :func:`init_rank` first and reports through
:func:`emit_result`, one ``"RESULT" + json`` line.

Every group is gloo, on the CPU and on the card alike: NCCL refuses two
ranks on one device, and the collectives of the sharded calibration and
database move host arrays (``distributed.sharding.Mesh`` stages device
tensors through the host).

The hazard is a hang: a rank that raises leaves its peers blocked in a
collective. So every process group has a finite timeout, and the
launcher kills every rank as soon as one exits non-zero or the clock
runs out, then raises with each rank's stdout and stderr tails.
"""
from __future__ import annotations

import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
# what each rank's failure message keeps of its stdout and of its stderr
TAIL_CHARS = 3000


def _tail(path: str) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-TAIL_CHARS:]


def _tails(logs) -> str:
    return "\n".join(f"--- rank {r} stdout ---\n{_tail(out)}\n"
                     f"--- rank {r} stderr ---\n{_tail(err)}"
                     for r, (out, err) in enumerate(logs))


def run_ranks(script: str, n_ranks: int, *, device: str = "cuda",
              timeout: float = 900) -> List[Dict]:
    """Run the Python source ``script`` as ranks ``0..n_ranks-1`` of one
    process group; returns each rank's last RESULT line, parsed.

    ``device`` reaches the ranks as ``$ZIPLM_RANK_DEVICE`` (what
    :func:`init_rank` returns). ``PYTHONPATH`` is prepended to, not
    replaced. Raises RuntimeError with every rank's output tails when a
    rank exits non-zero, when ``timeout`` seconds pass (the ranks are
    killed first, so nothing is left running), or when a rank prints no
    RESULT line.
    """
    tmp = tempfile.mkdtemp(prefix="ziplm-ranks-")
    env = dict(os.environ)
    env["PYTHONPATH"] = _SRC + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env.update(WORLD_SIZE=str(n_ranks), OMP_NUM_THREADS="1",
               ZIPLM_RANK_DEVICE=device,
               ZIPLM_RENDEZVOUS=os.path.join(tmp, "rendezvous"))
    # gloo binds to the loopback interface unless the caller chose one
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, logs, files = [], [], []
    try:
        for r in range(n_ranks):
            out, err = (os.path.join(tmp, f"rank{r}.{s}")
                        for s in ("out", "err"))
            logs.append((out, err))
            files += [open(out, "w"), open(err, "w")]
            procs.append(subprocess.Popen(
                [sys.executable, "-u", "-c", script],
                env=dict(env, RANK=str(r)), stdin=subprocess.DEVNULL,
                stdout=files[-2], stderr=files[-1]))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                _kill(procs)
                raise RuntimeError(
                    f"rank(s) {failed} of {n_ranks} failed (exit codes "
                    f"{[p.returncode for p in procs]}); the others were "
                    f"killed:\n{_tails(logs)}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                _kill(procs)
                raise RuntimeError(
                    f"ranks timed out after {timeout}s and were killed; "
                    f"partial output:\n{_tails(logs)}")
            time.sleep(0.05)
        results = []
        for r, (out, _) in enumerate(logs):
            with open(out, errors="replace") as f:
                lines = [l for l in f.read().splitlines()
                         if l.startswith("RESULT")]
            if not lines:
                raise RuntimeError(f"rank {r} printed no RESULT line:\n"
                                   f"{_tails(logs)}")
            results.append(json.loads(lines[-1][len("RESULT"):]))
        return results
    finally:
        _kill(procs)
        for f in files:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _kill(procs) -> None:
    """Kill every rank still running and reap them all."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def init_rank(timeout: float = 300, device=None):
    """The rank side of :func:`run_ranks`: one CPU thread, the gloo
    process group (its collectives time out after ``timeout`` seconds),
    and the rank's device (``device``, else ``$ZIPLM_RANK_DEVICE``).
    Returns ``(rank, world_size, device)``; a ``"cuda"`` rank on a
    machine without a GPU raises. Without ``$ZIPLM_RENDEZVOUS`` (a rank
    that ``torchrun`` started) the group meets at ``env://``."""
    import torch
    import torch.distributed as dist

    from ..runtime.device import resolve_device

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = resolve_device(device if device is not None
                            else os.environ.get("ZIPLM_RANK_DEVICE"))
    where = os.environ.get("ZIPLM_RENDEZVOUS")
    dist.init_process_group(
        "gloo", init_method="file://" + where if where else "env://",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return rank, world, device


def emit_result(result: Dict) -> None:
    """Print the rank's RESULT line and leave the process group."""
    import torch.distributed as dist

    print("RESULT" + json.dumps(result), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
