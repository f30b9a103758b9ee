"""Build the port's CUDA kernels and load them through ``ctypes``.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` (Hopper)
into its own shared library with a plain C interface. The library name
carries a hash of the source, so an edited kernel is rebuilt and a stale
one is never loaded. Libraries go to ``build/kernels/`` at the root of
the checkout. ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the first launch of a kernel builds
(or finds) its library. Every wrapper's call passes :func:`dispatch`,
the ``kernel.pallas`` fault site, first.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

from ..robustness import faults

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def dispatch() -> None:
    """The ``kernel.pallas`` fault site, hit by each kernel wrapper's call
    before it dispatches, on either device. An injected failure raises
    out of the wrapper before a launch is counted: the port has no
    fall-back from a kernel to its plain version."""
    faults.hit("kernel.pallas")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that are not built yet, in parallel.

    Returns ``{name: ptxas report}`` for the sources compiled by this
    call (registers, shared memory and spills per kernel). Raises with
    the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, failed = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial library
        reports[name] = log
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return reports


def build_all() -> Dict[str, str]:
    return build(sorted(p.stem for p in CSRC.glob("*.cu")))


def load(name: str, signatures: Dict[str, List]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C entry to its ``argtypes``; every entry
    returns the ``cudaError_t`` of its launch as an int.
    """
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a launch error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def check_no_grad(what: str, *tensors) -> None:
    """Raise before a launch of a kernel without a backward (flash
    attention's) that autograd would need to see through: its output
    would carry no ``grad_fn``, and a backward pass would silently drop
    the gradients of its inputs."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, but the CUDA kernel has no "
            "backward yet; run it under torch.no_grad(), or train through "
            "a path without this kernel")
