"""Artifact integrity: sha256 verification on load, and quarantine.

A stage artifact whose recorded sha256 (the family manifest's) no longer
matches its bytes, or that fails to parse at all, is renamed
``*.corrupt`` (never deleted: the bytes are the bug report) and the load
returns None, which makes the owning stage run again instead of the
resume crashing. ``file_sha256`` is also the checkpoint manager's.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, Optional

import numpy as np

from .report import current_report


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def quarantine_file(path: str, site: str = "artifact") -> Optional[str]:
    """Rename ``path`` to a fresh ``*.corrupt[.N]`` sibling; returns the
    quarantine path (None if the rename itself failed)."""
    qpath = path + ".corrupt"
    n = 0
    while os.path.exists(qpath):
        n += 1
        qpath = f"{path}.corrupt.{n}"
    try:
        os.replace(path, qpath)
    except OSError:
        return None
    rep = current_report()
    rep.quarantine(qpath, site=site)
    rep.note(f"[robustness] quarantined corrupt artifact {path} -> {qpath}")
    return qpath


def checked_npz_load(path: str, expected_sha: Optional[str] = None,
                     site: str = "artifact", quarantine: bool = True
                     ) -> Optional[Dict]:
    """Load an ``.npz`` artifact with integrity checks.

    Returns ``{name: np.ndarray}`` fully read, or None when the file is
    missing (a plain miss, no quarantine), its sha256 does not match
    ``expected_sha``, or it fails to parse; the latter two quarantine the
    file unless ``quarantine=False`` (a reader that must not write).
    ``expected_sha=None`` skips the hash check but still catches an
    unparseable file."""
    if not os.path.exists(path):
        return None
    if expected_sha is not None and file_sha256(path) != expected_sha:
        if quarantine:
            quarantine_file(path, site=site)
        return None
    try:
        with np.load(path) as data:
            return {k: np.asarray(data[k]) for k in data.files}
    except Exception:  # any parse failure of the bytes: quarantine them
        if quarantine:
            quarantine_file(path, site=site)
        return None
