"""Deterministic, seeded fault injection.

A :class:`FaultPlan` is a set of :class:`FaultRule`\\ s over named sites.
Each site keeps a hit counter; a rule fires on hits ``[nth, nth+count)``
of its site. Injection is a pure function of (plan, call sequence), so a
failure observed under a plan reproduces bit for bit from its spec
string: there is no wall-clock or RNG-draw dependence anywhere.

Spec grammar (``FaultPlan.parse`` / ``$ZIPLM_FAULTS``), the JAX
package's, so one spec string means the same in both packages::

    spec  := rule ("," rule)*
    rule  := site ":" mode ["@" nth] ["x" count] ["~" delay_s]
    mode  := raise | oserror | nan | inf | corrupt | delay

``site:mode`` alone means "the first hit, once". Examples::

    obs.cholesky:nan@0             NaN-poison the first inverse Hessian
    ckpt.async_write:oserror@1x2   fail async checkpoint writes #2 and #3
    latency.measure:delay~0.2      sleep 0.2 s inside the first timing call

Modes ``raise``/``oserror`` raise (:class:`FaultInjected` /
:class:`FaultIOError`, the latter an ``OSError`` so the transient-I/O
retry paths are the ones exercised); ``delay`` sleeps; ``nan``/``inf``/
``corrupt`` return the fired rule for the site to act on (a poison
scalar, byte flips).

The sites are the JAX package's. ``kernel.pallas`` keeps its name so that spec strings carry across; in
the port it marks the dispatch of a CUDA kernel's wrapper.
"""
from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .report import current_report

SITES = ("calib.batch", "obs.cholesky", "db.artifact_write",
         "ckpt.async_write", "latency.measure", "kernel.pallas",
         "spdy.batched_eval", "serve.step", "db.sharded_group")
MODES = ("raise", "oserror", "nan", "inf", "corrupt", "delay")


def _check_site(site: str) -> None:
    if site not in SITES:
        raise ValueError(f"unknown fault site {site!r}; sites: {SITES}")


class FaultInjected(RuntimeError):
    """An injected (not organic) failure, raised by ``raise`` rules.
    ``site`` is the site whose rule fired."""

    def __init__(self, msg: str, site: str = ""):
        super().__init__(msg)
        self.site = site


class FaultIOError(OSError):
    """Injected transient I/O failure; an ``OSError`` so the bounded-retry
    paths that heal real transient I/O errors are the ones exercised
    (``raise`` mode tests the unhandled path instead). ``site`` is the
    site whose rule fired."""

    def __init__(self, msg: str, site: str = ""):
        super().__init__(msg)
        self.site = site


INJECTED = (FaultInjected, FaultIOError)


@dataclass
class FaultRule:
    site: str
    mode: str
    nth: int = 0          # first hit index (0-based) the rule fires on
    count: int = 1        # number of consecutive hits it fires on
    delay_s: float = 0.05

    def __post_init__(self):
        _check_site(self.site)
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"modes: {MODES}")

    def fires(self, hit_index: int) -> bool:
        return self.nth <= hit_index < self.nth + self.count


class FaultPlan:
    """Seeded rule set with per-site hit counters (thread-safe: the
    checkpoint worker and a family's export thread hit sites off the
    main thread)."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self.hits: Dict[str, int] = {}
        self.fired: List[Dict] = []
        self._lock = threading.Lock()

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            try:
                site, rest = part.split(":", 1)
                delay = 0.05
                if "~" in rest:
                    rest, d = rest.split("~", 1)
                    delay = float(d)
                count = 1
                if "x" in rest:
                    rest, c = rest.split("x", 1)
                    count = int(c)
                nth = 0
                if "@" in rest:
                    rest, n = rest.split("@", 1)
                    nth = int(n)
                rules.append(FaultRule(site=site.strip(), mode=rest.strip(),
                                       nth=nth, count=count, delay_s=delay))
            except ValueError as e:
                raise ValueError(
                    f"bad fault rule {part!r} (grammar: "
                    f"site:mode[@nth][xCOUNT][~DELAY]): {e}") from e
        return cls(rules, seed=seed)

    @classmethod
    def from_env(cls, environ=None) -> Optional["FaultPlan"]:
        env = os.environ if environ is None else environ
        spec = env.get("ZIPLM_FAULTS")
        if not spec:
            return None
        return cls.parse(spec, seed=int(env.get("ZIPLM_FAULT_SEED", "0")))

    def check(self, site: str) -> Optional[FaultRule]:
        """Advance ``site``'s hit counter; return the rule that fires on
        this hit (if any) and record the event."""
        with self._lock:
            idx = self.hits.get(site, 0)
            self.hits[site] = idx + 1
            for rule in self.rules:
                if rule.site == site and rule.fires(idx):
                    self.fired.append(
                        {"site": site, "mode": rule.mode, "hit": idx})
                    return rule
        return None


# ----------------------------------------------------------------------
# ambient plan
# ----------------------------------------------------------------------

_ACTIVE: List[Optional[FaultPlan]] = [None]
_ENV_CHECKED = [False]


def active_plan() -> Optional[FaultPlan]:
    """The installed plan, else (once per process) one parsed from
    ``$ZIPLM_FAULTS``, cached so its hit counters persist."""
    if _ACTIVE[0] is not None:
        return _ACTIVE[0]
    if not _ENV_CHECKED[0]:
        _ENV_CHECKED[0] = True
        _ACTIVE[0] = FaultPlan.from_env()
    return _ACTIVE[0]


@contextmanager
def install(plan: Optional[FaultPlan]):
    """Make ``plan`` the ambient fault plan within the block."""
    prev, prev_env = _ACTIVE[0], _ENV_CHECKED[0]
    _ACTIVE[0], _ENV_CHECKED[0] = plan, True
    try:
        yield plan
    finally:
        _ACTIVE[0], _ENV_CHECKED[0] = prev, prev_env


# ----------------------------------------------------------------------
# site hooks
# ----------------------------------------------------------------------

def hit(site: str) -> Optional[FaultRule]:
    """One site hit. ``raise``/``oserror`` rules raise here, ``delay``
    sleeps; ``nan``/``inf``/``corrupt`` (and ``delay``) return the fired
    rule for the caller to act on. Returns None when nothing fires, the
    only path a fault-free run takes."""
    _check_site(site)
    plan = active_plan()
    if plan is None:
        return None
    rule = plan.check(site)
    if rule is None:
        return None
    current_report().count("injected", site)
    if rule.mode == "raise":
        raise FaultInjected(f"injected failure at {site} "
                            f"(hit {plan.hits[site] - 1})", site)
    if rule.mode == "oserror":
        raise FaultIOError(f"injected transient I/O failure at {site} "
                           f"(hit {plan.hits[site] - 1})", site)
    if rule.mode == "delay":
        time.sleep(rule.delay_s)
    return rule


_POISON = {"nan": float("nan"), "inf": float("inf")}


def poison_scalar(site: str) -> float:
    """1.0 (an IEEE-exact multiplicative identity) normally; NaN/Inf when
    a rule fires."""
    rule = hit(site)
    return 1.0 if rule is None else _POISON.get(rule.mode, 1.0)


def poison_array(site: str, arr):
    """``arr`` untouched normally (the same object, no pass over it);
    multiplied by NaN/Inf on its own device when a rule fires."""
    rule = hit(site)
    if rule is None or rule.mode not in _POISON:
        return arr
    return arr * _POISON[rule.mode]


def corrupt_bytes(path: str, seed: int = 0, n_flips: int = 32) -> bool:
    """Flip ``n_flips`` seeded byte positions of ``path`` in place (the
    same seed and file size give the same flips as the JAX package's)."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return False
    if size == 0:
        return False
    rng = np.random.default_rng([seed, size])
    pos = rng.integers(0, size, size=min(n_flips, size))
    with open(path, "r+b") as f:
        for p in sorted(set(int(x) for x in pos)):
            f.seek(p)
            b = f.read(1)
            f.seek(p)
            f.write(bytes([b[0] ^ 0xFF]))
    return True


def corrupt_if(rule: Optional[FaultRule], path: str) -> bool:
    """Flip bytes of ``path`` (seeded by the plan) when ``rule`` is a
    fired ``corrupt`` rule: the corrupt-after-write mode of the write
    sites. Returns whether the file was corrupted."""
    if rule is None or rule.mode != "corrupt":
        return False
    plan = active_plan()
    return corrupt_bytes(path, seed=plan.seed if plan else 0)


def corrupt_file(site: str, path: str) -> bool:
    """Hit ``site``; if a ``corrupt`` rule fires, flip bytes of ``path``
    (seeded by the plan). Returns whether the file was corrupted."""
    return corrupt_if(hit(site), path)
