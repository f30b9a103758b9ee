"""Synthetic request stream for the serving engine.

Requests arrive as a Poisson process (seeded exponential inter-arrival
times) with prompt and generation lengths drawn from small fixed menus,
and a latency class that the family server routes by. Prompts come from
the same deterministic Markov-Zipf corpus as calibration
(``data.synthetic``), numpy-seeded as in the JAX package, so the port and
the reference see identical streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..data.synthetic import synthetic_tokens

# latency class -> minimum family speedup it demands (family routing)
CLASS_SPEEDUP = {"relaxed": 1.0, "standard": 1.5, "strict": 2.0}
LATENCY_CLASSES = tuple(CLASS_SPEEDUP)


@dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (s,) prompt token ids
    steps: int                    # tokens to generate (incl. first)
    arrival: float                # seconds since stream start
    latency_class: str = "relaxed"

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])


def synthetic_requests(cfg, n: int, *, seed: int = 0, rate: float = 100.0,
                       prompt_lens: Sequence[int] = (8, 12, 16, 24),
                       steps_range: Tuple[int, int] = (4, 16),
                       classes: Optional[Sequence[str]] = None
                       ) -> List[Request]:
    """``n`` requests with Poisson arrivals at ``rate`` req/s.

    Deterministic in ``seed``; prompt contents are per-request slices of
    the shared synthetic corpus, so two streams with the same seed are
    identical request for request.
    """
    classes = tuple(classes) if classes else LATENCY_CLASSES
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    reqs = []
    for i in range(n):
        s = int(rng.choice(prompt_lens))
        steps = int(rng.integers(steps_range[0], steps_range[1] + 1))
        toks = synthetic_tokens(cfg.vocab_size, 1, s, seed=seed + 101,
                                step=i)[0]
        reqs.append(Request(rid=i, tokens=toks, steps=steps,
                            arrival=float(arrivals[i]),
                            latency_class=str(rng.choice(classes))))
    return reqs
