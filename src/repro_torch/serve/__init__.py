"""Continuous-batching serving engine for dense and ZipLM-pruned families.

This is the end of the paper's inference-aware story: models pruned for a
concrete inference environment are served in one, and the wins show up as
measured tokens/s, per-request latency and KV-cache bytes.

Slot lifecycle
--------------
The engine owns ``num_slots`` decode slots backed by one batched KV cache
with a per-slot position vector (``cache["pos"]: (B,)``):

1. **admit**: when a slot is free and a request has arrived, its prompt
   is prefilled alone at a power-of-two padded bucket length (padding
   rows are never attended); on the card the prefill's attention is the
   flash-attention kernel, whatever the config's ``attn_impl`` says;
2. **insert**: the prefilled KV rows and the prompt length land in the
   free slot (in place), and the prefill's last-position logits give the
   request's first token;
3. **decode**: all occupied slots advance together, one batched decode
   step per token, each slot masking and writing at its own absolute
   position, so requests of different lengths and phases share every
   step (no head-of-line blocking on the longest request);
4. **retire**: a slot whose request has generated its ``steps`` tokens is
   freed at once and can be refilled at the next admit.

Cache sizing contract
---------------------
``max_len`` bounds ``prompt_len + steps`` for every request; the engine
rejects anything that would decode past it, because the decode write
index clamps at the last cache slot and would corrupt output. Pruned
members allocate their cache from the shrunk per-layer structure
(``init_cache(kv_heads=[...])``): a layer that kept ``g`` KV groups pays
for ``g`` heads, a dropped attention module pays nothing.

Family routing
--------------
:class:`~repro_torch.serve.family.FamilyServer` stitches every speedup
target of a family on the device from one resident ``SnapshotCache`` and
routes each request by its latency class to the smallest member target
that meets the class's speedup demand.

A decode step goes through the ``serve.step`` fault site: a failed step
(an injected fault, or non-finite logits on an active slot) is counted
and recomputed, at most ``engine._STEP_RETRIES`` times; a prefill's
non-finite logits raise.
"""
from .engine import (DenseServeModel, PrunedServeModel, RequestRecord,
                     ServeEngine, ServeReport)
from .family import DENSE_TARGET, FamilyServer
from .workload import (CLASS_SPEEDUP, LATENCY_CLASSES, Request,
                       synthetic_requests)

__all__ = [
    "DenseServeModel", "PrunedServeModel", "ServeEngine", "ServeReport",
    "RequestRecord", "FamilyServer", "DENSE_TARGET", "Request",
    "synthetic_requests", "CLASS_SPEEDUP", "LATENCY_CLASSES",
]
