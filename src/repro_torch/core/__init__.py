"""ZipLM core on PyTorch: structured-OBS pruning, latency tables, SPDY
search, the one-shot pipeline (``oneshot_prune``) and the gradual family
engine (``gradual_prune``, resumable from its ``family.json`` manifest)."""
from .database import (ModuleDB, SnapshotCache, apply_assignment,
                       build_database)
from .hessian import collect_hessians
from .latency import LatencyTable, build_table
from .latency_cache import LatencyCache
from .obs import (build_hessian, module_drop_error, prune_structured,
                  prune_structured_compact)
from .oneshot import OneShotResult, PrunedVariant, oneshot_prune
from .pipeline import (FamilyPreempted, FamilyRunState, GradualVariant,
                       family_run_dir, family_run_key, gradual_prune,
                       masks_from_assignment)
from .shrink import shrink, shrink_from_stitched
from .spdy import (SearchResult, dp_select, dp_select_batched, search,
                   search_family)

__all__ = ["FamilyPreempted", "FamilyRunState", "GradualVariant",
           "LatencyCache", "LatencyTable", "ModuleDB", "OneShotResult",
           "PrunedVariant", "SearchResult", "SnapshotCache",
           "apply_assignment", "build_database", "build_hessian",
           "build_table", "collect_hessians", "dp_select",
           "dp_select_batched", "family_run_dir", "family_run_key",
           "gradual_prune", "masks_from_assignment", "module_drop_error",
           "oneshot_prune", "prune_structured", "prune_structured_compact",
           "search", "search_family", "shrink", "shrink_from_stitched"]
