"""repro_torch.reliability — the time axis of the serving cache.

  * ``lifetime`` — per-leaf retention state (``LifetimeState``) and the
                   resolve-once ``LifetimePlan`` whose per-floor Delta(T)
                   decay advances inside decode bursts without host syncs;
  * ``scrub``    — corrective re-write passes over the decay masks,
                   through the CUDA scrub kernel or its twin behind the
                   ``repro_torch.memory`` backend registry;
  * ``policy``   — host-side scrub scheduling (periodic, wear-aware,
                   quality-floor), which the serving scheduler consults
                   between bursts.

Wear leveling, the per-die and row-group state, and the checkpoint
integrity pass of ``repro.reliability`` belong to later slices.
"""
from repro_torch.reliability.lifetime import (  # noqa: F401
    MIN_P_STEP, RETENTION_DERATE, LifetimePlan, LifetimeState,
    retention_delta, retention_flip_p)
from repro_torch.reliability.policy import (  # noqa: F401
    PeriodicScrub, QualityFloorScrub, ScrubPolicy, WearAwareScrub,
    make_scrub_policy)
from repro_torch.reliability.scrub import scrub_tree  # noqa: F401
