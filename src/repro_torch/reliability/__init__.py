"""repro_torch.reliability — the time axis of stored data.

  * ``lifetime`` — per-leaf retention state (``LifetimeState``) and the
                   resolve-once ``LifetimePlan`` whose per-floor Delta(T)
                   decay advances inside decode bursts without host syncs;
                   ``decay_tensor`` (one tensor, one dwell) and
                   ``RestoreIntegrity``, the checkpoint restore's
                   decay-and-scrub pass (``train.checkpoint``);
  * ``scrub``    — corrective re-write passes over the decay masks,
                   through the CUDA scrub kernel or its twin behind the
                   ``repro_torch.memory`` backend registry;
  * ``policy``   — host-side scrub scheduling (periodic, wear-aware,
                   quality-floor), which the serving scheduler consults
                   between bursts;
  * ``wear``     — host-side wear-leveling policies (when to rotate the
                   physical address map), consulted at the scheduler's
                   periodic wear checkpoints.

Per-die decay thresholds (``LifetimePlan.vectors_for_dies``) and
die-masked scrub passes (``scrub_tree(slot_mask=)``) serve a pool
sharded over dies. ``memory.MemoryRegion`` ages and scrubs a region
through the same plan.
"""
from repro_torch.reliability.lifetime import (  # noqa: F401
    MIN_P_STEP, RETENTION_DERATE, LifetimePlan, LifetimeState,
    RestoreIntegrity, decay_tensor, retention_delta, retention_flip_p)
from repro_torch.reliability.policy import (  # noqa: F401
    PeriodicScrub, QualityFloorScrub, ScrubPolicy, WearAwareScrub,
    make_scrub_policy)
from repro_torch.reliability.scrub import scrub_tree  # noqa: F401
from repro_torch.reliability.wear import (  # noqa: F401
    RotateWearPolicy, WearPolicy, make_wear_policy)
