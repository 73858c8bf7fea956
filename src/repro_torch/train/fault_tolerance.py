"""Failure detection, straggler mitigation, elastic re-mesh (the
counterpart of ``repro.train.fault_tolerance``).

Control-plane pieces, host-side and simple-state (everything can be
rebuilt from a checkpoint and the device list):

  * HeartbeatMonitor — per-host liveness with monotonic deadlines; the
    launcher polls ``dead_hosts()`` each step and re-meshes on change.
  * StragglerMonitor — flags hosts/steps slower than ``threshold`` x the
    rolling median of step times.
  * elastic re-mesh — the largest (data, model) mesh over the surviving
    devices that keeps the model axis (TP degree is a model property; DP
    shrinks), and the state laid onto it (``reshard_state``: each leaf
    ``.to()`` its sharding's device).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import tree as T
from repro_torch.sharding.mesh import Mesh, device_grid


# ---------------------------------------------------------------------------
# failure detection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._last: Dict[str, float] = {}

    def beat(self, host: str, at: Optional[float] = None) -> None:
        self._last[host] = self.clock() if at is None else at

    def dead_hosts(self, now: Optional[float] = None) -> List[str]:
        now = self.clock() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t > self.timeout_s)

    def alive_hosts(self, now: Optional[float] = None) -> List[str]:
        now = self.clock() if now is None else now
        return sorted(h for h, t in self._last.items()
                      if now - t <= self.timeout_s)


# ---------------------------------------------------------------------------
# straggler mitigation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps/hosts whose time exceeds threshold x rolling median."""
    threshold: float = 1.8
    window: int = 32

    def __post_init__(self):
        self._times: Dict[str, collections.deque] = {}
        self.flags: List[Tuple[str, int, float]] = []  # (host, step, ratio)

    def record(self, host: str, step: int, seconds: float) -> bool:
        dq = self._times.setdefault(
            host, collections.deque(maxlen=self.window))
        all_times = [t for d in self._times.values() for t in d]
        dq.append(seconds)
        if len(all_times) < 8:
            return False
        med = float(np.median(all_times))
        ratio = seconds / max(med, 1e-9)
        if ratio > self.threshold:
            self.flags.append((host, step, ratio))
            return True
        return False

    def chronic(self, min_flags: int = 3) -> List[str]:
        """Hosts flagged repeatedly -> candidates for eviction."""
        counts = collections.Counter(h for h, _, _ in self.flags)
        return sorted(h for h, c in counts.items() if c >= min_flags)


# ---------------------------------------------------------------------------
# elastic re-mesh
# ---------------------------------------------------------------------------

def best_elastic_mesh(devices: Sequence, model_parallel: int,
                      axis_names: Tuple[str, str] = ("data", "model")
                      ) -> Mesh:
    """Largest (data, model_parallel) mesh over the surviving devices:
    with d devices, floor(d / model_parallel) DP ranks, the remainder
    idle (reported, never silent)."""
    n = len(devices)
    dp = n // model_parallel
    if dp < 1:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with {n} devices")
    return Mesh(device_grid(list(devices)[:dp * model_parallel],
                      (dp, model_parallel)), tuple(axis_names))


def remesh_report(old_n: int, new_mesh: Mesh) -> Dict[str, Any]:
    new_n = new_mesh.size
    return {
        "old_devices": old_n,
        "new_devices": int(new_n),
        "idle_devices": old_n - int(new_n) if old_n > new_n else 0,
        "new_shape": new_mesh.shape,
        "dp_degree": int(new_mesh.devices.shape[0]),
    }


def reshard_state(state: Any, shardings: Any) -> Any:
    """Re-lay a tree of tensors onto a same-structure tree of shardings:
    each leaf ``.to()`` its sharding's device (one device per mesh in the
    port). With checkpointed state this composes as
    ``ckpt.restore(state_like, device=...)``."""
    flat, tdef = T.flatten_with_def(state)
    return tdef.unflatten([x.to(s.device) for (_, x), s in zip(
        flat, tdef.flatten_up_to(shardings))])


# ---------------------------------------------------------------------------
# orchestration: the recovery loop the launcher runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RecoveryPolicy:
    heartbeat: HeartbeatMonitor
    stragglers: StragglerMonitor
    model_parallel: int
    evict_chronic_stragglers: bool = True

    def plan(self, devices_by_host: Dict[str, Sequence]) -> Dict[str, Any]:
        """Decide the surviving device set. Returns {action, devices, ...};
        action in {none, remesh}."""
        dead = set(self.heartbeat.dead_hosts())
        if self.evict_chronic_stragglers:
            dead |= set(self.stragglers.chronic())
        if not dead:
            return {"action": "none"}
        survivors = [d for h, ds in sorted(devices_by_host.items())
                     if h not in dead for d in ds]
        mesh = best_elastic_mesh(survivors, self.model_parallel)
        return {"action": "remesh", "dead_hosts": sorted(dead),
                "mesh": mesh,
                "report": remesh_report(
                    sum(len(d) for d in devices_by_host.values()), mesh)}
