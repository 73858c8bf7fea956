"""Fault-tolerant checkpoints with EXTENT approximate NVM writes (the
counterpart of ``repro.train.checkpoint``).

Durability:
  * atomic: the leaves go into a temporary directory, an fsync'd
    ``COMPLETE`` marker is written last, then the directory is renamed
    to ``step_<9 digits>``; a crash leaves the previous checkpoint or a
    whole new one;
  * pruned to the newest ``keep_last``; ``restore`` takes the newest
    COMPLETE step and skips torn directories;
  * asynchronous: ``save`` snapshots the state to host memory and one
    worker thread commits it; ``wait()`` (and the next ``save``) joins
    it, and an exception raised in the commit surfaces there;
  * ``restore(device=)`` lays each leaf onto one device or onto a
    same-structure tree of devices.

EXTENT: with an ``extent_policy(path, leaf)``, every floating-point leaf
(numpy kind ``f``: float16/32/64, not bfloat16, as in the reference) is
written over zeros through the registry backend ``extent_backend`` at
the policy's level, leaf ``i`` keyed ``fold_in(PRNGKey(extent_seed +
step), i)``, on ``device``; a leaf whose bytes did not change since the
last save is skipped (delta elimination: no write, no energy). The
write stats accumulate on the device and reach the report in one host
read per commit. ``restore(integrity=RestoreIntegrity(...))`` decays the
approximate leaves over the configured dwell and scrubs them through
the backend's ``leaf_scrub``; the keys fold ``CHECKPOINT_RESTORE_OFFSET
+ step`` off ``PRNGKey(extent_seed)``, then ``i`` (decay) and
``RESTORE_SCRUB_OFFSET + i`` (scrub).

On disk: ``manifest.json`` ({"step", "extra", "leaves": [{"path",
"file", "dtype", "shape"}]}, paths rendered as ``jax.tree_util.keystr``
renders them) and ``leaf_{i:05d}.npy``; bfloat16 is stored as its
uint16 view with dtype "bfloat16". The reference reads these files and
writes the same ones.

``last_save_report["stage_s"]`` splits a save's seconds into the
snapshot, the commit's host-to-device copies, the writes (kernels), the
copies back, the digests, ``np.save`` and the commit proper (manifest,
marker, rename and pruning); ``last_restore_report
["stage_s"]`` a restore's into ``np.load``, the copies to the device,
the decay and the scrub. On a CUDA device each stage ends in a
synchronize, so its seconds are its own.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import shutil
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import rng
from repro_torch import tree as T
from repro_torch.core.priority import Priority, keystr
from repro_torch.device import resolve_device
from repro_torch.memory import rng_streams

COMPLETE = "COMPLETE"
_STEP_RE = re.compile(r"^step_(\d{9})$")
#: torch dtypes the reference's numpy sees as kind "f": the leaves the
#: EXTENT writes and the integrity pass take
_NP_FLOATS = (torch.float16, torch.float32, torch.float64)
_STAGES = ("snapshot", "to_device", "write", "to_host", "digest", "np_save",
           "commit")
_RESTORE_STAGES = ("np_load", "to_device", "decay", "scrub")

def _leaf_paths(tree: Any):
    flat, tdef = T.flatten_with_def(tree)
    return [(keystr(p), leaf) for p, leaf in flat], tdef


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "int32")."""
    return str(dtype).split(".")[-1]


def _to_host(x: Any) -> Tuple[np.ndarray, str]:
    """(host array, dtype name): bfloat16 as its uint16 view. Always a
    copy, so a caller that changes the state in place after ``save``
    (``p.add_``, ``torch.optim``) cannot reach a pending commit."""
    if not isinstance(x, torch.Tensor):
        a = np.array(x, copy=True)
        return a, str(a.dtype)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        a = x.view(torch.int16).to("cpu", copy=True).numpy()
        return a.view(np.uint16), "bfloat16"
    return x.to("cpu", copy=True).numpy(), _dtype_name(x.dtype)


def _from_host(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of ``dtype``, as the reference reads a
    leaf: a view when the widths agree (bfloat16 from its uint16 view),
    else a cast."""
    arr = np.require(arr, requirements="C")  # keeps 0-d arrays 0-d
    if dtype == torch.bfloat16:
        if arr.dtype.itemsize == 2:
            return torch.from_numpy(arr.view(np.int16)).view(dtype)
        return torch.from_numpy(arr.astype(np.float32)).to(dtype)
    want = torch.empty((), dtype=dtype).numpy().dtype
    if arr.dtype != want:
        arr = (arr.view(want) if arr.dtype.itemsize == want.itemsize
               else arr.astype(want))
    return torch.from_numpy(arr)


@dataclasses.dataclass
class Checkpointer:
    directory: str
    keep_last: int = 3
    async_save: bool = True
    #: EXTENT: None for exact writes, else a (path, leaf) -> Priority policy
    extent_policy: Optional[Callable] = None
    extent_seed: int = 7
    #: registry backend of the approximate writes ("oracle" stores the
    #: reference's bits for the same call)
    extent_backend: str = "oracle"
    #: where the EXTENT writes and the integrity pass run (default: the
    #: card)
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        Path(self.directory).mkdir(parents=True, exist_ok=True)
        self.device = resolve_device(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            # the worker thread selects it by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None
        self._last_digest: Dict[str, int] = {}  # leaf path -> content hash
        self.last_save_report: Dict[str, Any] = {}
        self.last_restore_report: Dict[str, Any] = {}

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        """Snapshot ``state`` to host memory now; commit it to disk in the
        worker thread (``async_save``) or here."""
        self.wait()
        t0 = time.perf_counter()
        flat, _ = _leaf_paths(state)
        host = [(p, *_to_host(x)) for p, x in flat]
        snapshot_s = time.perf_counter() - t0
        if self.async_save:
            self._pending = self._pool.submit(
                self._commit, step, host, extra or {}, snapshot_s)
        else:
            self._commit(step, host, extra or {}, snapshot_s)

    def wait(self):
        """Join the pending commit; its exception, if any, is raised here
        (once)."""
        fut, self._pending = self._pending, None
        if fut is not None:
            fut.result()

    def _sync(self, device: Optional[torch.device] = None):
        device = self.device if device is None else device
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _commit(self, step: int, host: List[Tuple[str, np.ndarray, str]],
                extra: Dict, snapshot_s: float = 0.0):
        if self.device.type == "cuda":
            # the worker thread's current device: the kernels' streams
            torch.cuda.set_device(self.device)
        t0 = time.perf_counter()
        stage = dict.fromkeys(_STAGES, 0.0)
        stage["snapshot"] = snapshot_s
        final = Path(self.directory) / f"step_{step:09d}"
        tmp = Path(tempfile.mkdtemp(prefix=f".tmp_step_{step}_",
                                    dir=self.directory))
        report = {"step": step, "leaves": len(host), "skipped_leaves": 0,
                  "energy_pj": 0.0, "bit_errors": 0, "bytes": 0}
        manifest = {"step": step, "extra": extra, "leaves": []}
        key = rng.PRNGKey(self.extent_seed + step)
        acc = None  # device-resident WriteStats; one host read per commit
        for i, (path, arr, dname) in enumerate(host):
            t = time.perf_counter()
            digest = hash(arr.tobytes())
            stage["digest"] += time.perf_counter() - t
            unchanged = self._last_digest.get(path) == digest
            entry = {"path": path, "file": f"leaf_{i:05d}.npy",
                     "dtype": dname, "shape": list(arr.shape)}
            if self.extent_policy is not None and arr.dtype.kind == "f" \
                    and dname != "bfloat16":
                level = self.extent_policy((path,), arr)
                if unchanged:
                    # redundant-write elimination: no write, no energy
                    report["skipped_leaves"] += 1
                else:
                    arr, st = self._extent_write(key, i, arr, level, stage)
                    acc = st if acc is None else acc + st
            self._last_digest[path] = digest
            t = time.perf_counter()
            np.save(tmp / entry["file"], arr)
            stage["np_save"] += time.perf_counter() - t
            report["bytes"] += arr.nbytes
            manifest["leaves"].append(entry)
        if acc is not None:  # the one device->host stats read
            h = acc.host_dict()
            report["energy_pj"] = h["energy_pj"]
            report["bit_errors"] = h["bit_errors"]
        t = time.perf_counter()
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        with open(tmp / COMPLETE, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()
        stage["commit"] = time.perf_counter() - t
        report["seconds"] = round(time.perf_counter() - t0, 3)
        report["stage_s"] = stage
        self.last_save_report = report
        return report

    def _extent_write(self, key, i: int, arr: np.ndarray, level, stage):
        """Leaf ``i`` written over zeros through the backend on the
        device: (the stored host array, WriteStats)."""
        from repro_torch import memory
        t = time.perf_counter()
        new = torch.from_numpy(arr).to(self.device)
        self._sync()
        stage["to_device"] += time.perf_counter() - t
        t = time.perf_counter()
        stored, st = memory.write(rng.fold_in(key, i), torch.zeros_like(new),
                                  new, level=level,
                                  backend=self.extent_backend)
        self._sync()
        stage["write"] += time.perf_counter() - t
        t = time.perf_counter()
        out = stored.cpu().numpy()
        stage["to_host"] += time.perf_counter() - t
        return out, st

    def _prune(self):
        steps = sorted(self._complete_steps())
        for s in steps[: -self.keep_last]:
            shutil.rmtree(Path(self.directory) / f"step_{s:09d}",
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def _complete_steps(self):
        out = []
        for d in Path(self.directory).iterdir():
            m = _STEP_RE.match(d.name)
            if m and (d / COMPLETE).exists():
                out.append(int(m.group(1)))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self._complete_steps()
        return max(steps) if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None,
                device: Any = None,
                integrity: Optional[Any] = None) -> Tuple[Any, Dict]:
        """Load the newest COMPLETE checkpoint (or ``step``) into the
        structure of ``state_like`` (tensors, ``meta`` ones included: only
        dtypes are read). ``device``: one device or a same-structure tree
        of devices (default: the checkpointer's).

        ``integrity`` (a ``reliability.RestoreIntegrity``) runs the
        pre-restore pass over the approximate leaves: their decay over
        the configured dwell is sampled and, with ``integrity.scrub``,
        corrected and re-written through ``extent_backend``; the
        re-write energy and the damage left land in
        ``last_restore_report``. Without it, and for every leaf outside
        ``extent_policy``, the restore is bit-identical to what was
        saved."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no COMPLETE checkpoint under "
                                    f"{self.directory}")
        d = Path(self.directory) / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = {e["path"]: e for e in manifest["leaves"]}
        flat, tdef = _leaf_paths(state_like)
        if device is None or isinstance(device, (str, torch.device)):
            devs = [resolve_device(device or self.device)] * len(flat)
        else:
            devs = [torch.device(x) for x in tdef.flatten_up_to(device)]
        check = integrity is not None and self.extent_policy is not None
        report = {"step": step, "leaves_checked": 0, "retention_flips": 0,
                  "scrub_energy_pj": 0.0, "residual_decayed_bits": 0}
        acc = counts = None  # device-resident; one host read at the end
        stage = dict.fromkeys(_RESTORE_STAGES, 0.0)
        # disjoint from save(step + 1)'s PRNGKey(extent_seed + step + 1)
        key = rng.fold_in(rng.PRNGKey(self.extent_seed),
                          rng_streams.CHECKPOINT_RESTORE_OFFSET + step)
        out = []
        for i, ((path, like), dev) in enumerate(zip(flat, devs)):
            e = by_path[path]
            t = time.perf_counter()
            arr = np.load(d / e["file"])
            stage["np_load"] += time.perf_counter() - t
            t = time.perf_counter()
            leaf = _from_host(arr, like.dtype).to(dev)
            self._sync(dev)
            stage["to_device"] += time.perf_counter() - t
            if check and like.dtype in _NP_FLOATS:
                level = Priority.coerce(self.extent_policy((path,), like))
                if level != Priority.EXACT:
                    leaf, st, c = self._integrity(key, i, leaf, level,
                                                  integrity, stage)
                    if st is not None:
                        acc = st if acc is None else acc + st
                    counts = c if counts is None else counts + c.to(
                        counts.device)
                    report["leaves_checked"] += 1
            out.append(leaf)
        if report["leaves_checked"]:
            h = counts.tolist()
            report["retention_flips"] = int(h[0])
            report["residual_decayed_bits"] = int(h[1])
            if acc is not None:
                report["scrub_energy_pj"] = acc.host_dict()["energy_pj"]
        report["stage_s"] = stage
        self.last_restore_report = report
        return tdef.unflatten(out), manifest["extra"]

    def _integrity(self, key, i: int, leaf: torch.Tensor, level: Priority,
                   integrity, stage: Dict[str, float]):
        """Decay leaf ``i`` over the stored dwell and, with a scrub,
        correct it: (leaf, scrub WriteStats or None, (2,) int64 [flips,
        residual bits])."""
        from repro_torch import memory
        from repro_torch.memory.stats import popcount
        from repro_torch.reliability import decay_tensor
        t = time.perf_counter()
        leaf, mask, flips = decay_tensor(
            rng.fold_in(key, i), leaf, level=level,
            ambient_k=integrity.ambient_k, dwell_s=integrity.dwell_s)
        self._sync(leaf.device)
        stage["decay"] += time.perf_counter() - t
        residual, st = mask, None
        if integrity.scrub:
            t = time.perf_counter()
            be = memory.get_backend(self.extent_backend)
            lv = memory.leaf_vectors(leaf.dtype, level, leaf.device)
            leaf, residual, st = be.leaf_scrub(
                rng.fold_in(key, rng_streams.RESTORE_SCRUB_OFFSET + i),
                leaf, mask, lv)
            self._sync(leaf.device)
            stage["scrub"] += time.perf_counter() - t
        return leaf, st, torch.stack([flips, popcount(residual)])
