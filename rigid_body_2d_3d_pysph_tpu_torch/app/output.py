"""Snapshot output: the npz writer, the background writer, the loader
and the iterator.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/app/output.py``, in the
same npz layout, so the reference's ``load`` and ``validate.py`` read
the port's snapshots as they are: one ``.npz`` per snapshot with every
per-particle output field of every group (``<group>/<field>``), the
group's surface normals (``<group>/normal``), each rigid group's body
state (``<group>/body.<key>``, ``<group>/body.nb``) and the solver data
(``solver/t``, ``solver/dt``, ``solver/count``).

Unlike the reference, a snapshot is written to a temporary file in the
same directory and renamed over its path (``os.replace``): a failed
write leaves no partial ``snapshot_*.npz``.  The background writer
copies the fields to pinned host buffers on the current stream before
the step loop goes on (torch tensors are not immutable), and its worker
waits for that copy before writing.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import threading
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DEFAULT_OUTPUT_FIELDS = (
    "x", "y", "z", "u", "v", "w", "fx", "fy", "fz", "m", "h", "rho", "p",
    "body_id", "dem_id", "is_boundary",
)

BODY_STATE_KEYS = ("xcm", "vcm", "R", "omega", "ang_mom", "total_mass",
                   "force", "torque", "izz")


def _wanted(scene, output_fields) -> List[str]:
    fields = output_fields or DEFAULT_OUTPUT_FIELDS
    want = [f for f in fields if f in scene]
    want += [k for k in ("normal", "body_id") + BODY_STATE_KEYS
             if k in scene and k not in want]
    return want


def _layout(host: Dict[str, np.ndarray], meta, n: int, t: float, dt: float,
            count: int, output_fields) -> Dict[str, np.ndarray]:
    """The reference's npz layout of the host arrays ``host``."""
    data: Dict[str, np.ndarray] = {
        "solver/t": np.float64(t),
        "solver/dt": np.float64(dt),
        "solver/count": np.int64(count),
    }
    fields = output_fields or DEFAULT_OUTPUT_FIELDS
    for g in meta.groups:
        for f in fields:
            arr = host.get(f)
            if arr is not None and np.ndim(arr) >= 1 and arr.shape[0] == n:
                data[f"{g.name}/{f}"] = arr[g.start:g.stop]
        if "normal" in host:
            data[f"{g.name}/normal"] = host["normal"][g.start:g.stop]
        if g.role == "rigid" and "xcm" in host:
            bid = host["body_id"][g.start:g.stop]
            if bid.size == 0 or bid.max() < 0:
                lo, hi = 0, 0
            else:
                lo, hi = int(bid.min()), int(bid.max()) + 1
            for k in BODY_STATE_KEYS:
                if k in host:
                    data[f"{g.name}/body.{k}"] = host[k][lo:hi]
            data[f"{g.name}/body.nb"] = np.int64(hi - lo)
    return data


def save_npz_atomic(path: str, data: Dict[str, np.ndarray]) -> None:
    """``np.savez`` to a hidden temporary file beside ``path``, renamed
    over ``path`` once written (no partial file under its name)."""
    d, base = os.path.split(path)
    tmp = os.path.join(d, f".{base}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _to_host(scene, names, pinned: bool):
    """Copies of ``scene[k]`` on the host.  ``pinned`` (CUDA scenes):
    queued on the current stream into pinned buffers; returns the event
    that marks their completion (None when the copies are done)."""
    if scene.device.type != "cuda":
        return {k: scene[k].detach().clone() for k in names}, None
    if not pinned:
        return {k: scene[k].detach().cpu() for k in names}, None
    out = {}
    for k in names:
        v = scene[k].detach()
        buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        buf.copy_(v, non_blocking=True)
        out[k] = buf
    ev = torch.cuda.Event()
    ev.record()
    return out, ev


def write_snapshot(path: str, scene, t: float, dt: float, count: int,
                   output_fields: Optional[Sequence[str]] = None) -> None:
    host, _ = _to_host(scene, _wanted(scene, output_fields), pinned=False)
    save_npz_atomic(path, _layout({k: v.numpy() for k, v in host.items()},
                                  scene.meta, scene.n, t, dt, count,
                                  output_fields))


class AsyncSnapshotWriter:
    """Background snapshot writer.

    ``submit`` queues the device-to-host copies of the wanted fields on
    the current stream (pinned buffers, so they overlap the steps that
    follow) and records an event; the worker thread waits for the event,
    then writes the npz.  A later step cannot change what is written,
    and the step loop does not wait for the disk.  ``max_pending`` bounds
    the queued snapshots.  An exception raised by the worker re-raises on
    the next ``submit`` or ``flush``."""

    def __init__(self, max_pending: int = 2):
        self._q = queue.Queue(maxsize=max_pending)
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                path, host, ev, meta, n, t, dt, count, fields = item
                if ev is not None:
                    ev.synchronize()
                save_npz_atomic(path, _layout(
                    {k: v.numpy() for k, v in host.items()}, meta, n, t, dt,
                    count, fields))
            except BaseException as e:  # surfaced on submit / flush
                self._err = e
            finally:
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async snapshot write failed") from err

    def submit(self, path, scene, t, dt, count, output_fields=None):
        self._check()
        host, ev = _to_host(scene, _wanted(scene, output_fields),
                            pinned=True)
        self._q.put((path, host, ev, scene.meta, scene.n, t, dt, count,
                     output_fields))

    def flush(self):
        self._q.join()
        self._check()

    def close(self):
        if self._thread.is_alive():
            self._q.join()
            self._q.put(None)
            self._thread.join()
        self._check()


class GroupSnapshot(SimpleNamespace):
    """Attribute view of one group in one snapshot; body-state arrays are
    exposed both shaped ([B, 3] / [B, 3, 3] as ``<key>_mat``) and flat
    (``xcm`` as [3 B], ``R`` as [9 B])."""


def load(path: str):
    with np.load(path) as z:
        raw = {k: z[k] for k in z.files}
    sd = {k.split("/", 1)[1]: raw.pop(k) for k in list(raw)
          if k.startswith("solver/")}
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in raw.items():
        gname, f = k.split("/", 1)
        groups.setdefault(gname, {})[f] = v
    out = {}
    for gname, fields in groups.items():
        ns = GroupSnapshot()
        for f, v in fields.items():
            if f.startswith("body."):
                key = f[len("body."):]
                setattr(ns, key, v if key != "nb" else np.array([int(v)]))
                if key in ("xcm", "vcm", "omega", "ang_mom", "force",
                           "torque", "R"):
                    setattr(ns, key, v.reshape(-1))
                    setattr(ns, key + "_mat", v)
            else:
                setattr(ns, f, v)
        out[gname] = ns
    return sd, out


def get_files(output_dir: str) -> List[str]:
    files = glob.glob(os.path.join(output_dir, "snapshot_*.npz"))
    return sorted(files, key=lambda f: int(
        os.path.basename(f).split("_")[1].split(".")[0]))


def iter_output(files: Sequence[str], group: str):
    """Yield ``(solver_data, group_snapshot)`` per file."""
    for f in files:
        sd, groups = load(f)
        yield sd, groups[group]


def write_info(path: str, **kw) -> None:
    with open(path, "w") as f:
        json.dump(kw, f, indent=2, default=str)
