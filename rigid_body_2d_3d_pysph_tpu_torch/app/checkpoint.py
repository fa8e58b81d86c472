"""Full-state checkpoint and resume.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/app/checkpoint.py``.
Snapshots hold only output fields; a checkpoint holds every scene field
(contact-slot springs and per-body state included) and the solver's time
and step count, written atomically.  Unlike the reference, it also holds
the scheme's capacity state (the capacity boost and its grid configs),
and the rigid compact store keeps the width it had when it was saved: a
run resumed after an overflow rebuild widened the store (and re-sized the
grid) carries on with the same store and the same grid, where the
reference raises a shape mismatch.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.base import SchemeChooser
from ..ops.cellpairs import CellGridConfig
from ..ops.rowwin import RowWinConfig
from ..state.scene import Scene
from .output import save_npz_atomic

# the scheme attributes that hold a grid config, and their types
_CONFIGS = {"_cell_cfg": CellGridConfig, "_rowwin_cfg": RowWinConfig}
# the compact store: its first dimension is the store width L
_COMPACT = ("cl_pid", "cl_state")


def _selected(scheme):
    return scheme.scheme if isinstance(scheme, SchemeChooser) else scheme


def scheme_state(scheme) -> dict:
    """The capacity boost and the grid configs of ``scheme``."""
    s = _selected(scheme)
    out = {"capacity_boost": float(s.capacity_boost)}
    for attr in _CONFIGS:
        cfg = getattr(s, attr, None)
        if cfg is not None:
            out[attr] = dataclasses.asdict(cfg)
    return out


def restore_scheme_state(scheme, state: dict) -> None:
    s = _selected(scheme)
    s.capacity_boost = float(state["capacity_boost"])
    for attr, cls in _CONFIGS.items():
        if attr in state:
            d = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in state[attr].items()}
            setattr(s, attr, cls(**d))


def save_checkpoint(path: str, scene: Scene, t: float, count: int,
                    scheme=None) -> None:
    data = {f"field/{k}": v.detach().cpu().numpy()
            for k, v in scene.fields.items()}
    data["solver/t"] = np.float64(t)
    data["solver/count"] = np.int64(count)
    if scheme is not None:
        data["scheme/state"] = np.array(json.dumps(scheme_state(scheme)))
    save_npz_atomic(path, data)


def load_checkpoint(path: str, scene: Scene,
                    scheme=None) -> Tuple[Scene, float, int]:
    """Restore the fields into an already-built scene (its meta and
    shapes come from the application's ``create_particles``), and the
    scheme's capacity state into ``scheme``.  The compact store takes
    the saved width."""
    with np.load(path) as z:
        fields = {}
        for k, v in scene.fields.items():
            key = f"field/{k}"
            if key not in z.files:
                fields[k] = v
                continue
            arr = z[key]
            same = (arr.shape[1:] == tuple(v.shape[1:]) if k in _COMPACT
                    else arr.shape == tuple(v.shape))
            if not same:
                raise ValueError(f"checkpoint field {k}: shape {arr.shape} "
                                 f"!= scene {tuple(v.shape)}")
            fields[k] = torch.as_tensor(arr, device=v.device).to(v.dtype)
        t = float(z["solver/t"])
        count = int(z["solver/count"])
        if scheme is not None and "scheme/state" in z.files:
            restore_scheme_state(scheme, json.loads(str(z["scheme/state"])))
    return Scene(fields, scene.meta), t, count


def latest_checkpoint(output_dir: str) -> Optional[str]:
    p = os.path.join(output_dir, "checkpoint.npz")
    return p if os.path.exists(p) else None
