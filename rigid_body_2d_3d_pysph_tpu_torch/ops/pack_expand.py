"""Pack expansion: cell-sorted pack fields -> dense slot blocks.

Counterpart of ``rigid_body_2d_3d_pysph_tpu/ops/pallas_pack.py``
(``expand_dft_pallas``).  The port's layout is ``dfT [NC + 1, F, M]``:
row s < NC is slot s (lane l < cnt[s] holds sorted row base[s] + l,
the other lanes hold the per-field sentinel) and row NC is all-sentinel,
so a missing stencil entry (== NC) reads a row whose gates are all
false.  No 128-lane padding and no program batching: those were TPU
layout choices.

``expand_slots`` launches ``csrc/pack_expand.cu`` for CUDA tensors and
runs :func:`expand_slots_reference` for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build


def expand_slots_reference(sorted_fields, base, cnt, sent, M: int):
    """Plain PyTorch version: ``sorted_fields [F, N]``, ``base``/``cnt``
    [NC], ``sent`` [F] -> [NC + 1, F, M]."""
    F, n = sorted_fields.shape
    lane = torch.arange(M, device=base.device)
    idx = base.to(torch.int64)[:, None] + lane[None, :]         # [NC, M]
    valid = lane[None, :] < cnt[:, None]
    vals = sorted_fields[:, torch.clamp(idx, 0, max(n - 1, 0))]  # [F, NC, M]
    out = torch.where(valid[None], vals, sent[:, None, None])
    out = out.permute(1, 0, 2)
    return torch.cat([out, sent[None, :, None].expand(1, F, M)], 0
                     ).contiguous()


def expand_slots(sorted_fields, base, cnt, sent, M: int):
    """Expand the pack into ``[NC + 1, F, M]`` (see module docstring)."""
    if sorted_fields.dim() != 2 or base.shape != cnt.shape \
            or sent.shape != (sorted_fields.shape[0],):
        raise ValueError("expand_slots: bad shapes "
                         f"{tuple(sorted_fields.shape)}, {tuple(base.shape)},"
                         f" {tuple(cnt.shape)}, {tuple(sent.shape)}")
    if sorted_fields.device.type == "cpu":
        return expand_slots_reference(sorted_fields, base, cnt, sent, M)
    if sorted_fields.device.type != "cuda":
        raise ValueError(f"unsupported device {sorted_fields.device}")
    if sorted_fields.dtype != torch.float32 or sent.dtype != torch.float32:
        raise ValueError("the pack-expansion kernel takes float32")
    if base.dtype != torch.int64 or cnt.dtype != torch.int64:
        raise ValueError("the pack-expansion kernel takes int64 base/cnt")
    F, n = sorted_fields.shape
    NC = base.shape[0]
    sorted_fields = sorted_fields.contiguous()
    base, cnt, sent = base.contiguous(), cnt.contiguous(), sent.contiguous()
    out = torch.empty((NC + 1, F, M), dtype=torch.float32,
                      device=sorted_fields.device)
    fn = _build.load("pack_expand")
    stream = torch.cuda.current_stream(sorted_fields.device).cuda_stream
    err = fn(sorted_fields.data_ptr(), base.data_ptr(), cnt.data_ptr(),
             sent.data_ptr(), out.data_ptr(), n, NC, F, M, stream)
    _build.check(err, "pack_expand")
    _build.count("pack_expand")
    return out
