"""A traced stretch of a run under ``torch.profiler``, reduced to what the
per-layer metrics read: the seconds the device was busy (the union of its
operations' intervals), the traced window's length, each kernel family's
device seconds (by the program's kernel names), the device operations that
took most time, and the longest idle gaps with what the host was doing
(the innermost host event around each gap's middle).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

# the program's CUDA kernels by family, as the profiler names them
KERNELS = {
    "matmul": ("skinny_rowb_kernel", "skinny_colb_kernel",
               "tiled_f32_kernel", "tiled_bf16_kernel"),
    "flash_fwd": ("flash_fwd_f32_kernel", "flash_fwd_bf16_kernel"),
    "flash_bwd": ("flash_bwd_kernel",),
    "rmsnorm": ("rmsnorm_warp_kernel", "rmsnorm_block_kernel",
                "rmsnorm_scalar_kernel", "rmsnorm_bwd_warp_kernel",
                "rmsnorm_bwd_block_kernel", "rmsnorm_bwd_scalar_kernel"),
}
TOP = 10


@dataclass
class TraceStats:
    busy_s: float = 0.0
    window_s: float = 0.0
    device_events: int = 0
    kernel_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)


def family(name: str):
    for fam, frags in KERNELS.items():
        if any(f in name for f in frags):
            return fam
    return None


def _merge(iv: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of the (start, end) rows of ``iv``."""
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def reduce(events, window_s: float) -> TraceStats:
    """``events``: the profiler's ``FunctionEvent``s of the traced window."""
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if e.device_type == cuda]
    stats = TraceStats(window_s=window_s, device_events=len(dev))
    if not dev:
        return stats
    iv = np.array([(e.time_range.start, e.time_range.end) for e in dev],
                  dtype=np.float64)
    merged = _merge(iv)
    stats.busy_s = float((merged[:, 1] - merged[:, 0]).sum()) / 1e6
    by_name: Dict[str, float] = {}
    for e in dev:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        fam = family(e.name)
        if fam:
            stats.kernel_s[fam] = stats.kernel_s.get(fam, 0.0) + us / 1e6
    stats.device_ops = [[n, t / 1e6] for n, t in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    gaps = np.stack([merged[:-1, 1], merged[1:, 0]], axis=1)
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:TOP]]
    host = [e for e in events if e.device_type != cuda]
    starts = np.array([e.time_range.start for e in host], dtype=np.float64)
    ends = np.array([e.time_range.end for e in host], dtype=np.float64)
    for s, e in gaps:
        if e <= s:
            continue
        mid = (s + e) / 2
        inside = np.nonzero((starts <= mid) & (ends > mid))[0]
        what = host[inside[np.argmax(starts[inside])]].name \
            if len(inside) else "no host event"
        stats.idle_gaps.append([what, float(e - s) / 1e6])
    return stats


@contextmanager
def traced(device):
    """Trace the block: yields a list that holds the ``TraceStats`` once
    the block has closed.  The device is synchronized at both ends, and
    the window is the host's time between them."""
    from torch.profiler import ProfilerActivity, profile
    out: List[TraceStats] = []
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    out.append(reduce(prof.events(), window))
