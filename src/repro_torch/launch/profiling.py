"""Device time of a piece of work, traced by ``torch.profiler``."""

from __future__ import annotations

from typing import Callable, Mapping

import torch

__all__ = ["device_profile"]


def device_profile(fn: Callable[[], None], device: torch.device, kernels: Mapping[str, str]) -> dict:
    """Trace ``fn()`` and sum the device time of the kernels it launched.

    Returns ``device_ms`` (all kernels), ``<name>_ms`` for each entry of
    ``kernels`` (kernels whose name contains the given substring), and the
    twelve heaviest kernels as ``top``.  ``fn`` should end in a synchronise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        fn()
    # device-side events only: a CPU op's own device time repeats its kernels',
    # and a range annotated on the device (a collective's ``nccl:*`` or
    # ``gloo:*``) spans kernels or host waits, not work of its own
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 and not e.is_user_annotation
    ]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    out = {"device_ms": sum(e.self_device_time_total for e in events) / 1e3}
    for name, match in kernels.items():
        out[f"{name}_ms"] = sum(e.self_device_time_total for e in events if match in e.key) / 1e3
    out["top"] = [
        {"name": e.key, "ms": e.self_device_time_total / 1e3, "count": e.count}
        for e in events[:12]
    ]
    return out
