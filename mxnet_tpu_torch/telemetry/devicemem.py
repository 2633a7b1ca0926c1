"""Shared device-memory probe.

Counterpart of ``mxnet_tpu/telemetry/devicemem.py``.  One place that
knows how to ask the allocator for its high-water mark: on a CUDA device
``torch.cuda.memory_stats(device)["allocated_bytes.all.peak"]`` (what
``torch.cuda.max_memory_allocated`` reads), and ``None`` on the CPU,
which keeps no allocator statistics.  Telemetry never resets torch's
peak counters: the watermark is the process's, or whatever the caller
last reset with ``torch.cuda.reset_peak_memory_stats``.  Consumed by
``telemetry/step.py``'s StepTimer (``mxnet_train_device_mem_peak_bytes``)
and both serving engines' ``mxnet_serve_memory_measured_peak_bytes``
gauges: the measured side of the static memory planner's
predicted-vs-measured pair.

Callers treat a ``None`` return as "this backend cannot say" and stop
probing (the probe-once discipline): the call itself is cheap, but a
gauge that can never move should not be scraped as a live zero.
"""
from __future__ import annotations

__all__ = ["device_memory_peak"]


def device_memory_peak(device=None):
    """Peak bytes allocated on ``device`` (a ``torch.device``, a device
    string or a ``Context``; default: the first card when one is
    present) per torch's caching allocator, or ``None`` on the CPU.
    Never raises."""
    try:
        import torch
        if device is None:
            if not torch.cuda.is_available():
                return None
            device = torch.device("cuda", 0)
        device = torch.device(getattr(device, "device", device))
        if device.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(device)
        if not stats:
            return None
        return int(stats.get("allocated_bytes.all.peak", 0) or 0)
    except Exception:
        return None
