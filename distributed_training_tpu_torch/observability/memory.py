"""Device-memory telemetry from the CUDA caching allocator.

The port of ``distributed_training_tpu/observability/memory.py``. Where
JAX reads ``device.memory_stats()``, the port reads
the allocator's statistics (``torch.cuda.memory_stats_as_nested_dict``:
what ``memory_allocated`` / ``max_memory_allocated`` read) and the card's
capacity: counters the allocator keeps on the host, so a read never
synchronizes the device and sampling them at the meter's flush keeps the
hot loop free of syncs.

On the CPU (and without a card) it returns ``{}``, as JAX's does where a
backend has no allocator stats; every consumer treats the keys as
optional.
"""

from __future__ import annotations

import torch


def device_memory_metrics(devices=None) -> dict[str, float]:
    """Allocator stats over ``devices`` (default: this process's current
    card; CPU devices are skipped):

    - ``mem_bytes_in_use``: the most bytes allocated on any of them;
    - ``mem_peak_bytes``: the highest high-water mark;
    - ``mem_bytes_limit``: the card's capacity.
    """
    if not torch.cuda.is_available():
        return {}
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    devices = [torch.device(d) for d in devices]
    devices = [d for d in devices if d.type == "cuda"]
    if not devices:
        return {}
    # One read of the allocator's statistics a card, nested as the
    # allocator keeps them (memory_allocated and max_memory_allocated would
    # each flatten the whole dict again in Python).
    stats = [torch.cuda.memory_stats_as_nested_dict(d).get("allocated_bytes", {})
             .get("all", {}) for d in devices]
    return {
        "mem_bytes_in_use": float(max(s.get("current", 0) for s in stats)),
        "mem_peak_bytes": float(max(s.get("peak", 0) for s in stats)),
        "mem_bytes_limit": float(max(torch.cuda.get_device_properties(d).total_memory
                                     for d in devices)),
    }
