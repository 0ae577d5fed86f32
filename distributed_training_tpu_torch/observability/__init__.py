"""Observability: the FLOP count and MFU of a train step, and the
percentile the bench reports step times with.

The port's part of ``distributed_training_tpu/observability``; the rest
of that package (flight recorder, traces, anomaly detection, metric
sinks) is not ported yet (ROADMAP.md, queue A10).
"""

from __future__ import annotations

from distributed_training_tpu_torch.observability.flops import (  # noqa: F401
    PEAK_BF16_FLOPS,
    device_peak_flops,
    forward_flops,
    gpt_forward_flops,
    mfu,
    resnet_forward_flops,
    train_step_flops,
)


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile (numpy's default method); ``q`` in
    [0, 100]; raises on an empty input."""
    if not len(values):
        raise ValueError("percentile of empty sequence")
    xs = sorted(float(v) for v in values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac
