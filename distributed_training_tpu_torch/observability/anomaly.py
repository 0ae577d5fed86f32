"""Anomaly detection over flushed training metrics.

The port of ``distributed_training_tpu/observability/anomaly.py``,
unchanged. Inputs are the values the trainers' ``MetricMeter`` already
fetched at its ``log_interval`` flush — the detector
adds ZERO device syncs and sees anomalies at flush granularity. That
granularity is sufficient for the failure modes it targets: a NaN/Inf
loss poisons the parameters, so every subsequent step's loss (including
the next flushed one) is non-finite; a diverging grad norm is a trend,
not a one-step event. The flags themselves are computed ON DEVICE inside
the step (``loss``, ``grad_norm``, ``grads_finite`` ride the metrics
dict as 0-d device tensors) — the host only inspects numbers it was
fetching anyway.

Multi-rank safety: every input is a replicated global value (losses and
grad norms are averaged or summed over the ranks in the step), so each
rank's detector reaches the same verdict at the same step — a triggered
raise happens on all ranks together instead of stranding the others at
the next collective.
"""

from __future__ import annotations

import math


class AnomalyError(RuntimeError):
    """A configured-fatal training anomaly (``anomaly_action='raise'``)."""


class AnomalyDetector:
    """Flags non-finite losses and grad-norm spikes.

    Spike rule: ``grad_norm > spike_factor × EMA(grad_norm)``, where the
    EMA only ingests non-anomalous values (a spike must not drag the
    baseline up and mask its successors). The first observed grad norm
    seeds the EMA, so a single flush of history is enough to arm.
    """

    def __init__(self, *, spike_factor: float = 10.0,
                 ema_decay: float = 0.9):
        if spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1 (got {spike_factor}); a factor "
                f"<= 1 would flag every steady-state step")
        self.spike_factor = spike_factor
        self.ema_decay = ema_decay
        self._grad_norm_ema: float | None = None

    @property
    def grad_norm_ema(self) -> float | None:
        return self._grad_norm_ema

    def check(self, metrics: dict) -> list[str]:
        """Reasons this flush is anomalous ([] = healthy). ``metrics`` is
        a flushed (host-side float) dict; missing keys are simply not
        checked, so the detector degrades gracefully when e.g. the
        grad-norm metric knob is off."""
        if metrics.get("grads_finite", 1.0) < 1.0:
            # Only the DYNAMIC fp16 scaler ever reports grads_finite=0
            # (commit_gradients pins True otherwise), and it already
            # responded by skipping the update — overflow handling in
            # action, not an anomaly. A genuinely poisoned bf16/fp32 run
            # keeps grads_finite=1 with a NaN loss and is flagged below.
            return []
        reasons: list[str] = []
        loss = metrics.get("loss")
        if loss is not None and not math.isfinite(loss):
            reasons.append(f"non-finite loss ({loss})")
        gn = metrics.get("grad_norm")
        if gn is not None:
            if not math.isfinite(gn):
                reasons.append(f"non-finite grad norm ({gn})")
            elif (self._grad_norm_ema is not None
                  and gn > self.spike_factor * self._grad_norm_ema):
                reasons.append(
                    f"grad-norm spike ({gn:.4g} > {self.spike_factor:g}x "
                    f"running mean {self._grad_norm_ema:.4g})")
            else:
                self._grad_norm_ema = (
                    gn if self._grad_norm_ema is None
                    else self.ema_decay * self._grad_norm_ema
                    + (1.0 - self.ema_decay) * gn)
        return reasons
