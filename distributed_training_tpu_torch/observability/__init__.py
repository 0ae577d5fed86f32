"""Observability: the trainers' flight instruments.

The port of ``distributed_training_tpu/observability``:

- :mod:`flops`: the analytic FLOPs of a train step and the per-card peak
  that turn a rate into an MFU;
- :mod:`flight_recorder`: a bounded ring of per-step host timestamps and
  flushed metrics: step-time percentiles, goodput, a JSON dump (on
  demand, on anomaly, on crash) that ``tools/flight_report.py`` renders;
- :mod:`histogram`: the fixed-bucket step-time histogram of a dump;
- :mod:`memory`: the CUDA allocator's counters at each meter flush;
- :mod:`anomaly`: NaN/Inf losses and grad-norm spikes over flushed
  metrics;
- :mod:`aggregate`: the cross-rank straggler view, exchanged over gloo;
- :mod:`prometheus`: a dump as Prometheus text;
- :mod:`trace`: span traces of the run, in Chrome/Perfetto JSON;
- :mod:`exporter`: the live ``/metrics``, ``/healthz`` and ``/vars``;
- :mod:`hooks`: :class:`TrainObservability`, which both trainers drive.
"""

from __future__ import annotations

from distributed_training_tpu_torch.observability.anomaly import (  # noqa: F401
    AnomalyDetector,
    AnomalyError,
)
from distributed_training_tpu_torch.observability.flight_recorder import (  # noqa: F401
    FlightRecorder,
    percentile,
)
from distributed_training_tpu_torch.observability.flops import (  # noqa: F401
    PEAK_BF16_FLOPS,
    device_peak_flops,
    forward_flops,
    gpt_forward_flops,
    mfu,
    resnet_forward_flops,
    train_step_flops,
)
from distributed_training_tpu_torch.observability.histogram import (  # noqa: F401
    FixedHistogram,
)
from distributed_training_tpu_torch.observability.hooks import (  # noqa: F401
    TrainObservability,
)
from distributed_training_tpu_torch.observability.memory import (  # noqa: F401
    device_memory_metrics,
)
from distributed_training_tpu_torch.observability.trace import (  # noqa: F401
    TraceSession,
    load_trace,
)
