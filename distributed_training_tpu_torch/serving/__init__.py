"""Continuous-batching serving for the transformer LM: the port of
``distributed_training_tpu/serving/``'s engine core.

:class:`Engine` (paged KV with chunked prefill, or the legacy contiguous
slots), :class:`RequestQueue` (tiers, tenants, quotas, deadlines,
shedding), :class:`SlotScheduler` (iteration-level batching with
preempt-and-requeue), :class:`PagePool`, :class:`ServeTelemetry` and
:class:`TelemetryRing`, and the per-request :class:`LatencyLedger`. The
CLI is ``gpt/torch_cuda/serve.py``. The prefix cache, speculation,
quantization, the journal, the hot swap, the SLO alerts and the fleet
(front door, router, supervisor) are not ported yet (ROADMAP.md A9 (b)
and (c)).
"""

from distributed_training_tpu_torch.resilience.errors import (  # noqa: F401
    DrainingError,
    QueueFullError,
)
from distributed_training_tpu_torch.serving.engine import Engine  # noqa: F401
from distributed_training_tpu_torch.serving.ledger import (  # noqa: F401
    LEDGER_CAUSES,
    TOKEN_CAUSES,
    LatencyLedger,
)
from distributed_training_tpu_torch.serving.metrics import ServeTelemetry  # noqa: F401
from distributed_training_tpu_torch.serving.pages import (  # noqa: F401
    NULL_PAGE,
    PagePool,
    pages_for,
)
from distributed_training_tpu_torch.serving.queue import RequestQueue  # noqa: F401
from distributed_training_tpu_torch.serving.request import (  # noqa: F401
    FINISH_CANCELLED,
    FINISH_EOS,
    FINISH_LENGTH,
    FINISH_PREEMPT_TIMEOUT,
    FINISH_SHED,
    FINISH_TIMEOUT,
    ActiveSequence,
    FinishedRequest,
    Request,
)
from distributed_training_tpu_torch.serving.scheduler import SlotScheduler  # noqa: F401
from distributed_training_tpu_torch.serving.timeseries import (  # noqa: F401
    TelemetryRing,
)
