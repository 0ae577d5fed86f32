"""Continuous-batching serving for the transformer LM: the port of
``distributed_training_tpu/serving/``'s engine and its features.

:class:`Engine` (paged KV with chunked prefill, or the legacy contiguous
slots), :class:`RequestQueue` (tiers, tenants, quotas, deadlines,
shedding), :class:`SlotScheduler` (iteration-level batching with
preempt-and-requeue), :class:`PagePool`, :class:`ServeTelemetry` and
:class:`TelemetryRing`, the per-request :class:`LatencyLedger`, the radix
:class:`PrefixCache`, the speculative drafters (``speculative.py``), int8
weights (``quantize.py``), the :class:`RequestJournal` and the
:class:`HotSwapper`; the control room (:class:`AlertEngine` over SLO
rules, the :class:`IncidentWriter`) and the fleet: the SSE front door of
one engine (:class:`ServingFrontend`), the cache-aware :class:`Router`
behind a :class:`RouterFrontDoor` over :class:`HttpReplica` clients, and the
:class:`ReplicaSupervisor`. The CLIs are ``gpt/torch_cuda/serve.py`` and
``python -m distributed_training_tpu_torch.tools.serve_net``.
"""

from distributed_training_tpu_torch.resilience.errors import (  # noqa: F401
    DrainingError,
    JournalCorruptError,
    QueueFullError,
    SwapError,
)
from distributed_training_tpu_torch.serving.alerts import (  # noqa: F401
    AlertEngine,
    IncidentWriter,
    SLORule,
    default_rules,
    parse_slo_rules,
)
from distributed_training_tpu_torch.serving.engine import Engine  # noqa: F401
from distributed_training_tpu_torch.serving.frontend import ServingFrontend  # noqa: F401
from distributed_training_tpu_torch.serving.hotswap import (  # noqa: F401
    HotSwapper,
    committed_epochs,
)
from distributed_training_tpu_torch.serving.journal import (  # noqa: F401
    JournaledRequest,
    RecoveredState,
    RequestJournal,
)
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
from distributed_training_tpu_torch.serving.prefix_cache import PrefixCache  # noqa: F401
from distributed_training_tpu_torch.serving.quantize import (  # noqa: F401
    QuantizedTensor,
    dequantize_params,
    quantize_params,
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
from distributed_training_tpu_torch.serving.router import (  # noqa: F401
    HttpReplica,
    Router,
    RouterFrontDoor,
)
from distributed_training_tpu_torch.serving.scheduler import SlotScheduler  # noqa: F401
from distributed_training_tpu_torch.serving.speculative import (  # noqa: F401
    GPTDrafter,
    NGramDrafter,
)
from distributed_training_tpu_torch.serving.supervisor import (  # noqa: F401
    ReplicaSupervisor,
)
from distributed_training_tpu_torch.serving.timeseries import (  # noqa: F401
    TelemetryRing,
)
