"""Inference: KV-cache autoregressive generation for the LM (the port of
``distributed_training_tpu/inference``): :mod:`sampler` (``Generator``),
:mod:`beam` (``BeamSearcher``), :mod:`restore` (a checkpoint of the GPT
CLI into a model)."""

from distributed_training_tpu_torch.inference.beam import (  # noqa: F401
    BeamConfig,
    BeamSearcher,
)
from distributed_training_tpu_torch.inference.sampler import (  # noqa: F401
    CacheBudgetError,
    Generator,
    SampleConfig,
    apply_top_k,
    apply_top_p,
    cache_budget,
    sample_token,
)
