"""The port's config dataclasses against the JAX package's: same field
names, same defaults, same plugin presets and batch-size arithmetic."""

import dataclasses

import pytest

from distributed_training_tpu import config as jcfg
from distributed_training_tpu_torch import config as tcfg

# TrainConfig fields whose dataclasses are not ported yet (ROADMAP.md);
# ``chaos``, the last, is ported.
NOT_PORTED_FIELDS: set = set()


def _fields(cls):
    """Each field's default; a nested dataclass's as its dict (each
    package has its own class)."""
    out = {f.name: (f.default if f.default is not dataclasses.MISSING
                    else f.default_factory()) for f in dataclasses.fields(cls)}
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in out.items()}


@pytest.mark.parametrize("name", ["OptimizerConfig", "SchedulerConfig",
                                  "PrecisionConfig", "ZeroConfig",
                                  "CheckpointConfig", "DataConfig",
                                  "MoEConfig", "LMConfig", "MeshSpec",
                                  "ObservabilityConfig", "TraceConfig",
                                  "ChaosConfig"])
def test_dataclass_fields_and_defaults_match(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_train_config_matches_but_unported_sections():
    j, t = _fields(jcfg.TrainConfig), _fields(tcfg.TrainConfig)
    assert set(j) - set(t) == NOT_PORTED_FIELDS
    assert set(t) <= set(j)
    for k in t:
        assert t[k] == j[k], k


@pytest.mark.parametrize("plugin", tcfg.PLUGINS)
def test_plugin_presets_match(plugin):
    j = jcfg.TrainConfig.from_plugin(plugin, model="resnet_micro")
    t = tcfg.TrainConfig.from_plugin(plugin, model="resnet_micro")
    for k in ("model", "plugin", "optimizer", "precision", "zero"):
        a, b = getattr(t, k), getattr(j, k)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b
    assert t.precision.initial_scale == j.precision.initial_scale


@pytest.mark.parametrize("batch,gbs,accum,world", [
    (8, None, 1, 1), (8, None, 3, 2), (8, 64, 1, 2), (8, 48, 1, 2),
    (8, 48, 2, 1), (8, 20, 1, 1),
])
def test_effective_batch_sizes_match(batch, gbs, accum, world):
    kw = dict(gradient_accumulation_steps=accum)
    j = jcfg.TrainConfig(data=jcfg.DataConfig(batch_size=batch, global_batch_size=gbs), **kw)
    t = tcfg.TrainConfig(data=tcfg.DataConfig(batch_size=batch, global_batch_size=gbs), **kw)
    assert tcfg.effective_batch_sizes(t, world) == jcfg.effective_batch_sizes(j, world)


def test_effective_batch_sizes_errors_match():
    t = tcfg.TrainConfig(data=tcfg.DataConfig(batch_size=8, global_batch_size=30),
                         gradient_accumulation_steps=4)
    with pytest.raises(ValueError):
        tcfg.effective_batch_sizes(t, 1)
    with pytest.raises(ValueError):
        tcfg.TrainConfig.from_plugin("nope")
