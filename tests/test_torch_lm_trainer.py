"""The port's LMTrainer on the CPU: ``fit()`` returns the JAX trainer's
keys and its loss falls; the slice as a whole matches the JAX package's
LMTrainer from the same weights; a checkpoint resume is step-accurate;
unported options raise; without ``device`` and without a GPU it raises.

The slice test runs both trainers on the same synthetic tokens, 4 steps
of ``hybrid_adam`` with ``attn_impl="flash"`` (the JAX side's Pallas
kernels in interpret mode) in float32 on a one-device mesh. Tolerances,
float32 on the CPU with sums in other orders over 4 steps: last loss and
eval perplexity rtol 1e-5, parameters atol 2e-5 (2% of lr 1e-3); Adam's
eps is 1e-4 so that near-zero gradients do not turn rounding into
lr-sized steps.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from distributed_training_tpu import config as jcfg
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch import config as tcfg
from distributed_training_tpu_torch.train.lm_trainer import LMTrainer, check_lm_config
from distributed_training_tpu_torch.train.trainer import Trainer

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

# distributed_training_tpu/train/lm_trainer.py returns exactly these keys.
JAX_FIT_KEYS = {"final_perplexity", "preempted", "last_metrics", "steps"}


def _cfg(mod, ckpt_dir, *, epochs=1, impl="flash", dtype="fp32", resume=-1,
         interval=1, **kw):
    return mod.TrainConfig(
        model="transformer_lm", num_epochs=epochs, log_interval=1,
        optimizer=mod.OptimizerConfig(name="hybrid_adam", lr=1e-3, eps=1e-4),
        precision=mod.PrecisionConfig(dtype=dtype),
        lm=mod.LMConfig(seq_len=32, vocab_size=64, num_layers=2, num_heads=2,
                        hidden_dim=32, max_len=64, attn_impl=impl,
                        logits_dtype="fp32", train_sequences=64,
                        eval_sequences=16),
        data=mod.DataConfig(batch_size=8, max_steps_per_epoch=4, prefetch=0),
        checkpoint=mod.CheckpointConfig(directory=str(ckpt_dir), interval=interval,
                                        resume=resume, async_save=False),
    ).replace(**kw)


def _params(trainer):
    return {n: p.detach().clone() for n, p in trainer.model.named_parameters()}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fit_returns_jax_keys_and_loss_falls(tmp_path, dtype):
    t = LMTrainer(_cfg(tcfg, tmp_path / "ck", epochs=2, dtype=dtype), device="cpu")
    out = t.fit()
    assert set(out) == JAX_FIT_KEYS
    assert out["steps"] == 8 and out["preempted"] is False
    losses = [h["loss"] for h in t.meter.history]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert np.isfinite(out["final_perplexity"]) and out["final_perplexity"] < 64
    assert set(out["last_metrics"]) == {"loss", "aux_loss", "accuracy", "perplexity",
                                        "loss_scale", "grads_finite", "step"}


def test_fit_matches_jax_lm_trainer(tmp_path):
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    jt = JaxLMTrainer(_cfg(jcfg, tmp_path / "jax", interval=0), mesh=mesh)
    tt = LMTrainer(_cfg(tcfg, tmp_path / "torch", interval=0), device="cpu")
    bridge.load_flax_variables(tt.model, jax.device_get(jt.state.params))
    jout, tout = jt.fit(), tt.fit()
    assert set(tout) == set(jout)
    assert tout["steps"] == jout["steps"] == 4
    assert set(tout["last_metrics"]) == set(jout["last_metrics"])
    for k in ("loss", "perplexity", "accuracy"):
        np.testing.assert_allclose(tout["last_metrics"][k], jout["last_metrics"][k],
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(tout["final_perplexity"], jout["final_perplexity"],
                               rtol=1e-5)
    params, _ = bridge.state_dict_to_flax(tt.model)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=2e-5),
                 jax.device_get(jt.state.params), params)


def test_ema_eval_matches_jax_lm_trainer(tmp_path):
    """``adamw`` with the parameter EMA, eval through the EMA on both
    sides (the slice test's tolerances; the EMA as the parameters)."""
    def cfg(mod, d):
        return _cfg(mod, d, interval=0, optimizer=mod.OptimizerConfig(
            name="adamw", lr=1e-3, eps=1e-4, weight_decay=1e-2, ema_decay=0.5))

    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    jt = JaxLMTrainer(cfg(jcfg, tmp_path / "jax"), mesh=mesh)
    tt = LMTrainer(cfg(tcfg, tmp_path / "torch"), device="cpu")
    bridge.load_flax_variables(tt.model, jax.device_get(jt.state.params))
    bridge.load_optax_state(tt.model, tt.state.opt_state, jax.device_get(jt.state.opt_state))
    jout, tout = jt.fit(), tt.fit()
    np.testing.assert_allclose(tout["final_perplexity"], jout["final_perplexity"],
                               rtol=1e-5)
    from distributed_training_tpu.train.optim import ema_params

    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=2e-5),
                 ema_params(jax.device_get(jt.state.opt_state)),
                 bridge.named_to_flax_tree(tt.model, tt.state.opt_state.ema))


def test_resume_is_step_accurate(tmp_path):
    straight = LMTrainer(_cfg(tcfg, tmp_path / "a", epochs=2), device="cpu")
    straight.fit()
    LMTrainer(_cfg(tcfg, tmp_path / "b", epochs=1), device="cpu").fit()
    resumed = LMTrainer(_cfg(tcfg, tmp_path / "b", epochs=2, resume=0), device="cpu")
    out = resumed.fit()
    assert out["steps"] == straight.state.step == 8
    assert resumed.state.opt_state.count == 8
    a, b = _params(straight), _params(resumed)
    for n in a:
        torch.testing.assert_close(b[n], a[n], rtol=0, atol=0)


@pytest.mark.parametrize("override", [
    dict(tp_overlap=True),
    dict(moe=tcfg.MoEConfig(enabled=True), mesh=tcfg.MeshSpec(sequence=2)),
    dict(mesh=tcfg.MeshSpec(sequence=2)),
    dict(mesh=tcfg.MeshSpec(model=2)),
    dict(mesh=tcfg.MeshSpec(pipe=2)),
    dict(mesh=tcfg.MeshSpec(expert=2), moe=tcfg.MoEConfig(enabled=True, num_experts=(4,)),
         zero=tcfg.ZeroConfig(stage=1)),
    dict(mesh=tcfg.MeshSpec(fsdp=2)),
], ids=lambda o: next(iter(o)) + "=" + str(next(iter(o.values())))[:40])
def test_unported_options_raise(tmp_path, override):
    """What the LM trainer still lacks raises ``NotImplementedError``.
    (ZeRO, remat, adamw under ZeRO and the data axis, which this test once
    listed, are ported: see test_torch_lm_distributed.py and
    test_torch_remat.py. So are the sequence and model axes and
    ``tp_overlap``, multi-rank in test_torch_lm_sequence_parallel.py,
    test_torch_tensor_parallel.py and test_torch_tp_overlap.py: here, at
    world 1, ``tp_overlap`` over a model axis of 1 builds the plain step,
    as the JAX trainer does, and a sequence or model axis of 2 is a mesh
    one process cannot hold, refused as ``create_mesh`` refuses it. MoE
    and the expert axis are ported too, multi-rank in
    test_torch_moe_parallel.py, and under the sequence and model axes,
    multi-rank in test_torch_moe_axes.py: at world 1 MoE with a sequence
    or model axis of 2 is the mesh one process cannot hold, as for the
    dense model. So is the pipeline, multi-rank in test_torch_pp_parallel.py:
    a pipe axis of 2 is a mesh one process cannot hold too. What stays
    refused: MoE in the alternating layout with a pipe axis (the JAX
    trainer's ``NotImplementedError``, word for word, checked on the mesh
    sizes; it named ROADMAP.md until the pipeline was ported),
    ``tp_overlap`` with MoE (the JAX trainer's ``NotImplementedError``,
    word for word), ZeRO × expert parallelism without ``moe_param_group``,
    the JAX trainer's ``ValueError``, checked on the mesh sizes since one
    process cannot hold an expert axis of 2. The ``fsdp`` axis is ported,
    multi-rank in test_torch_fsdp.py: at world 1 an fsdp axis of 2 is a
    mesh one process cannot hold. Beside it, the live exporter
    (``metrics_port``) and span traces, which raised naming ROADMAP.md
    until they were ported, now start: the trainer opens the exporter on
    a free port and the trace session, and ``close`` releases the one and
    writes the other.)"""
    cfg = _cfg(tcfg, tmp_path, **override)
    if override == dict(tp_overlap=True):
        t = LMTrainer(cfg, device="cpu")
        assert t.tp is None and t.strategy == "tensor/dp"
        return
    if "moe" in override:
        if "zero" in override:
            with pytest.raises(ValueError, match="requires --moe-param-group"):
                check_lm_config(cfg, 1, 1, expert=2)
            check_lm_config(cfg.replace(moe=tcfg.MoEConfig(
                enabled=True, num_experts=(4,), moe_param_group=True)), 1, 1, expert=2)
            return
        for axis in ("sequence", "model"):
            bad = cfg.replace(mesh=tcfg.MeshSpec(**{axis: 2}))
            with pytest.raises(ValueError, match="not divisible by fixed axes product 2"):
                LMTrainer(bad, device="cpu")
        with pytest.raises(ValueError, match="not divisible by fixed axes product 2"):
            LMTrainer(cfg.replace(mesh=tcfg.MeshSpec(pipe=2)), device="cpu")
        with pytest.raises(NotImplementedError) as info:
            check_lm_config(cfg, 1, 1, pipe=2)
        with pytest.raises(NotImplementedError) as want:
            JaxLMTrainer(jcfg.TrainConfig(model="transformer_lm",
                                          moe=jcfg.MoEConfig(enabled=True)),
                         mesh=create_mesh(MeshConfig(data=1, pipe=2), devices=jax.devices()[:2]))
        assert str(info.value) == str(want.value)
        with pytest.raises(NotImplementedError) as info:
            LMTrainer(cfg.replace(mesh=tcfg.MeshSpec(), tp_overlap=True), device="cpu")
        with pytest.raises(NotImplementedError) as want:
            JaxLMTrainer(jcfg.TrainConfig(model="transformer_lm", tp_overlap=True,
                                          moe=jcfg.MoEConfig(enabled=True)),
                         mesh=create_mesh(MeshConfig(data=1), devices=jax.devices()[:1]))
        assert str(info.value) == str(want.value)
        return
    if "mesh" in override and (cfg.mesh.sequence, cfg.mesh.model, cfg.mesh.pipe,
                               cfg.mesh.fsdp) != (1, 1, 1, 1):
        with pytest.raises(ValueError, match="not divisible by fixed axes product 2"):
            LMTrainer(cfg, device="cpu")
    if cfg.mesh.fsdp != 1:
        # Ported beside it: the live exporter and span traces.
        t = LMTrainer(cfg.replace(mesh=tcfg.MeshSpec(), observability=tcfg.ObservabilityConfig(
            metrics_port=0, trace=tcfg.TraceConfig(enabled=True))), device="cpu")
        assert t.obs.exporter.port > 0 and t.trace is not None
        t.obs.close()
        assert os.path.isfile(t.obs.trace_path)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_decoded_cache_field_is_an_image_option(tmp_path, prefetch):
    """``data.decoded_cache`` shapes the image datasets alone; the LM
    trainer reads its token data either way, as the JAX LMTrainer does
    (the field, refused here once, is ported for the image pipeline)."""
    runs = []
    for cached in (False, True):
        cfg = _cfg(tcfg, tmp_path / str(cached), interval=0)
        cfg = cfg.replace(data=tcfg.DataConfig(batch_size=8, max_steps_per_epoch=4,
                                               prefetch=prefetch, decoded_cache=cached))
        t = LMTrainer(cfg, device="cpu")
        out = t.fit()
        runs.append(([h["loss"] for h in t.meter.history], out["final_perplexity"]))
    assert runs[0] == runs[1] and len(runs[0][0]) == 4


@pytest.mark.parametrize("lm_override", [
    dict(num_microbatches=2), dict(num_microbatches=4), dict(virtual_stages=2),
    dict(virtual_stages=3)], ids=lambda o: "=".join(map(str, next(iter(o.items())))))
def test_unported_lm_options_raise(tmp_path, lm_override):
    """The pipeline's options, with the pipe axis they shape, are checked as
    the JAX trainer checks them (they raised until the pipeline was
    ported): at pipe 2 over the 2 layers, 2 and 4 microbatches build in
    both packages, and 2 and 3 virtual stages raise JAX's ``ValueError``,
    word for word, checked on the mesh sizes since one process cannot hold
    a pipe axis of 2 (test_torch_pp_parallel.py runs the pipeline over
    ranks). (The chunked and saved-probabilities CE, which this test once
    listed, are ported: test_torch_lm_ce.py. Without the pipe axis the JAX
    trainer reads neither option, and the port builds as it does.)"""
    cfg = _cfg(tcfg, tmp_path)
    cfg = cfg.replace(lm=tcfg.LMConfig(**{**vars(cfg.lm), **lm_override}))
    LMTrainer(cfg, device="cpu")
    jc = _cfg(jcfg, tmp_path, impl="exact")
    jc = jc.replace(lm=jcfg.LMConfig(**{**vars(jc.lm), **lm_override}))
    try:
        JaxLMTrainer(jc, mesh=create_mesh(MeshConfig(data=1, pipe=2), devices=jax.devices()[:2]))
        want = None
    except ValueError as e:
        want = str(e)
    if "virtual_stages" in lm_override:
        assert want is not None
        with pytest.raises(ValueError, match=f"^{re.escape(want)}$"):
            check_lm_config(cfg, 1, 1, pipe=2)
    else:
        assert want is None
        check_lm_config(cfg, 1, 1, pipe=2)


def test_bf16_stays_refused_on_the_image_path(tmp_path):
    """Named for the refusal it checked until the image path took bf16:
    now the image Trainer builds the model to compute in bfloat16 over
    float32 parameters, with an inert loss scaler, and fits."""
    cfg = tcfg.TrainConfig(model="resnet_micro", precision=tcfg.PrecisionConfig(dtype="bf16"),
                           num_epochs=1, eval_every=0,
                           checkpoint=tcfg.CheckpointConfig(directory=str(tmp_path), interval=0),
                           data=tcfg.DataConfig(dataset="synthetic_cifar", batch_size=4,
                                                max_steps_per_epoch=1))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert not trainer.state.loss_scale.dynamic
    assert trainer.fit()["steps"] == 1


def test_without_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMTrainer(_cfg(tcfg, tmp_path))
