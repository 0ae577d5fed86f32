"""The port's pipeline schedule in one process (``parallel/pipeline.py``)
against the JAX package's ``distributed_training_tpu/parallel/pipeline.py``.

- ``circular_layer_order`` gives JAX's lists;
- the tick schedule (chunk, microbatch, live, feed, done at every tick and
  stage) is ``spmd_pipeline``'s formulas, evaluated here in ``jnp``;
- the *virtual* pipeline (every stage in one process, the hops list
  rotations) computes the plain model's loss and gradients, GPipe and
  circular, with and without remat: loss rtol 1e-5, every gradient within
  1e-4 of its tensor's largest magnitude (float32);
- homogeneous MoE at a capacity that drops tokens: the virtual pipeline's
  logits and aux loss match JAX's ``PipelinedLM`` on a two-stage mesh from
  the same weights (the gate is local to each microbatch): rtol 1e-5;
- ``bubble_fraction`` and every refusal are JAX's (the message matched
  word for word);
- dropout draws distinct masks across microbatches and stages, and the
  same masks from the same generator.

The model is a micro GPT (2-4 layers, width 32, vocabulary 64, T 16,
exact attention).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.parallel import pipeline as jpipe
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.parallel import pipeline

torch.set_num_threads(1)

KW = dict(num_classes=64, num_heads=2, hidden_dim=32, max_len=64)
T = 16


def _plain(num_layers=4, **kw):
    return get_model("transformer_lm", num_layers=num_layers,
                     generator=torch.Generator().manual_seed(0), **KW, **kw)


def _tokens(b=4, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randint(0, 64, (b, T)))


@pytest.mark.parametrize("l,s,v", [(8, 4, 1), (8, 4, 2), (12, 4, 3), (12, 2, 2)])
def test_circular_layer_order_is_jaxs(l, s, v):
    assert pipeline.circular_layer_order(l, s, v) == jpipe.circular_layer_order(l, s, v)


@pytest.mark.parametrize("s,v,m", [(4, 1, 4), (2, 1, 3), (4, 3, 4), (2, 2, 2), (4, 2, 8)])
def test_tick_schedule_is_spmd_pipelines(s, v, m):
    """Every (tick, stage)'s chunk, microbatch, feed, live and done flags
    against ``spmd_pipeline``'s ``jnp`` formulas; the last stage finishes
    each microbatch exactly once, and the run has ``v·M + S − 1`` ticks."""
    ticks = pipeline.num_ticks(s, v, m)
    assert ticks == v * m + s - 1
    done = []
    for t in range(ticks):
        for idx in range(s):
            u = jnp.int32(t - idx)
            chunk = (jnp.maximum(u, 0) // s) % v
            mu = jnp.clip((u // (v * s)) * s + u % s, 0, m - 1)
            live = (u >= 0) & (u < v * m)
            want = pipeline.Tick(int(chunk), int(mu), bool(live),
                                 bool((idx == 0) & (chunk == 0)),
                                 bool((idx == s - 1) & (chunk == v - 1) & live))
            got = pipeline.tick_plan(t, idx, s, v, m)
            assert got == want, (t, idx)
            if got.done:
                done.append(got.microbatch)
    assert sorted(done) == list(range(m))


def _loss_and_grads(model, tokens):
    model.zero_grad()
    logits = model(tokens)
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, 64),
                                             torch.roll(tokens, -1, 1).reshape(-1))
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("layers,s,v,m,remat", [
    (4, 4, 1, 4, False), (4, 2, 1, 2, True), (8, 4, 2, 4, False), (8, 2, 2, 2, True),
    (12, 4, 3, 4, False)],
    ids=["gpipe_s4", "gpipe_s2_remat", "circular_s4_v2", "circular_s2_v2_remat",
         "circular_s4_v3"])
def test_virtual_pipeline_matches_the_plain_model(layers, s, v, m, remat):
    """The virtual pipeline's loss and every gradient against the plain
    model's on the same weights and batch (float32): its state dict is the
    plain model's, name for name."""
    plain = _plain(layers)
    pp = pipeline.PipelinedLM(_plain(layers, remat=remat), num_microbatches=m,
                              virtual_stages=v, pipe_size=s)
    assert list(pp.state_dict()) == list(plain.state_dict())
    pp.train()
    tokens = _tokens(8)
    want, want_g = _loss_and_grads(plain, tokens)
    got, got_g = _loss_and_grads(pp, tokens)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    for n, g in want_g.items():
        torch.testing.assert_close(got_g[n], g, rtol=0, atol=1e-4 * g.abs().max().item())


def test_virtual_moe_pipeline_matches_jax_pipelined_lm():
    """Homogeneous MoE (every layer 4 experts, top-1, capacity factor 0.5,
    so tokens drop) through the virtual pipeline: the logits and the aux
    loss of JAX's ``PipelinedLM`` on a data 1 × pipe 2 mesh, whose stage
    gates each microbatch alone."""
    moe = dict(moe_num_experts=4, moe_every=1, moe_top_k=1, moe_capacity_factor=0.5)
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, num_layers=4, **KW, **moe)
    mesh = create_mesh(MeshConfig(data=1, pipe=2), devices=jax.devices()[:2])
    jplm = jpipe.PipelinedLM(jm, mesh, num_microbatches=2)
    params = jplm.init_params(jax.random.PRNGKey(0))
    tokens = _tokens(4)
    want, mut = jax.jit(lambda p, t: jplm.apply_fn({"params": p}, t, mutable=["aux_loss"]))(
        params, jnp.asarray(tokens.numpy()))
    want_aux = float(mut["aux_loss"]["pipeline"][0])
    pp = pipeline.PipelinedLM(get_model("transformer_lm", num_layers=4, **KW, **moe),
                              num_microbatches=2, pipe_size=2)
    bridge.load_flax_pipeline(pp, jax.device_get(params), jplm.layer_order)
    pp.eval()
    with torch.no_grad():
        got, aux = pp(tokens, return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5)
    kept = [getattr(pp, f"block{i}").moe_mlp.kept_share.item() for i in range(4)]
    assert min(kept) < 1.0  # the capacity drops tokens


@pytest.mark.parametrize("s,v,m", [(4, 1, 4), (4, 2, 4), (2, 3, 8), (2, 1, 1)])
def test_bubble_fraction_is_jaxs(s, v, m):
    jm = jax_model("transformer_lm", num_layers=s * v * 2, **KW)
    mesh = create_mesh(MeshConfig(data=1, pipe=s), devices=jax.devices()[:s])
    want = jpipe.PipelinedLM(jm, mesh, num_microbatches=m, virtual_stages=v).bubble_fraction
    pp = pipeline.PipelinedLM(_plain(s * v * 2), num_microbatches=m, virtual_stages=v,
                              pipe_size=s)
    assert pp.bubble_fraction == pytest.approx(want, rel=1e-12)
    assert pipeline.bubble_fraction(s, v, m) == pytest.approx((s - 1) / (v * m + s - 1))


def _jax_refusal(layers, s, m, v, **kw):
    jm = jax_model("transformer_lm", num_layers=layers, **KW, **kw)
    mesh = create_mesh(MeshConfig(data=1, pipe=s), devices=jax.devices()[:s])
    with pytest.raises((ValueError, NotImplementedError)) as info:
        jpipe.PipelinedLM(jm, mesh, num_microbatches=m, virtual_stages=v)
    return info.type, str(info.value)


@pytest.mark.parametrize("layers,s,m,v,kw", [
    (3, 2, 2, 1, {}), (4, 2, 2, 3, {}), (8, 4, 2, 2, {}), (4, 2, 2, 0, {}),
    (4, 2, 2, 1, dict(moe_num_experts=4, moe_every=2)),
    (4, 2, 2, 1, dict(moe_num_experts=(4, 8, 4, 8), moe_every=1))],
    ids=["layers_by_stages", "layers_by_chunks", "circular_microbatches",
         "virtual_stages_0", "alternating_moe", "two_expert_counts"])
def test_refusals_are_jaxs(layers, s, m, v, kw):
    """What JAX's ``PipelinedLM`` refuses, the port's refuses with the same
    exception type and message."""
    kind, msg = _jax_refusal(layers, s, m, v, **kw)
    with pytest.raises(kind, match=f"^{re.escape(msg)}$"):
        pipeline.PipelinedLM(_plain(layers, **kw), num_microbatches=m, virtual_stages=v,
                             pipe_size=s)


def test_microbatches_must_divide_the_batch():
    """``spmd_pipeline``'s message for a local batch that the microbatches
    do not divide."""
    pp = pipeline.PipelinedLM(_plain(2), num_microbatches=3, pipe_size=2)
    with pytest.raises(ValueError, match="local batch 4 not divisible by microbatches 3"):
        pp(_tokens(4))


def test_dropout_masks_distinct_across_microbatches_and_stages():
    """With dropout, microbatches of identical rows come out different (each
    draws its own masks), every (microbatch, global chunk, layer) generator
    draws its own stream, and the same step generator gives the same
    result; without training the output is deterministic."""
    pp = pipeline.PipelinedLM(_plain(4, dropout_rate=0.5), num_microbatches=4, pipe_size=2)
    pp.train()
    tokens = _tokens(1).repeat(4, 1)
    gen = lambda: torch.Generator().manual_seed(123)  # noqa: E731
    with torch.no_grad():
        a, b = pp(tokens, generator=gen()), pp(tokens, generator=gen())
        c = pp(tokens, generator=torch.Generator().manual_seed(124))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    for i in range(1, 4):
        assert not torch.allclose(a[0], a[i])
    draws = set()
    s, v, m = 2, 1, 4
    for mu in range(m):
        for idx in range(s):
            for layer in pp.layers(idx):
                slot = mu * v * s + idx
                draws.add(torch.rand(4, generator=pipeline._layer_generator(
                    123, slot, layer, torch.device("cpu")))[0].item())
    assert len(draws) == m * 4
    pp.eval()
    with torch.no_grad():
        e = pp(tokens)
    torch.testing.assert_close(e[0], e[3], rtol=0, atol=0)


def test_bridge_carries_stacked_trees_to_each_stage():
    """JAX's stacked ``blocks`` tree in circular storage order, and a
    param-shaped tree of the same layout (Adam's moments), reach each
    stage's blocks under their layer names: the rows JAX's
    ``unstack_block_params`` gives those layers."""
    jm = jax_model("transformer_lm", num_layers=8, **KW)
    mesh = create_mesh(MeshConfig(data=1, pipe=4), devices=jax.devices()[:4])
    jplm = jpipe.PipelinedLM(jm, mesh, num_microbatches=4, virtual_stages=2)
    params = jax.device_get(jplm.init_params(jax.random.PRNGKey(0)))
    moments = jax.tree.map(lambda x: 2.0 * x + 1.0, params)
    whole = jpipe.unstack_block_params(moments["blocks"],
                                       {k: v for k, v in moments.items() if k != "blocks"},
                                       layer_order=jplm.layer_order)
    want = bridge.flax_tree_to_named(_plain(8), whole)
    for idx in range(4):
        # Stage idx's modules: the virtual pipeline less the other stages' blocks.
        stage = pipeline.PipelinedLM(_plain(8), num_microbatches=4, virtual_stages=2,
                                     pipe_size=4)
        for i in set(range(8)) - set(stage.layers(idx)):
            delattr(stage, f"block{i}")
        assert stage.layers(idx) == [idx, idx + 4]
        got = bridge.flax_pipeline_tree_to_named(stage, moments, jplm.layer_order)
        assert set(got) == {n for n, _ in stage.named_parameters()}
        for n, t in got.items():
            torch.testing.assert_close(t, want[n], rtol=0, atol=0)
        bridge.load_flax_pipeline(stage, params, jplm.layer_order)


def test_ce_chunk_check_takes_the_full_length_under_sp_x_pp():
    """JAX's CE chunk check: the sequence strategy's chunk must divide a
    shard's T/sp, the pipeline's (SP×PP too) the full T; the port's step
    runs the chunk over a shard in pieces that divide it (the same sum)."""
    from distributed_training_tpu_torch import config as tcfg
    from distributed_training_tpu_torch.train.lm_trainer import check_lm_config

    cfg = tcfg.TrainConfig(model="transformer_lm", data=tcfg.DataConfig(batch_size=4),
                           lm=tcfg.LMConfig(seq_len=32, num_layers=4, num_microbatches=2,
                                            ce_chunk_size=32))
    check_lm_config(cfg, 2, 1, pipe=2)
    with pytest.raises(ValueError, match=re.escape(
            "ce_chunk_size 32 must divide the per-shard loss sequence length (= 16)")):
        check_lm_config(cfg, 2, 1)
