"""The port's N-step call (``train/multi_step.py``) and the count on the
card it rests on, against the JAX package on the CPU.

- **Schedules.** The tensor form of ``make_schedule`` (a 0-d integer count
  tensor in, a 0-d float32 learning rate out) equals the host form bit for
  bit for ``constant`` and ``warmup_lr`` at counts 0–40, and for ``cosine``
  within 2**-23 of the peak rate: numpy's and PyTorch's float32 ``cos``
  differ by up to one ulp (of at most 1, so 2**-24, halved and scaled by
  the peak, plus the result's own rounding). Against optax's values the
  same bounds hold at rtol 1e-6 (XLA's float32 arithmetic, as
  ``tests/test_torch_fused_adam.py`` compares the host form).
- **K1's tensor scalars.** The plain version with ``scalars`` from
  ``adam_scalars_tensor`` equals the by-value form bit for bit.
- **The image step.** ``make_multi_step(n=3)`` on ``resnet_micro`` (10
  classes, bf16 compute over float32 parameters, SGD 0.1 with momentum
  0.9, accumulation 2: the bench's image step) against the root bench's
  ``multi``, a ``lax.scan`` of three steps of the JAX package's step, from
  the same weights (carried by ``bridge.py``). The images are 64×64 at
  batch 8, the single-step tests' size: at 32×32 and batch 4 each
  microbatch's last BatchNorm normalises 1×1 maps over 2 examples, and
  there even the float32 steps of the two packages end 16% apart (the
  norm of the difference of the updates over the update, measured on the
  CPU) from rounding alone, where at 64×64 they agree to 5.4e-6. So the
  float32 step is held to 1e-4 of the update and the last loss to rtol
  1e-5; the bf16 update to the single-step bf16 test's tolerance
  (``test_torch_bf16_ema.py``): XLA's and oneDNN's bf16 convolutions round
  at other places, so it is held to twice the JAX package's own
  bf16-vs-float32 gap over the same three steps. After three steps and
  six BatchNorm ticks that test's per-tensor 3e-2 on the statistics no
  longer holds (up to 5.7% measured), nor does a loss tolerance from one
  package alone (JAX's own bf16 loss lands 0.2% from its float32 one, the
  port's 1.2%, the two bf16 losses 1.4% apart): the last loss and the
  BatchNorm statistics (all tensors' norm) of the two bf16 runs are held to
  twice the larger of the two packages' own bf16-vs-float32 gaps.
- **The LM step.** The same on a 2-layer GPT (hidden 64, 4 heads, T 128,
  flash, float32 logits; JAX's flash in interpret mode), with AdamW under
  a warm-up schedule and with ``hybrid_adam`` (K1's plain version with
  tensor scalars) under a cosine one. The tolerance is the single-step LM
  test's (``test_torch_lm_step.py``, float32 with sums in other orders):
  the loss rtol 1e-5, parameters atol 1e-5, Adam moments within 1e-4 of
  each tensor's largest magnitude.
- **Loop against steps.** The N-step call equals N eager steps exactly:
  losses, parameters, optimizer slots, BatchNorm statistics, and the
  counts on the host and on the device.
- **Refusals.** A dynamic loss scale and a dropout model raise.
- **The graph's kernel census.** ``dot_kernel_names`` reads the kernel
  nodes of a verbose DOT dump (an excerpt of a GPT-2-small step's graph
  captured on an H100: K2, K3, K1, a copy, a memset and an edge); on the
  CPU there is no graph to dump.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.config import SchedulerConfig as JSched
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train import lm_step as jlm
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.optim import make_schedule as jschedule
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.step import make_train_step as jax_step
from distributed_training_tpu.train.train_state import TrainState as JState
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import (
    OptimizerConfig,
    PrecisionConfig,
    SchedulerConfig,
)
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.ops.fused_adam import (
    adam_scalars_tensor,
    fused_adam_reference,
    fused_adam_update,
)
from distributed_training_tpu_torch.train import lm_step
from distributed_training_tpu_torch.train.multi_step import (
    dot_kernel_names,
    graph_kernels,
    make_multi_step,
)
from distributed_training_tpu_torch.train.optim import make_optimizer, make_schedule
from distributed_training_tpu_torch.train.precision import LossScaleState
from distributed_training_tpu_torch.train.step import make_train_step
from distributed_training_tpu_torch.train.train_state import TrainState

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

SCHEDULES = [
    dict(name="constant"),
    dict(name="warmup_lr", warmup_min_lr=1e-4, warmup_max_lr=2e-3, warmup_num_steps=7),
    dict(name="cosine", warmup_min_lr=1e-5, warmup_num_steps=5, total_steps=30),
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: s["name"])
def test_tensor_schedule_matches_host_and_optax(sched):
    opt = dict(lr=2e-3, scale_lr_by_world=True)
    host = make_schedule(OptimizerConfig(**opt), SchedulerConfig(**sched), 2)
    js = jschedule(JOpt(**opt), JSched(**sched), world_size=2)
    atol = 0.0 if sched["name"] != "cosine" else 2 * 2e-3 * 2.0 ** -23
    for count in range(41):
        got = host(torch.tensor(count))
        assert got.dtype == torch.float32 and got.shape == ()
        want = host(count)
        assert isinstance(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
        np.testing.assert_allclose(got.numpy(), np.asarray(js(jnp.int32(count))),
                                   rtol=1e-6, atol=atol)


def test_k1_plain_version_takes_tensor_scalars():
    rng = np.random.RandomState(0)
    p, m, v = (torch.from_numpy(rng.randn(300, 7).astype(np.float32)) for _ in range(3))
    v = v.abs()
    g = torch.from_numpy(rng.randn(300, 7).astype(np.float32))
    for step in range(1, 6):
        scalars = adam_scalars_tensor(torch.tensor(3e-3, dtype=torch.float32),
                                      torch.tensor(step), 0.8, 0.95)
        want = fused_adam_reference(p, g, m, v, 3e-3, step, 0.8, 0.95, 1e-8)
        got = fused_adam_reference(p, g, m, v, b1=0.8, b2=0.95, eps=1e-8, scalars=scalars)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        outs = [torch.empty_like(t) for t in (p, m, v)]
        fused_adam_update([p], [g], [m], [v], b1=0.8, b2=0.95, eps=1e-8,
                          scalars=scalars, out=tuple([t] for t in outs))
        for a, b in zip(outs, want):
            assert torch.equal(a, b)
        p, m, v = want


def _jax_multi(inner, n):
    """The root bench's ``multi`` (``bench.py``): a ``lax.scan`` of ``n``
    steps of the jitted step over one batch, the state donated."""
    @functools.partial(jax.jit, donate_argnums=(0,))
    def multi(state, batch, key):
        def body(s, _):
            s, m = inner(s, batch, key)
            return s, m["loss"]
        state, losses = lax.scan(body, state, None, length=n)
        return state, {"loss": losses[-1]}
    return multi


def _mesh():
    return create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])


def _update_gap(p0, a, b):
    """‖Δa − Δb‖ / ‖Δa‖ over every tensor, Δ the change from ``p0``."""
    def delta(tree):
        return np.concatenate([(np.asarray(x, np.float32) - y).ravel()
                               for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(p0))])
    da, db = delta(a), delta(b)
    return np.linalg.norm(da - db) / np.linalg.norm(da)


def _gap(a, b):
    """‖a − b‖ / ‖b‖ over every leaf of two trees."""
    flat = [np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree.leaves(t)])
            for t in (a, b)]
    return np.linalg.norm(flat[0] - flat[1]) / np.linalg.norm(flat[1])


SGD = dict(name="sgd", lr=0.1, momentum=0.9)


def _image_batch(rng, size=32, batch=4):
    return {"image": rng.rand(batch, size, size, 3).astype(np.float32),
            "label": rng.randint(0, 10, batch).astype(np.int32)}


def test_image_multi_step_matches_jax_scan():
    batch = _image_batch(np.random.RandomState(0), size=64, batch=8)
    multi = _jax_multi(jax_step(_mesh(), donate=False, grad_accum_steps=2), 3)
    jout, tout = {}, {}
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        tm = get_model("resnet_micro", num_classes=10, dtype=tdt,
                       generator=torch.Generator().manual_seed(0))
        p0, stats0 = bridge.state_dict_to_flax(tm)
        js = JState.create(apply_fn=jax_model("resnet_micro", dtype=jdt).apply,
                           params=jax.tree.map(jnp.asarray, p0), tx=jmake(JOpt(**SGD)),
                           batch_stats=jax.tree.map(jnp.asarray, stats0),
                           loss_scale=JLoss.create(JPrec(dtype="bf16")))
        js, jm = multi(js, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
        jout[tdt] = (jax.device_get(js), float(jm["loss"]))
        tstate = TrainState.create(tm, make_optimizer(OptimizerConfig(**SGD)),
                                   LossScaleState.create(PrecisionConfig(dtype="bf16")))
        tmulti = make_multi_step(make_train_step(grad_accum_steps=2), tstate,
                                 {k: torch.from_numpy(v) for k, v in batch.items()}, 3)
        loss = float(tmulti()["loss"])
        assert int(js.step) == tstate.step == tstate.opt_state.count == 3
        assert int(tstate.opt_state.count_t) == 3
        tout[tdt] = (*bridge.state_dict_to_flax(tm), loss)
    (jb16, jloss), (jf32, jloss32) = jout[torch.bfloat16], jout[torch.float32]
    (p32, s32, loss32), (p16, s16, loss16) = tout[torch.float32], tout[torch.bfloat16]
    np.testing.assert_allclose(loss32, jloss32, rtol=1e-5)
    assert _update_gap(p0, jf32.params, p32) < 1e-4
    noise = _update_gap(p0, jb16.params, jf32.params)
    assert 0 < _update_gap(p0, jb16.params, p16) < 2 * noise
    assert abs(loss16 - jloss) <= 2 * max(abs(jloss - jloss32), abs(loss16 - loss32))
    assert _gap(s16, jb16.batch_stats) <= 2 * max(_gap(jf32.batch_stats, jb16.batch_stats),
                                                  _gap(s32, s16))


LM_KW = dict(num_classes=64, num_layers=2, num_heads=4, hidden_dim=64, max_len=128)
LM_CASES = {
    "adamw": (dict(name="adamw", lr=1e-3, eps=1e-4, weight_decay=1e-4),
              dict(name="warmup_lr", warmup_min_lr=1e-4, warmup_max_lr=1e-3,
                   warmup_num_steps=2)),
    "hybrid_adam": (dict(name="hybrid_adam", lr=1e-3, eps=1e-4, weight_decay=1e-4),
                    dict(name="cosine", warmup_min_lr=0.0, warmup_num_steps=1,
                         total_steps=4)),
}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_multi_step_matches_jax_scan(case):
    opt, sched = LM_CASES[case]
    tm = get_model("transformer_lm", attn_impl="flash", logits_dtype=torch.float32,
                   generator=torch.Generator().manual_seed(1), **LM_KW)
    p0, _ = bridge.state_dict_to_flax(tm)
    jm = jax_model("transformer_lm", attn_impl="flash", logits_dtype=jnp.float32, **LM_KW)
    js = JState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, p0),
                       tx=jmake(JOpt(**opt), JSched(**sched)), batch_stats={},
                       loss_scale=JLoss.create(JPrec()))
    toks = np.random.RandomState(2).randint(0, 64, (2, 129)).astype(np.int32)
    batch = lm_step.make_lm_batch(toks)
    multi = _jax_multi(jlm.make_tp_lm_train_step(_mesh(), model=jm, donate=False), 3)
    js, jmet = multi(js, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    js = jax.device_get(js)

    tstate = TrainState.create(tm, make_optimizer(OptimizerConfig(**opt),
                                                  SchedulerConfig(**sched)),
                               LossScaleState.create(PrecisionConfig()))
    tmulti = make_multi_step(lm_step.make_lm_train_step(max_len=128), tstate,
                             {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in batch.items()}, 3)
    metrics = tmulti()
    np.testing.assert_allclose(float(metrics["loss"]), float(jmet["loss"]), rtol=1e-5)
    assert int(js.step) == tstate.step == 3 and int(tstate.opt_state.count_t) == 3
    params, _ = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 js.params, params)
    moments = [s for s in jax.tree.leaves(js.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
               if hasattr(s, "mu")]
    assert len(moments) == 1 and int(moments[0].count) == tstate.opt_state.count == 3
    for mine, ref in ((tstate.opt_state.mu, moments[0].mu), (tstate.opt_state.nu, moments[0].nu)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()),
            ref, bridge.named_to_flax_tree(tm, mine))


SMALL_LM = dict(num_classes=64, num_layers=1, num_heads=2, hidden_dim=32, max_len=16)


def _image_case():
    model = get_model("resnet_micro", num_classes=10, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(3))
    state = TrainState.create(model, make_optimizer(OptimizerConfig(**SGD)),
                              LossScaleState.create(PrecisionConfig(dtype="bf16")))
    batch = _image_batch(np.random.RandomState(4), size=16)
    return state, make_train_step(grad_accum_steps=2), {
        k: torch.from_numpy(v) for k, v in batch.items()}


def _lm_case(name):
    model = get_model("transformer_lm", generator=torch.Generator().manual_seed(5),
                      **SMALL_LM)
    sched = SchedulerConfig(name="warmup_lr", warmup_min_lr=1e-4, warmup_max_lr=1e-3,
                            warmup_num_steps=4)
    state = TrainState.create(
        model, make_optimizer(OptimizerConfig(name=name, lr=1e-3, weight_decay=1e-4), sched),
        LossScaleState.create(PrecisionConfig()))
    toks = np.random.RandomState(6).randint(0, 64, (2, 17)).astype(np.int32)
    return state, lm_step.make_lm_train_step(max_len=16), {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in lm_step.make_lm_batch(toks).items()}


def _tensors(state):
    return [*state.model.state_dict().values(),
            *(t for slot in state.opt_state.slots.values() for t in slot.values())]


@pytest.mark.parametrize("case", ["image_sgd", "lm_adamw", "lm_hybrid_adam"])
def test_multi_step_equals_eager_steps(case):
    """Two calls of 3 steps against 6 single eager steps, from the same
    state: every tensor equal, and the counts."""
    build = _image_case if case == "image_sgd" else functools.partial(
        _lm_case, case[3:])
    (a, step, batch), (b, _, _) = build(), build()
    multi = make_multi_step(step, a, batch, 3)
    got = [float(multi()["loss"]) for _ in range(2)]
    want = [float(step(b, batch)["loss"]) for _ in range(6)]
    assert got == want[2::3]
    assert a.step == b.step == a.opt_state.count == b.opt_state.count == 6
    assert int(a.opt_state.count_t) == int(b.opt_state.count_t) == 6
    assert not a.capturable
    for x, y in zip(_tensors(a), _tensors(b)):
        assert torch.equal(x, y)


def test_dynamic_loss_scale_and_dropout_refuse_the_n_step_call():
    model = get_model("resnet_micro", num_classes=10, generator=torch.Generator().manual_seed(0))
    state = TrainState.create(model, make_optimizer(OptimizerConfig(**SGD)),
                              LossScaleState.create(PrecisionConfig(dtype="fp16")))
    batch = {k: torch.from_numpy(v) for k, v in _image_batch(np.random.RandomState(0), 16).items()}
    with pytest.raises(NotImplementedError, match="dynamic loss scale.*ROADMAP"):
        make_multi_step(make_train_step(), state, batch, 2)()
    assert not state.capturable and state.step == 0
    model = get_model("transformer_lm", dropout_rate=0.1,
                      generator=torch.Generator().manual_seed(0), **SMALL_LM)
    state = TrainState.create(model, make_optimizer(OptimizerConfig(name="adamw")),
                              LossScaleState.create(PrecisionConfig()))
    toks = np.zeros((2, 17), np.int32)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in lm_step.make_lm_batch(toks).items()}
    with pytest.raises(NotImplementedError, match="dropout.*ROADMAP"):
        make_multi_step(lm_step.make_lm_train_step(), state, batch, 2)()
    assert not state.capturable
    lm_step.make_lm_train_step()(state, batch)  # one eager step a call still runs
    assert state.step == 1


# Five nodes and an edge of ``cudaGraphDebugDotPrint``'s verbose dump of
# the bench's GPT-2-small hybrid_adam graph (torch 2.11, CUDA 12.8).
DOT_EXCERPT = r"""digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_23"[style="solid" style="solid" shape="record" label="{MEMSET
| {{ID | node handle | dptr | pitch | value | elementSize | width | height} | {23 (topoId: 34401) | 0x0000000020562A28 | 0x00007FA423C80000 | 0 | 0 | 1 | 4 | 1}}}"];
"graph_1_node_28"[style="bold" shape="record" label="{KERNEL
| {ID | 28 (topoId: 34396) | _ZN11flash_wgmma10fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_Pfiiiif\<\<\<3072,128,41984\>\>\>}
| {{node handle | func handle} | {0x0000000020564F30 | 0x00000000186EC6B0}}
| {accessPolicyWindow | {base_ptr | num_bytes | hitRatio | hitProp | missProp} | {0x0000000000000000 | 0 | 0.000000 | N | N}}
| {cooperative | 0}
| {priority | 0}
}"];
"graph_1_node_725"[style="solid" shape="record" label="{
MEMCPY
| {{ID | node handle} | {725 (topoId: 33699) | 0x00000000207B8388}}
| {kind | DtoD (DEVICE to DEVICE)}
}"];
"graph_1_node_830"[style="bold" shape="record" label="{KERNEL
| {ID | 830 (topoId: 33594) | _ZN11flash_wgmma10bwd_kernelI13__nv_bfloat16Li64ELb1EEEvPKT_S4_S4_S4_PKfS6_PfPS2_S8_iiiif\<\<\<3072,128,59392\>\>\>}
| {cooperative | 0}
}"];
"graph_1_node_2286"[style="bold" shape="record" label="{KERNEL
| {ID | 2286 (topoId: 32138) | _ZN46_GLOBAL__N__f72d0ee4_13_fused_adam_cu_cbf574d817fused_adam_kernelENS_11TensorTableENS_7ScalarsEPKf\<\<\<10046,256,0\>\>\>}
| {priority | 0}
}"];
"graph_1_node_28" -> "graph_1_node_725" [headlabel=0];
}
}
"""


def test_dot_kernel_names_reads_the_kernel_nodes():
    assert dot_kernel_names(DOT_EXCERPT) == [
        "_ZN11flash_wgmma10fwd_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_Pfiiiif",
        "_ZN11flash_wgmma10bwd_kernelI13__nv_bfloat16Li64ELb1EEEvPKT_S4_S4_S4_PKfS6_PfPS2_"
        "S8_iiiif",
        "_ZN46_GLOBAL__N__f72d0ee4_13_fused_adam_cu_cbf574d817fused_adam_kernelENS_"
        "11TensorTableENS_7ScalarsEPKf"]
    assert dot_kernel_names("digraph dot {\n}\n") == []


def test_the_cpu_call_has_no_graph_to_dump(tmp_path):
    state, step, batch = _lm_case("adamw")
    multi = make_multi_step(step, state, batch, 2, keep_graph=True)
    assert multi.graph is None
    with pytest.raises(ValueError, match="no CUDA graph"):
        graph_kernels(multi, str(tmp_path / "graph.dot"))
    multi()
    assert state.step == state.opt_state.count == int(state.opt_state.count_t) == 2
