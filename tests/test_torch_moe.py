"""The port's MoE layers (``models/moe.py``) against the JAX package's
(``distributed_training_tpu/models/moe.py``), one process, float32, the
same numpy inputs and the JAX-initialised weights carried by ``bridge.py``.

- ``TopKGate`` at top-1 and top-2, at a capacity that drops tokens and
  with ``min_capacity``: every token's (expert, slot) equals the JAX
  dispatch mask's exactly, the combine weights within 1e-6, the aux loss
  rtol 1e-6.
- ``MoEMlp`` ``standard`` and ``residual``: the output within 1e-5 (atol),
  the aux loss rtol 1e-6, and every gradient (the input's and each
  parameter's, of ``Σ out · g + aux``) within 1e-4 of its largest
  magnitude.
- ``MoEImageClassifier`` (2 layers, 4 experts): logits and aux in eval
  and train mode, atol 1e-5.
- GPT with MoE (2 layers, d 64): logits and aux atol 1e-5, and one
  ``hybrid_adam`` step against ``make_tp_lm_train_step`` on a one-device
  mesh at ``tests/test_torch_lm_step.py``'s tolerances.
- The expert init's standard deviation against ``1/√(d·E)``; the noisy
  gates draw from the step's generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.models import moe as jmoe
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train import lm_step as jstep_mod
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.models import moe
from distributed_training_tpu_torch.train import lm_step
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState
from distributed_training_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)

T, D, E, H = 64, 16, 4, 32
# (top_k, capacity_factor, min_capacity): top-1 and top-2 at capacities
# that drop tokens (C 8 and 16 of 64 tokens over 4 experts), and
# min_capacity lifting C to 12 above the factor's 8.
GATES = {"top1_drops": (1, 0.5, 0), "top2_drops": (2, 0.5, 0),
         "top1_min_capacity": (1, 0.5, 12), "top2_default": (2, 1.25, 0)}


def _tokens(seed=0, n=T, d=D):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _port_routing_dense(r: moe.Routing, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The port's routing as JAX's dense ``[T, E, C]`` dispatch and combine."""
    dispatch = np.zeros((n, E, r.capacity), bool)
    combine = np.zeros((n, E, r.capacity), np.float32)
    for i in range(r.experts.shape[0]):
        for t in range(n):
            if r.keep[i, t]:
                e, c = int(r.experts[i, t]), int(r.slots[i, t])
                dispatch[t, e, c] = True
                combine[t, e, c] = float(r.weights[i, t])
    return dispatch, combine


@pytest.mark.parametrize("case", list(GATES))
def test_gate_routing_matches_jax(case):
    k, cf, mc = GATES[case]
    x = _tokens()
    jg = jmoe.TopKGate(num_experts=E, top_k=k, capacity_factor=cf, min_capacity=mc)
    params = jg.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)["params"]
    jcombine, jdispatch, jaux = jg.apply({"params": params}, jnp.asarray(x), train=True)
    gate = moe.TopKGate(D, E, top_k=k, capacity_factor=cf, min_capacity=mc)
    bridge.load_flax_variables(gate, jax.device_get(params))
    with torch.no_grad():
        r = gate(torch.from_numpy(x))
    dispatch, combine = _port_routing_dense(r, T)
    assert r.capacity == jdispatch.shape[-1]
    if case.endswith("drops"):
        assert int(np.asarray(jdispatch).sum()) < T * k  # the capacity drops tokens
    np.testing.assert_array_equal(dispatch, np.asarray(jdispatch))
    np.testing.assert_allclose(combine, np.asarray(jcombine), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(r.aux), float(jaux), rtol=1e-6)


def _jax_moe_mlp(mlp_type, k=2, cf=0.5):
    return jmoe.MoEMlp(num_experts=E, hidden_dim=H, top_k=k, capacity_factor=cf,
                       mlp_type=mlp_type)


@pytest.mark.parametrize("mlp_type", ["standard", "residual"])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_forward_and_gradients_match_jax(mlp_type, k):
    x = _tokens(1).reshape(4, T // 4, D)
    g = np.random.RandomState(2).randn(*x.shape).astype(np.float32)
    jm = _jax_moe_mlp(mlp_type, k)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False)["params"]

    def jloss(p, xx):
        out, mut = jm.apply({"params": p}, xx, train=True, mutable=["aux_loss"])
        aux = sum(jax.tree.leaves(dict(mut)["aux_loss"]))
        return (out * jnp.asarray(g)).sum() + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    tm = moe.MoEMlp(D, E, H, top_k=k, capacity_factor=0.5, mlp_type=mlp_type)
    bridge.load_flax_variables(tm, jax.device_get(params))
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tm(tx, True)
    ((out * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    jgx = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), jgx, atol=1e-4 * np.abs(jgx).max())
    grads = bridge.named_to_flax_tree(tm, {n: p.grad for n, p in tm.named_parameters()})
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()),
        jax.device_get(jgp), grads)


@pytest.mark.parametrize("train", [False, True])
def test_moe_image_classifier_matches_jax(train):
    images = np.random.RandomState(3).rand(4, 16, 16, 3).astype(np.float32)
    kw = dict(num_classes=10, hidden_size=32, num_layers=2, num_experts=(4,),
              mlp_hidden=64, top_k=2, capacity_factor=0.5)
    jm = jax_model("moe_mlp", **kw)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16, 3)),
                     train=False)["params"]
    jlogits, mut = jm.apply({"params": params}, jnp.asarray(images), train=train,
                            mutable=["aux_loss"])
    jaux = sum(jax.tree.leaves(dict(mut).get("aux_loss", {})), 0.0)
    tm = get_model("moe_mlp", **{k: v for k, v in kw.items()})
    bridge.load_flax_variables(tm, jax.device_get(params))
    tm.train(train)
    with torch.no_grad():
        logits, aux = tm(torch.from_numpy(images), return_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_moe_image_classifier_dense_layers_keep_flax_names():
    """A layer of one expert is a dense MLP, as in JAX (``n_exp > 1``), and
    the port's tree carries the Flax auto-names both ways."""
    kw = dict(num_classes=10, hidden_size=16, num_layers=3, num_experts=(4, 1, 4),
              mlp_hidden=32)
    jm = jax_model("moe_mlp", **kw)
    params = jax.device_get(jm.init({"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, 8, 8, 3)), train=False)["params"])
    tm = get_model("moe_mlp", **kw)
    bridge.load_flax_variables(tm, params)
    back, _ = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(b, a), params, back)
    assert {"Dense_0", "Dense_1", "moe_0", "moe_2", "LayerNorm_3"} <= set(back)


LM_KW = dict(num_classes=64, num_layers=2, num_heads=2, hidden_dim=64, max_len=64)
MOE_KW = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=0.5)


def test_gpt_with_moe_logits_and_aux_match_jax():
    tokens = np.random.RandomState(4).randint(0, 64, (2, 32)).astype(np.int32)
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM_KW, **MOE_KW)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
                     train=False)["params"]
    assert "moe_mlp" in params["block1"] and "mlp" in params["block0"]
    jlogits, mut = jm.apply({"params": params}, jnp.asarray(tokens), train=True,
                            mutable=["aux_loss"])
    jaux = sum(jax.tree.leaves(dict(mut)["aux_loss"]))
    tm = get_model("transformer_lm", **LM_KW, **MOE_KW)
    bridge.load_flax_variables(tm, jax.device_get(params))
    tm.train()
    with torch.no_grad():
        logits, aux = tm(torch.from_numpy(tokens), return_aux=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(aux) > 0


def test_gpt_with_moe_hybrid_adam_step_matches_jax():
    opt = dict(name="hybrid_adam", lr=1e-3, eps=1e-4, weight_decay=1e-4, grad_clip_norm=1.0)
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM_KW, **MOE_KW)
    jstate = init_train_state(jm, jax.random.PRNGKey(0), (1, 8), jmake(JOpt(**opt)),
                              loss_scale=JLoss.create(JPrec()), input_dtype=jnp.int32)
    tm = get_model("transformer_lm", **LM_KW, **MOE_KW)
    bridge.load_flax_variables(tm, jax.device_get(jstate.params))
    tstate = TrainState.create(tm, make_optimizer(OptimizerConfig(**opt)),
                               LossScaleState.create(PrecisionConfig()))
    batch = lm_step.make_lm_batch(
        np.random.RandomState(5).randint(0, 64, (4, 33)).astype(np.int32))
    jstep = jstep_mod.make_tp_lm_train_step(mesh, model=jm, donate=False)
    jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(1))
    tmet = lm_step.make_lm_train_step(max_len=64)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(tmet["aux_loss"]) > 0
    for key in ("loss", "aux_loss", "perplexity", "accuracy"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]), rtol=1e-5, err_msg=key)
    params, _ = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 jax.device_get(jstate.params), params)


def test_expert_init_std_counts_experts_into_the_fan_in():
    """Flax ``lecun_normal`` on ``[E, d, h]`` has fan-in ``d·E``."""
    d, e, h = 64, 8, 256
    m = moe.ExpertMlp(e, d, h, generator=torch.Generator().manual_seed(0))
    for w, fan_in in ((m.w1, d * e), (m.w2, h * e)):
        np.testing.assert_allclose(float(w.detach().std()), 1.0 / np.sqrt(fan_in), rtol=0.02)
    jw = jmoe.ExpertMlp(num_experts=e, hidden_dim=h).init(
        jax.random.PRNGKey(0), jnp.zeros((e, 1, d)))["params"]["w1"]
    np.testing.assert_allclose(float(jnp.std(jw)), float(m.w1.detach().std()), rtol=0.02)


@pytest.mark.parametrize("policy", ["RSample", "Jitter"])
def test_noisy_gates_draw_from_the_generator(policy):
    """Training noise comes from the generator the forward is given: the
    same seed routes the same way, and eval adds none."""
    x = torch.from_numpy(_tokens(6))
    gate = moe.TopKGate(D, E, noisy_gate_policy=policy,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = gate(x, True, torch.Generator().manual_seed(1))
        b = gate(x, True, torch.Generator().manual_seed(1))
        clean = gate(x, False, torch.Generator().manual_seed(1))
        plain = moe.TopKGate(D, E, generator=torch.Generator().manual_seed(0))(x, True)
    assert torch.equal(a.experts, b.experts) and torch.equal(a.weights, b.weights)
    assert torch.equal(clean.weights, plain.weights)
    assert not torch.equal(a.weights, clean.weights)
