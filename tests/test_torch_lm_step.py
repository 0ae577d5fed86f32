"""The port's LM step against the JAX package's: the fused cross-entropy
rows and tie-inclusive accuracy, and the parameters, Adam moments and
metrics after two ``hybrid_adam`` steps against ``make_tp_lm_train_step``
on a one-device CPU mesh (its flash kernels in interpret mode).

Tolerances. CE rows: float32 logits rtol 1e-6; bfloat16 and float16
logits (both sides read the same stored values and sum exponentials in
float32) rtol 1e-5; their gradients within 1e-6 (float32) and one ulp of
the logits' dtype (bfloat16 2**-8, float16 2**-11) of the largest
magnitude. Train step, float32 on the CPU with
sums in other orders: metrics rtol 1e-5; parameters atol 1e-5 (1% of lr
1e-3); Adam moments within 1e-4 of each tensor's largest magnitude.
Adam's eps is 1e-4 so that a near-zero gradient does not turn rounding
noise into an lr-sized step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.ops.fused_adam import FusedAdamState
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train import lm_step as jstep_mod
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train import lm_step
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState
from distributed_training_tpu_torch.train.train_state import TrainState

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

OPT = dict(name="hybrid_adam", lr=1e-3, eps=1e-4, weight_decay=1e-4,
           grad_clip_norm=1.0)
KW = dict(num_classes=64, num_layers=2, num_heads=2, hidden_dim=32, max_len=64)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}
# One ulp of the logits' dtype: the CE gradient's limit, of its largest
# magnitude (float32: the float32 sums in another order).
GRAD_TOL = {"fp32": 1e-6, "bf16": 2.0 ** -8, "fp16": 2.0 ** -11}


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
def test_ce_rows_accuracy_and_gradient_match_jax(dtype):
    jd, td = DTYPES[dtype]
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(4, 16, 50)).astype(np.float32)
    targets = rng.randint(0, 50, (4, 16)).astype(np.int32)
    jl = jnp.asarray(logits, jd)
    (jrows, jcorrect) = jstep_mod._fused_ce_rows(jl, jnp.asarray(targets), with_correct=True)
    jgrad = jax.grad(lambda x: jstep_mod._fused_ce_rows(x, jnp.asarray(targets)).sum())(jl)
    tl = torch.from_numpy(logits).to(td).requires_grad_()
    rows, correct = lm_step._fused_ce_rows(tl, torch.from_numpy(targets), with_correct=True)
    rows.sum().backward()
    assert rows.dtype == torch.float32 and tl.grad.dtype == td
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(jrows),
                               rtol=1e-6 if dtype == "fp32" else 1e-5)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jcorrect))
    jg = np.asarray(jgrad.astype(jnp.float32))
    np.testing.assert_allclose(tl.grad.float().numpy(), jg,
                               atol=GRAD_TOL[dtype] * np.abs(jg).max())
    np.testing.assert_allclose(
        float(lm_step._fused_softmax_ce(tl.detach(), torch.from_numpy(targets))),
        float(jstep_mod._fused_softmax_ce(jl, jnp.asarray(targets))), rtol=1e-6)


def test_accuracy_is_tie_inclusive_like_jax():
    """A label whose logit ties another index's maximum counts as
    correct (``argmax`` would pick the first index and say no)."""
    logits = np.zeros((1, 3, 5), np.float32)
    logits[0, :, 1] = logits[0, :, 3] = 2.0
    targets = np.array([[1, 3, 0]], np.int32)
    _, jc = jstep_mod._fused_ce_rows(jnp.asarray(logits, jnp.bfloat16),
                                     jnp.asarray(targets), with_correct=True)
    _, tc = lm_step._fused_ce_rows(torch.from_numpy(logits).bfloat16(),
                                   torch.from_numpy(targets), with_correct=True)
    np.testing.assert_array_equal(tc.numpy(), [[1.0, 1.0, 0.0]])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _batches(n, b=4, t=64):
    rng = np.random.RandomState(5)
    return [lm_step.make_lm_batch(rng.randint(0, 64, (b, t + 1)).astype(np.int32))
            for _ in range(n)]


def _fused_state(opt_state):
    for s in (opt_state if isinstance(opt_state, tuple) else (opt_state,)):
        if isinstance(s, FusedAdamState):
            return s
    raise AssertionError("no FusedAdamState in the chain")


@pytest.mark.parametrize("impl", ["exact", "flash"])
@pytest.mark.parametrize("accum", [1, 2])
def test_two_hybrid_adam_steps_match_jax(impl, accum):
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    jm = jax_model("transformer_lm", attn_impl=impl, logits_dtype=jnp.float32, **KW)
    jstate = init_train_state(jm, jax.random.PRNGKey(0), (1, 8), jmake(JOpt(**OPT)),
                              loss_scale=JLoss.create(JPrec()), input_dtype=jnp.int32)
    tm = get_model("transformer_lm", attn_impl=impl, logits_dtype=torch.float32, **KW)
    bridge.load_flax_variables(tm, jax.device_get(jstate.params))
    tstate = TrainState.create(tm, make_optimizer(OptimizerConfig(**OPT)),
                               LossScaleState.create(PrecisionConfig()))
    jstep = jstep_mod.make_tp_lm_train_step(mesh, model=jm, donate=False,
                                            grad_accum_steps=accum)
    tstep = lm_step.make_lm_train_step(grad_accum_steps=accum, max_len=64)
    for batch in _batches(2):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(1))
        tmet = tstep(tstate, {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in batch.items()})
        assert set(tmet) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                       err_msg=k)
    assert tstate.step == int(jstate.step) == 2
    params, _ = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 jax.device_get(jstate.params), params)
    fs = _fused_state(jax.device_get(jstate.opt_state))
    assert tstate.opt_state.count == int(fs.count) == 2
    for mine, ref in ((tstate.opt_state.mu, fs.mu), (tstate.opt_state.nu, fs.nu)):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()),
            ref, bridge.named_to_flax_tree(tm, mine))


def test_metric_keys_without_accuracy_match_jax():
    mesh = create_mesh(MeshConfig(data=-1), devices=jax.devices()[:1])
    jm = jax_model("transformer_lm", **KW)
    jstate = init_train_state(jm, jax.random.PRNGKey(0), (1, 8), jmake(JOpt(**OPT)),
                              loss_scale=JLoss.create(JPrec()), input_dtype=jnp.int32)
    batch = _batches(1)[0]
    _, jmet = jstep_mod.make_tp_lm_train_step(mesh, model=jm, donate=False,
                                              accuracy_metric=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1))
    tm = get_model("transformer_lm", **KW)
    tstate = TrainState.create(tm, make_optimizer(OptimizerConfig(**OPT)))
    tmet = lm_step.make_lm_train_step(accuracy_metric=False)(
        tstate, {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    assert set(tmet) == set(jmet) and "accuracy" not in tmet


def test_step_refuses_what_jax_refuses():
    tm = get_model("transformer_lm", **KW)
    tstate = TrainState.create(tm, make_optimizer(OptimizerConfig(**OPT)))
    toks = torch.zeros((3, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="max_len"):
        lm_step.make_lm_train_step(max_len=32)(tstate, {"tokens": toks, "targets": toks})
    with pytest.raises(ValueError, match="divisible"):
        lm_step.make_lm_train_step(grad_accum_steps=2)(
            tstate, {"tokens": toks, "targets": toks})
    with pytest.raises(ValueError):
        lm_step.make_lm_train_step(grad_accum_steps=0)
    for name in ("fp32", "bf16"):
        assert lm_step.parse_logits_dtype(name) == DTYPES[name][1]
    with pytest.raises(ValueError, match="logits_dtype"):
        lm_step.parse_logits_dtype("bfloat16")
