"""Shared pieces of the port's sequence- and tensor-parallel LM tests
(``tests/test_torch_lm_sequence_parallel.py``,
``tests/test_torch_tensor_parallel.py``, ``tests/test_torch_tp_overlap.py``):
the micro GPT, its JAX-initialised weights carried into the port, the
batches, the JAX step on a mesh of virtual CPU devices, and the
comparisons.

The model is 2 layers, 4 heads, width 64, vocabulary 64, T 128, no
dropout, float32. The optimizer is the port's ``hybrid_adam`` against
optax ``adam`` in JAX (the same update; Adam's eps 1e-4 so that a
near-zero gradient does not turn rounding into an lr-sized step).
Tolerances are ``tests/test_torch_lm_distributed.py``'s: metrics rtol
1e-5, parameters atol 1e-5 (1% of lr 1e-3), Adam's moments within 1e-4
of each tensor's largest magnitude.
"""

from __future__ import annotations

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch_dist_worker as worker

from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.parallel.sharding import place_state
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.lm_step import make_lm_batch

LM_KW = dict(num_classes=64, num_layers=2, num_heads=4, hidden_dim=64, max_len=128)
T = 128
STEPS = 2


def cli_argv(directory, *extra) -> list[str]:
    """The port GPT CLI at a micro size (T 32, two steps, an eval, a save),
    flash attention and float32 logits; ``extra`` adds the strategy."""
    return ["--device", "cpu", "--num-layers", "2", "--num-heads", "4",
            "--hidden-dim", "64", "--vocab-size", "64", "--seq-len", "32",
            "--max-len", "64", "-b", "4", "-e", "1", "--steps-per-epoch", "2",
            "-i", "1", "--log-interval", "1", "--logits-dtype", "fp32",
            "--attn-impl", "flash", "-c", str(directory), *extra]


def port_cli():
    """``gpt/torch_cuda/train.py`` as a module."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "port_gpt_cli", os.path.join(root, "gpt", "torch_cuda", "train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def opt(**kw) -> dict:
    return {**worker.OPT, **kw}


def batches(n: int = STEPS, rows: int = 4, seed: int = 7) -> list[dict]:
    rng = np.random.RandomState(seed)
    return [make_lm_batch(rng.randint(0, 64, (rows, T + 1)).astype(np.int32))
            for _ in range(n)]


def jax_lm(seq_axis=None, **kw):
    return jax_model("transformer_lm", logits_dtype=jnp.float32, seq_axis=seq_axis,
                     **{**LM_KW, **kw})


def jax_state(jm, optimizer: dict):
    """The JAX initial state; the port's ``hybrid_adam`` runs as optax
    ``adam`` (the same update, compiled in a fraction of the Pallas
    kernel's interpret time)."""
    name = "adam" if optimizer["name"] == "hybrid_adam" else optimizer["name"]
    return init_train_state(jm, jax.random.PRNGKey(0), (1, 8),
                            jmake(JOpt(**{**optimizer, "name": name})),
                            loss_scale=JLoss.create(JPrec()), input_dtype=jnp.int32)


def port_weights(jstate) -> dict:
    """The JAX initial parameters as the port's whole state dict."""
    model = get_model("transformer_lm", **LM_KW)
    bridge.load_flax_variables(model, jax.device_get(jstate.params))
    return model.state_dict()


def jax_mesh(**sizes):
    n = int(np.prod(list(sizes.values())))
    return create_mesh(MeshConfig(**sizes), devices=jax.devices()[:n])


def run_jax(step, jstate, data: list[dict]) -> dict:
    """The JAX step over ``data``: final params, Adam's moments, metrics."""
    jstate = place_state(jstate, step.state_shardings(jstate))
    metrics = []
    for b in data:
        batch = jax.device_put({k: jnp.asarray(v) for k, v in b.items()},
                               step.batch_shardings)
        jstate, m = step(jstate, batch, jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    mu, nu = next((s.mu, s.nu) for s in jax.tree_util.tree_leaves(
        jax.device_get(jstate.opt_state), is_leaf=lambda x: hasattr(x, "nu"))
        if hasattr(s, "nu"))
    return {"params": jax.device_get(jstate.params), "mu": mu, "nu": nu,
            "metrics": metrics, "step": int(jstate.step)}


def assert_matches_jax(res: dict, ref: dict) -> None:
    """A port run (``state_dict`` and metrics, whole tensors) against the
    JAX run, at the module docstring's tolerances."""
    for got, want in zip(res["metrics"], ref["metrics"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert res["step"] == ref["step"] == len(ref["metrics"])
    tm = get_model("transformer_lm", **LM_KW)
    tm.load_state_dict(res["state"]["model"])
    params, _ = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 ref["params"], params)
    for key in ("mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()),
            ref[key], bridge.named_to_flax_tree(tm, res["state"]["opt_state"][key]))


def ranks_agree(ranks: list, name: str) -> bool:
    """Every rank holds the same whole state after the run."""
    first = ranks[0]["mesh"][name]["state"]["model"]
    return all(torch.equal(first[n], r["mesh"][name]["state"]["model"][n])
               for r in ranks[1:] for n in first)
