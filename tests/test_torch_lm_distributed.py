"""The port's LM step and ``LMTrainer`` on two ranks against the JAX
package on a two-device mesh.

Two ``spawn``ed processes (``tests/torch_dist_worker.py::run_lm``, gloo on
the CPU) run the port's LM step on a micro GPT (2 layers, hidden 32, 2
heads, vocab 64, T 16; global batch 4, two rows a rank) from the weights
the JAX initialiser made (carried over by ``bridge.py``), for two steps
at ZeRO stages 0–3, at stage 2 with the chunked CE (chunks of 8) and at
stage 3 with remat; then ``LMTrainer.fit()`` at world 2 (ZeRO 2, three
steps, an eval, an asynchronous save). Meanwhile this process runs the
JAX ``make_tp_lm_train_step`` on ``create_mesh(MeshConfig(data=2))`` over
two virtual CPU devices (optax ``adam``: the port's ``hybrid_adam``
update, compiled in a fraction of its Pallas kernel's interpret time) and
the same ``LMTrainer`` at world 1 on the same global batches.

Tolerances, ``tests/test_torch_lm_step.py``'s for one device: metrics
rtol 1e-5; parameters atol 1e-5 (1% of lr 1e-3); Adam moments within
1e-4 of each tensor's largest magnitude. Stages 1–3, the chunked CE and
remat against the port's stage 0: 1e-5 max-abs on the parameters, as
``tests/test_torch_distributed.py`` holds the image stages (the chunked
CE sums its chunks in another order). The world-2 trainer against the
world-1 one: the same limits, its eval perplexity rtol 1e-5, with float32
logits (under the bf16 head each rank rounds its half of the head's
gradient to bfloat16 before the mean, and Adam's first step turns that
rounding into 4% of lr on the head, measured: another run, not a fault).

Runtime: ~35 s serial on the CPU (~20 s of it the fixture, the JAX
compiles and the world-1 trainer overlapping the two ranks).
"""

import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker

from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train import lm_step as jstep_mod
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import LMTrainer, bridge
from distributed_training_tpu_torch.config import (
    CheckpointConfig,
    DataConfig,
    LMConfig,
    OptimizerConfig,
    TrainConfig,
    ZeroConfig,
)
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.lm_step import make_lm_batch

torch.set_num_threads(1)

WORLD = 2
STEPS = 2
JOIN_TIMEOUT_S = 150


def _batches():
    rng = np.random.RandomState(7)
    return [make_lm_batch(rng.randint(0, 64, (4, 17)).astype(np.int32))
            for _ in range(STEPS)]


def _trainer_cfg(directory, batch_size):
    return TrainConfig(
        model="transformer_lm", num_epochs=1, log_interval=1,
        optimizer=OptimizerConfig(name="hybrid_adam", lr=3e-3, eps=1e-4),
        zero=ZeroConfig(stage=2),
        lm=LMConfig(seq_len=16, vocab_size=64, num_layers=2, num_heads=2,
                    hidden_dim=32, max_len=32, train_sequences=32, eval_sequences=8,
                    logits_dtype="fp32"),
        data=DataConfig(batch_size=batch_size, max_steps_per_epoch=3),
        checkpoint=CheckpointConfig(directory=str(directory), interval=1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_dist")
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **worker.LM_KW)
    jstate = init_train_state(jm, jax.random.PRNGKey(0), (1, 8),
                              jmake(JOpt(**{**worker.OPT, "name": "adam"})),
                              loss_scale=JLoss.create(JPrec()), input_dtype=jnp.int32)
    model = get_model("transformer_lm", **worker.LM_KW)
    bridge.load_flax_variables(model, jax.device_get(jstate.params))
    batches = _batches()
    torch.save({"model": model.state_dict(), "batches": batches,
                "trainer_cfg": _trainer_cfg(out / "ck2", 4 // WORLD)}, out / "job.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run_lm, args=(r, WORLD, str(out / "store"), str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        mesh2 = create_mesh(MeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
        step = jstep_mod.make_tp_lm_train_step(mesh2, model=jm, donate=False)
        metrics = []
        for batch in batches:
            jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
        mu, nu = next((s.mu, s.nu) for s in jax.tree_util.tree_leaves(
            jax.device_get(jstate.opt_state), is_leaf=lambda x: hasattr(x, "nu"))
            if hasattr(s, "nu"))
        ref = {"params": jax.device_get(jstate.params), "mu": mu, "nu": nu,
               "metrics": metrics, "step": int(jstate.step)}
        world1 = LMTrainer(_trainer_cfg(out / "ck1", 4), device="cpu")
        ref["trainer"] = {"result": world1.fit(), "model": world1.state.state_dict()["model"]}
    finally:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    errors = [open(out / f).read() for f in sorted(os.listdir(out)) if f.startswith("error_")]
    assert not hung and not errors, (f"{len(hung)} rank(s) hung; " + "\n".join(errors))
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = [torch.load(out / f"results_{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "ref": ref, "dir": out}


def _max_abs(a: dict, b: dict) -> float:
    return max((a[n] - b[n]).abs().max().item() for n in a)


def test_stage0_matches_jax_two_device_mesh(runs):
    res, ref = runs["ranks"][0]["s0"], runs["ref"]
    for got, want in zip(res["metrics"], ref["metrics"]):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert res["step"] == ref["step"] == STEPS
    tm = get_model("transformer_lm", **worker.LM_KW)
    tm.load_state_dict(res["state"]["model"])
    params, _ = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 ref["params"], params)
    for key in ("mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()),
            ref[key], bridge.named_to_flax_tree(tm, res["state"]["opt_state"][key]))


@pytest.mark.parametrize("name", ["s1", "s2", "s3", "s2_chunk", "s3_remat"])
def test_stages_chunked_ce_and_remat_match_stage0(runs, name):
    base = runs["ranks"][0]["s0"]
    for rank in runs["ranks"]:
        res = rank[name]
        assert res["step"] == STEPS
        assert _max_abs(res["state"]["model"], base["state"]["model"]) < 1e-5
        for got, want in zip(res["metrics"], base["metrics"]):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    a, b = (r[name]["state"]["model"] for r in runs["ranks"])
    assert all(torch.equal(a[n], b[n]) for n in a)  # the ranks agree


def test_lm_trainer_at_world2_matches_world1(runs):
    got = runs["ranks"][0]["trainer"]
    want = runs["ref"]["trainer"]
    assert got["world"] == WORLD
    assert got["result"]["steps"] == want["result"]["steps"] == 3
    assert not got["result"]["preempted"]
    np.testing.assert_allclose(got["result"]["final_perplexity"],
                               want["result"]["final_perplexity"], rtol=1e-5)
    np.testing.assert_allclose(got["result"]["last_metrics"]["loss"],
                               want["result"]["last_metrics"]["loss"], rtol=1e-5)
    assert _max_abs(got["model"], want["model"]) < 1e-5
    assert os.path.exists(runs["dir"] / "ck2" / "epoch_0" / "COMMITTED")
