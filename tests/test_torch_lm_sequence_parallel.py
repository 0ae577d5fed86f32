"""The port's sequence strategy on two ranks against the JAX package's
sequence-parallel step on a two-device ``sequence`` mesh.

Two ``spawn``ed ranks (``tests/torch_dist_worker.py``, gloo on the CPU)
run the LM step on a ``(data 1, sequence 2)`` mesh: each rank its time
chunk (T_local 64) of the micro GPT's batches (``tests/torch_lm_mesh.py``),
ring attention over the two ranks, two steps at ZeRO 0, 1 and 3 (ZeRO
over ``data × sequence``), one at stage 1 with the chunked CE (chunks of
16); then the sharded eval; then ``LMTrainer.fit()`` at ``sequence=2``
with flash attention (the ring's hops on the kernels' plain versions);
then the GPT CLI with ``--sp 2``. Meanwhile this process runs the JAX
``make_lm_train_step`` on the same mesh over two virtual CPU devices, and
the world-1 ``LMTrainer`` and CLI.

Tolerances (``tests/torch_lm_mesh.py``): metrics rtol 1e-5, parameters
atol 1e-5, Adam's moments 1e-4 of each tensor's largest magnitude; the
sharded eval CE against the unsharded JAX eval on the JAX step's
parameters, rtol 1e-5; the world-2 trainer against the world-1 one:
perplexity and loss rtol 1e-5, parameters 1e-5 max-abs; the CLI's
perplexity against its world-1 run, rtol 1e-5.

Runtime: ~40 s serial (the JAX compiles overlap the ranks).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
import torch_lm_mesh as lmm

from distributed_training_tpu.train import lm_step as jstep
from distributed_training_tpu_torch import LMTrainer
from distributed_training_tpu_torch.config import (
    CheckpointConfig,
    DataConfig,
    LMConfig,
    MeshSpec,
    OptimizerConfig,
    TrainConfig,
)

torch.set_num_threads(1)

WORLD = 2
MESH = {"data": 1, "sequence": 2}
STAGES = (0, 1, 3)


def _trainer_cfg(directory, sequence):
    return TrainConfig(
        model="transformer_lm", num_epochs=1, log_interval=1,
        optimizer=OptimizerConfig(name="hybrid_adam", lr=3e-3, eps=1e-4),
        mesh=MeshSpec(sequence=sequence),
        lm=LMConfig(seq_len=lmm.T, vocab_size=64, num_layers=2, num_heads=4,
                    hidden_dim=64, max_len=lmm.T, train_sequences=12,
                    eval_sequences=4, logits_dtype="fp32", attn_impl="flash"),
        data=DataConfig(batch_size=4, max_steps_per_epoch=3),
        checkpoint=CheckpointConfig(directory=str(directory), interval=1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_sp")
    jm = lmm.jax_lm("sequence")
    jstate = lmm.jax_state(jm, lmm.opt())
    data = lmm.batches()
    scenarios = {f"s{s}": {"mesh": MESH, "stage": s, "opt": lmm.opt(), "eval": True}
                 for s in STAGES}
    scenarios["s1_chunk"] = {"mesh": MESH, "stage": 1, "opt": lmm.opt(),
                             "step": {"ce_chunk": 16}, "eval": True}
    torch.save({"model": lmm.port_weights(jstate), "batches": data, "eval": data[0],
                "lm_kw": lmm.LM_KW, "mesh_scenarios": scenarios, "dir": str(out),
                "trainer_cfgs": {"sp2": _trainer_cfg(out / "ck2", WORLD)},
                "cli_argv": [lmm.cli_argv(out / "cli2", "--sp", "2")]},
               out / "job.pt")
    join = worker.spawn(out, WORLD, ("_lm_mesh_steps", "_lm_trainer_mesh",
                                     "_cli_and_bench"))
    ref = {}
    try:
        mesh = lmm.jax_mesh(data=1, sequence=WORLD)
        for s in STAGES:
            step = jstep.make_lm_train_step(mesh, model=jm, zero_stage=s, donate=False)
            ref[f"s{s}"] = lmm.run_jax(step, jstate, data)
        step = jstep.make_lm_train_step(mesh, model=jm, zero_stage=1, ce_chunk=16,
                                        donate=False)
        ref["s1_chunk"] = lmm.run_jax(step, jstate, data)
        plain = lmm.jax_lm()
        ref["eval"] = float(jstep._fused_softmax_ce(
            plain.apply({"params": ref["s0"]["params"]}, jnp.asarray(data[0]["tokens"])),
            jnp.asarray(data[0]["targets"])))
        world1 = LMTrainer(_trainer_cfg(out / "ck1", 1), device="cpu")
        ref["trainer"] = {"result": world1.fit(),
                          "model": world1.state.state_dict()["model"]}
        ref["cli"] = lmm.port_cli().main(lmm.cli_argv(out / "cli1"))
    finally:
        ranks = join()
    return {"ranks": ranks, "ref": ref, "dir": out}


@pytest.mark.parametrize("name", ["s0", "s1", "s3", "s1_chunk"])
def test_sequence_step_matches_jax_sequence_mesh(runs, name):
    for rank in runs["ranks"]:
        lmm.assert_matches_jax(rank["mesh"][name], runs["ref"][name])
    assert lmm.ranks_agree(runs["ranks"], name)


def test_zero3_partitions_over_data_times_sequence(runs):
    """At stage 3 each rank keeps only its shard between steps (its model
    tensors are empty), and the ZeRO group is the two sequence ranks."""
    assert all(r["mesh"]["s3"]["local_numel"] == 0 for r in runs["ranks"])
    assert all(r["mesh"]["s0"]["local_numel"] > 0 for r in runs["ranks"])


@pytest.mark.parametrize("name", ["s0", "s1_chunk"])
def test_sharded_eval_matches_the_unsharded_oracle(runs, name):
    """The eval through the ring (each rank its time chunk, the CE averaged
    over the sequence ranks) against the unsharded JAX eval on the JAX
    step's parameters."""
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["mesh"][name]["eval"], runs["ref"]["eval"],
                                   rtol=1e-5)


def test_lm_trainer_at_sequence2_matches_world1(runs):
    got = runs["ranks"][0]["trainer"]["sp2"]
    want = runs["ref"]["trainer"]
    assert got["strategy"] == "sequence" and got["world"] == 1  # one data shard
    assert got["result"]["steps"] == want["result"]["steps"] == 3
    np.testing.assert_allclose(got["result"]["final_perplexity"],
                               want["result"]["final_perplexity"], rtol=1e-5)
    np.testing.assert_allclose(got["result"]["last_metrics"]["loss"],
                               want["result"]["last_metrics"]["loss"], rtol=1e-5)
    assert max((got["model"][n] - want["model"][n]).abs().max().item()
               for n in want["model"]) < 1e-5
    assert os.path.exists(runs["dir"] / "ck2" / "epoch_0" / "COMMITTED")


def test_gpt_cli_runs_sp2(runs):
    got, want = runs["ranks"][0]["cli"][0], runs["ref"]["cli"]
    assert got["steps"] == want["steps"] == 2
    np.testing.assert_allclose(got["final_perplexity"], want["final_perplexity"],
                               rtol=1e-5)
