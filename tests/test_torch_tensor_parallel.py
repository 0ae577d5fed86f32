"""The port's tensor parallelism on two ranks against the JAX package's
megatron TP step on a two-device ``model`` mesh.

- **Rule table**: the port's ``tp_spec_for_path`` against the JAX one for
  every leaf of the GPT, with and without the overlap placement (pure).
- **TP step**: two ``spawn``ed ranks (``tests/torch_dist_worker.py``,
  gloo on the CPU) on a ``(data 1, model 2)`` mesh hold the micro GPT
  (``tests/torch_lm_mesh.py``) cut by the rule table (heads, MLP columns
  and rows, vocabulary) and run two steps: at ZeRO 0 and 1 with the
  plain vocab-parallel CE, at stage 0 with the chunked CE (chunks of 32)
  and with the saved-probabilities CE, at stage 1 with a global-norm clip
  of 0.05 that binds (the norm sums each model-sharded leaf over the
  ranks and counts each replicated leaf once), and lamb at stage 1 (the
  trust ratio's whole-tensor norms). This process runs the JAX
  ``make_tp_lm_train_step`` on the same mesh over two virtual devices.
- **Checkpoints**: the stage-1 run saves at tp 2 and this process
  restores it at world 1, bit for bit; the ranks restore a world-1 save
  at tp 2, bit for bit.
- **Refusals**: each ``ValueError`` of the JAX trainer's checks, word for
  word against the JAX ``LMTrainer`` on the 8-device CPU mesh.
- **Entry points**: the ranks run the GPT CLI with ``--tp 2 --tp-overlap``
  (its perplexity against the world-1 CLI's, rtol 1e-5) and the port
  bench's LM leg with ``--tp 2 --tp-overlap`` (its GPT cut to one layer of
  width 32).

Tolerances as ``tests/torch_lm_mesh.py`` says (metrics rtol 1e-5,
parameters atol 1e-5, moments 1e-4 of the largest magnitude).

Runtime: ~45 s serial (the JAX compiles overlap the ranks).
"""

import numpy as np
import pytest
import torch
import torch_dist_worker as worker
import torch_lm_mesh as lmm

import distributed_training_tpu.config as jcfg
from distributed_training_tpu.ops import flash_attention as jfa
from distributed_training_tpu.parallel.tensor_parallel import tp_spec_for_path as jspec
from distributed_training_tpu.train import lm_step as jstep
from distributed_training_tpu.train.lm_trainer import LMTrainer as JLMTrainer
from distributed_training_tpu_torch import checkpoint as ckpt_lib
from distributed_training_tpu_torch import config as tcfg
from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.parallel.tensor_parallel import (
    param_path,
    tp_spec_for_path,
)
from distributed_training_tpu_torch.parallel.zero import Zero
from distributed_training_tpu_torch.train.lm_step import make_lm_train_step
from distributed_training_tpu_torch.train.lm_trainer import check_lm_config
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState
from distributed_training_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)

WORLD = 2
MESH = {"data": 1, "model": 2}
LAMB = dict(name="lamb", lr=1e-3, eps=1e-4, weight_decay=1e-3, grad_clip_norm=5.0)
# name: (zero stage, optimizer, step options of both packages)
SCENARIOS = {
    "s0": (0, lmm.opt(), {}),
    "s1": (1, lmm.opt(), {}),
    "s0_chunk": (0, lmm.opt(), {"ce_chunk": 32}),
    "s0_probs": (0, lmm.opt(), {"ce_save_probs": True}),
    "s1_clip": (1, lmm.opt(grad_clip_norm=0.05), {}),
    "lamb_s1": (1, LAMB, {}),
}


def _world1_state(weights, stage=1):
    model = get_model("transformer_lm", **lmm.LM_KW)
    model.load_state_dict(weights)
    return TrainState.create(model, make_optimizer(OptimizerConfig(**lmm.opt())),
                             LossScaleState.create(PrecisionConfig()), Zero(stage))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lm_tp")
    jm = lmm.jax_lm()
    weights = lmm.port_weights(lmm.jax_state(jm, lmm.opt()))
    data = lmm.batches()
    # A world-1 save after one step, for the ranks to restore at tp 2.
    w1 = _world1_state(weights)
    make_lm_train_step(zero_stage=1)(w1, {k: torch.from_numpy(np.ascontiguousarray(v))
                                          for k, v in data[0].items()})
    ckpt_lib.save_checkpoint(str(out / "w1"), 0, w1)
    scenarios = {name: {"mesh": MESH, "stage": st, "opt": o, "step": kw}
                 for name, (st, o, kw) in SCENARIOS.items()}
    scenarios["s1"]["save"] = True
    scenarios["restore_w1"] = {"mesh": MESH, "stage": 1, "opt": lmm.opt(),
                               "restore": str(out / "w1")}
    torch.save({"model": weights, "batches": data, "lm_kw": lmm.LM_KW,
                "mesh_scenarios": scenarios, "dir": str(out),
                "cli_argv": [lmm.cli_argv(out / "cli2", "--tp", "2", "--tp-overlap")],
                "bench_argv": [["--device", "cpu", "--lm", "--lm-batch", "2",
                                "--seq-len", "8", "--warmup", "0", "--steps", "1",
                                "--sync-interval", "1", "--tp", "2", "--tp-overlap"]],
                "bench_model": {"num_layers": 1, "num_heads": 2, "hidden_dim": 32}},
               out / "job.pt")
    join = worker.spawn(out, WORLD, ("_lm_mesh_steps", "_cli_and_bench"))
    ref = {}
    try:
        mesh = lmm.jax_mesh(data=1, model=WORLD)
        for name, (st, o, kw) in SCENARIOS.items():
            step = jstep.make_tp_lm_train_step(mesh, model=jm, zero_stage=st,
                                               donate=False, **kw)
            ref[name] = lmm.run_jax(step, lmm.jax_state(jm, o), data)
        ref["cli"] = lmm.port_cli().main(lmm.cli_argv(out / "cli1"))
    finally:
        ranks = join()
    return {"ranks": ranks, "ref": ref, "dir": out, "w1": w1.state_dict()}


def test_rule_table_matches_jax_for_every_gpt_leaf():
    names = [n for n, _ in get_model("transformer_lm", head_bias=True,
                                     **lmm.LM_KW).named_parameters()]
    assert any("lm_head.bias" in n for n in names)
    for overlap in (False, True):
        for n in names:
            want = tuple(jspec(param_path(n), overlap=overlap))
            assert tp_spec_for_path(param_path(n), overlap) == want, (n, overlap)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_tp_step_matches_jax_model_mesh(runs, name):
    for rank in runs["ranks"]:
        lmm.assert_matches_jax(rank["mesh"][name], runs["ref"][name])
    assert lmm.ranks_agree(runs["ranks"], name)


def test_the_clip_binds(runs):
    """The 0.05 clip changed the update (so the TP norm is what it held)."""
    clipped, plain = runs["ref"]["s1_clip"]["params"], runs["ref"]["s1"]["params"]
    assert not np.allclose(clipped["block0"]["mlp"]["fc1"]["kernel"],
                           plain["block0"]["mlp"]["fc1"]["kernel"], atol=1e-6)


def test_each_rank_holds_half_the_sharded_weights(runs):
    whole = sum(t.numel() for t in runs["w1"]["model"].values())
    local = runs["ranks"][0]["mesh"]["s0"]["local_numel"]
    ln_and_pos = sum(t.numel() for n, t in runs["w1"]["model"].items()
                     if tp_spec_for_path(param_path(n)) == ())
    assert local == (whole - ln_and_pos) // WORLD + ln_and_pos


def test_save_at_tp2_restores_at_world1(runs):
    saved = runs["ranks"][0]["mesh"]["s1"]["state"]
    state = _world1_state(runs["w1"]["model"])
    ckpt_lib.restore_checkpoint(str(runs["dir"] / "s1"), 0, state)
    got = state.state_dict()
    assert got["step"] == saved["step"] == lmm.STEPS
    for key in ("mu", "nu"):
        for n, t in saved["opt_state"][key].items():
            assert torch.equal(got["opt_state"][key][n], t)
    assert all(torch.equal(got["model"][n], t) for n, t in saved["model"].items())


def test_world1_save_restores_at_tp2(runs):
    want = runs["w1"]
    for rank in runs["ranks"]:
        got = rank["mesh"]["restore_w1"]["restored"]
        assert got["step"] == want["step"] == 1
        assert all(torch.equal(got["model"][n], t) for n, t in want["model"].items())
        for key in ("mu", "nu"):
            assert all(torch.equal(got["opt_state"][key][n], t)
                       for n, t in want["opt_state"][key].items())


# (mesh, lm overrides, tp_overlap) of each of the JAX trainer's checks.
REFUSALS = {
    "seq_len_by_sequence": (dict(sequence=2), dict(seq_len=127), False),
    "ce_chunk_below_1": (dict(), dict(ce_chunk_size=0), False),
    "ce_chunk_by_shard": (dict(sequence=2), dict(ce_chunk_size=48), False),
    "ce_chunk_by_overlap_shard": (dict(model=2), dict(ce_chunk_size=48), True),
    "num_heads": (dict(model=2), dict(num_heads=3, hidden_dim=96), False),
    "mlp_dim": (dict(model=8), dict(num_heads=8, hidden_dim=36, mlp_ratio=1), False),
    "vocab": (dict(model=2), dict(vocab_size=63), False),
    "overlap_shard_length": (dict(model=2, sequence=2), dict(seq_len=130), True),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_trainer_checks_refuse_as_jax_does(name, tmp_path):
    mesh, lm, overlap = REFUSALS[name]
    base = dict(seq_len=128, vocab_size=64, num_layers=1, num_heads=4, hidden_dim=64,
                max_len=256)
    jc = jcfg.TrainConfig(model="transformer_lm", tp_overlap=overlap,
                          mesh=jcfg.MeshSpec(data=-1, **mesh),
                          lm=jcfg.LMConfig(**{**base, **lm}),
                          checkpoint=jcfg.CheckpointConfig(directory=str(tmp_path)))
    with pytest.raises(ValueError) as jerr:
        JLMTrainer(jc)
    tc = tcfg.TrainConfig(model="transformer_lm", tp_overlap=overlap,
                          lm=tcfg.LMConfig(**{**base, **lm}))
    with pytest.raises(ValueError) as terr:
        check_lm_config(tc, mesh.get("sequence", 1), mesh.get("model", 1))
    assert str(terr.value) == str(jerr.value)


def test_flash_block_rule_at_the_shard_length():
    """ROADMAP C (e): a flash run whose per-shard length the kernels'
    blocks do not fit is refused when the trainer is built, with the JAX
    wrapper's own message."""
    with pytest.raises(ValueError) as jerr:
        jfa._block(1500, 1024)
    tc = tcfg.TrainConfig(model="transformer_lm",
                          lm=tcfg.LMConfig(seq_len=3000, max_len=4096, attn_impl="flash"))
    with pytest.raises(ValueError) as terr:
        check_lm_config(tc, 2, 1)
    assert str(terr.value) == str(jerr.value)
    check_lm_config(tc.replace(lm=tcfg.LMConfig(seq_len=3072, max_len=4096,
                                                attn_impl="flash")), 2, 1)


def test_gpt_cli_and_bench_run_tp2_overlap(runs):
    got, want = runs["ranks"][0]["cli"][0], runs["ref"]["cli"]
    assert got["steps"] == want["steps"] == 2
    np.testing.assert_allclose(got["final_perplexity"], want["final_perplexity"],
                               rtol=1e-5)
    for rank in runs["ranks"]:
        (line, loss), = rank["bench"]
        assert ", tp:2, tp-overlap, cpu)" in line["metric"]
        assert line["value"] > 0 and np.isfinite(loss)
