"""The port's MoE under the sequence and model axes, and gradient
accumulation in JAX's microbatch order, against the JAX package's steps on
CPU meshes of the same shape (gloo ranks, ``tests/torch_dist_worker.py``).

The model is a micro GPT with MoE (2 layers, 4 heads, width 32,
vocabulary 64, T 32; 4 experts at block 1, top-1, capacity factor 0.5, so
tokens drop), float32, two ``hybrid_adam`` steps against optax ``adam``.

- **The gate's scope.** JAX's sequence step is a shard_map manual over
  ``(data, sequence)`` (``train/lm_step.py:51-61``), and its MoE layer
  holds no collective over either axis: each shard gates its own tokens.
  Its GSPMD steps (data, model, expert) gate over the global batch. The
  cases: sequence 2, model 2 (two ranks); data 2 × sequence 2, sequence 2
  × expert 2, model 2 × expert 2 (also at ZeRO 1 with a clip that binds),
  model 2 × sequence 2 (four ranks), each against JAX's step on the
  matching mesh. At this capacity a global gate
  under the sequence axis routes other tokens and fails. The GPT CLI
  trains with ``--moe`` and ``--sp 2`` or ``--tp 2``.
- **The microbatch order** (ROADMAP C5): where JAX accumulates under
  GSPMD, microbatch *m* is a contiguous block of the global batch split
  over ``data``. ``LMTrainer`` with MoE and the image ``Trainer`` with
  ``resnet_micro`` and SyncBN, each at data 2 and two accumulation steps,
  run on their own loaders' rows against JAX's step on a 2-device mesh on
  the global batches (the MoE gate's drops and the BatchNorm statistics
  of each microbatch depend on which rows it holds). ``LMTrainer`` at data
  2 × sequence 2 keeps the shard-local microbatches of JAX's sequence
  step.

Tolerances are ``tests/torch_lm_mesh.py``'s: metrics rtol 1e-5,
parameters (and BatchNorm statistics) atol 1e-5, Adam's moments 1e-4 of
each tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
import torch_lm_mesh as lmm

from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.parallel.sharding import place_state
from distributed_training_tpu.train.lm_step import make_lm_train_step, make_tp_lm_train_step
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.step import make_train_step as jax_image_step
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import (
    DataConfig,
    LMConfig,
    MeshSpec,
    MoEConfig,
    OptimizerConfig,
    TrainConfig,
)
from distributed_training_tpu_torch.data.lm_text import TokenLoader, synthetic_tokens
from distributed_training_tpu_torch.data.pipeline import build_dataloaders
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.lm_step import make_lm_batch

torch.set_num_threads(1)

T = 32
MOE = dict(moe_num_experts=4, moe_top_k=1, moe_capacity_factor=0.5)
LM_KW = dict(num_classes=64, num_layers=2, num_heads=4, hidden_dim=32, max_len=64, **MOE)
ACCUM, PER_RANK = 2, 4
STEP_CASES = {
    2: {"seq2": {"sequence": 2}, "model2": {"data": 1, "model": 2}},
    4: {"d2s2": {"data": 2, "sequence": 2}, "s2e2": {"sequence": 2, "expert": 2},
        "m2e2": {"model": 2, "expert": 2}, "m2s2": {"model": 2, "sequence": 2},
        "m2e2_zero1": {"data": 1, "model": 2, "expert": 2}},
}
# ZeRO 1 under model × expert (the JAX trainer's moe_param_group rule: the
# expert moments partitioned within each expert rank's data group), with a
# clip that binds (0.05): the global norm sums model- and expert-sharded
# leaves over their ranks.
ZERO1 = {"m2e2_zero1"}
CLIP = lmm.opt(grad_clip_norm=0.05)


def _batches(n=lmm.STEPS, rows=4, seed=7):
    rng = np.random.RandomState(seed)
    return [make_lm_batch(rng.randint(0, 64, (rows, T + 1)).astype(np.int32))
            for _ in range(n)]


def _jax_lm(mesh_sizes=None, **kw):
    sizes = mesh_sizes or {}
    return jax_model("transformer_lm", logits_dtype=jnp.float32,
                     seq_axis="sequence" if sizes.get("sequence", 1) > 1 else None,
                     moe_expert_axis="expert" if sizes.get("expert", 1) > 1 else None,
                     **{**LM_KW, **kw})


def _jax_state(jm, shape=(1, 8), dtype=jnp.int32, tx=None):
    return init_train_state(jm, jax.random.PRNGKey(0), shape,
                            jmake(JOpt(**{**(tx or lmm.opt()), "name": "adam"})),
                            loss_scale=JLoss.create(JPrec()), input_dtype=dtype)


def _lm_cfg(mesh: dict) -> TrainConfig:
    return TrainConfig(
        model="transformer_lm", num_epochs=1, gradient_accumulation_steps=ACCUM,
        optimizer=OptimizerConfig(**lmm.opt()), mesh=MeshSpec(**mesh),
        moe=MoEConfig(enabled=True, num_experts=(4,), top_k=1, capacity_factor=0.5),
        lm=LMConfig(seq_len=T, vocab_size=64, num_layers=2, num_heads=4, hidden_dim=32,
                    max_len=64, train_sequences=64, logits_dtype="fp32"),
        data=DataConfig(batch_size=PER_RANK))


def _image_cfg() -> TrainConfig:
    return TrainConfig(
        model="resnet_micro", num_epochs=1, gradient_accumulation_steps=ACCUM,
        sync_batchnorm=True, optimizer=OptimizerConfig(**lmm.opt()),
        mesh=MeshSpec(data=2),
        data=DataConfig(dataset="synthetic_cifar", batch_size=PER_RANK, augment="none"))


def _lm_global_batches(cfg, world_data: int) -> list[dict]:
    """The global batches of the trainer's loader, at one process."""
    lm = cfg.lm
    gbs = PER_RANK * world_data * ACCUM
    loader = TokenLoader(synthetic_tokens(lm.train_sequences, lm.seq_len, lm.vocab_size,
                                          seed=cfg.seed),
                         global_batch_size=gbs, shuffle=True, seed=cfg.seed)
    return [make_lm_batch(b["tokens"]) for b, _ in zip(loader, range(lmm.STEPS))]


def _image_global_batches(cfg) -> list[dict]:
    loader, _ = build_dataloaders(cfg, seed=cfg.seed, global_batch_size=PER_RANK * 2 * ACCUM,
                                  process_index=0, process_count=1)
    loader.set_epoch(0)
    return [b for b, _ in zip(loader, range(lmm.STEPS))]


def _run_jax_image(step, jstate, data) -> dict:
    jstate = place_state(jstate, step.state_shardings(jstate)) \
        if hasattr(step, "state_shardings") else jstate
    metrics = []
    for b in data:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    adam = next(s for s in jax.tree_util.tree_leaves(
        jax.device_get(jstate.opt_state), is_leaf=lambda x: hasattr(x, "nu"))
        if hasattr(s, "nu"))
    return {"params": jax.device_get(jstate.params),
            "batch_stats": jax.device_get(jstate.batch_stats),
            "mu": adam.mu, "nu": adam.nu, "metrics": metrics, "step": int(jstate.step)}


@pytest.fixture(scope="module")
def setup():
    jm = _jax_lm()
    jstate = _jax_state(jm)
    tlm = get_model("transformer_lm", **LM_KW)
    bridge.load_flax_variables(tlm, jax.device_get(jstate.params))
    jimg = jax_model("resnet_micro", num_classes=10)
    istate = init_train_state(jimg, jax.random.PRNGKey(0), (1, 32, 32, 3),
                              jmake(JOpt(**{**lmm.opt(), "name": "adam"})),
                              loss_scale=JLoss.create(JPrec()))
    timg = get_model("resnet_micro")
    bridge.load_flax_variables(timg, jax.device_get(istate.params),
                               jax.device_get(istate.batch_stats))
    return {"jstate": jstate, "lm": tlm.state_dict(), "istate": istate, "jimg": jimg,
            "img": timg.state_dict()}


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Both spawns, started together, then the JAX references here."""
    joins = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"moe_axes{world}")
        scenarios = {name: dict(kind="lm", mesh=mesh, stage=int(name in ZERO1),
                                opt=CLIP if name in ZERO1 else lmm.opt())
                     for name, mesh in STEP_CASES[world].items()}
        trainers = {}
        if world == 2:
            trainers["lm_f1"] = {"cfg": _lm_cfg({"data": 2}), "weights": setup["lm"],
                                 "steps": lmm.STEPS}
            trainers["img_f1"] = {"cfg": _image_cfg(), "weights": setup["img"],
                                  "steps": lmm.STEPS}
        else:
            trainers["lm_d2s2_accum"] = {"cfg": _lm_cfg({"data": 2, "sequence": 2}),
                                         "weights": setup["lm"], "steps": lmm.STEPS}
        cli = ([lmm.cli_argv(d / f"cli_{flag[2:]}", "--moe", "--num-experts", "4", flag, "2")
                for flag in ("--sp", "--tp")] if world == 2 else [])
        torch.save({"lm_kw": LM_KW, "lm_model": setup["lm"], "lm_batches": _batches(),
                    "moe_scenarios": scenarios, "trainer_steps": trainers,
                    "cli_argv": cli, "dir": str(d)}, d / "job.pt")
        parts = ("_moe_steps", "_trainer_steps") + (("_cli_and_bench",) if cli else ())
        joins[world] = worker.spawn(d, world, parts, timeout_s=300.0)
    ref = {}
    try:
        jstate = setup["jstate"]
        for world in (2, 4):
            for name, sizes in STEP_CASES[world].items():
                mesh = lmm.jax_mesh(**sizes)
                jm = _jax_lm(sizes)
                make = (make_lm_train_step if sizes.get("sequence", 1) > 1
                        else make_tp_lm_train_step)
                step = make(mesh, model=jm, zero_stage=int(name in ZERO1), donate=False)
                state = jstate if name not in ZERO1 else _jax_state(jm, tx=CLIP)
                ref[name] = lmm.run_jax(step, state.replace(apply_fn=jm.apply), _batches())
        step = make_tp_lm_train_step(lmm.jax_mesh(data=2), model=_jax_lm(),
                                     grad_accum_steps=ACCUM, donate=False)
        ref["lm_f1"] = lmm.run_jax(step, jstate, _lm_global_batches(_lm_cfg({"data": 2}), 2))
        sizes = {"data": 2, "sequence": 2}
        jm = _jax_lm(sizes)
        step = make_lm_train_step(lmm.jax_mesh(**sizes), model=jm,
                                  grad_accum_steps=ACCUM, donate=False)
        ref["lm_d2s2_accum"] = lmm.run_jax(step, jstate.replace(apply_fn=jm.apply),
                                           _lm_global_batches(_lm_cfg(sizes), 2))
        step = jax_image_step(lmm.jax_mesh(data=2), grad_accum_steps=ACCUM, donate=False)
        ref["img_f1"] = _run_jax_image(step, setup["istate"],
                                       _image_global_batches(_image_cfg()))
        ref["lm_f1_batches"] = _lm_global_batches(_lm_cfg({"data": 2}), 2)
    finally:
        ranks = {w: join() for w, join in joins.items()}
    return {"ranks": ranks, "ref": ref}


def _assert_matches(res: dict, ref: dict, model: str = "transformer_lm",
                    kw: dict | None = None) -> None:
    for got, want in zip(res["metrics"], ref["metrics"]):
        for k in set(want) & set(got):
            if k != "grad_norm":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert res["step"] == ref["step"] == len(ref["metrics"])
    tm = get_model(model, **(LM_KW if kw is None else kw))
    tm.load_state_dict(res["state"]["model"])
    params, stats = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 ref["params"], params)
    if "batch_stats" in ref:
        jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                     ref["batch_stats"], stats)
    for key in ("mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()),
            ref[key], bridge.named_to_flax_tree(tm, res["state"]["opt_state"][key]))


CASES = [(w, n) for w in (2, 4) for n in STEP_CASES[w]]


@pytest.mark.parametrize("world,name", CASES, ids=[n for _, n in CASES])
def test_moe_step_matches_jax_on_the_same_mesh(runs, world, name):
    """Two steps of the MoE LM on each rank's shard match JAX's step on the
    matching mesh, at a capacity that drops tokens: the gate is local to
    each (data, sequence) shard under a sequence axis, global over the data
    ranks otherwise, and a model axis runs the layer whole on every rank."""
    for r in runs["ranks"][world]:
        _assert_matches(r["moe"][name], runs["ref"][name])
        assert all(m["aux_loss"] > 0 for m in r["moe"][name]["metrics"])


@pytest.mark.parametrize("flag", ["--sp", "--tp"])
def test_gpt_cli_trains_moe_under_the_sequence_and_model_axes(runs, flag):
    """The GPT CLI with ``--moe`` and ``--sp 2`` or ``--tp 2`` (refused by
    the trainer once) trains its two steps and evaluates on both ranks."""
    i = ["--sp", "--tp"].index(flag)
    outs = [r["cli"][i] for r in runs["ranks"][2]]
    for out in outs:
        assert out["steps"] == 2 and np.isfinite(out["final_perplexity"])
        assert out["last_metrics"]["aux_loss"] > 0
    assert outs[0]["final_perplexity"] == outs[1]["final_perplexity"]


def test_lm_trainer_microbatches_in_jax_order(runs):
    """``LMTrainer`` with MoE at data 2 and two accumulation steps gives
    each rank its share of each of JAX's microbatches, and its two steps
    match JAX's GSPMD step on the global batches."""
    glob = runs["ref"]["lm_f1_batches"][0]["tokens"]
    micro = PER_RANK * 2
    for d, r in enumerate(runs["ranks"][2]):
        res = r["trainer_steps"]["lm_f1"]
        want = np.concatenate([glob[m * micro + d * PER_RANK:m * micro + (d + 1) * PER_RANK]
                               for m in range(ACCUM)])
        np.testing.assert_array_equal(res["first"]["tokens"][:, :-1], want)
        _assert_matches(res, runs["ref"]["lm_f1"])


def test_syncbn_microbatches_in_jax_order(runs):
    """The image ``Trainer`` (``resnet_micro``, SyncBN) at data 2 and two
    accumulation steps matches JAX's GSPMD step on the global batches:
    parameters, Adam's moments and the BatchNorm statistics, which each
    microbatch's rows decide."""
    for r in runs["ranks"][2]:
        _assert_matches(r["trainer_steps"]["img_f1"], runs["ref"]["img_f1"],
                        model="resnet_micro", kw={})


def test_sequence_strategy_keeps_shard_local_microbatches(runs):
    """``LMTrainer`` with MoE at data 2 × sequence 2 and two accumulation
    steps matches JAX's sequence step, which scans each shard's own rows."""
    for r in runs["ranks"][4]:
        _assert_matches(r["trainer_steps"]["lm_d2s2_accum"], runs["ref"]["lm_d2s2_accum"])
