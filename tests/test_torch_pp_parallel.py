"""The port's pipeline over gloo ranks against the JAX package's
``make_pp_lm_train_step`` on CPU meshes of the same shape
(``tests/torch_dist_worker.py``).

The model is a micro GPT (4 layers, 8 for the circular case; 4 heads,
width 32, vocabulary 64, T 32, exact attention), float32, two
``hybrid_adam`` steps against optax ``adam``, from the same JAX-initialised
weights: JAX's stacked ``blocks`` tree in its storage order, carried to
each rank's stage through ``bridge.py``. The global batch is 8 rows.

The layouts (four ranks): pipe 4 (M 4); pipe 2 × data 2 at ZeRO 0 and 1;
pipe 2 × model 2; pipe 2 × sequence 2, also with the chunked CE at JAX's
chunk 32 over the full T (a shard holds 16 positions); pipe 4 at ``virtual_stages`` 2
(L 8, M 4); ``LMTrainer`` at pipe 2 × data 2 with two accumulation steps
(M 2, so 4 microbatches of each data shard's rows, on its loader's
batches); homogeneous MoE (4 experts at every layer, top-1, capacity
factor 0.5, so tokens drop) at pipe 2 × data 2 and at pipe 2 × expert 2.
The ZeRO 1 and pipe 4 cases clip at 0.05, which binds: the global norm
spans the stages. Under the pipeline JAX's MoE gate is local to each
(data shard, microbatch) (its stage sees one microbatch), and at this
capacity a gate over another token set routes other tokens and fails.

Two ranks: the GPT CLI's trainer with ``--pp 2 --microbatches 2`` (and
``--virtual-stages 2``) trains, evaluates and saves; the save resumes at
``--pp 1`` with the same weights; what JAX's pipeline refuses, the CLI
refuses with JAX's exception and message.

Tolerances are ``tests/torch_lm_mesh.py``'s: metrics rtol 1e-5,
parameters atol 1e-5, Adam's moments within 1e-4 of each tensor's largest
magnitude.
"""

import dataclasses

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
from distributed_training_tpu.parallel.pipeline import unstack_block_params
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train.lm_step import make_pp_lm_train_step
from distributed_training_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.train_state import TrainState as JState
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch import checkpoint as ckpt_lib
from distributed_training_tpu_torch.config import (
    DataConfig,
    LMConfig,
    MeshSpec,
    OptimizerConfig,
    TrainConfig,
)
from distributed_training_tpu_torch.data.lm_text import TokenLoader, synthetic_tokens
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.lm_step import make_lm_batch

torch.set_num_threads(1)

T, ROWS = 32, 8
BASE = dict(num_classes=64, num_heads=4, hidden_dim=32, max_len=64)
MOE = dict(moe_num_experts=4, moe_every=1, moe_top_k=1, moe_capacity_factor=0.5)
KW = {"lm": dict(num_layers=4, **BASE), "lm8": dict(num_layers=8, **BASE),
      "moe": dict(num_layers=4, **BASE, **MOE)}
CLIP = lmm.opt(grad_clip_norm=0.05)
# name: (model, mesh, microbatches, virtual stages, ZeRO stage, optimizer)
CASES = {
    "p4": ("lm", {"data": 1, "pipe": 4}, 4, 1, 0, CLIP),
    "p2d2": ("lm", {"data": 2, "pipe": 2}, 2, 1, 0, lmm.opt()),
    "p2d2_zero1": ("lm", {"data": 2, "pipe": 2}, 2, 1, 1, CLIP),
    "p2m2": ("lm", {"data": 1, "pipe": 2, "model": 2}, 2, 1, 0, lmm.opt()),
    "p2s2": ("lm", {"data": 1, "pipe": 2, "sequence": 2}, 2, 1, 0, lmm.opt()),
    "p4_v2": ("lm8", {"data": 1, "pipe": 4}, 4, 2, 0, lmm.opt()),
    "moe_p2d2": ("moe", {"data": 2, "pipe": 2}, 2, 1, 0, lmm.opt()),
    "moe_p2e2": ("moe", {"data": 1, "pipe": 2, "expert": 2}, 2, 1, 0, lmm.opt()),
    # The chunked CE over the full T (JAX's chunk 32): a shard holds 16.
    "p2s2_ce32": ("lm", {"data": 1, "pipe": 2, "sequence": 2}, 2, 1, 0, lmm.opt()),
}
STEP = {"p2s2_ce32": {"ce_chunk": 32}}
ACCUM, MICRO, PER_RANK = 2, 2, 4
# The CLI at two ranks (4 layers so that --virtual-stages 2 divides them).
CLI_FLAGS = (["--pp", "2", "--microbatches", "2"],
             ["--pp", "2", "--microbatches", "2", "--virtual-stages", "2"])
# What JAX's pipeline refuses, at pipe 2 over two ranks (the CLI's -b 4).
REFUSED = (["--pp", "2", "--tp-overlap"], ["--pp", "2", "--stage", "3"],
           ["--pp", "2", "--moe", "--num-experts", "4"],
           ["--pp", "2", "--virtual-stages", "3"],
           ["--pp", "2", "--virtual-stages", "2", "--microbatches", "3", "-b", "6"],
           ["--pp", "2", "--microbatches", "2", "--gradient-accumulation-steps", "4"])


def _batches(seed=7):
    rng = np.random.RandomState(seed)
    return [make_lm_batch(rng.randint(0, 64, (ROWS, T + 1)).astype(np.int32))
            for _ in range(lmm.STEPS)]


def _jax_lm(model: str, sizes: dict):
    return jax_model("transformer_lm", logits_dtype=jnp.float32,
                     seq_axis="sequence" if sizes.get("sequence", 1) > 1 else None,
                     moe_expert_axis="expert" if sizes.get("expert", 1) > 1 else None,
                     **KW[model])


def _jax_step(model, sizes, micro, virtual, stage, **step):
    return make_pp_lm_train_step(lmm.jax_mesh(**sizes), model=_jax_lm(model, sizes),
                                 num_microbatches=micro, virtual_stages=virtual,
                                 zero_stage=stage, donate=False, **step)


def _jax_state(step, opt):
    plm = step.pipelined
    tx = jmake(JOpt(**{**opt, "name": "adam"}))
    return JState.create(apply_fn=plm.apply_fn, params=plm.init_params(jax.random.PRNGKey(0)),
                         tx=tx, loss_scale=JLoss.create(JPrec()))


def _whole_flax(ref: dict, order) -> dict:
    """The JAX run's params and moments with the blocks unstacked."""
    return {k: unstack_block_params(ref[k]["blocks"], {n: v for n, v in ref[k].items()
                                                        if n != "blocks"},
                                    layer_order=order)
            for k in ("params", "mu", "nu")}


def _trainer_cfg() -> TrainConfig:
    return TrainConfig(
        model="transformer_lm", num_epochs=1, gradient_accumulation_steps=ACCUM,
        optimizer=OptimizerConfig(**lmm.opt()), mesh=MeshSpec(data=2, pipe=2),
        lm=LMConfig(seq_len=T, vocab_size=64, num_layers=4, num_heads=4, hidden_dim=32,
                    max_len=64, train_sequences=64, logits_dtype="fp32",
                    num_microbatches=MICRO),
        data=DataConfig(batch_size=PER_RANK))


def _trainer_batches(cfg) -> list[dict]:
    lm = cfg.lm
    loader = TokenLoader(synthetic_tokens(lm.train_sequences, lm.seq_len, lm.vocab_size,
                                          seed=cfg.seed),
                         global_batch_size=PER_RANK * 2 * ACCUM, shuffle=True, seed=cfg.seed)
    return [make_lm_batch(b["tokens"]) for b, _ in zip(loader, range(lmm.STEPS))]


def _cli_argv(directory, *flags):
    return lmm.cli_argv(directory, "--num-layers", "4", *flags)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX initial weights, both spawns started together, then the JAX
    references here."""
    weights = {}
    for model in KW:
        sizes = {"data": 1, "pipe": 4 if model == "lm8" else 2}
        step = _jax_step(model, sizes, 4, 2 if model == "lm8" else 1, 0)
        params = jax.device_get(step.pipelined.init_params(jax.random.PRNGKey(0)))
        tm = get_model("transformer_lm", **KW[model])
        bridge.load_flax_pipeline(tm, params, step.pipelined.layer_order)
        weights[model] = tm.state_dict()
    d4 = tmp_path_factory.mktemp("pp4")
    scenarios = {name: dict(model=m, mesh=mesh, micro=micro, virtual=v, stage=stage,
                            opt=opt, save=name == "p4_v2", step=STEP.get(name, {}))
                 for name, (m, mesh, micro, v, stage, opt) in CASES.items()}
    trainer_cfg = _trainer_cfg()
    torch.save({**{f"{m}_kw": KW[m] for m in KW}, **{f"{m}_model": weights[m] for m in KW},
                **{f"{m}_batches": _batches() for m in KW}, "pp_scenarios": scenarios,
                "trainer_steps": {"accum": {"cfg": trainer_cfg, "weights": weights["lm"],
                                            "steps": lmm.STEPS}},
                "dir": str(d4)}, d4 / "job.pt")
    d2 = tmp_path_factory.mktemp("pp2")
    torch.save({"pp_cli": [_cli_argv(d2 / f"cli{i}", *f) for i, f in enumerate(CLI_FLAGS)],
                "pp_refused": [_cli_argv(d2 / "refused", *f) for f in REFUSED],
                "dir": str(d2)}, d2 / "job.pt")
    joins = {4: worker.spawn(d4, 4, ("_pp_steps", "_trainer_steps"), timeout_s=400.0),
             2: worker.spawn(d2, 2, ("_pp_cli",), timeout_s=400.0)}
    ref = {}
    try:
        for name, (m, sizes, micro, v, stage, opt) in CASES.items():
            step = _jax_step(m, sizes, micro, v, stage, **STEP.get(name, {}))
            ref[name] = lmm.run_jax(step, _jax_state(step, opt), _batches())
            ref[name]["order"] = step.pipelined.layer_order
        step = _jax_step("lm", {"data": 2, "pipe": 2}, MICRO * ACCUM, 1, 0)
        ref["accum"] = lmm.run_jax(step, _jax_state(step, lmm.opt()),
                                   _trainer_batches(trainer_cfg))
        ref["accum"]["order"] = step.pipelined.layer_order
        ref["refused"] = [_jax_refusal(_cli_argv(d2 / "refused", *flags)[2:])
                          for flags in REFUSED]
    finally:
        ranks = {w: join() for w, join in joins.items()}
    return {"ranks": ranks, "ref": ref, "dir4": d4, "dir2": d2}


def _jax_refusal(argv: list[str]):
    """The JAX trainer's exception for the JAX CLI's config of ``argv`` (the
    port's flags less ``--device``), on a two-device mesh."""
    import importlib.util
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_gpt_cli", os.path.join(root, "gpt", "jax_tpu", "train.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    old, sys.argv = sys.argv, ["train.py", *argv]
    try:
        cfg = jcli.build_config(jcli.add_argument())
    finally:
        sys.argv = old
    mesh = create_mesh(MeshConfig(**{**dataclasses.asdict(cfg.mesh), "data": 1}),
                       devices=jax.devices()[:2])
    try:
        JaxLMTrainer(cfg, mesh=mesh)
    except (NotImplementedError, ValueError) as e:
        return (type(e).__name__, str(e))
    return None


def _assert_matches(res: dict, ref: dict, model: str) -> None:
    for got, want in zip(res["metrics"], ref["metrics"]):
        assert set(want) <= set(got) | {"grad_norm"}
        for k in set(want) & set(got):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert res["step"] == ref["step"] == lmm.STEPS
    want = _whole_flax(ref, ref["order"])
    tm = get_model("transformer_lm", **KW[model])
    tm.load_state_dict(res["state"]["model"])
    params, _ = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 want["params"], params)
    for key in ("mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()),
            want[key], bridge.named_to_flax_tree(tm, res["state"]["opt_state"][key]))


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_jax_on_the_same_mesh(runs, name):
    """Two pipeline steps on every rank's stage and shard match JAX's
    ``make_pp_lm_train_step`` on the matching mesh; every rank gathers the
    same whole state, in layer order."""
    model = CASES[name][0]
    ranks = runs["ranks"][4]
    for r in ranks:
        _assert_matches(r["pp"][name], runs["ref"][name], model)
        if model == "moe":
            assert all(m["aux_loss"] > 0 for m in r["pp"][name]["metrics"])
    first = ranks[0]["pp"][name]["state"]["model"]
    assert all(torch.equal(first[n], r["pp"][name]["state"]["model"][n])
               for r in ranks[1:] for n in first)


def test_each_stage_holds_its_layers_in_jax_storage_order(runs):
    """Rank r at pipe index p holds JAX's storage rows ``p·L/S ..``: the
    circular case's stage 1 holds layers 1 and 5."""
    pipe_index = [0, 1, 2, 3]
    for r, p in zip(runs["ranks"][4], pipe_index):
        assert r["pp"]["p4_v2"]["layers"] == [p, p + 4]
        assert r["pp"]["p4"]["layers"] == [p]


def test_lm_trainer_pipeline_accumulates_into_microbatches(runs):
    """``LMTrainer`` at pipe 2 × data 2 with two accumulation steps runs its
    loader's shard-local rows as ``num_microbatches × accum`` microbatches
    of one step, and matches JAX's pipeline step at M 4 on the global
    batches (each data shard a contiguous block of them)."""
    glob = runs["ref"]["accum"]
    batches = _trainer_batches(_trainer_cfg())
    rows = PER_RANK * ACCUM
    for rank, r in enumerate(runs["ranks"][4]):
        res = r["trainer_steps"]["accum"]
        d = rank // 2  # data is the outer axis: ranks 0, 1 hold data 0
        np.testing.assert_array_equal(res["first"]["tokens"][:, :-1],
                                      batches[0]["tokens"][d * rows:(d + 1) * rows])
        _assert_matches(res, glob, "lm")


def test_pp4_v2_save_resumes_at_world_one(runs):
    """The circular pipeline's save is the world-1 format, in layer order:
    a plain model loads it strictly and holds the gathered weights; the
    layout of the run is recorded beside it."""
    blob = torch.load(runs["dir4"] / "p4_v2" / "epoch_0" / "state.pt", weights_only=True)
    sd = blob["state"]
    assert sd["layout"] == {"pipe_size": 4, "virtual_stages": 2}
    tm = get_model("transformer_lm", **KW["lm8"])
    tm.load_state_dict(sd["model"], strict=True)
    want = runs["ranks"][4][0]["pp"]["p4_v2"]["state"]["model"]
    assert all(torch.equal(sd["model"][n], want[n]) for n in want)


@pytest.mark.parametrize("i", range(len(CLI_FLAGS)),
                         ids=["gpipe", "circular"])
def test_gpt_cli_pipeline_trains_evaluates_and_resumes_at_pp1(runs, i, tmp_path):
    """``--pp 2 --microbatches 2`` (and ``--virtual-stages 2``) over two
    ranks trains its two steps, evaluates and saves; the save resumes at
    ``--pp 1`` (world 1) with the same weights."""
    outs = [r["pp_cli"][i] for r in runs["ranks"][2]]
    for out in outs:
        assert out["strategy"] == "pipeline"
        assert out["result"]["steps"] == 2 and np.isfinite(out["result"]["final_perplexity"])
    assert outs[0]["result"]["final_perplexity"] == outs[1]["result"]["final_perplexity"]
    assert outs[0]["bubble"] == (1 / 3 if i == 0 else 1 / 5)
    cli = lmm.port_cli()
    directory = runs["dir2"] / f"cli{i}"
    t = cli.build_trainer(_cli_argv(directory, "-r", "0"))
    assert t.strategy == "tensor/dp"
    ckpt_lib.restore_checkpoint(str(directory), 0, t.state)
    got = t.state.state_dict()["model"]
    assert set(got) == set(outs[0]["model"])
    for n, v in outs[0]["model"].items():
        torch.testing.assert_close(got[n], v, rtol=0, atol=0)


@pytest.mark.parametrize("i", range(len(REFUSED)),
                         ids=["tp_overlap", "zero3", "alternating_moe", "layers",
                              "circular_microbatches", "accum"])
def test_gpt_cli_refuses_what_jax_refuses(runs, i):
    """Each configuration JAX's pipeline refuses is refused through the CLI
    on both ranks, with JAX's exception type and message."""
    want = runs["ref"]["refused"][i]
    assert want is not None
    for r in runs["ranks"][2]:
        assert r["pp_refused"][i] == want
