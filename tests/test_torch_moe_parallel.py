"""The port's MoE across ranks (gloo on the CPU) against the JAX package's
step on the unsharded global batch: the gate global over the data group
and the experts sharded over the expert group must give the one-device
step's losses, parameters and Adam moments.

Two spawns, every case inside them (``tests/torch_dist_worker.py``,
``_moe_steps``):

- two ranks: the micro GPT with MoE (2 layers, 4 heads, d 64, T 128, 4
  experts at block 1, top-2, capacity factor 0.5, so that tokens drop) as
  data 2 and as expert 2 (which also saves a checkpoint), that save
  restored at data 2 × expert 1; the ``moe_mlp`` image model (2 MoE
  layers of 4 experts, top-1, capacity factor 0.5) as data 2 and expert 2;
- four ranks: the GPT as data 2 × expert 2 at ZeRO 0, and at ZeRO 1 with
  ``moe_param_group`` and a clip that binds (0.05), whose global norm sums
  the expert tensors over the expert ranks.

Each runs two ``hybrid_adam`` steps, against optax ``adam`` in JAX (the
same update) on the same global batches. Tolerances are
``tests/torch_lm_mesh.py``'s: metrics rtol 1e-5, parameters atol 1e-5,
moments 1e-4 of each tensor's largest magnitude. The expert-2 save is
also restored at world 1 in this process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
import torch_lm_mesh as lmm

from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.train.lm_step import make_tp_lm_train_step
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.step import make_train_step as jax_image_step
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch import checkpoint as ckpt_lib
from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState
from distributed_training_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)

MOE_KW = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
LM_KW = {**lmm.LM_KW, **MOE_KW}
IMG_KW = dict(num_classes=10, hidden_size=32, num_layers=2, num_experts=(4,),
              mlp_hidden=64, top_k=1, capacity_factor=0.5)
CLIP = lmm.opt(grad_clip_norm=0.05)
SCENARIOS = {
    2: {"lm_data2": dict(kind="lm", mesh={"data": 2}, stage=0, opt=lmm.opt()),
        "lm_expert2": dict(kind="lm", mesh={"data": 1, "expert": 2}, stage=0,
                           opt=lmm.opt(), save=True),
        "img_data2": dict(kind="image", mesh={"data": 2}, stage=0, opt=lmm.opt()),
        "img_expert2": dict(kind="image", mesh={"data": 1, "expert": 2}, stage=0,
                            opt=lmm.opt())},
    4: {"lm_d2e2": dict(kind="lm", mesh={"data": 2, "expert": 2}, stage=0, opt=lmm.opt()),
        "lm_d2e2_zero1": dict(kind="lm", mesh={"data": 2, "expert": 2}, stage=1,
                              opt=CLIP)},
}


def _jax_opt(opt):
    return jmake(JOpt(**{**opt, "name": "adam"}))


def _image_batches(n=lmm.STEPS, rows=8, seed=9):
    rng = np.random.RandomState(seed)
    return [{"image": rng.rand(rows, 16, 16, 3).astype(np.float32),
             "label": rng.randint(0, 10, rows).astype(np.int32)} for _ in range(n)]


@pytest.fixture(scope="module")
def weights():
    jlm = lmm.jax_lm(**MOE_KW)
    lstate = lmm.jax_state(jlm, lmm.opt())
    tlm = get_model("transformer_lm", **LM_KW)
    bridge.load_flax_variables(tlm, jax.device_get(lstate.params))
    jimg = jax_model("moe_mlp", **IMG_KW)
    istate = init_train_state(jimg, jax.random.PRNGKey(0), (1, 16, 16, 3),
                              _jax_opt(lmm.opt()), loss_scale=JLoss.create(JPrec()))
    timg = get_model("moe_mlp", **IMG_KW)
    bridge.load_flax_variables(timg, jax.device_get(istate.params))
    return {"jlm": jlm, "lm": tlm.state_dict(), "jimg": jimg, "img": timg.state_dict(),
            "lm_params": lstate.params, "img_params": istate.params}


def _job(weights, tmp_path, world):
    return {"lm_kw": LM_KW, "image_kw": IMG_KW, "lm_model": weights["lm"],
            "image_model": weights["img"], "lm_batches": lmm.batches(),
            "image_batches": _image_batches(), "moe_scenarios": SCENARIOS[world],
            "dir": str(tmp_path)}


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    """Both spawns, started together; every rank's results by world."""
    joins = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"moe{world}")
        job = _job(weights, d, world)
        if world == 2:  # the ep-2 save restored at data 2, expert 1
            job["moe_scenarios"] = {**job["moe_scenarios"], "restore_data2": dict(
                kind="lm", mesh={"data": 2}, stage=0, opt=lmm.opt(),
                restore=os.path.join(str(d), "lm_expert2"))}
        torch.save(job, os.path.join(str(d), "job.pt"))
        joins[world] = (d, worker.spawn(d, world, ("_moe_steps",), timeout_s=240.0))
    return {w: (d, join()) for w, (d, join) in joins.items()}


@pytest.fixture(scope="module")
def jax_refs(weights):
    """The JAX step on the unsharded global batches, one per optimizer."""
    mesh = lmm.jax_mesh(data=1)
    out = {}
    for key, opt in (("lm", lmm.opt()), ("lm_clip", CLIP)):
        jstate = init_train_state(weights["jlm"], jax.random.PRNGKey(0), (1, 8),
                                  _jax_opt(opt), loss_scale=JLoss.create(JPrec()),
                                  input_dtype=jnp.int32)
        jstate = jstate.replace(params=weights["lm_params"])
        out[key] = lmm.run_jax(make_tp_lm_train_step(mesh, model=weights["jlm"],
                                                     donate=False), jstate, lmm.batches())
    jstate = init_train_state(weights["jimg"], jax.random.PRNGKey(0), (1, 16, 16, 3),
                              _jax_opt(lmm.opt()), loss_scale=JLoss.create(JPrec()))
    jstate = jstate.replace(params=weights["img_params"])
    step = jax_image_step(mesh, donate=False)
    metrics = []
    for b in _image_batches():
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    adam = next(s for s in jax.tree_util.tree_leaves(
        jax.device_get(jstate.opt_state), is_leaf=lambda x: hasattr(x, "nu"))
        if hasattr(s, "nu"))
    out["image"] = {"params": jax.device_get(jstate.params), "mu": adam.mu, "nu": adam.nu,
                    "metrics": metrics, "step": int(jstate.step)}
    return out


def _assert_matches(res, ref, kind):
    for got, want in zip(res["metrics"], ref["metrics"]):
        for k in set(want) & set(got):
            if k == "grad_norm":
                continue
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert res["step"] == ref["step"] == len(ref["metrics"])
    tm = get_model("transformer_lm" if kind == "lm" else "moe_mlp",
                   **(LM_KW if kind == "lm" else IMG_KW))
    tm.load_state_dict(res["state"]["model"])
    params, _ = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 ref["params"], params)
    for key in ("mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()),
            ref[key], bridge.named_to_flax_tree(tm, res["state"]["opt_state"][key]))


CASES = [(2, "lm_data2", "lm"), (2, "lm_expert2", "lm"), (2, "img_data2", "image"),
         (2, "img_expert2", "image"), (4, "lm_d2e2", "lm"), (4, "lm_d2e2_zero1", "lm_clip")]


@pytest.mark.parametrize("world,name,ref", CASES, ids=[c[1] for c in CASES])
def test_moe_step_matches_the_unsharded_jax_step(runs, jax_refs, world, name, ref):
    """Every rank ends with the whole state of the JAX step on the global
    batch; at a capacity that drops tokens the match needs the gate's
    global order over the data ranks."""
    _, ranks = runs[world]
    kind = "lm" if ref.startswith("lm") else "image"
    for r in ranks:
        _assert_matches(r["moe"][name], jax_refs[ref], kind)
    experts = 4 // SCENARIOS[world][name]["mesh"].get("expert", 1)
    assert all(r["moe"][name]["local_experts"] == experts for r in ranks)
    aux = [m["aux_loss"] for m in ranks[0]["moe"][name]["metrics"] if "aux_loss" in m]
    assert all(a > 0 for a in aux)


def test_expert2_checkpoint_resumes_at_expert1_and_world1(runs):
    """A save at expert 2 (ZeRO 0) loads at data 2 × expert 1 over the
    ranks, and at world 1 here, as the whole state it saved."""
    d, ranks = runs[2]
    saved = ranks[0]["moe"]["lm_expert2"]["state"]
    for r in ranks:
        restored = r["moe"]["restore_data2"]["restored"]
        for n, t in saved["model"].items():
            assert torch.equal(restored["model"][n], t), n
        for slot in ("mu", "nu"):
            for n, t in saved["opt_state"][slot].items():
                assert torch.equal(restored["opt_state"][slot][n], t), n
    model = get_model("transformer_lm", **LM_KW)
    state = TrainState.create(model, make_optimizer(OptimizerConfig(**lmm.opt())),
                              LossScaleState.create(PrecisionConfig()))
    ckpt_lib.restore_checkpoint(os.path.join(str(d), "lm_expert2"), 0, state)
    sd = state.state_dict()
    assert state.step == saved["step"] == lmm.STEPS
    for n, t in saved["model"].items():
        assert torch.equal(sd["model"][n], t), n
