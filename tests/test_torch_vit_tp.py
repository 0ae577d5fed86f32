"""ViT on the port's image ``Trainer`` across ranks (gloo on the CPU):
data parallelism, megatron tensor parallelism over the ``model`` axis and
``tp_overlap``'s rings, against the JAX package's TP step on CPU meshes of
the same shape (the cases of ``tests/test_vit_tp.py``).

The model is image 32, patch 8, hidden 64, 2 layers, 4 heads, MLP 128, 12
classes (the class-parallel head at model 4 needs a count that 4 divides,
as JAX's Trainer checks; the synthetic CIFAR labels use 10 of them; the
head's zero kernel is replaced by a random one, so every leaf moves),
float32, ``hybrid_adam`` against optax ``adam``, two steps on the
synthetic CIFAR batches of each ``Trainer``'s own loader, from the JAX
initial weights. Two spawns:

- two ranks: model 2, model 2 with ``tp_overlap`` (a save that this
  process resumes at model 1), and ``resnet_micro`` on the model axis,
  refused with JAX's ``NotImplementedError``; then ViT with
  ``seq_axis_name`` (the ring's exact non-causal attention in every block,
  as JAX's ``seq_axis_name`` runs it) on each rank's half of 4 images,
  against JAX's ViT under ``shard_map`` on a 2-device ``sequence`` mesh:
  the logits and every gradient of ``Σ logits · g`` within 1e-5 of the
  largest magnitude (float32);
- four ranks: DP 4, model 4 and model 4 overlapped, model 2 × data 2 at
  ZeRO 1, plain and overlapped.

Each against JAX's ``make_train_step`` (``tensor_parallel``, ``tp_overlap``)
on the matching mesh over the global batches. Tolerances are
``tests/torch_lm_mesh.py``'s: metrics rtol 1e-5, parameters atol 1e-5,
Adam's moments 1e-4 of each tensor's largest magnitude, but for the key
projection's bias, whose gradient is zero in exact arithmetic (the softmax
ignores a per-query constant): its moments hold rounding noise, held to
1e-8 (first) and 1e-16 (second) absolute. The Trainer's divisibility
messages and the ResNet refusal are JAX's, word for word.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
import torch_lm_mesh as lmm

from distributed_training_tpu.config import DataConfig as JData
from distributed_training_tpu.config import MeshSpec as JMesh
from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.config import TrainConfig as JTrainConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.parallel.sharding import place_state
from distributed_training_tpu.parallel.tensor_parallel import tp_state_shardings
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.step import make_train_step as jax_image_step
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu.train.trainer import Trainer as JTrainer
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch import checkpoint as ckpt_lib
from distributed_training_tpu_torch.config import (
    DataConfig,
    MeshSpec,
    OptimizerConfig,
    PrecisionConfig,
    TrainConfig,
    ZeroConfig,
)
from distributed_training_tpu_torch.data.pipeline import build_dataloaders
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState
from distributed_training_tpu_torch.train.train_state import TrainState
from distributed_training_tpu_torch.train.trainer import check_tp_model

torch.set_num_threads(1)

VIT_KW = dict(patch_size=8, hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128)
CLASSES, PER_RANK = 12, 4
# name: (mesh, tp_overlap, zero stage)
CASES = {
    2: {"m2": ({"data": 1, "model": 2}, False, 0),
        "m2_overlap": ({"data": 1, "model": 2}, True, 0)},
    4: {"dp4": ({"data": 4}, False, 0),
        "m4": ({"data": 1, "model": 4}, False, 0),
        "m4_overlap": ({"data": 1, "model": 4}, True, 0),
        "m2d2_zero1": ({"data": 2, "model": 2}, False, 1),
        "m2d2_zero1_overlap": ({"data": 2, "model": 2}, True, 1)},
}


def _cfg(mesh: dict, overlap: bool, stage: int, model: str = "vit_b16") -> TrainConfig:
    return TrainConfig(model=model, num_epochs=1, tp_overlap=overlap,
                       optimizer=OptimizerConfig(**lmm.opt()), mesh=MeshSpec(**mesh),
                       zero=ZeroConfig(stage=stage),
                       data=DataConfig(dataset="synthetic_cifar", batch_size=PER_RANK,
                                       num_classes=CLASSES, augment="none"))


def _global_batches(world: int) -> list[dict]:
    loader, _ = build_dataloaders(_cfg({"data": 1}, False, 0), seed=0,
                                  global_batch_size=PER_RANK * world,
                                  process_index=0, process_count=1)
    loader.set_epoch(0)
    return [b for b, _ in zip(loader, range(lmm.STEPS))]


def _jax_state(jm):
    state = init_train_state(jm, jax.random.PRNGKey(0), (1, 32, 32, 3),
                             jmake(JOpt(**{**lmm.opt(), "name": "adam"})),
                             loss_scale=JLoss.create(JPrec()))
    params = jax.device_get(state.params)
    params["head"]["kernel"] = np.random.RandomState(5).randn(
        *params["head"]["kernel"].shape).astype(np.float32) * 0.1
    return state.replace(params=params)


def _run_jax(mesh_sizes: dict, overlap: bool, stage: int, jm, jstate, data) -> dict:
    mesh = lmm.jax_mesh(**mesh_sizes)
    tp = mesh_sizes.get("model", 1) > 1
    if tp:
        jstate = place_state(jstate, tp_state_shardings(jstate, mesh, stage, overlap=overlap))
    step = jax_image_step(mesh, zero_stage=stage, donate=False, tensor_parallel=tp,
                          tp_overlap=overlap and tp)
    metrics = []
    for b in data:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                         jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    adam = next(s for s in jax.tree_util.tree_leaves(
        jax.device_get(jstate.opt_state), is_leaf=lambda x: hasattr(x, "nu"))
        if hasattr(s, "nu"))
    return {"params": jax.device_get(jstate.params), "mu": adam.mu, "nu": adam.nu,
            "metrics": metrics, "step": int(jstate.step)}


@pytest.fixture(scope="module")
def weights():
    jm = jax_model("vit_b16", num_classes=CLASSES, **VIT_KW)
    jstate = _jax_state(jm)
    tm = get_model("vit_b16", num_classes=CLASSES, image_size=32, **VIT_KW)
    bridge.load_flax_variables(tm, jstate.params)
    return {"jm": jm, "jstate": jstate, "port": tm.state_dict(), **_ring_setup()}


def _ring_model(kw: dict):
    """The port's ViT with ``seq_axis_name`` at world 1 (a one-rank ring)."""
    from distributed_training_tpu_torch.config import MeshSpec as TMesh
    from distributed_training_tpu_torch.runtime.mesh import Mesh

    return get_model("vit_b16", seq_axis_name="sequence", mesh=Mesh(TMesh()),
                     image_size=32, **kw)


def _ring_setup() -> dict:
    """JAX's ViT with ``seq_axis_name`` under ``shard_map`` (the images
    split over the sequence axis, the ring attending across the shards'
    tokens): its logits and gradients, and the job for the port's ranks."""
    from jax.sharding import PartitionSpec as P

    from distributed_training_tpu.utils.compat import shard_map

    kw = dict(num_classes=CLASSES, **VIT_KW)
    jring = jax_model("vit_b16", seq_axis_name="sequence", **kw)
    rng = np.random.RandomState(3)
    x = rng.rand(4, 32, 32, 3).astype(np.float32)
    g = rng.randn(4, CLASSES).astype(np.float32)
    mesh = lmm.jax_mesh(sequence=2)
    params = jax.device_get(jax.jit(shard_map(
        lambda xs: jring.init(jax.random.PRNGKey(0), xs, train=False)["params"], mesh,
        in_specs=P("sequence"), out_specs=P()))(jnp.asarray(x)))
    params["head"]["kernel"] = rng.randn(*params["head"]["kernel"].shape).astype(
        np.float32) * 0.1

    def loss(p):
        logits = shard_map(lambda p, xs: jring.apply({"params": p}, xs, train=True), mesh,
                           in_specs=(P(), P("sequence")), out_specs=P("sequence"))(
            p, jnp.asarray(x))
        return (logits * jnp.asarray(g)).sum(), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tm = _ring_model(kw)
    bridge.load_flax_variables(tm, params)
    return {"ring_ref": {"logits": np.asarray(logits), "grads": jax.device_get(grads)},
            "ring_job": {"vit_ring_kw": {"image_size": 32, **kw},
                         "vit_ring_model": tm.state_dict(), "vit_x": x, "vit_g": g}}


@pytest.fixture(scope="module")
def runs(weights, tmp_path_factory):
    joins, dirs = {}, {}
    for world in (2, 4):
        d = dirs[world] = tmp_path_factory.mktemp(f"vit_tp{world}")
        steps = {name: {"cfg": _cfg(mesh, overlap, stage), "model_kw": VIT_KW,
                        "weights": weights["port"], "steps": lmm.STEPS,
                        "save": name == "m2_overlap"}
                 for name, (mesh, overlap, stage) in CASES[world].items()}
        if world == 2:
            steps["resnet_m2"] = {"cfg": _cfg({"data": 1, "model": 2}, False, 0,
                                              model="resnet_micro"), "weights": {}, "steps": 0}
        job = {"trainer_steps": steps, "dir": str(d)}
        parts = ("_trainer_steps",)
        if world == 2:
            job.update(weights["ring_job"])
            parts += ("_vit_ring",)
        torch.save(job, d / "job.pt")
        joins[world] = worker.spawn(d, world, parts, timeout_s=300.0)
    ref = {}
    try:
        for world in (2, 4):
            data = _global_batches(world)
            for name, (mesh, overlap, stage) in CASES[world].items():
                ref[name] = _run_jax(mesh, overlap, stage, weights["jm"], weights["jstate"],
                                     data)
    finally:
        ranks = {w: join() for w, join in joins.items()}
    return {"ranks": ranks, "ref": ref, "dirs": dirs}


def _assert_matches(res: dict, ref: dict) -> None:
    for got, want in zip(res["metrics"], ref["metrics"]):
        for k in set(want) & set(got):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert res["step"] == ref["step"] == len(ref["metrics"])
    tm = get_model("vit_b16", num_classes=CLASSES, image_size=32, **VIT_KW)
    tm.load_state_dict(res["state"]["model"])
    params, _ = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 ref["params"], params)
    for key, floor in (("mu", 1e-8), ("nu", 1e-16)):
        def close(path, a, b, floor=floor):
            zero = "key/bias" in "/".join(k.key for k in path)
            atol = floor if zero else 1e-4 * np.abs(np.asarray(a)).max()
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=atol)
        jax.tree_util.tree_map_with_path(
            close, ref[key], bridge.named_to_flax_tree(tm, res["state"]["opt_state"][key]))


ALL = [(w, n) for w in (2, 4) for n in CASES[w]]


@pytest.mark.parametrize("world,name", ALL, ids=[n for _, n in ALL])
def test_vit_trainer_matches_jax_tp_step(runs, world, name):
    """Every rank ends with the whole state of JAX's step on the same mesh."""
    for r in runs["ranks"][world]:
        _assert_matches(r["trainer_steps"][name], runs["ref"][name])


def test_vit_with_a_sequence_axis_matches_jax(runs, weights):
    """ViT's ``seq_axis_name`` path: each rank's logits, and the gradients
    summed over the ranks, against JAX's ``shard_map`` run."""
    ref = weights["ring_ref"]
    tm = _ring_model(dict(num_classes=CLASSES, **VIT_KW))
    for rank, r in enumerate(runs["ranks"][2]):
        got = r["vit_ring"]
        want = ref["logits"][2 * rank:2 * rank + 2]
        assert np.abs(got["logits"].numpy() - want).max() <= 1e-5 * np.abs(want).max()
        grads = bridge.named_to_flax_tree(tm, got["grads"])
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=1e-5 * np.abs(np.asarray(a)).max()),
            ref["grads"], grads)


def test_tp_save_resumes_at_model_1(runs):
    """The model-2 overlapped run's save (the port's world-1 layout) loads
    into an unsharded state here as the whole state the ranks held."""
    saved = runs["ranks"][2][0]["trainer_steps"]["m2_overlap"]["state"]
    model = get_model("vit_b16", num_classes=CLASSES, image_size=32, **VIT_KW)
    state = TrainState.create(model, make_optimizer(OptimizerConfig(**lmm.opt())),
                              LossScaleState.create(PrecisionConfig()))
    ckpt_lib.restore_checkpoint(os.path.join(str(runs["dirs"][2]), "m2_overlap"), 0, state)
    sd = state.state_dict()
    assert state.step == saved["step"] == lmm.STEPS
    for n, t in saved["model"].items():
        assert torch.equal(sd["model"][n], t), n
    for slot in ("mu", "nu"):
        for n, t in saved["opt_state"][slot].items():
            assert torch.equal(sd["opt_state"][slot][n], t), n


def _jax_message(cfg: JTrainConfig, exc) -> str:
    with pytest.raises(exc) as info:
        JTrainer(cfg)
    return str(info.value)


def test_resnet_on_the_model_axis_is_refused_as_jax_refuses_it(runs):
    want = _jax_message(JTrainConfig(model="resnet18").replace(
        mesh=JMesh(data=4, model=2),
        data=JData(dataset="synthetic_cifar", batch_size=8, image_size=32,
                   num_classes=10)), NotImplementedError)
    for r in runs["ranks"][2]:
        kind, msg = r["trainer_steps"]["resnet_m2"]["raised"]
        assert kind == "NotImplementedError"
        assert msg == want.replace("'resnet18'", "'resnet_micro'")


@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
def test_rule_table_places_every_vit_leaf_as_jax_does(weights, overlap):
    """The port's spec of every ViT leaf is JAX's ``tp_spec_for_path``:
    q/k/v and ``fc1`` column-parallel, ``attn/out`` and ``fc2``
    row-parallel, the head class-parallel (replicated under overlap)."""
    from distributed_training_tpu.parallel.tensor_parallel import tp_spec_for_path as jspec
    from distributed_training_tpu_torch.parallel.tensor_parallel import (
        param_path,
        tp_spec_for_path,
    )

    names = list(weights["port"])
    for name in names:
        path = param_path(name)
        assert tp_spec_for_path(path, overlap) == tuple(jspec(path, overlap)), path
    sharded = {param_path(n) for n in names if tp_spec_for_path(param_path(n), overlap)}
    assert "encoder_0/attn/query/kernel" in sharded and "encoder_1/MlpBlock_0/fc2/kernel" in sharded
    assert ("head/kernel" in sharded) is not overlap


class _Dims:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("model_par,overlap,classes", [(8, False, 10), (4, False, 10)],
                         ids=["num_heads", "num_classes"])
def test_tp_divisibility_messages_are_jax_s(model_par, overlap, classes):
    """The JAX Trainer's ``ValueError`` at ViT-B/16's width, word for word;
    then the ``mlp_dim`` and (under ``tp_overlap``) ``hidden_size`` checks,
    which that width never trips, on the dims alone."""
    want = _jax_message(JTrainConfig(model="vit_b16", tp_overlap=overlap).replace(
        mesh=JMesh(data=-1, model=model_par),
        data=JData(dataset="synthetic_cifar", batch_size=8, image_size=32,
                   num_classes=classes)), ValueError)
    cfg = TrainConfig(model="vit_b16", tp_overlap=overlap,
                      data=DataConfig(num_classes=classes))
    vit = _Dims(num_heads=12, mlp_dim=3072, hidden_size=768)
    with pytest.raises(ValueError) as info:
        check_tp_model(cfg, vit, model_par)
    assert str(info.value) == want
    with pytest.raises(ValueError, match=r"must divide mlp_dim \(= 3070\)"):
        check_tp_model(cfg, _Dims(num_heads=12, mlp_dim=3070, hidden_size=768), 4)
    with pytest.raises(ValueError, match=r"tensor parallelism size 4 must divide "
                                         r"hidden_size \(= 766\)"):
        check_tp_model(cfg.replace(tp_overlap=True),
                       _Dims(num_heads=12, mlp_dim=3072, hidden_size=766), 4)
