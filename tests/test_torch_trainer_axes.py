"""The image ``Trainer`` on the ``sequence``, ``pipe`` and ``expert`` mesh
axes.

JAX's ``Trainer`` builds its mesh from every ``MeshSpec`` axis and shards
the image batch over ``data × fsdp`` alone (``runtime/mesh.py``
``batch_sharding``), so a ``sequence`` or ``pipe`` axis, or an ``expert``
axis on a model without MoE layers, replicates the step: its ranks train
on the same rows and keep the same state, and the global batch counts
every rank. The port does the same over gloo ranks
(``tests/torch_dist_worker.py``).

Four ranks run ``resnet_micro`` at data 2 × sequence 2 and data 2 × pipe
2 through ``Trainer(cfg).fit()``, each from JAX's ``Trainer``'s own
initial weights (carried over by ``bridge.py``); two ranks run the same
global batch at data 2 alone. Every train step's loss and accuracy are
held against JAX's ``Trainer(cfg).fit()`` on a four-device CPU mesh of
the same shape at rtol 1e-5 (``tests/test_torch_fsdp.py``'s metric
tolerance: SyncBN and the gradient mean reduce in another order), and
against the port's data-2 run at rtol 1e-6 (the same arithmetic, whose
only difference is a mean over four gloo ranks of two identical pairs
where data 2 averages two). Every rank ends with the same weights, to
1e-6 of the data-2 run's, and ``fit()``'s eval accuracy is JAX's to one of
its 1024 images. Two ranks run ``resnet_micro`` at data 1 × expert 2 in the
same spawn as data 2, held the same way against JAX's ``Trainer`` on a
two-device ``data × expert`` mesh. The optimizer is the worker's (``OPT``: Adam's
eps 1e-4): at eps 1e-8 a gradient that is zero in exact arithmetic turns
the reduction's rounding into an lr-sized step whose sign depends on the
order of the sums, and a mean over four ranks sums in another order than
one over two.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
import torch_lm_mesh as lmm

from distributed_training_tpu import config as jcfg
from distributed_training_tpu.train.trainer import Trainer as JaxTrainer
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import (
    CheckpointConfig,
    DataConfig,
    MeshSpec,
    OptimizerConfig,
    TrainConfig,
)
from distributed_training_tpu_torch.models import get_model

torch.set_num_threads(1)

STEPS, PER_RANK = 3, 2
MESHES = {"d2s2": {"data": 2, "sequence": 2}, "d2p2": {"data": 2, "pipe": 2}}
# The expert axis on a model without MoE layers, over two ranks.
EXPERT = {"d1e2": {"data": 1, "expert": 2}}


def _cfg(mesh: dict, per_rank: int, directory: str) -> TrainConfig:
    return TrainConfig(
        model="resnet_micro", num_epochs=1, log_interval=1,
        optimizer=OptimizerConfig(**worker.OPT),
        mesh=MeshSpec(**mesh),
        data=DataConfig(dataset="synthetic_cifar", batch_size=per_rank,
                        augment="none", max_steps_per_epoch=STEPS),
        checkpoint=CheckpointConfig(directory=directory, interval=5))


def _to_jax(obj):
    """A port config dataclass as the JAX package's class of that name."""
    if not dataclasses.is_dataclass(obj):
        return obj
    return getattr(jcfg, type(obj).__name__)(**{
        f.name: _to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _jax_fit(cfg: TrainConfig, sizes: dict):
    """JAX's ``Trainer(cfg).fit()`` on a CPU mesh of ``sizes``: its
    initial weights as the port's state dict, each step's metrics, and
    what ``fit()`` returns."""
    jt = JaxTrainer(_to_jax(cfg), mesh=lmm.jax_mesh(**sizes))
    tm = get_model("resnet_micro")
    bridge.load_flax_variables(tm, jax.device_get(jt.state.params),
                               jax.device_get(jt.state.batch_stats))
    steps, inner = [], jt.train_step

    def recorded(state, batch, rng):
        state, metrics = inner(state, batch, rng)
        steps.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    jt.train_step = recorded
    return {k: v.clone() for k, v in tm.state_dict().items()}, steps, jt.fit()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's fits here, then the two spawns, one after the other."""
    ref, weights = {}, None
    for name, mesh in {**MESHES, **EXPERT}.items():
        per_rank = PER_RANK * 4 // int(np.prod(list(mesh.values())))
        cfg = _cfg(mesh, per_rank, str(tmp_path_factory.mktemp(f"jax_{name}")))
        w, steps, result = _jax_fit(cfg, mesh)
        weights = w if weights is None else weights
        ref[name] = {"metrics": steps, "result": result}
        for k, v in w.items():
            torch.testing.assert_close(v, weights[k], rtol=0, atol=0)
    ranks = {}
    for world, cases in ((4, MESHES), (2, {"d2": {"data": 2}, **EXPERT})):
        d = tmp_path_factory.mktemp(f"axes{world}")
        per_rank = PER_RANK * 4 // world
        job = {"trainer_fit": {
            name: {"cfg": _cfg(mesh, per_rank, str(d / name)), "weights": weights}
            for name, mesh in cases.items()}}
        torch.save(job, d / "job.pt")
        ranks[world] = worker.spawn(d, world, ("_trainer_fit",), timeout_s=300.0)()
    return {"ref": ref, "ranks": ranks}


def _losses(metrics: list[dict], key: str = "loss") -> np.ndarray:
    return np.array([m[key] for m in metrics])


@pytest.mark.parametrize("name", list(MESHES))
def test_replicated_axis_matches_jax_trainer(runs, name):
    want = runs["ref"][name]["metrics"]
    assert len(want) == STEPS
    for r in runs["ranks"][4]:
        got = r["trainer_fit"][name]
        assert got["mesh"] == {**dict.fromkeys(
            ("data", "pipe", "fsdp", "model", "expert", "sequence"), 1), **MESHES[name]}
        assert got["result"]["steps"] == STEPS
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(_losses(got["metrics"], key), _losses(want, key),
                                       rtol=1e-5, err_msg=key)
        # The epoch's eval over the 1024 synthetic images, split over data
        # and counted over the replicas: at most one image's argmax apart.
        assert abs(got["result"]["final_acc"]
                   - runs["ref"][name]["result"]["final_acc"]) <= 1 / 1024


@pytest.mark.parametrize("name", list(MESHES))
def test_replicated_axis_matches_port_data_parallel(runs, name):
    dp = runs["ranks"][2][0]["trainer_fit"]["d2"]
    for r in runs["ranks"][4]:
        got = r["trainer_fit"][name]
        np.testing.assert_allclose(_losses(got["metrics"]), _losses(dp["metrics"]),
                                   rtol=1e-6)
        for k, v in got["model"].items():
            if v.is_floating_point():
                torch.testing.assert_close(v, dp["model"][k], rtol=0, atol=1e-6,
                                           msg=k)


def test_replicated_ranks_hold_the_same_state(runs):
    """The ranks of a data index (a sequence or pipe pair) end equal."""
    ranks = runs["ranks"][4]
    for name in MESHES:
        # The canonical order (data, pipe, ..., sequence) makes the pair of
        # a data index ranks (0, 1) and (2, 3) on either mesh.
        for a, b in ((0, 1), (2, 3)):
            for k, v in ranks[a]["trainer_fit"][name]["model"].items():
                torch.testing.assert_close(v, ranks[b]["trainer_fit"][name]["model"][k],
                                           rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("name", list(EXPERT))
def test_expert_axis_on_a_dense_model_matches_jax_trainer(runs, name):
    """An expert axis on ``resnet_micro`` (no MoE layers) replicates the
    step, as JAX's ``Trainer`` does: every rank trains on the whole global
    batch (``batch_size`` a rank, counted over both ranks, split over the
    data axis of 1), each train step's loss and accuracy JAX's at rtol
    1e-5, the eval accuracy within one of the 1024 images."""
    want = runs["ref"][name]["metrics"]
    assert len(want) == STEPS
    for r in runs["ranks"][2]:
        got = r["trainer_fit"][name]
        assert got["mesh"] == {**dict.fromkeys(
            ("data", "pipe", "fsdp", "model", "expert", "sequence"), 1), **EXPERT[name]}
        assert got["result"]["steps"] == STEPS
        for key in ("loss", "accuracy"):
            np.testing.assert_allclose(_losses(got["metrics"], key), _losses(want, key),
                                       rtol=1e-5, err_msg=key)
        assert abs(got["result"]["final_acc"]
                   - runs["ref"][name]["result"]["final_acc"]) <= 1 / 1024


def test_expert_ranks_hold_the_same_state(runs):
    """The two expert ranks of the dense model end equal."""
    a, b = (r["trainer_fit"]["d1e2"]["model"] for r in runs["ranks"][2])
    for k, v in a.items():
        torch.testing.assert_close(v, b[k], rtol=0, atol=0, msg=k)
