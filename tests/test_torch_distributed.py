"""The port's data parallelism on two ranks against the JAX package on a
two-device mesh.

Two ``spawn``ed processes (``tests/torch_dist_worker.py``, gloo on the
CPU, a ``file://`` store under the test's temporary directory) run the
port's train step on their halves of each global batch, from the weights
the JAX initialiser made (carried over by ``bridge.py``). Meanwhile this
process runs the JAX steps on ``create_mesh(MeshConfig(data=2))`` over two
virtual CPU devices: ``make_train_step(mesh2, zero_stage=k)`` (BatchNorm
over the global batch, the port's SyncBN) and
``make_shard_map_train_step(mesh2)`` (BatchNorm per shard, the port's
local BN). The port runs ``hybrid_adam`` (K1's plain version on the
CPU); the JAX side runs optax ``adam``, the same update, whose chain
compiles in half the time of its Pallas kernel in interpret mode.

Tolerances are ``tests/test_torch_step.py``'s for one device: loss and
accuracy rtol 1e-5; parameters atol 1e-6 (lr 1e-3); BatchNorm statistics
rtol 1e-4, atol 1e-5; Adam moments within 1e-4 of each tensor's largest
magnitude. SyncBN's variance E[x²] − E[x]² (Flax's too) and the
all-reduced sums change the last bits only. ZeRO stages 1–3 against the
port's stage 0: 1e-5 max-abs on the parameters, as
``tests/test_zero.py:67`` holds the JAX stages. lamb with the EMA at
stage 2 against the JAX lamb chain at stage 2: the same limits, the EMA
of the parameters as the parameters, that of the BatchNorm statistics as
the statistics.
"""

import concurrent.futures
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
from distributed_training_tpu.parallel.sharding import check_cpu_offload as jax_check_offload
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.step import make_shard_map_train_step
from distributed_training_tpu.train.step import make_train_step as jax_step
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import Trainer, bridge
from distributed_training_tpu_torch.config import (
    CheckpointConfig,
    DataConfig,
    MeshSpec,
    OptimizerConfig,
    TrainConfig,
    ZeroConfig,
    resolve_data_axis,
)
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.parallel.zero import Zero, check_cpu_offload

torch.set_num_threads(1)

WORLD = 2
STEPS = 2
JOIN_TIMEOUT_S = 150
STAGES = (0, 1, 2, 3)


def _jax_state(opt, name="adam"):
    return init_train_state(jax_model("resnet_micro"), jax.random.PRNGKey(0),
                            (8, 64, 64, 3), jmake(JOpt(**{**opt, "name": name})),
                            loss_scale=JLoss.create(JPrec()))


def _moments(opt_state):
    """(mu, nu) of the Adam state inside the chain (optax's or the fused
    kernel's)."""
    for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "nu")):
        if hasattr(s, "nu"):
            return s.mu, s.nu
    raise AssertionError("no Adam state in the chain")


def _jax_run(step, opt, batches, name="adam"):
    state = _jax_state(opt, name)
    ema = {}
    metrics = []
    for batch in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    opt_state = jax.device_get(state.opt_state)
    mu, nu = _moments(opt_state)
    if hasattr(opt_state, "ema_params"):
        ema = {"ema": opt_state.ema_params, "ema_stats": opt_state.ema_batch_stats}
    return {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats),
            "mu": mu, "nu": nu, "metrics": metrics, "step": int(state.step), **ema}


def _ckpt_cfg(directory, batch_size, num_epochs, resume=-1):
    return TrainConfig(
        model="resnet_micro", num_epochs=num_epochs, log_interval=1, eval_every=0,
        optimizer=OptimizerConfig(name="hybrid_adam", lr=3e-3, eps=1e-4),
        zero=ZeroConfig(stage=2),
        data=DataConfig(dataset="synthetic_cifar", batch_size=batch_size,
                        augment="none", max_steps_per_epoch=3),
        checkpoint=CheckpointConfig(directory=str(directory), interval=1,
                                    resume=resume))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, and the JAX references computed while the
    ranks run."""
    out = tmp_path_factory.mktemp("dist")
    init = _jax_state(worker.OPT)
    model = get_model("resnet_micro")
    bridge.load_flax_variables(model, jax.device_get(init.params),
                               jax.device_get(init.batch_stats))
    batches = worker.global_batches(STEPS)
    rng = np.random.RandomState(5)
    eval_batch = {"image": rng.rand(6, 32, 32, 3).astype(np.float32),
                  "label": rng.randint(0, 10, 6).astype(np.int32),
                  "mask": np.array([1, 1, 1, 1, 1, 0], np.float32)}
    torch.save({"model": model.state_dict(), "batches": batches, "eval": eval_batch,
                "dir": str(out),
                "ckpt_cfg": _ckpt_cfg(out / "ck", worker.CKPT_GLOBAL_BATCH // WORLD, 1)},
               out / "job.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, WORLD, str(out / "store"), str(out)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        mesh2 = create_mesh(MeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
        jobs = {f"s{k}": (jax_step(mesh2, zero_stage=k, donate=False), worker.OPT)
                for k in STAGES}
        jobs["local_bn"] = (make_shard_map_train_step(mesh2, donate=False), worker.OPT)
        jobs["ds_clip"] = (jax_step(mesh2, zero_stage=2, donate=False), worker.DS_OPT)
        jobs["lamb_s2"] = (jax_step(mesh2, zero_stage=2, donate=False), worker.LAMB_OPT)
        # XLA compiles outside the interpreter lock: the seven references
        # compile side by side.
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            futures = {name: pool.submit(_jax_run, step, opt, batches, opt["name"]
                                         if opt["name"] != "hybrid_adam" else "adam")
                       for name, (step, opt) in jobs.items()}
            ref = {name: f.result() for name, f in futures.items()}
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
    return {"ranks": ranks, "ref": ref, "eval": eval_batch, "model": model, "dir": out}


def _as_flax(model_sd):
    tm = get_model("resnet_micro")
    tm.load_state_dict(model_sd)
    return tm, bridge.state_dict_to_flax(tm)


def _assert_matches_jax(res, ref, param_atol=1e-6, moment_tol=1e-4):
    for got, want in zip(res["metrics"], ref["metrics"]):
        for k in ("loss", "accuracy", "loss_scale", "grads_finite"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    assert res["step"] == ref["step"] == STEPS
    tm, (params, stats) = _as_flax(res["state"]["model"])
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=param_atol),
                 ref["params"], params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                                         atol=1e-5),
                 ref["batch_stats"], stats)
    for key in ("mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=0, atol=moment_tol * np.abs(np.asarray(a)).max()),
            ref[key], bridge.named_to_flax_tree(tm, res["state"]["opt_state"][key]))


def _assert_ranks_agree(runs, name):
    """Every rank ends with the same whole state (replicated, or gathered
    from the shards)."""
    a, b = (r[name]["state"] for r in runs["ranks"])
    for key in ("model",):
        for n in a[key]:
            assert torch.equal(a[key][n], b[key][n]), n
    for key in ("mu", "nu"):
        for n in a["opt_state"][key]:
            assert torch.equal(a["opt_state"][key][n], b["opt_state"][key][n]), n


def test_stage0_sync_batchnorm_matches_jax(runs):
    res = runs["ranks"][0]["sync_s0"]
    _assert_matches_jax(res, runs["ref"]["s0"])
    _assert_ranks_agree(runs, "sync_s0")


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_zero_stage_matches_jax_and_stage0(runs, stage):
    res = runs["ranks"][0][f"sync_s{stage}"]
    _assert_matches_jax(res, runs["ref"][f"s{stage}"])
    _assert_ranks_agree(runs, f"sync_s{stage}")
    base = runs["ranks"][0]["sync_s0"]["state"]["model"]
    for n, t in res["state"]["model"].items():
        assert (t - base[n]).abs().max().item() < 1e-5, n


def test_zero_partitions_moments_and_stage3_parameters(runs):
    """Per rank, the Adam moments from stage 1 on, and the parameters at
    stage 3, take about half the bytes of the whole (each tensor padded to
    an even length: at most 4 bytes a tensor more)."""
    r0 = runs["ranks"][0]
    n_tensors = len(r0["sync_s0"]["state"]["opt_state"]["mu"])
    full_moments, full_params = r0["sync_s0"]["moment_bytes"], r0["sync_s0"]["param_bytes"]
    for stage in (1, 2, 3):
        for rank in runs["ranks"]:
            got = rank[f"sync_s{stage}"]["moment_bytes"]
            assert full_moments / 2 <= got <= full_moments / 2 + 2 * 4 * n_tensors
    for stage in (1, 2):
        assert r0[f"sync_s{stage}"]["param_bytes"] == full_params
    for rank in runs["ranks"]:
        got = rank["sync_s3"]["param_bytes"]
        assert full_params / 2 <= got <= full_params / 2 + 4 * n_tensors


def test_local_batchnorm_matches_jax_shard_map(runs):
    res = runs["ranks"][0]["local_bn"]
    _assert_matches_jax(res, runs["ref"]["local_bn"])
    _assert_ranks_agree(runs, "local_bn")


def test_deepspeed_clip_at_stage2_matches_jax(runs):
    """The deepspeed preset's Adam (beta1 0.8, clip 1.0) at stage 2, whose
    clip needs the global norm of every rank's gradient shard; and the same
    with ``cpu_offload``, moments in host memory, bit for bit.

    The clip scales every gradient down towards Adam's eps, where the
    update is most sensitive to the gradient's last bits: the JAX
    package's own one- and two-device steps of this config differ by
    2.47e-6 in the parameters (measured on the CPU), above the 1e-6 of the
    other cases. The parameters are held at 5e-6, about twice that."""
    res = runs["ranks"][0]["ds_clip"]
    _assert_matches_jax(res, runs["ref"]["ds_clip"], param_atol=5e-6)
    _assert_ranks_agree(runs, "ds_clip")
    for rank in runs["ranks"]:
        off = rank["ds_clip_offload"]
        assert off["moments_pinned_or_host"]
        for part in ("model",):
            for n, t in off["state"][part].items():
                assert torch.equal(t, rank["ds_clip"]["state"][part][n]), n
        for key in ("mu", "nu"):
            for n, t in off["state"]["opt_state"][key].items():
                assert torch.equal(t, rank["ds_clip"]["state"]["opt_state"][key][n]), n


def test_lamb_with_ema_at_stage2_matches_jax(runs):
    """lamb's trust ratio over the ranks' shards (each whole tensor's norm
    from one all-reduce of the shards' squared norms) and the two EMAs,
    partitioned, against the JAX 2-device mesh at stage 2.

    lamb moves each tensor by about lr·‖p‖, more than Adam's lr a step,
    so the second step's gradients carry more of the first step's
    rounding: the JAX package's own one- and two-device runs of this
    config differ in the moments by 1.10e-4 of each tensor's largest
    magnitude (measured on the CPU). The moments are held at 3e-4 of it,
    about three times that; the parameters at the usual 1e-6."""
    res, ref = runs["ranks"][0]["lamb_s2"], runs["ref"]["lamb_s2"]
    _assert_matches_jax(res, ref, moment_tol=3e-4)
    _assert_ranks_agree(runs, "lamb_s2")
    tm = get_model("resnet_micro")
    opt = res["state"]["opt_state"]
    assert set(opt) == {"count", "mu", "nu", "ema", "ema_stats"}
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-6),
                 ref["ema"], bridge.named_to_flax_tree(tm, opt["ema"]))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                                         atol=1e-5),
                 ref["ema_stats"], bridge.named_to_flax_stats(tm, opt["ema_stats"]))
    moments = runs["ranks"][0]["lamb_s2"]["moment_bytes"]
    assert moments < 0.51 * runs["ranks"][0]["sync_s0"]["moment_bytes"]


def test_fp16_overflow_in_one_rank_shard_skips_on_every_rank(runs):
    """An inf that only rank 1's gradient shard holds: rank 0's own shard
    is finite, yet both ranks skip the step (the finite flag is
    all-reduced) and keep the same loss scale."""
    a, b = (r["fp16_skip"] for r in runs["ranks"])
    assert a["local_finite"] and not b["local_finite"]
    for r in (a, b):
        assert r["committed"] is False and r["unchanged"] and r["step"] == 0
    assert (a["scale"], a["hysteresis_left"]) == (b["scale"], b["hysteresis_left"])
    assert a["scale"] == 2.0 ** 15 and a["hysteresis_left"] == 1


def test_eval_counts_are_summed_over_ranks(runs):
    """Each rank evaluates its half; both read the counts of the whole
    batch (the masked example dropped)."""
    batch = runs["eval"]
    model = runs["model"].eval()
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["image"]))
    labels = torch.from_numpy(batch["label"]).long()
    mask = torch.from_numpy(batch["mask"])
    top1 = float(((logits.argmax(-1) == labels).float() * mask).sum())
    top5 = float(((logits.topk(5).indices == labels[:, None]).any(-1).float() * mask).sum())
    for r in runs["ranks"]:
        assert r["eval"]["counts"] == [top1, top5, 5.0]


def test_stage2_save_at_world2_resumes_at_world1(runs, tmp_path):
    """One epoch at world 2 (ZeRO 2, 8 a rank) saved in the world-1
    format, then resumed at world 1 (16 a step) for a second epoch: the
    parameters, moments and BatchNorm statistics match a run of both
    epochs at world 1 (the same global batches, SyncBN over them)."""
    for r in runs["ranks"]:
        assert r["ckpt"]["world"] == 2 and r["ckpt"]["steps"] == 3
    full = sum(p.numel() for p in runs["model"].parameters())
    assert runs["ranks"][0]["ckpt"]["moment_numel"] < 0.51 * full
    resumed = Trainer(_ckpt_cfg(runs["dir"] / "ck", worker.CKPT_GLOBAL_BATCH, 2, resume=0),
                      device="cpu")
    resumed.fit()
    straight = Trainer(_ckpt_cfg(tmp_path / "ck", worker.CKPT_GLOBAL_BATCH, 2), device="cpu")
    straight.fit()
    assert resumed.state.step == straight.state.step == 6
    a, b = resumed.state.state_dict(), straight.state.state_dict()
    for n, t in b["model"].items():
        torch.testing.assert_close(a["model"][n], t, rtol=1e-4, atol=1e-5)
    for key in ("mu", "nu"):
        for n, t in b["opt_state"][key].items():
            torch.testing.assert_close(a["opt_state"][key][n], t, rtol=0,
                                       atol=1e-4 * t.abs().max().item())


def test_coordinator_over_two_ranks(runs):
    """Process index and count from the group, rank 0 the master and the
    first through ``priority_execution``, rank 0's scalar broadcast."""
    for rank, r in enumerate(runs["ranks"]):
        c = r["coord"]
        assert (c["index"], c["count"], c["master"]) == (rank, WORLD, rank == 0)
        assert c["order"] == [0, 1] and c["scalar"] == 1.5


def test_world_size_resolves_the_data_axis():
    """``MeshSpec.data`` is -1 (the world size) or the world size, and the
    replica count is ``data × fsdp``; a sequence or an fsdp axis of 2 is a
    mesh one process cannot hold (multi-rank in test_torch_trainer_axes.py
    and test_torch_fsdp.py)."""
    assert resolve_data_axis(MeshSpec(), 4) == 4
    assert resolve_data_axis(MeshSpec(data=2), 2) == 2
    assert resolve_data_axis(MeshSpec(data=-1, fsdp=2), 4) == 4
    with pytest.raises(ValueError, match="world size"):
        resolve_data_axis(MeshSpec(data=2), 1)
    with pytest.raises(ValueError, match="not divisible by fixed axes product 2"):
        Trainer(_ckpt_cfg("unused", 8, 1).replace(mesh=MeshSpec(sequence=2)), device="cpu")
    with pytest.raises(ValueError, match="not divisible by fixed axes product 2"):
        Trainer(_ckpt_cfg("unused", 8, 1).replace(mesh=MeshSpec(fsdp=2)), device="cpu")


def test_cpu_offload_needs_a_zero_stage():
    """Word for word the JAX package's contract, in the ZeRO module and
    through the Trainer."""
    with pytest.raises(ValueError) as jerr:
        jax_check_offload(True, 0)
    with pytest.raises(ValueError) as terr:
        check_cpu_offload(True, 0)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="cpu_offload requires a ZeRO stage"):
        Zero(0, cpu_offload=True)
    cfg = _ckpt_cfg("unused", 8, 1).replace(zero=ZeroConfig(stage=0, cpu_offload=True))
    with pytest.raises(ValueError, match="cpu_offload requires a ZeRO stage"):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("zero", [ZeroConfig(stage=1), ZeroConfig(stage=3),
                                  ZeroConfig(stage=2, cpu_offload=True)],
                         ids=["stage1", "stage3", "offload"])
def test_local_batchnorm_refuses_zero(zero):
    """``sync_batchnorm=False`` runs the explicit DP step, which has no ZeRO
    partition (the JAX Trainer refuses the same at any world)."""
    cfg = _ckpt_cfg("unused", 8, 1).replace(sync_batchnorm=False, zero=zero)
    with pytest.raises(NotImplementedError):
        Trainer(cfg, device="cpu")


def test_partition_rule_is_per_tensor_flat_and_padded():
    """Rank r of W owns elements [r c, (r + 1) c) of the flattened tensor,
    c = ceil(numel / W), the last shard padded with zeros; the shards of
    every rank put back together give the tensor."""
    t = torch.arange(10, dtype=torch.float32).reshape(2, 5)
    shards = []
    for rank in range(3):
        z = Zero(1)
        z.world = z.inner_size = 3
        z.rank = z.inner_rank = rank
        assert z.chunk(10) == 4
        shards.append(z.shard(t))
    assert [s.tolist() for s in shards] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 0, 0]]
    assert torch.equal(torch.cat(shards)[:10].view(2, 5), t)
    cl = torch.randn(2, 3, 4, 4).contiguous(memory_format=torch.channels_last)
    assert torch.equal(Zero(1).shard(cl), cl.reshape(-1))  # logical order, any layout
