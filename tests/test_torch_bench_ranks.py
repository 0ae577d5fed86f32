"""The port bench over the launcher's ranks, a tensor-parallel step's
host copies, and the teardown of the groups, on two gloo ranks.

One spawn of two ranks (``tests/torch_dist_worker.py``: ``_bench_legs``,
``_tp_clip_host_lists``) runs while this process computes the JAX
references:

- **The image leg** (``bench.image_step``) over the two ranks:
  ``resnet_micro`` in float32 (the bench's bf16 compute would not hold a
  tolerance), ``--batch-size 4`` a rank of one global batch of 8 made from
  ``RandomState(0)`` as the root bench makes it, ``--grad-accum 2`` and
  ``--zero-stage 1``. After two steps the ranks' parameters and BatchNorm
  statistics are equal (rtol 0, atol 0), and they match JAX's
  ``make_train_step`` on a two-device ``data`` mesh run on the same
  global batch from the same weights (the bench's seed-0 model carried
  over by ``bridge.py``) at rtol 2e-5, atol 1e-6 (for the elements near
  zero): SyncBN and the gradient mean sum in another order than XLA's.
- **The LM leg** (``bench.lm_step`` on ``bench.lm_mesh``) at ``--tp 1``
  over the two ranks is data-parallel: GPT cut to one layer of width 32
  (vocabulary 50304), float32, exact attention and float32 logits,
  ``--lm-batch 4`` global at T 8. Each step's loss matches JAX's
  ``make_tp_lm_train_step`` on a ``data 2 × model 1`` mesh on the global
  batch (rtol 2e-5), and the ranks end with equal weights.
- **The JSON lines** of ``bench.main`` for the image leg, the LM leg (at
  ``--tp 1``, and at ``--tp 2``, where each rank is alone in its data
  group) and ``--data-concurrent``: rank 0 alone prints each; the image leg's
  ``value`` is images/s a chip (its model FLOPs a second over it are two
  images' worth: the global batch is the chips' batches), the data leg's
  stress loader runs on rank 0's host alone and its metric says so.
- **The graph's host copies** (C12): a tensor-parallel GPT (model 2, ZeRO
  1) whose step clips to a norm that binds and reports ``grad_norm``
  builds no tensor from a Python list in its second step (the norms'
  masks are built once, on the first). A CUDA graph's capture refuses
  such a copy; this is the part of C12 the CPU can show.

A second spawn holds the teardown: five times in one process, the
straggler exchange's gloo group opened beside the default group (whose
backend reads as NCCL's, as on the card), one exchange over it, and
``shutdown_distributed``; every rank exits 0.

Runtime: ~25–45 s serial.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_dist_worker as worker

from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.parallel.sharding import place_state, state_shardings
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.train.lm_step import make_tp_lm_train_step
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.step import make_train_step
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.lm_step import make_lm_batch

torch.set_num_threads(1)

WORLD = 2
STEPS = 2
PER_RANK, SIZE, CLASSES, ACCUM, ZERO = 4, 16, 10, 2, 1
LM_BATCH, T, VOCAB = 4, 8, 50304
GPT_CUT = {"num_layers": 1, "num_heads": 2, "hidden_dim": 32}
RTOL, ATOL = 2e-5, 1e-6
CPU = ["--device", "cpu", "--warmup", "0", "--steps", "2", "--sync-interval", "1",
       "--steps-per-call", "1"]
IMAGE = ["--model", "resnet_micro", "--batch-size", str(PER_RANK), "--image-size",
         str(SIZE), "--num-classes", str(CLASSES), "--grad-accum", str(ACCUM),
         "--zero-stage", str(ZERO)]
LM = ["--lm-batch", str(LM_BATCH), "--seq-len", str(T), "--attn-impl", "exact",
      "--logits-dtype", "fp32"]
DATA = ["--data-images", "32", "--data-workers", "1", "--image-size", "32",
        "--batch-size", "4", "--model", "resnet_micro", "--steps", "3", "--warmup", "1"]


def _port_image_model():
    """The image leg's model as every rank builds it (seed 0), in float32."""
    return get_model("resnet_micro", num_classes=CLASSES, dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0), remat=False,
                     param_dtype=torch.float32)


def _port_gpt():
    """The LM leg's GPT as every rank builds it (seed 0), cut and float32."""
    from distributed_training_tpu_torch.train.lm_step import parse_logits_dtype

    return get_model("transformer_lm", num_classes=VOCAB, dtype=torch.float32,
                     max_len=T, attn_impl="exact", logits_dtype=parse_logits_dtype("fp32"),
                     head_bias=False, generator=torch.Generator().manual_seed(0), **GPT_CUT)


def _jax_image() -> dict:
    """The root bench's image step on a two-device data mesh, float32, from
    the port's seed-0 weights: the state after STEPS steps, as the port's
    state dict."""
    tm = _port_image_model()
    params, stats = bridge.state_dict_to_flax(tm)
    mesh = create_mesh(MeshConfig(data=WORLD), devices=jax.devices()[:WORLD])
    state = init_train_state(jax_model("resnet_micro", num_classes=CLASSES), jax.random.PRNGKey(0),
                             (PER_RANK * WORLD, SIZE, SIZE, 3), optax.sgd(0.1, momentum=0.9),
                             loss_scale=JLoss.create(JPrec(dtype="bf16")))
    state = state.replace(params=params, batch_stats=stats)
    state = place_state(state, state_shardings(state, mesh, zero_stage=ZERO))
    step = make_train_step(mesh, zero_stage=ZERO, donate=False, grad_accum_steps=ACCUM)
    rng = np.random.RandomState(0)  # the root bench's global batch
    images = rng.rand(PER_RANK * WORLD, SIZE, SIZE, 3).astype(np.float32)
    labels = rng.randint(0, CLASSES, PER_RANK * WORLD).astype(np.int32)
    batch = {"image": jnp.asarray(images), "label": jnp.asarray(labels)}
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    bridge.load_flax_variables(tm, jax.device_get(state.params),
                               jax.device_get(state.batch_stats))
    return {"losses": losses, "model": tm.state_dict()}


def _jax_lm() -> list:
    """The root bench's LM step on a ``data 2 × model 1`` mesh (AdamW
    3e-4), float32, from the port's seed-0 GPT: each step's loss."""
    tm = _port_gpt()
    jm = jax_model("transformer_lm", num_classes=VOCAB, max_len=T, attn_impl="exact",
                   logits_dtype=jnp.float32, head_bias=False, **GPT_CUT)
    state = init_train_state(jm, jax.random.PRNGKey(0), (1, 8), optax.adamw(3e-4),
                             loss_scale=JLoss.create(JPrec(dtype="bf16")),
                             input_dtype=jnp.int32)
    state = state.replace(params=bridge.named_to_flax_tree(tm, dict(tm.named_parameters())))
    mesh = create_mesh(MeshConfig(data=WORLD, model=1), devices=jax.devices()[:WORLD])
    step = make_tp_lm_train_step(mesh, model=jm, donate=False)
    toks = np.random.RandomState(0).randint(0, VOCAB, (LM_BATCH, T + 1)).astype(np.int32)
    batch = jax.device_put({k: jnp.asarray(v) for k, v in make_lm_batch(toks).items()},
                           step.batch_shardings)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench_ranks")
    torch.save({"dir": str(out), "bench_steps": STEPS,
                "bench_model": {"resnet_micro": {"dtype": torch.float32},
                                "transformer_lm": {**GPT_CUT, "dtype": torch.float32}},
                "bench_legs": {"image": [*CPU, *IMAGE], "lm": [*CPU, *LM]},
                "bench_lines": [[*CPU, "--image", *IMAGE], [*CPU, "--lm", *LM],
                                [*CPU[:2], "--data-concurrent", *DATA],
                                [*CPU, "--lm", *LM, "--tp", str(WORLD)]]},
               out / "job.pt")
    join = worker.spawn(out, WORLD, ("_bench_legs", "_tp_clip_host_lists"), timeout_s=200.0)
    try:
        ref = {"image": _jax_image(), "lm": _jax_lm()}
    finally:
        ranks = join()
    return {"ranks": ranks, "ref": ref}


def test_image_leg_ranks_hold_the_same_state(runs):
    a, b = (r["bench_legs"]["image"] for r in runs["ranks"])
    assert a["rows"] == b["rows"] == PER_RANK
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():
        torch.testing.assert_close(v, b["model"][k], rtol=0, atol=0, msg=k)
    assert a["losses"] == b["losses"]


def test_image_leg_matches_jax_data_parallel_step(runs):
    want = runs["ref"]["image"]
    for r in runs["ranks"]:
        got = r["bench_legs"]["image"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)
        for k, v in want["model"].items():
            if v.is_floating_point():  # the BatchNorm counters are integers
                torch.testing.assert_close(got["model"][k], v, rtol=RTOL, atol=ATOL, msg=k)


def test_lm_leg_at_tp1_is_data_parallel_and_matches_jax(runs):
    want = runs["ref"]["lm"]
    a, b = (r["bench_legs"]["lm"] for r in runs["ranks"])
    assert a["rows"] == b["rows"] == LM_BATCH // WORLD
    for got in (a, b):
        np.testing.assert_allclose(got["losses"], want, rtol=RTOL)
    for k, v in a["model"].items():
        torch.testing.assert_close(v, b["model"][k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("leg,unit", [(0, "images/sec/chip"), (1, "tokens/sec"),
                                      (2, "images/sec/chip"), (3, "tokens/sec")],
                         ids=["image", "lm", "data_concurrent", "lm_tp2"])
def test_rank0_alone_prints_each_leg(runs, leg, unit):
    first, second = (r["bench_legs"]["lines"][leg] for r in runs["ranks"])
    assert second["printed"] == []
    (line,) = first["printed"]
    (result, loss), = first["returned"]
    assert line == result and line["unit"] == unit and line["value"] > 0
    assert np.isfinite(loss)
    if leg == 0:
        # The model FLOPs a second count the global batch over the chips;
        # value, a chip's images/s, counts one chip's: two images' worth.
        per_image = worker_flops_per_image()
        assert line["model_flops_per_sec"] / line["value"] == pytest.approx(
            WORLD * per_image, rel=1e-3)
    if leg == 2:
        assert "concurrent stress loader on rank 0" in line["metric"]
        assert "spare_host_images_per_sec" in line
        assert "spare_host_images_per_sec" not in second["returned"][0][0]


def worker_flops_per_image() -> int:
    from distributed_training_tpu_torch.observability import forward_flops, train_step_flops

    return train_step_flops(forward_flops(_port_image_model(), image_size=SIZE, batch=1))


def test_tensor_parallel_clip_builds_no_tensor_from_a_host_list(runs):
    for r in runs["ranks"]:
        got = r["tp_clip"]
        assert got["lists"] == []
        assert got["masks"] >= 1  # built on the first step, reused on the second
        assert all(np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0.05
                   for m in got["metrics"])  # the clip binds


def test_host_group_teardown_five_times_every_rank_exits_0(tmp_path):
    """The host group opened beside the default group and shut down with
    it, five times in one spawn: the exchange's rows each time, and every
    rank exits 0 (``spawn``'s join raises on any other exit code)."""
    torch.save({"dir": str(tmp_path), "teardown_cycles": 5}, tmp_path / "job.pt")
    ranks = worker.spawn(tmp_path, WORLD, ("_teardown_cycles",), timeout_s=120.0)()
    for r in ranks:
        assert len(r["teardown"]) == 5
        for rows in r["teardown"]:
            np.testing.assert_array_equal(rows, [[0.0, 0.0], [1.0, 1.0]])


def test_image_leg_keeps_batchnorm_local_in_a_world_1_group(tmp_path):
    """Under a world-1 group (as ``chip_smoke.py`` opens NCCL's on one
    card) the image leg's gradients go through the group, but every
    BatchNorm keeps its own statistics, as ``torch.nn.SyncBatchNorm``
    does at world 1: a world-1 SyncBN only adds its all-reduces."""
    from distributed_training_tpu_torch import bench
    from distributed_training_tpu_torch.models.resnet import BatchNorm
    from distributed_training_tpu_torch.runtime import distributed

    group = distributed.initialize_distributed(
        init_method=f"file://{tmp_path}/store", world_size=1, rank=0, device="cpu")
    try:
        args = bench.build_parser().parse_args([*CPU, *IMAGE])
        model, state, _, batch = bench.image_step(args, torch.device("cpu"))
        assert state.zero.group is group
        norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
        assert norms and all(m.group is None for m in norms)
        assert len(batch["label"]) == PER_RANK
    finally:
        distributed.shutdown_distributed()
