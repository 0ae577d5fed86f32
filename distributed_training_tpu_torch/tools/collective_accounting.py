"""Per-strategy collective accounting of the port's train steps over N ranks.

The port of ``tools/collective_accounting.py``. For each parallel strategy
the JAX tool lists the collectives XLA compiled into one 8-device step;
this one runs one step of the port's own step on N ranks and counts the
``torch.distributed`` calls it makes (``utils/collectives.py``): kind,
count and bytes, beside the model's float32 gradient bytes. The rows are
the JAX tool's, under its names, built from the port's factories
(``make_train_step``, ``make_lm_train_step``, ``make_pp_lm_train_step``
over a ``runtime.mesh.Mesh``) with its micro models and shapes:
``resnet_micro`` (CIFAR stem, 8×8 images, 2·N rows), the 2-layer LM
(2 heads, width 16, vocabulary 32, ``max_len`` 64, tokens ``[N, 17]``),
ViT (patch 4, hidden 32, 2 layers, 2 heads, MLP 64), ``adam(1e-3)``,
float32, and the same mesh shapes (``data=N//2`` beside one axis of 2,
``data=N//4`` beside two).

    python -m distributed_training_tpu_torch.tools.collective_accounting \\
        --device cpu --ranks 8 --out profiles/torch_collectives_8rank
    python -m distributed_training_tpu_torch.tools.collective_accounting \\
        --ranks 4 --out profiles/torch_collectives_4gpu        # four cards, NCCL

It spawns ``--ranks`` processes, one world for every row: gloo on the CPU
with ``--device cpu``, else NCCL with one card a rank (it raises with
fewer cards). Rank 0 writes the JSON: ``devices`` (the ranks),
``platform`` and ``backend``, ``card`` (on the card), ``notes``, and
``strategies: {name: {mesh, grad_bytes_fp32, collectives}}``, where
``collectives`` is rank 0's; a row whose ranks differ adds ``per_rank``.
``--only`` rebuilds the rows whose name holds the string and implies
``--merge`` (start from the existing file and replace those rows).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import traceback

import numpy as np
import torch

VOCAB = 32
LM_KW = dict(num_classes=VOCAB, num_layers=2, num_heads=2, hidden_dim=16, max_len=64)
VIT_KW = dict(num_classes=10, patch_size=4, hidden_size=32, num_layers=2, num_heads=2,
              mlp_dim=64, image_size=8)
MOE_KW = dict(moe_num_experts=4, moe_top_k=1)

NOTES = [
    "dynamic call counts: each torch.distributed call one step makes counts "
    "once (utils/collectives.py), so the ring's 2·(n-1) hops a layer and "
    "direction are that many collective-permutes; JAX's counts are static, "
    "one op for a collective inside a loop body",
    "bytes are each call's output payload, as JAX's hlo.py sums output "
    "shapes: an all-reduce its tensor, an all-gather the gathered result, a "
    "reduce-scatter the shard it returns, a permute the tensor received, a "
    "broadcast its tensor",
    "ZeRO issues its own collectives, one call a step each on one flat "
    "buffer: stages 0-1 all-reduce the gradients, 2-3 reduce-scatter them "
    "(a true reduce-scatter, where XLA lowers the pattern to all-reduce + "
    "local slice and all-to-all), 1-2 all-gather the updated parameters and "
    "3 gathers them before the forward; the fsdp axis adds its own "
    "reduce-scatter and gathers",
    "MoE: each gate round all-gathers the data group's [D, E] per-expert "
    "token counts (models/moe.py) and the expert group sums the partial "
    "outputs with an all-reduce, where GSPMD emits psums of one-hot matmuls",
    "tensor parallelism: the megatron f/g all-reduces a block and direction "
    "and the vocab-parallel CE's three all-reduces; tp-overlap rows replace "
    "the block collectives by collective-permute rings (one permute a hop)",
    "pipeline: each stage hop is a batch_isend_irecv (one permute a "
    "microbatch, forward and backward), the last stage broadcasts the "
    "output to the stages for the CE (collective-broadcast), and the "
    "embeddings' gradient is summed over pipe",
    "collectives are rank 0's; a row whose ranks differ adds per_rank, every "
    "rank's (the pipeline's broadcast is a collective every stage calls, so "
    "its stages count alike)",
]


def _mesh(sizes: dict):
    from distributed_training_tpu_torch.config import MeshSpec
    from distributed_training_tpu_torch.runtime.mesh import Mesh

    return Mesh(MeshSpec(**sizes))


def _rows(x: np.ndarray, index: int, count: int) -> np.ndarray:
    n = x.shape[0] // count
    return x[index * n:(index + 1) * n]


def _lm_local(batch: dict, mesh, device) -> dict:
    """This rank's rows (its data shard) and time chunk (its sequence
    shard) of the global LM batch."""
    out = {}
    for k, v in batch.items():
        v = _rows(v, mesh.index("data"), mesh.size("data"))
        t = v.shape[1] // mesh.size("sequence")
        q = mesh.index("sequence")
        out[k] = torch.from_numpy(np.ascontiguousarray(v[:, q * t:(q + 1) * t])).to(device)
    return out


def _image_local(batch: dict, mesh, device) -> dict:
    """This rank's rows of the global image batch: its data × fsdp replica's."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        _rows(v, mesh.replica_index, mesh.data_size))).to(device) for k, v in batch.items()}


def _state(model, zero):
    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.train_state import TrainState

    return TrainState.create(model, make_optimizer(OptimizerConfig(name="adam", lr=1e-3)),
                             LossScaleState.create(PrecisionConfig(dtype="fp32")), zero)


def strategy_cases(world: int, only: str | None = None, device="cpu"):
    """Yield ``(name, mesh sizes above 1, accounting, grad_bytes_fp32)``
    for each row, on this rank of the open default group of ``world``
    ranks (a multiple of 4). Every rank must call it with the same
    arguments: each row opens its mesh's groups in the same order.

    ``only`` (a substring) skips the other rows before building them.
    Each row runs one counted step from seeded weights; the state then
    advances one step, which no row reuses."""
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.models.moe import MoEContext, shard_experts_
    from distributed_training_tpu_torch.models.resnet import set_batchnorm_group
    from distributed_training_tpu_torch.parallel.pipeline import PipelinedLM
    from distributed_training_tpu_torch.parallel.tensor_parallel import (
        ExpertParallel,
        TensorParallel,
        shard_model_,
    )
    from distributed_training_tpu_torch.parallel.zero import Zero
    from distributed_training_tpu_torch.train.lm_step import (
        make_lm_batch,
        make_lm_train_step,
        make_pp_lm_train_step,
    )
    from distributed_training_tpu_torch.train.step import make_train_step
    from distributed_training_tpu_torch.train.train_state import param_count
    from distributed_training_tpu_torch.utils.collectives import step_collectives

    if world % 4:
        raise ValueError(f"the rows need a multiple of 4 ranks, got {world}")
    device = torch.device(device)
    meshes: dict = {}

    def want(name: str) -> bool:
        return only is None or only in name

    def mesh_of(**sizes):
        key = tuple(sorted(sizes.items()))
        if key not in meshes:  # every rank opens the same groups in turn
            meshes[key] = _mesh(sizes)
        return meshes[key]

    def gen():
        return torch.Generator().manual_seed(0)

    def shape(mesh) -> dict:
        return {a: s for a, s in mesh.sizes.items() if s > 1}

    tokens = np.random.RandomState(0).randint(0, VOCAB, (world, 17)).astype(np.int64)
    lm_batch = make_lm_batch(tokens)
    rng = np.random.RandomState(0)
    image_batch = {"image": rng.rand(2 * world, 8, 8, 3).astype(np.float32),
                   "label": rng.randint(0, 10, 2 * world).astype(np.int64)}
    rng = np.random.RandomState(0)
    vit_batch = {"image": rng.rand(world, 8, 8, 3).astype(np.float32),
                 "label": rng.randint(0, 10, world).astype(np.int64)}

    # Image DP and ZeRO (the reference's own strategies); SyncBN over the
    # replica group, as the Trainer sets it.
    for name, sizes, stage in (("image dp (zero-0)", dict(data=-1), 0),
                               ("image dp×fsdp zero-1", dict(data=-1, fsdp=2), 1),
                               ("image dp zero-3", dict(data=-1), 3)):
        if not want(name):
            continue
        mesh = mesh_of(**sizes)
        model = get_model("resnet_micro", num_classes=10, stem="cifar", generator=gen())
        grad_bytes = 4 * param_count(model)
        group = mesh.group("data", "fsdp", "sequence")
        set_batchnorm_group(model, group)
        state = _state(model.to(device), Zero(stage, group, fsdp=mesh.group("fsdp"),
                                              inner=mesh.group("data", "sequence")))
        acct = step_collectives(make_train_step(zero_stage=stage), state,
                                _image_local(image_batch, mesh, device))
        yield name, shape(mesh), acct, grad_bytes

    def lm_case(mesh, stage: int = 0, overlap: bool = False, **model_kw):
        seq = {"seq_axis": "sequence"} if mesh.size("sequence") > 1 else {}
        model = get_model("transformer_lm", mesh=mesh, generator=gen(),
                          **{**LM_KW, **model_kw}, **seq)
        grad_bytes = 4 * param_count(model)
        tp = TensorParallel.from_mesh(mesh, overlap=overlap)
        shard_model_(model, tp)
        shard_experts_(model, MoEContext.from_mesh(mesh))
        state = _state(model.to(device), Zero(stage, mesh.group("data", "sequence"), tp=tp,
                                              ep=ExpertParallel.from_mesh(mesh)))
        step = make_lm_train_step(zero_stage=stage, max_len=LM_KW["max_len"])
        return step_collectives(step, state, _lm_local(lm_batch, mesh, device)), grad_bytes

    def pp_case(mesh, stage: int = 0, virtual: int = 1, **model_kw):
        seq = {"seq_axis": "sequence"} if mesh.size("sequence") > 1 else {}
        model = get_model("transformer_lm", mesh=mesh, generator=gen(),
                          **{**LM_KW, **model_kw}, **seq)
        grad_bytes = 4 * param_count(model)
        model = PipelinedLM(model, num_microbatches=2, virtual_stages=virtual, mesh=mesh)
        tp = TensorParallel.from_mesh(mesh)
        shard_model_(model, tp)
        shard_experts_(model, MoEContext.for_pipeline(mesh))
        state = _state(model.to(device), Zero(stage, mesh.group("data", "sequence"), tp=tp,
                                              ep=ExpertParallel.from_mesh(mesh),
                                              pp=model.stage))
        step = make_pp_lm_train_step(zero_stage=stage, max_len=LM_KW["max_len"])
        return step_collectives(step, state, _lm_local(lm_batch, mesh, device)), grad_bytes

    half, quarter = world // 2, world // 4
    lm_rows = (
        ("lm dp×tp zero-1", dict(data=half, model=2), lm_case, dict(stage=1)),
        # The ring-overlapped TP schedule on the same model; stage 0 keeps
        # the signature clean of ZeRO's own all-gather.
        ("lm dp×tp overlap", dict(data=half, model=2), lm_case, dict(overlap=True)),
        ("lm dp×pp (gpipe)", dict(data=half, pipe=2), pp_case, {}),
        ("lm dp×pp zero-1", dict(data=half, pipe=2), pp_case, dict(stage=1)),
        ("lm dp×pp circular (v=2)", dict(data=half, pipe=2), pp_case,
         dict(virtual=2, num_layers=4)),
        ("lm dp×ep (moe)", dict(data=half, expert=2), lm_case, MOE_KW),
        ("lm dp×pp×ep zero-1 (moe stages)", dict(data=quarter, pipe=2, expert=2), pp_case,
         dict(stage=1, moe_every=1, **MOE_KW)),
        ("lm dp×pp×sp zero-1 (ring-in-stage)", dict(data=quarter, pipe=2, sequence=2),
         pp_case, dict(stage=1)),
    )
    for name, sizes, case, kw in lm_rows:
        if want(name):
            mesh = mesh_of(**sizes)
            yield (name, shape(mesh), *case(mesh, **kw))

    # ViT over the model axis: the megatron placement, plain at ZeRO 1 and
    # ring-overlapped at stage 0.
    for name, stage, overlap in (("image vit dp×tp zero-1", 1, False),
                                 ("image vit dp×tp overlap", 0, True)):
        if not want(name):
            continue
        mesh = mesh_of(data=half, model=2)
        model = get_model("vit_b16", generator=gen(), **VIT_KW)
        grad_bytes = 4 * param_count(model)
        tp = TensorParallel.from_mesh(mesh, overlap=overlap)
        shard_model_(model, tp)
        state = _state(model.to(device), Zero(stage, mesh.group("data", "fsdp", "sequence"),
                                              tp=tp))
        acct = step_collectives(make_train_step(zero_stage=stage), state,
                                _image_local(vit_batch, mesh, device))
        yield name, shape(mesh), acct, grad_bytes

    sp_rows = (
        ("lm dp×sp (ring)", dict(data=half, sequence=2), {}),
        ("lm dp×sp zero-1", dict(data=half, sequence=2), dict(stage=1)),
        ("lm dp×sp×tp", dict(data=quarter, sequence=2, model=2), {}),
        # The K/V ring over sequence and the matmul rings over model.
        ("lm dp×sp×tp overlap", dict(data=quarter, sequence=2, model=2), dict(overlap=True)),
        ("lm dp×sp×ep", dict(data=quarter, sequence=2, expert=2), MOE_KW),
    )
    for name, sizes, kw in sp_rows:
        if want(name):
            mesh = mesh_of(**sizes)
            yield (name, shape(mesh), *lm_case(mesh, **kw))


def run_rows(world: int, only: str | None, device) -> dict:
    """Every row of :func:`strategy_cases` on this rank of the open group;
    returns the rows (on every rank) with rank 0's accounting and, where
    the ranks differ, ``per_rank``."""
    import torch.distributed as dist

    rows = {}
    for name, mesh_shape, acct, grad_bytes in strategy_cases(world, only, device):
        every = [None] * world
        dist.all_gather_object(every, acct)
        row = {"mesh": mesh_shape, "grad_bytes_fp32": grad_bytes, "collectives": every[0]}
        if any(a != every[0] for a in every):
            row["per_rank"] = every
        rows[name] = row
        if dist.get_rank() == 0:
            print(f"{name:36s} {acct}", flush=True)
    return rows


def _rank(rank: int, world: int, device: str, store: str, only: str | None,
          out_dir: str) -> None:
    """One spawned rank: open the group, run every row, rank 0 saves them."""
    from distributed_training_tpu_torch.runtime import distributed

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        distributed.initialize_distributed(
            init_method=f"file://{store}", world_size=world, rank=rank,
            local_rank=rank, device=device if device == "cpu" else None)
        dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", rank)
        rows = run_rows(world, only, dev)
        if rank == 0:
            torch.save(rows, os.path.join(out_dir, "rows.pt"))
        distributed.shutdown_distributed()
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn_rows(world: int, device: str, only: str | None = None,
               timeout_s: float = 900.0) -> dict:
    """Run :func:`run_rows` on ``world`` spawned ranks (a ``file://``
    store in a temporary directory); returns rank 0's rows, or raises with
    the failed ranks' tracebacks."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank, args=(r, world, device,
                                                 os.path.join(tmp, "store"), only, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout_s)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        errors = [open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp))
                  if f.startswith("error_")]
        if hung or errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"{len(hung)} rank(s) hung, exit codes "
                               f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))
        return torch.load(os.path.join(tmp, "rows.pt"), weights_only=False)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="profiles/torch_collectives_8rank",
                    help="the JSON's path without .json")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one card a rank; cpu: gloo")
    ap.add_argument("--only", default=None,
                    help="rebuild only the rows whose name holds this substring "
                         "(implies --merge)")
    ap.add_argument("--merge", action="store_true", default=False,
                    help="start from the existing file and replace only the rebuilt rows")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Write the JSON (see the module docstring); returns the report."""
    args = build_parser().parse_args(argv)
    if args.only and not args.merge:
        # Without --merge a partial run would drop every other committed row.
        print("--only implies --merge (a partial regeneration must not drop the "
              "other committed rows)", file=sys.stderr)
        args.merge = True
    report = {"devices": args.ranks, "notes": NOTES, "strategies": {}}
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            raise RuntimeError(f"--ranks {args.ranks} needs {args.ranks} CUDA devices, "
                               f"have {torch.cuda.device_count()}; pass --device cpu "
                               f"for gloo ranks on the CPU")
        from distributed_training_tpu_torch.utils.device import card_line

        report.update(platform="cuda", backend="nccl", card=card_line())
    else:
        report.update(platform="cpu", backend="gloo")
    path = args.out + ".json"
    if args.merge and os.path.exists(path):
        with open(path) as fh:
            report["strategies"] = json.load(fh)["strategies"]
    report["strategies"].update(spawn_rows(args.ranks, args.device, args.only))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)
    print(f"wrote {path}")
    return report


if __name__ == "__main__":
    main()
