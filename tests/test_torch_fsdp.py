"""The ``fsdp`` mesh axis in the port's trainers (gloo ranks on the CPU,
``tests/torch_dist_worker.py``) against the JAX package's steps on CPU
meshes of the same ``data × fsdp`` shape.

JAX's meaning of the axis (``parallel/sharding.py`` ``zero_stage_axes``):
it always shards the parameters and the optimizer state, and the
replica count is ``data × fsdp``. The image step splits the batch over
``(data, fsdp)`` (``batch_sharding``), its local-BN shard_map step over
``data`` alone, and every LM strategy over ``data`` alone, so there the
fsdp ranks of a data index run the same rows and their gradients'
mean over ``data × fsdp`` is the data ranks' mean.

Each case builds the ``Trainer`` or ``LMTrainer`` as a user builds it,
loads the initial weights (the port's seeded init, the same in JAX's
trees through ``bridge.py``), runs two steps on
its own loader's rows with ``observability.grad_norm`` on, and is held
against JAX's step over the same global batches:

- two ranks: ``resnet_micro`` at fsdp 2 (SyncBN, ZeRO 0) and with two
  accumulation microbatches (JAX's microbatch order); the LM at fsdp 2,
  ZeRO 0 (saved, and the save resumed at world 1 here), ZeRO 3 and ZeRO 1
  with ``cpu_offload`` (held against JAX's ZeRO 1 step without it: JAX's
  offload only places the state in pinned host memory, which XLA's CPU
  backend cannot partition);
- four ranks: ``resnet_micro`` at data 2 × fsdp 2 (ZeRO 1), fsdp 4
  (ZeRO 3) and local BN at data 2 × fsdp 2; the LM at data 2 × fsdp 2
  (ZeRO 1, a clip of 0.05 that binds; and with two accumulation
  microbatches), fsdp 2 × model 2, fsdp 2 × sequence 2 (the ring), fsdp
  2 × pipe 2 (ZeRO 1, two microbatches) and MoE at fsdp 2 × expert 2 (4
  experts, top-1, capacity factor 0.5, so tokens drop); ViT at fsdp 2 ×
  model 2 under ``tp_overlap`` (its mean over data × fsdp; dropout 0,
  since the port's masks are not JAX's bits); the ``moe_mlp`` image model
  at fsdp 2 × expert 2 (the gate over data × fsdp, as JAX's GSPMD step
  scopes it); and two configs that JAX's trainer refuses there (ZeRO 3
  under the pipeline, ZeRO 1 under the expert axis without
  ``moe_param_group``), refused with JAX's type and message.

Tolerances are ``tests/torch_lm_mesh.py``'s: metrics rtol 1e-5 (the grad
norm 1e-4: ResNet's float32 norm of ~17 sums 79k squares in another
order), parameters and BatchNorm statistics atol 1e-5, Adam's moments
1e-4 of each tensor's largest magnitude (1e-3 under local BN: per-shard
statistics leave some BatchNorm leaves with gradients of ~1e-6, the
float32 rounding of sums of far larger terms, and the port at data 2
without fsdp reads the same against JAX; 3e-4 for ResNet under
accumulation: two-row microbatches through SyncBN, whose float32
rounding moves single elements near 1e-4 even at world 1 without fsdp;
ViT's key bias, whose gradient
is zero in exact arithmetic, is held to 1e-8 and 1e-16 absolute, as in
``tests/test_torch_vit_tp.py``). The second moments scale with
the square of a gradient, so a sum over ``fsdp`` where JAX averages fails
them, and the grad norm, by F (checked apart). Each rank holds ``1/F`` of
the parameters and of the moments (``1/(D·F)`` of the moments from ZeRO 1
and of both at ZeRO 3), to the flat rule's padding.
"""

import concurrent.futures
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
import torch_lm_mesh as lmm

from distributed_training_tpu import config as jcfg
from distributed_training_tpu.config import OptimizerConfig as JOpt
from distributed_training_tpu.config import PrecisionConfig as JPrec
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.parallel.sharding import place_state, state_shardings
from distributed_training_tpu.train.lm_step import (
    make_lm_train_step,
    make_pp_lm_train_step,
    make_tp_lm_train_step,
)
from distributed_training_tpu.train.optim import make_optimizer as jmake
from distributed_training_tpu.train.precision import LossScaleState as JLoss
from distributed_training_tpu.train.step import make_shard_map_train_step
from distributed_training_tpu.train.step import make_train_step as jax_image_step
from distributed_training_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from distributed_training_tpu.parallel.tensor_parallel import tp_state_shardings
from distributed_training_tpu.train.train_state import TrainState as JState
from distributed_training_tpu.train.train_state import init_train_state
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch import checkpoint as ckpt_lib
from distributed_training_tpu_torch.config import (
    DataConfig,
    effective_batch_sizes,
    LMConfig,
    MeshSpec,
    MoEConfig,
    ObservabilityConfig,
    OptimizerConfig,
    PrecisionConfig,
    TrainConfig,
    ZeroConfig,
)
from distributed_training_tpu_torch.data.lm_text import TokenLoader, synthetic_tokens
from distributed_training_tpu_torch.data.pipeline import build_dataloaders
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.train.lm_step import make_lm_batch
from distributed_training_tpu_torch.train.optim import make_optimizer
from distributed_training_tpu_torch.train.precision import LossScaleState
from distributed_training_tpu_torch.train.train_state import TrainState

torch.set_num_threads(1)

T, PER_RANK, MICRO = 32, 2, 2
LM = dict(num_classes=64, num_layers=2, num_heads=4, hidden_dim=32, max_len=64)
MOE = dict(moe_num_experts=4, moe_top_k=1, moe_capacity_factor=0.5)
CLIP = lmm.opt(grad_clip_norm=0.05)
# The ViT and moe_mlp image models, cut (tests/test_torch_vit_tp.py's ViT,
# tests/test_torch_moe_parallel.py's moe_mlp).
VIT_KW = dict(patch_size=8, hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128)
VIT_CLASSES = 12
MIMG_KW = dict(hidden_size=32, num_layers=2, mlp_hidden=64)
MIMG_MOE = MoEConfig(enabled=True, num_experts=(4,), top_k=1, capacity_factor=0.5)
# name: (kind, mesh, zero stage, optimizer, the rest of the config); kind
# "img", "lbn" (local BN), "vit", "mimg" (moe_mlp), "lm", "moe" or "pp";
# the rest: "accum" (gradient_accumulation_steps), "cpu_offload",
# "tp_overlap".
CASES = {
    2: {"img_f2": ("img", {"data": 1, "fsdp": 2}, 0, lmm.opt(), {}),
        "lm_f2": ("lm", {"data": 1, "fsdp": 2}, 0, lmm.opt(), {}),
        "lm_f2_zero3": ("lm", {"data": 1, "fsdp": 2}, 3, lmm.opt(), {}),
        "img_f2_accum2": ("img", {"data": 1, "fsdp": 2}, 0, lmm.opt(), {"accum": 2}),
        "lm_f2_zero1_offload": ("lm", {"data": 1, "fsdp": 2}, 1, lmm.opt(),
                                {"cpu_offload": True})},
    4: {"img_d2f2_zero1": ("img", {"data": 2, "fsdp": 2}, 1, lmm.opt(), {}),
        "img_f4_zero3": ("img", {"data": 1, "fsdp": 4}, 3, lmm.opt(), {}),
        "lbn_d2f2": ("lbn", {"data": 2, "fsdp": 2}, 0, lmm.opt(), {}),
        "lm_d2f2_zero1": ("lm", {"data": 2, "fsdp": 2}, 1, CLIP, {}),
        "lm_f2m2": ("lm", {"data": 1, "fsdp": 2, "model": 2}, 0, lmm.opt(), {}),
        "lm_f2s2": ("lm", {"data": 1, "fsdp": 2, "sequence": 2}, 0, lmm.opt(), {}),
        "pp_f2p2_zero1": ("pp", {"data": 1, "fsdp": 2, "pipe": 2}, 1, lmm.opt(), {}),
        "moe_f2e2": ("moe", {"data": 1, "fsdp": 2, "expert": 2}, 0, lmm.opt(), {}),
        "lm_d2f2_zero1_accum2": ("lm", {"data": 2, "fsdp": 2}, 1, lmm.opt(), {"accum": 2}),
        "vit_f2m2_overlap": ("vit", {"data": 1, "fsdp": 2, "model": 2}, 0, lmm.opt(),
                             {"tp_overlap": True}),
        "mimg_f2e2": ("mimg", {"data": 1, "fsdp": 2, "expert": 2}, 0, lmm.opt(), {})},
}
IMAGE_KINDS = ("img", "lbn", "vit", "mimg")
OBS = ObservabilityConfig(grad_norm=True)
# What JAX's LMTrainer refuses on an fsdp mesh (four ranks): ZeRO 3 under
# the pipeline, and ZeRO 1 under an expert axis without moe_param_group.
REFUSED = {"pp_f2p2_zero3": ("pp", {"data": 1, "fsdp": 2, "pipe": 2}, 3, lmm.opt(), {}),
           "moe_f2e2_zero1": ("moe", {"data": 1, "fsdp": 2, "expert": 2}, 1, lmm.opt(),
                              {})}


def _cfg(kind: str, mesh: dict, stage: int, opt: dict, extra: dict) -> TrainConfig:
    common = dict(num_epochs=1, optimizer=OptimizerConfig(**opt), mesh=MeshSpec(**mesh),
                  zero=ZeroConfig(stage=stage, cpu_offload=extra.get("cpu_offload", False)),
                  gradient_accumulation_steps=extra.get("accum", 1),
                  tp_overlap=extra.get("tp_overlap", False), observability=OBS)
    if kind in IMAGE_KINDS:
        model = {"vit": "vit_b16", "mimg": "moe_mlp"}.get(kind, "resnet_micro")
        return TrainConfig(model=model, sync_batchnorm=kind != "lbn",
                           moe=MIMG_MOE if kind == "mimg" else MoEConfig(),
                           data=DataConfig(dataset="synthetic_cifar", batch_size=PER_RANK,
                                           num_classes=VIT_CLASSES if kind == "vit" else 10,
                                           augment="none"), **common)
    return TrainConfig(
        model="transformer_lm",
        moe=MoEConfig(enabled=kind == "moe", num_experts=(4,), top_k=1,
                      capacity_factor=0.5),
        lm=LMConfig(seq_len=T, vocab_size=64, num_layers=2, num_heads=4, hidden_dim=32,
                    max_len=64, train_sequences=64, logits_dtype="fp32",
                    num_microbatches=MICRO if kind == "pp" else 1),
        data=DataConfig(batch_size=PER_RANK), **common)


def _replicas(mesh: dict) -> int:
    return mesh.get("data", 1) * mesh.get("fsdp", 1)


def _global_batches(cfg: TrainConfig) -> list[dict]:
    """The global batches of the trainer's loader, at one process: the
    image Trainer counts every rank's batch, the LM trainer each replica's
    (both times the accumulation steps)."""
    sizes = cfg.mesh.__dict__
    image = cfg.model != "transformer_lm"
    world = int(np.prod(list(sizes.values()))) if image else _replicas(sizes)
    gbs = effective_batch_sizes(cfg, world)[0]
    if image:
        loader, _ = build_dataloaders(cfg, seed=cfg.seed, global_batch_size=gbs,
                                      process_index=0, process_count=1)
        loader.set_epoch(0)
        return [b for b, _ in zip(loader, range(lmm.STEPS))]
    lm = cfg.lm
    loader = TokenLoader(synthetic_tokens(lm.train_sequences, lm.seq_len, lm.vocab_size,
                                          seed=cfg.seed),
                         global_batch_size=gbs, shuffle=True, seed=cfg.seed)
    return [make_lm_batch(b["tokens"]) for b, _ in zip(loader, range(lmm.STEPS))]


def _jax_lm(sizes: dict, kind: str):
    return jax_model("transformer_lm", logits_dtype=jnp.float32,
                     seq_axis="sequence" if sizes.get("sequence", 1) > 1 else None,
                     moe_expert_axis="expert" if sizes.get("expert", 1) > 1 else None,
                     **LM, **(MOE if kind == "moe" else {}))


def _tx(opt: dict):
    return jmake(JOpt(**{**opt, "name": "adam"}))


def _jax_image(kind: str, sizes: dict, stage: int, opt: dict, extra: dict, istate,
               data) -> dict:
    mesh = lmm.jax_mesh(**sizes)
    state = istate.replace(tx=_tx(opt), opt_state=_tx(opt).init(istate.params))
    accum = extra.get("accum", 1)
    if kind == "lbn":
        step = make_shard_map_train_step(mesh, donate=False, grad_norm_metric=True,
                                         grad_accum_steps=accum)
    else:
        # The JAX Trainer's GSPMD step and placement (train/trainer.py).
        tp = kind == "vit" and sizes.get("model", 1) > 1
        overlap = extra.get("tp_overlap", False) and tp
        step = jax_image_step(mesh, zero_stage=stage, donate=False, grad_norm_metric=True,
                              grad_accum_steps=accum, tensor_parallel=tp, tp_overlap=overlap)
        shardings = (tp_state_shardings(state, mesh, stage, overlap=overlap) if tp
                     else state_shardings(state, mesh, stage))
        state = place_state(state, shardings)
    metrics = []
    for b in data:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        jax.random.PRNGKey(1))
        metrics.append({k: float(v) for k, v in m.items()})
    adam = next(s for s in jax.tree_util.tree_leaves(
        jax.device_get(state.opt_state), is_leaf=lambda x: hasattr(x, "nu"))
        if hasattr(s, "nu"))
    return {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats),
            "mu": adam.mu, "nu": adam.nu, "metrics": metrics, "step": int(state.step)}


def _jax_lm_run(kind: str, sizes: dict, stage: int, opt: dict, extra: dict, setup,
                data) -> dict:
    mesh = lmm.jax_mesh(**sizes)
    jm = _jax_lm(sizes, kind)
    if kind == "pp":
        step = make_pp_lm_train_step(mesh, model=jm, num_microbatches=MICRO,
                                     zero_stage=stage, donate=False, grad_norm_metric=True)
        state = JState.create(apply_fn=step.pipelined.apply_fn, params=setup["pp_params"],
                              tx=_tx(opt), loss_scale=JLoss.create(JPrec()))
        ref = lmm.run_jax(step, state, data)
        ref["order"] = step.pipelined.layer_order
        return ref
    make = make_lm_train_step if sizes.get("sequence", 1) > 1 else make_tp_lm_train_step
    # cpu_offload is placement alone in JAX (the state in pinned host
    # memory), which XLA's CPU backend cannot partition: the reference runs
    # the same arithmetic in device memory.
    step = make(mesh, model=jm, zero_stage=stage, donate=False, grad_norm_metric=True,
                grad_accum_steps=extra.get("accum", 1))
    base = setup["moe_state"] if kind == "moe" else setup["lm_state"]
    state = base.replace(apply_fn=jm.apply, tx=_tx(opt), opt_state=_tx(opt).init(base.params))
    return lmm.run_jax(step, state, data)


@pytest.fixture(scope="module")
def setup():
    """The initial weights, made by the port's seeded init and carried into
    JAX's trees through ``bridge.py`` (the pipeline's from JAX's stacked
    init, carried the other way)."""
    out = {}
    for kind, extra in (("lm", {}), ("moe", MOE)):
        jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM, **extra)
        tm = get_model("transformer_lm", generator=torch.Generator().manual_seed(0),
                       **LM, **extra)
        params, _ = bridge.state_dict_to_flax(tm)
        out[f"{kind}_state"] = JState.create(apply_fn=jm.apply, params=params,
                                             tx=_tx(lmm.opt()), loss_scale=JLoss.create(JPrec()))
        out[kind] = tm.state_dict()
    pp = make_pp_lm_train_step(lmm.jax_mesh(data=1, fsdp=2, pipe=2), model=_jax_lm({}, "lm"),
                               num_microbatches=MICRO, donate=False)
    out["pp_params"] = jax.device_get(pp.pipelined.init_params(jax.random.PRNGKey(0)))
    tm = get_model("transformer_lm", **LM)
    bridge.load_flax_pipeline(tm, out["pp_params"], pp.pipelined.layer_order)
    out["pp"] = tm.state_dict()
    jimg = jax_model("resnet_micro", num_classes=10)
    timg = get_model("resnet_micro", generator=torch.Generator().manual_seed(0))
    params, stats = bridge.state_dict_to_flax(timg)
    out["img_state"] = JState.create(apply_fn=jimg.apply, params=params, tx=_tx(lmm.opt()),
                                     batch_stats=stats, loss_scale=JLoss.create(JPrec()))
    out["img"] = out["lbn"] = timg.state_dict()
    # ViT from JAX's init, its zero head replaced by a random one so that
    # every leaf moves (tests/test_torch_vit_tp.py); moe_mlp from JAX's.
    jvit = jax_model("vit_b16", num_classes=VIT_CLASSES, **VIT_KW)
    vstate = init_train_state(jvit, jax.random.PRNGKey(0), (1, 32, 32, 3), _tx(lmm.opt()),
                              loss_scale=JLoss.create(JPrec()))
    params = jax.device_get(vstate.params)
    params["head"]["kernel"] = np.random.RandomState(5).randn(
        *params["head"]["kernel"].shape).astype(np.float32) * 0.1
    out["vit_state"] = vstate.replace(params=params)
    tvit = get_model("vit_b16", num_classes=VIT_CLASSES, image_size=32, **VIT_KW)
    bridge.load_flax_variables(tvit, params)
    out["vit"] = tvit.state_dict()
    out["mimg_state"] = init_train_state(_jax_mimg(), jax.random.PRNGKey(0), (1, 32, 32, 3),
                                         _tx(lmm.opt()), loss_scale=JLoss.create(JPrec()))
    tmimg = get_model("moe_mlp", **_mimg_kw())
    bridge.load_flax_variables(tmimg, jax.device_get(out["mimg_state"].params))
    out["mimg"] = tmimg.state_dict()
    return out


def _mimg_kw() -> dict:
    """The moe_mlp model's arguments as both Trainers pass them."""
    m = MIMG_MOE
    return dict(num_classes=10, num_experts=tuple(m.num_experts), top_k=m.top_k,
                capacity_factor=m.capacity_factor, min_capacity=m.min_capacity,
                noisy_gate_policy=m.noisy_gate_policy, mlp_type=m.mlp_type, **MIMG_KW)


def _jax_mimg(expert: bool = False):
    return jax_model("moe_mlp", expert_axis="expert" if expert else None, **_mimg_kw())


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """Both spawns, started together, then the JAX references here."""
    joins, dirs = {}, {}
    for world in (2, 4):
        d = dirs[world] = tmp_path_factory.mktemp(f"fsdp{world}")
        cases = {**CASES[world], **(REFUSED if world == 4 else {})}
        steps = {name: {"cfg": _cfg(*case), "weights": setup[case[0]],
                        "model_kw": {"vit": VIT_KW, "mimg": MIMG_KW}.get(case[0], {}),
                        "steps": lmm.STEPS, "save": name == "lm_f2"}
                 for name, case in cases.items()}
        torch.save({"trainer_steps": steps, "dir": str(d)}, d / "job.pt")
        joins[world] = worker.spawn(d, world, ("_trainer_steps",), timeout_s=300.0)
    def reference(kind, sizes, stage, opt, extra):
        data = _global_batches(_cfg(kind, sizes, stage, opt, extra))
        if kind not in IMAGE_KINDS:
            return _jax_lm_run(kind, sizes, stage, opt, extra, setup, data)
        istate = setup[f"{kind if kind in ('vit', 'mimg') else 'img'}_state"]
        if kind == "mimg":
            istate = istate.replace(apply_fn=_jax_mimg(sizes.get("expert", 1) > 1).apply)
        return _jax_image(kind, sizes, stage, opt, extra, istate, data)

    t0 = time.perf_counter()
    try:
        # XLA compiles outside the interpreter lock: side by side.
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            futures = {name: pool.submit(reference, *case)
                       for world in (2, 4) for name, case in CASES[world].items()}
            ref = {name: f.result() for name, f in futures.items()}
        ref["refused"] = {name: _jax_refusal(_cfg(*case)) for name, case in REFUSED.items()}
        t1 = time.perf_counter()
    finally:
        ranks = {w: join() for w, join in joins.items()}
    print(f"jax refs {t1 - t0:.1f} s, ranks {time.perf_counter() - t0:.1f} s")
    return {"ranks": ranks, "ref": ref, "dirs": dirs}


def _to_jax(obj):
    """A port config dataclass as the JAX package's class of that name."""
    if not dataclasses.is_dataclass(obj):
        return obj
    return getattr(jcfg, type(obj).__name__)(**{
        f.name: _to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def _jax_refusal(cfg: TrainConfig):
    """JAX's ``LMTrainer`` exception for ``cfg`` on the mesh it names."""
    sizes = {k: v for k, v in dataclasses.asdict(cfg.mesh).items() if v != 1}
    try:
        JaxLMTrainer(_to_jax(cfg), mesh=lmm.jax_mesh(**sizes))
    except (NotImplementedError, ValueError) as e:
        return (type(e).__name__, str(e))
    return None


def _kw(kind: str) -> tuple[str, dict]:
    if kind == "vit":
        return "vit_b16", dict(num_classes=VIT_CLASSES, image_size=32, **VIT_KW)
    if kind == "mimg":
        return "moe_mlp", _mimg_kw()
    if kind in IMAGE_KINDS:
        return "resnet_micro", {}
    return "transformer_lm", {**LM, **(MOE if kind == "moe" else {})}


def _assert_matches(res: dict, ref: dict, kind: str, accum: int = 1) -> None:
    for got, want in zip(res["metrics"], ref["metrics"]):
        assert "grad_norm" in got and "grad_norm" in want
        for k in set(want) & set(got):
            np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                       rtol=1e-4 if k == "grad_norm" else 1e-5)
    assert res["step"] == ref["step"] == lmm.STEPS
    model, kw = _kw(kind)
    tm = get_model(model, **kw)
    tm.load_state_dict(res["state"]["model"])
    params, stats = bridge.state_dict_to_flax(tm)
    want = {k: ref[k] for k in ("params", "mu", "nu")}
    if kind == "pp":
        from distributed_training_tpu.parallel.pipeline import unstack_block_params

        want = {k: unstack_block_params(v["blocks"], {n: x for n, x in v.items()
                                                      if n != "blocks"},
                                        layer_order=ref["order"])
                for k, v in want.items()}
    jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                 want["params"], params)
    if "batch_stats" in ref:
        jax.tree.map(lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-5),
                     ref["batch_stats"], stats)
    moment_tol = 1e-3 if kind == "lbn" else 3e-4 if kind == "img" and accum > 1 else 1e-4
    for key, floor in (("mu", 1e-8), ("nu", 1e-16)):
        def close(path, a, b, floor=floor, key=key):
            where = f"{key} {'/'.join(k.key for k in path)}"
            zero = kind == "vit" and "key/bias" in where
            atol = floor if zero else moment_tol * np.abs(np.asarray(a)).max()
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=atol, err_msg=where)
        jax.tree_util.tree_map_with_path(
            close, want[key], bridge.named_to_flax_tree(tm, res["state"]["opt_state"][key]))


ALL = [(w, n) for w in (2, 4) for n in CASES[w]]


@pytest.mark.parametrize("world,name", ALL, ids=[n for _, n in ALL])
def test_fsdp_step_matches_jax_on_the_same_mesh(runs, world, name):
    """Two steps of each trainer over its own loader's rows end, on every
    rank, with the whole state and metrics of JAX's step on the matching
    ``data × fsdp`` mesh."""
    kind, extra = CASES[world][name][0], CASES[world][name][4]
    for r in runs["ranks"][world]:
        _assert_matches(r["trainer_steps"][name], runs["ref"][name], kind,
                        extra.get("accum", 1))
    if kind == "moe":
        assert all(m["aux_loss"] > 0 for m in
                   runs["ranks"][world][0]["trainer_steps"][name]["metrics"])


def test_fsdp_reduction_is_a_mean_not_a_sum(runs):
    """Under the LM the fsdp ranks run the same rows: their gradients are
    averaged over ``data × fsdp``, as JAX's pmean of equal values. A sum
    over fsdp would scale the grad norm by F and Adam's second moment by
    F² (moments that Adam's normalised update alone would hide)."""
    got = runs["ranks"][2][0]["trainer_steps"]["lm_f2"]
    want = runs["ref"]["lm_f2"]
    for g, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-5)
        assert not np.isclose(g["grad_norm"], 2 * w["grad_norm"], rtol=1e-2)
    tm = get_model("transformer_lm", **LM)
    nu = bridge.named_to_flax_tree(tm, got["state"]["opt_state"]["nu"])
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, np.asarray(a), rtol=0, atol=1e-4 * np.abs(np.asarray(a)).max()), want["nu"], nu)


def _ceil(n: int, k: int) -> int:
    return -(-n // k)


@pytest.mark.parametrize("world,name", ALL, ids=[n for _, n in ALL])
def test_each_rank_holds_its_share(runs, world, name):
    """Each rank holds 1/F of its parameters between steps (1/(D·F) at
    ZeRO 3), and of Adam's moments 1/F at ZeRO 0 and 1/(D·F) from ZeRO 1
    (D the rest of the replica group: data × sequence), to within the
    flat rule's per-tensor padding."""
    kind, mesh, stage, _, _ = CASES[world][name]
    f = mesh["fsdp"]
    rest = mesh.get("data", 1) * mesh.get("sequence", 1)
    for r in runs["ranks"][world]:
        held = r["trainer_steps"][name]["held"]
        n_tensors = len(r["trainer_steps"][name]["state"]["model"])
        pad = n_tensors * f * rest  # at most one padded chunk per tensor
        params = held["whole"] / (f * rest if stage >= 3 else f)
        moments = held["whole"] / (f * rest if stage >= 1 else f)
        assert params <= held["params"] <= params + pad
        assert moments <= held["mu"] <= moments + pad
        assert held["mu"] == held["nu"]
        assert held["params"] < held["whole"]


def test_fsdp_save_resumes_at_world_one(runs):
    """The fsdp 2 run's save (the world-1 format) loads into an unsharded
    state here as the whole state the ranks held, bit for bit."""
    saved = runs["ranks"][2][0]["trainer_steps"]["lm_f2"]["state"]
    state = TrainState.create(get_model("transformer_lm", **LM),
                              make_optimizer(OptimizerConfig(**lmm.opt())),
                              LossScaleState.create(PrecisionConfig()))
    ckpt_lib.restore_checkpoint(os.path.join(str(runs["dirs"][2]), "lm_f2"), 0, state)
    sd = state.state_dict()
    assert state.step == saved["step"] == lmm.STEPS
    for n, t in saved["model"].items():
        assert torch.equal(sd["model"][n], t), n
    for slot in ("mu", "nu"):
        for n, t in saved["opt_state"][slot].items():
            assert torch.equal(sd["opt_state"][slot][n], t), n


@pytest.mark.parametrize("name", list(REFUSED))
def test_fsdp_refusals_are_jax_s(runs, name):
    """What JAX's trainer refuses on an fsdp mesh, the port's refuses on
    every rank with the same type and message, word for word."""
    want = runs["ref"]["refused"][name]
    assert want is not None
    for r in runs["ranks"][4]:
        assert r["trainer_steps"][name]["raised"] == want
