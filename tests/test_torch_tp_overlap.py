"""The port's ring-overlapped tensor parallelism (``tp_overlap``) against
the JAX package: the collective-matmul primitives and the overlapped LM
step, on two ranks, and TP×SP on four.

- **Primitives**: two ``spawn``ed ranks (``tests/torch_dist_worker.py``,
  gloo on the CPU) run ``allgather_matmul`` (x rows and w columns
  sharded) and ``matmul_reducescatter`` (the contraction sharded; output
  rows scattered, or columns scattered and gathered back by
  ``ring_all_gather``) on the JAX test's ``x [2, 8, 6]``, ``w [6, 10]``;
  outputs and the gradients of ``Σ out · co`` against the dense product
  and against the JAX primitives under ``shard_map`` on a two-device
  ``model`` mesh, atol 1e-5 (the JAX test's). The shape refusals raise as
  JAX's do.
- **Overlap step**: the same two ranks run the micro GPT
  (``tests/torch_lm_mesh.py``) under the overlap schedule at ZeRO 0, 1
  and 2 (time-sharded activations, ``lm_head`` and ``tok_embed``
  replicated, ``overlap_finalize_grads``), with the sharded eval, against
  the JAX ``make_tp_lm_train_step(tp_overlap=True)`` on the same mesh.
- **TP×SP**: four ranks on a ``(sequence 2, model 2)`` mesh, plain and
  overlapped at ZeRO 1, against the JAX ``make_lm_train_step`` on the same
  four-device mesh (the counterpart of JAX's
  ``test_sp_tp_overlap_matches_oracle``).

Step tolerances as ``tests/torch_lm_mesh.py`` says (metrics rtol 1e-5,
parameters atol 1e-5, moments 1e-4 of the largest magnitude); the sharded
eval against the unsharded JAX eval on the JAX step's parameters, rtol
1e-5.

Runtime: ~55 s serial (the JAX compiles overlap the ranks).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
import torch_lm_mesh as lmm
from jax.sharding import PartitionSpec as P

from distributed_training_tpu.parallel import collective_matmul as jcm
from distributed_training_tpu.parallel.sharding import place_state
from distributed_training_tpu.train import lm_step as jstep
from distributed_training_tpu.utils.compat import shard_map
from distributed_training_tpu_torch.parallel.collective_matmul import (
    allgather_matmul,
    matmul_reducescatter,
)
from distributed_training_tpu_torch.parallel.tensor_parallel import TensorParallel
from distributed_training_tpu_torch.train.lm_step import _overlap_targets

torch.set_num_threads(1)

STAGES = (0, 1, 2)
TPSP = {"data": 1, "sequence": 2, "model": 2}


def _xw():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 8, 6).astype(np.float32)
    w = rng.rand(6, 10).astype(np.float32)
    co = np.cos(np.arange(2 * 8 * 10, dtype=np.float32)).reshape(2, 8, 10)
    return x, w, co


def _jax_primitives(x, w, co):
    """Each primitive's output and (dx, dw) under shard_map on model=2."""
    mesh = lmm.jax_mesh(model=2)
    ag = shard_map(lambda xl, wl: jcm.allgather_matmul(xl, wl, "model"), mesh,
                   in_specs=(P(None, "model", None), P(None, "model")),
                   out_specs=P(None, None, "model"))

    def rs(dim):
        def f(xl, wl):
            y = jcm.matmul_reducescatter(xl, wl, "model", dim)
            return jcm.ring_all_gather(y, "model", -1) if dim == -1 else y
        return shard_map(f, mesh, in_specs=(P(None, None, "model"), P("model", None)),
                         out_specs=P(None, "model", None) if dim == -2 else P())

    out = {}
    for name, f in (("allgather", ag), ("rs_rows", rs(-2)), ("rs_cols", rs(-1))):
        def loss(x, w, f=f):
            y = f(x, w)
            return (y * co).sum(), y
        (_, y), (gx, gw) = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
            jnp.asarray(x), jnp.asarray(w))
        out[name] = (np.asarray(y), np.asarray(gx), np.asarray(gw))
    return out


def _jax_uneven_refusal():
    jm = lmm.jax_lm()
    step = jstep.make_tp_lm_train_step(lmm.jax_mesh(model=2), model=jm, donate=False,
                                       tp_overlap=True)
    state = lmm.jax_state(jm, lmm.opt())
    state = place_state(state, step.state_shardings(state))
    batch = {k: jnp.asarray(v[:, :31]) for k, v in lmm.batches(1)[0].items()}
    with pytest.raises(ValueError) as err:
        step(state, batch, jax.random.PRNGKey(1))
    return str(err.value)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, jm_seq = lmm.jax_lm(), lmm.jax_lm("sequence")
    weights = lmm.port_weights(lmm.jax_state(jm, lmm.opt()))
    data = lmm.batches()
    two = {f"ov_s{s}": {"mesh": {"data": 1, "model": 2}, "stage": s, "opt": lmm.opt(),
                        "overlap": True, "eval": True} for s in STAGES}
    four = {"tpsp": {"mesh": TPSP, "stage": 1, "opt": lmm.opt()},
            "tpsp_ov": {"mesh": TPSP, "stage": 1, "opt": lmm.opt(), "overlap": True}}
    joins = {}
    for world, scenarios, parts in ((2, two, ("_overlap_primitives", "_lm_mesh_steps")),
                                    (4, four, ("_lm_mesh_steps",))):
        out = tmp_path_factory.mktemp(f"ov{world}")
        torch.save({"model": weights, "batches": data, "eval": data[0], "xw": _xw(),
                    "lm_kw": lmm.LM_KW, "mesh_scenarios": scenarios, "dir": str(out)},
                   out / "job.pt")
        joins[world] = worker.spawn(out, world, parts)
    ref = {}
    try:
        ref["primitives"] = _jax_primitives(*_xw())
        mesh2 = lmm.jax_mesh(data=1, model=2)
        for s in STAGES:
            step = jstep.make_tp_lm_train_step(mesh2, model=jm, zero_stage=s,
                                               donate=False, tp_overlap=True)
            ref[f"ov_s{s}"] = lmm.run_jax(step, lmm.jax_state(jm, lmm.opt()), data)
        ref["eval"] = float(jstep._fused_softmax_ce(
            jm.apply({"params": ref["ov_s0"]["params"]}, jnp.asarray(data[0]["tokens"])),
            jnp.asarray(data[0]["targets"])))
        mesh4 = lmm.jax_mesh(**TPSP)
        for name, overlap in (("tpsp", False), ("tpsp_ov", True)):
            step = jstep.make_lm_train_step(mesh4, model=jm_seq, zero_stage=1,
                                            donate=False, tp_overlap=overlap)
            ref[name] = lmm.run_jax(step, lmm.jax_state(jm_seq, lmm.opt()), data)
        ref["uneven"] = _jax_uneven_refusal()
    finally:
        ranks = {world: join() for world, join in joins.items()}
    return {"ranks": ranks, "ref": ref}


@pytest.mark.parametrize("name", ["allgather", "rs_rows", "rs_cols"])
def test_primitives_match_dense_and_jax(runs, name):
    x, w, co = _xw()
    ranks = [r["primitives"][name] for r in runs["ranks"][2]]
    if name == "allgather":
        y = torch.cat([r["y"] for r in ranks], -1)
        dx = torch.cat([r["dx"] for r in ranks], -2)
        dw = torch.cat([r["dw"] for r in ranks], -1)
    else:
        y = (torch.cat([r["y"] for r in ranks], -2) if name == "rs_rows"
             else ranks[0]["y"])
        dx = torch.cat([r["dx"] for r in ranks], -1)
        dw = torch.cat([r["dw"] for r in ranks], -2)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    ((xt @ wt) * torch.from_numpy(co)).sum().backward()
    jy, jdx, jdw = runs["ref"]["primitives"][name]
    for got, dense, jax_ in ((y, (xt @ wt).detach(), jy), (dx, xt.grad, jdx),
                             (dw, wt.grad, jdw)):
        np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5)
        np.testing.assert_allclose(got.numpy(), jax_, atol=1e-5)


def test_primitive_shape_refusals():
    x, w = (torch.from_numpy(a) for a in _xw()[:2])
    for fn in (allgather_matmul, matmul_reducescatter):
        with pytest.raises(ValueError) as terr:
            fn(x, w.T)
        with pytest.raises(ValueError) as jerr:
            getattr(jcm, fn.__name__)(jnp.asarray(x.numpy()), jnp.asarray(w.T.numpy()),
                                      "model")
        assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="scatter_dim"):
        matmul_reducescatter(x, w, None, 0)


def test_uneven_time_shard_refused_as_jax_does(runs):
    tp = TensorParallel(group=None, size=2, index=0, overlap=True)
    with pytest.raises(ValueError) as err:
        _overlap_targets(torch.zeros(1, 31, dtype=torch.int32), tp)
    assert str(err.value) == runs["ref"]["uneven"]


@pytest.mark.parametrize("name", [f"ov_s{s}" for s in STAGES])
def test_overlap_step_matches_jax(runs, name):
    for rank in runs["ranks"][2]:
        lmm.assert_matches_jax(rank["mesh"][name], runs["ref"][name])
        np.testing.assert_allclose(rank["mesh"][name]["eval"], runs["ref"]["eval"],
                                   rtol=1e-5)
    assert lmm.ranks_agree(runs["ranks"][2], name)


@pytest.mark.parametrize("name", ["tpsp", "tpsp_ov"])
def test_tp_times_sp_matches_jax_four_device_mesh(runs, name):
    for rank in runs["ranks"][4]:
        lmm.assert_matches_jax(rank["mesh"][name], runs["ref"][name])
    assert lmm.ranks_agree(runs["ranks"][4], name)
