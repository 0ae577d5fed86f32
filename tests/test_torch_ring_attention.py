"""The port's ring attention over ranks against the JAX package's
``ring_attention`` under ``shard_map``.

Two and four ``spawn``ed ranks (``tests/torch_dist_worker.py::_ring``,
gloo on the CPU, one spawn per world size) each hold one time chunk of
q, k and v (``[2, 4, 128, 16]`` from numpy, float32) and run
``ring_attention`` over a ``sequence`` axis of the world's size, exact and
flash (the hops on the flash kernels' plain versions here), causal and
not; each rank returns its output chunk and the gradients of ``Σ out · g``
for its chunks. Meanwhile this process runs the JAX ``ring_attention``
under ``shard_map`` on a ``sequence`` mesh of as many virtual CPU devices
(its flash hops are the Pallas kernels in interpret mode, as
``tests/test_ring_attention.py`` runs them).

Tolerances are the JAX package's own for its ring against full attention:
outputs atol/rtol 2e-5 (exact) and 5e-5 (flash), gradients 1e-4. The
port's in-process ring (``ring_attention_virtual``, what ``chip_smoke.py``
runs on the card) against the ranks' ring: 1e-6 (the same hops and
merges in the same order). Perturbing the keys and values of the second
half of the sequence leaves the first half's causal output equal to 1e-6.

Runtime: ~25 s serial (the JAX flash rings' interpret-mode compiles
overlap the ranks).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker
from jax.sharding import PartitionSpec as P

from distributed_training_tpu.parallel.ring_attention import ring_attention as jring
from distributed_training_tpu.runtime.mesh import MeshConfig, create_mesh
from distributed_training_tpu.utils.compat import shard_map
from distributed_training_tpu_torch.parallel.ring_attention import (
    ring_attention,
    ring_attention_virtual,
)

torch.set_num_threads(1)

WORLDS = (2, 4)
CASES = [(impl, causal) for impl in ("exact", "flash") for causal in (False, True)]
TOL = {"exact": 2e-5, "flash": 5e-5}
GRAD_TOL = 1e-4


def _case_name(impl, causal):
    return f"{impl}_{'causal' if causal else 'full'}"


def _arrays(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, 4, 128, 16).astype(np.float32) for _ in range(4)]  # q k v g


def _perturbed(arrays):
    q, k, v, g = (a.copy() for a in arrays)
    k[:, :, 64:] += 3.0
    v[:, :, 64:] += 3.0
    return [q, k, v, g]


def _jax_ring(world, impl, causal, arrays):
    """Output and q/k/v gradients of ``Σ out · g`` through the JAX ring."""
    mesh = create_mesh(MeshConfig(data=1, sequence=world), devices=jax.devices()[:world])
    spec = P(None, None, "sequence", None)
    ringed = shard_map(functools.partial(jring, axis_name="sequence", causal=causal,
                                         impl=impl),
                       mesh, in_specs=(spec, spec, spec), out_specs=spec)
    q, k, v, g = map(jnp.asarray, arrays)

    def loss(q, k, v):
        out = ringed(q, k, v)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                 has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = {}
    for i, (impl, causal) in enumerate(CASES):
        cases[_case_name(impl, causal)] = (impl, causal, _arrays(i))
    base = cases["exact_causal"][2]
    cases["exact_perturbed"] = ("exact", True, _perturbed(base))
    cases["flash_perturbed"] = ("flash", True, _perturbed(cases["flash_causal"][2]))
    joins = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"ring{world}")
        torch.save({"ring_cases": cases}, out / "job.pt")
        joins[world] = worker.spawn(out, world, ("_ring",))
    ref = {}
    try:
        for world in WORLDS:
            for impl, causal in CASES:
                name = _case_name(impl, causal)
                ref[world, name] = _jax_ring(world, impl, causal, cases[name][2])
    finally:
        ranks = {world: join() for world, join in joins.items()}
    return {"ranks": ranks, "ref": ref, "cases": cases}


def _assembled(runs, world, name):
    """The ranks' chunks of out, dq, dk, dv joined along time."""
    parts = [r["ring"][name] for r in runs["ranks"][world]]
    return {k: torch.cat([p[k] for p in parts], dim=-2).numpy()
            for k in ("out", "dq", "dk", "dv")}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl,causal", CASES, ids=[_case_name(*c) for c in CASES])
def test_ring_over_ranks_matches_jax_shard_map(runs, world, impl, causal):
    got = _assembled(runs, world, _case_name(impl, causal))
    want_out, want_grads = runs["ref"][world, _case_name(impl, causal)]
    np.testing.assert_allclose(got["out"], want_out, atol=TOL[impl], rtol=TOL[impl])
    for key, want in zip(("dq", "dk", "dv"), want_grads):
        np.testing.assert_allclose(got[key], want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl,causal", CASES, ids=[_case_name(*c) for c in CASES])
def test_virtual_ring_matches_the_ranks(runs, world, impl, causal):
    """``ring_attention_virtual`` (every rank's hops in one process) gives
    the ranks' outputs and gradients: the code the card checks is the code
    the ranks run."""
    name = _case_name(impl, causal)
    got = _assembled(runs, world, name)
    q, k, v, g = (torch.from_numpy(a).requires_grad_(i < 3)
                  for i, a in enumerate(runs["cases"][name][2]))
    out = ring_attention_virtual(q, k, v, world, causal=causal, impl=impl)
    (out * g).sum().backward()
    want = {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    for key in want:
        np.testing.assert_allclose(got[key], want[key].numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ["exact", "flash"])
def test_causal_first_block_ignores_the_future(runs, world, impl):
    """Perturbing the second half's keys and values leaves the first
    half's causal output as it was, and changes the second half's."""
    base = _assembled(runs, world, f"{impl}_causal")["out"]
    pert = _assembled(runs, world, f"{impl}_perturbed")["out"]
    np.testing.assert_allclose(pert[:, :, :64], base[:, :, :64], atol=1e-6)
    assert not np.allclose(pert[:, :, 64:], base[:, :, 64:])


def test_bound_axis_needs_its_mesh():
    q = torch.zeros(1, 1, 8, 4)
    with pytest.raises(ValueError, match="needs the mesh"):
        ring_attention(q, q, q, axis_name="sequence")
