"""The port's ResNet against the Flax model, through ``bridge.py``.

The Flax variables are initialised by JAX, then BatchNorm scales,
offsets and running statistics are perturbed (the zero-initialised last
BN of each block would otherwise hide its branch), and the same weights
go into the port. Inputs are NHWC float32 from numpy.

Tolerances (float32 on the CPU, XLA's and oneDNN's convolutions summing
in different orders): eval logits atol/rtol 1e-4. Train mode normalises
by batch statistics; at batch 2 the last ResNet-18 stage is 1×1, so each
of its BatchNorms normalises two numbers and Flax's fast variance
``E[x²] − E[x]²`` cancels there, which amplifies those rounding
differences; resnet18's train-mode logits and statistics compare at
rtol/atol 1e-2, resnet_micro's at 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.models import available_models, get_model
from distributed_training_tpu_torch.models.resnet import same_pads

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)


def _variables(model, x, seed=1):
    v = jax.device_get(model.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                  train=False))
    rs = np.random.RandomState(seed + 1)

    def perturb(path, a):
        a = np.asarray(a) + 0.1 * rs.randn(*a.shape).astype(np.float32)
        return np.abs(a) if getattr(path[-1], "key", "") == "var" else a
    bn = lambda t: jax.tree_util.tree_map_with_path(perturb, t)  # noqa: E731
    params = {k: (bn(p) if "bn" in k or "block" in k else p)
              for k, p in v["params"].items()}
    return {"params": params, "batch_stats": bn(v["batch_stats"])}


def _compare(name, stem, size, tol_train):
    x = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32)
    jm = jax_model(name, stem=stem)
    v = _variables(jm, x)
    tm = get_model(name, stem=stem)
    bridge.load_flax_variables(tm, v["params"], v["batch_stats"])
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(v["params"]))

    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    want, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm.train()
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol_train, atol=tol_train)
    _, stats = bridge.state_dict_to_flax(tm.state_dict())
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, np.asarray(a), rtol=tol_train, atol=tol_train),
        jax.device_get(mut["batch_stats"]), stats)


@pytest.mark.parametrize("stem", ["imagenet", "cifar"])
@pytest.mark.parametrize("size", [32, 33])
def test_resnet_micro_matches_flax(stem, size):
    _compare("resnet_micro", stem, size, tol_train=1e-4)


def test_resnet18_matches_flax():
    _compare("resnet18", "imagenet", 32, tol_train=1e-2)


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (32, 3, 2, (0, 1)), (33, 3, 2, (1, 1)), (32, 7, 2, (2, 3)),
    (16, 3, 2, (0, 1)), (32, 3, 1, (1, 1)), (32, 1, 2, (0, 0)),
])
def test_same_pads_are_flax_same(size, kernel, stride, pads):
    assert same_pads(size, kernel, stride) == pads


def test_bridge_round_trip_is_identity():
    tm = get_model("resnet_micro")
    sd = tm.state_dict()
    params, stats = bridge.state_dict_to_flax(sd)
    back = bridge.flax_to_state_dict(params, stats)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k])


def test_resnet18_has_62_tensors_and_published_size():
    m = get_model("resnet18")
    assert len(list(m.parameters())) == 62
    assert sum(p.numel() for p in m.parameters()) == 11_181_642


def test_registry_refuses_unported_models():
    assert "resnet18" in available_models()
    for name in ("vit_b16", "moe_mlp", "transformer_lm"):
        with pytest.raises(NotImplementedError):
            get_model(name)
    with pytest.raises(ValueError):
        get_model("resnet7")
