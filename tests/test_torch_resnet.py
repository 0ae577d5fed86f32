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
    _, stats = bridge.state_dict_to_flax(tm)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, np.asarray(a), rtol=tol_train, atol=tol_train),
        jax.device_get(mut["batch_stats"]), stats)


@pytest.mark.parametrize("stem", ["imagenet", "cifar"])
@pytest.mark.parametrize("size", [32, 33])
def test_resnet_micro_matches_flax(stem, size):
    _compare("resnet_micro", stem, size, tol_train=1e-4)


def test_resnet_micro_matches_flax_where_the_last_stage_is_1x1():
    """At 16² the imagenet stem leaves the last stage's strided 3×3 conv a
    1×1 image, which the port computes as its centre tap."""
    _compare("resnet_micro", "imagenet", 16, tol_train=1e-4)


@pytest.mark.parametrize("stride", [2, 3])
def test_conv_on_a_1x1_image_is_its_centre_tap(stride):
    """The strided SAME conv of a 1×1 image against the padded conv it
    stands for.
    In bf16 channels_last, where the CPU's own backward of the padded
    strided conv returns garbage weight gradients, the weight gradient is
    within bf16 rounding (2**-6 of the largest, over 20 draws) of the
    float32 one on the same bf16 inputs. In float32 the output and both
    gradients are within 1e-6 (oneDNN sums the 8 products in another order
    for the 1×1 conv than for the padded 3×3 one)."""
    from distributed_training_tpu_torch.models.resnet import Conv

    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        conv = Conv(8, 16, 3, stride, dtype=dtype)
        conv.reset_parameters(gen)
        conv.to(memory_format=torch.channels_last)
        for _ in range(20 if dtype == torch.bfloat16 else 1):
            x = torch.randn(4, 8, 1, 1, generator=gen).to(memory_format=torch.channels_last)
            g = torch.randn(4, 16, 1, 1, generator=gen)
            conv.weight.grad = None
            xa = x.clone().requires_grad_()
            (conv(xa).float() * g).sum().backward()
            w = conv.weight.detach().to(dtype).float().requires_grad_()
            xb = x.to(dtype).float().requires_grad_()
            y = torch.nn.functional.conv2d(xb, w, stride=stride, padding=1)
            (y * g).sum().backward()
            if dtype == torch.float32:  # the 8 products summed in another order
                torch.testing.assert_close(conv(x), y.detach(), rtol=1e-6, atol=1e-6)
                torch.testing.assert_close(conv.weight.grad, w.grad, rtol=1e-6, atol=1e-6)
                torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-6, atol=1e-6)
            else:
                err = (conv.weight.grad.float() - w.grad).abs().max()
                assert torch.isfinite(conv.weight.grad).all()
                assert err <= 2 ** -6 * w.grad.abs().max(), err


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
    params, stats = bridge.state_dict_to_flax(tm, sd)
    back = bridge.flax_to_state_dict(tm, params, stats)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k])


def test_resnet18_has_62_tensors_and_published_size():
    m = get_model("resnet18")
    assert len(list(m.parameters())) == 62
    assert sum(p.numel() for p in m.parameters()) == 11_181_642


def test_registry_refuses_unported_models():
    """Every model of the JAX registry is ported: ``vit_b16``, which this
    test once refused, builds (``tests/test_torch_vit.py`` holds it
    against JAX), and so do ``moe_mlp`` and the LM with MoE layers, under a
    sequence axis too (``tests/test_torch_moe_axes.py``); an unknown name
    still raises."""
    from distributed_training_tpu_torch.config import MeshSpec
    from distributed_training_tpu_torch.models import NOT_PORTED
    from distributed_training_tpu_torch.runtime.mesh import Mesh

    assert {"resnet18", "moe_mlp", "vit_b16"} <= set(available_models())
    assert NOT_PORTED == ()
    vit = get_model("vit_b16", num_classes=1000)
    assert vit.encoder_11.attn.query.kernel.shape == (768, 12, 64)
    assert get_model("moe_mlp").moe_0.num_experts == 4
    lm = get_model("transformer_lm", moe_num_experts=4)
    assert lm.block1.moe_mlp.experts.w1.shape[0] == 4 and hasattr(lm.block0, "mlp")
    sp = get_model("transformer_lm", moe_num_experts=4, seq_axis="sequence",
                   mesh=Mesh(MeshSpec()))
    assert sp.block1.moe_mlp.experts.w1.shape[0] == 4
    with pytest.raises(ValueError):
        get_model("resnet7")
