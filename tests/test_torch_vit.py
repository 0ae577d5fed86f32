"""The port's ViT (``models/vit.py``) against the JAX package's
(``distributed_training_tpu/models/vit.py``), one process, the same numpy
inputs and the JAX-initialised weights carried by ``bridge.py``.

The model is image 32, patch 8 (16 patches and the class token), hidden
64, 2 layers, 4 heads, MLP 128, 10 classes; the head's zero kernel is
replaced by a random one on both sides, so that the logits and every
gradient are non-trivial.

- float32 logits and every parameter's gradient (of the mean CE over 6
  images) in training mode, with and without remat: each within 1e-5 of
  its tensor's largest magnitude (relative), the logits within 1e-5; the
  key projection's bias, whose gradient is zero in exact arithmetic (the
  softmax over keys ignores a per-query constant), within 1e-7 absolute on
  both sides;
- bf16 compute (float32 parameters, float32 logits): the logits within
  2e-2 of their largest magnitude. Both sides round every product and the
  softmax to bf16, in a different order of summation (XLA's CPU dots
  against torch's), so they differ by a few bf16 ulps, not by 1e-5;
- the bridge both ways, the JAX leaves' names and shapes, the registry's
  ViT-B/16 and its parameter count; the FLOP count against JAX's
  ``vit_forward_flops`` (and its ViT-B/16 value); dropout with remat draws
  the masks of the run without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.observability.flops import forward_flops as jax_forward_flops
from distributed_training_tpu.observability.flops import vit_forward_flops as jax_vit_flops
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.models import available_models, get_model
from distributed_training_tpu_torch.models.vit import ViT
from distributed_training_tpu_torch.observability import forward_flops
from distributed_training_tpu_torch.observability.flops import vit_forward_flops

torch.set_num_threads(1)

VIT_KW = dict(num_classes=10, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
              mlp_dim=128)
IMAGE = 32


def _images(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, IMAGE, IMAGE, 3).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def _jax_params(jm, seed=0):
    x, _ = _images(1)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)["params"]
    params = jax.device_get(params)
    params["head"]["kernel"] = np.random.RandomState(5).randn(
        *params["head"]["kernel"].shape).astype(np.float32) * 0.1
    return params


def _port(params, **kw):
    tm = get_model("vit_b16", image_size=IMAGE, **{**VIT_KW, **kw})
    bridge.load_flax_variables(tm, params)
    return tm


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_vit_logits_and_gradients_match_jax(remat):
    jm = jax_model("vit_b16", remat=remat, **VIT_KW)
    params = _jax_params(jm)
    x, y = _images()

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    tm = _port(params, remat=remat)
    tm.train()
    logits = tm(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    assert _rel(logits.detach(), jlogits) < 1e-5
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    grads = bridge.named_to_flax_tree(tm, {n: p.grad for n, p in tm.named_parameters()})
    jgrads = jax.device_get(jgrads)
    for i in range(VIT_KW["num_layers"]):
        key = f"encoder_{i}"
        for g in (grads[key]["attn"]["key"].pop("bias"), jgrads[key]["attn"]["key"].pop("bias")):
            assert np.abs(g).max() < 1e-7
    rels = jax.tree.map(_rel, grads, jgrads)
    assert max(jax.tree.leaves(rels)) < 1e-5, rels


def test_vit_bf16_logits_match_jax():
    jm = jax_model("vit_b16", dtype=jnp.bfloat16, **VIT_KW)
    params = _jax_params(jm)
    x, _ = _images()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), train=False))
    tm = _port(params, dtype=torch.bfloat16)
    tm.eval()
    got = tm(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _rel(got.detach(), want) < 2e-2


def test_vit_bridge_and_names_are_the_flax_tree():
    jm = jax_model("vit_b16", **VIT_KW)
    params = _jax_params(jm)
    tm = _port(params)
    back, stats = bridge.state_dict_to_flax(tm)
    assert stats == {}
    shapes = jax.tree.map(np.shape, params)
    assert jax.tree.map(np.shape, back) == shapes
    jax.tree.map(np.testing.assert_array_equal, back, params)
    assert shapes["encoder_0"]["attn"]["query"]["kernel"] == (64, 4, 16)
    assert shapes["encoder_0"]["attn"]["out"]["kernel"] == (4, 16, 64)
    assert shapes["patch_embed"]["kernel"] == (8, 8, 3, 64)


def test_vit_initial_values_follow_flax():
    """Zero head and class token, ``pos_embed`` normal with std 0.02,
    lecun-normal kernels (std ``1/√fan_in``)."""
    tm = get_model("vit_b16", image_size=IMAGE, generator=torch.Generator().manual_seed(0),
                   **{**VIT_KW, "hidden_size": 256, "num_heads": 8, "mlp_dim": 512})
    assert not tm.head.kernel.any() and not tm.cls_token.any()
    assert abs(float(tm.pos_embed.std()) - 0.02) < 2e-3
    q = tm.encoder_0.attn.query.kernel
    assert abs(float(q.std()) * 16.0 - 1.0) < 0.05  # fan-in 256
    o = tm.encoder_0.attn.out.kernel
    assert abs(float(o.std()) * 16.0 - 1.0) < 0.05  # fan-in 8·32


def test_registry_builds_vit_b16_at_its_published_size():
    assert "vit_b16" in available_models()
    tm = get_model("vit_b16", num_classes=1000)
    jm = jax_model("vit_b16", num_classes=1000)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 224, 224, 3)), train=False))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == want == 86_567_656
    assert (tm.patch_size, tm.hidden_size, tm.num_layers, tm.num_heads, tm.mlp_dim) == \
        (16, 768, 12, 12, 3072)


@pytest.mark.parametrize("size", ["micro", "b16"])
def test_vit_flops_match_jax(size):
    kw = (dict(image_size=IMAGE, **{k: v for k, v in VIT_KW.items()}) if size == "micro"
          else dict(image_size=224, num_classes=1000, patch_size=16, hidden_size=768,
                    num_layers=12, num_heads=12, mlp_dim=3072))
    image = kw.pop("image_size")
    heads = kw.pop("num_heads")
    want = jax_vit_flops(image_size=image, batch=3, **kw)
    assert vit_forward_flops(image_size=image, batch=3, **kw) == want
    if size == "b16":
        assert want == 3 * 35_127_656_448
    jm = jax_model("vit_b16", num_heads=heads, **kw)
    tm = ViT(num_heads=heads, image_size=image, **kw)
    assert forward_flops(tm, image_size=image, batch=3) == \
        jax_forward_flops(jm, image_size=image, batch=3) == want


def test_dropout_under_remat_draws_the_masks_of_the_plain_run():
    jm = jax_model("vit_b16", **VIT_KW)
    params = _jax_params(jm)
    x, y = _images()
    grads = {}
    for remat in (False, True):
        tm = _port(params, remat=remat, dropout_rate=0.1)
        tm.train()
        gen = torch.Generator().manual_seed(3)
        loss = torch.nn.functional.cross_entropy(tm(torch.from_numpy(x), generator=gen),
                                                 torch.from_numpy(y).long())
        loss.backward()
        grads[remat] = {n: p.grad.clone() for n, p in tm.named_parameters()}
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, rtol=0, atol=1e-6)
    tm.eval()
    with pytest.raises(ValueError, match="generator"):
        tm.train()
        tm(torch.from_numpy(x))
