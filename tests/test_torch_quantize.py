"""The port's int8 weights (``serving/quantize.py``) and int8 KV pages
(``PagedCache`` with ``kv_dtype="int8"``) against the JAX package's.

At micro size (``transformer_lm`` with 2 layers, 2 heads, hidden 32,
vocab 61, max_len 64; the port's seeded weights carried into JAX's tree
through ``bridge.py``):

1. **Codes and scales**: the port's ``quantize_params`` on its float32
   parameters and JAX's on the bridged tree quantize the same leaves
   (JAX's ``reduce_axes_for`` rule) to the same int8 codes and float32
   scales, exactly; JAX's quantized tree carried across by
   ``bridge.flax_to_serving_params`` serves the port's logits; the
   quantized token table gathers rows first and equals the dequantized
   table's lookup.
2. **Engines**: the port's quantizing engine gives JAX's quantizing
   engine's greedy tokens and ``quantized_params_bytes``; with int8 KV
   pages on top, the same greedy tokens and ``kv_bytes_per_token``.
3. **int8 pools**: ``paged_decode_attend`` on an int8 pool writes JAX's
   codes and scales exactly (float32 compute) and attends within rtol 1e-5
   / atol 1e-6.

One JAX engine run (both flags) and one (weights alone) serve the module.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import ServeConfig as JServeConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.parallel.ring_attention import PagedKV as JPagedKV
from distributed_training_tpu.parallel.ring_attention import RingSelfAttention as JAttn
from distributed_training_tpu.serving import Engine as JEngine
from distributed_training_tpu.serving import quantize as jq
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.parallel.ring_attention import PagedCache, PagedKV, paged_decode_attend
from distributed_training_tpu_torch.serving import Engine
from distributed_training_tpu_torch.serving import quantize as tq

torch.set_num_threads(1)

VOCAB = 61
LM = dict(num_classes=VOCAB, num_layers=2, num_heads=2, hidden_dim=32, max_len=64,
          head_bias=True)
N_NEW = 8
H, HD, PS = 2, 8, 4


def _model():
    return get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **LM).eval()


@pytest.fixture(scope="module")
def flax_params():
    params, _ = bridge.state_dict_to_flax(_model())
    return jax.tree.map(jnp.asarray, params)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(1)
    return [rng.randint(0, VOCAB, size=n).astype(np.int32) for n in (3, 5, 9, 5, 3, 9)]


def _flat(tree, prefix=()):
    if isinstance(tree, jq.QuantizedTensor) or not hasattr(tree, "items"):
        return {"/".join(prefix): tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)))
    return out


def test_codes_and_scales_match_jax(flax_params):
    want = _flat(jq.quantize_params(flax_params))
    got = tq.quantize_params(tq.serving_params(_model()))
    assert sorted(n.replace(".", "/") for n in got) == sorted(want)
    quantized = [n for n, v in got.items() if isinstance(v, tq.QuantizedTensor)]
    assert sorted(n.replace(".", "/") for n in quantized) == sorted(
        n for n, v in want.items() if isinstance(v, jq.QuantizedTensor))
    assert "tok_embed.embedding" in quantized and "lm_head.kernel" not in quantized
    assert len(quantized) == 1 + 4 * LM["num_layers"]
    for n in quantized:
        w = want[n.replace(".", "/")]
        np.testing.assert_array_equal(got[n].q.numpy(), np.asarray(w.q))
        np.testing.assert_array_equal(got[n].scale.numpy(), np.asarray(w.scale))
        assert got[n].q.dtype == torch.int8 and got[n].scale.dtype == torch.float32
    assert tq.quantized_param_bytes(got) == jq.quantized_param_bytes(jq.quantize_params(flax_params))
    deq = tq.dequantize_params(got)
    jdeq = _flat(jq.dequantize_params(jq.quantize_params(flax_params)))
    for n in quantized:
        np.testing.assert_array_equal(deq[n].numpy(), np.asarray(jdeq[n.replace(".", "/")]))


def test_zero_channel_and_rounding_are_jax_s():
    w = np.array([[0.0, 1.0, -2.5], [0.0, 0.5, 1.25], [0.0, -1.0, 0.3]], np.float32)
    want = jq.quantize_array(jnp.asarray(w), (0,))
    got = tq.quantize_array(torch.from_numpy(w), (0,))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.scale[0, 0] == 1.0


def test_bridged_jax_tree_serves_the_port_logits(flax_params):
    """JAX's quantized tree, carried across, gives the port's own
    quantized model's logits; the token table's row gather equals the
    dequantized table's lookup."""
    own = _model()
    tq.install_params(own, tq.quantize_params(tq.serving_params(own)))
    carried = _model()
    tq.install_params(carried, bridge.flax_to_serving_params(
        carried, jax.device_get(jq.quantize_params(flax_params))))
    toks = torch.from_numpy(np.random.RandomState(4).randint(0, VOCAB, (2, 7)))
    with torch.no_grad():
        np.testing.assert_array_equal(carried(toks).numpy(), own(toks).numpy())
        emb = own.tok_embed.embedding
        assert isinstance(emb, tq.QuantizedTensor)
        np.testing.assert_array_equal(own.tok_embed(toks).numpy(),
                                      torch.nn.functional.embedding(toks, emb.to(torch.float32)).numpy())
    names = set(tq.serving_params(own))
    assert names == set(tq.serving_params(_model()))


def _serve_port(prompts, **kw):
    eng = Engine(_model(), ServeConfig(max_batch=2, prefill_bucket=8, max_new_tokens=N_NEW, **kw))
    for p in prompts:
        eng.submit(p)
    done = {f.uid: f.tokens.tolist() for f in eng.run()}
    eng.check_balanced()
    return done, eng.stats()


def _serve_jax(flax_params, prompts, **kw):
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM)
    eng = JEngine(jm, flax_params, JServeConfig(max_batch=2, prefill_bucket=8,
                                                 max_new_tokens=N_NEW, **kw))
    for p in prompts:
        eng.submit(p)
    return {f.uid: f.tokens.tolist() for f in eng.run()}, eng.stats()


@pytest.mark.parametrize("kw", [dict(quantize_weights=True),
                                dict(quantize_weights=True, kv_dtype="int8")],
                         ids=["weights", "weights+kv"])
def test_quantized_engine_matches_jax(flax_params, prompts, kw):
    got, stats = _serve_port(prompts, **kw)
    want, jstats = _serve_jax(flax_params, prompts, **kw)
    assert got == want
    for key in ("quantized_params_bytes", "kv_bytes_per_token", "tokens_emitted"):
        assert stats[key] == jstats[key], key
    assert stats["weight_quant_s"] > 0
    # int8 rows + float32 per-head scales, per position: 2*H*hd + 2*H*4
    # bytes against 2*H*hd*4 for float32.
    h, hd = LM["num_heads"], LM["hidden_dim"] // LM["num_heads"]
    per_layer = (2 * h * hd + 2 * h * 4) if "kv_dtype" in kw else 2 * h * hd * 4
    assert stats["kv_bytes_per_token"] == LM["num_layers"] * per_layer


def test_quantized_engine_serves_its_dequantized_twin(prompts):
    """The dequant-at-use path: the quantizing engine's tokens equal an
    engine serving the dequantized float32 set."""
    m = _model()
    twin = _model()
    tq.install_params(twin, tq.dequantize_params(tq.quantize_params(tq.serving_params(m))))
    a = Engine(m, ServeConfig(max_batch=2, max_new_tokens=N_NEW, quantize_weights=True))
    b = Engine(twin, ServeConfig(max_batch=2, max_new_tokens=N_NEW))
    outs = []
    for eng in (a, b):
        for p in prompts:
            eng.submit(p)
        outs.append({f.uid: f.tokens.tolist() for f in eng.run()})
    assert outs[0] == outs[1]


class _JaxPaged(JAttn):
    @nn.compact
    def __call__(self, q, k, v, pages):
        return self._paged_decode_attend(q, k, v, HD, pages)


@pytest.mark.parametrize("b,t_in", [(3, 1), (1, 5), (2, 3)])
def test_int8_pool_matches_jax(b, t_in):
    """Quantize-on-scatter and dequantize-in-gather: the int8 pools and the
    scales exactly, the outputs within the stated tolerance, on pools that
    hold earlier int8 rows and scales everywhere."""
    rng = np.random.RandomState(b * 10 + t_in)
    n_pages, pps = 12, 3
    perm = rng.permutation(np.arange(1, n_pages))
    table = perm[:b * pps].reshape(b, pps)
    positions = np.stack([rng.randint(0, pps * PS - t_in) + np.arange(t_in) for _ in range(b)])
    valid = rng.rand(b, t_in) > 0.25
    valid[:, 0] = True
    rows = n_pages * PS
    pk = rng.randint(-127, 128, (rows, H, HD)).astype(np.int8)
    pv = rng.randint(-127, 128, (rows, H, HD)).astype(np.int8)
    sk = rng.rand(rows, H).astype(np.float32) * 0.05
    sv = rng.rand(rows, H).astype(np.float32) * 0.05
    q, k, v = (rng.randn(b, t_in, H, HD).astype(np.float32) for _ in range(3))
    k[0, 0, 0] = 0.0  # an all-zero row takes scale 1.0
    mod = _JaxPaged(num_heads=H, causal=True, kv_page_size=PS, kv_pages=n_pages,
                    kv_dtype="int8")
    want, state = mod.apply(
        {"cache": {"key_pages": jnp.asarray(pk), "value_pages": jnp.asarray(pv),
                   "key_scales": jnp.asarray(sk), "value_scales": jnp.asarray(sv)}},
        q, k, v, JPagedKV(jnp.asarray(table, jnp.int32), jnp.asarray(positions, jnp.int32),
                          jnp.asarray(valid)), mutable=["cache"])
    cache = PagedCache([torch.from_numpy(pk.copy())], [torch.from_numpy(pv.copy())], PS,
                       [torch.from_numpy(sk.copy())], [torch.from_numpy(sv.copy())])
    got = paged_decode_attend(*(torch.from_numpy(t) for t in (q, k, v)), cache, 0,
                              PagedKV(torch.from_numpy(table), torch.from_numpy(positions),
                                      torch.from_numpy(valid)))
    st = state["cache"]
    for mine, theirs in ((cache.keys, "key_pages"), (cache.values, "value_pages"),
                         (cache.key_scales, "key_scales"), (cache.value_scales, "value_scales")):
        np.testing.assert_array_equal(mine[0].numpy()[PS:], np.asarray(st[theirs])[PS:])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=1e-5, atol=1e-6)
