"""Generation in the port (``inference/``, the decode branch of
``models/gpt.py`` and ``parallel/ring_attention.py``,
``gpt/torch_cuda/generate.py``) against the JAX package's, on the CPU.

The Flax GPT is initialised by JAX and every leaf perturbed (zero biases
would hide a wrong mapping); ``bridge.py`` carries the weights over.
Tolerances, float32: decode logits against the full forward and against
JAX's decode 2e-5 (the cached attention sums in another order than the
training path's, and XLA's and PyTorch's CPU kernels differ in theirs);
beam scores 1e-4 (sums of log-probabilities over the steps). Greedy and
beam tokens must be equal: with fp32 logits no step of these seeds has a
near tie. MoE decode: JAX's own test holds its decode against its full
forward at 1e-4 (the gate sees another set of tokens per call), and here
the port's decode is held against JAX's decode, each call with the same
tokens, at 2e-5.

Then JAX's refusals with their messages, the sampled path by its
properties (support of top-k and top-p, a seeded generator repeats, calls
without one differ), the restore of the port's own checkpoints (EMA too),
the generate CLI end to end, and the root ``tools/bench_compare.py`` on
the port bench's lines.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.inference import BeamConfig as JBeamConfig
from distributed_training_tpu.inference import BeamSearcher as JBeamSearcher
from distributed_training_tpu.inference import Generator as JGenerator
from distributed_training_tpu.inference import SampleConfig as JSampleConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.inference import (
    BeamConfig,
    BeamSearcher,
    CacheBudgetError,
    Generator,
    SampleConfig,
    apply_top_k,
    apply_top_p,
    cache_budget,
    sample_token,
)
from distributed_training_tpu_torch.inference import restore as restore_lib
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.parallel.ring_attention import KVCache

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 64
KW = dict(num_classes=VOCAB, num_layers=2, num_heads=2, hidden_dim=32, max_len=32)
MOE = dict(moe_num_experts=4, moe_top_k=2)
LOGIT_TOL = 2e-5


def _models(head_bias=False, **extra):
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, head_bias=head_bias,
                   **KW, **extra)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                                    train=False)["params"])
    rs = np.random.RandomState(1)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*np.shape(a))).astype(np.float32), params)
    tm = get_model("transformer_lm", logits_dtype=torch.float32, head_bias=head_bias,
                   **KW, **extra)
    bridge.load_flax_variables(tm, params)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def lm():
    return _models()


def _prompt(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, t)).astype(np.int32)


@pytest.mark.parametrize("b,t,n", [(1, 5, 12), (2, 5, 10), (3, 1, 8), (2, 16, 16)])
def test_greedy_tokens_equal_jax(lm, b, t, n):
    jm, params, tm = lm
    prompt = _prompt(b, t, seed=b + t)
    want = JGenerator(jm, params, JSampleConfig(max_new_tokens=n, temperature=0.0))(prompt)
    got = Generator(tm, SampleConfig(max_new_tokens=n, temperature=0.0))(prompt)
    assert got.shape == (b, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,n,penalty", [(1, 6, 0.0), (3, 6, 0.0), (4, 5, 1.0)])
def test_beam_search_equals_jax(lm, k, n, penalty):
    """Sequences equal JAX's, scores within 1e-4; distinct beams sorted
    best first; one beam is greedy."""
    jm, params, tm = lm
    prompt = _prompt(2, 4, seed=k)
    jseqs, jscores = JBeamSearcher(jm, params, JBeamConfig(
        num_beams=k, max_new_tokens=n, length_penalty=penalty))(prompt)
    seqs, scores = BeamSearcher(tm, BeamConfig(num_beams=k, max_new_tokens=n,
                                               length_penalty=penalty))(prompt)
    np.testing.assert_array_equal(seqs, jseqs)
    np.testing.assert_allclose(scores, jscores, rtol=1e-4, atol=1e-4)
    assert (np.diff(scores, axis=1) <= 0).all()
    assert all(len({tuple(s) for s in seqs[i]}) == k for i in range(2))
    if k == 1:
        greedy = Generator(tm, SampleConfig(max_new_tokens=n, temperature=0.0))(prompt)
        np.testing.assert_array_equal(seqs[:, 0], greedy)


def test_beam_eos_freezes_and_pads():
    """A head bias that makes EOS the argmax: every beam emits EOS then
    only pad; JAX's searcher agrees."""
    jm, params, tm = _models(head_bias=True)
    eos = 7
    params = jax.tree.map(lambda x: x, params)
    params["lm_head"] = dict(params["lm_head"])
    params["lm_head"]["bias"] = np.asarray(params["lm_head"]["bias"]).copy()
    params["lm_head"]["bias"][eos] += 1e4
    bridge.load_flax_variables(tm, params)
    prompt = _prompt(1, 3)
    cfg = dict(num_beams=2, max_new_tokens=4, eos_id=eos, pad_id=0)
    jseqs, jscores = JBeamSearcher(jm, params, JBeamConfig(**cfg))(prompt)
    seqs, scores = BeamSearcher(tm, BeamConfig(**cfg))(prompt)
    np.testing.assert_array_equal(seqs, jseqs)
    np.testing.assert_allclose(scores, jscores, rtol=1e-4, atol=1e-4)
    assert seqs[0, 0, 0] == eos and (seqs[0, 0, 1:] == 0).all()
    out = Generator(tm, SampleConfig(max_new_tokens=6, temperature=0.0, eos_id=eos))(
        np.array([[1, 2]]))
    assert out[0, 0] == eos and (out[0, 1:] == 0).all()


@pytest.mark.parametrize("chunks", [(8,), (3, 1, 1, 1, 1, 1), (5, 3), (1,) * 8])
def test_cached_decode_equals_the_full_forward_and_jax(lm, chunks):
    """Prefill and stepwise decode, in any chunking, give the full
    forward's logits at every position, and JAX's decode logits; the
    cache's index advances by each call's length."""
    jm, params, tm = lm
    tokens = _prompt(2, sum(chunks), seed=3)
    with torch.no_grad():
        full = tm(torch.from_numpy(tokens).long()).numpy()
        cache = tm.init_cache(2, 12)
        got, i = [], 0
        for c in chunks:
            pos = torch.arange(i, i + c).expand(2, c)
            got.append(tm(torch.from_numpy(tokens[:, i:i + c]).long(), pos, cache=cache))
            i += c
            assert cache.index == i
    got = torch.cat(got, 1).numpy()
    np.testing.assert_allclose(got, full, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    jdecode = jm.clone(cache_len=12)
    variables, want, i = {"params": params}, [], 0
    for c in chunks:
        out, mut = jdecode.apply(variables, jnp.asarray(tokens[:, i:i + c]),
                                 positions=jnp.broadcast_to(jnp.arange(i, i + c), (2, c)),
                                 train=False, decode=True, mutable=["cache"])
        variables = {"params": params, "cache": mut["cache"]}
        want.append(np.asarray(out))
        i += c
    np.testing.assert_allclose(got, np.concatenate(want, 1), rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_moe_decode_equals_jax(step):
    """MoE FFNs run position-wise over each call's tokens, their gate's
    capacity from that count (a one-token step keeps every choice): the
    port's prefill and decode steps against JAX's, call for call; and
    JAX's own tolerance against the full forward."""
    jm, params, tm = _models(**MOE)
    tokens = _prompt(2, 8, seed=7)
    jdecode = jm.clone(cache_len=16)
    out, mut = jdecode.apply({"params": params}, jnp.asarray(tokens),
                             positions=jnp.broadcast_to(jnp.arange(8), (2, 8)),
                             train=False, decode=True, mutable=["cache"])
    with torch.no_grad():
        cache = tm.init_cache(2, 16)
        got = tm(torch.from_numpy(tokens).long(), torch.arange(8).expand(2, 8), cache=cache)
        full = tm(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-4, atol=1e-4)
    if step == "prefill":
        np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=LOGIT_TOL, atol=LOGIT_TOL)
        return
    nxt = _prompt(2, 1, seed=8)
    jout, _ = jdecode.apply({"params": params, "cache": mut["cache"]}, jnp.asarray(nxt),
                            positions=jnp.full((2, 1), 8), train=False, decode=True,
                            mutable=["cache"])
    with torch.no_grad():
        got = tm(torch.from_numpy(nxt).long(), torch.full((2, 1), 8), cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(jout), rtol=LOGIT_TOL, atol=LOGIT_TOL)
    want = JGenerator(jm, params, JSampleConfig(max_new_tokens=6, temperature=0.0))(tokens)
    np.testing.assert_array_equal(
        Generator(tm, SampleConfig(max_new_tokens=6, temperature=0.0))(tokens), want)


def _jax_error(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("case", ["cache_overflow", "no_positions", "cache_len_above_max_len",
                                  "sequence_axis", "kv_dtype", "past_the_end",
                                  "straddling_the_end"])
def test_refusals_as_jax(lm, case):
    """JAX's refusals with its messages, word for word; past the end of
    the cache a call comes out NaN (whole, when a chunk straddles it)."""
    jm, params, tm = lm
    tok = torch.zeros((1, 1), dtype=torch.long)
    if case == "cache_overflow":
        want = _jax_error(lambda: JGenerator(jm, params, JSampleConfig(max_new_tokens=60))(
            np.zeros((1, 10), np.int32)))
        with pytest.raises(CacheBudgetError) as info:
            Generator(tm, SampleConfig(max_new_tokens=60))(np.zeros((1, 10), np.int32))
        assert str(info.value) == want and "exceeds the KV cache" in want
        assert cache_budget(tm) == 32 and cache_budget(tm, 20) == 20
    elif case == "no_positions":
        want = _jax_error(lambda: jm.apply({"params": params}, jnp.zeros((1, 1), jnp.int32),
                                           decode=True, mutable=["cache"]))
        with pytest.raises(ValueError) as info:
            tm(tok, cache=tm.init_cache(1, 4))
        assert str(info.value) == want
    elif case == "cache_len_above_max_len":
        want = _jax_error(lambda: jm.clone(cache_len=40).apply(
            {"params": params}, jnp.zeros((1, 1), jnp.int32), positions=jnp.zeros((1, 1), int),
            decode=True, mutable=["cache"]))
        with pytest.raises(ValueError) as info:
            tm.init_cache(1, 40)
        assert str(info.value) == want
    elif case == "sequence_axis":
        from distributed_training_tpu.inference.sampler import check_unsharded as jcheck
        from distributed_training_tpu_torch.inference.sampler import check_unsharded
        from distributed_training_tpu_torch.parallel.ring_attention import RingSelfAttention

        jsp = jax_model("transformer_lm", seq_axis="sequence", **KW)
        want = _jax_error(lambda: jcheck(jsp))
        with pytest.raises(ValueError) as info:
            check_unsharded(type("M", (), {"seq_axis": "sequence"})())
        assert str(info.value) == want and "seq_axis=None" in want
        attn = RingSelfAttention(32, 2, causal=True, axis_name="sequence", mesh=object())
        with pytest.raises(ValueError, match="does not compose with sequence-parallel"):
            attn(torch.zeros(1, 1, 32), cache=KVCache.empty(
                layers=1, batch=1, cache_len=4, heads=2, head_dim=16, dtype=torch.float32))
    elif case == "kv_dtype":
        want = _jax_error(lambda: jm.clone(kv_dtype="int8").apply(
            {"params": params}, jnp.zeros((1, 1), jnp.int32), positions=jnp.zeros((1, 1), int),
            decode=True, mutable=["cache"]))
        with pytest.raises(ValueError) as info:
            tm.init_cache(1, 4, kv_dtype="int8")
        assert str(info.value) == want
    else:
        n = tm.max_len if case == "past_the_end" else tm.max_len - 2
        tokens = torch.from_numpy(_prompt(1, n, seed=9)).long()
        with torch.no_grad():
            cache = tm.init_cache(1)
            tm(tokens, torch.arange(n)[None], cache=cache)
            t = 1 if case == "past_the_end" else 4
            out = tm(tokens[:, :t], (n + torch.arange(t))[None], cache=cache)
        assert torch.isnan(out).all()


def test_sampling_transforms_and_seeded_draws(lm):
    """top-k keeps the k largest; top-p the smallest prefix reaching p (the
    best always); both against JAX's transforms. A seeded generator
    repeats a draw; calls without one differ; every sampled token lies in
    the top-k support."""
    from distributed_training_tpu.inference import apply_top_k as japply_top_k
    from distributed_training_tpu.inference import apply_top_p as japply_top_p

    logits = np.random.RandomState(0).randn(4, VOCAB).astype(np.float32)
    for k in (1, 5, 100):
        np.testing.assert_array_equal(apply_top_k(torch.from_numpy(logits), k).numpy(),
                                      np.asarray(japply_top_k(jnp.asarray(logits), k)))
    for p in (0.05, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(apply_top_p(torch.from_numpy(logits), p).numpy(),
                                      np.asarray(japply_top_p(jnp.asarray(logits), p)))
    for bad, fn in ((0, apply_top_k), (1.5, apply_top_p)):
        with pytest.raises(ValueError):
            fn(torch.from_numpy(logits), bad)
    with pytest.raises(ValueError, match="temperature"):
        SampleConfig(temperature=-1)
    cfg = SampleConfig(temperature=0.8, top_k=5)
    draws = sample_token(torch.Generator().manual_seed(0), torch.from_numpy(logits).repeat(50, 1),
                         cfg).numpy().reshape(50, 4)
    top5 = np.argsort(-logits, -1)[:, :5]
    assert all(set(draws[:, i]) <= set(top5[i]) for i in range(4))
    assert len(set(draws[:, 0])) > 1
    only = sample_token(None, torch.from_numpy(logits), SampleConfig(top_p=1e-6))
    np.testing.assert_array_equal(only.numpy(), logits.argmax(-1))
    _, _, tm = lm
    gen = Generator(tm, SampleConfig(max_new_tokens=8, top_p=0.9), seed=3)
    prompt = _prompt(2, 4)
    a = gen(prompt, generator=torch.Generator().manual_seed(5))
    b = gen(prompt, generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a, b)
    c, d = gen(prompt), gen(prompt)
    assert not np.array_equal(c, d)
    e = Generator(tm, SampleConfig(max_new_tokens=8, top_p=0.9), seed=3)(prompt)
    np.testing.assert_array_equal(c, e)  # the same seed and call count


def _train(tmp_path, *extra):
    spec = importlib.util.spec_from_file_location(
        "port_gpt_cli_gen", os.path.join(ROOT, "gpt", "torch_cuda", "train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    ckpt = str(tmp_path / "ck")
    cli.main(["--device", "cpu", "-e", "1", "--steps-per-epoch", "2", "-b", "2",
              "--seq-len", "8", "--num-layers", "1", "--num-heads", "2", "--hidden-dim", "16",
              "--max-len", "32", "--log-interval", "1", "-i", "1", "--no-flight-recorder",
              "-c", ckpt,
              *extra])
    return ckpt


MODEL_FLAGS = dict(vocab_size=256, num_layers=1, num_heads=2, hidden_dim=16, max_len=32)


@pytest.mark.parametrize("ema", [False, True], ids=["raw", "ema"])
def test_restore_reads_the_gpt_clis_checkpoint(ema, tmp_path):
    """A checkpoint the GPT CLI wrote restores into a model that generates:
    the raw weights are the saved ones; with ``--ema-decay`` the EMA
    weights are the saved EMA slot; ``--use-ema`` without a decay, and
    flags that do not fit, exit with JAX's messages; no checkpoint gives
    the seeded random init."""
    from distributed_training_tpu_torch import checkpoint as ckpt_lib

    ckpt = _train(tmp_path, *(["--ema-decay", "0.9"] if ema else []))
    lines = []
    model, epoch = restore_lib.build_lm_and_restore(
        **MODEL_FLAGS, checkpoint=ckpt, ema_decay=0.9 if ema else None, use_ema=ema,
        device="cpu", printer=lines.append)
    assert epoch == 0 and lines[0] == f"restored epoch 0 from {ckpt}"
    saved = torch.load(os.path.join(ckpt, "epoch_0", ckpt_lib.PAYLOAD),
                       weights_only=True)["state"]
    want = saved["opt_state"]["ema"] if ema else saved["model"]
    for n, p in model.named_parameters():
        assert torch.equal(p.detach().reshape(-1), want[n].reshape(-1)), n
    out = Generator(model, SampleConfig(max_new_tokens=4, temperature=0.0))(np.array([1, 2]))
    assert out.shape == (1, 4)
    with pytest.raises(SystemExit, match="--use-ema requires --ema-decay"):
        restore_lib.build_lm_and_restore(**MODEL_FLAGS, checkpoint=ckpt, use_ema=True,
                                         device="cpu")
    with pytest.raises(SystemExit, match="model flags must mirror the training run"):
        restore_lib.build_lm_and_restore(**{**MODEL_FLAGS, "hidden_dim": 32}, checkpoint=ckpt,
                                         ema_decay=0.9 if ema else None, device="cpu")
    lines = []
    _, epoch = restore_lib.build_lm_and_restore(**MODEL_FLAGS, checkpoint=str(tmp_path / "no"),
                                                device="cpu", printer=lines.append)
    assert epoch == -1 and "seeded random init" in lines[0]
    assert restore_lib.moe_kwargs_from_flags(enabled=False, num_experts=[8], top_k=1,
                                             min_capacity=0, mlp_type="standard") == {}
    assert restore_lib.moe_kwargs_from_flags(
        enabled=True, num_experts=[4, 8], top_k=2, min_capacity=1, mlp_type="residual") == dict(
        moe_num_experts=(4, 8), moe_top_k=2, moe_min_capacity=1, moe_mlp_type="residual")


def _generate_cli():
    spec = importlib.util.spec_from_file_location(
        "port_generate", os.path.join(ROOT, "gpt", "torch_cuda", "generate.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_generate_cli_flags_are_the_jax_clis(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "jax_generate", os.path.join(ROOT, "gpt", "jax_tpu", "generate.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    monkeypatch.setattr(sys, "argv", ["generate.py"])
    want = vars(jcli.add_argument())
    got = vars(_generate_cli().build_parser().parse_args([]))
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("mode", [["--temperature", "0"], ["--num-beams", "2"],
                                  ["--top-k", "5", "--temperature", "0.7"]],
                         ids=["greedy", "beam", "sampled"])
def test_generate_cli_end_to_end(mode, tmp_path):
    """``gpt/torch_cuda/generate.py`` on a checkpoint the port's GPT CLI
    wrote, byte-level: it restores epoch 0 and prints the completion."""
    ckpt = _train(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = _generate_cli().main(["--device", "cpu", "-c", ckpt, "--num-layers", "1",
                                   "--num-heads", "2", "--hidden-dim", "16", "--max-len", "32",
                                   "--prompt", "Hi ", "--max-new-tokens", "6", *mode])
    text = buf.getvalue()
    assert rc == 0 and f"restored epoch 0 from {ckpt}" in text
    assert ("beam 1 (score" in text) if "--num-beams" in mode else ("'Hi ' -> " in text)


def test_bench_compare_reads_the_port_bench_lines(tmp_path):
    """The root ``tools/bench_compare.py`` (standard library only) gates
    the port bench's lines by their ``value``: equal lines pass, a halved
    throughput exits 1 naming the metric."""
    from distributed_training_tpu_torch import bench

    (line, _), = bench.main(["--device", "cpu", "--model", "resnet_micro", "--batch-size", "4",
                             "--image-size", "32", "--num-classes", "10", "--warmup", "0",
                             "--steps", "1", "--sync-interval", "1", "--steps-per-call", "1",
                             "--image"])
    spec = importlib.util.spec_from_file_location(
        "bench_compare", os.path.join(ROOT, "tools", "bench_compare.py"))
    compare = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(compare)
    base, same, slow = (tmp_path / n for n in ("base.json", "same.json", "slow.json"))
    base.write_text(json.dumps(line) + "\n")
    same.write_text(json.dumps(line) + "\n")
    slow.write_text(json.dumps({**line, "value": line["value"] / 2}) + "\n")
    with contextlib.redirect_stdout(io.StringIO()):
        assert compare.main([str(base), str(same)]) == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert compare.main([str(base), str(slow)]) == 1
    assert "value" in buf.getvalue() and line["metric"] in buf.getvalue()
