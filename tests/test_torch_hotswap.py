"""The port's live weight hot swap (``serving/hotswap.py`` and the
engine's barrier) against the JAX package's.

At micro size (``transformer_lm`` with 2 layers, 2 heads, hidden 32,
vocab 61, max_len 64): two seeded weight sets, epoch 1 (seed 0) and
epoch 2 (seed 1), carried into JAX's trees through ``bridge.py``.

1. **The barrier**: the same request script with epoch 2 armed after the
   same iteration in both packages' engines (prefix cache on): the same
   tokens for every request (those in flight at the barrier continue on
   the new weights), the same swap counters and epoch, and the trie
   flushed at the barrier alike. Requests admitted after the barrier
   equal a fresh engine on epoch 2's weights; ``rollback()`` re-arms
   epoch 1 and its set serves again.
2. **The pipeline** (the port's own checkpoints): ``HotSwapper.poll_once``
   quarantines a corrupt newer save and arms the newest good one; a
   staging read failed by chaos (``ChaosConfig.swap_error_rate``) is
   rejected at stage "stage" and retried on the next poll; a candidate of
   another shape is rejected at "validate".
3. **What rides the barrier**: a quantizing engine quantizes a float32
   candidate at arm time; the GPT self-drafter follows the new weights
   and speculation stays lossless across the swap.

One JAX engine run serves the module.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import ServeConfig as JServeConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.serving import Engine as JEngine
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch import checkpoint as ckpt_lib
from distributed_training_tpu_torch.config import (
    ChaosConfig,
    OptimizerConfig,
    PrecisionConfig,
    SchedulerConfig,
    ServeConfig,
)
from distributed_training_tpu_torch.inference.restore import build_lm_and_restorer
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.resilience import chaos
from distributed_training_tpu_torch.resilience.errors import SwapError
from distributed_training_tpu_torch.serving import Engine, HotSwapper, committed_epochs
from distributed_training_tpu_torch.serving import quantize as tq

torch.set_num_threads(1)

VOCAB = 61
LM = dict(num_classes=VOCAB, num_layers=2, num_heads=2, hidden_dim=32, max_len=64,
          head_bias=True)
N_NEW = 8
SWAP_AT = 12  # iterations before the barrier: the first requests have finished
PROMPTS = [np.random.RandomState(u).randint(0, VOCAB, size=n).astype(np.int32)
           for u, n in enumerate((9, 5, 9, 6, 9, 7))]
LATE = 2  # requests submitted after the barrier
CFG = dict(max_batch=2, prefill_bucket=8, max_new_tokens=N_NEW, prefill_chunk=4,
           kv_page_size=4)


def _model(seed=0):
    return get_model("transformer_lm", generator=torch.Generator().manual_seed(seed),
                     **LM).eval()


def _fresh_set(seed):
    return {n: p.detach().clone() for n, p in tq.serving_params(_model(seed)).items()}


def _script(eng, arm):
    """Serve PROMPTS but the last LATE; arm epoch 2 after SWAP_AT
    iterations; submit the LATE ones after the barrier; run out."""
    for p in PROMPTS[:-LATE]:
        eng.submit(p)
    done = []
    for _ in range(SWAP_AT):
        done += eng.step()
    held_before = eng.prefix_cache.num_pages
    arm(eng)
    done += eng.step()  # the barrier
    held_after = eng.prefix_cache.num_pages
    for p in PROMPTS[-LATE:]:
        eng.submit(p)
    done += eng.run()
    eng.check_balanced()
    return {f.uid: np.asarray(f.tokens).tolist() for f in done}, (held_before, held_after)


@pytest.fixture(scope="module")
def jax_swap():
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM)
    p1, p2 = (jax.tree.map(jnp.asarray, bridge.state_dict_to_flax(_model(s))[0])
              for s in (0, 1))
    eng = JEngine(jm, p1, JServeConfig(prefix_cache=True, **CFG), weights_epoch=1)
    out, held = _script(eng, lambda e: e.arm_swap(p2, epoch=2))
    return out, held, eng.stats()


@pytest.fixture(scope="module")
def port_swap():
    eng = Engine(_model(0), ServeConfig(prefix_cache=True, **CFG), weights_epoch=1)
    first = eng.params
    out, held = _script(eng, lambda e: e.arm_swap(_fresh_set(1), epoch=2))
    return eng, first, out, held


def test_barrier_matches_jax(port_swap, jax_swap):
    eng, _, out, held = port_swap
    jout, jheld, jstats = jax_swap
    assert out == jout
    assert held == jheld and held[0] > 0 and held[1] == 0  # the trie flushed
    stats = eng.stats()
    for k in ("swaps_completed", "weights_epoch", "prefix_cache_hit_tokens",
              "prefix_cache_pages_held", "tokens_emitted"):
        assert stats[k] == jstats[k], k
    assert stats["swaps_completed"] == 1 and stats["swap_blocked_s"] > 0


def test_late_requests_equal_a_fresh_engine_on_the_new_weights(port_swap):
    _, _, out, _ = port_swap
    fresh = Engine(_model(1), ServeConfig(**CFG))
    late = range(len(PROMPTS) - LATE, len(PROMPTS))
    for p in PROMPTS[:-LATE]:
        fresh.submit(p)  # the same uids
    fresh.run()
    for p in PROMPTS[-LATE:]:
        fresh.submit(p)
    got = {f.uid: f.tokens.tolist() for f in fresh.run()}
    assert {u: out[u] for u in late} == {u: got[u] for u in late}


def test_rollback_rearms_the_previous_weights(port_swap):
    eng, first, _, _ = port_swap
    assert eng.rollback() == 1
    assert eng.phase == "swapping"
    eng.step()
    assert eng.weights_epoch == 1 and all(eng.params[n] is first[n] for n in first)
    toks = torch.arange(7)[None] % VOCAB
    with torch.no_grad():
        np.testing.assert_array_equal(eng.model(toks).numpy(), _model(0)(toks).numpy())
    assert eng.stats()["swaps_completed"] == 2


# -- the pipeline --------------------------------------------------------------
def _save(directory, epoch, seed):
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.train_state import TrainState

    tx = make_optimizer(OptimizerConfig(), SchedulerConfig(), world_size=1)
    state = TrainState.create(_model(seed), tx, LossScaleState.create(PrecisionConfig()))
    return ckpt_lib.save_checkpoint(directory, epoch, state)


@pytest.fixture()
def watched(tmp_path):
    d = str(tmp_path / "ck")
    _save(d, 1, 0)
    _save(d, 2, 1)
    model, epoch, restore_fn = build_lm_and_restorer(
        vocab_size=VOCAB, num_layers=2, num_heads=2, hidden_dim=32, max_len=64,
        head_bias=True, logits_dtype="fp32", checkpoint=d, resume=1, device="cpu",
        printer=lambda m: None)
    eng = Engine(model, ServeConfig(**CFG), weights_epoch=epoch)
    return d, eng, HotSwapper(eng, d, lambda e: restore_fn(e, d), printer=lambda m: None)


def test_poll_quarantines_corrupt_and_arms_newest_good(watched):
    d, eng, swapper = watched
    chaos.corrupt_committed_checkpoint(_save(d, 3, 2))
    assert committed_epochs(d) == [3, 2, 1]
    assert swapper.poll_once() == 2
    assert os.path.isdir(os.path.join(d, "epoch_3.corrupt"))
    assert eng.stats()["swaps_rejected"] == 1 and eng.last_swap_error.stage == "verify"
    eng.step()
    assert eng.weights_epoch == 2
    toks = torch.arange(5)[None]
    with torch.no_grad():
        np.testing.assert_array_equal(eng.model(toks).numpy(), _model(1)(toks).numpy())
    assert swapper.poll_once() is None  # nothing newer


def test_chaos_staging_fault_is_retried(watched):
    _, eng, swapper = watched
    chaos.install(chaos.ChaosMonkey(ChaosConfig(swap_error_rate=1.0)))
    try:
        assert swapper.poll_once() is None
        assert swapper.last_error.stage == "stage"
        assert swapper.poll_once() == 2  # the fault is one-shot a key
    finally:
        chaos.uninstall()
    assert eng.stats()["swaps_rejected"] == 1


def test_mismatched_candidate_is_rejected(watched):
    _, eng, _ = watched
    bad = _fresh_set(0)
    bad["lm_head.kernel"] = torch.zeros(3, 3)
    with pytest.raises(SwapError, match="leaf shapes/dtypes differ") as e:
        eng.arm_swap(bad, epoch=9)
    assert e.value.stage == "arm" and eng.phase != "swapping"
    with pytest.raises(SwapError, match="names"):
        eng.validate_swap({"nope": torch.zeros(1)})


# -- what rides the barrier ----------------------------------------------------
def test_quantizing_engine_quantizes_at_arm():
    eng = Engine(_model(0), ServeConfig(quantize_weights=True, **CFG), weights_epoch=1)
    t0 = eng.stats()["weight_quant_s"]
    new = _fresh_set(1)
    eng.arm_swap(new, epoch=2)
    staged = eng._pending_swap[0]
    want = tq.quantize_params(new)
    for n, v in want.items():
        if isinstance(v, tq.QuantizedTensor):
            np.testing.assert_array_equal(staged[n].q.numpy(), v.q.numpy())
    eng.step()
    assert eng.weights_epoch == 2 and eng.stats()["weight_quant_s"] > t0
    assert isinstance(eng.model.block0.attn.qkv.kernel, tq.QuantizedTensor)
    # The rollback's set is already quantized: it arms as it is.
    assert eng.rollback() == 1


def test_gpt_drafter_follows_the_swap():
    """The self-drafter drafts with the installed weights; the requests
    admitted after the barrier get the plain engine's tokens (those in
    flight met the barrier at other positions: speculation ran ahead)."""
    outs = []
    for kw in ({}, {"spec_k": 2, "spec_drafter": "gpt"}):
        eng = Engine(_model(0), ServeConfig(prefix_cache=True, **CFG, **kw), weights_epoch=1)
        out = _script(eng, lambda e: e.arm_swap(_fresh_set(1), epoch=2))[0]
        outs.append({u: out[u] for u in range(len(PROMPTS) - LATE, len(PROMPTS))})
        if kw:
            assert eng.drafter.epoch == 2 and eng.drafter.model is eng.model
            assert eng.stats()["accepted_tokens"] > 0
    assert outs[0] == outs[1]
