"""The port's write-ahead request journal (``serving/journal.py``) and
``Engine.recover`` against the JAX package's.

1. **The journal alone**: the same call script (admits, token batches, a
   preemption, finishes, acks, notes, rotation under a small segment
   size) through both packages' ``RequestJournal``; a fresh journal of
   each recovers a ``RecoveredState`` equal to the other's, wall-clock
   fields aside. A torn tail is truncated and quarantined alike, and a
   fingerprint that differs from the journaled one raises the typed
   ``JournalCorruptError`` in both.
2. **Crash and recovery in the engine** (micro ``transformer_lm``: 2
   layers, 2 heads, hidden 32, vocab 61; the port's seeded weights carried
   into JAX's tree through ``bridge.py``): the same request script, the
   writer paused so what is durable at the crash is fixed, the crash
   after the same iteration in both engines; the journals recover equal
   states, and the port's engine recovered and run to the end completes
   every request exactly once with the tokens of an uninterrupted run,
   greedy and sampled, paged and legacy, speculation on.

One JAX engine run serves the module.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu.config import ServeConfig as JServeConfig
from distributed_training_tpu.models import get_model as jax_model
from distributed_training_tpu.resilience.errors import JournalCorruptError as JCorrupt
from distributed_training_tpu.serving import Engine as JEngine
from distributed_training_tpu.serving import journal as jj
from distributed_training_tpu_torch import bridge
from distributed_training_tpu_torch.config import ServeConfig
from distributed_training_tpu_torch.models import get_model
from distributed_training_tpu_torch.resilience.errors import JournalCorruptError
from distributed_training_tpu_torch.serving import Engine
from distributed_training_tpu_torch.serving import journal as tj
from distributed_training_tpu_torch.serving.request import ActiveSequence, Request

torch.set_num_threads(1)

VOCAB = 61
LM = dict(num_classes=VOCAB, num_layers=2, num_heads=2, hidden_dim=32, max_len=64,
          head_bias=True)
N_NEW = 8
WALL = ("arrival_wall", "first_wall", "last_wall")


def _model():
    return get_model("transformer_lm", generator=torch.Generator().manual_seed(0), **LM).eval()


def _state(st) -> dict:
    """A RecoveredState as a plain dict, the wall-clock fields out."""
    reqs = {}
    for uid, r in st.requests.items():
        d = dataclasses.asdict(r)
        for k in WALL:
            d[k] = d[k] is not None
        reqs[uid] = d
    return {"requests": reqs, "notes": st.notes, "max_uid": st.max_uid,
            "records_replayed": st.records_replayed, "torn_bytes": st.torn_bytes}


# -- the journal alone ---------------------------------------------------------
def _script(mod, path):
    """One call script through a package's journal; its own recovery."""
    j = mod.RequestJournal(path, fsync="none", segment_bytes=4096,
                           fingerprint={"seed": 1})
    j.recover()
    j.pause()
    seqs = []
    for uid in range(6):
        req = Request(uid=uid, prompt=np.arange(uid + 3, dtype=np.int32) * 7,
                      max_new_tokens=40, arrival_t=1.0 + uid, deadline_t=30.0 + uid,
                      priority=uid % 2, tenant=f"t{uid % 3}")
        j.log_admit(req)
        seqs.append(ActiveSequence(request=req, slot=uid % 2))
    for step in range(30):
        for s in seqs[:4]:
            s.note_token(step * 3 + s.request.uid, 2.0 + step)
            j.note_tokens(s)
        if step == 5:
            j.note_preempt(seqs[1])
        if step % 4 == 0:
            j.persist()
        j.log_note({"cursor": step}, flush=False)
    fin = type("Fin", (), dict(uid=0, finish_reason="length", tokens=seqs[0].tokens,
                               ttft_ms=1.5, tpot_ms=0.25))
    j.note_finish(fin)
    j.persist()
    j.ack([0])
    j.note_finish(type("Fin", (), dict(uid=2, finish_reason="eos", tokens=seqs[2].tokens[:3],
                                       ttft_ms=2.0, tpot_ms=None)))
    j.persist()
    rotated = j.segments_rotated
    j.shutdown()
    return mod.RequestJournal(path, fingerprint={"seed": 1}).recover(), rotated


def test_journal_script_recovers_as_jax_s(tmp_path):
    mine, rot = _script(tj, str(tmp_path / "port"))
    theirs, jrot = _script(jj, str(tmp_path / "jax"))
    assert rot == jrot and rot > 0  # the 4096-byte segments rotated
    assert _state(mine) == _state(theirs)
    assert mine.requests[1].preempts == 1 and 0 not in mine.requests
    assert mine.requests[2].finish_reason == "eos"


def test_torn_tail_and_fingerprint_as_jax(tmp_path):
    torn = {}
    for name, mod in (("port", tj), ("jax", jj)):
        d = str(tmp_path / name)
        _script(mod, d)
        seg = sorted(f for f in os.listdir(d) if f.endswith(".log"))[-1]
        with open(os.path.join(d, seg), "ab") as fh:
            fh.write(b"\x07\x00\x00\x00garbage-tail")
        st = mod.RequestJournal(d, fingerprint={"seed": 1}).recover()
        torn[name] = (st.torn_bytes, _state(st)["requests"],
                      sorted(f for f in os.listdir(d) if ".corrupt" in f))
    assert torn["port"] == torn["jax"] and torn["port"][0] > 0
    with pytest.raises(JournalCorruptError, match="different RNG"):
        tj.RequestJournal(str(tmp_path / "port"), fingerprint={"seed": 2}).recover()
    with pytest.raises(JCorrupt, match="different RNG"):
        jj.RequestJournal(str(tmp_path / "jax"), fingerprint={"seed": 2}).recover()
    j = tj.RequestJournal(str(tmp_path / "fresh"))
    with pytest.raises(JournalCorruptError, match="has not been recovered"):
        j.log_note({"a": 1})


# -- crash and recovery in the engine ------------------------------------------
PROMPTS = [np.random.RandomState(1).randint(0, VOCAB, size=n).astype(np.int32)
           for n in (3, 5, 9, 5, 3, 9)]
CRASH_AFTER, DURABLE_AT = 9, 6  # iterations


def _crash_run(eng):
    """The request script up to the crash: the writer paused, the journal
    persisted after DURABLE_AT iterations, the crash after CRASH_AFTER
    (the records of the iterations between are lost)."""
    eng.recover()
    eng.journal.pause()
    for p in PROMPTS:
        eng.submit(p)
    done = []
    for it in range(CRASH_AFTER):
        done += eng.step()
        if it + 1 == DURABLE_AT:
            eng.journal.persist()
    eng.journal.crash()
    return done


CFG = dict(max_batch=2, prefill_bucket=8, max_new_tokens=N_NEW, prefill_chunk=4)


@pytest.fixture(scope="module")
def jax_crash(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_journal"))
    params, _ = bridge.state_dict_to_flax(_model())
    jm = jax_model("transformer_lm", logits_dtype=jnp.float32, **LM)
    eng = JEngine(jm, jax.tree.map(jnp.asarray, params), JServeConfig(journal_dir=d, **CFG))
    _crash_run(eng)
    return d


def _uninterrupted(**kw):
    eng = Engine(_model(), ServeConfig(**{**CFG, **kw}))
    for p in PROMPTS:
        eng.submit(p)
    return {f.uid: f.tokens.tolist() for f in eng.run()}


def _crash_and_recover(d, **kw):
    cfg = ServeConfig(journal_dir=d, **{**CFG, **kw})
    before = _crash_run(Engine(_model(), cfg))
    eng = Engine(_model(), cfg)
    report = eng.recover()
    after = report["redelivered"] + report["completed_at_replay"] + eng.run()
    eng.check_balanced()
    eng.journal.shutdown()
    return before, after, report, eng.stats()


def test_recovered_state_equals_jax_s(jax_crash, tmp_path):
    d = str(tmp_path / "port")
    _crash_run(Engine(_model(), ServeConfig(journal_dir=d, **CFG)))
    fp = dict(seed=0, temperature=0.0, top_k=None, top_p=None, eos_id=None, pad_id=0,
              quantize_weights=False, kv_dtype=None, weights_epoch=-1)
    mine = tj.RequestJournal(d, fingerprint=fp).recover()
    theirs = jj.RequestJournal(jax_crash, fingerprint=fp).recover()
    assert _state(mine) == _state(theirs)
    assert any(r.tokens for r in mine.requests.values())


@pytest.mark.parametrize("kw", [{}, {"temperature": 1.0, "top_k": 10, "seed": 3},
                                {"kv_page_size": None}, {"spec_k": 2}],
                         ids=["greedy", "sampled", "legacy", "spec"])
def test_crash_then_recover_equals_uninterrupted(tmp_path, kw):
    want = _uninterrupted(**kw)
    before, after, report, stats = _crash_and_recover(str(tmp_path / "j"), **kw)
    # Every request completes once in the recovered process: finished
    # before the crash and durable (redelivered, never acked), or resumed.
    assert sorted(f.uid for f in after) == sorted(want)
    assert {f.uid for f in before} <= {f.uid for f in after}
    assert {f.uid: f.tokens.tolist() for f in after} == want
    assert report["resumed"] > 0 and stats["requests_recovered"] == len(want)
    assert stats["tokens_recomputed_on_recovery"] > 0


def test_deadline_expired_during_downtime_completes_at_replay(tmp_path, monkeypatch):
    import distributed_training_tpu_torch.serving.engine as engine_mod

    d = str(tmp_path / "j")
    cfg = ServeConfig(journal_dir=d, deadline_ms=1e4, **CFG)
    _crash_run(Engine(_model(), cfg))
    # The clock ran on while the engine was down: every journaled instant
    # lands 1000 s in the new process's past, past every deadline.
    real = engine_mod.perf_of
    monkeypatch.setattr(engine_mod, "perf_of", lambda w: real(w) - 1e3)
    eng = Engine(_model(), cfg)
    report = eng.recover()
    assert report["resumed"] == 0
    assert {f.finish_reason for f in report["completed_at_replay"]} <= {"timeout",
                                                                       "preempted_timeout"}
    assert len(report["completed_at_replay"]) + len(report["redelivered"]) == len(PROMPTS)
    assert eng.idle
    eng.journal.shutdown()
