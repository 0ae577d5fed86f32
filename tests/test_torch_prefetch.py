"""The device prefetcher (``data/prefetch.py``) and the trainers' batches
through it, on the CPU:

- order and values kept, at most ``depth`` placed batches waiting (and one
  being placed), an exception in the loader raised at the consumer's next
  batch after the ones before it, the worker stopping when the consumer
  leaves the loop, ``depth < 1`` refused;
- ``Trainer.fit()`` over a decoded imagefolder cache and ``LMTrainer.fit()``
  give equal losses at ``data.prefetch`` 0 and 2, and at 0 each batch's
  load and copy land in the wall clock's ``data`` phase;
- on the card (``cuda`` marker): a consumer slower than the copies
  (``torch.cuda._sleep`` on its stream) receives every batch intact, the
  copies issued on the prefetcher's own stream.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_training_tpu_torch import LMTrainer, Trainer
from distributed_training_tpu_torch.config import DataConfig, LMConfig, OptimizerConfig, TrainConfig
from distributed_training_tpu_torch.data.prefetch import DevicePrefetcher, prefetch_to_device
from torch_image_tree import write_tree

torch.set_num_threads(1)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"image": rng.randint(0, 256, (3, 4, 4, 3)).astype(np.uint8),
             "label": np.full(3, i, np.int32)} for i in range(n)]


def _workers_alive() -> int:
    return sum(t.name == "DevicePrefetcher" and t.is_alive() for t in threading.enumerate())


def _wait_workers_gone(timeout=5.0) -> bool:
    deadline = time.monotonic() + timeout
    while _workers_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    return _workers_alive() == 0


def test_order_and_values_are_kept():
    batches = _batches(7)
    got = list(prefetch_to_device(batches, torch.device("cpu"), depth=3))
    assert len(got) == 7
    for g, b in zip(got, batches):
        for k in b:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), b[k])
    assert _wait_workers_gone()


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_the_worker_stays_at_most_depth_ahead(depth):
    produced = []

    def loader():
        for i in range(12):
            produced.append(i)
            yield i

    ahead = []
    for i in DevicePrefetcher(loader(), lambda b: b, depth=depth):
        # A slow consumer: the worker fills the queue and waits.
        time.sleep(0.5 if i == 0 else 0.01)
        ahead.append(len(produced) - (i + 1))
    # The queue's depth, plus the batch the worker holds while it waits.
    assert ahead[0] == depth + 1 and max(ahead) <= depth + 1 and min(ahead) >= 0
    assert _wait_workers_gone()


def test_a_loader_error_reaches_the_consumer_after_the_earlier_batches():
    def loader():
        yield from range(3)
        raise OSError("disk gone")

    got = []
    with pytest.raises(OSError, match="disk gone"):
        for b in DevicePrefetcher(loader(), lambda b: b * 10, depth=2):
            got.append(b)
    assert got == [0, 10, 20]
    assert _wait_workers_gone()


def test_a_place_error_reaches_the_consumer():
    def place(b):
        if b == 2:
            raise ValueError("bad batch")
        return b

    with pytest.raises(ValueError, match="bad batch"):
        list(DevicePrefetcher(range(5), place, depth=1))


def test_leaving_the_loop_stops_the_worker():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    it = iter(DevicePrefetcher(endless(), lambda b: b, depth=2))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert _wait_workers_gone()


def test_depth_below_one_is_refused():
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher([], lambda b: b, depth=0)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("tree"))


def _image_run(tree, tmp_path, prefetch, breakdown=False):
    cfg = TrainConfig(
        model="resnet_micro", num_epochs=2, log_interval=1, seed=3,
        wall_clock_breakdown=breakdown, eval_precise_bn_batches=1,
        optimizer=OptimizerConfig(name="hybrid_adam"),
        data=DataConfig(dataset="imagefolder", data_path=tree, decoded_cache=True,
                        num_classes=2, image_size=16, batch_size=4, num_workers=2,
                        prefetch=prefetch))
    cfg = cfg.replace(checkpoint=cfg.checkpoint.__class__(directory=str(tmp_path), interval=0))
    trainer = Trainer(cfg, device="cpu")
    return trainer, trainer.fit()


def test_trainer_losses_equal_at_prefetch_0_and_2(tree, tmp_path, capsys):
    t0, out0 = _image_run(tree, tmp_path / "p0", 0, breakdown=True)
    clock = [line for line in capsys.readouterr().out.splitlines() if "[wall_clock]" in line]
    assert len(clock) == 2 and all("'data':" in line for line in clock)
    t2, out2 = _image_run(tree, tmp_path / "p2", 2)
    assert out0["steps"] == out2["steps"] == 6
    assert [h["loss"] for h in t0.meter.history] == [h["loss"] for h in t2.meter.history]
    assert out0["final_acc"] == out2["final_acc"]
    for n, p in t0.model.named_parameters():
        assert torch.equal(p, dict(t2.model.named_parameters())[n]), n
    assert _wait_workers_gone()


def test_lm_trainer_losses_equal_at_prefetch_0_and_2(tmp_path):
    runs = []
    for prefetch in (0, 2):
        cfg = TrainConfig(
            num_epochs=1, log_interval=1, seed=1,
            optimizer=OptimizerConfig(name="adamw", lr=1e-3),
            lm=LMConfig(seq_len=16, vocab_size=64, num_layers=1, num_heads=2, hidden_dim=16,
                        max_len=16, train_sequences=24, eval_sequences=8),
            data=DataConfig(batch_size=4, prefetch=prefetch))
        cfg = cfg.replace(checkpoint=cfg.checkpoint.__class__(
            directory=str(tmp_path / str(prefetch)), interval=0))
        trainer = LMTrainer(cfg, device="cpu")
        out = trainer.fit()
        runs.append(([h["loss"] for h in trainer.meter.history], out["final_perplexity"]))
    assert runs[0] == runs[1] and len(runs[0][0]) == 6
    assert _wait_workers_gone()


@pytest.mark.cuda
def test_slow_consumer_receives_every_batch_intact_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    batches = [{"image": rng.randint(0, 256, (32, 64, 64, 3)).astype(np.uint8),
                "label": np.arange(32, dtype=np.int32) + i} for i in range(10)]
    pf = prefetch_to_device(batches, torch.device("cuda"), depth=3)
    got = []
    for b in pf:
        torch.cuda._sleep(50_000_000)  # the step's stream is busy ~30 ms
        got.append({k: (v.float() * 1).cpu().numpy() for k, v in b.items()})
    assert len(got) == 10
    for g, b in zip(got, batches):
        for k in b:
            np.testing.assert_array_equal(g[k], b[k].astype(np.float32))
    assert pf.stager.copies == 20
    assert pf.stager.stream is not None
    assert pf.stager.stream != torch.cuda.current_stream()
