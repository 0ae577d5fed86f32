"""The port's ResNet CLI (``resnet/torch_cuda/train.py``) and
``from_ds_config`` against the JAX package's on the CPU.

- ``from_ds_config`` on the reference's in-code ds_config (the JAX CLI's
  ``default_ds_config``, every dtype and ZeRO stage) and on variants of
  it gives the JAX package's fields; unknown keys raise in both, and what
  asks for a behaviour the port lacks raises ``NotImplementedError``.
- The CLI parses the JAX CLI's flags with its names and defaults (plus
  ``--device``), builds the same config
  from the same command line (every flag of the JAX CLI, the span trace's,
  the live exporter's and the chaos flags included), and trains through
  ``Trainer.fit()``.
"""

import contextlib
import dataclasses
import importlib.util
import json
import os

import pytest
import torch

from distributed_training_tpu import config as jcfg
from distributed_training_tpu_torch import config as tcfg

# The suite runs several pytest workers on one host: torch's intra-op
# thread pool in each of them would oversubscribe the cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# TrainConfig fields both packages have and a ds_config or the CLI sets.
FIELDS = ("model", "plugin", "num_epochs", "gradient_accumulation_steps", "label_smoothing",
          "seed", "log_interval", "target_acc", "optimizer", "scheduler", "precision",
          "zero", "checkpoint", "data", "remat", "wall_clock_breakdown", "observability",
          "chaos")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_CLI = _load("resnet/jax_tpu/train.py", "jax_cli")
PORT_CLI = _load("resnet/torch_cuda/train.py", "port_cli")


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if dataclasses.is_dataclass(x):
            x, y = dataclasses.asdict(x), dataclasses.asdict(y)
            assert set(y) <= set(x), f  # the port's fields are the JAX package's
            x = {k: v for k, v in x.items() if k in y}
        assert x == y, f


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "fp16"])
def test_reference_ds_config_maps_as_in_jax(dtype, stage):
    ds = JAX_CLI.default_ds_config(dtype, stage, 96)
    _same(jcfg.from_ds_config(ds), tcfg.from_ds_config(ds))


@pytest.mark.parametrize("change", [
    {"optimizer": {"type": "SGD", "params": {"lr": 0.1, "momentum": 0.8, "nesterov": True}}},
    {"optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.05}}},
    {"optimizer": {"type": "Lamb", "params": {"lr": 1e-2}}},
    {"fp16": {"enabled": True, "loss_scale": 128}},
    {"train_micro_batch_size_per_gpu": 32, "gradient_accumulation_steps": 4},
    {"activation_checkpointing": {"partition_activations": False}},
], ids=["sgd", "adamw", "lamb", "static_fp16", "batch_triple", "ac_off"])
def test_ds_config_variants_map_as_in_jax(change):
    ds = {**JAX_CLI.default_ds_config("fp32", 1, 96), **change}
    warns = lambda: (pytest.warns(UserWarning, match="remat stays OFF")  # noqa: E731
                     if "activation_checkpointing" in change else contextlib.nullcontext())
    with warns():
        want = jcfg.from_ds_config(ds)
    with warns():
        got = tcfg.from_ds_config(ds)
    _same(want, got)


@pytest.mark.parametrize("bad", [{"zero_optimization": {"stage": 1, "bogus": 1}},
                                 {"not_a_key": 1}, {"optimizer": {"type": "Adagrad"}},
                                 {"scheduler": {"type": "OneCycle"}}])
def test_invalid_ds_config_raises_in_both(bad):
    ds = {**JAX_CLI.default_ds_config("fp32", 0, 96), **bad}
    with pytest.raises(ValueError):
        jcfg.from_ds_config(ds)
    with pytest.raises(ValueError):
        tcfg.from_ds_config(ds)


@pytest.mark.parametrize("lacking", [{"activation_checkpointing": {"enabled": True}},
                                     {"wall_clock_breakdown": True}])
def test_ds_config_asking_for_what_the_port_lacks_raises(lacking):
    """Named for the refusal it checked until remat and the wall-clock
    breakdown were ported: both now map as in the JAX package."""
    ds = {**JAX_CLI.default_ds_config("fp32", 0, 96), **lacking}
    want, got = jcfg.from_ds_config(ds), tcfg.from_ds_config(ds)
    _same(want, got)
    assert got.remat or got.wall_clock_breakdown


@pytest.mark.parametrize("ac", [
    {"enabled": False, "partition_activations": True}, {"number_checkpoints": 4},
    {"cpu_checkpointing": False, "profile": True}, True, False,
], ids=["enabled_false_wins", "number_checkpoints", "no_opt_in", "bool_true", "bool_false"])
def test_activation_checkpointing_maps_as_in_jax(ac):
    """The opt-in rule of ``activation_checkpointing`` (the ``enabled``
    key wins both ways; a truthy functional sub-knob opts in; a block with
    none warns and leaves remat off), against the JAX ``from_ds_config``."""
    ds = {**JAX_CLI.default_ds_config("fp32", 0, 96), "activation_checkpointing": ac}
    warns = lambda: (pytest.warns(UserWarning, match="remat stays OFF")  # noqa: E731
                     if ac == {"cpu_checkpointing": False, "profile": True}
                     else contextlib.nullcontext())
    with warns():
        want = jcfg.from_ds_config(ds)
    with warns():
        got = tcfg.from_ds_config(ds)
    _same(want, got)


def _jax_args(argv):
    import sys

    old = sys.argv
    sys.argv = ["train.py", *argv]
    try:
        return JAX_CLI.add_argument()
    finally:
        sys.argv = old


def test_cli_flags_are_the_jax_clis():
    jax_args, port_args = vars(_jax_args([])), vars(PORT_CLI.build_parser().parse_args([]))
    assert set(port_args) == set(jax_args) | {"device"}
    # --flight-recorder is on by default, as in JAX (it was off until the
    # flight instruments were ported).
    assert {k for k in jax_args if jax_args[k] != port_args[k]} == set()


@pytest.mark.parametrize("argv", [
    [],
    ["-p", "deepspeed", "--dtype", "bf16", "--stage", "2"],
    ["-p", "torch_ddp_fp16", "-r", "3", "-c", "/tmp/ck", "-i", "2", "--target_acc", "0.9"],
    ["-p", "gemini", "--optimizer", "sgd", "--lr", "0.1", "--momentum", "0.8", "--nesterov",
     "--weight-decay", "1e-4", "--weight-decay-mask", "no_1d", "--ema-decay", "0.999"],
    ["--optimizer", "lamb", "--dataset", "synthetic_imagenet", "--model", "resnet50",
     "-b", "32", "-e", "2", "--steps-per-epoch", "10", "--label-smoothing", "0.1",
     "--gradient-accumulation-steps", "2", "--auto-resume", "--seed", "3"],
    ["--remat", "--precise-bn-batches", "2", "--wall-clock-breakdown", "--profile-dir", "p",
     "--tensorboard-dir", "tb", "--metrics-jsonl", "m.jsonl"],
    ["--dataset", "imagefolder", "--data-path", "/d", "--decoded-cache", "--model", "resnet50"],
    ["-p", "deepspeed", "--dataset", "imagefolder", "--data-path", "/d", "--image-size", "160",
     "--num-classes", "100"],
], ids=["defaults", "deepspeed_bf16_s2", "resume_target", "sgd_ema", "lamb_imagenet",
        "trainer_features", "imagefolder_cached", "imagefolder_deepspeed"])
def test_cli_builds_the_jax_clis_config(argv):
    want = JAX_CLI.build_config(_jax_args(argv))
    got = PORT_CLI.build_config(PORT_CLI.build_parser().parse_args(argv))
    _same(want, got)


@pytest.mark.parametrize("argv", [
    ["--moe"], ["--num-experts", "4"], ["--top-k", "2"], ["--chaos-kill-at-step", "3"],
    ["--chaos-data-error-rate", "0.1"], ["--flight-recorder"], ["--flight-dir", "f"],
    ["--trace"], ["--metrics-port", "0"], ["--grad-norm-metric"], ["--anomaly-detection"],
    ["--trace-dir", "t"], ["--ep-world-size", "2"],
], ids=lambda a: a[0].lstrip("-"))
def test_cli_refuses_what_the_port_lacks(argv):
    """What the port lacked raised naming ROADMAP.md; every flag this test
    lists is ported now. The MoE flags build the JAX CLI's config
    (``--moe`` switches the model to ``moe_mlp``; ``--ep-world-size`` sizes
    the expert axis under ``--moe`` alone). So do the flight instruments'
    (``--flight-recorder`` and ``--no-flight-recorder``, ``--flight-dir``,
    ``--grad-norm-metric``, ``--anomaly-detection``), and, refused until
    the span trace, the exporter and chaos were ported, ``--trace`` (and
    ``--no-trace``), ``--trace-dir``, ``--metrics-port`` and the chaos
    flags (with the kill signal and the other faults beside them): the JAX
    CLI's ``observability`` and ``chaos`` configs."""
    flight = {"--flight-recorder": ["--no-flight-recorder"], "--flight-dir": [],
              "--grad-norm-metric": [], "--anomaly-detection": ["--anomaly-action", "skip"],
              "--trace": ["--no-trace"], "--trace-dir": ["--trace"], "--metrics-port": [],
              "--chaos-kill-at-step": ["--chaos-kill-signal", "kill", "--chaos-seed", "4"],
              "--chaos-data-error-rate": ["--chaos-torn-ckpt-epoch", "1", "--chaos-torn-bytes",
                                          "8", "--chaos-corrupt-ckpt-epoch", "2",
                                          "--chaos-slow-step-every", "3", "--chaos-slow-step-ms",
                                          "7", "--chaos-slow-step-host", "1"]}
    if argv[0] in flight:
        for args in (argv, [*argv, *flight[argv[0]]]):
            want = JAX_CLI.build_config(_jax_args(args))
            got = PORT_CLI.build_config(PORT_CLI.build_parser().parse_args(args))
            _same(want, got)
            for f in ("observability", "chaos"):
                assert dataclasses.asdict(getattr(got, f)) == dataclasses.asdict(
                    getattr(want, f)), f
        return
    if argv[0] in ("--moe", "--num-experts", "--top-k", "--ep-world-size"):
        for extra in ([], ["--moe"] if argv[0] != "--moe" else ["--ep-world-size", "2"]):
            want = JAX_CLI.build_config(_jax_args([*argv, *extra]))
            got = PORT_CLI.build_config(PORT_CLI.build_parser().parse_args([*argv, *extra]))
            _same(want, got)
            for f in ("moe", "mesh"):
                assert dataclasses.asdict(getattr(got, f)) == dataclasses.asdict(
                    getattr(want, f)), f
        return
    raise AssertionError(f"{argv[0]} is in neither list")


def test_cli_takes_vit_b16_as_the_jax_cli_does(tmp_path, monkeypatch):
    """``--model vit_b16`` (refused by the port's registry once) builds the
    JAX CLI's config and trains through the ``Trainer``: here a ViT cut to
    patch 8, width 32, one layer, through the registry the Trainer calls."""
    argv = ["--model", "vit_b16", "--remat", "--dataset", "synthetic_cifar"]
    _same(JAX_CLI.build_config(_jax_args(argv)),
          PORT_CLI.build_config(PORT_CLI.build_parser().parse_args(argv)))
    from distributed_training_tpu_torch.models.vit import ViT
    from distributed_training_tpu_torch.train import trainer

    get_model = trainer.get_model
    monkeypatch.setattr(trainer, "get_model", lambda name, **kw: get_model(
        name, **{**kw, "patch_size": 8, "hidden_size": 32, "num_layers": 1,
                 "num_heads": 2, "mlp_dim": 64}))
    out = PORT_CLI.main(["--device", "cpu", *argv, "-b", "4", "-e", "1",
                         "--steps-per-epoch", "2", "-c", str(tmp_path), "-i", "1"])
    assert out["steps"] == 2 and 0.0 <= out["final_acc"] <= 1.0


def test_cli_trains_through_the_trainer(tmp_path):
    out = PORT_CLI.main([
        "--device", "cpu", "--model", "resnet_micro", "--dataset", "synthetic_cifar",
        "-b", "8", "-e", "1", "--steps-per-epoch", "2", "-c", str(tmp_path), "-i", "1",
        "--dtype", "bf16", "--optimizer", "sgd", "--lr", "0.05", "--ema-decay", "0.9"])
    assert out["steps"] == 2 and 0.0 <= out["final_acc"] <= 1.0
    assert os.path.isdir(tmp_path / "epoch_0")


@pytest.mark.parametrize("flag", [
    ["--remat"], ["--precise-bn-batches", "2"], ["--wall-clock-breakdown"],
    ["--profile-dir", "prof"], ["--tensorboard-dir", "tb"], ["--metrics-jsonl", "m.jsonl"],
], ids=lambda a: a[0].lstrip("-"))
def test_cli_runs_the_trainer_feature_flags(tmp_path, flag):
    """Each trainer-feature flag the CLI once refused runs: two resnet_micro
    steps and an eval, with what the flag writes where it says."""
    if flag[0].endswith("-dir") or flag[0] == "--metrics-jsonl":
        flag = [flag[0], str(tmp_path / flag[1])]
    out = PORT_CLI.main([
        "--device", "cpu", "--model", "resnet_micro", "--dataset", "synthetic_cifar",
        "-b", "8", "-e", "1", "--steps-per-epoch", "2", "-c", str(tmp_path / "ck"), "-i", "1",
        "--log-interval", "1", *flag])
    assert out["steps"] == 2 and 0.0 <= out["final_acc"] <= 1.0
    if flag[0] == "--metrics-jsonl":
        with open(flag[1]) as fh:
            lines = [json.loads(x) for x in fh]
        assert [x["prefix"] for x in lines] == ["train", "train", "eval"]
    elif flag[0] in ("--profile-dir", "--tensorboard-dir"):
        assert os.listdir(flag[1])


@pytest.mark.parametrize("cached", [True, False], ids=["decoded_cache", "live_decode"])
def test_cli_trains_on_an_imagefolder_tree(tmp_path, cached):
    """``--dataset imagefolder`` (and ``--decoded-cache``) for one short
    epoch on a tiny tree: every step committed, the checkpoint saved, the
    cache written under ``<root>/.decoded_cache``."""
    from torch_image_tree import write_tree

    root = write_tree(tmp_path / "tree")
    out = PORT_CLI.main([
        "--device", "cpu", "--model", "resnet_micro", "--dataset", "imagefolder",
        "--data-path", root, "--num-classes", "2", "--image-size", "16", "-b", "4", "-e", "1",
        "-c", str(tmp_path / "ck"), "-i", "1", "--dtype", "bf16",
        "--optimizer", "hybrid_adam", "--log-interval", "1"]
        + (["--decoded-cache"] if cached else []))
    assert out["steps"] == 3 and 0.0 <= out["final_acc"] <= 1.0
    assert os.path.isdir(tmp_path / "ck" / "epoch_0")
    assert os.path.exists(os.path.join(root, ".decoded_cache", "train_16.npy")) == cached
