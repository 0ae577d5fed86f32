"""The port's GPT CLI (``gpt/torch_cuda/train.py``) against the JAX one
(``gpt/jax_tpu/train.py``): the same flags with the same dests and
defaults (plus ``--device``), the same config from the same command line
(every flag of the JAX CLI, the span trace's, the live exporter's and the
chaos flags included), and a short run on the CPU through ``LMTrainer``."""

import dataclasses
import importlib.util
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# TrainConfig fields both packages have and the GPT CLI sets.
FIELDS = ("model", "num_epochs", "gradient_accumulation_steps", "remat", "tp_overlap",
          "seed", "log_interval", "wall_clock_breakdown", "profile_dir", "tensorboard_dir",
          "metrics_jsonl", "optimizer", "precision", "zero", "mesh", "checkpoint", "data",
          "lm", "moe", "observability", "chaos")

torch.set_num_threads(1)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_CLI = _load("gpt/jax_tpu/train.py", "jax_gpt_cli")
PORT_CLI = _load("gpt/torch_cuda/train.py", "port_gpt_cli")


def _jax_args(argv):
    old = sys.argv
    sys.argv = ["train.py", *argv]
    try:
        return JAX_CLI.add_argument()
    finally:
        sys.argv = old


def _port_args(argv):
    return PORT_CLI.build_parser().parse_args(argv)


def test_parser_dests_and_defaults_are_the_jax_clis():
    jax_args, port_args = vars(_jax_args([])), vars(_port_args([]))
    assert set(port_args) == set(jax_args) | {"device"}
    # --flight-recorder is on by default, as in JAX (it was off until the
    # flight instruments were ported).
    assert {k for k in jax_args if jax_args[k] != port_args[k]} == set()


@pytest.mark.parametrize("argv", [
    [],
    ["--vocab-size", "50304", "--num-layers", "12", "--num-heads", "12",
     "--hidden-dim", "768", "--seq-len", "1024", "--max-len", "1024", "-b", "16",
     "--dtype", "bf16", "--attn-impl", "flash", "--logits-dtype", "bf16",
     "--no-head-bias", "--stage", "2", "--remat", "--ce-chunk-size", "256"],
    ["--ce-save-probs", "--logits-dtype", "fp32", "--head-bias", "--ema-decay", "0.99",
     "--gradient-accumulation-steps", "2", "--corpus", "/tmp/c.txt", "--stage", "3"],
    ["-c", "/tmp/ck", "-i", "2", "-r", "1", "--auto-resume", "--log-interval", "5",
     "--steps-per-epoch", "7", "--seed", "3", "-e", "4", "--wall-clock-breakdown",
     "--profile-dir", "p", "--tensorboard-dir", "tb", "--metrics-jsonl", "m.jsonl"],
], ids=["defaults", "gpt2_small", "save_probs", "run_control"])
def test_build_config_equals_the_jax_clis(argv):
    want = JAX_CLI.build_config(_jax_args(argv))
    got = PORT_CLI.build_config(_port_args(argv))
    for f in FIELDS:
        x, y = getattr(want, f), getattr(got, f)
        if dataclasses.is_dataclass(x):
            x, y = dataclasses.asdict(x), dataclasses.asdict(y)
            assert set(y) <= set(x), f  # the port's fields are the JAX package's
            x = {k: v for k, v in x.items() if k in y}
        assert x == y, f


@pytest.mark.parametrize("argv", [
    ["--moe"], ["--num-experts", "4"], ["--ep-world-size", "2"], ["--top-k", "2"],
    ["--tp", "2"], ["--tp-overlap"], ["--pp", "2"], ["--virtual-stages", "2"],
    ["--microbatches", "4"], ["--sp", "4"], ["--flight-recorder"], ["--trace"],
    ["--metrics-port", "0"], ["--grad-norm-metric"], ["--anomaly-detection"],
    ["--anomaly-action", "skip"], ["--chaos-kill-at-step", "3"],
    ["--chaos-slow-step-every", "2"],
], ids=lambda a: a[0].lstrip("-"))
def test_unported_flags_raise_naming_the_flag(argv):
    """The flags of what the port lacks raise naming the flag. ``--tp``,
    ``--tp-overlap`` and ``--sp``, which this test once listed, are ported:
    they build the JAX CLI's config (the mesh's model and sequence axes,
    ``tp_overlap``). So are the MoE flags (the ``moe`` config and the
    expert axis, with and without ``--moe``), and the pipeline's: ``--pp``
    (the mesh's pipe axis), ``--microbatches`` and ``--virtual-stages``
    (the ``lm`` config), which build the JAX CLI's config with and without
    ``--pp 2`` (they raised beside it until the pipeline was ported). So
    are the flight instruments' (``--flight-recorder`` with and without
    ``--no-flight-recorder``, ``--grad-norm-metric``,
    ``--anomaly-detection``, ``--anomaly-action``): they build the JAX
    CLI's ``observability`` config. So, last, are ``--trace`` (with and
    without ``--no-trace``, with ``--trace-dir``), ``--metrics-port`` and
    the chaos flags (with every other chaos flag beside them), refused
    until the span trace, the exporter and chaos were ported: they build
    the JAX CLI's ``observability`` and ``chaos`` configs. No flag is
    refused now."""
    flight = {"--flight-recorder": [[], ["--no-flight-recorder"]],
              "--grad-norm-metric": [[]], "--anomaly-detection": [[], ["--anomaly-action",
                                                                        "skip"]],
              "--anomaly-action": [[], ["--anomaly-detection"]],
              "--trace": [[], ["--no-trace"], ["--trace-dir", "t"]], "--metrics-port": [[]],
              "--chaos-kill-at-step": [[], ["--chaos-kill-signal", "kill", "--chaos-seed", "2"]],
              "--chaos-slow-step-every": [[], ["--chaos-slow-step-ms", "9",
                                               "--chaos-slow-step-host", "1",
                                               "--chaos-torn-ckpt-epoch", "0",
                                               "--chaos-torn-bytes", "3",
                                               "--chaos-corrupt-ckpt-epoch", "1",
                                               "--chaos-data-error-rate", "0.5"]]}
    if argv[0] in ("--tp", "--tp-overlap", "--sp", "--moe", "--num-experts",
                   "--ep-world-size", "--top-k", "--microbatches", "--virtual-stages",
                   "--pp", *flight):
        extras = ([[], ["--moe"]] if argv[0] in ("--num-experts", "--ep-world-size", "--top-k")
                  else [[], ["--pp", "2"]] if argv[0] in ("--microbatches", "--virtual-stages")
                  else flight.get(argv[0], [[]]))
        for extra in extras:
            want = JAX_CLI.build_config(_jax_args([*argv, *extra]))
            got = PORT_CLI.build_config(_port_args([*argv, *extra]))
            for f in FIELDS:
                x, y = getattr(want, f), getattr(got, f)
                if dataclasses.is_dataclass(x):
                    x, y = dataclasses.asdict(x), dataclasses.asdict(y)
                    x = {k: v for k, v in x.items() if k in y}
                assert x == y, f
        return
    raise AssertionError(f"{argv[0]} is not mapped")


def test_two_step_cpu_run(tmp_path):
    """Two steps of a micro GPT at ZeRO 2 with remat and the chunked CE,
    then an eval and a save; the JSONL sink gets both train steps."""
    out = PORT_CLI.main([
        "--device", "cpu", "--num-layers", "2", "--num-heads", "2", "--hidden-dim", "32",
        "--vocab-size", "64", "--seq-len", "16", "--max-len", "32", "-b", "4",
        "--steps-per-epoch", "2", "-e", "1", "-i", "1", "-c", str(tmp_path / "ck"),
        "--stage", "2", "--remat", "--ce-chunk-size", "8", "--log-interval", "1",
        "--metrics-jsonl", str(tmp_path / "m.jsonl")])
    assert out["steps"] == 2 and not out["preempted"]
    assert out["final_perplexity"] > 1.0
    with open(tmp_path / "m.jsonl") as fh:
        lines = [json.loads(x) for x in fh]
    assert [(x["prefix"], x["step"]) for x in lines] == [("train", 1), ("train", 2),
                                                          ("eval", 2)]
    assert os.path.exists(tmp_path / "ck" / "epoch_0" / "COMMITTED")
