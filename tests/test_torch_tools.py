"""The port's entry points for K4 and K5 on the CPU: the flash kernel bench
and the conv fusion probe verify with ``--device cpu`` (plain versions),
validate their flags as the JAX tools do, restore the flash switches
whatever happens, and refuse to run without a card unless asked for the
CPU."""

import pytest
import torch

from distributed_training_tpu.ops import flash_attention as jfa
from distributed_training_tpu_torch.ops import flash_attention as tfa
from distributed_training_tpu_torch.tools import conv_fusion_probe, flash_kernel_bench

torch.set_num_threads(1)


@pytest.mark.parametrize("flags", [[], ["--split-bwd", "--exp2"]], ids=["default", "split-exp2"])
def test_flash_bench_verifies_on_the_cpu(monkeypatch, flags):
    """Verify runs the public op on the plain versions with the switches
    the flags set (the split backward is taken), times nothing, and leaves
    both switches as they were."""
    split_calls = []
    inner = tfa.flash_bwd_split

    def spy(*a, **kw):
        split_calls.append(tfa._USE_EXP2)
        return inner(*a, **kw)
    monkeypatch.setattr(tfa, "flash_bwd_split", spy)
    assert flash_kernel_bench.main(flags + ["--device", "cpu", "--shapes", "gpt"]) == []
    assert split_calls == ([True] if flags else [])
    assert not tfa._USE_SPLIT_BWD and not tfa._USE_EXP2


@pytest.mark.parametrize("flag", ["--blocks", "--bwd-blocks"])
@pytest.mark.parametrize("block", [64, 100, 384, 640, 1024])
def test_flash_bench_blocks_rejected_as_the_jax_rule_rejects(flag, block):
    """Each block is held against every sequence length the run uses (the
    verify's 512 and the shapes'): the tool raises exactly when the JAX
    package's ``_block`` does."""
    shapes = ["gpt", "t4096"]
    ts = [flash_kernel_bench.VERIFY_T] + [flash_kernel_bench.SHAPES[s][2] for s in shapes]
    try:
        for t in ts:
            jfa._block(t, block)
    except ValueError:
        rejected = True
    else:
        rejected = False
    argv = [flag, f"{block}x{block}", "--device", "cpu", "--no-verify", "--shapes", *shapes]
    if rejected:
        with pytest.raises(ValueError, match="divisible"):
            flash_kernel_bench.main(argv)
    else:
        assert flash_kernel_bench.main(argv) == []


@pytest.mark.parametrize("text", ["512", "512x", "x512", "0x512", "axb"])
def test_flash_bench_malformed_blocks_are_usage_errors(text):
    with pytest.raises(SystemExit):
        flash_kernel_bench.main(["--blocks", text, "--device", "cpu", "--no-verify"])


def test_flash_bench_restores_the_switches_when_verify_raises(monkeypatch):
    seen = []

    def failing_verify(kwargs, device):
        seen.append((tfa._USE_SPLIT_BWD, tfa._USE_EXP2))
        raise AssertionError("mismatch")
    monkeypatch.setattr(flash_kernel_bench, "verify", failing_verify)
    with pytest.raises(AssertionError, match="mismatch"):
        flash_kernel_bench.main(["--split-bwd", "--exp2", "--device", "cpu"])
    assert seen == [(True, True)]
    assert not tfa._USE_SPLIT_BWD and not tfa._USE_EXP2


def test_conv_probe_verifies_on_the_cpu(capsys):
    assert conv_fusion_probe.main(["--device", "cpu"]) == []
    err = capsys.readouterr().err
    for key in conv_fusion_probe.SHAPES:
        assert f"verify {key}: ok" in err


def test_conv_probe_bn_must_divide_the_batch():
    """At N 4 on the CPU, bn 2 verifies and bn 3 is refused, where the JAX
    kernel would leave the last image unwritten."""
    assert conv_fusion_probe.main(["--device", "cpu", "--shapes", "s2", "--bn", "2"]) == []
    with pytest.raises(ValueError, match="multiple"):
        conv_fusion_probe.main(["--device", "cpu", "--shapes", "s2", "--bn", "3"])


@pytest.mark.parametrize("tool", [flash_kernel_bench, conv_fusion_probe],
                         ids=["flash_kernel_bench", "conv_fusion_probe"])
def test_tools_without_a_card_raise_unless_asked_for_the_cpu(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--device", "cuda"])
