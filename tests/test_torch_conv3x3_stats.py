"""The port's conv3×3 + BN-statistics op (K5) on the CPU (the wrapper's
plain version) against the JAX probe's ``tools/conv_fusion_probe.py``.

bf16 inputs from numpy, as the probe makes them. Two references, because
the JAX kernel run in interpret mode gives ``out`` but not the sums:

- ``out`` against ``pallas_conv3x3_stats(..., interpret=True)``: within
  one bf16 step, 2**-7 of the element (both sum the same float32 products
  in another order, and a float32 sum near a rounding boundary may round
  the other way), plus 1e-5 absolute for elements near zero, where that
  order moves the float32 sum by more than the element's own bf16 step;
- ``sum`` and ``sumsq`` against the probe's oracle ``xla_conv_stats``, the
  same float32 conv and sums (the kernel's own sums are NaN in interpret
  mode: each program's partial starts from its uninitialised output times
  0): each channel's error within 1e-5 of the sum of its terms' magnitudes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_tpu_torch.ops import conv3x3_stats as k5
from distributed_training_tpu_torch.ops.conv3x3_stats import (
    conv3x3_stats,
    conv3x3_stats_reference,
)
from tools import conv_fusion_probe as probe

torch.set_num_threads(1)


def _inputs(n, h, w, cin, cout, seed=0):
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(n, h, w, cin), jnp.bfloat16)
    wts = jnp.asarray(rng.randn(3, 3, cin, cout) * 0.05, jnp.bfloat16)
    to_torch = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    return x, wts, to_torch(x), to_torch(wts)


@pytest.mark.parametrize("n,h,w,cin,cout,bn", [
    (2, 8, 8, 16, 16, 1),
    (4, 8, 8, 16, 32, 2),
    (2, 6, 10, 16, 16, 2),
    (3, 6, 10, 16, 32, 1),
])
def test_matches_the_jax_probe(n, h, w, cin, cout, bn):
    jx, jw, x, wts = _inputs(n, h, w, cin, cout, seed=n + h + cout)
    got_out, got_s, got_ss = conv3x3_stats(x, wts, bn=bn)
    assert got_out.shape == (n, h, w, cout) and got_out.dtype == torch.bfloat16
    assert got_s.shape == got_ss.shape == (cout,)
    assert got_s.dtype == got_ss.dtype == torch.float32

    k_out, _, _ = probe.pallas_conv3x3_stats(jx, jw, bn=bn, interpret=True)
    np.testing.assert_allclose(got_out.float().numpy(), np.asarray(k_out, np.float32),
                               rtol=2 ** -7, atol=1e-5)

    ref_out, ref_s, ref_ss = probe.xla_conv_stats(jx, jw)
    terms = np.abs(np.asarray(ref_out, np.float32)).sum((0, 1, 2))
    np.testing.assert_array_less(np.abs(got_s.numpy() - np.asarray(ref_s)), 1e-5 * terms)
    ref_ss = np.asarray(ref_ss)
    np.testing.assert_array_less(np.abs(got_ss.numpy() - ref_ss), 1e-5 * ref_ss)


def test_batch_not_a_multiple_of_bn_raises():
    """The JAX kernel leaves the last N % bn images unwritten; the port
    refuses the call."""
    _, _, x, wts = _inputs(3, 8, 8, 16, 16)
    with pytest.raises(ValueError, match="multiple"):
        conv3x3_stats(x, wts, bn=2)
    with pytest.raises(ValueError, match="multiple"):
        conv3x3_stats(x, wts, bn=0)


def test_reference_sums_are_of_the_float32_result():
    """The sums are taken before the cast: they differ from the sums of the
    bf16 ``out``, and equal those of the float32 conv."""
    _, _, x, wts = _inputs(2, 8, 8, 16, 16, seed=9)
    out, s, ss = conv3x3_stats_reference(x, wts)
    want = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2),
                                      wts.float().permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(s, want.sum((0, 2, 3)), rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(ss, want.square().sum((0, 2, 3)), rtol=1e-6, atol=1e-5)
    assert not torch.equal(s, out.float().sum((0, 1, 2)))


def test_cpu_takes_the_plain_version_and_off_cpu_never_falls_back():
    _, _, x, wts = _inputs(2, 8, 8, 16, 16)
    n = conv3x3_stats.launches
    for a, b in zip(conv3x3_stats(x, wts), conv3x3_stats_reference(x, wts)):
        assert torch.equal(a, b)
    xm = torch.empty((2, 8, 8, 16), dtype=torch.bfloat16, device="meta")
    wm = torch.empty((3, 3, 16, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_stats(xm, wm)
    with pytest.raises(ValueError, match="CUDA"):  # 6 channels: padded, then refused
        conv3x3_stats(xm[..., :6], wm[:, :, :6, :])
    with pytest.raises(ValueError, match="dtype"):
        conv3x3_stats(xm, wm.float())
    assert conv3x3_stats.launches == n


def test_bf16_channels_must_be_multiples_of_8_off_the_cpu():
    """bfloat16 and float16 run on the tensor-core kernel, whose 16-byte
    copies take 8 channels (float32 keeps its rule of 4): off the CPU the
    wrapper pads Cin and Cout up to those multiples with zero channels
    before the kernel's checks (here a ``meta`` tensor is then refused as
    not on a card); the CPU still takes the plain version."""
    xm = torch.empty((2, 8, 8, 12), dtype=torch.bfloat16, device="meta")
    wm = torch.empty((3, 3, 12, 16), dtype=torch.bfloat16, device="meta")
    for dtype, want in ((torch.bfloat16, (16, 16)), (torch.float16, (16, 16)),
                        (torch.float32, (12, 16))):
        px, pw, cout = k5.pad_channels(xm.to(dtype), wm.to(dtype))
        assert (px.shape[-1], pw.shape[-1]) == want and pw.shape[2] == want[0]
        assert cout == 16
    px, pw, cout = k5.pad_channels(xm[..., :8], wm[:, :, :8, :12])
    assert (px.shape[-1], pw.shape[2], pw.shape[-1], cout) == (8, 8, 16, 12)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_stats(xm, wm)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_stats(xm[..., :8], wm[:, :, :8, :12])
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3_stats(xm.float(), wm.float())
    _, _, x, wts = _inputs(1, 4, 4, 12, 12)
    for a, b in zip(conv3x3_stats(x, wts), conv3x3_stats_reference(x, wts)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cin,cout", [(3, 12), (20, 36), (13, 5)])
def test_other_channel_counts_match_the_jax_probe(cin, cout):
    """Channel counts the kernel pads (not multiples of 8): the plain
    version against the JAX probe's interpret-mode kernel and oracle under
    the limits above; and the wrapper's padding (zero channels in, extra
    output channels sliced off) leaves the plain version's result as it
    was: out within one bf16 step, the sums within 1e-6 of their terms."""
    jx, jw, x, wts = _inputs(2, 6, 10, cin, cout, seed=cin + cout)
    got_out, got_s, got_ss = conv3x3_stats(x, wts)
    assert got_out.shape == (2, 6, 10, cout) and got_s.shape == (cout,)
    k_out, _, _ = probe.pallas_conv3x3_stats(jx, jw, interpret=True)
    np.testing.assert_allclose(got_out.float().numpy(), np.asarray(k_out, np.float32),
                               rtol=2 ** -7, atol=1e-5)
    ref_out, ref_s, ref_ss = probe.xla_conv_stats(jx, jw)
    terms = np.abs(np.asarray(ref_out, np.float32)).sum((0, 1, 2))
    np.testing.assert_array_less(np.abs(got_s.numpy() - np.asarray(ref_s)), 1e-5 * terms)
    ref_ss = np.asarray(ref_ss)
    np.testing.assert_array_less(np.abs(got_ss.numpy() - ref_ss), 1e-5 * ref_ss)

    px, pw, true_cout = k5.pad_channels(x, wts)
    assert px.shape[-1] % 8 == 0 and pw.shape[-1] % 8 == 0 and true_cout == cout
    p_out, p_s, p_ss = conv3x3_stats_reference(px, pw)
    assert not p_out[..., cout:].float().abs().any()
    torch.testing.assert_close(p_out[..., :cout].float(), got_out.float(),
                               rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(p_s[:cout], got_s, rtol=0, atol=1e-6 * terms.max())
    torch.testing.assert_close(p_ss[:cout], got_ss, rtol=1e-6, atol=0)
