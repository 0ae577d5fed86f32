"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import no JAX, so they run on the GPU machine:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Without a GPU they skip (the kernels have no CPU mode).
"""

import pytest
import torch

from distributed_training_tpu_torch.ops.fused_adam import (
    fused_adam_reference,
    fused_adam_update,
)


@pytest.fixture
def require_cuda():
    """Decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_kernel_matches_reference_on_the_card(require_cuda):
    """On the card: the kernel against its plain version, bit for bit
    (both round every operation to float32 in the same order), over
    shapes that exercise the float4 path, the ragged tail and a
    misaligned view."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(1,), (300, 7), (5, 3, 2), (32768,), (64, 64, 3, 3), (20001,)]
    ps = [torch.randn(s, device=dev, generator=gen) for s in shapes]
    gs = [torch.randn(s, device=dev, generator=gen) for s in shapes]
    base = torch.randn(1001, device=dev, generator=gen)
    ps.append(base[1:])                                   # not 16-byte aligned
    gs.append(torch.randn(1000, device=dev, generator=gen))
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    ref = [(p.clone(), m.clone(), v.clone()) for p, m, v in zip(ps, ms, vs)]
    for step in range(1, 4):
        fused_adam_update(ps, gs, ms, vs, lr=1e-3, step=step)
        ref = [fused_adam_reference(p, g, m, v, 1e-3, step)
               for (p, m, v), g in zip(ref, gs)]
    torch.cuda.synchronize()
    for (p, m, v), rp, rm, rv in zip(ref, ps, ms, vs):
        torch.testing.assert_close(rp, p, rtol=0, atol=0)
        torch.testing.assert_close(rm, m, rtol=0, atol=0)
        torch.testing.assert_close(rv, v, rtol=0, atol=0)


@pytest.mark.cuda
def test_kernel_out_of_place_and_counter(require_cuda):
    dev = torch.device("cuda")
    p, g = torch.randn(4099, device=dev), torch.randn(4099, device=dev)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    before = [t.clone() for t in (p, m, v)]
    outs = ([torch.empty_like(p)], [torch.empty_like(p)], [torch.empty_like(p)])
    n0 = fused_adam_update.launches
    fused_adam_update([p], [g], [m], [v], lr=1e-3, step=1, out=outs)
    assert fused_adam_update.launches == n0 + 1
    torch.cuda.synchronize()
    for t, b in zip((p, m, v), before):
        assert torch.equal(t, b)
    for o, w in zip(outs, fused_adam_reference(p, g, m, v, 1e-3, 1)):
        assert torch.equal(o[0], w)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_take(require_cuda):
    dev = torch.device("cuda")
    p = torch.randn(8, 8, device=dev)
    with pytest.raises(ValueError):
        fused_adam_update([p], [p.t()], [p], [p], lr=1e-3, step=1)
    with pytest.raises(ValueError):
        fused_adam_update([p.half()], [p.half()], [p.half()], [p.half()],
                          lr=1e-3, step=1)
    with pytest.raises(ValueError):
        fused_adam_update([p], [p.cpu()], [p], [p], lr=1e-3, step=1)
