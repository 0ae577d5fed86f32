"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import no JAX, so they run on the GPU machine:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py

Without a GPU they skip (the kernels have no CPU mode).
"""

import pytest
import torch

from distributed_training_tpu_torch.ops.fused_adam import (
    adam_scalars_tensor,
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


@pytest.mark.cuda
def test_kernel_reads_its_step_scalars_on_the_card(require_cuda):
    """The device-scalar launch (``scalars=``) against the plain version
    with the same tensor scalars, bit for bit; captured in a CUDA graph and
    replayed after the scalars are rewritten in place, it takes each
    replay's values (by-value arguments would repeat the first step's)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    p, g = (torch.randn(20001, device=dev, generator=gen) for _ in range(2))
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    lr = torch.tensor(1e-3, device=dev)
    scalars = adam_scalars_tensor(lr, torch.tensor(1, device=dev), 0.9, 0.999)
    want = fused_adam_reference(p, g, m, v, scalars=scalars)
    fused_adam_update([p], [g], [m], [v], scalars=scalars)
    for got, w in zip((p, m, v), want):
        assert torch.equal(got, w)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fused_adam_update([p], [g], [m], [v], scalars=scalars)
    for step in range(2, 5):
        scalars.copy_(adam_scalars_tensor(lr, torch.tensor(step, device=dev), 0.9, 0.999))
        want = fused_adam_reference(p, g, m, v, scalars=scalars)
        graph.replay()
        for got, w in zip((p, m, v), want):
            assert torch.equal(got, w)
    with pytest.raises(ValueError, match="scalars"):
        fused_adam_update([p], [g], [m], [v], scalars=scalars.double())


@pytest.mark.cuda
def test_multi_step_graph_takes_new_step_numbers(require_cuda, tmp_path):
    """``make_multi_step`` on the card: two replays of a 3-step graph of a
    float32 ResNet step with ``hybrid_adam`` under a warm-up schedule (so
    each step's rate and bias corrections differ) against 6 eager steps
    from a copy of the state: the same losses within rtol 1e-5 and
    parameters within atol 1e-5 (cuDNN's backward sums with atomics in an
    order that changes from run to run: two eager runs differ by up to
    ~3e-6 on a BatchNorm bias of ~1.5e-3 after 6 steps at lr 1e-3 on an
    H100), and the counts on the host and the card both advanced by 6;
    the kept graph holds one K1 node a step (``graph_kernels``)."""
    import copy

    from distributed_training_tpu_torch.config import (
        OptimizerConfig,
        PrecisionConfig,
        SchedulerConfig,
    )
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.train.multi_step import graph_kernels, make_multi_step
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.step import make_train_step
    from distributed_training_tpu_torch.train.train_state import TrainState

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    model = get_model("resnet_micro", num_classes=10,
                      generator=torch.Generator().manual_seed(0)).to(dev)
    sched = SchedulerConfig(name="warmup_lr", warmup_min_lr=1e-4, warmup_max_lr=1e-3,
                            warmup_num_steps=8)
    state = TrainState.create(model, make_optimizer(OptimizerConfig(name="hybrid_adam"), sched),
                              LossScaleState.create(PrecisionConfig()))
    gen = torch.Generator(device=dev).manual_seed(2)
    batch = {"image": torch.rand(8, 32, 32, 3, device=dev, generator=gen),
             "label": torch.randint(0, 10, (8,), device=dev, generator=gen)}
    step = make_train_step()
    multi = make_multi_step(step, state, batch, 3, keep_graph=True)
    names = graph_kernels(multi, str(tmp_path / "graph.dot"))
    assert sum("fused_adam_kernel" in x for x in names) == 3
    eager = copy.deepcopy(state)
    start = state.step
    got = [float(multi()["loss"]) for _ in range(2)]
    want = [float(step(eager, batch)["loss"]) for _ in range(6)][2::3]
    torch.testing.assert_close(torch.tensor(got), torch.tensor(want), rtol=1e-5, atol=0)
    for a, b in zip(state.model.parameters(), eager.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert state.step == state.opt_state.count == int(state.opt_state.count_t) == start + 6


@pytest.mark.cuda
def test_vit_step_captures(require_cuda):
    """A ViT step (the bench's ``--model vit_b16`` leg, cut to one narrow
    layer) captures in a CUDA graph: its attention scale is filled on the
    card, where a copy from the host would be refused during the capture;
    two replays of 2 steps against 4 eager steps from a copy of the state,
    within the cuBLAS tolerance of the test above."""
    import copy

    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.train.multi_step import make_multi_step
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.step import make_train_step
    from distributed_training_tpu_torch.train.train_state import TrainState

    dev = torch.device("cuda")
    model = get_model("vit_b16", num_classes=10, dtype=torch.bfloat16, image_size=32,
                      patch_size=8, hidden_size=32, num_layers=1, num_heads=2, mlp_dim=64,
                      generator=torch.Generator().manual_seed(0)).to(dev)
    state = TrainState.create(model, make_optimizer(OptimizerConfig(name="sgd", lr=0.1,
                                                                    momentum=0.9)),
                              LossScaleState.create(PrecisionConfig(dtype="bf16")))
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = {"image": torch.rand(8, 32, 32, 3, device=dev, generator=gen),
             "label": torch.randint(0, 10, (8,), device=dev, generator=gen)}
    step = make_train_step(grad_accum_steps=2)
    multi = make_multi_step(step, state, batch, 2)
    eager = copy.deepcopy(state)
    got = [float(multi()["loss"]) for _ in range(2)]
    want = [float(step(eager, batch)["loss"]) for _ in range(4)][1::2]
    torch.testing.assert_close(torch.tensor(got), torch.tensor(want), rtol=1e-5, atol=0)
    for a, b in zip(state.model.parameters(), eager.model.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# -- flash attention (K2 forward, K3 backward) --------------------------------
#
# bfloat16 runs on the tensor-core kernels (csrc/flash_wgmma.cuh), float32
# on the CUDA-core loops (csrc/flash_tiles.cuh); both meet the same limits.
#
# Tolerances, row by row (a row is one query's out or dq, one key's dk or
# dv): the largest error in the row over the RMS of the plain version's
# row, that RMS held at least a tenth of the whole tensor's (causal row 0
# has dq = 0). float32: the same products summed in another order (dQ adds
# its k-tile parts with atomics, in an order that changes from run to
# run). bfloat16: the kernel rounds p and dS to bfloat16 before they
# multiply V, dO, Q and K, as the TPU kernel does, the plain version keeps
# them in float32, and every output is rounded to bfloat16. The limits are
# chip_smoke.py's, about three times the worst error measured on the card.
# lse is float32 in both: its largest error over its largest magnitude.
# Through autograd, card against CPU, each run feeds its own out into
# delta, so the bfloat16 gradients get a wider limit.
# float16 rounds p and dS where bfloat16 does, with 3 more mantissa bits:
# an eighth of bfloat16's limits.
FLASH_TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (0.1, 0.1),
             torch.float16: (0.1 / 8, 0.1 / 8)}
LSE_GRAD_TOL = {torch.float32: 3e-5, torch.bfloat16: 0.2}


def _rel_err(got, want):
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()


def _row_err(got, want):
    want = want.float()
    err = (got.float() - want).abs().amax(-1)
    rms = want.square().mean(-1).sqrt()
    floor = 0.1 * want.square().mean().sqrt().clamp_min(1e-30)
    return (err / rms.clamp_min(floor)).max().item()


def _attn_inputs(shape, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, device="cuda", generator=gen).to(dtype)
            for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,t,d", [(6, 128, 32), (4, 384, 64), (3, 200, 64),
                                    (2, 1024, 64), (3, 256, 128)])
def test_flash_kernels_match_reference(require_cuda, dtype, causal, bh, t, d):
    from distributed_training_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference,
        flash_attention_reference,
        flash_bwd,
        flash_fwd,
    )

    q, k, v, g = _attn_inputs((bh, t, d), dtype)
    n_fwd, n_bwd = flash_fwd.launches, flash_bwd.launches
    out, lse = flash_fwd(q, k, v, causal=causal)
    grads = flash_bwd(q, k, v, out, lse, g, causal=causal)
    torch.cuda.synchronize()
    assert (flash_fwd.launches, flash_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    want_out, want_lse = flash_attention_reference(q, k, v, causal=causal)
    want = flash_attention_bwd_reference(q, k, v, out, lse, g, causal=causal)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert _row_err(out, want_out) < fwd_tol
    assert _rel_err(lse, want_lse) < 1e-5
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert _row_err(a, b) < bwd_tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 7, 65, 1000])
def test_flash_bf16_tensor_core_tiles_at_ragged_lengths(require_cuda, causal, d, t):
    """bf16 goes to the tensor-core kernels (wgmma tiles): K2, K3 and K4b
    against the plain versions at lengths that are not multiples of the
    64-row tile, T 1 included, under FLASH_TOL. A non-zero lse cotangent
    keeps dq and dk well defined at T 1, where without it dS = p (dp −
    delta) is 0 up to rounding and the comparison would be of noise."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((3, t, d), torch.bfloat16, seed=6)
    g_lse = torch.randn((3, t), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(7))
    n = (fa.flash_fwd.launches, fa.flash_bwd.launches, fa.flash_bwd_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    grads = fa.flash_bwd(q, k, v, out, lse, g, g_lse, causal=causal)
    dk4, dv4 = fa.flash_bwd_dkv(q, k, v, g, lse, fa._delta(g, out, g_lse), causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches,
            fa.flash_bwd_dkv.launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse, causal=causal)
    fwd_tol, bwd_tol = FLASH_TOL[torch.bfloat16]
    assert _row_err(out, want_out) < fwd_tol
    assert _rel_err(lse, want_lse) < 1e-5
    for name, a, b in zip(("dq", "dk", "dv", "K4b dk", "K4b dv"),
                          (*grads, dk4, dv4), (*want, *want[1:])):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        assert _row_err(a, b) < bwd_tol, name


@pytest.mark.cuda
def test_flash_bwd_repeatable_on_the_card(require_cuda):
    """Two K3 launches on the same bf16 inputs: dk and dv are written once
    from registers, so they repeat bit for bit; dq's k-tile parts are
    added with atomics in an order that changes, so the two agree within
    the bf16 limit."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((8, 1024, 64), torch.bfloat16, seed=8)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    first = fa.flash_bwd(q, k, v, out, lse, g, causal=True)
    second = fa.flash_bwd(q, k, v, out, lse, g, causal=True)
    torch.cuda.synchronize()
    assert _row_err(first[0], second[0]) < FLASH_TOL[torch.bfloat16][1]
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,t,d", [(3, 200, 32), (2, 1000, 64), (2, 65, 128)])
def test_flash_float32_route_keeps_its_limit(require_cuda, causal, bh, t, d):
    """float32 stays on the CUDA-core loops: K2, K3 and K4b against the
    plain versions within the float32 limit (3e-5 by row), with a non-zero
    lse cotangent."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((bh, t, d), torch.float32, seed=9)
    g_lse = torch.randn((bh, t), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(10))
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    grads = fa.flash_bwd(q, k, v, out, lse, g, g_lse, causal=causal)
    dk4, dv4 = fa.flash_bwd_dkv(q, k, v, g, lse, fa._delta(g, out, g_lse), causal=causal)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse, causal=causal)
    fwd_tol, bwd_tol = FLASH_TOL[torch.float32]
    assert fwd_tol == bwd_tol == 3e-5
    assert _row_err(out, want_out) < fwd_tol
    assert _rel_err(lse, want_lse) < 1e-5
    for name, a, b in zip(("dq", "dk", "dv", "K4b dk", "K4b dv"),
                          (*grads, dk4, dv4), (*want, *want[1:])):
        assert a.dtype == torch.float32
        assert _row_err(a, b) < bwd_tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_flash_lse_gradient_on_the_card(require_cuda, dtype):
    """flash_attention_lse through autograd: a loss that reads out and lse
    takes the same gradients on the card as on the CPU (plain versions).
    Its cotangents are fixed random tensors: one made from out itself lets
    the two runs' roundings of out pass into dO and delta, which cancel in
    dq, and the comparison would measure that, not the kernels."""
    from distributed_training_tpu_torch.ops.flash_attention import flash_attention_lse

    q, k, v, w_out = _attn_inputs((2, 3, 256, 64), dtype, seed=1)
    w_lse = w_out[..., 0].float()

    def grads(device):
        xs = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
        out, lse = flash_attention_lse(*xs, causal=True, block_q=128, block_k=128)
        ((out.float() * w_out.to(device).float()).sum()
         + (lse * w_lse.to(device)).sum()).backward()
        return [x.grad.cpu() for x in xs]

    for a, b in zip(grads("cuda"), grads("cpu")):
        assert _row_err(a, b) < LSE_GRAD_TOL[dtype]


@pytest.mark.cuda
def test_flash_kernels_refuse_what_they_cannot_take(require_cuda):
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd

    q, k, v, g = _attn_inputs((2, 128, 64), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, causal=True)
    with pytest.raises(ValueError):
        flash_fwd(q, k.bfloat16(), v, causal=True)
    with pytest.raises(ValueError):
        flash_fwd(q.double(), k.double(), v.double(), causal=True)
    with pytest.raises(ValueError, match="at least 1"):
        flash_fwd(*(x[..., :0] for x in (q, k, v)), causal=True)
    with pytest.raises(ValueError):
        flash_fwd(q, k.cpu(), v, causal=True)
    out, lse = flash_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError):
        flash_bwd(q, k, v, out, lse[:, :64].contiguous(), g, causal=True)


# float32 starts at T 65, as the float32 test above does: at T 1, out = v,
# so dS = dO·v − rowsum(dO·out) + ... cancels exactly, and the comparison
# would measure two float32 summation orders of a sum near 16 (d 256), not
# the kernel.
D256_CASES = [(dtype, t) for dtype in (torch.float32, torch.bfloat16, torch.float16)
              for t in ((65, 100, 256) if dtype == torch.float32 else (1, 100, 256))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t", D256_CASES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [160, 256])
def test_flash_kernels_at_head_dims_up_to_256(require_cuda, dtype, causal, d, t):
    """The D-256 instantiations (16-bit: each tile's outputs split between
    two blocks of 128 columns; float32: 32-row tiles): K2, K3, K4a and K4b
    against their plain versions at d 256 and at d 160 (padded to 256), at
    ragged and admissible T, with a non-zero lse cotangent, under
    FLASH_TOL; each kernel launches once."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((3, t, d), dtype, seed=13)
    g_lse = torch.randn((3, t), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(14))
    counters = (fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    n = [f.launches for f in counters]
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    delta = fa._delta(g, out, g_lse)
    grads = fa.flash_bwd(q, k, v, out, lse, g, g_lse, causal=causal)
    dq4 = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal)
    dk4, dv4 = fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert [f.launches - m for f, m in zip(counters, n)] == [1, 1, 1, 1]
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse, causal=causal)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    assert out.shape == (3, t, d) and _row_err(out, want_out) < fwd_tol
    assert _rel_err(lse, want_lse) < 1e-5
    for name, a, b in zip(("dq", "dk", "dv", "K4a dq", "K4b dk", "K4b dv"),
                          (*grads, dq4, dk4, dv4), (*want, *want)):
        assert a.dtype == dtype and a.shape == b.shape
        assert _row_err(a, b) < bwd_tol, name


WIDE_CASES = [(dtype, d) for dtype in (torch.float32, torch.bfloat16, torch.float16)
              for d in (257, 320, 384, 512) + ((768,) if dtype == torch.bfloat16 else ())]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", WIDE_CASES, ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [100, 384])
def test_flash_kernels_above_head_dim_256(require_cuda, dtype, d, causal, t):
    """The d > 256 kernels (d streamed in slabs of 64 columns, 64 output
    columns a block; d padded to a multiple of 64): K2, K3, K4a and K4b
    against their plain versions under FLASH_TOL, each launched once, and
    K4a the same bit for bit across two launches."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((2, t, d), dtype, seed=17)
    g_lse = torch.randn((2, t), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(18))
    counters = (fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    n = [f.launches for f in counters]
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    delta = fa._delta(g, out, g_lse)
    grads = fa.flash_bwd(q, k, v, out, lse, g, g_lse, causal=causal)
    dq4 = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal)
    dk4, dv4 = fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert [f.launches - m for f, m in zip(counters, n)] == [1, 1, 1, 1]
    assert torch.equal(dq4, fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal))
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse, causal=causal)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    assert out.shape == (2, t, d) and _row_err(out, want_out) < fwd_tol
    assert _rel_err(lse, want_lse) < 1e-5
    for name, a, b in zip(("dq", "dk", "dv", "K4a dq", "K4b dk", "K4b dv"),
                          (*grads, dq4, dk4, dv4), (*want, *want)):
        assert a.dtype == dtype and a.shape == b.shape
        assert _row_err(a, b) < bwd_tol, name


# -- split flash backward (K4a dq, K4b dk/dv) and exp2 ------------------------
#
# Row by row under the K2/K3 limits above: K4a and K4b round p and dS where
# K3 does and sum in the same float32, without K3's atomics.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,t,d", [(6, 128, 32), (3, 200, 64), (2, 1024, 64),
                                    (3, 256, 128)])
def test_split_kernels_match_reference(require_cuda, dtype, causal, bh, t, d):
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((bh, t, d), dtype, seed=2)
    g_lse = torch.randn((bh, t), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(3))
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    delta = fa._delta(g, out, g_lse)
    n = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (n[0] + 1, n[1] + 1)
    want_dq = fa.flash_attention_dq_reference(q, k, v, g, lse, delta, causal=causal)
    want_dk, want_dv = fa.flash_attention_dkv_reference(q, k, v, g, lse, delta,
                                                        causal=causal)
    tol = FLASH_TOL[dtype][1]
    for name, a, b in (("dq", dq, want_dq), ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert a.dtype == dtype and a.shape == b.shape
        assert _row_err(a, b) < tol, name


@pytest.mark.cuda
def test_split_dq_is_bitwise_repeatable(require_cuda):
    """K4a writes each dq row once from registers: no atomics, so two
    launches on the same inputs give the same bits."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((8, 1024, 64), torch.bfloat16, seed=4)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa._delta(g, out)
    first = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True)
    second = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 63, 65, 129, 1000])
def test_split_dq_bf16_tensor_core_tiles_at_ragged_lengths(require_cuda, causal, d, t):
    """bf16 K4a runs on the tensor cores (flash_wgmma::dq_kernel): dq
    against the plain version at lengths that are not multiples of the
    64-row tile, T 1 included, under FLASH_TOL, with a non-zero lse
    cotangent (without it dq at T 1 is 0 up to rounding)."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((3, t, d), torch.bfloat16, seed=11)
    g_lse = torch.randn((3, t), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(12))
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    delta = fa._delta(g, out, g_lse)
    n = fa.flash_bwd_dq.launches
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == n + 1
    want = fa.flash_attention_dq_reference(q, k, v, g, lse, delta, causal=causal)
    assert dq.dtype == torch.bfloat16 and dq.shape == want.shape
    assert _row_err(dq, want) < FLASH_TOL[torch.bfloat16][1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("split", [False, True], ids=["fused", "split"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_exp2_kernels_match_reference(require_cuda, monkeypatch, dtype, split, d):
    """Under _USE_EXP2 the kernels (K2 with K3 or K4) against the plain
    versions, which read the switch too, and against the natural-exp
    forward: the same function."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((3, 384, d), dtype, seed=5)
    nat_out, nat_lse = fa.flash_fwd(q, k, v, causal=True)
    monkeypatch.setattr(fa, "_USE_EXP2", True)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    bwd = fa.flash_bwd_split if split else fa.flash_bwd
    grads = bwd(q, k, v, out, lse, g, causal=True)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, causal=True)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    assert _row_err(out, want_out) < fwd_tol
    assert _rel_err(lse, want_lse) < 1e-5
    assert _row_err(out, nat_out) < fwd_tol and _rel_err(lse, nat_lse) < 1e-5
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert _row_err(a, b) < bwd_tol, name


@pytest.mark.cuda
def test_split_kernels_refuse_what_they_cannot_take(require_cuda):
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((2, 128, 64), torch.float32)
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa._delta(g, out)
    with pytest.raises(ValueError):
        fa.flash_bwd_dq(q, k, v, g, lse, delta[:, :64].contiguous(), causal=True)
    with pytest.raises(ValueError):
        fa.flash_bwd_dkv(q, k.bfloat16(), v, g, lse, delta, causal=True)


# -- conv3x3 + BN statistics (K5) ---------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["s0", "s1", "s2", "border"])
def test_conv3x3_stats_matches_reference(require_cuda, shape):
    """The probe's shapes at batch 2, and a border-heavy 7 x 9 image (one
    partial 8 x 8 tile, every pixel on or beside the border), in bf16
    under the probe's limits (``check`` raises above them)."""
    from distributed_training_tpu_torch.ops.conv3x3_stats import conv3x3_stats
    from distributed_training_tpu_torch.tools import conv_fusion_probe as probe

    n, h, w, cin, cout = (3, 7, 9, 16, 32) if shape == "border" else (2, *probe.SHAPES[shape][2:])
    x, wts = probe.inputs(n, h, w, cin, cout, "cuda", seed=1)
    before = conv3x3_stats.launches
    probe.check(x, wts)
    assert conv3x3_stats.launches == before + 1


@pytest.mark.cuda
def test_conv3x3_stats_float32_and_repeatable(require_cuda):
    """float32 inputs: the kernel and the plain version sum the same exact
    products in another order (out within float32 noise); and the sums,
    reduced in a fixed order without atomics, repeat bit for bit."""
    from distributed_training_tpu_torch.ops.conv3x3_stats import (
        conv3x3_stats,
        conv3x3_stats_reference,
    )
    from distributed_training_tpu_torch.tools import conv_fusion_probe as probe

    x, wts = probe.inputs(2, 7, 9, 16, 32, "cuda", seed=2)
    x, wts = x.float(), wts.float()
    out, s, ss = conv3x3_stats(x, wts)
    want = conv3x3_stats_reference(x, wts)
    torch.testing.assert_close(out, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, want[1], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ss, want[2], rtol=1e-5, atol=1e-4)
    again = conv3x3_stats(x, wts)
    assert torch.equal(again[1], s) and torch.equal(again[2], ss)


@pytest.mark.cuda
def test_conv3x3_stats_refuses_what_it_cannot_take(require_cuda):
    from distributed_training_tpu_torch.ops.conv3x3_stats import conv3x3_stats

    x = torch.randn(2, 8, 8, 16, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(3, 3, 16, 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3_stats(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        conv3x3_stats(x, w.float())
    with pytest.raises(ValueError):
        conv3x3_stats(x.double(), w.double())
    with pytest.raises(ValueError):
        conv3x3_stats(x, w.cpu())
    with pytest.raises(ValueError, match="multiple"):
        conv3x3_stats(x[:1].expand(3, 8, 8, 16).contiguous(), w, bn=2)


@pytest.mark.cuda
@pytest.mark.parametrize("cout", [32, 64, 128, 256])
@pytest.mark.parametrize("cin", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("h,w", [(7, 9), (13, 17), (14, 14)])
def test_conv3x3_stats_bf16_tensor_core_at_ragged_sizes(require_cuda, h, w, cin, cout):
    """bf16 K5 runs on the tensor cores (conv_wgmma::conv_kernel): images
    that 8 x 8 tiles do not divide, Cin below, at and above the 64-channel
    chunk, Cout at the n32 form (32) and over several 64-channel slices,
    under the probe's limits (``check`` raises above them)."""
    from distributed_training_tpu_torch.ops.conv3x3_stats import conv3x3_stats
    from distributed_training_tpu_torch.tools import conv_fusion_probe as probe

    x, wts = probe.inputs(2, h, w, cin, cout, "cuda", seed=h + cin + cout)
    before = conv3x3_stats.launches
    probe.check(x, wts)
    assert conv3x3_stats.launches == before + 1


@pytest.mark.cuda
def test_conv3x3_stats_sums_ignore_pixels_past_the_edge(require_cuda):
    """A 7 x 9 image in 8 x 8 tiles: the tile rows and columns past the
    edge are built from zero-filled halo pixels but still see the last real
    row and column. x is zero but for large values there, so those rows
    would move the sums far past the limits; the kernel's sums must match
    the plain version's, not those of the image padded to whole tiles."""
    from distributed_training_tpu_torch.ops.conv3x3_stats import (
        conv3x3_stats,
        conv3x3_stats_reference,
    )
    from distributed_training_tpu_torch.tools import conv_fusion_probe as probe

    x, wts = probe.inputs(2, 7, 9, 16, 32, "cuda", seed=13)
    edge = torch.zeros_like(x)
    edge[:, -1], edge[:, :, -1] = 8 * x[:, -1], 8 * x[:, :, -1]
    _, s, ss = conv3x3_stats(edge, wts)
    _, want_s, want_ss = conv3x3_stats_reference(edge, wts)
    padded = torch.zeros((2, 8, 16, 16), dtype=x.dtype, device="cuda")
    padded[:, :7, :9] = edge
    _, tile_s, tile_ss = conv3x3_stats_reference(padded, wts)
    rss = want_ss.sqrt()
    assert ((tile_ss - want_ss).abs() / want_ss).min() > 100 * probe.SUMSQ_TOL
    assert ((s - want_s).abs() / rss).max() <= probe.SUM_TOL
    assert ((ss - want_ss).abs() / want_ss).max() <= probe.SUMSQ_TOL


@pytest.mark.cuda
def test_conv3x3_stats_bf16_is_bitwise_repeatable(require_cuda):
    """bf16 K5 twice on the same inputs: each block writes its out tile and
    its partial sums once and the caller sums the partials in a fixed
    order, so out, sum and sumsq repeat bit for bit."""
    from distributed_training_tpu_torch.ops.conv3x3_stats import conv3x3_stats
    from distributed_training_tpu_torch.tools import conv_fusion_probe as probe

    x, wts = probe.inputs(4, 28, 28, 128, 128, "cuda", seed=14)
    first, second = conv3x3_stats(x, wts), conv3x3_stats(x, wts)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_conv3x3_stats_bf16_refuses_channels_not_a_multiple_of_8(require_cuda):
    """The tensor-core kernel copies 16-byte rows: in bf16 Cin and Cout must
    be multiples of 8, and its C entry refuses 12 (returns
    cudaErrorInvalidValue, launching nothing); the wrapper pads 12 to 16
    and slices back, where float32 takes multiples of 4 on its CUDA-core
    kernel as they are."""
    from distributed_training_tpu_torch.ops import conv3x3_stats as k5
    from distributed_training_tpu_torch.ops.conv3x3_stats import (
        conv3x3_stats,
        conv3x3_stats_reference,
    )

    x = torch.randn(2, 8, 8, 12, device="cuda")
    w = torch.randn(3, 3, 12, 12, device="cuda") * 0.05
    xb, wb = x.bfloat16(), w.bfloat16()
    out = torch.empty_like(xb)
    part = torch.empty((2, 12), device="cuda")
    err = k5._lib().conv3x3_stats(
        xb.data_ptr(), wb.data_ptr(), out.data_ptr(), part.data_ptr(),
        part.data_ptr(), 2, 8, 8, 12, 12, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 1  # cudaErrorInvalidValue
    padded = k5.pad_channels(xb, wb)
    assert padded[0].shape[-1] == padded[1].shape[-1] == 16 and padded[2] == 12
    got = conv3x3_stats(xb, wb)
    assert got[0].shape == (2, 8, 8, 12) and got[1].shape == (12,)
    out, _, _ = conv3x3_stats(x, w)
    torch.testing.assert_close(out, conv3x3_stats_reference(x, w)[0],
                               rtol=1e-5, atol=1e-5)


# -- float16 and padding (K2-K5) -----------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 65, 384, 1000])
def test_flash_fp16_tensor_core_kernels_match_reference(require_cuda, causal, d, t):
    """float16 runs the fp16 instantiations of K2, K3, K4a and K4b (wgmma
    .f16): each against its plain version at ragged and whole-tile lengths,
    under FLASH_TOL[float16], with a non-zero lse cotangent; every call a
    launch."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((3, t, d), torch.float16, seed=21)
    g_lse = torch.randn((3, t), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(22))
    fns = (fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    n = [f.launches for f in fns]
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    grads = fa.flash_bwd(q, k, v, out, lse, g, g_lse, causal=causal)
    delta = fa._delta(g, out, g_lse)
    dq4 = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal)
    dk4, dv4 = fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [x + 1 for x in n]
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse, causal=causal)
    fwd_tol, bwd_tol = FLASH_TOL[torch.float16]
    assert out.dtype == torch.float16
    assert _row_err(out, want_out) < fwd_tol
    assert _rel_err(lse, want_lse) < 1e-5
    for name, a, b in zip(("dq", "dk", "dv", "K4a dq", "K4b dk", "K4b dv"),
                          (*grads, dq4, dk4, dv4), (*want, *want)):
        assert a.dtype == torch.float16 and a.shape == b.shape
        assert _row_err(a, b) < bwd_tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("d", [16, 48, 96])
def test_flash_pads_other_head_dims(require_cuda, dtype, d):
    """A head dim between the instantiated ones is zero-padded to the next
    (32, 64, 128) and sliced back, with the true d's scale: K2, K3, K4a and
    K4b each launch once and match the plain versions at d."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    q, k, v, g = _attn_inputs((3, 200, d), dtype, seed=d)
    fns = (fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    n = [f.launches for f in fns]
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    grads = fa.flash_bwd(q, k, v, out, lse, g, causal=True)
    delta = fa._delta(g, out)
    split = (fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True),
             *fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True))
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [x + 1 for x in n]
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, g, causal=True)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    assert out.shape == q.shape and out.is_contiguous()
    assert _row_err(out, want_out) < fwd_tol
    assert _rel_err(lse, want_lse) < 1e-5
    for a, b in zip((*grads, *split), (*want, *want)):
        assert a.shape == b.shape and a.dtype == dtype
        assert _row_err(a, b) < bwd_tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["s0", "s1", "s2", "border"])
def test_conv3x3_stats_fp16_matches_reference(require_cuda, shape):
    """float16 K5 (the fp16 conv_wgmma::conv_kernel) at the probe's shapes
    at batch 2 and on a border-heavy 7 x 9 image, under the probe's float16
    limits."""
    from distributed_training_tpu_torch.ops.conv3x3_stats import conv3x3_stats
    from distributed_training_tpu_torch.tools import conv_fusion_probe as probe

    n, h, w, cin, cout = (3, 7, 9, 16, 32) if shape == "border" else (2, *probe.SHAPES[shape][2:])
    x, wts = probe.inputs(n, h, w, cin, cout, "cuda", seed=5, dtype=torch.float16)
    before = conv3x3_stats.launches
    probe.check(x, wts)
    assert conv3x3_stats.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("cin,cout", [(3, 12), (20, 36), (13, 5)])
def test_conv3x3_stats_pads_other_channel_counts(require_cuda, dtype, cin, cout):
    """Cin and Cout that are not multiples of the kernel's (8 in the 16-bit
    types, 4 in float32) are zero-padded and sliced back: one launch, out
    of the true shape, under the probe's limits."""
    from distributed_training_tpu_torch.ops.conv3x3_stats import conv3x3_stats
    from distributed_training_tpu_torch.tools import conv_fusion_probe as probe

    x, wts = probe.inputs(2, 7, 9, cin, cout, "cuda", seed=cin + cout, dtype=dtype)
    before = conv3x3_stats.launches
    out, s, ss = conv3x3_stats(x, wts)
    assert conv3x3_stats.launches == before + 1
    assert out.shape == (2, 7, 9, cout) and s.shape == ss.shape == (cout,)
    probe.check(x, wts)
