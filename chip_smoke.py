"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result line:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel in ``distributed_training_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel), and print ptxas's
   registers and spills, the dynamic shared memory and the count of HGMMA
   instructions in the SASS (``cuobjdump``) of each of the 44 tensor-core
   instantiations, bf16 and fp16, of K2, K3, K4a, K4b (d 32, 64, 128, 256
   and the d > 256 kernels) and K5 (one missing, no HGMMA, or a spill at d
   64, above 256 or in K5, fails);
3. kernel phase: the fused-Adam kernel against its plain PyTorch version
   on all 62 ResNet-18 parameter shapes for 3 steps, and its time beside
   the plain version's, ``torch.optim.Adam(fused=True)``'s (a yardstick
   only; the port never calls it) and the least time the card could take;
4. train phase: ``Trainer.fit()`` on full-width ResNet-18, batch 100, 20
   steps of ``hybrid_adam`` in fp32, then eval; the loss must be finite
   and fall, and every optimizer step must have gone through the kernel;
   the trained model's logits on the card must match the same model's on
   the CPU;
4b. bf16 image phase: ``Trainer.fit()`` on full-width ResNet-18 in bf16
   (20 steps of ``hybrid_adam``, batch 100): the loss finite and falling,
   K1 once a step; then the same with ``ema_decay`` 0.9, whose eval must
   go through the EMA weights;
5. fp16 phase: a few ``torch_ddp_fp16`` steps through the dynamic loss
   scale and its guarded, out-of-place update;
5b. DP/ZeRO phase: each of the five plugin presets (``torch_ddp``,
   ``torch_ddp_fp16``, ``low_level_zero`` ZeRO 1, ``gemini`` ZeRO 3,
   ``deepspeed`` ZeRO 2 with ``cpu_offload``) runs 5 steps of full-width
   ResNet-18 (batch 100) through ``Trainer.fit()``, first without a
   process group, then under a world-1 NCCL group that
   ``runtime.distributed.initialize_distributed`` brings up (SyncBN, the
   stage's collectives, K1 on the rank's shard); the loss must be finite
   and fall, K1 must launch once a step, each step's loss must match the
   no-group run's, and the offloaded moments must be pinned host tensors;
   one more step counted (``utils/collectives.py``), printed as a
   ``[collectives]`` line and held exactly, counts and bytes, to
   :func:`expected_dp_collectives`; images/s and peak memory per preset;
6. flash kernel phase: the flash-attention forward (K2), fused backward
   (K3) and split backward (K4a dq, K4b dk and dv) against their plain
   versions over float32 and bfloat16, causal and not, head dims 32, 64
   and 128 and T 128, 384 and 1024 (with a non-zero lse cotangent), and at
   every shape of ``flash_kernel_bench`` (bf16 causal);
   ``flash_attention_lse`` through autograd on the card against the CPU;
   K4a's dq bit for bit across two launches; then all four timed at the
   GPT-2-small shape (BH 192, T 1024, d 64, bf16, causal) beside their
   plain versions, ``F.scaled_dot_product_attention`` forward and backward
   (yardsticks only; the port never calls it) and the least time the card
   could take, with TFLOP/s, the share of the bound, and their times
   before the tensor-core redesign; then at every shape of
   ``flash_kernel_bench`` the split pair's backward beside K3's;
6b. ring phase: ring attention (``parallel/ring_attention.py``, the
   sequence strategy's attention) over P virtual ranks in one process,
   through the package's own hop and merge (``ring_attention_virtual``:
   each rank's hops in ring order, K2 causal on the diagonal block and
   not on past blocks, no kernel on future ones, the float32 ``logaddexp``
   merge), forward and backward through autograd (K3 with a nonzero lse
   cotangent), at GPT-2-small's attention shape (B 16, H 12, T 1024, d
   64, bf16, causal) with P 2 and 4, and at the flash bench's long shape
   (B 2, H 12, T 16384) with P 4 (T_local 4096); out, dq, dk and dv (dk
   and dv summed over the ranks that saw each block) against one
   unsharded ``flash_attention`` call on K2/K3, and on every head against
   the plain version (its backward fed the unsharded call's out and lse),
   by row within the flash tolerances; K2 and K3 launched once a hop that runs (counted from 0
   around the checked run); each rank's hop times against the unsharded
   call's over P;
7. LM phase: ``LMTrainer.fit()`` on GPT-2-small at full width (12 layers,
   hidden 768, 12 heads, vocab 50304, T 1024, batch 16, bf16,
   ``attn_impl="flash"``, ``hybrid_adam``), 10 steps and an eval of 2
   batches; the loss must be finite and fall, every attention forward and
   backward must have gone through K2/K3 and every update through K1; with
   the trained weights, each layer's attention output, one eval batch's
   logits and the eval loss with the exact attention must match the flash
   ones; then steady-state ms/step, tokens/s, device-busy share and peak
   memory;
7b. fp16 LM phase: 5 steps of the same GPT-2-small ``LMTrainer`` in
   fp16 (loss scaling), K2 and K3 launched as in the bf16 phase, the loss
   finite;
7c. fp16 and padding phase: K2–K4 in fp16 at the flash bench's five
   shapes, K2–K4 at head dims 16, 48 and 96 (padded to the instantiated
   ones) in bf16 and fp16, K5 in fp16 at s0–s2 and at Cin/Cout 3→12 and
   20→36 in every dtype, each against its plain version; then the fp16
   times of K2–K4 at the GPT-2-small shape and of K5 at s0–s2;
7d. ResNet CLI phase: ``resnet/torch_cuda/train.py -p torch_ddp_fp16``
   (what ``run.sh`` runs) for one short epoch on synthetic CIFAR;
7d'. gpt_cli phase: the GPT CLI (``gpt/torch_cuda/train.py``'s
   ``build_trainer`` and ``fit``, what ``main`` runs) at GPT-2-small width
   (vocab 50304, 12 layers, 12 heads, hidden 768, T 1024, batch 16, bf16,
   flash, bf16 logits, no head bias) for 4 steps and an eval under a
   world-1 NCCL group, at ZeRO 2 with remat and the chunked CE (256) and a
   JSONL sink: the loss finite and falling, K2 launched twice a layer a
   step (forward and recompute) and once a layer an eval batch, K3 once a
   layer a step, the JSONL lines written, one more step's collectives
   held as in the DP phase; tokens/s and peak memory beside
   the same run without remat and the chunked CE, whose peak must be
   higher; with fp32 logits, stage 0 against stage 3 and the
   saved-probabilities CE against the default, each step's loss; then the
   CLI as a subprocess (GPT-2-small width, 2 layers, T 256, float32),
   SIGTERM after its third logged step: it must save and exit 0, and the
   run resumed with ``--auto-resume`` must end at the uninterrupted run's
   step count and final loss;
7d''. MoE phases: the GPT CLI's trainer at GPT-2-small width with
   ``--moe`` at the JAX CLI's defaults (8 experts at every 2nd layer,
   top-1, capacity factor 1.25; B 16 T 1024, bf16, flash, ``hybrid_adam``)
   for 8 steps and an eval, then top-2 with ``--mlp-type residual``,
   beside the dense model of the same flags: losses finite and falling,
   the aux loss finite and positive, K2/K3 once a layer a step (K2 also an
   eval batch), K1 once a step; the model's parameter count, tokens/s, ms a
   step, peak memory and each MoE layer's kept share; one MoE layer at that
   width in float32 on the card against the CPU (output, aux, the input's
   and the router's gradients within 1e-5 of their largest magnitude);
   then the ResNet CLI's ``--moe --num-experts 4`` (``moe_mlp``, synthetic
   CIFAR, batch 100, 20 steps of ``hybrid_adam``): losses falling, K1 once
   a step, the trained logits on the card against the CPU within 1e-3;
7d'''. pipeline phase: GPT-2-small (B 16, T 1024, flash) through the
   virtual pipeline (every stage in this process) at S 4 M 4 (GPipe), S 4
   v 3 M 4 (circular) and GPipe with remat, against the plain model on the
   same weights and batch: float32 loss within 1e-5 relative and every
   gradient within 1e-4 of its tensor's largest magnitude, K2 12·M (24·M
   with remat) and K3 12·M a step; one bf16 ``hybrid_adam`` step through
   the pipeline step against the plain step's loss within 5e-3, the
   bubble fraction, ms a step beside the plain model's, peak memory and
   a ``{"pipeline": ...}`` line;
7d4. flight phase: the flight instruments (``observability/``, on by
   default as in JAX) on full-width ResNet-18 (``Trainer.fit``, batch 100,
   bf16) and GPT-2-small (``LMTrainer.fit``, B 16 T 1024, bf16, flash,
   ``hybrid_adam``): recorder off, on, on, off in one process, each train
   loop iteration timed (the card synchronised at each step's entry), the
   "on" median within the "off" runs' interquartile spread of the "off"
   median; one run off and one on under ``torch.cuda.set_sync_debug_mode
   ("warn")`` with as many synchronising calls; every flush of an "on"
   run with finite ``mfu``, ``model_flops_per_sec`` and memory keys, its
   dump rendered by the port's ``flight_report``; then GPT-2-small with
   every parameter NaN after step 2: ``anomaly_action="skip"`` completes
   and leaves the dump, the batch ``.npz`` and a non-empty ``torch.profiler``
   trace of 2 steps, ``"raise"`` raises ``AnomalyError`` after that window;
   K1 once a step and K2/K3 once a layer a step in every run;
7d5. trace phase: the span trace on the same two configurations, trace
   off, on, on, off (mean loop interval each, reported), the span calls'
   own host time under 1% of the step, as many synchronising calls with
   the trace on as off, the file rendered by the port's ``trace_report``
   with the wall clock's spans, the async writer's track and one step span
   a step; GPT-2-small's traced run also serves ``metrics_port``, scraped
   (``/metrics``, ``/healthz``, ``/vars``, each 200, the flushed MFU in
   ``/vars``) from a second thread during the fit (see TRACE_STEPS);
7d6. resilience phase: the chaos drills through both CLIs on ResNet-18
   (batch 100) and GPT-2-small at full width, 2 of its 12 layers
   (RES_GPT_LAYERS): SIGTERM at a step (the
   restored state bit for bit the saved one, then the resume), SIGKILL (the
   resume from the newest committed save) in subprocesses; a torn newest
   save skipped and quarantined; a corrupted committed save refused by
   ``verify_checkpoint``; data-read faults over an imagefolder tree and an
   LM corpus, counted per key; slow steps in the flight dump; each resumed
   run's losses held to the two uninterrupted runs by the continuation
   rule, its branch printed (see RES_EPOCHS);
7d7. generate phase: GPT-2-small trained 4 steps, saved, restored through
   ``inference/restore.py``; greedy generation at batch 8 for 128 + 128
   and 512 + 512 tokens, the cached logits against the full forward, the
   tokens against the teacher-forced rollout (near ties counted), beam
   search, the generate CLI; prefill ms, decode ms a token, tokens/s, the
   cache's MiB and the peak (see GEN_SHAPES);
7d8. serve phase: the serving engine on GPT-2-small (bf16, random weights):
   32 requests of 64 greedy tokens through the paged engine, the legacy
   engine and a two-tier run on half the pool with preemption; every
   request finished, the pool balanced, the ledgers conserved, the
   preempted requests and every request against its uninterrupted or
   Generator tokens (a difference only at a near tie); TTFT, TPOT,
   tokens/s, reads of the card an iteration, the busy share (see
   SERVE_REQUESTS);
7d9. serve-features phase: the same model, paged: the prefix cache on
   against off over requests sharing a 256-token system prompt,
   speculative decoding (n-gram and GPT self-drafter) against spec_k 0,
   int8 weights against the dequantized set, int8 KV pages against the
   bf16 pool (bytes a token and the first differences' gaps within their
   bounds), the journal crashed mid-run and recovered in a new engine
   (every request once), the hot swap of a committed epoch 2 armed by
   ``HotSwapper.poll_once`` mid-run and rolled back; tokens under the
   near-tie gate; prefill positions saved, TTFT, acceptance, tokens a
   dispatch, tokens/s, weight and pool bytes, recovery time, recomputed
   tokens, ``swap_blocked_s`` (see FEAT_PAGE);
7d10. fleet phase: two ``serve_net`` replica processes at GPT-2-small width
   on the card under the supervisor, behind the router in this process:
   prefix routing against round_robin on shared_prefix (prefix-hit tokens,
   TTFT and tokens/s through the door), a SIGKILL mid-stream (1 restart,
   1 breaker open, 1 failover resume, ``fleet_trace --check-failover``), a
   rolling deploy mid-load (2 deploys, 0 failed); the door's tokens against
   an in-process replica under the near-tie gate; SLO alerts and an
   incident bundle from an overloaded in-process engine, ``/timeseries``
   and ``/alerts`` scraped; no kernel runs (see FLEET_WIDTH);
7e. d-256 phase: K2–K4 at head dims 256 and 160 (padded to 256), and at
   257, 320, 384 and 512 (768 in bf16; the d > 256 kernels, d padded to a
   multiple of 64), in float32, bf16 and fp16, T 100 and 384, causal and
   not, against their plain versions, K4a bit for bit across two launches
   above 256; then all four timed in bf16 at BH 48 (4 × 12 heads), T
   1024, d 256 and at BH 24 (2 × 12), T 1024, d 512, causal, beside their
   plain versions, SDPA (and the backend it ran) and the bound;
8. exp2 phase: under the ``_USE_EXP2`` switch, K2, K3 and K4 against the
   plain versions (exp2 too) over the flash grid's bf16 causal cases (head
   dims 32, 64, 128) and at every shape of ``flash_kernel_bench``, then
   each timed at the GPT-2-small shape;
9. conv phase: the conv3x3 + BN-statistics kernel (K5) against its plain
   version on a border-heavy 7 x 9 image (the probe's own verify holds it
   at the ResNet-50 shapes s0, s1, s2 in the tools phase), and the plain
   version timed at those shapes (batch 256);
10. tools phase, the entry points that run K4 and K5:
   ``flash_kernel_bench.main`` over its five shapes as it is, with
   ``--split-bwd`` and with ``--exp2`` (``--iters 5``), then
   ``conv_fusion_probe.main`` over s0, s1, s2; each run starts with every
   kernel count at 0, each must verify and launch its kernels, and both
   switches must be back to False after them;
10b. bench phase: ``python -m distributed_training_tpu_torch.bench`` at
   its defaults (the bf16 ResNet-50 leg at 224², batch 512 as 2 × 256,
   SGD; the GPT-2-small AdamW leg at B16 T1024 with flash attention; each
   leg a CUDA graph of 15 steps a call, ``--steps-per-call``), each leg
   printing its JSON line, then the LM leg with ``--lm-optimizer
   hybrid_adam``; every value and MFU finite and positive, MFU at most 1,
   the losses finite, K2/K3 once a layer and K1 once a captured or priming
   step on the hybrid_adam leg; then the graph check on the image and the
   hybrid_adam legs (two replays of 15 steps against 30 eager steps from
   each of two clones of the state, within 5× the gap of the two eager
   runs; the counts on the host and the card; one replay's K1/K2/K3
   counted by name among the captured graph's kernel nodes, and each seen
   in a profiler trace of a replay; ms/step, busy share, graph pool and
   eager peak both ways; two eager steps of each profiled: device busy
   share, kernels by device time); last, both graph checks again under a
   world-1 NCCL group (one replay each), the step's collectives captured,
   K1–K3 counted exactly, NCCL's kernel nodes and version printed, and
   the part's seconds;
10c. data phase: the native augment library built on this host
   (``available()``) and bit for bit the numpy path on 256 crops at 224
   from 257² images; the bench's ``--data-only --data-mode both`` and
   ``--data-concurrent --data-stress`` over 512 and 1024 JPEGs (the
   concurrent one 10 steps after 1; ``DATA_BENCH_CUT``), every value finite and
   positive, the decoded cache through the native library;
   ``Trainer.fit()`` on full-width ResNet-50 (imagenet stem, 224, bf16,
   ``hybrid_adam``) over the decoded cache of a JPEG tree, 3 epochs of 10
   steps at batch 32, at ``prefetch`` 0 and 2: the loss finite, K1 once a
   step, the batches the step received at 2 bit for bit those at 0, the
   prefetched pinned copies on a stream no kernel runs on; ms/step and
   the device's busy share of each; then the bench's image leg by default,
   with ``--remat`` and with ``--remat-policy conv`` (4 eager steps each),
   images/s and peak memory, remat's peak below the default's;
10d. vit phase: the bench's image leg with ``--model vit_b16`` at batch
   256 (2 x 128) and at 512 with ``--remat`` (the JAX bench's ViT flags),
   images/s, MFU (finite, at most 1), p50/p95 ms and peak memory each;
   ViT-B/16's float32 logits on the card against the CPU within 1e-3 of
   their largest magnitude; a ``{"vit": ...}`` line;
11. K5's time at each probe shape beside its yardsticks and its time
   before the tensor-core redesign, a ``{"kernels": [...]}`` line (six
   kernels, each with its launches by path, its fp16 time, its d-256 and
   d-512 times and its tensor-core instantiations; K2 and K3 with their
   ring launches and each rank's hop times), then the card line,
   and last ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits with code 2 before doing anything.

``torchrun --nproc-per-node W chip_smoke.py --mesh`` (W 2 or 4 GPUs)
runs instead (:func:`mesh_main`), over NCCL: the image Trainer on
ResNet-18 across the ranks at the global batch 100 for each plugin preset
(SyncBN, ZeRO 0/1/3 and 2 with ``cpu_offload``, fp32 and fp16) against
the same preset at world 1, local BN, and a ZeRO 1 save resumed at world
1; GPT-2-small with MoE as DP W, EP W and EP 2 × DP 2 and ``moe_mlp`` as
DP W and EP W, each against its DP run's losses; ViT-B/16 through the
image Trainer (bf16, ZeRO 1, hybrid_adam) as DP W and over the model axis
(model 2 and, at W 4, model 2 x data 2 and model 4), plain and
overlapped, against DP W's losses; GPT-2-small MoE at a capacity that
drops no token under the sequence and model axes (SP W, TP W; at W 4 SP 2
x EP 2, TP 2 x EP 2, TP 2 x SP 2) and as DP W with two accumulation
steps, against DP W's losses; then the LM trainer's strategies: data
parallelism, the ring over W ranks, TP over W with and without the
overlap schedule, and at W 4 TP×SP (overlapped too) and TP×DP, through
the GPT CLI at GPT-2-small width, each against data parallelism's
losses; then (``bench``, see :func:`bench_mesh`) the bench's legs over
the W ranks at the default 15 steps a call, each a CUDA graph with NCCL's
collectives inside the capture, held against eager steps at the same
world, beside the same legs at world 1 on each rank's card (run first);
then (W 4) the pipeline
through the GPT CLI (``PP_LAYOUTS``: pipe 4 GPipe and circular, pipe 2 ×
data 2, × model 2, × sequence 2, pipe 4 with accumulation, homogeneous
MoE at pipe 4 and pipe 2 × expert 2) against DP 4's losses (MoE: the CE),
and the circular run's save resumed at world 1; then (W 4) the fsdp axis
(``FSDP_LAYOUTS``: GPT-2-small at fsdp 4 ZeRO 0 and 3, fsdp 2 × data 2
ZeRO 1, × model 2, × sequence 2, × pipe 2 ZeRO 1, MoE at fsdp 2 × expert
2; ResNet-18 at fsdp 4 SyncBN; ViT-B/16 at fsdp 2 × model 2), each against
its DP 4 run's losses, rates, rank 0's peak and its parameter and
optimizer-state bytes against DP 4's (they must fall by the fsdp size),
and the fsdp 4 save resumed at world 1; then (``resilience``) the chaos
drills across the ranks: a slow step on rank 1 named the straggler by
every rank, a SIGTERM kill on every rank resumed at world 4 by the
continuation rule, and the flight recorder's gloo exchange timed a flush
on each rank (see RES_MESH_EPOCHS); then (W 4, ``collectives``) the
collective accounting tool's micro rows over NCCL against the same rows
over gloo on the CPU, and one counted, timed step at full width a
strategy (GPT-2-small's, ResNet-18 data parallel), the data-parallel ones
held exactly to what the port's code implies (see COLL_WARMUP).
``--mesh PART ...`` (names of ``MESH_PARTS``: a11, moe, vit, moe_axes,
lm, bench, pp, fsdp, resilience, collectives) runs only those parts.

``python3 chip_smoke.py --phase NAME ...`` runs the build and only the
named phases (kernel, bench, dp, gpt_cli, data, ring, moe_lm, moe_image, vit, pipeline,
flight, trace, resilience, generate, serve, serve_features, fleet), without a result line.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import sys
import tempfile
import threading
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from distributed_training_tpu_torch.utils.device import card_line, cuda_ms  # noqa: E402

# H100 SXM: 3.35 TB/s HBM3, 67 TFLOP/s float32 outside the tensor cores
# (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Per element of fused Adam: read p, g, m, v, write p, m, v (float32); and
# 12 float32 operations (3 for m, 4 for v, 5 for p).
ADAM_BYTES, ADAM_FLOPS = 28, 12
# Kernel vs plain version: both round each float32 operation in the same
# order, so they should agree exactly; this is the stated tolerance.
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7
# bf16 tensor-core peak (NVIDIA data sheet, dense, 700 W): the rate the
# flash kernels' bf16 operations are held to.
BF16_FLOPS = 989e12
# Flash kernels vs plain versions, row by row (a row is one query's out or
# dq, one key's dk or dv): the largest error in the row over the RMS of the
# plain version's row, that RMS held at least a tenth of the whole tensor's
# (causal row 0 has dq = 0, the last keys' dk and dv rows are ~1/200 of
# the typical one). float32: the same products summed in another order
# (dQ's k-tile parts added with atomics, in an order that changes between
# runs). bfloat16: the kernels round p and dS to bfloat16 before they
# multiply V, dO, Q and K (as the TPU kernels do), the plain versions keep
# float32, and every output is rounded to bfloat16 (2**-9 of an element,
# several times that of the row's RMS). Each limit is about three times the
# worst error measured on an H100 80GB HBM3 at 700 W (PERF.md).
FLASH_TOL = {torch.float32: (3e-5, 3e-5), torch.bfloat16: (0.1, 0.1),
             # float16 rounds p and dS where bfloat16 does, with 3 more
             # mantissa bits: an eighth of bfloat16's limits.
             torch.float16: (0.1 / 8, 0.1 / 8)}
# lse, float32 in both: the largest error over the largest magnitude.
LSE_TOL = 1e-5
# flash_attention_lse through autograd, bf16: the card's kernels against
# the CPU's plain versions, by row as above. Each run feeds its own out
# (bf16, rounded in other places) into delta, so dq differs by more than
# in the kernel-vs-plain cases, which share out: 0.2, about three times
# the worst reading (PERF.md). The loss's cotangents are fixed random
# tensors: a cotangent made from out itself (say, of the sum of out
# squared) passes those roundings into dO too, where they cancel in dq,
# and the comparison would measure the loss's conditioning, not the
# kernels.
LSE_GRAD_TOL = 0.2
# The GPT-2-small shape (bench.py bench_lm): batch 16, 12 heads, T 1024,
# head dim 64.
GPT_B, GPT_H, GPT_T, GPT_D, GPT_LAYERS = 16, 12, 1024, 64, 12
LM_STEPS, LM_EVAL_BATCHES = 10, 2
# The same trained bf16 weights with the flash and the exact attention:
# the exact path rounds the scores to bf16 before its float32 softmax and
# normalises p before it rounds it, the kernel keeps the scores float32 and
# rounds the unnormalised p. Row by row as above (a row is one token's
# 768-wide attention output, or its 50304 logits): each layer's attention
# on the same input within LM_ATTN_TOL; the whole model's logits, where
# the layers' differences add up, within LM_LOGITS_TOL; eval CE within
# LM_EVAL_ATOL nats. The first two are about three times what an H100
# 80GB HBM3 at 700 W measured (PERF.md); the eval CE read the same nine
# digits both ways there, and 1e-4 is about a hundred float32 steps of a
# mean near 11.
LM_ATTN_TOL, LM_LOGITS_TOL, LM_EVAL_ATOL = 0.15, 0.1, 1e-4


# The DP/ZeRO phase: the five plugin presets on full-width ResNet-18
# (batch 100, synthetic CIFAR), DP_STEPS steps each through Trainer.fit(),
# with a world-1 NCCL group and with none. With the group, BatchNorm takes
# the SyncBN path (local means of x and x² through an all-reduce, var =
# E[x²] − E[x]², its own backward) where the run without one takes
# cuDNN's batch norm, and cuDNN's backward kernels sum with atomics in an
# order that changes from run to run: each step's loss must agree with the
# no-group run's within DP_LOSS_RTOL, relative, by compute dtype. In fp32
# the two agree to 1.45e-7 on an H100 80GB HBM3 at 700 W; in fp16 the two
# batch norms round the fp16 activations at other places, 7e-6 apart at
# the first step, and 5 fp16 Adam steps amplify that to 1.47e-3 (PERF.md).
# Each limit is about three times (fp16) or seventy times (fp32, where
# only summation order differs) that reading.
DP_STEPS = 5
DP_LOSS_RTOL = {"fp32": 1e-5, "fp16": 5e-3}
DP_PRESETS = ("torch_ddp", "torch_ddp_fp16", "low_level_zero", "gemini", "deepspeed")


def _adam_dev_scalars(ps, gs, ms, vs, lr: float, b1: float, b2: float, eps: float) -> dict:
    """K1's device-scalar launch (``scalars=``, the one a CUDA graph of
    steps replays) on copies of ``ps``/``ms``/``vs``: three steps against
    the plain version given the same tensor scalars, each step's scalars
    computed on the card from a count tensor; the largest error."""
    from distributed_training_tpu_torch.ops.fused_adam import (
        adam_scalars_tensor,
        fused_adam_reference,
        fused_adam_update,
    )

    dev = ps[0].device
    got = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    ref = [(p.clone(), m.clone(), v.clone()) for p, m, v in zip(ps, ms, vs)]
    lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
    for step in range(1, 4):
        scalars = adam_scalars_tensor(lr_t, torch.tensor(step, device=dev), b1, b2)
        fused_adam_update(got[0], gs, got[1], got[2], b1=b1, b2=b2, eps=eps, scalars=scalars)
        ref = [fused_adam_reference(p, g, m, v, b1=b1, b2=b2, eps=eps, scalars=scalars)
               for (p, m, v), g in zip(ref, gs)]
    torch.cuda.synchronize()
    max_abs = 0.0
    for got_t, want in zip(zip(*got), ref):
        for a, b in zip(got_t, want):
            max_abs = max(max_abs, (a - b).abs().max().item())
            torch.testing.assert_close(a, b, rtol=ADAM_RTOL, atol=ADAM_ATOL)
    return {"max_abs_err": max_abs}


def _adam_launch_ms(ps, gs, ms, vs, lr: float, b1: float, b2: float, eps: float) -> dict:
    """K1 by value against K1 reading its scalars from the card (one
    ``(lr, bc1, bc2)`` tensor made once), on the same tensors, in turns
    (by value, device, device, by value)."""
    from distributed_training_tpu_torch.ops.fused_adam import (
        adam_scalars_tensor,
        fused_adam_update,
    )

    dev = ps[0].device
    scalars = adam_scalars_tensor(torch.tensor(lr, dtype=torch.float32, device=dev),
                                  torch.tensor(4, device=dev), b1, b2)
    calls = {"by_value": lambda: fused_adam_update(ps, gs, ms, vs, lr=lr, step=4, b1=b1,
                                                   b2=b2, eps=eps),
             "dev_scalars": lambda: fused_adam_update(ps, gs, ms, vs, b1=b1, b2=b2, eps=eps,
                                                      scalars=scalars)}
    times = {k: [] for k in calls}
    for k in ("by_value", "dev_scalars", "dev_scalars", "by_value"):
        times[k].append(cuda_ms(calls[k], 50))
    return {k: min(v) for k, v in times.items()}


def kernel_phase() -> dict:
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.ops.fused_adam import (
        fused_adam_reference,
        fused_adam_update,
    )

    dev = torch.device("cuda")
    model = get_model("resnet18").to(dev)
    shapes = [p for p in model.parameters()]
    assert len(shapes) == 62, len(shapes)
    n = sum(p.numel() for p in shapes)
    gen = torch.Generator(device=dev).manual_seed(0)
    ps = [torch.randn(p.shape, device=dev, generator=gen).to(
        memory_format=torch.channels_last if p.dim() == 4 else torch.contiguous_format)
        for p in shapes]
    gs = [torch.randn_like(p) for p in ps]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    ref = [(p.clone(), m.clone(), v.clone()) for p, m, v in zip(ps, ms, vs)]
    lr, b1, b2, eps = 1e-3, 0.9, 0.999, 1e-8
    for step in range(1, 4):
        fused_adam_update(ps, gs, ms, vs, lr=lr, step=step, b1=b1, b2=b2, eps=eps)
        ref = [fused_adam_reference(p, g, m, v, lr, step, b1, b2, eps)
               for (p, m, v), g in zip(ref, gs)]
    torch.cuda.synchronize()
    max_abs = max_rel = 0.0
    for got, want in zip(zip(ps, ms, vs), ref):
        for a, b in zip(got, want):
            d = (a - b).abs()
            max_abs = max(max_abs, d.max().item())
            max_rel = max(max_rel, (d / b.abs().clamp_min(1e-30)).max().item())
            torch.testing.assert_close(a, b, rtol=ADAM_RTOL, atol=ADAM_ATOL)
    print(f"[kernel] fused_adam vs plain on 62 ResNet-18 tensors ({n:,} params), "
          f"3 steps: max_abs_err={max_abs:.3g} max_rel_err={max_rel:.3g} "
          f"(tolerance rtol {ADAM_RTOL} atol {ADAM_ATOL})")

    adam = lambda: fused_adam_update(  # noqa: E731
        ps, gs, ms, vs, lr=lr, step=4, b1=b1, b2=b2, eps=eps)
    kernel_ms = cuda_ms(adam, 50)
    call_ms = cuda_ms(adam, 50, ahead=False)

    def plain():
        for p, g, m, v in zip(ps, gs, ms, vs):
            fused_adam_reference(p, g, m, v, lr, 4, b1, b2, eps)
    plain_ms = cuda_ms(plain, 20)

    lib_params = [torch.nn.Parameter(p.clone()) for p in ps]
    for p, g in zip(lib_params, gs):
        p.grad = g
    lib = torch.optim.Adam(lib_params, lr=lr, betas=(b1, b2), eps=eps, fused=True)
    library_ms = cuda_ms(lib.step, 50)

    bound_by_bytes = ADAM_BYTES * n / HBM_BYTES_PER_S * 1e3
    bound_by_ops = ADAM_FLOPS * n / FP32_FLOPS * 1e3
    bound_ms = max(bound_by_bytes, bound_by_ops)
    print(f"[kernel] fused_adam wrapper call back to back (host-bound): "
          f"{call_ms:.4f} ms")
    print(f"[kernel] fused_adam ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
          f"({ADAM_BYTES * n / 1e6:.1f} MB at 3.35 TB/s) "
          f"achieved {ADAM_BYTES * n / kernel_ms / 1e9:.3f} TB/s")
    # The device-scalar launch (what a CUDA graph of steps replays): held to
    # the plain version with the same tensor scalars, and timed beside the
    # by-value launch, here and at GPT-2-small's 149 tensors.
    dev_check = _adam_dev_scalars(ps, gs, ms, vs, lr, b1, b2, eps)
    resnet_ms = _adam_launch_ms(ps, gs, ms, vs, lr, b1, b2, eps)
    del ps, gs, ms, vs, ref, lib_params, lib
    with torch.device("meta"):
        gpt = get_model("transformer_lm", num_classes=50304, num_layers=GPT_LAYERS,
                        num_heads=GPT_H, hidden_dim=GPT_H * GPT_D, max_len=GPT_T)
    shapes = [p.shape for p in gpt.parameters()]
    gpt_n = sum(p.numel() for p in gpt.parameters())
    ps = [torch.randn(sh, device=dev, generator=gen) for sh in shapes]
    gs = [torch.randn_like(p) for p in ps]
    ms = [torch.zeros_like(p) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    gpt_ms = _adam_launch_ms(ps, gs, ms, vs, lr, b1, b2, eps)
    gpt_bound = ADAM_BYTES * gpt_n / HBM_BYTES_PER_S * 1e3
    del ps, gs, ms, vs
    torch.cuda.empty_cache()
    print(f"[kernel] fused_adam device-scalar launch vs plain (the same tensor scalars), "
          f"3 steps on the 62 ResNet-18 tensors: max_abs_err={dev_check['max_abs_err']:.3g}; "
          f"ms by value / device scalars (in turns): ResNet-18 "
          f"{resnet_ms['by_value']:.4f} / {resnet_ms['dev_scalars']:.4f}, GPT-2-small "
          f"({len(shapes)} tensors, {gpt_n:,} params) {gpt_ms['by_value']:.4f} / "
          f"{gpt_ms['dev_scalars']:.4f}, bound {gpt_bound:.4f}")
    return {"max_abs_err": max(max_abs, dev_check["max_abs_err"]), "ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_by_bytes >= bound_by_ops else "operations",
            "dev_scalars": {"max_abs_err": dev_check["max_abs_err"],
                            "resnet18_ms": resnet_ms,
                            "gpt2_small": {"tensors": len(shapes), "params": gpt_n,
                                           "ms": gpt_ms, "bound_ms": gpt_bound}}}


def _timed_train_epochs(trainer) -> list[float]:
    """Wrap ``trainer.train_epoch`` to record its synchronised wall time."""
    times = []
    inner = trainer.train_epoch

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    trainer.train_epoch = timed
    return times


def train_phase(ckpt_dir: str) -> int:
    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    steps = 20
    cfg = TrainConfig.from_plugin(
        "torch_ddp", model="resnet18", num_epochs=1, log_interval=5,
        optimizer=OptimizerConfig(name="hybrid_adam", scale_lr_by_world=True),
        data=DataConfig(dataset="synthetic_cifar", batch_size=100,
                        max_steps_per_epoch=steps),
        checkpoint=CheckpointConfig(directory=ckpt_dir))
    trainer = Trainer(cfg)
    times = _timed_train_epochs(trainer)
    fused_adam_update.launches = 0
    out = trainer.fit()
    launches = fused_adam_update.launches
    hist = trainer.meter.history
    losses = [h["loss"] for h in hist]
    print(f"[train] fit -> {out}")
    print(f"[train] logged losses {losses}; {steps} steps in {times[0]:.3f} s: "
          f"{steps / times[0]:.3f} steps/s, {steps * 100 / times[0]:.1f} images/s "
          f"(first step's cuDNN planning included)")
    if not all(map(lambda x: x == x and abs(x) != float("inf"), losses)):
        raise SystemExit(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"loss did not fall: {losses}")
    if out["steps"] != steps:
        raise SystemExit(f"expected {steps} committed steps, got {out['steps']}")
    if launches != steps or launches == 0:
        raise SystemExit(f"fused_adam launches {launches} != {steps} steps x 1")
    if not 0.0 <= out["final_acc"] <= 1.0:
        raise SystemExit(f"bad accuracy {out['final_acc']}")

    # The trained model on the card against the same weights on the CPU.
    import copy

    model = trainer.model.eval()
    cpu_model = copy.deepcopy(model).cpu()
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x.cuda()).cpu()
        want = cpu_model(x)
    assert got.shape == (4, 10) and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    print(f"[train] eval logits card vs CPU: max_abs_err={err:.3g} (tolerance 1e-3)")
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    from distributed_training_tpu_torch.data.pipeline import to_device

    loader, _ = trainer.make_loaders()
    batches = [to_device(b, trainer.device) for _, b in zip(range(10), loader)]
    steady_state(trainer, batches, 100, "images")
    return launches


def steady_state(trainer, batches: list, per_step: int, unit: str,
                 tag: str = "steady", profiled: int = 3) -> None:
    """Time train steps after warm-up on batches already on the card, and
    profile ``profiled`` of them: where the device time goes, and how much
    of the step the device is busy. ``per_step`` ``unit``s (images,
    tokens) go through each step."""
    for b in batches[:2]:
        trainer.train_step(trainer.state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for b in batches:
        trainer.train_step(trainer.state, b)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(batches) * 1e3
    print(f"[{tag}] {ms:.3f} ms/step, {1e3 / ms:.3f} steps/s, "
          f"{per_step * 1e3 / ms:.1f} {unit}/s over {len(batches)} steps "
          f"(batches on the card, after warm-up); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile([lambda b=b: trainer.train_step(trainer.state, b)
              for b in batches[:profiled]], tag)


def _device_rows(prof) -> list:
    """``(device µs, name, count)`` of the profile's device events
    (kernels, copies, memsets), largest first. Device events only: an
    operator's row carries the time of the kernels it launched, which are
    rows of their own, so summing every row would count that time twice."""
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    return rows


def _busy_us(prof) -> float:
    """The device's busy µs in the profile: the union of its device events'
    ``[start, end)`` intervals (kernels, copies, memsets), so that what runs
    on two streams at once (NCCL's kernels beside the compute stream, a
    copy beside a kernel) counts once. Summing the rows would count it
    twice and can pass 100% of the wall."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def _profile(calls: list, tag: str) -> None:
    """Run ``calls`` under ``torch.profiler`` and print where the device
    time goes: the wall time, the device's busy share of it, and the
    kernels by device time (the port's own wherever they rank)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof)
    busy = _busy_us(prof)
    print(f"[{tag}] profile of {len(calls)} steps: wall {wall_us / 1e3:.3f} ms "
          f"(profiled), device busy {busy / 1e3:.3f} ms = "
          f"{100 * busy / wall_us:.1f}% of wall")
    for dev_us, key, count in rows[:12]:
        print(f"[{tag}]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    for dev_us, key, count in rows[12:]:  # the port's own kernels, wherever they rank
        if re.search(r"flash|fused_adam|conv3x3", key):
            print(f"[{tag}]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]} "
                  f"(rank {rows.index((dev_us, key, count)) + 1})")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dp_config(plugin: str, ckpt_dir: str):
    import dataclasses

    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        TrainConfig,
        ZeroConfig,
    )

    extra = {"zero": ZeroConfig(stage=2, cpu_offload=True)} if plugin == "deepspeed" else {}
    cfg = TrainConfig.from_plugin(
        plugin, model="resnet18", num_epochs=1, log_interval=1, eval_every=0,
        data=DataConfig(dataset="synthetic_cifar", batch_size=100,
                        max_steps_per_epoch=DP_STEPS),
        checkpoint=CheckpointConfig(directory=ckpt_dir, interval=0), **extra)
    return cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, name="hybrid_adam"))


def _data_parallel_alone(trainer) -> bool:
    """Whether ``trainer`` runs over its ZeRO group alone: no model,
    expert, pipe, fsdp or sequence axis."""
    z = trainer.state.zero
    return ((z.tp, z.ep, z.pp, z.fsdp) == (None,) * 4
            and getattr(trainer.model, "seq_axis", None) is None)


def expected_dp_collectives(trainer) -> dict:
    """The ``{kind: {"count", "bytes"}}`` one train step of ``trainer``
    (the image ``Trainer`` or ``LMTrainer``, data parallel over its ZeRO
    group alone, one microbatch) must issue, from the port's code, with
    W the group's ranks and c = Σ ceil(n/W) over the parameters' sizes n:

    - the gradient exchange (``parallel/zero.py``): one all-reduce of the
      whole flat gradients at stages 0-1, one reduce-scatter returning the
      c-element shard at 2-3;
    - the parameters (``train/train_state.py``): one all-gather of W·c
      elements, after the update at stages 1-2, before the forward at 3;
    - from stage 1 on, the clip's global norm over the shards and, under
      the dynamic loss scale, the finite flag: one 4-byte all-reduce each;
    - SyncBN (``models/resnet.py``): each BatchNorm layer's [2, C] float32
      moments forward and [2, C] sums backward, one all-reduce each;
    - the metrics: one all-reduce of the float32 scalars (loss and
      accuracy; the LM step's CE, aux loss and accuracy when it is on)."""
    from distributed_training_tpu_torch import LMTrainer
    from distributed_training_tpu_torch.models.resnet import BatchNorm

    state, lm = trainer.state, isinstance(trainer, LMTrainer)
    zero = state.zero
    if not _data_parallel_alone(trainer) or trainer.grad_accum != 1 or state.tx.name == "lamb":
        raise NotImplementedError("the expectation covers data parallelism alone, one "
                                  "microbatch, without lamb's trust ratio")
    acct: dict = {}

    def add(kind: str, nbytes: int) -> None:
        entry = acct.setdefault(kind, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += nbytes

    if zero.group is None:
        return acct
    w, stage = zero.world, zero.stage
    size = next(iter(state.model.parameters())).element_size()
    numels = [math.prod(shape) for shape, _ in state.layouts.values()]
    chunks = sum(-(-n // w) for n in numels)
    if stage == 3:
        add("all-gather", w * chunks * size)
    for bn in state.model.modules():
        if isinstance(bn, BatchNorm) and bn.group is not None:
            add("all-reduce", 2 * bn.running_mean.numel() * 4)  # forward moments
            add("all-reduce", 2 * bn.running_mean.numel() * 4)  # backward sums
    if stage < 2:
        add("all-reduce", sum(numels) * size)
    else:
        add("reduce-scatter", chunks * size)
    if stage >= 1:
        if state.tx.clip is not None:
            add("all-reduce", 4)
        if state.loss_scale.dynamic:
            add("all-reduce", 4)
        if stage < 3:
            add("all-gather", w * chunks * size)
    metrics = 2 + trainer.cfg.lm.metrics_accuracy if lm else 2
    add("all-reduce", 4 * metrics)
    if trainer.cfg.observability.grad_norm and stage >= 1:
        add("all-reduce", 4)
    return acct


def _collectives_line(acct: dict) -> str:
    return "; ".join(f"{kind} {e['count']} calls {e['bytes']} bytes"
                     for kind, e in sorted(acct.items())) or "none"


def counted_step(trainer, batch: dict, tag: str) -> dict:
    """One more train step of ``trainer`` on ``batch`` under
    ``count_collectives()``: printed as a ``[collectives]`` line and held
    exactly, counts and bytes, to :func:`expected_dp_collectives`."""
    from distributed_training_tpu_torch.utils.collectives import step_collectives

    want = expected_dp_collectives(trainer)
    got = step_collectives(trainer.train_step, trainer.state, batch)
    print(f"[collectives] {tag}, zero stage {trainer.state.zero.stage}, world "
          f"{trainer.state.zero.world}: {_collectives_line(got)}", flush=True)
    if got != want:
        raise SystemExit(f"{tag}: one step's collectives {got}, expected {want}")
    return got


def dp_phase(ckpt_dir: str) -> dict:
    """The five plugin presets through ``Trainer(cfg).fit()`` on full-width
    ResNet-18: first each without a process group, then each under a
    world-1 NCCL group brought up by ``initialize_distributed`` (SyncBN,
    the ZeRO stage's collectives, K1 on the rank's shard). Checks per
    preset: finite losses that fall, one K1 launch a step, each step's loss
    against the no-group run's, pinned host moments under ``cpu_offload``;
    then images/s and peak memory in the steady state."""
    import torch.distributed as dist

    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.data.pipeline import to_device
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update
    from distributed_training_tpu_torch.runtime import distributed

    alone = {}
    for plugin in DP_PRESETS:
        trainer = Trainer(_dp_config(plugin, os.path.join(ckpt_dir, plugin)))
        trainer.fit()
        alone[plugin] = [h["loss"] for h in trainer.meter.history]
        del trainer
    port = _free_port()
    group = distributed.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    if group is None or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise SystemExit("the world-1 NCCL group did not come up")
    print(f"[dp] NCCL process group up at tcp://127.0.0.1:{port}, world "
          f"{dist.get_world_size()}, backend {dist.get_backend()}")
    results = {}
    try:
        for plugin in DP_PRESETS:
            cfg = _dp_config(plugin, os.path.join(ckpt_dir, plugin + "_nccl"))
            trainer = Trainer(cfg)
            zero = trainer.state.zero
            if zero.group is None or zero.stage != cfg.zero.stage:
                raise SystemExit(f"{plugin}: the trainer did not join the group "
                                 f"at stage {cfg.zero.stage}")
            times = _timed_train_epochs(trainer)
            fused_adam_update.launches = 0
            out = trainer.fit()
            launches = fused_adam_update.launches
            hist = trainer.meter.history
            losses = [h["loss"] for h in hist]
            diff = max(abs(a - b) / abs(b) for a, b in zip(losses, alone[plugin]))
            pinned = None
            if cfg.zero.cpu_offload:
                moments = [*trainer.state.opt_state.mu.values(),
                           *trainer.state.opt_state.nu.values()]
                pinned = all(m.device.type == "cpu" and m.is_pinned() for m in moments)
            print(f"[dp] {plugin}: zero stage {cfg.zero.stage}"
                  f"{' cpu_offload' if cfg.zero.cpu_offload else ''}, "
                  f"{cfg.precision.dtype}, per step (loss, loss_scale, committed) "
                  f"{[(h['loss'], h['loss_scale'], h['grads_finite']) for h in hist]}; "
                  f"without a group {alone[plugin]}; largest relative difference "
                  f"{diff:.3g} (tolerance {DP_LOSS_RTOL[cfg.precision.dtype]}); "
                  f"K1 launches {launches}; "
                  f"{DP_STEPS} steps in {times[0]:.3f} s (first step's cuDNN planning "
                  f"included)" + ("" if pinned is None else f"; moments pinned host {pinned}"))
            if not all(x == x and abs(x) != float("inf") for x in losses):
                raise SystemExit(f"{plugin}: non-finite loss {losses}")
            if not losses[-1] < losses[0]:
                raise SystemExit(f"{plugin}: loss did not fall: {losses}")
            if launches != DP_STEPS:
                raise SystemExit(f"{plugin}: K1 launches {launches} != {DP_STEPS} steps")
            _check(f"{plugin} loss with the NCCL group vs without", diff,
                   DP_LOSS_RTOL[cfg.precision.dtype])
            if pinned is False:
                raise SystemExit(f"{plugin}: cpu_offload moments are not pinned host tensors")
            loader, _ = trainer.make_loaders()
            batches = [to_device(b, trainer.device) for _, b in zip(range(10), loader)]
            counted = counted_step(trainer, batches[0], f"dp {plugin} (ResNet-18, batch 100)")
            steady_state(trainer, batches, 100, "images", tag=f"dp {plugin}", profiled=2)
            results[plugin] = {"launches": launches, "loss_rel_diff": diff,
                               "committed": out["steps"], "moments_pinned": pinned,
                               "collectives": counted}
            del trainer, batches
    finally:
        distributed.shutdown_distributed()
    torch.cuda.empty_cache()
    return results


def fp16_pad_phase() -> dict:
    """The float16 instantiations and the padded shapes: K2–K4 in fp16 at
    the flash bench's five shapes; K2–K4 at d 16, 48 and 96 in bf16 and
    fp16; K5 in fp16 at s0–s2 and at Cin/Cout 3→12 and 20→36 in every
    dtype; each against its plain version, each call counted. Then the
    fp16 times at each row's shape (K2–K4 at the GPT-2-small shape, K5 at
    s0–s2) beside bf16's."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.ops.conv3x3_stats import conv3x3_stats
    from distributed_training_tpu_torch.tools import conv_fusion_probe as probe

    gen = torch.Generator(device="cuda").manual_seed(4)
    counters = (fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    fp16 = _bench_shape_checks("fp16", gen, torch.float16)
    worst: dict = {}
    for dtype in (torch.bfloat16, torch.float16):
        for d in (16, 48, 96):
            for causal in (False, True):
                n = [f.launches for f in counters]
                q, k, v, g = (_randn(gen, 4, 384, d, dtype=dtype) for _ in range(4))
                rows, _ = _flash_case(f"pad {str(dtype)[6:]} d={d} causal={causal}",
                                      q, k, v, g, _randn(gen, 4, 384), causal=causal)
                if [f.launches - m for f, m in zip(counters, n)] != [1, 1, 1, 1]:
                    raise SystemExit(f"padded d {d}: a flash kernel did not launch once")
                for name, err in rows.items():
                    key = f"{str(dtype)[6:]} {name}"
                    worst[key] = max(worst.get(key, 0.0), err)
    print("[fp16] K2/K3/K4 at d 16, 48, 96 (padded to 32, 64, 128), bf16 and fp16, "
          "causal and not, T 384, worst errors by row: "
          + ", ".join(f"{n} {e:.3g}" for n, e in sorted(worst.items())))
    k5 = {}
    for key, (_, n, h, w, cin, cout) in probe.SHAPES.items():
        x, wts = probe.inputs(n, h, w, cin, cout, "cuda", seed=7, dtype=torch.float16)
        k5[key] = probe.check(x, wts)
        print(f"[fp16] K5 fp16 vs plain at {key} [{n},{h},{w},{cin}]->{cout}: "
              + " ".join(f"{e}={v:.3g}" for e, v in k5[key].items())
              + f" (limits out {probe.OUT_TOLS[torch.float16]}, sum {probe.SUM_TOL}, "
                f"sumsq {probe.SUMSQ_TOL})")
        k5[key]["ms"] = cuda_ms(lambda: conv3x3_stats(x, wts), 20)
        del x, wts
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for cin, cout in ((3, 12), (20, 36)):
            x, wts = probe.inputs(8, 14, 14, cin, cout, "cuda", seed=cin, dtype=dtype)
            before = conv3x3_stats.launches
            errs = probe.check(x, wts)
            if conv3x3_stats.launches != before + 1:
                raise SystemExit(f"K5 {dtype} {cin}->{cout}: the kernel did not launch once")
            print(f"[fp16] K5 {str(dtype)[6:]} Cin/Cout {cin}->{cout} (padded to "
                  f"multiples of {8 if dtype != torch.float32 else 4}) vs plain: "
                  + " ".join(f"{e}={v:.3g}" for e, v in errs.items()))
    bh, t, d = GPT_B * GPT_H, GPT_T, GPT_D
    q, k, v, g = (_randn(gen, bh, t, d, dtype=torch.float16) for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa._delta(g, out)
    ms = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, causal=True), 20),
          "flash_bwd": cuda_ms(lambda: fa.flash_bwd(q, k, v, out, lse, g, causal=True), 10),
          "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(
              q, k, v, g, lse, delta, causal=True), 10),
          "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(
              q, k, v, g, lse, delta, causal=True), 10)}
    print(f"[fp16] at BH {bh} T {t} d {d} fp16 causal, ms: "
          + ", ".join(f"{n} {v:.4f}" for n, v in ms.items())
          + "; K5 fp16 at the probe's shapes, ms: "
          + ", ".join(f"{key} {r['ms']:.4f}" for key, r in k5.items()))
    del q, k, v, g, out, lse, delta
    torch.cuda.empty_cache()
    errs = {"flash_fwd": fp16["K2 out"],
            "flash_bwd": max(fp16["K3 dq"], fp16["K3 dk"], fp16["K3 dv"]),
            "flash_bwd_dq": fp16["K4a dq"],
            "flash_bwd_dkv": max(fp16["K4b dk"], fp16["K4b dv"])}
    return {"ms": ms, "max_abs_err": errs, "k5": k5}


def lm_fp16_phase(ckpt_dir: str) -> dict:
    """GPT-2-small ``LMTrainer`` in fp16 with the flash kernels: 5 steps
    and an eval of 2 batches, the loss finite, K2 and K3 launched as in the
    bf16 phase (fp16 instantiations)."""
    import math

    from distributed_training_tpu_torch import LMTrainer
    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        LMConfig,
        OptimizerConfig,
        PrecisionConfig,
        TrainConfig,
    )
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    steps = 5
    cfg = TrainConfig(
        model="transformer_lm", num_epochs=1, log_interval=1,
        optimizer=OptimizerConfig(name="hybrid_adam", lr=1e-3),
        precision=PrecisionConfig(dtype="fp16"),
        lm=LMConfig(seq_len=GPT_T, vocab_size=50304, num_layers=GPT_LAYERS,
                    num_heads=GPT_H, hidden_dim=GPT_H * GPT_D, mlp_ratio=4,
                    max_len=GPT_T, attn_impl="flash", logits_dtype="bf16",
                    head_bias=False, train_sequences=GPT_B * steps,
                    eval_sequences=GPT_B * LM_EVAL_BATCHES),
        data=DataConfig(batch_size=GPT_B, max_steps_per_epoch=steps),
        checkpoint=CheckpointConfig(directory=ckpt_dir, interval=0))
    trainer = LMTrainer(cfg)
    times = _timed_train_epochs(trainer)
    for fn in (flash_fwd, flash_bwd, fused_adam_update):
        fn.launches = 0
    out = trainer.fit()
    launches = {"flash_fwd": flash_fwd.launches, "flash_bwd": flash_bwd.launches,
                "fused_adam": fused_adam_update.launches}
    hist = trainer.meter.history
    print(f"[lm fp16] fit -> {out}")
    print(f"[lm fp16] per step (loss, loss_scale, committed) "
          f"{[(h['loss'], h['loss_scale'], h['grads_finite']) for h in hist]}; "
          f"{steps} steps in {times[0]:.3f} s ({GPT_B * GPT_T * steps / times[0]:.1f} "
          f"tokens/s, first step included); launches {launches}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise SystemExit(f"non-finite fp16 LM loss: {[h['loss'] for h in hist]}")
    want = {"flash_fwd": GPT_LAYERS * (steps + LM_EVAL_BATCHES),
            "flash_bwd": GPT_LAYERS * steps, "fused_adam": steps}
    if launches != want:
        raise SystemExit(f"fp16 LM launches {launches} != {want}")
    del trainer
    torch.cuda.empty_cache()
    return launches


def fp16_phase(ckpt_dir: str) -> None:
    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        OptimizerConfig,
        TrainConfig,
    )
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    steps = 5
    cfg = TrainConfig.from_plugin(
        "torch_ddp_fp16", model="resnet18", num_epochs=1, log_interval=1,
        eval_every=0,
        optimizer=OptimizerConfig(name="hybrid_adam", scale_lr_by_world=True),
        data=DataConfig(dataset="synthetic_cifar", batch_size=100,
                        max_steps_per_epoch=steps),
        checkpoint=CheckpointConfig(directory=ckpt_dir))
    trainer = Trainer(cfg)
    fused_adam_update.launches = 0
    out = trainer.fit()
    hist = trainer.meter.history
    print(f"[fp16] fit -> {out}")
    print(f"[fp16] per step (loss, loss_scale, committed): "
          f"{[(h['loss'], h['loss_scale'], h['grads_finite']) for h in hist]}")
    if fused_adam_update.launches != steps:
        raise SystemExit(f"fp16 fused_adam launches {fused_adam_update.launches} "
                         f"!= {steps} steps (each builds a candidate)")
    committed = sum(h["grads_finite"] for h in hist)
    if out["steps"] != committed or committed == 0:
        raise SystemExit(f"committed steps {out['steps']} vs flags {committed}")
    if not all(h["loss"] == h["loss"] for h in hist):
        raise SystemExit("non-finite fp16 loss")


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-6)).item()


def _row_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of a row (the last axis) over the RMS of ``want``'s
    row, that RMS held at least a tenth of the whole tensor's."""
    want = want.float()
    err = (got.float() - want).abs().amax(-1)
    rms = want.square().mean(-1).sqrt()
    floor = 0.1 * want.square().mean().sqrt().clamp_min(1e-30)
    return (err / rms.clamp_min(floor)).max().item()


def _check(what: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise SystemExit(f"{what}: error {err:.3g} above the tolerance {tol}")


def _bound(nbytes: float, ops: dict) -> tuple[float, str]:
    """The least time in ms and what sets it: ``nbytes`` at 3.35 TB/s
    against each kind of operation at its own peak (``ops`` maps a rate to
    a count). Tensor cores, CUDA cores and memory run at once, so the
    bound is the largest of the times, not their sum."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = max(n / rate * 1e3 for rate, n in ops.items())
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _randn(gen, *shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def _flash_case(what: str, q, k, v, g, g_lse=None, *, causal: bool) -> tuple[dict, dict]:
    """K2, K3 and the split backward's K4a and K4b on one input against
    their plain versions, under the flash module's switches as they stand.
    Raises above the limits; returns each output's error by row (lse's
    over its largest magnitude) and each output's largest absolute error."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    fwd_tol, bwd_tol = FLASH_TOL[q.dtype]
    out, lse = fa.flash_fwd(q, k, v, causal=causal)
    want_out, want_lse = fa.flash_attention_reference(q, k, v, causal=causal)
    delta = fa._delta(g, out, g_lse)
    pairs = {"K2 out": (out, want_out)}
    pairs.update(zip(("K3 dq", "K3 dk", "K3 dv"), zip(
        fa.flash_bwd(q, k, v, out, lse, g, g_lse, causal=causal),
        fa.flash_attention_bwd_reference(q, k, v, out, lse, g, g_lse, causal=causal))))
    pairs["K4a dq"] = (fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal),
                       fa.flash_attention_dq_reference(q, k, v, g, lse, delta, causal=causal))
    pairs.update(zip(("K4b dk", "K4b dv"), zip(
        fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=causal),
        fa.flash_attention_dkv_reference(q, k, v, g, lse, delta, causal=causal))))
    rows = {n: _row_err(a, b) for n, (a, b) in pairs.items()}
    rows["K2 lse"] = _rel_err(lse, want_lse)
    for n, err in rows.items():
        _check(f"{what}: {n}", err,
               LSE_TOL if n == "K2 lse" else fwd_tol if n == "K2 out" else bwd_tol)
    return rows, {n: (a.float() - b.float()).abs().max().item() for n, (a, b) in pairs.items()}


def _flash_grid(what: str, gen, dtypes: tuple, causals: tuple) -> dict:
    """:func:`_flash_case` over ``dtypes`` x ``causals`` x head dims 32,
    64, 128 x T 128, 384, 1024, each with a non-zero lse cotangent: the
    worst error by row of each output, by dtype."""
    worst: dict = {}
    for dtype in dtypes:
        name = str(dtype)[6:]
        for causal in causals:
            for d in (32, 64, 128):
                for t in (128, 384, 1024):
                    bh = 8 if t < 1024 else 4
                    q, k, v, g = (_randn(gen, bh, t, d, dtype=dtype) for _ in range(4))
                    rows, _ = _flash_case(f"{what} {name} causal={causal} d={d} T={t}",
                                          q, k, v, g, _randn(gen, bh, t), causal=causal)
                    for n, err in rows.items():
                        worst[f"{name} {n}"] = max(worst.get(f"{name} {n}", 0.0), err)
    return worst


def _bench_shape_checks(what: str, gen, dtype=torch.bfloat16) -> dict:
    """:func:`_flash_case` at each of ``flash_kernel_bench``'s shapes,
    causal with no lse cotangent, as the bench runs them (in bf16, or
    ``dtype``). BH is cut where the plain versions' float32 [BH, T, T]
    scores would pass 2 GiB (only T 16384, to BH 2): the kernels' tiles and
    loops depend on T and d, not on BH. Returns the largest absolute
    errors at the ``gpt`` shape."""
    from distributed_training_tpu_torch.tools.flash_kernel_bench import SHAPES

    gpt = {}
    for key, (_, bh, t, d) in SHAPES.items():
        bh = min(bh, 2**29 // t**2)
        q, k, v, g = (_randn(gen, bh, t, d, dtype=dtype) for _ in range(4))
        rows, abs_errs = _flash_case(f"{what} {key}", q, k, v, g, causal=True)
        print(f"[{what}] K2/K3/K4 vs plain at the bench's {key} [{bh},{t},{d}] "
              f"{str(dtype)[6:]} causal, by row: "
              + ", ".join(f"{n} {e:.3g}" for n, e in rows.items()))
        if key == "gpt":
            gpt = abs_errs
        del q, k, v, g
    torch.cuda.empty_cache()
    return gpt


def flash_kernel_phase() -> dict:
    """K2, K3 and the split backward's K4a (dq) and K4b (dk, dv) against
    their plain versions over a grid of shapes and at the flash bench's
    shapes, K4a's dq bit for bit across two launches, then all four timed
    at the GPT-2-small shape."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = _flash_grid("flash", gen, (torch.float32, torch.bfloat16), (False, True))
    print("[flash] K2/K3/K4 vs plain, 36 cases (dtype x causal x d 32,64,128 x T "
          "128,384,1024, non-zero g_lse), worst errors by row (lse: of its "
          "largest magnitude): "
          + ", ".join(f"{n} {e:.3g}" for n, e in sorted(worst.items())))

    # flash_attention_lse through autograd: card (K2/K3) vs CPU (plain).
    q, k, v = (_randn(gen, 2, 3, 384, 64, dtype=torch.bfloat16) for _ in range(3))
    w_out, w_lse = _randn(gen, 2, 3, 384, 64), _randn(gen, 2, 3, 384)

    def lse_grads(device):
        xs = [x.detach().to(device).requires_grad_() for x in (q, k, v)]
        out, lse = fa.flash_attention_lse(*xs, causal=True, block_q=128, block_k=128)
        ((out.float() * w_out.to(device)).sum()
         + (lse * w_lse.to(device)).sum()).backward()
        return [x.grad.cpu() for x in xs]

    for n, a, b in zip("qkv", lse_grads("cuda"), lse_grads("cpu")):
        err = _row_err(a, b)
        print(f"[flash] flash_attention_lse d{n} card vs CPU (bf16, causal, "
              f"T 384): {err:.3g} by row (tolerance {LSE_GRAD_TOL})")
        _check(f"flash_attention_lse d{n}", err, LSE_GRAD_TOL)

    gpt = _bench_shape_checks("flash", gen)
    errs = {"flash_fwd": gpt["K2 out"],
            "flash_bwd": max(gpt["K3 dq"], gpt["K3 dk"], gpt["K3 dv"]),
            "flash_bwd_dq": gpt["K4a dq"],
            "flash_bwd_dkv": max(gpt["K4b dk"], gpt["K4b dv"])}

    # The GPT-2-small shape.
    bh, t, d = GPT_B * GPT_H, GPT_T, GPT_D
    q, k, v, g = (_randn(gen, bh, t, d, dtype=torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa._delta(g, out)
    dq = fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True)
    if not torch.equal(dq, fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True)):
        raise SystemExit("K4a dq differs between two launches on the same inputs")
    print(f"[flash] K4a dq equal bit for bit across two launches at BH {bh} T {t} "
          f"d {d} bf16 causal")
    result = _time_flash("flash", q, k, v, g, GPT_B, errs)
    pair_ms = cuda_ms(lambda: fa.flash_bwd_split(q, k, v, out, lse, g, causal=True), 10)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        result[name].update(library_call="SDPA backward (dq, dk, dv)", pair_ms=pair_ms,
                            pair_bound_ms=result["flash_bwd"]["bound_ms"])
    print(f"[flash] K3 time includes its wrapper's delta, dq zeroing and cast; the "
          f"K4 pair through flash_bwd_split (with delta) {pair_ms:.4f} ms, "
          f"{pair_ms / result['flash_bwd']['ms']:.3f}x K3")
    del q, k, v, g, out, lse, delta, dq
    torch.cuda.empty_cache()
    result["flash_bwd_dq"]["bench_shapes"] = _split_vs_fused(gen)
    return result


# The ring phase's configurations: (name, B, H, T, virtual ranks P). The
# GPT-2-small attention shape at P 2 and 4, and the flash bench's long
# shape (BH 24, T 16384) at P 4, T_local 4096.
RING_CONFIGS = (("gpt2_small_p2", GPT_B, GPT_H, GPT_T, 2),
                ("gpt2_small_p4", GPT_B, GPT_H, GPT_T, 4),
                ("long_t16384_p4", 2, GPT_H, 16384, 4))


# The ring against the plain version on every head, the plain backward
# fed the unsharded K2 call's out and lse as _flash_case feeds it the
# kernel's: the plain version's own out (float32 scores, rounded once)
# differs from the kernels' (p rounded to bf16 in their tiles), and a
# backward whose delta = rowsum(dO · out) comes from another out reads up
# to 0.276 by row in dq where dP − delta cancels (on an H100 80GB HBM3 at
# 700 W). The plain version runs RING_PLAIN_ROWS query rows' worth of
# heads at a time (one head at T 16384) to bound its [T, T] scores.
RING_PLAIN_ROWS = 16384


def _out_and_grads(fn, q, k, v, g) -> list:
    """``[out, dq, dk, dv]`` of ``fn(q, k, v)`` with the output cotangent
    ``g``, through autograd, each as ``[BH, T, d]``."""
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fn(*xs)
    out.backward(g)
    return [t.reshape(-1, *t.shape[-2:]) for t in (out.detach(), *(x.grad for x in xs))]


def _ring_plain(q, k, v, g) -> list:
    """The plain version's ``[out, dq, dk, dv]`` on every head, ``[BH, T,
    d]``: out from its own forward, the gradients from its backward fed the
    unsharded K2 call's out and lse (see RING_PLAIN_ROWS), heads in groups
    of RING_PLAIN_ROWS query rows."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    t = q.shape[-2]
    flat = [x.reshape(-1, t, GPT_D) for x in (q, k, v, g)]
    out, lse = fa.flash_fwd(*flat[:3], causal=True)
    step = max(1, RING_PLAIN_ROWS // t)
    parts = []
    for i in range(0, flat[0].shape[0], step):
        qf, kf, vf, gf = (x[i:i + step] for x in flat)
        p_out, _ = fa.flash_attention_reference(qf, kf, vf, causal=True)
        grads = fa.flash_attention_bwd_reference(qf, kf, vf, out[i:i + step],
                                                 lse[i:i + step], gf, causal=True)
        parts.append([p_out, *grads])
        del p_out, grads
    return [torch.cat(x) for x in zip(*parts)]


def _ring_hop_times(q, k, v, g, p: int, gen) -> list:
    """Each virtual rank's hops of the causal ring, timed one by one: K2 on
    the rank's q chunk and the block (causal on the diagonal), K3 with a
    cotangent and a nonzero lse cotangent. Returns per rank ``(K2 ms, K3
    ms, hops)`` summed over its hops."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.parallel.ring_attention import hop_kind

    flat = [x.reshape(-1, *x.shape[-2:]) for x in (q, k, v, g)]
    qs, ks, vs, gs = ([c.contiguous() for c in x.chunk(p, dim=-2)] for x in flat)
    ranks = []
    for r in range(p):
        fwd = bwd = 0.0
        hops = 0
        for i in range(p):
            src = (r + i) % p
            kind = hop_kind(r, src, True)
            if kind == "future":
                continue
            causal, hops = kind == "diag", hops + 1
            qr, kb, vb = qs[r], ks[src], vs[src]
            out, lse = fa.flash_fwd(qr, kb, vb, causal=causal)
            g_lse = _randn(gen, *lse.shape)
            fwd += cuda_ms(lambda: fa.flash_fwd(qr, kb, vb, causal=causal), 10)
            bwd += cuda_ms(lambda: fa.flash_bwd(qr, kb, vb, out, lse, gs[r], g_lse,
                                                causal=causal), 10)
        ranks.append((fwd, bwd, hops))
    return ranks


def ring_phase() -> dict:
    """Ring attention over P virtual ranks on the card, through the hop
    and merge the ranks run, against one unsharded K2/K3 call and the
    plain version; K2 and K3 counted and timed per hop."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.parallel.ring_attention import (
        ring_attention_virtual,
    )

    if fa._USE_SPLIT_BWD or fa._USE_EXP2:
        raise SystemExit("the ring phase runs K2/K3 as the model path does: "
                         "the flash switches must be off")
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_tol, bwd_tol = FLASH_TOL[torch.bfloat16]
    result = {}
    for name, b, h, t, p in RING_CONFIGS:
        q, k, v, g = (_randn(gen, b, h, t, GPT_D, dtype=torch.bfloat16) for _ in range(4))

        def ring(*x, p=p):
            return ring_attention_virtual(*x, p, causal=True, impl="flash")

        def unsharded(*x):
            return fa.flash_attention(*x, causal=True)

        fa.flash_fwd.launches = fa.flash_bwd.launches = 0
        got = _out_and_grads(ring, q, k, v, g)
        torch.cuda.synchronize()
        launches = {"flash_fwd": fa.flash_fwd.launches, "flash_bwd": fa.flash_bwd.launches}
        hops = p * (p + 1) // 2  # rank r runs its diagonal and r past blocks
        if launches != {"flash_fwd": hops, "flash_bwd": hops}:
            raise SystemExit(f"ring {name}: K2/K3 launches {launches}, want {hops} each "
                             f"(one a hop that runs)")
        want = _out_and_grads(unsharded, q, k, v, g)
        plain = _ring_plain(q, k, v, g)
        errs = {}
        for i, key in enumerate(("out", "dq", "dk", "dv")):
            tol = fwd_tol if key == "out" else bwd_tol
            for ref_name, ref, mine in (("K2/K3", want[i], got[i]),
                                        ("plain", plain[i], got[i]),
                                        ("K2/K3~plain", plain[i], want[i])):
                errs[f"{key} vs {ref_name}"] = err = _row_err(mine, ref)
                _check(f"ring {name}: {key} vs {ref_name}", err, tol)
        max_abs = max((a.float() - b_.float()).abs().max().item()
                      for a, b_ in zip(got, want))
        del want, plain
        ranks = _ring_hop_times(q, k, v, g, p, gen)
        flat = [x.reshape(-1, t, GPT_D) for x in (q, k, v, g)]
        out, lse = fa.flash_fwd(*flat[:3], causal=True)
        full_fwd = cuda_ms(lambda: fa.flash_fwd(*flat[:3], causal=True), 10)
        full_bwd = cuda_ms(lambda: fa.flash_bwd(*flat[:3], out, lse, flat[3],
                                                causal=True), 10)
        ring_ms = cuda_ms(lambda: _out_and_grads(ring, q, k, v, g), 5)
        whole_ms = cuda_ms(lambda: _out_and_grads(unsharded, q, k, v, g), 5)
        print(f"[ring] {name}: B {b} H {h} T {t} d {GPT_D} bf16 causal over {p} virtual "
              f"ranks (T_local {t // p}); K2 {launches['flash_fwd']} and K3 "
              f"{launches['flash_bwd']} launches ({hops} hops run: the diagonal, causal, "
              f"and each past block; no kernel on future blocks); by row: "
              + ", ".join(f"{e} {v_:.3g}" for e, v_ in errs.items())
              + f" (tolerances {fwd_tol}, {bwd_tol}; plain on all {b * h} heads, its "
              f"backward from the unsharded K2 call's out and lse); "
              f"max_abs_err vs K2/K3 {max_abs:.3g}; {card}")
        for r, (fwd, bwd, nh) in enumerate(ranks):
            print(f"[ring] {name} rank {r}: {nh} hop(s), K2 {fwd:.4f} ms, K3 {bwd:.4f} ms; "
                  f"the unsharded call over {p}: K2 {full_fwd / p:.4f} ms, K3 "
                  f"{full_bwd / p:.4f} ms")
        print(f"[ring] {name}: the whole virtual ring forward + backward (every rank's "
              f"hops, merges and casts, one after another) {ring_ms:.4f} ms; one "
              f"unsharded flash_attention forward + backward {whole_ms:.4f} ms")
        result[name] = {"virtual_ranks": p, "t_local": t // p, "hops": hops,
                        "launches": launches, "errors_by_row": errs,
                        "max_abs_err": max_abs,
                        "rank_hop_ms": [{"K2": f, "K3": bw, "hops": nh}
                                        for f, bw, nh in ranks],
                        "unsharded_over_p_ms": {"K2": full_fwd / p, "K3": full_bwd / p},
                        "ring_fwd_bwd_ms": ring_ms, "unsharded_fwd_bwd_ms": whole_ms}
        del q, k, v, g, got, flat, out, lse
        torch.cuda.empty_cache()
    return result


def _time_flash(tag: str, q, k, v, g, batch: int, errs: dict) -> dict:
    """K2, K3, K4a and K4b timed on ``[BH, T, d]`` inputs (causal), beside
    their plain versions, ``F.scaled_dot_product_attention`` forward and
    backward on the same tensors as ``[batch, heads, T, d]`` (a yardstick
    only; the port never calls it) and the least time the card could take;
    printed, and returned by kernel with ``errs`` (its max_abs_err)."""
    import torch.nn.functional as F

    from distributed_training_tpu_torch.ops import flash_attention as fa

    bh, t, d = q.shape
    dtype = str(q.dtype)[6:]
    out, lse = fa.flash_fwd(q, k, v, causal=True)
    delta = fa._delta(g, out)
    ms = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, causal=True), 20),
          "flash_bwd": cuda_ms(lambda: fa.flash_bwd(q, k, v, out, lse, g, causal=True), 10),
          "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(
              q, k, v, g, lse, delta, causal=True), 10),
          "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(
              q, k, v, g, lse, delta, causal=True), 10)}
    plain = {"flash_fwd": cuda_ms(lambda: fa.flash_attention_reference(
                 q, k, v, causal=True), 5),
             "flash_bwd": cuda_ms(lambda: fa.flash_attention_bwd_reference(
                 q, k, v, out, lse, g, causal=True), 3),
             "flash_bwd_dq": cuda_ms(lambda: fa.flash_attention_dq_reference(
                 q, k, v, g, lse, delta, causal=True), 3),
             "flash_bwd_dkv": cuda_ms(lambda: fa.flash_attention_dkv_reference(
                 q, k, v, g, lse, delta, causal=True), 3)}
    q4, k4, v4, g4 = (x.view(batch, bh // batch, t, d) for x in (q, k, v, g))
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20)
    xs = [x.detach().requires_grad_() for x in (q4, k4, v4)]
    o4 = F.scaled_dot_product_attention(*xs, is_causal=True)
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(o4, xs, g4, retain_graph=True), 10)

    # Least times: every input read once and every output written once at
    # 3.35 TB/s, against the unmasked (q, k) pairs' products at the bf16
    # peak, 2·d operations a product: 2 a pair forward (s, p·v), 5 in the
    # fused backward (s, dp, dS·K, pᵀ·dO, dSᵀ·Q), of which K4a does s, dp
    # and dS·K, and K4b s, dp, pᵀ·dO and dSᵀ·Q.
    pairs = bh * t * (t + 1) // 2
    x, rows = bh * t * d * q.element_size(), bh * t * 4
    work = {"flash_fwd": (4 * x + rows, 4 * d),             # q k v out, lse
            "flash_bwd": (7 * x + 2 * rows, 10 * d),        # q k v dO dq dk dv, lse δ
            "flash_bwd_dq": (5 * x + 2 * rows, 6 * d),      # q k v dO dq, lse δ
            "flash_bwd_dkv": (6 * x + 2 * rows, 8 * d)}     # q k v dO dk dv, lse δ
    result = {}
    for name, (nbytes, per_pair) in work.items():
        ops = per_pair * pairs
        bound, by = _bound(nbytes, {BF16_FLOPS: ops})
        lib = sdpa_fwd if name == "flash_fwd" else sdpa_bwd
        result[name] = {"max_abs_err": errs[name], "ms": ms[name], "plain_ms": plain[name],
                        "library_ms": lib, "bound_ms": bound, "bound_by": by}
        before = _before(name, ms[name]) if d == GPT_D else ""
        print(f"[{tag}] {name} at BH {bh} T {t} d {d} {dtype} causal: ms={ms[name]:.4f} "
              f"plain_ms={plain[name]:.4f} library_ms={lib:.4f} (SDPA) bound_ms="
              f"{bound:.4f} ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP; {by}); "
              f"{ops / ms[name] / 1e9:.2f} TFLOP/s, {100 * bound / ms[name]:.1f}% of "
              f"the bound, {ms[name] / lib:.2f}x SDPA{before}; "
              f"max_abs_err={errs[name]:.3g}")
    del out, lse, delta, q4, k4, v4, g4, xs, o4
    return result


def _split_vs_fused(gen) -> dict:
    """At each ``flash_kernel_bench`` shape (bf16 causal): the backward
    through K3's wrapper against the split pair through
    ``flash_bwd_split``, and K4a and K4b alone, in ms; and K4a without the
    causal mask, which does twice the work with no q tile lighter than
    another: causal K4a at about half of it shows that the causal
    imbalance (q tiles see 1 to T / 64 k tiles) costs little."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.tools.flash_kernel_bench import SHAPES

    times = {}
    for key, (_, bh, t, d) in SHAPES.items():
        q, k, v, g = (_randn(gen, bh, t, d, dtype=torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, causal=True)
        delta = fa._delta(g, out)
        times[key] = {
            "K3": cuda_ms(lambda: fa.flash_bwd(q, k, v, out, lse, g, causal=True), 5),
            "pair": cuda_ms(lambda: fa.flash_bwd_split(q, k, v, out, lse, g, causal=True), 5),
            "K4a": cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=True), 5),
            "K4b": cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, g, lse, delta, causal=True), 5)}
        out, lse = fa.flash_fwd(q, k, v, causal=False)
        delta = fa._delta(g, out)
        times[key]["K4a_not_causal"] = cuda_ms(
            lambda: fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=False), 5)
        r = times[key]
        print(f"[flash] backward at the bench's {key} [{bh},{t},{d}] bf16 causal, ms: "
              f"K3 (wrapper) {r['K3']:.4f}, split pair (flash_bwd_split) {r['pair']:.4f} "
              f"= {r['pair'] / r['K3']:.3f}x K3; K4a {r['K4a']:.4f}, K4b {r['K4b']:.4f}; "
              f"K4a not causal {r['K4a_not_causal']:.4f} (causal "
              f"{r['K4a'] / r['K4a_not_causal']:.3f}x)")
        del q, k, v, g, out, lse, delta
    torch.cuda.empty_cache()
    return times


def lm_phase(ckpt_dir: str) -> dict:
    """GPT-2-small LM training through ``LMTrainer.fit()`` with the flash
    kernels, and what it shows."""
    import math

    from distributed_training_tpu_torch import LMTrainer
    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        LMConfig,
        OptimizerConfig,
        PrecisionConfig,
        TrainConfig,
    )
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update
    from distributed_training_tpu_torch.parallel.ring_attention import RingSelfAttention

    cfg = TrainConfig(
        model="transformer_lm", num_epochs=1, log_interval=1,
        optimizer=OptimizerConfig(name="hybrid_adam", lr=1e-3),
        precision=PrecisionConfig(dtype="bf16"),
        lm=LMConfig(seq_len=GPT_T, vocab_size=50304, num_layers=GPT_LAYERS,
                    num_heads=GPT_H, hidden_dim=GPT_H * GPT_D, mlp_ratio=4,
                    max_len=GPT_T, attn_impl="flash", logits_dtype="bf16",
                    head_bias=False, train_sequences=GPT_B * LM_STEPS,
                    eval_sequences=GPT_B * LM_EVAL_BATCHES),
        data=DataConfig(batch_size=GPT_B, max_steps_per_epoch=LM_STEPS),
        checkpoint=CheckpointConfig(directory=ckpt_dir, interval=0))
    trainer = LMTrainer(cfg)
    n_tensors = len(list(trainer.model.parameters()))
    _, eval_loader = trainer.make_loaders()
    # Each train batch is 16 runs of consecutive token ids, so the train
    # loss moves from batch to batch by about as much as 10 steps lower
    # it; the fall is judged on the same held-out batches before and after.
    ce_before = math.log(trainer.evaluate(eval_loader))
    times = _timed_train_epochs(trainer)
    for fn in (flash_fwd, flash_bwd, fused_adam_update):
        fn.launches = 0
    out = trainer.fit()
    launches = {"flash_fwd": flash_fwd.launches, "flash_bwd": flash_bwd.launches,
                "fused_adam": fused_adam_update.launches}
    losses = [h["loss"] for h in trainer.meter.history]
    tokens = GPT_B * GPT_T * LM_STEPS
    ce_after = math.log(out["final_perplexity"])
    print(f"[lm] fit -> {out}")
    print(f"[lm] train loss per step {losses}; eval CE {ce_before:.6f} before "
          f"training, {ce_after:.6f} after; {LM_STEPS} steps in {times[0]:.3f} s "
          f"({tokens / times[0]:.1f} tokens/s, first step included); "
          f"{n_tensors} parameter tensors; launches {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite LM loss: {losses}")
    if not ce_after < ce_before:
        raise SystemExit(f"LM eval loss did not fall: {ce_before} -> {ce_after}")
    if out["steps"] != LM_STEPS:
        raise SystemExit(f"expected {LM_STEPS} committed LM steps, got {out['steps']}")
    want = {"flash_fwd": GPT_LAYERS * (LM_STEPS + LM_EVAL_BATCHES),
            "flash_bwd": GPT_LAYERS * LM_STEPS, "fused_adam": LM_STEPS}
    if launches != want:
        raise SystemExit(f"LM launches {launches} != {want}")

    # The trained weights with the flash and the exact attention: eval CE,
    # one eval batch's logits, and each layer's attention output on the
    # input that layer saw in the flash run.
    batch = trainer.place(next(iter(eval_loader)))
    model = trainer.model.eval()
    attns = [m for m in model.modules() if isinstance(m, RingSelfAttention)]
    ce, logits, seen = {}, {}, []
    for impl in ("flash", "exact"):
        for m in attns:  # the same parameters serve both
            m.attn_impl = impl
        n = flash_fwd.launches
        ce[impl] = math.log(trainer.evaluate(eval_loader))
        hooks = [m.register_forward_hook(lambda m, args, out: seen.append((args[0], out)))
                 for m in attns if impl == "flash"]
        with torch.no_grad():
            logits[impl] = model(batch["tokens"])
        for h in hooks:
            h.remove()
        used = flash_fwd.launches - n
        if used != (GPT_LAYERS * (LM_EVAL_BATCHES + 1) if impl == "flash" else 0):
            raise SystemExit(f"{impl} eval launched the flash kernel {used} times")
    with torch.no_grad():  # every layer runs the exact attention here
        attn_errs = [_row_err(out, m(x)) for m, (x, out) in zip(attns, seen)]
    for m in attns:
        m.attn_impl = "flash"
    logit_err = _row_err(logits["flash"], logits["exact"])
    ce_diff = abs(ce["flash"] - ce["exact"])
    del logits, seen
    print(f"[lm] trained weights, flash vs exact attention, by row: each "
          f"layer's attention output on the same input "
          f"{[round(e, 6) for e in attn_errs]} (tolerance {LM_ATTN_TOL}); one "
          f"eval batch's logits {logit_err:.3g} (tolerance {LM_LOGITS_TOL}); "
          f"eval CE {ce['flash']:.9f} vs {ce['exact']:.9f}, difference "
          f"{ce_diff:.3g} nats (tolerance {LM_EVAL_ATOL})")
    if len(attn_errs) != GPT_LAYERS:
        raise SystemExit(f"saw {len(attn_errs)} attention layers, not {GPT_LAYERS}")
    _check("LM attention output flash vs exact", max(attn_errs), LM_ATTN_TOL)
    _check("LM logits flash vs exact", logit_err, LM_LOGITS_TOL)
    _check("LM eval CE flash vs exact", ce_diff, LM_EVAL_ATOL)

    # K1 at this model's 149 tensors: device time (launches queued ahead)
    # and the wrapper's host time back to back, on copies of the state.
    ps = [p.detach().clone() for p in trainer.model.parameters()]
    gs = [torch.randn_like(p) for p in ps]
    mus = [torch.zeros_like(p) for p in ps]
    nus = [torch.zeros_like(p) for p in ps]
    adam = lambda: fused_adam_update(ps, gs, mus, nus, lr=1e-3, step=1)  # noqa: E731
    n = sum(p.numel() for p in ps)
    print(f"[lm] fused_adam on {len(ps)} GPT-2-small tensors ({n:,} params): "
          f"{cuda_ms(adam, 20):.4f} ms on the card (bound "
          f"{ADAM_BYTES * n / HBM_BYTES_PER_S * 1e3:.4f} ms), "
          f"{cuda_ms(adam, 20, ahead=False):.4f} ms a call back to back (host-bound)")
    del ps, gs, mus, nus

    loader, _ = trainer.make_loaders()
    batches = [trainer.place(b) for _, b in zip(range(5), loader)]
    steady_state(trainer, batches, GPT_B * GPT_T, "tokens", tag="lm", profiled=2)
    return launches


# The pipeline phase (one card): GPT-2-small (GPT_LAYERS 12, B 16, T 1024,
# flash) through the virtual pipeline (parallel/pipeline.py: every stage's
# ticks in turn in one process, the hops list rotations) against the plain
# TransformerLM on the same weights and batch. float32: the loss within
# PIPE_LOSS_RTOL relative, every gradient within PIPE_GRAD_TOL of its
# tensor's largest magnitude (the same products on B/M rows at a time, the
# gradients summed over microbatches in another order, K3's dQ atomics in
# an order that changes between runs). bf16, one hybrid_adam step through
# the pipeline step against the plain step: the loss within
# GPT_STAGE_RTOL. K2 runs once a layer a live microbatch (twice under
# remat), K3 once: 12·M (24·M) and 12·M a step.
PIPE_RUNS = (("gpipe_s4_m4", 4, 1, 4, False), ("circular_s4_v3_m4", 4, 3, 4, False),
             ("gpipe_s4_m4_remat", 4, 1, 4, True))
PIPE_LOSS_RTOL = 1e-5
PIPE_GRAD_TOL = 1e-4
PIPE_TIMED_STEPS = 3


def pipeline_phase() -> dict:
    """The virtual pipeline at GPT-2-small width against the plain model
    (see PIPE_RUNS): float32 loss and gradients, bf16 step losses, K2/K3
    launches a step, bubble fractions and ms a step (the plain model's
    beside them)."""
    import copy

    from distributed_training_tpu_torch.config import OptimizerConfig, PrecisionConfig
    from distributed_training_tpu_torch.models import get_model
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update
    from distributed_training_tpu_torch.parallel.pipeline import PipelinedLM
    from distributed_training_tpu_torch.train.lm_step import (
        _fused_ce_rows,
        make_lm_batch,
        make_lm_train_step,
        make_pp_lm_train_step,
    )
    from distributed_training_tpu_torch.train.optim import make_optimizer
    from distributed_training_tpu_torch.train.precision import LossScaleState
    from distributed_training_tpu_torch.train.train_state import TrainState

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, 50304, (GPT_B, GPT_T + 1), generator=gen)
    batch = {k: v.to(dev) for k, v in make_lm_batch(tokens).items()}

    def build(dtype):
        return get_model("transformer_lm", num_classes=50304, num_layers=GPT_LAYERS,
                         num_heads=GPT_H, hidden_dim=GPT_H * GPT_D, max_len=GPT_T,
                         attn_impl="flash", dtype=dtype, logits_dtype=dtype,
                         generator=torch.Generator().manual_seed(0))

    def pipelined(base, s, v, m, remat):
        model = copy.deepcopy(base)
        model.remat = remat
        return PipelinedLM(model, num_microbatches=m, virtual_stages=v, pipe_size=s).to(dev)

    def loss_and_grads(model):
        model.train()
        loss = _fused_ce_rows(model(batch["tokens"]), batch["targets"]).mean()
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        return loss.item(), grads

    base32 = build(torch.float32)
    plain = copy.deepcopy(base32).to(dev)
    want, want_g = loss_and_grads(plain)
    del plain
    runs = {}
    for name, s, v, m, remat in PIPE_RUNS:
        model = pipelined(base32, s, v, m, remat)
        flash_fwd.launches = flash_bwd.launches = 0
        got, got_g = loss_and_grads(model)
        launches = {"flash_fwd": flash_fwd.launches, "flash_bwd": flash_bwd.launches}
        loss_err = abs(got - want) / abs(want)
        grad_err = max((got_g[n] - g).abs().max().item() / g.abs().max().item()
                       for n, g in want_g.items())
        runs[name] = {"stages": s, "virtual_stages": v, "microbatches": m, "remat": remat,
                      "bubble_fraction": model.bubble_fraction, "launches": launches,
                      "fp32_loss": got, "fp32_loss_rel_err": loss_err,
                      "fp32_grad_err": grad_err}
        del model, got_g
        torch.cuda.empty_cache()
        _check(f"pipeline {name} fp32 loss", loss_err, PIPE_LOSS_RTOL)
        _check(f"pipeline {name} fp32 gradients", grad_err, PIPE_GRAD_TOL)
        per_step = {"flash_fwd": GPT_LAYERS * m * (2 if remat else 1),
                    "flash_bwd": GPT_LAYERS * m}
        if launches != per_step:
            raise SystemExit(f"pipeline {name}: launches {launches} != {per_step}")
    del want_g, base32

    # bf16: one hybrid_adam step each, the plain step first (the reference),
    # then PIPE_TIMED_STEPS timed steps on the card (CUDA events).
    base16 = build(torch.bfloat16)
    opt = OptimizerConfig(name="hybrid_adam", lr=1e-3)

    def bf16_run(model, step):
        state = TrainState.create(model, make_optimizer(opt),
                                  LossScaleState.create(PrecisionConfig(dtype="bf16")))
        fused_adam_update.launches = 0
        first = float(step(state, batch)["loss"])
        ms = cuda_ms(lambda: step(state, batch), PIPE_TIMED_STEPS, ahead=False)
        return first, ms, fused_adam_update.launches

    plain_loss, plain_ms, _ = bf16_run(copy.deepcopy(base16).to(dev),
                                       make_lm_train_step(max_len=GPT_T,
                                                          logits_dtype=torch.bfloat16))
    torch.cuda.empty_cache()
    card = card_line()
    for name, s, v, m, remat in PIPE_RUNS:
        torch.cuda.reset_peak_memory_stats()
        loss, ms, k1 = bf16_run(pipelined(base16, s, v, m, remat),
                                make_pp_lm_train_step(max_len=GPT_T,
                                                      logits_dtype=torch.bfloat16))
        r = runs[name]
        r.update(bf16_loss=loss, bf16_loss_rel_err=abs(loss - plain_loss) / abs(plain_loss),
                 ms=ms, plain_ms=plain_ms, fused_adam=k1,
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.empty_cache()
        _check(f"pipeline {name} bf16 loss", r["bf16_loss_rel_err"], GPT_STAGE_RTOL)
        if k1 != 3 + 1 + PIPE_TIMED_STEPS:  # the first step, warm-up and timed ones
            raise SystemExit(f"pipeline {name}: K1 launches {k1}")
        print(f"[pipeline] {name} (GPT-2-small, B {GPT_B} T {GPT_T}, virtual S {s} v {v} "
              f"M {m}{' remat' if remat else ''}): bubble fraction "
              f"{r['bubble_fraction']:.4f}; float32 loss {r['fp32_loss']:.7f} vs plain "
              f"{want:.7f} ({r['fp32_loss_rel_err']:.3g} relative, tolerance "
              f"{PIPE_LOSS_RTOL}), gradients "
              f"{r['fp32_grad_err']:.3g} of each tensor's largest (tolerance {PIPE_GRAD_TOL}); "
              f"K2/K3 a step {r['launches']}; bf16 hybrid_adam step {ms:.3f} ms against the "
              f"plain model's {plain_ms:.3f} ms, first loss {loss:.6f} vs {plain_loss:.6f} "
              f"({r['bf16_loss_rel_err']:.3g} relative, tolerance {GPT_STAGE_RTOL}); peak "
              f"{r['peak_gib']:.3f} GiB; {card}", flush=True)
    return {"runs": runs, "plain_fp32_loss": want, "plain_bf16_loss": plain_loss,
            "plain_ms": plain_ms}


# The flight phase: the flight instruments (observability/), on by default
# in both trainers, on full-width ResNet-18 (Trainer.fit, batch 100, bf16)
# and GPT-2-small (LMTrainer.fit, B 16 T 1024, bf16, flash, hybrid_adam).
# - A/B in one process, recorder off, on, on, off, twice over (FLIGHT_AB),
#   and that FLIGHT_AB_REPEATS times over (FLIGHT_STEPS steps at log
#   interval FLIGHT_LOG each): each iteration of
#   the train loop timed from one step's entry to the next's, the card
#   synchronised at each entry, so an interval holds the step's device work
#   and all the loop's host work (the recorder's included, its flushes
#   too). A run's step time is the mean of its intervals after the first
#   two. The check fails if the "on" runs' mean step time exceeds the "off"
#   runs' by more than the spread of the "off" runs' step times (largest
#   less smallest of the four in each FLIGHT_AB, averaged over its repeats).
#   Two blocks, not one: with one, a recorder that costs nothing fails about
#   one run in five under independent run-to-run noise; with two, about one
#   in forty (independent normal noise). ResNet-18's loop is host-bound and
#   its intervals vary widely within a run, so it repeats FLIGHT_AB: the
#   threshold's expectation stays that of four "off" runs while the
#   difference of the means is taken over twice the runs, and a free
#   recorder fails about one run in 370.
#   Each timed run starts from a full collection (gc.collect() after the
#   trainer is built), so that no collection an earlier run left owing
#   lands in its intervals; the collector's pauses inside each run's
#   counted intervals are reported.
# - Self time: one more run with the recorder on, every call into the
#   instruments (TrainObservability's on_step, on_flush, on_epoch) and into
#   the wall clock's phases timed on the host, each kind of call taken at
#   its median (a wait for the interpreter lock, which the loader's thread
#   may hold, is not the call's work; the card's clock for CPU time ticks
#   too coarsely to count it); their sum a step, from the third step on,
#   must stay
#   under FLIGHT_SELF_SHARE of the "off" runs' step time. This resolves a
#   cost far below the A/B's noise, and names where it goes.
# - Sync count: one run off and one on under
#   torch.cuda.set_sync_debug_mode("warn"), every synchronising call
#   counted; the counts must be equal (the recorder adds no host read of
#   the device; the meter's flushes read alike in both).
# - The "on" runs' flushes carry mfu, model_flops_per_sec and the memory
#   keys, finite, and their dump renders through the port's flight_report.
# - Anomaly: GPT-2-small at log interval 2, every parameter NaN after step
#   FLIGHT_POISON_AFTER (tests/test_anomaly.py's poisoning): with "skip" the
#   run completes and leaves the dump, the batch .npz and a non-empty
#   torch.profiler trace of FLIGHT_TRACE_STEPS steps; with "raise" the
#   AnomalyError comes after that window. K1 once a step, K2/K3 once a layer
#   a step, counted from 0 around each run.
FLIGHT_STEPS, FLIGHT_LOG = 24, 4
FLIGHT_SYNC_STEPS = 8
FLIGHT_AB = ("off", "on", "on", "off") * 2
FLIGHT_AB_REPEATS = {"resnet18": 2, "gpt2_small": 1}
FLIGHT_SELF_SHARE = 0.01
FLIGHT_POISON_AFTER, FLIGHT_TRACE_STEPS, FLIGHT_ANOMALY_STEPS = 2, 2, 8


def _flight_cfg(kind: str, ckpt_dir: str, steps: int, log: int, interval: int = 0,
                **obs):
    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        LMConfig,
        ObservabilityConfig,
        OptimizerConfig,
        PrecisionConfig,
        TrainConfig,
    )

    common = dict(num_epochs=1, log_interval=log, eval_every=0,
                  optimizer=OptimizerConfig(name="hybrid_adam", lr=1e-3),
                  precision=PrecisionConfig(dtype="bf16"),
                  checkpoint=CheckpointConfig(directory=ckpt_dir, interval=interval),
                  observability=ObservabilityConfig(**obs))
    if kind == "resnet18":
        return TrainConfig(model="resnet18", data=DataConfig(
            dataset="synthetic_cifar", batch_size=100, max_steps_per_epoch=steps), **common)
    return TrainConfig(
        model="transformer_lm",
        lm=LMConfig(seq_len=GPT_T, vocab_size=50304, num_layers=GPT_LAYERS,
                    num_heads=GPT_H, hidden_dim=GPT_H * GPT_D, max_len=GPT_T,
                    attn_impl="flash", logits_dtype="bf16", head_bias=False,
                    train_sequences=GPT_B * steps, eval_sequences=GPT_B),
        data=DataConfig(batch_size=GPT_B, max_steps_per_epoch=steps), **common)


def _time_calls(obj, names: tuple, acc: dict, live) -> None:
    """Wrap the methods ``names`` of ``obj`` so that each call made while
    ``live()`` appends its host seconds to ``acc[name]``."""
    def wrap(name, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if live():
                    acc.setdefault(name, []).append(time.perf_counter() - t0)
        return timed

    for name in names:
        setattr(obj, name, wrap(name, getattr(obj, name)))


def _time_phases(clock, acc: dict, live) -> None:
    """Wrap ``clock.phase`` so that entering and leaving each phase while
    ``live()`` appends their host seconds to ``acc["phases"]`` (the body in
    between is not counted)."""
    phase = clock.phase

    class Timed:
        def __init__(self, name):
            self.cm = phase(name)

        def __enter__(self):
            t0 = time.perf_counter()
            self.cm.__enter__()
            if live():
                acc.setdefault("phases", []).append(time.perf_counter() - t0)

        def __exit__(self, *exc):
            t0 = time.perf_counter()
            self.cm.__exit__(*exc)
            if live():
                acc.setdefault("phases", []).append(time.perf_counter() - t0)

    clock.phase = Timed


def _self_ms(acc: dict, steps: int) -> dict:
    """Host ms a step by kind of call, each call taken at its kind's median
    (a call the loader's thread held up at the interpreter lock would
    otherwise bill that wait to the instruments), and the plain sum."""
    out = {k: 1e3 * sorted(v)[len(v) // 2] * len(v) / steps for k, v in acc.items()}
    out["sum_of_calls"] = 1e3 * sum(sum(v) for v in acc.values()) / steps
    return out


def _flight_run(kind: str, ckpt_dir: str, *, steps: int, log: int, timed: bool = False,
                sync_debug: bool = False, poison_after: int | None = None,
                self_time: bool = False, span_self_time: bool = False,
                scrape: bool = False, interval: int = 0, **obs) -> dict:
    """One ``fit()`` of ``kind`` with ``obs`` as its ObservabilityConfig;
    the loop intervals (``timed``), the synchronising calls counted
    (``sync_debug``), the parameters poisoned after ``poison_after`` steps,
    the host seconds spent in the instruments and the clock's phases
    (``self_time``) or in the span trace's own calls (``span_self_time``),
    a live scrape of the exporter from another thread (``scrape``), a save
    every ``interval`` epochs; K1/K2/K3 launches from 0; the trainer, and
    the exception ``fit`` raised."""
    import warnings

    from distributed_training_tpu_torch import LMTrainer, Trainer
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    cfg = _flight_cfg(kind, ckpt_dir, steps, log, interval, **obs)
    trainer = (Trainer if kind == "resnet18" else LMTrainer)(cfg)
    step, entries, calls = trainer.train_step, [], []

    def wrapped(state, batch):
        if timed:
            torch.cuda.synchronize()
            entries.append(time.perf_counter())
        out = step(state, batch)
        calls.append(1)
        if len(calls) == poison_after:
            with torch.no_grad():
                for p in state.master_params().values():
                    p.mul_(float("nan"))
        if timed and len(calls) == steps:
            torch.cuda.synchronize()
            entries.append(time.perf_counter())
        return out

    trainer.train_step = wrapped
    # Self time from the third step's entry on, as the intervals count.
    spent, live = {}, lambda: len(calls) >= 2
    if self_time:
        _time_calls(trainer.obs, ("on_step", "on_flush", "on_epoch"), spent, live)
        _time_phases(trainer.clock, spent, live)
    if span_self_time:  # every span, instant and counter, any thread
        _time_calls(trainer.trace, ("complete", "instant", "counter"), spent, live)
    scraper = _Scraper(trainer.obs) if scrape else None
    for fn in (fused_adam_update, flash_fwd, flash_bwd):
        fn.launches = 0
    pauses = []  # (start, seconds, generation) of each collection in fit()

    def on_gc(phase, info, started=[0.0]):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            pauses.append((started[0], time.perf_counter() - started[0], info["generation"]))

    if timed:  # the same collector state at every timed run's start
        gc.collect()
        gc.callbacks.append(on_gc)
    error = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if sync_debug:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.fit()
        except Exception as e:  # noqa: BLE001 - the anomaly runs expect one
            error = e
        finally:
            torch.cuda.set_sync_debug_mode(0)
            if scraper is not None:
                scraper.stop()
            if timed:
                gc.callbacks.remove(on_gc)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    intervals = [1e3 * (b - a) for a, b in zip(entries, entries[1:])][2:]
    # The collector's pauses inside the counted intervals, by generation.
    counted = [(s, g) for t, s, g in pauses if len(entries) > 2 and entries[2] <= t < entries[-1]]
    gc_window = {"ms": 1e3 * sum(s for s, _ in counted),
                 "by_generation": [sum(g == n for _, g in counted) for n in range(3)]}
    return {"trainer": trainer, "error": error, "calls": len(calls), "syncs": len(syncs),
            "sync_kinds": sorted(set(s.split("\n")[0][:120] for s in syncs)),
            "intervals_ms": intervals, "gc": gc_window, "self_s": spent,
            "scrape": scraper.result if scraper is not None else None,
            "launches": {"fused_adam": fused_adam_update.launches,
                         "flash_fwd": flash_fwd.launches, "flash_bwd": flash_bwd.launches}}


def _flight_report_text(path: str) -> str:
    import contextlib
    import io

    from distributed_training_tpu_torch.tools import flight_report

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = flight_report.main([path])
    if rc != 0:
        raise SystemExit(f"flight: flight_report exited {rc} on {path}")
    return buf.getvalue()


def _check_launches(tag: str, kind: str, launches: dict, steps: int) -> None:
    want = {"fused_adam": steps}
    if kind == "gpt2_small":
        want.update(flash_fwd=GPT_LAYERS * steps, flash_bwd=GPT_LAYERS * steps)
    if any(launches[k] != n for k, n in want.items()):
        raise SystemExit(f"flight {tag}: launches {launches}, expected {want}")


def flight_phase(ckpt_dir: str) -> dict:
    """The flight instruments on both trainers (see FLIGHT_STEPS)."""
    import glob
    import math

    from distributed_training_tpu_torch.observability import AnomalyError

    out = {"launches": {}}
    for kind in ("resnet18", "gpt2_small"):
        ab, order = {}, FLIGHT_AB * FLIGHT_AB_REPEATS[kind]
        for i, mode in enumerate(order):
            run = _flight_run(kind, os.path.join(ckpt_dir, f"{kind}_ab{i}"),
                              steps=FLIGHT_STEPS, log=FLIGHT_LOG, timed=True,
                              flight_recorder=mode == "on")
            _check_launches(f"{kind} {mode}", kind, run["launches"], FLIGHT_STEPS)
            out["launches"][f"flight_{kind}_ab{i}_{mode}"] = run["launches"]
            ab.setdefault(mode, []).append(run["intervals_ms"])
            ab.setdefault(f"gc_{mode}", []).append(run["gc"])
            trainer = run.pop("trainer")
            if mode == "on" and "dump" not in ab:
                flushes = trainer.obs.recorder.flushes
                keys = ("mfu", "model_flops_per_sec", "mem_bytes_in_use", "mem_peak_bytes",
                        "mem_bytes_limit")
                for f in flushes[1:]:
                    if not all(isinstance(f.get(k), float) and math.isfinite(f[k])
                               and f[k] > 0 for k in keys):
                        raise SystemExit(f"flight {kind}: flush without finite {keys}: {f}")
                ab["dump"] = trainer.obs.dump()
                ab["report"] = _flight_report_text(ab["dump"])
                ab["last_flush"] = flushes[-1]
            del trainer
            torch.cuda.empty_cache()
        step_ms = {m: [sum(x) / len(x) for x in ab[m]] for m in ("on", "off")}
        on_ms, off_ms = (sum(step_ms[m]) / len(step_ms[m]) for m in ("on", "off"))
        per = FLIGHT_AB.count("off")  # the "off" runs of one FLIGHT_AB
        offs = [step_ms["off"][j:j + per] for j in range(0, len(step_ms["off"]), per)]
        spread = sum(max(o) - min(o) for o in offs) / len(offs)
        run = _flight_run(kind, os.path.join(ckpt_dir, f"{kind}_self"), steps=FLIGHT_STEPS,
                          log=FLIGHT_LOG, self_time=True)
        _check_launches(f"{kind} self time", kind, run["launches"], FLIGHT_STEPS)
        out["launches"][f"flight_{kind}_self"] = run["launches"]
        self_split = _self_ms(run["self_s"], FLIGHT_STEPS - 2)
        self_ms = sum(v for k, v in self_split.items() if k != "sum_of_calls")
        del run["trainer"]
        syncs = {}
        for mode in ("off", "on"):
            run = _flight_run(kind, os.path.join(ckpt_dir, f"{kind}_sync_{mode}"),
                              steps=FLIGHT_SYNC_STEPS, log=FLIGHT_LOG, sync_debug=True,
                              flight_recorder=mode == "on")
            out["launches"][f"flight_{kind}_sync_{mode}"] = run["launches"]
            syncs[mode] = {"count": run["syncs"], "kinds": run["sync_kinds"]}
            del run["trainer"]
        r = out[kind] = {"step_ms": {"on": on_ms, "off": off_ms}, "off_spread_ms": spread,
                         "run_step_ms": step_ms,
                         "order": list(order), "self_ms_per_step": self_ms,
                         "self_ms_per_step_by_call": self_split,
                         "syncs": syncs, "last_flush": ab["last_flush"],
                         "gc_pauses": {m: ab[f"gc_{m}"] for m in ("on", "off")}}
        gc_note = (f"collector pauses in the counted intervals, a run: on "
                   f"{[round(g['ms'], 3) for g in ab['gc_on']]} ms, off "
                   f"{[round(g['ms'], 3) for g in ab['gc_off']]} ms (full collections on "
                   f"{sum(g['by_generation'][2] for g in ab['gc_on'])}, off "
                   f"{sum(g['by_generation'][2] for g in ab['gc_off'])})")
        print(f"[flight] {kind}: mean loop interval, recorder off {off_ms:.3f} ms, on "
              f"{on_ms:.3f} ms (runs in the order {'/'.join(order)}: on "
              f"{r['run_step_ms']['on']}, off {r['run_step_ms']['off']}); off runs' spread "
              f"{spread:.3f} ms (a FLIGHT_AB's, averaged); {gc_note}; the instruments and the clock's phases "
              f"{1e3 * self_ms:.1f} us "
              f"a step on the host ({100 * self_ms / off_ms:.3f}% of the off step; by call "
              f"{self_split}); "
              f"synchronising calls off {syncs['off']['count']}, on {syncs['on']['count']} "
              f"({syncs['on']['kinds']}); last flush {ab['last_flush']}", flush=True)
        print("[flight] " + ab["report"].replace("\n", "\n[flight] ").rstrip(), flush=True)
        if on_ms - off_ms > spread:
            raise SystemExit(f"flight {kind}: recorder on {on_ms:.3f} ms against off "
                             f"{off_ms:.3f} ms, more than the off runs' spread {spread:.3f} "
                             f"(runs on {step_ms['on']}, off {step_ms['off']}; {gc_note}; "
                             f"self time {1e3 * self_ms:.1f} us a step)")
        if self_ms > FLIGHT_SELF_SHARE * off_ms:
            raise SystemExit(f"flight {kind}: the instruments take {self_ms:.4f} ms a step, "
                             f"over {FLIGHT_SELF_SHARE:.0%} of the {off_ms:.3f} ms step")
        if syncs["on"]["count"] != syncs["off"]["count"]:
            raise SystemExit(f"flight {kind}: synchronising calls on {syncs['on']} "
                             f"against off {syncs['off']}")
    for action in ("skip", "raise"):
        d = os.path.join(ckpt_dir, f"anomaly_{action}")
        run = _flight_run("gpt2_small", d, steps=FLIGHT_ANOMALY_STEPS, log=2,
                          poison_after=FLIGHT_POISON_AFTER, grad_norm=True,
                          anomaly_detection=True, anomaly_action=action,
                          anomaly_trace_steps=FLIGHT_TRACE_STEPS)
        out["launches"][f"flight_gpt2_small_anomaly_{action}"] = run["launches"]
        trainer, err = run.pop("trainer"), run["error"]
        flight = os.path.join(d, "flight")
        dumps = glob.glob(os.path.join(flight, "anomaly_step*_flight.json"))
        npz = glob.glob(os.path.join(flight, "anomaly_step*_batch.npz"))
        traces = glob.glob(os.path.join(flight, "anomaly_step*_trace", "trace_*.json"))
        events = (len(json.load(open(traces[0])).get("traceEvents", []))
                  if traces else 0)
        # Seen at the flush after the poisoned step, traced over the next
        # FLIGHT_TRACE_STEPS steps; "raise" stops the run there.
        seen = 2 * (FLIGHT_POISON_AFTER // 2 + 1)
        want_calls = (FLIGHT_ANOMALY_STEPS if action == "skip"
                      else seen + FLIGHT_TRACE_STEPS)
        r = out[f"anomaly_{action}"] = {
            "error": repr(err), "calls": run["calls"], "dumps": len(dumps),
            "npz": len(npz), "trace_events": events, "launches": run["launches"],
            "anomalies": (json.load(open(dumps[0]))["anomalies"] if dumps else [])}
        print(f"[flight] anomaly ({action}): {r}", flush=True)
        ok_error = (err is None if action == "skip"
                    else isinstance(err, AnomalyError) and "non-finite loss" in str(err))
        if not (ok_error and run["calls"] == want_calls and len(dumps) == 1
                and len(npz) == 1 and events > 0):
            raise SystemExit(f"flight anomaly {action}: {r}, expected {want_calls} steps")
        _check_launches(f"anomaly {action}", "gpt2_small", run["launches"], want_calls)
        del trainer
        torch.cuda.empty_cache()
    return out


class _Scraper:
    """A thread that, once the recorder holds a flush, fetches the live
    exporter's ``/metrics``, ``/healthz`` and ``/vars`` (urllib, loopback)
    until each has answered, while ``fit()`` runs; ``result`` holds the
    status codes, the last flush's MFU from ``/vars`` and the ``/healthz``
    phase."""

    def __init__(self, obs):
        self.obs, self.result = obs, {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="scraper", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        import urllib.request

        while not self._stop.is_set():
            exp, rec = self.obs.exporter, self.obs.recorder
            if exp is None or rec is None or not rec.flushes:
                time.sleep(0.002)
                continue
            try:
                got = {}
                for path in ("/metrics", "/healthz", "/vars"):
                    with urllib.request.urlopen(exp.url(path), timeout=10) as resp:
                        got[path] = (resp.status, resp.read().decode())
            except OSError as e:
                self.result["error"] = repr(e)
                time.sleep(0.01)
                continue
            flushes = json.loads(got["/vars"][1]).get("flushes") or [{}]
            self.result = {"codes": {p: c for p, (c, _) in got.items()},
                           "mfu": flushes[-1].get("mfu"),
                           "phase": json.loads(got["/healthz"][1])["phase"],
                           "metrics_lines": got["/metrics"][1].count("\n"),
                           "step": flushes[-1].get("step")}
            return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)


# The trace phase: the span trace (observability/trace.py) on both trainers
# at the flight phase's configurations (full-width ResNet-18 at batch 100
# and GPT-2-small, bf16, hybrid_adam; TRACE_STEPS steps, a flush every
# TRACE_LOG): trace off, on, on, off in one process, each run's mean loop
# interval after its first two steps; the first "on" run also times every
# span call on the host (must stay under TRACE_SELF_SHARE of the off step)
# and saves once, so its file holds the async writer's track. The A/B is
# reported, not gated: with two "off" runs the spread cannot resolve a cost
# of ~0.1 ms (the flight phase's finding). Then TRACE_SYNC_STEPS steps off
# and on under torch.cuda.set_sync_debug_mode("warn"), with as many
# synchronising calls; GPT-2-small's "on" run also serves --metrics-port,
# scraped from a second thread during the fit.
TRACE_AB = ("off", "on", "on", "off")
TRACE_STEPS, TRACE_LOG, TRACE_SYNC_STEPS = 12, 4, 8
TRACE_SELF_SHARE = 0.01


def _trace_report(path: str) -> tuple[dict, str]:
    """The port's trace_report on ``path``: its summary and its text (the
    tool must exit 0)."""
    import contextlib
    import io

    from distributed_training_tpu_torch.observability.trace import load_trace
    from distributed_training_tpu_torch.tools import trace_report

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trace_report.main([path])
    if rc != 0:
        raise SystemExit(f"trace: trace_report exited {rc} on {path}")
    return trace_report.summarize(load_trace(path)), buf.getvalue()


def _span_counts(path: str) -> dict:
    """{track: {span or event name: count}} of a trace file."""
    from distributed_training_tpu_torch.observability.trace import load_trace

    events = load_trace(path)["traceEvents"]
    tracks = {e["tid"]: e["args"]["name"] for e in events
              if e["ph"] == "M" and e["name"] == "thread_name"}
    out: dict = {}
    for e in events:
        if e["ph"] != "M":
            by = out.setdefault(tracks[e["tid"]], {})
            by[e["name"]] = by.get(e["name"], 0) + 1
    return out


def trace_phase(ckpt_dir: str) -> dict:
    """The span trace on both trainers (see TRACE_STEPS)."""
    from distributed_training_tpu_torch.config import TraceConfig

    out = {"launches": {}}
    for kind in ("resnet18", "gpt2_small"):
        ab, first = {"on": [], "off": []}, None
        for i, mode in enumerate(TRACE_AB):
            on = mode == "on"
            d = os.path.join(ckpt_dir, f"{kind}_ab{i}")
            is_first = on and first is None
            run = _flight_run(kind, d, steps=TRACE_STEPS, log=TRACE_LOG, timed=True,
                              span_self_time=is_first, interval=1 if is_first else 0,
                              trace=TraceConfig(enabled=on))
            _check_launches(f"trace {kind} {mode}", kind, run["launches"], TRACE_STEPS)
            out["launches"][f"trace_{kind}_ab{i}_{mode}"] = run["launches"]
            ab[mode].append(sum(run["intervals_ms"]) / len(run["intervals_ms"]))
            if is_first:
                path = run["trainer"].obs.trace_path
                summary, text = _trace_report(path)
                first = {"path": path, "summary": summary, "text": text,
                         "spans": _span_counts(path),
                         "self": _self_ms(run["self_s"], TRACE_STEPS - 2)}
            del run["trainer"]
            torch.cuda.empty_cache()
        spans = first["spans"]
        want = {"step": TRACE_STEPS, "data": None, "log": TRACE_STEPS, "ckpt": 1}
        train = spans.get("train", {})
        if (any(train.get(n, 0) < 1 or (c is not None and train[n] != c)
                for n, c in want.items())
                or spans.get("ckpt-writer", {}).get("ckpt.persist") != 1):
            raise SystemExit(f"trace {kind}: spans {spans}, expected {want} on the train track "
                             f"and one ckpt.persist on ckpt-writer")
        syncs, scrape = {}, None
        for mode in ("off", "on"):
            live = mode == "on" and kind == "gpt2_small"
            run = _flight_run(kind, os.path.join(ckpt_dir, f"{kind}_sync_{mode}"),
                              steps=TRACE_SYNC_STEPS, log=TRACE_LOG, sync_debug=True,
                              scrape=live, trace=TraceConfig(enabled=mode == "on"),
                              **({"metrics_port": _free_port()} if live else {}))
            _check_launches(f"trace {kind} sync {mode}", kind, run["launches"],
                            TRACE_SYNC_STEPS)
            out["launches"][f"trace_{kind}_sync_{mode}"] = run["launches"]
            syncs[mode] = {"count": run["syncs"], "kinds": run["sync_kinds"]}
            scrape = run["scrape"] if live else scrape
            del run["trainer"]
            torch.cuda.empty_cache()
        on_ms, off_ms = (sum(ab[m]) / len(ab[m]) for m in ("on", "off"))
        self_ms = sum(v for k, v in first["self"].items() if k != "sum_of_calls")
        r = out[kind] = {"step_ms": {"on": on_ms, "off": off_ms}, "run_step_ms": ab,
                         "off_spread_ms": max(ab["off"]) - min(ab["off"]),
                         "order": list(TRACE_AB), "span_self_ms_per_step": self_ms,
                         "span_self_by_call": first["self"], "syncs": syncs,
                         "spans": spans, "events": first["summary"]["events"],
                         "scrape": scrape}
        print(f"[trace] {kind}: mean loop interval, trace off {off_ms:.3f} ms, on {on_ms:.3f} ms "
              f"({on_ms - off_ms:+.3f}; runs {'/'.join(TRACE_AB)}: on {ab['on']}, off "
              f"{ab['off']}; off spread {r['off_spread_ms']:.3f} ms, reported, not gated); the "
              f"span calls {1e3 * self_ms:.1f} us a step on the host ({100 * self_ms / off_ms:.3f}%"
              f" of the off step; by call {first['self']}); synchronising calls off "
              f"{syncs['off']['count']}, on {syncs['on']['count']}; {r['events']} events, spans "
              f"by track {spans}" + (f"; live scrape {scrape}" if scrape is not None else ""),
              flush=True)
        print("[trace] " + first["text"].replace("\n", "\n[trace] ").rstrip(), flush=True)
        if self_ms > TRACE_SELF_SHARE * off_ms:
            raise SystemExit(f"trace {kind}: the span calls take {self_ms:.4f} ms a step, over "
                             f"{TRACE_SELF_SHARE:.0%} of the {off_ms:.3f} ms step")
        if syncs["on"]["count"] != syncs["off"]["count"]:
            raise SystemExit(f"trace {kind}: synchronising calls on {syncs['on']} against off "
                             f"{syncs['off']}")
        if kind == "gpt2_small":
            mfu = (scrape or {}).get("mfu")
            if (not scrape or set(scrape.get("codes", {}).values()) != {200}
                    or not isinstance(mfu, float) or not 0 < mfu < 1):
                raise SystemExit(f"trace: the live scrape during the GPT-2-small fit: {scrape}")
    return out


# The resilience phase: the chaos drills through both CLIs, ResNet-18
# (-p deepspeed: its normalize-only input draws no random numbers; bf16,
# synthetic CIFAR at batch 100) and GPT-2-small at full width cut to
# RES_GPT_LAYERS of its 12 layers for the script's time (every drill stays;
# a save shrinks from 1.5 GB to ~0.8; bf16, flash,
# T 1024, batch 16, over a seeded random byte corpus), RES_EPOCHS epochs of
# RES_STEPS steps, every step's loss in a JSONL file. The uninterrupted run
# twice, in this process through the CLI's build_trainer: the first with a
# slow step every 2nd step (the flight dump's step-time percentiles show
# them), a data-error rate (GPT: the corpus read) and its one save, at the
# end, corrupted after commit (verify_checkpoint raises); the second saving
# every epoch, its last save torn (auto-resume skips and quarantines it).
# SIGTERM at step RES_KILL_STEP, in this process (the chaos monkey raises
# the signal, the trainer's PreemptionGuard catches it), with no interval
# save: a step-accurate save and a clean return; the resume's trainer
# restores it (the parameters, moments, step and data position equal the
# saved ones bit for bit) and trains to the end. SIGKILL at step
# RES_HARD_KILL_STEP, the first of the last epoch, in a subprocess (it must
# kill the child, not this script) saving every epoch; then the resume, in
# this process, from the newest committed interval save (the writer's queue
# holds one task, so epoch 0's save was committed before epoch 1's could be
# queued; epoch 1's may or may not be). No run evaluates but the SIGKILL
# child (the CLIs have no flag for it) and no resume saves: no drill reads
# either. ResNet-18 also reads an imagefolder tree of RES_TREE JPEGs (one
# step of batch 100; two before the same cut for time) under a
# data-error rate: io_faults in the dump equals the keys the seeded choice
# faults.
#
# The continuation check: if the two uninterrupted runs' losses agree bit
# for bit, each resumed run's must too; else each resumed step's loss lies
# within RES_CONT_FACTOR times the largest gap between the two
# uninterrupted runs (at any step) of the first run's loss at that step. K3
# adds dQ with float32 atomics and cuDNN may pick algorithms that do not
# repeat, so either branch can come up; which one each model took is
# printed. No algorithm is switched to force determinism.
RES_EPOCHS, RES_STEPS = 3, 2
RES_KILL_STEP, RES_HARD_KILL_STEP = 3, 5
RES_SLOW_MS, RES_DATA_ERROR_RATE, RES_CHAOS_SEED = 100.0, 0.3, 5
RES_CONT_FACTOR = 5.0
RES_GPT_LAYERS = 2
RES_TREE = 100
RES_RESNET_ARGS = ["-p", "deepspeed", "--model", "resnet18", "--dataset", "synthetic_cifar",
                   "-b", "100", "--dtype", "bf16"]
RES_SCRIPTS = {"resnet18": "resnet/torch_cuda/train.py", "gpt2_small": "gpt/torch_cuda/train.py"}


def _res_args(kind: str) -> list:
    """The model's flags: RES_RESNET_ARGS, or the GPT CLI phase's width at
    RES_GPT_LAYERS layers."""
    if kind == "resnet18":
        return RES_RESNET_ARGS
    args = GPT_CLI_WIDTH[:GPT_CLI_WIDTH.index("-e")]
    at = args.index("--num-layers") + 1
    return [*args[:at], str(RES_GPT_LAYERS), *args[at + 1:]]


def _res_argv(kind: str, run_dir: str, interval: int, *extra) -> list:
    return [*_res_args(kind), "-e", str(RES_EPOCHS), "--steps-per-epoch", str(RES_STEPS),
            "--log-interval", "1", "-i", str(interval), "--auto-resume", "-c", run_dir,
            "--metrics-jsonl", run_dir + ".jsonl", *extra]


def _jsonl_losses(path: str) -> dict:
    """{step: loss} of a run's train lines."""
    with open(path) as fh:
        rows = [json.loads(x) for x in fh]
    return {r["step"]: r["loss"] for r in rows if r["prefix"] == "train"}


def _cli_subprocess(kind: str, argv: list, log_path: str, expect: int) -> str:
    import subprocess

    with open(log_path, "w") as log:
        rc = subprocess.run([sys.executable, os.path.join(REPO, RES_SCRIPTS[kind]), *argv],
                            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
                            timeout=600).returncode
    out = open(log_path).read()
    if rc != expect:
        raise SystemExit(f"resilience {kind}: {' '.join(argv)} exited {rc}, expected "
                         f"{expect}: {out[-3000:]}")
    return out


def _res_cli(kind: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"res_cli_{kind}",
                                                  os.path.join(REPO, RES_SCRIPTS[kind]))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def _res_trainer(cli, argv: list):
    """The CLI's trainer for ``argv`` (its ``build_config``), with
    ``eval_every`` 0: no drill reads an eval."""
    from distributed_training_tpu_torch import LMTrainer, Trainer

    args = cli.build_parser().parse_args(argv)
    cfg = cli.build_config(args).replace(eval_every=0)
    return (LMTrainer if cfg.model == "transformer_lm" else Trainer)(cfg, device=args.device)


def _res_fit(trainer) -> dict:
    """``trainer.fit()``; the flight dump, the chaos counters and K1/K2/K3
    launches from 0."""
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    for fn in (fused_adam_update, flash_fwd, flash_bwd):
        fn.launches = 0
    result = trainer.fit()
    out = {"result": result, "dump": json.load(open(trainer.obs.dump())),
           "chaos": dict(trainer.chaos.counters) if trainer.chaos is not None else {},
           "launches": {"fused_adam": fused_adam_update.launches,
                        "flash_fwd": flash_fwd.launches, "flash_bwd": flash_bwd.launches}}
    del trainer
    torch.cuda.empty_cache()
    return out


def _restored_equals_saved(trainer, run_dir: str, want_start: tuple) -> dict:
    """A resume's restore (what ``fit`` does first) into ``trainer``
    against the saved payload: every tensor of the state bit for bit, the
    step, and where in its epoch the data resumes."""
    from distributed_training_tpu_torch import checkpoint as ckpt_lib

    epoch = ckpt_lib.resolve_resume(trainer.cfg.checkpoint)
    start = ckpt_lib.restore_checkpoint(run_dir, epoch, trainer.state)
    saved = torch.load(os.path.join(run_dir, f"epoch_{epoch}", ckpt_lib.PAYLOAD),
                       map_location="cpu", weights_only=True)["state"]
    got = trainer.state.state_dict()
    tensors = unequal = 0
    for part in ("model", "opt_state"):
        for k, v in saved[part].items():
            for n, t in (v.items() if isinstance(v, dict) else [(None, v)]):
                g = got[part][k] if n is None else got[part][k][n]
                if isinstance(t, torch.Tensor):
                    tensors += 1
                    unequal += not torch.equal(g.cpu(), t)
                elif g != t:
                    unequal += 1
    out = {"epoch": epoch, "start": start, "step": got["step"], "saved_step": saved["step"],
           "tensors": tensors, "unequal": unequal}
    del saved, got
    if (start != want_start or out["step"] != out["saved_step"]
            or out["saved_step"] != RES_KILL_STEP or unequal):
        raise SystemExit(f"resilience: the restore after SIGTERM at step {RES_KILL_STEP}: "
                         f"{out}, expected start {want_start}")
    return out


def _continuation(tag: str, base: list, resumed: dict) -> dict:
    """The continuation rule (see RES_CONT_FACTOR) for the resumed run's
    {step: loss} against the two uninterrupted runs' ``base``."""
    a, b = base
    gap = max(abs(a[s] - b[s]) for s in a)
    err = max(abs(resumed[s] - a[s]) for s in resumed)
    branch = "bitwise" if gap == 0.0 else "within_gap"
    ok = err == 0.0 if branch == "bitwise" else err <= RES_CONT_FACTOR * gap
    out = {"branch": branch, "gap": gap, "resumed_err": err, "steps": sorted(resumed),
           "limit": 0.0 if branch == "bitwise" else RES_CONT_FACTOR * gap}
    if not ok or sorted(resumed) != sorted(s for s in a if s > min(resumed) - 1):
        raise SystemExit(f"resilience {tag}: continuation {out}; losses {resumed} against "
                         f"{a} and {b}")
    return out


def _io_faults_expected(keys: list, seed: int, rate: float) -> int:
    """How many of ``keys`` the seeded choice faults (``ChaosMonkey.io_check``)."""
    import zlib

    return sum(zlib.crc32(f"{seed}:data:{k}".encode()) % 1_000_000 < int(rate * 1_000_000)
               for k in keys)


def resilience_phase(ckpt_dir: str) -> dict:
    """The chaos drills through both CLIs (see RES_EPOCHS)."""
    import shutil
    import warnings

    import numpy as np

    from distributed_training_tpu_torch import bench
    from distributed_training_tpu_torch import checkpoint as ckpt_lib
    from distributed_training_tpu_torch.resilience.errors import CheckpointCorruptError
    from distributed_training_tpu_torch.resilience.verify import verify_checkpoint

    out = {"launches": {}}
    corpus = os.path.join(ckpt_dir, "corpus.bin")
    os.makedirs(ckpt_dir, exist_ok=True)
    with open(corpus, "wb") as fh:
        fh.write(np.random.RandomState(0).randint(0, 256, 1 << 21, dtype=np.uint8).tobytes())
    for kind in ("resnet18", "gpt2_small"):
        t0 = time.perf_counter()
        cli, d = _res_cli(kind), os.path.join(ckpt_dir, kind)
        data = ["--corpus", corpus] if kind == "gpt2_small" else []
        chaos = ["--chaos-seed", str(RES_CHAOS_SEED)]
        runs = {}
        # The uninterrupted run, twice; with drills that leave the losses alone.
        a_dir, b_dir = os.path.join(d, "base_a"), os.path.join(d, "base_b")
        runs["base_a"] = _res_fit(_res_trainer(cli, _res_argv(
            kind, a_dir, RES_EPOCHS, *data, *chaos, "--chaos-slow-step-every", "2",
            "--chaos-slow-step-ms", str(RES_SLOW_MS),
            "--chaos-corrupt-ckpt-epoch", str(RES_EPOCHS - 1),
            *(["--chaos-data-error-rate", "1.0"] if kind == "gpt2_small" else []))))
        runs["base_b"] = _res_fit(_res_trainer(cli, _res_argv(
            kind, b_dir, 1, *data, *chaos, "--chaos-torn-ckpt-epoch", str(RES_EPOCHS - 1))))
        for name in ("base_a", "base_b"):
            out["launches"][f"resilience_{kind}_{name}"] = runs[name]["launches"]
        base = [_jsonl_losses(x + ".jsonl") for x in (a_dir, b_dir)]
        # Drill 4: committed, and the checksum pass refuses it.
        try:
            verify_checkpoint(os.path.join(a_dir, f"epoch_{RES_EPOCHS - 1}"))
            raise SystemExit(f"resilience {kind}: the corrupted save verified")
        except CheckpointCorruptError as e:
            corrupt = {"reason": e.reason, "faults": runs["base_a"]["chaos"]}
        if corrupt["reason"] != "checksum" or corrupt["faults"]["corrupt_ckpts"] != 1:
            raise SystemExit(f"resilience {kind}: corrupt drill {corrupt}")
        # Drill 3: auto-resume skips the torn newest save and quarantines it.
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fallback = ckpt_lib.resolve_resume(cli.build_config(cli.build_parser().parse_args(
                _res_argv(kind, b_dir, 1))).checkpoint)
        torn = {"resume_epoch": fallback,
                "quarantined": os.path.isdir(os.path.join(b_dir, f"epoch_{RES_EPOCHS - 1}.corrupt")),
                "warning": [str(w.message)[:160] for w in caught][:1]}
        if fallback != RES_EPOCHS - 2 or not torn["quarantined"]:
            raise SystemExit(f"resilience {kind}: torn drill {torn}")
        # Drill 6: the stalls in the flight dump's step times.
        stats = runs["base_a"]["dump"]["step_time_stats"]
        slow = {"stats": stats, "slow_steps": runs["base_a"]["chaos"]["slow_steps"]}
        if (slow["slow_steps"] != RES_EPOCHS * RES_STEPS // 2
                or stats["step_time_max_ms"] < RES_SLOW_MS):
            raise SystemExit(f"resilience {kind}: slow-step drill {slow}")
        # Drill 1: SIGTERM at a step, a step-accurate save, its restore, the resume.
        t_dir = os.path.join(d, "term")
        term_argv = _res_argv(kind, t_dir, 0, *data)
        killed = _res_fit(_res_trainer(cli, [*term_argv, "--chaos-kill-at-step",
                                             str(RES_KILL_STEP)]))
        if not killed["result"]["preempted"] or killed["chaos"]["kills"] != 1:
            raise SystemExit(f"resilience {kind}: SIGTERM run not preempted: "
                             f"{killed['result']}, {killed['chaos']}")
        out["launches"][f"resilience_{kind}_sigterm"] = killed["launches"]
        os.replace(t_dir + ".jsonl", t_dir + "_first.jsonl")
        trainer = _res_trainer(cli, term_argv)
        restore = _restored_equals_saved(
            trainer, t_dir, (RES_KILL_STEP // RES_STEPS, RES_KILL_STEP % RES_STEPS))
        run = _res_fit(trainer)
        del trainer
        out["launches"][f"resilience_{kind}_sigterm_resume"] = run["launches"]
        term = _continuation(f"{kind} SIGTERM", base, _jsonl_losses(t_dir + ".jsonl"))
        # Drill 2: SIGKILL, no save; the resume from the newest committed one.
        k_dir = os.path.join(d, "kill")
        _cli_subprocess(kind, [*_res_argv(kind, k_dir, 1, *data), "--chaos-kill-at-step",
                               str(RES_HARD_KILL_STEP), "--chaos-kill-signal", "kill"],
                        k_dir + ".log", -9)
        committed = ckpt_lib.latest_valid_epoch(k_dir, quarantine=False)
        os.replace(k_dir + ".jsonl", k_dir + "_first.jsonl")
        run = _res_fit(_res_trainer(cli, _res_argv(kind, k_dir, 0, *data)))
        out["launches"][f"resilience_{kind}_sigkill_resume"] = run["launches"]
        kill = {"newest_committed": committed, "resumed_steps": run["result"]["steps"],
                **_continuation(f"{kind} SIGKILL", base, _jsonl_losses(k_dir + ".jsonl"))}
        if committed not in (0, 1) or kill["steps"][0] != (committed + 1) * RES_STEPS + 1:
            raise SystemExit(f"resilience {kind}: SIGKILL drill {kill}")
        # Drill 5: data-read faults absorbed by the retry, counted per key.
        io = {}
        if kind == "gpt2_small":
            io = {"corpus": runs["base_a"]["chaos"]["io_faults"], "expected": 1,
                  "dump": runs["base_a"]["dump"]["resilience"]["chaos_faults"]["io_faults"],
                  "retries": runs["base_a"]["dump"]["resilience"]["io_retries"]}
        else:
            root = tempfile.mkdtemp(prefix="chip_smoke_res_tree_")
            try:
                paths = []
                for split, n in (("train", RES_TREE), ("val", 100)):
                    paths += bench._jpeg_tree(os.path.join(root, split), n, 2)[0]
                tree_argv = [*_res_args(kind), "--dataset", "imagefolder", "--data-path", root,
                             "--image-size", "32", "--num-classes", "2", "-e", "1",
                             "--steps-per-epoch", str(RES_TREE // 100), "-i", "0",
                             "-c", os.path.join(d, "tree"), *chaos,
                             "--chaos-data-error-rate", str(RES_DATA_ERROR_RATE)]
                run = _res_fit(_res_trainer(cli, tree_argv))
                out["launches"][f"resilience_{kind}_imagefolder"] = run["launches"]
                train = [p for p in paths if os.sep + "train" + os.sep in p]
                io = {"imagefolder": run["chaos"]["io_faults"],
                      "expected": _io_faults_expected(train, RES_CHAOS_SEED,
                                                      RES_DATA_ERROR_RATE),
                      "dump": run["dump"]["resilience"]["chaos_faults"]["io_faults"],
                      "retries": run["dump"]["resilience"]["io_retries"]}
            finally:
                shutil.rmtree(root, ignore_errors=True)
        got = io.get("imagefolder", io.get("corpus"))
        if not (got == io["expected"] == io["dump"] and got > 0):
            raise SystemExit(f"resilience {kind}: data-error drill {io}")
        r = out[kind] = {"corrupt": corrupt, "torn": torn, "slow": slow, "restore": restore,
                         "sigterm": term, "sigkill": kill, "io": io,
                         "base_losses": [[base[0][s] for s in sorted(base[0])],
                                         [base[1][s] for s in sorted(base[1])]],
                         "seconds": time.perf_counter() - t0}
        print(f"[resilience] {kind}: every drill passed in {r['seconds']:.1f} s: continuation "
              f"branch {term['branch']} (gap between the uninterrupted runs {term['gap']!r}); "
              f"SIGTERM at step {RES_KILL_STEP}: restore {restore}, resumed steps "
              f"{term['steps']} within {term['resumed_err']!r}; SIGKILL at step "
              f"{RES_HARD_KILL_STEP}: newest committed save epoch {committed}, resumed "
              f"steps {kill['steps']} within {kill['resumed_err']!r}; torn {torn}; "
              f"corrupt {corrupt}; slow {slow}; data errors {io}", flush=True)
    return out


# The generate phase: GPT-2-small at full width, bf16 (the flight phase's
# configuration), GEN_TRAIN_STEPS LMTrainer steps and a save; the save
# restored through inference/restore.py (the GPT CLI's flags: bf16, bf16
# logits, no head bias), its weights bit for bit the trained ones; then
# greedy generation at batch GEN_BATCH for each (prompt, new tokens) of
# GEN_SHAPES. The cached logits at every decoded position against one full
# forward without a cache over the same tokens, row by row (_row_err) within
# GEN_ROW_TOL: both run the exact attention in bf16, but the decode's
# scores are float32 products of the bf16 q and k where the full forward
# rounds them to bf16 first, and the difference grows through 12 layers
# (the LM phase's limit for two bf16 attentions, LM_LOGITS_TOL). The greedy
# tokens against a naive rollout (the full forward teacher-forced on the
# generated prefix picks each next token) at every position whose top-2 gap
# exceeds GEN_ROW_TOL of that row's RMS; the near ties are counted. Beam
# search, GEN_BEAMS beams on GEN_BEAM_BATCH prompts: distinct beams, best
# first, and one beam equal to greedy. The generate CLI once, on the save.
# Prefill ms, decode ms a token, tokens/s, the cache's MiB and the peak GiB
# of each shape, and the Generator call's synchronising calls, counted under
# torch.cuda.set_sync_debug_mode("warn") (GEN_MAX_SYNCS); the decode loop
# launches no flash kernel (prefill runs JAX's plain attention too).
GEN_TRAIN_STEPS, GEN_BATCH = 4, 8
GEN_SHAPES = ((128, 128), (512, 512))
GEN_ROW_TOL = LM_LOGITS_TOL
GEN_BEAM_BATCH, GEN_BEAMS, GEN_BEAM_NEW = 2, 4, 32
# A generate call copies the prompt to the card and the tokens back; a
# synchronising call inside the decode loop would grow with the tokens.
GEN_MAX_SYNCS = 2
# Decode steps timed and profiled a shape (_decode_profile).
GEN_PROFILED = 16
GEN_MODEL = dict(vocab_size=50304, num_layers=GPT_LAYERS, num_heads=GPT_H,
                 hidden_dim=GPT_H * GPT_D, max_len=GPT_T, dtype="bf16", head_bias=False,
                 logits_dtype="bf16")


def _decode_profile(model, prompt: torch.Tensor, steps: int) -> dict:
    """Where a decode step's time goes: ``steps`` greedy steps after a
    prefill, timed on the host (the wall, and the dispatch: the loop's time
    before the closing synchronize), then ``steps`` more under
    ``torch.profiler`` for the device's kernel time and events a step."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_tpu_torch.inference import sampler

    with torch.no_grad():
        logits, cache = sampler.prefill(model, prompt, 2 * steps)
        tok = logits[:, -1].argmax(-1)
        del logits
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            tok = sampler.decode_step(model, tok, prompt.shape[1] + i, cache).argmax(-1)
        dispatch = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(steps, 2 * steps):
                tok = sampler.decode_step(model, tok, prompt.shape[1] + i, cache).argmax(-1)
            torch.cuda.synchronize()
    rows = _device_rows(prof)
    busy_ms = _busy_us(prof) / 1e3
    return {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
            "dispatch_ms_per_step": 1e3 * dispatch / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "device_busy_share": busy_ms / (1e3 * wall),
            "device_events_per_step": sum(r[2] for r in rows) / steps,
            "top_device": [(round(us / 1e3, 4), key[:60], n) for us, key, n in rows[:6]]}


def _gen_case(model, prompt: torch.Tensor, new: int) -> dict:
    """One greedy shape: timing through ``Generator``, the cached logits of
    the same decode loop (``sampler.prefill``/``decode_step``) against a
    full forward, the tokens against the teacher-forced rollout."""
    import warnings

    from distributed_training_tpu_torch.inference import Generator, SampleConfig
    from distributed_training_tpu_torch.inference import sampler
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd

    b, tp = prompt.shape
    gen = Generator(model, SampleConfig(max_new_tokens=new, temperature=0.0))
    # Warm-up at the prompt's shape (the first prefill at a shape pays for
    # cuBLAS's choice and the allocator's growth).
    Generator(model, SampleConfig(max_new_tokens=2, temperature=0.0))(prompt.cpu().numpy())
    start = _peak_start()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = sampler.prefill(model, prompt, new)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        cache_bytes = cache.nbytes
        del cache
    launches = (flash_fwd.launches, flash_bwd.launches)
    host_prompt = prompt.cpu().numpy()
    torch.cuda.synchronize()
    # Every synchronising call of the generation counted as it runs: the
    # check only reads a flag where no call synchronises.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            tokens = gen(host_prompt)
            total_s = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message).split("\n")[0][:120] for w in caught
             if "synchroniz" in str(w.message)]
    peak = torch.cuda.max_memory_allocated() - start
    if (flash_fwd.launches, flash_bwd.launches) != launches:
        raise SystemExit("generate: the decode loop launched a flash kernel")
    with torch.no_grad():
        logits, cache = sampler.prefill(model, prompt, new)
        steps, tok = [logits[:, -1].float()], logits[:, -1].float().argmax(-1)
        mine = [tok]
        for i in range(new - 1):
            step = sampler.decode_step(model, tok, tp + i, cache).float()
            tok = step.argmax(-1)
            steps.append(step)
            mine.append(tok)
        cached = torch.stack(steps, 1)                    # [B, new, V]
        mine = torch.stack(mine, 1)
        gen_tok = torch.from_numpy(tokens).to(prompt.device)
        seq = torch.cat([prompt, gen_tok[:, :-1]], 1)
        full = model(seq)[:, tp - 1:].float()             # [B, new, V]
        row_err = _row_err(cached, full)
        top2 = full.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        rms = full.square().mean(-1).sqrt()
        decisive = gap > GEN_ROW_TOL * rms
        wrong = (decisive & (gen_tok != full.argmax(-1))).sum().item()
        near = (~decisive).sum().item()
        near_differ = (~decisive & (gen_tok != full.argmax(-1))).sum().item()
        same_loop = bool(torch.equal(mine, gen_tok))
        del cache, logits, cached, full
        profiled = _decode_profile(model, prompt, GEN_PROFILED)
    out = {"prompt": tp, "new": new, "batch": b, "prefill_ms": 1e3 * prefill_s,
           "decode_ms_per_token": 1e3 * (total_s - prefill_s) / (new - 1),
           "tokens_per_s": b * new / total_s, "generate_s": total_s,
           "syncs": len(syncs), "sync_kinds": sorted(set(syncs)),
           "cache_mib": cache_bytes / 2**20, "peak_gib": peak / 2**30,
           "cached_vs_full_row_err": row_err, "decisive_mismatches": wrong,
           "near_ties": near, "near_ties_differing": near_differ,
           "generator_equals_the_loop": same_loop, "decode_profile": profiled}
    _check(f"generate {tp}+{new}: cached logits vs the full forward", row_err, GEN_ROW_TOL)
    if wrong or not same_loop:
        raise SystemExit(f"generate {tp}+{new}: greedy tokens against the rollout: {out}")
    return out


def generate_phase(ckpt_dir: str) -> dict:
    """Train, save, restore, generate (see GEN_SHAPES)."""
    import contextlib
    import importlib.util
    import io

    import numpy as np

    from distributed_training_tpu_torch.inference import (
        BeamConfig,
        BeamSearcher,
        Generator,
        SampleConfig,
    )
    from distributed_training_tpu_torch.inference.restore import build_lm_and_restore

    run = _flight_run("gpt2_small", ckpt_dir, steps=GEN_TRAIN_STEPS, log=2, interval=1)
    _check_launches("generate training", "gpt2_small", run["launches"], GEN_TRAIN_STEPS)
    trained = {n: p.detach().cpu() for n, p in run["trainer"].model.named_parameters()}
    del run["trainer"]
    torch.cuda.empty_cache()
    lines = []
    model, epoch = build_lm_and_restore(**GEN_MODEL, checkpoint=ckpt_dir, printer=lines.append)
    if epoch != 0 or any(not torch.equal(p.detach().cpu(), trained[n])
                         for n, p in model.named_parameters()):
        raise SystemExit(f"generate: the restored weights are not the trained ones ({lines})")
    out = {"launches": {"generate_gpt2_small_train": run["launches"]}, "restore": lines,
           "shapes": {}}
    gen = torch.Generator().manual_seed(0)
    for tp, new in GEN_SHAPES:
        prompt = torch.randint(0, 50304, (GEN_BATCH, tp), generator=gen).cuda()
        r = out["shapes"][f"{tp}+{new}"] = _gen_case(model, prompt, new)
        print(f"[generate] GPT-2-small bf16, batch {GEN_BATCH}, prompt {tp} + {new} new, "
              f"greedy: prefill {r['prefill_ms']:.3f} ms, decode {r['decode_ms_per_token']:.3f} "
              f"ms a token, {r['tokens_per_s']:.1f} tokens/s, cache {r['cache_mib']:.1f} MiB, "
              f"peak {r['peak_gib']:.3f} GiB; cached logits vs the full forward "
              f"{r['cached_vs_full_row_err']:.4g} (tolerance {GEN_ROW_TOL}); near ties "
              f"{r['near_ties']} (differing {r['near_ties_differing']}), decisive mismatches "
              f"{r['decisive_mismatches']}; synchronising calls {r['syncs']} "
              f"{r['sync_kinds']}; decode profile {r['decode_profile']}", flush=True)
    syncs = {k: r["syncs"] for k, r in out["shapes"].items()}
    if len(set(syncs.values())) != 1 or max(syncs.values()) > GEN_MAX_SYNCS:
        raise SystemExit(f"generate: synchronising calls by shape {syncs}: the decode loop "
                         f"synchronises per token (at most {GEN_MAX_SYNCS} a call, the "
                         f"same for every length)")
    prompt = torch.randint(0, 50304, (GEN_BEAM_BATCH, GEN_SHAPES[0][0]), generator=gen)
    seqs, scores = BeamSearcher(model, BeamConfig(num_beams=GEN_BEAMS,
                                                  max_new_tokens=GEN_BEAM_NEW))(prompt.numpy())
    one, _ = BeamSearcher(model, BeamConfig(num_beams=1,
                                            max_new_tokens=GEN_BEAM_NEW))(prompt.numpy())
    greedy = Generator(model, SampleConfig(max_new_tokens=GEN_BEAM_NEW,
                                           temperature=0.0))(prompt.numpy())
    beam = {"scores": scores.tolist(),
            "distinct": all(len({tuple(x) for x in seqs[i]}) == GEN_BEAMS
                            for i in range(GEN_BEAM_BATCH)),
            "sorted": bool((np.diff(scores, axis=1) <= 0).all()),
            "one_beam_is_greedy": bool(np.array_equal(one[:, 0], greedy))}
    out["beam"] = beam
    if not (beam["distinct"] and beam["sorted"] and beam["one_beam_is_greedy"]):
        raise SystemExit(f"generate: beam search {beam}")
    del model
    torch.cuda.empty_cache()
    spec = importlib.util.spec_from_file_location(
        "generate_cli", os.path.join(REPO, "gpt", "torch_cuda", "generate.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    buf = io.StringIO()
    argv = ["--vocab-size", "50304", "--num-layers", str(GPT_LAYERS), "--num-heads",
            str(GPT_H), "--hidden-dim", str(GPT_H * GPT_D), "--max-len", str(GPT_T),
            "--dtype", "bf16", "--no-head-bias", "--logits-dtype", "bf16"]
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*argv, "-c", ckpt_dir, "--prompt", "The ", "--temperature", "0",
                       "--max-new-tokens", "16"])
    text = buf.getvalue()
    out["cli"] = text.strip().splitlines()
    if rc != 0 or "restored epoch 0" not in text or "'The ' -> " not in text:
        raise SystemExit(f"generate: the generate CLI exited {rc}: {text[-2000:]}")
    print(f"[generate] beam {beam}; generate.py: {out['cli']}", flush=True)
    return out



# The serve phase: the serving engine (serving/engine.py) on GPT-2-small at
# full width (12 layers, 12 heads, hidden 768, GPT-2's vocabulary of 50257,
# max_len 1024) in bf16 with bf16 logits and seeded random weights.
# SERVE_REQUESTS requests, prompt lengths drawn from the seed in
# SERVE_PROMPT, SERVE_NEW new tokens each, greedy, max_batch SERVE_BATCH and
# JAX's defaults kv_page_size 8 and prefill_chunk 64. Three runs: the paged
# engine; the legacy engine (kv_page_size None); two tiers on half the
# default pool, the first half of the requests best-effort (tier 1), the
# second half tier 0 submitted after SERVE_HEAD_START iterations, so that
# tier 0 preempts. Every request must finish with its SERVE_NEW tokens,
# check_balanced() hold and no ledger break conservation. The preempted
# requests against their tokens in the uninterrupted paged run, and every
# request of the paged and legacy runs against the port's Generator: where
# the tokens differ, the Generator's top-2 logit gap at the first differing
# position (its own prefill and decode steps, teacher-forced on the
# reference's tokens) must be under SERVE_GAP_TOL of that row's RMS, the
# generate phase's bf16 bound: a near tie that the kernels of another
# batch shape round the other way. The differing requests are counted.
# Prints TTFT and TPOT p50/p99, tokens/s, iterations, the engine's reads of
# the card an iteration, and the card's busy share over SERVE_PROFILED
# profiled iterations of the paged engine, with the share of the paged
# pool's gather and scatter (the index kernels).
SERVE_REQUESTS, SERVE_NEW, SERVE_BATCH = 32, 64, 8
SERVE_PROMPT = (16, 512)
SERVE_VOCAB = 50257
SERVE_HEAD_START = 8
SERVE_PROFILED = 24
SERVE_GAP_TOL = GEN_ROW_TOL


def _serve_model(seed: int = 0):
    from distributed_training_tpu_torch.models import get_model

    return get_model("transformer_lm", num_classes=SERVE_VOCAB, num_layers=GPT_LAYERS,
                     num_heads=GPT_H, hidden_dim=GPT_H * GPT_D, max_len=GPT_T,
                     dtype=torch.bfloat16, logits_dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(seed)).cuda().eval()


def _serve_run(model, prompts: list, cfg, *, low: int = 0) -> dict:
    """Serve ``prompts`` (the first ``low`` as tier 1, the rest submitted as
    tier 0 after SERVE_HEAD_START iterations); the engine, completions by
    uid, iterations, wall seconds and latency percentiles."""
    import numpy as np

    from distributed_training_tpu_torch.serving import Engine

    eng = Engine(model, cfg)
    done, iters = {}, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts[:low] if low else prompts:
        eng.submit(p, priority=1 if low else 0)
    if low:
        for _ in range(SERVE_HEAD_START):
            done |= {f.uid: f for f in eng.step()}
            iters += 1
        for p in prompts[low:]:
            eng.submit(p, priority=0)
    while not eng.idle:
        done |= {f.uid: f for f in eng.step()}
        iters += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = eng.stats()
    bad = {u: f.ledger.violations(ttft_ms=f.ttft_ms) for u, f in done.items()
           if f.ledger.violations(ttft_ms=f.ttft_ms)}
    short = {u: (f.finish_reason, int(f.tokens.size)) for u, f in done.items()
             if f.tokens.size != SERVE_NEW}
    if len(done) != len(prompts) or short or bad \
            or stats["ledger_conservation_violations"]:
        raise SystemExit(f"serve: {len(done)} of {len(prompts)} finished, short {short}, "
                         f"ledger violations {bad or stats['ledger_conservation_violations']}")
    eng.check_balanced()
    ttft = np.array([f.ttft_ms for f in done.values()])
    tpot = np.array([f.tpot_ms for f in done.values()])
    return {"engine": eng, "done": done, "out": {
        "iterations": iters, "wall_s": wall, "tokens": int(stats["tokens_emitted"]),
        "tokens_per_s_wall": stats["tokens_emitted"] / wall,
        "throughput_tok_s": stats["throughput_tok_s"],
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "tpot_p50_ms": float(np.percentile(tpot, 50)),
        "tpot_p99_ms": float(np.percentile(tpot, 99)),
        "device_reads": eng.device_reads,
        "device_reads_per_iteration": eng.device_reads / iters,
        "requests_preempted": stats["requests_preempted"],
        "preempted_token_recompute": stats["preempted_token_recompute"],
        "kv_reserved_vs_written": stats["kv_reserved_vs_written"],
        "cache_mib": eng._cache.nbytes / 2**20}}


def _reference(model, prompt) -> tuple[list, list]:
    """The ``Generator``'s greedy tokens for ``prompt`` (batch 1), by its own
    loop (``sampler.prefill``, then ``decode_step`` a token, argmax), and
    at each position the top-2 gap of its logits over the row's RMS."""
    from distributed_training_tpu_torch.inference import sampler

    with torch.no_grad():
        p = torch.as_tensor(prompt, dtype=torch.long, device=model.pos_embed.device)[None]
        logits, cache = sampler.prefill(model, p, SERVE_NEW)
        rows = [logits[0, -1]]
        for j in range(SERVE_NEW - 1):
            rows.append(sampler.decode_step(model, rows[-1].argmax()[None], p.shape[1] + j,
                                            cache)[0])
        rows = torch.stack(rows).float()
        top2 = rows.topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]) / rows.square().mean(-1).sqrt()
        return rows.argmax(-1).tolist(), gaps.tolist()


def _near_tie(model, prompt, ref, got) -> tuple[int, float]:
    """The first position where ``got`` leaves ``ref`` and the top-2 gap of
    the Generator's logits there over the row's RMS, its prefill and decode
    steps teacher-forced on ``ref``'s tokens."""
    from distributed_training_tpu_torch.inference import sampler

    i = int(next(j for j in range(len(ref)) if ref[j] != got[j]))
    device = model.pos_embed.device
    with torch.no_grad():
        p = torch.as_tensor(prompt, dtype=torch.long, device=device)[None]
        logits, cache = sampler.prefill(model, p, len(ref))
        row = logits[0, -1]
        for j in range(i):
            tok = torch.tensor([int(ref[j])], device=device)
            row = sampler.decode_step(model, tok, p.shape[1] + j, cache)[0]
        row = row.float()
        top2 = row.topk(2).values
        return i, float((top2[0] - top2[1]) / row.square().mean().sqrt())


def _against(model, prompts: list, ref: dict, got: dict, uids, what: str,
             gaps: dict | None = None) -> dict:
    """Requests ``uids`` of ``got`` against ``ref`` (token lists by uid):
    the count that differ, each one's first differing position and gap
    (from ``gaps``, the reference's own, when given); a difference at a gap
    at or above SERVE_GAP_TOL fails."""
    differing = {}
    for u in uids:
        a, b = list(ref[u]), list(got[u])
        if a != b:
            i = next(j for j in range(len(a)) if a[j] != b[j])
            differing[u] = ((i, gaps[u][i]) if gaps is not None
                            else _near_tie(model, prompts[u], a, b))
    decisive = {u: d for u, d in differing.items() if d[1] >= SERVE_GAP_TOL}
    if decisive:
        raise SystemExit(f"serve: {what}: requests whose tokens leave the reference at a "
                         f"decisive position (index, gap / RMS): {decisive}")
    return {"compared": len(list(uids)), "differing": len(differing),
            "first_difference": {u: [i, round(g, 5)] for u, (i, g) in differing.items()}}


def _gather_ms(eng) -> float:
    """One layer's paged gather at the engine's shapes (every slot's whole
    table view of K: [max_batch, pages_per_slot x page_size] rows of [H, hd]),
    timed with CUDA events over 50 launches after 5."""
    pool = eng._cache.keys[0]
    b, n = eng.cfg.max_batch, eng.pages_per_slot
    table = torch.randperm(eng.pool_pages, device=pool.device)[:b * n].view(b, n) + 1
    gather = (table[:, :, None] * eng.page_size
              + torch.arange(eng.page_size, device=pool.device)).reshape(b, -1)
    for _ in range(5):
        pool[gather]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        pool[gather]
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 50


def _serve_profile(model, prompts: list, cfg) -> dict:
    """The paged engine in steady decoding (SERVE_BATCH requests seated,
    prefills done): SERVE_PROFILED iterations timed on the host, as many
    under ``torch.profiler`` (the card's busy share, the pool's gather and
    scatter kernels' share of it), and the gather timed alone: its ms a
    step (K and V, every layer) and share of the iteration."""
    from torch.profiler import ProfilerActivity, profile

    from distributed_training_tpu_torch.serving import Engine

    eng = Engine(model, cfg)
    # Budgets that outlast the prefills (at most 8 chunks a prompt) and
    # both windows.
    for p in prompts[:SERVE_BATCH]:
        eng.submit(p, max_new_tokens=SERVE_BATCH * 8 + 2 * SERVE_PROFILED + 8)
    while any(q.prefilling for q in eng.scheduler.active()) or len(eng.queue):
        eng.step()
    t0 = time.perf_counter()
    for _ in range(SERVE_PROFILED):
        eng.step()  # each ends with its read of the sampled tokens
    wall_ms = (time.perf_counter() - t0) * 1e3 / SERVE_PROFILED
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SERVE_PROFILED):
            eng.step()
        torch.cuda.synchronize()
        prof_us = (time.perf_counter() - t0) * 1e6
    if len(eng.scheduler.active()) != SERVE_BATCH:
        raise SystemExit("serve: a request finished inside the timed windows")
    gather_ms = _gather_ms(eng) * 2 * GPT_LAYERS
    del eng
    rows = _device_rows(prof)
    busy = _busy_us(prof)
    pool_us = sum(r[0] for r in rows if re.search(r"gather|index|scatter", r[1]))
    # No device rows (a profiler that traces no kernels): not measured.
    return {"iterations": SERVE_PROFILED, "wall_ms_per_iteration": wall_ms,
            "profiled_wall_ms_per_iteration": prof_us / 1e3 / SERVE_PROFILED,
            "device_busy_ms_per_iteration": busy / 1e3 / SERVE_PROFILED if busy else None,
            "device_busy_share": busy / prof_us if busy else None,
            "pool_kernels_share_of_busy": pool_us / busy if busy else None,
            "gather_ms_per_step": gather_ms, "gather_share_of_iteration": gather_ms / wall_ms,
            "top_device": [(round(us / 1e3, 4), key[:60], n) for us, key, n in rows[:8]]}


def serve_phase() -> dict:
    """The serving engine at GPT-2-small width (see SERVE_REQUESTS)."""
    import numpy as np

    from distributed_training_tpu_torch.config import ServeConfig
    from distributed_training_tpu_torch.inference import Generator, SampleConfig
    from distributed_training_tpu_torch.serving import Engine

    t_phase = time.perf_counter()
    model = _serve_model()
    rng = np.random.RandomState(0)
    lens = rng.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, SERVE_REQUESTS)
    prompts = [rng.randint(0, SERVE_VOCAB, n).astype(np.int32) for n in lens]
    base = dict(max_batch=SERVE_BATCH, max_new_tokens=SERVE_NEW, temperature=0.0)
    paged_cfg = ServeConfig(**base)
    legacy_cfg = ServeConfig(kv_page_size=None, **base)
    # Warm-up (cuBLAS's choices, the allocator's growth) on both paths.
    for cfg in (paged_cfg, legacy_cfg):
        eng = Engine(model, cfg)
        for p in prompts[:2]:
            eng.submit(p, max_new_tokens=4)
        eng.run()
    del eng
    runs = {"paged": _serve_run(model, prompts, paged_cfg),
            "legacy": _serve_run(model, prompts, legacy_cfg)}
    half = runs["paged"]["engine"].pool_pages // 2
    low = SERVE_REQUESTS // 2
    runs["two_tier"] = _serve_run(model, prompts, ServeConfig(
        num_tiers=2, kv_pages=half, **base), low=low)
    tiered = runs["two_tier"]
    if not tiered["out"]["requests_preempted"]:
        raise SystemExit(f"serve: the two-tier run preempted nothing: {tiered['out']}")
    tokens = {n: {u: f.tokens.tolist() for u, f in r["done"].items()} for n, r in runs.items()}
    preempted = [u for u, f in tiered["done"].items()
                 if any(iv[0] == "preempt_requeue" for iv in f.ledger.intervals)]
    if not preempted:
        raise SystemExit("serve: no completion of the two-tier run shows a requeue")
    for r in runs.values():
        del r["engine"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reference, gaps = {}, {}
    for u, p in enumerate(prompts):
        reference[u], gaps[u] = _reference(model, p)
    generator_s = time.perf_counter() - t0
    # The loop is the Generator's: one request through the Generator itself.
    if Generator(model, SampleConfig(max_new_tokens=SERVE_NEW, temperature=0.0))(
            prompts[0])[0].tolist() != reference[0]:
        raise SystemExit("serve: the reference loop is not the Generator's")
    out = {"requests": SERVE_REQUESTS, "prompt_lens": lens.tolist(), "new": SERVE_NEW,
           "runs": {n: r["out"] for n, r in runs.items()},
           "preempted_uids": sorted(preempted),
           "preempted_vs_uninterrupted": _against(
               model, prompts, tokens["paged"], tokens["two_tier"], sorted(preempted),
               "preempted vs uninterrupted",
               # The reference's gaps hold where its tokens are the paged run's.
               gaps if all(tokens["paged"][u] == reference[u] for u in preempted) else None),
           "paged_vs_generator": _against(model, prompts, reference, tokens["paged"],
                                          range(SERVE_REQUESTS), "paged vs Generator", gaps),
           "legacy_vs_generator": _against(model, prompts, reference, tokens["legacy"],
                                           range(SERVE_REQUESTS), "legacy vs Generator", gaps),
           "generator_s": generator_s}
    out["profile"] = _serve_profile(model, prompts, paged_cfg)
    out["seconds"] = time.perf_counter() - t_phase
    for n, r in out["runs"].items():
        print(f"[serve] GPT-2-small bf16 {n}: {SERVE_REQUESTS} requests x {SERVE_NEW} tokens "
              f"in {r['iterations']} iterations, {r['wall_s']:.3f} s: TTFT p50 "
              f"{r['ttft_p50_ms']:.2f} / p99 {r['ttft_p99_ms']:.2f} ms, TPOT p50 "
              f"{r['tpot_p50_ms']:.3f} / p99 {r['tpot_p99_ms']:.3f} ms, "
              f"{r['tokens_per_s_wall']:.1f} tokens/s, {r['device_reads_per_iteration']:.4f} "
              f"reads of the card an iteration, preempted {r['requests_preempted']}, "
              f"cache {r['cache_mib']:.1f} MiB", flush=True)
    prof = out["profile"]
    print(f"[serve] differing from the reference (near ties, gap under {SERVE_GAP_TOL} of "
          f"the RMS): preempted vs uninterrupted "
          f"{out['preempted_vs_uninterrupted']['differing']} of {len(preempted)}, paged vs "
          f"Generator {out['paged_vs_generator']['differing']} of {SERVE_REQUESTS}, legacy "
          f"vs Generator {out['legacy_vs_generator']['differing']} of {SERVE_REQUESTS}; "
          f"steady decode: {prof['wall_ms_per_iteration']:.3f} ms an iteration "
          f"({prof['profiled_wall_ms_per_iteration']:.3f} profiled), device busy "
          f"{prof['device_busy_ms_per_iteration']} ms, share {prof['device_busy_share']}, "
          f"the pool's gather/scatter kernels a share {prof['pool_kernels_share_of_busy']} "
          f"of it; the gather alone {prof['gather_ms_per_step']:.4f} ms a step, "
          f"{100 * prof['gather_share_of_iteration']:.2f}% of the iteration; phase "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# The serve-features phase: the serving features (serving/prefix_cache.py,
# speculative.py, quantize.py, journal.py, hotswap.py) on the serve phase's
# model (GPT-2-small, bf16, seeded random weights), paged with
# SERVE_BATCH slots and pages of FEAT_PAGE, SERVE_NEW greedy tokens a
# request. Every run must finish each request with its SERVE_NEW tokens and
# drain the pool balanced; every comparison of tokens holds them under the
# serve phase's near-tie gate (a difference only where the reference's
# top-2 gap is under SERVE_GAP_TOL of the row's RMS), except int8 KV's:
# - prefix cache: FEAT_REQUESTS requests sharing a FEAT_SYSTEM-token system
#   prompt with tails drawn in FEAT_TAIL, the first served alone (it
#   leaves the prompt in the trie), then the rest; the cache on against
#   off: the prefill positions saved and the TTFT p50 of the rest;
# - speculative decoding: FEAT_SPEC requests at spec_k FEAT_K with the
#   n-gram drafter, and FEAT_GPT_DRAFT of them with the GPT self-drafter,
#   against spec_k 0: the acceptance rate, tokens landed a dispatch and
#   tokens/s;
# - int8 weights: the quantizing engine against an engine on the
#   dequantized set (bf16), the dequant-at-use path; the weight bytes;
# - int8 KV: against the bf16 pool: the pool bytes a token (within
#   FEAT_KV8_BYTES of bf16's), the share of requests whose tokens differ
#   and each first difference's gap, which must be under FEAT_KV8_GAP_TOL;
# - the journal: a run crashed (journal.crash()) after FEAT_CRASH_AT
#   iterations and a new engine's recover(): every request completed once,
#   the tokens of the uninterrupted run; the recovery time and
#   tokens_recomputed_on_recovery;
# - the hot swap: two seeded weight sets committed as epochs 1 and 2 in a
#   directory (a params file, the manifest and the COMMITTED marker),
#   HotSwapper.poll_once arms epoch 2 after FEAT_SWAP_AT iterations, and
#   FEAT_SPEC requests admitted after the barrier against a fresh engine on
#   epoch 2's weights; rollback() re-arms epoch 1's own tensors;
#   swap_blocked_s.
FEAT_PAGE = 8
FEAT_SYSTEM, FEAT_TAIL, FEAT_REQUESTS = 256, (16, 128), 16
FEAT_SPEC, FEAT_K = 8, 4
# The GPT self-drafter's run takes the first FEAT_GPT_DRAFT of the FEAT_SPEC
# requests: it runs spec_k eager forwards a slot an iteration and accepts
# ~0 on random weights, so more requests cost time and show nothing more.
FEAT_GPT_DRAFT = 2
FEAT_KV8_BYTES = (0.53, 0.54)   # (1 + 4/64) / 2 = 0.53125 at head dim 64
FEAT_KV8_GAP_TOL = 0.5
FEAT_CRASH_AT, FEAT_SWAP_AT = 40, 24


def _feat_run(model, prompts: list, cfg, *, warm: int = 0) -> dict:
    """Serve ``prompts`` (the first ``warm`` to completion first) through
    one engine; the engine, tokens by uid, stats, wall seconds and the
    TTFT p50 of the requests after the warm ones."""
    import numpy as np

    from distributed_training_tpu_torch.serving import Engine

    eng = Engine(model, cfg)
    done = {}
    for p in prompts[:warm]:
        eng.submit(p)
    done |= {f.uid: f for f in eng.run()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in prompts[warm:]:
        eng.submit(p)
    done |= {f.uid: f for f in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    short = {u: (f.finish_reason, int(f.tokens.size)) for u, f in done.items()
             if f.tokens.size != SERVE_NEW}
    if len(done) != len(prompts) or short:
        raise SystemExit(f"serve_features: {len(done)} of {len(prompts)} finished, short {short}")
    eng.check_balanced()
    stats = eng.stats()
    rest = [f for u, f in done.items() if u >= warm]
    return {"engine": eng, "tokens": {u: f.tokens.tolist() for u, f in done.items()},
            "stats": stats, "wall_s": wall,
            "tokens_per_s": sum(f.tokens.size for f in rest) / wall,
            "ttft_p50_ms": float(np.percentile([f.ttft_ms for f in rest], 50))}


def _save_params(directory: str, epoch: int, model) -> str:
    """``model``'s weights as a committed save: ``epoch_N/params.pt``, then
    the manifest and the COMMITTED marker (``resilience/verify.py``)."""
    from distributed_training_tpu_torch.resilience import verify

    path = os.path.join(directory, f"epoch_{epoch}")
    os.makedirs(path)
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               os.path.join(path, "params.pt"))
    verify.write_manifest(path)
    return path


def serve_features_phase() -> dict:
    """The serving features at GPT-2-small width (see FEAT_PAGE)."""
    import numpy as np

    from distributed_training_tpu_torch.config import ServeConfig
    from distributed_training_tpu_torch.serving import Engine, HotSwapper
    from distributed_training_tpu_torch.serving import quantize as qz

    t_phase = time.perf_counter()
    model = _serve_model()
    rng = np.random.RandomState(2)
    system = rng.randint(0, SERVE_VOCAB, FEAT_SYSTEM)
    shared = [np.concatenate([system, rng.randint(0, SERVE_VOCAB, n)]).astype(np.int32)
              for n in rng.randint(FEAT_TAIL[0], FEAT_TAIL[1] + 1, FEAT_REQUESTS)]
    prompts = [rng.randint(0, SERVE_VOCAB, n).astype(np.int32)
               for n in rng.randint(SERVE_PROMPT[0], FEAT_SYSTEM + 1, 2 * FEAT_SPEC)]
    first, late = prompts[:FEAT_SPEC], prompts[FEAT_SPEC:]
    base = dict(max_batch=SERVE_BATCH, max_new_tokens=SERVE_NEW, temperature=0.0,
                kv_page_size=FEAT_PAGE)
    out: dict = {}

    # Prefix cache.
    off = _feat_run(model, shared, ServeConfig(**base), warm=1)
    on = _feat_run(model, shared, ServeConfig(prefix_cache=True, **base), warm=1)
    st = on["stats"]
    out["prefix_cache"] = {
        "hit_tokens": st["prefix_cache_hit_tokens"],
        "hit_requests": st["prefix_cache_hit_requests"],
        "prompt_tokens": int(sum(p.size for p in shared)),
        "ttft_p50_ms": {"off": off["ttft_p50_ms"], "on": on["ttft_p50_ms"]},
        "wall_s": {"off": off["wall_s"], "on": on["wall_s"]},
        "on_vs_off": _against(model, shared, off["tokens"], on["tokens"],
                              range(FEAT_REQUESTS), "prefix cache on vs off")}
    if st["prefix_cache_hit_tokens"] < (FEAT_REQUESTS - 1) * (FEAT_SYSTEM - FEAT_PAGE):
        raise SystemExit(f"serve_features: the prefix cache hit too little: {out['prefix_cache']}")
    del off, on

    # Speculative decoding (the plain run is the later runs' reference).
    plain = _feat_run(model, first, ServeConfig(**base))
    spec = {}
    for drafter, n in (("ngram", FEAT_SPEC), ("gpt", FEAT_GPT_DRAFT)):
        r = _feat_run(model, first[:n], ServeConfig(spec_k=FEAT_K, spec_drafter=drafter,
                                                     **base))
        st = r["stats"]
        spec[drafter] = {
            "requests": n, "acceptance_rate": st["spec_acceptance_rate"],
            "tokens_per_dispatch": st["spec_tokens_per_dispatch"],
            "drafted": st["drafted_tokens"], "accepted": st["accepted_tokens"],
            "tokens_per_s": r["tokens_per_s"], "wall_s": r["wall_s"],
            "vs_plain": _against(model, first, plain["tokens"], r["tokens"],
                                 range(n), f"spec_k {FEAT_K} {drafter} vs 0")}
        if not st["drafted_tokens"]:
            raise SystemExit(f"serve_features: the {drafter} drafter drafted nothing")
    spec["plain"] = {"tokens_per_s": plain["tokens_per_s"], "wall_s": plain["wall_s"]}
    out["speculative"] = spec

    # int8 weights: the quantizing engine (on a model of its own: it
    # installs the int8 set there) against an engine on the dequantized set.
    qmodel = _serve_model()
    fp_bytes = sum(p.numel() * p.element_size() for n, p in qz.serving_params(qmodel).items()
                   if qz.reduce_axes_for(n.replace(".", "/")) is not None)
    quant = _feat_run(qmodel, first, ServeConfig(quantize_weights=True, **base))
    twin = _serve_model()
    qz.install_params(twin, qz.dequantize_params(qz.serving_params(qmodel), torch.bfloat16))
    deq = _feat_run(twin, first, ServeConfig(**base))
    out["int8_weights"] = {
        "quantized_bytes": quant["stats"]["quantized_params_bytes"],
        "float32_bytes": fp_bytes, "bf16_bytes": fp_bytes // 2,
        "weight_quant_s": quant["stats"]["weight_quant_s"],
        "tokens_per_s": quant["tokens_per_s"], "dequantized_tokens_per_s": deq["tokens_per_s"],
        "vs_dequantized": _against(twin, first, deq["tokens"], quant["tokens"],
                                   range(FEAT_SPEC), "int8 weights vs dequantized")}
    del qmodel, twin, quant, deq
    torch.cuda.empty_cache()

    # int8 KV pages against the bf16 pool.
    kv8 = _feat_run(model, first, ServeConfig(kv_dtype="int8", **base))
    ratio = kv8["stats"]["kv_bytes_per_token"] / plain["stats"]["kv_bytes_per_token"]
    diffs = {u: _near_tie(model, first[u], plain["tokens"][u], kv8["tokens"][u])
             for u in range(FEAT_SPEC) if plain["tokens"][u] != kv8["tokens"][u]}
    out["int8_kv"] = {
        "bytes_per_token": kv8["stats"]["kv_bytes_per_token"],
        "bf16_bytes_per_token": plain["stats"]["kv_bytes_per_token"], "ratio": ratio,
        "differing_share": len(diffs) / FEAT_SPEC,
        "first_difference": {u: [i, round(g, 5)] for u, (i, g) in diffs.items()},
        "tokens_per_s": kv8["tokens_per_s"]}
    if not FEAT_KV8_BYTES[0] <= ratio < FEAT_KV8_BYTES[1] or any(
            g >= FEAT_KV8_GAP_TOL for _, g in diffs.values()):
        raise SystemExit(f"serve_features: int8 KV out of its bounds: {out['int8_kv']}")
    del kv8

    with tempfile.TemporaryDirectory() as tmp:
        # The journal: crash mid-run, recover in a new engine.
        cfg = ServeConfig(journal_dir=os.path.join(tmp, "journal"), **base)
        eng = Engine(model, cfg)
        eng.recover()
        for p in first:
            eng.submit(p)
        before = []
        for _ in range(FEAT_CRASH_AT):
            before += eng.step()
        eng.journal.crash()
        del eng
        t0 = time.perf_counter()
        eng = Engine(model, cfg)
        report = eng.recover()
        recover_s = time.perf_counter() - t0
        after = report["redelivered"] + report["completed_at_replay"] + eng.run()
        resume_s = time.perf_counter() - t0
        eng.check_balanced()
        eng.journal.shutdown()
        uids = sorted(f.uid for f in after)
        st = eng.stats()
        if uids != list(range(FEAT_SPEC)):
            raise SystemExit(f"serve_features: the recovered run completed {uids}")
        out["journal"] = {
            "finished_before_crash": len(before), "redelivered": len(report["redelivered"]),
            "resumed": report["resumed"], "recover_s": recover_s, "run_to_end_s": resume_s,
            "requests_recovered": st["requests_recovered"],
            "tokens_recomputed_on_recovery": st["tokens_recomputed_on_recovery"],
            "vs_uninterrupted": _against(model, first, plain["tokens"],
                                         {f.uid: f.tokens.tolist() for f in after},
                                         range(FEAT_SPEC), "recovered vs uninterrupted")}
        del eng

        # The hot swap: epochs 1 (this model) and 2 (seed 1) committed.
        model2 = _serve_model(seed=1)
        ckpt = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        _save_params(ckpt, 1, model)
        _save_params(ckpt, 2, model2)
        save_s = time.perf_counter() - t0

        def restore_fn(epoch: int) -> dict:
            sd = torch.load(os.path.join(ckpt, f"epoch_{epoch}", "params.pt"))
            return {n: t.cuda() for n, t in sd.items()}

        eng = Engine(model, ServeConfig(prefix_cache=True, **base), weights_epoch=1)
        originals = dict(eng.params)
        swapper = HotSwapper(eng, ckpt, restore_fn, printer=lambda m: None)
        for p in first:
            eng.submit(p)
        done = []
        for _ in range(FEAT_SWAP_AT):
            done += eng.step()
        in_flight = FEAT_SPEC - len(done)
        t0 = time.perf_counter()
        armed = swapper.poll_once()
        stage_s = time.perf_counter() - t0
        done += eng.step()  # the barrier
        if armed != 2 or eng.weights_epoch != 2:
            raise SystemExit(f"serve_features: the swap armed {armed}, serving {eng.weights_epoch}")
        for p in late:
            eng.submit(p)
        done += eng.run()
        eng.check_balanced()
        blocked = eng.stats()["swap_blocked_s"]
        if eng.rollback() != 1:
            raise SystemExit("serve_features: rollback did not re-arm epoch 1")
        eng.step()
        if eng.weights_epoch != 1 or any(eng.params[n] is not t for n, t in originals.items()):
            raise SystemExit("serve_features: rollback did not re-install epoch 1's tensors")
        got = {f.uid - FEAT_SPEC: f.tokens.tolist() for f in done if f.uid >= FEAT_SPEC}
        fresh = _feat_run(model2, late, ServeConfig(**base))
        out["hot_swap"] = {
            "save_s": save_s, "poll_stage_s": stage_s, "swap_blocked_s": blocked,
            "swaps_completed": eng.stats()["swaps_completed"],
            "in_flight_at_barrier": in_flight,
            "late_vs_fresh": _against(model2, late, fresh["tokens"], got, range(FEAT_SPEC),
                                      "admitted after the barrier vs fresh epoch 2")}
        del eng, swapper, fresh, model2
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    pc, sp, q8, k8, jr, hs = (out[k] for k in ("prefix_cache", "speculative", "int8_weights",
                                               "int8_kv", "journal", "hot_swap"))
    print(f"[serve_features] GPT-2-small bf16, {SERVE_BATCH} slots, pages of {FEAT_PAGE}: "
          f"prefix cache: {pc['hit_tokens']} of {pc['prompt_tokens']} prompt positions "
          f"saved, TTFT p50 {pc['ttft_p50_ms']['off']:.2f} ms off / "
          f"{pc['ttft_p50_ms']['on']:.2f} ms on, differing {pc['on_vs_off']['differing']}; "
          f"spec_k {FEAT_K}: ngram acceptance {sp['ngram']['acceptance_rate']:.3f}, "
          f"{sp['ngram']['tokens_per_dispatch']:.3f} tokens a dispatch, "
          f"{sp['ngram']['tokens_per_s']:.1f} tokens/s; gpt acceptance "
          f"{sp['gpt']['acceptance_rate']:.3f}, {sp['gpt']['tokens_per_dispatch']:.3f} "
          f"a dispatch, {sp['gpt']['tokens_per_s']:.1f} tokens/s; plain "
          f"{sp['plain']['tokens_per_s']:.1f} tokens/s", flush=True)
    print(f"[serve_features] int8 weights {q8['quantized_bytes']} bytes against "
          f"{q8['bf16_bytes']} bf16 / {q8['float32_bytes']} float32 (quantized in "
          f"{q8['weight_quant_s']:.3f} s), differing from the dequantized engine "
          f"{q8['vs_dequantized']['differing']}; int8 KV {k8['bytes_per_token']:.1f} bytes a "
          f"token against {k8['bf16_bytes_per_token']:.1f} ({k8['ratio']:.5f}x), differing "
          f"share {k8['differing_share']:.3f}, first differences {k8['first_difference']}; "
          f"journal: recover {jr['recover_s']:.3f} s, to the end {jr['run_to_end_s']:.3f} s, "
          f"{jr['tokens_recomputed_on_recovery']} tokens recomputed, {jr['redelivered']} "
          f"redelivered, {jr['resumed']} resumed; hot swap: swap_blocked_s "
          f"{hs['swap_blocked_s']:.6f}, staged in {hs['poll_stage_s']:.2f} s, late requests "
          f"differing {hs['late_vs_fresh']['differing']}; phase {out['seconds']:.1f} s",
          flush=True)
    return out


# The fleet phase: the serving fleet and its control room. Two replicas of
# the port's serve_net (`python -m distributed_training_tpu_torch.tools.
# serve_net --replica`, one process each, on the card) at GPT-2-small's
# full width (FLEET_WIDTH: GPT-2's vocabulary of 50257, 12 layers, 12
# heads, hidden 768, max_len 1024; float32, seeded random weights; paged
# KV with the prefix cache on, serve_net's engine defaults, 8 greedy tokens
# a request) under one ReplicaSupervisor, with their journals and fleet
# traces on, behind a Router and its RouterFrontDoor in this process. At
# most FLEET_MAX_STARTS replica processes start (the first two side by
# side), each start's seconds printed. Four legs over
# the same two replicas, in this order, each with a door of its own and
# client-supplied trace ids (so no two legs' ids meet in the merged trace):
# - "prefix": FLEET_REQUESTS shared_prefix requests (seed 0) replayed one
#   at a time through the prefix policy; client TTFT and tokens/s, and the
#   fleet's prefix-hit tokens (the replicas' /vars before and after);
# - "failover": FLEET_FAILOVER_REQUESTS (seed 2) through a traced door
#   whose chaos hook SIGKILLs the replica serving request FLEET_KILL_AT
#   mid-stream (breaker threshold 1, cooldown 600 s): exactly 1 restart
#   (journal recovery before the port line), 1 breaker open, 1 failover
#   resume, 0 failed, 0 balance violations, 0 fleet-ledger violations;
#   then the port's fleet_trace --check-failover over every trace file;
# - "deploy": shared_prefix seed 1 at concurrency 4 with a rolling deploy
#   mid-load: 0 failed, 0 stream mismatches, 2 deploys; each deploy's
#   barrier flushes that replica's trie, so no page of seed 0 survives;
# - "round_robin": leg "prefix"'s requests again through round_robin: the
#   prefix policy must save more prefill positions, route some requests by
#   prefix, and round_robin none.
# Every leg must pass serve_net's own gate (row_ok). The token check: leg
# "prefix"'s completions against one in-process replica (serve_net's
# engine on this process's card, the same requests one at a time), under
# the serve phase's near-tie gate. The control room: an in-process engine
# on that model with FLEET_SLO_RULES over the degrading scenario at
# --virtual-dt pacing and a queue bound that sheds; /timeseries and
# /alerts scraped through attach_engine mid-run; at least one alert fired,
# one incident bundle written, incident_report exit 0 on it and 2 on a
# torn copy. No kernel of the port runs here (serving is a plain product).
FLEET_WIDTH = ["--vocab-size", str(SERVE_VOCAB), "--num-layers", str(GPT_LAYERS),
               "--num-heads", str(GPT_H), "--hidden-dim", str(GPT_H * GPT_D),
               "--model-max-len", str(GPT_T), "--max-new-tokens", "8"]
FLEET_REQUESTS, FLEET_FAILOVER_REQUESTS, FLEET_KILL_AT = 16, 12, 3
FLEET_MAX_STARTS = 5
FLEET_SLO_RULES = ("queue_pressure:queue_depth>2@3,10;"
                   "shed_rate:requests_shed/requests_submitted>0.05@3,10")
FLEET_ALERT_LOAD = dict(requests=64, rate=200.0, virtual_dt_ms=5.0, max_queue_depth=8,
                        max_batch=4, mean_prompt_len=24, max_new_tokens=16,
                        prefill_chunk=16, sample_every=2)


def _fleet_scenario(name: str, seed: int, n: int, args) -> list:
    from distributed_training_tpu_torch.tools.traffic import make_scenario

    return make_scenario(name, seed=seed, requests=n, rate=args.rate,
                         mean_prompt_len=args.mean_prompt_len,
                         max_prompt_len=args.max_prompt_len,
                         max_new_tokens=args.max_new_tokens, vocab_size=args.vocab_size,
                         budget=args.max_len)


def _fleet_leg(name: str, sup, serve_net, args, reqs: list, *, policy: str,
               concurrency: int = 1, deploy: bool = False, kill_at: int = 0,
               trace_dir: str | None = None, router_box: list) -> dict:
    """One leg through a door of its own over the supervisor's replicas:
    serve_net's SLA row, plus its wall seconds, tokens/s, client TTFT
    (sequential legs), the fleet's prefix-hit tokens of this leg and the
    door's results."""
    import numpy as np

    from distributed_training_tpu_torch.observability.trace import fleet_session
    from distributed_training_tpu_torch.serving.router import HttpReplica, Router, RouterFrontDoor
    from distributed_training_tpu_torch.tools.traffic import replay_over_http

    router = Router([HttpReplica(h.url, name=h.name) for h in sup.handles], policy=policy,
                    breaker_threshold=1, breaker_cooldown_s=600.0)
    router_box[:] = [router]
    killed = []

    def hook(seq: int, delivered: int, replica) -> None:
        if kill_at and not killed and seq == kill_at and delivered >= 1 and replica is not None:
            killed.append(replica)
            print(f"[fleet] {name}: SIGKILL replica {replica} mid-stream (request {seq}, "
                  f"{delivered} tokens delivered)", flush=True)
            sup.kill(replica)

    trace, trace_path = fleet_session("door", trace_dir)
    door = RouterFrontDoor(router, chaos_hook=hook if kill_at else None, trace=trace,
                           trace_path=trace_path,
                           supervisor_snapshot=sup.supervisor_snapshot).start()
    hits0 = sum(serve_net.replica_stats(h.url)["prefix_cache_hit_tokens"] for h in sup.handles)
    try:
        deployer = None
        if deploy:
            def rolling_deploy() -> None:
                time.sleep(0.5)  # mid-load: every replica has work
                router.rolling_deploy()

            deployer = threading.Thread(target=rolling_deploy, name="fleet-deploy",
                                        daemon=True)
            deployer.start()
        ttft: list = []
        t0 = time.perf_counter()
        results = replay_over_http(door.url("/generate"), reqs, concurrency=concurrency,
                                   timeout_s=300.0, trace_prefix=f"{name}-", ttft_ms=ttft)
        wall = time.perf_counter() - t0
        if deployer is not None:
            deployer.join(timeout=300.0)
        per_replica, balance = serve_net.settle_and_audit(sup, timeout_s=180.0)
        row = serve_net.fleet_row(scenario=name, results=results, dropped=set(), router=router,
                                  sup=sup, door=door, per_replica=per_replica,
                                  balance_violations=balance, concurrency=concurrency,
                                  wall_s=wall)
    finally:
        door.stop()
    if trace is not None:
        trace.save(trace_path)
    if not serve_net.row_ok(row):
        raise SystemExit(f"fleet: leg {name} failed serve_net's gate: {row}")
    row["tokens_per_s"] = row["tokens_emitted"] / wall
    # A restart starts its replica's counters afresh: no leg total then.
    row["leg_prefix_hit_tokens"] = None if kill_at else row["prefix_cache_hit_tokens"] - hits0
    if concurrency == 1 and not kill_at:  # client TTFT of the sequential legs
        if None in ttft:
            raise SystemExit(f"fleet: leg {name}: a request streamed no tokens: {ttft}")
        row["ttft_p50_ms"] = float(np.percentile(ttft, 50))
        row["ttft_p99_ms"] = float(np.percentile(ttft, 99))
    print(f"[fleet] {name}: {json.dumps(row)}", flush=True)
    return {"row": row, "results": results}


def _control_room(model, args, work_dir: str) -> dict:
    """The SLO drill in process (see FLEET_SLO_RULES): alerts, a bundle,
    incident_report, /timeseries and /alerts scraped mid-run."""
    import contextlib
    import io
    import urllib.request

    from distributed_training_tpu_torch.config import ServeConfig
    from distributed_training_tpu_torch.observability.exporter import attach_engine
    from distributed_training_tpu_torch.resilience.errors import QueueFullError
    from distributed_training_tpu_torch.serving import Engine
    from distributed_training_tpu_torch.tools import incident_report
    from distributed_training_tpu_torch.tools.traffic import make_scenario

    a = FLEET_ALERT_LOAD
    inc_dir = os.path.join(work_dir, "incidents")
    eng = Engine(model, ServeConfig(
        max_batch=a["max_batch"], max_new_tokens=a["max_new_tokens"], temperature=0.0,
        prefill_chunk=a["prefill_chunk"], max_queue_depth=a["max_queue_depth"],
        sample_every=a["sample_every"], slo_rules=FLEET_SLO_RULES, incident_dir=inc_dir))
    load = make_scenario("degrading", seed=0, requests=a["requests"], rate=a["rate"],
                         mean_prompt_len=a["mean_prompt_len"],
                         max_prompt_len=eng.budget - a["max_new_tokens"],
                         max_new_tokens=a["max_new_tokens"], vocab_size=args.vocab_size,
                         budget=eng.budget)
    exporter = attach_engine(eng, 0, component="fleet", printer=lambda m: None)
    scraped, shed, it, sub = {}, 0, 0, 0
    t0 = time.perf_counter()
    try:
        while sub < len(load):
            vnow = it * a["virtual_dt_ms"] / 1e3
            while sub < len(load) and load[sub].arrival_s <= vnow:
                try:
                    eng.submit(load[sub].prompt, max_new_tokens=load[sub].max_new_tokens)
                except QueueFullError:
                    shed += 1
                sub += 1
            eng.step()
            it += 1
            if sub == len(load) and not scraped:  # mid-run: the last arrivals queued
                for path in ("/timeseries", "/alerts"):
                    with urllib.request.urlopen(exporter.url(path), timeout=30.0) as resp:
                        scraped[path] = json.loads(resp.read())
        eng.drain()
    finally:
        exporter.close()
    wall = time.perf_counter() - t0
    eng.close_incidents()
    eng.check_balanced()
    stats = eng.stats()
    bundles = sorted(os.listdir(inc_dir)) if os.path.isdir(inc_dir) else []
    if not bundles:
        raise SystemExit(f"fleet: the control room wrote no incident bundle: {stats}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_good = incident_report.main([inc_dir])
    torn = os.path.join(work_dir, "torn.json")
    with open(os.path.join(inc_dir, bundles[0])) as fh:
        head = fh.read(256)
    with open(torn, "w") as fh:
        fh.write(head)
    with contextlib.redirect_stderr(io.StringIO()):
        rc_torn = incident_report.main([torn])
    out = {"alerts_fired": stats["alerts_fired"], "alerts_cleared": stats["alerts_cleared"],
           "incidents_captured": stats["incidents_captured"], "bundles": bundles,
           "requests_shed": stats["requests_shed"], "shed_at_submit": shed,
           "iterations": it, "wall_s": wall,
           "log": [(e["event"], e["rule"], e["iteration"]) for e in eng.alerts.log],
           "scraped": {"timeseries_samples": len(scraped["/timeseries"].get("samples", [])),
                       "timeseries_fields": len(scraped["/timeseries"].get("fields", [])),
                       "alerts_rules": [r["name"] for r in scraped["/alerts"]["rules"]]},
           "incident_report_rc": rc_good, "torn_rc": rc_torn,
           "report_head": buf.getvalue().splitlines()[:2]}
    if not (stats["alerts_fired"] >= 1 and stats["incidents_captured"] >= 1
            and rc_good == 0 and rc_torn == 2 and out["requests_shed"] > 0
            and out["scraped"]["timeseries_samples"] > 0):
        raise SystemExit(f"fleet: the control room failed: {out}")
    print(f"[fleet] control room: {json.dumps(out)}", flush=True)
    return out


def fleet_phase(work_dir: str) -> dict:
    """The serving fleet at GPT-2-small width (see FLEET_WIDTH)."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor

    from distributed_training_tpu_torch.serving.supervisor import ReplicaSupervisor
    from distributed_training_tpu_torch.tools import fleet_trace, serve_net

    t_phase = time.perf_counter()
    os.makedirs(work_dir, exist_ok=True)
    trace_dir = os.path.join(work_dir, "traces")
    args = serve_net.build_parser().parse_args(
        [*FLEET_WIDTH, "--journal-dir", os.path.join(work_dir, "journal"),
         "--trace-dir", trace_dir])
    starts: list = []
    router_box: list = []

    # The first two starts run side by side (each blocks on its port line);
    # the supervisor takes them as its first spawns, and a restart starts anew.
    with ThreadPoolExecutor(2) as pool:
        first = dict(enumerate(pool.map(lambda i: serve_net.ReplicaProc(i, args), range(2))))

    def spawn(i: int):
        if len(starts) >= FLEET_MAX_STARTS:
            raise SystemExit(f"fleet: more than {FLEET_MAX_STARTS} replica starts")
        h = first.pop(i) if i in first else serve_net.ReplicaProc(i, args)
        starts.append(round(h.start_s, 3))
        print(f"[fleet] replica {h.name} start {len(starts)}: {h.start_s:.2f} s", flush=True)
        return h

    def on_restart(i: int, h) -> None:
        if router_box:
            router_box[0].replicas[i].url = h.url

    out: dict = {"card": card_line()}
    sup = ReplicaSupervisor(spawn, 2, on_restart=on_restart).start()
    try:
        prefix_reqs = _fleet_scenario("shared_prefix", 0, FLEET_REQUESTS, args)
        # The kill before the deploy: a restarted replica comes up on the
        # seeded weights (epoch -1), and its journal must have been
        # written by that epoch, not the deploy's.
        legs = {"prefix": _fleet_leg("prefix", sup, serve_net, args, prefix_reqs,
                                     policy="prefix", router_box=router_box)}
        legs["failover"] = _fleet_leg(
            "failover", sup, serve_net, args,
            _fleet_scenario("shared_prefix", 2, FLEET_FAILOVER_REQUESTS, args),
            policy="prefix", kill_at=FLEET_KILL_AT, trace_dir=trace_dir,
            router_box=router_box)
        legs["deploy"] = _fleet_leg(
            "deploy", sup, serve_net, args,
            _fleet_scenario("shared_prefix", 1, FLEET_REQUESTS, args), policy="prefix",
            concurrency=4, deploy=True, router_box=router_box)
        legs["round_robin"] = _fleet_leg("round_robin", sup, serve_net, args, prefix_reqs,
                                         policy="round_robin", router_box=router_box)
    finally:
        sup.stop()
    rows = {k: v["row"] for k, v in legs.items()}
    out["legs"] = rows
    out["replica_start_s"] = starts
    p, rr, dep, fo = rows["prefix"], rows["round_robin"], rows["deploy"], rows["failover"]
    checks = {
        "prefix beats round_robin on prefix-hit tokens":
            p["leg_prefix_hit_tokens"] > rr["leg_prefix_hit_tokens"],
        "prefix routes by prefix": p["router_prefix_routed"] > 0,
        "round_robin routes none by prefix": rr["router_prefix_routed"] == 0,
        "2 deploys, 0 failed, 0 mismatches": (dep["router_deploys_completed"] == 2
                                              and dep["requests_failed"] == 0
                                              and dep["stream_vs_done_mismatches"] == 0),
        "1 restart, 1 breaker open, 1 resume": (fo["replica_restarts"] == 1
                                                and fo["breaker_opens"] == 1
                                                and fo["failover_resumes"] == 1),
        "failover: 0 failed, 0 balance violations": (fo["requests_failed"] == 0
                                                     and fo["balance_violations"] == 0),
        "at most 5 starts": len(starts) <= FLEET_MAX_STARTS,
    }
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fleet_trace.main(["--dir", trace_dir, "-o", os.path.join(work_dir, "merged.json"),
                               "--check-failover", "--slack-ms", "500"])
    out["fleet_trace"] = buf.getvalue().strip().splitlines()
    checks["fleet_trace --check-failover"] = rc == 0
    out["checks"] = checks
    if not all(checks.values()):
        raise SystemExit(f"fleet: failed checks {[k for k, v in checks.items() if not v]}: "
                         f"{out}")

    # The token check: one in-process replica, the same requests one at a time.
    in_args = serve_net.build_parser().parse_args(FLEET_WIDTH)
    eng = serve_net.build_engine(in_args)
    local = {}
    for i, r in enumerate(prefix_reqs):
        eng.submit(r.prompt, max_new_tokens=r.max_new_tokens)
        local[i] = eng.run()[0].tokens.tolist()
    door = {i: list(d["tokens"]) for i, d in enumerate(legs["prefix"]["results"])}
    out["door_vs_in_process"] = _against(eng.model, [r.prompt for r in prefix_reqs], local, door,
                                         range(len(prefix_reqs)), "fleet door vs in-process")
    model = eng.model
    del eng
    out["control_room"] = _control_room(model, in_args, work_dir)
    del model
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[fleet] {out['card']}: GPT-2-small float32, 2 replicas: prefix-hit tokens "
          f"{p['leg_prefix_hit_tokens']} (prefix) against {rr['leg_prefix_hit_tokens']} "
          f"(round_robin); through the door TTFT p50 {p['ttft_p50_ms']:.2f} / "
          f"{rr['ttft_p50_ms']:.2f} ms, {p['tokens_per_s']:.1f} / {rr['tokens_per_s']:.1f} "
          f"tokens/s; deploy leg {dep['router_deploys_completed']} deploys, "
          f"{dep['tokens_per_s']:.1f} tokens/s at concurrency 4; failover "
          f"{fo['replica_restarts']} restart, {fo['breaker_opens']} breaker open, "
          f"{fo['failover_resumes']} resume; replica starts {starts} s; alerts "
          f"{out['control_room']['alerts_fired']} fired, incidents "
          f"{out['control_room']['incidents_captured']}; door vs in-process differing "
          f"{out['door_vs_in_process']['differing']}; phase {out['seconds']:.1f} s", flush=True)
    return out


# Mesh part "resilience" (four cards): GPT-2-small through the GPT CLI's
# trainer as DP 4 at global batch 16 (ZeRO 1), RES_MESH_EPOCHS epochs of
# RES_STEPS steps, a flush every step. The straggler drill: a slow step of
# RES_SLOW_MS every 2nd step on rank 1 alone; every rank's cross-rank view
# must name rank 1. The kill drill: the uninterrupted run twice, then
# SIGTERM at step RES_KILL_STEP on every rank (each rank's own chaos monkey),
# the step-accurate save, the resume at world 4; the losses by the
# continuation rule. The recorder's exchange: each flush's host time of
# TrainObservability.on_flush and, inside it, of the gloo all-gather, on
# each rank, in the first uninterrupted run (no chaos).
RES_MESH_EPOCHS = 3


def _exchange_run(cli, argv: list) -> dict:
    """``build_trainer(argv).fit()`` with each train step timed on the card
    and each ``TrainObservability.on_flush`` and the gloo exchange inside
    it (``aggregate.gather_payloads``) timed on the host; the losses and
    the times in seconds."""
    from distributed_training_tpu_torch.observability import aggregate

    trainer = cli.build_trainer(argv)
    acc: dict = {}
    _time_calls(trainer.obs, ("on_flush",), acc, lambda: True)
    gather, step = aggregate.gather_payloads, trainer.train_step

    def timed_gather(*a, **kw):
        t0 = time.perf_counter()
        try:
            return gather(*a, **kw)
        finally:
            acc.setdefault("gather", []).append(time.perf_counter() - t0)

    def timed_step(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        acc.setdefault("step", []).append(time.perf_counter() - t0)
        return out

    aggregate.gather_payloads, trainer.train_step = timed_gather, timed_step
    try:
        result = trainer.fit()
    finally:
        aggregate.gather_payloads = gather
    run = {"result": result, "losses": [h["loss"] for h in trainer.meter.history],
           "times": acc}
    del trainer
    torch.cuda.empty_cache()
    return run


def resilience_mesh(world: int, ckpt: str, card: str) -> dict:
    """The chaos drills across the ranks (see RES_MESH_EPOCHS)."""
    import torch.distributed as dist

    cli = _gpt_cli_module()
    rank = dist.get_rank()
    # Every rank resumes from the save rank 0 wrote: one directory for all
    # (each rank's mesh_main opened a temporary directory of its own).
    shared = [ckpt]
    dist.broadcast_object_list(shared, src=0)
    ckpt = shared[0]
    argv = [*GPT_CLI_WIDTH, "-b", str(GPT_B // world), "--stage", "1", "-e",
            str(RES_MESH_EPOCHS), "--steps-per-epoch", str(RES_STEPS), "-i", "0",
            "--auto-resume"]
    holder = {}
    slow = _gpt_cli_run(cli, [*argv, "-c", os.path.join(ckpt, "res_slow"),
                              "--chaos-slow-step-every", "2", "--chaos-slow-step-host", "1",
                              "--chaos-slow-step-ms", str(RES_SLOW_MS)],
                        probe=lambda t: holder.update(hosts=t.obs.host_summary,
                                                      slow=t.chaos.counters["slow_steps"]))
    straggler = (holder["hosts"] or {}).get("straggler") or {}
    views = [None] * world
    dist.all_gather_object(views, straggler.get("host"))
    out = {"straggler": {"view": straggler, "every_rank_names": views,
                         "slow_steps_here": holder["slow"], "losses": slow["losses"]}}
    if views != [1] * world:
        raise SystemExit(f"mesh resilience: the straggler views {views}, expected rank 1; "
                         f"{straggler}")
    runs = {"base_a": _exchange_run(cli, [*argv, "-c", os.path.join(ckpt, "res_a")])}
    for name, extra in (("base_b", ["-c", os.path.join(ckpt, "res_b")]),
                        ("killed", ["-c", os.path.join(ckpt, "res_kill"),
                                    "--chaos-kill-at-step", str(RES_KILL_STEP)]),
                        ("resumed", ["-c", os.path.join(ckpt, "res_kill")])):
        r = _gpt_cli_run(cli, [*argv, *extra])
        runs[name] = {"result": r["result"], "losses": r["losses"]}
    total = RES_MESH_EPOCHS * RES_STEPS
    base = [dict(zip(range(1, total + 1), runs[n]["losses"])) for n in ("base_a", "base_b")]
    killed, resumed = runs["killed"], runs["resumed"]
    if not killed["result"]["preempted"] or killed["result"]["steps"] != RES_KILL_STEP:
        raise SystemExit(f"mesh resilience: the SIGTERM run {killed['result']}")
    cont = _continuation("mesh SIGTERM", base, dict(zip(
        range(RES_KILL_STEP + 1, total + 1), resumed["losses"])))
    times = {k: sorted(v) for k, v in runs["base_a"]["times"].items()}
    med = {k: 1e3 * v[len(v) // 2] for k, v in times.items()}
    mine = {"on_flush_ms_median": med["on_flush"], "gather_ms_median": med["gather"],
            "on_flush_ms_max": 1e3 * times["on_flush"][-1], "flushes": len(times["on_flush"]),
            "step_ms_median": med["step"]}
    every = [None] * world
    dist.all_gather_object(every, mine)
    out.update({"kill": {"continuation": cont, "killed": killed["result"],
                         "resumed": resumed["result"]}, "exchange_by_rank": every})
    if rank == 0:
        print(f"[mesh] resilience over {world} GPUs (GPT-2-small, DP {world}, global B {GPT_B}, "
              f"ZeRO 1): straggler view {straggler} on every rank; SIGTERM at step "
              f"{RES_KILL_STEP}: continuation {cont}; the recorder's flush on each rank "
              f"(on_flush / its gloo all-gather, median ms; step ms): "
              f"{[(e['on_flush_ms_median'], e['gather_ms_median'], e['step_ms_median']) for e in every]}"
              f"; {card}", flush=True)
    return out


def exp2_phase() -> dict:
    """Under ``_USE_EXP2``: K2, K3 and K4 against the plain versions (which
    read the switch too) over the grid's bf16 causal cases and at the flash
    bench's shapes, then each timed at the GPT-2-small shape."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    bh, t, d = GPT_B * GPT_H, GPT_T, GPT_D
    fa._USE_EXP2 = True
    try:
        worst = _flash_grid("exp2", gen, (torch.bfloat16,), (True,))
        print("[exp2] K2/K3/K4 vs plain (exp2 too), 9 cases (bf16 causal x d "
              "32,64,128 x T 128,384,1024, non-zero g_lse), worst errors by row "
              "(lse: of its largest magnitude): "
              + ", ".join(f"{n} {e:.3g}" for n, e in sorted(worst.items())))
        _bench_shape_checks("exp2", gen)
        q, k, v, g = (_randn(gen, bh, t, d, dtype=torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, causal=True)
        delta = fa._delta(g, out)
        ms = {"flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, causal=True), 20),
              "flash_bwd": cuda_ms(lambda: fa.flash_bwd(q, k, v, out, lse, g,
                                                        causal=True), 10),
              "flash_bwd_dq": cuda_ms(lambda: fa.flash_bwd_dq(
                  q, k, v, g, lse, delta, causal=True), 10),
              "flash_bwd_dkv": cuda_ms(lambda: fa.flash_bwd_dkv(
                  q, k, v, g, lse, delta, causal=True), 10)}
    finally:
        fa._USE_EXP2 = False
    print(f"[exp2] at BH {bh} T {t} d {d} bf16 causal, ms: "
          + ", ".join(f"{n} {v:.4f}" for n, v in ms.items()))
    del q, k, v, g, out, lse, delta
    torch.cuda.empty_cache()
    return ms


def conv_phase() -> dict:
    """K5 against its plain version on a border-heavy 7 x 9 image (the
    probe's own verify holds it at s0, s1 and s2 in the tools phase), then
    at each probe shape (batch 256) the plain version timed and the bound."""
    from distributed_training_tpu_torch.ops.conv3x3_stats import conv3x3_stats_reference
    from distributed_training_tpu_torch.tools import conv_fusion_probe as probe

    errs = probe.check(*probe.inputs(256, 7, 9, 16, 32, "cuda", seed=3))
    print("[conv] K5 vs plain, [256,7,9,16]->32 bf16 (border-heavy): "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + f" (limits out {probe.OUT_TOL}, sum {probe.SUM_TOL}, sumsq {probe.SUMSQ_TOL})")
    by_shape = {}
    for key, (_, n, h, w, cin, cout) in probe.SHAPES.items():
        x, wts = probe.inputs(n, h, w, cin, cout, "cuda")
        plain = cuda_ms(lambda: conv3x3_stats_reference(x, wts), 3)
        elem = x.element_size()
        outputs = n * h * w * cout
        bound, by = _bound((x.numel() + wts.numel() + outputs) * elem + 2 * cout * 4,
                           {BF16_FLOPS: 18 * cin * outputs, FP32_FLOPS: 3 * outputs})
        by_shape[key] = {"plain_ms": plain, "bound_ms": bound, "bound_by": by,
                         "gflop": 18 * cin * outputs / 1e9}
        print(f"[conv] {key} [{n},{h},{w},{cin}]->{cout} bf16: plain_ms={plain:.4f} "
              f"bound_ms={bound:.4f} ({by})")
        del x, wts
    torch.cuda.empty_cache()
    return by_shape


def tools_phase() -> tuple[dict, dict]:
    """The two tools as a user runs them: the flash bench over its five
    shapes, as it is and with --split-bwd and --exp2, then the conv probe
    over s0, s1 and s2. Each run starts with every kernel count at 0; both
    must verify, and both switches must be back to False afterwards."""
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.ops.conv3x3_stats import conv3x3_stats
    from distributed_training_tpu_torch.tools import conv_fusion_probe, flash_kernel_bench

    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
                "flash_bwd_dq": fa.flash_bwd_dq, "flash_bwd_dkv": fa.flash_bwd_dkv,
                "conv3x3_stats": conv3x3_stats}
    launches, results = {}, {}
    runs = [("flash_kernel_bench", flash_kernel_bench.main, ["--iters", "5"]),
            ("flash_kernel_bench --split-bwd", flash_kernel_bench.main,
             ["--split-bwd", "--iters", "5"]),
            ("flash_kernel_bench --exp2", flash_kernel_bench.main,
             ["--exp2", "--iters", "5"]),
            ("conv_fusion_probe", conv_fusion_probe.main, [])]
    for path, tool_main, argv in runs:
        for fn in counters.values():
            fn.launches = 0
        results[path] = tool_main(argv)
        launches[path] = {name: fn.launches for name, fn in counters.items()
                          if fn.launches}
        print(f"[tools] {path}: {len(results[path])} shapes, launches {launches[path]}")
    if fa._USE_SPLIT_BWD or fa._USE_EXP2:
        raise SystemExit("a tool left a flash switch set")
    want = {"flash_kernel_bench": {"flash_fwd", "flash_bwd"},
            "flash_kernel_bench --split-bwd": {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"},
            "flash_kernel_bench --exp2": {"flash_fwd", "flash_bwd"},
            "conv_fusion_probe": {"conv3x3_stats"}}
    for path, names in want.items():
        if set(launches[path]) != names or len(results[path]) != (
                3 if path == "conv_fusion_probe" else 5):
            raise SystemExit(f"{path}: launches {launches[path]}, {len(results[path])} "
                             f"results; expected launches of {sorted(names)}")
    return launches, results


# Head dims up to 256 (Gemma's width): K2–K4 checked at d 256 and at d 160
# (zero-padded to 256), then timed at BH 48 (batch 4, 12 heads), T 1024,
# d 256, bf16, causal. Above 256 (the kernels that stream d in slabs of 64
# columns): checked at d 257, 320, 384 and 512 in every dtype and at 768 in
# bf16, then timed at BH 24 (batch 2, 12 heads), T 1024, d 512: the
# GPT-2-small shape's elements (24 × 512 = 192 × 64), so its bounds.
D256_B, D256_H, D256_T = 4, 12, 1024
WIDE_DIMS = (257, 320, 384, 512)
D512_B = 2


def _sdpa_backend(q4, k4, v4) -> str:
    """The backend ``F.scaled_dot_product_attention`` dispatched to on
    these inputs (causal): the name of the backend's own aten operator in
    a host-side profile of one call (host events are recorded whether or
    not the profiler can trace the card)."""
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
        torch.cuda.synchronize()
    ops = [e.key for e in prof.key_averages()
           if e.key.startswith("aten::_scaled_dot_product_")
           or e.key.endswith("attention_forward")]
    for kind in ("cudnn", "flash", "efficient", "math"):
        hits = [k for k in ops if kind in k]
        if hits:
            return f"{kind} ({hits[0]})"
    return f"not identified (aten ops {ops})"


def d256_phase() -> dict:
    """The D-256 instantiations: K2, K3, K4a and K4b against their plain
    versions at d 256 and 160, in float32, bf16 and fp16, at a ragged
    (100) and an admissible (384) T, causal and not, with a non-zero lse
    cotangent, under FLASH_TOL; each kernel launched once a case. The d >
    256 kernels the same way at d 257, 320, 384 and 512 (and 768 in bf16),
    K4a's dq the same bit for bit across two launches. Then all four timed
    in bf16 at BH 48, T 1024, d 256 and at BH 24, T 1024, d 512, causal,
    beside their plain versions, SDPA (with the backend it ran) and the
    bound."""
    from distributed_training_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    counters = (fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    for label, dims_of in (("d256", lambda dtype: (160, 256)),
                           ("wide", lambda dtype: WIDE_DIMS + (
                               (768,) if dtype == torch.bfloat16 else ()))):
        worst: dict = {}
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for d in dims_of(dtype):
                for t in (100, 384):
                    for causal in (False, True):
                        n = [f.launches for f in counters]
                        q, k, v, g = (_randn(gen, 4, t, d, dtype=dtype) for _ in range(4))
                        rows, _ = _flash_case(
                            f"{label} {str(dtype)[6:]} d={d} T={t} causal={causal}",
                            q, k, v, g, _randn(gen, 4, t), causal=causal)
                        if [f.launches - m for f, m in zip(counters, n)] != [1, 1, 1, 1]:
                            raise SystemExit(f"d {d}: a flash kernel did not launch once")
                        if label == "wide":
                            out, lse = fa.flash_fwd(q, k, v, causal=causal)
                            delta = fa._delta(g, out)
                            if not torch.equal(
                                    fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal),
                                    fa.flash_bwd_dq(q, k, v, g, lse, delta, causal=causal)):
                                raise SystemExit(f"d {d}: K4a dq differs between launches")
                        for name, err in rows.items():
                            key = f"{str(dtype)[6:]} {name}"
                            worst[key] = max(worst.get(key, 0.0), err)
        dims = ("160 (padded to 256) and 256" if label == "d256" else
                "257, 320, 384, 512 (padded to multiples of 64; 768 in bf16)")
        print(f"[d256] K2/K3/K4 vs plain at d {dims}, float32, bf16 and fp16, T 100 "
              f"and 384, causal and not, worst errors by row (lse: of its largest "
              f"magnitude): " + ", ".join(f"{n} {e:.3g}" for n, e in sorted(worst.items())))
    print("[d256] K4a dq equal bit for bit across two launches at every d above 256")
    result = {}
    for d, batch in ((256, D256_B), (512, D512_B)):
        bh, t = batch * D256_H, D256_T
        q, k, v, g = (_randn(gen, bh, t, d, dtype=torch.bfloat16) for _ in range(4))
        _, abs_errs = _flash_case(f"d{d} timed shape [{bh},{t},{d}]", q, k, v, g, causal=True)
        errs = {"flash_fwd": abs_errs["K2 out"],
                "flash_bwd": max(abs_errs["K3 dq"], abs_errs["K3 dk"], abs_errs["K3 dv"]),
                "flash_bwd_dq": abs_errs["K4a dq"],
                "flash_bwd_dkv": max(abs_errs["K4b dk"], abs_errs["K4b dv"])}
        result[f"d{d}"] = _time_flash(f"d{d}", q, k, v, g, batch, errs)
        backend = _sdpa_backend(*(x.view(batch, D256_H, t, d) for x in (q, k, v)))
        print(f"[d{d}] SDPA at [{batch},{D256_H},{t},{d}] bf16 causal ran the {backend} "
              f"backend")
        for r in result[f"d{d}"].values():
            r["library_backend"] = backend
        del q, k, v, g
        torch.cuda.empty_cache()
    return result


def bf16_image_phase(ckpt_dir: str) -> dict:
    """``Trainer.fit()`` on full-width ResNet-18 in bf16 (20 steps of
    ``hybrid_adam``, batch 100): the loss finite and falling, K1 once a
    step. Then the same with ``ema_decay``: eval goes through the EMA
    weights (``TrainState.ema_weights``), which differ from the live ones."""
    import math

    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        OptimizerConfig,
        PrecisionConfig,
        TrainConfig,
    )
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    steps = 20
    out = {}
    for tag, ema in (("bf16", None), ("bf16_ema", 0.9)):
        cfg = TrainConfig(
            model="resnet18", num_epochs=1, log_interval=5,
            optimizer=OptimizerConfig(name="hybrid_adam", ema_decay=ema),
            precision=PrecisionConfig(dtype="bf16"),
            data=DataConfig(dataset="synthetic_cifar", batch_size=100,
                            max_steps_per_epoch=steps),
            checkpoint=CheckpointConfig(directory=os.path.join(ckpt_dir, tag), interval=0))
        trainer = Trainer(cfg)
        if trainer.model.dtype != torch.bfloat16:
            raise SystemExit("the bf16 Trainer did not build a bf16 model")
        entered = []
        swap = trainer.state.ema_weights
        trainer.state.ema_weights = lambda: (entered.append(1), swap())[1]
        times = _timed_train_epochs(trainer)
        fused_adam_update.launches = 0
        result = trainer.fit()
        launches = fused_adam_update.launches
        losses = [h["loss"] for h in trainer.meter.history]
        print(f"[{tag}] fit -> {result}")
        print(f"[{tag}] logged losses {losses}; {steps} steps in {times[0]:.3f} s, "
              f"{steps * 100 / times[0]:.1f} images/s (first step's cuDNN planning "
              f"included); K1 launches {launches}; EMA eval passes {len(entered)}")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise SystemExit(f"{tag}: the loss is not finite or did not fall: {losses}")
        if launches != steps:
            raise SystemExit(f"{tag}: K1 launches {launches} != {steps} steps")
        if ema is None:
            if entered:
                raise SystemExit("eval went through the EMA without ema_decay")
        else:
            opt = trainer.state.opt_state
            moved = max((opt.ema[n] - p).abs().max().item()
                        for n, p in trainer.model.named_parameters())
            if len(entered) != 1 or moved == 0:
                raise SystemExit(f"EMA eval passes {len(entered)}, EMA vs live {moved}")
            print(f"[{tag}] the EMA weights differ from the live ones by up to {moved:.3g}")
        out[tag] = launches
        del trainer
    torch.cuda.empty_cache()
    return out


# The bench phase's graph check: the image leg and the LM hybrid_adam leg
# at their defaults, one state cloned after make_multi_step's prime and
# capture: GRAPH_REPLAYS replays of the leg's graph of N steps
# (--steps-per-call, 15) against N·GRAPH_REPLAYS eager steps of each clone.
# The continuation rule (RES_CONT_FACTOR): if the two eager runs agree bit
# for bit, the graph must too; else the graph's losses at each replay's
# last step and its parameters lie within RES_CONT_FACTOR times the
# largest gap between the eager runs. K3 adds dQ with float32 atomics and
# cuDNN's backward may too; and the graph computes the learning rate and
# Adam's bias corrections on the card (CUDA's powf) where the eager step
# takes numpy's.
# Two replays: the second reads the count tensor the first advanced (the
# learning rate and Adam's bias corrections at steps N+1..2N).
GRAPH_REPLAYS = 2
# The graphs under a NCCL group (the bench phase's world-1 part, the mesh
# mode's bench part) replay once: they check the collectives in the
# capture, the replays above the continuation.
GRAPH_REPLAYS_NCCL = 1
# Eager steps profiled beside one profiled replay (a trace's processing
# grows with its kernels: two steps give the busy share).
GRAPH_EAGER_PROFILED = 2
# The port's kernels in a profiler trace or a graph's kernel nodes, by
# their (demangled or mangled) names: K1, K2 (bf16 or fp16 fwd_kernel) and
# K3 (bwd_kernel with dq).
TRACE_KERNELS = {
    "fused_adam": r"fused_adam_kernel",
    "flash_fwd": r"flash_wgmma::fwd_kernel<|_ZN11flash_wgmma10fwd_kernel",
    "flash_bwd": r"flash_wgmma::bwd_kernel<.*true>|_ZN11flash_wgmma10bwd_kernel.*Lb1E",
}


def _trace_counts(calls: list, tag: str | None = None) -> dict:
    """``calls`` under ``torch.profiler``: wall ms, the device's busy share
    of it (:func:`_busy_us`), and the port's kernels by
    :data:`TRACE_KERNELS` name; with ``tag`` the kernels by device time
    printed as :func:`_profile` does."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")  # a first event of its own, ahead of the calls'
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for call in calls:
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof)
    counts = {k: sum(c for _, key, c in rows if re.search(pat, key))
              for k, pat in TRACE_KERNELS.items()}
    busy = _busy_us(prof) / wall_us
    if tag is not None:
        print(f"[{tag}] profile of {len(calls)} steps: wall {wall_us / 1e3:.3f} ms "
              f"(profiled), device busy {100 * busy:.1f}% of wall")
        for dev_us, key, count in rows[:12]:
            print(f"[{tag}]   {dev_us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")
    return {"wall_ms": wall_us / 1e3, "busy": busy, "kernels": counts, "rows": len(rows)}


# NCCL's kernels among a graph's kernel nodes (ncclDevKernel_AllReduce_...,
# ncclKernel_...), by their mangled or plain names.
NCCL_KERNEL = re.compile(r"nccl", re.IGNORECASE)


def _graph_census(multi) -> tuple[dict, int, list]:
    """The kernels that each replay of ``multi`` (kept graph) launches: the
    port's by :data:`TRACE_KERNELS` name among its graph's kernel nodes,
    the number of kernel nodes in all, and NCCL's kernel nodes' names."""
    from distributed_training_tpu_torch.train.multi_step import graph_kernels

    with tempfile.TemporaryDirectory() as tmp:
        names = graph_kernels(multi, os.path.join(tmp, "graph.dot"))
    return ({k: sum(1 for x in names if re.search(pat, x)) for k, pat in TRACE_KERNELS.items()},
            len(names), [x for x in names if NCCL_KERNEL.search(x)])


@contextlib.contextmanager
def _groups_shared():
    """While it is entered, a deep copy (a state's clone) shares the
    process groups it meets instead of copying them: a group cannot be
    copied, and the clone's collectives run over the same ranks."""
    import torch.distributed as dist

    pg = type(dist.group.WORLD) if dist.is_initialized() else None
    if pg is not None:
        pg.__deepcopy__ = lambda self, memo: self
    try:
        yield
    finally:
        if pg is not None:
            del pg.__deepcopy__


def _nccl_version() -> str:
    return ".".join(str(x) for x in torch.cuda.nccl.version())


def _max_gap(a: list, b: list) -> float:
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def _graph_vs_eager(tag: str, setup, argv: list, want: dict, min_nccl: int = 0,
                    replays: int = GRAPH_REPLAYS) -> dict:
    """See GRAPH_REPLAYS: ``replays`` replays of the graph of the bench leg
    ``setup`` against eager steps from clones of its state, the host and
    card counts, ms a step both ways (synchronised wall time, and one replay against as many eager
    steps under the profiler: busy share and the port's kernels by name),
    the graph pool and the eager peak memory, and NCCL's kernel nodes in
    the graph (at least ``min_nccl``). Under a process group every rank
    runs it at the same point: the clones share the state's groups."""
    import copy

    from distributed_training_tpu_torch import bench
    from distributed_training_tpu_torch.train.multi_step import make_multi_step

    t_leg = time.perf_counter()
    args = bench.build_parser().parse_args(argv)
    n = args.steps_per_call
    _, state, step, batch = setup(args, torch.device("cuda"))
    multi = make_multi_step(step, state, batch, n, keep_graph=True)
    t_census = time.perf_counter()
    census, nodes, nccl = _graph_census(multi)
    census_s = time.perf_counter() - t_census
    with _groups_shared():
        clones = [copy.deepcopy(state) for _ in range(2)]
    start, count0 = state.step, state.opt_state.count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph_losses = [multi()["loss"].clone() for _ in range(replays)]
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) / (n * replays) * 1e3
    eager, eager_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for clone in clones:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager.append([step(clone, batch)["loss"].detach().clone()
                      for _ in range(n * replays)])
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) / (n * replays) * 1e3)
    eager_peak = torch.cuda.max_memory_allocated()
    params = [list(x.model.parameters()) for x in (state, *clones)]
    gap = {"loss": _max_gap(eager[0], eager[1]), "params": _max_gap(params[1], params[2])}
    err = {"loss": _max_gap(graph_losses, eager[0][n - 1::n]),
           "params": _max_gap(params[0], params[1])}
    branch = "bitwise" if max(gap.values()) == 0.0 else "within_gap"
    ok = all(err[k] <= RES_CONT_FACTOR * gap[k] for k in gap)
    counts = {"host_step": state.step, "host_count": state.opt_state.count,
              "card_count": int(state.opt_state.count_t),
              "eager_card_count": int(clones[0].opt_state.count_t)}
    want_count = count0 + n * replays
    counts_ok = (state.step == start + n * replays
                 and counts["host_count"] == counts["card_count"] == want_count
                 and counts["eager_card_count"] == clones[0].opt_state.count == want_count)
    # A trace can lose a kernel's record on some hosts (one K2 of 180),
    # never gain one: the count is the census, the trace must see each.
    graph_trace = _trace_counts([multi])
    traced_ok = all(0 < c <= census[k] if census[k] else c == 0
                    for k, c in graph_trace["kernels"].items())
    eager_trace = _trace_counts([lambda: step(clones[0], batch)] * GRAPH_EAGER_PROFILED,
                                f"bench {tag} eager")
    out = {"steps_per_call": n, "branch": branch, "gap": gap, "err": err,
           "limit_factor": RES_CONT_FACTOR, "counts": counts, "start": start,
           "graph_ms_per_step": graph_ms, "eager_ms_per_step": eager_ms,
           "graph_busy": graph_trace["busy"], "eager_busy": eager_trace["busy"],
           "graph_profiled_ms_per_step": graph_trace["wall_ms"] / n,
           "eager_profiled_ms_per_step": eager_trace["wall_ms"] / GRAPH_EAGER_PROFILED,
           "graph_kernels": census, "graph_kernel_nodes": nodes, "census_s": census_s,
           "nccl_kernel_nodes": len(nccl), "nccl_kernels": sorted({x[:60] for x in nccl}),
           "replay_kernels": graph_trace["kernels"],
           "eager_kernels": eager_trace["kernels"],
           "graph_pool_gib": multi.pool_bytes / 2**30, "eager_peak_gib": eager_peak / 2**30,
           "losses": {"graph": [float(x) for x in graph_losses],
                      "eager": [[float(x) for x in e[n - 1::n]] for e in eager]}}
    print(f"[bench graph] {tag}: {replays} replay(s) of a graph of {n} steps against "
          f"{n * replays} eager steps from clones: branch {branch}, gaps between the "
          f"eager runs {gap}, graph against eager {err} (limit {RES_CONT_FACTOR} x the gap); "
          f"counts {counts} from step {start}; ms/step graph {graph_ms:.3f}, eager "
          f"{' / '.join(f'{x:.3f}' for x in eager_ms)}; busy graph "
          f"{100 * graph_trace['busy']:.1f}% / eager {100 * eager_trace['busy']:.1f}% "
          f"(profiled, {graph_trace['wall_ms'] / n:.3f} / "
          f"{eager_trace['wall_ms'] / GRAPH_EAGER_PROFILED:.3f} ms/step); kernels in one "
          f"replay {census} (the graph's, of {nodes} kernel nodes, read in {census_s:.1f} s; "
          f"its trace {graph_trace['kernels']}), NCCL's kernel nodes {len(nccl)} "
          f"{out['nccl_kernels']}, in "
          f"{GRAPH_EAGER_PROFILED} eager steps "
          f"{eager_trace['kernels']}; graph pool {out['graph_pool_gib']:.3f} GiB, eager peak "
          f"{out['eager_peak_gib']:.3f} GiB; {card_line()}; "
          f"{time.perf_counter() - t_leg:.1f} s", flush=True)
    if not ok or not counts_ok or census != want or not traced_ok or len(nccl) < min_nccl:
        raise SystemExit(f"bench graph {tag}: {out}; kernels in one replay expected {want}, "
                         f"each seen in its trace and none more often than in the graph, "
                         f"and at least {min_nccl} NCCL kernel node(s)")
    del multi, state, clones, params, step, batch
    torch.cuda.empty_cache()
    return out


def bench_phase() -> dict:
    """The port's bench as a user runs it: a bare run at its defaults (the
    bf16 ResNet-50 leg, then the GPT-2-small AdamW leg; each prints its
    JSON line), then the LM leg with ``--lm-optimizer hybrid_adam``, each
    at the default ``--steps-per-call`` N (15): one CUDA graph of N steps.
    Every kernel count starts at 0 before each run; the wrappers count when
    the graph is captured (and at the priming step), so the LM legs must
    count K2 and K3 12 · (N + 1) times and the hybrid_adam leg K1 N + 1
    times. Each ``value`` and ``mfu`` must be finite and positive, each
    ``mfu`` at most 1, each loss finite. Then the graph check (see
    GRAPH_REPLAYS) on the image leg and the hybrid_adam leg, its replay's
    kernels counted among the graph's kernel nodes: K2 and K3 12 · N
    times, K1 N times on the hybrid_adam leg, each also seen in a
    profiler trace of a replay and never more often; its profile of two eager steps prints
    the kernels by device time (the image leg's default step, and the LM
    leg's with K1 where the default takes AdamW)."""
    import math

    from distributed_training_tpu_torch import bench
    from distributed_training_tpu_torch.ops import flash_attention as fa
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    t_phase = time.perf_counter()
    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
                "fused_adam": fused_adam_update}
    defaults = bench.build_parser().parse_args([])
    n = defaults.steps_per_call
    runs, launches = {}, {}
    for path, argv in (("bench", []), ("bench --lm --lm-optimizer hybrid_adam",
                                       ["--lm", "--lm-optimizer", "hybrid_adam"])):
        for fn in counters.values():
            fn.launches = 0
        runs[path] = bench.main(argv)
        launches[path] = {k: fn.launches for k, fn in counters.items()}
        print(f"[bench] {path}: launches {launches[path]}")
    results = [*runs["bench"], *runs["bench --lm --lm-optimizer hybrid_adam"]]
    for line, loss in results:
        ok = (math.isfinite(line["value"]) and line["value"] > 0 and line["mfu"] is not None
              and math.isfinite(line["mfu"]) and 0 < line["mfu"] <= 1 and math.isfinite(loss)
              and f"steps/call:{n}" in line["metric"])
        if not ok:
            raise SystemExit(f"bench line out of range (loss {loss}): {line}")
    lm = GPT_LAYERS * (n + 1)
    want = {"bench": {"flash_fwd": lm, "flash_bwd": lm, "fused_adam": 0},
            "bench --lm --lm-optimizer hybrid_adam": {"flash_fwd": lm, "flash_bwd": lm,
                                                      "fused_adam": n + 1}}
    if launches != want:
        raise SystemExit(f"bench launches {launches} != {want}")
    print(f"[bench] losses {[round(loss, 4) for _, loss in results]}; image "
          f"{results[0][0]['value']} images/s mfu {results[0][0]['mfu']}, LM AdamW "
          f"{results[1][0]['value']} tokens/s mfu {results[1][0]['mfu']}, LM hybrid_adam "
          f"{results[2][0]['value']} tokens/s mfu {results[2][0]['mfu']}")
    t0 = time.perf_counter()
    print(f"[bench] the bare runs took {t0 - t_phase:.1f} s", flush=True)

    def per_steps(k: int, lm: bool) -> dict:
        return {"fused_adam": k if lm else 0, "flash_fwd": GPT_LAYERS * k if lm else 0,
                "flash_bwd": GPT_LAYERS * k if lm else 0}
    graphs = {"image": _graph_vs_eager("image leg", bench.image_step, [], per_steps(n, False)),
              "lm_hybrid_adam": _graph_vs_eager("LM hybrid_adam leg", bench.lm_step,
                                                ["--lm-optimizer", "hybrid_adam"],
                                                per_steps(n, True))}
    print(f"[bench] the graph checks took {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "graphs": graphs, "nccl": _bench_nccl_world1(per_steps)}


def _bench_nccl_world1(per_steps) -> dict:
    """The bench phase's last part: both legs (the image leg, the LM leg's
    ``hybrid_adam`` with K1, K2 and K3) under a world-1 NCCL group, as the
    DP phase brings one up, each a graph of the default N steps whose
    capture takes the step's collectives on the group (the gradients'
    all-reduce, the LM metrics' mean), held against its eager
    steps (GRAPH_REPLAYS_NCCL), K1–K3 counted exactly in the graph; NCCL's
    kernel nodes printed (at world 1 NCCL may put a copy, or nothing, in
    place of a kernel). Both legs at the bench's defaults: the image leg's
    ms a step read against the check without a group (at world 1 the
    bench keeps each BatchNorm local, so only the gradients' all-reduce
    joins the step)."""
    import torch.distributed as dist

    from distributed_training_tpu_torch import bench
    from distributed_training_tpu_torch.runtime import distributed

    t0 = time.perf_counter()
    n = bench.build_parser().parse_args([]).steps_per_call
    port = _free_port()
    group = distributed.initialize_distributed(
        init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    if group is None or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise SystemExit("bench: the world-1 NCCL group did not come up")
    print(f"[bench nccl] world-1 NCCL group up at tcp://127.0.0.1:{port} (NCCL "
          f"{_nccl_version()}): both legs as graphs of {n} steps with the group's "
          f"collectives inside the capture", flush=True)
    try:
        graphs = {"image": _graph_vs_eager(
                      "image leg, world-1 NCCL", bench.image_step, [], per_steps(n, False),
                      replays=GRAPH_REPLAYS_NCCL),
                  "lm_hybrid_adam": _graph_vs_eager(
                      "LM hybrid_adam leg, world-1 NCCL", bench.lm_step,
                      ["--lm-optimizer", "hybrid_adam"], per_steps(n, True),
                      replays=GRAPH_REPLAYS_NCCL)}
    finally:
        distributed.shutdown_distributed()
    seconds = time.perf_counter() - t0
    print(f"[bench nccl] NCCL {_nccl_version()}: NCCL kernel nodes a graph "
          f"{ {k: g['nccl_kernel_nodes'] for k, g in graphs.items()} }; the part took "
          f"{seconds:.1f} s", flush=True)
    return {"graphs": graphs, "seconds": seconds, "nccl_version": _nccl_version()}


# The vit phase: ViT-B/16 through the port's bench image leg at the JAX
# bench's two ViT configurations (BASELINE.md:35-36): bf16 at batch 256 (2
# x 128 accumulated, the bench's default), and batch 512 with --remat
# (2 x 256); then ViT-B/16's float32 logits on the card against the CPU's,
# within VIT_LOGITS_TOL of their largest magnitude (the ResNet check's 1e-3:
# the same weights and images, products summed in another order).
VIT_RUNS = (("b256", ["--batch-size", "256"]), ("b512_remat", ["--batch-size", "512", "--remat"]))
VIT_LOGITS_TOL = 1e-3


def vit_phase() -> dict:
    """ViT-B/16 (see VIT_RUNS): each bench run's JSON line, its images/s
    and MFU finite with 0 < MFU <= 1, its loss finite, its peak memory;
    then the logits check on a ViT-B/16 whose zero head is replaced by a
    random one (so that the logits carry the whole model)."""
    import copy

    from distributed_training_tpu_torch import bench
    from distributed_training_tpu_torch.models import get_model

    out = {}
    for tag, flags in VIT_RUNS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        (line, loss), = bench.main(["--image", "--model", "vit_b16", *flags])
        peak = (torch.cuda.max_memory_allocated() - start) / 2**30
        ok = (math.isfinite(line["value"]) and line["value"] > 0 and line["mfu"] is not None
              and math.isfinite(line["mfu"]) and 0 < line["mfu"] <= 1 and math.isfinite(loss))
        if not ok:
            raise SystemExit(f"vit {tag}: bench line out of range (loss {loss}): {line}")
        out[tag] = {"images_per_s": line["value"], "mfu": line["mfu"],
                    "step_time_p50_ms": line["step_time_p50_ms"],
                    "step_time_p95_ms": line["step_time_p95_ms"], "peak_gib": peak,
                    "loss": loss, "metric": line["metric"]}
        print(f"[vit] {line['metric']}: {line['value']} images/s, MFU {line['mfu']}, p50 "
              f"{line['step_time_p50_ms']} ms, p95 {line['step_time_p95_ms']} ms, peak "
              f"{peak:.3f} GiB, loss {loss:.4f}", flush=True)
    torch.cuda.empty_cache()
    model = get_model("vit_b16", num_classes=1000, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.kernel.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(1))
    model.eval()
    cpu_model = copy.deepcopy(model)
    x = torch.rand(4, 224, 224, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model.cuda()(x.cuda()).cpu()
        want = cpu_model(x)
    err = (got - want).abs().max().item() / want.abs().max().item()
    print(f"[vit] ViT-B/16 float32 logits card vs CPU: {err:.3g} of the largest "
          f"(tolerance {VIT_LOGITS_TOL})", flush=True)
    if not (got.shape == (4, 1000) and torch.isfinite(got).all() and err <= VIT_LOGITS_TOL):
        raise SystemExit(f"vit logits card vs CPU: {err}")
    out["logits_card_vs_cpu"] = err
    del model, cpu_model
    torch.cuda.empty_cache()
    return out


def _resnet_cli_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_cuda_train", os.path.join(REPO, "resnet", "torch_cuda", "train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def cli_phase(ckpt_dir: str) -> dict:
    """The ResNet CLI (``resnet/torch_cuda/train.py``) as ``run.sh`` calls
    it (``-p torch_ddp_fp16 -c <dir>``), on synthetic CIFAR for one short
    epoch: it must commit every step and save its checkpoint."""
    cli = _resnet_cli_module()
    steps = 10
    out = cli.main(["-p", "torch_ddp_fp16", "-c", ckpt_dir, "-i", "1", "-e", "1",
                    "--dataset", "synthetic_cifar", "--steps-per-epoch", str(steps)])
    if out["steps"] != steps or not os.path.isdir(os.path.join(ckpt_dir, "epoch_0")):
        raise SystemExit(f"the ResNet CLI did not commit {steps} steps and save: {out}")
    print(f"[cli] resnet/torch_cuda/train.py -p torch_ddp_fp16: {out}")
    return out


# The gpt_cli phase: the GPT CLI (gpt/torch_cuda/train.py) at GPT-2-small
# width, GPT_CLI_STEPS steps and one eval (256 sequences, 16 batches) a run.
GPT_CLI_STEPS = 4
GPT_CLI_WIDTH = ["--vocab-size", "50304", "--num-layers", str(GPT_LAYERS),
                 "--num-heads", str(GPT_H), "--hidden-dim", str(GPT_H * GPT_D),
                 "--seq-len", str(GPT_T), "--max-len", str(GPT_T), "-b", str(GPT_B),
                 "--dtype", "bf16", "--attn-impl", "flash", "--no-head-bias",
                 "-e", "1", "--steps-per-epoch", str(GPT_CLI_STEPS), "--log-interval", "1"]
# ZeRO stage 0 against stage 3 at world 1: the same arithmetic, but K3
# adds dQ with atomics in an order that changes from run to run, and bf16
# rounds the activations, so two runs of one config differ in the last
# bits and Adam carries that on: the DP phase's limit for a 16-bit compute
# type (DP_LOSS_RTOL["fp16"]), relative, each step's loss.
GPT_STAGE_RTOL = DP_LOSS_RTOL["fp16"]
# The saved-probabilities CE against the default CE (fp32 logits): the
# same forward, a backward from bf16-rounded probabilities; each step's
# loss within 1e-4 nats. Both with the exact attention: two flash runs of
# one config already differ by up to 1.9e-4 nats at step 4 (K3's dQ
# atomics; H100 80GB HBM3 at 700 W, PERF.md), which would hide the CE's
# own difference.
GPT_SAVE_PROBS_ATOL = 1e-4
# Preempt and resume: GPT-2-small's width at 2 layers and T 256, float32,
# 3 epochs of 8 steps; SIGTERM once step GPT_PREEMPT_AFTER is logged. The
# resumed run's final loss against the uninterrupted run's: float32, but
# K3's dQ and the embedding's backward add with atomics in an order that
# changes from run to run, so rtol 1e-4, not bit for bit.
GPT_PREEMPT_AFTER = 3
GPT_PREEMPT_RTOL = 1e-4
GPT_PREEMPT_ARGS = ["--vocab-size", "50304", "--num-layers", "2", "--num-heads", "12",
                    "--hidden-dim", "768", "--seq-len", "256", "--max-len", "256", "-b", "4",
                    "--dtype", "fp32", "--attn-impl", "flash", "-e", "3",
                    "--steps-per-epoch", "8", "--log-interval", "1", "--auto-resume"]


def _gpt_cli_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gpt_torch_cuda_train", os.path.join(REPO, "gpt", "torch_cuda", "train.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


def _peak_start() -> int:
    """The bytes allocated before a run, its peak counter reset: earlier
    runs' garbage collected first, so that none of it is freed during the
    run and hides the run's own peak."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _gpt_cli_run(cli, argv: list, edit=None, eval_before: bool = False,
                 keep_model: bool = False, probe=None) -> dict:
    """``build_trainer(argv).fit()`` with each train step timed on the card
    (synchronised before and after); its losses, step times, peak memory
    (above what the process held before the run: earlier phases keep some
    tensors alive), eval batches and ZeRO view. ``edit`` maps the CLI's
    config to the one the trainer runs (a field the CLI has no flag for,
    such as the optimizer); ``eval_before`` evaluates once before training
    too (``ppl_before``). With MoE layers, each step's aux loss and each
    layer's kept share of (token, choice) pairs; ``keep_model``: the whole
    model after the run, on the host (every rank must ask for it);
    ``probe(trainer)`` is called after the run."""
    from distributed_training_tpu_torch import LMTrainer
    from distributed_training_tpu_torch.models.moe import MoEMlp

    start = _peak_start()
    if edit is None:
        trainer = cli.build_trainer(argv)
    else:
        args = cli.build_parser().parse_args(argv)
        trainer = LMTrainer(edit(cli.build_config(args)), device=args.device)
    step, times, kept = trainer.train_step, [], []
    moe_layers = [m for m in trainer.model.modules() if isinstance(m, MoEMlp)]

    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if moe_layers:
            kept.append([float(m.kept_share) for m in moe_layers])
        return out

    trainer.train_step = timed
    ppl_before = trainer.evaluate(trainer.make_loaders()[1]) if eval_before else None
    result = trainer.fit()
    rows = trainer.train_gbs
    run = {"result": result, "losses": [h["loss"] for h in trainer.meter.history],
           "aux": [h["aux_loss"] for h in trainer.meter.history], "ppl_before": ppl_before,
           "kept_share": kept, "params": trainer.param_count,
           "step_s": list(times), "peak_bytes": torch.cuda.max_memory_allocated() - start,
           "held_before_bytes": start,
           "eval_batches": len(trainer.make_loaders()[1]),
           "stage": trainer.state.zero.stage, "grouped": trainer.state.zero.group is not None,
           "tokens_per_s": rows * GPT_T * (len(times) - 1) / sum(times[1:]),
           "strategy": trainer.strategy,
           "bubble": getattr(trainer.model, "bubble_fraction", None)}
    if keep_model:
        run["model"] = {n: t.cpu() for n, t in trainer.state.state_dict()["model"].items()}
    if probe is not None:
        probe(trainer)
    del trainer
    torch.cuda.empty_cache()
    return run


def _check_losses(tag: str, losses: list, steps: int) -> None:
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{tag}: expected {steps} finite losses, got {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{tag}: loss did not fall: {losses}")


def _preempt_and_resume(cli, ckpt_dir: str) -> dict:
    """The CLI as a subprocess, sent SIGTERM once it has logged step
    GPT_PREEMPT_AFTER: it must save and exit 0; then the same command
    with ``--auto-resume`` runs to the end, where the committed steps and
    the final loss must be the uninterrupted run's."""
    import json
    import signal
    import subprocess

    straight = cli.main([*GPT_PREEMPT_ARGS, "-c", os.path.join(ckpt_dir, "straight")])
    torch.cuda.empty_cache()
    run_dir, jsonl = os.path.join(ckpt_dir, "preempted"), os.path.join(ckpt_dir, "p.jsonl")
    log_path = os.path.join(ckpt_dir, "preempted.log")
    cmd = [sys.executable, os.path.join(REPO, "gpt", "torch_cuda", "train.py"),
           *GPT_PREEMPT_ARGS, "-c", run_dir, "--metrics-jsonl", jsonl]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        try:
            logged = 0
            while logged < GPT_PREEMPT_AFTER:
                if proc.poll() is not None:
                    raise SystemExit(f"the CLI exited ({proc.returncode}) before step "
                                     f"{GPT_PREEMPT_AFTER}: {open(log_path).read()[-3000:]}")
                if time.perf_counter() - t0 > 240:
                    raise SystemExit("the CLI logged no step in 240 s")
                time.sleep(0.1)
                if os.path.exists(jsonl):
                    with open(jsonl) as fh:
                        steps = [json.loads(x)["step"] for x in fh if '"train"' in x]
                    logged = max(steps, default=0)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=240)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = open(log_path).read()
    saved = [x for x in out.splitlines() if "SIGTERM: saved preemption checkpoint" in x]
    if rc != 0 or not saved or "'preempted': True" not in out:
        raise SystemExit(f"the preempted CLI exited {rc} without its save: {out[-3000:]}")
    resumed = cli.main([*GPT_PREEMPT_ARGS, "-c", run_dir])
    want, got = straight["last_metrics"]["loss"], resumed["last_metrics"]["loss"]
    rel = abs(got - want) / abs(want)
    print(f"[gpt_cli] preempted after step {logged} (SIGTERM sent then): {saved[0].strip()}; "
          f"resumed to {resumed['steps']} steps, final loss {got!r} against the "
          f"uninterrupted run's {want!r} ({straight['steps']} steps): relative "
          f"difference {rel:.3g} (tolerance {GPT_PREEMPT_RTOL})")
    if resumed["steps"] != straight["steps"] or resumed["preempted"]:
        raise SystemExit(f"resumed run committed {resumed['steps']} steps, the "
                         f"uninterrupted one {straight['steps']}")
    _check("preempted-and-resumed final loss vs uninterrupted", rel, GPT_PREEMPT_RTOL)
    return {"signalled_after_step": logged, "save_line": saved[0].strip(),
            "steps": resumed["steps"], "loss": got, "loss_straight": want, "rel_diff": rel}


def gpt_cli_phase(ckpt_dir: str) -> dict:
    """The GPT CLI (``gpt/torch_cuda/train.py``) at GPT-2-small width under
    a world-1 NCCL group: bf16, flash (K2, K3), ZeRO 2, remat, chunked CE
    (256) and a JSONL sink; the loss finite and falling, K2 twice a layer a
    step (forward and remat recompute) plus once a layer an eval batch, K3
    once a layer a step, the JSONL written; tokens/s and peak memory beside
    the same run without remat and the chunked CE (peak memory must be
    lower with them). Then, with fp32 logits, stage 0 against stage 3, and
    the saved-probabilities CE against the default one (exact attention,
    see GPT_SAVE_PROBS_ATOL), each step's loss; then preempt and resume
    (:func:`_preempt_and_resume`)."""
    import json

    import torch.distributed as dist

    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.runtime import distributed

    os.makedirs(ckpt_dir, exist_ok=True)
    cli = _gpt_cli_module()
    port = _free_port()
    distributed.initialize_distributed(init_method=f"tcp://127.0.0.1:{port}",
                                       world_size=1, rank=0)
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise SystemExit("the world-1 NCCL group did not come up")
    try:
        jsonl = os.path.join(ckpt_dir, "gpt2_small.jsonl")
        flash_fwd.launches = flash_bwd.launches = 0
        launches, counted = {}, {}

        def count_one_more(trainer):
            # The fit's launches, then one more step, its collectives counted.
            launches.update(flash_fwd=flash_fwd.launches, flash_bwd=flash_bwd.launches)
            loader = trainer.make_loaders()[0]
            loader.set_epoch(0)
            counted.update(counted_step(trainer, trainer.place(next(iter(loader))),
                                        "gpt_cli GPT-2-small (bf16, flash, remat, ce_chunk 256)"))

        chunked = _gpt_cli_run(cli, [*GPT_CLI_WIDTH, "--stage", "2", "--remat",
                                  "--ce-chunk-size", "256", "--metrics-jsonl", jsonl,
                                  "-c", os.path.join(ckpt_dir, "main")], probe=count_one_more)
        want = {"flash_fwd": GPT_LAYERS * (2 * GPT_CLI_STEPS + chunked["eval_batches"]),
                "flash_bwd": GPT_LAYERS * GPT_CLI_STEPS}
        with open(jsonl) as fh:
            lines = [json.loads(x) for x in fh]
        print(f"[gpt_cli] GPT-2-small (bf16, flash, ZeRO {chunked['stage']} in the NCCL "
              f"group {chunked['grouped']}, remat, ce_chunk 256), {GPT_CLI_STEPS} steps: losses "
              f"{chunked['losses']}; K2 launches {launches['flash_fwd']} (want "
              f"{want['flash_fwd']}: 2 a layer a step, 1 a layer an eval batch), K3 "
              f"{launches['flash_bwd']} (want {want['flash_bwd']}); JSONL lines "
              f"{[(x['prefix'], x['step']) for x in lines]}; eval perplexity "
              f"{chunked['result']['final_perplexity']:.4f}")
        _check_losses("gpt_cli", chunked["losses"], GPT_CLI_STEPS)
        if not chunked["grouped"] or chunked["stage"] != 2:
            raise SystemExit("the GPT CLI's trainer did not join the group at stage 2")
        if launches != want:
            raise SystemExit(f"gpt_cli launches {launches}, want {want}")
        if ([(x["prefix"], x["step"]) for x in lines]
                != [("train", i + 1) for i in range(GPT_CLI_STEPS)]
                + [("eval", GPT_CLI_STEPS)]):
            raise SystemExit(f"gpt_cli JSONL lines: {lines}")
        base = _gpt_cli_run(cli, [*GPT_CLI_WIDTH, "--stage", "2",
                                  "-c", os.path.join(ckpt_dir, "base")])
        _check_losses("gpt_cli without remat", base["losses"], GPT_CLI_STEPS)
        for tag, r in (("remat + ce_chunk 256", chunked), ("neither", base)):
            print(f"[gpt_cli] {tag}: {r['tokens_per_s']:.1f} tokens/s (steps 2-"
                  f"{GPT_CLI_STEPS}, {1e3 * sum(r['step_s'][1:]) / (GPT_CLI_STEPS - 1):.3f} "
                  f"ms a step), peak memory {r['peak_bytes'] / 2**30:.3f} GiB above the "
                  f"{r['held_before_bytes'] / 2**30:.3f} GiB held before the run")
        if not chunked["peak_bytes"] < base["peak_bytes"]:
            raise SystemExit(f"peak memory with remat and the chunked CE "
                             f"{chunked['peak_bytes']} is not below {base['peak_bytes']}")
        fp32_logits = [*GPT_CLI_WIDTH, "--logits-dtype", "fp32"]
        exact = [a if a != "flash" else "exact" for a in fp32_logits]
        runs = {name: _gpt_cli_run(cli, [*argv, *extra, "-c", os.path.join(ckpt_dir, name)])
                for name, argv, extra in (
                    ("s0", fp32_logits, ["--stage", "0"]),
                    ("s3", fp32_logits, ["--stage", "3"]),
                    ("exact_ce", exact, ["--stage", "0"]),
                    ("exact_save_probs", exact, ["--stage", "0", "--ce-save-probs"]))}
        for name, r in runs.items():
            _check_losses(f"gpt_cli {name}", r["losses"], GPT_CLI_STEPS)
        stage_diff = max(abs(a - b) / abs(b) for a, b in zip(runs["s3"]["losses"],
                                                               runs["s0"]["losses"]))
        stage_nats = max(abs(a - b) for a, b in zip(runs["s3"]["losses"],
                                                    runs["s0"]["losses"]))
        ce_diff = max(abs(a - b) for a, b in zip(runs["exact_save_probs"]["losses"],
                                                 runs["exact_ce"]["losses"]))
        print(f"[gpt_cli] fp32 logits, losses: stage 0 {runs['s0']['losses']}, stage 3 "
              f"{runs['s3']['losses']} (largest relative difference {stage_diff:.3g}, "
              f"{stage_nats:.3g} nats; tolerance {GPT_STAGE_RTOL} relative); exact "
              f"attention, default CE {runs['exact_ce']['losses']}, saved-probabilities "
              f"CE {runs['exact_save_probs']['losses']} (largest difference "
              f"{ce_diff:.3g} nats, tolerance {GPT_SAVE_PROBS_ATOL}); tokens/s "
              + ", ".join(f"{n} {r['tokens_per_s']:.1f}" for n, r in runs.items())
              + "; peak GiB "
              + ", ".join(f"{n} {r['peak_bytes'] / 2**30:.3f}" for n, r in runs.items()))
        _check("gpt_cli stage 3 vs stage 0 loss", stage_diff, GPT_STAGE_RTOL)
        _check("gpt_cli saved-probabilities CE vs default", ce_diff, GPT_SAVE_PROBS_ATOL)
    finally:
        distributed.shutdown_distributed()
    preempt = _preempt_and_resume(cli, ckpt_dir)
    return {"launches": launches, "chunked": chunked, "base": base, "runs": runs,
            "preempt": preempt, "collectives": counted}


# The MoE phases. The LM: the GPT CLI's --moe at the JAX CLI's defaults
# (8 experts at every 2nd layer, top-1, capacity factor 1.25) at
# GPT-2-small width, B 16 T 1024, bf16, flash, hybrid_adam (the CLI has no
# optimizer flag: the config is edited), an eval, MOE_LM_STEPS steps and an
# eval; then top-2 with --mlp-type residual; beside the dense model of the
# same flags. The fall is judged on the eval CE before and after, as in
# the LM phase: the train batches differ from step to step by about as
# much as the steps lower the loss. One MoE layer at that width (d 768, h 3072, 8 experts, top-1) on
# MOE_LAYER_TOKENS tokens in float32 (TF32 off), forward and backward: the
# card against the CPU, each output's largest error over its largest
# magnitude within MOE_LAYER_RTOL.
MOE_LM_STEPS = 8
MOE_LAYER_TOKENS = 2048
MOE_LAYER_RTOL = 1e-5
# The image: the ResNet CLI's --moe --num-experts 4 (moe_mlp) on synthetic
# CIFAR, batch 100, MOE_IMAGE_STEPS steps of hybrid_adam; the trained
# model's logits on the card against the CPU within MOE_IMAGE_LOGITS_RTOL
# of their largest magnitude.
MOE_IMAGE_STEPS = 20
MOE_IMAGE_LOGITS_RTOL = 1e-3


def _hybrid_adam(cfg):
    import dataclasses

    return cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, name="hybrid_adam"))


def _moe_layer_check() -> dict:
    """One GPT-2-small-width MoE layer, float32, the card against the CPU:
    output, aux loss, the input's and the router's gradients."""
    import copy

    from distributed_training_tpu_torch.models.moe import MoEMlp

    gen = torch.Generator().manual_seed(0)
    d = GPT_H * GPT_D
    layer = MoEMlp(d, 8, 4 * d, generator=gen)
    x = torch.randn(MOE_LAYER_TOKENS // GPT_T, GPT_T, d, generator=gen)
    g = torch.randn(x.shape, generator=gen)

    def run(m, x, g):
        x = x.clone().requires_grad_()
        out, aux = m(x, True)
        ((out * g).sum() + aux).backward()
        return {"out": out.detach(), "aux": aux.detach(), "dx": x.grad,
                "d_router": m.gate.router.kernel.grad, "kept": m.kept_share}

    want = run(layer, x, g)
    got = run(copy.deepcopy(layer).cuda(), x.cuda(), g.cuda())
    errs = {k: _rel_err(got[k].cpu(), want[k]) for k in ("out", "aux", "dx", "d_router")}
    for k, e in errs.items():
        _check(f"MoE layer {k}, card vs CPU", e, MOE_LAYER_RTOL)
    print(f"[moe] one MoE layer (d {d}, h {4 * d}, 8 experts, top-1, capacity factor "
          f"1.25, {MOE_LAYER_TOKENS} tokens, float32), card vs CPU, largest error over "
          f"largest magnitude: " + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
          + f" (tolerance {MOE_LAYER_RTOL}); kept share card {float(got['kept']):.4f}, "
          f"CPU {float(want['kept']):.4f}")
    return errs


def moe_lm_phase(ckpt_dir: str) -> dict:
    """GPT-2-small with MoE through the GPT CLI's trainer (see
    MOE_LM_STEPS): the dense model, top-1 and top-2 residual; losses finite
    and falling, aux finite and positive, K2 once a layer a step and an
    eval batch, K3 once a layer a step, K1 once a step; tokens/s, ms a
    step, peak memory and each MoE layer's kept share; then one MoE layer
    on the card against the CPU."""
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    cli = _gpt_cli_module()
    card = card_line()
    runs = {}
    for name, extra in (("dense", []), ("moe_top1", ["--moe"]),
                        ("moe_top2_residual", ["--moe", "--top-k", "2",
                                               "--mlp-type", "residual"])):
        for fn in (flash_fwd, flash_bwd, fused_adam_update):
            fn.launches = 0
        run = _gpt_cli_run(cli, [*GPT_CLI_WIDTH, "--steps-per-epoch", str(MOE_LM_STEPS),
                                 *extra, "-c", os.path.join(ckpt_dir, name)], _hybrid_adam,
                           eval_before=True)
        launches = {"flash_fwd": flash_fwd.launches, "flash_bwd": flash_bwd.launches,
                    "fused_adam": fused_adam_update.launches}
        want = {"flash_fwd": GPT_LAYERS * (MOE_LM_STEPS + 2 * run["eval_batches"]),
                "flash_bwd": GPT_LAYERS * MOE_LM_STEPS, "fused_adam": MOE_LM_STEPS}
        kept = run["kept_share"]
        ms = 1e3 * sum(run["step_s"][1:]) / (MOE_LM_STEPS - 1)
        ce = (math.log(run["ppl_before"]), math.log(run["result"]["final_perplexity"]))
        print(f"[moe] GPT-2-small {name} ({run['params']:,} parameters; B {GPT_B} T {GPT_T}, "
              f"bf16, flash, hybrid_adam), {MOE_LM_STEPS} steps: losses {run['losses']}; "
              f"eval CE {ce[0]:.6f} before, {ce[1]:.6f} after; aux {run['aux']}; "
              f"{run['tokens_per_s']:.1f} tokens/s, {ms:.3f} ms a step "
              f"(steps 2-{MOE_LM_STEPS}), peak {run['peak_bytes'] / 2**30:.3f} GiB above "
              f"the {run['held_before_bytes'] / 2**30:.3f} GiB held before; kept share by "
              f"MoE layer, step 1 {[round(k, 4) for k in kept[0]] if kept else []}, step "
              f"{MOE_LM_STEPS} {[round(k, 4) for k in kept[-1]] if kept else []}; launches "
              f"{launches} (want {want}); {card}")
        if not all(math.isfinite(x) for x in run["losses"]) or not ce[1] < ce[0]:
            raise SystemExit(f"moe {name}: losses {run['losses']} not finite, or the eval "
                             f"CE did not fall: {ce}")
        if launches != want:
            raise SystemExit(f"moe {name}: launches {launches}, want {want}")
        if name != "dense" and not all(math.isfinite(a) and a > 0 for a in run["aux"]):
            raise SystemExit(f"moe {name}: aux loss {run['aux']} not finite and positive")
        runs[name] = {"params": run["params"], "losses": run["losses"], "aux": run["aux"],
                      "tokens_per_s": run["tokens_per_s"], "step_ms": ms,
                      "peak_gib": run["peak_bytes"] / 2**30, "kept_share": kept,
                      "launches": launches, "eval_ce": ce}
        torch.cuda.empty_cache()
    layer = _moe_layer_check()
    return {"runs": runs, "layer": layer,
            "launches": {k: sum(r["launches"][k] for r in runs.values())
                         for k in ("flash_fwd", "flash_bwd", "fused_adam")}}


def moe_image_phase(ckpt_dir: str) -> dict:
    """The ResNet CLI's ``--moe --num-experts 4`` (see MOE_IMAGE_STEPS):
    losses falling, K1 once a step, then the trained model's logits on the
    card against the CPU."""
    import copy

    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.data.pipeline import to_device
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update
    from distributed_training_tpu_torch.train.step import _input_images

    cli = _resnet_cli_module()
    args = cli.build_parser().parse_args([
        "--moe", "--num-experts", "4", "--dataset", "synthetic_cifar", "-b", "100",
        "-e", "1", "--steps-per-epoch", str(MOE_IMAGE_STEPS), "--optimizer", "hybrid_adam",
        "--log-interval", "1", "-c", ckpt_dir])
    trainer = Trainer(cli.build_config(args))
    times = _timed_train_epochs(trainer)
    fused_adam_update.launches = 0
    out = trainer.fit()
    launches = fused_adam_update.launches
    losses = [h["loss"] for h in trainer.meter.history]
    _, eval_loader = trainer.make_loaders()
    batch = to_device(next(iter(eval_loader)), trainer.device)
    model = trainer.model.eval()
    with torch.no_grad():
        images = _input_images(batch, trainer.input_affine)
        got = model(images)
        want = copy.deepcopy(model).cpu()(images.cpu())
    err = _rel_err(got.cpu(), want)
    print(f"[moe image] resnet/torch_cuda/train.py --moe --num-experts 4 -> moe_mlp "
          f"({sum(p.numel() for p in model.parameters()):,} parameters), synthetic CIFAR, "
          f"batch 100, {MOE_IMAGE_STEPS} steps of hybrid_adam: losses {losses}; K1 "
          f"launches {launches}; epoch {times[0]:.3f} s; top-1 {out['final_acc']}; logits "
          f"card vs CPU {err:.3g} of the largest (tolerance {MOE_IMAGE_LOGITS_RTOL})")
    _check_losses("moe image", losses, MOE_IMAGE_STEPS)
    if launches != MOE_IMAGE_STEPS:
        raise SystemExit(f"moe image: K1 launches {launches} != {MOE_IMAGE_STEPS} steps")
    _check("moe image logits, card vs CPU", err, MOE_IMAGE_LOGITS_RTOL)
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "logits_rel_err": err}


# Each kernel's time on CUDA cores, before its tensor-core redesign, at
# the path's shape on an H100 80GB HBM3 at 700 W (PERF.md's kernel table):
# K2, K3, K4a and K4b at the GPT-2-small shape, K5 at the probe's shapes.
CUDA_CORE_MS = {"flash_fwd": 0.9222, "flash_bwd": 3.1057, "flash_bwd_dkv": 2.1614,
                "flash_bwd_dq": 1.3209, "conv3x3_stats s0": 1.8435,
                "conv3x3_stats s1": 2.3699, "conv3x3_stats s2": 2.3936}


def _before(name: str, ms: float) -> str:
    """The time before the tensor-core redesign and the speed-up since."""
    if name not in CUDA_CORE_MS:
        return ""
    old = CUDA_CORE_MS[name]
    return f"; before the tensor-core redesign {old:.4f} ms, {old / ms:.2f}x"


# The tensor-core kernels, as ptxas and cuobjdump name them: K2's
# flash_wgmma::fwd_kernel<T, D>, K3's and K4b's bwd_kernel<T, D, true /
# false>, K4a's dq_kernel<T, D> and K5's conv_wgmma::conv_kernel<T, NC>, T
# __nv_bfloat16 or __half. (library, the mangled name's pattern, the
# kernel's name, the index of its shared-memory query or None for K5's.)
_T = r"(13__nv_bfloat16|6__half)"
WGMMA_KERNELS = (
    ("flash_attention", rf"_ZN11flash_wgmma10fwd_kernelI{_T}Li(\d+)E", "K2 fwd_kernel", 0),
    ("flash_attention", rf"_ZN11flash_wgmma10bwd_kernelI{_T}Li(\d+)ELb1E",
     "K3 bwd_kernel(dq)", 1),
    ("flash_attention_split", rf"_ZN11flash_wgmma10bwd_kernelI{_T}Li(\d+)ELb0E",
     "K4b bwd_kernel", 2),
    ("flash_attention_split", rf"_ZN11flash_wgmma9dq_kernelI{_T}Li(\d+)E", "K4a dq_kernel", 3),
    ("conv3x3_stats", rf"_ZN10conv_wgmma11conv_kernelI{_T}Li(\d+)E", "K5 conv_kernel", None),
    # The d > 256 kernels take d at run time: one instantiation a type.
    ("flash_attention", rf"_ZN11flash_wgmma15fwd_wide_kernelI{_T}E", "K2 fwd_wide_kernel", 0),
    ("flash_attention", rf"_ZN11flash_wgmma15bwd_wide_kernelI{_T}Lb1E",
     "K3 bwd_wide_kernel(dq)", 1),
    ("flash_attention_split", rf"_ZN11flash_wgmma15bwd_wide_kernelI{_T}Lb0E",
     "K4b bwd_wide_kernel", 2),
    ("flash_attention_split", rf"_ZN11flash_wgmma14dq_wide_kernelI{_T}E",
     "K4a dq_wide_kernel", 3),
)
# 22 instantiations in each of the two types: K2, K3, K4b and K4a at d 32,
# 64, 128 and 256 and above 256 ("wide"), K5 at 32 and 64 output channels a
# block.
WGMMA_INSTANTIATIONS = 44


def _sass_by_function(lib: str) -> dict:
    """cuobjdump's SASS of one built library, by mangled function name."""
    import subprocess

    from distributed_training_tpu_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cuda_build._target(lib)], check=True,
                          capture_output=True, text=True).stdout
    return {part.split(None, 1)[0]: part for part in sass.split("Function : ")[1:]}


def wgmma_build_lines() -> dict:
    """Per tensor-core instantiation (bf16 and fp16): the HGMMA
    instructions in its SASS and, when this run built the libraries,
    ptxas's registers and spills, and the launch's dynamic shared memory.
    Fails unless all 44 are there (K2, K3, K4b, K4a at d 32, 64, 128, 256
    and above 256; K5 at 32 and 64 output channels a block; each in both
    types), each with HGMMA (the proof that it reaches the tensor cores),
    and on a spill at d 64 (the GPT path), above 256 or in K5."""
    import ctypes

    from distributed_training_tpu_torch.ops import conv3x3_stats as conv
    from distributed_training_tpu_torch.ops import cuda_build
    from distributed_training_tpu_torch.ops import flash_attention as fa

    flash = fa._lib()
    flash.flash_wgmma_smem_bytes.restype = ctypes.c_int
    flash.flash_wgmma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib5 = conv._lib()
    lib5.conv3x3_stats_wgmma_smem_bytes.restype = ctypes.c_int
    lib5.conv3x3_stats_wgmma_smem_bytes.argtypes = [ctypes.c_int]
    sass = {lib: _sass_by_function(lib) for lib in {k[0] for k in WGMMA_KERNELS}}
    ptxas = {}  # mangled name -> ptxas's lines for it, from this run's builds
    for log in cuda_build.build_logs.values():
        for entry in re.split(r"Compiling entry function", log)[1:]:
            ptxas[re.match(r" '(\w+)'", entry).group(1)] = entry
    if not ptxas:
        print("[build] wgmma: the libraries were built before this run; no ptxas "
              "output to read (remove distributed_training_tpu_torch/_build for it)")
    seen = {}
    for lib, pattern, name, smem_kind in WGMMA_KERNELS:
        for mangled, code in sass[lib].items():
            m = re.match(pattern, mangled)
            if not m:
                continue
            dtype = "bf16" if "bfloat16" in m.group(1) else "fp16"
            width = int(m.group(2)) if m.re.groups >= 2 else "wide"
            smem = (lib5.conv3x3_stats_wgmma_smem_bytes(width) if smem_kind is None
                    else flash.flash_wgmma_smem_bytes(smem_kind,
                                                      512 if width == "wide" else width))
            line = (f"[build] wgmma {name} {dtype} {'nc' if smem_kind is None else 'd'} "
                    f"{width} ({lib}): {code.count('HGMMA')} HGMMA in its SASS, dynamic "
                    f"shared memory {smem} B")
            spills = 0
            if mangled in ptxas:
                regs = int(re.search(r"Used (\d+) registers", ptxas[mangled]).group(1))
                stores, loads = map(int, re.search(r"(\d+) bytes spill stores, "
                                                   r"(\d+) bytes spill loads",
                                                   ptxas[mangled]).groups())
                spills = stores + loads
                line += f", {regs} registers, spill stores {stores} B, spill loads {loads} B"
            print(line)
            seen[(name, dtype, width)] = (spills, code.count("HGMMA"))
    if len(seen) != WGMMA_INSTANTIATIONS:
        raise SystemExit(f"expected {WGMMA_INSTANTIATIONS} tensor-core instantiations "
                         f"in the SASS, found {sorted(seen)}")
    if [k for k, (_, hgmma) in seen.items() if not hgmma]:
        raise SystemExit(f"no HGMMA in the SASS of {[k for k, v in seen.items() if not v[1]]}")
    if any(spills for (name, _, width), (spills, _) in seen.items()
           if width in (64, "wide") or name.startswith("K5")):
        raise SystemExit("a tensor-core instantiation spills at d 64, above 256 or in K5")
    print(f"[build] wgmma: {len(seen)} tensor-core instantiations (bf16 and fp16), "
          f"every one with HGMMA in its SASS")
    return seen


# The data phase: the host input pipeline, on the card machine's host.
# Native against numpy: a batch of DATA_CROPS crops at 224 from 257²
# uint8 images. The trained runs: full-width ResNet-50 (imagenet stem, 224,
# bf16, hybrid_adam) over a decoded cache of a JPEG tree of DATA_CLASSES
# classes × DATA_PER_CLASS images (256², quality 85; val a quarter of
# that), DATA_EPOCHS epochs of DATA_STEPS steps of batch DATA_BATCH, at
# prefetch 0 and 2. Cut in depth for the script's time (96 images a class
# and 20 steps an epoch until the bench phase's graph check came): every
# check stays.
DATA_CROPS = 256
# At 6 steps the profiled epoch's trace held 4 of its 12 pinned copies and
# the stream check (at least one a step) failed; at 10 it holds enough.
DATA_CLASSES, DATA_PER_CLASS, DATA_BATCH, DATA_STEPS, DATA_EPOCHS = 8, 48, 32, 10, 3
# The image leg with remat and the conv policy, beside the default leg:
# cut to REMAT_STEPS timed eager steps after REMAT_WARMUP (the default leg's
# full run is in the bench phase), which the lines say (3 and 15 before the
# same cut).
REMAT_WARMUP, REMAT_STEPS = 1, 4
# The two data benches, cut in depth from their defaults (2048 JPEGs; 5
# warm-up and 45 timed steps) for the same reason.
DATA_BENCH_CUT = {"data_only": ["--data-images", "512"],
                  "data_concurrent": ["--data-images", "1024", "--warmup", "1",
                                      "--steps", "10"]}


def _native_check() -> dict:
    """The native library is built on this host and each of its three
    routines gives the numpy path's bytes on DATA_CROPS crops at 224 from
    257² images (``-march=native`` decides the host's FMA contraction; the
    library's conversion is a written-out fused multiply-add, which the
    numpy path reproduces)."""
    import numpy as np

    from distributed_training_tpu_torch.data import transforms
    from distributed_training_tpu_torch.ops.native import native

    t0 = time.perf_counter()
    if not native.available():
        raise SystemExit(f"the native augment library did not build: {native.build_log}")
    print(f"[data] native library {native._target()} available in "
          f"{time.perf_counter() - t0:.2f} s, g++ flags {' '.join(native.built_with)}"
          f"{'' if native.built_with else '(built earlier in this checkout)'}")
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (DATA_CROPS, 257, 257, 3), dtype=np.uint8)
    n, size = DATA_CROPS, 224
    ys, xs = rng.randint(0, 257 - size + 1, n), rng.randint(0, 257 - size + 1, n)
    flips = rng.randint(0, 2, n)
    crops = native.gather_crop_flip(images, np.arange(n), ys, xs, flips, size)
    want = np.stack([images[i, y:y + size, x:x + size][:, ::-1 if f else 1]
                     for i, y, x, f in zip(range(n), ys, xs, flips)])
    out = {"gather_crop_flip": bool(np.array_equal(crops, want))}
    out["pad_crop_flip"] = bool(np.array_equal(
        transforms.pad_crop_flip(crops, np.random.RandomState(1), use_native=True),
        transforms.pad_crop_flip(crops, np.random.RandomState(1), use_native=False)))
    for name, (scale, bias) in (("to_float", (1 / 255, 0.0)), ("to_normalized", (2 / 255, -1.0))):
        out[f"u8_to_f32 {name}"] = bool(np.array_equal(
            transforms.u8_to_f32(crops, scale, bias, use_native=True),
            transforms.u8_to_f32(crops, scale, bias, use_native=False)))
    print(f"[data] native vs numpy, bit for bit, {n} crops at {size} from 257² images: {out}")
    if not all(out.values()):
        raise SystemExit(f"the native path differs from the numpy path: {out}")
    return out


def _trace_streams(prof) -> dict:
    """The card streams of the profile's pinned host-to-device copies and
    of its kernels, from its trace."""
    with tempfile.NamedTemporaryFile(suffix=".json") as fh:
        prof.export_chrome_trace(fh.name)
        with open(fh.name) as f:
            events = json.load(f).get("traceEvents", [])
    pinned_h2d, kernels = [], set()
    for e in events:
        stream = (e.get("args") or {}).get("stream", e.get("tid"))
        if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "") \
                and "Pinned" in e.get("name", ""):
            pinned_h2d.append(stream)
        elif e.get("cat") == "kernel":
            kernels.add(stream)
    return {"pinned_h2d": pinned_h2d, "kernels": kernels}


def _data_fit(root: str, ckpt_dir: str, prefetch: int) -> dict:
    """``Trainer.fit()`` on ResNet-50 over the tree's decoded cache at
    ``prefetch``, DATA_EPOCHS epochs of DATA_STEPS steps: the batches the
    step received (copied on the card as it received them), the losses,
    K1's launches; ms/step of the second epoch (synchronised wall time),
    the device's busy share of the third (profiled: its wall time grows
    by the profiler's host cost), and the streams of its copies and
    kernels."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.config import (
        CheckpointConfig,
        DataConfig,
        OptimizerConfig,
        PrecisionConfig,
        TrainConfig,
    )
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    cfg = TrainConfig(
        model="resnet50", num_epochs=DATA_EPOCHS, log_interval=1, seed=0,
        optimizer=OptimizerConfig(name="hybrid_adam"), precision=PrecisionConfig(dtype="bf16"),
        data=DataConfig(dataset="imagefolder", data_path=root, decoded_cache=True,
                        num_classes=DATA_CLASSES, image_size=224, batch_size=DATA_BATCH,
                        max_steps_per_epoch=DATA_STEPS, num_workers=os.cpu_count() or 8,
                        prefetch=prefetch),
        checkpoint=CheckpointConfig(directory=ckpt_dir, interval=0))
    trainer = Trainer(cfg)
    if trainer.model.stem != "imagenet" or trainer.model.dtype != torch.bfloat16:
        raise SystemExit("the data phase's ResNet-50 is not the imagenet-stem bf16 model")
    seen = []
    step = trainer.train_step

    def recording(state, batch):
        # A copy on the step's stream, queued before the step: the batch as
        # the step reads it (no host synchronisation).
        seen.append({k: v.clone() for k, v in batch.items()})
        return step(state, batch)

    trainer.train_step = recording
    inner, timed = trainer.train_epoch, {}

    def epoch(index, *a, **kw):
        if index == 0:  # warm-up: cuDNN's planning, the cache's pages
            return inner(index, *a, **kw)
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
              if index == 2 else contextlib.nullcontext()) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(index, *a, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if index == 1:
            timed["ms_per_step"] = wall / DATA_STEPS * 1e3
        else:
            timed["busy"] = _busy_us(prof) / 1e6 / wall
            timed.update(_trace_streams(prof))
        return out

    trainer.train_epoch = epoch
    fused_adam_update.launches = 0
    result = trainer.fit()
    launches = fused_adam_update.launches
    losses = [h["loss"] for h in trainer.meter.history]
    del trainer
    batches = [{k: v.cpu().numpy() for k, v in b.items()} for b in seen]
    del seen
    torch.cuda.empty_cache()
    return {"batches": batches, "losses": losses, "launches": launches, "result": result,
            "ms_per_step": timed["ms_per_step"], "busy": timed["busy"],
            "pinned_h2d": timed["pinned_h2d"], "kernel_streams": timed["kernels"]}


def data_phase(ckpt_dir: str) -> dict:
    """The input pipeline on the card's host and through the trainer and
    the bench (see the module docstring, phase 10c). Returns K1's launches
    by path and the readings."""
    import importlib.util
    import math
    import shutil

    import numpy as np

    from distributed_training_tpu_torch import bench
    from distributed_training_tpu_torch.ops.native import native

    t_phase = time.perf_counter()
    # What else holds the host: this process's threads and its CPU time
    # over a second of sleep (a spinning thread left by an earlier phase
    # would show), and the load average of the machine.
    before = os.times()
    time.sleep(1.0)
    after = os.times()
    spin = (after.user + after.system) - (before.user + before.system)
    names = sorted(t.name for t in threading.enumerate())
    print(f"[data] host before the phase: {len(names)} threads {names}; this process's "
          f"CPU time over 1 s asleep {spin:.3f} s; load average {os.getloadavg()}")
    checks = _native_check()
    # The phase writes and decodes real JPEG trees: it needs Pillow, and
    # fails without it.
    spec = importlib.util.find_spec("PIL")
    if spec is None:
        raise SystemExit("Pillow is not installed: the data phase writes and decodes JPEG trees")
    import PIL

    print(f"[data] Pillow {PIL.__version__}: real JPEG trees, live decode and the decoded cache")

    runs = {}
    for path, argv in (("bench --data-only --data-mode both", ["--data-only", "--data-mode", "both",
                                                               *DATA_BENCH_CUT["data_only"]]),
                       ("bench --data-concurrent --data-stress",
                        ["--data-concurrent", "--data-stress",
                         *DATA_BENCH_CUT["data_concurrent"]])):
        native.gather_crop_flip.calls = native.u8_to_f32.calls = native.pad_crop_flip.calls = 0
        t0 = time.perf_counter()
        (line, loss), = bench.main(argv)
        calls = {n: getattr(native, n).calls
                 for n in ("gather_crop_flip", "pad_crop_flip", "u8_to_f32")}
        print(f"[data] {path} (cut to {' '.join(argv[2:])}): {time.perf_counter() - t0:.1f} s; "
              f"native calls {calls}; loss {loss}")
        numbers = {k: v for k, v in line.items() if isinstance(v, (int, float))
                   and not isinstance(v, bool)}
        if not numbers or not all(math.isfinite(v) and v > 0 for v in numbers.values()):
            raise SystemExit(f"{path}: a value is not finite and positive: {line}")
        if loss is not None and not math.isfinite(loss):
            raise SystemExit(f"{path}: non-finite loss {loss}")
        if calls["gather_crop_flip"] == 0:
            raise SystemExit(f"{path}: the decoded cache did not go through the native library")
        runs[path] = line
    if runs["bench --data-only --data-mode both"].get("augment_images_per_sec") is None:
        raise SystemExit("--data-mode both did not time the augment path")

    root = tempfile.mkdtemp(prefix="chip_smoke_tree_")
    try:
        t0 = time.perf_counter()
        for split, per_class in (("train", DATA_PER_CLASS), ("val", DATA_PER_CLASS // 4)):
            bench._jpeg_tree(os.path.join(root, split), DATA_CLASSES * per_class, DATA_CLASSES)
        print(f"[data] JPEG tree {DATA_CLASSES} classes x {DATA_PER_CLASS} train / "
              f"{DATA_PER_CLASS // 4} val images at 256² written in "
              f"{time.perf_counter() - t0:.1f} s")
        fits = {p: _data_fit(root, os.path.join(ckpt_dir, f"prefetch{p}"), p) for p in (0, 2)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for p, r in fits.items():
        print(f"[data] Trainer.fit ResNet-50 (imagenet stem, 224, bf16, hybrid_adam) on the "
              f"decoded cache, batch {DATA_BATCH}, prefetch {p}: {r['result']}; losses "
              f"{r['losses']}; K1 launches {r['launches']}; {r['ms_per_step']:.3f} ms/step "
              f"(epoch 2), device busy {100 * r['busy']:.1f}% of epoch 3 (profiled); "
              f"pinned HtoD copies {len(r['pinned_h2d'])} on streams "
              f"{sorted(set(map(str, r['pinned_h2d'])))}, kernels on streams "
              f"{sorted(map(str, r['kernel_streams']))}")
        steps = DATA_EPOCHS * DATA_STEPS
        if not all(math.isfinite(x) for x in r["losses"]) or len(r["losses"]) != steps:
            raise SystemExit(f"prefetch {p}: losses {r['losses']}")
        if r["launches"] != steps:
            raise SystemExit(f"prefetch {p}: K1 launches {r['launches']} != {steps} steps")
        if len(r["batches"]) != steps:
            raise SystemExit(f"prefetch {p}: the step received {len(r['batches'])} batches")
    same = all(a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
               for a, b in zip(fits[0]["batches"], fits[2]["batches"]))
    print(f"[data] the {DATA_EPOCHS * DATA_STEPS} batches the step received at prefetch 2 "
          f"equal those at prefetch 0, bit for bit: {same}")
    if not same:
        raise SystemExit("the prefetched batches differ from the synchronous ones")
    # The trace keeps most of the epoch's 2 · DATA_STEPS copies (a run read
    # 38 and 32 of 40): at least one a step is required.
    copies, kernels = fits[2]["pinned_h2d"], fits[2]["kernel_streams"]
    if len(copies) < DATA_STEPS or set(copies) & kernels or not kernels:
        raise SystemExit(f"prefetch 2: pinned copies {copies} not on a stream of their own "
                         f"(kernels on {kernels})")

    # The image leg with remat and with the conv policy beside the default.
    legs = {}
    for tag, flags in (("default", []), ("remat", ["--remat"]),
                       ("remat-policy conv", ["--remat-policy", "conv"])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (line, loss), = bench.main(["--image", "--warmup", str(REMAT_WARMUP),
                                    "--steps", str(REMAT_STEPS), "--steps-per-call", "1",
                                    *flags])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"[data] image leg {tag}: {line['value']} images/s, peak memory {peak:.3f} GiB, "
              f"loss {loss} (cut to {REMAT_STEPS} steps after {REMAT_WARMUP})")
        if not (math.isfinite(line["value"]) and line["value"] > 0 and math.isfinite(loss)):
            raise SystemExit(f"image leg {tag}: {line}, loss {loss}")
        legs[tag] = {"images_per_sec": line["value"], "peak_gib": peak}
    if not legs["remat"]["peak_gib"] < legs["default"]["peak_gib"]:
        raise SystemExit(f"remat did not lower the image leg's peak memory: {legs}")
    print(f"[data] phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {f"resnet50_decoded_cache_prefetch{p}": r["launches"]
                         for p, r in fits.items()},
            "native": checks, "bench": runs, "legs": legs,
            "ms_per_step": {p: r["ms_per_step"] for p, r in fits.items()},
            "busy": {p: r["busy"] for p, r in fits.items()}}


# The mesh mode (``torchrun --nproc-per-node W chip_smoke.py --mesh`` on a
# machine with W GPUs, W 2 or 4): the LM strategies at GPT-2-small width
# over the ranks, NCCL, each on the same global batches (16 rows of T
# 1024) as data parallelism over all W ranks; each step's loss against the
# DP run's within GPT_STAGE_RTOL (bf16: the row-parallel partial sums are
# rounded to bf16 before their all-reduce, as JAX's psum of a bf16
# product is; the ranks' reductions run in other orders).
MESH_STEPS = GPT_CLI_STEPS


def _mesh_strategies(world: int) -> list:
    """(name, CLI flags) of every strategy the LM trainer runs over
    ``world`` ranks, data parallelism first (the reference)."""
    rows = str(GPT_B // world)
    out = [("dp", ["-b", rows]), (f"sp{world}", ["--sp", str(world)]),
           (f"tp{world}", ["--tp", str(world)]),
           (f"tp{world}_overlap", ["--tp", str(world), "--tp-overlap"])]
    if world == 4:
        out += [("tp2_sp2", ["--tp", "2", "--sp", "2"]),
                ("tp2_dp2", ["--tp", "2", "-b", str(GPT_B // 2)]),
                ("tp2_sp2_overlap", ["--tp", "2", "--sp", "2", "--tp-overlap"])]
    return out


# A11 and MoE in the mesh mode. The image Trainer over W ranks at the
# global batch 100 (100 / W a rank), ResNet-18, each plugin preset of the
# DP phase (DP_STEPS steps, hybrid_adam, synthetic CIFAR without the random
# crop and flip, so every layout sees the same images), SyncBN, against
# the same preset at world 1 on each rank's own card (run before the
# group opens): each step's loss within DP_LOSS_RTOL of its dtype; local
# BN (statistics per shard by design): finite and falling only. The
# low_level_zero run (ZeRO 1) saves its epoch, which rank 0 loads at
# world 1 after the group closes and trains on. So that the layouts
# differ in nothing else, every run takes the preset's learning rate
# unscaled (the DDP and ColossalAI presets scale it by the data-parallel
# world) and Adam's eps A11_EPS, as the CPU tests do. On four H100 80GB
# HBM3 at 700 W: at the world-4 rate (4x) five steps grew the layouts'
# last-bit differences to 6.3e-5 in fp32 and 5-8% in fp16; at the
# presets' eps 1e-8 Adam's first steps move every parameter by about the
# learning rate whatever its gradient, so a near-zero gradient whose fp16
# rounding differs between 25 images a rank and 100 in one moves it the
# other way, and the fp16 presets parted by 0.9-1.2% by step 4 while fp32
# agreed to 1e-7.
# MoE: GPT-2-small with --moe at ZeRO 1 (moe_param_group) as DP W, EP W and
# EP 2 x DP 2 (the rows a rank chosen so that the global batch is 16), and
# moe_mlp as DP W and EP W (25 images a rank, the learning rate unscaled
# in both): each step's loss against the DP run's within GPT_STAGE_RTOL;
# these agree only if the gate is global over the data ranks.
A11_BATCH = 100
A11_EPS = 1e-4
# The mesh mode's comparisons that failed, each (what, error, tolerance):
# every comparison runs, so one run shows them all, and the mode fails at
# its end if any did.
MESH_FAILURES: list = []


def _mesh_check(what: str, err: float, tol: float) -> None:
    if not err <= tol:
        MESH_FAILURES.append((what, err, tol))
        print(f"[mesh] FAILED {what}: {err:.3g} above {tol}", flush=True)


def _mesh_require(what: str, ok: bool) -> None:
    _mesh_check(what, 0.0 if ok else 1.0, 0.0)


class _Alone:
    """While it is entered, the launcher's rendezvous variables are hidden,
    so a trainer built here runs at world 1 on this rank's card."""

    KEYS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "GROUP_RANK",
            "ROLE_RANK", "LOCAL_WORLD_SIZE", "ROLE_WORLD_SIZE", "GROUP_WORLD_SIZE")

    def __enter__(self):
        self.saved = {k: os.environ.pop(k) for k in self.KEYS if k in os.environ}

    def __exit__(self, *exc):
        os.environ.update(self.saved)


def _a11_config(plugin: str, ckpt_dir: str, world: int, **changes):
    """The DP phase's preset over ``world`` ranks at the global batch
    A11_BATCH, without the random crop and flip, at the preset's learning
    rate unscaled by the world and Adam's eps A11_EPS (see A11_BATCH)."""
    import dataclasses

    cfg = _dp_config(plugin, ckpt_dir)
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=A11_BATCH // world,
                                                augment="normalize_only"),
                       optimizer=dataclasses.replace(cfg.optimizer, scale_lr_by_world=False,
                                                     eps=A11_EPS),
                       **changes)


def _image_run(cfg) -> dict:
    """``Trainer(cfg).fit()`` with each step timed on the card: losses, K1
    launches, images/s over steps 2 on, peak memory; and the trainer."""
    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    start = _peak_start()
    trainer = Trainer(cfg)
    step, times = trainer.train_step, []

    def timed(state, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    trainer.train_step = timed
    fused_adam_update.launches = 0
    trainer.fit()
    return {"losses": [h["loss"] for h in trainer.meter.history],
            "launches": fused_adam_update.launches,
            "images_per_s": trainer.train_gbs * (len(times) - 1) / sum(times[1:]),
            "peak_gib": (torch.cuda.max_memory_allocated() - start) / 2**30,
            "trainer": trainer}


def _rel_losses(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def a11_mesh(world: int, ckpt: str, alone: dict, card: str) -> dict:
    """The image Trainer across the ranks (see A11_BATCH): every preset
    against ``alone`` (its world-1 losses), local BN, the ZeRO 1 save."""
    import torch.distributed as dist

    rank, results = dist.get_rank(), {}
    runs = [(p, p, {}) for p in DP_PRESETS] + [("torch_ddp_local_bn", "torch_ddp",
                                               {"sync_batchnorm": False})]
    for name, plugin, extra in runs:
        if plugin == "low_level_zero":
            extra = {"checkpoint": _ckpt_cfg(os.path.join(ckpt, "a11_zero1"), interval=1)}
        cfg = _a11_config(plugin, os.path.join(ckpt, name), world, **extra)
        run = _image_run(cfg)
        trainer = run.pop("trainer")
        if plugin == "low_level_zero":
            results["zero1_saved_model"] = {
                n: t.clone() for n, t in trainer.state.state_dict()["model"].items()}
        _check_losses(f"a11 {name}", run["losses"], DP_STEPS)
        if run["launches"] != DP_STEPS:
            raise SystemExit(f"a11 {name}: rank {rank} K1 launches {run['launches']} "
                             f"!= {DP_STEPS} steps")
        line = {k: run[k] for k in ("losses", "launches", "images_per_s", "peak_gib")}
        line["zero"] = trainer.state.zero.stage
        line["world"] = trainer.world_size
        if name in alone:
            rtol = DP_LOSS_RTOL[cfg.precision.dtype]
            line["rel_vs_world1"] = diff = _rel_losses(run["losses"], alone[name])
            line["world1_losses"] = alone[name]
            _mesh_check(f"a11 {name}: each step's loss at world {world} vs world 1", diff,
                        rtol)
        results[name] = line
        if rank == 0:
            print(f"[a11] {name} over {world} GPUs (ResNet-18, global batch {A11_BATCH}, "
                  f"{cfg.precision.dtype}, zero {line['zero']}"
                  f"{' cpu_offload' if cfg.zero.cpu_offload else ''}"
                  f"{' local BN' if extra.get('sync_batchnorm') is False else ' SyncBN'}): "
                  f"losses {line['losses']}"
                  + (f" (world 1 {alone[name]}, {line['rel_vs_world1']:.3g} relative, "
                     f"tolerance {DP_LOSS_RTOL[cfg.precision.dtype]})" if name in alone
                     else " (statistics per shard: finite and falling only)")
                  + f"; K1 {run['launches']} launches a rank; {line['images_per_s']:.1f} "
                  f"images/s; peak {line['peak_gib']:.3f} GiB on rank 0; {card}", flush=True)
        del trainer
    return results


def _ckpt_cfg(directory: str, **kw):
    from distributed_training_tpu_torch.config import CheckpointConfig

    return CheckpointConfig(directory=directory, **kw)


def a11_resume(world: int, ckpt: str, saved_model: dict) -> dict:
    """Rank 0 alone, after the group closed: the world-``world`` ZeRO 1
    save loaded at world 1 (the whole model it gathered, bit for bit), then
    trained on for one more epoch."""
    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch import checkpoint as ckpt_lib

    directory = os.path.join(ckpt, "a11_zero1")
    cfg = _a11_config("low_level_zero", directory, 1, num_epochs=2,
                      checkpoint=_ckpt_cfg(directory, interval=0, resume=0))
    with _Alone():
        run = _image_run(cfg)
        trainer = run.pop("trainer")
        probe = Trainer(cfg.replace(checkpoint=_ckpt_cfg(directory, interval=0)))
        ckpt_lib.restore_checkpoint(directory, 0, probe.state)
        loaded = probe.state.state_dict()["model"]
    same = all(torch.equal(loaded[n].cpu(), t.cpu()) for n, t in saved_model.items())
    print(f"[a11] the ZeRO 1 save at world {world} loaded at world 1: whole model bit for "
          f"bit {same}; epoch 2 at world 1 from it: losses {run['losses']}, "
          f"{trainer.state.step} committed steps", flush=True)
    if not same or trainer.state.step != 2 * DP_STEPS:
        raise SystemExit("a11: the world-4 ZeRO 1 checkpoint did not resume at world 1")
    if not all(math.isfinite(x) for x in run["losses"]):
        raise SystemExit(f"a11 resume: non-finite losses {run['losses']}")
    return {"bitwise": same, "losses": run["losses"], "steps": trainer.state.step}


def moe_mesh(world: int, ckpt: str, card: str) -> dict:
    """GPT-2-small MoE and moe_mlp across the ranks (see A11_BATCH)."""
    import dataclasses

    import torch.distributed as dist

    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    rank, results = dist.get_rank(), {}
    cli = _gpt_cli_module()

    def edit(cfg):
        return _hybrid_adam(cfg).replace(moe=dataclasses.replace(cfg.moe, moe_param_group=True))

    ref = None
    for name, flags in ((f"moe_dp{world}", ["-b", str(GPT_B // world)]),
                        (f"moe_ep{world}", ["--ep-world-size", str(world), "-b", str(GPT_B)]),
                        ("moe_ep2_dp2", ["--ep-world-size", "2", "-b", str(2 * GPT_B // world)])):
        fused_adam_update.launches = 0
        run = _gpt_cli_run(cli, [*GPT_CLI_WIDTH, "--moe", "--stage", "1", *flags,
                                 "-c", os.path.join(ckpt, name)], edit)
        if not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"mesh {name}: non-finite losses {run['losses']}")
        if fused_adam_update.launches != MESH_STEPS:
            raise SystemExit(f"mesh {name}: rank {rank} K1 launches "
                             f"{fused_adam_update.launches} != {MESH_STEPS}")
        ref = ref or run
        worst = _rel_losses(run["losses"], ref["losses"])
        _mesh_check(f"mesh {name} losses vs moe_dp{world}", worst, GPT_STAGE_RTOL)
        results[name] = {"losses": run["losses"], "aux": run["aux"],
                         "worst_rel_vs_dp": worst, "tokens_per_s": run["tokens_per_s"],
                         "step_ms": 1e3 * sum(run["step_s"][1:]) / (MESH_STEPS - 1),
                         "peak_gib_rank0": run["peak_bytes"] / 2**30,
                         "kept_share_step1": run["kept_share"][0]}
        if rank == 0:
            r = results[name]
            print(f"[mesh] {name} over {world} GPUs (GPT-2-small MoE, 8 experts every 2nd "
                  f"layer, top-1, global B {GPT_B} T {GPT_T}, bf16, flash, ZeRO 1, "
                  f"hybrid_adam): {r['tokens_per_s']:.1f} tokens/s, {r['step_ms']:.3f} ms a "
                  f"step, peak {r['peak_gib_rank0']:.3f} GiB on rank 0; losses {r['losses']} "
                  f"({worst:.3g} relative of moe_dp{world}'s, tolerance {GPT_STAGE_RTOL}); "
                  f"aux {r['aux']}; {card}", flush=True)
    rcli = _resnet_cli_module()
    ref = None
    for name, flags in ((f"moe_mlp_dp{world}", []),
                        (f"moe_mlp_ep{world}", ["--ep-world-size", str(world)])):
        args = rcli.build_parser().parse_args([
            "--moe", "--num-experts", "4", "--dataset", "synthetic_cifar",
            "-b", str(A11_BATCH // world), "-e", "1", "--steps-per-epoch", str(DP_STEPS),
            "--optimizer", "hybrid_adam", "--log-interval", "1", "-i", "0",
            "-c", os.path.join(ckpt, name), *flags])
        cfg = rcli.build_config(args)
        # The preset scales the learning rate by the data replicas (4 at DP
        # 4, 1 at EP 4): both runs take it unscaled, so they differ only
        # in the layout.
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, augment="normalize_only"),
                          optimizer=dataclasses.replace(cfg.optimizer,
                                                        scale_lr_by_world=False),
                          eval_every=0)
        run = _image_run(cfg)
        run.pop("trainer")
        if not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"mesh {name}: non-finite losses {run['losses']}")
        ref = ref or run
        worst = _rel_losses(run["losses"], ref["losses"])
        _mesh_check(f"mesh {name} losses vs moe_mlp_dp{world}", worst, GPT_STAGE_RTOL)
        results[name] = {k: run[k] for k in ("losses", "launches", "images_per_s",
                                             "peak_gib")}
        results[name]["worst_rel_vs_dp"] = worst
        if rank == 0:
            print(f"[mesh] {name} over {world} GPUs (moe_mlp, 4 experts, global batch "
                  f"{A11_BATCH}, fp32): losses {run['losses']} ({worst:.3g} relative of "
                  f"moe_mlp_dp{world}'s); {run['images_per_s']:.1f} images/s; {card}",
                  flush=True)
    return results


# ViT in the mesh mode: ViT-B/16 through Trainer.fit() on synthetic
# ImageNet (224², uint8, 1000 classes, no augmentation), bf16, hybrid_adam
# (K1 on each rank's ZeRO 1 shard), Adam's eps A11_EPS, DP_STEPS steps,
# VIT_MESH_BATCH images a rank (the JAX Trainer's per-chip rule), as data
# parallelism over the ranks and, over 4, as model 2 x data 2 and model 4,
# each plain and with tp_overlap (over 2: model 2, both ways): each step's
# loss against the data-parallel run's within GPT_STAGE_RTOL (bf16, the
# row-parallel partial products rounded before their sum, as in the LM).
VIT_MESH_BATCH = 8
# MoE under the sequence and model axes: GPT-2-small with --moe (8 experts
# every 2nd layer, top-1) at ZeRO 1 (moe_param_group), at a capacity that
# drops no token (capacity_factor 8, the expert count: every token fits in
# its expert's queue, so the shard-local gate of the sequence strategy
# routes as the global one and only its aux loss differs, ~1e-4 of the
# loss in the JAX package's own probe), as data parallelism over the ranks
# (the reference), the ring (SP W; over 4 also SP 2 x EP 2), TP W (over 4
# also TP 2 x EP 2 and TP 2 x SP 2), and data parallelism with two
# accumulation steps on the same global batch (JAX's microbatch order):
# each step's loss against the first's within GPT_STAGE_RTOL. The
# capacities that drop tokens are held to the JAX package's steps by the
# CPU tests (tests/test_torch_moe_axes.py).
MOE_NODROP_CAPACITY = 8.0


def vit_mesh(world: int, ckpt: str, card: str) -> dict:
    """ViT-B/16 across the ranks (see VIT_MESH_BATCH)."""
    from distributed_training_tpu_torch.config import (
        DataConfig,
        MeshSpec,
        OptimizerConfig,
        PrecisionConfig,
        TrainConfig,
        ZeroConfig,
    )
    import torch.distributed as dist

    rank, results, ref = dist.get_rank(), {}, None
    layouts = [(f"vit_dp{world}", {"data": world}, False)]
    for tp in ((2, 4) if world == 4 else (2,)):
        for overlap in (False, True):
            name = f"vit_tp{tp}" + (f"_dp{world // tp}" if world > tp else "")
            layouts.append((name + ("_overlap" if overlap else ""),
                            {"data": world // tp, "model": tp}, overlap))
    for name, mesh, overlap in layouts:
        cfg = TrainConfig(
            model="vit_b16", num_epochs=1, log_interval=1, eval_every=0,
            tp_overlap=overlap, mesh=MeshSpec(**mesh), zero=ZeroConfig(stage=1),
            precision=PrecisionConfig(dtype="bf16"),
            optimizer=OptimizerConfig(name="hybrid_adam", eps=A11_EPS),
            data=DataConfig(dataset="synthetic_imagenet", image_size=224, num_classes=1000,
                            batch_size=VIT_MESH_BATCH, max_steps_per_epoch=DP_STEPS,
                            augment="none"),
            checkpoint=_ckpt_cfg(os.path.join(ckpt, name), interval=0))
        run = _image_run(cfg)
        trainer = run.pop("trainer")
        losses = run["losses"]
        if len(losses) != DP_STEPS or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"mesh {name}: expected {DP_STEPS} finite losses, got {losses}")
        if run["launches"] != DP_STEPS:
            raise SystemExit(f"mesh {name}: rank {rank} K1 launches {run['launches']} "
                             f"!= {DP_STEPS} steps")
        ref = ref or run
        worst = _rel_losses(losses, ref["losses"])
        _mesh_check(f"mesh {name} losses vs vit_dp{world}", worst, GPT_STAGE_RTOL)
        results[name] = {**{k: run[k] for k in ("losses", "launches", "images_per_s",
                                                 "peak_gib")},
                         "worst_rel_vs_dp": worst, "zero": trainer.state.zero.stage,
                         "global_batch": trainer.train_gbs}
        if rank == 0:
            print(f"[mesh] {name} over {world} GPUs (ViT-B/16, synthetic 224², global "
                  f"batch {trainer.train_gbs}, bf16, ZeRO 1, hybrid_adam): "
                  f"{run['images_per_s']:.1f} images/s, peak {run['peak_gib']:.3f} GiB on "
                  f"rank 0; K1 {run['launches']} launches a rank; losses {losses} "
                  f"({worst:.3g} relative of vit_dp{world}'s, tolerance {GPT_STAGE_RTOL}); "
                  f"{card}", flush=True)
        del trainer
    return results


def moe_axes_mesh(world: int, ckpt: str, card: str) -> dict:
    """GPT-2-small MoE under the sequence and model axes (see
    MOE_NODROP_CAPACITY): tokens/s, K2/K3 launches counted from 0 for each
    layout and summed over the ranks (each ring hop launches them), the
    losses against data parallelism's."""
    import dataclasses

    import torch.distributed as dist

    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    rank, results, ref = dist.get_rank(), {}, None
    cli = _gpt_cli_module()

    def edit(cfg):
        return _hybrid_adam(cfg).replace(moe=dataclasses.replace(
            cfg.moe, moe_param_group=True, capacity_factor=MOE_NODROP_CAPACITY))

    rows = str(GPT_B // world)
    layouts = [(f"moe_nodrop_dp{world}", ["-b", rows]), (f"moe_nodrop_sp{world}", ["--sp", str(world)]),
               (f"moe_nodrop_tp{world}", ["--tp", str(world)])]
    if world == 4:
        layouts += [("moe_nodrop_sp2_ep2", ["--sp", "2", "--ep-world-size", "2"]),
                    ("moe_nodrop_tp2_ep2", ["--tp", "2", "--ep-world-size", "2"]),
                    ("moe_nodrop_tp2_sp2", ["--tp", "2", "--sp", "2"])]
    layouts.append((f"moe_nodrop_dp{world}_accum2",
                    ["-b", str(GPT_B // world // 2), "--gradient-accumulation-steps", "2"]))
    for name, flags in layouts:
        fused_adam_update.launches = flash_fwd.launches = flash_bwd.launches = 0
        run = _gpt_cli_run(cli, [*GPT_CLI_WIDTH, "--moe", "--stage", "1", *flags,
                                 "-c", os.path.join(ckpt, name)], edit)
        counts = torch.tensor([flash_fwd.launches, flash_bwd.launches], device="cuda")
        dist.all_reduce(counts)
        if len(run["losses"]) != MESH_STEPS or not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"mesh {name}: non-finite losses {run['losses']}")
        if fused_adam_update.launches != MESH_STEPS:
            raise SystemExit(f"mesh {name}: rank {rank} K1 launches "
                             f"{fused_adam_update.launches} != {MESH_STEPS}")
        if min(flash_fwd.launches, flash_bwd.launches) == 0:
            raise SystemExit(f"mesh {name}: rank {rank} launched no K2/K3")
        ref = ref or run
        worst = _rel_losses(run["losses"], ref["losses"])
        _mesh_check(f"mesh {name} losses vs moe_nodrop_dp{world}", worst, GPT_STAGE_RTOL)
        results[name] = {"losses": run["losses"], "aux": run["aux"],
                         "worst_rel_vs_dp": worst, "tokens_per_s": run["tokens_per_s"],
                         "step_ms": 1e3 * sum(run["step_s"][1:]) / (MESH_STEPS - 1),
                         "peak_gib_rank0": run["peak_bytes"] / 2**30,
                         "launches_all_ranks": {"flash_fwd": int(counts[0]),
                                                "flash_bwd": int(counts[1])},
                         "kept_share_step1": run["kept_share"][0]}
        if rank == 0:
            r = results[name]
            print(f"[mesh] {name} over {world} GPUs (GPT-2-small MoE, 8 experts every 2nd "
                  f"layer, top-1, capacity factor {MOE_NODROP_CAPACITY}, global B {GPT_B} T "
                  f"{GPT_T}, bf16, flash, ZeRO 1, hybrid_adam): {r['tokens_per_s']:.1f} "
                  f"tokens/s, {r['step_ms']:.3f} ms a step, peak {r['peak_gib_rank0']:.3f} "
                  f"GiB on rank 0; K2/K3 launches (all ranks) {r['launches_all_ranks']}; "
                  f"losses {r['losses']} ({worst:.3g} relative of moe_nodrop_dp{world}'s, "
                  f"tolerance {GPT_STAGE_RTOL}); aux {r['aux']}; kept share step 1 "
                  f"{r['kept_share_step1']}; {card}", flush=True)
    return results


# The pipeline over four cards (--mesh pp): the GPT CLI's trainer at
# GPT-2-small width (bf16, flash, hybrid_adam, ZeRO 1, MESH_STEPS steps,
# the global batch GPT_B) in each layout of PP_LAYOUTS, each step's loss
# against DP 4's within GPT_STAGE_RTOL; the MoE layouts (every layer 8
# experts, top-1, capacity factor MOE_NODROP_CAPACITY: no token dropped)
# compare the CE (loss less aux) against MoE DP 4's, since their aux
# differs by design (the pipeline's gate sees one microbatch, DP's the
# global batch). This is one card's batch over four cards: overheads only.
PP_LAYOUTS = (
    ("dp4", ["-b", str(GPT_B // 4)]),
    ("pp4", ["--pp", "4", "--microbatches", "4"]),
    ("pp4_v3", ["--pp", "4", "--virtual-stages", "3", "--microbatches", "4", "-i", "1"]),
    ("pp2_dp2", ["--pp", "2", "--microbatches", "2", "-b", str(GPT_B // 2)]),
    ("pp2_tp2", ["--pp", "2", "--tp", "2", "--microbatches", "2"]),
    ("pp2_sp2", ["--pp", "2", "--sp", "2", "--microbatches", "2"]),
    ("pp4_accum2", ["--pp", "4", "-b", str(GPT_B // 2), "--microbatches", "2",
                    "--gradient-accumulation-steps", "2"]),
    ("moe_nodrop_dp4", ["--moe", "--moe-every", "1", "-b", str(GPT_B // 4)]),
    ("moe_nodrop_pp4", ["--moe", "--moe-every", "1", "--pp", "4", "--microbatches", "4"]),
    ("moe_nodrop_pp2_ep2", ["--moe", "--moe-every", "1", "--pp", "2", "--ep-world-size", "2",
                            "--microbatches", "2"]),
)


def pp_mesh(world: int, ckpt: str, card: str) -> dict:
    """The pipeline layouts of PP_LAYOUTS over the ranks: tokens/s, peak
    memory, bubble fraction and K1/K2/K3 launches (summed over the ranks),
    losses (CE for MoE) against the DP 4 run's; returns the results and the
    whole model the ``pp4_v3`` run saved."""
    import dataclasses

    import torch.distributed as dist

    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    if world != 4:
        raise SystemExit("chip_smoke --mesh pp: the layouts need four ranks")
    rank, results, refs, saved = dist.get_rank(), {}, {}, None
    cli = _gpt_cli_module()

    def edit(cfg):
        cfg = _hybrid_adam(cfg)
        if not cfg.moe.enabled:
            return cfg
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, moe_param_group=True, capacity_factor=MOE_NODROP_CAPACITY))

    for name, flags in PP_LAYOUTS:
        fused_adam_update.launches = flash_fwd.launches = flash_bwd.launches = 0
        run = _gpt_cli_run(cli, [*GPT_CLI_WIDTH, "--stage", "1", *flags,
                                 "-c", os.path.join(ckpt, name)], edit,
                           keep_model=name == "pp4_v3")
        counts = torch.tensor([fused_adam_update.launches, flash_fwd.launches,
                               flash_bwd.launches], device="cuda")
        dist.all_reduce(counts)
        if len(run["losses"]) != MESH_STEPS or not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"mesh {name}: non-finite losses {run['losses']}")
        if fused_adam_update.launches != MESH_STEPS or min(flash_fwd.launches,
                                                           flash_bwd.launches) == 0:
            raise SystemExit(f"mesh {name}: rank {rank} launches K1 "
                             f"{fused_adam_update.launches}, K2 {flash_fwd.launches}, "
                             f"K3 {flash_bwd.launches}")
        moe = name.startswith("moe")
        ce = [loss - aux for loss, aux in zip(run["losses"], run["aux"])]
        ref = refs.setdefault("moe" if moe else "dense", ce)
        worst = _rel_losses(ce, ref)
        if name not in ("dp4", "moe_nodrop_dp4"):
            _mesh_check(f"mesh {name} {'CE' if moe else 'losses'} vs "
                        f"{'moe_nodrop_dp4' if moe else 'dp4'}", worst, GPT_STAGE_RTOL)
        if "model" in run:
            saved = run.pop("model")
        results[name] = {"losses": run["losses"], "aux": run["aux"], "ce": ce,
                         "worst_rel_vs_dp": worst, "tokens_per_s": run["tokens_per_s"],
                         "step_ms": 1e3 * sum(run["step_s"][1:]) / (MESH_STEPS - 1),
                         "peak_gib_rank0": run["peak_bytes"] / 2**30,
                         "bubble_fraction": run["bubble"], "strategy": run["strategy"],
                         "final_perplexity": run["result"]["final_perplexity"],
                         "launches_all_ranks": {"fused_adam": int(counts[0]),
                                                "flash_fwd": int(counts[1]),
                                                "flash_bwd": int(counts[2])}}
        if rank == 0:
            r = results[name]
            print(f"[mesh] {name} over {world} GPUs (GPT-2-small{' MoE every layer' if moe else ''}"
                  f", global B {GPT_B} T {GPT_T}, bf16, flash, ZeRO 1, hybrid_adam; "
                  f"{r['strategy']}): {r['tokens_per_s']:.1f} tokens/s, {r['step_ms']:.3f} "
                  f"ms a step, peak {r['peak_gib_rank0']:.3f} GiB on rank 0, bubble fraction "
                  f"{r['bubble_fraction']}; launches (all ranks) {r['launches_all_ranks']}; "
                  f"{'CE' if moe else 'losses'} {ce} ({worst:.3g} relative of "
                  f"{'moe_nodrop_dp4' if moe else 'dp4'}'s, tolerance {GPT_STAGE_RTOL}); "
                  f"aux {r['aux']}; eval perplexity {r['final_perplexity']:.4f}; {card}",
                  flush=True)
    return {"layouts": results, "saved_model": saved}


def pp_resume(ckpt: str, saved_model: dict) -> dict:
    """Rank 0 alone, after the group closed: the ``pp4_v3`` save (four
    stages, three virtual stages each) loaded at world 1 (the whole model,
    bit for bit, in layer order), then trained on for one more epoch."""
    from distributed_training_tpu_torch import checkpoint as ckpt_lib

    cli = _gpt_cli_module()
    directory = os.path.join(ckpt, "pp4_v3")
    argv = [*GPT_CLI_WIDTH, "-c", directory, "-i", "0"]
    with _Alone():
        probe = cli.build_trainer(argv)
        ckpt_lib.restore_checkpoint(directory, 0, probe.state)
        loaded = probe.state.state_dict()["model"]
        del probe
        torch.cuda.empty_cache()
        run = _gpt_cli_run(cli, [*argv, "-r", "0", "-e", "2"], _hybrid_adam)
    same = (set(loaded) == set(saved_model)
            and all(torch.equal(loaded[n].cpu(), t.cpu()) for n, t in saved_model.items()))
    print(f"[mesh] the pp4_v3 save (pipe 4 x virtual 3) loaded at world 1: whole model bit "
          f"for bit {same}; epoch 2 at world 1 from it: losses {run['losses']}, "
          f"{run['result']['steps']} committed steps", flush=True)
    if not same or run["result"]["steps"] != 2 * MESH_STEPS:
        raise SystemExit("pp: the pipe 4 x virtual 3 checkpoint did not resume at world 1")
    if not all(math.isfinite(x) for x in run["losses"]):
        raise SystemExit(f"pp resume: non-finite losses {run['losses']}")
    return {"bitwise": same, "losses": run["losses"], "steps": run["result"]["steps"]}


# The fsdp axis in the mesh mode (four ranks; no CLI has a flag for it, as
# in JAX, so each run's config gains MeshSpec.fsdp): GPT-2-small through the
# GPT CLI's trainer at the global batch GPT_B (bf16, flash, hybrid_adam,
# MESH_STEPS steps) as DP 4 (the reference, ZeRO 0), fsdp 4 at ZeRO 0 (its
# save resumed at world 1) and ZeRO 3, fsdp 2 x DP 2 at ZeRO 1, fsdp 2 x TP
# 2, fsdp 2 x SP 2, fsdp 2 x PP 2 at ZeRO 1; MoE every 2nd layer at
# MOE_NODROP_CAPACITY as DP 4 and fsdp 2 x EP 2; ResNet-18 (the A11 config,
# fp32 SyncBN) and ViT-B/16 (VIT_MESH_BATCH a rank, bf16) as DP 4 and at
# fsdp 4, fsdp 2 x TP 2. Each step's loss against its DP 4 run's (an LM's
# fsdp ranks run the same rows, so the LM layouts are world 1's step on
# the same global batch, as DP 4's is): GPT_STAGE_RTOL, and DP_LOSS_RTOL
# in fp32 for ResNet-18. Rank 0's parameter and optimizer-state bytes
# against its DP 4 run's (ZeRO 0): they must fall by at least the fsdp
# size (less 2% for the flat rule's padding).
FSDP_LAYOUTS = (
    ("dp4", ["-b", str(GPT_B // 4)], 1),
    ("fsdp4_zero0", ["-b", str(GPT_B // 4), "-i", "1"], 4),
    ("fsdp4_zero3", ["-b", str(GPT_B // 4), "--stage", "3"], 4),
    ("fsdp2_dp2_zero1", ["-b", str(GPT_B // 4), "--stage", "1"], 2),
    ("fsdp2_tp2", ["-b", str(GPT_B // 2), "--tp", "2"], 2),
    ("fsdp2_sp2", ["-b", str(GPT_B // 2), "--sp", "2"], 2),
    ("fsdp2_pp2_zero1", ["-b", str(GPT_B // 2), "--pp", "2", "--microbatches", "2",
                         "--stage", "1"], 2),
    ("moe_dp4", ["-b", str(GPT_B // 4), "--moe"], 1),
    ("moe_fsdp2_ep2", ["-b", str(GPT_B // 2), "--moe", "--ep-world-size", "2"], 2),
)
FSDP_IMAGE_LAYOUTS = (("resnet18_dp4", "resnet18", {"data": 4}),
                      ("resnet18_fsdp4", "resnet18", {"data": 1, "fsdp": 4}),
                      ("vit_dp4", "vit_b16", {"data": 4}),
                      ("vit_fsdp2_tp2", "vit_b16", {"data": 1, "fsdp": 2, "model": 2}))
FSDP_BYTES_SLACK = 0.98


def _state_bytes(trainer) -> dict:
    """Bytes of the parameters (the shards where they are held so) and of
    the optimizer state this rank holds."""
    st = trainer.state
    params = st.shards if st.shards is not None else st.params()
    return {"params": sum(t.numel() * t.element_size() for t in params.values()),
            "opt": sum(t.numel() * t.element_size() for slot in st.opt_state.slots.values()
                       for t in slot.values())}


def _fsdp_bytes_check(name: str, got: dict, ref: dict, fsdp: int) -> dict:
    ratios = {k: ref[k] / got[k] for k in ("params", "opt")}
    if fsdp > 1:
        for k, r in ratios.items():
            _mesh_check(f"mesh {name} {k} bytes fall by the fsdp size {fsdp} (ratio {r:.3f})",
                        fsdp * FSDP_BYTES_SLACK - r, 0.0)
    return ratios


def fsdp_mesh(world: int, ckpt: str, card: str) -> dict:
    """The fsdp layouts (see FSDP_LAYOUTS): losses, tokens/s or images/s,
    rank 0's peak and state bytes; returns them and the whole model the
    ``fsdp4_zero0`` run saved."""
    import dataclasses

    import torch.distributed as dist

    from distributed_training_tpu_torch.config import (
        DataConfig,
        MeshSpec,
        OptimizerConfig,
        PrecisionConfig,
        TrainConfig,
        ZeroConfig,
    )
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.ops.fused_adam import fused_adam_update

    if world != 4:
        raise SystemExit("chip_smoke --mesh fsdp: the layouts need four ranks")
    rank, results, refs, saved = dist.get_rank(), {}, {}, None
    cli = _gpt_cli_module()
    for name, flags, fsdp in FSDP_LAYOUTS:
        state_bytes = {}

        def edit(cfg, fsdp=fsdp):
            cfg = _hybrid_adam(cfg).replace(mesh=dataclasses.replace(cfg.mesh, fsdp=fsdp))
            if cfg.moe.enabled:
                cfg = cfg.replace(moe=dataclasses.replace(
                    cfg.moe, capacity_factor=MOE_NODROP_CAPACITY))
            return cfg

        def probe(trainer, store=state_bytes):
            store.update(_state_bytes(trainer))

        fused_adam_update.launches = flash_fwd.launches = flash_bwd.launches = 0
        run = _gpt_cli_run(cli, [*GPT_CLI_WIDTH, *flags, "-c", os.path.join(ckpt, name)],
                           edit, keep_model=name == "fsdp4_zero0", probe=probe)
        if len(run["losses"]) != MESH_STEPS or not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"mesh {name}: non-finite losses {run['losses']}")
        if fused_adam_update.launches != MESH_STEPS or min(flash_fwd.launches,
                                                           flash_bwd.launches) == 0:
            raise SystemExit(f"mesh {name}: rank {rank} launches K1 "
                             f"{fused_adam_update.launches}, K2 {flash_fwd.launches}, "
                             f"K3 {flash_bwd.launches}")
        ref_name = "moe_dp4" if name.startswith("moe") else "dp4"
        ref = refs.setdefault(ref_name, {"losses": run["losses"], "bytes": state_bytes})
        worst = _rel_losses(run["losses"], ref["losses"])
        if name != ref_name:
            _mesh_check(f"mesh {name} losses vs {ref_name}", worst, GPT_STAGE_RTOL)
        ratios = _fsdp_bytes_check(name, state_bytes, ref["bytes"], fsdp)
        if "model" in run:
            saved = run.pop("model")
        results[name] = {"losses": run["losses"], "worst_rel_vs_dp4": worst,
                         "tokens_per_s": run["tokens_per_s"],
                         "step_ms": 1e3 * sum(run["step_s"][1:]) / (MESH_STEPS - 1),
                         "peak_gib_rank0": run["peak_bytes"] / 2**30,
                         "state_bytes_rank0": state_bytes,
                         "dp4_over_this_bytes": ratios, "strategy": run["strategy"]}
        if rank == 0:
            r = results[name]
            print(f"[mesh] {name} over {world} GPUs (GPT-2-small{' MoE' if 'moe' in name else ''}"
                  f", global B {GPT_B} T {GPT_T}, bf16, flash, hybrid_adam; {r['strategy']}): "
                  f"{r['tokens_per_s']:.1f} tokens/s, {r['step_ms']:.3f} ms a step, peak "
                  f"{r['peak_gib_rank0']:.3f} GiB on rank 0, parameters "
                  f"{state_bytes['params'] / 2**20:.1f} MiB and optimizer state "
                  f"{state_bytes['opt'] / 2**20:.1f} MiB on rank 0 ({ref_name}'s over this: "
                  f"{ratios['params']:.3f}, {ratios['opt']:.3f}); losses {r['losses']} "
                  f"({worst:.3g} relative of {ref_name}'s, tolerance {GPT_STAGE_RTOL}); {card}",
                  flush=True)
    for name, model, mesh in FSDP_IMAGE_LAYOUTS:
        fsdp = mesh.get("fsdp", 1)
        if model == "resnet18":
            cfg = _a11_config("torch_ddp", os.path.join(ckpt, name), world,
                              mesh=MeshSpec(**mesh))
            tol, unit = DP_LOSS_RTOL["fp32"], "ResNet-18, fp32 SyncBN"
        else:
            cfg = TrainConfig(
                model="vit_b16", num_epochs=1, log_interval=1, eval_every=0,
                mesh=MeshSpec(**mesh), zero=ZeroConfig(stage=0),
                precision=PrecisionConfig(dtype="bf16"),
                optimizer=OptimizerConfig(name="hybrid_adam", eps=A11_EPS),
                data=DataConfig(dataset="synthetic_imagenet", image_size=224,
                                num_classes=1000, batch_size=VIT_MESH_BATCH,
                                max_steps_per_epoch=DP_STEPS, augment="none"),
                checkpoint=_ckpt_cfg(os.path.join(ckpt, name), interval=0))
            tol, unit = GPT_STAGE_RTOL, "ViT-B/16, bf16, synthetic 224²"
        run = _image_run(cfg)
        trainer = run.pop("trainer")
        state_bytes = _state_bytes(trainer)
        losses = run["losses"]
        if len(losses) != DP_STEPS or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"mesh {name}: expected {DP_STEPS} finite losses, got {losses}")
        if run["launches"] != DP_STEPS:
            raise SystemExit(f"mesh {name}: rank {rank} K1 launches {run['launches']}")
        ref = refs.setdefault(model, {"losses": losses, "bytes": state_bytes})
        worst = _rel_losses(losses, ref["losses"])
        if fsdp > 1:
            _mesh_check(f"mesh {name} losses vs {model}_dp4", worst, tol)
        ratios = _fsdp_bytes_check(name, state_bytes, ref["bytes"], fsdp)
        results[name] = {**{k: run[k] for k in ("losses", "images_per_s", "peak_gib")},
                         "worst_rel_vs_dp4": worst, "state_bytes_rank0": state_bytes,
                         "dp4_over_this_bytes": ratios, "global_batch": trainer.train_gbs}
        if rank == 0:
            print(f"[mesh] {name} over {world} GPUs ({unit}, global batch "
                  f"{trainer.train_gbs}, hybrid_adam): {run['images_per_s']:.1f} images/s, "
                  f"peak {run['peak_gib']:.3f} GiB on rank 0, parameters "
                  f"{state_bytes['params'] / 2**20:.1f} MiB and optimizer state "
                  f"{state_bytes['opt'] / 2**20:.1f} MiB on rank 0 (dp4's over this: "
                  f"{ratios['params']:.3f}, {ratios['opt']:.3f}); losses {losses} "
                  f"({worst:.3g} relative of dp4's, tolerance {tol}); {card}", flush=True)
        del trainer
        torch.cuda.empty_cache()
    return {"layouts": results, "saved_model": saved}


# The flight recorder across four cards: GPT-2-small at fsdp 2 × DP 2, ZeRO 1,
# the mesh layouts' CLI flags (log interval 1: a flush, and so a gloo
# exchange of the straggler payloads, every step), recorder off, on, on,
# off twice over, FSDP_AB_STEPS steps each; each loop interval timed from
# one step's entry to the next's (card synchronised there), a run's step
# time the mean after the first two. Reported, not gated: four-card rates
# vary by up to 2x between calls.
FSDP_AB_STEPS = 12


def fsdp_flight_ab(world: int, ckpt: str, card: str) -> dict:
    """The recorder's cost on four cards (see FSDP_AB_STEPS)."""
    import dataclasses

    import torch.distributed as dist

    from distributed_training_tpu_torch import LMTrainer

    cli = _gpt_cli_module()
    argv = [*GPT_CLI_WIDTH, "-b", str(GPT_B // 4), "--stage", "1",
            "--steps-per-epoch", str(FSDP_AB_STEPS)]
    runs = {"on": [], "off": []}
    for i, mode in enumerate(FLIGHT_AB):
        args = cli.build_parser().parse_args([*argv, "-c", os.path.join(ckpt, f"ab{i}")])
        cfg = _hybrid_adam(cli.build_config(args))
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, fsdp=2),
                          observability=dataclasses.replace(
                              cfg.observability, flight_recorder=mode == "on"))
        trainer = LMTrainer(cfg, device=args.device)
        step, entries = trainer.train_step, []

        def timed(state, batch, step=step, entries=entries):
            torch.cuda.synchronize()
            entries.append(time.perf_counter())
            return step(state, batch)

        trainer.train_step = timed
        trainer.fit()
        torch.cuda.synchronize()
        entries.append(time.perf_counter())
        intervals = [b - a for a, b in zip(entries, entries[1:])][2:]
        runs[mode].append(1e3 * sum(intervals) / len(intervals))
        del trainer
        torch.cuda.empty_cache()
    # Rank 0's step is every rank's (each step ends in collectives).
    on_ms, off_ms = (sum(runs[m]) / len(runs[m]) for m in ("on", "off"))
    out = {"step_ms": {"on": on_ms, "off": off_ms}, "run_step_ms": runs,
           "off_spread_ms": max(runs["off"]) - min(runs["off"]), "order": list(FLIGHT_AB)}
    if dist.get_rank() == 0:
        print(f"[mesh] fsdp2_dp2_zero1 flight recorder A/B over {world} GPUs (log interval 1, "
              f"{FSDP_AB_STEPS} steps a run, runs {'/'.join(FLIGHT_AB)}): mean loop interval "
              f"off {off_ms:.3f} ms, on {on_ms:.3f} ms ({on_ms - off_ms:+.3f}); runs on "
              f"{runs['on']}, off {runs['off']}; off runs' spread {out['off_spread_ms']:.3f} ms;"
              f" {card}", flush=True)
    return out


def fsdp_resume(ckpt: str, saved_model: dict) -> dict:
    """Rank 0 alone, after the group closed: the ``fsdp4_zero0`` save loaded
    at world 1 (the whole model, bit for bit), then trained on for one
    more epoch."""
    from distributed_training_tpu_torch import checkpoint as ckpt_lib

    cli = _gpt_cli_module()
    directory = os.path.join(ckpt, "fsdp4_zero0")
    argv = [*GPT_CLI_WIDTH, "-c", directory, "-i", "0"]
    with _Alone():
        probe = cli.build_trainer(argv)
        ckpt_lib.restore_checkpoint(directory, 0, probe.state)
        loaded = probe.state.state_dict()["model"]
        del probe
        torch.cuda.empty_cache()
        run = _gpt_cli_run(cli, [*argv, "-r", "0", "-e", "2"], _hybrid_adam)
    same = (set(loaded) == set(saved_model)
            and all(torch.equal(loaded[n].cpu(), t.cpu()) for n, t in saved_model.items()))
    print(f"[mesh] the fsdp4_zero0 save loaded at world 1: whole model bit for bit {same}; "
          f"epoch 2 at world 1 from it: losses {run['losses']}, "
          f"{run['result']['steps']} committed steps", flush=True)
    if not same or run["result"]["steps"] != 2 * MESH_STEPS:
        raise SystemExit("fsdp: the fsdp 4 checkpoint did not resume at world 1")
    if not all(math.isfinite(x) for x in run["losses"]):
        raise SystemExit(f"fsdp resume: non-finite losses {run['losses']}")
    return {"bitwise": same, "losses": run["losses"], "steps": run["result"]["steps"]}


# The collectives part of the mesh mode (W 4). The collective accounting
# tool's micro rows (tools/collective_accounting.py) over the W NCCL ranks,
# every rank's accounting equal to the same tool's over W gloo ranks on
# the CPU (run beside it as a subprocess: the counter reads the port's
# calls, not the backend); then one counted step at full width after
# COLL_WARMUP uncounted ones (NCCL's communicators and cuDNN's plans come
# up in those), timed on the card: GPT-2-small through the GPT CLI at each
# of _mesh_strategies' flags at ZeRO 0, data parallelism at ZeRO 1 and 3,
# GPipe over 4 stages and 4 microbatches, and ResNet-18 data parallel
# (A11_BATCH). The data-parallel rows must equal expected_dp_collectives
# exactly; every data-parallel all-reduce of the gradients must lie in
# [G, 2G) bytes (G = 4 × parameters); ZeRO 3 must all-gather; the sp and
# overlap rows and the pipeline must permute. Bytes a rank a step over the
# step's ms is the link rate the step would need (printed, not gated).
COLL_WARMUP = 2
COLL_FULL = (*((n, ["--stage", "0", *f]) for n, f in _mesh_strategies(4)),
             ("dp_zero1", ["--stage", "1", "-b", str(GPT_B // 4)]),
             ("dp_zero3", ["--stage", "3", "-b", str(GPT_B // 4)]),
             ("pp4", ["--stage", "0", "--pp", "4", "--microbatches", "4"]))


def _counted_timed_step(trainer, batches: list) -> tuple[dict, float]:
    """COLL_WARMUP steps, then one step counted and timed on the card."""
    from distributed_training_tpu_torch.utils.collectives import step_collectives

    for b in batches[:COLL_WARMUP]:
        trainer.train_step(trainer.state, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acct = step_collectives(trainer.train_step, trainer.state, batches[COLL_WARMUP])
    torch.cuda.synchronize()
    return acct, 1e3 * (time.perf_counter() - t0)


def collectives_mesh(world: int, ckpt: str, card: str) -> dict:
    """The collectives part (see COLL_WARMUP); writes
    ``profiles/torch_collectives_4gpu.json`` on rank 0."""
    import subprocess

    import torch.distributed as dist

    from distributed_training_tpu_torch import Trainer
    from distributed_training_tpu_torch.data.pipeline import to_device
    from distributed_training_tpu_torch.tools import collective_accounting as tool
    from distributed_training_tpu_torch.train.train_state import param_count

    if world != 4:
        raise SystemExit("chip_smoke --mesh collectives: the rows need four ranks")
    rank = dist.get_rank()
    cpu_out = os.path.join(ckpt, "collectives_cpu")
    proc = (subprocess.Popen([sys.executable, "-m", tool.__name__, "--device", "cpu",
                              "--ranks", str(world), "--out", cpu_out], cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if rank == 0 else None)
    t0 = time.perf_counter()
    micro = tool.run_rows(world, None, torch.device("cuda", torch.cuda.current_device()))
    micro_s = time.perf_counter() - t0
    if rank == 0:
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise SystemExit(f"the CPU accounting exited {proc.returncode}: {log[-3000:]}")
        with open(cpu_out + ".json") as fh:
            cpu = json.load(fh)["strategies"]
        differ = sorted(n for n in set(cpu) | set(micro) if cpu.get(n) != micro.get(n))
        print(f"[collectives] the tool's {len(micro)} micro rows over {world} NCCL ranks in "
              f"{micro_s:.1f} s: every rank's accounting against {world} gloo ranks on the "
              f"CPU, rows that differ {differ}", flush=True)
        _mesh_require(f"collectives: micro rows equal over NCCL and gloo, {differ} differ",
                      not differ)
    cli = _gpt_cli_module()
    full = {}

    def record(name: str, trainer, batches: list, what: str) -> None:
        acct, ms = _counted_timed_step(trainer, batches)
        grad_bytes = 4 * (trainer.param_count if hasattr(trainer, "param_count")
                          else param_count(trainer.model))
        sent = sum(e["bytes"] for e in acct.values())
        row = {"model": what, "collectives": acct, "step_ms": ms,
               "grad_bytes_fp32": grad_bytes, "bytes_per_rank": sent,
               "link_gb_per_s": sent / ms / 1e6, "strategy": getattr(trainer, "strategy", "dp")}
        if _data_parallel_alone(trainer):
            row["expected"] = want = expected_dp_collectives(trainer)
            _mesh_require(f"collectives {name}: equal to expected_dp_collectives {want}",
                          acct == want)
            if trainer.state.zero.stage < 2:
                reduced = acct.get("all-reduce", {}).get("bytes", 0)
                _mesh_require(f"collectives {name}: all-reduce bytes {reduced} in [G, 2G)",
                              grad_bytes <= reduced < 2 * grad_bytes)
        full[name] = row
        if rank == 0:
            print(f"[collectives] {name} over {world} GPUs ({what}; {row['strategy']}): "
                  f"{_collectives_line(acct)}; {sent} bytes a rank a step in {ms:.3f} ms "
                  f"= {row['link_gb_per_s']:.2f} GB/s of link the step would need; "
                  f"G {grad_bytes} bytes; {card}", flush=True)

    for name, flags in COLL_FULL:
        trainer = cli.build_trainer([*GPT_CLI_WIDTH, *flags,
                                     "-c", os.path.join(ckpt, "coll_" + name)])
        loader = trainer.make_loaders()[0]
        loader.set_epoch(0)
        batches = [trainer.place(b) for _, b in zip(range(COLL_WARMUP + 1), loader)]
        record(name, trainer, batches, f"GPT-2-small, B {GPT_B} T {GPT_T}, bf16, flash, "
               f"{' '.join(flags)}")
        del trainer, batches
        torch.cuda.empty_cache()
    trainer = Trainer(_a11_config("torch_ddp", os.path.join(ckpt, "coll_resnet18"), world))
    batches = [to_device(b, trainer.device)
               for _, b in zip(range(COLL_WARMUP + 1), trainer.make_loaders()[0])]
    record("resnet18_dp4", trainer, batches, f"ResNet-18, global batch {A11_BATCH}, fp32, "
           f"SyncBN, ZeRO 0")
    del trainer, batches
    _mesh_require("collectives dp_zero3: all-gathers", "all-gather" in
                  full["dp_zero3"]["collectives"])
    for name in ("sp4", "tp4_overlap", "tp2_sp2", "tp2_sp2_overlap", "pp4"):
        _mesh_require(f"collectives {name}: permutes",
                      "collective-permute" in full[name]["collectives"])
    if rank == 0:
        path = os.path.join(REPO, "profiles", "torch_collectives_4gpu.json")
        with open(path, "w") as fh:
            json.dump({"devices": world, "platform": "cuda", "backend": "nccl", "card": card,
                       "notes": tool.NOTES, "strategies": micro, "full_width": full},
                      fh, indent=1, sort_keys=True)
        print(f"[collectives] wrote {path}", flush=True)
    return {"micro_rows": len(micro), "full_width": full}


MESH_PARTS = ("a11", "moe", "vit", "moe_axes", "lm", "bench", "pp", "fsdp", "resilience",
              "collectives")


def bench_mesh(world: int, card: str, alone: dict) -> dict:
    """The mesh mode's bench part: the port bench's legs over the ``world``
    ranks at their defaults, each at the default N steps a call (one CUDA
    graph of N steps, NCCL's collectives inside the capture): the image leg
    (ResNet-50, batch 512 a chip) at ZeRO 0 and 1, the LM leg
    (GPT-2-small, AdamW, B16 T1024 global) as DP ``world``, ``--tp world``
    and ``--tp world --tp-overlap``. Each runs as ``bench.main`` runs it
    (its JSON line, rank 0's printed), then its graph against eager steps
    from clones at the same world (GRAPH_REPLAYS_NCCL), K2/K3
    counted in the graph (12 · N on the LM legs), at least one NCCL kernel
    node a step on every rank; per-chip images/s and tokens/s beside the
    world-1 run's (``alone``), and each graph's busy share."""
    import torch.distributed as dist

    from distributed_training_tpu_torch import bench

    rank = dist.get_rank()
    n = bench.build_parser().parse_args([]).steps_per_call
    out = {"nccl_version": _nccl_version(), "world1": alone}
    legs = (("image_zero0", "image", []), ("image_zero1", "image", ["--zero-stage", "1"]),
            (f"lm_dp{world}", "lm", []), (f"lm_tp{world}", "lm", ["--tp", str(world)]),
            (f"lm_tp{world}_overlap", "lm", ["--tp", str(world), "--tp-overlap"]))
    for name, leg, flags in legs:
        t0 = time.perf_counter()
        (line, loss), = bench.main([f"--{leg}", *flags])
        if not (line["value"] > 0 and math.isfinite(loss) and f"steps/call:{n}" in line["metric"]):
            raise SystemExit(f"mesh bench {name}: {line}, loss {loss}")
        lm = leg == "lm"
        want = {"fused_adam": 0, "flash_fwd": GPT_LAYERS * n if lm else 0,
                "flash_bwd": GPT_LAYERS * n if lm else 0}
        g = _graph_vs_eager(f"{name} over {world} GPUs", getattr(bench, f"{leg}_step"), flags,
                            want, min_nccl=n, replays=GRAPH_REPLAYS_NCCL)
        out[name] = {"line": line, "loss": loss, "world1_value": alone[leg]["value"],
                     **{k: g[k] for k in ("branch", "gap", "err", "graph_ms_per_step",
                                          "eager_ms_per_step", "graph_busy", "eager_busy",
                                          "graph_kernels", "nccl_kernel_nodes",
                                          "nccl_kernels")}}
        if rank == 0:
            print(f"[mesh] bench {name} over {world} GPUs (NCCL {out['nccl_version']}): "
                  f"{line['value']} {line['unit']} against {alone[leg]['value']} at world 1 "
                  f"on one card ({line['value'] / alone[leg]['value']:.3f}x), mfu "
                  f"{line['mfu']}; graph {g['graph_ms_per_step']:.3f} ms/step, eager "
                  f"{' / '.join(f'{x:.3f}' for x in g['eager_ms_per_step'])}, busy graph "
                  f"{100 * g['graph_busy']:.1f}% / eager {100 * g['eager_busy']:.1f}%; NCCL "
                  f"kernel nodes {g['nccl_kernel_nodes']} in a graph of {n} steps; "
                  f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)
    return out


def mesh_main(parts: list | None = None) -> int:
    """The mesh mode: first the image Trainer's presets at world 1 on each
    rank's card, then over the ranks (A11_BATCH: each against world 1, local
    BN, the ZeRO 1 save), MoE over the data and expert axes, ViT-B/16 over
    the data and model axes (VIT_MESH_BATCH), MoE under the sequence and
    model axes (MOE_NODROP_CAPACITY); then every LM strategy through the GPT
    CLI's trainer at ZeRO 1 (see ``MESH_STEPS``), its tokens/s, peak memory
    and K2/K3 launches (summed over the ranks), its losses against data
    parallelism; the bench's legs over the ranks (:func:`bench_mesh`);
    last, on rank 0 alone, the ZeRO 1 save resumed at world 1. ``parts``
    (names of MESH_PARTS) runs those alone."""
    import torch.distributed as dist

    from distributed_training_tpu_torch import bench
    from distributed_training_tpu_torch.ops import cuda_build
    from distributed_training_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd
    from distributed_training_tpu_torch.runtime import distributed

    parts = list(parts or MESH_PARTS)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if any(p not in MESH_PARTS for p in parts):
        print(f"chip_smoke --mesh: parts are {MESH_PARTS}", file=sys.stderr)
        return 2
    if world not in (2, 4) or torch.cuda.device_count() < world:
        print(f"chip_smoke --mesh: run under torchrun over 2 or 4 GPUs (WORLD_SIZE "
              f"{world}, {torch.cuda.device_count()} GPUs)", file=sys.stderr)
        return 2
    cuda_build.build_all()
    card = card_line()
    torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    alone = bench_alone = {}
    if "a11" in parts:
        with tempfile.TemporaryDirectory() as ckpt, _Alone():
            alone = {p: _image_run(_a11_config(p, os.path.join(ckpt, "w1_" + p), 1))["losses"]
                     for p in DP_PRESETS}
    if "bench" in parts:
        with _Alone():  # each rank's card at world 1, the legs at their defaults
            bench_alone = {leg: bench.main([f"--{leg}"])[0][0] for leg in ("image", "lm")}
    distributed.initialize_distributed()
    rank = dist.get_rank()
    cli = _gpt_cli_module()
    results, ref, saved = {}, None, None
    with tempfile.TemporaryDirectory() as ckpt:
        if "a11" in parts:
            a11 = a11_mesh(world, ckpt, alone, card)
            saved = a11.pop("zero1_saved_model")
            results["a11"] = a11
        if "moe" in parts:
            results["moe"] = moe_mesh(world, ckpt, card)
        if "vit" in parts:
            results["vit"] = vit_mesh(world, ckpt, card)
        if "moe_axes" in parts:
            results["moe_axes"] = moe_axes_mesh(world, ckpt, card)
        pp_saved = fsdp_saved = None
        if "pp" in parts:
            results["pp"] = pp_mesh(world, ckpt, card)
            pp_saved = results["pp"].pop("saved_model")
        if "fsdp" in parts:
            results["fsdp"] = fsdp_mesh(world, ckpt, card)
            fsdp_saved = results["fsdp"].pop("saved_model")
            results["fsdp"]["flight_ab"] = fsdp_flight_ab(world, os.path.join(ckpt, "fsdp_ab"),
                                                          card)
        if "resilience" in parts:
            results["resilience"] = resilience_mesh(world, os.path.join(ckpt, "resilience"),
                                                    card)
        if "collectives" in parts:
            results["collectives"] = collectives_mesh(world, ckpt, card)
        for name, flags in (_mesh_strategies(world) if "lm" in parts else []):
            flash_fwd.launches = flash_bwd.launches = 0
            run = _gpt_cli_run(cli, [*GPT_CLI_WIDTH, "--stage", "1", *flags,
                                     "-c", os.path.join(ckpt, name)])
            counts = torch.tensor([flash_fwd.launches, flash_bwd.launches], device="cuda")
            dist.all_reduce(counts)
            _check_losses(f"mesh {name}", run["losses"], MESH_STEPS)
            if min(flash_fwd.launches, flash_bwd.launches) == 0:
                raise SystemExit(f"mesh {name}: rank {rank} launched no K2/K3")
            ref = ref or run
            worst = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
            if worst > GPT_STAGE_RTOL:
                raise SystemExit(f"mesh {name}: losses {run['losses']} against dp "
                                 f"{ref['losses']}, {worst:.3g} relative")
            results[name] = {"losses": run["losses"], "worst_rel_vs_dp": worst,
                             "final_perplexity": run["result"]["final_perplexity"],
                             "tokens_per_s": run["tokens_per_s"],
                             "step_ms": 1e3 * sum(run["step_s"][1:]) / (MESH_STEPS - 1),
                             "peak_gib_rank0": run["peak_bytes"] / 2**30,
                             "launches_all_ranks": {"flash_fwd": int(counts[0]),
                                                    "flash_bwd": int(counts[1])}}
            if rank == 0:
                r = results[name]
                print(f"[mesh] {name} over {world} GPUs (GPT-2-small, B {GPT_B} T {GPT_T}, "
                      f"bf16, flash, ZeRO 1): {r['tokens_per_s']:.1f} tokens/s, "
                      f"{r['step_ms']:.3f} ms a step, peak {r['peak_gib_rank0']:.3f} GiB on "
                      f"rank 0; K2/K3 launches (all ranks) {r['launches_all_ranks']}; "
                      f"losses {r['losses']} ({worst:.3g} relative of dp's, tolerance "
                      f"{GPT_STAGE_RTOL}); eval perplexity {r['final_perplexity']:.4f}; "
                      f"{card}", flush=True)
        if "bench" in parts:
            results["bench"] = bench_mesh(world, card, bench_alone)
        distributed.shutdown_distributed()
        if rank == 0 and saved is not None:
            results["a11"]["zero1_resume_world1"] = a11_resume(world, ckpt, saved)
        if rank == 0 and pp_saved is not None:
            results["pp"]["pp4_v3_resume_world1"] = pp_resume(ckpt, pp_saved)
        if rank == 0 and fsdp_saved is not None:
            results["fsdp"]["fsdp4_zero0_resume_world1"] = fsdp_resume(ckpt, fsdp_saved)
    if rank != 0:  # rank 0 saw the same comparisons, and reports them
        return 0
    print(json.dumps({"mesh": results}, default=str), flush=True)
    if MESH_FAILURES:
        raise SystemExit(f"mesh: {len(MESH_FAILURES)} comparison(s) failed: {MESH_FAILURES}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase_main(names: list) -> int:
    """``--phase NAME ...``: the build, then only the named phases (kernel,
    bench, dp, gpt_cli, data, ring, moe_lm, moe_image, vit, pipeline,
    flight, trace, resilience, generate, serve, serve_features, fleet),
    for a short check of one part on the card; prints their results and no
    result line."""
    from distributed_training_tpu_torch.ops import cuda_build

    phases = {"kernel": lambda d: kernel_phase(), "bench": lambda d: bench_phase(),
              "dp": dp_phase, "gpt_cli": gpt_cli_phase,
              "data": data_phase, "ring": lambda d: ring_phase(), "moe_lm": moe_lm_phase,
              "moe_image": moe_image_phase, "vit": lambda d: vit_phase(),
              "pipeline": lambda d: pipeline_phase(), "flight": flight_phase,
              "trace": trace_phase, "resilience": resilience_phase,
              "generate": generate_phase, "serve": lambda d: serve_phase(),
              "serve_features": lambda d: serve_features_phase(), "fleet": fleet_phase}
    if not names or any(n not in phases for n in names):
        print(f"chip_smoke --phase: name one or more of {sorted(phases)}", file=sys.stderr)
        return 2
    print(f"[card] {card_line()}; torch {torch.__version__} CUDA {torch.version.cuda}")
    cuda_build.build_all()
    with tempfile.TemporaryDirectory() as ckpt:
        for n in names:
            t0 = time.perf_counter()
            out = phases[n](os.path.join(ckpt, n))
            print(f"[phase] {n} in {time.perf_counter() - t0:.1f} s: "
                  f"{json.dumps(out, default=str)[:4000]}", flush=True)
    return 0


def _timed(name: str, phase, *args):
    """Run one phase of the full script and print its seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[phase] {name} in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--mesh"]:
        return mesh_main(sys.argv[2:])
    if sys.argv[1:2] == ["--phase"]:
        return phase_main(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from distributed_training_tpu_torch.ops import cuda_build

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"[build] {cuda_build.kernel_names()} built in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in cuda_build.build_logs.items():
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {name}: ptxas, kernel by kernel: registers "
              f"{' '.join(regs)}; bytes of spill stores {' '.join(spills)}")
    instantiations = wgmma_build_lines()

    k = _timed("kernel", kernel_phase)
    with tempfile.TemporaryDirectory() as ckpt:
        launches = _timed("train", train_phase, os.path.join(ckpt, "fp32"))
        _timed("fp16", fp16_phase, os.path.join(ckpt, "fp16"))
        bf16 = _timed("bf16_image", bf16_image_phase, os.path.join(ckpt, "bf16"))
        dp = _timed("dp", dp_phase, os.path.join(ckpt, "dp"))
        flash = _timed("flash_kernel", flash_kernel_phase)
        ring = _timed("ring", ring_phase)
        lm = _timed("lm", lm_phase, os.path.join(ckpt, "lm"))
        lm16 = _timed("lm_fp16", lm_fp16_phase, os.path.join(ckpt, "lm_fp16"))
        _timed("cli", cli_phase, os.path.join(ckpt, "cli"))
        gpt = _timed("gpt_cli", gpt_cli_phase, os.path.join(ckpt, "gpt_cli"))
        moe_lm = _timed("moe_lm", moe_lm_phase, os.path.join(ckpt, "moe_lm"))
        moe_img = _timed("moe_image", moe_image_phase, os.path.join(ckpt, "moe_image"))
        flight = _timed("flight", flight_phase, os.path.join(ckpt, "flight"))
        traced = _timed("trace", trace_phase, os.path.join(ckpt, "trace"))
        res = _timed("resilience", resilience_phase, os.path.join(ckpt, "resilience"))
        generated = _timed("generate", generate_phase, os.path.join(ckpt, "generate"))
        served = _timed("serve", serve_phase)
        features = _timed("serve_features", serve_features_phase)
        fleet = _timed("fleet", fleet_phase, os.path.join(ckpt, "fleet"))
    # The new phases' in-process runs: K1 once a step, K2/K3 once a layer a
    # step (the resilience phase's subprocesses count in their own process).
    late_launches = {**traced["launches"], **res["launches"], **generated["launches"]}
    pipe = _timed("pipeline", pipeline_phase)
    half = _timed("fp16_pad", fp16_pad_phase)
    d256 = _timed("d256", d256_phase)
    exp2 = _timed("exp2", exp2_phase)
    k5 = _timed("conv", conv_phase)
    tool_launches, tool_results = _timed("tools", tools_phase)
    bench = _timed("bench", bench_phase)
    vit = _timed("vit", vit_phase)
    with tempfile.TemporaryDirectory() as ckpt:
        data = _timed("data", data_phase, ckpt)
    bench_lm = {"bench_gpt2_small_adamw": bench["launches"]["bench"],
                "bench_gpt2_small_hybrid_adam":
                    bench["launches"]["bench --lm --lm-optimizer hybrid_adam"]}
    replayed = bench["graphs"]["lm_hybrid_adam"]["graph_kernels"]
    replayed_nccl = bench["nccl"]["graphs"]["lm_hybrid_adam"]["graph_kernels"]

    def by_path(name: str, **more) -> dict:
        paths = {**more, **{p: n[name] for p, n in tool_launches.items() if name in n}}
        return {"launches": sum(paths.values()), "launches_by_path": paths}

    def built(prefix: str) -> list:
        """The kernel's tensor-core instantiations, as the build check saw them."""
        return [f"{dtype} {'nc' if name.startswith('K5') else 'd'} {width}: {hgmma} HGMMA"
                for (name, dtype, width), (_, hgmma) in sorted(instantiations.items())
                if name.startswith(prefix)]

    k5_shapes = {}
    for key, r in zip(k5, tool_results["conv_fusion_probe"]):
        k5_shapes[key] = {**{e: r[e] for e in ("out_err", "sum_err", "sumsq_err",
                                                "max_abs_err")},
                          **k5[key], "ms": r["fused_ms"], "library_ms": r["torch_conv_ms"],
                          "library_conv_stats_ms": r["torch_conv_stats_ms"],
                          "tool_line": r["shape"]}
    for key, r in k5_shapes.items():
        print(f"[conv] K5 {key} (probe): ms={r['ms']:.4f}, cuDNN conv {r['library_ms']:.4f}, "
              f"conv + stats {r['library_conv_stats_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({100 * r['bound_ms'] / r['ms']:.1f}%)" + _before(f"conv3x3_stats {key}", r["ms"]))
    s0 = k5_shapes["s0"]
    ring_names = ("flash_fwd", "flash_bwd")  # the kernels each ring hop runs
    flash_src = "distributed_training_tpu_torch/csrc/flash_attention.cu"
    split_src = "distributed_training_tpu_torch/csrc/flash_attention_split.cu"
    ref = "distributed_training_tpu/ops/flash_attention.py"
    # Every check above raises before this line when it fails.
    kernels = [{
        "name": "fused_adam", "route": "cuda",
        "source": "distributed_training_tpu_torch/csrc/fused_adam.cu",
        "replaces": "distributed_training_tpu/ops/fused_adam.py:40",
        "launches": (launches + sum(bf16.values()) + lm["fused_adam"] + lm16["fused_adam"]
                     + sum(r["launches"] for r in dp.values())
                     + sum(n["fused_adam"] for n in bench_lm.values())
                     + sum(data["launches"].values())
                     + moe_lm["launches"]["fused_adam"] + moe_img["launches"]
                     + sum(r["fused_adam"] for r in pipe["runs"].values())
                     + sum(r["fused_adam"] for r in flight["launches"].values())
                     + sum(r["fused_adam"] for r in late_launches.values())),
        "launches_by_path": {"resnet18_train": launches,
                             **{f"resnet18_train_{tag}": n for tag, n in bf16.items()},
                             **{f"resnet18_{p}_nccl_world1": r["launches"]
                                for p, r in dp.items()},
                             "gpt2_small_train": lm["fused_adam"],
                             "gpt2_small_train_fp16": lm16["fused_adam"],
                             **{p: n["fused_adam"] for p, n in bench_lm.items()
                                if n["fused_adam"]},
                             **data["launches"],
                             **{f"gpt2_small_{n}": r["launches"]["fused_adam"]
                                for n, r in moe_lm["runs"].items()},
                             "moe_mlp_cli": moe_img["launches"],
                             **{f"pipeline_{n}_bf16_steps": r["fused_adam"]
                                for n, r in pipe["runs"].items()},
                             **{p: r["fused_adam"] for p, r in flight["launches"].items()},
                             **{p: r["fused_adam"] for p, r in late_launches.items()}},
        "graph_replay_launches": {"bench_gpt2_small_hybrid_adam": replayed["fused_adam"],
                                  "bench_gpt2_small_hybrid_adam_nccl_world1":
                                      replayed_nccl["fused_adam"]},
        **k, "ok": True,
    }, *({
        "name": name, "route": "cuda", "source": src, "replaces": f"{ref}:{line}",
        **by_path(name, **({"gpt2_small_train": lm[name],
                            "gpt2_small_train_fp16": lm16[name],
                            "gpt_cli_gpt2_small_zero2_remat": gpt["launches"][name],
                            **{f"gpt2_small_{n}": r["launches"][name]
                               for n, r in moe_lm["runs"].items()},
                            **{p: n[name] for p, n in bench_lm.items()},
                            **{f"ring_{c}": r["launches"][name] for c, r in ring.items()},
                            **{f"pipeline_{n}_step": r["launches"][name]
                               for n, r in pipe["runs"].items()},
                            **{p: r[name] for p, r in flight["launches"].items() if r[name]},
                            **{p: r[name] for p, r in late_launches.items() if r[name]}}
                           if name in lm else {})),
        **({"ring": {c: {"launches": r["launches"][name], "hops": r["hops"],
                         "rank_hop_ms": [x["K2" if name == "flash_fwd" else "K3"]
                                         for x in r["rank_hop_ms"]],
                         "unsharded_over_p_ms": r["unsharded_over_p_ms"][
                             "K2" if name == "flash_fwd" else "K3"]}
                     for c, r in ring.items()}} if name in ring_names else {}),
        **flash[name], "d256": d256["d256"][name], "d512": d256["d512"][name],
        "exp2_ms": exp2[name],
        **({"graph_replay_launches": {"bench_gpt2_small_hybrid_adam": replayed[name],
                                      "bench_gpt2_small_hybrid_adam_nccl_world1":
                                          replayed_nccl[name]}}
           if name in replayed else {}),
        "fp16_ms": half["ms"][name],
        "fp16_max_abs_err": half["max_abs_err"][name],
        "instantiations": built(tag), "ok": True,
    } for name, src, line, tag in (
        ("flash_fwd", flash_src, 107, "K2"), ("flash_bwd", flash_src, 280, "K3"),
        ("flash_bwd_dq", split_src, 212, "K4a"), ("flash_bwd_dkv", split_src, 243, "K4b"))), {
        "name": "conv3x3_stats", "route": "cuda",
        "source": "distributed_training_tpu_torch/csrc/conv3x3_stats.cu",
        "replaces": "tools/conv_fusion_probe.py:55", **by_path("conv3x3_stats"),
        "shape": "s0", "ms": s0["ms"], "plain_ms": s0["plain_ms"],
        "library_ms": s0["library_ms"], "library_call": "F.conv2d bf16 (cuDNN)",
        "bound_ms": s0["bound_ms"], "bound_by": s0["bound_by"],
        "max_abs_err": max(r["max_abs_err"] for r in k5_shapes.values()),
        "by_shape": k5_shapes, "fp16_ms": half["k5"]["s0"]["ms"],
        "fp16_max_abs_err": max(r["max_abs_err"] for r in half["k5"].values()),
        "fp16_by_shape": half["k5"], "instantiations": built("K5"), "ok": True,
    }]
    print(json.dumps({"vit": vit}))
    print(json.dumps({"pipeline": pipe}))
    print(json.dumps({"flight": {k: v for k, v in flight.items() if k != "launches"}},
                     default=str))
    for tag, phase in (("trace", traced), ("resilience", res), ("generate", generated),
                       ("serve", served), ("serve_features", features), ("fleet", fleet)):
        print(json.dumps({tag: {k: v for k, v in phase.items() if k != "launches"}},
                         default=str))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
