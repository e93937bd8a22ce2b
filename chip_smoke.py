#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA host

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   eight CUDA kernel sources from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the served paths give it (N = 2 images, per-row scales): int32
   accumulators equal, ``y`` within 1 ulp, requantized int8 codes off by
   at most 1 on at most 1e-5 of them; ``sparse_matvec`` and
   ``cfmm_matmul`` (the int8 and cfmm modes' product) also at the LM's
   linear shapes, ``cfmm_matmul`` with its plan (variant, tiles,
   splits), also at the dense LM configs' widest linears and untied
   heads; ``sparse_matvec`` also at Gemma3-1B's; both at OLMoE-1B-7B's
   expert linears (M = the expert queue's cap: 160, 80, 16 for the 1024-,
   512- and 64-token buckets, 8 in decode) and attention linears, and at
   DeepSeek-V2-Lite-16B's expert linears (cap 120 and 8), ``cfmm_matmul``
   also at its MLA projections (q, kv_down, k_up / v_up, o at 1024
   tokens);
   ``flash_attention`` in bf16 and f32 at SmolLM-360M's prefill shapes,
   rectangular Tq < Tk, a non-causal Tk = 1500, a Gemma3-like window and
   Dv != D, and in bf16 at the prefill shapes of StableLM-3B (D = 80),
   Gemma3-1B (D = 256, window 512 and none), Phi-3-medium and
   OLMoE-1B-7B (D = 128), DeepSeek-V2-Lite's MLA (D = 192, Dv = 128) and
   Qwen2-VL-7B (D = 128, G = 7) at T = 1024, Whisper-small's encoder and
   cross-attention (4 clips of 1500 frames, G = 1, non-causal; a 4-token
   prompt's and a decode step's one query row against 1500 keys), and a
   non-causal Tq = 448 > Tk = 24 in bf16 and f32, within ``FLASH_TOL``; the
   flash-attention backward
   (``flash_attention_bwd``, the training path's gradient) in bf16 and f32
   at ``FLASH_BWD_SHAPES`` (SmolLM-360M's and Gemma3-1B's training shapes,
   seq 512 x batch 8, Whisper-small's at batch 2, 1500 frames and 448
   tokens, Tq > Tk, and the served attention shapes above) from the
   forward kernel's output and log-sum-exp, within ``FLASH_BWD_TOL`` of
   its plain version, timed beside its bound and SDPA's backward (its
   backend named) between CUDA events and as the profiler's kernel
   durations; ``cfmm_matmul`` also at the SSM
   paths' linears (Mamba's x_proj and dt_proj, RWKV's low-rank mix and
   decay projections, Jamba's experts, both 65536-token heads) and at
   Qwen2-VL-7B's (k/v, gate/up, down, its 152064-token head) and, with
   ``sparse_matvec``, Whisper-small's (6000 encoder rows, the prompts'
   and decode rows, its 51865-token head); prints the
   variant each shape runs (flash and its backward: the tensor-core
   ``mma`` or the CUDA-core ``fma`` kernels; ``sparse_matvec``: ``rows``
   or ``split`` and its split over K); times each (median of CUDA-event
   timings of CUDA-graph replays) beside its bound and, where one PyTorch
   call computes the same function, that call (SDPA for attention, a
   window or Tq < Tk as its boolean mask;
   ``torch._int_mm`` on the dense or unpacked codes for ``sparse_matvec``
   and every conv shape — of an im2col built outside the timed region,
   K zero-padded to a multiple of 8), checked against the kernel's int32
   output; the conv lines also print each shape's launch plan
   (``conv_implicit.plan``: copy widths, tiles, splits x chunks); the
   depthwise kernel at MobileNetV2's ten shapes is held tighter (y 0 ulp,
   amax equal, no y_q code off) and prints its plan
   (``conv_depthwise.plan``: slice, rows per band, column words, copy
   width, threads, grid, shared memory); its ``profile_g`` zero counts
   at three shapes (counted in the epilogue) and one (recounted on y)
   equal the plain version's dict, with y, amax and acc the same with
   profiling on and off; so do both conv kernels' zero counts
   (``CONV_ZERO_COUNTS``: g = 4, 8, 32, 64 counted in the epilogue, at
   tiles in one image and across images and under split K; g = 128
   recounted on y), each printed with the call's time profiled and not;
   a ``[floor]`` line times one trivial graph node
   (a 2-element ``torch.zeros``, a 2-element add) under the same timer;
2b. drives ``ops.block_sparse_matmul`` (no served path of the JAX package
   calls it) in f32 and bf16, TF32 off: (A) the paper's recipe at every
   distinct shape of ResNet50's 1x1 convs (224 px, microbatch 2) —
   seeded N(0, 1) weights pruned to 80 %, INT7 codes, ``cluster_rows``,
   x's columns and w's rows permuted alike — at blocks of 64 x 64 and,
   where they tile, 128 x 128, printing the block sparsity before and
   after clustering; (B) four shapes (ResNet50 conv2_x, conv4_x,
   conv5_x, SmolLM-360M's gate/up at 1024 tokens) with 100, 50 and 20 %
   of their 64 x 64 blocks kept, printing kernel time per active block;
   (C) an empty mask (zeros, no launch), an empty block column, ragged
   M, a 48 x 80 block and bf16 weights that round; each line with its
   plan (``block_sparse.plan``: variant, tiles, splits), and the bf16 and
   f32 sums apart.  Each call's output
   is held to the kernel's plain version within ``BS_RTOL``/``BS_ATOL``
   (and part A's to the unpermuted ``x @ w``), and timed beside its
   bound, the plain version and one cuBLAS ``torch.matmul`` of x with
   the dense masked weights;
3. serves, through ``PipelineEngine`` on the card, seeded random weights
   at full width (224 px, 1000 classes): ResNet50 in ``int8`` and
   ``sparse_cfmm`` at 1 and 2 stages and in ``cfmm`` and ``bitserial`` at
   1 stage; MobileNetV2 in ``int8`` and ``sparse_cfmm`` and RepVGG-A0
   (fused) in ``int8``, at 1 and 2 stages.  Each run is three requests of
   1, 2 and 3 images at microbatch 2.  Checks finite logits, top-1 and
   max |dlogit| (tolerance 0) of the first request against the same
   forward on the CPU's plain versions, 1- and 2-stage logits
   bit-identical, and the launch counters of every kernel (set to 0
   just before each run, read just after) against the path's count per
   microbatch; each 1-stage run's profile prints ``conv_mma_kernel`` and
   ``conv_dw_kernel`` ms (MobileNetV2's must show the latter);
3b. serves full-width ResNet50 behind the port's ``ResNetFrontend``: 2
   replicas x 1 stage on the one card, microbatch 2, the serve phase's
   compiled trees (``fleet_phase``): a closed wave, then (a) an open-loop
   ``poisson_plan`` wave of 16 requests of 1-3 images at 0.7 x its rows/s
   (p50/p95 latency, queue depth, rows per replica, bubble attribution,
   shed count), (b) the same requests with replica 1 killed at its step
   2 (rows requeued), (c) a traced open-loop wave whose Chrome trace must
   validate, (d) profiled waves (groups of 8) in ``int8`` and
   ``sparse_cfmm`` whose sparsity snapshot must equal the CPU
   ``reference_profile``; every request's logits bit-identical to the
   single-engine card forward of its rows, the launch counters checked
   per wave;
3c. runs the CNN zoo's dense reference forwards (the ``dense`` mode:
   im2col + ``torch.matmul``, no port kernel) at full width on the card,
   2 images: ResNet50, MobileNetV2, RepVGG-A0 fused and unfused, each
   within ``DENSE_CNN_REL_BOUND`` of the CPU's dense forward, ResNet50's
   distance to its served ``int8`` logits printed;
4. serves the LM zoo at full width (``LM_PATHS``; seeded random
   weights initialised and compiled on the card, one model tree and one
   engine alive at a time) through the LM ``ServingEngine``: SmolLM-360M
   in ``int8``, ``sparse_cfmm`` and ``dense`` (8 requests of 37-1000
   prompt tokens, 8 new tokens each), Gemma3-1B in ``dense``, ``int8``
   and ``sparse_cfmm``, StableLM-3B and Phi-3-medium-14B (published
   widths, 20 of Phi-3's 40 layers) in ``dense`` and
   ``int8`` (4 requests of 37-1000 tokens, 8 new tokens each), the MoE
   OLMoE-1B-7B in ``dense`` at its 16 layers and in ``int8`` and
   ``sparse_cfmm`` at 8 of them, and the MLA +
   MoE DeepSeek-V2-Lite-16B (published widths; its dense first layer,
   64 routed experts top-6 beside 2 shared) in ``dense`` at its published
   depth of 27 layers and in ``int8`` at 4 (2 requests of 37 and 777
   tokens, 2 new tokens each: one decode step), the recurrent RWKV6-7B
   (published widths and depth) on the dense configs'
   traffic and Jamba-v0.1 (published widths, one period of 8 of its 32
   layers: Mamba, attention, 16 experts top-2) on
   OLMoE's, in ``dense`` and ``int8``, and Qwen2-VL-7B (M-RoPE, published
   widths and depth: 28 layers, 28 heads over 4 KV heads) on the dense
   configs' traffic in ``dense`` and ``int8``, 4 slots.
   Checks one ``flash_attention`` launch per attention layer and
   request, and per forward one ``cfmm_matmul`` (``int8``) or
   ``sparse_matvec`` (``sparse_cfmm``) per linear (``lm_linears``: 7 per
   dense layer, 4 + 3 per expert in an MoE layer, and the untied head;
   MLA's 5 in a prefill and 3 in a decode step, whose absorbed path
   takes k_up and v_up as dense weights: 5209 and 5155 per DeepSeek
   forward at 27 layers, 609 and 601 at 4; 4 per Mamba mixer, 11 per
   RWKV layer: 353 per RWKV6 forward, 237 per Jamba period), the
   first prefills' logits against the CPU's plain forward of the same
   tree (SmolLM two, Gemma3 one; the others are too large for a CPU
   forward in the time), and the logits and greedy tokens against a card
   run with the plain versions of every kernel of the path substituted,
   all within ``LM_LOGIT_BOUND`` (StableLM's, Phi-3's and DeepSeek's
   ``int8`` decode steps within their ``LM_DECODE_BOUNDS``, Gemma3's
   ``sparse_cfmm`` ones there on its long-prompt slots, with the witnesses
   of where that spread comes from: ``decode_witnesses``, in an MoE stack
   each pair of runs on one routing); in every compiled mode
   also against a card run with only the linears' plain version (the
   float64 product) substituted, which must be equal to the bit, and in
   ``int8`` that run's profile beside the kernel run's (which must show
   no float64 GEMM); in the compiled modes one stacked leaf compiled on
   the card equals the CPU's compile byte for byte; in ``dense`` the
   bucketed prefill against the unpadded one on the card, within
   ``LM_BUCKET_BOUND`` (an MoE stack at a capacity that keeps every
   pick: the capacity follows the padded token count), which a planted
   length fault must fail; a recurrent stack instead prefills at exact
   length (checked) and runs the state-carry witness: prefill(T + 1)
   against prefill(T) and one decode step, within ``LM_LOGIT_BOUND``,
   which the step on a zeroed recurrent state must fail (RWKV: the card
   keeps the decay floor's subnormal); in an MoE stack the share of
   routing picks equal between the kernel run and the plain run, and
   the witness of a spread past the bounds: the kernel run on the plain
   run's picks replayed (``RouteRecorder``), held to the bounds;
   Qwen2-VL-7B adds two checks (``LM_EXTRA_CHECKS``): (a) in ``dense``, a
   1000-token prompt in its layout (10 text tokens, a 1 x 24 x 32 image at
   3-D positions, 222 text tokens) prefilled with its ``positions`` and
   decoded 4 steps, within ``LM_LOGIT_BOUND`` of the plain flash, its 10
   leading tokens' logits bit-equal to text positions' and the rest moved
   past twice the bound (``mrope_check``); (b) in ``int8``, the four prompts
   served into an int8 KV cache one slot each, its codes and scales equal
   to the plain-linear run's to the bit, its prefills (and each request
   served alone) within the bound of the plain versions', its decode
   steps within ``LM_KV_INT8_BOUND`` (witnessed: the bf16 cache's
   spread, per-row scales, a lost tile), read beside the bf16 cache's,
   its bytes against bf16 (``int8_kv_check``);
   reports prefill and decode tokens/s, one profiled run's idle share
   (device time summed from the profiler's raw events), the ``int8``
   compile's peak and the peak device memory of each path;
4a. runs the encoder-decoder, Whisper-small, at its published widths and
   depth (12 + 12 layers, d 768; seeded random weights initialised on the
   card) through ``lm.forward_prefill`` and ``lm.forward_decode`` (no
   engine takes frames, as in the JAX package): (d) one training step in
   ``dense`` (batch 2, 1500 frames, 448 tokens), its gradients against the
   plain attention's within ``TRAIN_GRAD_BOUND`` per leaf (SDPA and a lost
   KV tile as witnesses); then in ``dense``, ``int8`` and ``sparse_cfmm``
   4 clips of 1500 frames, 4-token prompts, 32 greedy tokens each, the
   launch counts of the run checked (``whisper_launches``), (a) every
   call's logits within ``LM_LOGIT_BOUND`` of the CPU's plain forward
   (clip 0 alone on both, 4 tokens) and of the card's plain versions, equal to the bit to the linears' plain
   version alone, (b) the decode steps against ``forward_train`` of the
   same tokens (tests/test_decode.py's protocol), (c) the cross cache bf16
   (12, 4, 1500, 12, 64) and equal to the prefill's projections in bf16;
   prints the encoder's ms per clip, prefill ms, decode tokens/s, peak
   memory, the ``int8`` compile's peak and one profiled run's idle share;
4b. trains through ``repro_torch.launch.train.main`` at full width, seq
   512, batch 8, Markov data (``train_phase``): SmolLM-360M 12 plain steps
   (finite loss that falls), the same run crashed at step 8 (exit 42, a
   checkpoint at 8) and resumed, each step's loss equal to the
   uninterrupted run's to the bit (``torch.use_deterministic_algorithms``
   on), 4 QAT steps resumed from that checkpoint, one step's gradients
   against the plain attention's (per leaf relative L2 within
   ``TRAIN_GRAD_BOUND``, with an SDPA witness and a planted lost KV tile
   that must fail it), and Gemma3-1B 4 plain steps (D = 256, window 512);
   each path prints its median step, train tok/s, peak memory and flash
   launches per step (checked: two forwards per template layer under the
   remat, one backward per attention layer), and a profiled step its
   device time by phase and idle share;
5. runs the seven example ports (``examples/torch_*.py``) from ``main``
   on the card at their default flags: each one's own checks and "OK"
   line, and the launch counters of the kernels on its path;
5b. distribution and the dry run (``dist_phase``, ``[dist]``): (a) a
   world-1 NCCL process group (a ``file://`` store in a temporary
   directory) and its 1 x 1 ("data", "model") ``DeviceMesh``:
   ``param_shardings`` over SmolLM-360M's full-width ``int8`` serve tree
   (on the meta device) gives ``Replicate()`` on every leaf, and
   ``distribute_params`` of the MoE layer below gives it back to the bit;
   (b) ``a2a_expert_exchange`` (``all_to_all_single`` over NCCL) of one
   MoE layer at OLMoE-1B-7B's published widths (d 2048, 64 experts of
   d_ff 1024, top-8; seeded f32 weights on the card), 256 tokens at a
   capacity where no pick drops, its experts compiled in ``int8``
   (``cfmm_matmul``, 3 launches an expert over the ep * cap received
   slots) and ``sparse_cfmm`` (``sparse_matvec``), against
   ``moe_forward``'s expert path on the same picks and gates and against
   the same exchange with the plain versions substituted, within
   ``DIST_BOUND``; (c) one dry-run cell through the entry point, ``python
   -m repro_torch.launch.dryrun --arch olmoe_1b_7b --shape decode_32k
   --mesh single``, its line printed (an analytic projection on H100
   SXM constants, not a measurement);
6. prints the ``kernels`` JSON line, then ``{"ok": true, ...}`` last.

Any failed check raises: the script exits non-zero and prints no ``ok``
line.  It also fails without CUDA, and outside a checkout of the repo.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's peaks, kept in one place
from repro_torch.roofline.analysis import (HBM_BW, PEAK_BF16,  # noqa: E402
                                           PEAK_F32, PEAK_INT8)

TIMING_REPS = 25
SERVE_REPS = 5

# kernel launches per microbatch forward, per served (model, mode)
RESNET50_CONVS = 53          # stem + 16 blocks x 3 + 4 projections
MOBILENET_V2_CONVS = 35      # stem + 16 expand + 17 project + tail
MOBILENET_V2_DW = 17         # one depthwise 3x3 per block
REPVGG_A0_CONVS = 22         # 1 + 2 + 4 + 14 + 1 fused 3x3 blocks
PER_MICROBATCH = {
    ("resnet50", "int8"): {"conv_implicit": RESNET50_CONVS,
                           "cfmm_matmul": 1},
    ("resnet50", "sparse_cfmm"): {"conv_sparse": RESNET50_CONVS,
                                  "sparse_matvec": 1},
    ("resnet50", "cfmm"): {"conv_implicit": RESNET50_CONVS,
                           "cfmm_matmul": 1},
    ("resnet50", "bitserial"): {"conv_implicit": RESNET50_CONVS},
    ("mobilenet_v2", "int8"): {"conv_implicit": MOBILENET_V2_CONVS,
                               "conv_depthwise": MOBILENET_V2_DW,
                               "cfmm_matmul": 1},
    ("mobilenet_v2", "sparse_cfmm"): {"conv_sparse": MOBILENET_V2_CONVS,
                                      "conv_depthwise": MOBILENET_V2_DW,
                                      "sparse_matvec": 1},
    ("repvgg_a0", "int8"): {"conv_implicit": REPVGG_A0_CONVS,
                            "cfmm_matmul": 1},
}
# (model, mode, stage counts served)
SERVED = [
    ("resnet50", "int8", (1, 2)),
    ("resnet50", "sparse_cfmm", (1, 2)),
    ("resnet50", "cfmm", (1,)),
    ("resnet50", "bitserial", (1,)),
    ("mobilenet_v2", "int8", (1, 2)),
    ("mobilenet_v2", "sparse_cfmm", (1, 2)),
    ("repvgg_a0", "int8", (1, 2)),
]
# the port's kernels as torch.profiler names them
OUR_KERNELS = ("conv_mma_kernel", "sparse_mma_kernel", "conv_dw_kernel",
               "cfmm_mma_kernel", "flash_kernel", "flash_mma_kernel")


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=TIMING_REPS, per_graph=10) -> float:
    """Device time of one ``fn()`` call: ``per_graph`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between CUDA events,
    median over the replays divided by ``per_graph``.  The graph keeps
    the host's per-call Python and launch overhead out of the number."""
    for _ in range(3):                       # warm up: builds, allocator
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    del graph
    return float(np.median(times))


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in representable f32 steps between a and b."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def popcount(bitmap: torch.Tensor) -> int:
    return sum(int(((bitmap >> j) & 1).sum()) for j in range(8))


def bound_ms(ops: float, nbytes: float, peak=PEAK_INT8) -> tuple:
    t_ops, t_bytes = ops / peak, nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def fmt(x) -> str:
    return "null" if x is None else f"{x:.4f}"


def compare_conv_outputs(label, acc, acc_p, y, y_p, amax, amax_p):
    """A conv kernel's outputs against its plain version's: int32
    accumulators equal, ``y`` within 1 ulp, the requantized int8 codes
    off by at most 1 on at most 1e-5 of them.  Returns (max |dy|, ulps,
    code mismatches)."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    check(torch.equal(acc, acc_p), f"{label}: int32 accumulators differ")
    ulps = ulp_distance(y, y_p)
    dy = float((y - y_p).abs().max())
    s, s_p = ops.requant_scale(amax), ops.requant_scale(amax_p)
    q = torch.clamp(torch.round(y / s.reshape(-1, 1, 1, 1)), -127, 127)
    q_p = torch.clamp(torch.round(y_p / s_p.reshape(-1, 1, 1, 1)), -127, 127)
    dq = (q - q_p).abs()
    mism = int((dq > 0).sum())
    check(ulps <= 1, f"{label}: y off by {ulps} ulp")
    check(int(dq.max()) <= 1 and mism / q.numel() <= 1e-5,
          f"{label}: {mism} y_q codes differ (max {int(dq.max())})")
    return dy, ulps, mism


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

# (name, k, stride, c_in, c_out, input hw, relu, shortcut kind)
CONV_SHAPES = [
    ("stem", 7, 2, 3, 64, 224, True, None),
    ("conv2_x_2/b", 3, 1, 64, 64, 56, True, None),
    ("conv3_x_1/a", 1, 2, 256, 128, 56, True, None),
    ("conv4_x_2/b", 3, 1, 256, 256, 14, True, None),
    ("conv5_x_1/c", 1, 1, 512, 2048, 7, True, "f32"),
    ("conv5_x_2/c", 1, 1, 512, 2048, 7, True, "int8"),
    ("mbv2 stem", 3, 2, 3, 32, 224, True, None),
    ("mbv2 block14/pj", 1, 1, 576, 96, 14, False, "int8"),
    ("repvgg stage5_1", 3, 2, 192, 1280, 14, True, None),
    ("conv5_x_2/b", 3, 1, 512, 512, 7, True, None),
    ("conv4_x_2/a", 1, 1, 1024, 256, 14, True, None),
]
# MobileNetV2's depthwise 3x3 convs at 224 px: (C, input hw, stride)
DW_SHAPES = [(32, 112, 1), (96, 112, 2), (144, 56, 1), (144, 56, 2),
             (192, 28, 1), (192, 28, 2), (384, 14, 1), (576, 14, 1),
             (576, 14, 2), (960, 7, 1)]
# cfmm_matmul, the product of every int8 and cfmm linear: (label, M, K,
# N) at the CNN heads (M = 128 exercises the row tiling) and at
# SmolLM-360M's linears in decode (4 slots) and prefill (64, 1024 tokens)
CFMM_SHAPES = [("head", 2, 2048, 1000), ("head", 2, 1280, 1000),
               ("head", 128, 2048, 1000), ("LM decode", 4, 960, 2560),
               ("LM decode", 4, 2560, 960), ("LM gate/up", 64, 960, 2560),
               ("LM q/o", 1024, 960, 960), ("LM k/v", 1024, 960, 320),
               ("LM gate/up", 1024, 960, 2560), ("LM down", 1024, 2560, 960),
               # the dense LM configs' widest linears and untied heads
               # (the prefill's head takes the last position only: M = 1)
               ("Gemma3 gate/up", 1024, 1152, 6912),
               ("StableLM gate/up", 1024, 2560, 6912),
               ("StableLM head decode", 4, 2560, 50304),
               ("Phi-3 gate/up", 1024, 5120, 17920),
               ("Phi-3 down", 1024, 17920, 5120),
               ("Phi-3 gate/up decode", 4, 5120, 17920),
               ("Phi-3 head prefill", 1, 5120, 100352),
               ("Phi-3 head decode", 4, 5120, 100352),
               # Qwen2-VL-7B: d 3584, d_ff 18944, 4 KV heads of 128, its
               # 152064-token head
               ("Qwen2-VL k/v", 1024, 3584, 512),
               ("Qwen2-VL gate/up", 1024, 3584, 18944),
               ("Qwen2-VL down", 1024, 18944, 3584),
               ("Qwen2-VL head decode", 4, 3584, 152064)] + [
    # OLMoE-1B-7B: each expert's linears on its queue of cap rows (cap
    # 160, 80, 16 for the 1024-, 512- and 64-token buckets, 8 in decode)
    # and the attention linears at 1024 tokens
    (f"OLMoE expert {name} cap={M}", M, K, N)
    for M in (160, 80, 16, 8)
    for name, K, N in (("gate/up", 2048, 1024), ("down", 1024, 2048))] + [
    ("OLMoE q/k/v/o", 1024, 2048, 2048)] + [
    # DeepSeek-V2-Lite-16B: each routed expert's linears on its queue (cap
    # 120 at the 1024-token bucket, 8 in decode and at 64 tokens) and the
    # MLA projections at 1024 tokens: q (2048 x 16 heads x 192), kv_down
    # (2048 x 512 + 64), k_up / v_up (512 x 16 heads x 128) and o
    (f"DeepSeek expert {name} cap={M}", M, K, N)
    for M in (120, 8)
    for name, K, N in (("gate/up", 2048, 1408), ("down", 1408, 2048))] + [
    ("DeepSeek MLA q", 1024, 2048, 3072),
    ("DeepSeek MLA kv_down", 1024, 2048, 576),
    ("DeepSeek MLA k_up/v_up", 1024, 512, 2048),
    ("DeepSeek MLA o", 1024, 2048, 2048)] + [
    # the SSM paths (exact-length prefills of 777 and 1000 tokens, 4 slots
    # in decode): Mamba's x_proj (8192 -> dt_rank 256 + 2 x d_state 16)
    # and dt_proj; RWKV6's low-rank token-shift mix (5 x 32), decay
    # lora (64) in and out; Jamba's experts on their queues (cap 128 at
    # 777 tokens, 8 at 37 and in decode); both configs' 65536-token heads
    ("Mamba x_proj", 777, 8192, 288), ("Mamba dt_proj", 777, 256, 8192),
    ("Mamba x_proj decode", 4, 8192, 288),
    ("RWKV mix_lora_a", 1000, 4096, 160), ("RWKV w_lora_a", 1000, 4096, 64),
    ("RWKV w_lora_b", 1000, 64, 4096), ("RWKV w_lora_b decode", 4, 64, 4096)
] + [(f"Jamba expert {name} cap={M}", M, K, N)
     for M in (128, 8)
     for name, K, N in (("gate/up", 4096, 14336), ("down", 14336, 4096))] + [
    ("SSM head prefill", 1, 4096, 65536), ("SSM head decode", 4, 4096, 65536)
] + [
    # Whisper-small: the encoder over 4 clips of 1500 frames (6000 rows:
    # q/k/v/o and the cross-attention's k/v, gate/up, down), the 4-token
    # prompts (16 rows), the decode slots, its untied 768 x 51865 head
    ("Whisper enc q/k/v/o", 6000, 768, 768),
    ("Whisper enc gate/up", 6000, 768, 3072),
    ("Whisper enc down", 6000, 3072, 768),
    ("Whisper dec q/o prompt", 16, 768, 768),
    ("Whisper dec gate/up decode", 4, 768, 3072),
    ("Whisper dec down decode", 4, 3072, 768),
    ("Whisper head decode", 4, 768, 51865)]


def conv_case(spec, dev, gen):
    """Inputs of one served conv: int8 activations, dense and
    bitmap-packed weights compiled as the model compiles them, per-row
    dequant rows, bias and the shortcut."""
    from repro_torch.core.compiled_linear import _compile_leaf_2d
    name, k, stride, c_in, c_out, hw, relu, sc_kind = spec
    N = 2
    x = torch.randint(-127, 128, (N, hw, hw, c_in), generator=gen,
                      dtype=torch.int8)
    w = torch.randn((c_in * k * k, c_out), generator=gen) / (c_in * k * k) ** .5
    dense = _compile_leaf_2d(w, "int8", 0.8, conv_k=k)
    packed = _compile_leaf_2d(w, "sparse_cfmm", 0.8, conv_k=k)
    x_scale = 0.02 + 0.01 * torch.rand((N,), generator=gen)
    eff = (x_scale.reshape(-1, 1) * dense["scale"].reshape(1, -1)).float()
    bias = 0.1 * torch.randn((c_out,), generator=gen)
    h_out = -(-hw // stride)
    shortcut = None
    if sc_kind == "f32":
        shortcut = torch.randn((N, h_out, h_out, c_out), generator=gen)
    elif sc_kind == "int8":
        shortcut = (torch.randint(-127, 128, (N, h_out, h_out, c_out),
                                  generator=gen, dtype=torch.int8),
                    0.02 + 0.01 * torch.rand((N,), generator=gen))
    to = lambda t: t.to(dev).contiguous()
    sc = (None if shortcut is None else
          (tuple(map(to, shortcut)) if isinstance(shortcut, tuple)
           else to(shortcut)))
    return dict(name=name, k=k, stride=stride, relu=relu, x=to(x),
                w_sp=to(dense["values"]), bitmap=to(packed["bitmap"]),
                values=to(packed["values"]), eff=to(eff), bias=to(bias),
                shortcut=sc, sc_kind=sc_kind, N=N, h_out=h_out,
                c_in=c_in, c_out=c_out, hw=hw)


def conv_bytes(c, weight_bytes):
    N, m, n_out = c["N"], c["h_out"] ** 2, c["c_out"]
    b = (c["x"].numel() + weight_bytes + c["eff"].numel() * 4
         + n_out * 4 + N * m * n_out * 4 + N * 4)
    if c["sc_kind"] == "f32":
        b += N * m * n_out * 4
    elif c["sc_kind"] == "int8":
        b += N * m * n_out + N * 4
    return b


def im2col_operands(c, codes):
    """``torch._int_mm`` operands of one conv: the (M, K8) int8 im2col of
    the SAME-padded input in spatial-major order (row = tap*C + c) and
    the (K8, n_out) codes column-major, K zero-padded to K8, the next
    multiple of 8."""
    from repro_torch.kernels import ref
    k, stride, C = c["k"], c["stride"], c["c_in"]
    K = k * k * C
    K8 = -(-K // 8) * 8
    xp, h_out, w_out = ref.pad_same_nhwc(c["x"], k, stride)
    cols = [xp[:, dy:dy + (h_out - 1) * stride + 1:stride,
               dx:dx + (w_out - 1) * stride + 1:stride, :]
            for dy in range(k) for dx in range(k)]
    a = torch.cat(cols, dim=-1).reshape(-1, K)
    a = F.pad(a, (0, K8 - K)).contiguous()
    b = F.pad(codes[:K], (0, 0, 0, K8 - K))
    return a, b.t().contiguous().t()


def check_conv_kernel(kind, c):
    """One conv kernel at one shape against its plain version, on the
    card.  Returns the shape's row for the kernels line."""
    from repro_torch.core.compiled_linear import bitmap_unpack
    from repro_torch.kernels import conv_implicit, conv_sparse
    kw = dict(k=c["k"], stride=c["stride"], relu=c["relu"])
    if kind == "conv_implicit":
        args = (c["x"], c["w_sp"], c["eff"], c["bias"], c["shortcut"])
        kern, plain = conv_implicit.conv2d_implicit, \
            conv_implicit.conv2d_implicit_plain
        nnz = c["w_sp"].numel()        # a dense product does every MAC
        wbytes = c["w_sp"].numel()
    else:
        args = (c["x"], c["bitmap"], c["values"], c["eff"], c["bias"],
                c["shortcut"])
        kern, plain = conv_sparse.conv2d_sparse, \
            conv_sparse.conv2d_sparse_plain
        nnz = popcount(c["bitmap"])   # only nonzero weights need a MAC
        wbytes = c["bitmap"].numel() + c["values"].numel()
    y, amax, acc = kern(*args, return_acc=True, **kw)
    y_p, amax_p, acc_p = plain(*args, return_acc=True, **kw)
    dy, ulps, mism = compare_conv_outputs(f"{kind} {c['name']}", acc, acc_p,
                                          y, y_p, amax, amax_p)
    ms = median_ms(lambda: kern(*args, **kw))
    plain_ms = median_ms(lambda: plain(*args, **kw), per_graph=2)
    m_total = c["N"] * c["h_out"] ** 2
    ops_needed = 2.0 * m_total * nnz          # nonzero weights only
    b_ms, b_by = bound_ms(ops_needed, conv_bytes(c, wbytes))
    # yardstick: one torch._int_mm of the im2col of the input (built
    # here, outside the timed region) with the dense codes (for
    # conv_sparse, the codes its packed operands stand for), K zero-padded
    # to the multiple of 8 it needs; the port never calls it
    a, b = im2col_operands(c, c["w_sp"] if kind == "conv_implicit"
                           else bitmap_unpack(c["bitmap"], c["values"]))
    check(torch.equal(torch._int_mm(a, b).reshape(acc.shape), acc),
          f"{kind} {c['name']}: torch._int_mm disagrees with the kernel")
    library_ms = median_ms(lambda: torch._int_mm(a, b))
    cplan = conv_implicit.plan(c["N"], c["h_out"], c["h_out"], c["c_in"],
                               c["k"], c["c_out"],
                               sparse=kind == "conv_sparse")
    plan_txt = (f"vec={cplan.vec}/{cplan.bvec} tiles={cplan.m_tiles}x"
                f"{cplan.n_tiles} splits={cplan.splits}x{cplan.chunks_per}")
    print(f"[kernel] {kind:14s} {c['name']:16s} acc_equal=True "
          f"max|dy|={dy:.3g} ({ulps} ulp) y_q_mismatch={mism} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={b_ms:.5f} ({b_by}) library_ms={fmt(library_ms)} "
          f"{plan_txt}", flush=True)
    return dict(shape=c["name"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, max_abs_err=dy,
                ulps=ulps, y_q_mismatch=mism, plan=list(cplan))


def dw_case(C, hw, stride, dev, gen, N=2, k=3):
    """Inputs of one of MobileNetV2's depthwise convs as served: int8
    activations, INT7 tap-major weights, per-row dequant rows, bias."""
    from repro_torch.core.quantize import quantize_int7
    x = torch.randint(-127, 128, (N, hw, hw, C), generator=gen,
                      dtype=torch.int8)
    qt = quantize_int7(torch.randn((k * k, C), generator=gen) / 3, axis=-1)
    x_scale = 0.02 + 0.01 * torch.rand((N,), generator=gen)
    eff = (x_scale.reshape(-1, 1) * qt.scale.reshape(1, -1)).float()
    bias = 0.1 * torch.randn((C,), generator=gen)
    return tuple(t.to(dev).contiguous() for t in (x, qt.values, eff, bias))


def check_depthwise(C, hw, stride, dev, gen):
    """The depthwise kernel at one of MobileNetV2's shapes (ReLU, no
    shortcut, as served) against its plain version: accumulators equal,
    y within 0 ulp, amax equal, no y_q code off; the library yardstick is
    an f32 grouped ``F.conv2d`` of the int8-valued inputs, whose sums are
    exact (|acc| < 2**24), so its result equals the accumulators."""
    from repro_torch.kernels import conv_depthwise, ref
    N, k = 2, 3
    x, w, eff, bias = dw_case(C, hw, stride, dev, gen, N, k)
    args = (x, w, eff, bias, None)
    kw = dict(k=k, stride=stride, relu=True)
    label = f"{C}@{hw}/s{stride}"
    y, amax, acc = conv_depthwise.conv2d_dw(*args, return_acc=True, **kw)
    y_p, amax_p, acc_p = conv_depthwise.conv2d_dw_plain(*args,
                                                        return_acc=True, **kw)
    dy, ulps, mism = compare_conv_outputs(f"conv_depthwise {label}", acc,
                                          acc_p, y, y_p, amax, amax_p)
    check(ulps == 0 and mism == 0 and torch.equal(amax, amax_p),
          f"conv_depthwise {label}: y off by {ulps} ulp, {mism} codes, "
          f"amax equal {torch.equal(amax, amax_p)}")
    ms = median_ms(lambda: conv_depthwise.conv2d_dw(*args, **kw))
    plain_ms = median_ms(lambda: conv_depthwise.conv2d_dw_plain(*args, **kw),
                         per_graph=2)
    h_out = -(-hw // stride)
    n_y = N * h_out * h_out * C
    b_ms, b_by = bound_ms(2.0 * n_y * k * k,
                          x.numel() + w.numel() + eff.numel() * 4 + C * 4
                          + n_y * 4 + N * 4)
    # yardstick: one grouped f32 conv on the SAME-padded NCHW input
    xf = ref.pad_same_nhwc(x, k, stride)[0].permute(0, 3, 1, 2).float() \
        .contiguous()
    wf = w.float().t().reshape(C, 1, k, k).contiguous()
    lib = lambda: F.conv2d(xf, wf, stride=stride, groups=C)
    check(torch.equal(lib().permute(0, 2, 3, 1), acc.float()),
          f"conv_depthwise {label}: F.conv2d disagrees with the kernel")
    library_ms = median_ms(lib)
    p = conv_depthwise.plan(N, hw, hw, C, k, stride)
    plan_txt = (f"cb={p.cb} rows={p.rows} cw={p.cw} vec={p.vec} "
                f"threads={p.threads} grid={N * p.n_bands * p.n_slices} "
                f"smem={p.smem}")
    print(f"[kernel] conv_depthwise {label:16s} acc_equal=True "
          f"max|dy|={dy:.3g} ({ulps} ulp) y_q_mismatch={mism} amax_equal=True "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={b_ms:.5f} ({b_by}) library_ms={fmt(library_ms)} "
          f"{plan_txt}", flush=True)
    return dict(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, max_abs_err=dy,
                ulps=ulps, y_q_mismatch=mism, plan=list(p))


# (DW_SHAPES entry, coarse_in group size): counted in the kernel's
# epilogue at the first three, recounted on y at the last (a slice of 32)
DW_ZERO_COUNTS = [((144, 56, 1), 8), ((576, 14, 2), 8), ((960, 7, 1), 4),
                  ((576, 14, 2), 48)]


def check_dw_zero_counts(shape, g, dev, gen):
    """The ``profile_g`` zero counts at one MobileNetV2 shape: equal to
    the plain version's dict, and y, amax, acc the same with profiling
    on and off."""
    from repro_torch.kernels import conv_depthwise
    C, hw, stride = shape
    x, w, eff, bias = dw_case(C, hw, stride, dev, gen)
    args = (x, w, eff, bias, None)
    kw = dict(k=3, stride=stride, relu=True, return_acc=True)
    *on, zc = conv_depthwise.conv2d_dw(*args, profile_g=g, **kw)
    off = conv_depthwise.conv2d_dw(*args, **kw)
    zc_p = conv_depthwise.conv2d_dw_plain(*args, profile_g=g, **kw)[-1]
    torch.cuda.synchronize()
    label = f"{C}@{hw}/s{stride} g={g}"
    check(all(torch.equal(a, b) for a, b in zip(on, off)),
          f"conv_depthwise {label}: outputs change with profiling")
    for key in zc_p:
        check(torch.equal(zc[key], zc_p[key]),
              f"conv_depthwise {label}: zero count {key} differs")
    cb = conv_depthwise.plan(2, hw, hw, C, 3, stride).cb
    route = "epilogue" if cb % g == 0 else "recount on y"
    print(f"[kernel] conv_depthwise zero counts {label}: equal to the plain "
          f"version ({route}; row_zeros {zc['row_zeros'].tolist()}, "
          f"all-zero cells {float(zc['group_allzero'].sum()):.0f}); outputs "
          "equal with profiling on and off", flush=True)


# (CONV_SHAPES name, coarse_in group size) of the conv kernels' zero
# counts: counted in the epilogue at g = 64 (over the two column warps,
# tiles in one image), 8 (in a thread; conv3_x_1/a's 784 rows an image:
# tiles cross images), 32 (over a quad; 196 rows an image, K split 6x6)
# and 4 (49 rows an image, K split 9x8); recounted on y at g = 128 (a
# group wider than the 64-channel tile, n_out 256)
CONV_ZERO_COUNTS = [("conv2_x_2/b", 64), ("conv3_x_1/a", 8),
                    ("conv4_x_2/b", 32), ("conv5_x_2/b", 4),
                    ("conv4_x_2/b", 128)]


def dead_channel_bias(bias):
    """The bias with whole channel blocks driven far below zero (every
    other 64-channel tile, every third group of 8), so the ReLU zeroes
    whole groups beside partly zero ones: every all-zero-cell branch of
    the epilogue has work."""
    n = torch.arange(bias.numel(), device=bias.device)
    dead = ((n // 64) % 2 == 1) | ((n // 8) % 3 == 0)
    return torch.where(dead, torch.full_like(bias, -1e6), bias)


def check_conv_zero_counts(kind, c, g):
    """One conv kernel's ``profile_g`` zero counts at one shape: every
    key of the dict equal to the plain version's; y, amax and acc the
    same with profiling on and off.  Times the call both ways, and the
    zeroing and dict ops the profiled call adds around the kernel."""
    from repro_torch.kernels import conv_implicit, conv_sparse
    if kind == "conv_implicit":
        kern, plain = (conv_implicit.conv2d_implicit,
                       conv_implicit.conv2d_implicit_plain)
        wts = (c["w_sp"],)
    else:
        kern, plain = (conv_sparse.conv2d_sparse,
                       conv_sparse.conv2d_sparse_plain)
        wts = (c["bitmap"], c["values"])
    args = (c["x"], *wts, c["eff"], dead_channel_bias(c["bias"]),
            c["shortcut"])
    kw = dict(k=c["k"], stride=c["stride"], relu=c["relu"])
    *on, zc = kern(*args, profile_g=g, return_acc=True, **kw)
    off = kern(*args, return_acc=True, **kw)
    *ref, zc_p = plain(*args, profile_g=g, return_acc=True, **kw)
    torch.cuda.synchronize()
    label = f"{kind} {c['name']} g={g}"
    check(all(torch.equal(a, b) for a, b in zip(on, off)),
          f"{label}: y, amax or acc change with profiling")
    check(all(torch.equal(a, b) for a, b in zip(on, ref)),
          f"{label}: outputs differ from the plain version")
    check(zc.keys() == zc_p.keys(), f"{label}: zero-count keys differ")
    for key in zc_p:
        check(torch.equal(zc[key], zc_p[key]),
              f"{label}: zero count {key} differs from the plain version")
    in_kernel = conv_implicit.counts_in_kernel(c["c_out"], g)
    ms_off = median_ms(lambda: kern(*args, **kw))
    ms_on = median_ms(lambda: kern(*args, profile_g=g, **kw))
    N, G = c["N"], c["c_out"] // g
    h = c["h_out"]

    def around():               # what the wrapper adds around the kernel
        zg, za = torch.zeros((2, N, G), dtype=torch.int32,
                             device=c["x"].device)
        return conv_implicit.zero_count_dict(zg, za, h, h, c["c_out"])
    around_ms = median_ms(around) if in_kernel else None
    p = conv_implicit.plan(N, h, h, c["c_in"], c["k"], c["c_out"],
                           sparse=kind == "conv_sparse")
    route = "epilogue" if in_kernel else "recount on y"
    cells = float(zc["group_allzero"].sum())
    print(f"[kernel] {kind:14s} zero counts {c['name']:12s} g={g:<3d} "
          f"{route}: equal to the plain version (zeros "
          f"{float(zc['row_zeros'].sum()):.0f}, all-zero cells {cells:.0f}; "
          f"{h * h} rows an image, splits={p.splits}x"
          f"{p.chunks_per}); y, amax, acc equal with profiling on and off; "
          f"unprofiled {ms_off:.4f} ms, profiled {ms_on:.4f} ms "
          f"(zeroing + dict {fmt(around_ms)} ms)", flush=True)
    return dict(shape=c["name"], g=g, route=route, ms=ms_off,
                profiled_ms=ms_on, around_ms=around_ms, all_zero_cells=cells)


def floor_line(card):
    """The time of one trivial graph node under ``median_ms``: a
    2-element fill (``torch.zeros``) and a 2-element add."""
    a = torch.ones(2, device="cuda")
    zeros_ms = median_ms(lambda: torch.zeros(2, device="cuda"))
    add_ms = median_ms(lambda: a + a)
    print(f"[floor] one graph node under median_ms: torch.zeros(2) "
          f"{zeros_ms:.4f} ms, 2-element add {add_ms:.4f} ms on {card}",
          flush=True)
    return dict(zeros_ms=zeros_ms, add_ms=add_ms)


def check_cfmm(name, M, K, N, dev, gen):
    """The int8 GEMM against its plain version: the int32 product (the
    served call) equal, and with a scale one f32 rounding equal; prints
    the plan (variant, tiles, splits x chunks).  The library yardstick is
    ``torch._int_mm``, with M zero-padded to the 32 rows it needs and N
    to a multiple of 8 (Whisper's 51865-token head)."""
    from repro_torch.core.compiled_linear import _compile_leaf_2d, act_quant
    from repro_torch.kernels import cfmm_matmul
    leaf = _compile_leaf_2d(torch.randn((K, N), generator=gen) / K ** .5,
                            "cfmm", 0.8)
    x_q, _ = act_quant(torch.randn((M, K), generator=gen).clamp_min(0),
                       per_row=True)
    x_q, codes, scale = (t.to(dev).contiguous()
                         for t in (x_q, leaf["codes"], leaf["scale"]))
    out = cfmm_matmul.cfmm_matmul(x_q, codes)
    out_p = cfmm_matmul.cfmm_matmul_plain(x_q, codes)
    f = cfmm_matmul.cfmm_matmul(x_q, codes, scale)
    f_p = cfmm_matmul.cfmm_matmul_plain(x_q, codes, scale)
    torch.cuda.synchronize()
    label = f"M={M} K={K} N={N}"
    check(out.dtype == torch.int32 and torch.equal(out, out_p),
          f"cfmm_matmul {label}: int32 products differ")
    ulps = ulp_distance(f, f_p)
    check(ulps <= 1, f"cfmm_matmul {label}: scaled output off by {ulps} ulp")
    err = float((f - f_p).abs().max())
    ms = median_ms(lambda: cfmm_matmul.cfmm_matmul(x_q, codes))
    plain_ms = median_ms(lambda: cfmm_matmul.cfmm_matmul_plain(x_q, codes),
                         per_graph=2)
    b_ms, b_by = bound_ms(2.0 * M * K * N, M * K + K * N + M * N * 4)
    a = F.pad(x_q, (0, 0, 0, max(0, 32 - M))).contiguous()
    b = F.pad(codes, (0, -N % 8)).t().contiguous().t()
    check(torch.equal(torch._int_mm(a, b)[:M, :N], out),
          f"cfmm_matmul {label}: torch._int_mm disagrees with the kernel")
    library_ms = median_ms(lambda: torch._int_mm(a, b))
    p = cfmm_matmul.plan(M, K, N)
    print(f"[kernel] cfmm_matmul    {name} {label} equal=True scaled "
          f"{ulps} ulp variant={p.variant} tiles={p.m_tiles}x{p.n_tiles} "
          f"splits={p.splits}x{p.chunks_per} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by}) "
          f"library_ms={fmt(library_ms)} kernel/library="
          f"{ms / library_ms:.2f} kernel/bound={ms / b_ms:.1f}", flush=True)
    return dict(shape=f"{name} {label}", ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                max_abs_err=err, ulps=ulps, plan=list(p))


# sparse_matvec: the ResNet head, then SmolLM-360M's linears in
# sparse_cfmm (M = the prefill bucket, or the 4 decode slots)
SPARSE_SHAPES = [("head", 2, 2048, 1000), ("LM q/o", 1024, 960, 960),
                 ("LM k/v", 1024, 960, 320), ("LM gate/up", 1024, 960, 2560),
                 ("LM down", 1024, 2560, 960), ("LM gate/up", 64, 960, 2560),
                 ("LM gate/up decode", 4, 960, 2560),
                 # Gemma3-1B's linears in sparse_cfmm (K = 1152, 6912)
                 ("Gemma3 q", 1024, 1152, 1024),
                 ("Gemma3 gate/up", 1024, 1152, 6912),
                 ("Gemma3 down", 1024, 6912, 1152),
                 ("Gemma3 gate/up decode", 4, 1152, 6912)] + [
    # OLMoE-1B-7B's expert linears (cap rows) and attention linears
    (f"OLMoE expert {name} cap={M}", M, K, N)
    for M in (160, 80, 16, 8)
    for name, K, N in (("gate/up", 2048, 1024), ("down", 1024, 2048))] + [
    ("OLMoE q/k/v/o", 1024, 2048, 2048)] + [
    # DeepSeek-V2-Lite-16B's routed expert linears (cap rows)
    (f"DeepSeek expert {name} cap={M}", M, K, N)
    for M in (120, 8)
    for name, K, N in (("gate/up", 2048, 1408), ("down", 1408, 2048))] + [
    # Whisper-small in sparse_cfmm (CFMM_SHAPES' rows)
    ("Whisper enc q/k/v/o", 6000, 768, 768),
    ("Whisper enc gate/up", 6000, 768, 3072),
    ("Whisper enc down", 6000, 3072, 768),
    ("Whisper dec gate/up decode", 4, 768, 3072),
    ("Whisper head decode", 4, 768, 51865)]


def check_sparse_matvec(label, M, K, N, dev, gen):
    """The sparse matmul at one shape against its plain version (int32
    products equal), with the variant and split its ``plan`` picks; the
    library yardstick is one ``torch._int_mm`` of x with the dense codes
    the packed operands stand for, M zero-padded to the 32 rows it
    needs and N to a multiple of 8."""
    from repro_torch.core.compiled_linear import (_compile_leaf_2d, act_quant,
                                                  bitmap_unpack)
    from repro_torch.kernels import ref, sparse_matvec
    w = torch.randn((K, N), generator=gen) / K ** .5
    packed = _compile_leaf_2d(w, "sparse_cfmm", 0.8)
    x_q, _ = act_quant(torch.randn((M, K), generator=gen).clamp_min(0),
                       per_row=True)
    x_q, bm, vals = (t.to(dev).contiguous() for t in
                     (x_q, packed["bitmap"], packed["values"]))
    out = sparse_matvec.sparse_matvec(x_q, bm, vals)
    out_p = ref.sparse_matvec_ref(x_q, bm, vals)
    torch.cuda.synchronize()
    check(torch.equal(out, out_p), f"sparse_matvec {label}: int32 products "
          "differ")
    err = float((out - out_p).abs().max())
    ms = median_ms(lambda: sparse_matvec.sparse_matvec(x_q, bm, vals))
    plain_ms = median_ms(lambda: ref.sparse_matvec_ref(x_q, bm, vals),
                         per_graph=2)
    nnz = popcount(bm)
    b_ms, b_by = bound_ms(2.0 * M * nnz, x_q.numel() + bm.numel()
                          + vals.numel() + M * N * 4)
    a = F.pad(x_q, (0, 0, 0, max(0, 32 - M))).contiguous()
    b = F.pad(bitmap_unpack(bm, vals), (0, -N % 8)).t().contiguous().t()
    check(torch.equal(torch._int_mm(a, b)[:M, :N], out),
          f"sparse_matvec {label}: torch._int_mm disagrees with the kernel")
    library_ms = median_ms(lambda: torch._int_mm(a, b))
    variant, splits, per = sparse_matvec.plan(M, K, N)
    shape = f"{label} M={M} K={K} N={N}"
    print(f"[kernel] sparse_matvec  {shape} equal=True variant={variant} "
          f"splits={splits}x{per} chunks kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by}) "
          f"library_ms={fmt(library_ms)} kernel/library="
          f"{ms / library_ms:.2f}", flush=True)
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, max_abs_err=err,
                variant=variant, splits=splits)


# flash attention: (label, B, KVH, G, Tq, Tk, D, Dv, causal, window)
FLASH_SHAPES = [
    ("SmolLM prefill T=64", 1, 5, 3, 64, 64, 64, 64, True, None),
    ("SmolLM prefill T=256", 1, 5, 3, 256, 256, 64, 64, True, None),
    ("SmolLM prefill T=1024", 1, 5, 3, 1024, 1024, 64, 64, True, None),
    ("Tq=1 vs Tk=1000", 1, 5, 3, 1, 1000, 64, 64, True, None),
    ("Tq=7 vs Tk=1000", 1, 5, 3, 7, 1000, 64, 64, True, None),
    ("non-causal Tk=1500", 1, 12, 1, 1500, 1500, 64, 64, False, None),
    ("Gemma3-like window 512", 1, 1, 4, 1024, 1024, 256, 256, True, 512),
    ("MLA-like D=192 Dv=128", 1, 16, 1, 512, 512, 192, 128, True, None),
    # queries past the keys, non-causal with no window (a decoder of 448
    # tokens over a clip of 24 frames)
    ("non-causal Tq=448 > Tk=24", 2, 12, 1, 448, 24, 64, 64, False, None),
]
# the dense LM configs' prefill attention at the largest bucket, bf16 only
LM_FLASH_SHAPES = [
    ("StableLM-3B prefill T=1024", 1, 32, 1, 1024, 1024, 80, 80, True, None),
    ("Gemma3-1B local T=1024", 1, 1, 4, 1024, 1024, 256, 256, True, 512),
    ("Gemma3-1B global T=1024", 1, 1, 4, 1024, 1024, 256, 256, True, None),
    ("Phi-3-medium prefill T=1024", 1, 10, 4, 1024, 1024, 128, 128, True,
     None),
    ("OLMoE-1B-7B prefill T=1024", 1, 16, 1, 1024, 1024, 128, 128, True,
     None),
    # MLA's expanded prefill: q.k over qk_nope + qk_rope = 192, p.v over
    # v_dim = 128
    ("DeepSeek-V2-Lite prefill T=1024", 1, 16, 1, 1024, 1024, 192, 128,
     True, None),
    # Jamba's one attention layer per period: 32 heads over 8 KV heads,
    # prefilled at exact length (777 tokens)
    ("Jamba-v0.1 prefill T=777", 1, 8, 4, 777, 777, 128, 128, True, None),
    # Qwen2-VL-7B: 28 heads over 4 KV heads, G = 7 (9 positions per
    # 64-row tile and one pad row)
    ("Qwen2-VL-7B prefill T=1024", 1, 4, 7, 1024, 1024, 128, 128, True,
     None),
    # Whisper-small, 12 heads of 64 (G = 1) over 4 clips of 1500 frames:
    # the non-causal encoder, the cross-attention of the 4-token prompts
    # and of a decode step (one query row against 1500 keys)
    ("Whisper encoder T=1500", 4, 12, 1, 1500, 1500, 64, 64, False, None),
    ("Whisper cross prefill Tq=4", 4, 12, 1, 4, 1500, 64, 64, False, None),
    ("Whisper cross decode Tq=1", 4, 12, 1, 1, 1500, 64, 64, False, None),
]
# kernel against plain version on the card (as tests/test_torch_kernels_
# cuda.py): the sums run in other orders and the kernel's p is relative
# to a running max, so p rounds to bf16 at other points.  f32: 2e-5
# absolute; bf16: 1e-2 absolute plus one output ulp (<= 2**-7 of it).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def flash_work(q, k, v, causal, window):
    """(flops, bytes) the function needs on these inputs: the score and
    p.v products of the (query, key) pairs the mask keeps, and q, k, v
    and the output moved once."""
    from repro_torch.kernels.flash_attention import position_mask
    B, KVH, G, Tq, D = q.shape
    Tk, Dv = k.shape[2], v.shape[-1]
    pairs = int(position_mask(Tq, Tk, causal, window, "cpu").sum())
    flops = 2.0 * B * KVH * G * pairs * (D + Dv)
    nbytes = (q.numel() + k.numel() + v.numel() + B * KVH * G * Tq * Dv) \
        * q.element_size()
    return flops, nbytes


def check_flash(spec, dtype, dev, gen):
    """The flash-attention kernel at one shape against its plain version;
    the library yardstick is SDPA (``enable_gqa=True``): ``is_causal``
    where Tq = Tk and there is no window, else ``position_mask`` as a
    boolean ``attn_mask`` (SDPA's causal mask is top-left aligned, the
    kernel's bottom-right: queries at the end of the keys)."""
    from repro_torch.kernels import flash_attention as fa
    label, B, KVH, G, Tq, Tk, D, Dv, causal, window = spec
    q = torch.randn((B, KVH, G, Tq, D), generator=gen)
    k = torch.randn((B, KVH, Tk, D), generator=gen)
    v = torch.randn((B, KVH, Tk, Dv), generator=gen)
    q, k, v = (t.to(dtype).to(dev).contiguous() for t in (q, k, v))
    out = fa.flash_attention(q, k, v, causal, window)
    want = fa.flash_attention_plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs()
    tol = FLASH_TOL[dtype] + (want.float().abs() * 2.0 ** -7
                              if dtype == torch.bfloat16 else 0.0)
    check(bool(torch.isfinite(out).all()) and bool((err <= tol).all()),
          f"flash_attention {label} {dtype}: off its plain version by "
          f"{float(err.max()):.3g}")
    ms = median_ms(lambda: fa.flash_attention(q, k, v, causal, window))
    plain_ms = median_ms(lambda: fa.flash_attention_plain(q, k, v, causal,
                                                          window),
                         per_graph=2)
    flops, nbytes = flash_work(q, k, v, causal, window)
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16
                          if dtype == torch.bfloat16 else PEAK_F32)
    qs = q.reshape(B, KVH * G, Tq, D)
    mask = (None if window is None and Tq == Tk else
            fa.position_mask(Tq, Tk, causal, window, q.device))
    sdpa = lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)
    lib_err = float((sdpa().reshape(out.shape).float()
                     - want.float()).abs().max())
    library_ms = median_ms(sdpa)
    print(f"[kernel]   SDPA vs plain max|d|={lib_err:.3g}", flush=True)
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    shape = f"{label} {dt}"
    variant = fa.variant(dtype, D, Dv)
    print(f"[kernel] flash_attention {shape:32s} variant={variant} "
          f"max|d|={float(err.max()):.3g} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by}) "
          f"library_ms={fmt(library_ms)}", flush=True)
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms,
                max_abs_err=float(err.max()), variant=variant)


# flash attention backward (the training path's gradient): the served
# attention shapes and the two training shapes, (label, B, KVH, G, Tq, Tk,
# D, Dv, causal, window)
FLASH_BWD_SHAPES = [
    ("SmolLM-360M train T=512", 8, 5, 3, 512, 512, 64, 64, True, None),
    ("SmolLM-360M T=1024", 1, 5, 3, 1024, 1024, 64, 64, True, None),
    ("Tq=7 vs Tk=1000", 1, 5, 3, 7, 1000, 64, 64, True, None),
    ("non-causal Tk=1500", 1, 12, 1, 1500, 1500, 64, 64, False, None),
    ("StableLM-3B T=1024", 1, 32, 1, 1024, 1024, 80, 80, True, None),
    ("Phi-3-medium T=1024", 1, 10, 4, 1024, 1024, 128, 128, True, None),
    ("Gemma3-1B train T=512 w512", 8, 1, 4, 512, 512, 256, 256, True, 512),
    ("Gemma3-1B T=1024 w512", 1, 1, 4, 1024, 1024, 256, 256, True, 512),
    ("DeepSeek-V2-Lite MLA T=1024", 1, 16, 1, 1024, 1024, 192, 128, True,
     None),
    # Whisper-small's training step (batch 2, 1500 frames, 448 tokens):
    # the encoder, the cross-attention, the decoder; and queries past the
    # keys (448 tokens over 24 frames), non-causal
    ("Whisper train encoder T=1500", 2, 12, 1, 1500, 1500, 64, 64, False,
     None),
    ("Whisper train cross Tq=448 Tk=1500", 2, 12, 1, 448, 1500, 64, 64,
     False, None),
    ("Whisper train decoder T=448", 2, 12, 1, 448, 448, 64, 64, True, None),
    ("non-causal Tq=448 > Tk=24", 2, 12, 1, 448, 24, 64, 64, False, None),
]
# backward kernel against its plain version on the card (as tests/test_
# torch_kernels_cuda.py): both sum in f32 in other orders and round once to
# the inputs' type.  f32: 1e-4 absolute plus 1e-5 relative; bf16: 1e-2
# absolute plus one output ulp (<= 2**-7 of it).
FLASH_BWD_TOL = {torch.float32: (1e-4, 1e-5),
                 torch.bfloat16: (1e-2, 2.0 ** -7)}


def event_ms(fn, reps=10) -> float:
    """Median device time of one ``fn()`` call between CUDA events (no
    CUDA graph: the SDPA yardstick runs autograd, which a graph capture
    does not take), after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profiled_ms(fn, reps=5) -> float:
    """Device time of one ``fn()`` call: the durations of the kernels it
    launches, from ``torch.profiler``'s trace of ``reps`` calls (after a
    warm-up call), summed and divided by ``reps`` -- the host's gaps
    between launches, which ``event_ms`` counts, left out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ms for ms, _ in device_kernels(prof).values()) / reps


def flash_bwd_work(q, k, v, causal, window):
    """(flops, bytes) the backward needs on these inputs: per visible
    (query, key) pair the recomputed score (2 D), dp (2 Dv), dv (2 Dv), dq
    and dk (2 D each), 2.5 times the forward's 2 (D + Dv) at D = Dv; q, k,
    v, o, dout and lse read once, dq, dk and dv written once."""
    from repro_torch.kernels.flash_attention import position_mask
    B, KVH, G, Tq, D = q.shape
    Tk, Dv = k.shape[2], v.shape[-1]
    pairs = int(position_mask(Tq, Tk, causal, window, "cpu").sum())
    flops = 2.0 * B * KVH * G * pairs * (3 * D + 2 * Dv)
    rows = B * KVH * G * Tq
    nbytes = (2 * (q.numel() + k.numel() + v.numel()) + 2 * rows * Dv) \
        * q.element_size() + 4 * rows
    return flops, nbytes


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


def sdpa_backward(q, k, v, dout, causal, window):
    """One SDPA forward at the kernel's shape (GQA, the window or Tq < Tk
    as a boolean mask) on the first backend that takes it, and a function
    that runs its backward at ``dout``: (backend name, fn)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    B, KVH, G, Tq, D = q.shape
    qs = q.reshape(B, KVH * G, Tq, D).detach().requires_grad_()
    ks, vs = k.detach().requires_grad_(), v.detach().requires_grad_()
    ds = dout.reshape(B, KVH * G, Tq, v.shape[-1])
    mask = (None if window is None and Tq == k.shape[2] else
            fa.position_mask(Tq, k.shape[2], causal, window, q.device))
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")   # the backends it skips
                out = F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask,
                    is_causal=causal and mask is None, enable_gqa=True)
                torch.autograd.grad(out, (qs, ks, vs), ds, retain_graph=True)
        except RuntimeError:
            continue
        return name, lambda: torch.autograd.grad(out, (qs, ks, vs), ds,
                                                 retain_graph=True)
    raise CheckFailed("no SDPA backend takes the backward at this shape")


def check_flash_bwd(spec, dtype, dev, gen):
    """The backward kernel at one shape against its plain version, from
    the forward kernel's output and log-sum-exp; timed beside its bound,
    the plain version and SDPA's backward (its backend named), between
    CUDA events (``ms``, ``library_ms``: autograd's host gaps between
    SDPA's launches included) and as the profiler's kernel durations
    (``device_ms``, ``library_device_ms``)."""
    from repro_torch.kernels import flash_attention as fa
    label, B, KVH, G, Tq, Tk, D, Dv, causal, window = spec
    q = torch.randn((B, KVH, G, Tq, D), generator=gen)
    k = torch.randn((B, KVH, Tk, D), generator=gen)
    v = torch.randn((B, KVH, Tk, Dv), generator=gen)
    do = torch.randn((B, KVH, G, Tq, Dv), generator=gen)
    q, k, v, do = (t.to(dtype).to(dev).contiguous() for t in (q, k, v, do))
    o, lse = fa.flash_attention_fwd(q, k, v, causal, window)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, causal, window)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal, window)
    torch.cuda.synchronize()
    atol, rtol = FLASH_BWD_TOL[dtype]
    err = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        e = (a.float() - b.float()).abs()
        check(bool(torch.isfinite(a).all())
              and bool((e <= atol + rtol * b.float().abs()).all()),
              f"flash_attention_bwd {label} {dtype} {name}: off its plain "
              f"version by {float(e.max()):.3g}")
        err = max(err, float(e.max()))
    ms = event_ms(lambda: fa.flash_attention_bwd(q, k, v, o, do, lse, causal,
                                                 window))
    plain_ms = event_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, do, lse, causal, window), reps=3)
    flops, nbytes = flash_bwd_work(q, k, v, causal, window)
    b_ms, b_by = bound_ms(flops, nbytes, PEAK_BF16
                          if dtype == torch.bfloat16 else PEAK_F32)
    backend, sdpa_bwd = sdpa_backward(q, k, v, do, causal, window)
    library_ms = event_ms(sdpa_bwd)
    device_ms = profiled_ms(lambda: fa.flash_attention_bwd(
        q, k, v, o, do, lse, causal, window))
    library_device_ms = profiled_ms(sdpa_bwd)
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    shape = f"{label} {dt}"
    variant = fa.bwd_variant(dtype, D, Dv)
    print(f"[kernel] flash_attention_bwd {shape:34s} variant={variant} "
          f"max|d|={err:.3g} kernel_ms={ms:.4f} (device {device_ms:.4f}) "
          f"plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} ({b_by}) "
          f"library_ms={library_ms:.4f} (device {library_device_ms:.4f}; "
          f"SDPA {backend})", flush=True)
    return dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, max_abs_err=err,
                library_backend=backend, device_ms=device_ms,
                library_device_ms=library_device_ms, variant=variant)


# ---------------------------------------------------------------------------
# Phase 2b: the block-sparse constant-weight matmul
# ---------------------------------------------------------------------------

# kernel against plain version on the card (as tests/test_torch_kernels_
# cuda.py): the same f32 terms summed in another order, rounded once to
# x's type.  f32: 1e-5 relative plus 1e-4 absolute; bf16: that plus one
# output ulp (<= 2**-7 of it), as the two f32 sums may straddle a
# rounding point.
BS_RTOL, BS_ATOL = 1e-5, 1e-4
BS_REPS = 10                 # timing reps: part A times 54 cases
# part B: (label, M, K, N) at block (64, 64), with 100, 50 and 20 % of the
# blocks kept
BS_MASK_SHAPES = [("ResNet50 conv2_x", 6272, 64, 256),
                  ("ResNet50 conv4_x", 392, 1024, 256),
                  ("ResNet50 conv5_x", 98, 2048, 512),
                  ("SmolLM-360M gate/up, 1024 tokens", 1024, 960, 2560)]
BS_KEEP = (1.0, 0.5, 0.2)


def bs_close(got, want):
    """(within BS_RTOL/BS_ATOL (+ one bf16 ulp), max |d|)."""
    err = (got.float() - want.float()).abs()
    tol = BS_ATOL + BS_RTOL * want.float().abs()
    if want.dtype == torch.bfloat16:
        tol = tol + want.float().abs() * 2.0 ** -7
    return bool((err <= tol).all()), float(err.max())


def resnet50_1x1_shapes():
    """Every distinct (M, c_in, c_out) of ResNet50's 1x1 convs as the
    port's ``resnet_graph`` gives them at 224 px, microbatch 2 (M is the
    conv's output pixels: a stride-2 1x1 conv multiplies the subsampled
    map)."""
    from repro_torch.models import resnet
    g = resnet.resnet_graph(resnet.ResNetConfig())
    info = g.shapes()
    return sorted({(2 * info[n.name].hw ** 2, n.c_in, n.c_out)
                   for n in g.nodes if n.op == "conv" and n.k == 1})


def check_block_sparse(label, x, w, block, dev):
    """One call of ``ops.block_sparse_matmul`` on the card (the path; its
    launch counter set to 0 just before and read just after), then its
    output against the kernel's plain version on the kernel's own
    operands, the empty block columns exact zeros, and the times of the
    kernel, the plain version and one cuBLAS ``torch.matmul`` of x with
    the dense masked weights (the same function without the skipping).
    Returns (the shape's row, path launches, the op's output)."""
    from repro_torch.kernels import block_sparse, ops, ref
    dtype = x.dtype
    block_sparse.KERNEL.launches = 0
    y = ops.block_sparse_matmul(x, w, block)
    torch.cuda.synchronize()
    launches = block_sparse.KERNEL.launches
    p = block_sparse.pack_blocks(w, block, dtype, dev)
    mask = p.mask
    check(launches == int(mask.any()), f"block_sparse {label}: {launches} "
          f"launches for one call")
    args = (p.w_blocks, p.meta, p.offsets, block, p.n_blocks_n)
    y_p = ref.block_sparse_matmul_plain(x, *args)
    ok, err = bs_close(y, y_p)
    check(ok and bool(torch.isfinite(y).all()),
          f"block_sparse {label}: off its plain version by {err:.3g}")
    empty = torch.from_numpy(~mask.any(axis=0)).repeat_interleave(
        block[1]).to(dev)
    check(bool((y[:, empty] == 0).all()),
          f"block_sparse {label}: an empty block column is not zero")
    ms = median_ms(lambda: block_sparse.block_sparse_matmul(x, *args),
                   reps=BS_REPS)
    plain_ms = median_ms(lambda: ref.block_sparse_matmul_plain(x, *args),
                         reps=BS_REPS, per_graph=2)
    w_dense = w.to(dtype).to(dev)      # zero outside the active blocks
    library_ms = median_ms(lambda: torch.matmul(x, w_dense), reps=BS_REPS)
    M, K = x.shape
    bk, bn = block
    elt = x.element_size()
    used_k = int(mask.any(axis=1).sum())       # k-blocks any column reads
    nbytes = (M * used_k * bk + p.n_active * bk * bn
              + M * p.n_blocks_n * bn) * elt + 16 * p.n_active \
        + 4 * (p.n_blocks_n + 1)
    b_ms, b_by = bound_ms(2.0 * M * p.n_active * bk * bn, nbytes,
                          PEAK_BF16 if dtype == torch.bfloat16
                          else PEAK_F32)
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    shape = f"{label} M={M} K={K} N={w.shape[1]} block={bk}x{bn} {dt}"
    bplan = block_sparse.plan(M, block, p.n_blocks_n, p.n_active, dtype)
    row = dict(shape=shape, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms, max_abs_err=err,
               n_active=p.n_active, n_blocks=int(mask.size), dtype=dt,
               plan=list(bplan))
    print(f"[block_sparse] {shape} active {p.n_active}/{mask.size} "
          f"variant={bplan.variant} tiles={bplan.m_tiles}x{bplan.n_tiles} "
          f"splits={bplan.splits} "
          f"max|d|={err:.3g} kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={b_ms:.5f} ({b_by}) cublas_dense_ms={library_ms:.4f} "
          f"kernel/cublas={ms / library_ms:.2f} kernel/bound="
          f"{ms / b_ms:.1f}", flush=True)
    return row, launches, y


def block_sparse_phase(dev, gen):
    """Parts A (the paper's recipe at ResNet50's 1x1 shapes), B (skipping
    under block masks) and C (edge cases).  Returns (rows, launches by
    path)."""
    from repro_torch.core.quantize import quantize_int7
    from repro_torch.core.sparsity import (block_sparsity, cluster_rows,
                                           magnitude_prune)
    from repro_torch.kernels import block_sparse, ops
    torch.backends.cuda.matmul.allow_tf32 = False    # f32 stays f32
    rows, paths = [], {"block_sparse/resnet50_1x1": 0,
                       "block_sparse/masks": 0, "block_sparse/edges": 0}

    # A. prune to 80 %, INT7 codes, cluster rows; permute w's rows and x's
    # columns alike
    for M, K, N in resnet50_1x1_shapes():
        w = magnitude_prune(torch.randn((K, N), generator=gen), 0.8)
        codes = quantize_int7(w).values
        x = torch.randn((M, K), generator=gen)
        for block in [(64, 64), (128, 128)]:
            if K % block[0] or N % block[1]:
                continue
            before = block_sparsity(codes, block)
            perm = torch.from_numpy(cluster_rows(codes, block[0]))
            after = block_sparsity(codes[perm], block)
            print(f"[block_sparse] A M={M} K={K} N={N} block={block}: block "
                  f"sparsity {before:.4f} before cluster_rows, {after:.4f} "
                  f"after", flush=True)
            for dtype in (torch.float32, torch.bfloat16):
                xd = x.to(dtype).to(dev)
                row, n, y = check_block_sparse("A", xd[:, perm.to(dev)]
                                               .contiguous(), w[perm], block,
                                               dev)
                paths["block_sparse/resnet50_1x1"] += n
                # the unpermuted product of the same rounded operands
                want = (xd.float() @ w.to(dtype).to(dev).float()).to(dtype)
                ok, d = bs_close(y, want)
                check(ok, f"block_sparse A M={M} K={K} N={N}: off the "
                      f"unpermuted x @ w by {d:.3g}")
                print(f"[block_sparse]   vs unpermuted x @ w: max|d|={d:.3g}",
                      flush=True)
                rows.append(dict(row, part="A", block_sparsity_before=before,
                                 block_sparsity_after=after,
                                 max_abs_err_unpermuted=d))

    # B. whole blocks zeroed: the time should fall with the active blocks
    bk, bn = 64, 64
    for label, M, K, N in BS_MASK_SHAPES:
        w = torch.randn((K, N), generator=gen)
        x = torch.randn((M, K), generator=gen)
        n_blocks = (K // bk) * (N // bn)
        order = torch.randperm(n_blocks, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            per_block = {}
            for keep in BS_KEEP:
                n_keep = max(1, round(keep * n_blocks))
                kept = torch.zeros(n_blocks, dtype=torch.bool)
                kept[order[:n_keep]] = True
                wm = w * kept.reshape(K // bk, N // bn).repeat_interleave(
                    bk, 0).repeat_interleave(bn, 1)
                row, n, _ = check_block_sparse(f"B {label} keep {keep}",
                                               x.to(dtype).to(dev), wm,
                                               (bk, bn), dev)
                paths["block_sparse/masks"] += n
                per_block[keep] = row["ms"] / row["n_active"]
                rows.append(dict(row, part="B", keep=keep))
            full = per_block[1.0]
            dt = "bf16" if dtype == torch.bfloat16 else "f32"
            print(f"[block_sparse] B {label} {dt}: kernel time per active "
                  f"block at " + ", ".join(
                      f"{k:.0%} kept {v * 1e3:.3f} us ({v / full:.2f}x)"
                      for k, v in per_block.items())
                  + " (1.00x: time in proportion to the active blocks)",
                  flush=True)

    # C. edge cases
    x = torch.randn((98, 256), generator=gen).to(dev)
    block_sparse.KERNEL.launches = 0
    y = ops.block_sparse_matmul(x, torch.zeros((256, 128)), (64, 64))
    torch.cuda.synchronize()
    check(block_sparse.KERNEL.launches == 0 and y.device == x.device
          and bool((y == 0).all()) and y.shape == (98, 128),
          "block_sparse C: an empty mask launched or is not zero")
    print("[block_sparse] C empty mask: zeros, no launch", flush=True)
    w = torch.randn((256, 256), generator=gen)
    w[:, 64:128] = 0.0                               # one empty block column
    w[64:128, 128:192] = 0.0
    row, n, y = check_block_sparse("C empty column, ragged M", x, w,
                                   (64, 64), dev)
    check(bool((y[:, 64:128] == 0).all()), "block_sparse C: block column 1 "
          "is not exactly zero")
    paths["block_sparse/edges"] += n
    rows.append(dict(row, part="C"))
    w = torch.randn((480, 400), generator=gen)
    w[48:96, :] = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        row, n, _ = check_block_sparse(
            "C block 48x80", torch.randn((37, 480), generator=gen)
            .to(dtype).to(dev), w, (48, 80), dev)
        paths["block_sparse/edges"] += n
        rows.append(dict(row, part="C"))
    # bf16 weights round before the product: 1 * (1 + 2**-9) - 1 * 1 is
    # 2**-9 in f32 and 0 once the weight has rounded to 1
    w = torch.zeros((64, 64))
    w[0, 0], w[1, 0] = 1.0 + 2.0 ** -9, 1.0
    x = torch.zeros((2, 64))
    x[:, 0], x[:, 1] = 1.0, -1.0
    block_sparse.KERNEL.launches = 0
    y16 = ops.block_sparse_matmul(x.bfloat16().to(dev), w, (64, 64))
    y32 = ops.block_sparse_matmul(x.to(dev), w, (64, 64))
    paths["block_sparse/edges"] += block_sparse.KERNEL.launches
    check(float(y16[0, 0]) == 0.0 and float(y32[0, 0]) == 2.0 ** -9,
          f"block_sparse C: bf16 weights did not round first "
          f"({float(y16[0, 0])}, {float(y32[0, 0])})")
    print("[block_sparse] C bf16 weights round before the product: "
          f"bf16 {float(y16[0, 0])}, f32 {float(y32[0, 0])}", flush=True)
    for path, n in paths.items():
        check(n > 0, f"{path}: the block-sparse kernel never launched")
    for dt in ("bf16", "f32"):
        sel = [r for r in rows if r["dtype"] == dt]
        ms, lib = sum(r["ms"] for r in sel), sum(r["library_ms"] for r in sel)
        print(f"[block_sparse] {dt}: {len(sel)} cases, kernel {ms:.4f} ms, "
              f"bound {sum(r['bound_ms'] for r in sel):.5f} ms, plain "
              f"{sum(r['plain_ms'] for r in sel):.3f} ms, cuBLAS dense "
              f"{lib:.4f} ms: kernel/cublas={ms / lib:.2f}", flush=True)
    return rows, paths


# ---------------------------------------------------------------------------
# Phase 3: the served paths, full width, on the card
# ---------------------------------------------------------------------------

def profile_serve(run, label):
    """Where a served batch's time goes: one more run (``run()``, which
    reads every output back) under ``torch.profiler``; prints wall time,
    the card's busy time (sum of kernel times on the one stream) and the
    kernels that take most.  Returns (wall ms, busy ms, conv_mma_kernel
    ms, conv_dw_kernel ms) or None when the profiler saw no kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's own row repeats the time of
    # the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"[profile] {label}: wall {wall_ms:.1f} ms; device time not "
              "measured (the profiler saw no kernels)", flush=True)
        return None
    ours_ms = sum(e.self_device_time_total for e in events
                  if any(k in e.key for k in OUR_KERNELS)) / 1e3
    # every CNN path runs its convs on the tensor-core conv kernel
    conv_ms = sum(e.self_device_time_total for e in events
                  if "conv_mma_kernel" in e.key) / 1e3
    check(conv_ms > 0, f"{label}: the profile shows no conv_mma_kernel")
    dw_ms = sum(e.self_device_time_total for e in events
                if "conv_dw_kernel" in e.key) / 1e3
    check(dw_ms > 0 or not label.startswith("mobilenet_v2"),
          f"{label}: the profile shows no conv_dw_kernel")
    print(f"[profile] {label}: conv_mma_kernel {conv_ms:.3f} ms, "
          f"conv_dw_kernel {dw_ms:.3f} ms", flush=True)
    print(f"[profile] {label} n_stages=1: wall {wall_ms:.1f} ms, device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; the port's kernels "
          f"{ours_ms:.2f} ms of it; device launches "
          f"{sum(e.count for e in events)}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:5d}  {e.key[:90]}", flush=True)
    return wall_ms, busy_ms, conv_ms, dw_ms


def model_config(model):
    """(config, boxed params) of a served model at full width: seeded
    random weights; RepVGG's are fused as served."""
    from repro_torch.configs.mobilenet_v2_compiled import CONFIG as mbv2
    from repro_torch.configs.repvgg_a0_compiled import CONFIG as repvgg
    from repro_torch.configs.resnet50_compiled import CONFIG as resnet50
    cfg = {"resnet50": resnet50, "mobilenet_v2": mbv2,
           "repvgg_a0": repvgg}[model]
    params = cfg.init(torch.Generator().manual_seed(0))
    if model == "repvgg_a0":
        params = cfg.fuse(params)
    return cfg, params


def graph_launches(cfg, mode) -> dict:
    """Kernel launches per microbatch forward that the model's graph
    implies (cross-checks the constants in PER_MICROBATCH)."""
    nodes = cfg.graph().nodes
    convs = sum(n.op == "conv" for n in nodes)
    dws = sum(n.op == "dwconv" for n in nodes)
    out = {("conv_sparse" if mode == "sparse_cfmm" else "conv_implicit"):
           convs}
    if dws:
        out["conv_depthwise"] = dws
    head = {"sparse_cfmm": "sparse_matvec", "cfmm": "cfmm_matmul",
            "int8": "cfmm_matmul"}.get(mode)
    if head:
        out[head] = 1
    return out


def serve(kernels, card):
    """Serve every (model, mode, stage count) of SERVED; returns
    ({(model, mode, n_stages): result}, {(model, mode): (config, compiled
    tree, request 0's CPU plain logits)}, the requests' images)."""
    from repro_torch.core.compiled_linear import ensure_compiled
    from repro_torch.serving.pipeline import (PipelineEngine,
                                              PipelineRequest,
                                              reference_logits)
    results, trees = {}, {}
    rng = np.random.RandomState(0)
    images = [rng.randn(n, 224, 224, 3).astype(np.float32)
              for n in (1, 2, 3)]
    n_img = sum(len(im) for im in images)
    models = {}
    for model, mode, stage_counts in SERVED:
        if model not in models:
            t0 = time.perf_counter()
            models[model] = model_config(model)
            cfg = models[model][0]
            check(cfg.in_hw == 224 and cfg.num_classes == 1000
                  and cfg.width_mult == 1.0, f"{model}: not full width")
            print(f"[serve] {model} width {cfg.width_mult} hw {cfg.in_hw} "
                  f"classes {cfg.num_classes}: init "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        cfg, params = models[model]
        per_mb = PER_MICROBATCH[(model, mode)]
        check(per_mb == graph_launches(cfg, mode),
              f"{model}/{mode}: the graph implies {graph_launches(cfg, mode)} "
              f"launches per microbatch, not {per_mb}")
        t0 = time.perf_counter()
        compiled = ensure_compiled(params, mode, 0.8)
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_cpu = reference_logits(compiled, cfg,
                                   torch.from_numpy(images[0]), 2).numpy()
        print(f"[serve] {model}/{mode}: compile {t_compile:.1f}s, CPU plain "
              f"forward of request 0 {time.perf_counter() - t0:.1f}s",
              flush=True)
        trees[(model, mode)] = (cfg, compiled, ref_cpu)
        by_stages = {}
        for n_stages in stage_counts:
            label = f"{model}/{mode}/{n_stages}"
            eng = PipelineEngine(cfg, compiled, mode=mode, n_stages=n_stages,
                                 microbatch=2, device="cuda")
            eng.run([PipelineRequest(rid=i, images=im)
                     for i, im in enumerate(images)])        # warm-up
            eng.reset_counters()
            for kern in kernels.values():
                kern.launches = 0
            times = []
            for _ in range(SERVE_REPS):
                reqs = [PipelineRequest(rid=i, images=im)
                        for i, im in enumerate(images)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run(reqs)                # reads every output back
                times.append(time.perf_counter() - t0)
            counts = {name: kern.launches for name, kern in kernels.items()}
            dt = float(np.median(times))
            n_mb = eng.stats()["mb_injected"]   # over all SERVE_REPS runs
            for name, got in counts.items():
                want = per_mb.get(name, 0) * n_mb
                check(got == want, f"{label}: {got} {name} launches for "
                      f"{n_mb} microbatches, want {want}")
            for r in reqs:
                check(r.done and r.logits.shape == (len(r.images),
                                                    cfg.num_classes),
                      f"{label}: request {r.rid} incomplete")
                check(np.isfinite(r.logits).all(),
                      f"{label}: non-finite logits")
            d_logit = float(np.abs(reqs[0].logits - ref_cpu).max())
            top1 = bool((reqs[0].logits.argmax(-1)
                         == ref_cpu.argmax(-1)).all())
            check(top1, f"{label}: top-1 differs from the CPU plain forward")
            # every op on the path is exact or IEEE-rounded the same way on
            # both devices, so the tolerance is zero
            check(d_logit == 0.0, f"{label}: logits differ from the CPU "
                  f"plain forward by up to {d_logit:.3g}")
            by_stages[n_stages] = np.concatenate([r.logits for r in reqs])
            st = eng.stats()
            print(f"[serve] {label} microbatch=2: {n_img} images in "
                  f"{dt * 1e3:.1f} ms (median of {SERVE_REPS}; min "
                  f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}) = "
                  f"{n_img / dt:.1f} im/s on {card}; launches {counts}; vs "
                  f"CPU plain: top1_equal={top1} max|dlogit|={d_logit:.3g}; "
                  f"bubble {st['bubble_fraction']:.2f}", flush=True)
            res = dict(counts=counts, n_microbatches=n_mb,
                       im_s=n_img / dt, d_logit=d_logit)
            if n_stages == 1:
                prof = profile_serve(
                    lambda: eng.run([PipelineRequest(rid=i, images=im)
                                     for i, im in enumerate(images)]),
                    f"{model}/{mode}")
                if prof is not None:
                    (res["profile_wall_ms"], res["device_busy_ms"],
                     res["conv_kernel_ms"], res["dw_kernel_ms"]) = prof
            results[(model, mode, n_stages)] = res
        if len(by_stages) == 2:
            check(np.array_equal(by_stages[1], by_stages[2]),
                  f"{model}/{mode}: 1-stage and 2-stage logits differ")
    return results, trees, images


# ---------------------------------------------------------------------------
# Phase 3b: the replicated front door (ResNetFrontend) on the card
# ---------------------------------------------------------------------------

FLEET_REQUESTS = 16          # per open-loop wave, 1-3 images each
FLEET_MIX = ((1, 1.0), (2, 1.0), (3, 1.0))
FLEET_LOAD = 0.7             # offered rows/s over the closed wave's
FLEET_GROUPS = 8             # coarse_in group size of the profiled waves
FLEET_MAX_WALL_S = 120.0


def pool_rows(pool, images) -> int:
    """The first pool row of a request's images (a ``poisson_plan``
    request is a view of the pool)."""
    off = images.__array_interface__["data"][0] - \
        pool.__array_interface__["data"][0]
    check(np.shares_memory(pool, images) and off % pool[0].nbytes == 0,
          "a fleet request is not a slice of the image pool")
    return off // pool[0].nbytes


def check_fleet_logits(label, pool, ref, reqs):
    """Every request done, its logits bit-identical to the single-engine
    card forward of the same rows."""
    for r in reqs:
        a = pool_rows(pool, r.images)
        check(r.done and r.logits is not None,
              f"{label}: request {r.rid} incomplete")
        check(np.array_equal(r.logits, ref[a:a + len(r.images)]),
              f"{label}: request {r.rid}'s logits differ from the "
              "single-engine card forward")


def fleet_launches(kernels, fe, label, per_mb):
    """Launch counts of a fleet wave (counters zeroed just before it)
    against the graph's count per microbatch over every replica's
    injected microbatches."""
    n_mb = sum(eng.stats()["mb_injected"] for eng in fe.replicas)
    counts = {name: kern.launches for name, kern in kernels.items()}
    for name, got in counts.items():
        want = per_mb.get(name, 0) * n_mb
        check(got == want, f"{label}: {got} {name} launches for {n_mb} "
              f"microbatches, want {want}")
    return {k: v for k, v in counts.items() if v}


def zero_launches(kernels):
    for kern in kernels.values():
        kern.launches = 0


def fleet_phase(kernels, card, trees, serve_images):
    """Full-width ResNet50 behind the port's ``ResNetFrontend`` on the
    card: 2 replicas x 1 stage, both on the one card, microbatch 2, the
    serve phase's compiled trees.  (a) an open-loop ``poisson_plan`` wave
    at ``FLEET_LOAD`` x the rows/s of a closed wave; (b) the same
    requests as one burst with replica 1 killed at its step 2; (c) a
    traced open-loop wave, its Chrome trace validated; (d) profiled
    waves in ``int8`` and ``sparse_cfmm`` whose sparsity snapshot must
    equal the CPU ``reference_profile`` of the same images.  Every
    request's logits are held to the single-engine card forward of its
    rows (which the serve phase holds to the CPU), bit for bit."""
    from repro_torch.obs import Telemetry, validate_chrome_trace
    from repro_torch.serving.faults import Fault, FaultInjector
    from repro_torch.serving.frontend import FrontendRequest, ResNetFrontend
    from repro_torch.serving.loadgen import (offered_rows_per_s,
                                             poisson_plan, run_open_loop)
    from repro_torch.serving.pipeline import (PipelineEngine,
                                              reference_profile)
    cfg, compiled, ref_cpu = trees[("resnet50", "int8")]
    rng = np.random.RandomState(1)
    # the serve phase's six images (request 0 first), then two more
    pool = np.concatenate(list(serve_images) + [
        rng.randn(2, *serve_images[0].shape[1:]).astype(np.float32)])
    refs = {}
    for mode in ("int8", "sparse_cfmm"):
        eng = PipelineEngine(cfg, trees[("resnet50", mode)][1], mode=mode,
                             n_stages=1, microbatch=2, device="cuda")
        refs[mode] = eng.run_batch(pool)
        check(np.array_equal(refs[mode][:1],
                             trees[("resnet50", mode)][2]),
              f"fleet {mode}: the card forward of request 0 differs from "
              "the CPU plain forward")
    ref = refs["int8"]
    per_mb = PER_MICROBATCH[("resnet50", "int8")]

    def make(mode="int8", telemetry=None):
        return ResNetFrontend(cfg, trees[("resnet50", mode)][1], mode=mode,
                              n_replicas=2, n_stages=1, microbatch=2,
                              device="cuda", telemetry=telemetry)

    def plan(rate, rid_base):
        return poisson_plan(rate_rps=rate, n_requests=FLEET_REQUESTS,
                            image_pool=pool, size_mix=FLEET_MIX, seed=0,
                            rid_base=rid_base)

    out = {}
    fe = make()
    check(fe.replicas[0].pipe.stages[0].device
          == fe.replicas[1].pipe.stages[0].device,
          "fleet: the two replicas are not on the one card")
    warm = plan(1.0, 0)
    fe.run([a.req for a in warm])                # warm-up
    fe.reset_service_rate()
    closed = [a.req for a in plan(1.0, 100)]
    fe.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fe.run(closed)                               # reads every output back
    dt = time.perf_counter() - t0
    check_fleet_logits("fleet closed wave", pool, ref, closed)
    rows = sum(len(r.images) for r in closed)
    cap = rows / dt
    st = fe.stats()
    print(f"[fleet] resnet50/int8 2 replicas x 1 stage on one card, "
          f"microbatch 2: closed wave of {len(closed)} requests, {rows} "
          f"images in {dt * 1e3:.1f} ms = {cap:.1f} im/s; latency p50 "
          f"{st['latency_p50_s'] * 1e3:.1f} ms p95 "
          f"{st['latency_p95_s'] * 1e3:.1f} ms on {card}", flush=True)
    out["closed"] = dict(requests=len(closed), rows=rows, wall_s=dt,
                         im_s=cap, latency_p50_s=st["latency_p50_s"],
                         latency_p95_s=st["latency_p95_s"])
    # the closed wave once more, profiled
    prof = profile_serve(lambda: fe.run([a.req for a in plan(1.0, 200)]),
                         "fleet/resnet50/int8 2 replicas")
    if prof is not None:
        out["closed"].update(zip(("profile_wall_ms", "device_busy_ms",
                                  "conv_kernel_ms"), prof))

    # (a) open loop at FLEET_LOAD x the closed wave's rows/s
    mean_rows = sum(n * w for n, w in FLEET_MIX) / sum(w for _, w in FLEET_MIX)
    wave = plan(FLEET_LOAD * cap / mean_rows, 1000)
    fe.reset_stats()
    zero_launches(kernels)
    res = run_open_loop(fe, wave, max_wall_s=FLEET_MAX_WALL_S)
    counts = fleet_launches(kernels, fe, "fleet open loop", per_mb)
    check(res["admitted"] == FLEET_REQUESTS and res["rejected"] == 0,
          f"fleet open loop: {res['rejected']} requests shed without an SLO")
    check_fleet_logits("fleet open loop", pool, ref, res["admitted_requests"])
    st = fe.stats()
    attr = [r["bubble_attribution"] for r in st["replicas"]]
    print(f"[fleet] (a) open loop: {FLEET_REQUESTS} requests, "
          f"{res['offered_rows']} images offered at "
          f"{offered_rows_per_s(wave):.1f} im/s ({FLEET_LOAD} x the closed "
          f"wave); latency p50 {res['latency_p50_s'] * 1e3:.1f} ms p95 "
          f"{res['latency_p95_s'] * 1e3:.1f} ms; goodput "
          f"{res['goodput_rows_s']:.1f} im/s; max queue depth "
          f"{st['max_queue_depth']}; rows per replica "
          f"{st['rows_dispatched']}; shed {res['rejected']}; bubble "
          f"{st['replica_bubble']}, attribution {attr}; launches {counts}; "
          f"logits bit-identical to the single-engine card forward",
          flush=True)
    out["open_loop"] = dict(
        offered_im_s=offered_rows_per_s(wave), rows=res["offered_rows"],
        latency_p50_s=res["latency_p50_s"],
        latency_p95_s=res["latency_p95_s"],
        goodput_im_s=res["goodput_rows_s"], wall_s=res["wall_s"],
        max_queue_depth=st["max_queue_depth"],
        rows_per_replica=st["rows_dispatched"], shed=res["rejected"],
        bubble=st["replica_bubble"], bubble_attribution=attr,
        launches=counts)

    # (b) the same requests as one burst, replica 1 killed at its step 2
    inj = FaultInjector()
    inj.arm(fe.replicas[1], Fault("kill", at_step=2))
    burst = [a.req for a in plan(1.0, 2000)]
    fe.reset_stats()
    zero_launches(kernels)
    fe.run(burst)
    counts = fleet_launches(kernels, fe, "fleet killed replica", per_mb)
    check_fleet_logits("fleet killed replica", pool, ref, burst)
    st = fe.stats()
    check(st["replicas_failed"] == 1 and st["failed"] == [False, True]
          and st["rows_requeued"] >= 1,
          f"fleet killed replica: failed {st['failed']}, requeued "
          f"{st['rows_requeued']} rows")
    print(f"[fleet] (b) replica 1 killed at its step 2: {len(burst)} "
          f"requests completed, {st['rows_requeued']} rows requeued over "
          f"{st['requeues']} spans, rows per replica "
          f"{st['rows_dispatched']}; latency p50 "
          f"{st['latency_p50_s'] * 1e3:.1f} ms p95 "
          f"{st['latency_p95_s'] * 1e3:.1f} ms; launches {counts}; logits "
          "bit-identical", flush=True)
    out["killed"] = dict(rows_requeued=st["rows_requeued"],
                         requeues=st["requeues"],
                         rows_per_replica=st["rows_dispatched"],
                         latency_p50_s=st["latency_p50_s"],
                         latency_p95_s=st["latency_p95_s"], launches=counts)
    inj.disarm(fe.replicas[1])
    del fe

    # (c) a traced open-loop wave
    tel = Telemetry(trace=True)
    fe = make(telemetry=tel)
    fe.run([a.req for a in plan(1.0, 3000)])     # warm-up
    traced = plan(FLEET_LOAD * cap / mean_rows, 4000)
    fe.reset_stats()
    zero_launches(kernels)
    res = run_open_loop(fe, traced, max_wall_s=FLEET_MAX_WALL_S)
    counts = fleet_launches(kernels, fe, "fleet traced wave", per_mb)
    check_fleet_logits("fleet traced wave", pool, ref,
                       res["admitted_requests"])
    errs = validate_chrome_trace(tel.trace.to_chrome_trace())
    check(not errs, f"fleet traced wave: invalid Chrome trace: {errs[:5]}")
    spans = collections.Counter(sp.name for sp in tel.trace.spans)
    instants = collections.Counter(i.name for i in tel.trace.instants)
    print(f"[fleet] (c) traced open loop: valid Chrome trace, spans "
          f"{dict(sorted(spans.items()))}, instants "
          f"{dict(sorted(instants.items()))}, dropped {tel.trace.dropped}; "
          f"latency p50 {res['latency_p50_s'] * 1e3:.1f} ms p95 "
          f"{res['latency_p95_s'] * 1e3:.1f} ms; logits bit-identical",
          flush=True)
    out["traced"] = dict(spans=dict(spans), instants=dict(instants),
                         latency_p50_s=res["latency_p50_s"],
                         latency_p95_s=res["latency_p95_s"], launches=counts)
    del fe

    # (d) profiled waves: the epilogues' zero counts against the CPU
    for mode in ("int8", "sparse_cfmm"):
        tel = Telemetry(sparsity_groups=FLEET_GROUPS)
        fe = make(mode, telemetry=tel)
        req = FrontendRequest(rid=0, images=pool[:2])
        zero_launches(kernels)
        fe.run([req])
        counts = fleet_launches(kernels, fe, f"fleet profiled {mode}",
                                PER_MICROBATCH[("resnet50", mode)])
        check_fleet_logits(f"fleet profiled {mode}", pool, refs[mode], [req])
        snap = tel.sparsity.snapshot()
        t0 = time.perf_counter()
        _, oracle = reference_profile(trees[("resnet50", mode)][1], cfg,
                                      pool[:2], 2, FLEET_GROUPS)
        check(snap == oracle, f"fleet profiled {mode}: the sparsity "
              "snapshot differs from the CPU reference_profile")
        worst = max(snap["layers"].items(),
                    key=lambda kv: kv[1]["zero_fraction"])
        print(f"[fleet] (d) profiled {mode}, groups of {FLEET_GROUPS}, 2 "
              f"images: snapshot equal to the CPU reference_profile "
              f"({time.perf_counter() - t0:.1f}s); {len(snap['layers'])} "
              f"layers, overall zero fraction "
              f"{snap['overall_zero_fraction']:.4f}, most zero "
              f"{worst[0]} {worst[1]['zero_fraction']:.4f}; launches "
              f"{counts}; logits equal to the unprofiled forward",
              flush=True)
        out[f"profiled_{mode}"] = dict(
            layers=len(snap["layers"]),
            overall_zero_fraction=snap["overall_zero_fraction"],
            launches=counts)
        del fe
    return out


# ---------------------------------------------------------------------------
# Phase 3c: the CNN zoo's dense reference forwards on the card
# ---------------------------------------------------------------------------

# max |dlogit| / max |logit| allowed between the card's dense forward and
# the CPU's: the same f32 products (cuBLAS with TF32 off, PyTorch's
# default for matmuls) summed in other orders.  A wrong patch order or
# SAME padding moves logits by the order of max |logit|.
DENSE_CNN_REL_BOUND = 1e-4


def dense_cnn_phase(kernels, card, trees, serve_images):
    """The zoo's dense reference forwards (``apply`` on unboxed float
    trees, the ``dense`` mode) at full width on the card, on the serve
    phase's request of 2 images: ResNet50, MobileNetV2 and RepVGG-A0
    fused and unfused, each held to the CPU's dense forward of the same
    tree within ``DENSE_CNN_REL_BOUND``, launching none of the port's
    kernels (the convs are im2col + ``torch.matmul``, as JAX's are
    ``jnp.matmul``); ResNet50's distance to its served ``int8`` logits is
    printed, not checked."""
    from repro_torch import nn
    from repro_torch.serving.pipeline import PipelineEngine
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the dense forward would not be f32")
    x = torch.from_numpy(serve_images[1])
    out = {}
    for model, unfused in (("resnet50", False), ("mobilenet_v2", False),
                           ("repvgg_a0", False), ("repvgg_a0", True)):
        label = f"{model}{'/unfused' if unfused else ''}/dense"
        cfg, params = model_config(model)
        if unfused:
            params = cfg.init(torch.Generator().manual_seed(0))
        tree = nn.unbox(params)
        t0 = time.perf_counter()
        want = cfg.apply(tree, x)
        cpu_s = time.perf_counter() - t0
        card_tree = nn.to_device(tree, "cuda")
        xc = x.cuda()
        cfg.apply(card_tree, xc)                         # warm-up
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = cfg.apply(card_tree, xc)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        counts = {n: k.launches for n, k in kernels.items() if k.launches}
        check(not counts, f"{label}: launched the port's kernels {counts}")
        got = got.cpu()
        check(got.shape == (2, cfg.num_classes)
              and bool(torch.isfinite(got).all()),
              f"{label}: logits of shape {tuple(got.shape)} or non-finite")
        d = float((got - want).abs().max())
        scale = float(want.abs().max())
        top1 = bool((got.argmax(-1) == want.argmax(-1)).all())
        res = dict(max_abs_dlogit=d, max_abs_logit=scale, rel=d / scale,
                   top1_equal=top1, card_ms=card_ms, cpu_s=cpu_s)
        line = (f"[dense] {label} full width, 2 images: card vs CPU dense "
                f"max|dlogit|={d:.3g} ({d / scale:.3g} of max|logit| "
                f"{scale:.3g}) top1_equal={top1}; card forward "
                f"{card_ms:.1f} ms, CPU {cpu_s:.1f}s on {card}")
        if model == "resnet50":
            eng = PipelineEngine(cfg, trees[("resnet50", "int8")][1],
                                 mode="int8", n_stages=1, microbatch=2,
                                 device="cuda")
            served = torch.from_numpy(eng.run_batch(serve_images[1]))
            res["int8_max_abs_dlogit"] = float((served - got).abs().max())
            res["int8_top1_equal"] = bool((served.argmax(-1)
                                           == got.argmax(-1)).all())
            line += (f"; served int8 vs dense max|dlogit|="
                     f"{res['int8_max_abs_dlogit']:.3g} top1_equal="
                     f"{res['int8_top1_equal']}")
        print(line, flush=True)
        check(d <= DENSE_CNN_REL_BOUND * scale and top1,
              f"{label}: card dense logits off the CPU's by {d:.3g}")
        out[label] = res
    return out


# ---------------------------------------------------------------------------
# Phase 4: the LM zoo served at full width through the LM engine
# ---------------------------------------------------------------------------

LM_PROMPTS = (37, 64, 130, 255, 300, 511, 777, 1000)
# 8 new tokens each (16 before Whisper-small's path joined: the run's
# time), so slots still refill while others are live
LM_NEW, LM_SLOTS = 8, 4
# the three larger dense configs: 4 requests (buckets 64, 512, 1024,
# 1024, so Gemma3's window of 512 binds), 8 new tokens each
DENSE_LM_PROMPTS = (37, 300, 777, 1000)
DENSE_LM_NEW = 8
# OLMoE-1B-7B: every forward runs 3137 linears at 16 layers (3 x 64
# experts and the attention's 4 per layer, and the head), about 1 s of
# host per forward in the compiled modes; 2 requests (buckets 64 and 1024), 2 new tokens each
# (one decode step); DeepSeek-V2-Lite-16B takes the same traffic
OLMOE_PROMPTS = (37, 777)
OLMOE_NEW = 2
LM_MAX_SEQ = 1024 + 16 + 8
# (arch, modes, prompts, new tokens, prefills held against the CPU's plain
# forward[, layers served where the published depth does not fit the card])
LM_PATHS = [
    ("smollm_360m", ("int8", "sparse_cfmm", "dense"), LM_PROMPTS, LM_NEW, 2),
    ("gemma3_1b", ("dense", "int8", "sparse_cfmm"), DENSE_LM_PROMPTS,
     DENSE_LM_NEW, 1),
    ("stablelm_3b", ("dense", "int8"), DENSE_LM_PROMPTS, DENSE_LM_NEW, 0),
    # f32 weights are 58.6 GB: too large for a CPU forward in the time;
    # 20 of its 40 layers since the distribution phase joined (27-44 s):
    # its path took 80-83 s of 1085-1176 s runs at 40 (the f32 init, the
    # compile), 39-43 s at 20
    ("phi3_medium_14b", ("dense", "int8"), DENSE_LM_PROMPTS, DENSE_LM_NEW, 0,
     20),
    # the MoE FFN: f32 weights are 25.8 GiB, too large for a CPU forward
    # in the time
    # `dense` at its published 16 layers, the compiled modes at 8 (1569
    # linears a forward): their host-bound checks took 47.2 + 49.9 s of a
    # 1005.4 s run at 16 once Qwen2-VL-7B's path joined
    ("olmoe_1b_7b", ("dense",), OLMOE_PROMPTS, OLMOE_NEW, 0),
    ("olmoe_1b_7b", ("int8", "sparse_cfmm"), OLMOE_PROMPTS, OLMOE_NEW, 0, 8),
    # MLA on the MoE FFN: f32 weights are 58.5 GiB, the int8 tree 14.6 GiB.
    # `dense` at the published depth (27 layers); `int8` at 4 (the dense
    # first layer and 3 MoE layers): its checks, host-bound (~276k
    # launches a profiled run), took 152 s of a 1041 s run at 27 layers
    # once the training phases joined, 61.1 s of a 970.9 s run at 14 once
    # Whisper-small's path joined, 40-44 s at 8 and 15-23 s at 4 once the
    # distribution phase joined
    ("deepseek_v2_lite_16b", ("dense",), OLMOE_PROMPTS, OLMOE_NEW, 0),
    ("deepseek_v2_lite_16b", ("int8",), OLMOE_PROMPTS, OLMOE_NEW, 0, 4),
    # RWKV-6: f32 weights 28.2 GiB, at its published depth
    ("rwkv6_7b", ("dense", "int8"), DENSE_LM_PROMPTS, DENSE_LM_NEW, 0),
    # Jamba: 192.1 GiB of f32 weights at 32 layers; one period of 8 layers
    # (every kind of block it has) is 49.5 GiB, with the int8 tree beside
    # it about 62 GiB (10 layers would need about 77 GiB)
    ("jamba_v01_52b", ("dense", "int8"), OLMOE_PROMPTS, OLMOE_NEW, 0, 8),
    # M-RoPE: f32 weights 28.4 GiB, at its published depth; `dense` also
    # runs the 3-D position check, `int8` the int8 KV cache check
    ("qwen2_vl_7b", ("dense", "int8"), DENSE_LM_PROMPTS, DENSE_LM_NEW, 0),
]
# the kernel each compiled mode's linears launch
LM_LINEAR = {"int8": "cfmm_matmul", "sparse_cfmm": "sparse_matvec"}
# (n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff, vocab) as
# published (configs/<arch>.py names the source)
PUBLISHED = {
    "smollm_360m": (32, 960, 15, 5, 64, 2560, 49152),
    "gemma3_1b": (26, 1152, 4, 1, 256, 6912, 262144),
    "stablelm_3b": (32, 2560, 32, 32, 80, 6912, 50304),
    "phi3_medium_14b": (40, 5120, 40, 10, 128, 17920, 100352),
    "olmoe_1b_7b": (16, 2048, 16, 16, 128, 1024, 50304),
    "deepseek_v2_lite_16b": (27, 2048, 16, 16, 192, 10944, 102400),
    "rwkv6_7b": (32, 4096, 64, 64, 64, 14336, 65536),
    "jamba_v01_52b": (32, 4096, 32, 8, 128, 14336, 65536),
    "qwen2_vl_7b": (28, 3584, 28, 4, 128, 18944, 152064),
}
# (n_experts, top_k, d_ff_expert, n_shared) of the MoE configs,
# (kv_lora, qk_nope, qk_rope, v_dim) of the MLA ones, and the SSM
# mixers' (d_inner, d_state, d_conv, dt_rank) for Mamba and (head_dim,
# decay_lora) for RWKV-6, as published
PUBLISHED_MOE = {"olmoe_1b_7b": (64, 8, 1024, 0),
                 "deepseek_v2_lite_16b": (64, 6, 1408, 2),
                 "jamba_v01_52b": (16, 2, 14336, 0)}
PUBLISHED_MLA = {"deepseek_v2_lite_16b": (512, 128, 64, 128)}
PUBLISHED_SSM = {"jamba_v01_52b": ("mamba", 8192, 16, 4, 256),
                 "rwkv6_7b": ("rwkv6", 64, 64)}
# (mrope_sections, rope_theta) of the M-RoPE configs, as published
PUBLISHED_MROPE = {"qwen2_vl_7b": ((16, 24, 24), 1e6)}
# max |dlogit| allowed between two forwards of the same tokens: the card
# against the CPU's plain versions, and the kernels against their plain
# versions substituted on the card.  Both sides compute the same function
# with bf16 rounded at other points (flash p and sums, CUDA's and the
# CPU's exp/rsqrt/sin/cos, cuBLAS's and the CPU's bf16 GEMMs); one such
# rounding can flip an int8 activation code under a tensor-wide scale,
# and the layers carry the flip on.  Measured on an H100 80GB HBM3
# (700 W), SmolLM-360M: 0.12 card vs CPU (prompts 37 and 64) and 0.31
# kernel vs plain attention, with logits of std 0.54; a wrong mask or a
# lost tile moves logits by several standard deviations.
LM_LOGIT_BOUND = 0.5
# The int8 decode steps of StableLM-3B and Phi-3-medium spread further:
# 0.7266 and 0.8479 against the plain versions (logits of std 0.88),
# every prefill within 0.31.  Measured cause (``decode_witnesses``, H100
# 80GB HBM3, 700 W): the first decode step on the same cache is exact;
# the spread sits in the 37-token slot, which attends to its prompt's
# pad rows (37 to 63) because the slots share one KV length counter, as
# in the JAX engine; swapping only those rows of the plain run's cache
# into the kernel run's moves the step by 0.74 / 0.85; the same requests
# one slot at a time spread 0.20 / 0.21; a per-row activation scale
# leaves 0.65 / 0.64; one SDPA call as the attention sits 0.65-0.85 from
# both runs.  A planted fault (one lost 64-key tile) reads 2.2-3.7 on
# those decode steps.  Held to 1.0: 1.17x the largest healthy reading,
# below half the planted one.  DeepSeek-V2-Lite-16B's int8 decode step
# (at 14 layers) reads 0.5273 (logits of std 0.88) on the plain run's
# routing replayed,
# with every witness on one routing: the plain step on the kernel's
# cache exact; its 37-token slot's latent pad rows swapped in move the
# step by 0.6094; one slot 0.207; a per-row scale 0.5557; SDPA 0.5962
# from both runs; the lost tile 1.0742 / 2.7344 (H100 80GB HBM3, 700 W).
# Gemma3-1B's `sparse_cfmm` decode step is bounded slot by slot: the
# shared length counter moves its short-prompt slots past any bound that
# would part a fault from health.  Its first step by slot (prompts 37,
# 300, 777, 1000), kernel vs plain: 2.0659 / 0.3428 / 0.1641 / 0.1602
# (logits of std 0.60); the plain step on the kernel's cache exact; the
# plain run's pad rows swapped in move it by 2.102; one slot at a time
# 0.1602; one SDPA call as the attention 3.5547 / 0.6758 / 2.1055 / 2.0234
# from the plain run; a lost 64-key tile 2.543 / 2.7539 / 2.1367 / 3.1016
# (H100 80GB HBM3, 700 W).  The 777- and 1000-token slots keep
# LM_LOGIT_BOUND, which the lost tile fails there; the others are held by
# the witnesses (the step exact on the kernel's cache, one slot within
# LM_LOGIT_BOUND).  Its `int8` path spreads the same way in the witnesses
# (2.8281 / 2.3125 / 0.1797 / 0.1729), but its tokens part in the prefill,
# before a decode step is compared; the `dense` path reads 0.065.
# Every other decode step, and every prefill, keeps LM_LOGIT_BOUND.
LM_DECODE_BOUNDS = {"stablelm_3b/int8": 1.0, "phi3_medium_14b/int8": 1.0,
                    "deepseek_v2_lite_16b/int8": 1.0,
                    "gemma3_1b/sparse_cfmm": {777: LM_LOGIT_BOUND,
                                              1000: LM_LOGIT_BOUND}}
# max |dlogit| of a bucketed dense prefill against the unpadded one on
# the card: measured 0 to 0.0703 (H100 80GB HBM3, 700 W; SmolLM, Gemma3,
# StableLM, Phi-3 at 37 -> 64 and 777 -> 1024 tokens), held with 2x
# headroom; a prefill that reads the wrong position reads several
LM_BUCKET_BOUND = 0.15
# the MoE capacity factor of that check: every expert queue holds every
# token, so no pick is dropped in either run (JAX's test_decode.py runs
# its MoE configs at the same factor)
LOOSE_CAPACITY = 16.0


def lm_linears(cfg, decode=False) -> int:
    """The linears one forward runs: per layer the mixer's (attention: q,
    k, v, o; MLA's q, kv_down, k_up, v_up and o in a prefill, and in a
    decode step q, kv_down and o: the absorbed path takes k_up and v_up as
    dense weights; Mamba: in_proj, x_proj, dt_proj, out_proj; RWKV-6:
    mix_lora_a, r, k, v, g, w_lora_a, w_lora_b, o) and the FFN's (gate, up
    and down, three per expert in an MoE layer — every expert runs on its
    queue, empty rows too, as JAX's vmap runs them — and three for the
    shared experts; RWKV's channel-mix wk, wr, wv), and an untied head."""
    mixer = {"attn": (3 if decode else 5) if cfg.mla else 4,
             "mamba": 4, "rwkv": 8}
    n = 0
    for sig in cfg.layer_sigs():
        experts = (cfg.moe.n_experts + (cfg.moe.n_shared > 0)
                   if sig["moe"] else 1)
        n += mixer[sig["kind"]] + 3 * experts
    return n + (0 if cfg.tie_embeddings else 1)


def lm_requests(cfg, prompts=LM_PROMPTS, new=LM_NEW):
    from repro_torch.serving.engine import Request
    rng = np.random.RandomState(0)
    return [Request(rid=i, prompt=[int(t) for t in rng.randint(1, cfg.vocab,
                                                               L)],
                    max_new_tokens=new)
            for i, L in enumerate(prompts)]


class LMRecorder:
    """Wraps ``lm.forward_prefill``/``forward_decode`` for one engine run:
    per call its kind, the active slots, the last-position logits (kept
    on the card), and the call's time with the card synchronised on both
    sides.  The engine syncs at every step anyway (it reads the argmax).
    With ``snapshot``, also the first decode step's batch and a copy of
    the cache it was given."""

    def __init__(self, engine, snapshot=False):
        self.engine, self.calls = engine, []
        self.snapshot = None if snapshot else False

    def __enter__(self):
        from repro_torch.models import lm
        self._orig = (lm.forward_prefill, lm.forward_decode)

        def wrap(kind, fn):
            def call(*a, **kw):
                if kind == "decode" and self.snapshot is None:
                    self.snapshot = (a[1], _clone_tree(a[3]))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, nc = fn(*a, **kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                rows = [0] if kind == "prefill" else [
                    i for i, r in enumerate(self.engine.active)
                    if r is not None]
                self.calls.append((kind, rows, logits[:, -1].float(), dt,
                                   a[1]))
                return logits, nc
            return call
        lm.forward_prefill = wrap("prefill", self._orig[0])
        lm.forward_decode = wrap("decode", self._orig[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.models import lm
        lm.forward_prefill, lm.forward_decode = self._orig


class RouteRecorder:
    """Wraps ``moe.route`` for one run: the picks (``expert_idx``, on the
    card) and keep mask of every MoE layer call, in order.  With
    ``replay`` (another run's recorder), ``moe.pick_experts`` returns that
    run's picks, call by call, in place of its own: the run makes the
    other run's routing choices with its own arithmetic."""

    def __init__(self, replay=None):
        self.picks, self.keeps, self.replay = [], [], replay

    def __enter__(self):
        from repro_torch.models import moe
        self._orig = (moe.route, moe.pick_experts)

        def route(*a, **kw):
            r = self._orig[0](*a, **kw)
            self.picks.append(r.expert_idx)
            self.keeps.append(r.keep)
            return r
        moe.route = route
        if self.replay is not None:
            taped = iter(self.replay.picks)

            def pick(probs, top_k):
                want = next(taped)
                check(tuple(want.shape) == (probs.shape[0], top_k),
                      "routing replay: the runs' schedules differ")
                return want
            moe.pick_experts = pick
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route, moe.pick_experts = self._orig


def real_rows(call) -> list:
    """The token rows of one recorded forward whose routing reaches a
    served logit: a prefill's first L rows (its pad rows queue behind
    them), a decode step's active slots."""
    kind, rows, _, _, batch = call
    if kind == "decode":
        return rows
    length = batch.get("length")
    return list(range(int(length[0]) if length is not None
                      else batch["tokens"].shape[1]))


def routing_agreement(calls_a, calls_b, route_a, route_b, n_moe):
    """Two runs' routing picks, (layer, token, choice) by choice, over the
    real rows (``real_rows``) of every prefill and of the decode steps
    before a greedy token parts (as ``compare_runs``).  Returns (picks
    compared, share equal)."""
    n = same = 0
    parted = False
    for c, (call_a, call_b) in enumerate(zip(calls_a, calls_b)):
        if call_a[0] == "decode" and parted:
            continue
        rows = torch.tensor(real_rows(call_a))
        for i in range(c * n_moe, (c + 1) * n_moe):
            a = route_a.picks[i].cpu()[rows]
            b = route_b.picks[i].cpu()[rows]
            n += a.numel()
            same += int((a == b).sum())
        parted = parted or any(int(call_a[2][r].argmax())
                               != int(call_b[2][r].argmax())
                               for r in call_a[1])
    return n, same / max(n, 1)


@contextlib.contextmanager
def plain_versions(names, attention=None):
    """Substitute the named kernels' plain versions in ``ops`` for one
    run (the LM paths launch ``flash_attention``, ``cfmm_matmul`` and
    ``sparse_matvec``; a training step takes the attention's gradient by
    autograd through the plain version); ``attention`` replaces the flash
    kernel's plain version by another function of the same signature."""
    from repro_torch.kernels import cfmm_matmul, flash_attention, ops, ref
    att = attention or flash_attention.flash_attention_plain
    plain = {"flash_attention": {"_flash_kernel": att, "_flash_grad": att},
             "cfmm_matmul": {"_cfmm_kernel": cfmm_matmul.cfmm_matmul_plain},
             "sparse_matvec": {"sparse_matvec": ref.sparse_matvec_ref}}
    subs = {attr: fn for n in names for attr, fn in plain[n].items()}
    orig = {name: getattr(ops, name) for name in subs}
    for name, fn in subs.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(ops, name, fn)


@contextlib.contextmanager
def per_row_scales():
    """Every LM linear quantizes its input rows each under its own scale
    (``apply_linear(per_row=True)``), for one run."""
    from repro_torch.models import attention, layers, lm, ssm
    mods = (attention, layers, lm, ssm)
    orig = attention.apply_linear
    row = functools.partial(orig, per_row=True)
    for mod in mods:
        mod.apply_linear = row
    try:
        yield
    finally:
        for mod in mods:
            mod.apply_linear = orig


def sdpa_attention(q, k, v, causal=True, window=None):
    """The flash kernel's function as one SDPA call, its mask by
    position: a third implementation of the attention."""
    from repro_torch.kernels import flash_attention as fa
    return _sdpa(q, k, v, fa.position_mask(q.shape[3], k.shape[2], causal,
                                           window, q.device))


def lost_tile_attention(q, k, v, causal=True, window=None):
    """A planted fault: ``sdpa_attention`` with keys 64 to 127 hidden
    from every query past them, as if a kernel lost one KV tile."""
    from repro_torch.kernels import flash_attention as fa
    Tq, Tk = q.shape[3], k.shape[2]
    mask = fa.position_mask(Tq, Tk, causal, window, q.device)
    qpos = torch.arange(Tq, device=q.device)[:, None] + (Tk - Tq)
    kpos = torch.arange(Tk, device=q.device)[None, :]
    return _sdpa(q, k, v, mask & ~((kpos >= 64) & (kpos < 128)
                                   & (qpos >= 128)))


def _sdpa(q, k, v, mask):
    B, KVH, G, Tq, D = q.shape
    o = F.scaled_dot_product_attention(q.reshape(B, KVH * G, Tq, D), k, v,
                                       attn_mask=mask, enable_gqa=True)
    return o.reshape(B, KVH, G, Tq, v.shape[-1])


def compare_runs(calls_a, calls_b):
    """Two engine runs of the same requests, call by call (the schedule is
    the same without EOS).  Every prefill sees only its prompt; decode
    steps are compared up to the first step whose greedy token differs
    (slots share each linear's activation scale).  Returns (max |dlogit|
    per prefill, max |dlogit| over the decode steps compared, tokens
    compared, the margins of run a's top token over run b's where they
    differ, and {slot: max |dlogit| over its decode steps compared})."""
    pre, dec, n_tok, margins, parted = [], 0.0, 0, [], False
    by_slot = collections.defaultdict(float)
    for (kind, rows, la, _, _), (_, _, lb, _, _) in zip(calls_a, calls_b):
        if kind == "decode" and parted:
            continue
        for r in rows:
            d = float((la[r] - lb[r]).abs().max())
            if kind == "prefill":
                pre.append(d)
            else:
                dec = max(dec, d)
                by_slot[r] = max(by_slot[r], d)
            ta, tb = int(la[r].argmax()), int(lb[r].argmax())
            if ta != tb:
                margins.append(float(la[r][ta] - la[r][tb]))
                parted = True
            n_tok += 1
    return pre, dec, n_tok, margins, dict(by_slot)


def decode_over(bound, by_slot, prompts):
    """Whether decode readings ``by_slot`` ({slot: max |dlogit|}; slot i
    serves ``prompts[i]``) pass an ``LM_DECODE_BOUNDS`` value: a number
    bounds every slot, a dict {prompt length: bound} only those prompts'
    slots."""
    if isinstance(bound, dict):
        check(len(prompts) <= LM_SLOTS, "a bound by prompt needs a slot "
              "for each prompt")
        return any(by_slot.get(i, 0.0) > bound[L]
                   for i, L in enumerate(prompts) if L in bound)
    return any(d > bound for d in by_slot.values())


def f64_gemm(key: str) -> bool:
    """A cuBLAS float64 matrix product's kernel, by its profiler name."""
    k = key.lower()
    return ("gemm" in k or "gemv" in k) and any(
        t in k for t in ("double", "f64", "dgemm", "zgemm"))


def profile_lm(make_engine, requests, label):
    """One more served run (``requests()``) under ``torch.profiler``: wall
    time, the card's busy time (sum of device kernel times on the one
    stream), idle share, the time of float64 GEMMs and of
    ``direct_copy`` (casts and copies), and the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile
    eng = make_engine()
    torch.cuda.synchronize()
    # device activity only: a run is ~270k host ops, whose records would
    # cost more than the run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(requests())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_kernels(prof)
    if not events:
        print(f"[profile] {label}: wall {wall_ms:.1f} ms; device time not "
              "measured (the profiler saw no kernels)", flush=True)
        return None
    busy_ms = sum(ms for ms, _ in events.values())
    ours_ms = sum(ms for key, (ms, _) in events.items()
                  if any(k in key for k in OUR_KERNELS))
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; the port's kernels "
          f"{ours_ms:.2f} ms of it; device launches "
          f"{sum(n for _, n in events.values())}", flush=True)
    f64_ms = sum(ms for key, (ms, _) in events.items() if f64_gemm(key))
    copy_ms = sum(ms for key, (ms, _) in events.items()
                  if "direct_copy" in key)
    print(f"[profile] {label}: float64 GEMM {f64_ms:.3f} ms, direct_copy "
          f"{copy_ms:.3f} ms", flush=True)
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:8]
    for key, (ms, n) in top:
        print(f"[profile]   {ms:8.3f} ms x{n:5d}  {key[:120]}", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, ours_ms=ours_ms,
                idle=1 - busy_ms / wall_ms, f64_gemm_ms=f64_ms,
                direct_copy_ms=copy_ms,
                top=[(key[:120], ms, n) for key, (ms, n) in top])


def device_kernels(prof) -> dict:
    """name -> (device ms, launches) of the device activity a profiler
    recorded (kernels, copies, sets), summed from its raw events: the
    profiler's per-event Python records (``key_averages``) cost ~0.2 ms
    an event, ~50 s for one of DeepSeek's ``int8`` runs."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and e.duration_ns() > 0:
            acc = out[e.name()]
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
    return {k: tuple(v) for k, v in out.items()}


def gib(n_bytes) -> str:
    return f"{n_bytes / 2 ** 30:.2f} GiB"


def bucketed_against_unpadded(tree, cfg, reqs, label):
    """``dense`` only: a bucketed (end-padded) prefill against the
    unpadded one, on the card, for the shortest and a 777-token prompt
    (buckets 64 and 1024).  Exact on the CPU (tests); on the card cuBLAS
    may pick another GEMM for another M.  A planted fault, the bucketed
    prefill told a length one short (it reads the logits of the token
    before the last), must fall outside the bound.  Returns max |dlogit|
    by prompt, and the planted fault's.

    An MoE stack runs at ``LOOSE_CAPACITY``: its capacity follows the
    token count, pad rows included (a 37-token prompt queues 8 rows per
    expert unpadded and 16 in its 64 bucket at the served 1.25), so at
    the served capacity a real pick dropped in one run may be kept in the
    other; at 16 every queue holds every token, no pick is dropped, and
    the pad rows queue behind the real ones (as the CPU test
    ``test_dense_bucketed_prefill_bit_exact`` runs it)."""
    from repro_torch import nn
    from repro_torch.models import lm, moe
    from repro_torch.serving.engine import _bucket_len
    out, planted = {}, {}
    served = moe.moe_forward
    if cfg.moe is not None:
        moe.moe_forward = functools.partial(served,
                                            capacity_factor=LOOSE_CAPACITY)
    try:
        for r in (reqs[0], next(r for r in reqs if len(r.prompt) == 777)):
            L = len(r.prompt)
            bucket = _bucket_len(L, LM_MAX_SEQ)
            logits = []
            for width, length in ((L, None), (bucket, L), (bucket, L - 1)):
                toks = torch.zeros((1, width), dtype=torch.long)
                toks[0, :L] = torch.tensor(r.prompt)
                batch = {"tokens": toks.cuda()}
                if length is not None:
                    batch["length"] = torch.tensor([length],
                                                   dtype=torch.int32)
                cache = nn.unbox(lm.cache_init(cfg, 1, LM_MAX_SEQ,
                                               device="cuda"))
                logits.append(lm.forward_prefill(tree, batch, cfg, cache)[0]
                              .float())
            out[L] = float((logits[0] - logits[1]).abs().max())
            planted[L] = float((logits[0] - logits[2]).abs().max())
    finally:
        moe.moe_forward = served
    print(f"[lm] {label}: bucketed vs unpadded prefill on the card"
          + (f" (MoE capacity factor {LOOSE_CAPACITY})" if cfg.moe else "")
          + f": max|dlogit| by prompt {out}; planted length-1 fault "
          f"{planted}", flush=True)
    check(max(out.values()) <= LM_BUCKET_BOUND,
          f"{label}: bucketed prefill off the unpadded one by {out}")
    check(min(planted.values()) > LM_BUCKET_BOUND,
          f"{label}: the planted length fault passes the bound: {planted}")
    return dict(max_dlogit=out, planted_length_fault=planted)


# the recurrent state leaves of a Mamba (conv, ssm) and an RWKV (the
# time-mix shift and wkv, the channel-mix cm) layer's cache
RECURRENT_LEAVES = ("conv", "ssm", "shift", "wkv", "cm")


def _zero_recurrent(cache, key=None):
    """The cache with every recurrent state leaf zeroed (a planted fault:
    a decode step that lost the state its prefill carried)."""
    if isinstance(cache, dict):
        return {k: _zero_recurrent(v, k) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_zero_recurrent(v) for v in cache]
    return torch.zeros_like(cache) if key in RECURRENT_LEAVES else cache


def decay_floor_check(label):
    """RWKV's log-decay floors its decay at 1e-38, below f32's smallest
    normal number: the card must keep the subnormal (no flush to zero),
    as the CPU does, or a decay that underflows to 0 logs to -inf.  The
    floor equal to the CPU's bits, its log finite and within 1e-6
    relative (CUDA's logf and the CPU's round apart by an ulp)."""
    zero = torch.zeros(1)
    floor, card = torch.clamp_min(zero, 1e-38), torch.clamp_min(
        zero.cuda(), 1e-38)
    want, got = torch.log(floor), torch.log(card).cpu()
    print(f"[lm] {label}: max(0, 1e-38) on the card {float(card):.6g} "
          f"(the CPU's {float(floor):.6g}); its log {float(got):.6f}, "
          f"on the CPU {float(want):.6f}", flush=True)
    check(torch.equal(card.cpu(), floor) and float(floor) > 0
          and bool(torch.isfinite(got).all())
          and float((got - want).abs()) <= 1e-6 * float(want.abs()),
          f"{label}: the card flushes the decay floor's subnormal")


RWKV_CHUNK = 64              # ssm.rwkv6_forward's chunk


def carry_prompts(cfg, reqs) -> list:
    """The state-carry witness's prompts: the shortest, and the 777-token
    one, or in an RWKV stack the longest whose last 64-token chunk holds
    at least 34 tokens in both prefills (T mod 64 >= 33).  RWKV's chunk
    factors its decays through the chunk's position 32, the last real
    token when the chunk is shorter; so prefill(T) and prefill(T + 1)
    then round the chunk's first rows differently, and 32 layers carry
    that on (the 777-token reading is printed beside, unchecked)."""
    if cfg.ssm is None or cfg.ssm.kind != "rwkv6":
        return [reqs[0], next(r for r in reqs if len(r.prompt) == 777)]
    return [reqs[0], max((r for r in reqs
                          if (len(r.prompt) - 1) % RWKV_CHUNK >= 33),
                         key=lambda r: len(r.prompt))]


def state_carry_witness(tree, cfg, reqs, label, per_row=False):
    """A recurrent stack's prefill carries its state into decode: for the
    ``carry_prompts``, prefill(T + 1) against prefill(T) followed by one
    decode step of token T + 1, on the card, within ``LM_LOGIT_BOUND``
    (the chunked scan against the one-token step).  A planted fault, the
    step on a zeroed recurrent state, must read above the bound.  An MoE
    stack runs at ``LOOSE_CAPACITY``, where no pick is dropped in either
    run (the capacity follows the token count).  In a compiled mode the
    served run shares one activation scale among a prefill's T + 1 rows
    where the step has its one row: that reading is printed, and the
    check runs with per-row scales (``per_row_scales``), which quantize
    the last row alike in both.  Returns max |dlogit| and the planted
    fault's, by prompt (and the served scales' reading; in an RWKV stack
    the unchecked 777-token reading)."""
    from repro_torch import nn
    from repro_torch.models import lm, moe
    prompts = carry_prompts(cfg, reqs)
    extra = [r for r in reqs if len(r.prompt) == 777 and r not in prompts]

    def run(scales, chosen=prompts):
        out, planted = {}, {}
        for r in chosen:
            T = len(r.prompt) - 1
            toks = torch.tensor([r.prompt], dtype=torch.long, device="cuda")

            def prefill(n):
                cache = nn.unbox(lm.cache_init(cfg, 1, LM_MAX_SEQ,
                                               device="cuda"))
                return lm.forward_prefill(tree, {"tokens": toks[:, :n]},
                                          cfg, cache)
            with scales():
                full = prefill(T + 1)[0][0, -1].float()
                _, cache = prefill(T)
                step = {"token": toks[:, T:T + 1]}
                carried = lm.forward_decode(tree, step, cfg, cache)[0]
                lost = lm.forward_decode(tree, step, cfg,
                                         _zero_recurrent(cache))[0]
            out[T + 1] = float((carried[0, -1].float() - full).abs().max())
            planted[T + 1] = float((lost[0, -1].float() - full).abs().max())
        return out, planted

    served = moe.moe_forward
    if cfg.moe is not None:
        moe.moe_forward = functools.partial(served,
                                            capacity_factor=LOOSE_CAPACITY)
    checked = per_row_scales if per_row else contextlib.nullcontext
    try:
        shared = run(contextlib.nullcontext)[0] if per_row else None
        out, planted = run(checked)
        unchecked = run(checked, extra)[0] if extra else None
    finally:
        moe.moe_forward = served
    print(f"[lm] {label}: state carry on the card"
          + (f" (MoE capacity factor {LOOSE_CAPACITY})" if cfg.moe else "")
          + f": prefill(T+1) vs prefill(T) + one decode step, max|dlogit| "
          f"by T+1 {out}"
          + (f" with per-row activation scales ({shared} with the served "
             f"per-tensor ones)" if per_row else "")
          + f"; planted zeroed state {planted}"
          + (f"; unchecked, RWKV's chunk reference on a pad token: "
             f"{unchecked}" if extra else ""), flush=True)
    check(max(out.values()) <= LM_LOGIT_BOUND,
          f"{label}: the decode step off the longer prefill by {out}")
    check(min(planted.values()) > LM_LOGIT_BOUND,
          f"{label}: the planted zeroed state passes the bound: {planted}")
    return dict(max_dlogit=out, planted_zeroed_state=planted,
                served_scales_max_dlogit=shared,
                unchecked_pad_reference=unchecked)


# ---------------------------------------------------------------------------
# M-RoPE and the int8 KV cache (Qwen2-VL-7B)
# ---------------------------------------------------------------------------

# check (a)'s prompt in Qwen2-VL's layout: 10 text tokens at 0-9 on every
# stream, an image of 1 x 24 x 32 patches at (10, 10 + h, 10 + w), then
# 222 text tokens from 10 + 32 on every stream: 1000 tokens
MROPE_TEXT, MROPE_GRID, MROPE_AFTER = 10, (1, 24, 32), 222
MROPE_STEPS = 4
# how far the 3-D positions must move the image tokens' and the later
# text tokens' logits off the text positions' (max |dlogit| over their
# rows).  A path that dropped the streams reads 0 to the bit (the same
# function of the same inputs); the kernel against the plain flash reads
# 0.0625 on this prompt.  Measured 1.996 (image) and 2.068 (later text)
# on an H100 80GB HBM3 at 700 W, logits of std 0.88: random weights mix
# little across positions.  Held above twice ``LM_LOGIT_BOUND``.
MROPE_MOVED_MIN = 2 * LM_LOGIT_BOUND


def mrope_prompt_positions(steps=MROPE_STEPS):
    """(3, 1, 1000 + steps) int32: check (a)'s prompt and the decode
    steps after it (every stream equal from the image's largest position
    + 1 on)."""
    gt, gh, gw = MROPE_GRID
    t, h, w = torch.meshgrid(torch.arange(gt), torch.arange(gh),
                             torch.arange(gw), indexing="ij")
    image = torch.stack([t.flatten(), h.flatten(), w.flatten()]) + MROPE_TEXT
    start = int(image.max()) + 1
    text = torch.arange(MROPE_TEXT)
    after = torch.arange(start, start + MROPE_AFTER + steps)
    pos = torch.cat([text.expand(3, -1), image, after.expand(3, -1)], dim=1)
    return pos[:, None].to(torch.int32)


def mrope_check(kernels, tree, cfg, label):
    """Check (a), ``dense`` at full width: 3-D positions reach the served
    rotation.  One 1000-token prompt in Qwen2-VL's layout
    (``mrope_prompt_positions``) prefilled through ``lm.forward_prefill``
    with its ``positions``, then ``MROPE_STEPS`` greedy decode steps; the
    same calls with the plain flash attention on the kernel run's tokens,
    each within ``LM_LOGIT_BOUND``.  Two witnesses from ``forward_train``'s
    logits at every position, 3-D positions against text ones: the 10
    leading text tokens bit-equal (causal attention; the dense GEMMs are
    row-independent), the image tokens and the text after them moved by
    more than ``MROPE_MOVED_MIN``."""
    from repro_torch import nn
    from repro_torch.models import lm
    pos = mrope_prompt_positions().cuda()
    T = pos.shape[-1] - MROPE_STEPS
    rng = np.random.RandomState(3)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab, (1, T))).cuda()

    def run(forced=None):
        cache = nn.unbox(lm.cache_init(cfg, 1, LM_MAX_SEQ, device="cuda"))
        logits, cache = lm.forward_prefill(
            tree, {"tokens": toks, "positions": pos[:, :, :T]}, cfg, cache)
        out, picked = [logits[0, -1].float()], []
        for i in range(MROPE_STEPS):
            nxt = int(out[-1].argmax()) if forced is None else forced[i]
            picked.append(nxt)
            batch = {"token": torch.tensor([[nxt]], device="cuda"),
                     "positions": pos[:, :, T + i:T + i + 1]}
            logits, cache = lm.forward_decode(tree, batch, cfg, cache)
            out.append(logits[0, -1].float())
        return out, picked

    for kern in kernels.values():
        kern.launches = 0
    got, picked = run()
    n_attn = sum(sig["kind"] == "attn" for sig in cfg.layer_sigs())
    check(kernels["flash_attention"].launches == n_attn,
          f"{label}: {kernels['flash_attention'].launches} flash launches "
          f"in the 3-D prefill, want {n_attn}")
    with plain_versions(["flash_attention"]):
        want, _ = run(picked)
    d = [float((a - b).abs().max()) for a, b in zip(got, want)]
    finite = all(bool(torch.isfinite(x).all()) for x in got)

    # every position's logits, 3-D positions against text ones
    flat = dataclasses.replace(cfg, remat=False)
    with torch.no_grad():
        by_3d = lm.forward_train(tree, {"tokens": toks,
                                        "positions": pos[:, :, :T]}, flat)[0]
        by_text = lm.forward_train(tree, {"tokens": toks}, flat)[0]
    img_end = MROPE_TEXT + MROPE_GRID[0] * MROPE_GRID[1] * MROPE_GRID[2]
    lead_equal = torch.equal(by_3d[0, :MROPE_TEXT], by_text[0, :MROPE_TEXT])
    moved = [float((by_3d[0, a:b].float() - by_text[0, a:b].float())
                   .abs().max())
             for a, b in ((MROPE_TEXT, img_end), (img_end, T))]
    flipped = float((by_3d[0, MROPE_TEXT:].argmax(-1)
                     != by_text[0, MROPE_TEXT:].argmax(-1)).float().mean())
    last = float((by_3d[0, -1].float() - got[0]).abs().max())
    del by_3d, by_text
    print(f"[lm] {label}: 3-D positions (10 text, a 1x24x32 image at "
          f"(10, 10+h, 10+w), 222 text from 42; {T} tokens, "
          f"{MROPE_STEPS} decode steps): kernel vs plain flash max|dlogit| "
          f"prefill {d[0]:.4g}, steps {[round(x, 4) for x in d[1:]]}; "
          f"witnesses: 10 leading text tokens bit-equal to text positions "
          f"{lead_equal}; image tokens moved {moved[0]:.4g}, later text "
          f"{moved[1]:.4g} (must exceed {MROPE_MOVED_MIN}), top-1 changed "
          f"on {flipped:.3f} of those rows; "
          f"forward_train's last row vs the prefill's {last:.4g}",
          flush=True)
    check(finite, f"{label}: non-finite logits on 3-D positions")
    check(max(d) <= LM_LOGIT_BOUND,
          f"{label}: 3-D positions, kernel off plain by {d}")
    check(lead_equal, f"{label}: the leading text tokens' logits moved "
          "with the image's positions")
    check(min(moved) > MROPE_MOVED_MIN,
          f"{label}: the 3-D positions barely move the logits: {moved}")
    return dict(prefill_max_dlogit=d[0], decode_max_dlogit=d[1:],
                leading_text_bit_equal=lead_equal,
                image_moved=moved[0], later_text_moved=moved[1],
                top1_changed_share=flipped,
                train_last_row_vs_prefill=last)


def kv_cache_run(tree, cfg, reqs, kv_dtype, new, forced=None):
    """Serve ``reqs`` through ``lm.forward_prefill`` / ``forward_decode``
    into a cache of ``kv_dtype``, one slot each: each prompt prefilled
    alone at its exact length and merged into its slot (the engine's
    ``_merge_slot_cache``), then ``new - 1`` decode steps over the slots,
    greedy or on the ``forced`` tokens.  Returns (per call the logits of
    its rows, f32 on the card; the tokens; the cache)."""
    from repro_torch import nn
    from repro_torch.models import lm
    from repro_torch.serving.engine import _merge_slot_cache
    cache = nn.unbox(lm.cache_init(cfg, len(reqs), LM_MAX_SEQ,
                                   kv_dtype=kv_dtype, device="cuda"))
    calls, tokens = [], []
    for slot, r in enumerate(reqs):
        one = nn.unbox(lm.cache_init(cfg, 1, LM_MAX_SEQ, kv_dtype=kv_dtype,
                                     device="cuda"))
        toks = torch.tensor([r.prompt], dtype=torch.long, device="cuda")
        logits, one = lm.forward_prefill(tree, {"tokens": toks}, cfg, one)
        _merge_slot_cache(cache, one, slot)
        calls.append(logits[:, -1].float())
        tokens.append(logits[0, -1].argmax()[None])
    tokens = [torch.cat(tokens)]
    for i in range(new - 1):
        last = tokens[-1] if forced is None else forced[i]
        logits, cache = lm.forward_decode(tree, {"token": last[:, None]},
                                          cfg, cache)
        calls.append(logits[:, -1].float())
        tokens.append(logits[:, -1].argmax(-1))
    return calls, tokens, cache


# check (b)'s bound on the decode steps of its 4-slot run, kernel against
# plain (its prefills, and each request served alone, keep
# LM_LOGIT_BOUND).  Measured (H100 80GB HBM3, 700 W; Qwen2-VL-7B `int8`,
# logits of std 0.88): the steps read 0.5957-0.752 with the int8 cache
# and 0.6113-0.7354 with the bf16 cache on the same protocol, so the
# int8 cache adds no spread; per-row activation scales in both runs leave
# 0.3667-0.4629, each request alone 0.2031-0.313 over its calls: the
# slots' shared per-tensor activation scale carries it, as in the
# StableLM and Phi-3 engine steps (LM_DECODE_BOUNDS).  A planted lost KV
# tile reads 2.4844-3.0312 on the steps.  Held to 1.0: 1.33x the largest
# healthy reading, below half the planted one.
LM_KV_INT8_BOUND = 1.0


def int8_kv_check(kernels, tree, cfg, reqs, label):
    """Check (b), ``int8`` weights at full width: the int8 KV cache.  The
    ``DENSE_LM_PROMPTS`` prefilled into an int8 cache one slot each and
    ``DENSE_LM_NEW`` tokens served (``kv_cache_run``), the kernel run
    greedy and the other runs on its tokens: the bf16 cache; the int8
    cache with every kernel's plain version; with only the linears'
    plain version (the float64 product).  Held: the kernel run's prefill
    logits equal the bf16 cache's (a prefill attends its own unquantized
    keys); its codes and scales equal the plain-linear run's to the bit
    (the same f32 inputs give the same codes), and the first layer's
    equal the all-plain run's (its inputs are the same there); its
    prefills within ``LM_LOGIT_BOUND`` of the all-plain run's and its
    decode steps within ``LM_KV_INT8_BOUND``, each request served alone
    within ``LM_LOGIT_BOUND``; a planted lost KV tile outside the
    bound.  Reported beside: the step logits against
    the bf16 cache, the bf16 cache's own kernel-vs-plain spread, per-row
    activation scales, and the cache's bytes against bf16."""
    n_attn = sum(sig["kind"] == "attn" for sig in cfg.layer_sigs())
    both = ["flash_attention", "cfmm_matmul"]
    for kern in kernels.values():
        kern.launches = 0
    k_calls, picked, k_cache = kv_cache_run(tree, cfg, reqs, torch.int8,
                                            DENSE_LM_NEW)
    torch.cuda.synchronize()
    n_pre, n_dec = len(reqs), DENSE_LM_NEW - 1
    want = {"flash_attention": n_attn * n_pre,
            "cfmm_matmul": lm_linears(cfg) * (n_pre + n_dec)}
    for name, kern in kernels.items():
        check(kern.launches == want.get(name, 0),
              f"{label}: int8 KV run launched {kern.launches} {name}, want "
              f"{want.get(name, 0)}")
    forced = picked[:-1]

    def run(kv_dtype, subs=(), attention=None, one=False):
        """The calls' logits of one more run on the kernel run's tokens:
        ``subs`` the kernels replaced by their plain versions; ``one``
        serves each request alone (a cache of one slot)."""
        with plain_versions(subs, attention):
            if not one:
                return kv_cache_run(tree, cfg, reqs, kv_dtype, DENSE_LM_NEW,
                                    forced)[::2]
            return [kv_cache_run(tree, cfg, [r], kv_dtype, DENSE_LM_NEW,
                                 [f[i:i + 1] for f in forced])[0]
                    for i, r in enumerate(reqs)], None

    mx = lambda a, b: [round(float((x - y).abs().max()), 4)
                       for x, y in zip(a, b)]
    b_calls, b_cache = run(torch.bfloat16)
    p_calls, p_cache = run(torch.int8, both)
    l_calls, l_cache = run(torch.int8, ["cfmm_matmul"])
    pb_calls, _ = run(torch.bfloat16, both)
    lost_calls, _ = run(torch.int8, both, lost_tile_attention)
    with per_row_scales():
        rk_calls, _ = run(torch.int8)
        rp_calls, _ = run(torch.int8, both)
    one_k, _ = run(torch.int8, one=True)
    one_p, _ = run(torch.int8, both, one=True)
    vs_plain, vs_bf16 = mx(k_calls, p_calls), mx(k_calls, b_calls)
    vs_linear, bf16_spread = mx(k_calls, l_calls), mx(b_calls, pb_calls)
    lost, per_row = mx(p_calls, lost_calls), mx(rk_calls, rp_calls)
    alone = [max(x) for x in map(mx, one_k, one_p)]
    prefill_same = all(torch.equal(a, b)
                       for a, b in zip(k_calls[:n_pre], b_calls[:n_pre]))
    kq, pq, lq = (dict(_kv_leaves(c)) for c in (k_cache, p_cache, l_cache))
    codes_equal = all(torch.equal(kq[p], lq[p]) for p in kq)
    layer0_equal = all(torch.equal(kq[p][0], pq[p][0]) for p in kq)
    plain_share = {key: round(float(torch.cat([
        (kq[p] == pq[p]).flatten() for p in kq if p.endswith(f"/{key}")])
        .float().mean()), 4) for key in ("k", "v")}
    q_bytes = sum(t.numel() * t.element_size() for t in kq.values())
    b_bytes = sum(t.numel() * t.element_size()
                  for _, t in _kv_leaves(b_cache))
    finite = all(bool(torch.isfinite(c).all()) for c in k_calls)
    print(f"[lm] {label}: int8 KV cache ({len(reqs)} prompts "
          f"{[len(r.prompt) for r in reqs]}, one slot each at exact length, "
          f"{n_dec} decode steps; the other runs on the kernel run's "
          f"tokens), max|dlogit| per call (4 prefills, then the steps): vs "
          f"the plain versions {vs_plain}; vs the bf16 cache {vs_bf16} "
          f"(prefills bit-equal {prefill_same}); vs the plain linear only "
          f"{vs_linear}; codes and scales equal to the plain-linear run's "
          f"{codes_equal}, layer 0 equal to the all-plain run's "
          f"{layer0_equal}, share of codes equal to the all-plain run's "
          f"{plain_share}; cache {gib(q_bytes)} against bf16 {gib(b_bytes)} "
          f"({q_bytes / b_bytes:.4f}x)", flush=True)
    print(f"[lm] {label}: int8 KV witnesses, kernel vs plain: the bf16 "
          f"cache {bf16_spread}; per-row activation scales {per_row}; each "
          f"request alone, max over its calls {alone}; planted lost tile "
          f"{lost}; bound {LM_KV_INT8_BOUND}", flush=True)
    check(finite, f"{label}: non-finite logits with the int8 KV cache")
    check(prefill_same, f"{label}: an int8-cache prefill differs from the "
          "bf16 cache's")
    check(codes_equal and max(vs_linear) == 0.0,
          f"{label}: the int8 KV run differs from the plain-linear one")
    check(layer0_equal, f"{label}: layer 0's int8 KV codes differ from the "
          "plain run's")
    check(max(vs_plain[:n_pre]) <= LM_LOGIT_BOUND
          and max(vs_plain[n_pre:]) <= LM_KV_INT8_BOUND,
          f"{label}: int8 KV cache, kernel off plain by {vs_plain}")
    check(max(alone) <= LM_LOGIT_BOUND,
          f"{label}: int8 KV cache, a request alone off plain by {alone}")
    check(min(lost[n_pre:]) > LM_KV_INT8_BOUND,
          f"{label}: the planted lost tile passes the bound: {lost}")
    return dict(vs_plain=vs_plain, vs_bf16_cache=vs_bf16,
                prefill_equal_bf16=prefill_same, codes_equal_plain_linear=
                codes_equal, layer0_equal_plain=layer0_equal,
                codes_equal_share_plain=plain_share, bf16_cache_spread=
                bf16_spread, per_row_scales=per_row, alone=alone,
                lost_tile=lost, cache_bytes=q_bytes,
                bf16_cache_bytes=b_bytes)


# extra checks of one served path, by label: (a) and (b) above
LM_EXTRA_CHECKS = {"qwen2_vl_7b/dense": "mrope", "qwen2_vl_7b/int8": "int8_kv"}


def serve_lm(kernels, card, arch, modes, prompts, new, n_cpu,
             n_layers=None):
    """Serve one LM config at full width on the card in each of ``modes``:
    seeded random weights initialised (and compiled) on the card; launch
    counts of one run; the first ``n_cpu`` prefills' logits against the
    CPU's plain forward of the same tree; the logits and greedy tokens
    against a card run with every kernel of the path replaced by its
    plain version; in a compiled mode, one leaf's card-compiled bytes
    against the CPU's, and the run with only the linears' plain version
    (the float64 product), equal to the bit, with that run's profile in
    ``int8``; the ``LM_DECODE_BOUNDS`` paths' decode witnesses; in
    ``dense``, the bucketed prefill against the unpadded one (a recurrent
    stack: its exact-length prefills, and in every mode the state-carry
    witness); prefill and decode tokens/s; one profiled run; the peak
    device memory.  ``n_layers`` serves the published widths at that
    depth.  One model tree and one engine live at a time."""
    from repro_torch import nn
    from repro_torch.core.compiled_linear import ensure_compiled
    from repro_torch.launch.serve import build_cfg
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServingEngine, _bucket_len
    cfg = build_cfg(arch, "full")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim, cfg.d_ff, cfg.vocab) == PUBLISHED[arch],
          f"{arch}: not the published full width")
    if arch in PUBLISHED_MOE:
        check((cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
               cfg.moe.n_shared) == PUBLISHED_MOE[arch],
              f"{arch}: not the published MoE")
    if arch in PUBLISHED_MLA:
        m = cfg.mla
        check((m.kv_lora, m.qk_nope, m.qk_rope, m.v_dim)
              == PUBLISHED_MLA[arch], f"{arch}: not the published MLA")
    if arch in PUBLISHED_SSM:
        m = cfg.ssm
        got = ((m.kind, m.d_inner, m.d_state, m.d_conv, m.dt_rank)
               if m.kind == "mamba" else (m.kind, m.head_dim, m.decay_lora))
        check(got == PUBLISHED_SSM[arch], f"{arch}: not the published SSM")
    if arch in PUBLISHED_MROPE:
        check(cfg.pos == "mrope" and (cfg.mrope_sections, cfg.rope_theta)
              == PUBLISHED_MROPE[arch], f"{arch}: not the published M-RoPE")
    if n_layers is not None:
        print(f"[lm] {arch}: published depth {cfg.n_layers} layers, served "
              f"at {n_layers} (the published widths)", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    recurrent = any(sig["kind"] != "attn" for sig in cfg.layer_sigs())
    n_attn = sum(sig["kind"] == "attn" for sig in cfg.layer_sigs())
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        decay_floor_check(arch)
    requests = lambda: lm_requests(cfg, prompts, new)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.value.numel() for p in nn.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, nn.Param)))
    init_peak = torch.cuda.max_memory_allocated()
    print(f"[lm] {arch} full width: {n_params / 1e6:.1f} M params, init on "
          f"the card {time.perf_counter() - t0:.1f}s; f32 tree "
          f"{gib(4 * n_params)}, peak during init {gib(init_peak)} of "
          f"{gib(torch.cuda.get_device_properties(0).total_memory)}",
          flush=True)
    results = {}
    seen_peak = init_peak                # the peak from init on, over resets
    for i, mode in enumerate(modes):
        label = f"{arch}/{mode}"
        seen_peak = max(seen_peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        t0 = t_mode = time.perf_counter()
        tree = ensure_compiled(params, mode, 0.8)
        torch.cuda.synchronize()
        t_compile = time.perf_counter() - t0
        compile_peak = torch.cuda.max_memory_allocated()
        linear = LM_LINEAR.get(mode)
        if linear:
            print(f"[lm] {label}: compile peak {gib(compile_peak)} (the f32 "
                  f"tree and the compiled one) of "
                  f"{gib(torch.cuda.get_device_properties(0).total_memory)}",
                  flush=True)
            check_card_compile(params, tree, cfg, mode, label)
        if i == len(modes) - 1:
            params = None                    # the last mode: one tree left
            torch.cuda.empty_cache()
        make = lambda slots=LM_SLOTS: ServingEngine(
            cfg, tree, mode=mode, batch_slots=slots, max_seq=LM_MAX_SEQ,
            device="cuda")
        make().run(requests()[:2])                       # warm-up
        for kern in kernels.values():
            kern.launches = 0
        eng = make()
        reqs = requests()
        witnessed = label in LM_DECODE_BOUNDS
        t0 = time.perf_counter()
        with LMRecorder(eng, snapshot=witnessed) as rec, \
                RouteRecorder() as route_k:
            eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: kern.launches for name, kern in kernels.items()}
        n_fwd = len(rec.calls)
        n_dec = sum(c[0] == "decode" for c in rec.calls)
        want = {"flash_attention": n_attn * len(prompts)}
        if linear:
            want[linear] = (lm_linears(cfg) * (n_fwd - n_dec)
                            + lm_linears(cfg, decode=True) * n_dec)
        for name, got in counts.items():
            check(got == want.get(name, 0), f"{label}: {got} {name} "
                  f"launches in {n_fwd} forwards ({n_dec} decode), want "
                  f"{want.get(name, 0)}")
        for r in reqs:
            check(r.done and len(r.tokens_out) == new
                  and all(0 <= t < cfg.vocab for t in r.tokens_out),
                  f"{label}: request {r.rid} incomplete")
        logits_ok = all(bool(torch.isfinite(c[2][c[1]]).all())
                        for c in rec.calls)
        check(logits_ok, f"{label}: non-finite logits")
        pre = [c for c in rec.calls if c[0] == "prefill"]
        dec = [c for c in rec.calls if c[0] == "decode"]
        pre_tok = sum(prompts)
        pre_bucket = (pre_tok if recurrent else
                      sum(_bucket_len(L, LM_MAX_SEQ) for L in prompts))
        dec_tok = sum(len(c[1]) for c in dec)
        pre_s, dec_s = sum(c[3] for c in pre), sum(c[3] for c in dec)
        print(f"[lm] {label}: compile on the card {t_compile:.1f}s; "
              f"{len(reqs)} requests x {new} tokens in {wall:.2f}s on "
              f"{card}; prefill {pre_tok} tokens ({pre_bucket} "
              f"{'at exact length' if recurrent else 'bucketed'}) in "
              f"{pre_s * 1e3:.1f} ms = {pre_tok / pre_s:.0f} tok/s; decode "
              f"{dec_tok} tokens in {len(dec)} steps, {dec_s * 1e3:.1f} ms "
              f"= {dec_tok / dec_s:.1f} tok/s; launches {counts}",
              flush=True)

        # the first n_cpu prefills against the CPU's plain forward
        t0 = time.perf_counter()
        cpu_tree = nn.to_device(tree, "cpu") if n_cpu else None
        d_cpu = []
        for j in range(n_cpu):
            L = prompts[j]
            bucket = _bucket_len(L, LM_MAX_SEQ)
            toks = torch.zeros((1, bucket), dtype=torch.long)
            toks[0, :L] = torch.tensor(reqs[j].prompt)
            check(torch.equal(pre[j][4]["tokens"].cpu(), toks),
                  f"{label}: prefill {j} saw other tokens")
            cache = nn.unbox(lm.cache_init(cfg, 1, LM_MAX_SEQ))
            batch = {"tokens": toks}
            if bucket != L:
                batch["length"] = torch.tensor([L], dtype=torch.int32)
            ref, _ = lm.forward_prefill(cpu_tree, batch, cfg, cache)
            ref = ref[0, -1].float()
            got = pre[j][2][0].cpu()
            d = float((got - ref).abs().max())
            top_ref, top_got = int(ref.argmax()), int(got.argmax())
            margin = float(ref[top_ref] - ref[top_got])
            print(f"[lm] {label}: prefill L={L} card vs CPU plain: "
                  f"max|dlogit|={d:.4g} top1_equal={top_ref == top_got} "
                  f"(CPU margin over the card's top {margin:.4g})",
                  flush=True)
            check(d <= LM_LOGIT_BOUND, f"{label}: card logits off the CPU's "
                  f"by {d:.4g} at L={L}")
            check(top_ref == top_got or margin <= 2 * LM_LOGIT_BOUND,
                  f"{label}: top-1 differs from the CPU's at margin "
                  f"{margin:.4g}")
            d_cpu.append(d)
        del cpu_tree
        if n_cpu:
            print(f"[lm] {label}: CPU plain forwards "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)

        # the logits and greedy tokens against the plain versions
        substituted = ["flash_attention"] + ([linear] if linear else [])
        with RouteRecorder() as route_p:
            rec_plain, plain_reqs = substituted_run(
                make, requests, kernels, plain_versions(substituted),
                substituted, label, snapshot=witnessed)
        pre_d, dec_d, n_tok, margins, dec_slots = compare_runs(
            rec_plain.calls, rec.calls)
        same = sum(a == b for r, pr in zip(reqs, plain_reqs)
                   for a, b in zip(r.tokens_out, pr.tokens_out))
        streams_equal = all(r.tokens_out == pr.tokens_out
                            for r, pr in zip(reqs, plain_reqs))
        std = float(torch.stack([c[2][0] for c in pre]).std())
        print(f"[lm] {label}: served tokens vs the plain "
              f"{' and '.join(substituted)} on the card: streams_equal="
              f"{streams_equal}, {same} of {len(reqs) * new} tokens equal; "
              f"{n_tok} compared before any decode step parted; prefill "
              f"max|dlogit| by prompt "
              f"{dict(zip(prompts, (round(d, 4) for d in pre_d)))}, "
              f"decode {dec_d:.4g} (logit std {std:.3f}); margins where "
              f"parted {margins}", flush=True)
        dec_bound = LM_DECODE_BOUNDS.get(label, LM_LOGIT_BOUND)
        held = dict(prefill=pre_d, decode=dec_d, decode_slots=dec_slots,
                    margins=margins, streams_equal=streams_equal)
        routing = rec_replay = None
        if cfg.moe is not None:
            routing, rec_replay = moe_routing(
                make, requests, kernels, cfg, label, rec, rec_plain, route_k,
                route_p, n_fwd, plain_reqs, snapshot=witnessed)
            if (max(pre_d) > LM_LOGIT_BOUND
                    or decode_over(dec_bound, dec_slots, prompts)
                    or any(m > 2 * LM_LOGIT_BOUND for m in margins)):
                # a routing pick turned by a rounding: the witness, the
                # kernel run on the plain run's picks, must hold the bounds
                held = routing["replayed"]
                print(f"[lm] {label}: off the plain run past the bounds; "
                      f"held on the plain run's routing replayed "
                      f"(witness)", flush=True)
        check(max(held["prefill"]) <= LM_LOGIT_BOUND
              and not decode_over(dec_bound, held["decode_slots"], prompts),
              f"{label}: kernel run off the plain run by "
              f"{max(held['prefill']):.4g} (prefill), decode by slot "
              f"{held['decode_slots']} (bound {dec_bound})")
        check(all(m <= 2 * LM_LOGIT_BOUND for m in held["margins"]),
              f"{label}: a token parted at margin "
              f"{max(held['margins'], default=0)}")
        check(held["streams_equal"] or held["margins"], f"{label}: streams "
              "differ though no compared step parted")

        bucketed = carry = None
        if recurrent:
            check(not eng._bucket_prefill and all(
                c[4]["tokens"].shape[1] == L and "length" not in c[4]
                for c, L in zip(pre, prompts)),
                f"{label}: a recurrent stack must prefill at exact length")
            carry = state_carry_witness(tree, cfg, reqs, label,
                                        per_row=linear is not None)
        elif mode == "dense":
            bucketed = bucketed_against_unpadded(tree, cfg, reqs, label)
        prof = profile_lm(make, requests, label)
        plain_linear = witnesses = None
        if linear:
            plain_linear = compare_plain_linear(make, requests, kernels,
                                                linear, label, rec, reqs,
                                                profiled=mode == "int8")
        if mode == "int8":
            check(prof is None or prof["f64_gemm_ms"] == 0.0,
                  f"{label}: the profile still shows a float64 GEMM")
        if witnessed:
            # an MoE stack is witnessed on the plain run's routing: the
            # kernel run that replayed it, and every pair of runs below
            # making one routing
            witnesses = decode_witnesses(
                make, requests, kernels, substituted, cfg, prompts, label,
                dec_bound, rec_replay or rec, rec_plain,
                route=route_p if cfg.moe is not None else None)
        del rec_plain
        extra = LM_EXTRA_CHECKS.get(label)
        mrope = kv_int8 = None
        if extra == "mrope":
            mrope = mrope_check(kernels, tree, cfg, label)
        elif extra == "int8_kv":
            kv_int8 = int8_kv_check(kernels, tree, cfg, reqs, label)
        peak = max(seen_peak, torch.cuda.max_memory_allocated())
        print(f"[lm] {label}: peak device memory {gib(peak)} (init "
              f"{gib(init_peak)}) of "
              f"{gib(torch.cuda.get_device_properties(0).total_memory)}; "
              f"the mode's checks took {time.perf_counter() - t_mode:.1f}s",
              flush=True)
        results[label] = dict(
            counts=counts, forwards=n_fwd, wall_s=wall,
            prefill_tok_s=pre_tok / pre_s, prefill_ms=pre_s * 1e3,
            decode_tok_s=dec_tok / dec_s, decode_ms=dec_s * 1e3,
            decode_steps=len(dec), cpu_max_dlogit=d_cpu,
            plain=dict(kernels=substituted, streams_equal=streams_equal,
                       tokens_equal=same, prefill_max_dlogit=pre_d,
                       decode_max_dlogit=dec_d, decode_bound=dec_bound,
                       logit_std=std, margins=margins),
            routing=routing, bucketed_vs_unpadded=bucketed,
            state_carry=carry, profile=prof,
            plain_linear=plain_linear, decode_witnesses=witnesses,
            mrope_positions=mrope, int8_kv_cache=kv_int8,
            peak_bytes=peak, init_peak_bytes=init_peak,
            compile_peak_bytes=compile_peak if linear else None)
        del eng, rec, tree, make, route_k, route_p, rec_replay
        torch.cuda.empty_cache()
    return results


def check_card_compile(params, tree, cfg, mode, label):
    """One stacked leaf (and in an MoE stack the first two experts of one
    expert leaf) compiled on the card: the same bytes as the CPU's
    compile.  A function of its own, so that no reference to the f32
    tree outlives the check."""
    from repro_torch import nn
    from repro_torch.core.compiled_linear import _compile_leaf
    block, ctree = params["template"][0], tree["template"][0]
    attn = ("kv_down" if cfg.mla else
            "in_proj" if "in_proj" in block["mixer"] else "k")
    leaves = [(attn, block["mixer"][attn], ctree["mixer"][attn], ...)]
    if cfg.moe is not None:
        j = next(j for j, b in enumerate(params["template"])
                 if "experts" in b["ffn"])
        leaves.append(("expert down",
                       params["template"][j]["ffn"]["experts"]["down"],
                       tree["template"][j]["ffn"]["experts"]["down"],
                       (0, slice(0, 2))))
    for name, leaf, card_leaf, part in leaves:
        value = leaf.value[part].cpu()
        cpu_leaf = _compile_leaf(nn.Param(value, leaf.axes[-value.ndim:],
                                          leaf.kind), mode, 0.8)
        for key, p in cpu_leaf.items():
            check(torch.equal(card_leaf[key][part].cpu(), p.value),
                  f"{label}: the card's compiled {name}[{key}] differs "
                  "from the CPU's")


def moe_routing(make, requests, kernels, cfg, label, rec, rec_plain,
                route_k, route_p, n_fwd, plain_reqs, snapshot=False):
    """An MoE path's routing: the share of (layer, token, choice) picks
    equal between the kernel run and the plain-version run, and the
    witness of where a logit spread past the bounds comes from: the
    kernel run again with the plain run's picks replayed
    (``RouteRecorder(replay=)``) against the plain run.  Returns the
    summary and that run's recorder (with ``snapshot``, holding its first
    decode step's batch and cache)."""
    n_moe = sum(bool(sig["moe"]) for sig in cfg.layer_sigs())
    check(len(route_k.picks) == len(route_p.picks) == n_fwd * n_moe,
          f"{label}: {len(route_k.picks)} routed layer calls in {n_fwd} "
          f"forwards, want {n_fwd * n_moe}")
    n_picks, share = routing_agreement(
        rec.calls, rec_plain.calls, route_k, route_p, n_moe)
    replay = RouteRecorder(replay=route_p)
    rec_replay, replay_reqs = substituted_run(make, requests, kernels,
                                              replay, [], label,
                                              snapshot=snapshot)
    check(all(torch.equal(a, b) for a, b in zip(replay.picks,
                                                 route_p.picks)),
          f"{label}: the replayed run made other picks")
    r_pre, r_dec, r_tok, r_margins, r_slots = compare_runs(rec_plain.calls,
                                                  rec_replay.calls)
    r_streams = all(r.tokens_out == pr.tokens_out
                    for r, pr in zip(replay_reqs, plain_reqs))
    kept = [float(k.float().mean()) for k in route_k.keeps]
    print(f"[lm] {label}: routing, kernel run vs the plain run: "
          f"{100 * share:.3f}% of {n_picks} (layer, token, choice) picks "
          f"equal; "
          f"kept picks per layer call {min(kept):.4f}-{max(kept):.4f}; "
          f"the kernel run on the plain run's picks vs the plain run: "
          f"prefill max|dlogit| {[round(d, 4) for d in r_pre]}, decode "
          f"{r_dec:.4g} over {r_tok} tokens, margins where parted "
          f"{r_margins}, streams_equal={r_streams}", flush=True)
    return dict(picks=n_picks, equal_share=share,
                kept_min=min(kept), kept_max=max(kept),
                replayed=dict(prefill=r_pre, decode=r_dec, decode_slots=r_slots,
                              tokens=r_tok, margins=r_margins,
                              streams_equal=r_streams)
                ), rec_replay


def substituted_run(make, requests, kernels, subs, names, label,
                    slots=LM_SLOTS, snapshot=False):
    """One engine run of ``requests()`` inside the substitution ``subs``
    (a context manager), checking that none of the kernels ``names`` it
    replaces launched.  Returns (recorder, requests)."""
    for name in names:
        kernels[name].launches = 0
    eng = make(slots)
    with subs, LMRecorder(eng, snapshot) as rec:
        out = eng.run(requests())
    check(all(kernels[name].launches == 0 for name in names),
          f"{label}: the substituted run launched {names}")
    return rec, out


def compare_plain_linear(make, requests, kernels, linear, label, rec, reqs,
                         profiled):
    """The run again with only the linears' kernel replaced by its plain
    version (the float64 product and its casts): the int32 sums are the
    same, so every logit and token must be too.  With ``profiled``, that
    run's profile: the path as it ran before the kernel took it."""
    rec_plain, plain_reqs = substituted_run(
        make, requests, kernels, plain_versions([linear]), [linear], label)
    prof = None
    if profiled:
        with plain_versions([linear]):
            prof = profile_lm(make, requests,
                              f"{label} with the plain {linear}")
    pre_d, dec_d, n_tok, _, _ = compare_runs(rec_plain.calls, rec.calls)
    streams_equal = all(r.tokens_out == pr.tokens_out
                        for r, pr in zip(reqs, plain_reqs))
    print(f"[lm] {label}: vs the plain {linear} on the card: "
          f"streams_equal={streams_equal}; max|dlogit| prefill "
          f"{max(pre_d):.4g}, decode {dec_d:.4g} over {n_tok} tokens",
          flush=True)
    check(streams_equal and max(pre_d + [dec_d]) == 0.0,
          f"{label}: the {linear} kernel's run differs from the plain "
          f"product's by {max(pre_d + [dec_d]):.4g}")
    return dict(streams_equal=streams_equal, prefill_max_dlogit=max(pre_d),
                decode_max_dlogit=dec_d, profile=prof)


def first_decode_rows(calls_a, calls_b):
    """max |dlogit| of each active row at the first decode step, whether
    or not a token parted before it."""
    a, b = (next(c for c in calls if c[0] == "decode")
            for calls in (calls_a, calls_b))
    return [float((a[2][r] - b[2][r]).abs().max()) for r in a[1]]


def decode_witnesses(make, requests, kernels, substituted, cfg, prompts,
                     label, bound, kern, plain, route=None):
    """Where the decode spread of an ``LM_DECODE_BOUNDS`` path comes from,
    on the card, each reading beside the kernel-vs-plain one (``kern``
    and ``plain``: the two runs' recorders, with their snapshots):

    - the first decode step with the plain versions, on the kernel run's
      cache and tokens, equals the kernel run's step (the step itself is
      exact; the spread comes in with the caches);
    - the kernel run's cache with only the pad rows of the plain run's
      (positions L to the bucket of each slot's prompt) swapped in: how
      far that alone moves the step;
    - one slot (each request alone; no slot attends to another's
      length): kernel against plain, held to ``LM_LOGIT_BOUND``;
    - a per-row activation scale in both runs (slots no longer share a
      scale);
    - a third attention, one SDPA call, against each run;
    - a planted fault, the attention losing one 64-key tile, which the
      bound must fail.

    In an MoE stack (``route``: the plain run's routing) ``kern`` is the
    kernel run on the plain run's picks, and each pair of runs makes one
    routing: the kernel side replays the picks its plain partner made
    (the single decode steps, the picks of the plain run's step; SDPA
    and the lost tile, the plain run's)."""
    from types import SimpleNamespace

    from repro_torch.models import lm
    from repro_torch.serving.engine import _bucket_len
    subs = lambda **attn: plain_versions(substituted, **attn)
    routed = (lambda replay=None: RouteRecorder(replay=replay)) if route \
        else (lambda replay=None: contextlib.nullcontext())
    healthy = first_decode_rows(plain.calls, kern.calls)
    (batch, cache_k), (_, cache_p) = kern.snapshot, plain.snapshot
    step = next(i for i, c in enumerate(kern.calls) if c[0] == "decode")
    first_k = kern.calls[step][2]
    n_moe = sum(bool(sig["moe"]) for sig in cfg.layer_sigs())
    step_picks = SimpleNamespace(
        picks=route.picks[step * n_moe:(step + 1) * n_moe] if route else [])
    with subs(), routed(step_picks):
        teacher, _ = lm.forward_decode(kern.engine.params, batch, cfg,
                                       _clone_tree(cache_k))
    teacher = float((teacher[:, -1].float() - first_k).abs().max())
    for path, leaf_k in _kv_leaves(cache_k):
        leaf_p = dict(_kv_leaves(cache_p))[path]
        for slot, L in enumerate(prompts):
            end = _bucket_len(L, LM_MAX_SEQ)
            leaf_k[:, slot, L:end] = leaf_p[:, slot, L:end]
    with routed(step_picks):
        swapped, _ = lm.forward_decode(kern.engine.params, batch, cfg,
                                       cache_k)
    swapped = float((swapped[:, -1].float() - first_k).abs().max())
    del kern.snapshot, plain.snapshot, cache_k, cache_p

    def pair(slots=LM_SLOTS):
        """A plain run and a kernel run on its routing."""
        rp = routed()
        p, _ = substituted_run(make, requests, kernels, _entered(subs(), rp),
                               substituted, label, slots=slots)
        k, _ = substituted_run(make, requests, kernels,
                               routed(rp if route else None), [], label,
                               slots=slots)
        return p, k
    one_p, one_k = pair(slots=1)
    one_pre, one_dec, _, _, _ = compare_runs(one_p.calls, one_k.calls)
    with per_row_scales():
        row_p, row_k = pair()
    sdpa, _ = substituted_run(make, requests, kernels,
                              _entered(subs(attention=sdpa_attention),
                                       routed(route)), substituted, label)
    lost, _ = substituted_run(make, requests, kernels,
                              _entered(subs(attention=lost_tile_attention),
                                       routed(route)), substituted, label)
    lost_pre, _, _, _, _ = compare_runs(plain.calls, lost.calls)
    out = dict(
        kernel_vs_plain=healthy, teacher_forced=teacher,
        pad_rows_swapped=swapped,
        one_slot=dict(prefill=max(one_pre), decode=one_dec),
        per_row_scale=first_decode_rows(row_p.calls, row_k.calls),
        sdpa_vs_kernel=first_decode_rows(kern.calls, sdpa.calls),
        sdpa_vs_plain=first_decode_rows(plain.calls, sdpa.calls),
        lost_tile=dict(prefill=max(lost_pre),
                       decode=first_decode_rows(plain.calls, lost.calls)))
    r4 = lambda xs: [round(x, 4) for x in xs]
    print(f"[lm] {label}: decode witnesses, max|dlogit| of the first "
          f"decode step by slot (prompts {list(prompts)}): kernel vs plain "
          f"{r4(healthy)}; plain step on the kernel's cache {teacher:.4g}; "
          f"the plain run's pad rows swapped into the kernel's cache "
          f"{swapped:.4g}; one slot: prefill {max(one_pre):.4g}, decode "
          f"{one_dec:.4g}; per-row activation scale "
          f"{r4(out['per_row_scale'])}; SDPA vs kernel "
          f"{r4(out['sdpa_vs_kernel'])}, vs plain "
          f"{r4(out['sdpa_vs_plain'])}; planted lost tile: prefill "
          f"{max(lost_pre):.4g}, decode {r4(out['lost_tile']['decode'])}; "
          f"bound {bound}", flush=True)
    check(teacher == 0.0, f"{label}: the plain decode step on the kernel's "
          f"cache differs by {teacher:.4g}")
    check(max(one_pre + [one_dec]) <= LM_LOGIT_BOUND,
          f"{label}: one slot, kernel off plain by "
          f"{max(one_pre + [one_dec]):.4g}")
    check(decode_over(bound, dict(enumerate(out["lost_tile"]["decode"])),
                      prompts) and max(lost_pre) > LM_LOGIT_BOUND,
          f"{label}: the planted lost tile passes the bounds: {out}")
    return out


@contextlib.contextmanager
def _entered(*managers):
    """The context managers entered together, in order."""
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def _clone_tree(t):
    if isinstance(t, dict):
        return {k: _clone_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_clone_tree(v) for v in t]
    return t.clone() if isinstance(t, torch.Tensor) else t


def _kv_leaves(cache, path=""):
    """(path, leaf) of every attention cache leaf (``k``/``v`` and an
    int8 cache's scales ``k_s``/``v_s``; MLA's latent ``c_kv`` and
    ``k_rope``), as (layers, slots, S, ...): a prefix or suffix layer's
    (slots, S, ...) leaf gets a view with a leading layer axis of 1."""
    if isinstance(cache, dict):
        for k, v in cache.items():
            yield from _kv_leaves(v, f"{path}/{k}")
    elif isinstance(cache, list):
        for i, v in enumerate(cache):
            yield from _kv_leaves(v, f"{path}[{i}]")
    elif isinstance(cache, torch.Tensor) and path.rsplit("/", 1)[-1] in (
            "k", "v", "k_s", "v_s", "c_kv", "k_rope"):
        yield path, cache if path.startswith("/template") else cache[None]


# ---------------------------------------------------------------------------
# Phase 4a: the encoder-decoder, Whisper-small, through lm.forward_prefill
# and lm.forward_decode (no engine takes frames, in either package)
# ---------------------------------------------------------------------------

WHISPER = "whisper_small"
WHISPER_MODES = ("dense", "int8", "sparse_cfmm")
# (n_enc_layers, n_layers, d_model, n_heads, n_kv_heads, head_dim, d_ff,
# vocab, dec_len) as published (configs/whisper_small.py names the source)
PUBLISHED_ENC_DEC = {WHISPER: (12, 12, 768, 12, 12, 64, 3072, 51865, 448)}
# 4 clips of 30 s (1500 post-conv frames each), a 4-token decoder prompt
# each, 32 greedy new tokens: one prefill and 31 decode steps
WHISPER_CLIPS, WHISPER_FRAMES = 4, 1500
WHISPER_PROMPT, WHISPER_NEW = 4, 32
# check (a) against the CPU: clip 0 alone, a prefill and 3 decode steps
# (the CPU's plain sparse product unpacks every bitmap at every call:
# 48.2 s for 32 tokens in sparse_cfmm, H100 80GB HBM3 host, 700.00 W)
WHISPER_CPU_NEW = 4
# the training check: batch 2, 1500 frames, the decoder's 448 tokens
WHISPER_TRAIN_BATCH = 2
# tests/test_decode.py's protocol: decode against the full forward within
# 0.06 of max |logit|, greedy tokens equal where the full forward's top
# token leads by more than 0.05 of it
WHISPER_DECODE_REL, WHISPER_DECODE_MARGIN = 0.06, 0.05


def whisper_inputs(cfg, clips, frames, tokens, seed=0):
    """Seeded post-conv frames (clips, frames, d_model) bf16 and decoder
    tokens (clips, tokens) in [1, vocab), on the CPU."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(clips, frames, cfg.d_model).astype(
        np.float32)).to(torch.bfloat16)
    return x, torch.from_numpy(rng.randint(1, cfg.vocab, (clips, tokens)))


@torch.no_grad()
def whisper_generate(tree, cfg, frames, prompt, new, forced=None):
    """Greedy decoding on ``frames``' device: ``lm.forward_prefill`` over
    the frames and the prompt, then ``new - 1`` ``lm.forward_decode``
    steps against a cache of ``dec_len`` tokens.  ``forced`` (clips, new)
    feeds those tokens instead of the run's own picks, so that two runs
    see the same inputs at every call.  Returns the last-position logits
    of every call (f32), the tokens picked (clips, new) on the CPU, each
    call's host time with the device synchronised, and the cache."""
    from repro_torch import nn
    from repro_torch.models import lm
    dev = frames.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cache = nn.unbox(lm.cache_init(cfg, frames.shape[0], cfg.dec_len,
                                   S_enc=frames.shape[1], device=dev))
    batch, step = {"frames": frames, "tokens": prompt}, lm.forward_prefill
    logits, picks, times = [], [], []
    for i in range(new):
        sync()
        t0 = time.perf_counter()
        out, cache = step(tree, batch, cfg, cache)
        sync()
        times.append(time.perf_counter() - t0)
        logits.append(out[:, -1].float())
        own = logits[-1].argmax(-1).cpu()
        picks.append(own if forced is None else forced[:, i])
        batch, step = {"token": picks[-1][:, None].to(dev)}, lm.forward_decode
    return dict(logits=logits, tokens=torch.stack(picks, 1), times=times,
                cache=cache)


def whisper_launches(cfg, steps, linear) -> dict:
    """Launches of one prefill and ``steps`` decode steps: flash for every
    encoder layer and each decoder layer's self and cross-attention in the
    prefill, the cross-attention alone in a step (its self-attention reads
    the cache in plain PyTorch); the linears: 7 per encoder layer, 11 per
    decoder layer in the prefill (the cross k/v projections there), 9 in a
    step, and the untied head once per call."""
    want = {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers
            + cfg.n_layers * steps}
    if linear:
        want[linear] = (7 * cfg.n_enc_layers + 11 * cfg.n_layers + 1
                        + (9 * cfg.n_layers + 1) * steps)
    return want


def call_dlogits(run_a, run_b) -> list:
    """max |dlogit| per call of two ``whisper_generate`` runs."""
    return [float((a.cpu() - b.cpu()).abs().max())
            for a, b in zip(run_a["logits"], run_b["logits"])]


def whisper_train_check(kernels, params, cfg, label):
    """Check (d): one training step at full width in ``dense`` (batch 2,
    1500 frames, 448 decoder tokens): the flash launches of a step (two
    forwards per attention layer under the remat, one backward), its
    gradients against the same step with the plain attention
    (per-leaf relative L2 within ``TRAIN_GRAD_BOUND``), SDPA and a lost KV
    tile as witnesses, and one AdamW step's time on a copy of the
    weights."""
    from repro_torch import nn
    from repro_torch.training import optimizer
    from repro_torch.training.train_step import make_train_step, \
        value_and_grad
    dev = torch.device("cuda")
    frames, toks = whisper_inputs(cfg, WHISPER_TRAIN_BATCH, WHISPER_FRAMES,
                                  cfg.dec_len, seed=1)
    batch = {"frames": frames.to(dev), "tokens": toks.to(dev),
             "labels": toks.to(dev)}
    p = nn.unbox(params)
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    zero_launches(kernels)
    loss_k, _, g_k = value_and_grad(p, batch, cfg)
    torch.cuda.synchronize()
    launches = (kernels["flash_attention"].launches,
                kernels["flash_attention_bwd"].launches)
    check(launches == (2 * n_attn if cfg.remat else n_attn, n_attn),
          f"{label}: flash launches forward / backward {launches} in a "
          f"training step, want {2 * n_attn} / {n_attn}")
    with plain_versions(["flash_attention"]):
        loss_p, _, g_p = value_and_grad(p, batch, cfg)
    rel = grad_rel_l2(g_k, g_p)
    del g_k
    with plain_versions(["flash_attention"], attention=sdpa_attention):
        sdpa = max(grad_rel_l2(value_and_grad(p, batch, cfg)[2],
                               g_p).values())
    with plain_versions(["flash_attention"], attention=lost_tile_attention):
        lost = max(grad_rel_l2(value_and_grad(p, batch, cfg)[2],
                               g_p).values())
    del g_p
    worst = max(rel, key=rel.get)
    copy = nn.tree_map(lambda t: t.clone(), p)
    opt_state = optimizer.init(copy)
    step = make_train_step(cfg, optimizer.OptConfig(lr=1e-4))
    copy, opt_state, _ = step(copy, opt_state, batch)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    copy, opt_state, m = step(copy, opt_state, batch)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del copy, opt_state
    n_tok = WHISPER_TRAIN_BATCH * (WHISPER_FRAMES + cfg.dec_len)
    print(f"[lm] {label} train step (batch {WHISPER_TRAIN_BATCH}, "
          f"{WHISPER_FRAMES} frames, {cfg.dec_len} tokens): {step_ms:.1f} "
          f"ms, {n_tok / step_ms * 1e3:.0f} frames + tokens/s, peak "
          f"{gib(peak)}; loss {loss:.5f}; flash launches forward / "
          f"backward {launches}; gradients vs the plain attention: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f}, per-leaf relative "
          f"L2 max {rel[worst]:.3g} ({worst}), median "
          f"{float(np.median(list(rel.values()))):.3g}, bound "
          f"{TRAIN_GRAD_BOUND}; witnesses: SDPA vs plain {sdpa:.3g}, a "
          f"planted lost KV tile {lost:.3g}", flush=True)
    check(np.isfinite(loss), f"{label}: non-finite training loss")
    check(rel[worst] <= TRAIN_GRAD_BOUND,
          f"{label}: gradient {worst} off the plain attention's by "
          f"{rel[worst]:.3g}")
    check(lost > TRAIN_GRAD_BOUND, f"{label}: the planted lost tile reads "
          f"{lost:.3g}, within the bound")
    return dict(step_ms=step_ms, loss=loss, peak_bytes=peak,
                launches=dict(zip(("flash_attention", "flash_attention_bwd"),
                                  launches)),
                loss_kernels=float(loss_k), loss_plain=float(loss_p),
                max_rel_l2=rel[worst], leaf=worst,
                median_rel_l2=float(np.median(list(rel.values()))),
                sdpa_vs_plain=sdpa, planted_lost_tile=lost)


def serve_whisper(kernels, card):
    """Whisper-small at its published widths and depth (12 + 12 layers, d
    768) on the card, seeded random weights initialised there: check (d),
    one training step in ``dense``; then in each of ``WHISPER_MODES`` 4
    clips of 1500 frames, 4-token prompts and 32 greedy tokens
    (``whisper_generate``), with the launch counts of the run
    (``whisper_launches``); (a) every call's logits within
    ``LM_LOGIT_BOUND`` of the CPU's plain forward (clip 0 served alone on
    both, ``WHISPER_CPU_NEW`` tokens: a compiled mode's activation scale
    spans the batch) and of a card run with
    the path's kernels' plain versions substituted, and in a compiled
    mode equal to the bit to a run with only the linears' plain version
    (each on the kernel run's tokens); (b) the decode steps against
    ``forward_train`` of the same tokens (tests/test_decode.py's
    protocol); (c) the cross cache bf16 (12, 4, 1500, 12, 64) and equal to
    the prefill's projections of the encoder's output cast to bf16.
    Prints the encoder's ms per clip, the prefill's ms, decode tokens/s,
    the peak device memory, the ``int8`` compile's peak, one profiled
    run's device busy and idle share, and launches per forward."""
    from repro_torch import nn
    from repro_torch.core.compiled_linear import _compile_leaf, \
        ensure_compiled
    from repro_torch.launch.serve import build_cfg
    from repro_torch.models import lm
    from torch.profiler import ProfilerActivity, profile
    cfg = build_cfg(WHISPER, "full")
    check((cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab, cfg.dec_len)
          == PUBLISHED_ENC_DEC[WHISPER], f"{WHISPER}: not the published "
          "widths and depth")
    dev = torch.device("cuda")
    total = gib(torch.cuda.get_device_properties(0).total_memory)
    frames, prompt = whisper_inputs(cfg, WHISPER_CLIPS, WHISPER_FRAMES,
                                    WHISPER_PROMPT)
    frames_d, prompt_d = frames.to(dev), prompt.to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.value.numel() for p in nn.tree_leaves(
        params, is_leaf=lambda x: isinstance(x, nn.Param)))
    init_peak = torch.cuda.max_memory_allocated()
    print(f"[lm] {WHISPER} full width: {n_params / 1e6:.1f} M params, init "
          f"on the card {time.perf_counter() - t0:.1f}s; f32 tree "
          f"{gib(4 * n_params)}, peak during init {gib(init_peak)} of "
          f"{total}", flush=True)
    results = {f"{WHISPER}/train": whisper_train_check(
        kernels, params, cfg, f"{WHISPER}/dense")}
    for mode in WHISPER_MODES:
        label = f"{WHISPER}/{mode}"
        linear = LM_LINEAR.get(mode)
        t_mode = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ctree = ensure_compiled(params, mode, 0.8)
        torch.cuda.synchronize()
        compile_peak = torch.cuda.max_memory_allocated()
        tree = nn.unbox(ctree)
        if linear:
            print(f"[lm] {label}: compile peak {gib(compile_peak)} (the f32 "
                  f"tree and the compiled one) of {total}", flush=True)
            # one stacked leaf, the cross-attention's k, compiled on the
            # CPU: the card's bytes
            leaf = params["dec_blocks"]["xattn"]["k"]
            cpu_leaf = _compile_leaf(nn.Param(leaf.value[0].cpu(),
                                              leaf.axes[1:], leaf.kind),
                                     mode, 0.8)
            for key, p in cpu_leaf.items():
                check(torch.equal(tree["dec_blocks"]["xattn"]["k"][key][0]
                                  .cpu(), p.value),
                      f"{label}: the card's compiled xattn k[{key}] "
                      "differs from the CPU's")
        whisper_generate(tree, cfg, frames_d, prompt_d, 2)     # warm-up
        zero_launches(kernels)
        t0 = time.perf_counter()
        run = whisper_generate(tree, cfg, frames_d, prompt_d, WHISPER_NEW)
        wall = time.perf_counter() - t0
        counts = {name: kern.launches for name, kern in kernels.items()}
        want = whisper_launches(cfg, WHISPER_NEW - 1, linear)
        for name, got in counts.items():
            check(got == want.get(name, 0), f"{label}: {got} {name} "
                  f"launches in one prefill and {WHISPER_NEW - 1} steps, "
                  f"want {want.get(name, 0)}")
        check(all(bool(torch.isfinite(l).all()) for l in run["logits"])
              and bool(((run["tokens"] >= 0)
                        & (run["tokens"] < cfg.vocab)).all()),
              f"{label}: non-finite logits or tokens out of the vocab")
        steps = WHISPER_NEW - 1
        pre_ms = run["times"][0] * 1e3
        dec_s = sum(run["times"][1:])
        with torch.no_grad():
            enc_ms = event_ms(lambda: lm._encode(tree, frames_d, cfg),
                              reps=3) / WHISPER_CLIPS
        pre = whisper_launches(cfg, 0, linear)
        per_fwd = {n: (pre[n], (want[n] - pre[n]) // steps) for n in want}
        print(f"[lm] {label}: {WHISPER_CLIPS} clips x {WHISPER_FRAMES} "
              f"frames, prompts of {WHISPER_PROMPT}, {WHISPER_NEW} new "
              f"tokens each in {wall:.2f}s on {card}; encoder "
              f"{enc_ms:.2f} ms per clip; prefill {pre_ms:.1f} ms; decode "
              f"{WHISPER_CLIPS * steps} tokens in {steps} steps, "
              f"{dec_s * 1e3:.1f} ms = {WHISPER_CLIPS * steps / dec_s:.1f} "
              f"tok/s; launches {counts}, per prefill / per step "
              f"{per_fwd}", flush=True)

        # (c) the cross cache: bf16, (layers, clips, frames, KVH, D), the
        # prefill's projections of the encoder's output cast to bf16
        cross = run["cache"]["cross"]
        shape = (cfg.n_layers, WHISPER_CLIPS, WHISPER_FRAMES, cfg.n_kv_heads,
                 cfg.head_dim)
        check(all(cross[k].dtype == torch.bfloat16
                  and tuple(cross[k].shape) == shape for k in ("k", "v")),
              f"{label}: cross cache {cross['k'].dtype} "
              f"{tuple(cross['k'].shape)}, want bf16 {shape}")
        with torch.no_grad():
            enc = lm._encode(tree, frames_d, cfg)
            for l, p in enumerate(nn.unstack(tree["dec_blocks"],
                                             cfg.n_layers)):
                k, v = lm._cross_kv(p, enc, cfg)
                check(torch.equal(cross["k"][l], k.to(torch.bfloat16))
                      and torch.equal(cross["v"][l], v.to(torch.bfloat16)),
                      f"{label}: cross cache layer {l} is not the "
                      "prefill's projections in bf16")
        del enc

        # (a) one clip on the card against the CPU's plain forward of it
        # (the batch's shared activation scale makes a clip's logits
        # depend on its batch: the same batch on both sides), then the
        # batch against the plain versions on the card, and (compiled)
        # against the linears' plain version alone
        t0 = time.perf_counter()
        one = whisper_generate(tree, cfg, frames_d[:1], prompt_d[:1],
                               WHISPER_CPU_NEW)
        cpu = whisper_generate(nn.to_device(tree, "cpu"), cfg, frames[:1],
                               prompt[:1], WHISPER_CPU_NEW,
                               forced=one["tokens"])
        d_cpu = call_dlogits(cpu, one)
        cpu_s = time.perf_counter() - t0
        del cpu, one
        substituted = ["flash_attention"] + ([linear] if linear else [])
        zero_launches(kernels)
        with plain_versions(substituted):
            plain = whisper_generate(tree, cfg, frames_d, prompt_d,
                                     WHISPER_NEW, forced=run["tokens"])
        check(all(kernels[n].launches == 0 for n in substituted),
              f"{label}: the substituted run launched {substituted}")
        d_plain = call_dlogits(plain, run)
        del plain
        d_linear = None
        if linear:
            with plain_versions([linear]):
                lin = whisper_generate(tree, cfg, frames_d, prompt_d,
                                       WHISPER_NEW, forced=run["tokens"])
            d_linear = max(call_dlogits(lin, run))
            del lin
        std = float(run["logits"][0].std())
        print(f"[lm] {label}: max|dlogit| prefill / decode steps: card vs "
              f"CPU plain, clip 0 alone, {WHISPER_CPU_NEW} tokens, "
              f"{d_cpu[0]:.4g} / "
              f"{max(d_cpu[1:]):.4g} ({cpu_s:.1f}s); the batch vs the "
              f"plain {' and '.join(substituted)} on "
              f"the card {d_plain[0]:.4g} / {max(d_plain[1:]):.4g}; vs the "
              f"plain {linear} alone {d_linear}; logit std {std:.3f}; "
              f"bound {LM_LOGIT_BOUND}", flush=True)
        check(max(d_cpu) <= LM_LOGIT_BOUND, f"{label}: card logits off "
              f"the CPU's by {max(d_cpu):.4g}")
        check(max(d_plain) <= LM_LOGIT_BOUND, f"{label}: kernel run off "
              f"the plain run by {max(d_plain):.4g}")
        check(d_linear in (None, 0.0), f"{label}: the {linear} kernel's run "
              f"differs from the plain product's by {d_linear}")

        # (b) decode against the full forward of the same tokens
        with torch.no_grad():
            toks = torch.cat([prompt, run["tokens"][:, :-1]], 1).to(dev)
            full, _ = lm.forward_train(tree, {"frames": frames_d,
                                              "tokens": toks}, cfg)
        ref = full[:, WHISPER_PROMPT - 1:].float()
        dec = torch.stack(run["logits"], 1)
        del full
        scale = float(ref.abs().max())
        rel = float((dec - ref).abs().max()) / scale
        top2 = torch.topk(ref, 2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]) / scale
        parted = dec.argmax(-1) != ref.argmax(-1)
        real = int((parted & (margin > WHISPER_DECODE_MARGIN)).sum())
        print(f"[lm] {label}: decode vs forward_train of the same "
              f"{toks.shape[1]} tokens: max|dlogit| {rel * scale:.4g} = "
              f"{rel:.4g} of max|logit| (bound {WHISPER_DECODE_REL}); "
              f"greedy tokens differ at {int(parted.sum())} of "
              f"{parted.numel()} positions, {real} past the margin",
              flush=True)
        check(rel < WHISPER_DECODE_REL and real == 0, f"{label}: decode off "
              f"the full forward by {rel:.4g} of max|logit|, {real} tokens "
              "past the margin")

        # one profiled run: the card's busy and idle share
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            whisper_generate(tree, cfg, frames_d, prompt_d, WHISPER_NEW)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) * 1e3
        events = device_kernels(prof)
        busy = sum(ms for ms, _ in events.values())
        ours = sum(ms for key, (ms, _) in events.items()
                   if any(k in key for k in OUR_KERNELS))
        idle = 1 - busy / prof_ms if events else None
        print(f"[profile] {label}: wall {prof_ms:.1f} ms, device busy "
              f"{busy:.2f} ms, idle "
              f"{'not measured' if idle is None else f'{100 * idle:.1f}%'};"
              f" the port's kernels {ours:.2f} ms of it; device launches "
              f"{sum(n for _, n in events.values())}", flush=True)
        for key, (ms, n) in sorted(events.items(),
                                   key=lambda kv: -kv[1][0])[:6]:
            print(f"[profile]   {ms:8.3f} ms x{n:5d}  {key[:110]}",
                  flush=True)
        peak = max(compile_peak, torch.cuda.max_memory_allocated())
        print(f"[lm] {label}: peak device memory {gib(peak)} (init "
              f"{gib(init_peak)}) of {total}; the mode's checks took "
              f"{time.perf_counter() - t_mode:.1f}s", flush=True)
        results[label] = dict(
            counts=counts, forwards=WHISPER_NEW, wall_s=wall,
            encoder_ms_per_clip=enc_ms, prefill_ms=pre_ms,
            decode_tok_s=WHISPER_CLIPS * steps / dec_s, decode_steps=steps,
            cpu_max_dlogit=max(d_cpu), plain_max_dlogit=max(d_plain),
            plain_linear_max_dlogit=d_linear, logit_std=std,
            decode_vs_full_rel=rel, profile=dict(
                wall_ms=prof_ms, busy_ms=busy, ours_ms=ours, idle=idle),
            peak_bytes=peak, init_peak_bytes=init_peak,
            compile_peak_bytes=compile_peak if linear else None)
        del run, tree, ctree
    del params
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 4b: training
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_BATCH = 512, 8
TRAIN_STEPS = 12             # SmolLM-360M's uninterrupted plain run
TRAIN_FAIL = 8               # the crash step; the checkpoint holds step 8
TRAIN_QAT_TO = 12            # QAT resumed from step 8: 4 steps
GEMMA_STEPS = 4
# the trainer warms up over 20 steps; at the JAX driver's default peak
# (3e-3) SmolLM-360M's loss rises past step 10, at 1.5e-3 it falls over
# the 12 steps (a scan on the card, 5e-4 to 3e-2)
TRAIN_LR = "1.5e-3"
# one step's gradients with the kernels against the same step with the
# plain attention substituted, per leaf: ||g - g_plain|| / ||g_plain||
TRAIN_GRAD_BOUND = 0.05


def train_args(arch, steps, *extra):
    return ["--arch", arch, "--preset", "full", "--seq", str(TRAIN_SEQ),
            "--batch", str(TRAIN_BATCH), "--steps", str(steps),
            "--lr", TRAIN_LR, "--log-every", "1", "--device", "cuda",
            *extra]


def train_launches(cfg) -> tuple:
    """(flash forward, flash backward) launches per training step: the
    template layers run their attention forward twice (once more when the
    remat recomputes them in the backward pass), the prefix and suffix
    layers once; one backward per attention layer."""
    from repro_torch.models import lm
    sigs = cfg.layer_sigs()
    pre, period, groups, _ = lm.group_layers(sigs)
    attn = [s["kind"] == "attn" for s in sigs]
    templ = sum(attn[pre:pre + period * groups])
    return (2 if cfg.remat else 1) * templ + sum(attn) - templ, sum(attn)


def train_run(kernels, label, argv, cfg, expect_exit=None):
    """One ``repro_torch.launch.train.main`` run on the card, launch
    counters zeroed just before it: per-step losses (exact floats), the
    median step time (steps after the run's first), tokens/s, the peak
    device memory, and the flash launches checked per step."""
    from repro_torch.launch import train
    hist = []
    zero_launches(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    code = None
    try:
        train.main(argv, on_step=lambda step, m, dt: hist.append(
            (step, m, dt)))
    except SystemExit as e:
        code = e.code
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(code == expect_exit, f"train {label}: exit {code}, want "
          f"{expect_exit}")
    check(hist and all(np.isfinite(m["loss"]) for _, m, _ in hist),
          f"train {label}: non-finite loss")
    counts = {n: k.launches for n, k in kernels.items() if k.launches}
    fwd, bwd = train_launches(cfg)
    n = len(hist)
    want = {"flash_attention": fwd * n, "flash_attention_bwd": bwd * n}
    check(counts == want, f"train {label}: launches {counts}, want {want} "
          f"over {n} steps")
    step_s = float(np.median([dt for _, _, dt in hist[1:]] or
                             [hist[0][2]]))
    res = dict(steps=[s for s, _, _ in hist],
               loss=[m["loss"] for _, m, _ in hist],
               grad_norm=[m["grad_norm"] for _, m, _ in hist],
               step_ms=1e3 * step_s,
               tok_s=TRAIN_BATCH * TRAIN_SEQ / step_s, wall_s=wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               counts=counts, flash_fwd_per_step=fwd,
               flash_bwd_per_step=bwd)
    print(f"[train] {label}: {n} steps, median step {res['step_ms']:.1f} ms "
          f"({res['tok_s']:.0f} train tok/s), loss {res['loss'][0]:.4f} -> "
          f"{res['loss'][-1]:.4f}, peak {res['peak_gib']:.2f} GiB, flash "
          f"launches per step {fwd} forward / {bwd} backward, wall "
          f"{wall:.1f}s", flush=True)
    return res


def profile_train_step(cfg, label):
    """Where one training step's device time goes (fresh seeded weights,
    one warm-up step first): the forward with its loss, the backward
    (which recomputes every template layer), and AdamW, each between CUDA
    events; the recompute's share measured as one more forward of the
    layer stack (the work the remat repeats); then the whole step under
    ``torch.profiler``: wall time, device busy time and idle share, and
    the flash kernels' device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import nn
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.models import lm
    from repro_torch.training import optimizer
    from repro_torch.training.train_step import make_train_step
    dev = torch.device("cuda")
    params = nn.unbox(lm.init(torch.Generator(device=dev).manual_seed(0),
                              cfg))
    opt_state = optimizer.init(params)
    opt_cfg = optimizer.OptConfig(lr=3e-3, warmup_steps=20,
                                  total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, opt_cfg)
    data = SyntheticDataset(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    params, opt_state, _ = step(params, opt_state, batch)     # warm-up
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = nn.tree_leaves(params)
    live = [t.detach().requires_grad_(True) for t in leaves]
    it = iter(live)
    p = nn.tree_map(lambda _: next(it), params)
    torch.cuda.synchronize()
    ev[0].record()
    logits, aux = lm.forward_train(p, batch, cfg)
    loss, _ = lm.loss_fn(logits, batch["labels"], aux)
    ev[1].record()
    grads = torch.autograd.grad(loss, live)
    ev[2].record()
    it = iter(grads)
    optimizer.apply_updates(params, nn.tree_map(lambda _: next(it), params),
                            opt_state, opt_cfg)
    ev[3].record()
    ev[3].synchronize()
    fwd_ms, bwd_ms, opt_ms = (ev[i].elapsed_time(ev[i + 1])
                              for i in range(3))
    del logits, loss, grads, live, p
    with torch.no_grad():
        x = lm._embed_tokens(params, batch["tokens"], cfg)
        pos = lm._positions(cfg, batch, TRAIN_BATCH, TRAIN_SEQ).to(dev)
        re_ms = event_ms(lambda: lm._run_stack(params, x, cfg,
                                               lm._grouping_info(cfg), pos),
                         reps=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_kernels(prof)
    busy_ms = sum(ms for ms, _ in events.values())
    flash_fwd = sum(ms for key, (ms, _) in events.items()
                    if "::flash_mma_kernel<" in key
                    or "::flash_kernel<" in key)
    flash_bwd = sum(ms for key, (ms, _) in events.items()
                    if "::flash_bwd_" in key)
    idle = 1 - busy_ms / wall_ms if events else None
    print(f"[train] {label} step breakdown: forward + loss {fwd_ms:.1f} ms, "
          f"backward {bwd_ms:.1f} ms (of which the recompute, one stack "
          f"forward, ~{re_ms:.1f} ms), AdamW {opt_ms:.1f} ms; profiled step "
          f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle "
          f"{'not measured' if idle is None else f'{100 * idle:.1f}%'}; "
          f"flash forward {flash_fwd:.1f} ms, flash backward "
          f"{flash_bwd:.1f} ms", flush=True)
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:6]
    for key, (ms, n) in top:
        print(f"[train]   {ms:8.3f} ms x{n:5d}  {key[:110]}", flush=True)
    return dict(forward_ms=fwd_ms, backward_ms=bwd_ms, recompute_ms=re_ms,
                adamw_ms=opt_ms, wall_ms=wall_ms, busy_ms=busy_ms,
                idle=idle, flash_fwd_ms=flash_fwd, flash_bwd_ms=flash_bwd)


def grad_rel_l2(g_a, g_b) -> dict:
    """leaf name -> ||g_a - g_b|| / ||g_b|| over two gradient trees."""
    from repro_torch import nn
    return {"/".join(map(str, path)): float(
        torch.linalg.vector_norm((a - b).float())
        / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))
        for (path, a), (_, b) in zip(nn.tree_flatten_with_path(g_a),
                                     nn.tree_flatten_with_path(g_b))}


def grads_against_plain(cfg, label):
    """One step's gradients (fresh seeded weights, batch 0) with the
    flash kernels against the same step with the plain attention
    substituted (``plain_versions``: autograd through
    ``flash_attention_plain``): per-leaf relative L2 within
    ``TRAIN_GRAD_BOUND``.  Two witnesses beside it: SDPA's autograd in
    place of the plain attention (a third implementation: the spread two
    correct bf16 attentions show) and a planted lost KV tile
    (``lost_tile_attention``), which must read above the bound."""
    from repro_torch import nn
    from repro_torch.data.pipeline import DataConfig, SyntheticDataset
    from repro_torch.models import lm
    from repro_torch.training.train_step import value_and_grad
    dev = torch.device("cuda")
    params = nn.unbox(lm.init(torch.Generator(device=dev).manual_seed(0),
                              cfg))
    data = SyntheticDataset(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(0).items()}
    loss_k, _, g_k = value_and_grad(params, batch, cfg)
    with plain_versions(["flash_attention"]):
        loss_p, _, g_p = value_and_grad(params, batch, cfg)
    rel = grad_rel_l2(g_k, g_p)
    del g_k
    with plain_versions(["flash_attention"], attention=sdpa_attention):
        sdpa = max(grad_rel_l2(value_and_grad(params, batch, cfg)[2],
                               g_p).values())
    with plain_versions(["flash_attention"], attention=lost_tile_attention):
        lost = max(grad_rel_l2(value_and_grad(params, batch, cfg)[2],
                               g_p).values())
    worst = max(rel, key=rel.get)
    print(f"[train] {label} gradients, kernels vs plain attention: loss "
          f"{float(loss_k):.6f} vs {float(loss_p):.6f}; per-leaf relative "
          f"L2 max {rel[worst]:.3g} ({worst}), median "
          f"{float(np.median(list(rel.values()))):.3g}; bound "
          f"{TRAIN_GRAD_BOUND}; witnesses: SDPA vs plain {sdpa:.3g}, a "
          f"planted lost KV tile {lost:.3g}", flush=True)
    check(rel[worst] <= TRAIN_GRAD_BOUND,
          f"{label}: gradient {worst} off the plain attention's by "
          f"{rel[worst]:.3g}")
    check(lost > TRAIN_GRAD_BOUND,
          f"{label}: the planted lost tile reads {lost:.3g}, within the "
          f"bound")
    return dict(loss=float(loss_k), loss_plain=float(loss_p),
                max_rel_l2=rel[worst], leaf=worst,
                median_rel_l2=float(np.median(list(rel.values()))),
                sdpa_vs_plain=sdpa, planted_lost_tile=lost)


def train_phase(kernels, card):
    """``repro_torch.launch.train.main`` on the card at full width, seq
    512, batch 8, Markov data, with ``torch.use_deterministic_algorithms``
    on (the embedding's backward then sums without atomics):
    SmolLM-360M plain for ``TRAIN_STEPS`` steps (finite loss that falls),
    the same run crashed at ``TRAIN_FAIL`` (exit 42, a checkpoint at step
    8) and resumed (every step's loss equal to the uninterrupted run's to
    the bit, the crashed run's steps too), QAT resumed from that
    checkpoint (finite, and off the plain losses: the fake-quant is in
    the forward), one step's gradients against the plain attention's, the
    step's device time by phase; Gemma3-1B plain for ``GEMMA_STEPS``."""
    import shutil
    import tempfile
    from repro_torch.launch.train import build_cfg
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        cfg = build_cfg("smollm_360m", "full")
        a = out["smollm_360m/plain"] = train_run(
            kernels, "smollm_360m/plain", train_args("smollm_360m",
                                                     TRAIN_STEPS), cfg)
        check(np.mean(a["loss"][-3:]) < np.mean(a["loss"][:3]),
              f"smollm_360m/plain: loss did not fall: {a['loss']}")
        ck = ["--ckpt-dir", ckpt_dir, "--ckpt-every", str(TRAIN_FAIL)]
        b = out["smollm_360m/crash"] = train_run(
            kernels, "smollm_360m/crash",
            train_args("smollm_360m", TRAIN_STEPS, *ck, "--fail-at-step",
                       str(TRAIN_FAIL)), cfg, expect_exit=42)
        c = out["smollm_360m/resume"] = train_run(
            kernels, "smollm_360m/resume",
            train_args("smollm_360m", TRAIN_STEPS, *ck, "--resume"), cfg)
        check(b["steps"] == list(range(TRAIN_FAIL))
              and c["steps"] == list(range(TRAIN_FAIL, TRAIN_STEPS)),
              f"crash/resume steps {b['steps']} + {c['steps']}")
        same = b["loss"] + c["loss"] == a["loss"]
        diff = max(abs(x - y) for x, y in zip(b["loss"] + c["loss"],
                                              a["loss"]))
        print(f"[train] crash at step {TRAIN_FAIL} and resume: losses equal "
              f"to the uninterrupted run's to the bit: {same} (max |d| "
              f"{diff:.3g})", flush=True)
        check(same, f"resumed losses off the uninterrupted run's by {diff}")
        q = out["smollm_360m/qat"] = train_run(
            kernels, "smollm_360m/qat",
            train_args("smollm_360m", TRAIN_QAT_TO, *ck, "--resume",
                       "--qat"), cfg)
        dq = [x - y for x, y in zip(q["loss"], a["loss"][TRAIN_FAIL:])]
        print(f"[train] QAT from step {TRAIN_FAIL}: loss minus the plain "
              f"run's at the same steps {['%.4g' % d for d in dq]}",
              flush=True)
        check(any(d != 0 for d in dq), "QAT losses equal the plain run's")
        a["profile"] = profile_train_step(cfg, "smollm_360m")
        a["grads_vs_plain"] = grads_against_plain(cfg, "smollm_360m")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
    cfg = build_cfg("gemma3_1b", "full")
    g = out["gemma3_1b/plain"] = train_run(
        kernels, "gemma3_1b/plain", train_args("gemma3_1b", GEMMA_STEPS),
        cfg)
    g["profile"] = profile_train_step(cfg, "gemma3_1b")
    print(f"[train] on {card}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 5: the example ports
# ---------------------------------------------------------------------------

# example -> the kernels its path launches on the card
EXAMPLES = {
    "quickstart": ("sparse_matvec", "flash_attention"),
    "compile_resnet50": ("conv_implicit", "conv_sparse", "cfmm_matmul",
                         "sparse_matvec"),
    "serve_resnet50_pipeline": ("conv_implicit", "cfmm_matmul"),
    "serve_resnet50_fleet": ("conv_implicit", "cfmm_matmul"),
    "serve_model_zoo": ("conv_implicit", "conv_depthwise", "cfmm_matmul"),
    "serve_lm": ("cfmm_matmul", "sparse_matvec", "flash_attention"),
    "train_lm": ("flash_attention", "flash_attention_bwd"),
}


def examples_phase(kernels):
    """Each ``examples/torch_<name>.py`` run from ``main(["--device",
    "cuda"])`` at its default flags: its own checks pass (served logits
    bit-identical to ``reference_logits`` on the card, ...), its last
    line is "<name> OK", and the launch counters (set to 0 just before)
    show the kernels of its path ran."""
    import importlib.util
    import io
    out = {}
    for name, needed in EXAMPLES.items():
        spec = importlib.util.spec_from_file_location(
            f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for kern in kernels.values():
            kern.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            mod.main(["--device", "cuda"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lines = buf.getvalue().rstrip().splitlines()
        counts = {k: v.launches for k, v in kernels.items() if v.launches}
        print(f"[examples] {name}: {dt:.1f}s, launches {counts}; last "
              f"lines: {lines[-3:]}", flush=True)
        check(lines and lines[-1] == f"{name} OK",
              f"example {name}: no OK line")
        check(all(counts.get(k, 0) > 0 for k in needed),
              f"example {name}: launched {counts}, want {needed}")
        out[name] = dict(seconds=dt, launches=counts)
    return out


DIST_ARCH = "olmoe_1b_7b"
DIST_TOKENS = 256
# no pick drops: the exchange's bins hold T * K / E * cf * E_loc = 2048
# slots at ep 1 (every pick); moe_forward's queues hold all 256 tokens
DIST_A2A_CF = 1.0
DIST_MOE_CF = LOOSE_CAPACITY
DIST_MODES = ("int8", "sparse_cfmm")
# the exchange against moe_forward and against its plain versions: the
# same int8 codes reach each expert (one activation scale an expert:
# the other slots are zero rows), the int32 products are exact, and a
# token's K terms add in choice order
DIST_BOUND = 0.0


def dist_phase(kernels, card):
    """Distribution on one card (section 5b of the docstring): the NCCL
    group and spec check (a), the MoE exchange at OLMoE-1B-7B's widths
    (b), one dry-run cell through its entry point (c)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import nn
    from repro_torch.configs.base import get_config
    from repro_torch.core.compiled_linear import compile_params
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.moe_a2a import (a2a_expert_exchange,
                                                 capacity)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import lm, moe
    from repro_torch.models.layers import ffn
    from torch.distributed.tensor import Replicate

    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_debug_mesh((1, 1))
            check(mesh.device_type == "cuda"
                  and dist.get_backend() == "nccl", f"[dist] mesh {mesh}")
            # (a) every leaf of a full-width serve tree replicates
            scfg = get_config("smollm_360m")
            stree = compile_params(lm.init(nn.SHAPE_ONLY, scfg), "int8")
            specs = [sp for sp in nn.tree_leaves(
                shd.param_shardings(stree, mesh, shd.SERVE_RULES),
                is_leaf=lambda x: isinstance(x, tuple))
                if isinstance(sp, tuple)]
            n_leaves = sum(isinstance(p, nn.Param) for p in nn.tree_leaves(
                stree, is_leaf=lambda x: isinstance(x, nn.Param)))
            check(len(specs) == n_leaves and all(
                shd.placements_of(sp, mesh) == [Replicate(), Replicate()]
                for sp in specs),
                f"[dist] (a) {len(specs)} of {n_leaves} leaves replicate")
            print(f"[dist] (a) {card}: {dist.get_backend()} world 1, "
                  f"mesh 1 x 1 (data, model); SmolLM-360M int8 serve tree: "
                  f"{n_leaves} leaves, every one Replicate()", flush=True)

            # (b) one MoE layer at OLMoE-1B-7B's published widths
            cfg = get_config(DIST_ARCH)
            m = cfg.moe
            check((cfg.d_model, m.n_experts, m.d_ff_expert, m.top_k)
                  == (2048, 64, 1024, 8), f"[dist] {DIST_ARCH} widths")
            gen = torch.Generator(device="cuda").manual_seed(0)
            layer = moe.moe_init(gen, cfg)
            put = shd.distribute_params(layer, mesh)
            same = all(torch.equal(a.value.full_tensor(), b.value)
                       for a, b in zip(
                           nn.tree_leaves(put, is_leaf=lambda x:
                                          isinstance(x, nn.Param)),
                           nn.tree_leaves(layer, is_leaf=lambda x:
                                          isinstance(x, nn.Param))))
            check(same, "[dist] (a) distribute_params round trip")
            del put
            x = torch.randn((1, DIST_TOKENS, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
            xt = x.reshape(-1, cfg.d_model)
            for mode in DIST_MODES:
                linear = LM_LINEAR[mode]
                p = nn.unbox(compile_params(layer, mode))
                r = moe.route(xt, p["router"], m.top_k, DIST_MOE_CF)
                check(bool(r.keep.all()), f"[dist] {mode}: picks dropped")
                experts = nn.unstack(p["experts"], m.n_experts)

                def apply(x_e):
                    return torch.stack([ffn(experts[e], x_e[e], act=m.act)
                                        for e in range(m.n_experts)])

                def exchange():
                    return a2a_expert_exchange(
                        xt, r.expert_idx, r.gate_vals, apply, m.n_experts,
                        mesh, capacity_factor=DIST_A2A_CF)

                zero_launches(kernels)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = exchange()
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                counts = {k: v.launches for k, v in kernels.items()
                          if v.launches}
                check(counts == {linear: 3 * m.n_experts},
                      f"[dist] {mode}: launches {counts}")
                ref, _ = moe.moe_forward(p, x, cfg,
                                         capacity_factor=DIST_MOE_CF)
                with plain_versions([linear]):
                    plain = exchange()
                d_ref = (got.float() - ref.reshape(xt.shape).float()
                         ).abs().max().item()
                d_plain = (got.float() - plain.float()).abs().max().item()
                scale = ref.float().abs().max().item()
                cap = capacity(DIST_TOKENS, m.top_k, m.n_experts,
                               m.n_experts, DIST_A2A_CF)
                print(f"[dist] (b) {card}: {DIST_ARCH} layer, {mode}: "
                      f"{DIST_TOKENS} tokens x top-{m.top_k} over "
                      f"{m.n_experts} experts, ep 1, cap {cap} slots; "
                      f"exchange {dt:.1f} ms (host clock, first call); "
                      f"max|d| vs moe_forward {d_ref:.3g}, vs plain "
                      f"versions {d_plain:.3g} (bound {DIST_BOUND}; "
                      f"max|y| {scale:.4g}); launches {counts}", flush=True)
                check(torch.isfinite(got.float()).all().item() and scale > 0,
                      f"[dist] {mode}: output not finite")
                check(d_ref <= DIST_BOUND and d_plain <= DIST_BOUND,
                      f"[dist] {mode}: {d_ref} / {d_plain} > {DIST_BOUND}")
                out[f"dist/{DIST_ARCH}/{mode}"] = dict(
                    counts=counts, ms=dt, max_abs_vs_moe_forward=d_ref,
                    max_abs_vs_plain=d_plain)
                del p, experts, got, ref, plain
            del layer
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

    # (c) one dry-run cell through its entry point
    art = ROOT / "build" / "dryrun" / "single" / \
        f"{DIST_ARCH}__decode_32k.json"
    art.unlink(missing_ok=True)
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DIST_ARCH, "--shape", "decode_32k", "--mesh", "single"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    dt = time.perf_counter() - t0
    check(run.returncode == 0, f"[dryrun] exit {run.returncode}: "
          f"{run.stderr[-2000:]}")
    line = run.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    check(art.exists() and rec["artifact"] == str(art)
          and not (ROOT / "experiments" / "dryrun").exists(),
          f"[dryrun] artifact {rec.get('artifact')}")
    print(f"[dryrun] {line} ({dt:.1f}s; an analytic projection on H100 SXM "
          f"constants, not a measurement)", flush=True)
    out["dryrun"] = dict(seconds=dt, **rec)
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import (_cuda, block_sparse, cfmm_matmul,
                                     conv_depthwise, conv_implicit,
                                     conv_sparse, flash_attention,
                                     sparse_matvec)
    card = gpu_identity()
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    kernels = {"conv_implicit": conv_implicit.KERNEL,
               "conv_sparse": conv_sparse.KERNEL,
               "sparse_matvec": sparse_matvec.KERNEL,
               "conv_depthwise": conv_depthwise.KERNEL,
               "cfmm_matmul": cfmm_matmul.KERNEL,
               "flash_attention": flash_attention.KERNEL,
               "flash_attention_bwd": flash_attention.BWD_KERNEL,
               "block_sparse": block_sparse.KERNEL}
    t0 = time.perf_counter()
    logs = _cuda.build_all(kernels.values())
    print(f"[build] {len(kernels)} kernels in {time.perf_counter() - t0:.1f}s",
          flush=True)
    # ptxas -v by kernel instance (its mangled name: flash_mma_kernel<256,
    # 256> is ..flash_mma_kernelILi256ELi256EE..); every tensor-core flash
    # instance, forward and backward, must spill nothing
    spills = collections.Counter()
    for src, log in logs.items():
        name = ""
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                name = m.group(1)
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {src}: {name}: {line.strip()}", flush=True)
            kind = re.search(r"\d(flash_mma|flash_bwd_dq_mma|flash_bwd_dkdv_mma)"
                             r"_kernelI", name)
            if kind and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                        r"bytes spill loads", line)):
                spills[kind.group(1)] += 1
                check(m.group(1) == m.group(2) == "0",
                      f"ptxas: {name} spills ({line.strip()})")
    n_fwd, n_bwd = len(flash_attention.MMA_PAIRS), len(
        flash_attention.BWD_MMA_PAIRS)
    check(spills == {"flash_mma": n_fwd, "flash_bwd_dq_mma": n_bwd,
                     "flash_bwd_dkdv_mma": n_bwd},
          f"ptxas: spill lines of {dict(spills)} tensor-core flash "
          f"instances, want {n_fwd} forward and {n_bwd} of each backward")
    print(f"[ptxas] 0 spill bytes in each of {n_fwd} flash_mma_kernel and "
          f"2 x {n_bwd} backward tensor-core instances", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {"conv_implicit": [], "conv_sparse": []}
    cases = {}
    for spec in CONV_SHAPES:
        c = cases[spec[0]] = conv_case(spec, dev, gen)
        for kind in ("conv_implicit", "conv_sparse"):
            rows[kind].append(check_conv_kernel(kind, c))
    zero_rows = {kind: [check_conv_zero_counts(kind, cases[name], g)
                        for name, g in CONV_ZERO_COUNTS]
                 for kind in ("conv_implicit", "conv_sparse")}
    for kind, zr in zero_rows.items():
        epi = [r for r in zr if r["route"] == "epilogue"]
        print(f"[kernel] {kind} zero counts over {len(epi)} epilogue "
              f"cases: unprofiled {sum(r['ms'] for r in epi):.4f} ms, "
              f"profiled {sum(r['profiled_ms'] for r in epi):.4f} ms, of "
              f"which zeroing + dict "
              f"{sum(r['around_ms'] for r in epi):.4f} ms", flush=True)
    rows["sparse_matvec"] = [check_sparse_matvec(*sh, dev, gen)
                             for sh in SPARSE_SHAPES]
    rows["flash_attention"] = [check_flash(sp, dt, dev, gen)
                               for dt in (torch.bfloat16, torch.float32)
                               for sp in FLASH_SHAPES]
    rows["flash_attention"] += [check_flash(sp, torch.bfloat16, dev, gen)
                                for sp in LM_FLASH_SHAPES]
    rows["flash_attention_bwd"] = [check_flash_bwd(sp, dt, dev, gen)
                                   for dt in (torch.bfloat16, torch.float32)
                                   for sp in FLASH_BWD_SHAPES]
    rows["conv_depthwise"] = [check_depthwise(*s, dev, gen)
                              for s in DW_SHAPES]
    for shape, g in DW_ZERO_COUNTS:
        check_dw_zero_counts(shape, g, dev, gen)
    dw_ms = sum(r["ms"] for r in rows["conv_depthwise"])
    dw_lib = sum(r["library_ms"] for r in rows["conv_depthwise"])
    print(f"[kernel] conv_depthwise over {len(DW_SHAPES)} shapes: kernel "
          f"{dw_ms:.4f} ms, cuDNN {dw_lib:.4f} ms, kernel/cudnn="
          f"{dw_ms / dw_lib:.2f}", flush=True)
    floor = floor_line(card)
    rows["cfmm_matmul"] = [check_cfmm(*s, dev, gen) for s in CFMM_SHAPES]
    print(f"[time] kernel phase done at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    rows["block_sparse"], bs_paths = block_sparse_phase(dev, gen)
    print(f"[time] block-sparse phase done at "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)

    served, trees, serve_images = serve(kernels, card)
    print(f"[time] CNN serve phase done at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    fleet = fleet_phase(kernels, card, trees, serve_images)
    print(f"[time] fleet phase done at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    dense_cnn = dense_cnn_phase(kernels, card, trees, serve_images)
    del trees
    print(f"[time] dense CNN phase done at "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    lm_served = {}
    for path in LM_PATHS:
        lm_served.update(serve_lm(kernels, card, *path))
        print(f"[time] LM {path[0]} done at "
              f"{time.perf_counter() - t_start:.1f}s", flush=True)
    whisper = serve_whisper(kernels, card)
    print(f"[time] LM {WHISPER} done at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    trained = train_phase(kernels, card)
    print(f"[time] training phase done at "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    examples = examples_phase(kernels)
    print(f"[time] examples done at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    dist = dist_phase(kernels, card)
    print(f"[time] dist phase done at {time.perf_counter() - t_start:.1f}s",
          flush=True)

    meta = {
        "conv_implicit": ("src/repro_torch/csrc/conv_implicit.cu",
                          "src/repro/kernels/conv_implicit.py:144"),
        "conv_sparse": ("src/repro_torch/csrc/conv_sparse.cu",
                        "src/repro/kernels/conv_sparse.py:90"),
        "sparse_matvec": ("src/repro_torch/csrc/sparse_matvec.cu",
                          "src/repro/kernels/sparse_matvec.py:55"),
        "conv_depthwise": ("src/repro_torch/csrc/conv_depthwise.cu",
                           "src/repro/kernels/conv_depthwise.py:80"),
        "cfmm_matmul": ("src/repro_torch/csrc/cfmm_matmul.cu",
                        "src/repro/kernels/cfmm_matmul.py:44"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:84"),
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/models/attention.py:57 "
                                "(jax.value_and_grad)"),
        "block_sparse": ("src/repro_torch/csrc/block_sparse.cu",
                         "src/repro/kernels/block_sparse.py:64"),
    }
    entries = []
    for name, shape_rows in rows.items():
        ops_ms = sum(r["bound_ms"] for r in shape_rows
                     if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in shape_rows
                       if r["bound_by"] == "bytes")
        lib_rows = [r for r in shape_rows if r["library_ms"] is not None]
        by_path = {f"{m}/{mode}/{n}": v["counts"][name]
                   for (m, mode, n), v in served.items()
                   if v["counts"][name]}
        by_path.update({path: v["counts"][name]
                        for path, v in lm_served.items()
                        if v["counts"][name]})
        by_path.update({path: v["counts"][name]
                        for path, v in whisper.items()
                        if v.get("counts", {}).get(name)})
        by_path.update({path: v["launches"][name]
                        for path, v in whisper.items()
                        if v.get("launches", {}).get(name)})
        by_path.update({f"fleet/resnet50/{wave}": v["launches"][name]
                        for wave, v in fleet.items()
                        if v.get("launches", {}).get(name)})
        by_path.update({f"train/{path}": v["counts"][name]
                        for path, v in trained.items()
                        if v["counts"].get(name)})
        by_path.update({f"examples/{ex}": v["launches"][name]
                        for ex, v in examples.items()
                        if v["launches"].get(name)})
        by_path.update({path: v["counts"][name] for path, v in dist.items()
                        if v.get("counts", {}).get(name)})
        status = (f"built, launched on the served paths, equal to its "
                  f"plain version at {len(shape_rows)} shape(s)")
        zr = zero_rows.get(name)
        if zr:
            epi = [r for r in zr if r["route"] == "epilogue"]
            status += (f"; its profile_g zero counts equal to the plain "
                       f"version's dict at {len(zr)} case(s), {len(epi)} "
                       f"counted in the epilogue (g "
                       f"{sorted({r['g'] for r in epi})}) and "
                       f"{len(zr) - len(epi)} recounted on y, with y, amax "
                       f"and acc the same with profiling on and off; the "
                       f"profiled fleet waves ran them")
        if name == "flash_attention_bwd":
            status = (f"built, launched on the training paths, equal to its "
                      f"plain version at {len(shape_rows)} shape(s)")
        if name == "block_sparse":
            by_path.update(bs_paths)
            status = (f"built, launched by the block-sparse phase (no served "
                      f"path of the JAX package calls it), equal to its "
                      f"plain version at {len(shape_rows)} shape(s)")
        entries.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sum(by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in shape_rows),
            "ms": sum(r["ms"] for r in shape_rows),
            "plain_ms": sum(r["plain_ms"] for r in shape_rows),
            "bound_ms": sum(r["bound_ms"] for r in shape_rows),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            # summed over the shapes that have one library call; ms_there
            # is the kernel's own time summed over the same shapes
            "library_ms": (sum(r["library_ms"] for r in lib_rows)
                           if lib_rows else None),
            "library_shapes": [r["shape"] for r in lib_rows],
            "ms_at_library_shapes": (sum(r["ms"] for r in lib_rows)
                                     if lib_rows else None),
            "launches_by_path": by_path,
            "status": status,
            "shapes": shape_rows,
            **({"zero_counts": zero_rows[name]} if name in zero_rows
               else {}),
        })
    serve_line = [{"path": f"{m}/{mode}", "n_stages": n, **v}
                  for (m, mode, n), v in served.items()]
    print(json.dumps({"serve": serve_line, "floor": floor}), flush=True)
    print(json.dumps({"fleet": fleet}), flush=True)
    print(json.dumps({"dense_cnn": dense_cnn}), flush=True)
    print(json.dumps({"lm_serve": lm_served}), flush=True)
    print(json.dumps({"whisper": whisper}), flush=True)
    print(json.dumps({"train": trained}), flush=True)
    print(json.dumps({"examples": examples}), flush=True)
    print(json.dumps({"dist": dist}), flush=True)
    print(f"[time] total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(f"[card] {card}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
