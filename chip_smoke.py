#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line as soon as it has its numbers:

1. card: name and power limit (``nvidia-smi``), TF32 settings;
2. build: compiles the CUDA kernels of ``avatar_tpu_torch/csrc`` with
   ``nvcc`` (one process per library, in parallel): every source's bf16 /
   head dim 64 build, the Hopper kernels and the WMMA A, B and E at head dim
   128; the bf16 and f32 variants at other head dims that
   kernel_generality needs build meanwhile in the background;
3. kernels (``kernel_*`` lines): each of the five attention kernels against
   its plain PyTorch version (bf16) at every shape a driven path gives it
   (832 and 5376 tokens, 256 caption keys, batch 1, 3 and the training
   batch 8 x 480): bounded and unbounded, masked, a fully masked row,
   ragged lengths, and for the head-major kernels the row log-sum-exp; A
   (``rope_fused_attention_sm90``), B (``fused_token_attention_sm90``, also
   at 512 keys) and the bounded (C), online (D) and
   whole-row (E) kernels run the Hopper kernels (``flash_*_sm90``), also at
   head dim 128 and, for C-E, on transposed views; each is timed (A, B and
   E by the profiler's device time: their wrappers' host time exceeds the
   kernels') at its main-path shapes beside the WMMA kernel it replaces on
   the same inputs, ``scaled_dot_product_attention`` and its bound, and
   their WMMA route (``*_wmma``) at f32; the int8 product on the Hopper
   kernel (``w8a8_matmul_sm90``: exact int32 sums; the dequant at the DiT's
   three W8A8 shapes, 832 and a ragged 5000 rows, equal to the ``mma.sync``
   kernel's, each timed beside it and ``torch._int_mm``; the W8A8
   crossover, ``linear`` on the kernel route against the short route at
   832, 3328 and 5376 tokens) and the three row-quant kernels (at most one
   int8 level apart on a stated fraction, scales at rtol 1e-6; J on its
   Hopper route, ``rms_mod_quant_sm90``, beside its row-block kernel; K on
   its Hopper route, ``act_quant_sm90``, for each activation beside its
   row-block kernel, and its bound from the SASS instructions it issues,
   ``avatar_tpu_torch/tools/act_quant_sass.py``; I, J and K on rows with a
   NaN or an inf, exactly as their plain versions); the W8A8 VAE's kernel
   L (``kernel_int8_conv3d``: L1's levels and L2's outputs bit for bit
   against their plain versions, L2 on the route ``conv_plan`` names
   (``int8_conv3d_sm90``: wgmma, split K where planned) and on the gather
   kernel, at every int8 conv shape of the 2B VAE's encode of a reference
   frame and 97 pose frames at 256 px and its decode of [13, 8, 8, 128]
   latents and of a served batch-4 decode, with replicate padding, stride
   2, zero and NaN inputs, split K among them; the one-read activation
   scale equal to the two-pass one; each shape's route and split, device
   times of both L2 routes and both L1 designs beside cuDNN's bf16 conv
   and the bounds (L1's the larger of bytes and the issue of its work's
   SASS), and the sums over a video and per shape class); the flash
   backward's two kernels
   (``kernel_flash_bwd_dkv``, ``kernel_flash_bwd_dq``) on the Hopper
   kernels (``flash_bwd_*_sm90``) at the training shapes, at 5376 tokens
   with lse from kernel C and from D, ragged with a fully masked sample and
   at head dim 128, timed beside the WMMA kernels they replace; the
   dense-bias attention's four kernels on the Hopper route
   (``kernel_flash_dense_*_sm90``: forward, dK/dV, dQ, dBias) at T5-XXL's
   shape with a per-head position-and-padding bias and at 5376 tokens with
   one shared bias, a band of masked keys and a fully masked row, beside
   the WMMA kernels on the same inputs, and at Lk = 254 on the WMMA route;
   then each one's time, the plain version's, one PyTorch library call's
   where there is one (a yardstick the port never calls) and the card's
   lower bound for the same work; then autograd through the three
   attention entries on the card against their plain versions in f32
   (``attention_gradients``), and the dense-bias path's driven run
   (``attention_dense_bias``: autograd through
   ``scaled_dot_product_attention(mask=<4-D bias>, impl="flash")`` at both
   shapes, out and every gradient, bias included, against f32);
   kernel_generality: every attention family (A, B, C, D, E, F, G) at
   small ragged shapes, bf16 at head dims 32, 80, 128, 256 (and 512 for
   C-G) and f32 at 64 and 128, against the plain versions, with the
   variants' build seconds and C's and D's times at 5376 tokens;
4. reference: a tiny pipeline at guidance 1 in bf16 on the card against the
   same pipeline in f32 on the CPU (plain kernel versions), once as it is
   and once with the timestep rounded as a bf16 run rounds it, and in bf16
   on the card without the kernels, same weights and noise;
5. reference_guided: the same with CFG 3 + STG 1 + rescale 0.7 + Heun, on
   the default path and with ``attention_impl="flash", rope_split=False``
   at shapes that reach each head-major kernel inside a pipeline, and each
   of these also in f32 on the card against f32 on the CPU (the f32
   variants; ``reference_guided_f32``);
   reference_conditioned: conditioning items (first frame resized up with
   the image-conditioning noise; off-centre beside a sequence at frame 8
   with its prefix tokens) and ``media_items`` with skipped initial steps,
   the same four ways; reference_vae_variants: a VAE with group norm,
   timestep conditioning, decoder noise injection and ``attn_res_x``
   blocks at 192 and 1280 tokens (E and D on the Hopper kernel), its decode
   in bf16 on the card against f32 on the CPU, and a tiny pipeline whose
   DiT has ``adaptive_norm="none"`` the four ways above;
6. reference_w8a8: tiny quantized pipelines in bf16 on the card against
   f32 on the CPU, same int8 weights and noise: W8A8 at 4352 tokens (the
   int8 kernels), W8A8 at 16 tokens (the library int8 product) and
   weight-only w8; reference_vae_w8a8: the tiny VAE of
   ``tests/test_extras.py::test_w8a8_vae`` in f32 on the card, its W8A8
   encode and decode (kernel L in f32) within that test's 0.08 of the f32
   VAE's, L2's launches on each route as ``conv_plan`` names them;
7. t5: T5-XXL at full width, seeded random bf16 weights: a prompt and a
   negative prompt encoded (2 x 256 tokens), its time, peak memory, the
   W8A8 encode's time and distance, and a tiny T5 in bf16 on the card
   against f32 on the CPU;
   pipeline: the full-width 2B DiT (28 layers, 32 x 64) and the 2B VAE
   with timestep conditioning, random weights from a seed, 97 frames at
   256 px, 40 Euler steps, guidance 1, STG 0, I420 output; checks shapes,
   finite latents, and that each kernel of the path launched exactly
   28 x 40 times; then a profile (device time by kernel over 5 steps,
   torch.profiler) and the device's idle share of an unprofiled step;
8. pipeline_long: the same models at 161 frames and 512 px (5376 tokens),
   where self-attention goes through the head-major max-free kernel (the
   Hopper kernel, 28 x 40 launches, none of the WMMA one) and
   cross-attention through the token-major one; profile of 3 steps;
9. pipeline_guided: 97 frames at 256 px with the shipped guided settings
   (CFG 3, STG 1 on block 19 with AttentionValues, rescale 0.7): three
   conds per step in one batch; pipeline_conditioned: the same with the
   t5 phase's embeddings as prompt and negative prompt and one first-frame
   conditioning item (strength 1, image-conditioning noise 0.15):
   image-to-video;
   pipeline_vae_w8a8: the short path with ``quantize_vae="w8a8"`` (the
   same DiT and VAE weights): L1 and L2 of kernel L launched exactly once
   per int8 conv of the video's two encodes and its decode (129; L2 on
   the wgmma route 123 times, on the gather route for the 6 stride-2
   convs), stage
   seconds, then both VAEs' encode and decode in turns (bf16, int8, int8,
   bf16) and the int8 decode's distance from the bf16 one (printed);
   serving: ``AvatarServer`` over the bf16 pipeline, the JAX package's
   serving traffic (97 f · 256 px, 40 steps, I420, one avatar for every
   request, batches of up to 4 within 50 ms): a warm-up of 4 requests,
   two rounds of 12; requests and frames per second, latency, batches per
   round, media-cache hits, A's and B's launches, and a batched request
   against the same one alone (without decode-time noise);
10. pipeline_long_w8a8: the long path with the DiT quantized W8A8 (from
   the same bf16 weights): every block linear through the int8 kernels
   (the product on the Hopper kernel, 8,960 launches, none of the
   ``mma.sync`` one; J on its Hopper kernel, 2,240 launches, none of the
   row-block one), launches checked per kernel, profile of 3 steps
   (device ms by kernel), and the latents''
   relative RMS against the bf16 long path's (printed, not held);
11. cli, cli_long_video, cli_multiscale: the inference CLI
   (``avatar_tpu_torch.cli.infer.generate``) on a single-file checkpoint
   the port exports from the same 2B models, the ``t5`` embeddings as its
   ``prompt_embeds_path`` and the shipped ``configs/inference-avatars.yaml``
   (held here as a dict: the card's machine has no PyYAML) at the CLI's
   defaults (192 x 320, 121 frames, 40 steps): one pass (960 tokens, A and
   B), 185 frames as two windows of 97 (780 tokens: E for both attentions,
   as the route predicates send a length that is not a multiple of 16),
   and the multi-scale pipeline with a random ``LatentUpsamplerConfig()``
   (a 384-token pass on A and B, a 1536-token pass on C and B); load,
   warm-up and video seconds, frames / s, peak memory, launches exactly as
   ``dit_route_counts`` names them;
12. reference_train (run after phase 6): a tiny DiT (heads of 64, 128
   tokens) trained 2 steps with accumulation 2, "lora_audio" and "full",
   bf16 on the card against f32 on the CPU and against the card without
   the kernels, same weights, t and noise; train_cli: the port's
   ``train_loop`` writing, exporting and resuming in a temporary
   directory;
13. train: the full-width 2B DiT trained in "lora_audio" mode at the
   training point (batch 8, 480 tokens, caption 256, accumulation 2, 3
   optimizer steps): losses, launches per micro-step (A, B, E and F on the
   Hopper kernels only), seconds per step, peak memory and a profile of
   one micro-step with A's, B's, E's and F's device ms; then the
   multi-device layer over an NCCL process group of one (this card):
   parallel_world1: the long point's DiT input (5376 tokens) through
   ``dit_apply_sp`` (Ulysses, ring) and ``dit_apply_pp`` at one stage
   against ``dit_apply`` (``PARALLEL_TOL``), each timed, its launches by
   route (C for every attention under sp, no A or B), and a ``dp_mesh``
   pipeline's generation equal to the pipeline's; ring_chunks: the ring's
   chunk step over 4 chunks of 1,344 keys at [1|2, 32, 5376, 64] bf16 (C
   bounded, D not; F backward), merged O, lse, dQ, dK, dV against the
   whole-sequence kernels and their plain versions, a row with no kept key
   0 in O and every gradient, 4 launches of each kernel, the chunked
   forward and backward timed beside the whole-sequence C / D and F;
   train_parallel_world1: one step of ``train``'s shape under sp (Ulysses,
   ring), zero2 and fsdp, AdamW and Adafactor, each against the dp step
   (loss, update), peak memory;
14. reference_train_options (after reference_train): the tiny DiT in f32
   with Adafactor ("lora_audio" and "full", factored leaves), card against
   CPU, and one micro-step's gradients under remat "dots" against "full"
   and none on the card; reference_train_decoder: the tiny VAE's decoder
   fine-tuning in f32, card against CPU; train_cli_decoder: the CLI's
   ``train_mode="decoder"`` with its export read back (beside train_cli);
15. faceformer: full-width wav2vec2-base and FaceFormer (random weights
   through ``import_faceformer_state``, f32) on 4.85 s of audio and on
   ``MAX_AUDIO_SAMPLES``, against the CPU; ms per predict and per frame,
   launches and busy share; vertices to landmark pixels (no renderer on
   the card's machine);
16. train_audio: the "lora_audio" training on audio latents made on the
   card by FaceFormer, padded to T = 86 (cross-attention on E and F) and
   to T = 80 (on B), launches as ``PINNED_LAUNCHES`` and
   ``train_route_counts`` both name them;
   train_full_remat: "full"-mode training of the 2B DiT with Adafactor
   without remat, with remat "full" and "dots", and AdamW with "dots":
   seconds per step, micro-step device ms, peak memory ("dots" between
   "full" and none) and launches; train_decoder: decoder fine-tuning of
   the 2B VAE, 97 frames at 256 px, remat per up block, AdamW, 3 steps;
17. preprocess_vae_latents: the preprocessing CLI's ``save-vae-latents``
   (``cmd_save_vae_latents``) over the pipeline's 2B VAE in bf16, on 57 x
   192 x 320 random uint8 clips handed over after decode and resize (no cv2
   or PIL on the card's machine), through the staging thread, the encode
   and the save: the encode alone (ms per encode by CUDA events, its
   kernels' device ms, busy share, dispatch ms, host- or device-bound);
   runs of 16 and 272 clips, twice, and the steady-state clips and frames
   / s and stage split of each pair's difference; peak memory; every file
   read back equal to the latents the encode returned, the uint8 path
   equal to the float path bit for bit; reference_preprocess: a tiny
   checkpoint written by the port through ``save-vae-latents`` in f32 on
   the card and on the CPU with the same draws (1e-5, metadata equal);
   preprocess_text_latents: ``save-text-latents`` with a random full-width
   FaceFormer ``.pth`` on two wavs, card against CPU (1e-5), ms per file;
   profiling: ``utils/profiling.trace`` around one encode in
   ``annotate("encode")`` (the range and CUDA kernels in the trace file),
   ``timed`` on a chain of bf16 products inside the spread of CUDA event
   times, and below it with its synchronize taken out;
   reference_video_autoencoder: the legacy VideoAutoencoder at ``dims`` 3
   and (2, 1), card against CPU in f32 (1e-5). None of them launches a
   kernel of A-L.

The launch counts are set to 0 just before each driven path and read just
after it. Then the kernel summary line, the ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line. Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

TOKENS, CAPTION, HEADS, HEAD_DIM = 832, 256, 32, 64
WIDTH = HEADS * HEAD_DIM
STEPS, LAYERS = 40, 28
# A kernel's bf16 output against its plain version's, per case: the two
# round p and o to bf16 at the same places but sum in another order (and
# the online kernel rounds p against a running max), so an element may land
# on the neighbouring bf16 value. The limit is two bf16 ulps of the case's
# largest output, 2 * 2^-7 * max|ref|: 1.8e-3 at 5376 keys (4.9e-4
# measured), where outputs are averages of about 0.02 RMS and one dropped
# key tile of 84 would move some element by about 1e-2.
KERNEL_ULPS = 2
# lse = [m +] log l in f32, values of O(10): the kernel sums the same
# bf16-rounded p in another order, and the online kernel rounds p against
# a running max where its plain version uses the final one (7e-4 at most
# measured; one dropped key tile of 84 moves lse by 1.2e-2)
LSE_TOL = 2e-3
# the long-sequence operating point: 161 frames at 512 px = 21 x 16 x 16
LONG_GRID = (21, 16, 16)
LONG_TOKENS = 21 * 16 * 16
# Tiny pipelines, 3 steps, as the RMS of the difference over the RMS of the
# latents. A bf16 run scales the timestep t = sigma * 1000 in bf16, as the
# JAX package does, which rounds t to a multiple of 4 above 512; that is
# nearly all of its distance from an f32 run
# (``avatar_tpu_torch/tools/bf16_error.py``). So the card's bf16 run is held
# to the f32 CPU run fed the same rounded t (0.007 to 0.012 measured: bf16's
# own rounding in this model) ...
REFERENCE_TOL = 0.02
# ... and to the f32 CPU run as it is, with a limit by the schedule: the
# 12- and 16-token runs round t = 628.2 and 628.4 to 628 (0.021 to 0.026
# measured), the 1280-token runs round t = 673.8 to 672 (0.110 and 0.111).
EXACT_T_TOL = {"short": 0.04, "long": 0.14}
# The same tiny pipelines in f32 on the card (the kernels' f32 variants)
# against f32 on the CPU at the same t: both keep f32 throughout, the
# kernels' 3xTF32 products hold about 2^-22 relative, and sums run in
# another order, so the relative RMS should sit near 1e-6.
F32_REFERENCE_TOL = 1e-4
# The kernels' path against plain attention (``attention_impl="xla"``), both
# bf16 on the card: the kernels round p and o at other places (0.005 to
# 0.011 measured, CFG 3 + STG 1 + Heun included).
KERNEL_PATH_TOL = 0.02
# dense bf16 tensor-core peak, memory rate, dense int8 tensor-core peak and
# f32 peak outside the tensor cores, NVIDIA data sheets (SXM)
PEAKS = {"H200": (989e12, 4.8e12, 1979e12, 67e12),
         "H100": (989e12, 3.35e12, 1979e12, 67e12)}
# The int8 kernels. w8a8_matmul and its plain version round each f32 step
# of the dequant alike, so they agree exactly; the limit is one bf16 ulp of
# the case's largest output all the same. The row-quant kernels: the scales
# within rtol 1e-6 and the int8 at most one level apart on at most
# LEVEL_FRACTION of the elements (a sum of squares taken in another order,
# or a transcendental an ulp apart, moves an element across a rounding
# boundary).
SCALE_RTOL = 1e-6
LEVEL_FRACTION = 1e-3
# The f32 variants of the attention kernels against their plain versions in
# f32 (TF32 off): within 1e-5 of the case's largest output. The kernels
# multiply through a 3xTF32 split (about 2^-22 relative per product, sums
# in f32 in another order); one-pass TF32 (2^-11) would miss it by far.
F32_REL_TOL = 1e-5
# and their lse (values of O(10), f32 sums in another order)
LSE_TOL_F32 = 1e-4
# The Hopper kernel (csrc/flash_forward_sm90.cu) replaces C, D and E at bf16
# with head dim 64 or 128; every other (type, head dim) runs the WMMA tile code
SM90_SOURCE = "avatar_tpu_torch/csrc/flash_forward_sm90.cu"
WMMA_SOURCE = "avatar_tpu_torch/csrc/flash_forward.cu"
# A at bf16 with head dim 64 or 128 runs csrc/rope_attention_sm90.cu, every
# other case csrc/rope_attention.cu
ROPE_SM90_SOURCE = "avatar_tpu_torch/csrc/rope_attention_sm90.cu"
ROPE_WMMA_SOURCE = "avatar_tpu_torch/csrc/rope_attention.cu"
# B at bf16 with head dim 64 or 128 runs csrc/token_attention_sm90.cu, every
# other case csrc/token_attention.cu
TOKEN_SM90_SOURCE = "avatar_tpu_torch/csrc/token_attention_sm90.cu"
TOKEN_WMMA_SOURCE = "avatar_tpu_torch/csrc/token_attention.cu"
# A and B on a bf16 path at head dim 64: every launch on the Hopper kernels
TOKEN_MAJOR_BF16 = ("rope_fused_attention", "rope_fused_attention_sm90",
                    "fused_token_attention", "fused_token_attention_sm90")
# ... and csrc/flash_backward_sm90.cu the flash backward's two kernels (F)
SM90_BWD_SOURCE = "avatar_tpu_torch/csrc/flash_backward_sm90.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100", PEAKS["H100"]


def time_ms(fn, reps: int = 20, batches: int = 5) -> float:
    """Median over batches of the mean device time of ``reps`` back-to-back
    calls, from CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


class EventsMs(float):
    """A time per call that :func:`device_ms` took from CUDA events, host
    time included, because the profiler recorded no kernel."""


def mark_event_times(row: dict) -> dict:
    """Adds ``"<key>_source": "events"`` beside each time in ``row`` (and
    in the dicts it holds) that :func:`device_ms` took from CUDA events, so
    that such a number cannot pass for a device time."""
    for key, value in list(row.items()):
        if isinstance(value, dict):
            mark_event_times(value)
        elif isinstance(value, EventsMs):
            row[f"{key}_source"] = "events"
    return row


def device_ms(fn, match=None, reps: int = 20) -> float:
    """Mean device time per call of the kernels ``fn`` launches whose name
    holds ``match`` (every kernel when None), from torch.profiler: unlike
    :func:`time_ms`, no host time between launches, which a wrapper's few
    tens of microseconds of Python can exceed for a kernel that short.
    Where three profiling sessions record none of them, the time per call
    from CUDA events as an :class:`EventsMs`, which the kernels line marks
    (:func:`mark_event_times`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # a profiling session now and then records no kernel at all: it is
    # taken again, up to three times
    for _ in range(3):
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and (match is None or match in e.key))
        if total_us > 0:
            return total_us / reps / 1e3
    return EventsMs(time_ms(fn, reps=reps, batches=3))


def bound(flops: float, nbytes: float, peaks, op_rate=None):
    """The least time in ms for ``flops`` operations at ``op_rate`` (default
    the bf16 tensor-core peak) and ``nbytes`` at the memory rate."""
    t_ops, t_bytes = flops / (op_rate or peaks[0]), nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


class KernelErrors:
    """Max abs error of a kernel's output against its plain version's, case
    by case, each held to ``KERNEL_ULPS`` bf16 ulps of the case's largest
    reference output, or to ``rel`` times it where given (f32 variants:
    ``F32_REL_TOL``)."""

    def __init__(self, kernel, ulps=KERNEL_ULPS, rel=None):
        self.kernel, self.errs, self.tols = kernel, {}, {}
        self.rel = rel if rel is not None else ulps * 2.0**-7

    def add(self, label, out, ref):
        ref = ref.float()
        self.errs[label] = (out.float() - ref).abs().max().item()
        self.tols[label] = self.rel * ref.abs().max().item()

    def check(self):
        """Fails on a case above its limit; else the largest error and that
        case's limit."""
        bad = {k: (e, self.tols[k]) for k, e in self.errs.items()
               if not (math.isfinite(e) and e <= self.tols[k])}
        if bad:
            fail(f"{self.kernel} disagrees with its plain version (error, limit): {bad}")
        worst = max(self.errs, key=self.errs.get)
        return self.errs[worst], self.tols[worst]


def reset_counts() -> None:
    from avatar_tpu_torch.ops import causal_conv3d as cc
    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.ops import int8_matmul as i8

    fa.reset_launch_counts()
    i8.reset_launch_counts()
    cc.reset_launch_counts()


def read_counts() -> dict:
    """Launches of every kernel since :func:`reset_counts`."""
    from avatar_tpu_torch.ops import causal_conv3d as cc
    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.ops import int8_matmul as i8

    return {**fa.launch_counts, **i8.launch_counts, **cc.launch_counts}


def rms_rows(x):
    return x * (x.float().pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt().to(x.dtype)


def rope_inputs(g, batch, length, grid):
    """rms-normed q/k, v and split-half cos/sin for ``grid`` = (f, h, w)
    latent tokens, token-major bf16 on the card."""
    import torch

    from avatar_tpu_torch.ops.rope import (
        get_latent_coords, latent_to_pixel_coords, precompute_freqs_cis, split_freqs,
    )

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    coords = latent_to_pixel_coords(
        get_latent_coords(*grid, batch, device="cuda"), (8, 32, 32))
    coords[:, 0] /= 25.0
    cos, sin = split_freqs(precompute_freqs_cis(coords, WIDTH,
                                                out_dtype=torch.bfloat16))
    return (rms_rows(randn(batch, length, WIDTH)), rms_rows(randn(batch, length, WIDTH)),
            randn(batch, length, WIDTH), cos, sin)


def _rope_work(batch, length, width=WIDTH, itemsize=2):
    """(operations, bytes) of A: QK^T and PV over every head; q, k, v and o
    once each, cos and sin (half the width) once each."""
    return (4.0 * batch * length * length * width,
            (4 * batch * length * width + 2 * batch * length * (width // 2)) * itemsize)


def _wmma_rope_entry(dtype_name="bf16", defines=()):
    """A's WMMA kernel of csrc/rope_attention.cu called directly (no
    counter): to time it at the shapes the Hopper kernel took over from it."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa

    fn = fa._c_entry("rope_attention", f"rope_attention_{dtype_name}", 6, 4,
                     defines=defines)

    def call(q, k, v, cos, sin, out, heads, scale, bounded):
        b, length, c = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                 out.data_ptr(), b, length, heads, c // heads, float(scale), int(bounded),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"rope_attention_{dtype_name} (WMMA) failed with {err}")
    return call


# The inference CLI's latent grids (frames, height, width) at its default
# 192 x 320: one pass of 121 frames, a window of 97 frames, and the
# multi-scale passes at 128 x 192 and 256 x 384 (121 frames)
CLI_GRIDS = {"one pass": (16, 6, 10), "window": (13, 6, 10),
             "multi-scale first pass": (16, 4, 6), "multi-scale second pass": (16, 8, 12)}


def dit_routes(tokens: int, caption: int):
    """[(counter, implementation)] of one block of the 2B DiT (bf16, 32
    heads of 64, q/k-normed: bounded logits) at ``tokens`` self-attention
    tokens and ``caption`` caption keys, self-attention first, as
    ``models/dit.py:_attention``'s route predicates name them: A where
    ``rope_fused_supports`` holds, else the head-major forward mode of
    ``flash_mode``; B where ``fused_supports`` holds, else the same."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa

    bf16 = torch.bfloat16
    if fa.rope_fused_supports(tokens, HEADS, HEAD_DIM, bf16):
        routes = [("rope_fused_attention", fa.rope_impl(bf16, HEAD_DIM))]
    else:
        mode = fa.flash_mode(tokens, tokens, True)
        routes = [(f"flash_{mode}", fa.forward_impl(mode, bf16, HEAD_DIM))]
    if fa.fused_supports(tokens, caption, HEADS, HEAD_DIM, bf16):
        return routes + [("fused_token_attention", fa.token_impl(bf16, HEAD_DIM))]
    mode = fa.flash_mode(tokens, caption, True)
    return routes + [(f"flash_{mode}", fa.forward_impl(mode, bf16, HEAD_DIM))]


def cli_shapes(counter: str):
    """The attention calls of the CLI phases that ``dit_routes`` sends to
    ``counter``: [(label, tokens, keys, grid)], keys the tokens for the
    self-attention and the 256 caption keys (200 kept, as the ``t5``
    phase's prompt) for the cross-attention."""
    out = []
    for label, grid in CLI_GRIDS.items():
        n = math.prod(grid)
        (self_name, _), (cross_name, _) = dit_routes(n, CAPTION)
        if self_name == counter:
            out.append((f"cli {label} self {n}", n, n, grid))
        if cross_name == counter:
            out.append((f"cli {label} cross {n}x{CAPTION}", n, CAPTION, grid))
    return out


# A's shapes on the driven paths: (batch, tokens, grid) of the short path,
# the guided path's three conds, the training forward and the long path's
# length (which the reference's 6 MiB cap sends to C instead)
ROPE_SHAPES = {"832": (1, TOKENS, (13, 8, 8)), "batch 3": (3, TOKENS, (13, 8, 8)),
               "train 8x480": (8, 480, (8, 6, 10)),
               f"{LONG_TOKENS}": (1, LONG_TOKENS, LONG_GRID)}


def check_rope_kernel(peaks):
    """A on the Hopper kernel (bf16, head dim 64 and 128) against its plain
    version, bounded and unbounded (the two-pass whole-row max): the short
    path's 832 tokens, the guided batch 3, the training batch 8 x 480, a
    ragged L = 80, the largest length the reference's cap admits (1248) and
    the CLI phases' lengths that reach A (``cli_shapes``); every call must
    launch ``rope_fused_attention_sm90``. Then at each shape of ROPE_SHAPES,
    the CLI's and at head dim 128: the kernel's time, the bound
    and its fraction, ``scaled_dot_product_attention`` on q and k rotated
    beforehand (head-major, contiguous), and the WMMA kernel it replaces on
    the same inputs; the plain version's time at 832 tokens."""
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.ops.rope import apply_rotary_emb_split

    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(length, grid, batch=1):
        return rope_inputs(g, batch, length, grid)

    def d128(args):
        # the same tensors read as 16 heads of 128
        return args, 16, 128**-0.5

    main = inputs(TOKENS, (13, 8, 8))
    scale = HEAD_DIM**-0.5
    cases = {
        "832": (main, HEADS, scale),
        "batch 3": (inputs(TOKENS, (13, 8, 8), batch=3), HEADS, scale),
        "train 8x480": (inputs(480, (8, 6, 10), batch=8), HEADS, scale),
        # lengths that are not multiples of the 128-row tile
        "ragged L=80": (inputs(80, (5, 4, 4)), HEADS, scale),
        "L=1248": (inputs(1248, (13, 12, 8)), HEADS, scale),
        "d=128 832": d128(main),
        "d=128 ragged L=80, batch 2": d128(inputs(80, (5, 4, 4), batch=2)),
    }
    # the CLI phases' self-attention that the route predicates send to A
    cli = {label: (1, n, grid) for label, n, _, grid in cli_shapes("rope_fused_attention")}
    cases.update({label: (inputs(n, grid), HEADS, scale) for label, (_, n, grid) in cli.items()})
    errors = KernelErrors("rope_fused_attention_sm90")
    for label, (args, heads, sc) in cases.items():
        for bounded in (True, False):
            before = dict(fa.launch_counts)
            out = fa.rope_fused_attention(*args, heads, sc, bounded)
            torch.cuda.synchronize()
            launched = {n: c - before[n] for n, c in fa.launch_counts.items()
                        if c > before[n]}
            if launched != {"rope_fused_attention": 1, "rope_fused_attention_sm90": 1}:
                fail(f"rope {label}: launched {launched}, expected the Hopper kernel")
            ref = fa._rope_attention_plain(*args, heads, sc, bounded)
            errors.add(f"{label}, bounded={bounded}", out, ref)
            del out, ref
    err, tol = errors.check()

    wmma64, wmma128 = _wmma_rope_entry(), _wmma_rope_entry(defines=("ATTN_D=128",))

    def timings(args, heads, sc, wmma):
        q, k, v, cos, sin = args
        b, length, c = q.shape
        d = c // heads

        def head_major(t):
            return fa.split_to_head_major(t, heads).reshape(b, length, heads, d
                                                            ).transpose(1, 2).contiguous()

        qh = head_major(apply_rotary_emb_split(q, (cos, sin)))
        kh = head_major(apply_rotary_emb_split(k, (cos, sin)))
        vh = v.reshape(b, length, heads, d).transpose(1, 2).contiguous()
        out = torch.empty_like(q)

        def call():
            return fa.rope_fused_attention(q, k, v, cos, sin, heads, sc, True)

        ms = device_ms(call, "rope_sm90_kernel")
        bound_ms, bound_by = bound(*_rope_work(b, length), peaks)
        res = {"ms": ms, "ms_per_call_events": time_ms(call), "bound_ms": bound_ms,
               "bound_by": bound_by, "fraction_of_bound": bound_ms / ms,
               "library_ms": device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
               "wmma_ms_same_inputs": device_ms(
                   lambda: wmma(q, k, v, cos, sin, out, heads, sc, True),
                   "rope_attention_kernel", reps=5)}
        res["wmma_over_sm90"] = res["wmma_ms_same_inputs"] / ms
        res["sm90_over_library"] = ms / res["library_ms"]
        return res

    shapes = {}
    for label, (b, length, grid) in {**ROPE_SHAPES, **cli}.items():
        args = main if label == "832" else (
            cases[label][0] if label in cli else inputs(length, grid, batch=b))
        shapes[label] = timings(args, HEADS, scale, wmma64)
        if length == LONG_TOKENS:
            # what the long path runs instead (the reference's 6 MiB cap):
            # RoPE and the head-major relayout in plain code, then C on views
            q, k, v, cos, sin = args

            def rope_pass():
                return [fa.split_to_head_major(apply_rotary_emb_split(t, (cos, sin)), HEADS)
                        for t in (q, k)]

            def split(t):
                return t.reshape(b, length, HEADS, HEAD_DIM).transpose(1, 2)

            rq, rk = rope_pass()
            shapes[label]["plain_rope_pass_ms"] = time_ms(rope_pass)
            shapes[label]["c_on_rotated_views_ms"] = time_ms(lambda: fa.flash_attention(
                split(rq), split(rk), split(v), scale=scale, bounded_logits=True))
            del q, k, v, cos, sin, rq, rk
        del args
    shapes["d=128 832"] = timings(main, 16, 128**-0.5, wmma128)
    q, k, v, cos, sin = main
    plain_ms = time_ms(lambda: fa._rope_attention_plain(
        q, k, v, cos, sin, HEADS, scale, True), reps=5, batches=3)
    top = shapes["832"]
    row = {"name": "rope_fused_attention_sm90", "route": "cuda", "source": ROPE_SM90_SOURCE,
           "replaces": "avatar_tpu/ops/flash_attention.py:729",
           "max_abs_err": err, "tol": tol, "ms": top["ms"], "plain_ms": plain_ms,
           "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
           "library_ms": top["library_ms"]}
    emit({"phase": "kernel_rope_fused_attention", "errors": errors.errs,
          "limits": errors.tols, "plain_ms_832": plain_ms, "shapes": shapes})
    return row


def _kept_keys(b, lk, mask):
    """Keys the [b, lk] keep-mask keeps over the batch (all without one)."""
    return b * lk if mask is None else float((mask > 0.5).sum())


def _token_work(b, lq, lk, mask, c=WIDTH, itemsize=2):
    """(operations, bytes) of B over the keys this mask keeps: QK^T and PV
    per kept key; q, o and the mask once each, k and v of the kept keys."""
    kept = _kept_keys(b, lk, mask)
    nbytes = (2 * b * lq + 2 * kept) * c * itemsize + (0 if mask is None else b * lk * 4)
    return 4.0 * lq * c * kept, nbytes


def _wmma_token_entry(dtype_name="bf16", defines=()):
    """B's WMMA kernel of csrc/token_attention.cu called directly (no
    counter): to time it at the shapes the Hopper kernel took over from it."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa

    fn = fa._c_entry("token_attention", f"token_attention_{dtype_name}", 5, 5,
                     defines=defines)

    def call(q, k, v, mask, out, heads, scale, bounded):
        b, lq, c = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(), b, lq,
                 k.shape[1], heads, c // heads, float(scale), int(bounded),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"token_attention_{dtype_name} (WMMA) failed with {err}")
    return call


# B's shapes on the driven paths: (batch, queries, kept caption keys per
# sample; 0 a fully masked sample): the short path, the guided path's three
# conds (the first with fewer keys), the long path and the training batch
# with one sample's caption masked; each over the 256 caption keys
TOKEN_SHAPES = {"832x256": (1, TOKENS, (200,)), "batch 3": (3, TOKENS, (120, 200, 200)),
                f"{LONG_TOKENS}x256": (1, LONG_TOKENS, (200,)),
                "train 8x480x256": (8, 480, (200,) * 7 + (0,))}


def check_token_kernel(peaks):
    """B on the Hopper kernel (bf16, head dim 64 and 128) against its plain
    version, bounded and unbounded (the two-pass whole-row max), with and
    without a mask, at every shape of TOKEN_SHAPES and of the CLI phases
    that reach B (``cli_shapes``), a ragged Lk = 77 with a fully masked
    sample, Lk = 512 (four key tiles) and head dim 128; every call must
    launch ``fused_token_attention_sm90`` and a fully masked sample must be
    0. Then at each shape of TOKEN_SHAPES and the CLI's, and at head dim
    128: the kernel's device time, the WMMA kernel it replaced on the same
    inputs (through its C entry), ``scaled_dot_product_attention`` on head-major contiguous
    copies with the same keep-mask (all three by the profiler's device
    time, each also by CUDA events), and the bound over the kept keys; the
    plain version's time at 832 tokens."""
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(1)
    scale = HEAD_DIM**-0.5

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    def inputs(b, lq, kept, lk=CAPTION):
        mask = torch.ones(b, lk, device="cuda")
        for i, n in enumerate(kept):
            mask[i, n:] = 0.0
        return (rms_rows(randn(b, lq, WIDTH)), rms_rows(randn(b, lk, WIDTH)),
                randn(b, lk, WIDTH), mask)

    shapes = {label: inputs(b, lq, kept) for label, (b, lq, kept) in TOKEN_SHAPES.items()}
    # the CLI phases' cross-attention that the route predicates send to B
    shapes.update({label: inputs(1, n, (T5_KEPT[0],), lk=lk)
                   for label, n, lk, _ in cli_shapes("fused_token_attention")})
    q, k, v, mask = shapes["832x256"]
    cases = {label: (args, HEADS, scale) for label, args in shapes.items()}
    cases.update({
        "mask=False": ((q, k, v, None), HEADS, scale),
        "ragged Lk=77, masked sample": (inputs(2, 96, (50, 0), lk=77), HEADS, scale),
        "Lk=512": (inputs(2, 1024, (512, 300), lk=512), HEADS, scale),
        "d=128 832x256": ((q, k, v, mask), 16, 128**-0.5),
        "d=128 train 8x480x256": (shapes["train 8x480x256"], 16, 128**-0.5),
        # train_audio's cross-attention at T = 80 (the per-sample audio
        # frames kept), train_full_remat's self-attention (no mask)
        "train audio 8x480x80": (inputs(TRAIN_BATCH, TRAIN_TOKENS, AUDIO_FRAMES["T80"],
                                        lk=80), HEADS, scale),
        "train full self 8x480": (inputs(TRAIN_BATCH, TRAIN_TOKENS, (), lk=TRAIN_TOKENS)[:3]
                                  + (None,), HEADS, scale),
    })
    errors = KernelErrors("fused_token_attention_sm90")
    for label, (args, heads, sc) in cases.items():
        for bounded in (True, False):
            before = dict(fa.launch_counts)
            out = fa.fused_token_attention(*args, heads, sc, bounded)
            torch.cuda.synchronize()
            launched = {n: c - before[n] for n, c in fa.launch_counts.items()
                        if c > before[n]}
            if launched != {"fused_token_attention": 1, "fused_token_attention_sm90": 1}:
                fail(f"token {label}: launched {launched}, expected the Hopper kernel")
            mask_ = args[3]
            if mask_ is not None:
                empty = (mask_ <= 0.5).all(dim=1)
                if not bool((out[empty] == 0).all()):
                    fail(f"fused_token_attention_sm90 {label}: a fully masked row is not 0")
            errors.add(f"{label}, bounded={bounded}", out,
                       fa._token_attention_plain(*args, heads, sc, bounded))
            del out
    err, tol = errors.check()

    wmma = {64: _wmma_token_entry(), 128: _wmma_token_entry(defines=("ATTN_D=128",))}

    def timings(args, heads, sc):
        q, k, v, mask = args
        b, lq, c = q.shape
        lk, d = k.shape[1], c // heads

        def head_major(t):
            return t.reshape(b, -1, heads, d).transpose(1, 2).contiguous()

        qh, kh, vh = head_major(q), head_major(k), head_major(v)
        keep = (mask > 0.5)[:, None, None, :]
        out = torch.empty_like(q)

        def call():
            return fa.fused_token_attention(q, k, v, mask, heads, sc, True)

        def wmma_call():
            return wmma[d](q, k, v, mask, out, heads, sc, True)

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep)

        ms = device_ms(call, "token_sm90_kernel")
        bound_ms, bound_by = bound(*_token_work(b, lq, lk, mask, c), peaks)
        res = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "fraction_of_bound": bound_ms / ms,
               "wmma_ms_same_inputs": device_ms(wmma_call, "token_attention_kernel"),
               "library_ms": device_ms(library),
               "events_ms": time_ms(call), "wmma_events_ms": time_ms(wmma_call),
               "library_events_ms": time_ms(library)}
        res["wmma_over_sm90"] = res["wmma_ms_same_inputs"] / ms
        res["sm90_over_library"] = ms / res["library_ms"]
        return res

    times = {label: timings(args, HEADS, scale) for label, args in shapes.items()}
    times["d=128 832x256"] = timings((q, k, v, mask), 16, 128**-0.5)
    times["Lk=512 1024 queries"] = timings(cases["Lk=512"][0], HEADS, scale)
    plain_ms = time_ms(lambda: fa._token_attention_plain(
        q, k, v, mask, HEADS, scale, True), reps=5, batches=3)
    top = times["832x256"]
    row = {"name": "fused_token_attention_sm90", "route": "cuda", "source": TOKEN_SM90_SOURCE,
           "replaces": "avatar_tpu/ops/flash_attention.py:611",
           "max_abs_err": err, "tol": tol, "ms": top["ms"], "plain_ms": plain_ms,
           "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
           "library_ms": top["library_ms"]}
    emit({"phase": "kernel_fused_token_attention", "errors": errors.errs,
          "limits": errors.tols, "plain_ms_832": plain_ms, "shapes": times})
    return row


FLASH_KERNELS = {
    # mode: (row name and implementation counter, TPU kernel it replaces,
    # bounded_logits, source)
    "bounded": ("flash_bounded_sm90", "avatar_tpu/ops/flash_attention.py:241", True,
                SM90_SOURCE),
    "online": ("flash_online_sm90", "avatar_tpu/ops/flash_attention.py:140", False,
               SM90_SOURCE),
    "single": ("flash_single_sm90", "avatar_tpu/ops/flash_attention.py:387", False,
               SM90_SOURCE),
}
# E's shapes on the driven paths: every backward recompute of the training
# step (self-attention over 480 tokens; cross-attention to 256 caption keys
# with 200 kept and one sample's caption fully masked), and a DiT-like
# single-block self-attention
SINGLE_SHAPES = ("637x637", "train self 8x480", "train cross 8x480x256")


def _attention_work(b, h, lq, lk, d, itemsize=2):
    """(operations, bytes) of a head-major attention forward: QK^T and PV,
    q, k, v and o once each in ``itemsize`` bytes and the f32 lse."""
    return 4.0 * b * h * lq * lk * d, (2 * lq + 2 * lk) * b * h * d * itemsize + b * h * lq * 4


def plain_forward(q, k, v, mask, scale, mode):
    """The plain version of a ``_flash_forward`` mode, fed q and the scale
    as the wrapper feeds its kernel (``fold_scale``)."""
    from avatar_tpu_torch.ops import flash_attention as fa

    q, scale = fa.fold_scale(q, scale)
    return fa._flash_plain(q, k, v, mask, scale, mode)


def _wmma_entry(mode, defines=()):
    """The bf16 WMMA kernel of csrc/flash_forward.cu (the bf16 / 64 build,
    or ``defines``) called directly (no counter): to time it at the shapes
    the Hopper kernel took over from it."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa

    fn = fa._c_entry("flash_forward", f"flash_{mode}_bf16", 6, 5, bounded_flag=False,
                     defines=defines)

    def call(q, k, v, out, lse, mask=None):
        b, h, lq, d = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if mask is None else mask.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, h, lq, k.shape[2], d, 1.0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"flash_{mode}_bf16 (WMMA) failed with {err}")
    return call


def _forward_work(q, k, mask):
    """(operations, bytes) of a head-major attention forward over the keys
    this mask keeps: QK^T and PV per kept key; q, o, the mask and the f32
    lse once each, k and v of the kept keys."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    kept = _kept_keys(b, lk, mask)
    nbytes = (2 * b * lq + 2 * kept) * h * d * 2 + b * h * lq * 4 + (
        0 if mask is None else b * lk * 4)
    return 4.0 * h * lq * d * kept, nbytes


def check_flash_kernel(mode, peaks):
    """One forward kernel (head-major, O and lse) on the Hopper kernel
    against its plain version: unmasked, masked (a tail and a band of
    keys), a fully masked batch row, ragged lengths, head dim 128 and q, k,
    v as head-major views of token-major tensors (read in place), and the
    CLI phases' shapes that reach this mode (``cli_shapes``); the
    whole-row mode (E) also at the training shapes, the caption's with a
    fully masked sample. Then the times at its
    main-path shapes (E: SINGLE_SHAPES and the CLI's): the kernel, the WMMA
    kernel it replaces on the same inputs, ``scaled_dot_product_attention``,
    the bound and its fraction, and at head dim 128; the plain version's
    time; for C and D also the kernel on transposed views and at the CLI's
    shapes (kernel and bound)."""
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import flash_attention as fa

    row_name, replaces, bounded, source = FLASH_KERNELS[mode]
    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    def qkv(b, lq, lk, d=HEAD_DIM, token_major=False):
        # per-head rms-normed rows: logits of O(1), as after the qk-norm
        heads = WIDTH // d
        if token_major:
            return (rms_rows(randn(b, lq, heads, d)).transpose(1, 2),
                    rms_rows(randn(b, lk, heads, d)).transpose(1, 2),
                    randn(b, lk, heads, d).transpose(1, 2))
        return (rms_rows(randn(b, heads, lq, d)), rms_rows(randn(b, heads, lk, d)),
                randn(b, heads, lk, d))

    def keep_mask(b, lk, kept, empty_row=None, band=None):
        m = torch.ones(b, lk, device="cuda")
        m[0, kept:] = 0.0
        if band is not None:
            m[:, band[0]:band[1]] = 0.0
        if empty_row is not None:
            m[empty_row] = 0.0
        return m

    def audio_mask(kept, lk):
        m = torch.ones(len(kept), lk, device="cuda")
        for i, n in enumerate(kept):
            m[i, n:] = 0.0
        return m

    long_len = LONG_TOKENS
    if mode == "single":
        main = qkv(1, 637, 637)
        # the training cross-attention: 200 caption keys kept, the last
        # sample's caption fully masked
        cross_mask = keep_mask(TRAIN_BATCH, CAPTION, 200, TRAIN_BATCH - 1)
        cross_mask[:, 200:] = 0.0
        shaped = {"637x637": (main, None), "train self 8x480": (qkv(8, 480, 480), None),
                  "train cross 8x480x256": (qkv(8, 480, CAPTION), cross_mask)}
        cases = {
            "637x637": (main, None, None),
            "637x637 masked": (main, keep_mask(1, 637, 500), None),
            "train self 8x480": (shaped["train self 8x480"][0], None, None),
            "train cross 8x480x256, masked sample": (
                shaped["train cross 8x480x256"][0], cross_mask, TRAIN_BATCH - 1),
            "1024x256 ragged mask, masked row": (
                qkv(2, 1024, 256), keep_mask(2, 256, 200, 1), 1),
            "100x77 ragged": (qkv(1, 100, 77), None, None),
            "637x700 transposed views, band, masked row": (
                qkv(2, 637, 700, token_major=True), keep_mask(2, 700, 600, 1, (40, 90)), 1),
            "d=128 637x637": (qkv(1, 637, 637, 128), None, None),
            "d=128 8x480x256, masked sample": (qkv(8, 480, CAPTION, 128), cross_mask,
                                               TRAIN_BATCH - 1),
            "d=128 1000x900 transposed views, band, masked row": (
                qkv(2, 1000, 900, 128, True), keep_mask(2, 900, 800, 1, (100, 300)), 1),
            # train_audio's cross-attention at T = 86, each sample's audio
            # frames kept, on the DiT's head-major views
            "train audio cross 8x480x86": (
                qkv(TRAIN_BATCH, TRAIN_TOKENS, 86, token_major=True),
                audio_mask(AUDIO_FRAMES["T86"], 86), None),
        }
    else:
        main = qkv(1, long_len, long_len)
        main128 = qkv(1, long_len, long_len, 128)
        views = qkv(1, long_len, long_len, token_major=True)
        cases = {
            f"{long_len}x{long_len}": (main, None, None),
            f"{long_len}x{long_len} masked tail and band": (
                main, keep_mask(1, long_len, 5000, band=(2000, 2500)), None),
            f"{long_len}x{long_len} transposed views": (views, None, None),
            "5000x333 ragged, masked row": (
                qkv(2, 5000, 333), keep_mask(2, 333, 300, 1), 1),
            f"d=128 {long_len}x{long_len}": (main128, None, None),
            "d=128 5000x333 ragged, band, masked row": (
                qkv(2, 5000, 333, 128), keep_mask(2, 333, 300, 1, (40, 90)), 1),
        }
    # the CLI phases' attention that the route predicates send to this mode:
    # q, k, v as the DiT hands them over (head-major views of token-major
    # tensors), the caption's keys with the prompt's mask
    mode_counter = f"flash_{mode}"
    cli = {label: (qkv(1, n, lk, token_major=True),
                   None if lk == n else keep_mask(1, lk, T5_KEPT[0]))
           for label, n, lk, _ in cli_shapes(mode_counter)}
    cases.update({label: (args, mask, None) for label, (args, mask) in cli.items()})
    errors, lse_errs = KernelErrors(f"flash {mode}"), {}
    for label, ((q, k, v), mask, empty_row) in cases.items():
        d = q.shape[-1]
        scale = d**-0.5
        if fa.flash_mode(q.shape[2], k.shape[2], bounded) != mode:
            fail(f"{label}: dispatch would not reach the {mode} kernel")
        before = dict(fa.launch_counts)
        out, lse = fa.flash_attention(q, k, v, kv_mask=mask, scale=scale,
                                      bounded_logits=bounded, with_lse=True)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
        if launched != {mode_counter: 1, row_name: 1}:
            fail(f"{label}: launched {launched}, expected {row_name}")
        ref, ref_lse = plain_forward(q, k, v, mask, scale, mode)
        errors.add(label, out, ref)
        live = ref_lse < 1e29
        lse_errs[label] = (lse - ref_lse)[live].abs().max().item()
        if not bool((lse[~live] == fa.LSE_MASKED).all()):
            fail(f"{label}: lse of a fully masked row is not {fa.LSE_MASKED}")
        if empty_row is not None and not (
                bool((out[empty_row] == 0).all()) and not bool(live[empty_row].any())):
            fail(f"{label}: a fully masked batch row is not O = 0, lse = 1e30")
        del out, lse, ref, ref_lse
    (err, tol), lse_err = errors.check(), max(lse_errs.values())
    if not (math.isfinite(lse_err) and lse_err <= LSE_TOL):
        fail(f"flash {mode}: lse disagrees with its plain version's: {lse_errs}")

    q, k, v = main
    b, h, lq, d = q.shape
    scale = d**-0.5

    def kernel_ms(q_, k_, v_):
        return time_ms(lambda: fa.flash_attention(q_, k_, v_, scale=q_.shape[-1]**-0.5,
                                                  bounded_logits=bounded))

    plain_ms = time_ms(lambda: fa._flash_plain(q * scale, k, v, None, 1.0, mode),
                       reps=5, batches=3)
    flops, nbytes = _attention_work(b, h, lq, lq, d)
    if mode == "single":
        wmma64, wmma128 = _wmma_entry(mode), _wmma_entry(mode, ("ATTN_D=128",))

        def timings(q_, k_, v_, mask, wmma):
            b_, h_, lq_, d_ = q_.shape
            sc = d_**-0.5
            # the WMMA kernel reads contiguous tensors (its route copies views)
            qs, kc, vc = (q_ * sc).contiguous(), k_.contiguous(), v_.contiguous()
            out = torch.empty_like(qs)
            lse = torch.empty(b_, h_, lq_, device="cuda")
            keep = None if mask is None else (mask > 0.5)[:, None, None, :]

            def call():
                return fa.flash_attention(q_, k_, v_, kv_mask=mask, scale=sc)

            # the kernel alone: the call also folds the scale into q
            ms_ = device_ms(call, "flash_sm90_kernel")
            bound_ms_, bound_by_ = bound(*_forward_work(q_, k_, mask), peaks)
            res = {"shape": list(q_.shape) + [k_.shape[2]], "ms": ms_,
                   "ms_per_call_events": time_ms(call), "bound_ms": bound_ms_,
                   "bound_by": bound_by_, "fraction_of_bound": bound_ms_ / ms_,
                   "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
                       q_, k_, v_, attn_mask=keep)),
                   "wmma_ms_same_inputs": device_ms(
                       lambda: wmma(qs, kc, vc, out, lse, mask), "flash_forward_kernel",
                       reps=5)}
            res["wmma_over_sm90"] = res["wmma_ms_same_inputs"] / ms_
            res["sm90_over_library"] = ms_ / res["library_ms"]
            return res

        shaped.update(cli)
        shapes = {label: timings(*shaped[label][0], shaped[label][1], wmma64)
                  for label in (*SINGLE_SHAPES, *cli)}
        shapes["d=128 637x637"] = timings(*cases["d=128 637x637"][0], None, wmma128)
        shapes["d=128 8x480x256, masked sample"] = timings(
            *cases["d=128 8x480x256, masked sample"][0], cross_mask, wmma128)
        top = shapes["637x637"]
        ms, lib_ms = top["ms"], top["library_ms"]
        bound_ms, bound_by = top["bound_ms"], top["bound_by"]
        extra = {"shapes": shapes, "fraction_of_bound": bound_ms / ms}
    else:
        ms = kernel_ms(q, k, v)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        bound_ms, bound_by = bound(flops, nbytes, peaks)
        # the same inputs through the WMMA kernel it replaces (scale folded)
        qs, out = q * scale, torch.empty_like(q)
        lse = torch.empty(b, h, lq, device="cuda")
        wmma = _wmma_entry(mode)
        q128, k128, v128 = main128
        lib128 = time_ms(lambda: F.scaled_dot_product_attention(q128, k128, v128))
        # the copies the WMMA route makes per call on the DiT's views: q,
        # k, v to contiguous head-major, and O back to token-major
        o_head_major = torch.empty(views[0].shape, device="cuda", dtype=torch.bfloat16)
        extra = {
            "ms_transposed_views": kernel_ms(*views),
            "relayout_copies_ms_avoided_per_call": time_ms(lambda: [
                t.contiguous() for t in views] + [o_head_major.transpose(1, 2).contiguous()]),
            "ms_d128": kernel_ms(q128, k128, v128),
            "library_ms_d128": lib128,
            "bound_ms_d128": bound(*_attention_work(*q128.shape[:3], lq, 128), peaks)[0],
            "wmma_ms_same_inputs": time_ms(lambda: wmma(qs, k, v, out, lse), reps=5, batches=3),
            "fraction_of_bound": bound_ms / ms,
            "shapes": {label: {
                "shape": list(q_.shape) + [k_.shape[2]],
                "ms": time_ms(lambda: fa.flash_attention(
                    q_, k_, v_, kv_mask=m_, scale=scale, bounded_logits=bounded)),
                "bound_ms": bound(*_forward_work(q_, k_, m_), peaks)[0]}
                for label, ((q_, k_, v_), m_) in cli.items()},
        }
        del qs, out, lse
    row = {"name": row_name, "route": "cuda", "source": source, "replaces": replaces,
           "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
           "lse_tol": LSE_TOL, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_ms}
    emit({"phase": f"kernel_{row_name}", "shape": list(q.shape), "errors": errors.errs,
          "limits": errors.tols, "lse_errors": lse_errs, "lse_tol": LSE_TOL, "ms": ms,
          "plain_ms": plain_ms, "library_ms": lib_ms, "bound_us": bound_ms * 1e3,
          "bound_by": bound_by, "flops": flops, "bytes": nbytes, **extra})
    return row


WMMA_ROWS = {"bounded": ("flash_bounded_wmma", "avatar_tpu/ops/flash_attention.py:241"),
             "online": ("flash_online_wmma", "avatar_tpu/ops/flash_attention.py:140")}
# dense TF32 tensor-core peak (NVIDIA data sheet, SXM); the f32 variants
# multiply through 3xTF32, three TF32 products per product
TF32_PEAK = 495e12
# B's f32 row: the short path's cross-attention in f32
TOKEN_MAJOR_F32_SHAPE = f"[1, {TOKENS}, {WIDTH}] x {CAPTION} keys, 200 kept"


def check_wmma_rows(peaks):
    """C and D on the WMMA route, which the f32 variants and the bf16 head
    dims other than 64 and 128 take: at f32 [1, 32, 5376, 64] against the
    plain version in f32 (F32_REL_TOL, lse within LSE_TOL_F32), then the
    kernel's time, the plain version's, ``scaled_dot_product_attention``'s
    in f32 and the bound (the algorithm's operations as three TF32
    products each at the TF32 peak, f32 bytes)."""
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn(3, 1, HEADS, LONG_TOKENS, HEAD_DIM, generator=g, device="cuda")
    q, k, v = x * (x.pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt()
    v = torch.randn(v.shape, generator=g, device="cuda")
    del x
    scale = HEAD_DIM**-0.5
    flops, nbytes = _attention_work(1, HEADS, LONG_TOKENS, LONG_TOKENS, HEAD_DIM, 4)
    bound_ms, bound_by = bound(3 * flops, nbytes, peaks, op_rate=TF32_PEAK)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), reps=5, batches=3)
    rows = []
    for mode, (name, replaces) in WMMA_ROWS.items():
        before = dict(fa.launch_counts)
        out, lse = fa.flash_attention(q, k, v, scale=scale, bounded_logits=mode == "bounded",
                                      with_lse=True)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
        if launched != {f"flash_{mode}": 1, name: 1}:
            fail(f"{name}: launched {launched}")
        ref, ref_lse = fa._flash_plain(q * scale, k, v, None, 1.0, mode)
        errors = KernelErrors(name, rel=F32_REL_TOL)
        errors.add(f"f32 {LONG_TOKENS}", out, ref)
        err, tol = errors.check()
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= LSE_TOL_F32:
            fail(f"{name}: lse error {lse_err} above {LSE_TOL_F32}")
        del out, lse, ref, ref_lse
        ms = time_ms(lambda m=mode: fa.flash_attention(q, k, v, scale=scale,
                                                       bounded_logits=m == "bounded"),
                     reps=5, batches=3)
        plain_ms = time_ms(lambda m=mode: fa._flash_plain(q * scale, k, v, None, 1.0, m),
                           reps=2, batches=3)
        row = {"name": name, "route": "cuda", "source": WMMA_SOURCE, "replaces": replaces,
               "max_abs_err": err, "tol": tol, "lse_max_abs_err": lse_err,
               "lse_tol": LSE_TOL_F32, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
               "shape": f"f32 [1, {HEADS}, {LONG_TOKENS}, {HEAD_DIM}]"}
        emit({"phase": f"kernel_{name}", **row, "flops": flops, "bytes": nbytes})
        rows.append(row)
    return rows + check_wmma_token_rows(peaks)


def check_wmma_token_rows(peaks):
    """A, B and E on the WMMA route, which the f32 variants and the bf16
    head dims other than 64 and 128 take (``rope_fused_attention_wmma``,
    ``fused_token_attention_wmma``, ``flash_single_wmma``): in f32 at their
    main-path shapes ([1, 832, 2048] for A, bounded; B over 256 caption keys
    with 200 kept; [1, 32, 637, 64] for E) against the plain versions in f32
    (F32_REL_TOL; E's lse within LSE_TOL_F32), then the kernel's time, the
    plain version's, ``scaled_dot_product_attention``'s in f32 and the bound
    (three TF32 products per product, f32 bytes)."""
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.ops.rope import apply_rotary_emb_split

    g = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    q, k, v, cos, sin = (t.float() for t in rope_inputs(g, 1, TOKENS, (13, 8, 8)))
    scale = HEAD_DIM**-0.5
    before = dict(fa.launch_counts)
    out = fa.rope_fused_attention(q, k, v, cos, sin, HEADS, scale, True)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    if launched != {"rope_fused_attention": 1, "rope_fused_attention_wmma": 1}:
        fail(f"rope_fused_attention_wmma: launched {launched}")
    errors = KernelErrors("rope_fused_attention_wmma", rel=F32_REL_TOL)
    errors.add(f"f32 {TOKENS}", out, fa._rope_attention_plain(q, k, v, cos, sin, HEADS,
                                                             scale, True))
    err, tol = errors.check()

    def head_major(t):
        return fa.split_to_head_major(t, HEADS).reshape(1, TOKENS, HEADS, HEAD_DIM
                                                        ).transpose(1, 2).contiguous()

    qh = head_major(apply_rotary_emb_split(q, (cos, sin)))
    kh = head_major(apply_rotary_emb_split(k, (cos, sin)))
    vh = v.reshape(1, TOKENS, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    flops, nbytes = _rope_work(1, TOKENS, itemsize=4)
    bound_ms, bound_by = bound(3 * flops, nbytes, peaks, op_rate=TF32_PEAK)
    row = {"name": "rope_fused_attention_wmma", "route": "cuda", "source": ROPE_WMMA_SOURCE,
           "replaces": "avatar_tpu/ops/flash_attention.py:729", "max_abs_err": err,
           "tol": tol,
           "ms": time_ms(lambda: fa.rope_fused_attention(q, k, v, cos, sin, HEADS, scale,
                                                         True), reps=5, batches=3),
           "plain_ms": time_ms(lambda: fa._rope_attention_plain(
               q, k, v, cos, sin, HEADS, scale, True), reps=2, batches=3),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
           "shape": f"f32 [1, {TOKENS}, {WIDTH}]"}
    emit({"phase": "kernel_rope_fused_attention_wmma", **row, "flops": flops,
          "bytes": nbytes})
    rows.append(row)

    tk, tv = k[:, :CAPTION], v[:, :CAPTION]
    tmask = torch.ones(1, CAPTION, device="cuda")
    tmask[0, 200:] = 0.0
    before = dict(fa.launch_counts)
    out = fa.fused_token_attention(q, tk, tv, tmask, HEADS, scale, False)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    if launched != {"fused_token_attention": 1, "fused_token_attention_wmma": 1}:
        fail(f"fused_token_attention_wmma: launched {launched}")
    errors = KernelErrors("fused_token_attention_wmma", rel=F32_REL_TOL)
    errors.add(f"f32 {TOKEN_MAJOR_F32_SHAPE}", out,
               fa._token_attention_plain(q, tk, tv, tmask, HEADS, scale, False))
    err, tol = errors.check()

    def head_major(t):
        return t.reshape(1, -1, HEADS, HEAD_DIM).transpose(1, 2).contiguous()

    qh, kh, vh = head_major(q), head_major(tk), head_major(tv)
    keep = (tmask > 0.5)[:, None, None, :]
    flops, nbytes = _token_work(1, TOKENS, CAPTION, tmask, itemsize=4)
    bound_ms, bound_by = bound(3 * flops, nbytes, peaks, op_rate=TF32_PEAK)
    row = {"name": "fused_token_attention_wmma", "route": "cuda",
           "source": TOKEN_WMMA_SOURCE, "replaces": "avatar_tpu/ops/flash_attention.py:611",
           "max_abs_err": err, "tol": tol,
           "ms": device_ms(lambda: fa.fused_token_attention(q, tk, tv, tmask, HEADS, scale,
                                                            False), "token_attention_kernel"),
           "plain_ms": time_ms(lambda: fa._token_attention_plain(
               q, tk, tv, tmask, HEADS, scale, False), reps=2, batches=3),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": device_ms(lambda: F.scaled_dot_product_attention(
               qh, kh, vh, attn_mask=keep)),
           "shape": f"f32 {TOKEN_MAJOR_F32_SHAPE}"}
    emit({"phase": "kernel_fused_token_attention_wmma", **row, "flops": flops,
          "bytes": nbytes})
    rows.append(row)

    x = torch.randn(3, 1, HEADS, 637, HEAD_DIM, generator=g, device="cuda")
    q, k, v = x * (x.pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt()
    v = torch.randn(v.shape, generator=g, device="cuda")
    mask = torch.ones(1, 637, device="cuda")
    mask[0, 500:] = 0.0
    before = dict(fa.launch_counts)
    out, lse = fa.flash_attention(q, k, v, kv_mask=mask, scale=scale, with_lse=True)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    if launched != {"flash_single": 1, "flash_single_wmma": 1}:
        fail(f"flash_single_wmma: launched {launched}")
    ref, ref_lse = fa._flash_plain(q * scale, k, v, mask, 1.0, "single")
    errors = KernelErrors("flash_single_wmma", rel=F32_REL_TOL)
    errors.add("f32 637, masked tail", out, ref)
    err, tol = errors.check()
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= LSE_TOL_F32:
        fail(f"flash_single_wmma: lse error {lse_err} above {LSE_TOL_F32}")
    flops, nbytes = _attention_work(1, HEADS, 637, 637, HEAD_DIM, 4)
    bound_ms, bound_by = bound(3 * flops, nbytes, peaks, op_rate=TF32_PEAK)
    row = {"name": "flash_single_wmma", "route": "cuda", "source": WMMA_SOURCE,
           "replaces": "avatar_tpu/ops/flash_attention.py:387", "max_abs_err": err,
           "tol": tol, "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL_F32,
           "ms": time_ms(lambda: fa.flash_attention(q, k, v, scale=scale), reps=5, batches=3),
           "plain_ms": time_ms(lambda: fa._flash_plain(q * scale, k, v, None, 1.0, "single"),
                               reps=2, batches=3),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
           "shape": f"f32 [1, {HEADS}, 637, {HEAD_DIM}]"}
    emit({"phase": "kernel_flash_single_wmma", **row, "flops": flops, "bytes": nbytes})
    rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# Every attention family at every (type, head dim) the reference admits
# ---------------------------------------------------------------------------

# sampled head dims of kernel_generality: bf16 (512 only for the head-major
# kernels C-G, whose reference predicates admit it) and f32
GENERALITY_DIMS = {"bf16": (32, 80, 128, 256, 512), "f32": (64, 128)}
ATTENTION_SOURCES = ("rope_attention", "token_attention", "flash_forward",
                     "flash_backward", "flash_dense")


def generality_specs():
    """The ``(source, defines)`` libraries that kernel_generality needs
    beyond the default build: one per (source, type, padded head dim)."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa

    specs = []
    for dtype_name, dims in GENERALITY_DIMS.items():
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
        for d in dims:
            for source in ATTENTION_SOURCES:
                if d > 256 and source in ("rope_attention", "token_attention"):
                    continue
                _, defines = fa.kernel_variant(dtype, d)
                specs.append((source, defines))
            if dtype == torch.bfloat16 and d in fa.SM90_HEAD_DIMS and d != 64:
                specs += [(source, fa.sm90_defines(d)) for source in (
                    "rope_attention_sm90", "token_attention_sm90", "flash_forward_sm90",
                    "flash_backward_sm90", "flash_dense_sm90")]
    return [spec for spec in dict.fromkeys(specs) if spec[1]]


def check_kernel_generality(builds, peaks):
    """Every attention family (A, B, C, D, E, F's dK/dV and dQ, G's four)
    at small ragged shapes with masks and a fully masked row, at bf16 with
    head dims 32, 80, 128, 256 (and 512 for C-G) and f32 with 64 and 128,
    each against its plain version: bf16 within the kernels' ulp gates, f32
    within F32_REL_TOL of the largest output. Each call must launch its
    kernel on the route :func:`forward_impl` names. ``builds`` is the
    future of the background build of :func:`generality_specs`; its
    libraries and seconds are printed. Then C and D at a DiT-like shape
    ([1, 2048 / d, 5376, d]) for each variant, one time each."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.ops import kernel_build

    t0 = time.perf_counter()
    builds.result()
    wait_s = time.perf_counter() - t0
    built = {kernel_build.label(*spec): kernel_build.build_seconds.get(kernel_build.label(*spec))
             for spec in generality_specs()}
    g = torch.Generator(device="cuda").manual_seed(31)
    results, times = {}, {}
    for dtype_name, dims in GENERALITY_DIMS.items():
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
        for d in dims:
            label = f"{dtype_name} d={d}"
            results[label] = _generality_case(g, fa, dtype, d)
            times[label] = _generality_times(g, fa, dtype, d)
    emit({"phase": "kernel_generality", "built_seconds": built,
          "build_wait_s": wait_s, "f32_rel_tol": F32_REL_TOL,
          "bf16_forward_ulps": KERNEL_ULPS, "bf16_backward_ulps": BWD_ULPS,
          "results": results, "times_ms_at_5376": times})


def _generality_case(g, fa, dtype, d):
    """Each family at one (dtype, head dim): returns {kernel: (max error,
    limit)}; fails on any case above its limit or a launch on another
    route."""
    import torch

    f32 = dtype == torch.float32
    heads = 2
    scale = d**-0.5

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def rows(*shape):
        x = torch.randn(shape, generator=g, device="cuda")
        return (x * (x.pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt()).to(dtype)

    def errors(name, ulps=KERNEL_ULPS):
        return KernelErrors(f"{name} ({dtype}, d={d})", ulps,
                            rel=F32_REL_TOL if f32 else None)

    def launched_by(fn, *args, **kw):
        before = dict(fa.launch_counts)
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}

    found = {}
    c = heads * d
    if d <= 256:
        if d % 16 == 0:
            # A: rope inside, ragged L = 80
            err = errors("rope_fused_attention")
            q, k, v = rows(2, 80, c), rows(2, 80, c), randn(2, 80, c)
            ang = torch.rand(2, 80, c // 2, generator=g, device="cuda") * 6.3
            cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
            for bounded in (True, False):
                out, got = launched_by(fa.rope_fused_attention, q, k, v, cos, sin, heads,
                                       scale, bounded)
                want = {"rope_fused_attention": 1,
                        f"rope_fused_attention_{fa.rope_impl(dtype, d)}": 1}
                if got != want:
                    fail(f"rope_fused_attention {dtype} d={d}: launched {got}, expected "
                         f"{want}")
                err.add(f"bounded={bounded}", out, fa._rope_attention_plain(
                    q, k, v, cos, sin, heads, scale, bounded))
            found[f"rope_fused_attention_{fa.rope_impl(dtype, d)}"] = err.check()
        # B: ragged Lk = 77, a partly and a fully masked sample
        err = errors("fused_token_attention")
        q, k, v = rows(3, 100, c), rows(3, 77, c), randn(3, 77, c)
        mask = torch.ones(3, 77, device="cuda")
        mask[1, 30:60] = 0.0
        mask[2] = 0.0
        impl = fa.token_impl(dtype, d)
        for bounded in (True, False):
            out, got = launched_by(fa.fused_token_attention, q, k, v, mask, heads, scale,
                                   bounded)
            want = {"fused_token_attention": 1, f"fused_token_attention_{impl}": 1}
            if got != want or not bool((out[2] == 0).all()):
                fail(f"fused_token_attention {dtype} d={d}: launched {got}, expected "
                     f"{want}, or a masked row is not 0")
            err.add(f"bounded={bounded}", out, fa._token_attention_plain(
                q, k, v, mask, heads, scale, bounded))
        found[f"fused_token_attention_{impl}"] = err.check()
    # C, D and E with O and lse, then F from D's O and lse
    for mode, (lq, lk) in (("bounded", (1030, 150)), ("online", (1030, 150)),
                           ("single", (100, 77))):
        err = errors(f"flash_{mode}")
        q, k, v = rows(2, heads, lq, d), rows(2, heads, lk, d), randn(2, heads, lk, d)
        mask = torch.ones(2, lk, device="cuda")
        mask[0, lk // 3: lk // 2] = 0.0
        mask[1] = 0.0
        (out, lse), got = launched_by(fa.flash_attention, q, k, v, kv_mask=mask,
                                      scale=scale, bounded_logits=mode == "bounded",
                                      with_lse=True)
        want = {f"flash_{mode}": 1, f"flash_{mode}_{fa.forward_impl(mode, dtype, d)}": 1}
        if got != want:
            fail(f"flash_{mode} {dtype} d={d}: launched {got}, expected {want}")
        ref, ref_lse = plain_forward(q, k, v, mask, scale, mode)
        err.add("O", out, ref)
        lse_err = (lse[0] - ref_lse[0]).abs().max().item()
        if not (lse_err <= (LSE_TOL_F32 if f32 else LSE_TOL)
                and bool((lse[1] == fa.LSE_MASKED).all()) and bool((out[1] == 0).all())):
            fail(f"flash_{mode} {dtype} d={d}: lse error {lse_err}, or a fully masked "
                 "row is not O = 0, lse = 1e30")
        name = f"flash_{mode}_{fa.forward_impl(mode, dtype, d)}"
        found[name] = err.check() + (lse_err,)
        if mode == "online":
            gout = randn(2, heads, lq, d)
            (dq, dk, dv), got = launched_by(fa._flash_backward, q, k, v, mask, out, lse,
                                            gout, scale)
            # the Hopper kernels take bf16 at head dim 64 and 128 only
            impl = "sm90" if dtype == torch.bfloat16 and d in (64, 128) else "wmma"
            want = {"flash_bwd_dkv": 1, "flash_bwd_dq": 1, f"flash_bwd_dkv_{impl}": 1,
                    f"flash_bwd_dq_{impl}": 1}
            if got != want or fa.backward_impl(dtype, d) != impl:
                fail(f"flash backward {dtype} d={d}: launched {got}, expected {want}")
            rq, rk, rv = fa._flash_backward_plain(q, k, v, mask, out, lse, gout, scale)
            dkv = errors(f"flash_bwd_dkv_{impl}", BWD_ULPS)
            dqe = errors(f"flash_bwd_dq_{impl}", BWD_ULPS)
            dkv.add("dk", dk, rk)
            dkv.add("dv", dv, rv)
            dqe.add("dq", dq, rq)
            found[f"flash_bwd_dkv_{impl}"], found[f"flash_bwd_dq_{impl}"] = (
                dkv.check(), dqe.check())
    # G: a shared bias with a masked band and a fully masked query row
    lq, lk = 160, 140
    q, k, v = rows(2, heads, lq, d), rows(2, heads, lk, d), randn(2, heads, lk, d)
    bias = torch.randn(2, 1, lq, lk, generator=g, device="cuda")
    bias[..., 50:70] = -1e30
    bias[:, :, 7] = -1e30
    bias3 = fa._dense_bias3(bias)
    (out, lse), got = launched_by(fa._flash_dense_forward, q, k, v, bias3, scale)
    ref, ref_lse = fa._flash_dense_plain(q, k, v, bias3, scale)
    route = fa.dense_impl(dtype, d, lk)
    err = errors(f"flash_dense_fwd_{route}")
    err.add("O", out, ref)
    found[f"flash_dense_fwd_{route}"] = err.check()
    gout = randn(2, heads, lq, d)
    (dq, dk, dv, db), got2 = launched_by(fa._flash_dense_backward, q, k, v, bias3, out,
                                         lse, gout, scale, True)
    got = {n: got.get(n, 0) + got2.get(n, 0) for n in set(got) | set(got2)}
    if got != dense_launches(route):
        fail(f"flash_dense {dtype} d={d}: launched {got}, expected the {route} route")
    rq, rk, rv, rdb = fa._flash_dense_backward_plain(q, k, v, bias3, out, lse, gout, scale)
    for key, pairs in (("bwd_dkv", (("dk", dk, rk), ("dv", dv, rv))),
                       ("bwd_dq", (("dq", dq, rq),)), ("bwd_db", (("db", db, rdb),))):
        err = errors(f"flash_dense_{key}_{route}", BWD_ULPS)
        for lbl, a, b in pairs:
            err.add(lbl, a, b)
        found[f"flash_dense_{key}_{route}"] = err.check()
    return found


def _generality_times(g, fa, dtype, d):
    """C and D (by their route at this type and head dim) at [1, 2048 / d,
    5376, d], one time each (CUDA events)."""
    import torch

    heads = max(1, WIDTH // d)
    x = torch.randn(3, 1, heads, LONG_TOKENS, d, generator=g, device="cuda")
    q, k, v = (x * (x.pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt()).to(dtype)
    out = {}
    for mode in ("bounded", "online"):
        out[f"flash_{mode}_{fa.forward_impl(mode, dtype, d)}"] = time_ms(
            lambda m=mode: fa.flash_attention(q, k, v, bounded_logits=m == "bounded"),
            reps=3, batches=3)
    out["shape"] = [1, heads, LONG_TOKENS, d]
    return out


# The DiT's W8A8 products per block at the long operating point: (K, N) of
# attn1 q/k/v/out and attn2 q/out (six), FF in and FF out
W8A8_SHAPES = {"2048x2048": (WIDTH, WIDTH), "2048x8192": (WIDTH, 4 * WIDTH),
               "8192x2048": (4 * WIDTH, WIDTH)}


# The Hopper int8 product (csrc/int8_matmul_sm90.cu) replaces the mma.sync
# kernel of csrc/int8_matmul.cu, which stays as the comparison
I8_SM90_SOURCE = "avatar_tpu_torch/csrc/int8_matmul_sm90.cu"
# token counts of the W8A8 crossover: the short path's 832, 3328 (below the
# reference's 4096 threshold) and the long path's 5376
CROSSOVER_TOKENS = (TOKENS, 3328, LONG_TOKENS)


def _mma_w8a8_call():
    """H's ``mma.sync`` kernel of csrc/int8_matmul.cu called through its C
    entry (no counter): x_q, x_s, w_q, w_s, bias -> bf16 out, the arguments
    of ``w8a8_matmul``, to compare the Hopper kernel with on the same
    inputs."""
    import ctypes

    import torch

    from avatar_tpu_torch.ops import int8_matmul as i8

    fn = i8._entry("w8a8_matmul", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])

    def call(x_q, x_s, w_q, w_s, bias):
        (m, k), n = x_q.shape, w_q.shape[0]
        w_s = w_s.float()
        bias = None if bias is None else bias.float()
        out = torch.empty((m, n), device=x_q.device, dtype=torch.bfloat16)
        err = fn(x_q.data_ptr(), x_s.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k, 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"the mma.sync w8a8_matmul failed with cudaError_t {err}")
        return out
    return call


def check_w8a8_kernel(peaks):
    """Kernel H on the Hopper route (``w8a8_matmul_sm90``) against its plain
    version: with unit scales and an f32 output, exactly the int32 sums;
    with real scales, with and without bias, bf16 output, within one bf16
    ulp of the case's largest output (equal in fact); and equal to the
    ``mma.sync`` kernel on the same inputs. M = 5376 at the three DiT
    shapes, 832 and a ragged 5000. Then, per shape, the device times
    (profiler) of both kernels and of the library int8 product (which
    lacks the epilogue), the Hopper kernel's time per call with the
    wrapper's host work (CUDA events), the bound at the int8 peak and the
    rate; and the W8A8 crossover: ``linear`` on the kernel route (row-quant
    kernel, then H) against the short route (eager quantization, the
    library product, eager dequant) at 832, 3328 and 5376 tokens."""
    import torch

    from avatar_tpu_torch.models import layers
    from avatar_tpu_torch.ops import int8_matmul as i8

    g = torch.Generator(device="cuda").manual_seed(11)
    mma = _mma_w8a8_call()

    def operands(m, k, n):
        x_q = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                            dtype=torch.int8)
        w_q = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                            dtype=torch.int8)
        x_s = torch.rand(m, 1, generator=g, device="cuda") * 1e-2 + 1e-3
        w_s = torch.rand(n, generator=g, device="cuda") * 1e-3 + 1e-4
        bias = torch.randn(n, generator=g, device="cuda").bfloat16()
        return x_q, x_s, w_q, w_s, bias

    cases = {f"{LONG_TOKENS}x{kn}": (LONG_TOKENS, *shape)
             for kn, shape in W8A8_SHAPES.items()}
    cases.update({f"{TOKENS}x2048x2048": (TOKENS, WIDTH, WIDTH),
                  "5000x2048x2048 ragged": (5000, WIDTH, WIDTH)})
    errors, exact, ops, same_as_mma = KernelErrors("w8a8_matmul_sm90"), {}, {}, {}
    timed = {}
    for label, (m, k, n) in cases.items():
        x_q, x_s, w_q, w_s, bias = ops[label] = operands(m, k, n)
        ones_m, ones_n = torch.ones_like(x_s), torch.ones_like(w_s)
        before = dict(i8.launch_counts)
        acc = i8.w8a8_matmul(x_q, ones_m, w_q, ones_n, out_dtype=torch.float32)
        launched = {c: i8.launch_counts[c] - before[c] for c in before
                    if i8.launch_counts[c] != before[c]}
        if launched != {"w8a8_matmul": 1, "w8a8_matmul_sm90": 1}:
            fail(f"w8a8_matmul {label}: launched {launched}, expected the Hopper kernel")
        ref = i8._w8a8_matmul_plain(x_q, ones_m, w_q, ones_n, None, torch.float32)
        exact[label] = bool(torch.equal(acc, ref))
        if not exact[label]:
            fail(f"w8a8_matmul_sm90 {label}: the int32 sums differ from the plain version's")
        for b in (bias, None):
            out = i8.w8a8_matmul(x_q, x_s, w_q, w_s, b)
            errors.add(f"{label}, bias={b is not None}", out,
                       i8._w8a8_matmul_plain(x_q, x_s, w_q, w_s, b, torch.bfloat16))
            same_as_mma[f"{label}, bias={b is not None}"] = bool(torch.equal(
                out, mma(x_q, x_s, w_q, w_s, b)))
    torch.cuda.synchronize()
    if not all(same_as_mma.values()):
        fail(f"w8a8_matmul_sm90 differs from the mma.sync kernel: {same_as_mma}")
    # one bf16 ulp (2^-8 of the largest output): the limit, not the expectation
    errors.tols = {k: v / 2 / KERNEL_ULPS for k, v in errors.tols.items()}
    err, tol = errors.check()
    for label, (m, k, n) in cases.items():
        if "ragged" in label:
            continue
        x_q, x_s, w_q, w_s, bias = ops[label]
        nbytes = m * k + n * k + 2 * m * n + 4 * m + 4 * n + 2 * n
        bound_ms, bound_by = bound(2.0 * m * n * k, nbytes, peaks, peaks[2])
        ms = device_ms(lambda: i8.w8a8_matmul(x_q, x_s, w_q, w_s, bias), "w8a8_sm90_kernel")
        timed[label] = {
            "ms": ms,
            "events_ms_per_call": time_ms(lambda: i8.w8a8_matmul(x_q, x_s, w_q, w_s, bias)),
            "mma_ms": device_ms(lambda: mma(x_q, x_s, w_q, w_s, bias), "w8a8_matmul_kernel"),
            "library_ms": device_ms(lambda: torch._int_mm(x_q, w_q.t())),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tera_ops_per_s": 2.0 * m * n * k / (ms * 1e-3) / 1e12,
            "tile_n": i8.matmul_tile_n(m, n)}
    main = f"{LONG_TOKENS}x2048x2048"
    x_q, x_s, w_q, w_s, bias = ops[main]
    plain_ms = time_ms(lambda: i8._w8a8_matmul_plain(x_q, x_s, w_q, w_s, bias,
                                                     torch.bfloat16), reps=3, batches=3)
    del ops
    # the crossover, as linear runs each route: the reference's threshold
    # moved below and above the token count
    w_q8 = torch.randint(-127, 128, (WIDTH, WIDTH), generator=g, device="cuda",
                         dtype=torch.int8)
    params = {"kernel_q8": w_q8, "scale": torch.rand(WIDTH, generator=g, device="cuda") * 1e-3,
              "bias": torch.randn(WIDTH, generator=g, device="cuda").bfloat16()}
    crossover, threshold = {}, i8.W8A8_PALLAS_MIN_TOKENS
    try:
        for tokens in CROSSOVER_TOKENS:
            x = torch.randn(1, tokens, WIDTH, generator=g, device="cuda").bfloat16()
            row = {}
            for route, at in (("kernel_route_ms", 0), ("short_route_ms", 10**9)):
                i8.W8A8_PALLAS_MIN_TOKENS = at
                row[route] = time_ms(lambda: layers.linear(params, x))
            crossover[str(tokens)] = row
    finally:
        i8.W8A8_PALLAS_MIN_TOKENS = threshold
    t = timed[main]
    row = {"name": "w8a8_matmul_sm90", "route": "cuda", "source": I8_SM90_SOURCE,
           "replaces": "avatar_tpu/ops/int8_matmul.py:47",
           "max_abs_err": err, "tol": tol, "ms": t["ms"], "plain_ms": plain_ms,
           "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
           "library_ms": t["library_ms"], "mma_ms": t["mma_ms"],
           "shape": f"M x K x N = {main}",
           "ff_shapes": {k: {n: v[n] for n in ("ms", "mma_ms", "bound_ms", "library_ms")}
                         for k, v in timed.items() if k != main}}
    emit({"phase": "kernel_w8a8_matmul", "int32_exact": exact, "errors": errors.errs,
          "limits": errors.tols, "equal_to_mma": same_as_mma, "plain_ms": plain_ms,
          "times": timed, "crossover_2048x2048": crossover,
          "w8a8_pallas_min_tokens": threshold})
    return row


ROW_QUANT_KERNELS = {
    # row name: (TPU kernel it replaces, f32 operations per output element)
    "quantize_rows": ("avatar_tpu/ops/int8_matmul.py:231", 3),
    "rms_mod_quant": ("avatar_tpu/ops/int8_matmul.py:305", 8),
    # K's operations are the instructions its function needs per element,
    # counted from the SASS of this run's build of a loop that does that
    # work alone (avatar_tpu_torch/tools/act_quant_work.cu, counted by
    # act_quant_sass.py): accurate tanhf and erff take tens each, where 12
    # f32 operations per element were counted before
    "act_quant_sm90": ("avatar_tpu/ops/int8_matmul.py:392", None),
}
ROW_QUANT_SOURCE = "avatar_tpu_torch/csrc/row_quant.cu"


def _rowblock_act_quant(h, act):
    """K's row-block kernel (``act_quant`` of csrc/row_quant.cu) through its
    C entry, no counter: to compare and time it on the inputs the Hopper
    route takes."""
    import torch

    from avatar_tpu_torch.ops import int8_matmul as i8

    fn = i8._entry("act_quant", [i8._P] * 3 + [i8._I] * 4 + [i8._P])
    b, n, c2 = h.shape
    width = c2 // 2 if act == "geglu" else c2
    q = torch.empty((b * n, width), device="cuda", dtype=torch.int8)
    s = torch.empty((b * n, 1), device="cuda", dtype=torch.float32)
    err = fn(h.data_ptr(), q.data_ptr(), s.data_ptr(), b * n, c2, i8.ACTIVATIONS[act],
             int(h.dtype == torch.float32), torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"act_quant (row block) failed with {err}")
    return q, s


def _rowblock_rms_mod_quant(x, cvec, shift, eps=1e-6):
    """J's row-block kernel (``rms_mod_quant`` of csrc/row_quant.cu) through
    its C entry, no counter: to compare and time it on the inputs the
    Hopper route takes."""
    import torch

    from avatar_tpu_torch.ops import int8_matmul as i8

    fn = i8._entry("rms_mod_quant", [i8._P] * 5 + [i8._I] * 3 + [i8._F, i8._I, i8._P])
    b, n, c = x.shape
    cvec = cvec.float().reshape(b, c).contiguous()
    shift = None if shift is None else shift.float().reshape(b, c).contiguous()
    q = torch.empty((b * n, c), device="cuda", dtype=torch.int8)
    s = torch.empty((b * n, 1), device="cuda", dtype=torch.float32)
    err = fn(x.data_ptr(), cvec.data_ptr(), None if shift is None else shift.data_ptr(),
             q.data_ptr(), s.data_ptr(), b, n, c, eps, int(x.dtype == torch.float32),
             torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"rms_mod_quant (row block) failed with {err}")
    return q, s


def _rows_differ(q, s, ref_q, ref_s):
    """(largest level difference, fraction of elements off, largest scale
    relative error) of int8 rows against a reference."""
    diff = (q.int() - ref_q.int()).abs()
    return (diff.max().item(), (diff > 0).float().mean().item(),
            ((s - ref_s).abs() / ref_s.abs()).max().item())


# one NaN, +inf and -inf element in rows 3, 5 and 8 of 16 rows
NONFINITE_ROWS = {3: float("nan"), 5: float("inf"), 8: float("-inf")}


def check_nonfinite_rows():
    """I, J (both routes) and K (both kernels, each activation) on rows with
    one NaN, +inf or -inf element beside finite rows, at the DiT's widths,
    against the plain versions on the card: on those rows the levels
    exactly equal (all 0) and the scales equal, NaN to NaN and inf to inf;
    the finite rows to the usual rule; K's two kernels equal bit for bit
    (levels, and the scales' bits). Any failure stops the run."""
    import torch

    from avatar_tpu_torch.ops import int8_matmul as i8

    g = torch.Generator(device="cuda").manual_seed(13)
    bad = sorted(NONFINITE_ROWS)
    finite = [i for i in range(16) if i not in NONFINITE_ROWS]

    def rows(width):
        x = torch.randn(1, 16, width, generator=g, device="cuda")
        for row, value in NONFINITE_ROWS.items():
            x[0, row, 17] = value
        return x.bfloat16()

    def same_scales(a, b):
        return bool(((a == b) | (a.isnan() & b.isnan())).all())

    x, h = rows(WIDTH), rows(4 * WIDTH)
    cvec = torch.randn(1, 1, WIDTH, generator=g, device="cuda") * 0.3 + 1.0
    shift = torch.randn(1, 1, WIDTH, generator=g, device="cuda") * 0.2

    def prequant(pq):
        return pq.q, pq.s

    j_plain = i8._row_quant_plain(i8._rms_mod_plain(x, cvec, shift, 1e-6))
    cases = {
        "quantize_rows": (lambda: i8.quantize_rows_pallas(x[0]),
                          i8._row_quant_plain(x[0].float())),
        "rms_mod_quant_sm90": (lambda: prequant(i8.fused_rms_mod_quant(x, cvec, shift)),
                               j_plain),
        "rms_mod_quant_rowblock": (lambda: _rowblock_rms_mod_quant(x, cvec, shift), j_plain)}
    for act in i8.ACTIVATIONS:
        ref = i8._row_quant_plain(i8._act_plain(h, act))
        cases[f"act_quant_sm90 {act}"] = (lambda act=act: prequant(i8.fused_act_quant(h, act)),
                                          ref)
        cases[f"act_quant_rowblock {act}"] = (lambda act=act: _rowblock_act_quant(h, act), ref)
    results, outs = {}, {}
    for label, (kernel, (ref_q, ref_s)) in cases.items():
        q, s = outs[label] = kernel()
        torch.cuda.synchronize()
        levels, fraction, scale_err = _rows_differ(q[finite], s[finite], ref_q[finite],
                                                   ref_s[finite])
        res = {"scales": [s[i].item() for i in bad],
               "levels_equal": bool(torch.equal(q[bad], ref_q[bad])),
               "levels_all_zero": not bool(q[bad].any()),
               "scales_equal": same_scales(s[bad], ref_s[bad]),
               "finite_rows": {"levels": levels, "fraction": fraction,
                               "scale_rel_err": scale_err}}
        if label.startswith("act_quant_rowblock"):
            q90, s90 = outs[label.replace("rowblock", "sm90")]
            res["equal_to_sm90_bits"] = bool(torch.equal(q, q90) and torch.equal(
                s.view(torch.int32), s90.view(torch.int32)))
        results[label] = res
        if not (res["levels_equal"] and res["levels_all_zero"] and res["scales_equal"]
                and res.get("equal_to_sm90_bits", True) and levels <= 1
                and fraction <= LEVEL_FRACTION and scale_err <= SCALE_RTOL):
            fail(f"{label} on rows that are not finite: {res}")
    emit({"phase": "row_quant_nonfinite", "rows": {"nan": 3, "inf": 5, "-inf": 8},
          "results": results})


def check_row_quant_kernels(peaks):
    """Kernels I, J and K against their plain versions at the DiT's long
    shapes (I [5376, 2048]; J [1, 5376, 2048] with and without shift on its
    Hopper route; K [1, 5376, 8192] for each activation on its Hopper
    route), and at a ragged batch of 2 x 1001 rows with a zero row; J also
    at a width of 2056 (its Hopper route, not a multiple of 32) and in f32
    (its row-block route), and on its Hopper route against its row-block
    kernel on the same inputs (the sums of squares in another order); K
    also on its row-block route at a width of 8190 (not a multiple of 8).
    The scales within SCALE_RTOL, the int8 at most one level apart on at
    most LEVEL_FRACTION of the elements; every J and K call must launch
    the route ``rms_mod_quant_impl`` / ``act_quant_impl`` names. Then
    (``check_nonfinite_rows``) rows with a NaN or an inf. Then the times
    (device time; J's and K's two kernels on the same inputs, the
    row-block kernel through its C entry, and for K whether their outputs
    are equal) and the bound: bytes (the input read once, the int8 and
    scales written once) for I and J; for K the larger of that and the
    SASS instructions its function needs per element
    (``act_quant_sass.count_work``, apart from either kernel's own code)
    over the SMs' issue rate at the card's top SM clock; each kernel's own
    count beside it. No single library call computes any of them."""
    import torch

    from avatar_tpu_torch.ops import int8_matmul as i8
    from avatar_tpu_torch.tools import act_quant_sass

    g = torch.Generator(device="cuda").manual_seed(12)

    def randn(*shape, scale=1.0, offset=0.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                + offset).bfloat16()

    x = randn(1, LONG_TOKENS, WIDTH)
    x_r = randn(2, 1001, WIDTH)
    x_r[1, 7] = 0.0  # zero row: s = 1e-30 / 127 and q = 0 (I), the shift (J)
    cvec, shift = randn(1, 1, WIDTH, scale=0.3, offset=1.0), randn(1, 1, WIDTH, scale=0.2)
    cvec_r, shift_r = randn(2, 1, WIDTH, scale=0.3, offset=1.0), randn(2, 1, WIDTH, scale=0.2)
    h = randn(1, LONG_TOKENS, 4 * WIDTH, scale=2.0)
    h_r = randn(2, 1001, 4 * WIDTH, scale=2.0)
    h_r[0, 3] = 0.0
    h_odd = randn(1, 333, 4 * WIDTH - 2, scale=2.0)
    x_2056 = randn(1, 333, WIDTH + 8)
    cvec_2056, shift_2056 = (randn(1, 1, WIDTH + 8, scale=0.3, offset=1.0),
                             randn(1, 1, WIDTH + 8, scale=0.2))
    cases = {"quantize_rows": {}, "rms_mod_quant": {}, "act_quant_sm90": {}}
    for label, xx in ((f"{LONG_TOKENS}x{WIDTH}", x), ("ragged 2x1001, zero row", x_r)):
        flat = xx.reshape(-1, WIDTH)
        cases["quantize_rows"][label] = (
            lambda flat=flat: i8.quantize_rows_pallas(flat),
            lambda flat=flat: i8._row_quant_plain(flat.float()))
    j_args = {"shift": (x, cvec, shift), "no shift": (x, cvec, None),
              "ragged 2x1001, zero row, shift": (x_r, cvec_r, shift_r),
              "width 2056, shift": (x_2056, cvec_2056, shift_2056),
              "f32 (row block), shift": (x_r[:1, :333].float(), cvec, shift)}
    for label, args in j_args.items():
        cases["rms_mod_quant"][label] = (
            lambda a=args: i8.fused_rms_mod_quant(*a, eps=1e-6),
            lambda a=args: i8._row_quant_plain(i8._rms_mod_plain(*a, 1e-6)))
    rowblock_diffs = {}
    for act in i8.ACTIVATIONS:
        for label, hh in ((act, h), (f"{act}, ragged 2x1001, zero row", h_r),
                          (f"{act}, row block, width 8190", h_odd)):
            cases["act_quant_sm90"][label] = (
                lambda hh=hh, act=act: i8.fused_act_quant(hh, act),
                lambda hh=hh, act=act: i8._row_quant_plain(i8._act_plain(hh, act)))
    rows = []
    for name, named in cases.items():
        levels, fractions, scale_errs = {}, {}, {}
        for label, (kernel, plain) in named.items():
            before = dict(i8.launch_counts)
            out = kernel()
            torch.cuda.synchronize()
            launched = {n: c - before[n] for n, c in i8.launch_counts.items()
                        if c > before[n]}
            if name == "act_quant_sm90":
                width = out.q.shape[1]
                route = f"act_quant_{i8.act_quant_impl(width, torch.bfloat16)}"
                if launched != {"act_quant": 1, route: 1}:
                    fail(f"act_quant {label}: launched {launched}, expected {route}")
            if name == "rms_mod_quant":
                impl = i8.rms_mod_quant_impl(out.shape[-1], j_args[label][0].dtype)
                route = f"rms_mod_quant_{impl}"
                if launched != {"rms_mod_quant": 1, route: 1}:
                    fail(f"rms_mod_quant {label}: launched {launched}, expected {route}")
                if impl == "sm90":  # against the row-block kernel on the same inputs
                    rowblock_diffs[label] = _rows_differ(
                        out.q, out.s, *_rowblock_rms_mod_quant(*j_args[label]))
                    lv, fr, se = rowblock_diffs[label]
                    if not (lv <= 1 and fr <= LEVEL_FRACTION and se <= SCALE_RTOL):
                        fail(f"rms_mod_quant {label} against the row-block kernel: "
                             f"{lv} levels on {fr} of the elements, scales {se}")
            q, s = (out.q, out.s) if isinstance(out, i8.PrequantRows) else out
            levels[label], fractions[label], scale_errs[label] = _rows_differ(
                q, s, *plain())
            if not (levels[label] <= 1 and fractions[label] <= LEVEL_FRACTION
                    and scale_errs[label] <= SCALE_RTOL):
                fail(f"{name} {label}: {levels[label]} levels on "
                     f"{fractions[label]} of the elements, scales {scale_errs[label]}")
        kernel, plain = next(iter(named.values()))
        inp = h if name == "act_quant_sm90" else x
        rows_n, width = inp.shape[1], inp.shape[2]
        nbytes = rows_n * width * 2 + rows_n * width + rows_n * 4
        if name == "rms_mod_quant":
            nbytes += 2 * width * 4
        replaces, per_elem = ROW_QUANT_KERNELS[name]
        extra = {"events_ms_per_call": time_ms(kernel)}
        if name == "act_quant_sm90":
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            clock = act_quant_sass.max_sm_clock_mhz()
            work = act_quant_sass.count_work()
            counts = act_quant_sass.count_act_quant()
            by_act = {}
            for act in i8.ACTIVATIONS:
                out_w = act_quant_sass.out_width(act, width)
                act_bytes = rows_n * width * 2 + rows_n * out_w + rows_n * 4
                pq = i8.fused_act_quant(h, act)
                block_q, block_s = _rowblock_act_quant(h, act)
                res = {"ms": device_ms(lambda act=act: i8.fused_act_quant(h, act),
                                       "act_quant_regs_kernel"),
                       "rowblock_ms_same_inputs": device_ms(
                           lambda act=act: _rowblock_act_quant(h, act), "act_quant_kernel"),
                       "events_ms": time_ms(lambda act=act: i8.fused_act_quant(h, act)),
                       "equal_to_rowblock": bool(torch.equal(pq.q, block_q)
                                                 and torch.equal(pq.s, block_s)),
                       "bytes_bound_ms": bound(0.0, act_bytes, peaks)[0]}
                for route in ("sm90", "rowblock"):
                    per = counts[act][route]["per_element"]
                    res[f"{route}_instructions_per_element"] = per
                    res[f"{route}_issue_ms"] = act_quant_sass.issue_bound_ms(
                        per, rows_n * out_w, sms, clock)
                res["work_instructions_per_element"] = work[act]["per_element"]
                res["issue_bound_ms"] = act_quant_sass.issue_bound_ms(
                    work[act]["per_element"], rows_n * out_w, sms, clock)
                res["bound_ms"], res["bound_by"] = bound(
                    work[act]["per_element"] * rows_n * out_w, act_bytes, peaks,
                    sms * act_quant_sass.INSTRUCTIONS_PER_CLOCK * clock * 1e6)
                # "operations" here are issued instructions
                res["fraction_of_bound"] = res["bound_ms"] / res["ms"]
                by_act[act] = res
                del pq, block_q, block_s
            extra.update({"by_activation": by_act, "sms": sms, "max_sm_clock_mhz": clock,
                          "sass_work": work, "sass_counts": counts})
            top = by_act["gelu-approximate"]
            ms, bound_ms, bound_by = top["ms"], top["bound_ms"], top["bound_by"]
        elif name == "rms_mod_quant":
            ms = device_ms(kernel, "rms_mod_quant_regs_kernel")
            bound_ms, bound_by = bound(per_elem * rows_n * width, nbytes, peaks, peaks[3])
            rowblock_ms = device_ms(lambda: _rowblock_rms_mod_quant(x, cvec, shift),
                                    "rms_mod_quant_kernel")
            # the same with the 50 MB L2 written over before each launch:
            # the 22 MB input otherwise stays there from call to call
            flush = torch.empty(64 << 20, device="cuda", dtype=torch.uint8)
            extra.update({
                "l2_cold_ms": device_ms(
                    lambda: (flush.zero_(), i8.fused_rms_mod_quant(x, cvec, shift)),
                    "rms_mod_quant_regs_kernel"),
                "rowblock_l2_cold_ms": device_ms(
                    lambda: (flush.zero_(), _rowblock_rms_mod_quant(x, cvec, shift)),
                    "rms_mod_quant_kernel"),
                "rowblock_ms_same_inputs": rowblock_ms,
                "no_shift_ms": device_ms(lambda: i8.fused_rms_mod_quant(x, cvec, None),
                                         "rms_mod_quant_regs_kernel"),
                "against_rowblock": {k: dict(zip(("levels", "fraction", "scale_rel_err"), v))
                                     for k, v in rowblock_diffs.items()},
                "fraction_of_bound": bound_ms / ms,
                "at_least_half_of_bound": bound_ms / ms >= 0.5,
                "faster_than_rowblock": ms < rowblock_ms})
        else:
            ms = device_ms(kernel, f"{name}_kernel")
            bound_ms, bound_by = bound(per_elem * rows_n * width, nbytes, peaks, peaks[3])
        plain_ms = time_ms(plain, reps=5, batches=3)
        rows.append({"name": name, "route": "cuda", "source": ROW_QUANT_SOURCE,
                     "replaces": replaces, "max_abs_err": max(levels.values()),
                     "err_unit": "int8 levels",
                     "tol": f"1 level on <= {LEVEL_FRACTION} of elements",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
        if name == "rms_mod_quant":
            rows[-1].update({"kernel": "rms_mod_quant_regs_kernel",
                             "rowblock_ms_same_inputs": extra["rowblock_ms_same_inputs"]})
        emit({"phase": f"kernel_{name}", "levels": levels, "level_fractions": fractions,
              "scale_rel_errs": scale_errs, "ms": ms, "plain_ms": plain_ms,
              "library_ms": None, "bound_us": bound_ms * 1e3, "bound_by": bound_by,
              "bytes": nbytes, "shape": list(inp.shape), **extra})
    check_nonfinite_rows()
    return rows


def _tree_to(tree, device, dtype):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype if tree.ndim else torch.float32)


def _tiny_models(qk_norm="rms_norm", heads=2):
    import dataclasses

    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.models.vae import demo_config, init_vae

    dcfg = DiTConfig(num_attention_heads=heads, attention_head_dim=64, in_channels=16,
                     out_channels=16, num_layers=2, cross_attention_dim=heads * 64,
                     caption_channels=64, qk_norm=qk_norm)
    vcfg = dataclasses.replace(demo_config(latent_channels=16), base_channels=32,
                               decoder_base_channels=32)
    return (dcfg, init_dit(dcfg, 2, device="cpu"), vcfg,
            init_vae(vcfg, 3, device="cpu"))


def _rel_rms(a, b):
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def _rounded_t_tables(params, cfg, timesteps, batch, dtype):
    """The AdaLN timestep tables in ``dtype`` from t = sigma * multiplier as
    a bf16 run rounds it."""
    import torch

    from avatar_tpu_torch.models.dit import precompute_timestep_tables

    mult = cfg.timestep_scale_multiplier
    t = (timesteps.to(torch.bfloat16) * mult).float()
    return precompute_timestep_tables(params, cfg, t / mult, batch, dtype=dtype)


def _tiny_inputs(dcfg, size, frames, caption, settings, encode, avatar=True):
    """Seeded CPU inputs of a 3-step tiny pipeline and its
    ``GenerationParams``: prompts, initial noise and, with ``avatar``, the
    reference and pose (pixels to encode, or latents). The negative prompt
    keeps some keys, so the kernel and plain attention paths compute one
    function."""
    import torch

    from avatar_tpu_torch.pipelines.pipeline import GenerationParams

    g = torch.Generator().manual_seed(4)
    lat_f, lat_hw, ch = (frames - 1) // 8 + 1, size // 32, dcfg.in_channels
    steps = 3
    keep = (torch.arange(caption) < caption - 10).float()[None]
    inputs = dict(
        prompt_embeds=torch.randn(1, caption, 64, generator=g),
        prompt_attention_mask=keep,
        negative_prompt_embeds=torch.randn(1, caption, 64, generator=g),
        negative_prompt_attention_mask=keep,
        init_noise=torch.randn(1, lat_f, lat_hw, lat_hw, ch, generator=g),
    )
    if not avatar:
        pass
    elif encode:
        inputs.update(
            ref_image=torch.rand(1, 1, size, size, 3, generator=g) * 2 - 1,
            pose_frames=torch.rand(1, frames, size, size, 3, generator=g) * 2 - 1,
            ref_noise=torch.randn(1, 1, lat_hw, lat_hw, ch, generator=g),
            pose_noise=torch.randn(1, lat_f, lat_hw, lat_hw, ch, generator=g))
    else:
        inputs.update(
            ref_latents=torch.randn(1, 1, lat_hw, lat_hw, ch, generator=g),
            pose_latents=torch.randn(1, lat_f, lat_hw, lat_hw, ch, generator=g))
    params = GenerationParams(height=size, width=size, num_frames=frames - 1,
                              num_inference_steps=steps, decode_timestep=0.05,
                              **settings)
    return inputs, params


def _reference_run(label, models, size, frames, caption, settings, ctor,
                   expect_kernels, encode=True, avatar=True, extra=None,
                   exact_t_tol=None, expect_f32=None):
    """One tiny pipeline, same weights and noise, four ways: f32 on the CPU
    (the kernels' plain versions) as it is and with t rounded as a bf16 run
    rounds it, bf16 on the card through the CUDA kernels, and bf16 on the
    card with ``attention_impl="xla"`` (no kernel). ``extra``: more inputs
    of the call (conditioning inputs and their noise); ``exact_t_tol``
    replaces EXACT_T_TOL for a schedule of its own. With ``expect_f32``
    (the kernels an f32 run must launch) a fifth way: f32 on the card
    through the kernels' f32 variants, held to F32_REFERENCE_TOL of the f32
    CPU run; its launches are ``res["f32_launches"]``. Returns the kernel
    run's errors against the others and its launches."""
    from unittest import mock

    import torch

    from avatar_tpu_torch.pipelines import pipeline as pipeline_mod
    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline

    dcfg, dit, vcfg, vae = models
    inputs, params = _tiny_inputs(dcfg, size, frames, caption, settings, encode, avatar)
    inputs.update(extra or {})
    steps, ch = params.num_inference_steps, dcfg.in_channels
    lat_f, lat_hw = (frames - 1) // 8 + 1, size // 32
    schedules = []

    def run(device, dtype, **ctor_kw):
        pipe = LTXVideoPipeline(dcfg, _tree_to(dit, device, dtype), vcfg,
                                _tree_to(vae, device, dtype), device=device,
                                **ctor_kw)
        schedules.append(pipe.schedule)
        reset_counts()
        out = pipe(params, torch.Generator(device=device), **inputs,
                   output_type="latent", dtype=dtype).float().cpu()
        return out, {k: n for k, n in read_counts().items() if n}

    cpu_exact_t, _ = run("cpu", torch.float32, **ctor)
    with mock.patch.object(pipeline_mod, "precompute_timestep_tables",
                           _rounded_t_tables):
        cpu, _ = run("cpu", torch.float32, **ctor)
    no_kernel, none = run("cuda", torch.bfloat16, **{**ctor, "attention_impl": "xla"})
    card, launches = run("cuda", torch.bfloat16, **ctor)
    f32_res = {}
    if expect_f32 is not None:
        card32, launches32 = run("cuda", torch.float32, **ctor)
        f32_res = {"f32_rel_rms_err": _rel_rms(card32, cpu_exact_t),
                   "f32_max_abs_err": (card32 - cpu_exact_t).abs().max().item(),
                   "f32_tol": F32_REFERENCE_TOL, "f32_launches": launches32}
        if set(launches32) != set(expect_f32):
            fail(f"{label}: the f32 run launched {launches32}, expected exactly "
                 f"{expect_f32}")
        if not f32_res["f32_rel_rms_err"] <= F32_REFERENCE_TOL:
            fail(f"{label}: the card's f32 kernel path disagrees with the f32 CPU "
                 f"run: {f32_res}")
    tokens = lat_f * lat_hw * lat_hw
    exact_t_tol = exact_t_tol or EXACT_T_TOL["long" if tokens > 1000 else "short"]
    sigmas = torch.tensor(schedules[0].set_timesteps(
        num_inference_steps=steps,
        samples_shape=(1, ch, lat_f, lat_hw, lat_hw)).sigmas, dtype=torch.float32)
    mult = dcfg.timestep_scale_multiplier
    res = {"tokens": tokens,
           "t_f32": (sigmas * mult).tolist(),
           "t_bf16": (sigmas.to(torch.bfloat16) * mult).float().tolist(),
           "max_abs_err": (card - cpu).abs().max().item(),
           "rel_rms_err": _rel_rms(card, cpu),
           "no_kernel_rel_rms_err": _rel_rms(no_kernel, cpu),
           "rel_rms_vs_no_kernel": _rel_rms(card, no_kernel),
           "exact_t_rel_rms_err": _rel_rms(card, cpu_exact_t),
           "exact_t_tol": exact_t_tol,
           "launches": launches, **f32_res}
    if not all(math.isfinite(res[k]) for k in res if k.endswith("err")):
        fail(f"{label}: not finite: {res}")
    if none or set(launches) != set(expect_kernels):
        fail(f"{label}: launched {launches} (and {none} under 'xla'), expected "
             f"exactly {expect_kernels}")
    if (res["rel_rms_err"] > REFERENCE_TOL
            or res["rel_rms_vs_no_kernel"] > KERNEL_PATH_TOL
            or res["exact_t_rel_rms_err"] > exact_t_tol):
        fail(f"{label}: the card's kernel path disagrees with its references: {res}")
    return res


def check_reference():
    """Guidance 1, Euler: 16 tokens and 48 caption keys (multiples of 16,
    so the token-major kernels take them in bf16)."""
    res = _reference_run(
        "reference", _tiny_models(), 64, 25, 48,
        dict(guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0), {},
        TOKEN_MAJOR_BF16)
    emit({"phase": "reference", **res, "rel_rms_tol": REFERENCE_TOL,
          "vs_no_kernel_tol": KERNEL_PATH_TOL})
    return res["launches"]


GUIDED = dict(guidance_scale=3.0, stg_scale=1.0, rescaling_scale=0.7,
              skip_block_list=[1], solver="heun")


def check_reference_guided():
    """CFG 3 + STG 1 (block 1, AttentionValues) + rescale 0.7 + Heun in tiny
    pipelines: once on the default path (token-major kernels at batch 3),
    and with ``attention_impl="flash", rope_split=False`` at shapes that
    reach each head-major kernel: 12 tokens (the whole-row kernel), 1280
    tokens with q/k norm (the max-free kernel: the Hopper kernel in bf16)
    and without (the online kernel). Each also runs in f32 on the card
    (the f32 variants: WMMA C and D, A, B, E). Returns the launches of the
    bf16 runs and of the f32 runs."""
    from avatar_tpu_torch.models.dit import SkipLayerStrategy

    settings = dict(GUIDED, skip_layer_strategy=SkipLayerStrategy.AttentionValues)
    flash = dict(attention_impl="flash", rope_split=False)
    token_major32 = ("rope_fused_attention", "rope_fused_attention_wmma",
                     "fused_token_attention", "fused_token_attention_wmma")
    # in f32 the reference's sublane of 8 (16 in bf16) lets the 40-key
    # caption take the token-major kernel B at 1280 queries
    runs = {
        "token_major": (_tiny_models(), 64, 25, 48, {}, True, TOKEN_MAJOR_BF16,
                        token_major32),
        "flash_single": (_tiny_models(), 64, 17, 40, flash, True,
                         ("flash_single", "flash_single_sm90"),
                         ("flash_single", "flash_single_wmma")),
        "flash_bounded": (_tiny_models(), 256, 153, 40, flash, False,
                          ("flash_bounded", "flash_bounded_sm90"),
                          ("flash_bounded", "flash_bounded_wmma", "fused_token_attention",
                           "fused_token_attention_wmma")),
        "flash_online": (_tiny_models(qk_norm=None), 256, 153, 40, flash, False,
                         ("flash_online", "flash_online_sm90"),
                         ("flash_online", "flash_online_wmma", "fused_token_attention",
                          "fused_token_attention_wmma")),
    }
    results, total, total32 = {}, {}, {}
    for label, (models, size, frames, caption, ctor, encode, kernels,
                kernels32) in runs.items():
        results[label] = _reference_run(
            f"reference_guided/{label}", models, size, frames, caption, settings,
            ctor, kernels, encode, expect_f32=kernels32)
        for name, n in results[label]["launches"].items():
            total[name] = total.get(name, 0) + n
        for name, n in results[label]["f32_launches"].items():
            total32[name] = total32.get(name, 0) + n
    emit({"phase": "reference_guided", "settings": {**GUIDED,
          "skip_layer_strategy": "AttentionValues"}, "runs": results,
          "rel_rms_tol": REFERENCE_TOL, "vs_no_kernel_tol": KERNEL_PATH_TOL,
          "f32_tol": F32_REFERENCE_TOL})
    return total, total32


def check_reference_conditioned():
    """The conditioning inputs in tiny pipelines (guidance 1, no avatar
    inputs, 3 steps), the four ways of :func:`_reference_run`: a first-frame
    item resized up from 32 px with ``image_cond_noise_scale`` 0.15 (16
    tokens); at 128 px an off-centre item (64 px at x = 64, y = 0) beside a
    17-frame sequence at frame 8 resized down from 160 px, whose two-frame
    prefix adds 32 tokens (96); ``media_items`` with
    ``skip_initial_inference_steps`` 1. Every draw (item encodes, prefix,
    per-step conditioning noise, media encode) is handed to both devices as
    the same CPU tensor. Each run goes through kernels A and B."""
    import torch

    from avatar_tpu_torch.pipelines.pipeline import ConditioningItem

    g = torch.Generator().manual_seed(26)
    ch = 16

    def pixels(frames, size):
        return torch.rand(1, frames, size, size, 3, generator=g) * 2 - 1

    def noise(*shape):
        return torch.randn(shape, generator=g)

    # (size, frames, settings, inputs, limit against the f32 run at exact t):
    # with conditioning items every token's t runs in f32 inside the model,
    # so bf16 rounds no t (CPU rehearsal 0.006); without them the media run
    # walks 2 of the 3 steps, t = 628.4 (rounded to 628) and 100, and the
    # rounding weighs more than in a 3-step walk (CPU rehearsal in bf16:
    # 0.036 at exact t, 0.006 at the rounded t)
    runs = {
        "first_frame_resize_up_noise": (64, 25, dict(image_cond_noise_scale=0.15), dict(
            conditioning_items=[ConditioningItem(pixels(1, 32))],
            item_noise=[noise(1, 1, 2, 2, ch)], image_cond_noise=noise(3, 1, 16, ch)),
            None),
        "off_centre_and_sequence_at_8": (128, 25, {}, dict(
            conditioning_items=[ConditioningItem(pixels(1, 64), 0, 1.0, 64, 0),
                                ConditioningItem(pixels(17, 160), 8, 0.9)],
            item_noise=[noise(1, 1, 2, 2, ch), noise(1, 3, 4, 4, ch)],
            prefix_noise=[None, noise(1, 2, 4, 4, ch)]), None),
        "media_items_skip_initial": (64, 25, dict(skip_initial_inference_steps=1), dict(
            media_items=pixels(25, 64), media_noise=noise(1, 4, 2, 2, ch)), 0.08),
    }
    plain = dict(guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0)
    results, total = {}, {}
    for label, (size, frames, settings, extra, exact_tol) in runs.items():
        results[label] = _reference_run(
            f"reference_conditioned/{label}", _tiny_models(), size, frames, 48,
            {**plain, **settings}, {}, TOKEN_MAJOR_BF16,
            avatar=False, extra=extra, exact_t_tol=exact_tol)
        for name, n in results[label]["launches"].items():
            total[name] = total.get(name, 0) + n
    emit({"phase": "reference_conditioned", "runs": results,
          "rel_rms_tol": REFERENCE_TOL, "vs_no_kernel_tol": KERNEL_PATH_TOL})
    return total


def _int8_leaves(tree, path=""):
    """{path: tensor} of every int8 kernel and its scale in a params tree."""
    if isinstance(tree, list):
        tree = dict(enumerate(tree))
    out = {}
    for key, val in tree.items():
        if isinstance(val, (dict, list)):
            out.update(_int8_leaves(val, f"{path}/{key}"))
        elif key in ("kernel_q", "kernel_q8") or (
                key == "scale" and ("kernel_q" in tree or "kernel_q8" in tree)):
            out[f"{path}/{key}"] = val
    return out


def check_reference_w8a8():
    """Tiny quantized pipelines (2 layers, random weights, guidance 1, 3
    steps) in bf16 on the card against f32 on the CPU fed the bf16-rounded
    timestep. The weights are rounded to bf16 first, so both devices
    quantize the same values; their int8 kernels and scales must be equal.
    Runs: "kernel_route", W8A8 at 4352 tokens (129 frames at 512 px, above
    W8A8_PALLAS_MIN_TOKENS: kernels H, I, J and K, with no patch);
    "short_route", W8A8 at 16 tokens (the library int8 product); "w8",
    weight-only, on a DiT of 8 heads x 64 whose linears reach the w8
    threshold of 2^18 elements."""
    from unittest import mock

    import torch

    from avatar_tpu_torch.pipelines import pipeline as pipeline_mod
    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline

    per_video = 2 * 3  # layers x steps
    token_major = {name: per_video for name in TOKEN_MAJOR_BF16}
    runs = {
        "kernel_route": (_tiny_models(), 512, 129, "w8a8", False, {
            "w8a8_matmul": 8 * per_video, "w8a8_matmul_sm90": 8 * per_video,
            "quantize_rows": 3 * per_video,
            "rms_mod_quant": 2 * per_video, "rms_mod_quant_sm90": 2 * per_video,
            "act_quant": per_video, "act_quant_sm90": per_video,
            "flash_bounded": per_video, "flash_bounded_sm90": per_video,
            "fused_token_attention": per_video, "fused_token_attention_sm90": per_video}),
        "short_route": (_tiny_models(), 64, 25, "w8a8", True, token_major),
        "w8": (_tiny_models(heads=8), 64, 25, "w8", True, token_major),
    }
    plain = dict(guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0)
    results, total = {}, {}
    for label, (models, size, frames, mode, encode, expect) in runs.items():
        dcfg, dit, vcfg, vae = models
        dit = _tree_to(dit, "cpu", torch.bfloat16)
        inputs, params = _tiny_inputs(dcfg, size, frames, 48, plain, encode)

        def run(device, dtype):
            pipe = LTXVideoPipeline(dcfg, _tree_to(dit, device, dtype), vcfg,
                                    _tree_to(vae, device, dtype), device=device,
                                    quantize_weights=mode)
            reset_counts()
            out = pipe(params, torch.Generator(device=device), **inputs,
                       output_type="latent", dtype=dtype).float().cpu()
            return out, {k: n for k, n in read_counts().items() if n}, pipe

        with mock.patch.object(pipeline_mod, "precompute_timestep_tables",
                               _rounded_t_tables):
            cpu, _, cpu_pipe = run("cpu", torch.float32)
        card, launches, card_pipe = run("cuda", torch.bfloat16)
        cpu_q, card_q = (_int8_leaves(p.raw_dit_params) for p in (cpu_pipe, card_pipe))
        if not cpu_q or set(cpu_q) != set(card_q) or not all(
                torch.equal(cpu_q[k], card_q[k].cpu()) for k in cpu_q):
            fail(f"reference_w8a8/{label}: the card's int8 params differ from the CPU's")
        # REFERENCE_TOL as for the unquantized pipelines: where bf16 moves an
        # activation across an int8 rounding boundary it flips one level of
        # max|row| / 127, which the same run on the CPU in bf16 puts within
        # bf16's own distance (0.006 to 0.007 against 0.005 for w8)
        tol = REFERENCE_TOL
        res = {"mode": mode, "tokens": card.shape[1] * card.shape[2] * card.shape[3],
               "int8_leaves": len(cpu_q), "max_abs_err": (card - cpu).abs().max().item(),
               "rel_rms_err": _rel_rms(card, cpu), "rel_rms_tol": tol,
               "launches": launches}
        if not (math.isfinite(res["rel_rms_err"]) and res["rel_rms_err"] <= tol):
            fail(f"reference_w8a8/{label}: the card disagrees with the CPU: {res}")
        if launches != expect:
            fail(f"reference_w8a8/{label}: launched {launches}, expected {expect}")
        results[label] = res
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    emit({"phase": "reference_w8a8", "runs": results})
    return total


# The flash backward (F) against its plain version, per case: both round p
# and dS to bf16 before their products and sum in f32, but in another order
# over up to 5376 queries or keys, and an element of p or dS may land on the
# neighbouring bf16 value; so each gradient is held to BWD_ULPS bf16 ulps of
# the case's largest reference gradient.
BWD_ULPS = 4
# Autograd through A, B and flash_attention in bf16 on the card against
# autograd through their plain versions in f32 on the card, same (bf16)
# inputs: the relative RMS of each gradient (bf16 operands and outputs)
GRAD_TOL = 2e-2
# The training operating point (configs/train-avatars.yaml,
# tools/profile_train.py): batch 8 of 57-frame 320 x 192 clips, latents
# [8, 8, 6, 10, 128] = 480 tokens, 256 caption tokens of which 200 kept
TRAIN_BATCH, TRAIN_GRID, TRAIN_TOKENS = 8, (8, 6, 10), 480
TRAIN_ACCUM, TRAIN_STEPS = 2, 3


def _bwd_case(g, b, lq, lk, kept=None, empty_row=False, bounded=False, d=HEAD_DIM):
    """bf16 head-major q, k, v (WIDTH / d heads of d), the output gradient,
    an optional keep-mask (``kept`` keys of each sample, or a tuple of each
    sample's; the last sample fully masked with ``empty_row``) and the forward's O and lse from the
    kernel path."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    h = WIDTH // d
    q, k = rms_rows(randn(b, h, lq, d)), rms_rows(randn(b, h, lk, d))
    v, gout = randn(b, h, lk, d), randn(b, h, lq, d)
    mask = None
    if kept is not None:
        mask = torch.ones(b, lk, device="cuda")
        for i, n in enumerate(kept if isinstance(kept, tuple) else (kept,) * b):
            mask[i, n:] = 0.0
        if empty_row:
            mask[-1] = 0.0
    with torch.no_grad():
        out, lse = fa.flash_attention(q, k, v, kv_mask=mask, bounded_logits=bounded,
                                      with_lse=True)
    return q, k, v, gout, mask, out, lse


def _bwd_work(q, k, mask):
    """(dkv operations, dq operations, dkv bytes, dq bytes) of the flash
    backward: 4 (dkv) or 3 (dq) products of 2 * Lq * D per kept key and
    head; each input read once (k and v of the kept keys) and each gradient
    written once."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    kept = _kept_keys(b, lk, mask)
    product = 2.0 * h * lq * d * kept
    reads = (2 * b * h * lq * d + 2 * h * kept * d) * 2 + 2 * b * h * lq * 4 + (
        0 if mask is None else b * lk * 4)
    return 4 * product, 3 * product, reads + 2 * b * h * lk * d * 2, reads + b * h * lq * d * 2


def _wmma_backward_entries():
    """F's bf16 / 64 WMMA kernels of csrc/flash_backward.cu called directly
    (no counter): to time them at the shapes the Hopper kernels took over
    from them."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa

    dkv = fa._c_entry("flash_backward", "flash_bwd_dkv_bf16", 9, 5, bounded_flag=False)
    dq = fa._c_entry("flash_backward", "flash_bwd_dq_bf16", 8, 5, bounded_flag=False)

    def call(kernel, q, k, v, gout, lse, delta, mask, scale, outs):
        b, h, lq, d = q.shape
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), gout.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), None if mask is None else mask.data_ptr()]
        args += [t.data_ptr() for t in outs] + [b, h, lq, k.shape[2], d, float(scale),
                                                torch.cuda.current_stream().cuda_stream]
        err = (dkv if kernel == "dkv" else dq)(*args)
        if err:
            fail(f"flash_bwd_{kernel}_bf16 (WMMA) failed with {err}")
    return call


def check_flash_backward(peaks):
    """Kernels flash_bwd_dkv and flash_bwd_dq on the Hopper route
    (``flash_backward_sm90.cu``) against the plain version, bf16: at the
    training shapes (self-attention [8, 32, 480, 64] with lse from the
    whole-row kernel E; cross-attention 480 x 256 with 200 keys kept and one
    sample fully masked), at 5376 tokens with lse from the max-free kernel C
    and from the online kernel D, ragged 477 x 250 with a mask, and at head
    dim 128 ([1, 16, 5376, 128]). Then times at the three main shapes: each
    Hopper kernel and the WMMA kernel it replaced on the same inputs (CUDA
    events), the whole plain backward, the backward of the library
    attention (``scaled_dot_product_attention`` through
    ``torch.autograd.grad``, minus its forward), and each kernel's bound;
    the Hopper kernels also at head dim 128."""
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(21)
    scale = HEAD_DIM**-0.5
    b = TRAIN_BATCH
    cases = {
        f"self {b}x{TRAIN_TOKENS}": _bwd_case(g, b, TRAIN_TOKENS, TRAIN_TOKENS),
        f"cross {b}x{TRAIN_TOKENS}x{CAPTION}, masked row": _bwd_case(
            g, b, TRAIN_TOKENS, CAPTION, kept=200, empty_row=True),
        f"{LONG_TOKENS}, lse of C": _bwd_case(g, 1, LONG_TOKENS, LONG_TOKENS, bounded=True),
        f"{LONG_TOKENS}, lse of D": _bwd_case(g, 1, LONG_TOKENS, LONG_TOKENS),
        "ragged 2x477x250, masked": _bwd_case(g, 2, 477, 250, kept=190),
        f"audio cross {b}x{TRAIN_TOKENS}x86": _bwd_case(g, b, TRAIN_TOKENS, 86,
                                                        kept=AUDIO_FRAMES["T86"]),
        f"d=128 {LONG_TOKENS}, lse of C": _bwd_case(g, 1, LONG_TOKENS, LONG_TOKENS,
                                                    bounded=True, d=128),
    }
    dkv_err = KernelErrors("flash_bwd_dkv_sm90", BWD_ULPS)
    dq_err = KernelErrors("flash_bwd_dq_sm90", BWD_ULPS)
    want = {"flash_bwd_dkv": 1, "flash_bwd_dq": 1, "flash_bwd_dkv_sm90": 1,
            "flash_bwd_dq_sm90": 1}
    for label, (q, k, v, gout, mask, out, lse) in cases.items():
        scale = q.shape[-1]**-0.5
        before = dict(fa.launch_counts)
        dq, dk, dv = fa._flash_backward(q, k, v, mask, out, lse, gout, scale)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
        if launched != want:
            fail(f"flash backward {label}: launched {launched}, expected {want}")
        ref_dq, ref_dk, ref_dv = fa._flash_backward_plain(q, k, v, mask, out, lse, gout, scale)
        dkv_err.add(f"{label}: dk", dk, ref_dk)
        dkv_err.add(f"{label}: dv", dv, ref_dv)
        dq_err.add(f"{label}: dq", dq, ref_dq)
        if mask is not None and bool((mask[-1] == 0).all()) and not all(
                bool((x[-1] == 0).all()) for x in (dq, dk, dv)):
            fail(f"flash backward {label}: a fully masked sample has nonzero gradients")
        del ref_dq, ref_dk, ref_dv
    (dkv_e, dkv_tol), (dq_e, dq_tol) = dkv_err.check(), dq_err.check()

    wmma = _wmma_backward_entries()
    scale = HEAD_DIM**-0.5
    timed = {}
    for label in (f"self {b}x{TRAIN_TOKENS}", f"cross {b}x{TRAIN_TOKENS}x{CAPTION}, "
                  "masked row", f"{LONG_TOKENS}, lse of C"):
        q, k, v, gout, mask, out, lse = cases[label]
        delta = (gout.float() * out.float()).sum(-1)
        dkv_ops, dq_ops, dkv_bytes, dq_bytes = _bwd_work(q, k, mask)
        keep = None if mask is None else (mask > 0.5)[:, None, None, :]
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        outs = (torch.empty_like(k), torch.empty_like(v), torch.empty_like(q))

        def lib_fwd():
            return F.scaled_dot_product_attention(*leaves, attn_mask=keep)

        fwd_ms = time_ms(lib_fwd)
        timed[label] = {
            "dkv_ms": time_ms(lambda: fa.flash_bwd_dkv(q, k, v, gout, lse, delta, mask,
                                                       scale)),
            "dq_ms": time_ms(lambda: fa.flash_bwd_dq(q, k, v, gout, lse, delta, mask,
                                                     scale)),
            "dkv_wmma_ms": time_ms(lambda: wmma("dkv", q, k, v, gout, lse, delta, mask,
                                                scale, outs[:2])),
            "dq_wmma_ms": time_ms(lambda: wmma("dq", q, k, v, gout, lse, delta, mask,
                                               scale, outs[2:])),
            "plain_ms": time_ms(lambda: fa._flash_backward_plain(
                q, k, v, mask, out, lse, gout, scale), reps=2, batches=3),
            "library_backward_ms": time_ms(lambda: torch.autograd.grad(
                lib_fwd(), leaves, gout)) - fwd_ms,
            "dkv_bound": bound(dkv_ops, dkv_bytes, peaks),
            "dq_bound": bound(dq_ops, dq_bytes, peaks),
            "dkv_flops": dkv_ops, "dq_flops": dq_ops,
        }
        del outs
    q, k, v, gout, mask, out, lse = cases[f"d=128 {LONG_TOKENS}, lse of C"]
    delta = (gout.float() * out.float()).sum(-1)
    dkv_ops, dq_ops, dkv_bytes, dq_bytes = _bwd_work(q, k, mask)
    d128 = {"shape": list(q.shape),
            "dkv_ms": time_ms(lambda: fa.flash_bwd_dkv(q, k, v, gout, lse, delta, mask,
                                                       128**-0.5)),
            "dq_ms": time_ms(lambda: fa.flash_bwd_dq(q, k, v, gout, lse, delta, mask,
                                                     128**-0.5)),
            "dkv_bound_ms": bound(dkv_ops, dkv_bytes, peaks)[0],
            "dq_bound_ms": bound(dq_ops, dq_bytes, peaks)[0]}
    main = timed[f"self {b}x{TRAIN_TOKENS}"]
    rows = []
    for name, err, tol, line in (("flash_bwd_dkv_sm90", dkv_e, dkv_tol, 996),
                                 ("flash_bwd_dq_sm90", dq_e, dq_tol, 1058)):
        short = name.split("_")[2]
        rows.append({"name": name, "route": "cuda", "source": SM90_BWD_SOURCE,
                     "replaces": f"avatar_tpu/ops/flash_attention.py:{line}",
                     "max_abs_err": err, "tol": tol, "ms": main[f"{short}_ms"],
                     "wmma_ms": main[f"{short}_wmma_ms"],
                     "plain_ms": main["plain_ms"], "bound_ms": main[f"{short}_bound"][0],
                     "bound_by": main[f"{short}_bound"][1],
                     "library_ms": main["library_backward_ms"],
                     "shape": f"[{b}, {HEADS}, {TRAIN_TOKENS}, {HEAD_DIM}] self-attention",
                     "plain_and_library_cover": "the whole backward (dq, dk, dv)"})
    for short, err in (("dkv", dkv_err), ("dq", dq_err)):
        emit({"phase": f"kernel_flash_bwd_{short}", "route": "sm90", "errors": err.errs,
              "limits": err.tols, "ulps": BWD_ULPS,
              "times": {label: {"ms": t[f"{short}_ms"], "wmma_ms": t[f"{short}_wmma_ms"],
                                "speedup_over_wmma": t[f"{short}_wmma_ms"] / t[f"{short}_ms"],
                                "plain_ms": t["plain_ms"],
                                "library_backward_ms": t["library_backward_ms"],
                                "bound_us": t[f"{short}_bound"][0] * 1e3,
                                "bound_by": t[f"{short}_bound"][1],
                                "fraction_of_bound": t[f"{short}_bound"][0] / t[f"{short}_ms"],
                                "flops": t[f"{short}_flops"]}
                        for label, t in timed.items()},
              "d128": {"shape": d128["shape"], "ms": d128[f"{short}_ms"],
                       "bound_us": d128[f"{short}_bound_ms"] * 1e3}})
    return rows


def check_attention_gradients():
    """Autograd through the three attention entries on the card, bf16,
    against autograd through their plain versions in f32 on the card from
    the same inputs: A and B at the training shapes (480 tokens, 256
    caption keys, batch 8, one sample's caption fully masked), head-major
    flash_attention at 2 x 1100 masked, bounded (C) and not (D). Each entry
    must launch its forward kernel and the flash backward."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(22)
    scale = HEAD_DIM**-0.5
    b = TRAIN_BATCH

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    rq, rk, rv, cos, sin = rope_inputs(g, b, TRAIN_TOKENS, TRAIN_GRID)
    tq, tk, tv = (rms_rows(randn(b, TRAIN_TOKENS, WIDTH)), rms_rows(randn(b, CAPTION, WIDTH)),
                  randn(b, CAPTION, WIDTH))
    tmask = torch.ones(b, CAPTION, device="cuda")
    tmask[:, 200:] = 0.0
    tmask[-1] = 0.0
    hq, hk, hv = (rms_rows(randn(2, HEADS, 1100, HEAD_DIM)),
                  rms_rows(randn(2, HEADS, 1100, HEAD_DIM)), randn(2, HEADS, 1100, HEAD_DIM))
    hmask = torch.ones(2, 1100, device="cuda")
    hmask[1, 900:] = 0.0
    cases = {
        "rope_fused_attention": ((rq, rk, rv), lambda q, k, v: fa.rope_fused_attention(
            q, k, v, cos, sin, HEADS, scale, True),
            lambda q, k, v: fa._rope_attention_plain(q, k, v, cos, sin, HEADS, scale, True),
            "rope_fused_attention_sm90"),
        "fused_token_attention": ((tq, tk, tv), lambda q, k, v: fa.fused_token_attention(
            q, k, v, tmask, HEADS, scale, True),
            lambda q, k, v: fa._token_attention_plain(q, k, v, tmask, HEADS, scale, True),
            "fused_token_attention_sm90"),
    }
    for bounded, mode in ((True, "bounded"), (False, "online")):
        cases[f"flash_attention {mode}"] = (
            (hq, hk, hv), lambda q, k, v, bd=bounded: fa.flash_attention(
                q, k, v, kv_mask=hmask, scale=scale, bounded_logits=bd),
            lambda q, k, v, m=mode: fa._flash_plain(q, k, v, hmask, scale, m)[0],
            f"flash_{mode}")
    results = {}
    for label, (inputs, kernel, plain, forward) in cases.items():
        gout = randn(*kernel(*inputs).shape)
        before = dict(fa.launch_counts)
        leaves = [t.detach().requires_grad_() for t in inputs]
        got = torch.autograd.grad(kernel(*leaves), leaves, gout)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
        if not (launched.get(forward) and launched.get("flash_bwd_dkv_sm90")
                and launched.get("flash_bwd_dq_sm90") and not launched.get("flash_bwd_dkv_wmma")
                and not launched.get("flash_bwd_dq_wmma")):
            fail(f"gradient of {label}: launched {launched}, expected the Hopper backward")
        leaves32 = [t.detach().float().requires_grad_() for t in inputs]
        want = torch.autograd.grad(plain(*leaves32), leaves32, gout.float())
        errs = [_rel_rms(a.float(), w) for a, w in zip(got, want)]
        results[label] = {"rel_rms_dq_dk_dv": errs, "launched": launched}
        if not all(math.isfinite(e) and e <= GRAD_TOL for e in errs):
            fail(f"gradient of {label} disagrees with its plain version's: {errs}")
    emit({"phase": "attention_gradients", "tol": GRAD_TOL, "results": results})


# The dense-bias attention (G) against its plain version, per case: the
# output within KERNEL_ULPS bf16 ulps of the case's largest plain output and
# lse within LSE_TOL (the forward's running max against the whole-row max,
# sums in another order); dQ, dK, dV and dBias within BWD_ULPS bf16 ulps of
# the case's largest reference gradient (p and dS rounded to bf16 at the
# same places, f32 sums in another order; dBias sums the heads of a slab in
# the same order). Two shapes: T5-XXL's self-attention, [2, 64, 256, 64]
# with a per-head bias built as ``t5_encode`` builds it, and the 2B DiT's
# long self-attention, [1, 32, 5376, 64] with one shared bias.
T5_BATCH, T5_HEADS, T5_TOKENS = 2, 64, 256
# keys kept of the prompt's and the negative prompt's 256 (the t5 phase)
T5_KEPT = (200, 40)
# G's four kernels: (the counter of every launch, the kernel's key in the
# route counters flash_dense_<key>_sm90 / _wmma, the TPU kernel's line)
DENSE_ROWS = (("flash_dense_forward", "fwd", 317), ("flash_dense_bwd_dkv", "bwd_dkv", 1328),
              ("flash_dense_bwd_dq", "bwd_dq", 1367), ("flash_dense_bwd_db", "bwd_db", 1397))
# bf16 at head dim 64 / 128 with Lk % 4 == 0 runs csrc/flash_dense_sm90.cu,
# every other case csrc/flash_dense.cu (fa.dense_impl)
DENSE_SM90_SOURCE = "avatar_tpu_torch/csrc/flash_dense_sm90.cu"
# a key length whose f32 bias rows the Hopper kernels' tensor maps cannot
# step (Lk % 4 != 0): the WMMA route
DENSE_RAGGED_LK = 254


def dense_launches(route, times=1):
    """The counters G's four kernels move on ``route``, ``times`` each."""
    return {**{total: times for total, _, _ in DENSE_ROWS},
            **{f"flash_dense_{key}_{route}": times for _, key, _ in DENSE_ROWS}}


def dense_cases(g):
    """{label: (q, k, v, bias [B, 1|H, Lq, Lk] f32, output gradient, scale,
    fully masked query row or None)}, bf16 on the card."""
    import torch

    from avatar_tpu_torch.models.t5 import KEY_PADDING_BIAS, compute_position_bias

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).bfloat16()

    # T5: unscaled logits of O(1) (the scale sits in T5's weights), the
    # relative-position bias of a seeded [32, 64] table plus -1e9 on the 56
    # padded keys of 256
    b, h, n = T5_BATCH, T5_HEADS, T5_TOKENS
    table = torch.randn(32, h, generator=g, device="cuda") * 0.1
    t5_bias = compute_position_bias(table, n, n, 32, 128).repeat(b, 1, 1, 1)
    t5_bias[..., T5_KEPT[0]:] += KEY_PADDING_BIAS
    t5 = (randn(b, h, n, HEAD_DIM, scale=HEAD_DIM**-0.25),
          randn(b, h, n, HEAD_DIM, scale=HEAD_DIM**-0.25), randn(b, h, n, HEAD_DIM),
          t5_bias, randn(b, h, n, HEAD_DIM), 1.0, None)
    # the DiT's long self-attention: one seeded bias shared by the 32 heads,
    # -1e30 on a band of keys and on every key of query row 77
    n = LONG_TOKENS
    long_bias = torch.randn(1, 1, n, n, generator=g, device="cuda")
    long_bias[..., 2000:2500] = -1e30
    long_bias[:, :, 77] = -1e30
    dit = (rms_rows(randn(1, HEADS, n, HEAD_DIM)), rms_rows(randn(1, HEADS, n, HEAD_DIM)),
           randn(1, HEADS, n, HEAD_DIM), long_bias, randn(1, HEADS, n, HEAD_DIM),
           HEAD_DIM**-0.5, 77)
    return {f"t5 [{b}, {h}, {T5_TOKENS}, {HEAD_DIM}] per-head bias": t5,
            f"dit [1, {HEADS}, {n}, {HEAD_DIM}] shared bias": dit}


def _dense_work(q, k, bias3):
    """(operations, bytes) of each of G's kernels: 2, 4, 3 and 2 products
    of 2 * Lq * Lk * D per head (forward s and PV; dK/dV s, dP, dV, dK; dQ
    s, dP, dQ; dBias s, dP); each input read once and each output written
    once (the bias f32, lse and delta f32, dBias f32)."""
    b, h, lq, d = q.shape
    lk = k.shape[2]
    product = 2.0 * b * h * lq * lk * d
    qo, kv = b * h * lq * d * 2, b * h * lk * d * 2
    rows, bias_bytes = b * h * lq * 4, bias3.numel() * 4
    fwd_in = qo + 2 * kv + bias_bytes
    bwd_in = fwd_in + qo + 2 * rows
    return {"flash_dense_forward": (2 * product, fwd_in + qo + rows),
            "flash_dense_bwd_dkv": (4 * product, bwd_in + 2 * kv),
            "flash_dense_bwd_dq": (3 * product, bwd_in + qo),
            "flash_dense_bwd_db": (2 * product, bwd_in + bias_bytes)}


def _dense_run(fa, q, k, v, bias3, gout, scale):
    """(out, lse, dq, dk, dv, db) through G's four wrappers, on the route
    ``dense_impl`` names."""
    out, lse = fa._flash_dense_forward(q, k, v, bias3, scale)
    delta = (gout.float() * out.float()).sum(-1)
    dk, dv = fa.flash_dense_bwd_dkv(q, k, v, gout, lse, delta, bias3, scale)
    dq = fa.flash_dense_bwd_dq(q, k, v, gout, lse, delta, bias3, scale)
    db = fa.flash_dense_bwd_db(q, k, v, gout, lse, delta, bias3, scale)
    return out, lse, dq, dk, dv, db


def _dense_c_calls(fa, route, q, k, v, bias3, gout, scale):
    """G's four kernels of ``route`` ("sm90" or "wmma") called through their
    C entries (no counter), to compare the routes on the same contiguous
    inputs: ({kernel: call}, run). Each call writes its outputs into
    buffers of its own; the backward calls read the lse and delta that
    ``run`` leaves, which runs all four in order and returns (out, lse, dq,
    dk, dv, db)."""
    import torch

    b, heads, lq, d = q.shape
    dims = (b, heads, lq, k.shape[2], b * heads // bias3.shape[0], d, float(scale))
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, lq), device=q.device, dtype=torch.float32)
    delta = torch.empty_like(lse)
    dq, dk, dv, db = (torch.empty_like(t) for t in (q, k, v, bias3))
    outs = {"fwd": (out, lse), "bwd_dkv": (dk, dv), "bwd_dq": (dq,), "bwd_db": (db,)}

    def caller(kernel):
        name, fn = fa._dense_entry(kernel, route, q.dtype, d)
        ins = (q, k, v, bias3) if kernel == "fwd" else (q, k, v, gout, lse, delta, bias3)
        ptrs = [t.data_ptr() for t in ins + outs[kernel]]

        def call():
            err = fn(*ptrs, *dims, torch.cuda.current_stream().cuda_stream)
            if err:
                fail(f"{name} failed with cudaError_t {err}")
        return call

    calls = {kernel: caller(kernel) for kernel in outs}

    def run():
        calls["fwd"]()
        delta.copy_((gout.float() * out.float()).sum(-1))
        for kernel in ("bwd_dkv", "bwd_dq", "bwd_db"):
            calls[kernel]()
        return out, lse, dq, dk, dv, db
    return calls, run


def _dense_errors(fa, errors, label, q, k, v, bias3, gout, scale, got):
    """Adds each kernel's error against its plain version to ``errors``
    (by total counter); returns the lse error over the live rows."""
    out, lse, dq, dk, dv, db = got
    ref, ref_lse = fa._flash_dense_plain(q, k, v, bias3, scale)
    errors["flash_dense_forward"].add(label, out, ref)
    live = ref_lse < 1e29
    lse_err = (lse - ref_lse)[live].abs().max().item()
    del ref, ref_lse
    want = fa._flash_dense_backward_plain(q, k, v, bias3, out, lse, gout, scale)
    for name, grad, a, b in (("flash_dense_bwd_dkv", "dk", dk, want[1]),
                             ("flash_dense_bwd_dkv", "dv", dv, want[2]),
                             ("flash_dense_bwd_dq", "dq", dq, want[0]),
                             ("flash_dense_bwd_db", "dbias", db, want[3])):
        errors[name].add(f"{label}: {grad}", a, b)
    return lse_err


def check_flash_dense(peaks):
    """G's four kernels on the Hopper route (``csrc/flash_dense_sm90.cu``)
    against their plain versions at the two shapes of :func:`dense_cases`,
    the backward from the forward kernel's own O and lse; the fully masked
    query row 77 gives O = 0, lse = 1e30, dQ = 0 and dBias = 0. The WMMA
    kernels (``csrc/flash_dense.cu``, through their C entries) run on the
    same inputs, held to the same gates, and the two routes' distance is
    printed. One more case, Lk = 254 (Lk % 4 != 0), takes the WMMA route
    and is held to the gates. Then each kernel's device time (profiler) and
    time per call (CUDA events), the WMMA kernel's device time, its bound,
    the plain version's time (the forward; the whole backward for the three
    backward rows) and the library's device time:
    ``scaled_dot_product_attention`` with the bias as its bf16
    ``attn_mask``, forward, and its autograd backward (bias included)
    minus its forward."""
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(23)

    def gates(route):
        return {total: KernelErrors(f"flash_dense_{key}_{route}",
                                    KERNEL_ULPS if key == "fwd" else BWD_ULPS)
                for total, key, _ in DENSE_ROWS}

    errors, wmma_errors = gates("sm90"), gates("wmma")
    lse_errs, wmma_lse_errs, routes_apart, timed = {}, {}, {}, {}
    for label, (q, k, v, bias, gout, scale, masked_row) in dense_cases(g).items():
        bias3 = fa._dense_bias3(bias)
        if fa.dense_impl(q.dtype, q.shape[-1], k.shape[2]) != "sm90":
            fail(f"flash_dense {label}: dense_impl does not name the Hopper route")
        before = dict(fa.launch_counts)
        out, lse = fa._flash_dense_forward(q, k, v, bias3, scale)
        dq, dk, dv, db = fa._flash_dense_backward(q, k, v, bias3, out, lse, gout, scale,
                                                  with_db=True)
        torch.cuda.synchronize()
        launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
        if launched != dense_launches("sm90"):
            fail(f"flash_dense {label}: launched {launched}, expected the four Hopper kernels")
        got = (out, lse, dq, dk, dv, db)
        lse_errs[label] = _dense_errors(fa, errors, label, q, k, v, bias3, gout, scale, got)
        if masked_row is not None:
            r = masked_row
            if not all(bool(x.all()) for x in (
                    out[:, :, r] == 0, lse[:, :, r] == fa.LSE_MASKED, dq[:, :, r] == 0,
                    db[:, r] == 0)):
                fail(f"flash_dense {label}: the fully masked row {r} is not 0 (lse 1e30)")
        wmma_calls, wmma_run = _dense_c_calls(fa, "wmma", q, k, v, bias3, gout, scale)
        wmma = wmma_run()
        torch.cuda.synchronize()
        wmma_lse_errs[label] = _dense_errors(fa, wmma_errors, label, q, k, v, bias3, gout,
                                             scale, wmma)
        # the two routes' distance, in bf16 ulps of the WMMA output's largest value
        routes_apart[label] = {
            name: (a.float() - b.float()).abs().max().item()
            / (2.0**-8 * b.float().abs().max().item())
            for name, a, b in zip(("out", "dq", "dk", "dv", "dbias"),
                                  (out, dq, dk, dv, db), wmma[:1] + wmma[2:])}
        del wmma, dq, dk, dv, db
        delta = (gout.float() * out.float()).sum(-1)
        work = _dense_work(q, k, bias3)
        lib_leaves = [t.detach().requires_grad_() for t in (q, k, v, bias.to(q.dtype))]

        def lib_fwd():
            return F.scaled_dot_product_attention(*lib_leaves[:3], attn_mask=lib_leaves[3],
                                                  scale=scale)

        lib_fwd_ms = device_ms(lib_fwd)
        lib_all_ms = device_ms(lambda: torch.autograd.grad(lib_fwd(), lib_leaves, gout))
        lib_bwd_ms = lib_all_ms - lib_fwd_ms
        if isinstance(lib_all_ms, EventsMs) or isinstance(lib_fwd_ms, EventsMs):
            lib_bwd_ms = EventsMs(lib_bwd_ms)
        plain_bwd_ms = time_ms(lambda: fa._flash_dense_backward_plain(
            q, k, v, bias3, out, lse, gout, scale), reps=2, batches=3)
        calls = {
            "fwd": lambda: fa._flash_dense_forward(q, k, v, bias3, scale),
            "bwd_dkv": lambda: fa.flash_dense_bwd_dkv(q, k, v, gout, lse, delta, bias3, scale),
            "bwd_dq": lambda: fa.flash_dense_bwd_dq(q, k, v, gout, lse, delta, bias3, scale),
            "bwd_db": lambda: fa.flash_dense_bwd_db(q, k, v, gout, lse, delta, bias3, scale)}
        plain_ms = {"fwd": time_ms(lambda: fa._flash_dense_plain(q, k, v, bias3, scale),
                                   reps=2, batches=3)}
        timed[label] = {}
        for total, key, _ in DENSE_ROWS:
            call = calls[key]
            ops, nbytes = work[total]
            bound_ms, bound_by = bound(ops, nbytes, peaks)
            timed[label][total] = {
                "ms": device_ms(call, f"flash_dense_{key}_sm90_kernel"),
                "events_ms_per_call": time_ms(call),
                "wmma_ms": device_ms(wmma_calls[key], f"flash_dense_{key}_kernel", reps=5),
                "plain_ms": plain_ms.get(key, plain_bwd_ms),
                "library_ms": lib_fwd_ms if key == "fwd" else lib_bwd_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "flops": ops, "bytes": nbytes}
        del out, lse, delta, lib_leaves, wmma_calls, wmma_run
        torch.cuda.empty_cache()
    # Lk % 4 != 0: the WMMA route, held to the same gates
    lk = DENSE_RAGGED_LK

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    q, k = (rms_rows(randn(2, 8, n, HEAD_DIM)).bfloat16() for n in (256, lk))
    v, gout = randn(2, 8, lk, HEAD_DIM).bfloat16(), randn(2, 8, 256, HEAD_DIM).bfloat16()
    bias = randn(2, 1, 256, lk)
    bias[..., 90:120] = -1e30
    bias3 = fa._dense_bias3(bias)
    ragged_label = f"[2, 8, 256, {HEAD_DIM}] x Lk {lk}, shared bias"
    route = fa.dense_impl(q.dtype, HEAD_DIM, lk)
    before = dict(fa.launch_counts)
    got = _dense_run(fa, q, k, v, bias3, gout, HEAD_DIM**-0.5)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    if route != "wmma" or launched != dense_launches("wmma"):
        fail(f"flash_dense {ragged_label}: route {route}, launched {launched}")
    wmma_lse_errs[ragged_label] = _dense_errors(fa, wmma_errors, ragged_label, q, k, v,
                                                bias3, gout, HEAD_DIM**-0.5, got)
    del got
    checked = {name: err.check() for name, err in errors.items()}
    wmma_checked = {name: err.check() for name, err in wmma_errors.items()}
    for errs in (lse_errs, wmma_lse_errs):
        lse_err = max(errs.values())
        if not (math.isfinite(lse_err) and lse_err <= LSE_TOL):
            fail(f"flash_dense forward: lse disagrees with its plain version's: {errs}")
    t5_label, dit_label = list(timed)
    rows = []
    for total, key, line in DENSE_ROWS:
        err, tol = checked[total]
        main = timed[t5_label][total]
        name = f"flash_dense_{key}_sm90"
        row = {"name": name, "route": "cuda", "source": DENSE_SM90_SOURCE,
               "replaces": f"avatar_tpu/ops/flash_attention.py:{line}",
               "max_abs_err": err, "tol": tol, "ms": main["ms"], "plain_ms": main["plain_ms"],
               "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
               "library_ms": main["library_ms"], "wmma_ms": main["wmma_ms"],
               "shape": t5_label,
               "long_shape": {"shape": dit_label, **{
                   k: timed[dit_label][total][k]
                   for k in ("ms", "wmma_ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")}}}
        if key != "fwd":
            row["plain_and_library_cover"] = "the whole backward (dq, dk, dv, dbias)"
        rows.append(row)
        emit({"phase": f"kernel_{name}", "errors": errors[total].errs,
              "limits": errors[total].tols,
              "wmma_errors": wmma_errors[total].errs, "wmma_limits": wmma_errors[total].tols,
              "wmma_max_abs_err_and_tol": wmma_checked[total],
              **({"lse_errors": lse_errs, "wmma_lse_errors": wmma_lse_errs,
                  "lse_tol": LSE_TOL} if key == "fwd" else {"ulps": BWD_ULPS}),
              "routes_apart_in_ulps": routes_apart,
              "times": {label: t[total] for label, t in timed.items()}})
    return rows


def check_attention_dense_bias():
    """G's driven path: autograd through ``scaled_dot_product_attention(q,
    k, v, mask=<4-D bias requiring grad>, impl="flash")`` in bf16 on the
    card at both shapes of :func:`dense_cases`, against autograd through the
    plain forward in f32 on the card from the same inputs: out, dQ, dK, dV
    and dBias each within GRAD_TOL relative RMS. Each of G's four kernels
    launches exactly twice (once per shape) and no other kernel runs."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.ops.attention import scaled_dot_product_attention

    g = torch.Generator(device="cuda").manual_seed(24)
    cases = dense_cases(g)
    results = {}
    reset_counts()
    for label, (q, k, v, bias, gout, scale, _) in cases.items():
        leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        out = scaled_dot_product_attention(*leaves[:3], mask=leaves[3], scale=scale,
                                           impl="flash")
        got = (out,) + torch.autograd.grad(out, leaves, gout)
        torch.cuda.synchronize()
        results[label] = [t.detach() for t in got]
        del out, got, leaves
    launches = {k: n for k, n in read_counts().items() if n}
    for label, (q, k, v, bias, gout, scale, _) in cases.items():
        leaves32 = [t.detach().float().requires_grad_() for t in (q, k, v, bias)]
        ref = fa._flash_dense_plain(*leaves32[:3], fa._dense_bias3(leaves32[3]), scale)[0]
        want = (ref.detach(),) + torch.autograd.grad(ref, leaves32, gout.float())
        errs = [_rel_rms(a.float(), w) for a, w in zip(results[label], want)]
        results[label] = dict(zip(("out", "dq", "dk", "dv", "dbias"), errs))
        del ref, want, leaves32
        torch.cuda.empty_cache()
        if not all(math.isfinite(e) and e <= GRAD_TOL for e in errs):
            fail(f"attention_dense_bias {label}: the card disagrees with the plain "
                 f"versions in f32: {results[label]}")
    expect = dense_launches("sm90", len(cases))
    emit({"phase": "attention_dense_bias", "tol": GRAD_TOL, "rel_rms": results,
          "launches": launches})
    if launches != expect:
        fail(f"attention_dense_bias: launched {launches}, expected {expect}")
    return launches


# Tiny training runs: a DiT of 2 heads of 64 (so the CUDA kernels take it)
# and 128 tokens (so the backwards take the flash route: 128 * 128 is the
# route rule's threshold), 2 layers, 2 optimizer steps of 2 micro-batches
TINY_TRAIN_DIT = dict(num_attention_heads=2, attention_head_dim=64, in_channels=16,
                      out_channels=16, num_layers=2, cross_attention_dim=128,
                      caption_channels=64)
# The card's bf16 training against f32 on the CPU fed the same weights (the
# bf16 values), t and noise, with t * 1000 rounded in the model as bf16
# rounds it (the timestep embedding's input; see REFERENCE_TOL): the loss of
# each step within TRAIN_LOSS_RTOL, and the change of the trainable tree over
# the two steps within TRAIN_UPDATE_TOL relative RMS. Adam's first steps
# are near sign(g) * lr, so elements whose gradient bf16 moves across 0
# dominate the second: a CPU rehearsal of the same runs in bf16 read
# 1e-4 / 1.3e-3 on the loss and 0.05 / 0.06 on the update (lora_audio /
# full), 0.035 between its kernel path and its plain attention path.
TRAIN_LOSS_RTOL = 5e-3
TRAIN_UPDATE_TOL = 0.15


def _tiny_train_setup():
    import torch

    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.train.train import clamp_rf_timesteps

    dcfg = DiTConfig(**TINY_TRAIN_DIT)
    # bf16 values held in f32, so that both devices train the same model
    params = _tree_to(_tree_to(init_dit(dcfg, 2, device="cpu"), "cpu", torch.bfloat16),
                      "cpu", torch.float32)
    g = torch.Generator().manual_seed(3)
    accum, micro, frames, hw, ch, cap = TRAIN_ACCUM, 2, 2, 8, 16, 128
    batch = {k: torch.randn(accum, micro, f, hw, hw, ch, generator=g)
             for k, f in (("latents", frames), ("pose_latents", frames),
                          ("ref_image_latents", 1))}
    embeds = torch.randn(1, cap, TINY_TRAIN_DIT["caption_channels"], generator=g)
    mask = torch.ones(1, cap)
    mask[0, 100:] = 0.0
    draws = [(clamp_rf_timesteps(torch.randn(accum * micro, generator=g), -0.5, 1.0,
                                 0.005, 0.999).reshape(accum, micro),
              torch.randn(accum, micro, frames * hw * hw, ch, generator=g))
             for _ in range(2)]
    return dcfg, params, batch, embeds, mask, draws


def _tiny_train_config(mode):
    from avatar_tpu_torch.core.config import TrainConfig

    return TrainConfig(checkpoint_path="-", train_mode=mode, learning_rate=1e-3,
                       lora_rank=8, lora_alpha=8, gradient_accumulation_steps=TRAIN_ACCUM,
                       batch_size=2, rf_log_normal_mu=-0.5, rf_log_normal_sigma=1.0)


def _tiny_train_run(setup, mode, device, dtype, impl="auto"):
    """Two optimizer steps; returns (initial trainable, final trainable,
    losses, launches), trees f32 on the CPU."""
    import torch

    from avatar_tpu_torch.models.dit import permute_dit_params_for_split_rope
    from avatar_tpu_torch.train import train as tt

    dcfg, params, batch, embeds, mask, draws = setup
    cfg = _tiny_train_config(mode)
    tr0 = tt.init_trainable(params, dcfg, cfg, torch.Generator().manual_seed(1))
    split = mode == "lora_audio"
    dit = _tree_to(params, device, dtype)
    run = permute_dit_params_for_split_rope(dit, dcfg) if split else dit
    opt = tt.make_optimizer(cfg)
    tr = _tree_to(tr0, device, torch.float32)
    state = opt.init(tr)
    step = tt.make_train_step(dcfg, cfg, opt, attention_impl=impl, rope_split=split)
    losses = []
    reset_counts()
    for t, noise in draws:
        tr, state, metrics = step(tr, state, run, _tree_to(batch, device, torch.float32),
                                  embeds.to(device), mask.to(device), t=t.to(device),
                                  noise=noise.to(device))
        losses.append(float(metrics["loss"]))
    launches = {k: n for k, n in read_counts().items() if n}
    return tr0, _tree_to(tr, "cpu", torch.float32), losses, launches


def _update_rel_rms(tr0, a, b):
    """RMS of the difference of two runs' changes to the trainable tree,
    over the RMS of ``b``'s change."""
    import torch

    from avatar_tpu_torch.train.train import tree_leaves

    da = torch.cat([(x - y).flatten() for x, y in zip(tree_leaves(a), tree_leaves(tr0))])
    db = torch.cat([(x - y).flatten() for x, y in zip(tree_leaves(b), tree_leaves(tr0))])
    return ((da - db).norm() / db.norm()).item()


def check_reference_train():
    """The tiny DiT trained 2 steps with accumulation 2 in "lora_audio"
    (split RoPE: A, B) and "full" (B for both attentions) mode: bf16 on the
    card through the kernels, against f32 on the CPU (plain versions, t
    rounded as bf16 rounds it) and against bf16 on the card with
    ``attention_impl="xla"`` (no kernel). Each kernel launched exactly as
    often as the path calls it."""
    from unittest import mock

    import torch

    from avatar_tpu_torch.train import train as tt

    setup = _tiny_train_setup()
    layers, micro_steps = TINY_TRAIN_DIT["num_layers"], 2 * TRAIN_ACCUM
    apply = tt.dit_apply

    def rounded_t(params, cfg, hidden, coords, t, *a, **kw):
        mult = cfg.timestep_scale_multiplier
        return apply(params, cfg, hidden, coords,
                     (t.to(torch.bfloat16) * mult).float() / mult, *a, **kw)

    results, total = {}, {}
    for mode in ("lora_audio", "full"):
        with mock.patch.object(tt, "dit_apply", rounded_t):
            tr0, cpu, cpu_losses, _ = _tiny_train_run(setup, mode, "cpu", torch.float32)
        _, xla, xla_losses, none = _tiny_train_run(setup, mode, "cuda", torch.bfloat16, "xla")
        _, card, losses, launches = _tiny_train_run(setup, mode, "cuda", torch.bfloat16)
        expect = {k: n * micro_steps for k, n in pinned_launches(
            128, 128, mode, False, layers, TINY_TRAIN_DIT["num_attention_heads"]).items()}
        res = {"losses": losses, "cpu_losses": cpu_losses, "xla_losses": xla_losses,
               "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)),
               "update_rel_rms": _update_rel_rms(tr0, card, cpu),
               "update_rel_rms_vs_xla": _update_rel_rms(tr0, card, xla),
               "launches": launches}
        results[mode] = res
        if none or launches != expect:
            fail(f"reference_train/{mode}: launched {launches} (and {none} under 'xla'), "
                 f"expected {expect}")
        if not (res["loss_rel_err"] <= TRAIN_LOSS_RTOL
                and res["update_rel_rms"] <= TRAIN_UPDATE_TOL
                and res["update_rel_rms_vs_xla"] <= TRAIN_UPDATE_TOL):
            fail(f"reference_train/{mode}: the card disagrees with its references: {res}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    emit({"phase": "reference_train", "runs": results, "loss_rtol": TRAIN_LOSS_RTOL,
          "update_tol": TRAIN_UPDATE_TOL})
    return total


def profile_train_step(step, args, step_s, sums=None):
    """Device time by kernel over one call of ``step`` (torch.profiler), and
    the device's idle share of an unprofiled call of ``step_s`` seconds;
    ``sums`` maps a label to a kernel-name substring whose device ms and
    launches are summed over every matching kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or busy_us <= 0:
        return {"device_time": "not measured (profiler saw no device time)"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:14]
    return {
        "device_busy_ms": busy_us / 1e3, "unprofiled_ms": step_s * 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / (step_s * 1e3),
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels_ms": {e.key[:90]: e.self_device_time_total / 1e3 for e in top},
        "top_kernels_launches": {e.key[:90]: e.count for e in top},
        "summed_ms": {label: sum(e.self_device_time_total for e in kernels if part in e.key)
                      / 1e3 for label, part in (sums or {}).items()},
        "summed_launches": {label: sum(e.count for e in kernels if part in e.key)
                            for label, part in (sums or {}).items()},
    }


def run_train(pipe):
    """The full-width 2B DiT trained in "lora_audio" mode (r 32 / alpha 32,
    AdamW at lr 1e-4, split RoPE) on random latents at the training point:
    batch 8, [8, 8, 6, 10, 128] latents (480 tokens), 256 caption tokens of
    which 200 kept, 2 micro-batches per step, 3 optimizer steps, t and noise
    drawn on the card. Checks finite losses, nonzero LoRA b after the first
    step and the launches per micro-step (A and B once per block, E and
    both F kernels once per attention backward: :func:`pinned_launches`);
    prints seconds per step, peak memory and a profile of one micro-step (a
    step of one micro-batch)."""
    import dataclasses

    import torch

    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.train import train as tt

    dcfg = pipe.dit_cfg
    cfg = TrainConfig(checkpoint_path="-", train_mode="lora_audio", learning_rate=1e-4,
                      lora_rank=32, lora_alpha=32, batch_size=TRAIN_BATCH,
                      gradient_accumulation_steps=TRAIN_ACCUM, rf_log_normal_mu=-0.5,
                      rf_log_normal_sigma=1.0)
    g = torch.Generator(device="cuda").manual_seed(31)
    batch = _train_batch(dcfg, g)
    embeds = torch.randn(1, CAPTION, dcfg.caption_channels, generator=g, device="cuda")
    mask = torch.ones(1, CAPTION, device="cuda")
    mask[0, 200:] = 0.0
    trainable = tt.init_trainable(pipe.raw_dit_params, dcfg, cfg, g)
    opt = tt.make_optimizer(cfg)
    state = opt.init(trainable)
    step = tt.make_train_step(dcfg, cfg, opt, rope_split=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_s = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        trainable, state, metrics = step(trainable, state, pipe.dit_params, batch, embeds,
                                         mask, g)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        if i == 0 and not all(bool(blk["attn2"][n]["b"].abs().sum() > 0)
                              for blk in trainable["lora"]["blocks"]
                              for n in blk["attn2"]):
            fail("train: a LoRA b is still zero after the first step")
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    micro_steps = TRAIN_STEPS * TRAIN_ACCUM
    # A, B, E and F on the Hopper kernels only: any WMMA launch fails below
    per_micro = pinned_launches(TRAIN_TOKENS, CAPTION, "lora_audio", False)
    for name, n in launches.items():
        if n != per_micro.get(name, 0) * micro_steps:
            fail(f"train: {name} launched {n} times in {micro_steps} micro-steps, "
                 f"expected {per_micro.get(name, 0)} per micro-step")
    if not all(math.isfinite(x) for x in losses):
        fail(f"train: losses not finite: {losses}")
    steady = statistics.mean(step_s[1:])
    # one micro-step: a step of one micro-batch, timed, then profiled
    one = tt.make_train_step(dcfg, dataclasses.replace(cfg, gradient_accumulation_steps=1),
                             opt, rope_split=True)
    micro_batch = {k: v[:1] for k, v in batch.items()}
    args = (trainable, state, pipe.dit_params, micro_batch, embeds, mask, g)
    one(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one(*args)
    torch.cuda.synchronize()
    micro_s = time.perf_counter() - t0
    emit({"phase": "train", "mode": "lora_audio", "batch": TRAIN_BATCH,
          "tokens": TRAIN_TOKENS, "caption": CAPTION, "accum": TRAIN_ACCUM,
          "lora_rank": 32, "losses": losses, "step_s": step_s,
          "s_per_optimizer_step": steady, "s_per_micro_step": steady / TRAIN_ACCUM,
          "s_one_micro_batch_step": micro_s,
          "samples_per_s": TRAIN_BATCH * TRAIN_ACCUM / steady,
          "max_memory_allocated_gib": peak_gib, "launches": launches,
          "launches_per_micro_step": {k: n / micro_steps for k, n in launches.items() if n},
          "clock_max_clock_power_temperature_after": card_state()})
    emit({"phase": "profile_train_micro_step", **profile_train_step(
        one, args, micro_s, {"flash_bwd_dkv": "flash_bwd_dkv_sm90_kernel",
                             "flash_bwd_dq": "flash_bwd_dq_sm90_kernel",
                             "flash_single_sm90": "flash_sm90_kernel<2",
                             "rope_fused_attention_sm90": "rope_sm90_kernel",
                             "fused_token_attention_sm90": "token_sm90_kernel"})})
    return launches


def check_train_cli():
    """The port's ``train_loop`` on the tiny DiT in a temporary directory:
    a checkpoint written by ``save_single_file_checkpoint``, four synthetic
    .npy clips, batch 2, 2 epochs in bf16 on the card with validation;
    checks the exports and the resume state, then a second call with 3
    epochs resumes at the saved step and runs the third epoch only."""
    import dataclasses
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from avatar_tpu_torch.cli.train import train_loop
    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.train.checkpoints import TrainStateCheckpointer
    from avatar_tpu_torch.utils.weight_import import save_single_file_checkpoint

    dcfg = DiTConfig(**TINY_TRAIN_DIT)
    rng = np.random.default_rng(8)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt = root / "base.safetensors"
        save_single_file_checkpoint(ckpt, init_dit(dcfg, 4, device="cpu",
                                                   dtype=torch.bfloat16), dcfg)
        enc, cond = root / "enc", root / "cond"
        enc.mkdir()
        cond.mkdir()
        for i in range(4):
            for d, stem, shape in ((enc, f"c{i}", (16, 2, 8, 8)), (cond, f"c{i}", (16, 2, 8, 8)),
                                   (cond, f"c{i}_ref", (16, 8, 8))):
                np.save(d / f"{stem}.npy", rng.standard_normal(shape).astype(np.float32))
        out = root / "out"
        cfg = TrainConfig(checkpoint_path=str(ckpt), condition_latents_dir=str(cond),
                          encoder_latents_dir=str(enc), val_condition_latents_dir=str(cond),
                          val_encoder_latents_dir=str(enc), output_dir=str(out),
                          batch_size=2, num_epochs=2, learning_rate=1e-3, lora_rank=8,
                          lora_alpha=8, precision="bf16", train_mode="lora_audio",
                          log_every_n_steps=1, wandb_project=None,
                          rf_log_normal_mu=-0.5, rf_log_normal_sigma=1.0)
        reset_counts()
        t0 = time.perf_counter()
        train_loop(cfg, device="cuda")
        state = TrainStateCheckpointer(out / "state")
        first_step = state.latest_step()
        exports = sorted(p.name for p in out.glob("*.safetensors"))
        train_loop(dataclasses.replace(cfg, num_epochs=3), device="cuda")
        seconds = time.perf_counter() - t0
        launches = {k: n for k, n in read_counts().items() if n}
        second_step = state.latest_step()
        logged = [json.loads(line)["step"] for line in
                  (out / "metrics.jsonl").read_text().splitlines() if "train/loss" in line]
        exports_after = sorted(p.name for p in out.glob("*.safetensors"))
    res = {"exports_after_first_call": exports, "exports": exports_after,
           "resume_step_after_first_call": first_step,
           "resume_step_after_second_call": second_step, "logged_steps": logged,
           "seconds": seconds, "launches": launches}
    emit({"phase": "train_cli", **res})
    if not (first_step == 4 and second_step == 6 and logged == [1, 2, 3, 4, 5, 6]
            and len(exports) == 2 and len(exports_after) == 3):
        fail(f"train_cli: expected steps 4 then 6, two exports then three: {res}")
    if not {"rope_fused_attention_sm90", "fused_token_attention_sm90", "flash_single_sm90",
            "flash_bwd_dkv_sm90", "flash_bwd_dq_sm90"} <= set(launches) or any(
                "wmma" in name for name in launches):
        fail(f"train_cli: the training path did not launch the kernels: {launches}")
    return _merge_counts(launches, check_train_cli_decoder())


def check_train_cli_decoder():
    """``train_loop`` with ``train_mode="decoder"`` for one epoch in bf16 on
    the card: a checkpoint of the tiny DiT and a tiny VAE (``demo_config``
    at the DiT's 16 latent channels), four clips with uint8 pixel targets;
    the exported ``vae_epoch_1.safetensors`` loads back with the port's
    loader, its DiT leaves equal to the checkpoint's and its decoder leaves
    moved, and the resume state is at step 2."""
    import dataclasses
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch

    from avatar_tpu_torch.cli.train import train_loop
    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.models.vae import VAEConfig, demo_config, init_vae
    from avatar_tpu_torch.train.checkpoints import TrainStateCheckpointer
    from avatar_tpu_torch.utils import weight_import as wi

    dcfg = DiTConfig(**TINY_TRAIN_DIT)
    vcfg = dataclasses.replace(demo_config(latent_channels=16), base_channels=32,
                               decoder_base_channels=32)
    rng = np.random.default_rng(9)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        ckpt = root / "base.safetensors"
        vae = init_vae(vcfg, 6, device="cpu", dtype=torch.bfloat16)
        vae["per_channel_statistics"] = {"std_of_means": torch.ones(16),
                                         "mean_of_means": torch.zeros(16)}
        wi.save_single_file_checkpoint(
            ckpt, init_dit(dcfg, 4, device="cpu", dtype=torch.bfloat16), dcfg,
            vae_state=wi.export_vae_state(vae, vcfg), vae_config=vcfg.to_dict())
        enc, cond = root / "enc", root / "cond"
        enc.mkdir()
        cond.mkdir()
        for i in range(4):
            for d, stem, shape in ((enc, f"c{i}", (16, 2, 8, 8)), (cond, f"c{i}", (16, 2, 8, 8)),
                                   (cond, f"c{i}_ref", (16, 8, 8))):
                np.save(d / f"{stem}.npy", rng.standard_normal(shape).astype(np.float32))
            np.save(enc / f"c{i}_pixels.npy",
                    rng.integers(0, 256, (9, 256, 256, 3), dtype=np.uint8))
        out = root / "out"
        cfg = TrainConfig(checkpoint_path=str(ckpt), condition_latents_dir=str(cond),
                          encoder_latents_dir=str(enc), output_dir=str(out), batch_size=2,
                          num_epochs=1, learning_rate=1e-3, precision="bf16",
                          train_mode="decoder", gradient_checkpointing=True,
                          log_every_n_steps=1, wandb_project=None)
        reset_counts()
        t0 = time.perf_counter()
        train_loop(cfg, device="cuda")
        seconds = time.perf_counter() - t0
        launches = {k: n for k, n in read_counts().items() if n}
        configs, t_state, v_state = wi.load_single_file_checkpoint(out / "vae_epoch_1.safetensors")
        _, t_state0, v_state0 = wi.load_single_file_checkpoint(ckpt)
        step = TrainStateCheckpointer(out / "state").latest_step()
        dit_same = t_state.keys() == t_state0.keys() and all(
            torch.equal(t_state[k], t_state0[k]) for k in t_state)
        decoder_keys = [k for k in v_state if k.startswith("decoder.")]
        moved = sum(not torch.equal(v_state[k], v_state0[k]) for k in decoder_keys)
        encoder_same = all(torch.equal(v_state[k], v_state0[k]) for k in v_state
                           if k.startswith("encoder."))
        reloaded = wi.import_vae_state(v_state, VAEConfig.from_dict(configs["vae"]),
                                       device="cuda")
    res = {"seconds": seconds, "resume_step": step, "dit_leaves_unchanged": dit_same,
           "encoder_leaves_unchanged": encoder_same,
           "decoder_leaves_moved": f"{moved} of {len(decoder_keys)}", "launches": launches}
    emit({"phase": "train_cli_decoder", **res})
    if not (step == 2 and dit_same and encoder_same and moved and reloaded
            and not launches):
        fail(f"train_cli_decoder: {res}")
    return launches


# ---------------------------------------------------------------------------
# The pose path and training part 1: FaceFormer, audio-conditioned and
# "full" training with Adafactor and remat, VAE-decoder fine-tuning
# ---------------------------------------------------------------------------

# FaceFormer on the card in f32 (TF32 off) against the same port functions
# on the CPU in f32, same weights and audio: the relative RMS of the
# vertex offsets (prediction minus template) and of the decoder features
# (printed per quarter of the frames too: the decode feeds each frame back
# into the next). The limit sits between two readings on an H100: 4.5e-7
# (offsets) and 4.2e-7 (features) with TF32 off, and the reading of the
# same predict with TF32 on for the products and convs, which the phase
# takes too and which must exceed the limit (the fault the limit is there
# to catch)
FACEFORMER_TOL = 1e-5
# a 97-frame video at 20 fps: 4.85 s of audio, about 145 frames at 30 fps
FACEFORMER_SECONDS = 4.85
# per-sample audio frame counts (FaceFormer frames at 30 fps) of the
# audio-conditioned training batches: 57-frame clips at 25-20 fps are
# 2.28-2.85 s, 68-86 frames. Padded to 86, the cross-attention's key length
# is no multiple of 16 and takes E and F (the reference's fused_supports
# refuses it); padded to 80 it takes B
AUDIO_FRAMES = {"T86": (86, 84, 81, 78, 76, 73, 70, 68),
                "T80": (80, 78, 76, 75, 73, 71, 70, 68)}
# the reference's train-avatars.yaml comment: full-mode adafactor + dots
# 459 ms / step on a v5e (a TPU number, not the port's)
FULL_REMAT_RUNS = (("adafactor", None), ("adafactor", "full"), ("adafactor", "dots"),
                   ("adamw", "dots"))
# tiny-model references in f32, card against CPU: the loss of each step
# and the relative RMS of the change to the trainable tree. f32 on both
# (the card's attention on its f32 WMMA kernels), the summation orders
# differ by ~1e-6; Adafactor's and Adam's normalised updates carry that
TRAIN_F32_LOSS_RTOL = 1e-4
TRAIN_F32_UPDATE_TOL = 1e-3
# the decoder's gradients in f32, card against CPU: cuDNN's and the CPU's
# conv3d sum in other orders, ~1e-6 relative
TRAIN_F32_GRAD_TOL = 1e-4
# remat "dots", "full" and none on the card: the same kernels on the same
# inputs, so the gradients should agree bit for bit; a relative RMS above
# this fails
REMAT_GRAD_TOL = 1e-6


def faceformer_frames(samples: int, w2v_cfg, fps: float = 30.0) -> int:
    """FaceFormer's frame count for ``samples`` of 16 kHz audio: the conv
    stack's output length, taken as 50 Hz, at ``fps``."""
    n = samples
    for k, s in zip(w2v_cfg.conv_kernel, w2v_cfg.conv_stride):
        n = (n - k) // s + 1
    return int(n / 50.0 * fps)


def samples_for_frames(frames: int, w2v_cfg) -> int:
    """The fewest 16 kHz samples that give ``frames`` FaceFormer frames."""
    n = int(frames / 30.0 * 16000)
    while faceformer_frames(n, w2v_cfg) < frames:
        n += 1
    while faceformer_frames(n - 1, w2v_cfg) >= frames:
        n -= 1
    return n


def random_faceformer_state(w2v_cfg, ff_cfg, seed: int, device="cuda") -> dict:
    """A vocaset-layout FaceFormer state dict (wav2vec2 in Hugging Face's
    names, the positional conv's weight norm as weight_g / weight_v), random
    uniform +-1/sqrt(fan in) from ``seed``: the checkpoint is not in the
    repository."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def u(*shape, fan_in):
        return (torch.rand(shape, generator=g, device=device) * 2 - 1) * fan_in**-0.5

    def norm(prefix, c):
        return {f"{prefix}.weight": 1 + 0.1 * u(c, fan_in=1), f"{prefix}.bias": 0.1 * u(
            c, fan_in=1)}

    def lin(prefix, i, o):
        return {f"{prefix}.weight": u(o, i, fan_in=i), f"{prefix}.bias": u(o, fan_in=i)}

    h, w = w2v_cfg.hidden_size, "audio_encoder."
    s, c_in = {}, 1
    for i, (c, k) in enumerate(zip(w2v_cfg.conv_dim, w2v_cfg.conv_kernel)):
        s[f"{w}feature_extractor.conv_layers.{i}.conv.weight"] = u(c, c_in, k, fan_in=c_in * k)
        if i == 0:
            s.update(norm(f"{w}feature_extractor.conv_layers.0.layer_norm", c))
        c_in = c
    s.update(norm(f"{w}feature_projection.layer_norm", c_in))
    s.update(lin(f"{w}feature_projection.projection", c_in, h))
    k, groups = w2v_cfg.num_conv_pos_embeddings, w2v_cfg.num_conv_pos_embedding_groups
    s[f"{w}encoder.pos_conv_embed.conv.weight_g"] = 1 + 0.1 * u(1, 1, k, fan_in=1)
    s[f"{w}encoder.pos_conv_embed.conv.weight_v"] = u(h, h // groups, k,
                                                      fan_in=h // groups * k)
    s[f"{w}encoder.pos_conv_embed.conv.bias"] = u(h, fan_in=h)
    s.update(norm(f"{w}encoder.layer_norm", h))
    for i in range(w2v_cfg.num_hidden_layers):
        pre = f"{w}encoder.layers.{i}"
        for name in ("q", "k", "v", "out"):
            s.update(lin(f"{pre}.attention.{name}_proj", h, h))
        s.update(lin(f"{pre}.feed_forward.intermediate_dense", h, w2v_cfg.intermediate_size))
        s.update(lin(f"{pre}.feed_forward.output_dense", w2v_cfg.intermediate_size, h))
        s.update(norm(f"{pre}.layer_norm", h))
        s.update(norm(f"{pre}.final_layer_norm", h))
    d, vd = ff_cfg.feature_dim, ff_cfg.vertice_dim
    s.update(lin("audio_feature_map", h, d))
    s.update(lin("vertice_map", vd, d))
    s.update(lin("vertice_map_r", d, vd))
    s["obj_vector.weight"] = u(d, ff_cfg.num_identities, fan_in=ff_cfg.num_identities)
    dec = "transformer_decoder.layers.0"
    for name in ("self_attn", "multihead_attn"):
        s[f"{dec}.{name}.in_proj_weight"] = u(3 * d, d, fan_in=d)
        s[f"{dec}.{name}.in_proj_bias"] = u(3 * d, fan_in=d)
        s.update(lin(f"{dec}.{name}.out_proj", d, d))
    s.update(lin(f"{dec}.linear1", d, 2 * d))
    s.update(lin(f"{dec}.linear2", 2 * d, d))
    for i in (1, 2, 3):
        s.update(norm(f"{dec}.norm{i}", d))
    return s


def run_faceformer():
    """Full-width wav2vec2-base (``Wav2Vec2Config()``: 12 layers, 768 wide, 7
    conv layers of 512) with FaceFormer (``FaceFormerConfig()``: 64 wide, 4
    heads, 15,069 vertex coordinates), random weights read through
    ``import_faceformer_state``, f32: ``faceformer_predict`` and
    ``extract_audio_motion_features`` on a 4.85 s waveform and on one of
    ``MAX_AUDIO_SAMPLES`` (600 frames), each against the same functions on
    the CPU; ms per predict, per decoded frame, the device's launches and
    busy share of one predict (torch.profiler); no kernel of A-L launches
    (the attention is the plain path). Rendering needs cv2 or matplotlib,
    which the card's machine lacks: the phase stops at ``project_vertices``
    and the landmark pixels. Returns (params, configs) for train_audio."""
    import torch

    from avatar_tpu_torch.models import faceformer as tff
    from avatar_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from avatar_tpu_torch.pipelines import pose_frames as tpose

    w2v_cfg, ff_cfg = Wav2Vec2Config(), tff.FaceFormerConfig()
    state = random_faceformer_state(w2v_cfg, ff_cfg, seed=41)
    params = tff.import_faceformer_state(state, w2v_cfg, device="cuda")
    cpu_params = tff.import_faceformer_state({k: v.cpu() for k, v in state.items()},
                                             w2v_cfg, device="cpu")
    del state
    g = torch.Generator().manual_seed(42)
    template = 0.1 * torch.randn(1, ff_cfg.vertice_dim, generator=g)
    one_hot = torch.zeros(1, ff_cfg.num_identities)
    one_hot[0, 0] = 1.0
    res, worst = {}, 0.0
    for label, samples in (("4.85 s", int(FACEFORMER_SECONDS * 16000)),
                           ("MAX_AUDIO_SAMPLES", tpose.MAX_AUDIO_SAMPLES)):
        audio = 0.1 * torch.randn(1, samples, generator=g)
        args = (params, ff_cfg, w2v_cfg, audio.cuda(), template.cuda(), one_hot.cuda())

        def predict():
            with torch.no_grad():
                return tff.faceformer_predict(*args)

        predict()
        torch.cuda.synchronize()
        times = []
        reset_counts()
        for _ in range(3):
            t0 = time.perf_counter()
            verts = predict()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launched = {k: n for k, n in read_counts().items() if n}
        with torch.no_grad():
            feats = tff.extract_audio_motion_features(params, ff_cfg, w2v_cfg, audio.cuda())
            ref_v = tff.faceformer_predict(cpu_params, ff_cfg, w2v_cfg, audio, template,
                                           one_hot)
            ref_f = tff.extract_audio_motion_features(cpu_params, ff_cfg, w2v_cfg, audio)
        frames = verts.shape[1]
        off, ref_off = (verts.cpu() - template[:, None]), ref_v - template[:, None]
        quarters = [_rel_rms(off[:, i * frames // 4:(i + 1) * frames // 4],
                             ref_off[:, i * frames // 4:(i + 1) * frames // 4])
                    for i in range(4)]
        errs = {"vertex_offsets_rel_rms": _rel_rms(off, ref_off),
                "features_rel_rms": _rel_rms(feats.cpu(), ref_f),
                "vertex_offsets_rel_rms_by_quarter": quarters}
        worst = max(worst, errs["vertex_offsets_rel_rms"], errs["features_rel_rms"])
        if label == "4.85 s":
            errs.update(_faceformer_tf32_errs(params, ff_cfg, w2v_cfg, audio, template,
                                              one_hot, ref_off, ref_f))
        seq = verts[0].cpu().numpy().reshape(frames, -1, 3)
        coords, depth = tpose.project_vertices(seq[0])
        xs, ys = tpose._landmark_pixels(seq[0], 256, 256, (0.25, 0.25, 0.75, 0.75), True)
        step_s = statistics.median(times)
        res[label] = {
            "samples": samples, "frames": frames,
            "expected_frames": faceformer_frames(samples, w2v_cfg),
            "s_per_predict": step_s, "ms_per_decoded_frame": step_s * 1e3 / frames,
            "predict_s": times, **errs, "launches": launched,
            "landmarks_in_frame": int(((xs >= 0) & (xs < 256) & (ys >= 0) & (ys < 256)).sum()),
            "profile": profile_train_step(predict, (), step_s)}
        if (frames != faceformer_frames(samples, w2v_cfg) or launched
                or not bool(torch.isfinite(verts).all())
                or not (np_finite(coords) and np_finite(depth) and np_finite(xs))):
            fail(f"faceformer {label}: {res[label]}")
    emit({"phase": "faceformer", "tol_rel_rms": FACEFORMER_TOL, "runs": res,
          "rendering": "not run: the card's machine has no cv2 or matplotlib; stops at "
                       "project_vertices and the landmark pixels"})
    if not worst <= FACEFORMER_TOL:
        fail(f"faceformer: the card disagrees with the CPU: {worst} > {FACEFORMER_TOL}")
    tf32 = res["4.85 s"]["tf32_on_vertex_offsets_rel_rms"]
    if not tf32 > FACEFORMER_TOL:
        fail(f"faceformer: TF32 on reads {tf32}, inside the limit {FACEFORMER_TOL}")
    return params, (ff_cfg, w2v_cfg)


def _faceformer_tf32_errs(params, ff_cfg, w2v_cfg, audio, template, one_hot, ref_off,
                          ref_f) -> dict:
    """The card's vertex offsets and features with TF32 on for products and
    convs, against the CPU's f32 ones: the relative RMS a TF32 fault gives."""
    import torch

    from avatar_tpu_torch.models import faceformer as tff

    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            verts = tff.faceformer_predict(params, ff_cfg, w2v_cfg, audio.cuda(),
                                           template.cuda(), one_hot.cuda())
            feats = tff.extract_audio_motion_features(params, ff_cfg, w2v_cfg, audio.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return {"tf32_on_vertex_offsets_rel_rms": _rel_rms(verts.cpu() - template[:, None],
                                                       ref_off),
            "tf32_on_features_rel_rms": _rel_rms(feats.cpu(), ref_f)}


def np_finite(a) -> bool:
    import numpy as np

    return bool(np.isfinite(a).all())


# launches per micro-step of each training run, written down before the
# runs (PERF.md's predictions), by kernel: A rope_fused_attention, B
# fused_token_attention, E flash_single, F one flash_bwd_dkv and one
# flash_bwd_dq; each on the Hopper route (bf16, head dim 64). Key: (tokens,
# keys, mode, remat, layers, heads). A run must launch exactly these and
# exactly what train_route_counts derives from the route predicates
PINNED_LAUNCHES = {
    # the 2B DiT: 28 blocks, 32 heads, 480 tokens; "lora_audio" leaves the
    # first self-attention's backward out (55 = 2 * 28 - 1)
    (480, 256, "lora_audio", False, 28, 32): {"A": 28, "B": 28, "E": 55, "F": 55},
    (480, 86, "lora_audio", False, 28, 32): {"A": 28, "E": 55, "F": 55},
    (480, 80, "lora_audio", False, 28, 32): {"A": 28, "B": 28, "E": 55, "F": 55},
    (480, 256, "full", None, 28, 32): {"B": 56, "E": 56, "F": 56},
    (480, 256, "full", "full", 28, 32): {"B": 112, "E": 56, "F": 56},
    (480, 256, "full", "dots", 28, 32): {"B": 112, "E": 56, "F": 56},
    # the tiny DiT: 2 blocks, 2 heads, 128 tokens, 128 caption tokens
    (128, 128, "lora_audio", False, 2, 2): {"A": 2, "B": 2, "E": 3, "F": 3},
    (128, 128, "full", False, 2, 2): {"B": 4, "E": 4, "F": 4},
    (128, 128, "lora_audio", "full", 2, 2): {"A": 4, "B": 4, "E": 3, "F": 3},
    (128, 128, "lora_audio", "dots", 2, 2): {"A": 4, "B": 4, "E": 3, "F": 3},
}
PINNED_COUNTERS = {"A": ("rope_fused_attention",), "B": ("fused_token_attention",),
                   "E": ("flash_single",), "F": ("flash_bwd_dkv", "flash_bwd_dq")}


def pinned_launches(tokens: int, keys: int, mode: str, remat, layers: int = LAYERS,
                    heads: int = HEADS) -> dict:
    """The counters a training micro-step must read: PINNED_LAUNCHES's
    literals for this run, each counter and its Hopper route's; fails where
    they and :func:`train_route_counts` disagree."""
    pinned = {}
    for letter, n in PINNED_LAUNCHES[(tokens, keys, mode, remat, layers, heads)].items():
        for name in PINNED_COUNTERS[letter]:
            pinned[name] = pinned[f"{name}_sm90"] = n
    derived = train_route_counts(tokens, keys, mode, remat, layers, heads)
    if pinned != derived:
        fail(f"launches for {(tokens, keys, mode, remat)}: pinned {pinned}, but the route "
             f"predicates name {derived}")
    return pinned


def train_route_counts(tokens: int, keys: int, mode: str, remat, layers: int = LAYERS,
                       heads: int = HEADS, dtype_name: str = "bfloat16") -> dict:
    """Launches per micro-step of the DiT's train step (``heads`` of 64,
    bounded logits, ``dtype_name``), per counter, as the route predicates
    name them. Self-attention takes A where the split layout and
    ``rope_fused_supports`` hold ("lora_audio"), else B where
    ``fused_supports`` holds; cross-attention to ``keys`` keys B where it
    holds; else the head-major mode of ``flash_mode`` where Lq * Lk >= 128
    * 128 (``supports``), else the plain path (no kernel). Every block runs
    its forward once, twice under remat (the backward recomputes it). The
    backward of every attention it reaches (all but "lora_audio"'s first
    self-attention, whose inputs depend on no trainable leaf: the LoRA
    targets attn2 and everything before the first block is frozen) is, at
    Lq * Lk >= 128 * 128,
    one F dkv and one F dq, after one whole-row forward (E) where the
    forward was token-major (A, B); below, autograd's."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa

    dtype, counts = getattr(torch, dtype_name), {}

    def add(name, impl, n):
        for key in (name, f"{name}_{impl}"):
            counts[key] = counts.get(key, 0) + n

    forwards = layers * (2 if remat else 1)
    split = mode == "lora_audio"
    for kind, lk, reached in (("self", tokens, layers - split), ("cross", keys, layers)):
        big = tokens * lk >= 128 * 128
        token_major = True
        if kind == "self" and split and fa.rope_fused_supports(tokens, heads, HEAD_DIM, dtype):
            add("rope_fused_attention", fa.rope_impl(dtype, HEAD_DIM), forwards)
        elif fa.fused_supports(tokens, lk, heads, HEAD_DIM, dtype):
            add("fused_token_attention", fa.token_impl(dtype, HEAD_DIM), forwards)
        elif big:
            token_major = False
            mode_ = fa.flash_mode(tokens, lk, True)
            add(f"flash_{mode_}", fa.forward_impl(mode_, dtype, HEAD_DIM), forwards)
        if not big:
            continue
        if token_major:
            mode_ = fa.flash_mode(tokens, lk, False)
            add(f"flash_{mode_}", fa.forward_impl(mode_, dtype, HEAD_DIM), reached)
        for name in ("flash_bwd_dkv", "flash_bwd_dq"):
            add(name, fa.backward_impl(dtype, HEAD_DIM), reached)
    return counts


def _train_batch(dcfg, g, audio=None):
    """``run_train``'s batch: [accum, batch, ...] random latents on the card
    and, with ``audio`` (16 FaceFormer feature arrays [T_i, 64] on the
    host), the audio latents and keep-mask ``collate_latent_pairs`` makes."""
    import numpy as np
    import torch

    from avatar_tpu_torch.data.dataset import collate_latent_pairs

    f, h, w = TRAIN_GRID
    batch = {k: torch.randn(TRAIN_ACCUM, TRAIN_BATCH, n, h, w, dcfg.in_channels,
                            generator=g, device="cuda")
             for k, n in (("latents", f), ("pose_latents", f), ("ref_image_latents", 1))}
    if audio is not None:
        z = np.zeros((1, 1, 1, 1), np.float32)
        items = [{"latents": z, "pose_latents": z, "ref_image_latents": z, "stem": str(i),
                  "audio_latents": a} for i, a in enumerate(audio)]
        stacked = collate_latent_pairs(items)
        for k in ("audio_latents", "audio_mask"):
            v = stacked[k]
            batch[k] = torch.from_numpy(v.reshape(TRAIN_ACCUM, TRAIN_BATCH, *v.shape[1:])).cuda()
    return batch


def _run_train_steps(step, trainable, state, params, batch, embeds, mask, g):
    """TRAIN_STEPS optimizer steps: (trainable, state, losses, seconds per
    step, launches, peak GiB); peak memory and counts start at 0 here."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        trainable, state, metrics = step(trainable, state, params, batch, embeds, mask, g)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
    launches = {k: n for k, n in read_counts().items() if n}
    return (trainable, state, losses, step_s, launches,
            torch.cuda.max_memory_allocated() / 2**30)


def _check_launches(phase, launches, per_micro):
    micro_steps = TRAIN_STEPS * TRAIN_ACCUM
    expect = {k: n * micro_steps for k, n in per_micro.items()}
    if launches != expect:
        fail(f"{phase}: launched {launches} in {micro_steps} micro-steps, expected {expect}")


def run_train_audio(pipe, ff):
    """``run_train``'s shipped "lora_audio" training (r 32, AdamW, split
    RoPE, 8 x 480 tokens, accumulation 2, 3 steps) on audio-conditioned
    batches: each batch's FaceFormer features made on the card by
    ``extract_audio_motion_features`` from 8 waveforms (AUDIO_FRAMES; the
    two micro-batches share them), right-padded with the keep-mask by
    ``collate_latent_pairs``. At T = 86 cross-attention takes E and F, at
    T = 80 B: the launches per micro-step exactly as
    :func:`pinned_launches` names them; finite losses, seconds per step,
    peak memory."""
    import torch

    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.models import faceformer as tff
    from avatar_tpu_torch.train import train as tt

    ff_params, (ff_cfg, w2v_cfg) = ff
    dcfg = pipe.dit_cfg
    cfg = TrainConfig(checkpoint_path="-", train_mode="lora_audio", learning_rate=1e-4,
                      lora_rank=32, lora_alpha=32, batch_size=TRAIN_BATCH,
                      gradient_accumulation_steps=TRAIN_ACCUM, rf_log_normal_mu=-0.5,
                      rf_log_normal_sigma=1.0)
    g = torch.Generator(device="cuda").manual_seed(51)
    ga = torch.Generator().manual_seed(52)
    res, launches_all = {}, {}
    for label, frames in AUDIO_FRAMES.items():
        t0 = time.perf_counter()
        feats = []
        with torch.no_grad():
            for n in frames:
                audio = 0.1 * torch.randn(1, samples_for_frames(n, w2v_cfg), generator=ga)
                feats.append(tff.extract_audio_motion_features(
                    ff_params, ff_cfg, w2v_cfg, audio.cuda())[0].cpu().numpy())
        torch.cuda.synchronize()
        features_s = time.perf_counter() - t0
        got = tuple(f.shape[0] for f in feats)
        if got != frames:
            fail(f"train_audio {label}: FaceFormer frames {got}, expected {frames}")
        batch = _train_batch(dcfg, g, feats + feats)
        t_pad = batch["audio_latents"].shape[2]
        trainable = tt.init_trainable(pipe.raw_dit_params, dcfg, cfg, g)
        opt = tt.make_optimizer(cfg)
        step = tt.make_train_step(dcfg, cfg, opt, rope_split=True)
        _, _, losses, step_s, launches, peak = _run_train_steps(
            step, trainable, opt.init(trainable), pipe.dit_params, batch, None, None, g)
        per_micro = pinned_launches(TRAIN_TOKENS, t_pad, "lora_audio", False)
        res[label] = {"audio_frames": frames, "padded_T": t_pad, "losses": losses,
                      "step_s": step_s, "s_per_optimizer_step": statistics.mean(step_s[1:]),
                      "features_s": features_s, "max_memory_allocated_gib": peak,
                      "launches_per_micro_step": {k: n / (TRAIN_STEPS * TRAIN_ACCUM)
                                                  for k, n in launches.items()},
                      "predicted_per_micro_step": per_micro}
        _check_launches(f"train_audio {label}", launches, per_micro)
        if not all(math.isfinite(x) for x in losses):
            fail(f"train_audio {label}: losses not finite: {losses}")
        launches_all = _merge_counts(launches_all, launches)
        del batch
    emit({"phase": "train_audio", "mode": "lora_audio", "batch": TRAIN_BATCH,
          "tokens": TRAIN_TOKENS, "accum": TRAIN_ACCUM, "lora_rank": 32, "runs": res,
          "clock_max_clock_power_temperature_after": card_state()})
    return launches_all


def run_train_full_remat(pipe):
    """"full"-mode training of the 2B DiT (attention, AdaLN and output
    layers trainable, no split RoPE) at ``run_train``'s shape and caption,
    3 steps each: Adafactor without remat, with remat "full" and with
    "dots", and AdamW with "dots". Seconds per step, the device ms of one
    micro-step (torch.profiler), peak memory, launches per micro-step
    exactly as :func:`pinned_launches` names them; "dots"'s peak memory must
    lie between "full"'s and no remat's (the same optimizer)."""
    import dataclasses

    import torch

    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.train import train as tt

    dcfg = pipe.dit_cfg
    g = torch.Generator(device="cuda").manual_seed(61)
    batch = _train_batch(dcfg, g)
    embeds = torch.randn(1, CAPTION, dcfg.caption_channels, generator=g, device="cuda")
    mask = torch.ones(1, CAPTION, device="cuda")
    mask[0, 200:] = 0.0
    res, launches_all = {}, {}
    for optimizer, remat in FULL_REMAT_RUNS:
        label = f"{optimizer}, remat {remat or 'none'}"
        cfg = TrainConfig(checkpoint_path="-", train_mode="full", learning_rate=1e-5,
                          batch_size=TRAIN_BATCH, gradient_accumulation_steps=TRAIN_ACCUM,
                          rf_log_normal_mu=-0.5, rf_log_normal_sigma=1.0,
                          optimizer=optimizer, gradient_checkpointing=remat is not None,
                          remat_policy=remat or "full")
        torch.cuda.empty_cache()
        trainable = tt.init_trainable(pipe.raw_dit_params, dcfg, cfg, g)
        opt = tt.make_optimizer(cfg)
        step = tt.make_train_step(dcfg, cfg, opt)
        trainable, state, losses, step_s, launches, peak = _run_train_steps(
            step, trainable, opt.init(trainable), pipe.raw_dit_params, batch, embeds, mask, g)
        per_micro = pinned_launches(TRAIN_TOKENS, CAPTION, "full", remat)
        _check_launches(f"train_full_remat {label}", launches, per_micro)
        if not all(math.isfinite(x) for x in losses):
            fail(f"train_full_remat {label}: losses not finite: {losses}")
        one = tt.make_train_step(dcfg, dataclasses.replace(cfg, gradient_accumulation_steps=1),
                                 opt)
        args = (trainable, state, pipe.raw_dit_params, {k: v[:1] for k, v in batch.items()},
                embeds, mask, g)
        one(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one(*args)
        torch.cuda.synchronize()
        micro_s = time.perf_counter() - t0
        prof = profile_train_step(one, args, micro_s)
        res[label] = {"losses": losses, "step_s": step_s,
                      "s_per_optimizer_step": statistics.mean(step_s[1:]),
                      "s_one_micro_batch_step": micro_s,
                      "micro_step_device_ms": prof.get("device_busy_ms"),
                      "device_idle_share": prof.get("device_idle_share"),
                      "max_memory_allocated_gib": peak,
                      "launches_per_micro_step": {k: n / (TRAIN_STEPS * TRAIN_ACCUM)
                                                  for k, n in launches.items()}}
        launches_all = _merge_counts(launches_all, launches)
        del trainable, state, args
    peaks = {r: res[f"adafactor, remat {r}"]["max_memory_allocated_gib"]
             for r in ("none", "full", "dots")}
    emit({"phase": "train_full_remat", "mode": "full", "batch": TRAIN_BATCH,
          "tokens": TRAIN_TOKENS, "accum": TRAIN_ACCUM, "runs": res,
          "adafactor_peak_gib": peaks,
          "clock_max_clock_power_temperature_after": card_state()})
    if not peaks["full"] < peaks["dots"] < peaks["none"]:
        fail(f"train_full_remat: dots's peak memory not between full's and none's: {peaks}")
    return launches_all


def check_reference_train_options():
    """The tiny DiT (``check_reference_train``'s) in f32, 2 steps with
    accumulation 2, on the card against the CPU: Adafactor on "lora_audio"
    (the LoRA leaves too narrow to factor) and on "full" (the 128 x 128
    attention weights factored), with the same t and noise; then the
    gradients of one "lora_audio" micro-step in bf16 on the card (A, B, E,
    F) under remat "dots" against remat "full" and none."""
    import torch

    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.models.dit import permute_dit_params_for_split_rope
    from avatar_tpu_torch.train import train as tt

    setup = _tiny_train_setup()
    dcfg, params, batch, embeds, mask, draws = setup
    res, total = {}, {}
    factored = {}
    for mode in ("lora_audio", "full"):
        cfg = TrainConfig(checkpoint_path="-", train_mode=mode, learning_rate=1e-3,
                          lora_rank=8, lora_alpha=8, gradient_accumulation_steps=TRAIN_ACCUM,
                          batch_size=2, rf_log_normal_mu=-0.5, rf_log_normal_sigma=1.0,
                          optimizer="adafactor")
        tr0 = tt.init_trainable(params, dcfg, cfg, torch.Generator().manual_seed(1))
        opt = tt.make_optimizer(cfg)
        factored[mode] = sum(opt.factored_dims(x.shape) is not None
                             for x in tt.tree_leaves(tr0))
        runs = {}
        for device in ("cpu", "cuda"):
            split = mode == "lora_audio"
            dit = _tree_to(params, device, torch.float32)
            run = permute_dit_params_for_split_rope(dit, dcfg) if split else dit
            tr = _tree_to(tr0, device, torch.float32)
            state = opt.init(tr)
            step = tt.make_train_step(dcfg, cfg, opt, rope_split=split)
            losses = []
            reset_counts()
            for t, noise in draws:
                tr, state, metrics = step(tr, state, run, _tree_to(batch, device, torch.float32),
                                          embeds.to(device), mask.to(device),
                                          t=t.to(device), noise=noise.to(device))
                losses.append(float(metrics["loss"]))
            launches = {k: n for k, n in read_counts().items() if n}
            runs[device] = (_tree_to(tr, "cpu", torch.float32), losses, launches)
        (cpu, cpu_losses, _), (card, losses, launches) = runs["cpu"], runs["cuda"]
        r = {"losses": losses, "cpu_losses": cpu_losses,
             "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses)),
             "update_rel_rms": _update_rel_rms(tr0, card, cpu),
             "factored_leaves": factored[mode], "launches": launches}
        res[f"adafactor {mode}"] = r
        total = _merge_counts(total, launches)
        if not (r["loss_rel_err"] <= TRAIN_F32_LOSS_RTOL
                and r["update_rel_rms"] <= TRAIN_F32_UPDATE_TOL):
            fail(f"reference_train_options/adafactor {mode}: {r}")
    if not factored["full"]:
        fail(f"reference_train_options: no factored leaf in 'full' mode: {factored}")

    # remat: one lora_audio micro-step's gradients in bf16 on the card
    cfg = TrainConfig(checkpoint_path="-", train_mode="lora_audio", lora_rank=8,
                      lora_alpha=8, rf_log_normal_mu=-0.5, rf_log_normal_sigma=1.0)
    tr0 = tt.init_trainable(params, dcfg, cfg, torch.Generator().manual_seed(1))
    run = permute_dit_params_for_split_rope(_tree_to(params, "cuda", torch.bfloat16), dcfg)
    t, noise = draws[0]
    grads, launches = {}, {}
    for remat in (False, "full", "dots"):
        leaves = [x.cuda().requires_grad_() for x in tt.tree_leaves(tr0)]
        reset_counts()
        loss, _ = tt.velocity_loss(
            tt.tree_unflatten(tr0, leaves), run, dcfg, cfg,
            {k: v[0].cuda() for k, v in batch.items()}, embeds.cuda(), mask.cuda(),
            train_mode="lora_audio", remat=remat, rope_split=True, t=t[0].cuda(),
            noise=noise[0].cuda())
        grads[remat] = [x.float().cpu() for x in torch.autograd.grad(loss, leaves)]
        launches[str(remat)] = {k: n for k, n in read_counts().items() if n}
        total = _merge_counts(total, launches[str(remat)])
    layers, heads = TINY_TRAIN_DIT["num_layers"], TINY_TRAIN_DIT["num_attention_heads"]
    for remat in (False, "full", "dots"):
        expect = pinned_launches(128, 128, "lora_audio", remat, layers, heads)
        if launches[str(remat)] != expect:
            fail(f"reference_train_options remat {remat}: launched {launches[str(remat)]}, "
                 f"expected {expect}")
    errs = {f"{a} vs {b}": (torch.cat([x.flatten() for x in grads[a]])
                            - torch.cat([x.flatten() for x in grads[b]])).norm().item()
            / torch.cat([x.flatten() for x in grads[b]]).norm().item()
            for a, b in (("dots", "full"), ("dots", False))}
    res["remat_grads_rel_rms"] = errs
    res["remat_launches"] = launches
    emit({"phase": "reference_train_options", "runs": res,
          "loss_rtol": TRAIN_F32_LOSS_RTOL, "update_tol": TRAIN_F32_UPDATE_TOL,
          "remat_grad_tol": REMAT_GRAD_TOL})
    if not all(e <= REMAT_GRAD_TOL for e in errs.values()):
        fail(f"reference_train_options: remat gradients differ: {errs}")
    return total


# decoder fine-tuning of the 2B VAE: 97 frames at 256 px; fewer where 97 do
# not fit the card (each cut printed)
DECODER_LATENT = (1, 13, 8, 8, 128)


def run_train_decoder(pipe):
    """Decoder fine-tuning of the 2B VAE (``make_full_pipeline``'s,
    timestep-conditioned, bf16) from [1, 13, 8, 8, 128] latents to 97 x 256
    x 256 uint8 targets from a seed, remat per up block
    (``gradient_checkpointing``), AdamW, 3 steps: seconds per step, peak
    memory, finite L1 and PSNR; the decoder's leaves must move."""
    import torch

    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.train import decoder as td
    from avatar_tpu_torch.train import train as tt

    cfg = TrainConfig(checkpoint_path="-", train_mode="decoder", decoder_train=True,
                      learning_rate=1e-5, batch_size=1, gradient_checkpointing=True)
    g = torch.Generator(device="cuda").manual_seed(71)
    cuts = []
    for latent_frames in (DECODER_LATENT[1], 7, 4):
        frames = (latent_frames - 1) * pipe.video_scale_factor + 1
        shape = (1, 1, latent_frames) + DECODER_LATENT[2:]
        batch = {"latents": torch.randn(shape, generator=g, device="cuda"),
                 "pixels": torch.randint(0, 256, (1, 1, frames, 256, 256, 3), generator=g,
                                         device="cuda", dtype=torch.uint8)}
        trainable = td.init_decoder_trainable(pipe.vae_params)
        first = [x.clone() for x in tt.tree_leaves(trainable)[:4]]
        opt = tt.make_optimizer(cfg)
        step = td.make_decoder_train_step(pipe.vae_cfg, cfg, opt)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            state, metrics_all, step_s = opt.init(trainable), [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                trainable, state, metrics = step(trainable, state, pipe.vae_params, batch, g)
                metrics_all.append({k: float(v) for k, v in metrics.items()})
                step_s.append(time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError as e:
            cuts.append(f"{frames} frames did not fit: {str(e).splitlines()[0]}")
            del trainable, batch
            continue
        break
    else:
        fail(f"train_decoder: no frame count fit: {cuts}")
    launches = {k: n for k, n in read_counts().items() if n}
    moved = any(not torch.equal(a, b) for a, b in zip(first, tt.tree_leaves(trainable)))
    res = {"latents": list(shape), "frames": frames, "cuts": cuts, "metrics": metrics_all,
           "step_s": step_s, "s_per_optimizer_step": statistics.mean(step_s[1:]),
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "trainable_params": sum(x.numel() for x in tt.tree_leaves(trainable)),
           "launches": launches, "decoder_moved": moved,
           "clock_max_clock_power_temperature_after": card_state()}
    emit({"phase": "train_decoder", **res})
    if launches or not moved or not all(math.isfinite(v) for m in metrics_all
                                        for v in m.values()):
        fail(f"train_decoder: {res}")
    del trainable, state, batch
    torch.cuda.empty_cache()
    return launches


def check_reference_train_decoder():
    """``tests/test_decoder_train.py``'s tiny VAE (``demo_config`` at latent
    width 8, 32 base channels), decoder fine-tuning in f32 with remat, on
    the card against the CPU, the same t and noise: the gradient of one
    micro-batch's loss (gated at TRAIN_F32_GRAD_TOL), then 2 AdamW steps
    with accumulation 2: each step's loss (gated) and the change to the
    decoder (printed: Adam's first steps move every element by about lr
    whatever its gradient, so an element whose gradient is within rounding
    of 0 may move either way on the two devices)."""
    import dataclasses

    import torch

    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.models.vae import demo_config, init_vae
    from avatar_tpu_torch.train import decoder as td
    from avatar_tpu_torch.train import train as tt

    vcfg = dataclasses.replace(demo_config(latent_channels=8), base_channels=32,
                               decoder_base_channels=32)
    params = init_vae(vcfg, 5, device="cpu")
    g = torch.Generator().manual_seed(6)
    params["per_channel_statistics"] = {"std_of_means": 0.5 + torch.rand(8, generator=g),
                                        "mean_of_means": torch.randn(8, generator=g)}
    batch = {"latents": torch.randn(TRAIN_ACCUM, 2, 2, 2, 2, 8, generator=g),
             "pixels": torch.randint(0, 256, (TRAIN_ACCUM, 2, 9, 64, 64, 3), generator=g,
                                     dtype=torch.uint8)}
    draws = [(torch.rand(TRAIN_ACCUM, 2, generator=g),
              torch.randn(TRAIN_ACCUM, 2, 2, 2, 2, 8, generator=g)) for _ in range(2)]
    cfg = TrainConfig(checkpoint_path="-", train_mode="decoder", learning_rate=1e-3,
                      batch_size=2, gradient_accumulation_steps=TRAIN_ACCUM,
                      gradient_checkpointing=True)
    tr0 = td.init_decoder_trainable(params)
    runs, grads = {}, {}
    for device in ("cpu", "cuda"):
        opt = tt.make_optimizer(cfg)
        p = _tree_to(params, device, torch.float32)
        tr = _tree_to(tr0, device, torch.float32)
        leaves = [x.clone().requires_grad_() for x in tt.tree_leaves(tr)]
        loss, _ = td.decoder_loss(tt.tree_unflatten(tr, leaves), p, vcfg, cfg,
                                  {k: v[0].to(device) for k, v in batch.items()},
                                  remat=True, t=draws[0][0][0].to(device),
                                  noise=draws[0][1][0].to(device))
        grads[device] = torch.cat([x.flatten().cpu() for x in torch.autograd.grad(loss, leaves)])
        state, losses = opt.init(tr), []
        step = td.make_decoder_train_step(vcfg, cfg, opt)
        for t, noise in draws:
            tr, state, m = step(tr, state, p, {k: v.to(device) for k, v in batch.items()},
                                t=t.to(device), noise=noise.to(device))
            losses.append(float(m["loss"]))
        runs[device] = (_tree_to(tr, "cpu", torch.float32), losses)
    res = {"losses": runs["cuda"][1], "cpu_losses": runs["cpu"][1],
           "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"][1],
                                                                   runs["cpu"][1])),
           "grad_rel_rms": ((grads["cuda"] - grads["cpu"]).norm()
                            / grads["cpu"].norm()).item(),
           "update_rel_rms": _update_rel_rms(tr0, runs["cuda"][0], runs["cpu"][0])}
    emit({"phase": "reference_train_decoder", **res, "loss_rtol": TRAIN_F32_LOSS_RTOL,
          "grad_tol": TRAIN_F32_GRAD_TOL})
    if not (res["loss_rel_err"] <= TRAIN_F32_LOSS_RTOL
            and res["grad_rel_rms"] <= TRAIN_F32_GRAD_TOL):
        fail(f"reference_train_decoder: the card disagrees with the CPU: {res}")
    return {}


# T5 in bf16 on the card against f32 on the CPU, same (bf16) weights, at a
# tiny width (2 layers, d_model 256, 4 heads of 64): random-init T5 has
# unscaled logits of std ~8, so bf16's rounding of q and k moves the softmax;
# a CPU rehearsal in bf16 read 0.016 relative RMS (0.051 at 4 layers of 512)
T5_TINY_TOL = 0.05


def run_t5():
    """T5-XXL at full width (``T5Config()``: 24 layers, d_model 4096, 64
    heads of 64, d_ff 10240, gated-gelu, vocab 32128), seeded random bf16
    weights on the card: encodes a prompt and a negative prompt as seeded
    token ids (batch 2 x 256, 200 and 40 kept), checks shape, finite values
    and that no kernel launched (T5's attention runs the plain path, as in
    the JAX package); times the encode (medians of CUDA-event batches),
    peak memory, the same encode with ``quantize_t5_params("w8a8")`` and
    with the f32 weights the bf16 ones were rounded from (times and
    relative RMS against bf16: findings, not gates). Then a tiny T5 in bf16
    on the card against f32 on the CPU (T5_TINY_TOL; and its W8A8 encode,
    reported). Returns the bf16 embeddings [2, 256, 4096], their mask and
    the launches."""
    import torch

    from avatar_tpu_torch.models.t5 import T5Config, init_t5_encoder, t5_encode
    from avatar_tpu_torch.train.train import tree_leaves
    from avatar_tpu_torch.utils.quantize import quantize_t5_params

    cfg = T5Config()
    torch.cuda.synchronize()
    base_gib = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = init_t5_encoder(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    g = torch.Generator(device="cuda").manual_seed(25)
    ids = torch.randint(0, cfg.vocab_size, (2, CAPTION), generator=g, device="cuda",
                        dtype=torch.int32)
    mask = torch.zeros(2, CAPTION, device="cuda")
    for row, kept in enumerate(T5_KEPT):
        mask[row, :kept] = 1.0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    embeds = t5_encode(params, cfg, ids, mask)
    torch.cuda.synchronize()
    launches = {k: n for k, n in read_counts().items() if n}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if tuple(embeds.shape) != (2, CAPTION, cfg.d_model) or embeds.dtype != torch.bfloat16 \
            or not bool(torch.isfinite(embeds).all()):
        fail(f"t5: embeddings {embeds.dtype} {tuple(embeds.shape)} not finite or misshaped")
    if launches:
        fail(f"t5: the encoder launched {launches}; its attention runs the plain path")
    ms = time_ms(lambda: t5_encode(params, cfg, ids, mask), reps=5, batches=5)
    t0 = time.perf_counter()
    q8 = quantize_t5_params(params, "w8a8")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    reset_counts()
    embeds8 = t5_encode(q8, cfg, ids, mask)
    torch.cuda.synchronize()
    launches8 = {k: n for k, n in read_counts().items() if n}
    if launches8 or not bool(torch.isfinite(embeds8).all()):
        fail(f"t5 w8a8: launched {launches8} (expected none: the short route), or not finite")
    ms8 = time_ms(lambda: t5_encode(q8, cfg, ids, mask), reps=5, batches=5)
    rel8 = _rel_rms(embeds8.float(), embeds.float())
    del q8, embeds8
    torch.cuda.empty_cache()
    # the same seed draws the f32 weights that the bf16 ones round
    p32 = init_t5_encoder(cfg, seed=0, device="cuda", dtype=torch.float32)
    embeds32 = t5_encode(p32, cfg, ids, mask)
    ms32 = time_ms(lambda: t5_encode(p32, cfg, ids, mask), reps=2, batches=3)
    rel16 = _rel_rms(embeds.float(), embeds32)
    del p32, embeds32
    torch.cuda.empty_cache()

    tiny = T5Config(vocab_size=1000, d_model=256, d_kv=64, d_ff=512, num_layers=2,
                    num_heads=4)
    tparams = _tree_to(_tree_to(init_t5_encoder(tiny, 1, device="cpu"), "cpu",
                                torch.bfloat16), "cpu", torch.float32)
    tg = torch.Generator().manual_seed(27)
    tids = torch.randint(0, 1000, (2, 64), generator=tg)
    tmask = torch.zeros(2, 64)
    tmask[0, :50] = 1.0
    tmask[1, :10] = 1.0
    ref = t5_encode(tparams, tiny, tids, tmask)
    ref_bf16 = t5_encode(_tree_to(tparams, "cpu", torch.bfloat16), tiny, tids, tmask).float()
    card_params = _tree_to(tparams, "cuda", torch.bfloat16)
    card = t5_encode(card_params, tiny, tids.cuda(), tmask.cuda()).float().cpu()
    tiny_rel = _rel_rms(card, ref)
    ref8 = t5_encode(quantize_t5_params(tparams, "w8a8"), tiny, tids, tmask)
    card8 = t5_encode(quantize_t5_params(card_params, "w8a8"), tiny, tids.cuda(),
                      tmask.cuda()).float().cpu()
    res = {"config": "T5Config() (t5-v1_1-xxl)", "parameters": n_params,
           "init_s": init_s, "batch": 2, "tokens": CAPTION, "kept": list(T5_KEPT),
           "encode_ms": ms, "peak_memory_gib": peak_gib,
           "memory_before_gib": base_gib, "launches": launches,
           "w8a8_quantize_s": quant_s, "w8a8_encode_ms": ms8, "w8a8_rel_rms_vs_bf16": rel8,
           "f32_encode_ms": ms32, "bf16_rel_rms_vs_f32": rel16,
           "tiny_bf16_card_vs_f32_cpu_rel_rms": tiny_rel,
           "tiny_bf16_card_vs_bf16_cpu_rel_rms": _rel_rms(card, ref_bf16),
           "tiny_w8a8_card_vs_f32_cpu_rel_rms": _rel_rms(card8, ref8),
           "tiny_w8a8_cpu_vs_f32_cpu_rel_rms": _rel_rms(ref8, ref),
           "tiny_tol": T5_TINY_TOL}
    emit({"phase": "t5", **res})
    if not (math.isfinite(tiny_rel) and tiny_rel <= T5_TINY_TOL):
        fail(f"t5: the card's bf16 encode disagrees with the CPU's f32: {tiny_rel}")
    return embeds, mask, launches


def card_state() -> str:
    """SM clock, power draw and temperature as ``nvidia-smi`` reads them now:
    a card that throttles under a long load shows it here."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def make_full_pipeline():
    """The full-width 2B DiT (28 layers, 32 x 64) and the 2B VAE with
    timestep conditioning, random weights from a seed, bf16 on the card."""
    import torch

    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.models.vae import LTX_VAE_CONFIG, VAEConfig, init_vae
    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline

    t0 = time.perf_counter()
    dcfg = DiTConfig()
    vcfg = VAEConfig.from_dict({**LTX_VAE_CONFIG, "timestep_conditioning": True})
    pipe = LTXVideoPipeline(
        dcfg, init_dit(dcfg, seed=1, device="cuda", dtype=torch.bfloat16), vcfg,
        init_vae(vcfg, seed=0, device="cuda", dtype=torch.bfloat16), device="cuda")
    torch.cuda.synchronize()
    return pipe, time.perf_counter() - t0


def run_pipeline(pipe, phase, size, frames, settings, expect, profile_steps,
                 extra=None, inputs=None):
    """One video through ``LTXVideoPipeline.__call__`` at 40 steps with I420
    output: checks the output's shape and type, finite latents, and that
    each kernel launched exactly ``expect[name]`` times (0 for the rest);
    prints stage seconds, peak memory and a profile of the first steps.
    ``inputs`` replaces the default call inputs (a random caption of 200
    kept tokens, a reference image and pose frames). Returns the launches,
    the seconds of the timed video and the latents of a second video from
    the same seed."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams

    dcfg = pipe.dit_cfg
    g = torch.Generator(device="cuda").manual_seed(2)
    embeds = torch.randn(1, CAPTION, dcfg.caption_channels, generator=g,
                         device="cuda", dtype=torch.bfloat16)
    mask = torch.ones(1, CAPTION, device="cuda")
    mask[0, 200:] = 0.0
    ref = torch.randn(1, 1, size, size, 3, generator=g, device="cuda",
                      dtype=torch.bfloat16)
    pose = torch.randn(1, frames, size, size, 3, generator=g, device="cuda",
                       dtype=torch.bfloat16)

    def params(steps):
        return GenerationParams(
            height=size, width=size, num_frames=frames - 1, frame_rate=25.0,
            num_inference_steps=steps, decode_timestep=0.05, **settings)

    if inputs is None:
        inputs = dict(prompt_embeds=embeds, prompt_attention_mask=mask, ref_image=ref,
                      pose_frames=pose)

    def run(steps, output_type, stage_times=None):
        return pipe(params(steps), torch.Generator(device="cuda").manual_seed(5),
                    output_type=output_type, stage_times=stage_times, **inputs)

    t0 = time.perf_counter()
    run(1, "yuv420")  # warm-up: cuBLAS/cuDNN handles and algorithm choice
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    stages = {}
    reset_counts()
    t0 = time.perf_counter()
    out = run(STEPS, "yuv420", stages)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    state = card_state()
    launches = read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    shape = (1, frames, size * 3 // 2, size)
    if out.dtype != torch.uint8 or tuple(out.shape) != shape:
        fail(f"{phase}: output {out.dtype} {tuple(out.shape)}, expected uint8 {shape}")
    for name, n in launches.items():
        if n != expect.get(name, 0):
            fail(f"{phase}: {name} launched {n} times, expected {expect.get(name, 0)}")
    del out
    latents = run(STEPS, "latent")
    lat_shape = (1, (frames - 1) // 8 + 1, size // 32, size // 32, dcfg.in_channels)
    if tuple(latents.shape) != lat_shape or not bool(torch.isfinite(latents).all()):
        fail(f"{phase}: latents not finite or of wrong shape {tuple(latents.shape)}")
    emit({"phase": phase, "frames": frames, "size": size, "steps": STEPS,
          "tokens": lat_shape[1] * lat_shape[2] * lat_shape[3],
          "settings": {k: str(v) for k, v in settings.items()},
          "warmup_s": warm_s, **stages, "total_s": total_s,
          "frames_per_s": frames / total_s,
          "denoise_step_ms": stages["denoise_s"] / STEPS * 1e3,
          "max_memory_allocated_gib": peak_gib,
          "clock_max_clock_power_temperature_after": state, "launches": launches,
          "latent_std": latents.float().std().item(), **(extra or {})})
    if profile_steps:
        emit({"phase": f"profile_{phase}", **profile_denoise(
            pipe, params(STEPS), embeds, mask, ref, pose,
            stages["denoise_s"] / STEPS, profile_steps)})
    return launches, total_s, latents


def profile_denoise(pipe, p, embeds, mask, ref, pose, step_s, steps):
    """Device time by kernel over the first ``steps`` Euler steps at
    guidance 1 (torch.profiler), and the device's idle share of an
    unprofiled step of ``step_s`` seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    g = torch.Generator(device="cuda").manual_seed(5)
    ref_lat = pipe.encode_media(ref, g)
    pose_lat = pipe.encode_media(pose, g)
    lat_f = p.num_frames // pipe.video_scale_factor + 1
    lat_hw = p.height // pipe.vae_scale_factor
    shape = (1, lat_f, lat_hw, lat_hw, pipe.dit_cfg.in_channels)
    tokens, coords, _, _ = pipe.prepare_conditioning(
        None, pipe.prepare_latents(g, shape, torch.bfloat16))
    coords = coords.float()
    coords[:, 0] /= p.frame_rate
    sched = pipe.schedule.set_timesteps(
        num_inference_steps=p.num_inference_steps,
        samples_shape=(1, shape[-1], lat_f, lat_hw, lat_hw))
    sigmas = torch.tensor(sched.sigmas[:steps], dtype=torch.float32, device="cuda")
    embeds = embeds.to(torch.bfloat16)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.denoise(tokens, coords, embeds, mask, sigmas, ref_lat, pose_lat)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not kernels or busy_us <= 0:
        return {"device_time": "not measured (profiler saw no device time)"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    busy_step_ms = busy_us / 1e3 / steps
    return {
        "steps_profiled": steps,
        "device_busy_ms_per_step": busy_step_ms,
        "unprofiled_step_ms": step_s * 1e3,
        "device_idle_share": 1.0 - busy_step_ms / (step_s * 1e3),
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels_ms_per_step": {
            e.key[:90]: e.self_device_time_total / 1e3 / steps for e in top},
    }


# ---------------------------------------------------------------------------
# The VAE / DiT variants and the inference CLI
# ---------------------------------------------------------------------------

# A decoder with the variant blocks, in the reference's block order (the
# decoder walks it backwards): an attention block at the latent size (192
# tokens: E), an up-conv, an attention block with noise at 1280 tokens (D),
# an up-conv to 64 channels, a noisy resnet, an up-conv; group norm and
# timestep conditioning throughout. Attention at 128 channels: 2 heads of 64.
VAE_VARIANT = {
    "latent_channels": 16, "encoder_base_channels": 32, "decoder_base_channels": 64,
    "patch_size": 4, "norm_layer": "group_norm", "timestep_conditioning": True,
    "latent_log_var": "uniform",
    "encoder_blocks": [("res_x", {"num_layers": 1}), ("compress_all", {}),
                       ("res_x_y", {"multiplier": 2}), ("compress_all", {}),
                       ("compress_all", {}), ("res_x", {"num_layers": 1})],
    "decoder_blocks": [("compress_all", {}),
                       ("res_x", {"num_layers": 1, "inject_noise": True}),
                       ("compress_all", {"residual": True, "multiplier": 2}),
                       ("attn_res_x", {"num_layers": 1, "attention_head_dim": 64,
                                       "inject_noise": True}),
                       ("compress_all", {}),
                       ("attn_res_x", {"num_layers": 1, "attention_head_dim": 64})],
}
VAE_VARIANT_LATENT = (1, 3, 8, 8, 16)  # -> 17 frames at 256 px
# The variant decode in bf16 on the card against f32 on the CPU, relative
# RMS of the pixels: bf16 rounds each of about 20 convs' inputs and the
# attention's p and o (0.012 measured in bf16 on the CPU)
VAE_VARIANT_TOL = 0.03
# The inference CLI's shipped pipeline config, configs/inference-avatars.yaml
# as yaml.safe_load reads it (the card's machine has no PyYAML;
# tests/test_torch_imports.py holds the two equal)
INFERENCE_AVATARS_YAML = {
    "pipeline_type": "base",
    "checkpoint_path": "ltxv-2b-0.9.6-dev-04-25.safetensors",
    "vae_checkpoint_path": "ltxv-2b-0.9.6-dev-04-25.safetensors",
    "guidance_scale": 1, "stg_scale": 0, "rescaling_scale": 1, "skip_block_list": [19],
    "num_inference_steps": 40, "stg_mode": "attention_values", "decode_timestep": 0.05,
    "decode_noise_scale": 0.025, "precision": "bfloat16", "sampler": "from_checkpoint",
    "stochastic_sampling": False, "output_path": "./result", "seed": 171198,
    "spatial_upscaler_model_path": None,
    "text_encoder_model_name_or_path": "PixArt-alpha/PixArt-XL-2-1024-MS",
}


def _variant_decode(vcfg, params, latents, t, noise, device, dtype):
    """The variant VAE's decode on ``device`` in ``dtype`` with the given
    injected noise; (pixels on the CPU in f32, launches)."""
    import torch

    from avatar_tpu_torch.models.vae import vae_decode

    reset_counts()
    out = vae_decode(_tree_to(params, device, dtype), vcfg, latents.to(device, dtype),
                     t.to(device), spatial_noise=[n.to(device, dtype) for n in noise])
    if device == "cuda":
        torch.cuda.synchronize()
    return out.float().cpu(), {k: n for k, n in read_counts().items() if n}


def _variant_noise(vcfg, params, latent_shape, seed=6):
    """[H, W] draws for each noisy conv of the decode, in its order."""
    import torch

    from avatar_tpu_torch.models.vae import _UP_STRIDE, _decoder_channel_walk

    g = torch.Generator().manual_seed(seed)
    h, w = latent_shape[2:4]
    noise = []
    for bp, (name, _, _, _) in zip(params["decoder"]["blocks"], _decoder_channel_walk(vcfg)):
        if name in _UP_STRIDE:
            h, w = h * _UP_STRIDE[name][1], w * _UP_STRIDE[name][2]
            continue
        for res in bp.get("res_blocks", [bp]):
            noise += [torch.randn(h, w, generator=g) for n in (1, 2)
                      if f"per_channel_scale{n}" in res]
    return noise


def check_reference_vae_variants():
    """The variants the shipped 2B models leave out, bf16 on the card
    against f32 on the CPU, same weights and noise: the variant VAE's decode
    (group norm, timestep conditioning, noise injection, attention blocks
    at 192 and 1280 tokens: E and D on the Hopper kernel, exactly as
    ``flash_mode`` and ``forward_impl`` route them), and a tiny pipeline
    whose DiT has ``adaptive_norm="none"`` and whose VAE is the variant one
    (``_reference_run``: A and B)."""
    import dataclasses

    import torch

    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.models.vae import VAEConfig, init_vae
    from avatar_tpu_torch.ops import flash_attention as fa

    vcfg = VAEConfig.from_dict(VAE_VARIANT)
    vae = _tree_to(init_vae(vcfg, 3, device="cpu"), "cpu", torch.float32)
    g = torch.Generator().manual_seed(8)
    # norm affines and injected-noise scales away from their init (1, 0)
    for name, leaf in _named_leaves(vae):
        if "per_channel_scale" in name or ("norm" in name and leaf.ndim == 1):
            leaf += 0.1 * torch.randn(leaf.shape, generator=g)
    latents = torch.randn(VAE_VARIANT_LATENT, generator=g)
    t = torch.tensor([0.05])
    noise = _variant_noise(vcfg, vae, VAE_VARIANT_LATENT)
    cpu, _ = _variant_decode(vcfg, vae, latents, t, noise, "cpu", torch.float32)
    card, launches = _variant_decode(vcfg, vae, latents, t, noise, "cuda", torch.bfloat16)
    expect = {}
    for tokens in (3 * 8 * 8, 5 * 16 * 16):  # the two attention blocks
        mode = fa.flash_mode(tokens, tokens, False)
        impl = fa.forward_impl(mode, torch.bfloat16, HEAD_DIM)
        for name in (f"flash_{mode}", f"flash_{mode}_{impl}"):
            expect[name] = expect.get(name, 0) + 1
    decode = {"shape": list(card.shape), "rel_rms_err": _rel_rms(card, cpu),
              "max_abs_err": (card - cpu).abs().max().item(), "tol": VAE_VARIANT_TOL,
              "noise_draws": len(noise), "launches": launches, "expected": expect}
    emit({"phase": "reference_vae_variants_decode", **decode})
    if tuple(card.shape) != (1, 17, 256, 256, 3) or not math.isfinite(decode["rel_rms_err"]):
        fail(f"reference_vae_variants: decode {decode}")
    if launches != expect:
        fail(f"reference_vae_variants: the VAE launched {launches}, expected {expect}")
    if decode["rel_rms_err"] > VAE_VARIANT_TOL:
        fail(f"reference_vae_variants: the card's bf16 decode disagrees with f32: {decode}")

    dcfg = DiTConfig(num_attention_heads=2, attention_head_dim=64, in_channels=16,
                     out_channels=16, num_layers=2, cross_attention_dim=128,
                     caption_channels=64, adaptive_norm="none",
                     norm_elementwise_affine=True)
    tiny_vcfg = dataclasses.replace(vcfg, decoder_base_channels=32)
    res = _reference_run(
        "reference_vae_variants", (dcfg, init_dit(dcfg, 2, device="cpu"), tiny_vcfg,
                                   init_vae(tiny_vcfg, 3, device="cpu")),
        64, 25, 48, dict(guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0), {},
        TOKEN_MAJOR_BF16)
    emit({"phase": "reference_vae_variants", **res, "rel_rms_tol": REFERENCE_TOL,
          "vs_no_kernel_tol": KERNEL_PATH_TOL, "dit": "adaptive_norm none",
          "vae": "VAE_VARIANT"})
    return _merge_counts(launches, res["launches"])


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def dit_route_counts(tokens: int, caption: int, calls: int) -> dict:
    """The launches of ``calls`` block calls of the 2B DiT at ``tokens``
    self-attention tokens and ``caption`` caption keys, per counter, as
    ``dit_routes`` names them."""
    counts = {}
    for name, impl in dit_routes(tokens, caption):
        for key in (name, f"{name}_{impl}"):
            counts[key] = counts.get(key, 0) + calls
    return counts


def _merge_counts(*counts) -> dict:
    out = {}
    for c in counts:
        for k, n in c.items():
            out[k] = out.get(k, 0) + n
    return out


def export_cli_assets(pipe, t5_embeds, t5_mask, tmp):
    """The files the CLI phases read, in ``tmp``: the 2B DiT and VAE as one
    single-file checkpoint written by the port's
    ``save_single_file_checkpoint``, the ``t5`` phase's embeddings (prompt
    and negative prompt) by its ``save_safetensors``, and a random-init
    ``LatentUpsamplerConfig()`` with its config metadata. Returns the paths
    and the seconds each write took."""
    import json
    from pathlib import Path

    import torch

    from avatar_tpu_torch.models.latent_upsampler import (
        LatentUpsamplerConfig,
        export_latent_upsampler_state,
        init_latent_upsampler,
    )
    from avatar_tpu_torch.utils.safetensors_io import save_safetensors
    from avatar_tpu_torch.utils.weight_import import (
        export_vae_state,
        save_single_file_checkpoint,
    )

    tmp = Path(tmp)
    paths, seconds = {}, {}
    t0 = time.perf_counter()
    paths["checkpoint"] = tmp / "ltxv-2b-random.safetensors"
    save_single_file_checkpoint(
        paths["checkpoint"], pipe.raw_dit_params, pipe.dit_cfg,
        vae_state=export_vae_state(pipe.vae_params, pipe.vae_cfg),
        vae_config=pipe.vae_cfg.to_dict(),
        scheduler_config={"_class_name": "RectifiedFlowScheduler",
                          "num_train_timesteps": 1000, "sampler": "Uniform",
                          "shifting": "SD3", "target_shift_terminal": 0.1})
    seconds["checkpoint"] = time.perf_counter() - t0
    paths["embeds"] = tmp / "t5_embeds.safetensors"
    save_safetensors({"prompt_embeds": t5_embeds[:1], "prompt_attention_mask": t5_mask[:1],
                      "negative_prompt_embeds": t5_embeds[1:],
                      "negative_prompt_attention_mask": t5_mask[1:]}, paths["embeds"])
    t0 = time.perf_counter()
    up_cfg = LatentUpsamplerConfig()
    paths["upsampler"] = tmp / "latent-upsampler-random.safetensors"
    save_safetensors(export_latent_upsampler_state(
        init_latent_upsampler(up_cfg, seed=4, device=pipe.device, dtype=torch.bfloat16)),
        paths["upsampler"], metadata={"config": json.dumps(up_cfg.to_dict())})
    seconds["upsampler"] = time.perf_counter() - t0
    paths["checkpoint_gib"] = paths["checkpoint"].stat().st_size / 2**30
    return paths, seconds


def run_cli(phase, paths, expect, num_frames=121, window_frames=0, multiscale=False):
    """One talking-avatar video through the inference CLI's ``generate`` at
    its defaults (192 x 320, seed 171198, frame rate 20) and the shipped
    pipeline yaml (40 steps, guidance 1), from the exported checkpoint and
    embeddings, conditioned on a reference image and ``num_frames`` pose
    frames handed over already loaded (``generate(conditioning=...)``; the
    card's machine has no PIL or cv2 to read image files): random pixels in
    [-1, 1] made on the host from a seed, which the pipeline encodes with the
    VAE and lerps into every step. The pipeline is loaded once by
    ``load_pipeline`` (timed), a 1-step video warms up, then the timed video
    runs with the launch counts from 0, then the same video without the
    reference and pose frames (timed, not counted). Fails unless the frames are uint8 of
    the asked shape, every denoised latent is finite and each counter moved
    exactly as ``expect`` says (0 for every other, every WMMA counter among
    them)."""
    import numpy as np
    import torch

    from avatar_tpu_torch.cli.infer import InferenceConfig, generate, load_pipeline

    pcfg = dict(INFERENCE_AVATARS_YAML, checkpoint_path=str(paths["checkpoint"]),
                vae_checkpoint_path=str(paths["checkpoint"]))
    if multiscale:
        pcfg.update(pipeline_type="multi-scale",
                    spatial_upscaler_model_path=str(paths["upsampler"]))
    config = InferenceConfig(prompt_embeds_path=str(paths["embeds"]), device="cuda",
                             num_frames=num_frames, window_frames=window_frames,
                             overlap_frames=9 if window_frames else 0)
    rng = np.random.default_rng(12)
    media = [rng.uniform(-1.0, 1.0, (1, f, config.height, config.width, 3)).astype(np.float32)
             for f in (1, num_frames)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = load_pipeline(pcfg, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    video_pipe = pipe.video_pipeline if multiscale else pipe
    finite = []
    decode = video_pipe.decode_latents

    def checked_decode(latents, *args, **kw):
        finite.append(bool(torch.isfinite(latents).all()))
        return decode(latents, *args, **kw)

    video_pipe.decode_latents = checked_decode
    t0 = time.perf_counter()
    generate(config, dict(pcfg, num_inference_steps=1), pipeline=pipe, conditioning=media)
    warm_s = time.perf_counter() - t0
    finite.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    frames = generate(config, pcfg, pipeline=pipe, conditioning=media)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {k: n for k, n in read_counts().items() if n}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finite_checked = list(finite)
    # the same video without the reference and pose frames: what they cost
    t0 = time.perf_counter()
    generate(config, pcfg, pipeline=pipe)
    torch.cuda.synchronize()
    text_only_s = time.perf_counter() - t0
    shape = (1, num_frames, config.height, config.width, 3)
    res = {"phase": phase, "num_frames": num_frames, "height": config.height,
           "width": config.width, "steps": pcfg["num_inference_steps"],
           "window_frames": window_frames, "multiscale": multiscale,
           "conditioning": [list(m.shape) for m in media], "load_s": load_s,
           "warmup_s": warm_s, "total_s": total_s, "frames_per_s": num_frames / total_s,
           "text_only_total_s": text_only_s, "shape": list(frames.shape),
           "dtype": str(frames.dtype), "latents_finite": finite_checked,
           "frames_mean": float(frames.mean()), "frames_std": float(frames.std()),
           "max_memory_allocated_gib": peak_gib,
           "clock_max_clock_power_temperature_after": card_state(),
           "launches": launches, "expected": expect}
    emit(res)
    if tuple(frames.shape) != shape or frames.dtype.name != "uint8":
        fail(f"{phase}: frames {frames.dtype} {frames.shape}, expected uint8 {shape}")
    if not finite_checked or not all(finite_checked) or not res["frames_std"] > 0:
        fail(f"{phase}: latents finite {finite_checked}, frames std {res['frames_std']}")
    if launches != expect:
        fail(f"{phase}: launched {launches}, expected {expect}")
    # the wrapper holds the pipeline's own bound method: a reference cycle
    # that would keep these weights on the card until the garbage collector
    # runs, counted in the next phase's peak memory
    del video_pipe.decode_latents
    del pipe, video_pipe
    torch.cuda.empty_cache()
    return launches, total_s


def run_cli_phases(pipe, t5_embeds, t5_mask) -> dict:
    """The inference CLI on the card at full width (the 2B DiT and VAE of
    ``make_full_pipeline``), each over CLI_GRIDS' tokens with the launches
    its routes name: one pass of 121 frames, 185 frames as two windows of
    97 overlapping by 9, and the multi-scale pipeline (a 128 x 192 pass,
    then 256 x 384)."""
    import tempfile

    from avatar_tpu_torch.pipelines.long_video import window_starts

    tokens = {label: math.prod(grid) for label, grid in CLI_GRIDS.items()}
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths, seconds = export_cli_assets(pipe, t5_embeds, t5_mask, tmp)
        emit({"phase": "cli_export", "seconds": seconds,
              "checkpoint_gib": paths["checkpoint_gib"]})
        calls = LAYERS * STEPS
        by_path["cli"], _ = run_cli(
            "cli", paths, dit_route_counts(tokens["one pass"], CAPTION, calls))
        windows = len(window_starts(185, 97, 9))
        by_path["cli_long_video"], _ = run_cli(
            "cli_long_video", paths,
            dit_route_counts(tokens["window"], CAPTION, windows * calls),
            num_frames=185, window_frames=97)
        by_path["cli_multiscale"], _ = run_cli(
            "cli_multiscale", paths, _merge_counts(*(
                dit_route_counts(tokens[f"multi-scale {p} pass"], CAPTION, calls)
                for p in ("first", "second"))),
            multiscale=True)
    return by_path


# ---------------------------------------------------------------------------
# The W8A8 VAE (kernel L) and the serving layer
# ---------------------------------------------------------------------------

CONV_SOURCE = "avatar_tpu_torch/csrc/int8_conv3d.cu"
CONV_SM90_SOURCE = "avatar_tpu_torch/csrc/int8_conv3d_sm90.cu"
# the 2B VAE's work on the main path: the reference frame and 97 pose frames
# at 256 px encoded, [1, 13, 8, 8, 128] latents decoded
VAE_FRAMES, VAE_SIZE, VAE_LATENT = 97, 256, (1, 13, 8, 8, 128)
# a served batch: the decode of 4 requests' latents at once
SERVED_BATCH = 4
# tests/test_extras.py::test_w8a8_vae's tiny VAE and its bound: the int8
# VAE's encode and decode within 0.08 of the f32 VAE's, as the mean absolute
# difference over the mean absolute value
TINY_W8A8_VAE = {
    "latent_channels": 8, "base_channels": 32,
    "encoder_blocks": [["res_x", {"num_layers": 1}], ["compress_all", {"multiplier": 2}],
                       ["res_x", {"num_layers": 1}]],
    "decoder_blocks": [["res_x", {"num_layers": 1}],
                       ["compress_all", {"residual": True, "multiplier": 2}],
                       ["res_x", {"num_layers": 1}]],
    "norm_layer": "pixel_norm", "patch_size": 2, "latent_log_var": "uniform",
}
TINY_W8A8_VAE_TOL = 0.08
# the JAX package's serving traffic (bench.py's serving rows): the same
# avatar for every request, batches of up to 4 within 50 ms, rounds of 12
SERVING_MAX_BATCH, SERVING_WINDOW_S, SERVING_ROUND = 4, 0.05, 12


def _conv_key(x, params, kw):
    k = params["kernel_q8"]
    return (tuple(x.shape), tuple(k.shape), str(kw.get("stride", 1)),
            bool(kw.get("causal", True)), kw.get("spatial_padding_mode", "zeros"))


def record_int8_convs(vcfg, qparams, batch=1, encode=True):
    """Each int8 conv of the 2B VAE's work for one video (with ``encode``
    the reference frame's and the pose frames' encodes, then the decode of
    ``batch`` latents), by distinct shape: ({key: {"x": first input,
    "params", "kw", "calls"}} in the order met, the int8 convs of the
    decode)."""
    import torch

    from avatar_tpu_torch.models import vae as tvae

    seen = {}
    original = tvae.conv3d_params

    def record(params, x, **kw):
        if "kernel_q8" in params:
            ent = seen.setdefault(_conv_key(x, params, kw),
                                  {"x": x, "params": params, "kw": kw, "calls": 0})
            ent["calls"] += 1
        return original(params, x, **kw)

    def calls():
        return sum(e["calls"] for e in seen.values())

    g = torch.Generator(device="cuda").manual_seed(12)
    tvae.conv3d_params = record
    try:
        for frames in (1, VAE_FRAMES) if encode else ():
            media = torch.rand(1, frames, VAE_SIZE, VAE_SIZE, 3, generator=g,
                               device="cuda") * 2 - 1
            tvae.vae_encode(qparams, vcfg, media.bfloat16(), generator=g,
                            per_channel_normalize=True)
        encodes = calls()
        latents = torch.randn((batch, *VAE_LATENT[1:]), generator=g,
                              device="cuda").bfloat16()
        tvae.vae_decode(qparams, vcfg, latents,
                        timestep=torch.full((batch,), 0.05, device="cuda"),
                        per_channel_normalize=True)
    finally:
        tvae.conv3d_params = original
    torch.cuda.synchronize()
    return seen, calls() - encodes


def _levels_plain(x, s):
    """L1's plain version: the levels, channels-last, zeros to 32 channels."""
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import causal_conv3d as cc

    q = cc._levels(x, s).to(torch.int8).permute(0, 2, 3, 4, 1)
    c = x.shape[1]
    return F.pad(q, (0, cc.padded_channels(c) - c)).contiguous()


def _conv_plain(x, params, kw):
    from avatar_tpu_torch.ops import causal_conv3d as cc

    return cc._int8_conv3d_plain(x, params["kernel_q8"], params["scale"], params.get("bias"),
                                 kw.get("stride", 1), kw.get("causal", True),
                                 kw.get("spatial_padding_mode", "zeros"))


def _conv_work(x, params, kw):
    """(int8 operations, bytes) of L2 on this conv: each input read once
    (the levels, the stored weight, its scales and bias), the output
    written once."""
    from avatar_tpu_torch.ops import causal_conv3d as cc

    wq = params["kernel_q8"]
    n, kt, kh, kw_, cp = wq.shape
    fo, ho, wo = cc._out_size(x.shape, (kt, kh, kw_), kw.get("stride", 1),
                              kw.get("causal", True))
    m = x.shape[0] * fo * ho * wo
    k = kt * kh * kw_ * x.shape[1]
    nbytes = x[:, 0].numel() * cp + wq.numel() + 4 * n + (n + m * n) * x.element_size()
    return 2.0 * m * n * k, nbytes, (m, n, k)


def conv_plan_of(x, params, kw):
    """:func:`conv_plan` of one recorded conv."""
    from avatar_tpu_torch.ops import causal_conv3d as cc

    wq = params["kernel_q8"]
    return cc.conv_plan(tuple(x.shape), wq.shape[0], tuple(wq.shape[1:4]),
                        cc._triple(kw.get("stride", 1)), kw.get("causal", True),
                        kw.get("spatial_padding_mode", "zeros"), x.dtype)


def _count_conv(counts, x, params, kw, calls=1) -> None:
    """Adds ``calls`` launches of L1 and of the L2 route conv_plan names."""
    route = conv_plan_of(x, params, kw).route
    counts["int8_conv3d_quant"] += calls
    counts["int8_conv3d" if route == "gather" else "int8_conv3d_sm90"] += calls


def planned_launches(records) -> dict:
    """L1's and each L2 route's launches for the recorded convs ({key:
    {"x", "params", "kw", "calls"}}) as :func:`conv_plan` routes them."""
    counts = {"int8_conv3d_quant": 0, "int8_conv3d": 0, "int8_conv3d_sm90": 0}
    for rec in records.values():
        _count_conv(counts, rec["x"], rec["params"], rec["kw"], rec["calls"])
    return counts


@contextlib.contextmanager
def planned_conv_launches():
    """Counts the int8 convs the VAE runs in the block, L1's and each L2
    route's as ``conv_plan`` routes them: the launches the wrapper must
    make."""
    from avatar_tpu_torch.models import vae as tvae

    counts = {"int8_conv3d_quant": 0, "int8_conv3d": 0, "int8_conv3d_sm90": 0}
    original = tvae.conv3d_params

    def count(params, x, **kw):
        if "kernel_q8" in params:
            _count_conv(counts, x, params, kw)
        return original(params, x, **kw)

    tvae.conv3d_params = count
    try:
        yield counts
    finally:
        tvae.conv3d_params = original


def _gather_l2(levels, s, params, kw, dtype):
    """L2 on the gather kernel (the first design) through its C entry, on
    any shape: the comparison beside the route the plan names."""
    import torch

    from avatar_tpu_torch.ops import causal_conv3d as cc

    _, out, (args, _keep) = cc._conv_args(
        levels, s, params["kernel_q8"], params["scale"], params.get("bias"), dtype,
        kw.get("stride", 1), kw.get("causal", True), kw.get("spatial_padding_mode", "zeros"))
    err = cc.gather_entry()(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"int8_conv3d (gather) launch failed with cudaError_t {err}")
    return out


def _old_levels(x, s):
    """L1's first design (``quant_relayout_kernel`` of csrc/int8_conv3d.cu)
    through its C entry: the comparison beside the new L1."""
    import torch

    from avatar_tpu_torch.ops import causal_conv3d as cc

    b, c = x.shape[:2]
    cp = cc.padded_channels(c)
    xq = torch.empty((b, *x.shape[2:], cp), device=x.device, dtype=torch.int8)
    fn = cc._entry("int8_conv3d", "int8_conv3d_quant", [cc._P] * 3 + [cc._I] * 5 + [cc._P])
    err = fn(x.data_ptr(), s.data_ptr(), xq.data_ptr(), b, c, x[0, 0].numel(), cp,
             int(x.dtype == torch.float32), torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"int8_conv3d_quant (first design) launch failed with cudaError_t {err}")
    return xq


def _two_pass_scale(x):
    """The activation scale in two passes (|x| written, then its amax),
    which the one-read ``act_scale`` must equal."""
    import torch

    from avatar_tpu_torch.ops.int8_matmul import div127

    return div127(torch.clamp_min(x.abs().amax().float(), 1e-8))


def _same_scale(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b) or (torch.isnan(a) and torch.isnan(b)))


def _out_diff(out, ref) -> float:
    """0.0 where equal bit for bit; the max |difference| otherwise (NaN
    where equal where finite but the NaNs differ)."""
    import torch

    if torch.equal(out, ref):
        return 0.0
    err = (out.float() - ref.float()).abs().max().item()
    return err if err else float("nan")


def _compare_conv(x, params, kw):
    """L1's levels and L2's output (on its planned route and on the gather
    kernel) against their plain versions on ``x``, and the one-read scale
    against the two-pass one: (levels' max |difference|, each output's
    difference (:func:`_out_diff`), whether the scales are equal, the plain
    version's seconds)."""
    import torch

    from avatar_tpu_torch.ops import causal_conv3d as cc

    s = cc.act_scale(x)
    same_scale = _same_scale(s, _two_pass_scale(x))
    levels = cc.quantize_levels(x, s)
    l1_err = (levels.int() - _levels_plain(x, s).int()).abs().max().item()
    out = cc.int8_conv3d(x, params, **kw)
    gathered = _gather_l2(levels, s, params, kw, x.dtype)
    del levels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = _conv_plain(x, params, kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    return l1_err, _out_diff(out, ref), _out_diff(gathered, ref), same_scale, plain_s


def conv_class(m: int, n: int) -> str:
    """A conv shape's class by its output positions ``m`` and channels
    ``n``: ``sub_wave`` where the first design's grid of 128 x 128 tiles is
    under a wave of the SMs, else ``small`` up to 4,096 positions, else
    ``large``."""
    from avatar_tpu_torch.ops import causal_conv3d as cc

    return ("sub_wave" if -(-m // 128) * -(-n // 128) < cc.SMS
            else "small" if m <= 4096 else "large")


def check_int8_conv3d(peaks):
    """Kernel L against its plain version on the card, bit for bit: L1's
    levels and L2's outputs at full size at every distinct W8A8 conv shape
    of the 2B VAE on the main path (its encode of 97 pose frames and a
    reference frame at 256 px, its decode of [13, 8, 8, 128] latents) and
    of a served batch's decode (``SERVED_BATCH`` latents), on the route
    ``conv_plan`` names (wgmma, with split K where it says) and on the
    gather kernel, with replicate padding, stride 2, an all-zero input and a
    NaN; the one-read activation scale equal to the two-pass one. Each
    main-path shape's route and split, L1's (new and first design) and L2's
    (planned route, gather kernel) device times (profiler), launches per
    video, bound and cuDNN's bf16 conv of the same shape (what the bf16 VAE
    runs); the sums over one video and per shape class (:func:`conv_class`).
    L1's bound is the larger of its bytes and the issue of the instructions
    its function needs per element (``act_quant_sass.count_level_work``).
    Returns L1's and L2's kernel rows and the launches per route of a video
    and of one served decode."""
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.models.vae import LTX_VAE_CONFIG, VAEConfig, init_vae
    from avatar_tpu_torch.ops import causal_conv3d as cc
    from avatar_tpu_torch.tools import act_quant_sass
    from avatar_tpu_torch.utils.quantize import quantize_vae_params

    vcfg = VAEConfig.from_dict({**LTX_VAE_CONFIG, "timestep_conditioning": True})
    qparams = quantize_vae_params(init_vae(vcfg, seed=0, device="cuda",
                                           dtype=torch.bfloat16))
    records, decode_convs = record_int8_convs(vcfg, qparams)
    served, _ = record_int8_convs(vcfg, qparams, batch=SERVED_BATCH, encode=False)
    shapes, served_shapes, unequal = {}, {}, {}
    for recs, table in ((records, shapes), (served, served_shapes)):
        for rec in recs.values():
            x, p, kw = rec["x"].contiguous(), rec["params"], rec["kw"]
            _, _, (m, n, k) = _conv_work(x, p, kw)
            plan = conv_plan_of(x, p, kw)
            label = (f"{tuple(x.shape)} {x.shape[1]}->{n} k{p['kernel_q8'].shape[1]}"
                     f" stride {kw.get('stride', 1)} causal {kw.get('causal', True)}")
            l1_err, l2_err, gather_err, same_scale, plain_s = _compare_conv(x, p, kw)
            if l1_err or l2_err or gather_err or not same_scale:
                unequal[label] = {"l1_levels": l1_err, "l2_max_abs_err": l2_err,
                                  "gather_max_abs_err": gather_err, "scale_equal": same_scale}
            table[label] = {"calls": rec["calls"], "m_n_k": [m, n, k], "route": plan.route,
                            "tile_m": plan.tile_m, "chunk": plan.chunk, "split": plan.split,
                            "items": plan.items, "class": conv_class(m, n),
                            "l1_max_abs_err": l1_err, "max_abs_err": l2_err,
                            "gather_max_abs_err": gather_err, "plain_s": plain_s}
    # replicate padding and stride 2 at the largest conv's widths, an
    # all-zero input, a NaN (through the wgmma kernel and its split-K path)
    big = max(records.values(), key=lambda r: _conv_work(r["x"], r["params"], r["kw"])[0])
    x9 = big["x"][:, :, :9].contiguous()
    small = next(r for r in records.values()
                 if conv_plan_of(r["x"], r["params"], r["kw"]).split > 1)
    extra = {"replicate": (x9, big["params"], dict(big["kw"], spatial_padding_mode="replicate")),
             "replicate, stride 2, non-causal": (
                 x9, big["params"], dict(big["kw"], spatial_padding_mode="replicate", stride=2,
                                         causal=False)),
             "all zero": (torch.zeros_like(x9), big["params"], big["kw"]),
             "all zero, split K": (torch.zeros_like(small["x"]), small["params"],
                                   small["kw"])}
    extra_routes = {}
    for label, (xe, pe, kw) in extra.items():
        extra_routes[label] = conv_plan_of(xe, pe, kw).route
        out, ref = cc.int8_conv3d(xe, pe, **kw), _conv_plain(xe, pe, kw)
        if not torch.equal(out, ref):
            unequal[label] = _out_diff(out, ref)
    for label, rec in (("nan", big), ("nan, split K", small)):
        nan = rec["x"][:, :, :9].clone(memory_format=torch.contiguous_format)
        nan.view(-1)[nan.numel() // 3] = float("nan")
        if not _same_scale(cc.act_scale(nan), _two_pass_scale(nan)):
            unequal[f"{label} scale"] = "the one-read scale differs"
        nan_out = cc.int8_conv3d(nan, rec["params"], **rec["kw"])
        if not torch.isnan(nan_out).all():
            unequal[label] = "finite outputs from a NaN input"
        extra_routes[label] = conv_plan_of(nan, rec["params"], rec["kw"]).route
    torch.cuda.synchronize()
    if unequal:
        fail(f"int8_conv3d disagrees with its plain version: {unequal}")

    # L1's bound: the larger of its bytes and the issue of the instructions
    # its work needs per input element (SASS of this run's build)
    level_work = act_quant_sass.count_level_work()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = act_quant_sass.max_sm_clock_mhz()

    # times: L2 on its planned route (the kernel and, with split K, the
    # workspace's memset) and on the gather kernel, L1 new and first design,
    # by the profiler's device time; cuDNN's bf16 conv on the same shape
    # (the pad the bf16 VAE concatenates first is not timed)
    sums = ("l2_ms", "gather_ms", "cudnn_bf16_ms", "bound_ms", "l1_ms", "l1_old_ms",
            "l1_bound_ms")
    video = dict.fromkeys(sums, 0.0)
    by_class = {}
    for rec, label in zip(records.values(), shapes):
        x, p, kw = rec["x"].contiguous(), rec["params"], rec["kw"]
        stride, causal = kw.get("stride", 1), kw.get("causal", True)
        s = cc.act_scale(x)
        levels = cc.quantize_levels(x, s)
        wq = p["kernel_q8"]
        mode = kw.get("spatial_padding_mode", "zeros")
        l2 = device_ms(lambda: cc.conv_levels(levels, s, wq, p["scale"], p.get("bias"),
                                              x.dtype, stride, causal, mode))
        gather = device_ms(lambda: _gather_l2(levels, s, p, kw, x.dtype))
        l1 = device_ms(lambda: cc.quantize_levels(x, s), "quant_levels_kernel")
        l1_old = device_ms(lambda: _old_levels(x, s), "quant_relayout_kernel")
        w = (cc.int8_kernel_view(wq, x.shape[1]).float()
             * p["scale"][:, None, None, None, None]).bfloat16()
        bias = p.get("bias")
        padded, padding = cc._spatial_pad(cc._time_pad(x, wq.shape[1], causal), wq.shape[2],
                                          wq.shape[3], mode)
        cudnn = device_ms(lambda: F.conv3d(padded, w, bias, stride=cc._triple(stride),
                                           padding=padding))
        ops, nbytes, _ = _conv_work(x, p, kw)
        bound_ms, bound_by = bound(ops, nbytes, peaks, peaks[2])
        l1_bytes_ms = bound(0, x.numel() * x.element_size() + levels.numel(), peaks)[0]
        per_element = level_work["f32" if x.dtype == torch.float32 else "bf16"]["per_element"]
        l1_issue_ms = act_quant_sass.issue_bound_ms(per_element, x.numel(), sms, clock)
        row = shapes[label]
        row.update({
            "ms": l2, "gather_ms": gather, "l1_ms": l1, "l1_old_ms": l1_old,
            "cudnn_bf16_ms": cudnn, "bound_ms": bound_ms, "bound_by": bound_by,
            "l1_bytes_bound_ms": l1_bytes_ms, "l1_issue_bound_ms": l1_issue_ms,
            "l1_bound_ms": max(l1_bytes_ms, l1_issue_ms),
            "l1_bound_by": "bytes" if l1_bytes_ms >= l1_issue_ms else "operations",
            "tera_ops_per_s": ops / (l2 * 1e-3) / 1e12})
        cls = by_class.setdefault(row["class"], dict.fromkeys(sums, 0.0) | {"shapes": 0,
                                                                          "calls": 0})
        cls["shapes"] += 1
        cls["calls"] += rec["calls"]
        for name, t in (("l2_ms", l2), ("gather_ms", gather), ("cudnn_bf16_ms", cudnn),
                        ("bound_ms", bound_ms), ("l1_ms", l1), ("l1_old_ms", l1_old),
                        ("l1_bound_ms", row["l1_bound_ms"])):
            video[name] += t * rec["calls"]
            cls[name] += t * rec["calls"]
        del levels, padded, w
    # the rows' shape: the conv that takes L2 the most time per video; its
    # plain versions timed on the same full-size inputs
    main = max(shapes, key=lambda lb: shapes[lb]["ms"] * shapes[lb]["calls"])
    rec = list(records.values())[list(shapes).index(main)]
    x, p, kw = rec["x"].contiguous(), rec["params"], rec["kw"]
    plain_ms = time_ms(lambda: _conv_plain(x, p, kw), reps=1, batches=3)
    s = cc.act_scale(x)
    l1_plain_ms = time_ms(lambda: _levels_plain(x, s), reps=3, batches=3)
    per_video = planned_launches(records)
    per_decode = planned_launches(served)
    emit({"phase": "kernel_int8_conv3d", "shapes": shapes,
          "served_decode_shapes": served_shapes, "equal_bit_for_bit": True,
          "one_read_scale_equal": True, "extra_cases": extra_routes,
          "per_video_ms": video, "per_class_ms": by_class, "main_shape": main,
          "l1_level_work": level_work, "sms": sms, "max_sm_clock_mhz": clock,
          "convs_per_video": sum(r["calls"] for r in shapes.values()),
          "convs_per_decode": decode_convs, "launches_per_video": per_video,
          "launches_per_served_decode": per_decode})
    m = shapes[main]
    gather_main = next((lb for lb in shapes if shapes[lb]["route"] == "gather"), main)
    g = shapes[gather_main]
    rows = [
        {"name": "int8_conv3d_quant", "route": "cuda", "source": CONV_SM90_SOURCE,
         "replaces": "avatar_tpu/ops/causal_conv3d.py:73",
         "reference_op": "XLA's per-tensor quantization (no Pallas kernel)",
         "max_abs_err": m["l1_max_abs_err"], "ms": m["l1_ms"], "plain_ms": l1_plain_ms,
         "bound_ms": m["l1_bound_ms"], "bound_by": m["l1_bound_by"],
         "bytes_bound_ms": m["l1_bytes_bound_ms"], "issue_bound_ms": m["l1_issue_bound_ms"],
         "library_ms": None, "first_design_ms": m["l1_old_ms"], "first_design": CONV_SOURCE,
         "shape": main, "per_video_ms": video["l1_ms"],
         "first_design_per_video_ms": video["l1_old_ms"],
         "bound_per_video_ms": video["l1_bound_ms"]},
        {"name": "int8_conv3d_sm90", "route": "cuda", "source": CONV_SM90_SOURCE,
         "replaces": "avatar_tpu/ops/causal_conv3d.py:94",
         "reference_op": "XLA's int8 convolution (no Pallas kernel)",
         "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": plain_ms,
         "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
         "library_ms": m["cudnn_bf16_ms"], "library": "cuDNN bf16 F.conv3d",
         "gather_ms": m["gather_ms"], "shape": main,
         "per_video_ms": video["l2_ms"], "bound_per_video_ms": video["bound_ms"],
         "gather_per_video_ms": video["gather_ms"],
         "cudnn_bf16_per_video_ms": video["cudnn_bf16_ms"], "per_class_ms": by_class},
        {"name": "int8_conv3d", "route": "cuda", "source": CONV_SOURCE,
         "replaces": "avatar_tpu/ops/causal_conv3d.py:94",
         "reference_op": "XLA's int8 convolution (no Pallas kernel)",
         "max_abs_err": g["gather_max_abs_err"], "ms": g["gather_ms"], "plain_ms": plain_ms,
         "plain_ms_shape": main, "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
         "library_ms": g["cudnn_bf16_ms"], "library": "cuDNN bf16 F.conv3d",
         "shape": gather_main,
         "main_path_shapes": [lb for lb in shapes if shapes[lb]["route"] == "gather"],
         "per_video_ms": sum(shapes[lb]["gather_ms"] * shapes[lb]["calls"] for lb in shapes
                             if shapes[lb]["route"] == "gather"),
         "every_shape_per_video_ms": video["gather_ms"]},
    ]
    del records, served, qparams
    torch.cuda.empty_cache()
    return rows, per_video, per_decode


def check_reference_vae_w8a8():
    """tests/test_extras.py::test_w8a8_vae on the card: the tiny VAE in f32,
    its W8A8 encode and decode (kernel L in f32) against the f32 VAE's
    within 0.08, finite, and a zero latent decoded to finite pixels."""
    import torch

    from avatar_tpu_torch.models.vae import VAEConfig, init_vae, vae_decode, vae_encode
    from avatar_tpu_torch.utils.quantize import quantize_vae_params

    cfg = VAEConfig.from_dict(TINY_W8A8_VAE)
    params = init_vae(cfg, seed=0, device="cuda")
    qparams = quantize_vae_params(params, min_size=2**10)
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(1, 9, 32, 32, 3, generator=g, device="cuda")
    reset_counts()
    with planned_conv_launches() as planned:
        lat = vae_encode(params, cfg, x, sample_posterior=False)
        latq = vae_encode(qparams, cfg, x, sample_posterior=False)
        y, yq = vae_decode(params, cfg, lat), vae_decode(qparams, cfg, lat)
        zero = vae_decode(qparams, cfg, torch.zeros_like(lat))
    torch.cuda.synchronize()
    launches = {k: n for k, n in read_counts().items() if n}

    def rel(a, b):
        return ((a - b).abs().mean() / (a.abs().mean() + 1e-8)).item()

    res = {"latents_rel": rel(lat, latq), "pixels_rel": rel(y, yq), "tol": TINY_W8A8_VAE_TOL,
           "launches": launches, "planned_conv_launches": planned}
    emit({"phase": "reference_vae_w8a8", **res})
    if not (res["latents_rel"] < TINY_W8A8_VAE_TOL and res["pixels_rel"] < TINY_W8A8_VAE_TOL
            and bool(torch.isfinite(yq).all()) and bool(torch.isfinite(zero).all())):
        fail(f"reference_vae_w8a8: {res}")
    if not planned["int8_conv3d_quant"] or any(
            launches.get(k, 0) != n for k, n in planned.items()):
        fail(f"reference_vae_w8a8: launches {launches}, planned {planned}")
    return launches


def run_pipeline_vae_w8a8(pipe, conv_launches, attention, bf16_s):
    """The 2B pipeline with ``quantize_vae="w8a8"`` (the same DiT and VAE
    weights) on the main path: L1 and L2 launched once per int8 conv of the
    video's two encodes and its decode, exactly, L2 on each route as
    ``conv_plan`` names it (``conv_launches``); then the encode and the
    decode of both VAEs in turns (bf16, int8, int8, bf16) on the same
    inputs, and the mean relative difference of their decodes of the same
    latents (printed, not held)."""
    import torch

    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline

    t0 = time.perf_counter()
    pipe_q = LTXVideoPipeline(pipe.dit_cfg, pipe.raw_dit_params, pipe.vae_cfg,
                              pipe.vae_params, quantize_vae="w8a8", device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plain = dict(guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0)
    launches, _, _ = run_pipeline(
        pipe_q, "pipeline_vae_w8a8", VAE_SIZE, VAE_FRAMES, plain,
        {**attention, **conv_launches},
        0, extra={"init_s": init_s, "bf16_vae_total_s": bf16_s})

    g = torch.Generator(device="cuda").manual_seed(13)
    ref = torch.rand(1, 1, VAE_SIZE, VAE_SIZE, 3, generator=g, device="cuda") * 2 - 1
    pose = torch.rand(1, VAE_FRAMES, VAE_SIZE, VAE_SIZE, 3, generator=g,
                      device="cuda") * 2 - 1
    latents = torch.randn(VAE_LATENT, generator=g, device="cuda").bfloat16()
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams

    p = GenerationParams(height=VAE_SIZE, width=VAE_SIZE, num_frames=VAE_FRAMES - 1,
                         decode_timestep=0.05, decode_noise_scale=0.0)
    noise = torch.zeros_like(latents)
    times = {"bf16": {"encode_s": [], "decode_s": []}, "w8a8": {"encode_s": [],
                                                                "decode_s": []}}
    decoded = {}
    for name, pp in (("bf16", pipe), ("w8a8", pipe_q), ("w8a8", pipe_q), ("bf16", pipe)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for media in (ref, pose):
            pp.encode_media(media.bfloat16(), torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decoded[name] = pp.decode_latents(latents, p, noise=noise, output_type="np")
        torch.cuda.synchronize()
        times[name]["encode_s"].append(t1 - t0)
        times[name]["decode_s"].append(time.perf_counter() - t1)
    a, b = decoded["w8a8"].float(), decoded["bf16"].float()
    res = {"times_in_turns": times,
           "decode_mean_rel_diff": ((a - b).abs().mean() / b.abs().mean()).item(),
           "decode_rel_rms": _rel_rms(a, b), "conv_launches": conv_launches}
    emit({"phase": "pipeline_vae_w8a8_vs_bf16", **res})
    del pipe_q, decoded
    torch.cuda.empty_cache()
    return launches


def run_serving(pipe, phase, per_batch, solo_gate=True):
    """The JAX package's serving traffic (``bench.py``'s serving rows,
    which serve its W8A8 DiT + W8A8 VAE pipeline; here over ``pipe``, the
    bf16 pipeline in ``serving`` and that W8A8 one in ``serving_w8a8``):
    ``AvatarServer`` over ``pipe`` at 97 frames, 256 px, 40 steps, I420
    output, the same reference image and pose frames (host arrays) for
    every request, batches of up to 4 within 50 ms: a warm-up round of 4
    requests, then two rounds of 12 (3 batches each). Requests and frames
    per second of the faster round, per-request latency (p50, max),
    batches per round, the media cache's hits and misses, and the launches
    of the rounds, each kernel held to ``per_batch`` launches a batch; then
    the first and the last request of a batch of 4 each against the same
    request served alone, both without decode-time noise, held to
    ``REFERENCE_TOL`` where ``solo_gate``."""
    import dataclasses

    import numpy as np
    import torch

    from avatar_tpu_torch.pipelines.pipeline import GenerationParams
    from avatar_tpu_torch.pipelines.serving import AvatarServer, GenerationRequest

    rng = np.random.default_rng(14)
    dcfg = pipe.dit_cfg
    embeds = rng.standard_normal((1, CAPTION, dcfg.caption_channels)).astype(np.float32)
    mask = np.ones((1, CAPTION), np.float32)
    mask[0, 200:] = 0.0
    ref = rng.uniform(-1, 1, (1, 1, VAE_SIZE, VAE_SIZE, 3)).astype(np.float32)
    pose = rng.uniform(-1, 1, (1, VAE_FRAMES, VAE_SIZE, VAE_SIZE, 3)).astype(np.float32)
    params = GenerationParams(height=VAE_SIZE, width=VAE_SIZE, num_frames=VAE_FRAMES - 1,
                              frame_rate=25.0, num_inference_steps=STEPS, guidance_scale=1.0,
                              stg_scale=0.0, rescaling_scale=1.0, decode_timestep=0.05)

    # the decode-time noise comes from the batch's generator (in the JAX
    # server too), so the check of a batched request against the same one
    # alone runs without it
    quiet = dataclasses.replace(params, decode_noise_scale=0.0)

    def request(seed, p=params):
        return GenerationRequest(p, embeds, mask, ref_image=ref, pose_frames=pose,
                                 seed=seed, output_type="yuv420")

    def serve(server, seeds, p=params):
        done = {}
        t0 = time.perf_counter()
        futs = []
        for i, seed in enumerate(seeds):
            fut = server.submit(request(seed, p))
            fut.add_done_callback(lambda _, i=i: done.setdefault(i, time.perf_counter()))
            futs.append(fut)
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        return wall, [done[i] - t0 for i in range(len(seeds))], outs

    server = AvatarServer(pipe, max_batch=SERVING_MAX_BATCH, batch_window_s=SERVING_WINDOW_S)
    rounds = []
    try:
        warm_s, _, _ = serve(server, range(SERVING_MAX_BATCH))
        cache = server._media_cache
        warm = (cache.misses, cache.hits, server.stats["batches"])
        reset_counts()
        for r in range(2):
            before = server.stats["batches"]
            seeds = [100 * (r + 1) + i for i in range(SERVING_ROUND)]
            wall, latency, outs = serve(server, seeds)
            rounds.append({"wall_s": wall, "requests_per_s": SERVING_ROUND / wall,
                           "frames_per_s": SERVING_ROUND * VAE_FRAMES / wall,
                           "latency_p50_s": statistics.median(latency),
                           "latency_max_s": max(latency),
                           "batches": server.stats["batches"] - before})
            del outs
        launches = read_counts()
        cache = (cache.misses, cache.hits)
        batched_seeds = list(range(300, 300 + SERVING_MAX_BATCH))
        batched = serve(server, batched_seeds, quiet)[2]
    finally:
        server.shutdown()
    solo = AvatarServer(pipe, max_batch=1, batch_window_s=0.0)
    try:
        # the batch's leader and its last request, each served alone
        alone = {i: solo.submit(request(batched_seeds[i], quiet)).result(timeout=600)
                 for i in (0, SERVING_MAX_BATCH - 1)}
    finally:
        solo.shutdown()
    batches = 2 * SERVING_ROUND // SERVING_MAX_BATCH
    expect = {name: n * batches for name, n in per_batch.items()}
    best = max(rounds, key=lambda r: r["requests_per_s"])
    first = batched[0]
    solo_rel_rms = {f"request {i} (seed {batched_seeds[i]})": _rel_rms(
        torch.from_numpy(batched[i]).float(), torch.from_numpy(out).float())
        for i, out in alone.items()}
    res = {"requests_per_s": best["requests_per_s"], "frames_per_s": best["frames_per_s"],
           "latency_p50_s": best["latency_p50_s"], "latency_max_s": best["latency_max_s"],
           "rounds": rounds, "warmup_s": warm_s,
           "cache_misses_hits_batches_after_warmup": warm,
           "cache_misses_hits_after_rounds": cache,
           "solo_rel_rms": solo_rel_rms,
           "solo_tol": REFERENCE_TOL if solo_gate else None, "output_shape": list(first.shape),
           "launches": {k: n for k, n in launches.items() if n}, "expected": expect}
    emit({"phase": phase, **res})
    if any(o.dtype != np.uint8 or o.shape != (VAE_FRAMES, VAE_SIZE * 3 // 2, VAE_SIZE)
           for o in batched):
        fail(f"{phase}: output {first.dtype} {first.shape}")
    if any(r["batches"] != SERVING_ROUND // SERVING_MAX_BATCH for r in rounds):
        fail(f"{phase}: batches per round {[r['batches'] for r in rounds]}")
    if warm[:2] != (2, 2 * SERVING_MAX_BATCH - 2) or cache[0] != 2:
        fail(f"{phase}: media cache {warm} after warm-up, {cache} after the rounds")
    for name, n in launches.items():
        if n != expect.get(name, 0):
            fail(f"{phase}: {name} launched {n} times, expected {expect.get(name, 0)}")
    if solo_gate and not max(solo_rel_rms.values()) <= REFERENCE_TOL:
        fail(f"{phase}: batched requests against alone {solo_rel_rms}")
    return launches


def run_serving_w8a8(pipe, per_batch):
    """The JAX package's served pipeline itself (``bench.py`` serves its
    ``quantize_weights="w8a8", quantize_vae="w8a8"`` pipeline): the same
    traffic as :func:`run_serving` over the 2B pipeline with the W8A8 DiT
    and the W8A8 VAE, so that kernel L runs at a served batch's decode
    shapes. The batched requests against alone are printed, not held: the
    int8 VAE's activation scale is one per tensor, over the batch, in the
    reference too."""
    import torch

    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline

    t0 = time.perf_counter()
    pipe_q = LTXVideoPipeline(pipe.dit_cfg, pipe.raw_dit_params, pipe.vae_cfg,
                              pipe.vae_params, quantize_weights="w8a8",
                              quantize_vae="w8a8", device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "init_serving_w8a8", "seconds": time.perf_counter() - t0})
    launches = run_serving(pipe_q, "serving_w8a8", per_batch, solo_gate=False)
    del pipe_q
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Preprocessing, profiling and the legacy VideoAutoencoder
# ---------------------------------------------------------------------------

# save-vae-latents at the CLI's defaults: 57-frame clips of 192 x 320,
# cycled from a pool of distinct clips; the end-to-end rate is that of the
# difference of a short and a long run (their fill and drain cancel),
# taken twice
PREPROCESS_FRAMES, PREPROCESS_SIZE, PREPROCESS_POOL = 57, (192, 320), 8
PREPROCESS_RUNS = (16, 272)
# the encode is device-bound where its kernels fill this share of the time
# per encode of back-to-back calls, else host-bound
DEVICE_BOUND_BUSY = 0.9
# f32 card against f32 CPU through the VAE's (or VideoAutoencoder's) convs,
# TF32 off: cuDNN's and the CPU's summation orders differ by ~1e-7 a layer
PREPROCESS_F32_TOL = 1e-5
# ``timed`` is held on a chain of bf16 products (count, square size) whose
# device time, ~25 ms, is about 200 times its dispatch
TIMED_CHAIN = (16, 8192)


def _clip_items(n, frames, size, seed, base="clip"):
    """``n`` decoded uint8 clips [1, frames, H, W, 3] as the CLI's decode
    stage hands them on (the card's machine has no cv2 or PIL to decode and
    resize), at 25 fps."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (1, frames, *size, 3), np.uint8), base, i, frames * i,
             frames * (i + 1), 25.0) for i in range(n)]


def _host_normalized(u8):
    """preprocess_frames' host expression: f32, times 2 / 255, minus 1."""
    import numpy as np

    x = u8.astype(np.float32)
    x *= 2.0 / 255.0
    x -= 1.0
    return x


class _KeptEncoder:
    """An encoder whose latents stay referenced on the card (no copy, no
    synchronize), for checking the files written against them."""

    def __init__(self, enc):
        self.enc, self.device, self.kept = enc, enc.device, {}

    def encode(self, media, seed, per_channel=True, noise=None):
        lat = self.enc.encode(media, seed, per_channel, noise)
        self.kept[seed] = lat
        return lat


def _vae_latents_args(out_dir, save_pixels=False):
    import types

    h, w = PREPROCESS_SIZE
    return types.SimpleNamespace(output_dir=str(out_dir), clip_length=PREPROCESS_FRAMES,
                                 stride=PREPROCESS_FRAMES, height=h, width=w,
                                 per_channel_normalize=True, format="safetensors",
                                 save_pixels=save_pixels, inputs=[], ckpt=None)


def _save_vae_latents_run(enc, pool, n):
    """One ``save-vae-latents`` run over ``n`` clips cycled from ``pool``
    into a temporary directory: (the run's stats, the files that are not
    [1, 128, 8, 6, 10], finite and equal to the latents the encode
    returned, the number of files)."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    import torch

    from avatar_tpu_torch.cli import preprocess as tpre
    from avatar_tpu_torch.utils.safetensors_io import load_safetensors

    f = PREPROCESS_FRAMES
    items = [(pool[i % len(pool)][0], "clip", i, f * i, f * (i + 1), 25.0) for i in range(n)]
    kept = _KeptEncoder(enc)
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        stats = tpre.cmd_save_vae_latents(_vae_latents_args(tmp), encoder=kept,
                                          clips=iter(items))
        n_files, bad = len(list(Path(tmp).iterdir())), []
        for _, base, i, _, _, _ in items:
            lat = load_safetensors(Path(tmp) / f"{base}_{i}.safetensors")[0]["latents"]
            want = kept.kept[i].float().cpu().permute(0, 4, 1, 2, 3)
            if (tuple(lat.shape) != (1, 128, 8, 6, 10) or not bool(torch.isfinite(lat).all())
                    or not torch.equal(lat, want)):
                bad.append((n, i, list(lat.shape)))
    return stats, bad, n_files


def run_preprocess_vae_latents(pipe):
    """``save-vae-latents`` of the port's preprocessing CLI over the 2B VAE
    (the pipeline's: ``LTX_VAE_CONFIG`` with timestep conditioning, random
    weights from a seed, bf16) on 57 x 192 x 320 random uint8 clips handed
    over after decode and resize, through the staging thread (pinned
    memory, a side stream), the encode and the save into a temporary
    directory. The encode alone on a resident clip: ms per encode of
    back-to-back calls by CUDA events, its kernels' device ms (profiler),
    the busy share and the host's dispatch ms, and whether it is host- or
    device-bound. End to end: runs of 16 and 272 clips, twice; the
    steady-state clips / s, frames / s and stage split of each pair's
    difference; peak memory. Every file read back through the port's
    safetensors reader: [1, 128, 8, 6, 10], finite, equal to the latents
    the encode returned; the uint8 path equal to the float path bit for bit
    on one clip with the same draw. No kernel of A-L runs."""
    import torch

    from avatar_tpu_torch.cli import preprocess as tpre

    enc = tpre.VAEEncoder.from_params(pipe.vae_params, pipe.vae_cfg, "bfloat16", "cuda")
    pool = _clip_items(PREPROCESS_POOL, PREPROCESS_FRAMES, PREPROCESS_SIZE, seed=31)
    resident = torch.from_numpy(pool[0][0]).cuda()
    encode_ms = time_ms(lambda: enc.encode(resident, 0), reps=5, batches=3)
    kernel_ms = device_ms(lambda: enc.encode(resident, 0), reps=3)
    dispatch = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode(resident, 0)
        dispatch.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    busy = None if isinstance(kernel_ms, EventsMs) else kernel_ms / encode_ms
    encode = {"ms_per_encode_events": encode_ms, "kernel_device_ms": kernel_ms,
              "busy_share": busy, "dispatch_ms": statistics.median(dispatch),
              "bound": None if busy is None else
              ("device" if busy >= DEVICE_BOUND_BUSY else "host")}

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runs, steady, bad, n_files = [], [], [], []
    for _ in range(2):
        pair = []
        for n in PREPROCESS_RUNS:
            stats, bad_run, files = _save_vae_latents_run(enc, pool, n)
            pair.append(stats)
            bad += bad_run
            n_files.append((n, files))
        runs += pair
        short, long = pair
        d = {k: long[k] - short[k] for k in ("clips", "frames", "seconds", "wait_s",
                                              "encode_s", "flush_s")}
        steady.append({"window_s": d["seconds"], "clips_per_s": d["clips"] / d["seconds"],
                       "frames_per_s": d["frames"] / d["seconds"],
                       "ms_per_clip": d["seconds"] / d["clips"] * 1e3,
                       "stage_share": {k: d[k] / d["seconds"]
                                       for k in ("wait_s", "encode_s", "flush_s")}})
    launched = {k: n for k, n in read_counts().items() if n}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # the uint8 path against the float path, the same draw
    noise = torch.randn((1, 8, 6, 10, 128), generator=torch.Generator().manual_seed(3))
    host = torch.from_numpy(_host_normalized(pool[1][0]))
    via_u8 = enc.encode(torch.from_numpy(pool[1][0]).cuda(), 1, noise=noise)
    via_f32 = enc.encode(host, 1, noise=noise)
    norm_equal = torch.equal(enc.normalize(torch.from_numpy(pool[1][0]).cuda()).float(),
                             host.cuda().to(enc.dtype).float())
    res = mark_event_times({
        "frames_per_clip": PREPROCESS_FRAMES, "size": list(PREPROCESS_SIZE), "dtype": "bf16",
        "encode": encode,
        "runs": [{k: r[k] for k in ("clips", "seconds", "wait_s", "encode_s", "flush_s")}
                 for r in runs],
        "steady_state": steady, "peak_gib": peak_gib, "files": n_files, "bad_files": bad,
        "uint8_equals_float": bool(torch.equal(via_u8, via_f32)),
        "normalize_equal": norm_equal, "launches": launched})
    emit({"phase": "preprocess_vae_latents", **res})
    if (bad or any(files != 2 * n for n, files in n_files) or launched
            or not res["uint8_equals_float"] or not norm_equal):
        fail(f"preprocess_vae_latents: {res}")
    return launched


def run_reference_preprocess():
    """``save-vae-latents`` from a tiny single-file checkpoint written by
    the port (the demo VAE of ``_tiny_models``, per-channel statistics away
    from 1 / 0), in f32 on the card and on the CPU, the same clips handed
    over decoded and the same draws: files within 1e-5 relative RMS and
    metadata equal."""
    import contextlib
    import io
    import json
    import tempfile
    from pathlib import Path

    import torch

    from avatar_tpu_torch.cli import preprocess as tpre
    from avatar_tpu_torch.utils.safetensors_io import load_safetensors
    from avatar_tpu_torch.utils.weight_import import (
        export_vae_state,
        save_single_file_checkpoint,
    )

    dcfg, dit, vcfg, vae = _tiny_models()
    g = torch.Generator().manual_seed(12)
    stats = vae["per_channel_statistics"]
    stats["std_of_means"] += 0.5 * torch.rand(stats["std_of_means"].shape, generator=g)
    stats["mean_of_means"] += 0.3 * torch.randn(stats["mean_of_means"].shape, generator=g)
    items = _clip_items(3, 17, (64, 96), seed=13, base="tiny")
    shape = (1, 3, 2, 3, vcfg.latent_channels)
    draws = {i: torch.randn(shape, generator=g) for i in range(3)}

    class Drawn(_KeptEncoder):
        def encode(self, media, seed, per_channel=True, noise=None):
            return super().encode(media, seed, per_channel, draws[seed])

    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        ckpt = Path(tmp) / "tiny.safetensors"
        save_single_file_checkpoint(ckpt, dit, dcfg, vae_state=export_vae_state(vae, vcfg),
                                    vae_config=vcfg.to_dict())
        out, launched = {}, {}
        for device in ("cuda", "cpu"):
            enc = Drawn(tpre.VAEEncoder(str(ckpt), precision="float32", device=device))
            reset_counts()
            tpre.cmd_save_vae_latents(_vae_latents_args(Path(tmp) / device), encoder=enc,
                                      clips=iter(items))
            launched.update({k: n for k, n in read_counts().items() if n})
            out[device] = {p.name: (load_safetensors(p)[0]["latents"] if p.suffix ==
                                    ".safetensors" else json.loads(p.read_text()))
                           for p in (Path(tmp) / device).iterdir()}
    errs = {n: _rel_rms(v, out["cpu"][n]) for n, v in out["cuda"].items()
            if isinstance(v, torch.Tensor)}
    meta_equal = all(out["cuda"][n] == v for n, v in out["cpu"].items() if isinstance(v, dict))
    res = {"files": sorted(out["cuda"]), "rel_rms": errs, "tol": PREPROCESS_F32_TOL,
           "metadata_equal": meta_equal, "launches": launched}
    emit({"phase": "reference_preprocess", **res})
    if (sorted(out["cuda"]) != sorted(out["cpu"]) or len(errs) != 3 or not meta_equal
            or launched or not all(e <= PREPROCESS_F32_TOL for e in errs.values())):
        fail(f"reference_preprocess: {res}")
    return launched


def run_preprocess_text_latents():
    """``save-text-latents`` on a random full-width FaceFormer
    (wav2vec2-base and ``FaceFormerConfig()``, ``random_faceformer_state``)
    saved as a vocaset-layout ``.pth``, over two wavs written with scipy
    (4.85 s and ``MAX_AUDIO_SAMPLES``), on the card and on the CPU in f32
    (TF32 off, as ``faceformer`` sets it): ``{stem}_ff.npy`` within
    ``FACEFORMER_TOL``; ms per file on the card (the checkpoint's load not
    included)."""
    import contextlib
    import io
    import tempfile
    import types
    from pathlib import Path

    import numpy as np
    import torch
    from scipy.io import wavfile

    from avatar_tpu_torch.cli import preprocess as tpre
    from avatar_tpu_torch.models import faceformer as tff
    from avatar_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from avatar_tpu_torch.pipelines import pose_frames as tpose

    rng = np.random.default_rng(17)
    res, launched = {}, {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(io.StringIO()):
        tmp = Path(tmp)
        torch.save(random_faceformer_state(Wav2Vec2Config(), tff.FaceFormerConfig(), seed=43,
                                           device="cpu"), tmp / "vocaset.pth")
        for name, samples in (("short", int(FACEFORMER_SECONDS * 16000)),
                              ("max", tpose.MAX_AUDIO_SAMPLES)):
            wavfile.write(tmp / f"{name}.wav", 16000,
                          (rng.standard_normal(samples) * 3000).astype(np.int16))
        wavs = [str(tmp / "short.wav"), str(tmp / "max.wav")]
        out = {}
        for device in ("cuda", "cpu"):
            args = types.SimpleNamespace(inputs=wavs, output_dir=str(tmp / device),
                                         faceformer_checkpoint=str(tmp / "vocaset.pth"),
                                         device=device)
            if device == "cuda":
                tpre.cmd_save_text_latents(args)  # warm-up
                reset_counts()
            res[f"{device}_s_by_file"] = dict(tpre.cmd_save_text_latents(args))
            if device == "cuda":
                launched = {k: n for k, n in read_counts().items() if n}
            out[device] = {p.name: np.load(p) for p in (tmp / device).glob("*_ff.npy")}
    errs = {n: _rel_rms(torch.from_numpy(v), torch.from_numpy(out["cpu"][n]))
            for n, v in out["cuda"].items()}
    res.update({"shapes": {n: list(v.shape) for n, v in out["cuda"].items()},
                "rel_rms": errs, "tol": FACEFORMER_TOL,
                "ms_per_file": {k: v * 1e3 for k, v in res["cuda_s_by_file"].items()},
                "launches": launched})
    emit({"phase": "preprocess_text_latents", **res})
    if (sorted(out["cuda"]) != ["max_ff.npy", "short_ff.npy"] or launched
            or not all(e <= FACEFORMER_TOL for e in errs.values())):
        fail(f"preprocess_text_latents: {res}")
    return launched


def run_profiling(pipe):
    """``utils/profiling.py`` on the card. ``trace()`` around one 2B VAE
    encode of a resident 57 x 192 x 320 clip inside ``annotate("encode")``:
    the trace file holds the range and CUDA kernel events. ``timed`` over a
    chain of 16 bf16 products of 8192 x 8192 (device time ~200 times its
    dispatch): its seconds per call inside the window of single-call CUDA
    event times taken before and after it, widened on either side by their
    spread and above by ``timed``'s own cost on a trivial call (launch and
    synchronize); and the same ``timed`` with its synchronize taken out
    below that window."""
    import json
    import tempfile
    from pathlib import Path
    from unittest import mock

    import torch

    from avatar_tpu_torch.cli import preprocess as tpre
    from avatar_tpu_torch.utils import profiling

    enc = tpre.VAEEncoder.from_params(pipe.vae_params, pipe.vae_cfg, "bfloat16", "cuda")
    clip = torch.from_numpy(_clip_items(1, PREPROCESS_FRAMES, PREPROCESS_SIZE, 37)[0][0]).cuda()
    enc.encode(clip, 0)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(str(Path(tmp) / "trace")) as prof:
            with profiling.annotate("encode"):
                enc.encode(clip, 0)
        events = json.loads(Path(prof.trace_path).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ranges = [e for e in events if e.get("name") == "encode"]

    count, n = TIMED_CHAIN
    g = torch.Generator(device="cuda").manual_seed(41)
    a = torch.randn((n, n), device="cuda", dtype=torch.bfloat16, generator=g)
    b = torch.randn((n, n), device="cuda", dtype=torch.bfloat16, generator=g) / math.sqrt(n)

    def chain():
        x = a
        for _ in range(count):
            x = x @ b
        return x

    def event_times(reps=4):
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / 1e3)
        return out

    chain()
    torch.cuda.synchronize()
    single = event_times()
    _, timed_s = profiling.timed(chain, iters=5, warmup=1)
    single += event_times()
    _, trivial_s = profiling.timed(lambda: a[:1, :1] + 1, iters=20, warmup=2)
    with mock.patch.object(profiling, "_materialize", lambda result: None):
        _, unsynced_s = profiling.timed(chain, iters=5, warmup=1)
    torch.cuda.synchronize()
    spread = max(single) - min(single)
    lo, hi = min(single) - spread, max(single) + spread + trivial_s
    res = {"trace_events": len(events), "kernel_events": len(kernels),
           "encode_ranges": len(ranges),
           "kernel_device_ms": sum(e.get("dur", 0) for e in kernels) / 1e3,
           "chain": list(TIMED_CHAIN), "timed_s": timed_s, "events_s": single,
           "trivial_timed_s": trivial_s, "accepted_s": [lo, hi],
           "unsynchronized_timed_s": unsynced_s}
    emit({"phase": "profiling", **res})
    if not kernels or not ranges or not lo <= timed_s <= hi or not unsynced_s < lo:
        fail(f"profiling: {res}")


def run_reference_video_autoencoder():
    """The legacy VideoAutoencoder, tiny, at ``dims=3`` (pixel norm, patch
    2) and ``dims=(2, 1)`` (group norm, channel padding, single-frame path
    too), f32 on the card against f32 on the CPU, same weights: moments and
    reconstructions within 1e-5 relative RMS. Nothing calls this model; no
    kernel of A-L runs."""
    import torch

    from avatar_tpu_torch.models import video_autoencoder as tva

    cases = {
        "dims3": (tva.VideoAutoencoderConfig(
            latent_channels=8, block_out_channels=(32, 64, 64), layers_per_block=2,
            norm_layer="pixel_norm", patch_size=2, patch_size_t=1), (2, 8, 64, 64, 3)),
        "dims21": (tva.VideoAutoencoderConfig.from_dict(dict(
            _class_name="VideoAutoencoder", dims=[2, 1], latent_channels=8,
            block_out_channels=[32, 64], patch_size=2, norm_layer="group_norm",
            add_channel_padding=True)), (1, 8, 32, 32, 3)),
        "dims21_frame": (None, (1, 1, 32, 32, 3)),
    }
    res, worst, launched = {}, 0.0, {}
    g = torch.Generator().manual_seed(21)
    for name, (cfg, shape) in cases.items():
        cfg = cfg or cases["dims21"][0]
        params = tva.init_video_autoencoder(cfg, seed=5, device="cpu")
        x = torch.randn(shape, generator=g)
        in_time = shape[1] != 1
        outs = {}
        for device in ("cpu", "cuda"):
            p = _tree_to(params, device, torch.float32)
            reset_counts()
            with torch.no_grad():
                m = tva.video_encoder_apply(p, cfg, x.to(device))
                r = tva.video_decoder_apply(p, cfg, m[..., :cfg.latent_channels],
                                            upsample_in_time=in_time)
            launched.update({k: n for k, n in read_counts().items() if n})
            outs[device] = (m.cpu(), r.cpu())
        errs = [_rel_rms(outs["cuda"][i], outs["cpu"][i]) for i in (0, 1)]
        res[name] = {"moments_rel_rms": errs[0], "recon_rel_rms": errs[1],
                     "recon_shape": list(outs["cuda"][1].shape)}
        worst = max(worst, *errs)
        if tuple(outs["cuda"][1].shape) != shape:
            fail(f"reference_video_autoencoder {name}: {res[name]}")
    emit({"phase": "reference_video_autoencoder", "runs": res, "tol": PREPROCESS_F32_TOL,
          "launches": launched})
    if not worst <= PREPROCESS_F32_TOL or launched:
        fail(f"reference_video_autoencoder: {worst} > {PREPROCESS_F32_TOL} or {launched}")
    return launched


def run_preprocess_phases(pipe) -> dict:
    """The five phases of the preprocessing slice; each path's launches of
    A-L (none)."""
    import torch

    torch.cuda.empty_cache()
    paths = {"preprocess_vae_latents": run_preprocess_vae_latents(pipe),
             "reference_preprocess": run_reference_preprocess(),
             "preprocess_text_latents": run_preprocess_text_latents()}
    run_profiling(pipe)
    paths["reference_video_autoencoder"] = run_reference_video_autoencoder()
    return paths


# ---------------------------------------------------------------------------
# The multi-device layer at world size 1 (parallel/)
# ---------------------------------------------------------------------------

# The sequence- and pipeline-parallel DiT against the unsharded one, both
# bf16 on the card: they run the same function through other kernels (C for
# every attention under sp, where the unsharded long path runs C and B), so
# they differ as the kernel path differs from plain attention
# (KERNEL_PATH_TOL).
PARALLEL_TOL = KERNEL_PATH_TOL
# The ring's 4 chunks merged against the whole-sequence kernels, bf16: O, dK
# and dV are each one kernel's output rounded once (KERNEL_ULPS and F's
# F_ULPS); dQ sums 4 bf16-rounded partials in f32, so it may sit up to half
# an ulp of each partial further (RING_DQ_ULPS); the merged lse is an f32
# log-sum-exp of the chunks' (LSE_TOL).
F_ULPS = 4
RING_DQ_ULPS = 8
RING_CHUNKS = 4


def init_world1():
    """An NCCL process group of one (this process, the card) on a TCP store
    at a free localhost port: the multi-device layer's collectives then run
    on NCCL, at world size 1."""
    import socket

    from avatar_tpu_torch.parallel import initialize

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize(f"localhost:{port}", 1, 0, device="cuda", timeout_s=300)


def _long_inputs(pipe, g):
    """The long operating point's denoiser input (5376 tokens, 256 caption
    tokens of which 200 kept) and the walk's hoisted tables, bf16."""
    import torch

    from avatar_tpu_torch.models.dit import (
        precompute_cross_attention_kv, precompute_timestep_tables)
    from avatar_tpu_torch.ops.rope import get_latent_coords, precompute_freqs_cis, split_freqs

    dcfg, bf16 = pipe.dit_cfg, torch.bfloat16
    x = torch.randn(1, LONG_TOKENS, dcfg.in_channels, generator=g, device="cuda").to(bf16)
    grid = get_latent_coords(*LONG_GRID, batch_size=1, device="cuda").float()
    embeds = torch.randn(1, CAPTION, dcfg.caption_channels, generator=g,
                         device="cuda").to(bf16)
    mask = torch.ones(1, CAPTION, device="cuda")
    mask[0, 200:] = 0.0
    freqs = split_freqs(precompute_freqs_cis(
        grid, dim=dcfg.inner_dim, theta=dcfg.positional_embedding_theta,
        max_pos=dcfg.positional_embedding_max_pos, out_dtype=bf16))
    kv, _ = precompute_cross_attention_kv(pipe.dit_params, dcfg, embeds, dtype=bf16)
    ada, emb = precompute_timestep_tables(pipe.dit_params, dcfg,
                                          torch.tensor([0.7], device="cuda"), 1, bf16)
    return x, dict(encoder_attention_mask=mask, freqs_cis=freqs, cross_kv=kv,
                   timestep_tables=(ada[0], emb[0]), rope_split=True)


def run_parallel_world1(pipe) -> dict:
    """``dit_apply_sp`` (Ulysses, ring) and ``dit_apply_pp`` (one stage) on
    the long operating point's input, each against the unsharded
    ``dit_apply`` (PARALLEL_TOL) and timed beside it (CUDA events), with its
    launches by route; then a ``dp_mesh`` pipeline's generation at 161 f ·
    512 px against the same pipeline without the mesh on the same
    generator (equal: the same kernels, a gather of one rank). All over an
    NCCL process group of one (:func:`init_world1`)."""
    import numpy as np
    import torch

    from avatar_tpu_torch.models.dit import dit_apply
    from avatar_tpu_torch.parallel import (
        Mesh, dit_apply_pp, dit_apply_sp, make_pp_mesh, stack_block_params)
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams, LTXVideoPipeline

    dcfg = pipe.dit_cfg
    g = torch.Generator(device="cuda").manual_seed(41)
    x, common = _long_inputs(pipe, g)
    sp_mesh, pp_mesh = Mesh(np.arange(1), ("sp",)), make_pp_mesh(1)
    stacked = dict(pipe.dit_params, blocks=stack_block_params(pipe.dit_params["blocks"]))
    paths = {
        "unsharded": lambda: dit_apply(pipe.dit_params, dcfg, x, **common),
        "sp_ulysses": lambda: dit_apply_sp(pipe.dit_params, dcfg, x, None, None,
                                           mesh=sp_mesh, sp_impl="ulysses", **common),
        "sp_ring": lambda: dit_apply_sp(pipe.dit_params, dcfg, x, None, None,
                                        mesh=sp_mesh, sp_impl="ring", **common),
        "pp_1": lambda: dit_apply_pp(stacked, dcfg, x, None, None, mesh=pp_mesh, **common),
    }
    by_path, rows, base = {}, {}, None
    with torch.no_grad():
        for name, fn in paths.items():
            torch.cuda.synchronize()
            reset_counts()
            out = fn()
            torch.cuda.synchronize()
            launches = {k: n for k, n in read_counts().items() if n}
            if not torch.isfinite(out).all():
                fail(f"parallel_world1 {name}: non-finite output")
            if base is None:
                base = out.float()
            row = {"launches": launches, "ms": time_ms(fn, reps=3, batches=3)}
            if name != "unsharded":
                row["rel_rms_vs_unsharded"] = _rel_rms(out.float(), base)
                if row["rel_rms_vs_unsharded"] > PARALLEL_TOL:
                    fail(f"parallel_world1 {name}: {row['rel_rms_vs_unsharded']} from the "
                         f"unsharded DiT (limit {PARALLEL_TOL})")
                by_path[f"parallel_world1_{name}"] = launches
            rows[name] = row
    for name in ("sp_ulysses", "sp_ring"):
        got = rows[name]["launches"]
        if any(got.get(k) for k in TOKEN_MAJOR_BF16):
            fail(f"parallel_world1 {name}: a token-major kernel ran under sp: {got}")
        if got.get("flash_bounded_sm90") != 2 * LAYERS:
            fail(f"parallel_world1 {name}: {got.get('flash_bounded_sm90')} launches of C, "
                 f"expected {2 * LAYERS} (self- and cross-attention per block)")
    del stacked
    # the dp pipeline at world 1 against the same pipeline without the mesh
    pipe_dp = LTXVideoPipeline(pipe.dit_cfg, pipe.raw_dit_params, pipe.vae_cfg,
                               pipe.vae_params, dp_mesh=Mesh(np.arange(1), ("data",)),
                               device="cuda")
    params = GenerationParams(height=512, width=512, num_frames=161, num_inference_steps=3,
                              guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0)
    embeds = torch.randn(1, CAPTION, dcfg.caption_channels, generator=g, device="cuda")
    mask = torch.ones(1, CAPTION, device="cuda")
    outs = {}
    for name, p in (("unsharded", pipe), ("dp_1", pipe_dp)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            outs[name] = p(params, torch.Generator(device="cuda").manual_seed(5), embeds, mask,
                           output_type="latent")
        torch.cuda.synchronize()
        rows[f"pipeline_{name}"] = {"seconds": time.perf_counter() - t0,
                                    "launches": {k: n for k, n in read_counts().items() if n}}
    by_path["parallel_world1_dp_1"] = rows["pipeline_dp_1"]["launches"]
    if not torch.equal(outs["dp_1"], outs["unsharded"]):
        fail(f"parallel_world1 dp_1: {_rel_rms(outs['dp_1'].float(), outs['unsharded'].float())}"
             " from the pipeline without the mesh (expected equal)")
    del pipe_dp
    torch.cuda.empty_cache()
    emit({"phase": "parallel_world1", "backend": "nccl", "world_size": 1,
          "tokens": LONG_TOKENS, "caption": CAPTION, "paths": rows,
          "tolerance": PARALLEL_TOL})
    return by_path


def _ring_case(g, batch, masked):
    """q, k (rms-normalized rows: qk-norm-like logits, |s| <= 8 at scale
    1/8), v, the output gradient and the kv keep-mask: with ``masked``,
    batch row 0 keeps 80% of its keys and none of the second chunk's, row
    1 keeps none."""
    import torch

    bf16 = torch.bfloat16

    def draw():
        return torch.randn(batch, HEADS, LONG_TOKENS, HEAD_DIM, generator=g, device="cuda")

    q, k = (rms_rows(draw()).to(bf16) for _ in range(2))
    v, gout = draw().to(bf16), draw().to(bf16)
    mask = None
    if masked:
        mask = (torch.rand(batch, LONG_TOKENS, generator=g, device="cuda") > 0.2).float()
        c = LONG_TOKENS // RING_CHUNKS
        mask[0, c:2 * c] = 0.0
        mask[1:] = 0.0
    return q, k, v, gout, mask


def check_ring_chunks(peaks) -> dict:
    """The ring's chunk step on one card: [B, 32, 5376, 64] bf16 split into
    RING_CHUNKS chunks of 1,344 keys, each hop one flash forward (C when
    bounded, D when not) merged by log-sum-exp, the backward one F (dK/dV
    and dQ) per hop against the merged lse and O. The merged O and lse, dQ,
    dK and dV against the whole-sequence kernels and their plain versions
    on the same inputs; with a kv mask, a batch row with no kept key gets
    O = 0 and zero gradients. Launch counts: RING_CHUNKS forwards, dkv and
    dq launches per run; the chunked forward and backward timed beside the
    whole-sequence C / D and F (CUDA events)."""
    import torch

    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.parallel.sequence import (
        ring_flash_chunk_backward, ring_flash_chunk_forward, ring_global_lse)

    g = torch.Generator(device="cuda").manual_seed(43)
    scale = HEAD_DIM ** -0.5
    c = LONG_TOKENS // RING_CHUNKS
    cases = {"bounded": (True, 1, False), "online": (False, 1, False),
             "bounded_masked": (True, 2, True), "online_masked": (False, 2, True)}
    out_rows, by_path = {}, {}
    for name, (bounded, batch, masked) in cases.items():
        q, k, v, gout, mask = _ring_case(g, batch, masked)
        ks = [k[:, :, i * c:(i + 1) * c].contiguous() for i in range(RING_CHUNKS)]
        vs = [v[:, :, i * c:(i + 1) * c].contiguous() for i in range(RING_CHUNKS)]
        ms = [None if mask is None else mask[:, i * c:(i + 1) * c].contiguous()
              for i in range(RING_CHUNKS)]

        def chunked_forward():
            acc = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
            lse = torch.full(q.shape[:3], fa.NEG_INF, dtype=torch.float32, device="cuda")
            for kc, vc, mc in zip(ks, vs, ms):
                acc, lse = ring_flash_chunk_forward(q, kc, vc, mc, acc, lse, scale, bounded)
            return acc.to(q.dtype), lse

        def chunked_backward(out, lse):
            lse = ring_global_lse(lse)
            dq = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
            dks, dvs = [], []
            for kc, vc, mc in zip(ks, vs, ms):
                zero = torch.zeros(kc.shape, dtype=torch.float32, device="cuda")
                dq, dk, dv = ring_flash_chunk_backward(q, kc, vc, mc, out, lse, gout, scale,
                                                       dq, zero, zero.clone())
                dks.append(dk)
                dvs.append(dv)
            return dq, torch.cat(dks, 2), torch.cat(dvs, 2)

        torch.cuda.synchronize()
        reset_counts()
        out, lse = chunked_forward()
        dq, dk, dv = chunked_backward(out, lse)
        torch.cuda.synchronize()
        launches = {k_: n for k_, n in read_counts().items() if n}
        mode = "bounded" if bounded else "online"
        expect = {f"flash_{mode}": RING_CHUNKS, f"flash_{mode}_sm90": RING_CHUNKS,
                  "flash_bwd_dkv": RING_CHUNKS, "flash_bwd_dkv_sm90": RING_CHUNKS,
                  "flash_bwd_dq": RING_CHUNKS, "flash_bwd_dq_sm90": RING_CHUNKS}
        if launches != expect:
            fail(f"ring_chunks {name}: launched {launches}, expected {expect}")
        if not masked:
            by_path[f"ring_chunks_{mode}"] = launches
        # the whole sequence: C / D and F, then the plain versions
        o_w, lse_w = fa._flash_forward(q, k, v, mask, scale, bounded)
        dq_w, dk_w, dv_w = fa._flash_backward(q, k, v, mask, o_w, lse_w, gout, scale)
        # the plain versions a batch row at a time (their f32 logits are
        # 3.7 GB a row)
        plain = []
        for b_ in range(batch):
            sl = slice(b_, b_ + 1)
            m_ = None if mask is None else mask[sl]
            qf, sf = fa.fold_scale(q[sl], scale)
            o_b, lse_b = fa._flash_plain(qf, k[sl], v[sl], m_, sf, mode)
            plain.append((o_b, lse_b) + fa._flash_backward_plain(
                q[sl], k[sl], v[sl], m_, o_b, lse_b, gout[sl], scale))
        o_p, lse_p, dq_p, dk_p, dv_p = (torch.cat(t) for t in zip(*plain))
        del plain
        row = {}
        for ref_name, refs in (("whole", (o_w, lse_w, dq_w, dk_w, dv_w)),
                               ("plain", (o_p, lse_p, dq_p, dk_p, dv_p))):
            errs = KernelErrors(f"ring_chunks {name} against the {ref_name} sequence")
            errs.add("o", out, refs[0])
            f_errs = KernelErrors(f"ring_chunks {name} dK/dV against the {ref_name} sequence",
                                  ulps=F_ULPS)
            f_errs.add("dk", dk, refs[3])
            f_errs.add("dv", dv, refs[4])
            q_errs = KernelErrors(f"ring_chunks {name} dQ against the {ref_name} sequence",
                                  ulps=RING_DQ_ULPS)
            q_errs.add("dq", dq, refs[2])
            keep = refs[1] < 0.5 * fa.LSE_MASKED
            lse_err = (ring_global_lse(lse) - refs[1])[keep].abs().max().item()
            if not lse_err <= LSE_TOL:
                fail(f"ring_chunks {name}: lse {lse_err} from the {ref_name} sequence")
            row[ref_name] = {"o": errs.check(), "dk_dv": f_errs.check(), "dq": q_errs.check(),
                             "lse": lse_err}
        if masked:
            dead = [t[1:] for t in (out, dq, dk, dv)]
            if any(bool(t.abs().max() != 0) for t in dead):
                fail(f"ring_chunks {name}: a row with no kept key got a nonzero output or "
                     "gradient")
        row["launches"] = launches
        if not masked:
            row["chunked_forward_ms"] = time_ms(chunked_forward, reps=5, batches=3)
            row["whole_forward_ms"] = time_ms(
                lambda: fa._flash_forward(q, k, v, mask, scale, bounded), reps=5, batches=3)
            row["chunked_backward_ms"] = time_ms(lambda: chunked_backward(out, lse), reps=5,
                                                 batches=3)
            row["whole_backward_ms"] = time_ms(
                lambda: fa._flash_backward(q, k, v, mask, o_w, lse_w, gout, scale),
                reps=5, batches=3)
        out_rows[name] = row
        del q, k, v, gout, ks, vs
    emit({"phase": "ring_chunks", "shape": [1, HEADS, LONG_TOKENS, HEAD_DIM],
          "chunks": RING_CHUNKS, "keys_per_chunk": c, "cases": out_rows,
          "tolerance_ulps": {"o": KERNEL_ULPS, "dk_dv": F_ULPS, "dq": RING_DQ_ULPS},
          "lse_tol": LSE_TOL})
    return by_path


def run_train_parallel_world1(pipe) -> dict:
    """One "lora_audio" optimizer step at ``run_train``'s shape (batch 8 x
    480 tokens, 2 micro-batches) under the sharded train step
    (``TrainSharding``) at world size 1 over NCCL: "sp" with Ulysses and
    with the ring, "zero2" and "fsdp", each with AdamW and Adafactor,
    against the unsharded ("dp") step on the same batch and generator:
    the loss within TRAIN_LOSS_RTOL, the update within TRAIN_UPDATE_TOL
    relative RMS. Peak memory per run."""
    import dataclasses

    import numpy as np
    import torch

    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.parallel import Mesh, make_mesh
    from avatar_tpu_torch.train import train as tt

    dcfg = pipe.dit_cfg
    g = torch.Generator(device="cuda").manual_seed(47)
    batch = _train_batch(dcfg, g)
    embeds = torch.randn(1, CAPTION, dcfg.caption_channels, generator=g, device="cuda")
    mask = torch.ones(1, CAPTION, device="cuda")
    mask[0, 200:] = 0.0
    base_cfg = TrainConfig(checkpoint_path="-", train_mode="lora_audio", learning_rate=1e-4,
                           lora_rank=32, lora_alpha=32, batch_size=TRAIN_BATCH,
                           gradient_accumulation_steps=TRAIN_ACCUM, rf_log_normal_mu=-0.5,
                           rf_log_normal_sigma=1.0)
    trainable0 = tt.init_trainable(pipe.raw_dit_params, dcfg, base_cfg,
                                   torch.Generator(device="cuda").manual_seed(3))
    modes = {"sp_ulysses": ("sp", "ulysses"), "sp_ring": ("sp", "ring"),
             "zero2": ("zero2", None), "fsdp": ("fsdp", None)}
    rows, by_path = {}, {}
    for opt_name in ("adamw", "adafactor"):
        cfg = dataclasses.replace(base_cfg, optimizer=opt_name)
        runs = {}
        for name, (mode, sp_impl) in [("dp", (None, None))] + list(modes.items()):
            opt = tt.make_optimizer(cfg)
            params, trainable = pipe.dit_params, trainable0
            run_cfg = cfg if sp_impl is None else dataclasses.replace(cfg, sp_impl=sp_impl)
            if mode is None:
                state, sharding = opt.init(trainable), None
            else:
                mesh = (Mesh(np.arange(1).reshape(1, 1), ("data", "sp")) if mode == "sp"
                        else make_mesh(data=1, fsdp=1))
                sharding = tt.TrainSharding(mesh, mode)
                params, trainable = sharding.place(params, trainable)
                state = sharding.init_optimizer(opt, trainable)
            step = tt.make_train_step(dcfg, run_cfg, opt, rope_split=True, sharding=sharding)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            trainable, state, metrics = step(trainable, state, params, batch, embeds, mask,
                                             torch.Generator(device="cuda").manual_seed(9))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: n for k, n in read_counts().items() if n}
            if sharding is not None:
                trainable = sharding.full_tree(trainable)
                by_path[f"train_parallel_world1_{name}_{opt_name}"] = launches
            runs[name] = (float(metrics["loss"]), trainable)
            row = {"loss": float(metrics["loss"]), "seconds": seconds,
                   "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
                   "launches": launches}
            if mode is not None:
                ref_loss, ref_tr = runs["dp"]
                row["loss_rel"] = abs(row["loss"] - ref_loss) / abs(ref_loss)
                row["update_rel_rms"] = _update_rel_rms(trainable0, trainable, ref_tr)
                if not (row["loss_rel"] <= TRAIN_LOSS_RTOL
                        and row["update_rel_rms"] <= TRAIN_UPDATE_TOL):
                    fail(f"train_parallel_world1 {name} {opt_name}: loss {row['loss_rel']}, "
                         f"update {row['update_rel_rms']} from the dp step")
            rows[f"{name}_{opt_name}"] = row
            del state, step
        del runs
        torch.cuda.empty_cache()
    emit({"phase": "train_parallel_world1", "backend": "nccl", "world_size": 1,
          "batch": TRAIN_BATCH, "tokens": TRAIN_TOKENS, "accum": TRAIN_ACCUM, "runs": rows,
          "loss_rtol": TRAIN_LOSS_RTOL, "update_tol": TRAIN_UPDATE_TOL})
    return by_path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card only",
              file=sys.stderr)
        return 1
    from avatar_tpu_torch.models.dit import SkipLayerStrategy
    from avatar_tpu_torch.ops import kernel_build
    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    peak_key, peaks = peaks_for(name)
    emit({"phase": "card", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "peaks_from": f"{peak_key} data sheet",
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # the default build: every source's bf16 / 64 library, the Hopper
    # kernels at head dim 128 and the WMMA A, B and E at head dim 128 (timed
    # beside them), one nvcc each, all in parallel
    t0 = time.perf_counter()
    kernel_build.build_all(list(kernel_build.KERNEL_SOURCES)
                           + [(name, ("ATTN_D=128",)) for name in (
                               "rope_attention_sm90", "token_attention_sm90",
                               "flash_forward_sm90", "flash_backward_sm90",
                               "rope_attention", "token_attention", "flash_forward")])
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in kernel_build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "seconds_by_library": dict(kernel_build.build_seconds), "ptxas": ptxas})
    # the variants kernel_generality needs build meanwhile, in the background
    builder = ThreadPoolExecutor(max_workers=1)
    builds = builder.submit(kernel_build.build_all, generality_specs())

    rows = [check_rope_kernel(peaks), check_token_kernel(peaks)] + [
        check_flash_kernel(mode, peaks) for mode in FLASH_KERNELS] + check_flash_backward(
        peaks) + [check_w8a8_kernel(peaks)]
    rows += check_row_quant_kernels(peaks) + check_flash_dense(peaks)
    conv_rows, conv_launches, decode_launches = check_int8_conv3d(peaks)
    rows += conv_rows
    check_attention_gradients()
    # the f32 variants come from the background build
    rows += check_wmma_rows(peaks)
    check_kernel_generality(builds, peaks)
    builder.shutdown()
    emit({"phase": "build_variants", "ptxas": {
        n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for n, log in kernel_build.build_logs.items() if n not in ptxas}})
    # launches of each kernel on each driven path: the counts are set to 0
    # just before a path and read just after it
    by_path = {"attention_dense_bias": check_attention_dense_bias(),
               "reference": check_reference()}
    by_path["reference_guided"], by_path["reference_guided_f32"] = check_reference_guided()
    by_path.update({"reference_conditioned": check_reference_conditioned(),
               "reference_vae_variants": check_reference_vae_variants(),
               "reference_w8a8": check_reference_w8a8(),
               "reference_vae_w8a8": check_reference_vae_w8a8(),
               "reference_train": check_reference_train(),
               "reference_train_options": check_reference_train_options(),
               "reference_train_decoder": check_reference_train_decoder(),
               "train_cli": check_train_cli()})
    t5_embeds, t5_mask, by_path["t5"] = run_t5()
    torch.cuda.empty_cache()
    pipe, init_s = make_full_pipeline()
    emit({"phase": "init", "seconds": init_s})
    every = LAYERS * STEPS
    plain = dict(guidance_scale=1.0, stg_scale=0.0, rescaling_scale=1.0)
    shipped = dict(guidance_scale=3.0, stg_scale=1.0, rescaling_scale=0.7,
                   skip_block_list=[19],
                   skip_layer_strategy=SkipLayerStrategy.AttentionValues)
    # A and B on the Hopper kernels at every launch, none on the WMMA ones
    # (run_pipeline holds every other counter to 0)
    short_attention = {name: every for name in TOKEN_MAJOR_BF16}
    by_path["pipeline"], plain_s, _ = run_pipeline(
        pipe, "pipeline", 256, 97, plain, short_attention, 5)
    # the long path's self-attention: every launch on the Hopper kernel,
    # none on the WMMA one (run_pipeline holds every other counter to 0)
    long_attention = {"flash_bounded": every, "flash_bounded_sm90": every,
                      "fused_token_attention": every, "fused_token_attention_sm90": every}
    by_path["pipeline_long"], long_s, long_latents = run_pipeline(
        pipe, "pipeline_long", 512, 161, plain, long_attention, 3)
    by_path["pipeline_guided"], guided_s, _ = run_pipeline(
        pipe, "pipeline_guided", 256, 97, shipped,
        short_attention, 0,
        extra={"num_conds": 3, "guidance_1_total_s": plain_s})
    # image-to-video: the T5-XXL embeddings as prompt and negative prompt,
    # the shipped guidance, one first-frame item of strength 1 with the
    # image-conditioning noise
    from avatar_tpu_torch.pipelines.pipeline import ConditioningItem

    image = torch.rand(1, 1, 256, 256, 3, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(9)) * 2 - 1
    by_path["pipeline_conditioned"], _, _ = run_pipeline(
        pipe, "pipeline_conditioned", 256, 97,
        {**shipped, "image_cond_noise_scale": 0.15},
        short_attention, 0,
        extra={"num_conds": 3, "guided_total_s": guided_s,
               "prompt": f"T5-XXL embeddings, {T5_KEPT[0]} and {T5_KEPT[1]} kept tokens",
               "conditioning": "first frame, strength 1.0"},
        inputs=dict(prompt_embeds=t5_embeds[:1], prompt_attention_mask=t5_mask[:1],
                    negative_prompt_embeds=t5_embeds[1:],
                    negative_prompt_attention_mask=t5_mask[1:],
                    conditioning_items=[ConditioningItem(image, 0, 1.0)]))
    # the W8A8 VAE on the main path, then the serving layer's traffic
    by_path["pipeline_vae_w8a8"] = run_pipeline_vae_w8a8(pipe, conv_launches,
                                                         short_attention, plain_s)
    # (a batch decodes once; the cached media are not encoded again)
    per_batch = {name: every for name in TOKEN_MAJOR_BF16}
    by_path["serving"] = run_serving(pipe, "serving", per_batch)
    by_path["serving_w8a8"] = run_serving_w8a8(pipe, {
        **per_batch, **decode_launches})
    # W8A8 from the same raw (unpermuted, bf16) tree: only the int8 copies
    # of the block linears and the permuted q/k are new
    t0 = time.perf_counter()
    pipe_w8a8 = LTXVideoPipeline(pipe.dit_cfg, pipe.raw_dit_params, pipe.vae_cfg,
                                 pipe.vae_params, quantize_weights="w8a8", device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "init_w8a8", "seconds": time.perf_counter() - t0})
    by_path["pipeline_long_w8a8"], _, w8a8_latents = run_pipeline(
        pipe_w8a8, "pipeline_long_w8a8", 512, 161, plain,
        {"w8a8_matmul": 8 * every, "w8a8_matmul_sm90": 8 * every,
         "quantize_rows": 3 * every,
         "rms_mod_quant": 2 * every, "rms_mod_quant_sm90": 2 * every,
         "act_quant": every, "act_quant_sm90": every,
         **long_attention}, 3,
        extra={"bf16_total_s": long_s})
    # a finding, not a gate: how far int8 moves the 2B latents from bf16's
    emit({"phase": "pipeline_long_w8a8_vs_bf16",
          "rel_rms": _rel_rms(w8a8_latents.float(), long_latents.float())})
    del pipe_w8a8, w8a8_latents, long_latents
    torch.cuda.empty_cache()
    # the inference CLI from a checkpoint exported from these models
    by_path.update(run_cli_phases(pipe, t5_embeds, t5_mask))
    del t5_embeds
    by_path["train"] = run_train(pipe)
    # the multi-device layer at world size 1, over NCCL
    t0 = time.perf_counter()
    init_world1()
    by_path.update(run_parallel_world1(pipe))
    by_path.update(check_ring_chunks(peaks))
    by_path.update(run_train_parallel_world1(pipe))
    emit({"phase": "parallel_phases", "seconds": time.perf_counter() - t0})
    # the pose path, then training part 1 at full width
    ff = run_faceformer()
    by_path["train_audio"] = run_train_audio(pipe, ff)
    del ff
    torch.cuda.empty_cache()
    by_path["train_full_remat"] = run_train_full_remat(pipe)
    by_path["train_decoder"] = run_train_decoder(pipe)
    # the preprocessing CLI, profiling and the legacy VideoAutoencoder
    by_path.update(run_preprocess_phases(pipe))
    for row in rows:
        row["launches_by_path"] = {
            path: counts[row["name"]] for path, counts in by_path.items()
            if counts.get(row["name"])}
        row["launches"] = sum(row["launches_by_path"].values())
        if not row["launches"]:
            fail(f"{row['name']} was launched on no driven path")
    emit({"kernels": [mark_event_times(row) for row in rows]})
    import torch.distributed as dist

    dist.destroy_process_group()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
