#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line as soon as it has its numbers:

1. card: name and power limit (``nvidia-smi``), TF32 settings;
2. build: compiles the CUDA kernels of ``avatar_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, in parallel);
3. kernel_*: each attention kernel at the 2B DiT's shapes (bf16) against
   its plain PyTorch version, bounded and unbounded, masked, with a fully
   masked row and a ragged key count; then its time, the plain version's,
   one PyTorch library call's (a yardstick the port never calls) and the
   card's lower bound for the same work;
4. reference: a tiny pipeline in bf16 on the card against the same
   pipeline in f32 on the CPU (plain kernel versions), same weights and
   noise;
5. pipeline: the full-width 2B DiT (28 layers, 32 x 64) and the 2B VAE
   with timestep conditioning, random weights from a seed, 97 frames at
   256 px, 40 Euler steps, guidance 1, STG 0, I420 output; checks shapes,
   finite latents, and that each kernel launched exactly 28 x 40 times;
6. profile: device time by kernel over 5 Euler steps (torch.profiler) and
   the device's idle share of an unprofiled step.

Then the kernel summary line, the ``nvidia-smi`` line, and as the last
line ``{"ok": true, "device": {...}}``. Any failed check exits non-zero
without that line. Needs one CUDA card; exits 1 without one.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

TOKENS, CAPTION, HEADS, HEAD_DIM = 832, 256, 32, 64
WIDTH = HEADS * HEAD_DIM
STEPS, LAYERS = 40, 28
# bf16 outputs of O(1): the kernel and its plain version round p and o to
# bf16 at the same places but sum in another order, and the online max
# (unbounded) rounds p relative to a running max; a few bf16 ulps of O(1)
KERNEL_TOL = 1e-2
# tiny pipeline, bf16 on the card vs f32 on the CPU, 3 steps
REFERENCE_TOL = 0.1
# dense bf16 tensor-core peak and memory rate, NVIDIA data sheets (SXM)
PEAKS = {"H200": (989e12, 4.8e12), "H100": (989e12, 3.35e12)}


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


def bound(flops: float, nbytes: float, peaks):
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def rms_rows(x):
    return x * (x.float().pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt().to(x.dtype)


def check_rope_kernel(peaks):
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.ops.rope import (
        get_latent_coords, latent_to_pixel_coords, precompute_freqs_cis, split_freqs,
    )

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    def inputs(length, grid):
        coords = latent_to_pixel_coords(
            get_latent_coords(*grid, 1, device="cuda"), (8, 32, 32))
        coords[:, 0] /= 25.0
        cos, sin = split_freqs(precompute_freqs_cis(coords, WIDTH,
                                                    out_dtype=torch.bfloat16))
        return (rms_rows(randn(1, length, WIDTH)), rms_rows(randn(1, length, WIDTH)),
                randn(1, length, WIDTH), cos, sin)

    q, k, v, cos, sin = inputs(TOKENS, (13, 8, 8))
    scale = HEAD_DIM**-0.5
    errs = {}
    for bounded in (True, False):
        out = fa.rope_fused_attention(q, k, v, cos, sin, HEADS, scale, bounded)
        ref = fa._rope_attention_plain(q, k, v, cos, sin, HEADS, scale, bounded)
        torch.cuda.synchronize()
        errs[f"bounded={bounded}"] = (out.float() - ref.float()).abs().max().item()
    # ragged length (not a multiple of the 64-row tile)
    rq, rk, rv, rc, rs = inputs(80, (5, 4, 4))
    out = fa.rope_fused_attention(rq, rk, rv, rc, rs, HEADS, scale, True)
    ref = fa._rope_attention_plain(rq, rk, rv, rc, rs, HEADS, scale, True)
    errs["ragged L=80"] = (out.float() - ref.float()).abs().max().item()
    err = max(errs.values())
    if not all(math.isfinite(e) for e in errs.values()) or err > KERNEL_TOL:
        fail(f"rope_fused_attention disagrees with its plain version: {errs}")

    def head_major(t):
        return fa._split_to_head_major(t, HEADS).reshape(1, TOKENS, HEADS, HEAD_DIM
                                                        ).transpose(1, 2)

    from avatar_tpu_torch.ops.rope import apply_rotary_emb_split

    qh = head_major(apply_rotary_emb_split(q, (cos, sin))).contiguous()
    kh = head_major(apply_rotary_emb_split(k, (cos, sin))).contiguous()
    vh = v.reshape(1, TOKENS, HEADS, HEAD_DIM).transpose(1, 2).contiguous()
    ms = time_ms(lambda: fa.rope_fused_attention(q, k, v, cos, sin, HEADS, scale, True))
    plain_ms = time_ms(lambda: fa._rope_attention_plain(
        q, k, v, cos, sin, HEADS, scale, True), reps=5, batches=3)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    flops = 4.0 * TOKENS * TOKENS * WIDTH
    nbytes = 4 * TOKENS * WIDTH * 2 + 2 * TOKENS * (WIDTH // 2) * 2
    bound_ms, bound_by = bound(flops, nbytes, peaks)
    row = {"name": "rope_fused_attention", "route": "cuda",
           "source": "avatar_tpu_torch/csrc/rope_attention.cu",
           "replaces": "avatar_tpu/ops/flash_attention.py:729",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    emit({"phase": "kernel_rope_fused_attention", "errors": errs, "tol": KERNEL_TOL,
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_us": bound_ms * 1e3, "bound_by": bound_by, "flops": flops,
          "bytes": nbytes})
    return row


def check_token_kernel(peaks):
    import torch
    import torch.nn.functional as F

    from avatar_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)

    q = rms_rows(randn(1, TOKENS, WIDTH))
    k, v = rms_rows(randn(1, CAPTION, WIDTH)), randn(1, CAPTION, WIDTH)
    mask = torch.ones(1, CAPTION, device="cuda")
    mask[0, 200:] = 0.0
    scale = HEAD_DIM**-0.5
    errs = {}
    for bounded in (True, False):
        for m in (None, mask):
            out = fa.fused_token_attention(q, k, v, m, HEADS, scale, bounded)
            ref = fa._token_attention_plain(q, k, v, m, HEADS, scale, bounded)
            torch.cuda.synchronize()
            key = f"bounded={bounded},mask={m is not None}"
            errs[key] = (out.float() - ref.float()).abs().max().item()
    # batch 2 with every key of sample 1 masked, ragged Lk = 77
    q2, k2, v2 = (rms_rows(randn(2, 96, WIDTH)), rms_rows(randn(2, 77, WIDTH)),
                  randn(2, 77, WIDTH))
    m2 = torch.ones(2, 77, device="cuda")
    m2[0, 50:] = 0.0
    m2[1] = 0.0
    for bounded in (True, False):
        out = fa.fused_token_attention(q2, k2, v2, m2, HEADS, scale, bounded)
        ref = fa._token_attention_plain(q2, k2, v2, m2, HEADS, scale, bounded)
        torch.cuda.synchronize()
        if not bool((out[1] == 0).all()):
            fail("fused_token_attention: a fully masked row is not 0")
        errs[f"ragged Lk=77, masked row, bounded={bounded}"] = (
            out.float() - ref.float()).abs().max().item()
    err = max(errs.values())
    if not all(math.isfinite(e) for e in errs.values()) or err > KERNEL_TOL:
        fail(f"fused_token_attention disagrees with its plain version: {errs}")

    def head_major(t):
        return t.reshape(1, -1, HEADS, HEAD_DIM).transpose(1, 2).contiguous()

    qh, kh, vh = head_major(q), head_major(k), head_major(v)
    keep = (mask > 0.5)[:, None, None, :]
    ms = time_ms(lambda: fa.fused_token_attention(q, k, v, mask, HEADS, scale, True))
    plain_ms = time_ms(lambda: fa._token_attention_plain(
        q, k, v, mask, HEADS, scale, True), reps=5, batches=3)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep))
    flops = 4.0 * TOKENS * CAPTION * WIDTH
    nbytes = 2 * TOKENS * WIDTH * 2 + 2 * CAPTION * WIDTH * 2 + CAPTION * 4
    bound_ms, bound_by = bound(flops, nbytes, peaks)
    row = {"name": "fused_token_attention", "route": "cuda",
           "source": "avatar_tpu_torch/csrc/token_attention.cu",
           "replaces": "avatar_tpu/ops/flash_attention.py:611",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    emit({"phase": "kernel_fused_token_attention", "errors": errs, "tol": KERNEL_TOL,
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_us": bound_ms * 1e3, "bound_by": bound_by, "flops": flops,
          "bytes": nbytes})
    return row


def _tree_to(tree, device, dtype):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device, dtype) for v in tree]
    return tree.to(device, dtype if tree.ndim else torch.float32)


def check_reference():
    """Tiny pipeline: bf16 on the card (CUDA kernels) vs f32 on the CPU
    (plain versions), same weights and noise."""
    import dataclasses

    import torch

    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.models.vae import demo_config, init_vae
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams, LTXVideoPipeline

    dcfg = DiTConfig(num_attention_heads=2, attention_head_dim=64, in_channels=16,
                     out_channels=16, num_layers=2, cross_attention_dim=128,
                     caption_channels=64)
    vcfg = dataclasses.replace(demo_config(latent_channels=16), base_channels=32,
                               decoder_base_channels=32)
    dit, vae = init_dit(dcfg, 2, device="cpu"), init_vae(vcfg, 3, device="cpu")
    g = torch.Generator().manual_seed(4)
    size, frames = 64, 17
    inputs = dict(
        prompt_embeds=torch.randn(1, 40, 64, generator=g),
        prompt_attention_mask=(torch.arange(40) < 30).float()[None],
        ref_image=torch.rand(1, 1, size, size, 3, generator=g) * 2 - 1,
        pose_frames=torch.rand(1, frames, size, size, 3, generator=g) * 2 - 1,
        ref_noise=torch.randn(1, 1, 2, 2, 16, generator=g),
        pose_noise=torch.randn(1, 3, 2, 2, 16, generator=g),
        init_noise=torch.randn(1, 3, 2, 2, 16, generator=g),
    )
    params = GenerationParams(height=size, width=size, num_frames=frames - 1,
                              num_inference_steps=3, guidance_scale=1.0,
                              stg_scale=0.0, rescaling_scale=1.0,
                              decode_timestep=0.05)
    outs = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        pipe = LTXVideoPipeline(dcfg, _tree_to(dit, device, dtype), vcfg,
                                _tree_to(vae, device, dtype), device=device)
        outs[device] = pipe(params, torch.Generator(device=device), **inputs,
                            output_type="latent", dtype=dtype).float().cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    if not math.isfinite(err) or err > REFERENCE_TOL:
        fail(f"tiny pipeline on the card disagrees with the CPU reference: {err}")
    emit({"phase": "reference", "latent_shape": list(outs["cuda"].shape),
          "max_abs_err": err, "tol": REFERENCE_TOL})


def run_pipeline():
    import torch

    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.models.vae import LTX_VAE_CONFIG, VAEConfig, init_vae
    from avatar_tpu_torch.ops import flash_attention as fa
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams, LTXVideoPipeline

    t0 = time.perf_counter()
    dcfg = DiTConfig()
    vcfg = VAEConfig.from_dict({**LTX_VAE_CONFIG, "timestep_conditioning": True})
    pipe = LTXVideoPipeline(
        dcfg, init_dit(dcfg, seed=1, device="cuda", dtype=torch.bfloat16), vcfg,
        init_vae(vcfg, seed=0, device="cuda", dtype=torch.bfloat16), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    size, frames = 256, 97
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
            num_inference_steps=steps, guidance_scale=1.0, stg_scale=0.0,
            rescaling_scale=1.0, decode_timestep=0.05)

    def run(steps, output_type, stage_times=None):
        return pipe(params(steps), torch.Generator(device="cuda").manual_seed(5),
                    embeds, mask, ref_image=ref, pose_frames=pose,
                    output_type=output_type, stage_times=stage_times)

    t0 = time.perf_counter()
    run(1, "yuv420")  # warm-up: cuBLAS/cuDNN handles and algorithm choice
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    stages = {}
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    out = run(STEPS, "yuv420", stages)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(fa.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    expect = (1, frames, size * 3 // 2, size)
    if out.dtype != torch.uint8 or tuple(out.shape) != expect:
        fail(f"pipeline output {out.dtype} {tuple(out.shape)}, expected uint8 {expect}")
    for name, n in launches.items():
        if n != LAYERS * STEPS:
            fail(f"{name} launched {n} times on the main path, expected "
                 f"{LAYERS * STEPS}")
    latents = run(STEPS, "latent")
    if tuple(latents.shape) != (1, 13, 8, 8, 128) or not bool(
            torch.isfinite(latents).all()):
        fail(f"latents not finite or of wrong shape {tuple(latents.shape)}")
    emit({"phase": "pipeline", "frames": frames, "size": size, "steps": STEPS,
          "init_s": init_s, "warmup_s": warm_s, **stages, "total_s": total_s,
          "frames_per_s": frames / total_s,
          "denoise_step_ms": stages["denoise_s"] / STEPS * 1e3,
          "max_memory_allocated_gib": peak_gib, "launches": launches,
          "latent_std": latents.float().std().item()})
    emit({"phase": "profile", **profile_denoise(
        pipe, params(STEPS), embeds, mask, ref, pose, stages["denoise_s"] / STEPS)})
    return launches


def profile_denoise(pipe, p, embeds, mask, ref, pose, step_s, steps=5):
    """Device time by kernel over the first ``steps`` Euler steps of the
    main path (torch.profiler), and the device's idle share of an
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
    tokens, coords = pipe.prepare_conditioning(
        pipe.prepare_latents(g, shape, torch.bfloat16))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card only",
              file=sys.stderr)
        return 1
    from avatar_tpu_torch.ops import kernel_build

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

    t0 = time.perf_counter()
    kernel_build.build_all()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in kernel_build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    rows = [check_rope_kernel(peaks), check_token_kernel(peaks)]
    check_reference()
    launches = run_pipeline()
    for row in rows:
        row["launches"] = launches[row["name"]]
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
