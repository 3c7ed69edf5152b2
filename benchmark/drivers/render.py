"""Closed-loop rendering: ``LTXVideoPipeline.__call__``, the call the
inference CLI makes, one long video after another, each with its own
caption, reference image, pose sequence and draws (all made on the device
from the seed), I420 out and copied to the host.

The rate is the frames of every video started in the window over the
time from the window's start to the end of the last of them. A traced run
passes ``stage_times`` (the pipeline's encode / denoise / decode spans,
each ending in a synchronize) and profiles one whole video. Afterwards the
program is freed and one video of the window, drawn from the seed, is
generated again by the plain reference from the same inputs and draws.
"""

from __future__ import annotations

import math
import time

from benchmark import common, traffic, work


def inputs(ctx: common.Ctx, v: int, caption_channels: int):
    """Video ``v``'s call inputs, on the device from the seed: caption
    embeddings and mask, reference image, pose frames, and the draws the
    pipeline would otherwise take from its generator."""
    import torch

    from benchmark.reference import ltxv

    mix, dev = ctx.mix, ctx.device
    h, w, f = mix["height"], mix["width"], mix["frames"]
    ts, ss = ltxv.vae_scales(ctx.config["vae"])
    c = ctx.config["vae"]["latent_channels"]
    lat = (1, (f - 1) // ts + 1, h // ss, w // ss, c)
    kept = int(traffic.caption_lengths(ctx.seed, 1024, *mix["caption_kept"])[v % 1024])
    avatar = int(traffic.zipf_choice(ctx.seed, 1024, mix["avatars"], mix["avatar_zipf"])[v % 1024])
    g = torch.Generator(device=dev).manual_seed(traffic.sub_seed(ctx.seed, "video", v))
    ga = torch.Generator(device=dev).manual_seed(traffic.sub_seed(ctx.seed, "avatar", avatar))
    bf = torch.bfloat16
    mask = torch.zeros(1, mix["caption_tokens"], device=dev)
    mask[0, :kept] = 1.0
    return dict(
        prompt_embeds=torch.randn(1, mix["caption_tokens"], caption_channels, generator=g,
                                  device=dev, dtype=bf),
        prompt_attention_mask=mask,
        ref_image=torch.rand(1, 1, h, w, 3, generator=ga, device=dev, dtype=bf) * 2 - 1,
        pose_frames=torch.rand(1, f, h, w, 3, generator=g, device=dev, dtype=bf) * 2 - 1,
        ref_noise=torch.randn((1, 1) + lat[2:], generator=g, device=dev),
        pose_noise=torch.randn(lat, generator=g, device=dev),
        init_noise=torch.randn(lat, generator=g, device=dev),
        decode_noise=torch.randn(lat, generator=g, device=dev),
    ), kept


def _params(mix, steps):
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams

    return GenerationParams(
        height=mix["height"], width=mix["width"], num_frames=mix["frames"] - 1,
        frame_rate=mix["frame_rate"], num_inference_steps=steps, guidance_scale=1.0,
        stg_scale=0.0, rescaling_scale=1.0, decode_timestep=mix["decode_timestep"],
        decode_noise_scale=mix["decode_noise_scale"])


def video_work(ctx, vae, kept, peaks) -> work.Work:
    """The model's work of one video: the DiT walk, the encodes of the
    reference image and the pose frames, and the decode."""
    from benchmark.reference import ltxv

    mix, q = ctx.mix, common.quantized(ctx.config)
    ts, ss = ltxv.vae_scales(ctx.config["vae"])
    c = ctx.config["vae"]["latent_channels"]
    lat = (1, (mix["frames"] - 1) // ts + 1, mix["height"] // ss, mix["width"] // ss, c)
    tokens = lat[1] * lat[2] * lat[3]
    dit = work.dit_video_work(ctx.config["dit"], 1, tokens, mix["caption_tokens"], kept,
                              mix["steps"], q.get("dit") == "w8a8", peaks)
    media = [(1, 1, mix["height"], mix["width"], 3),
             (1, mix["frames"], mix["height"], mix["width"], 3)]
    int8_min = q.get("vae_min_weight_elements") if q.get("vae") else None
    return dit.merged(work.vae_work(vae, ctx.config["vae"], media, lat, int8_min, peaks))


def run(ctx: common.Ctx) -> common.Record:
    import torch

    rec = common.Record(ctx)
    mix, dev = ctx.mix, ctx.device
    common.build_kernels(dev)
    pipe, dit, dcfg, vae, vcfg = common.make_pipeline(ctx)
    peaks = work.peaks_for(torch.cuda.get_device_name(0)) if dev == "cuda" else None

    def call(v, steps, stages=None):
        kw, kept = inputs(ctx, v, dcfg.caption_channels)
        gen = torch.Generator(device=dev).manual_seed(0)
        out = pipe(_params(mix, steps), gen, output_type=mix["output"], stage_times=stages,
                   **kw)
        return out.cpu(), kept

    call(-1, mix["warmup_steps"])
    call(-2, mix["steps"])
    if dev == "cuda":
        torch.cuda.synchronize()
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    if ctx.trace:
        common.DeviceTrace.warm()
    outs, kepts, spans = {}, [], []
    traced = mix.get("trace_video", 1)
    t0 = time.perf_counter()
    rec.window_start = t0
    rec.setup_s = t0 - ctx.t_start
    v = 0
    while time.perf_counter() < t0 + ctx.seconds:
        stages = {} if ctx.trace else None
        trace = common.DeviceTrace() if ctx.trace and v == traced else None
        if trace is not None:
            trace.start()
        try:
            start = time.perf_counter()
            outs[v], kept = call(v, mix["steps"], stages)
            kepts.append(kept)
            rec.done.append((time.perf_counter(), mix["frames"]))
            spans.append((start, rec.done[-1][0], v == traced and trace is not None))
        except Exception as e:  # noqa: BLE001 - counted as failed
            common.log(f"video {v} failed: {type(e).__name__}: {e}")
            rec.failed += 1
        if trace is not None:
            trace.stop()
            trace.analyze()
            rec.trace = trace
        if stages:
            for name, s in stages.items():
                rec.span(name, s)
        v += 1
    rec.attempted = v
    rec.units_end = time.perf_counter()
    if dev == "cuda":
        rec.peak_mem_bytes = torch.cuda.max_memory_allocated()
        rec.memory_peak_bytes = max(rec.memory_peak_bytes, rec.peak_mem_bytes)
    common.log(f"videos {v} in {rec.units_end - t0:.6f} s, failed {rec.failed}")
    if peaks is not None and kepts:
        per_video = [video_work(ctx, vae, k, peaks) for k in kepts]
        # the model's least time over the videos' own times, the profiled
        # video left out
        rec.counters["model_least_s"] = sum(
            w_.model_least_s(peaks) for w_, sp in zip(per_video, spans) if not sp[2])
        rec.counters["video_s"] = sum(sp[1] - sp[0] for sp in spans if not sp[2])
        if rec.trace is not None and traced < len(per_video):
            rec.work = per_video[traced]

    if not outs:
        rec.checks.append(("video_gap_levels", math.inf, ctx.limits["video_gap_levels"]))
        return rec
    pick = sorted(outs)[traffic.rng(ctx.seed, "check").integers(0, len(outs))]
    out = outs[pick]
    outs.clear()
    common.free_program(pipe)
    del pipe
    gap = check(ctx, pick, out, dit, vae, common.reference_precision(ctx.config))
    common.log(f"check video {pick}: gap {gap:.4f} levels")
    rec.checks.append(("video_gap_levels", gap, ctx.limits["video_gap_levels"]))
    return rec


def reference_video(ctx, v, dit, vae, prec):
    import torch

    from benchmark.reference import ltxv

    mix = ctx.mix
    kw, _ = inputs(ctx, v, ctx.config["dit"]["caption_channels"])
    with torch.no_grad():
        ref_lat = ltxv.vae_encode(vae, ctx.config["vae"], kw["ref_image"], kw["ref_noise"], prec)
        pose_lat = ltxv.vae_encode(vae, ctx.config["vae"], kw["pose_frames"], kw["pose_noise"],
                                   prec)
        return ltxv.generate(
            dit, ctx.config["dit"], vae, ctx.config["vae"], embeds=kw["prompt_embeds"],
            mask=kw["prompt_attention_mask"], ref_lat=ref_lat, pose_lat=pose_lat,
            init_noise=kw["init_noise"], decode_noise=kw["decode_noise"], steps=mix["steps"],
            frame_rate=mix["frame_rate"], decode_timestep=mix["decode_timestep"],
            decode_noise_scale=mix["decode_noise_scale"], prec=prec)[0]


def check(ctx, v, out, dit, vae, prec) -> float:
    from benchmark.reference import ltxv

    ltxv.strict_f32()
    ref = reference_video(ctx, v, dit, vae, prec)
    return ltxv.video_gap(out[0], ref.cpu())
