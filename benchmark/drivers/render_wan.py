"""Closed-loop image-to-video on Wan2.1: ``WanI2VPipeline.__call__``, one
video after another, each with its own caption embeddings (umT5-XXL's
width, 512 rows of which the first 32-512 are caption and the rest zero),
and an avatar's reference image and CLIP tokens drawn Zipf from a pool, its
initial noise from the seed; the image is encoded with its zero frames on
every call, as published; I420 out and copied to the host.

The rate is the frames of every video started in the window over the time
from the window's start to the end of the last of them. A traced run
passes ``stage_times`` and profiles one whole video. Afterwards the
program is freed and one video of the window, drawn from the seed, is
generated again by the plain reference (``reference/wan.py``, f32) from
the same weights, inputs and draws: its I420 gap in 8-bit levels, and the
relative RMS gap of the timed call's denoised latents (kept on the host
beside its video), which sees the DiT without the VAE in front.

The program is imported inside :func:`run`, so that a checkout without the
Wan model fails at once.
"""

from __future__ import annotations

import math
import time

from benchmark import common, traffic, work, work_wan

# the checks of a run, each against the cell's limit of that name
CHECKS = ("video_gap_levels", "latent_gap")


def latent_shape(config: dict, mix: dict) -> tuple:
    z = config["vae"]["z_dim"]
    return (1, z, (mix["frames"] - 1) // 4 + 1, mix["height"] // 8, mix["width"] // 8)


def make_models(config: dict, seed: int, device: str):
    """(WanConfig, dit tree, WanVAEConfig, vae tree): the program's
    initializers at the published scales, drawn from ``seed``, in the
    configuration's dtype, published layout."""
    import torch

    from avatar_tpu_torch.models import wan, wan_vae

    dtype = getattr(torch, config["dtype"])
    cfg = wan.WanConfig.from_dict(config)
    vcfg = wan_vae.WanVAEConfig.from_dict(config["vae"])
    dit = wan.init_wan(cfg, traffic.sub_seed(seed, "dit"), device=device, dtype=dtype)
    vae = wan_vae.init_wan_vae(vcfg, traffic.sub_seed(seed, "vae"), device=device, dtype=dtype)
    return cfg, dit, vcfg, vae


def inputs(ctx: common.Ctx, v: int):
    """Video ``v``'s call inputs, on the device from the seed: the padded
    caption embeddings, the avatar's image and CLIP tokens, the initial
    noise; and the caption rows kept."""
    import torch

    mix, dev, config = ctx.mix, ctx.device, ctx.config
    kept = int(traffic.caption_lengths(ctx.seed, 1024, *mix["caption_kept"])[v % 1024])
    avatar = int(traffic.zipf_choice(ctx.seed, 1024, mix["avatars"], mix["avatar_zipf"])[v % 1024])
    g = torch.Generator(device=dev).manual_seed(traffic.sub_seed(ctx.seed, "video", v))
    ga = torch.Generator(device=dev).manual_seed(traffic.sub_seed(ctx.seed, "avatar", avatar))
    bf = torch.bfloat16
    text = torch.randn(1, mix["text_tokens"], config.get("text_dim", 4096), generator=g,
                       device=dev, dtype=bf)
    text[:, kept:] = 0
    return dict(
        text_embeds=text,
        image=torch.rand(1, 1, mix["height"], mix["width"], 3, generator=ga, device=dev,
                         dtype=bf) * 2 - 1,
        clip_embeds=torch.randn(1, mix["clip_tokens"], 1280, generator=ga, device=dev, dtype=bf),
        init_noise=torch.randn(latent_shape(config, mix), generator=g, device=dev),
    ), kept


def params_of(mix: dict, steps: int):
    from avatar_tpu_torch.pipelines.wan_i2v import WanGenerationParams

    return WanGenerationParams(height=mix["height"], width=mix["width"],
                               num_frames=mix["frames"], num_inference_steps=steps,
                               guidance_scale=mix["guidance"], shift=mix["shift"])


def run(ctx: common.Ctx) -> common.Record:
    import torch

    from avatar_tpu_torch.pipelines.wan_i2v import WanI2VPipeline

    rec = common.Record(ctx)
    mix, dev = ctx.mix, ctx.device
    common.build_kernels(dev)
    cfg, dit, vcfg, vae = make_models(ctx.config, ctx.seed, dev)
    pipe = WanI2VPipeline(cfg, dit, vcfg, vae, device=dev,
                          dtype=getattr(torch, ctx.config["dtype"]))
    peaks = work.peaks_for(torch.cuda.get_device_name(0)) if dev == "cuda" else None

    def call(v, steps, stages=None):
        kw, kept = inputs(ctx, v)
        out, lat = pipe(params_of(mix, steps), None, output_type=mix["output"],
                        stage_times=stages, return_latents=True, **kw)
        return (out.cpu(), lat.cpu()), kept

    call(-1, mix["warmup_steps"])
    call(-2, mix["steps"])
    if dev == "cuda":
        torch.cuda.synchronize()
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    if ctx.trace:
        common.DeviceTrace.warm()
    outs, spans = {}, []
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
            outs[v], _ = call(v, mix["steps"], stages)
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
    if peaks is not None and spans:
        per_video = work_wan.video_work(ctx.config, mix, vae, peaks)
        # the model's least time over the videos' own times, the profiled
        # video left out
        untraced = [sp for sp in spans if not sp[2]]
        rec.counters["model_least_s"] = len(untraced) * per_video.model_least_s(peaks)
        rec.counters["video_s"] = sum(sp[1] - sp[0] for sp in untraced)
        if rec.trace is not None:
            rec.work = per_video

    if not outs:
        rec.checks += [(name, math.inf, ctx.limits[name]) for name in CHECKS]
        return rec
    pick = sorted(outs)[traffic.rng(ctx.seed, "check").integers(0, len(outs))]
    out = outs[pick]
    outs.clear()
    common.free_program(pipe)
    del pipe
    gaps = check(ctx, pick, out, dit, vae)
    common.log(f"check video {pick}: gaps {gaps}")
    rec.checks += [(name, gaps[name], ctx.limits[name]) for name in CHECKS]
    return rec


def reference_video(ctx, v, dit, vae, prec):
    """Video ``v`` by the plain reference in ``prec``: (I420 [1, F, H 3/2,
    W], denoised latents [1, 16, F', h, w] f32)."""
    import torch

    from benchmark.reference import wan as ref

    mix = ctx.mix
    kw, _ = inputs(ctx, v)
    with torch.no_grad():
        return ref.generate(dit, ctx.config, vae, ctx.config["vae"], image=kw["image"],
                            text=kw["text_embeds"], clip=kw["clip_embeds"],
                            noise=kw["init_noise"], steps=mix["steps"], shift=mix["shift"],
                            guidance=mix["guidance"], prec=prec, return_latents=True)


def gaps_of(got, want) -> dict:
    """{check: gap} of a video and its latents (``got``) from the f32
    reference's (``want``)."""
    from benchmark.reference import wan as ref

    return {"video_gap_levels": ref.video_gap(got[0][0], want[0][0].cpu()),
            "latent_gap": ref.latent_gap(got[1].cpu(), want[1].cpu())}


def check(ctx, v, out, dit, vae) -> dict:
    from benchmark.reference import wan as ref

    ref.strict_f32()
    return gaps_of(out, reference_video(ctx, v, dit, vae, ref.Precision("f32")))
