"""Open-loop serving: requests go to ``AvatarServer.submit`` on a Poisson
schedule at the mix's fixed rate, each with its own caption embeddings,
its own pose frames (a new host array) and an avatar's reference image
from a pool drawn by Zipf.

Latency runs from a request's due time to its future's result on the
host. After the window the requests still in flight are waited for, up to
``drain_s``; one that fails or never comes counts as missing. Then the
program is freed, and a sample of the window's requests, drawn from the
seed with the one of the most caption tokens in it, is generated again by
the plain reference from the same inputs and draws: each served video's
gap from it is held to the cell's limit. A request's decode-time noise
comes from its batch's generator (seeded with the batch leader's seed), so
the check takes each sampled request's batch from its result: the rows of
one batch are views of one host array.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from benchmark import common, traffic


class Traffic:
    """The mix's requests, from the seed: due times, caption lengths,
    avatars, per-request seeds and pose frames (indices into a pool of
    frames made once)."""

    def __init__(self, mix: dict, seed: int, seconds: float, caption_channels: int):
        self.mix, self.seed, self.cc = mix, seed, caption_channels
        self.due = traffic.poisson_schedule(seed, mix["rate_per_s"], seconds)
        n = len(self.due)
        self.kept = traffic.caption_lengths(seed, n, *mix["caption_kept"])
        self.avatar = traffic.zipf_choice(seed, n, mix["avatars"], mix["avatar_zipf"])
        self.seeds = traffic.request_seeds(seed, n)
        h, w, f = mix["height"], mix["width"], mix["frames"]
        g = traffic.rng(seed, "media")
        self.refs = [g.uniform(-1, 1, (1, 1, h, w, 3)).astype(np.float32)
                     for _ in range(mix["avatars"])]
        self.pose_pool = g.uniform(-1, 1, (mix["pose_pool_frames"], h, w, 3)).astype(np.float16)
        self.pose_idx = [traffic.rng(seed, "pose", i).integers(0, mix["pose_pool_frames"], f)
                         for i in range(n)]

    def arrays(self, i: int):
        """(embeds [1, L, C], mask [1, L], reference image, pose frames) of
        request ``i``, new host arrays (the reference image is its avatar's
        pool entry)."""
        length = self.mix["caption_tokens"]
        embeds = traffic.rng(self.seed, "embeds", i).standard_normal(
            (1, length, self.cc), dtype=np.float32)
        mask = np.zeros((1, length), np.float32)
        mask[0, :self.kept[i]] = 1.0
        pose = self.pose_pool[self.pose_idx[i]][None]
        return embeds, mask, self.refs[self.avatar[i]], pose


def _params(mix: dict, steps: int):
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams

    return GenerationParams(
        height=mix["height"], width=mix["width"], num_frames=mix["frames"] - 1,
        frame_rate=mix["frame_rate"], num_inference_steps=steps, guidance_scale=1.0,
        stg_scale=0.0, rescaling_scale=1.0, decode_timestep=mix["decode_timestep"],
        decode_noise_scale=mix["decode_noise_scale"])


def _batches(results: dict) -> dict:
    """Request id -> (leader id, row, batch size). The server hands each
    request its row of its batch's one host array, so the rows of one batch
    are views of one array, in submission order; a result that is no such
    view is refused."""
    out, groups = {}, {}
    for i in sorted(results):
        r = results[i]
        if r.base is None or r.base.ndim != r.ndim + 1:
            raise ValueError(f"request {i}'s result is not a row of its batch's array")
        groups.setdefault(id(r.base), (r.base, []))[1].append(i)
    for base, ids in groups.values():
        start = base.__array_interface__["data"][0]
        rows = {i: (results[i].__array_interface__["data"][0] - start) // base.strides[0]
                for i in ids}
        leader = next((i for i in ids if rows[i] == 0), None)
        out.update({i: (leader, int(rows[i]), base.shape[0]) for i in ids})
    return out


def run(ctx: common.Ctx) -> common.Record:
    import torch

    from avatar_tpu_torch.pipelines.serving import AvatarServer, GenerationRequest

    rec = common.Record(ctx)
    mix = ctx.mix
    common.build_kernels(ctx.device)
    pipe, dit, dcfg, vae, vcfg = common.make_pipeline(ctx)
    tr = Traffic(mix, ctx.seed, ctx.seconds, dcfg.caption_channels)
    params = _params(mix, mix["steps"])
    server = AvatarServer(pipe, **mix["server"])

    def request(i):
        embeds, mask, ref, pose = tr.arrays(i)
        return GenerationRequest(params, embeds, mask, ref_image=ref, pose_frames=pose,
                                 seed=tr.seeds[i], output_type=mix["output"])

    # warm-up: every batch size at a short walk, then one full walk, with
    # media the window does not use
    warm = Traffic(mix, ctx.seed + 1, ctx.seconds, dcfg.caption_channels)
    for size in range(1, mix["server"]["max_batch"] + 1):
        short = _params(mix, mix["warmup_steps"])
        futs = []
        for j in range(size):
            e, m, r, pz = warm.arrays(j)
            futs.append(server.submit(GenerationRequest(short, e, m, ref_image=r.copy(),
                                                        pose_frames=pz, seed=j,
                                                        output_type=mix["output"])))
        for f in futs:
            f.result()
    e, m, r, pz = warm.arrays(0)
    server.submit(GenerationRequest(params, e, m, ref_image=r.copy(), pose_frames=pz,
                                    output_type=mix["output"])).result()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    n = len(tr.due)
    # every request's arrays are made before the window: the sender only sends
    requests = [request(i) for i in range(n)]
    done_at = [math.nan] * n
    futs = [None] * n
    late = []
    batches0 = server.stats["batches"]
    tracer = None
    if ctx.trace:
        common.DeviceTrace.warm()
        rec.trace = common.DeviceTrace()

        def trace_window():
            # off the sender's thread: the profiler's start, its drain of the
            # device at the end and its collection take seconds
            time.sleep(max(0.0, t0 + ctx.seconds * mix["trace_from"] - time.perf_counter()))
            rec.trace.start(sync=False)
            time.sleep(mix["trace_seconds"])
            rec.trace.stop()

        tracer = threading.Thread(target=trace_window, daemon=True)

    t0 = time.perf_counter()
    rec.window_start = t0
    rec.setup_s = t0 - ctx.t_start
    if tracer is not None:
        tracer.start()
    for i in range(n):
        wait = t0 + tr.due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        now = time.perf_counter()
        late.append(now - (t0 + tr.due[i]))
        fut = server.submit(requests[i])
        fut.add_done_callback(lambda _, i=i: done_at.__setitem__(i, time.perf_counter()))
        futs[i] = fut
    deadline = t0 + ctx.seconds + mix["drain_s"]
    results = {}
    for i, fut in enumerate(futs):
        try:
            results[i] = fut.result(timeout=max(0.0, deadline - time.perf_counter()))
        except Exception as e:  # noqa: BLE001 - a failed request counts as missing
            common.log(f"request {i} failed: {type(e).__name__}: {e}")
    rec.attempted = n
    rec.failed = n - len(results)
    rec.latencies = [done_at[i] - (t0 + tr.due[i]) if i in results else math.inf
                     for i in range(n)]
    rec.counters["requests"] = n
    rec.counters["batches"] = server.stats["batches"] - batches0
    if tracer is not None:
        tracer.join()
        rec.trace.analyze()
    if ctx.device == "cuda":
        peak = torch.cuda.max_memory_allocated()
        rec.peak_mem_bytes = peak
        rec.memory_peak_bytes = max(rec.memory_peak_bytes, peak)
    common.log(f"requests {n} in {ctx.seconds} s, finished {len(results)}, batches "
               f"{rec.counters['batches']}, generator late p50 {np.median(late):.6f} s "
               f"max {max(late):.6f} s")
    server.shutdown()
    del requests
    if not results:
        rec.checks.append(("video_gap_levels", math.inf, ctx.limits["video_gap_levels"]))
        return rec

    # the check, after the program is freed
    batch_of = _batches(results)
    pick = traffic.rng(ctx.seed, "check")
    # a request whose batch leader failed has no known decode-time noise
    served = sorted(i for i in results if batch_of[i][0] is not None)
    longest = max(served, key=lambda i: tr.kept[i])
    others = [i for i in served if i != longest]
    sample = [longest] + list(pick.choice(others, size=min(len(others),
                                                          mix["check_requests"] - 1),
                                          replace=False))
    common.free_program(pipe, server)
    del pipe, server
    gaps = check(ctx, tr, dit, vae, {i: results[i] for i in sample},
                 {i: batch_of[i] for i in sample}, common.reference_precision(ctx.config))
    common.log("check gaps (request: levels) " + ", ".join(f"{i}: {g:.4f}"
                                                            for i, g in gaps.items()))
    rec.checks.append(("video_gap_levels", max(gaps.values()), ctx.limits["video_gap_levels"]))
    return rec


def reference_video(ctx, tr, i, dit, vae, batch, prec):
    """The plain reference's I420 video of request ``i``, served as row
    ``row`` of a batch of ``size`` led by request ``leader``."""
    import torch

    from benchmark.reference import ltxv

    leader, row, size = batch
    mix, dev = ctx.mix, ctx.device
    embeds, mask, ref, pose = tr.arrays(i)
    ts, ss = ltxv.vae_scales(ctx.config["vae"])
    c = ctx.config["vae"]["latent_channels"]
    lat = ((mix["frames"] - 1) // ts + 1, mix["height"] // ss, mix["width"] // ss, c)

    def media_latents(pixels):
        # the server encodes each host array once, with a generator seeded 0
        g = torch.Generator(device=dev).manual_seed(0)
        shape = (1, (pixels.shape[1] - 1) // ts + 1) + lat[1:]
        noise = torch.randn(shape, generator=g, device=dev, dtype=torch.float32)
        px = torch.from_numpy(pixels).to(dev).to(torch.bfloat16)
        return ltxv.vae_encode(vae, ctx.config["vae"], px, noise, prec)

    g = torch.Generator(device=dev).manual_seed(tr.seeds[i])
    init = torch.randn(lat, generator=g, device=dev, dtype=torch.float32)[None]
    g = torch.Generator(device=dev).manual_seed(tr.seeds[leader])
    dec = torch.randn((size,) + lat, generator=g, device=dev, dtype=torch.float32)[row:row + 1]
    with torch.no_grad():
        return ltxv.generate(
            dit, ctx.config["dit"], vae, ctx.config["vae"],
            embeds=torch.from_numpy(embeds).to(dev).to(torch.bfloat16),
            mask=torch.from_numpy(mask).to(dev),
            ref_lat=media_latents(ref), pose_lat=media_latents(pose), init_noise=init,
            decode_noise=dec, steps=mix["steps"], frame_rate=mix["frame_rate"],
            decode_timestep=mix["decode_timestep"],
            decode_noise_scale=mix["decode_noise_scale"], prec=prec)[0]


def check(ctx, tr, dit, vae, outputs: dict, batches: dict, prec) -> dict:
    """Request id -> the gap of its served video from the reference's."""
    import torch

    from benchmark.reference import ltxv

    ltxv.strict_f32()
    gaps = {}
    for i, out in outputs.items():
        ref = reference_video(ctx, tr, i, dit, vae, batches[i], prec)
        gaps[i] = ltxv.video_gap(torch.from_numpy(np.ascontiguousarray(out)), ref.cpu())
    return gaps
