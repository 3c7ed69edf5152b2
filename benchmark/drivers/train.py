"""Fine-tuning: the optimizer step of ``train.train.make_train_step`` as
the training CLI's loop calls it, fed by the program's own
``prefetch_batches`` from a seeded pool of distinct samples held on the
host (latents, pose latents and reference latents), one caption, and the
timesteps and noise drawn by the benchmark from the seed.

Set-up builds the step with its model and optimizer state and drives it
through its first ``check_steps`` optimizer steps, on rows that all
differ; the window then goes on with the same objects. The rate is the
micro-batch tokens of every optimizer step started in the window over the
time from the window's start to the end of the last of them (a host read
of its loss). Afterwards the program is freed and the plain reference
follows the first steps from the same weights, rows and draws: each
step's loss, the first gradient's norm per trained leaf (from the AdamW
state after one step) and the norm per leaf of the parameters' change are
compared.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark import common, traffic, weights, work


def t_draws(normal, mu: float, sigma: float, q_min: float, q_max: float):
    """Log-normal timesteps t = z / (1 + z), z = exp(mu + sigma n), clamped
    to each micro-batch's ``q_min`` and ``q_max`` quantiles."""
    import torch

    z = torch.exp(mu + sigma * normal.float())
    t = z / (1.0 + z)
    lo = torch.quantile(t, q_min, dim=-1, keepdim=True)
    hi = torch.quantile(t, q_max, dim=-1, keepdim=True)
    return torch.minimum(torch.maximum(t, lo), hi)


class Data:
    """The seeded pool, the caption, and each optimizer step's rows and
    draws."""

    def __init__(self, ctx: common.Ctx, caption_channels: int):
        from benchmark.reference.ltxv import vae_scales

        mix, self.ctx = ctx.mix, ctx
        ts, ss = vae_scales(ctx.config["vae"])
        self.f = (mix["frames"] - 1) // ts + 1
        self.h, self.w = mix["height"] // ss, mix["width"] // ss
        c, n = mix["latent_channels"], mix["pool"]
        g = traffic.rng(ctx.seed, "pool")
        shape = (n, self.f, self.h, self.w, c)
        self.pool = {"latents": g.standard_normal(shape, dtype=np.float32),
                     "pose_latents": g.standard_normal(shape, dtype=np.float32),
                     "ref_image_latents": g.standard_normal((n, 1, self.h, self.w, c),
                                                            dtype=np.float32)}
        cg = traffic.rng(ctx.seed, "caption")
        self.embeds = cg.standard_normal((1, mix["caption_tokens"], caption_channels),
                                         dtype=np.float32)
        self.kept = int(cg.integers(mix["caption_kept"][0], mix["caption_kept"][1] + 1))
        self.mask = np.zeros((1, mix["caption_tokens"]), np.float32)
        self.mask[0, :self.kept] = 1.0
        self.accum = mix["train"]["gradient_accumulation_steps"]
        self.micro = mix["micro_batch"]

    def rows(self, k: int) -> np.ndarray:
        """Pool rows of optimizer step ``k`` (1, 2, ...) [accum, micro]: the
        steps of one pass over the pool take disjoint rows."""
        per = self.accum * self.micro
        n = len(self.pool["latents"])
        passes = max(1, n // per)
        order = traffic.rng(self.ctx.seed, "order", (k - 1) // passes).permutation(n)
        i = (k - 1) % passes
        return order[i * per:(i + 1) * per].reshape(self.accum, self.micro)

    def batch(self, k: int) -> dict:
        r = self.rows(k)
        return {name: arr[r] for name, arr in self.pool.items()}

    def draws(self, k: int):
        """(t [accum, micro], noise [accum, micro, N, C]) on the device."""
        import torch

        tr = self.ctx.mix["train"]
        g = torch.Generator(device=self.ctx.device).manual_seed(
            traffic.sub_seed(self.ctx.seed, "draws", k))
        normal = torch.randn(self.accum, self.micro, generator=g, device=self.ctx.device)
        noise = torch.randn(self.accum, self.micro, self.f * self.h * self.w,
                            self.ctx.mix["latent_channels"], generator=g,
                            device=self.ctx.device)
        return t_draws(normal, tr["rf_log_normal_mu"], tr["rf_log_normal_sigma"],
                       tr["rf_quantile_min"], tr["rf_quantile_max"]), noise

    def tokens_per_step(self) -> int:
        return self.accum * self.micro * self.f * self.h * self.w


def run(ctx: common.Ctx) -> common.Record:
    import torch

    from avatar_tpu_torch.core.config import TrainConfig
    from avatar_tpu_torch.data.dataset import prefetch_batches
    from avatar_tpu_torch.train.train import (
        init_trainable, make_optimizer, make_train_step,
    )
    from benchmark.reference.train import named_leaves

    rec = common.Record(ctx)
    mix, dev = ctx.mix, ctx.device
    common.build_kernels(dev)
    dcfg, dit = weights.make_dit(ctx.config["dit"], ctx.seed, dev,
                                 getattr(torch, ctx.config["dtype"]))
    cfg = TrainConfig(**mix["train"])
    optimizer = make_optimizer(cfg)
    state = {"trainable": init_trainable(dit, dcfg, cfg)}
    state["opt"] = optimizer.init(state["trainable"])
    step_fn = make_train_step(dcfg, cfg, optimizer, rope_split=False)
    data = Data(ctx, dcfg.caption_channels)
    embeds = torch.from_numpy(data.embeds).to(dev)
    mask = torch.from_numpy(data.mask).to(dev)

    def host_batches():
        k = 0
        while True:
            k += 1
            yield data.batch(k)

    def to_device(v):
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    feed = prefetch_batches(host_batches(), device_put=to_device)
    steps_done = [0]

    def one_step() -> float:
        steps_done[0] += 1
        t, noise = data.draws(steps_done[0])
        state["trainable"], state["opt"], metrics = step_fn(
            state["trainable"], state["opt"], dit, next(feed), embeds, mask, None, t, noise)
        return float(metrics["loss"])

    # the first steps, which the reference follows
    p0 = {k: v.detach().cpu() for k, v in named_leaves(state["trainable"]).items()}
    losses, g1 = [], None
    b1 = mix["adamw"]["b1"]
    for _ in range(mix["check_steps"]):
        losses.append(one_step())
        if g1 is None:
            g1 = {k: float(v.float().norm()) / (1.0 - b1)
                  for k, v in named_leaves(state["opt"]["mu"]).items()}
    change = {k: float((v.detach().float() - p0[k].to(dev)).norm())
              for k, v in named_leaves(state["trainable"]).items()}
    del p0
    if dev == "cuda":
        torch.cuda.synchronize()
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if ctx.trace:
            common.DeviceTrace.warm()

    peaks = work.peaks_for(torch.cuda.get_device_name(0)) if dev == "cuda" else None
    per_step = work.dit_train_micro_work(
        ctx.config["dit"], data.micro, data.f * data.h * data.w, mix["caption_tokens"],
        data.kept * data.micro, True, peaks).scaled(data.accum)
    traced = mix.get("trace_step", 1)
    spans = []
    t0 = time.perf_counter()
    rec.window_start = t0
    rec.setup_s = t0 - ctx.t_start
    n = 0
    while time.perf_counter() < t0 + ctx.seconds:
        trace = common.DeviceTrace() if ctx.trace and n == traced else None
        if trace is not None:
            trace.start()
        start = time.perf_counter()
        try:
            loss = one_step()
            if not math.isfinite(loss):
                raise FloatingPointError(f"loss {loss}")
            rec.done.append((time.perf_counter(), data.tokens_per_step()))
            spans.append((start, rec.done[-1][0], trace is not None))
        except Exception as e:  # noqa: BLE001 - counted as failed
            common.log(f"step {steps_done[0]} failed: {type(e).__name__}: {e}")
            rec.failed += 1
        if trace is not None:
            trace.stop()
            trace.analyze()
            rec.trace = trace
            rec.work = per_step
        n += 1
    rec.attempted = n
    rec.units_end = time.perf_counter()
    if dev == "cuda":
        rec.peak_mem_bytes = torch.cuda.max_memory_allocated()
        rec.memory_peak_bytes = max(rec.memory_peak_bytes, rec.peak_mem_bytes)
    rec.counters["micro_steps"] = data.accum
    if peaks is not None:
        rec.counters["model_least_s"] = sum(per_step.model_least_s(peaks)
                                            for sp in spans if not sp[2])
        rec.counters["step_s"] = sum(sp[1] - sp[0] for sp in spans if not sp[2])
    common.log(f"optimizer steps {n} in {rec.units_end - t0:.6f} s, failed {rec.failed}, "
               f"first losses {losses}")

    del feed, step_fn, state
    common.free_program()
    checks(ctx, rec, data, dit, losses, g1, change)
    return rec


def checks(ctx, rec, data, dit, losses, g1, change) -> None:
    """The reference's first steps against the program's."""
    import torch

    from benchmark.reference import ltxv
    from benchmark.reference import train as ref

    mix, dev = ctx.mix, ctx.device
    ltxv.strict_f32()
    steps = []
    for k in range(1, len(losses) + 1):
        t, noise = data.draws(k)
        steps.append({"batch": {n: torch.from_numpy(v).to(dev) for n, v in data.batch(k).items()},
                      "t": t, "noise": noise})
    a = mix["adamw"]
    out = ref.train_steps(dit, ctx.config["dit"], steps, torch.from_numpy(data.embeds).to(dev),
                          torch.from_numpy(data.mask).to(dev), mix["trained"],
                          mix["train"]["learning_rate"], a["b1"], a["b2"], a["eps"],
                          a["weight_decay"], common.reference_precision(ctx.config),
                          getattr(torch, ctx.config["dtype"]), mix.get("reference_rows", 0))
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(losses, out["losses"]))
    grad_gap, grad_leaf = ref.worst_leaf_gap(g1, out["grad_norms"])
    median = sorted(out["grad_norms"].values())[len(out["grad_norms"]) // 2]
    moved = {k for k, v in out["grad_norms"].items() if v >= 1e-3 * median}
    update_gap, update_leaf = ref.worst_leaf_gap(change, out["change_norms"], moved)
    common.log(f"reference losses {out['losses']}; worst gradient leaf {grad_leaf}, "
               f"worst change leaf {update_leaf}; leaves left out of the change "
               f"{sorted(set(out['grad_norms']) - moved)}")
    lim = ctx.limits
    rec.checks += [("loss_gap", loss_gap, lim["loss_gap"]), ("grad_gap", grad_gap, lim["grad_gap"]),
                   ("update_gap", update_gap, lim["update_gap"])]
