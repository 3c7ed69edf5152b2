"""Where a bf16 run of the tiny guided pipeline leaves its f32 run.

    python3 -m avatar_tpu_torch.tools.bf16_error [--device cuda]

``chip_smoke.py`` holds tiny pipelines in bf16 on the card against f32 on
the CPU. This probe splits that error into its sources, on one device, with
plain attention only (``attention_impl="xla"``, no kernel). It prints one
JSON line per case (token count x settings):

- ``bf16``: the denoising walk in bf16 against the same walk in f32, as
  the relative RMS of the final latents;
- ``bf16_exact_t``: the bf16 walk with the AdaLN timestep tables computed
  in f32 (the walk otherwise scales ``t = sigma * 1000`` in bf16, as the
  JAX package does, which rounds t to a multiple of 4 above 512);
- ``f32_rounded_t``: the f32 walk with t rounded as the bf16 walk rounds
  it, everything else f32;
- ``f32_rounded_sigmas``: the f32 walk on sigmas rounded to bf16 (the step
  sizes of ``rf_step`` as the bf16 walk sees them, and t from them);
- ``t_f32`` / ``t_bf16``: the schedule's timesteps either way.

Then, for the largest case, one model evaluation at the schedule's second
level, bf16 against f32 on the same input: the relative RMS of the
residual stream after each block, of each cond's velocity and of the
guided combination, with rounded and with exact timestep tables.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from avatar_tpu_torch.models import dit as dit_mod
from avatar_tpu_torch.models.dit import DiTConfig, SkipLayerStrategy, init_dit
from avatar_tpu_torch.models.vae import demo_config
from avatar_tpu_torch.ops.rope import (
    get_latent_coords,
    latent_to_pixel_coords,
    precompute_freqs_cis,
)
from avatar_tpu_torch.pipelines import pipeline as pipeline_mod
from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline, combine_guidance

CAPTION, STEPS = 40, 3
GRIDS = {16: (4, 2, 2), 320: (5, 8, 8), 1280: (20, 8, 8)}
SETTINGS = {
    "guidance 1, euler": dict(guidance=1.0, stg=0.0, rescale=1.0, solver="euler"),
    "cfg 3 + stg 1 + rescale 0.7, heun": dict(guidance=3.0, stg=1.0, rescale=0.7,
                                              solver="heun"),
}


def rel_rms(a, b):
    a, b = a.float(), b.float()
    return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()


def tree_to(tree, dtype):
    if isinstance(tree, dict):
        return {k: tree_to(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dtype) for v in tree]
    return tree.to(dtype)


def bf16_round(x):
    return x.to(torch.bfloat16).float()


def rounded_t_sigmas(sigmas, mult):
    """f32 sigmas whose ``sigma * mult`` in f32 is what the bf16 walk
    computes for t (two roundings: of sigma, then of the product)."""
    return bf16_round(bf16_round(sigmas) * mult) / mult


class Case:
    """One tiny DiT, one set of inputs; the walk in a dtype with a choice of
    timestep tables and sigmas."""

    def __init__(self, cfg, params, grid, device, seed=4):
        self.cfg, self.params32, self.device = cfg, params, device
        self.params16 = tree_to(params, torch.bfloat16)
        g = torch.Generator(device=device).manual_seed(seed)
        f, h, w = grid
        n, ch = f * h * w, cfg.in_channels

        def randn(*shape):
            return torch.randn(shape, generator=g, device=device)

        self.tokens = randn(1, n, ch)
        self.ref, self.pose = randn(1, 1, h, w, ch), randn(1, f, h, w, ch)
        self.embeds = randn(2, CAPTION, cfg.caption_channels)
        self.keep = (torch.arange(CAPTION, device=device) < CAPTION - 10).float()[None]
        coords = latent_to_pixel_coords(
            get_latent_coords(f, h, w, 1, device=device), (8, 32, 32)).float()
        coords[:, 0] /= 25.0
        self.coords = coords
        self.samples_shape = (1, ch, f, h, w)

    def conds(self, s):
        """Stacked [negative | text | perturbed] embeds and masks."""
        parts = ([0] if s["guidance"] > 1 else []) + [1] + ([1] if s["stg"] > 0 else [])
        return (torch.cat([self.embeds[i:i + 1] for i in parts]),
                torch.cat([self.keep] * len(parts)), len(parts))

    def walk(self, s, dtype, tables="own", sigmas=None):
        """Final latents of the denoising walk. ``tables``: "own" (computed
        in ``dtype``), "f32" (computed in f32, cast to ``dtype``) or
        "rounded" (computed in ``dtype`` from t as bf16 rounds it)."""
        params = self.params32 if dtype == torch.float32 else self.params16
        pipe = LTXVideoPipeline(self.cfg, params, demo_config(), None,
                                attention_impl="xla", device=self.device)
        sched = pipe.schedule.set_timesteps(num_inference_steps=STEPS,
                                            samples_shape=self.samples_shape)
        if sigmas is None:
            sigmas = torch.tensor(sched.sigmas, dtype=torch.float32,
                                  device=self.device)
        embeds, mask, num_conds = self.conds(s)
        skip = None
        if s["stg"] > 0:
            skip = dit_mod.create_skip_layer_mask(
                self.cfg.num_layers, 1, num_conds, num_conds - 1, [1],
                device=self.device)
        original = pipeline_mod.precompute_timestep_tables
        mult = self.cfg.timestep_scale_multiplier

        def patched(p, cfg, timesteps, batch, dtype=dtype):
            if tables == "f32":
                return tuple(t.to(dtype) for t in original(
                    self.params32, cfg, timesteps.float(), batch, dtype=torch.float32))
            if tables == "rounded":
                timesteps = rounded_t_sigmas(timesteps.float(), mult)
            return original(p, cfg, timesteps, batch, dtype=dtype)

        pipeline_mod.precompute_timestep_tables = patched
        try:
            steps = np.full(STEPS, 1.0, np.float32)
            return sigmas, pipe.denoise(
                self.tokens.to(dtype), torch.cat([self.coords] * num_conds),
                embeds.to(dtype), mask, sigmas, self.ref.to(dtype),
                self.pose.to(dtype), guidance=steps * s["guidance"],
                stg=steps * s["stg"], rescale=steps * s["rescale"], skip_layer_mask=skip,
                skip_layer_strategy=SkipLayerStrategy.AttentionValues,
                solver=s["solver"])
        finally:
            pipeline_mod.precompute_timestep_tables = original

    def evaluation(self, s, dtype, sigma, exact_t):
        """One model evaluation at ``sigma`` on the walk's first input:
        the residual stream after each block, each cond's velocity and the
        guided combination (interleaved RoPE layout, plain attention)."""
        cfg = self.cfg
        params = self.params32 if dtype == torch.float32 else self.params16
        embeds, mask, num_conds = self.conds(s)
        x_in = dit_mod.avatar_condition_tokens(
            torch.cat([self.tokens] * num_conds), torch.cat([self.ref] * num_conds),
            torch.cat([self.pose] * num_conds)).to(dtype)
        freqs = precompute_freqs_cis(
            torch.cat([self.coords] * num_conds), cfg.inner_dim,
            theta=cfg.positional_embedding_theta,
            max_pos=cfg.positional_embedding_max_pos, out_dtype=dtype)
        level = torch.tensor([sigma], device=self.device)
        if exact_t:
            ada, emb = (t.to(dtype) for t in dit_mod.precompute_timestep_tables(
                self.params32, cfg, level, num_conds, dtype=torch.float32))
        else:
            ada, emb = dit_mod.precompute_timestep_tables(
                params, cfg, rounded_t_sigmas(level, cfg.timestep_scale_multiplier),
                num_conds, dtype=dtype)
        cross_kv, _ = dit_mod.precompute_cross_attention_kv(
            params, cfg, embeds.to(dtype), dtype=dtype)
        skip = dit_mod.create_skip_layer_mask(
            cfg.num_layers, 1, num_conds, num_conds - 1, [1], device=self.device)
        x = dit_mod.linear(params["patchify_proj"], x_in)
        stream = [x]
        for i, (block, kv) in enumerate(zip(params["blocks"], cross_kv)):
            x = dit_mod._block_apply(
                block, x, cfg, freqs, ada[0], kv, mask, skip[i],
                SkipLayerStrategy.AttentionValues, "xla", False)
            stream.append(x)
        velocity = dit_mod._dit_epilogue(params, x, emb[0]).to(dtype)
        one = torch.ones((), device=self.device, dtype=dtype)
        guided = combine_guidance(
            velocity.chunk(num_conds), True, True, one * s["guidance"],
            one * s["stg"], s["rescale"], False)
        return stream, velocity, guided


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    device = parser.parse_args(argv).device
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DiTConfig(num_attention_heads=2, attention_head_dim=64, in_channels=16,
                    out_channels=16, num_layers=2, cross_attention_dim=128,
                    caption_channels=64)
    params = init_dit(cfg, 2, device=device)
    f32, bf16 = torch.float32, torch.bfloat16
    case = None
    for tokens, grid in GRIDS.items():
        case = Case(cfg, params, grid, device)
        for label, s in SETTINGS.items():
            sigmas, ref = case.walk(s, f32)
            t32 = sigmas * cfg.timestep_scale_multiplier
            t16 = rounded_t_sigmas(sigmas, cfg.timestep_scale_multiplier) * (
                cfg.timestep_scale_multiplier)
            print(json.dumps({
                "tokens": tokens, "settings": label,
                "t_f32": t32.tolist(), "t_bf16": t16.tolist(),
                "bf16": rel_rms(case.walk(s, bf16)[1], ref),
                "bf16_exact_t": rel_rms(case.walk(s, bf16, tables="f32")[1], ref),
                "f32_rounded_t": rel_rms(case.walk(s, f32, tables="rounded")[1], ref),
                "f32_rounded_sigmas": rel_rms(
                    case.walk(s, f32, sigmas=bf16_round(sigmas))[1], ref),
            }), flush=True)

    s = SETTINGS["cfg 3 + stg 1 + rescale 0.7, heun"]
    sigma = case.walk(s, f32)[0][1].item()
    ref_stream, ref_v, ref_g = case.evaluation(s, f32, sigma, exact_t=True)
    for exact_t in (False, True):
        stream, v, g = case.evaluation(s, bf16, sigma, exact_t)
        print(json.dumps({
            "evaluation_at_sigma": sigma, "tokens": max(GRIDS), "exact_t": exact_t,
            "stream_after_patchify_and_each_block": [
                rel_rms(a, b) for a, b in zip(stream, ref_stream)],
            "velocity_per_cond": [rel_rms(a, b) for a, b in zip(v, ref_v)],
            "guided": rel_rms(g, ref_g),
            "guided_rms_over_text_rms": (
                ref_g.pow(2).mean().sqrt() / ref_v[1].pow(2).mean().sqrt()).item(),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
