"""A tiny LTX-Video-shaped configuration and tiny mixes, for driving whole
runs of the harness on the CPU (the program's plain versions stand in for
its CUDA kernels)."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

DIT = {"num_attention_heads": 2, "attention_head_dim": 64, "in_channels": 16, "out_channels": 16,
       "num_layers": 2, "cross_attention_dim": 128, "caption_channels": 32,
       "attention_bias": True, "activation_fn": "gelu-approximate",
       "norm_elementwise_affine": False, "norm_eps": 1e-6, "qk_norm": "rms_norm",
       "standardization_norm": "rms_norm", "adaptive_norm": "single_scale_shift",
       "positional_embedding_theta": 10000.0, "positional_embedding_max_pos": [20, 2048, 2048],
       "timestep_scale_multiplier": 1000}
VAE = {"latent_channels": 16, "encoder_base_channels": 16,
       "blocks": [["res_x", 1], ["compress_all", 1], ["res_x_y", 1], ["compress_all", 1],
                  ["res_x", 1]],
       "norm_layer": "pixel_norm", "patch_size": 2, "latent_log_var": "uniform",
       "use_quant_conv": False, "causal_decoder": False, "timestep_conditioning": True}
W8A8 = {"dit": "w8a8", "vae": "w8a8", "vae_min_weight_elements": 65536}


def config(w8a8: bool = False) -> dict:
    return {"name": "tiny-w8a8" if w8a8 else "tiny", "dtype": "float32", "dit": DIT,
            "vae": VAE, "quantize": W8A8 if w8a8 else None}


def mix(traffic: str) -> dict:
    m = json.loads((BENCH / "mixes" / f"{traffic}.json").read_text())
    m.update(frames=9, height=32, width=32, steps=3, caption_tokens=16, caption_kept=[4, 16],
             warmup_steps=1)
    if m["driver"] == "train":
        m.update(frames=9, height=16, width=24, latent_channels=16, micro_batch=2, pool=16,
                 check_steps=2)
        m["train"] = dict(m["train"], gradient_accumulation_steps=2, learning_rate=1e-3)
    if m["driver"] == "serve":
        m.update(rate_per_s=6.0, pose_pool_frames=8, drain_s=60, check_requests=3)
    return m


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


# the cell each tiny traffic stands in for, by configuration
CELLS = {("render-long", False): "ltxv2b.render-long",
         ("render-long", True): "ltxv2b-w8a8.render-long",
         ("serve-poisson", False): "ltxv2b.serve-poisson",
         # W8A8 serving has no cell of its own: its configuration's render limit
         ("serve-poisson", True): "ltxv2b-w8a8.render-long",
         ("train-full", False): "ltxv2b.train-full"}


def committed(traffic: str, w8a8: bool = False) -> dict:
    """The committed limits (``benchmark/limits/<cell>.json``) of the cell
    that ``traffic`` stands in for."""
    return json.loads((BENCH / "limits" / f"{CELLS[traffic, w8a8]}.json").read_text())


def run(traffic: str, seed: int, seconds: float = 1.5, w8a8: bool = False, mix_update=None,
        limits=None):
    """(record, metrics) of one CPU run of a tiny cell on ``traffic``, held
    to ``limits`` (by default the committed limits of the cell it stands in
    for)."""
    from benchmark import run as harness

    m = mix(traffic)
    m.update(mix_update or {})
    cell = {"name": f"tiny.{traffic}", "config": "tiny", "traffic": traffic, "chips": 1}
    return harness.run_cell(cell, copy.deepcopy(config(w8a8)), m,
                            limits or committed(traffic, w8a8), spec(), seed, seconds, False,
                            device="cpu")
