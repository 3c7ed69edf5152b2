"""The cases of the sharded train step's tests, on a gloo world of 2 CPU
processes (not a test module): the tiny DiT, the batch, the sharding
modes and the world's payload, shared by ``test_torch_parallel_train.py``
(against the port's one-device step) and ``test_torch_parallel_train_jax.py``
(against the JAX package's step sharded alike)."""

import jax
import numpy as np
import torch

from avatar_tpu.core.config import TrainConfig as JConfig
from avatar_tpu.models import dit as jdit
from avatar_tpu.train import lora as jlora
from avatar_tpu.train import train as jtrain
from avatar_tpu_torch.core.config import TrainConfig
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.train import train as ttrain
from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy, lora_from_numpy
from torch_parity import dit_numpy_params

WORLD = 2
DIT_KW = dict(num_attention_heads=2, attention_head_dim=16, in_channels=8, out_channels=8,
              num_layers=2, cross_attention_dim=32, caption_channels=24)
ACCUM, MICRO_B, F_, HW, LK, STEPS, SEED = 2, 2, 2, 4, 16, 2, 3

BASE = dict(checkpoint_path="x", lora_rank=4, lora_alpha=4, learning_rate=1e-3,
            gradient_accumulation_steps=ACCUM, rf_log_normal_mu=-0.5, rf_log_normal_sigma=1.0)
LORA = dict(train="lora", rope_split=True, impl="auto")
FULL = dict(train="full", rope_split=False, impl="auto")
CASES = {
    "dp_adamw": dict(mode="dp", opt="adamw", **LORA),
    "dp_adafactor": dict(mode="dp", opt="adafactor", **LORA),
    "zero2_adamw": dict(mode="zero2", opt="adamw", min_size=64, **LORA),
    "zero2_adafactor_clip": dict(mode="zero2", opt="adafactor", min_size=64, clip=True, **LORA),
    "fsdp_adamw_clip": dict(mode="fsdp", opt="adamw", min_size=64, clip=True, **LORA),
    "fsdp_adafactor": dict(mode="fsdp", opt="adafactor", min_size=64, **LORA),
    "zero2_full_adamw": dict(mode="zero2", opt="adamw", min_size=64, **FULL),
    "fsdp_full_adafactor": dict(mode="fsdp", opt="adafactor", min_size=64, **FULL),
    "sp_ulysses_adamw": dict(mode="sp", opt="adamw", sp_impl="ulysses", **LORA),
    "sp_ring_adafactor": dict(mode="sp", opt="adafactor", sp_impl="ring", **LORA),
    "pp_adamw": dict(mode="pp", opt="adamw", **LORA),
    "pp_adafactor_clip": dict(mode="pp", opt="adafactor", clip=True, **LORA),
}
# one case a mode held to the JAX step sharded alike ("dp" shards the batch as
# "zero2" does and the JAX step is the same function, so zero2's case covers
# it; the ring's attention and DiT are held to JAX's in
# test_torch_sequence_parallel.py)
JAX_CASES = ["zero2_adafactor_clip", "fsdp_adamw_clip", "sp_ulysses_adamw", "pp_adamw"]
N_TOKENS = F_ * HW * HW


def _cfg(case):
    kw = dict(BASE, optimizer=case["opt"], sharding_mode=case["mode"],
              train_mode="lora_audio" if case["train"] == "lora" else "full",
              sp_impl=case.get("sp_impl", "ulysses"))
    if case.get("clip"):
        kw["max_grad_norm"] = 1e-3
    return kw


def _batch(rng):
    def draw(*shape):
        return rng.standard_normal((ACCUM, MICRO_B) + shape).astype(np.float32)

    return {"latents": draw(F_, HW, HW, 8), "ref_image_latents": draw(1, HW, HW, 8),
            "pose_latents": draw(F_, HW, HW, 8)}


def _jax_draws(cfg, key):
    """Per step the whole batch's (t, noise) [ACCUM, MICRO_B, ...] as the
    JAX step draws them from ``key``."""
    ts, noises = [], []
    for i in range(ACCUM):
        k_t, k_noise = jax.random.split(jax.random.fold_in(key, i))
        ts.append(np.asarray(jtrain.sample_rf_timesteps(
            k_t, MICRO_B, cfg.rf_log_normal_mu, cfg.rf_log_normal_sigma,
            cfg.rf_quantile_min, cfg.rf_quantile_max)))
        noises.append(np.asarray(jax.random.normal(k_noise, (MICRO_B, N_TOKENS, 8))))
    return np.stack(ts), np.stack(noises)


def _jax_lora(rng):
    """A JAX-layout LoRA with nonzero b."""
    lora = jlora.init_lora(jax.random.PRNGKey(1), jdit.DiTConfig(**DIT_KW), 4)
    return jax.tree.map(lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32),
                        lora)


def _adafactor_leaves(rng):
    out = {}
    for shape, dim in (((256, 192), 0), ((256, 192), 1), ((130, 3, 256), 2)):
        p = rng.standard_normal(shape).astype(np.float32)
        grads = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
        out[f"{shape}_dim{dim}"] = (p, grads, dim)
    return out



def train_payload(jax_fed: bool = False) -> dict:
    """The world's payload. Without ``jax_fed``: every case of ``CASES``
    on the generator's draws, Adafactor's chunks and the FSDP control;
    with it: the ``JAX_CASES`` as "jax_<name>", fed per step the t and
    noise the JAX step draws from ``PRNGKey(10 + step)``, on a JAX-layout
    LoRA ("lora_jax")."""
    rng = np.random.default_rng(0)
    dcfg = tdit.DiTConfig(**DIT_KW)
    params = dit_params_from_numpy(dit_numpy_params(jdit.DiTConfig(**DIT_KW)), dcfg,
                                   device="cpu")
    lora_cfg = TrainConfig(**dict(BASE, train_mode="lora_audio"))
    lora = ttrain.init_trainable(params, dcfg, lora_cfg, torch.Generator().manual_seed(0))
    # nonzero b, so that the deltas move the output from the first step
    lora["lora"] = ttrain.tree_map(
        lambda x: 0.1 * torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)),
        lora["lora"])
    full = ttrain.init_trainable(params, dcfg, TrainConfig(**dict(BASE, train_mode="full")))
    embeds = rng.standard_normal((1, LK, 24)).astype(np.float32)
    mask = np.ones((1, LK), np.float32)
    mask[0, 12:] = 0.0
    payload = {"dit_cfg": DIT_KW, "params": params,
               "params_split": tdit.permute_dit_params_for_split_rope(params, dcfg),
               "batch": _batch(rng), "embeds": embeds, "mask": mask, "seed": SEED,
               "steps": STEPS}
    if not jax_fed:
        return dict(payload, trainable={"lora": lora, "full": full},
                    cases={n: dict(c, cfg=_cfg(c)) for n, c in CASES.items()},
                    adafactor=_adafactor_leaves(rng), fsdp_control="fsdp_adamw_clip")
    jax_lora = _jax_lora(np.random.default_rng(1))
    cases = {}
    for n in JAX_CASES:
        cfg = _cfg(CASES[n])
        cases["jax_" + n] = dict(CASES[n], cfg=cfg, train="lora_jax", fed=[
            _jax_draws(JConfig(**cfg), jax.random.PRNGKey(10 + s)) for s in range(STEPS)])
    return dict(payload, cases=cases, jax_lora=jax_lora, trainable={"lora_jax": {
        "lora": lora_from_numpy(jax_lora, device="cpu"),
        "caption_projection": payload["params_split"]["caption_projection"]}})
