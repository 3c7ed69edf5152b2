"""VAE-decoder fine-tuning (port of ``avatar_tpu/train/decoder.py``).

The decoder learns to absorb the last denoising step, as the
timestep-conditioned decoder is meant to at inference (the pipeline's
decode re-noises the latents to a small t and conditions the decoder on
it):

  t ~ Uniform(0, decoder_t_max)                   per sample
  x_t = (1 - t) * latent + t * noise              (rectified-flow noising)
  pred = vae_decode(x_t, timestep=t)              timestep-conditioned decode
  loss = l1_weight * L1(pred, pixels)

LPIPS is not computed (``decoder_loss_lpips_weight`` > 0 only warns, in
the CLI). Pixel targets are uint8 [F, H, W, 3] ``{stem}_pixels.npy`` files
beside the encoder latents. Random numbers come from a
``torch.Generator``; :func:`decoder_loss` and the step also take t and the
noise as tensors, so that both packages can be fed the same ones.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from avatar_tpu_torch.core.config import TrainConfig
from avatar_tpu_torch.diffusion.rf import add_noise
from avatar_tpu_torch.models.vae import VAEConfig, vae_decode
from avatar_tpu_torch.train.train import tree_leaves, tree_map, tree_unflatten


def _base_dtype(vae_params: dict) -> torch.dtype:
    return tree_leaves(vae_params["decoder"])[0].dtype


def init_decoder_trainable(vae_params: dict) -> dict:
    """An f32 copy of the decoder subtree (the only part trained)."""
    return tree_map(lambda x: x.detach().to(torch.float32, copy=True), vae_params["decoder"])


def decoder_loss(
    trainable: dict,
    vae_params: dict,
    vae_cfg: VAEConfig,
    cfg: TrainConfig,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    remat: bool = False,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 of the timestep-conditioned decode of re-noised latents against
    the pixels, and PSNR. ``batch``: "latents" [B, F, H, W, C] and uint8
    "pixels" [B, F', H', W', 3]. t [B] is drawn from ``generator`` as
    U(0, 1) times ``decoder_t_max`` unless ``t`` gives the U(0, 1) draw; the
    noise [B, F, H, W, C] likewise unless ``noise`` gives it."""
    base_dtype = _base_dtype(vae_params)
    params = dict(vae_params, decoder=tree_map(lambda x: x.to(base_dtype), trainable))
    latents = batch["latents"].float()
    pixels = batch["pixels"].float() / 127.5 - 1.0
    b, device = latents.shape[0], latents.device
    if t is None:
        t = torch.rand(b, generator=generator, device=device)
    t = t.to(device, torch.float32) * cfg.decoder_t_max
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=device)
    noisy = add_noise(latents, noise.to(device, torch.float32), t).to(base_dtype)

    decoded = vae_decode(
        params, vae_cfg, noisy, timestep=t if vae_cfg.timestep_conditioning else None,
        per_channel_normalize=True, remat=bool(remat)).float()
    l1 = torch.mean(torch.abs(decoded - pixels))
    loss = cfg.decoder_loss_l1_weight * l1
    metrics = {
        "loss": loss,
        "decoder_l1": l1,
        "decoder_psnr": -10.0 * torch.log10(torch.mean((decoded - pixels) ** 2) / 4.0 + 1e-12),
    }
    return loss, metrics


def make_decoder_train_step(vae_cfg: VAEConfig, cfg: TrainConfig, optimizer) -> Callable:
    """The step ``(trainable, opt_state, vae_params, batch, generator=None,
    t=None, noise=None) -> (trainable, opt_state, metrics)``: batch arrays
    [accum, micro_b, ...] as in the DiT step (``t`` [accum, micro_b] and
    ``noise`` [accum, micro_b, F, H, W, C] where given), gradients summed
    in f32 and divided by the number of micro-batches, metrics their
    means; ``cfg.gradient_checkpointing`` turns on the decoder's remat."""
    accum = cfg.gradient_accumulation_steps
    remat = cfg.gradient_checkpointing

    def step(trainable, opt_state, vae_params, batch, generator=None, t=None, noise=None):
        leaves = tree_leaves(trainable)
        sums = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
        per_micro = []
        for i in range(accum):
            with torch.enable_grad():
                live = [x.detach().requires_grad_() for x in leaves]
                loss, metrics = decoder_loss(
                    tree_unflatten(trainable, live), vae_params, vae_cfg, cfg,
                    {k: v[i] for k, v in batch.items()}, generator, remat,
                    t=None if t is None else t[i], noise=None if noise is None else noise[i])
                grads = torch.autograd.grad(loss, live)
            for acc, g in zip(sums, grads):
                acc += g.float()
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        if accum > 1:
            sums = [g / accum for g in sums]
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        trainable, opt_state = optimizer.update(
            tree_unflatten(trainable, sums), opt_state, trainable)
        return trainable, opt_state, metrics

    return step


def merge_decoder_trainable(vae_params: dict, trainable: dict) -> dict:
    """The VAE params with the trained decoder, cast back to the base
    dtype, in place of theirs (for export)."""
    base_dtype = _base_dtype(vae_params)
    return dict(vae_params, decoder=tree_map(lambda x: x.detach().to(base_dtype), trainable))
