"""Training: LoRA / full fine-tuning of the avatar DiT (port of
``avatar_tpu/train/train.py``).

- :func:`make_train_step` gives one function per optimizer step: per
  micro-batch, log-normal timesteps with quantile clamping, rectified-flow
  noising and the velocity-MSE loss (:func:`velocity_loss`), the avatar
  ref/pose lerp and the LoRA deltas, then gradient accumulation as the mean
  of f32 gradient sums over the micro-batches, then the optimizer.
- Only the trainable subtree is differentiated (LoRA + caption_projection
  in "lora_audio" mode; the attention, AdaLN and output layers in "full"
  mode), so the frozen 2B weights get no gradient buffers.
- :func:`make_optimizer` is AdamW or Adafactor with optax's arithmetic,
  optional global-norm clipping before it and an EMA of the params after
  it, as the JAX package chains them.
- Batches with "audio_latents" (FaceFormer features) and "audio_mask"
  condition the DiT on them in place of the prompt.

Random numbers come from a ``torch.Generator``, which cannot give
``jax.random``'s draws; :func:`velocity_loss` and the step therefore also
take the timesteps and the noise as tensors, so that both packages can be
fed the same ones. One device, ``sharding_mode="dp"``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from avatar_tpu_torch.core.config import TrainConfig
from avatar_tpu_torch.diffusion.rf import add_noise, velocity_target
from avatar_tpu_torch.models.dit import DiTConfig, avatar_condition_tokens, dit_apply
from avatar_tpu_torch.models.patchifier import patchify
from avatar_tpu_torch.train.lora import init_lora, lora_scale

FULL_TRAINABLE_KEYS = (
    "proj_out",
    "scale_shift_table",
    "adaln_single",
    "caption_projection",
    "attn1",
    "attn2",
)


# ---------------------------------------------------------------------------
# Trees of tensors (nested dicts and lists)
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure with ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# Trainable-subtree partitioning
# ---------------------------------------------------------------------------


def split_full_trainable(params: dict, keys=FULL_TRAINABLE_KEYS) -> dict:
    """The trainable subtree of "full" mode: top-level proj_out,
    scale_shift_table, adaln_single and caption_projection, and every
    block's attn1, attn2 and scale_shift_table (a name filter over the
    reference's parameter names: not the feed-forward, not
    patchify_proj)."""
    top = {
        k: params[k]
        for k in ("proj_out", "scale_shift_table", "adaln_single",
                  "caption_projection")
        if k in params
    }
    top["blocks"] = [
        {k: block[k] for k in ("attn1", "attn2", "attn2_norm", "scale_shift_table")
         if k in block}
        for block in params["blocks"]
    ]
    return top


def overlay_params(params, trainable):
    """``params`` with the leaves of ``trainable`` put in their places."""
    if trainable is None:
        return params
    if isinstance(trainable, dict):
        out = dict(params)
        for k, v in trainable.items():
            out[k] = overlay_params(params.get(k), v) if isinstance(
                v, (dict, list)) else v
        return out
    if isinstance(trainable, list):
        return [overlay_params(p, t) for p, t in zip(params, trainable)]
    return trainable


# ---------------------------------------------------------------------------
# Timestep sampling
# ---------------------------------------------------------------------------


def sample_rf_timesteps(
    batch_size: int,
    mu: float,
    sigma: float,
    q_min: float,
    q_max: float,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> torch.Tensor:
    """LogNormal(mu, sigma) -> t = z / (1 + z), clamped to the batch's
    ``q_min`` and ``q_max`` quantiles (linear interpolation). f32 [B]."""
    n = torch.randn(batch_size, generator=generator, device=device)
    return clamp_rf_timesteps(n, mu, sigma, q_min, q_max)


def clamp_rf_timesteps(normal: torch.Tensor, mu: float, sigma: float,
                       q_min: float, q_max: float) -> torch.Tensor:
    """:func:`sample_rf_timesteps` from given standard-normal draws."""
    z = torch.exp(mu + sigma * normal.float())
    t = z / (1.0 + z)
    return torch.clamp(t, torch.quantile(t, q_min), torch.quantile(t, q_max))


def shift_timesteps_device(
    t: torch.Tensor,
    n_tokens: int,
    shifting: Optional[str],
    target_shift_terminal: Optional[float],
    base_resolution: int,
) -> torch.Tensor:
    """The resolution-dependent shift of the RF schedule, elementwise over
    the batch's t (the token count is fixed)."""
    if shifting == "SD3":
        m = (2.05 - 0.95) / (4096 - 1024)
        b = 0.95 - m * 1024
        mu = m * n_tokens + b
        shifted = math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0))
        if target_shift_terminal is not None:
            one_minus = 1.0 - shifted
            scale = one_minus[-1] / (1.0 - target_shift_terminal)
            shifted = 1.0 - one_minus / scale
        return shifted
    if shifting == "SimpleDiffusion":
        snr = (t / (1.0 - t)) ** 2
        shift_snr = torch.log(snr) + 2.0 * math.log(n_tokens / base_resolution)
        return torch.sigmoid(0.5 * shift_snr)
    return t


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _unported(pp_mesh, sp_mesh) -> None:
    if pp_mesh is not None or sp_mesh is not None:
        raise NotImplementedError("pipeline and sequence parallelism are not ported")


def velocity_loss(
    trainable: dict,
    dit_params: dict,
    dit_cfg: DiTConfig,
    cfg: TrainConfig,
    batch: Dict[str, torch.Tensor],
    prompt_embeds: torch.Tensor,
    prompt_mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    train_mode: str = "lora_audio",
    attention_impl: str = "auto",
    remat=False,
    rope_split: bool = False,
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    pp_mesh=None,
    sp_mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The velocity MSE of one micro-batch and its metrics.

    ``batch``: "latents" and "pose_latents" [B, F, H, W, C],
    "ref_image_latents" [B, 1, H, W, C], optionally "audio_latents"
    [B, T, D] with their keep-mask "audio_mask" [B, T], which replace the
    prompt (zero-padded to the caption width: the trainable
    caption_projection learns the map). The timesteps are drawn from
    ``generator`` (:func:`sample_rf_timesteps`) unless ``t`` [B] gives the
    draw, which is then shifted as a drawn one would be; the noise
    likewise unless ``noise`` [B, N, C] f32 gives it. ``rope_split``:
    ``dit_params`` are in the split-RoPE layout, and self-attention takes
    the RoPE-fused kernel (safe for "lora_audio": the permutation touches
    only frozen attn1 q/k)."""
    _unported(pp_mesh, sp_mesh)
    if train_mode == "lora_audio":
        lora = trainable["lora"]
        params = overlay_params(
            dit_params, {"caption_projection": trainable["caption_projection"]})
        scale = lora_scale(cfg.lora_rank, cfg.lora_alpha)
    else:
        lora = None
        params = overlay_params(dit_params, trainable)
        scale = 1.0

    model_dtype = dit_params["patchify_proj"]["weight"].dtype
    latents = batch["latents"].to(model_dtype)
    ref = batch["ref_image_latents"].to(model_dtype)
    pose = batch["pose_latents"].to(model_dtype)
    b = latents.shape[0]
    device = latents.device

    tokens, coords = patchify(latents)
    n_tokens = tokens.shape[1]
    if t is None:
        t = sample_rf_timesteps(
            b, cfg.rf_log_normal_mu or 0.0, cfg.rf_log_normal_sigma or 1.0,
            cfg.rf_quantile_min, cfg.rf_quantile_max, generator, device)
    t = shift_timesteps_device(
        t.to(device, torch.float32), n_tokens, cfg.rf_shifting,
        cfg.rf_target_shift_terminal, cfg.rf_base_resolution)

    tokens_f32 = tokens.float()
    if noise is None:
        noise = torch.randn(tokens.shape, generator=generator, device=device)
    noise = noise.to(device, torch.float32)
    noisy = add_noise(tokens_f32, noise, t).to(model_dtype)
    v_target = velocity_target(tokens_f32, noise, t)

    cond = avatar_condition_tokens(noisy, ref, pose)
    if "audio_latents" in batch:
        from avatar_tpu_torch.models.faceformer import audio_features_to_caption_embeds

        embeds = audio_features_to_caption_embeds(
            batch["audio_latents"], dit_cfg.caption_channels).to(model_dtype)
        mask = batch["audio_mask"]
    else:
        embeds = prompt_embeds.expand(b, *prompt_embeds.shape[1:]).to(model_dtype)
        mask = prompt_mask.expand(b, *prompt_mask.shape[1:])

    out = dit_apply(
        params, dit_cfg, cond, coords, t.to(model_dtype), embeds, mask,
        attention_impl=attention_impl, rope_split=rope_split, lora=lora,
        lora_scale=scale, remat=remat)

    out = out.float()
    std_target = torch.std(v_target, correction=1)
    mse = torch.mean((out - v_target) ** 2)
    loss = cfg.transformer_loss_weight * mse
    metrics = {
        "loss": loss,
        "transformer_mse": mse,
        "rel_mse": loss / (std_target**2 + 1e-12),
        "nrmse": torch.sqrt(loss) / (std_target + 1e-12),
    }
    return loss, metrics


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def make_lr_schedule(cfg: TrainConfig, total_steps: Optional[int] = None
                     ) -> Union[float, Callable[[int], float]]:
    """The learning rate as a float (constant, no warmup) or a function of
    the step: linear warmup, then constant, cosine or linear decay.
    ``total_steps`` (the CLI's num_epochs x steps per epoch) backs
    ``cfg.lr_total_steps``; a decay needs one of them."""
    base = cfg.learning_rate or 1e-4
    kind = (cfg.lr_schedule or "constant").lower()
    warmup = max(cfg.lr_warmup_steps, 0)
    total = cfg.lr_total_steps or total_steps or 0
    if kind == "constant" and warmup == 0:
        return base
    if kind not in ("constant", "cosine", "linear"):
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if kind != "constant" and total <= warmup:
        raise ValueError(
            f"lr_schedule={kind!r} needs lr_total_steps > lr_warmup_steps "
            f"(got total={total}, warmup={warmup})")
    decay_steps = max(total - warmup, 1)

    def schedule(step: int) -> float:
        warm = min(step / warmup, 1.0) if warmup else 1.0
        progress = min(max((step - warmup) / decay_steps, 0.0), 1.0)
        if kind == "cosine":
            factor = 0.5 * (1.0 + math.cos(math.pi * progress))
        elif kind == "linear":
            factor = 1.0 - progress
        else:
            factor = 1.0
        return base * warm * factor

    return schedule


class _Chain:
    """An optimizer as the JAX package chains it in optax: optional
    ``clip_by_global_norm``, then the optimizer's own update
    (:meth:`_apply`), then optionally ``ema_of_params``. The state is a
    dict of trees and step counts; :meth:`update` returns new trees and
    leaves its arguments as they are.

    - clipping: g_norm = sqrt(sum of every leaf's squares); below
      ``max_norm`` the gradients pass, else g / g_norm * max_norm;
    - the learning rate is lr(count) with the count before this step;
    - EMA: d = min(decay, (1 + n) / (10 + n)) at the n-th step,
      ema = d ema + (1 - d) p_new in f32, stored in ema's dtype.
    """

    def __init__(self, lr, max_grad_norm: float = 0.0, ema_decay: float = 0.0):
        self.lr, self.max_grad_norm, self.ema_decay = lr, max_grad_norm, ema_decay

    def init(self, params) -> Dict[str, Any]:
        state = {"count": 0, **self._init(params)}
        if self.ema_decay:
            state["ema"] = tree_map(lambda p: p.detach().clone(), params)
            state["ema_count"] = 0
        return state

    def learning_rate(self, step: int) -> float:
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads, state, params):
        """(new params, new state) after one step on ``grads``."""
        if self.max_grad_norm and self.max_grad_norm > 0:
            g_norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads)))
            clip = g_norm >= self.max_grad_norm
            grads = tree_map(
                lambda g: torch.where(clip, g / g_norm.to(g.dtype) * self.max_grad_norm, g),
                grads)
        params, state = self._apply(grads, state, params)
        if self.ema_decay:
            n = state["ema_count"] + 1
            # d and 1 - d as f32 values, as the JAX package forms them
            d = torch.minimum(torch.tensor(self.ema_decay, dtype=torch.float32),
                              torch.tensor(1.0 + n, dtype=torch.float32)
                              / torch.tensor(10.0 + n, dtype=torch.float32))
            d, one_minus = d.item(), (1.0 - d).item()
            state["ema"] = tree_map(
                lambda e, p: (d * e.float() + one_minus * p.float()).to(e.dtype),
                state["ema"], params)
            state["ema_count"] = n
        return params, state


class AdamW(_Chain):
    """``optax.adamw`` (``scale_by_adam``, ``add_decayed_weights``,
    ``scale_by_learning_rate``) inside :class:`_Chain`; state trees ``mu``
    and ``nu``.

    - moments: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu; with a
      bf16 ``mu_dtype`` the update reads the stored bf16 mu, b1 * mu is
      rounded to bf16 (a bf16 tensor times a scalar, as in JAX), and mu is
      rounded to bf16 after the bias-corrected mu_hat is taken;
    - update: mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p, times
      -lr(count), added to p in p's dtype.
    """

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                 mu_dtype: Optional[torch.dtype] = None, max_grad_norm: float = 0.0,
                 ema_decay: float = 0.0):
        super().__init__(lr, max_grad_norm, ema_decay)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.mu_dtype = weight_decay, mu_dtype

    def _init(self, params) -> Dict[str, Any]:
        return {
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype),
                           params),
            "nu": tree_map(torch.zeros_like, params),
        }

    def _apply(self, grads, state, params):
        count = state["count"] + 1
        bc1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** count
        bc2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** count
        step_size = -self.learning_rate(state["count"])
        new_mu, new_nu, new_params = [], [], []
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                              tree_leaves(state["nu"]), tree_leaves(params)):
            m = (1 - self.b1) * g + self.b1 * m
            v = (1 - self.b2) * g**2 + self.b2 * v
            u = (m / bc1.to(m.device, m.dtype)) / (
                torch.sqrt(v / bc2.to(v.device, v.dtype)) + self.eps)
            u = (u + self.weight_decay * p) * step_size
            new_params.append((p + u).to(p.dtype))
            new_mu.append(m.to(self.mu_dtype) if self.mu_dtype else m)
            new_nu.append(v)
        state = dict(state, count=count, mu=tree_unflatten(state["mu"], new_mu),
                     nu=tree_unflatten(state["nu"], new_nu))
        return tree_unflatten(params, new_params), state


# optax.adafactor's defaults (optax/_src/alias.py, factorized.py)
ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR = 128
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIPPING_THRESHOLD = 1.0
ADAFACTOR_MIN_PARAM_SCALE = 1e-3


class Adafactor(_Chain):
    """``optax.adafactor(lr)`` with optax's defaults inside :class:`_Chain`:
    ``scale_by_factored_rms`` (decay 1 - (count + 1)^-0.8, eps 1e-30 added
    to g^2, leaves with two axes of at least 128 factored), then
    ``clip_by_block_rms(1.0)``, the learning rate, ``scale_by_param_block_rms``
    (times max(rms(p), 1e-3)) and the sign; no momentum, no weight decay.
    State trees ``v_row``, ``v_col`` (factored leaves) and ``v`` (the
    others), each with a [1] placeholder where the leaf has no such
    moment, as in optax.

    A factored leaf's update is g * (v_row / mean(v_row))^-1/2 ⊗ v_col^-1/2,
    v_row the mean of g^2 over the larger axis d0 and v_col over the other,
    d1. optax picks the two axes by size on the JAX layout ([in, out],
    [kt, kh, kw, in, out]); the port's weights are in torch's layout
    ([out, in], [out, in, kt, kh, kw]), which reverses the order of in and
    out. :meth:`factored_dims` therefore breaks ties of size towards the
    lower axis, so that d0 and d1 are the same logical axes as in JAX, and
    the update is the transposed JAX update.
    """

    def factored_dims(self, shape) -> Optional[Tuple[int, int]]:
        """(d1, d0): the second largest and the largest axis, or None where
        the leaf is not factored (fewer than two axes, or the second
        largest below ``ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR``)."""
        if len(shape) < 2:
            return None
        order = sorted(range(len(shape)), key=lambda i: (shape[i], -i))
        if shape[order[-2]] < ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR:
            return None
        return order[-2], order[-1]

    def _init(self, params) -> Dict[str, Any]:
        def moments(p):
            dims = self.factored_dims(p.shape)
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            if dims is None:
                return one, one.clone(), torch.zeros_like(p)
            d1, d0 = dims
            row = [n for i, n in enumerate(p.shape) if i != d0]
            col = [n for i, n in enumerate(p.shape) if i != d1]
            return (torch.zeros(row, dtype=p.dtype, device=p.device),
                    torch.zeros(col, dtype=p.dtype, device=p.device), one)

        made = [moments(p) for p in tree_leaves(params)]
        return {name: tree_unflatten(params, [m[i] for m in made])
                for i, name in enumerate(("v_row", "v_col", "v"))}

    def _apply(self, grads, state, params):
        decay = 1.0 - torch.tensor(state["count"] + 1, dtype=torch.float32) ** (
            -ADAFACTOR_DECAY_RATE)
        keep = 1.0 - decay
        lr = self.learning_rate(state["count"])
        out = {"v_row": [], "v_col": [], "v": []}
        new_params = []
        for g, vr, vc, v, p in zip(tree_leaves(grads), tree_leaves(state["v_row"]),
                                   tree_leaves(state["v_col"]), tree_leaves(state["v"]),
                                   tree_leaves(params)):
            g2 = g * g + ADAFACTOR_EPS
            dims = self.factored_dims(p.shape)
            if dims is None:
                v = (decay * v + keep * g2).to(p.dtype)
                u = g * v**-0.5
            else:
                d1, d0 = dims
                vr = (decay * vr + keep * g2.mean(d0)).to(p.dtype)
                vc = (decay * vc + keep * g2.mean(d1)).to(p.dtype)
                row_factor = (vr / vr.mean(d1 - 1 if d1 > d0 else d1, keepdim=True))**-0.5
                u = g * row_factor.unsqueeze(d0) * (vc**-0.5).unsqueeze(d1)
            u = u / torch.clamp(torch.sqrt(torch.mean(u * u)) / ADAFACTOR_CLIPPING_THRESHOLD,
                                min=1.0)
            u = lr * u
            rms = torch.sqrt(torch.mean(p * p))
            u = u * torch.where(rms <= ADAFACTOR_MIN_PARAM_SCALE,
                                torch.full_like(rms, ADAFACTOR_MIN_PARAM_SCALE), rms)
            new_params.append((p + -1 * u).to(p.dtype))
            for name, x in (("v_row", vr), ("v_col", vc), ("v", v)):
                out[name].append(x)
        state = dict(state, count=state["count"] + 1,
                     **{k: tree_unflatten(state[k], x) for k, x in out.items()})
        return tree_unflatten(params, new_params), state


def make_optimizer(cfg: TrainConfig, total_steps: Optional[int] = None) -> _Chain:
    """``cfg.optimizer``: AdamW with torch's defaults (betas 0.9 / 0.999,
    eps 1e-8, weight decay 0.01) and ``cfg.optimizer_moment_dtype``, or
    Adafactor with optax's; both with the optional clipping, schedule and
    EMA of :class:`TrainConfig`."""
    if cfg.optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    if cfg.ema_decay and not 0.0 < cfg.ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in (0, 1): {cfg.ema_decay}")
    chain = dict(max_grad_norm=cfg.max_grad_norm or 0.0, ema_decay=cfg.ema_decay or 0.0)
    lr = make_lr_schedule(cfg, total_steps)
    if cfg.optimizer == "adafactor":
        return Adafactor(lr, **chain)
    mu_dtype = (torch.bfloat16 if cfg.optimizer_moment_dtype in ("bfloat16", "bf16")
                else None)
    return AdamW(lr, mu_dtype=mu_dtype, **chain)


def ema_params(opt_state):
    """The EMA of the trainable params, or None without ``ema_decay``."""
    return opt_state.get("ema")


def init_trainable(dit_params: dict, dit_cfg: DiTConfig, cfg: TrainConfig,
                   generator: Optional[torch.Generator] = None) -> dict:
    """f32 copies of the trainable leaves: the LoRA (from ``generator``)
    and caption_projection in "lora_audio" mode, the
    :func:`split_full_trainable` subtree in "full" mode."""
    def f32_copy(x):
        return x.detach().to(torch.float32, copy=True)

    if cfg.train_mode == "lora_audio":
        device = dit_params["patchify_proj"]["weight"].device
        return {
            "lora": init_lora(dit_cfg, cfg.lora_rank, generator, device=device),
            "caption_projection": tree_map(f32_copy, dit_params["caption_projection"]),
        }
    return tree_map(f32_copy, split_full_trainable(dit_params))


def _remat(cfg: TrainConfig):
    """False, "full" or "dots" (:func:`dit_apply`'s ``remat``)."""
    if not cfg.gradient_checkpointing:
        return False
    remat = cfg.remat_policy or "full"
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {remat!r}")
    return remat


def _micro(tree, i):
    return None if tree is None else tree[i]


def make_train_step(
    dit_cfg: DiTConfig,
    cfg: TrainConfig,
    optimizer: _Chain,
    attention_impl: str = "auto",
    rope_split: bool = False,
    pp_mesh=None,
    sp_mesh=None,
) -> Callable:
    """The step ``(trainable, opt_state, dit_params, batch, prompt_embeds,
    prompt_mask, generator=None, t=None, noise=None) -> (trainable,
    opt_state, metrics)``.

    ``batch`` arrays are [accum, micro_b, ...]; ``t`` [accum, micro_b] and
    ``noise`` [accum, micro_b, N, C], where given, replace the draws per
    micro-batch. The gradients are summed in f32 over the micro-batches and
    divided by their number; the metrics are their means."""
    accum = cfg.gradient_accumulation_steps
    remat = _remat(cfg)
    if pp_mesh is not None or sp_mesh is not None:
        raise NotImplementedError("pipeline and sequence parallelism are not ported")

    def step(trainable, opt_state, dit_params, batch, prompt_embeds, prompt_mask,
             generator=None, t=None, noise=None):
        leaves = tree_leaves(trainable)
        sums = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
        per_micro = []
        for i in range(accum):
            with torch.enable_grad():
                live = [x.detach().requires_grad_() for x in leaves]
                loss, metrics = velocity_loss(
                    tree_unflatten(trainable, live), dit_params, dit_cfg, cfg,
                    {k: v[i] for k, v in batch.items()}, prompt_embeds, prompt_mask,
                    generator, cfg.train_mode, attention_impl, remat, rope_split,
                    t=_micro(t, i), noise=_micro(noise, i))
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


def validate_step_fn(dit_cfg: DiTConfig, cfg: TrainConfig, attention_impl: str = "auto",
                     rope_split: bool = False, pp_mesh=None, sp_mesh=None) -> Callable:
    """``(trainable, dit_params, batch, prompt_embeds, prompt_mask,
    generator=None, t=None, noise=None) -> metrics``: the same noising and
    velocity MSE on one micro-batch, without gradients."""

    @torch.no_grad()
    def step(trainable, dit_params, batch, prompt_embeds, prompt_mask,
             generator=None, t=None, noise=None):
        _, metrics = velocity_loss(
            trainable, dit_params, dit_cfg, cfg, batch, prompt_embeds, prompt_mask,
            generator, cfg.train_mode, attention_impl, rope_split=rope_split,
            t=t, noise=noise, pp_mesh=pp_mesh, sp_mesh=sp_mesh)
        return metrics

    return step
