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
fed the same ones.

Over a mesh (:class:`TrainSharding`, one process per device) every
sharding mode of the JAX package runs: "dp", "zero2" and "fsdp" over a
('data', 'fsdp') mesh, "sp" over ('data', 'sp'), "pp" over ('data',
'pp'). Each rank holds its rows of the batch; the t and noise draws are
made for the whole batch from the step's generator on every rank, and
each rank takes its rows, so the draws are those of the one-device step.
The loss every rank differentiates is its rows' loss divided by the ranks
that share its rows, and the gradients are summed over the ranks, so a
step equals the one-device step on the whole batch.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from avatar_tpu_torch.parallel.collectives import (
    AxisGroup,
    all_gather,
    all_gather_plain,
    chunk_of,
    psum_plain,
    reduce_scatter_plain,
)

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
    data_axis: Optional[AxisGroup] = None,
    gather_params=None,
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
    only frozen attn1 q/k).

    ``pp_mesh`` ("lora_audio" only; blocks and LoRA blocks stacked or
    this stage's) runs the DiT through ``dit_apply_pp``, ``sp_mesh``
    through ``dit_apply_sp`` (``cfg.sp_impl``); both without their data
    axis: ``batch`` holds this rank's rows. ``data_axis`` (the group of
    ranks whose rows make up the batch): the metrics are those of the
    whole batch; the returned loss stays this rank's rows' (the step
    scales it). ``gather_params``: FSDP's gather on use (``dit_apply``)."""
    if pp_mesh is not None and train_mode != "lora_audio":
        raise ValueError("sharding_mode=pp needs train_mode lora_audio")
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

    common = dict(attention_impl=attention_impl, rope_split=rope_split, lora=lora,
                  lora_scale=scale, remat=remat)
    if pp_mesh is not None:
        from avatar_tpu_torch.parallel.pipeline import dit_apply_pp

        out = dit_apply_pp(params, dit_cfg, cond, coords, t.to(model_dtype), embeds, mask,
                           mesh=pp_mesh, num_microbatches=cfg.pp_microbatches or None,
                           **common)
    elif sp_mesh is not None:
        from avatar_tpu_torch.parallel.sequence import dit_apply_sp

        out = dit_apply_sp(params, dit_cfg, cond, coords, t.to(model_dtype), embeds, mask,
                           mesh=sp_mesh, sp_impl=cfg.sp_impl, **common)
    else:
        out = dit_apply(params, dit_cfg, cond, coords, t.to(model_dtype), embeds, mask,
                        gather_params=gather_params, **common)

    out = out.float()
    mse = torch.mean((out - v_target) ** 2)
    loss = cfg.transformer_loss_weight * mse
    if data_axis is not None and data_axis.size > 1:
        return loss, _batch_metrics(out.detach(), v_target, cfg, data_axis)
    std_target = torch.std(v_target, correction=1)
    metrics = {
        "loss": loss,
        "transformer_mse": mse,
        "rel_mse": loss / (std_target**2 + 1e-12),
        "nrmse": torch.sqrt(loss) / (std_target + 1e-12),
    }
    return loss, metrics


def _batch_metrics(out, v_target, cfg: TrainConfig, data_axis: AxisGroup) -> Dict:
    """The metrics of the whole batch from its ranks' rows: the squared
    error and the target's moments summed (f64) over ``data_axis``."""
    diff = out.double() - v_target.double()
    v = v_target.double()
    sums = psum_plain(torch.stack([(diff * diff).sum(), v.sum(), (v * v).sum()]), data_axis)
    n = v.numel() * data_axis.size
    mse = (sums[0] / n).float()
    var = ((sums[2] - sums[1] ** 2 / n) / (n - 1)).float()
    std_target = torch.sqrt(var)
    loss = cfg.transformer_loss_weight * mse
    return {"loss": loss, "transformer_mse": mse,
            "rel_mse": loss / (std_target**2 + 1e-12),
            "nrmse": torch.sqrt(loss) / (std_target + 1e-12)}


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

    Over a mesh the trees hold this rank's shards (:class:`TrainSharding`):
    ``shard`` gives, per leaf in :func:`tree_leaves` order, None or a
    :class:`LeafShard`, and the clipping norm sums the shards' squares
    over their groups.
    """

    def __init__(self, lr, max_grad_norm: float = 0.0, ema_decay: float = 0.0):
        self.lr, self.max_grad_norm, self.ema_decay = lr, max_grad_norm, ema_decay

    def init(self, params, shard=None) -> Dict[str, Any]:
        state = {"count": 0, **self._init(params, shard)}
        if self.ema_decay:
            state["ema"] = tree_map(lambda p: p.detach().clone(), params)
            state["ema_count"] = 0
        return state

    def learning_rate(self, step: int) -> float:
        return self.lr(step) if callable(self.lr) else self.lr

    def update(self, grads, state, params, shard=None):
        """(new params, new state) after one step on ``grads``."""
        if self.max_grad_norm and self.max_grad_norm > 0:
            squares = [torch.sum(g.float() ** 2) for g in tree_leaves(grads)]
            if shard is not None:
                squares = [sq if sh is None else sh.sum(sq) for sq, sh in zip(squares, shard)]
            g_norm = torch.sqrt(sum(squares))
            clip = g_norm >= self.max_grad_norm
            grads = tree_map(
                lambda g: torch.where(clip, g / g_norm.to(g.dtype) * self.max_grad_norm, g),
                grads)
        params, state = self._apply(grads, state, params, shard)
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

    def _init(self, params, shard=None) -> Dict[str, Any]:
        return {
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype),
                           params),
            "nu": tree_map(torch.zeros_like, params),
        }

    def _apply(self, grads, state, params, shard=None):
        # elementwise: a shard updates alone
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

    A sharded leaf (:class:`LeafShard`) takes its means over whole rows and
    columns, and its block RMS, from sums all-reduced over its group; its
    moments are the shards of the whole leaf's (a moment whose reduced
    axis is the sharded one is whole on every rank).
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

    def _init(self, params, shard=None) -> Dict[str, Any]:
        shard = shard or [None] * len(tree_leaves(params))

        def moments(p, sh):
            dims = self.factored_dims(p.shape if sh is None else sh.full_shape)
            one = torch.zeros(1, dtype=p.dtype, device=p.device)
            if dims is None:
                return one, one.clone(), torch.zeros_like(p)
            d1, d0 = dims
            row = [n for i, n in enumerate(p.shape) if i != d0]
            col = [n for i, n in enumerate(p.shape) if i != d1]
            return (torch.zeros(row, dtype=p.dtype, device=p.device),
                    torch.zeros(col, dtype=p.dtype, device=p.device), one)

        made = [moments(p, sh) for p, sh in zip(tree_leaves(params), shard)]
        return {name: tree_unflatten(params, [m[i] for m in made])
                for i, name in enumerate(("v_row", "v_col", "v"))}

    def _apply(self, grads, state, params, shard=None):
        decay = 1.0 - torch.tensor(state["count"] + 1, dtype=torch.float32) ** (
            -ADAFACTOR_DECAY_RATE)
        keep = 1.0 - decay
        lr = self.learning_rate(state["count"])
        out = {"v_row": [], "v_col": [], "v": []}
        new_params = []
        shard = shard or [None] * len(tree_leaves(params))
        for g, vr, vc, v, p, sh in zip(tree_leaves(grads), tree_leaves(state["v_row"]),
                                       tree_leaves(state["v_col"]), tree_leaves(state["v"]),
                                       tree_leaves(params), shard):
            g2 = g * g + ADAFACTOR_EPS
            dims = self.factored_dims(p.shape if sh is None else sh.full_shape)

            def mean(x, dim, along, keepdim=False):
                """x's mean over ``dim``, which is the leaf's axis ``along``."""
                if sh is None or sh.dim != along:
                    return x.mean(dim, keepdim=keepdim)
                return sh.sum(x.sum(dim, keepdim=keepdim)) / sh.full_shape[along]

            def whole_mean(x):
                if sh is None or sh.dim is None:
                    return torch.mean(x)
                return sh.sum(x.sum()) / sh.numel

            if dims is None:
                v = (decay * v + keep * g2).to(p.dtype)
                u = g * v**-0.5
            else:
                d1, d0 = dims
                vr = (decay * vr + keep * mean(g2, d0, d0)).to(p.dtype)
                vc = (decay * vc + keep * mean(g2, d1, d1)).to(p.dtype)
                row_factor = (vr / mean(vr, d1 - 1 if d1 > d0 else d1, d1, keepdim=True))**-0.5
                u = g * row_factor.unsqueeze(d0) * (vc**-0.5).unsqueeze(d1)
            u = u / torch.clamp(torch.sqrt(whole_mean(u * u)) / ADAFACTOR_CLIPPING_THRESHOLD,
                                min=1.0)
            u = lr * u
            rms = torch.sqrt(whole_mean(p * p))
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


class LeafShard:
    """A trainable leaf as this rank holds it: its chunk along ``dim`` of a
    whole leaf of ``full_shape`` split over ``group`` (ZeRO), or with
    ``dim`` None a whole leaf that only this rank of ``group`` holds (a
    pipeline stage's LoRA blocks). :meth:`sum` adds a partial sum over
    the group."""

    def __init__(self, dim: Optional[int], full_shape, group: AxisGroup):
        self.dim, self.full_shape, self.group = dim, tuple(full_shape), group

    @property
    def numel(self) -> int:
        return math.prod(self.full_shape)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return psum_plain(x, self.group)


class FsdpGather:
    """FSDP's gather on use: ``gather_params`` of ``dit_apply``. Called on a
    subtree and its path (``()``, ``("blocks", i)``, ``("lora", i)``), it
    returns the subtree's full tensors: the frozen chunks all-gathered
    plainly, the trainable ones through the differentiable gather (its
    backward reduce-scatters).

    Entered around the forward, it keeps autograd from holding the full
    tensors until the backward: a tensor that autograd saves and that
    views a gathered buffer is saved as its chunk and gathered again when
    the backward needs it (``saved_tensors_hooks``), so a block's gathered
    weights are freed when the block has run, with or without remat. Every
    rank's backward runs the same nodes in the same order, so the gathers
    it adds line up across the ranks."""

    def __init__(self, group: AxisGroup, dims, lora_dims):
        self.group, self.dims, self.lora_dims = group, dims, lora_dims
        # storage address of each gathered tensor still alive -> (chunk, dim)
        self._buffers: Dict[int, Tuple[torch.Tensor, int]] = {}
        self._saving = None

    def _gather_leaf(self, chunk: torch.Tensor, dim: int) -> torch.Tensor:
        full = (all_gather(chunk, self.group, dim) if chunk.requires_grad
                else all_gather_plain(chunk, self.group, dim))
        key = full.untyped_storage().data_ptr()
        if full.numel() and key != chunk.untyped_storage().data_ptr():
            self._buffers[key] = (chunk.detach(), dim)
            weakref.finalize(full, self._buffers.pop, key, None)
        return full

    def _gather_tree(self, tree, spec):
        if isinstance(tree, dict):
            return {k: self._gather_tree(v, spec.get(k) if isinstance(spec, dict) else None)
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self._gather_tree(v, spec[i]) for i, v in enumerate(tree)]
        if spec is None or not torch.is_tensor(tree):
            return tree
        return self._gather_leaf(tree, spec)

    def __call__(self, tree, path):
        if path == ():
            return self._gather_tree(tree, self.dims)
        if path[0] == "blocks":
            return self._gather_tree(tree, self.dims["blocks"][path[1]])
        return self._gather_tree(tree, self.lora_dims["blocks"][path[1]])

    def _pack(self, t: torch.Tensor):
        entry = self._buffers.get(t.untyped_storage().data_ptr())
        if entry is None or entry[0].dtype != t.dtype:
            return t
        chunk, dim = entry
        return (chunk, dim, tuple(t.shape), t.stride(), t.storage_offset())

    def _unpack(self, packed):
        if torch.is_tensor(packed):
            return packed
        chunk, dim, shape, stride, offset = packed
        return all_gather_plain(chunk, self.group, dim).as_strided(shape, stride, offset)

    def __enter__(self):
        self._saving = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
        self._saving.__enter__()
        return self

    def __exit__(self, *exc):
        saving, self._saving = self._saving, None
        return saving.__exit__(*exc)


class TrainSharding:
    """Where a train step's batch and trees lie over ``mesh`` in ``mode``
    (``TrainConfig.sharding_mode``), one process per device:

    - "dp", "zero2", "fsdp": a ('data', 'fsdp'[, 'tp']) mesh (``make_mesh``);
      the batch's rows shard over data x fsdp. "zero2" shards the
      optimizer state of every trainable leaf that the reference's rule
      shards (``parallel/mesh.py:opt_state_sharding``; ``min_size``): the
      gradients are reduce-scattered, each rank updates its chunk and the
      chunks are all-gathered. "fsdp" keeps those leaves, and the frozen
      params' (``param_sharding``), as chunks, gathered on use block by
      block, the gather's backward reduce-scattering the gradient; a
      block's gathered weights are freed after it and gathered again for
      its backward (:class:`FsdpGather`).
    - "sp": a ('data', 'sp') mesh; rows over data, tokens over sp
      (``dit_apply_sp``); everything replicated.
    - "pp": a ('data', 'pp') mesh, "lora_audio" only; rows over data; each
      stage holds its L/S blocks (stacked) and LoRA blocks (a list).

    Every rank differentiates its rows' loss over ``loss_divisor`` (the
    ranks that share the loss: the batch shards times the sp or pp
    ranks, which all hold the whole output) and the gradients are summed
    over the ranks that hold the same leaf.
    """

    def __init__(self, mesh, mode: str, min_size: Optional[int] = None):
        from avatar_tpu_torch.parallel.mesh import MIN_SHARD_SIZE

        if mode not in ("dp", "zero2", "fsdp", "sp", "pp"):
            raise ValueError(f"unknown sharding_mode {mode!r}")
        self.mesh, self.mode = mesh, mode
        self.min_size = MIN_SHARD_SIZE if min_size is None else min_size
        if mode in ("dp", "zero2", "fsdp"):
            self.batch_axes = tuple(a for a in ("data", "fsdp") if a in mesh.shape)
            self.shared_axis = None
        else:
            self.shared_axis = mode
            if mode not in mesh.shape:
                raise ValueError(f"sharding_mode={mode!r} needs a mesh with a {mode!r} axis")
            self.batch_axes = ("data",) if "data" in mesh.shape else ()
        self.batch_group = mesh.group(self.batch_axes)
        self.everyone = mesh.group(mesh.axis_names)
        self.loss_divisor = self.batch_group.size * (
            mesh.size(self.shared_axis) if self.shared_axis else 1)
        self.frozen_dims = None
        self.trainable_dims = None
        self.full_shapes = None

    @property
    def pp_mesh(self):
        return self.mesh if self.mode == "pp" else None

    @property
    def sp_mesh(self):
        return self.mesh if self.mode == "sp" else None

    def place(self, dit_params: dict, trainable: dict):
        """(dit_params, trainable) as this rank holds them, from the whole
        trees (the same on every rank)."""
        from avatar_tpu_torch.parallel.mesh import (
            map_with_path, opt_state_sharding, param_sharding, shard_pytree)
        from avatar_tpu_torch.parallel.pipeline import stack_block_params

        mesh = self.mesh
        self.full_shapes = [tuple(x.shape) for x in tree_leaves(trainable)]
        if self.mode in ("zero2", "fsdp"):
            self.trainable_dims = opt_state_sharding(mesh, trainable, mode=self.mode,
                                                     min_size=self.min_size)
        if self.mode == "fsdp":
            self.frozen_dims = param_sharding(mesh, dit_params, "fsdp", self.min_size)
            dit_params = shard_pytree(dit_params, self.frozen_dims, mesh)
            trainable = shard_pytree(trainable, self.trainable_dims, mesh)
        elif self.mode == "pp":
            pg = mesh.group("pp")
            blocks = dit_params["blocks"]
            if isinstance(blocks, (list, tuple)):
                blocks = stack_block_params(blocks)
            dit_params = dict(dit_params, blocks=map_with_path(
                lambda p, x: chunk_of(x, pg, 0).contiguous(), blocks))
            lora_blocks = list(trainable["lora"]["blocks"])
            per = len(lora_blocks) // pg.size
            trainable = dict(trainable, lora=dict(
                trainable["lora"], blocks=lora_blocks[pg.index * per:(pg.index + 1) * per]))
        return dit_params, trainable

    def _leaf_dims(self, trainable) -> List[Optional[int]]:
        if self.trainable_dims is None:
            return [None] * len(tree_leaves(trainable))
        return tree_leaves(self.trainable_dims)

    def leaf_shards(self, trainable) -> List[Optional[LeafShard]]:
        """Per leaf of this rank's trainable (:func:`tree_leaves` order),
        None or its :class:`LeafShard`."""
        if self.mode == "pp":
            pg = self.mesh.group("pp")
            return [LeafShard(None, x.shape, pg) if is_lora else None
                    for x, is_lora in zip(tree_leaves(trainable),
                                          tree_leaves(_lora_flags(trainable)))]
        fsdp = self.mesh.group("fsdp") if "fsdp" in self.mesh.shape else None
        return [None if d is None else LeafShard(d, shape, fsdp)
                for d, shape in zip(self._leaf_dims(trainable), self.full_shapes)]

    def rows(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of a whole-batch tensor."""
        return chunk_of(x, self.batch_group, dim)

    def reduce_grads(self, grads: List[torch.Tensor], trainable) -> List[torch.Tensor]:
        """This rank's summed gradient of each leaf it holds."""
        data = self.mesh.group("data") if "data" in self.mesh.shape else None
        out = []
        for g, d, sh in zip(grads, self._leaf_dims(trainable), self.leaf_shards(trainable)):
            if self.mode == "pp" and sh is not None:
                out.append(g if data is None else psum_plain(g, data))
            elif d is None:
                out.append(psum_plain(g, self.everyone))
            else:
                if self.mode == "zero2":
                    g = reduce_scatter_plain(g, self.mesh.group("fsdp"), d)
                out.append(g if data is None else psum_plain(g, data))
        return out

    def optimizer_view(self, trainable):
        """The trainable as the optimizer updates it: ZeRO-2's chunks of the
        whole leaves, else as held."""
        if self.mode != "zero2":
            return trainable
        fsdp = self.mesh.group("fsdp")
        return tree_unflatten(trainable, [
            x if d is None else chunk_of(x, fsdp, d).contiguous()
            for x, d in zip(tree_leaves(trainable), self._leaf_dims(trainable))])

    def after_update(self, trainable):
        """ZeRO-2: the updated chunks all-gathered into whole leaves."""
        if self.mode != "zero2":
            return trainable
        fsdp = self.mesh.group("fsdp")
        return tree_unflatten(trainable, [
            x if d is None else all_gather_plain(x, fsdp, d)
            for x, d in zip(tree_leaves(trainable), self._leaf_dims(trainable))])

    def full_tree(self, tree, held_as: str = "trainable"):
        """The whole tree on every rank (every rank must call it) from this
        rank's share of a tree of the trainable's structure: the trainable
        (``held_as="trainable"``) or a tree held as the optimizer holds it,
        such as the EMA (``"state"``)."""
        chunked = self.mode == "fsdp" or (self.mode == "zero2" and held_as == "state")
        if chunked:
            fsdp = self.mesh.group("fsdp")
            return tree_unflatten(tree, [
                x if d is None else all_gather_plain(x, fsdp, d)
                for x, d in zip(tree_leaves(tree), self._leaf_dims(tree))])
        if self.mode != "pp":
            return tree
        # each stage's LoRA blocks, gathered in stage order
        pg = self.mesh.group("pp")
        local = tree["lora"]["blocks"]
        stacked = all_gather_plain_tree(stack_tree(local), pg)
        blocks = [tree_map(lambda x, i=i: x[i], stacked)
                  for i in range(len(local) * pg.size)]
        return dict(tree, lora=dict(tree["lora"], blocks=blocks))

    def init_optimizer(self, optimizer: "_Chain", trainable):
        """The optimizer state of this rank's share."""
        return optimizer.init(self.optimizer_view(trainable), self.leaf_shards(trainable))

    def gather_hook(self) -> Optional["FsdpGather"]:
        """FSDP's gather on use for ``dit_apply`` (:class:`FsdpGather`);
        None in the other modes."""
        if self.mode != "fsdp":
            return None
        train_dims = dict(self.trainable_dims)
        lora_dims = train_dims.pop("lora", None)
        return FsdpGather(self.mesh.group("fsdp"),
                          overlay_params(self.frozen_dims, train_dims), lora_dims)

    def draws(self, micro: Dict[str, torch.Tensor], cfg: TrainConfig, generator,
              t: Optional[torch.Tensor], noise: Optional[torch.Tensor]):
        """This rank's rows of the whole batch's t and noise: given (whole
        batch) or drawn from ``generator`` in the one-device order (t, then
        the noise)."""
        latents = micro["latents"]
        b = latents.shape[0] * self.batch_group.size
        n = math.prod(latents.shape[1:4])
        if t is None:
            t = sample_rf_timesteps(
                b, cfg.rf_log_normal_mu or 0.0, cfg.rf_log_normal_sigma or 1.0,
                cfg.rf_quantile_min, cfg.rf_quantile_max, generator, latents.device)
        if noise is None:
            noise = torch.randn((b, n, latents.shape[-1]), generator=generator,
                                device=latents.device)
        return self.rows(t), self.rows(noise)


def stack_tree(trees: List[Any]):
    """Trees of one structure -> one tree of their leaves stacked on a new
    leading axis."""
    return tree_unflatten(trees[0], [torch.stack(xs) for xs in
                                     zip(*(tree_leaves(t) for t in trees))])


def all_gather_plain_tree(tree, ag: AxisGroup):
    return tree_map(lambda x: all_gather_plain(x, ag, 0), tree)


def _lora_flags(trainable):
    """True at the leaves under "lora", False elsewhere."""
    return {k: tree_map(lambda x, k=k: k == "lora", v) for k, v in trainable.items()}


def make_train_step(
    dit_cfg: DiTConfig,
    cfg: TrainConfig,
    optimizer: _Chain,
    attention_impl: str = "auto",
    rope_split: bool = False,
    sharding: Optional[TrainSharding] = None,
) -> Callable:
    """The step ``(trainable, opt_state, dit_params, batch, prompt_embeds,
    prompt_mask, generator=None, t=None, noise=None) -> (trainable,
    opt_state, metrics)``.

    ``batch`` arrays are [accum, micro_b, ...]; ``t`` [accum, micro_b] and
    ``noise`` [accum, micro_b, N, C], where given, replace the draws per
    micro-batch. The gradients are summed in f32 over the micro-batches and
    divided by their number; the metrics are their means.

    ``sharding``: the trees
    are this rank's (:meth:`TrainSharding.place`, the optimizer state from
    :meth:`TrainSharding.init_optimizer`), ``batch`` holds this rank's
    rows, and ``t`` / ``noise``, where given, the whole batch's."""
    accum = cfg.gradient_accumulation_steps
    remat = _remat(cfg)
    if sharding is not None and sharding.mode == "pp" and cfg.train_mode != "lora_audio":
        raise ValueError("sharding_mode=pp needs train_mode lora_audio")
    mesh_kw = {} if sharding is None else dict(
        pp_mesh=sharding.pp_mesh, sp_mesh=sharding.sp_mesh, data_axis=sharding.batch_group)

    def step(trainable, opt_state, dit_params, batch, prompt_embeds, prompt_mask,
             generator=None, t=None, noise=None):
        leaves = tree_leaves(trainable)
        sums = [torch.zeros_like(x, dtype=torch.float32) for x in leaves]
        per_micro = []
        hook = None if sharding is None else sharding.gather_hook()
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items()}
            t_i, noise_i = _micro(t, i), _micro(noise, i)
            scale = 1.0
            if sharding is not None:
                t_i, noise_i = sharding.draws(micro, cfg, generator, t_i, noise_i)
                scale = 1.0 / sharding.loss_divisor
            with torch.enable_grad():
                live = [x.detach().requires_grad_() for x in leaves]
                with hook if hook is not None else contextlib.nullcontext():
                    loss, metrics = velocity_loss(
                        tree_unflatten(trainable, live), dit_params, dit_cfg, cfg, micro,
                        prompt_embeds, prompt_mask, generator, cfg.train_mode,
                        attention_impl, remat, rope_split, t=t_i, noise=noise_i,
                        gather_params=hook, **mesh_kw)
                # backward() (not autograd.grad) runs every node of the graph,
                # a pipeline stage's hand-offs included
                (loss * scale if scale != 1.0 else loss).backward()
            for acc, x in zip(sums, live):
                if x.grad is not None:
                    acc += x.grad.float()
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        if accum > 1:
            sums = [g / accum for g in sums]
        metrics = {k: torch.stack([m[k] for m in per_micro]).mean() for k in per_micro[0]}
        if sharding is None:
            trainable, opt_state = optimizer.update(
                tree_unflatten(trainable, sums), opt_state, trainable)
            return trainable, opt_state, metrics
        sums = sharding.reduce_grads(sums, trainable)
        view = sharding.optimizer_view(trainable)
        view, opt_state = optimizer.update(tree_unflatten(trainable, sums), opt_state, view,
                                           shard=sharding.leaf_shards(trainable))
        return sharding.after_update(view), opt_state, metrics

    return step


def validate_step_fn(dit_cfg: DiTConfig, cfg: TrainConfig, attention_impl: str = "auto",
                     rope_split: bool = False,
                     sharding: Optional[TrainSharding] = None) -> Callable:
    """``(trainable, dit_params, batch, prompt_embeds, prompt_mask,
    generator=None, t=None, noise=None) -> metrics``: the same noising and
    velocity MSE on one micro-batch, without gradients (over a mesh as
    :func:`make_train_step`)."""

    @torch.no_grad()
    def step(trainable, dit_params, batch, prompt_embeds, prompt_mask,
             generator=None, t=None, noise=None):
        kw = {}
        if sharding is not None:
            t, noise = sharding.draws(batch, cfg, generator, t, noise)
            kw = dict(pp_mesh=sharding.pp_mesh, sp_mesh=sharding.sp_mesh,
                      data_axis=sharding.batch_group,
                      gather_params=sharding.gather_hook())
        _, metrics = velocity_loss(
            trainable, dit_params, dit_cfg, cfg, batch, prompt_embeds, prompt_mask,
            generator, cfg.train_mode, attention_impl, rope_split=rope_split,
            t=t, noise=noise, **kw)
        return metrics

    return step
