"""Plain float32 fine-tuning steps of the LTX-Video DiT: the velocity loss
of rectified flow with the avatar conditioning, gradients by autograd,
accumulated over micro-batches, and AdamW (decoupled weight decay, bias
correction, as optax's ``adamw``).

Nothing of the program is imported. The trained leaves are named by the
job's configuration; every other weight is frozen and read as float32.
The timesteps and the noise are given, so that the program and this
reference see the same draws.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from benchmark.reference import ltxv


def named_leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"blocks.3.attn1.to_q.weight": tensor, ...}`` of a tree of dicts
    and lists."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(named_leaves(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(named_leaves(v, f"{prefix}{i}."))
    elif torch.is_tensor(tree):
        out[prefix[:-1]] = tree
    return out


def trained(name: str, patterns: Sequence[str]) -> bool:
    """Whether leaf ``name`` falls under one of ``patterns`` ("blocks.*.attn1"
    matches every block's attn1 subtree)."""
    parts = name.split(".")
    for pat in patterns:
        p = pat.split(".")
        if len(p) <= len(parts) and all(a == "*" or a == b for a, b in zip(p, parts)):
            return True
    return False


def _with_leaves(tree, leaves: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _with_leaves(v, leaves, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_leaves(v, leaves, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return leaves.get(prefix[:-1], tree)


def velocity_loss(P, cfg, micro: Dict[str, torch.Tensor], t, noise, embeds, mask, prec,
                  working_dtype=torch.bfloat16):
    """Mean squared error of the DiT's velocity on one micro-batch: tokens
    noised to ``t`` [B] with ``noise`` [B, N, C], the first latent frame
    lerped toward the reference latents and the rest toward the pose
    latents, RoPE over the latent grid, the timestep t x 1000 rounded to
    the configuration's working type."""
    lat = micro["latents"].float()
    b, f, h, w, c = lat.shape
    tokens = lat.reshape(b, f * h * w, c)
    tt = t.float()[:, None, None]
    noisy = ((1 - tt) * tokens + tt * noise.float()).reshape(lat.shape)
    target = noise.float() - tokens
    x = ltxv.avatar_lerp(noisy, micro["ref_image_latents"].float(),
                         micro["pose_latents"].float()).reshape(b, -1, c)
    dev = lat.device
    grid = torch.stack(torch.meshgrid(torch.arange(f, device=dev), torch.arange(h, device=dev),
                                      torch.arange(w, device=dev), indexing="ij")).reshape(3, -1)
    rope = ltxv.rope_tables(grid[None].float().expand(b, -1, -1),
                            cfg["num_attention_heads"] * cfg["attention_head_dim"],
                            cfg["positional_embedding_theta"], cfg["positional_embedding_max_pos"])
    t_model = ltxv.bf16_round(ltxv.bf16_round(t, working_dtype) * 1000.0, working_dtype)
    emb = embeds.float().expand(b, -1, -1)
    kv = ltxv.caption_kv(P, cfg, emb, prec)
    out = ltxv.dit_forward(P, cfg, x, rope, t_model, kv, mask.float().expand(b, -1), prec)
    return torch.mean((out - target) ** 2)


def train_steps(dit_params, cfg: dict, steps: List[dict], embeds, mask, patterns,
                lr: float, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                prec: ltxv.Precision = None, working_dtype=torch.bfloat16,
                rows_per_pass: int = 0) -> dict:
    """Runs ``len(steps)`` optimizer steps from ``dit_params``. Each step
    is {"batch": {name: [accum, micro, ...]}, "t": [accum, micro], "noise":
    [accum, micro, N, C]}. Returns each step's loss (the mean over its
    micro-batches), the first step's gradient norm per trained leaf, and
    the norm per trained leaf of the parameters' change over all steps.
    ``rows_per_pass`` (0: all) splits each micro-batch into passes of that
    many rows, each pass's loss weighted by its share of the rows, so that
    the float32 activations fit."""
    prec = prec or ltxv.Precision("f32")
    leaves = {k: v for k, v in named_leaves(dit_params).items() if trained(k, patterns)}
    p0 = {k: v.detach().float().clone() for k, v in leaves.items()}
    params = {k: v.clone().requires_grad_() for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    losses, grad_norms = [], None
    for n, step in enumerate(steps, start=1):
        accum = step["t"].shape[0]
        grads = {k: torch.zeros_like(v) for k, v in p0.items()}
        total = 0.0
        for i in range(accum):
            P = _with_leaves(dit_params, params)
            rows = step["t"].shape[1]
            per = rows_per_pass or rows
            for r in range(0, rows, per):
                sl = slice(r, min(r + per, rows))
                micro = {k: v[i, sl] for k, v in step["batch"].items()}
                share = (sl.stop - sl.start) / rows
                loss = share * velocity_loss(P, cfg, micro, step["t"][i, sl],
                                             step["noise"][i, sl], embeds, mask, prec,
                                             working_dtype)
                g = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                for (k, _), gi in zip(params.items(), g):
                    if gi is not None:
                        grads[k] += gi
                total += float(loss.detach())
                del loss, g
        grads = {k: v / accum for k, v in grads.items()}
        losses.append(total / accum)
        if grad_norms is None:
            grad_norms = {k: float(v.norm()) for k, v in grads.items()}
        with torch.no_grad():
            bc1, bc2 = 1 - b1**n, 1 - b2**n
            for k, p in params.items():
                mu[k] = (1 - b1) * grads[k] + b1 * mu[k]
                nu[k] = (1 - b2) * grads[k] ** 2 + b2 * nu[k]
                u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) + weight_decay * p
                p -= lr * u
    with torch.no_grad():
        change = {k: float((params[k] - p0[k]).norm()) for k in params}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def worst_leaf_gap(program: Dict[str, float], reference: Dict[str, float],
                   keep=None) -> tuple:
    """The largest |program - reference| over the leaves, each against the
    larger of its reference norm and the median leaf's: (gap, leaf).
    ``keep`` names the leaves compared (all where None)."""
    names = [k for k in reference if keep is None or k in keep]
    if not names:
        return math.nan, None
    floor = sorted(reference[k] for k in names)[len(names) // 2]
    worst, where = -1.0, None
    for k in names:
        gap = abs(program[k] - reference[k]) / max(reference[k], floor, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, where = gap, k
    return worst, where
