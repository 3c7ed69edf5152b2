"""LoRA for the DiT cross-attention (port of ``avatar_tpu/train/lora.py``):
rank-r adapters on every block's attn2 {to_q, to_k, to_v, to_out}, the
"lora_audio" training strategy.

The adapters are a tree parallel to the DiT's params, consumed by
``dit_apply(lora=..., lora_scale=alpha / rank)``: per projection
``{"a": [in, r], "b": [r, out]}``, the JAX package's layout, so a JAX LoRA
tree carries over as it is (``utils/weight_import.py:lora_from_numpy``).
Export merges the deltas into the base weights (:func:`merge_lora`), so
saved checkpoints are plain single-file safetensors.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from avatar_tpu_torch.models.dit import DiTConfig

DEFAULT_TARGETS = ("to_q", "to_k", "to_v", "to_out")


def init_lora(
    cfg: DiTConfig,
    rank: int,
    generator: Optional[torch.Generator] = None,
    targets: Sequence[str] = DEFAULT_TARGETS,
    attn: str = "attn2",
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> dict:
    """a ~ U(-sqrt(3 / in), sqrt(3 / in)) (PEFT's kaiming-uniform with
    a = sqrt(5) on an [in, r] matrix), b = 0, so the initial delta is 0.
    Drawn from ``generator`` block by block; the JAX package draws from a
    key per (block, projection), so the two give different ``a`` for one
    seed (and the same function at init)."""
    inner = cfg.inner_dim
    dims = {
        "to_q": (inner, inner),
        "to_k": (cfg.cross_attention_dim, inner),
        "to_v": (cfg.cross_attention_dim, inner),
        "to_out": (inner, inner),
    }
    blocks = []
    for _ in range(cfg.num_layers):
        block = {}
        for name in targets:
            d_in, d_out = dims[name]
            bound = math.sqrt(3.0 / d_in)
            a = torch.empty((d_in, rank), device=device, dtype=torch.float32)
            a.uniform_(-bound, bound, generator=generator)
            block[name] = {"a": a.to(dtype),
                           "b": torch.zeros((rank, d_out), device=device, dtype=dtype)}
        blocks.append({attn: block})
    return {"blocks": blocks}


def lora_scale(rank: int, alpha: int) -> float:
    return alpha / rank


def merge_lora(dit_params: dict, lora: dict, scale: float) -> dict:
    """Fold the deltas into the base weights (PEFT's ``merge_and_unload``):
    W' = W + scale * (A B)^T in f32 ([out, in] weights), cast back to W's
    dtype. Returns a new tree; every leaf the LoRA does not touch is
    shared with ``dit_params``."""
    new_blocks = []
    for block, lora_block in zip(dit_params["blocks"], lora["blocks"], strict=True):
        block = dict(block)
        for attn_name, adapters in lora_block.items():
            attn = dict(block[attn_name])
            for proj, ab in adapters.items():
                p = dict(attn[proj])
                delta = (ab["a"].float() @ ab["b"].float()) * scale
                w = p["weight"]
                p["weight"] = (w.float() + delta.t().to(w.device)).to(w.dtype)
                attn[proj] = p
            block[attn_name] = attn
        new_blocks.append(block)
    return dict(dit_params, blocks=new_blocks)
