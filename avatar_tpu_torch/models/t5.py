"""T5 text encoder, the t5-v1_1-xxl variant PixArt-alpha ships (port of
``avatar_tpu/models/t5.py``).

T5LayerNorm (RMS, no mean subtraction, f32 variance), unscaled attention
(scale 1.0) with one relative-position bias table shared by every block,
and a gated-gelu (tanh form) or relu feed-forward. Prompts are encoded to a
fixed 256 tokens. The key-padding bias is -1e9 on masked keys, added to the
position bias, and the attention runs the plain path (``impl="xla"``), as
in the JAX package: no kernel runs here.

Parameters: ``{"shared": [vocab, d_model], "rel_bias": [buckets, heads],
"blocks": [{"attn": {"q", "k", "v", "o"}, "attn_norm", "ff_norm", "ff":
{"wi_0", "wi_1", "wo"} or {"wi", "wo"}}], "final_norm"}``, each linear
``{"weight": [out, in]}`` or its int8 form (``utils/quantize.py:
quantize_t5_params``).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from avatar_tpu_torch.models.layers import init_linear, init_normal, linear
from avatar_tpu_torch.ops.attention import scaled_dot_product_attention

KEY_PADDING_BIAS = -1e9


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"  # or "relu"

    @classmethod
    def from_dict(cls, d: dict) -> "T5Config":
        """From an HF ``config.json`` dict; keys it lacks take T5's
        defaults, except the widths and depth, which it must name."""
        return cls(
            vocab_size=d.get("vocab_size", 32128),
            d_model=d["d_model"],
            d_kv=d.get("d_kv", 64),
            d_ff=d["d_ff"],
            num_layers=d["num_layers"],
            num_heads=d["num_heads"],
            relative_attention_num_buckets=d.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=d.get("relative_attention_max_distance", 128),
            layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-6),
            feed_forward_proj=d.get("feed_forward_proj", "gated-gelu"),
        )

    @property
    def gated(self) -> bool:
        return "gated" in self.feed_forward_proj

    @property
    def act(self) -> str:
        return self.feed_forward_proj.replace("gated-", "")


def t5_layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm without mean subtraction: the variance in f32, the
    normalized x cast back to x's dtype before the weight, the result in
    the weight's dtype."""
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    out = xf * torch.pow(var + eps, -0.5)
    return (out.to(x.dtype) * weight).to(weight.dtype)


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 buckets, as the JAX package computes them: the log
    in f32 of ``n / max_exact + 1e-9``, truncated to int32 (not HF's
    formula, which can differ by one bucket at a boundary)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs().to(torch.int32)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    large = (torch.log(n.float() / max_exact + 1e-9)
             / math.log(max_distance / max_exact)
             * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp_max(max_exact + large, num_buckets - 1)
    return ret + torch.where(is_small, n, large)


def compute_position_bias(rel_bias_weight: torch.Tensor, q_len: int, k_len: int,
                          num_buckets: int, max_distance: int) -> torch.Tensor:
    """[1, heads, q_len, k_len] bias from the [buckets, heads] table."""
    device = rel_bias_weight.device
    ctx = torch.arange(q_len, device=device)[:, None]
    mem = torch.arange(k_len, device=device)[None, :]
    buckets = relative_position_bucket(mem - ctx, num_buckets, max_distance)
    return rel_bias_weight[buckets.long()].permute(2, 0, 1)[None]


def init_t5_encoder(cfg: T5Config, seed: int = 0, device="cuda",
                    dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters at the JAX package's scales (uniform linears, a
    unit-normal embedding, a relative-bias table of std 0.1, unit norms),
    drawn on ``device`` from ``seed``. In bf16 T5-XXL (4.76 B parameters)
    takes 9.5 GB."""
    gen = torch.Generator(device=device).manual_seed(seed)
    inner = cfg.num_heads * cfg.d_kv

    def lin(n_in, n_out):
        return init_linear(n_in, n_out, gen, bias=False, device=device, dtype=dtype)

    def ones():
        return torch.ones(cfg.d_model, device=device, dtype=dtype)

    blocks = []
    for _ in range(cfg.num_layers):
        attn = {name: lin(cfg.d_model, inner) for name in ("q", "k", "v")}
        attn["o"] = lin(inner, cfg.d_model)
        if cfg.gated:
            ff = {"wi_0": lin(cfg.d_model, cfg.d_ff), "wi_1": lin(cfg.d_model, cfg.d_ff)}
        else:
            ff = {"wi": lin(cfg.d_model, cfg.d_ff)}
        ff["wo"] = lin(cfg.d_ff, cfg.d_model)
        blocks.append({"attn": attn, "attn_norm": ones(), "ff_norm": ones(), "ff": ff})
    return {
        "shared": init_normal((cfg.vocab_size, cfg.d_model), 1.0, gen, device, dtype),
        "rel_bias": init_normal((cfg.relative_attention_num_buckets, cfg.num_heads), 0.1,
                                gen, device, dtype),
        "blocks": blocks,
        "final_norm": ones(),
    }


def t5_encode(params: dict, cfg: T5Config, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """last_hidden_state [B, L, d_model] of ``input_ids`` [B, L] with an
    optional [B, L] keep-mask (1 = keep), in the embedding's dtype."""
    b, length = input_ids.shape
    x = params["shared"][input_ids.long()]
    bias = compute_position_bias(params["rel_bias"].float(), length, length,
                                 cfg.relative_attention_num_buckets,
                                 cfg.relative_attention_max_distance)
    if attention_mask is not None:
        keep = attention_mask.to(x.device) > 0.5
        bias = bias + torch.where(keep, 0.0, KEY_PADDING_BIAS)[:, None, None, :]
    else:
        bias = bias.expand(b, *bias.shape[1:])

    def split(t):
        return t.reshape(b, length, cfg.num_heads, cfg.d_kv).transpose(1, 2)

    eps = cfg.layer_norm_epsilon
    for block in params["blocks"]:
        h = t5_layer_norm(x, block["attn_norm"], eps)
        a = block["attn"]
        q, k, v = (split(linear(a[name], h)) for name in ("q", "k", "v"))
        # T5 leaves the logits unscaled (the scale is folded into its init)
        out = scaled_dot_product_attention(q, k, v, mask=bias, scale=1.0, impl="xla")
        x = x + linear(a["o"], out.transpose(1, 2).reshape(b, length, -1))

        h = t5_layer_norm(x, block["ff_norm"], eps)
        ff = block["ff"]
        if cfg.gated:
            h = F.gelu(linear(ff["wi_0"], h), approximate="tanh") * linear(ff["wi_1"], h)
        else:
            h = F.relu(linear(ff["wi"], h))
        x = x + linear(ff["wo"], h)
    return t5_layer_norm(x, params["final_norm"], eps)


def import_t5_state(state: Dict[str, object], cfg: T5Config, device="cuda") -> dict:
    """HF ``T5EncoderModel`` state dict (torch tensors or numpy arrays) ->
    the port's tree on ``device``. Linear weights keep HF's [out, in]
    layout; leaves keep their stored dtype."""

    def tensor(key):
        t = state[key]
        t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
        return t.to(device)

    def lin(key):
        return {"weight": tensor(key)}

    blocks = []
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        attn = {name: lin(f"{pre}.0.SelfAttention.{name}.weight")
                for name in ("q", "k", "v", "o")}
        names = ("wi_0", "wi_1", "wo") if cfg.gated else ("wi", "wo")
        ff = {name: lin(f"{pre}.1.DenseReluDense.{name}.weight") for name in names}
        blocks.append({"attn": attn, "attn_norm": tensor(f"{pre}.0.layer_norm.weight"),
                       "ff_norm": tensor(f"{pre}.1.layer_norm.weight"), "ff": ff})
    return {
        "shared": tensor("shared.weight"),
        "rel_bias": tensor(
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "blocks": blocks,
        "final_norm": tensor("encoder.final_layer_norm.weight"),
    }


def load_t5_encoder(model_name_or_path, subfolder: str = "text_encoder",
                    quantize: Optional[str] = None, device="cuda"):
    """(cfg, params) from an HF T5 encoder directory: ``config.json`` and
    every ``*.safetensors`` file in it (or in its ``subfolder``), read with
    the port's own safetensors reader. ``quantize`` "w8" or "w8a8" makes the
    block linears int8 (``utils/quantize.py:quantize_t5_params``)."""
    from avatar_tpu_torch.utils.safetensors_io import load_safetensors

    root = Path(model_name_or_path)
    if subfolder and (root / subfolder).exists():
        root = root / subfolder
    with open(root / "config.json") as f:
        cfg = T5Config.from_dict(json.load(f))
    files = sorted(root.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors weights under {root}")
    state = {}
    for path in files:
        tensors, _ = load_safetensors(path)
        state.update(tensors)
    params = import_t5_state(state, cfg, device=device)
    if quantize:
        from avatar_tpu_torch.utils.quantize import quantize_t5_params

        params = quantize_t5_params(params, mode=quantize)
    return cfg, params


def encode_prompt(params: dict, cfg: T5Config, tokenizer, prompt,
                  max_length: int = 256):
    """(embeds [B, max_length, d_model], mask [B, max_length] f32) of one
    prompt or a list of them, through any tokenizer callable with the HF
    call signature (padded to ``max_length``, truncated, special tokens)."""
    if isinstance(prompt, str):
        prompt = [prompt]
    enc = tokenizer(prompt, padding="max_length", max_length=max_length, truncation=True,
                    add_special_tokens=True, return_tensors="np")
    device = params["shared"].device
    ids = torch.as_tensor(np.asarray(enc["input_ids"]), dtype=torch.int32, device=device)
    mask = torch.as_tensor(np.asarray(enc["attention_mask"]), dtype=torch.float32,
                           device=device)
    return t5_encode(params, cfg, ids, mask), mask
