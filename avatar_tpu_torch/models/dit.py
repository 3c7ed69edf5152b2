"""LTX-Video 2B DiT denoiser (port of ``avatar_tpu/models/dit.py``).

Tokens [B, N, C] with 3D RoPE, AdaLN-single timestep conditioning,
self-attention with q/k rms-norm, cross-attention over the projected
caption and a gelu-tanh MLP. Parameters are the JAX package's tree with
PyTorch layouts (see ``avatar_tpu_torch/__init__.py``).

The port runs the inference path of the main pipeline:
- :func:`dit_apply` takes params in the split-RoPE layout
  (:func:`permute_dit_params_for_split_rope`, applied once at load) and
  split-half (cos, sin) tables; self-attention goes through
  ``rope_fused_attention`` and cross-attention through
  ``fused_token_attention``;
- blocks are a list (no stacked layout), no STG, no LoRA, no sequence
  parallelism.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from avatar_tpu_torch.models.layers import (
    init_linear,
    init_normal,
    init_timestep_embedder,
    linear,
    timestep_embedder,
)
from avatar_tpu_torch.ops.flash_attention import (
    fused_token_attention,
    rope_fused_attention,
)
from avatar_tpu_torch.ops.normalization import layer_norm, rms_norm
from avatar_tpu_torch.ops.rope import (
    precompute_freqs_cis,
    rope_channel_permutation,
    split_freqs,
)


@dataclass(frozen=True)
class DiTConfig:
    """Static transformer config; defaults = the shipped 2B model."""

    num_attention_heads: int = 32
    attention_head_dim: int = 64
    in_channels: int = 128
    out_channels: int = 128
    num_layers: int = 28
    cross_attention_dim: int = 2048
    caption_channels: int = 4096
    attention_bias: bool = True
    activation_fn: str = "gelu-approximate"
    norm_elementwise_affine: bool = False
    norm_eps: float = 1e-6
    qk_norm: Optional[str] = "rms_norm"
    standardization_norm: str = "rms_norm"
    adaptive_norm: str = "single_scale_shift"
    positional_embedding_theta: float = 10000.0
    positional_embedding_max_pos: Tuple[int, int, int] = (20, 2048, 2048)
    timestep_scale_multiplier: float = 1000.0
    ff_mult: int = 4

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @classmethod
    def from_dict(cls, config: dict) -> "DiTConfig":
        """Reads the reference ``config.json`` schema."""
        return cls(
            num_attention_heads=config["num_attention_heads"],
            attention_head_dim=config["attention_head_dim"],
            in_channels=config["in_channels"],
            out_channels=config.get("out_channels", config["in_channels"]),
            num_layers=config["num_layers"],
            cross_attention_dim=config.get("cross_attention_dim"),
            caption_channels=config.get("caption_channels"),
            attention_bias=config.get("attention_bias", False),
            activation_fn=config.get("activation_fn", "geglu"),
            norm_elementwise_affine=config.get("norm_elementwise_affine", True),
            norm_eps=config.get("norm_eps", 1e-5),
            qk_norm=config.get("qk_norm"),
            standardization_norm=config.get("standardization_norm", "layer_norm"),
            adaptive_norm=config.get("adaptive_norm", "single_scale_shift"),
            positional_embedding_theta=config.get(
                "positional_embedding_theta", 10000.0),
            positional_embedding_max_pos=tuple(
                config.get("positional_embedding_max_pos", (20, 2048, 2048))
            ),
            timestep_scale_multiplier=config.get("timestep_scale_multiplier") or 1.0,
        )


def _n_ada(cfg: DiTConfig) -> int:
    return 4 if cfg.adaptive_norm == "single_scale" else 6


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_attention(query_dim, kv_dim, cfg, gen, device, dtype) -> dict:
    inner = cfg.inner_dim
    kw = dict(device=device, dtype=dtype)
    p = {
        "to_q": init_linear(query_dim, inner, gen, bias=cfg.attention_bias, **kw),
        "to_k": init_linear(kv_dim, inner, gen, bias=cfg.attention_bias, **kw),
        "to_v": init_linear(kv_dim, inner, gen, bias=cfg.attention_bias, **kw),
        "to_out": init_linear(inner, query_dim, gen, **kw),
    }
    if cfg.qk_norm is not None:
        for norm in ("q_norm", "k_norm"):
            p[norm] = {"scale": torch.ones(inner, **kw)}
            if cfg.qk_norm == "layer_norm":
                p[norm]["bias"] = torch.zeros(inner, **kw)
    return p


def init_dit(
    cfg: DiTConfig,
    seed: int = 0,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Seeded random params at the JAX init's scales, drawn on ``device``
    (unpermuted layout, like the JAX ``init_dit``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    inner = cfg.inner_dim
    kw = dict(device=device, dtype=dtype)
    blocks = []
    for _ in range(cfg.num_layers):
        block = {
            "attn1": _init_attention(inner, inner, cfg, gen, device, dtype),
            "attn2": _init_attention(inner, cfg.cross_attention_dim, cfg, gen,
                                     device, dtype),
            "ff": {
                "proj_in": init_linear(inner, inner * cfg.ff_mult, gen, **kw),
                "proj_out": init_linear(inner * cfg.ff_mult, inner, gen, **kw),
            },
            "scale_shift_table": init_normal(
                (_n_ada(cfg), inner), inner**-0.5, gen, **kw),
        }
        if cfg.norm_elementwise_affine:
            block["norm1"] = {"scale": torch.ones(inner, **kw)}
            block["norm2"] = {"scale": torch.ones(inner, **kw)}
        blocks.append(block)
    params = {
        "patchify_proj": init_linear(cfg.in_channels, inner, gen, **kw),
        "adaln_single": {
            "emb": init_timestep_embedder(inner, gen, **kw),
            "linear": init_linear(inner, _n_ada(cfg) * inner, gen, **kw),
        },
        "blocks": blocks,
        "scale_shift_table": init_normal((2, inner), inner**-0.5, gen, **kw),
        "proj_out": init_linear(inner, cfg.out_channels, gen, **kw),
    }
    if cfg.caption_channels is not None:
        params["caption_projection"] = {
            "linear_1": init_linear(cfg.caption_channels, inner, gen, **kw),
            "linear_2": init_linear(inner, inner, gen, **kw),
        }
    return params


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _std_norm(params: Optional[dict], x: torch.Tensor, cfg: DiTConfig):
    scale = None if not params else params.get("scale")
    bias = None if not params else params.get("bias")
    if cfg.standardization_norm == "rms_norm":
        return rms_norm(x, scale, eps=cfg.norm_eps)
    return layer_norm(x, scale, bias, eps=cfg.norm_eps)


def _qk_norm(params: Optional[dict], x: torch.Tensor, cfg: DiTConfig):
    # eps is fixed at 1e-5 here, unlike the block norms (cfg.norm_eps)
    if params is None:
        return x
    if cfg.qk_norm == "rms_norm":
        return rms_norm(x, params["scale"], eps=1e-5)
    return layer_norm(x, params["scale"], params.get("bias"), eps=1e-5)


def _bounded(params: dict, cfg: DiTConfig) -> bool:
    # The max-free softmax needs the qk-norm to actually run: gate on the
    # norm params being present, not only on cfg.qk_norm.
    return (cfg.qk_norm is not None and params.get("q_norm") is not None
            and params.get("k_norm") is not None)


def _self_attention(params, x, cfg, freqs_split):
    heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
    q = _qk_norm(params.get("q_norm"), linear(params["to_q"], x), cfg)
    k = _qk_norm(params.get("k_norm"), linear(params["to_k"], x), cfg)
    v = linear(params["to_v"], x)
    out = rope_fused_attention(
        q, k, v, freqs_split[0], freqs_split[1], heads, hd**-0.5,
        _bounded(params, cfg),
    )
    return linear(params["to_out"], out)


def _cross_attention(params, x, cfg, cross_kv, kv_mask):
    heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
    q = _qk_norm(params.get("q_norm"), linear(params["to_q"], x), cfg)
    k, v = cross_kv
    out = fused_token_attention(
        q, k, v, kv_mask, heads, hd**-0.5, _bounded(params, cfg),
    )
    return linear(params["to_out"], out)


def _feed_forward(params: dict, x: torch.Tensor, cfg: DiTConfig):
    h = linear(params["proj_in"], x)
    if cfg.activation_fn == "gelu-approximate":
        h = F.gelu(h, approximate="tanh")
    elif cfg.activation_fn == "gelu":
        h = F.gelu(h)
    elif cfg.activation_fn == "geglu":
        h, gate = h.chunk(2, dim=-1)
        h = h * F.gelu(gate)
    else:
        raise ValueError(cfg.activation_fn)
    return linear(params["proj_out"], h)


def _block_apply(params, x, cfg, freqs_split, timestep, cross_kv, kv_mask):
    """BasicTransformerBlock with AdaLN-single; ``timestep`` is the
    [B, 1 or N, n_ada*inner] AdaLN embedding."""
    b = x.shape[0]
    norm_x = _std_norm(params.get("norm1"), x, cfg)
    if cfg.adaptive_norm not in ("single_scale_shift", "single_scale"):
        raise NotImplementedError(f"adaptive_norm={cfg.adaptive_norm!r}")
    n_ada = params["scale_shift_table"].shape[0]
    ada = params["scale_shift_table"].to(x.dtype)[None, None] + timestep.reshape(
        b, timestep.shape[1], n_ada, -1).to(x.dtype)
    if cfg.adaptive_norm == "single_scale_shift":
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            ada[:, :, i] for i in range(6))
    else:
        scale_msa, gate_msa, scale_mlp, gate_mlp = (ada[:, :, i] for i in range(4))
        shift_msa = shift_mlp = None
    norm_x = norm_x * (1 + scale_msa)
    if shift_msa is not None:
        norm_x = norm_x + shift_msa

    x = x + gate_msa * _self_attention(params["attn1"], norm_x, cfg, freqs_split)
    x = x + _cross_attention(params["attn2"], x, cfg, cross_kv, kv_mask)

    norm_x = _std_norm(params.get("norm2"), x, cfg) * (1 + scale_mlp)
    if shift_mlp is not None:
        norm_x = norm_x + shift_mlp
    return x + gate_mlp * _feed_forward(params["ff"], norm_x, cfg)


def _caption_projection(params: dict, cfg: DiTConfig, eh: torch.Tensor):
    if "caption_projection" not in params:
        return eh
    cap = params["caption_projection"]
    eh = F.gelu(linear(cap["linear_1"], eh), approximate="tanh")
    return linear(cap["linear_2"], eh).reshape(eh.shape[0], -1, cfg.inner_dim)


def precompute_cross_attention_kv(
    params: dict,
    cfg: DiTConfig,
    encoder_hidden_states: torch.Tensor,  # [B, L, caption_channels]
    dtype: Optional[torch.dtype] = None,
) -> Tuple[List[Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]:
    """Caption projection and every block's cross-attention (k, v)
    [B, L, inner], computed once per run. Returns (cross_kv, projected)."""
    eh = encoder_hidden_states
    if dtype is not None:
        eh = eh.to(dtype)
    eh = _caption_projection(params, cfg, eh)
    cross_kv = []
    for block in params["blocks"]:
        attn2 = block["attn2"]
        k = _qk_norm(attn2.get("k_norm"), linear(attn2["to_k"], eh), cfg)
        cross_kv.append((k.contiguous(), linear(attn2["to_v"], eh).contiguous()))
    return cross_kv, eh


def precompute_timestep_tables(
    params: dict,
    cfg: DiTConfig,
    timesteps: torch.Tensor,  # [S] schedule sigma levels
    batch: int,
    dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AdaLN-single embeddings for a whole schedule, computed once:
    (ada [S, B, 1, n_ada*inner], embedded [S, B, 1, inner]). t is scaled in
    the activation dtype, as the in-loop prologue would."""
    inner = cfg.inner_dim
    t = timesteps.to(dtype) * cfg.timestep_scale_multiplier
    s = t.shape[0]
    embedded = timestep_embedder(params["adaln_single"]["emb"], t.reshape(-1),
                                 dtype=dtype)
    ada = linear(params["adaln_single"]["linear"], F.silu(embedded))
    ada_table = ada.reshape(s, 1, 1, -1).expand(s, batch, 1, ada.shape[-1])
    emb_table = embedded.reshape(s, 1, 1, inner).expand(s, batch, 1, inner)
    return ada_table.to(dtype), emb_table.to(dtype)


def _dit_prologue(params, cfg, hidden_states, indices_grid, timestep,
                  freqs_split, timestep_tables):
    b = hidden_states.shape[0]
    dtype = hidden_states.dtype
    x = linear(params["patchify_proj"], hidden_states)
    if freqs_split is None:
        freqs_split = split_freqs(precompute_freqs_cis(
            indices_grid, dim=cfg.inner_dim,
            theta=cfg.positional_embedding_theta,
            max_pos=cfg.positional_embedding_max_pos, out_dtype=dtype,
        ))
    if timestep_tables is not None:
        ada, embedded = (t.to(dtype) for t in timestep_tables)
    else:
        t = timestep * cfg.timestep_scale_multiplier
        embedded = timestep_embedder(params["adaln_single"]["emb"], t.reshape(-1),
                                     dtype=dtype)
        ada = linear(params["adaln_single"]["linear"], F.silu(embedded))
        ada = ada.reshape(b, -1, ada.shape[-1])
        embedded = embedded.reshape(b, -1, cfg.inner_dim)
    return x, freqs_split, ada, embedded


def _dit_epilogue(params, x, embedded_timestep):
    dtype = x.dtype
    scale_shift = params["scale_shift_table"][None, None].to(dtype) + (
        embedded_timestep[:, :, None])
    shift, scale = scale_shift[:, :, 0], scale_shift[:, :, 1]
    x = layer_norm(x, eps=1e-6)
    x = x * (1 + scale) + shift
    return linear(params["proj_out"], x)


def dit_apply(
    params: dict,
    cfg: DiTConfig,
    hidden_states: torch.Tensor,  # [B, N, in_channels]
    indices_grid: Optional[torch.Tensor] = None,  # [B, 3, N]
    timestep: Optional[torch.Tensor] = None,  # [B] or [B, N]
    encoder_hidden_states: Optional[torch.Tensor] = None,  # [B, L, caption_ch]
    encoder_attention_mask: Optional[torch.Tensor] = None,  # [B, L] keep mask
    freqs_cis: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cross_kv: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
    timestep_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Velocity tokens [B, N, out_channels].

    ``params`` must be in the split-RoPE layout and ``freqs_cis``, if
    given, the split-half (cos, sin) pair. ``cross_kv`` (from
    :func:`precompute_cross_attention_kv`) replaces
    ``encoder_hidden_states``; ``timestep_tables`` (one row of
    :func:`precompute_timestep_tables`) replaces ``timestep``. A caption
    key with mask 0 gets no weight; a query whose keys are all masked
    gets a zero cross-attention output, as in the attention kernels.
    """
    x, freqs_split, ada, embedded = _dit_prologue(
        params, cfg, hidden_states, indices_grid, timestep, freqs_cis,
        timestep_tables,
    )
    if cross_kv is None:
        if encoder_hidden_states is None:
            raise ValueError("need encoder_hidden_states or cross_kv")
        cross_kv, _ = precompute_cross_attention_kv(
            params, cfg, encoder_hidden_states, dtype=x.dtype)
    kv_mask = None
    if encoder_attention_mask is not None:
        kv_mask = encoder_attention_mask.to(torch.float32).contiguous()
    for block, kv in zip(params["blocks"], cross_kv, strict=True):
        x = _block_apply(block, x, cfg, freqs_split, ada, kv, kv_mask)
    return _dit_epilogue(params, x, embedded)


def avatar_condition_tokens(
    tokens: torch.Tensor,  # [B, N, C]
    ref_image_latents: torch.Tensor,  # [B, 1, H, W, C]
    pose_latents: torch.Tensor,  # [B, F, H, W, C]
    ref_lerp: float = 0.85,
    pose_lerp: float = 0.5,
) -> torch.Tensor:
    """Lerp frame 0 toward the reference latents and frames 1+ toward the
    pose latents (the avatar fork's in-transformer conditioning)."""
    b, f, h, w, c = pose_latents.shape
    x = tokens.reshape(b, f, h, w, c)
    frame0 = x[:, :1] + ref_lerp * (ref_image_latents - x[:, :1])
    rest = x[:, 1:] + pose_lerp * (pose_latents[:, 1:] - x[:, 1:])
    return torch.cat([frame0, rest], dim=1).reshape(b, f * h * w, c)


def permute_dit_params_for_split_rope(params: dict, cfg: DiTConfig) -> dict:
    """A new tree whose attn1 q/k output rows (weight, bias, qk-norm
    params) are in the split-RoPE layout; every other leaf is shared with
    ``params``. Apply exactly once: permuting twice corrupts attention."""
    perm = torch.from_numpy(rope_channel_permutation(cfg.inner_dim))

    def rows(t):
        return t[perm.to(t.device)].contiguous()

    new_blocks = []
    for block in params["blocks"]:
        attn1 = dict(block["attn1"])
        for name in ("to_q", "to_k"):
            attn1[name] = {k: rows(v) for k, v in attn1[name].items()}
        for name in ("q_norm", "k_norm"):
            if name in attn1:
                attn1[name] = {k: rows(v) for k, v in attn1[name].items()}
        new_blocks.append(dict(block, attn1=attn1))
    return dict(params, blocks=new_blocks)
