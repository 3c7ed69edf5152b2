"""LTX-Video 2B DiT denoiser (port of ``avatar_tpu/models/dit.py``).

Tokens [B, N, C] with 3D RoPE, AdaLN-single timestep conditioning,
self-attention with q/k rms-norm, cross-attention over the projected
caption and a gelu-tanh MLP. Parameters are the JAX package's tree with
PyTorch layouts (see ``avatar_tpu_torch/__init__.py``).

The port runs the inference paths:
- with ``rope_split`` the params are in the split-RoPE layout
  (:func:`permute_dit_params_for_split_rope`, applied once at load) and the
  (cos, sin) tables split-half; otherwise both are in the reference's
  interleaved layout;
- :func:`_attention` routes as the JAX package does: self-attention
  through ``rope_fused_attention`` where that path takes the length, else
  RoPE in plain code (or, before the head-major kernels without a
  gradient, kernel M: ``qk_norm_rope``) and then ``fused_token_attention``
  or, for long or unaligned lengths, head-major
  ``scaled_dot_product_attention`` (the flash kernels); cross-attention
  likewise without RoPE;
- STG through ``skip_layer_mask`` and a :class:`SkipLayerStrategy`;
- blocks as a list or stacked on a leading layer axis
  (:func:`stack_block_params`, at home in ``parallel/pipeline.py``);
- sequence parallelism (``sp_axis``, ``parallel/sequence.py``), tensor
  parallelism (``tp_axis``, ``parallel/mesh.py:dit_apply_tp``) and FSDP's
  gather on use (``gather_params``);
- training: LoRA deltas on the attention projections (``lora``,
  ``lora_scale``; the cross-attention k/v ones inside
  :func:`precompute_cross_attention_kv`) and ``remat="full"``, each block
  under ``torch.utils.checkpoint``; the attention kernels' gradients are
  their autograd Functions (``ops/flash_attention.py``);
- int8 linears (``utils/quantize.py``): weight-only ``kernel_q`` anywhere,
  and W8A8 ``kernel_q8`` in the eight per-token block linears, which at a
  per-sample sequence of at least ``W8A8_PALLAS_MIN_TOKENS`` run through
  the int8 kernels of ``ops/int8_matmul.py`` (:func:`_block_apply`,
  :func:`_feed_forward`, ``models/layers.py:linear``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from avatar_tpu_torch.models.layers import (
    init_linear,
    init_normal,
    init_timestep_embedder,
    linear,
    timestep_embedder,
)
from avatar_tpu_torch.ops import int8_matmul
from avatar_tpu_torch.ops.attention import scaled_dot_product_attention
from avatar_tpu_torch.ops.flash_attention import (
    _needs_grad,
    fused_supports,
    fused_token_attention,
    qk_norm_rope,
    qk_norm_rope_supports,
    rope_fused_attention,
    rope_fused_supports,
    split_to_head_major,
)
from avatar_tpu_torch.ops.normalization import layer_norm, rms_norm
from avatar_tpu_torch.ops.rope import (
    apply_rotary_emb,
    apply_rotary_emb_split,
    precompute_freqs_cis,
    rope_channel_permutation,
    split_freqs,
)
from avatar_tpu_torch.parallel.pipeline import (  # noqa: F401 (re-exported)
    stack_block_params,
    unstack_block_params,
)
from avatar_tpu_torch.utils.profiling import annotate


class SkipLayerStrategy(enum.Enum):
    """What an STG-perturbed sample (skip mask 0) gets in a skipped block."""

    AttentionSkip = enum.auto()
    AttentionValues = enum.auto()
    Residual = enum.auto()
    TransformerBlock = enum.auto()


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

    def to_dict(self) -> dict:
        """The reference ``config.json`` schema (the inverse of
        :meth:`from_dict`)."""
        return {
            "_class_name": "Transformer3DModel",
            "num_attention_heads": self.num_attention_heads,
            "attention_head_dim": self.attention_head_dim,
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "num_layers": self.num_layers,
            "cross_attention_dim": self.cross_attention_dim,
            "caption_channels": self.caption_channels,
            "attention_bias": self.attention_bias,
            "activation_fn": self.activation_fn,
            "norm_elementwise_affine": self.norm_elementwise_affine,
            "norm_eps": self.norm_eps,
            "qk_norm": self.qk_norm,
            "standardization_norm": self.standardization_norm,
            "adaptive_norm": self.adaptive_norm,
            "positional_embedding_type": "rope",
            "positional_embedding_theta": self.positional_embedding_theta,
            "positional_embedding_max_pos": list(self.positional_embedding_max_pos),
            "timestep_scale_multiplier": self.timestep_scale_multiplier,
        }


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
        }
        if cfg.adaptive_norm != "none":
            block["scale_shift_table"] = init_normal(
                (_n_ada(cfg), inner), inner**-0.5, gen, **kw)
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


def _qk_norm(params: Optional[dict], x: torch.Tensor, cfg: DiTConfig, tp_axis=None):
    """The q/k norm over the whole inner width; under tensor parallelism
    (``tp_axis``: x holds this rank's heads) its sums are all-reduced."""
    # eps is fixed at 1e-5 here, unlike the block norms (cfg.norm_eps)
    if params is None:
        return x
    if tp_axis is None:
        if cfg.qk_norm == "rms_norm":
            return rms_norm(x, params["scale"], eps=1e-5)
        return layer_norm(x, params["scale"], params.get("bias"), eps=1e-5)
    from avatar_tpu_torch.parallel.collectives import psum_plain

    xf = x.float()
    width = cfg.inner_dim
    if cfg.qk_norm == "rms_norm":
        var = psum_plain((xf * xf).sum(-1, keepdim=True), tp_axis) / width
        out = (xf * torch.rsqrt(var + 1e-5)).to(x.dtype)
    else:
        mean = psum_plain(xf.sum(-1, keepdim=True), tp_axis) / width
        var = psum_plain((xf - mean).square().sum(-1, keepdim=True), tp_axis) / width
        out = ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    out = out * params["scale"].to(x.dtype)
    return out + params["bias"].to(x.dtype) if "bias" in params else out


def _row_parallel(params: dict, x: torch.Tensor, tp_axis) -> torch.Tensor:
    """A row-parallel linear: this rank's input columns times its slice of
    the weight, all-reduced over the tensor-parallel group, then the bias
    once."""
    from avatar_tpu_torch.parallel.collectives import psum_plain

    out = psum_plain(linear({"weight": params["weight"]}, x), tp_axis)
    bias = params.get("bias")
    return out if bias is None else out + bias.to(out.dtype)


def _bounded(params: dict, cfg: DiTConfig) -> bool:
    # The max-free softmax needs the qk-norm to actually run: gate on the
    # norm params being present, not only on cfg.qk_norm.
    return (cfg.qk_norm is not None and params.get("q_norm") is not None
            and params.get("k_norm") is not None)


def _stg_mix(out, skipped, skip_layer_mask):
    """``out`` where the sample's mask is 1, ``skipped`` where it is 0. The
    mask is cast to the activation dtype (the mix is exact for 0/1), so a
    bf16 run stays bf16."""
    m = skip_layer_mask.reshape(-1, 1, 1).to(out.dtype)
    return out * m + skipped * (1.0 - m)


class _KeptProducts:
    """Remat "dots" for one block (the JAX package's
    ``dots_with_no_batch_dims_saveable``), by hand: the block's weight
    products (every linear projection, the LoRA's two products) keep their
    outputs on the block's first run; when the backward recomputes the
    block, each product gives its kept output back instead of multiplying
    again, and everything else is recomputed. The products run in the same
    order on both runs."""

    def __init__(self):
        self.outs: List[torch.Tensor] = []
        self.i, self.kept = 0, False

    def run(self, fn, x):
        self.i = 0
        out = fn(x)
        self.kept = True
        return out


class _KeptProduct(torch.autograd.Function):
    """``F.linear(x, w, b)`` whose output ``keep`` holds (see
    :class:`_KeptProducts`). It saves x and w on both runs, as the linear's
    own gradient does, so that the recompute saves what the first run
    saved; its backward is the linear's: dx = g w, dw = (x^T g)^T, db = the
    sum of g over the rows."""

    @staticmethod
    def forward(ctx, x, w, b, keep):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        if keep.kept:
            out = keep.outs[keep.i].detach()
        else:
            out = F.linear(x, w, b)
            keep.outs.append(out.detach())
        keep.i += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2, x2 = g.reshape(-1, g.shape[-1]), x.reshape(-1, x.shape[-1])
        dx = (g2 @ w).reshape(x.shape) if ctx.needs_input_grad[0] else None
        dw = (x2.t() @ g2).t() if ctx.needs_input_grad[1] else None
        db = g2.sum(0) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db, None


def _linear(params: dict, x, keep: Optional[_KeptProducts] = None):
    """``linear(params, x)``; under remat "dots" (``keep``) a plain weight's
    product keeps its output."""
    if keep is None or "weight" not in params or not torch.is_tensor(x):
        return linear(params, x)
    bias = params.get("bias")
    return _KeptProduct.apply(x, params["weight"].to(x.dtype),
                              None if bias is None else bias.to(x.dtype), keep)


def _lora_linear(params: dict, x, lora: Optional[dict], name: str,
                 lora_scale: float, perm: Optional[torch.Tensor] = None,
                 keep: Optional[_KeptProducts] = None):
    """``linear(params, x)`` plus, where ``lora`` holds ``name``, the
    low-rank delta ``lora_scale * (x a) b`` in x's dtype (a [in, r],
    b [r, out]); ``perm`` reorders b's output columns, as the split-RoPE
    layout reorders the base weight's rows. ``keep``: remat "dots"."""
    out = _linear(params, x, keep)
    if lora is None or name not in lora:
        return out
    a, b = lora[name]["a"], lora[name]["b"]
    if perm is not None:
        b = b[:, perm.to(b.device)]
    if keep is None:
        return out + lora_scale * ((x @ a.to(x.dtype)) @ b.to(x.dtype))
    xa = _KeptProduct.apply(x, a.to(x.dtype).t(), None, keep)
    return out + lora_scale * _KeptProduct.apply(xa, b.to(x.dtype).t(), None, keep)


def _attention(
    params: dict,
    x,
    cfg: DiTConfig,
    freqs_cis: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    kv_mask: Optional[torch.Tensor] = None,
    skip_layer_mask: Optional[torch.Tensor] = None,  # [B]
    skip_layer_strategy: Optional[SkipLayerStrategy] = None,
    attention_impl: str = "auto",
    rope_split: bool = False,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    keep: Optional[_KeptProducts] = None,
    sp_axis=None,
    sp_impl: str = "ulysses",
    tp_axis=None,
) -> torch.Tensor:
    """Self-attention over ``x`` (RoPE from ``freqs_cis``) or, with
    ``cross_kv`` (token-major (k, v) [B, Lk, inner]), cross-attention.
    ``x`` is [B, N, C] or, on the fused W8A8 route, its
    :class:`PrequantRows`, which the q/k/v products take as they are.

    Routing, as in the JAX package: the RoPE-fused kernel where
    ``rope_fused_supports`` holds (split layout, no mask); else RoPE in
    plain code, then the token-major kernel where ``fused_supports`` holds
    (mask absent or [B, Lk]), else ``scaled_dot_product_attention`` over
    head-major tensors. ``attention_impl="xla"`` takes neither token-major
    kernel. Where split-half RoPE would run in plain code before the
    head-major kernels under "auto" or "flash", with the RMS q/k norm,
    without sequence or tensor parallelism and without a gradient, the q/k
    norm, RoPE, the per-head layout and the power-of-two scale run as one
    kernel (M, :func:`qk_norm_rope`) with the same bits. The JAX package
    additionally asks for a TPU backend before it takes a kernel under
    "auto"; the port takes the same path on any device. ``lora`` holds this attention's deltas ({"to_q": {"a", "b"},
    ...}); with ``cross_kv`` its to_k/to_v ones are already in k and v.
    ``keep``: remat "dots" (:class:`_KeptProducts`).

    ``sp_axis`` (this rank's group of the sequence axis; ``x`` is its token
    shard): self-attention is Ulysses or, with ``sp_impl="ring"``, ring
    attention, head-major after plain RoPE; cross-attention is local
    head-major attention to the replicated caption k/v
    (``parallel/sequence.py``). Neither token-major kernel runs there, as
    in the JAX package; the ring's chunks are dense under "xla".
    ``tp_axis`` (tensor parallelism): the params hold this rank's heads
    (``parallel/mesh.py:shard_dit_params_tp``), the q/k norm all-reduces
    its sums and to_out is row-parallel; no LoRA there.
    """
    b = x.shape[0]
    heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
    if tp_axis is not None:
        if lora is not None:
            raise ValueError("tensor parallelism runs without LoRA (inference)")
        heads //= tp_axis.size
    scale = hd**-0.5
    bounded = _bounded(params, cfg)
    kernels = attention_impl in ("auto", "flash")
    is_cross = cross_kv is not None
    use_split_rope = rope_split and not is_cross and freqs_cis is not None
    qk_perm = None
    if lora is not None and use_split_rope:
        qk_perm = torch.from_numpy(rope_channel_permutation(heads * hd))
    proj = partial(_lora_linear, lora=lora, lora_scale=lora_scale, keep=keep)

    def mixed(out):
        out = out.to(q.dtype)
        if skip_layer_mask is not None:
            if skip_layer_strategy == SkipLayerStrategy.AttentionSkip:
                out = _stg_mix(out, x, skip_layer_mask)
            elif skip_layer_strategy == SkipLayerStrategy.AttentionValues:
                out = _stg_mix(out, v, skip_layer_mask)
        if tp_axis is not None:
            return _row_parallel(params["to_out"], out, tp_axis)
        return proj(params["to_out"], out, name="to_out")

    q = proj(params["to_q"], x, name="to_q", perm=qk_perm)
    if is_cross:
        q = _qk_norm(params.get("q_norm"), q, cfg, tp_axis)
        k, v = cross_kv
    else:
        k = proj(params["to_k"], x, name="to_k", perm=qk_perm)
        v = proj(params["to_v"], x, name="to_v")
        # kernel M where the chain below would run RoPE before a head-major
        # kernel, with the bounded RMS q/k norm and no gradient
        m_route = (use_split_rope and kernels and sp_axis is None and tp_axis is None
                   and cfg.qk_norm == "rms_norm" and bounded
                   and not rope_fused_supports(q.shape[1], heads, hd, q.dtype)
                   and qk_norm_rope_supports(heads * hd, heads, q.dtype)
                   and not _needs_grad(q, k, params["q_norm"]["scale"],
                                       params["k_norm"]["scale"]))
        if m_route:
            q, k, scale = qk_norm_rope(q, k, params["q_norm"]["scale"],
                                       params["k_norm"]["scale"], freqs_cis[0],
                                       freqs_cis[1], heads, scale)
        else:
            q = _qk_norm(params.get("q_norm"), q, cfg, tp_axis)
            k = _qk_norm(params.get("k_norm"), k, cfg, tp_axis)
            if (use_split_rope and kv_mask is None and kernels and sp_axis is None
                    and rope_fused_supports(q.shape[1], heads, hd, q.dtype)):
                return mixed(rope_fused_attention(
                    q, k, v, freqs_cis[0], freqs_cis[1], heads, scale, bounded))
            if freqs_cis is not None:
                rope = apply_rotary_emb_split if use_split_rope else apply_rotary_emb
                q, k = rope(q, freqs_cis), rope(k, freqs_cis)
            if use_split_rope:
                q, k = split_to_head_major(q, heads), split_to_head_major(k, heads)

    def split(t):
        return t.reshape(b, -1, heads, hd).transpose(1, 2)

    def merged(out):
        return out.transpose(1, 2).reshape(b, -1, heads * hd)

    if sp_axis is not None:
        from avatar_tpu_torch.parallel import sequence

        if is_cross:
            out = sequence.ulysses_cross_attention(
                split(q), split(k), split(v), kv_mask=kv_mask,
                attention_impl=attention_impl, bounded_logits=bounded)
        elif sp_impl == "ring":
            out = sequence.ring_attention(
                split(q), split(k), split(v), sp_axis, kv_mask=kv_mask,
                bounded_logits=bounded,
                chunk_impl="dense" if attention_impl == "xla" else "auto")
        else:
            out = sequence.ulysses_attention(
                split(q), split(k), split(v), sp_axis, kv_mask=kv_mask,
                attention_impl=attention_impl, bounded_logits=bounded)
        return mixed(merged(out))

    if (kernels and (kv_mask is None or kv_mask.ndim == 2)
            and fused_supports(q.shape[1], k.shape[1], heads, hd, q.dtype)):
        return mixed(fused_token_attention(q, k, v, kv_mask, heads, scale, bounded))

    out = scaled_dot_product_attention(
        split(q), split(k), split(v), mask=kv_mask, scale=scale, impl=attention_impl,
        bounded_logits=bounded)
    return mixed(merged(out))


def _feed_forward(params: dict, x, cfg: DiTConfig, keep: Optional[_KeptProducts] = None,
                  tp_axis=None):
    """``x`` is [B, N, C] or, on the fused W8A8 route, its
    :class:`PrequantRows`. With a W8A8 ``proj_out`` and a per-sample
    sequence of at least ``W8A8_PALLAS_MIN_TOKENS`` the activation and the
    row quantization run as one kernel (``fused_act_quant``). ``keep``:
    remat "dots"; ``tp_axis``: proj_in column-parallel, proj_out
    row-parallel."""
    h = _linear(params["proj_in"], x, keep)
    if (cfg.activation_fn in int8_matmul.ACTIVATIONS
            and "kernel_q8" in params["proj_out"] and h.ndim == 3
            and h.shape[1] >= int8_matmul.W8A8_PALLAS_MIN_TOKENS):
        return linear(params["proj_out"],
                      int8_matmul.fused_act_quant(h, cfg.activation_fn))
    if cfg.activation_fn == "gelu-approximate":
        h = F.gelu(h, approximate="tanh")
    elif cfg.activation_fn == "gelu":
        h = F.gelu(h)
    elif cfg.activation_fn == "geglu":
        h, gate = h.chunk(2, dim=-1)
        h = h * F.gelu(gate)
    else:
        raise ValueError(cfg.activation_fn)
    if tp_axis is not None:
        return _row_parallel(params["proj_out"], h, tp_axis)
    return _linear(params["proj_out"], h, keep)


def _norm_modulate(norm_params, x, scale, shift, cfg, fused_quant):
    """``norm(x) * (1 + scale) (+ shift)`` (the plain norm without AdaLN,
    ``scale`` None); with ``fused_quant`` one kernel that also quantizes
    the rows, fed ``cvec`` = (1 + scale) * norm scale formed in x's dtype,
    as in the JAX package."""
    if not fused_quant:
        out = _std_norm(norm_params, x, cfg)
        if scale is not None:
            out = out * (1 + scale)
        return out if shift is None else out + shift
    cvec = 1 + scale
    norm_scale = None if not norm_params else norm_params.get("scale")
    if norm_scale is not None:
        cvec = cvec * norm_scale.to(x.dtype)
    return int8_matmul.fused_rms_mod_quant(x, cvec, shift, eps=cfg.norm_eps)


def _gated(gate, out):
    return out if gate is None else gate * out


def _block_apply(params, x, cfg, freqs_cis, timestep, cross_kv, kv_mask,
                 skip_layer_mask=None, skip_layer_strategy=None,
                 attention_impl="auto", rope_split=False, lora=None,
                 lora_scale=1.0, keep=None, sp_axis=None, sp_impl="ulysses",
                 tp_axis=None):
    """BasicTransformerBlock with AdaLN-single; ``timestep`` is the
    [B, 1 or N, n_ada*inner] AdaLN embedding, ``skip_layer_mask`` this
    block's [B] row of the STG mask. With ``adaptive_norm="none"`` the
    norms are plain, the residuals ungated, and the cross-attention input
    is normed where the block holds an ``attn2_norm``.

    The fused W8A8 route, under the JAX package's conditions (rms-norm,
    AdaLN, one AdaLN row per sample, a per-sample sequence of at least
    ``W8A8_PALLAS_MIN_TOKENS``, W8A8 ``attn1.to_q``, no skip mask): the
    norm, the modulation and the row quantization before self-attention
    and before the FF run as one kernel (``fused_rms_mod_quant``), whose
    int8 rows feed the q/k/v and FF-in products directly. ``lora`` is this
    block's {"attn1"?, "attn2"?} deltas; ``keep`` its remat "dots" state;
    ``sp_axis`` / ``sp_impl``: sequence parallelism (:func:`_attention`;
    the fused W8A8 route is off there, as in the JAX package) and
    ``tp_axis``: tensor parallelism (:func:`_attention`, :func:`_feed_forward`)."""
    b = x.shape[0]
    lora = lora or {}
    original_x = x
    adaln = cfg.adaptive_norm != "none"
    fused_quant_norm = (
        adaln
        and cfg.standardization_norm == "rms_norm"
        and timestep.shape[1] == 1
        and x.ndim == 3 and x.shape[1] >= int8_matmul.W8A8_PALLAS_MIN_TOKENS
        and "kernel_q8" in params["attn1"]["to_q"]
        and skip_layer_mask is None and sp_axis is None and tp_axis is None)
    shift_msa = scale_msa = gate_msa = shift_mlp = scale_mlp = gate_mlp = None
    with annotate("dit.norm"):
        if adaln:
            n_ada = params["scale_shift_table"].shape[0]
            ada = params["scale_shift_table"].to(x.dtype)[None, None] + timestep.reshape(
                b, timestep.shape[1], n_ada, -1).to(x.dtype)
            if cfg.adaptive_norm == "single_scale_shift":
                shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
                    ada[:, :, i] for i in range(6))
            else:
                scale_msa, gate_msa, scale_mlp, gate_mlp = (ada[:, :, i] for i in range(4))
        norm_x = _norm_modulate(params.get("norm1"), x, scale_msa, shift_msa, cfg,
                                fused_quant_norm)

    with annotate("dit.attn1"):
        out = _attention(
            params["attn1"], norm_x, cfg, freqs_cis=freqs_cis,
            skip_layer_mask=skip_layer_mask, skip_layer_strategy=skip_layer_strategy,
            attention_impl=attention_impl, rope_split=rope_split,
            lora=lora.get("attn1"), lora_scale=lora_scale, keep=keep,
            sp_axis=sp_axis, sp_impl=sp_impl, tp_axis=tp_axis)
    x = x + _gated(gate_msa, out)
    with annotate("dit.attn2"):
        attn_in = x if adaln or "attn2_norm" not in params else _std_norm(
            params["attn2_norm"], x, cfg)
        out = _attention(params["attn2"], attn_in, cfg, kv_mask=kv_mask,
                         attention_impl=attention_impl, cross_kv=cross_kv,
                         lora=lora.get("attn2"), lora_scale=lora_scale, keep=keep,
                         sp_axis=sp_axis, tp_axis=tp_axis)
    x = x + out

    with annotate("dit.norm"):
        norm_x = _norm_modulate(params.get("norm2"), x, scale_mlp, shift_mlp, cfg,
                                fused_quant_norm and "kernel_q8" in params["ff"]["proj_in"])
    with annotate("dit.ff"):
        out = _feed_forward(params["ff"], norm_x, cfg, keep, tp_axis)
    x = x + _gated(gate_mlp, out)
    if (skip_layer_mask is not None
            and skip_layer_strategy == SkipLayerStrategy.TransformerBlock):
        x = _stg_mix(x, original_x, skip_layer_mask)
    return x


def _blocks_list(blocks: Union[dict, Sequence[dict]]) -> Sequence[dict]:
    return blocks if isinstance(blocks, (list, tuple)) else unstack_block_params(blocks)


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
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    tp_axis=None,
    gather=None,
):
    """Caption projection and every block's cross-attention (k, v)
    [B, L, inner], computed once per run, with the attn2 to_k/to_v LoRA
    deltas of ``lora`` where it holds them. Returns (cross_kv, projected):
    ``cross_kv`` is a list of per-block pairs, or for stacked blocks the
    stacked pair (k [L, B, Lk, inner], v [L, B, Lk, inner]). ``tp_axis``:
    the blocks hold this rank's heads (k/v [.., inner / tp]). ``gather``
    (``dit_apply``'s ``gather_params``) gives each block's attn2 and LoRA
    their full tensors just before the block's k and v are computed."""
    eh = encoder_hidden_states
    if dtype is not None:
        eh = eh.to(dtype)
    eh = _caption_projection(params, cfg, eh)
    blocks = _blocks_list(params["blocks"])
    lora_blocks = ([None] * len(blocks) if lora is None
                   else _blocks_list(lora["blocks"]))
    cross_kv = []
    for i, (block, block_lora) in enumerate(zip(blocks, lora_blocks, strict=True)):
        if gather is not None:
            block = gather({"attn2": block["attn2"]}, ("blocks", i))
            block_lora = None if block_lora is None else gather(block_lora, ("lora", i))
        attn2 = block["attn2"]
        a2_lora = None if block_lora is None else block_lora.get("attn2")
        proj = partial(_lora_linear, x=eh, lora=a2_lora, lora_scale=lora_scale)
        k = _qk_norm(attn2.get("k_norm"), proj(attn2["to_k"], name="to_k"), cfg, tp_axis)
        cross_kv.append((k.contiguous(), proj(attn2["to_v"], name="to_v").contiguous()))
    if not isinstance(params["blocks"], (list, tuple)):
        ks, vs = zip(*cross_kv)
        return (torch.stack(ks), torch.stack(vs)), eh
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
                  freqs_cis, timestep_tables, rope_split):
    b = hidden_states.shape[0]
    dtype = hidden_states.dtype
    x = linear(params["patchify_proj"], hidden_states)
    if freqs_cis is None:
        freqs_cis = precompute_freqs_cis(
            indices_grid, dim=cfg.inner_dim,
            theta=cfg.positional_embedding_theta,
            max_pos=cfg.positional_embedding_max_pos, out_dtype=dtype,
        )
        if rope_split:
            freqs_cis = split_freqs(freqs_cis)
    if timestep_tables is not None:
        ada, embedded = (t.to(dtype) for t in timestep_tables)
    else:
        t = timestep * cfg.timestep_scale_multiplier
        embedded = timestep_embedder(params["adaln_single"]["emb"], t.reshape(-1),
                                     dtype=dtype)
        ada = linear(params["adaln_single"]["linear"], F.silu(embedded))
        ada = ada.reshape(b, -1, ada.shape[-1])
        embedded = embedded.reshape(b, -1, cfg.inner_dim)
    return x, freqs_cis, ada, embedded


def _dit_epilogue(params, x, embedded_timestep):
    dtype = x.dtype
    scale_shift = params["scale_shift_table"][None, None].to(dtype) + (
        embedded_timestep[:, :, None])
    shift, scale = scale_shift[:, :, 0], scale_shift[:, :, 1]
    x = layer_norm(x, eps=1e-6)
    x = x * (1 + scale) + shift
    return linear(params["proj_out"], x)


def apply_blocks(x, blocks, lora_blocks, cross_kv, cfg: DiTConfig, *, freqs_cis, ada,
                 kv_mask, skip_layer_mask=None, skip_layer_strategy=None,
                 attention_impl="auto", rope_split=True, lora_scale=1.0, remat=False,
                 sp_axis=None, sp_impl="ulysses", tp_axis=None, gather=None):
    """``x`` through ``blocks`` (per-block param dicts) in order, block i
    with ``lora_blocks[i]`` (or None), ``cross_kv[i]`` (a per-block list,
    or the stacked pair) and row i of ``skip_layer_mask``; each block under
    ``remat`` (:func:`dit_apply`). Shared with the pipeline-parallel
    stages (``parallel/pipeline.py``)."""
    if remat not in (False, True, "full", "dots"):
        raise ValueError(f"unknown remat {remat!r} (False, True, 'full' or 'dots')")
    gather = gather or (lambda tree, path: tree)
    if lora_blocks is None:
        lora_blocks = [None] * len(blocks)
    if not isinstance(cross_kv, (list, tuple)) or torch.is_tensor(cross_kv[0]):
        cross_kv = list(zip(*cross_kv))  # stacked pair -> per-block pairs
    for i, (block, kv) in enumerate(zip(blocks, cross_kv, strict=True)):
        def run(x, keep=None, i=i, block=block, kv=kv):
            lb = lora_blocks[i]
            with annotate("dit.block"):
                return _block_apply(
                    gather(block, ("blocks", i)), x, cfg=cfg, freqs_cis=freqs_cis,
                    timestep=ada, cross_kv=kv, kv_mask=kv_mask,
                    skip_layer_mask=None if skip_layer_mask is None else skip_layer_mask[i],
                    skip_layer_strategy=skip_layer_strategy, attention_impl=attention_impl,
                    rope_split=rope_split,
                    lora=None if lb is None else gather(lb, ("lora", i)),
                    lora_scale=lora_scale, keep=keep, sp_axis=sp_axis, sp_impl=sp_impl,
                    tp_axis=tp_axis)

        if remat == "dots":
            keep = _KeptProducts()
            x = torch.utils.checkpoint.checkpoint(keep.run, partial(run, keep=keep), x,
                                                  use_reentrant=False)
        elif remat:
            x = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
        else:
            x = run(x)
    return x


def dit_apply(
    params: dict,
    cfg: DiTConfig,
    hidden_states: torch.Tensor,  # [B, N, in_channels]
    indices_grid: Optional[torch.Tensor] = None,  # [B, 3, N]
    timestep: Optional[torch.Tensor] = None,  # [B] or [B, N]
    encoder_hidden_states: Optional[torch.Tensor] = None,  # [B, L, caption_ch]
    encoder_attention_mask: Optional[torch.Tensor] = None,  # [B, L] keep mask
    skip_layer_mask: Optional[torch.Tensor] = None,  # [num_layers, B]
    skip_layer_strategy: Optional[SkipLayerStrategy] = None,
    attention_impl: str = "auto",
    freqs_cis: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rope_split: bool = True,
    cross_kv=None,
    timestep_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    lora: Optional[dict] = None,
    lora_scale: float = 1.0,
    remat=False,
    sp_axis=None,
    sp_impl: str = "ulysses",
    gather_params=None,
    tp_axis=None,
) -> torch.Tensor:
    """Velocity tokens [B, N, out_channels].

    ``rope_split`` (the default): ``params`` are in the split-RoPE layout
    and ``freqs_cis``, if given, is the split-half (cos, sin) pair;
    otherwise both are in the interleaved layout. ``params["blocks"]`` is
    a list, or one tree stacked on a leading layer axis, walked slice by
    slice. ``cross_kv`` (from :func:`precompute_cross_attention_kv`, in
    the blocks' layout) replaces ``encoder_hidden_states``;
    ``timestep_tables`` (one row of :func:`precompute_timestep_tables`)
    replaces ``timestep``. ``skip_layer_mask`` rows are 0 for the samples
    that ``skip_layer_strategy`` perturbs in that block. On the kernel
    paths a caption key with mask 0 gets no weight and a query whose keys
    are all masked gets a zero cross-attention output;
    ``attention_impl="xla"`` gives such a query unmasked attention.

    Training: ``lora`` ({"blocks": [{"attn2": {"to_q": {"a", "b"}, ...}}]})
    adds ``lora_scale`` times its low-rank deltas to the attention
    projections (with ``cross_kv`` given, its to_k/to_v deltas must already
    be in it). ``remat``: False; True or "full" (each block under
    ``torch.utils.checkpoint``: only block inputs are kept, the backward
    recomputes the block); "dots" (the JAX package's
    ``dots_with_no_batch_dims_saveable``: the outputs of the weight
    products, every linear projection and the LoRA's two products, are
    kept and the rest of the block, the attention kernels included, is
    recomputed; :class:`_KeptProducts`).

    ``sp_axis`` / ``sp_impl``: this rank's group of the sequence axis, the
    inputs its token shard (``parallel/sequence.py:dit_apply_sp``).
    ``gather_params(tree, path)``, if given, returns the full tensors of a
    sharded subtree (FSDP): it is called on the top-level params (path
    ``()``), on each block's params (``("blocks", i)``) and LoRA
    (``("lora", i)``) where the block runs, inside its remat, and on each
    block's attn2 where its cross-attention k and v are computed, so that
    a block's gathered weights live only while they are used (the copies
    autograd saves: ``train/train.py:FsdpGather``). ``tp_axis``: tensor
    parallelism, the params this rank's heads and ``freqs_cis`` their
    channels (``parallel/mesh.py:dit_apply_tp``).
    """
    if remat not in (False, True, "full", "dots"):
        raise ValueError(f"unknown remat {remat!r} (False, True, 'full' or 'dots')")
    gather = gather_params or (lambda tree, path: tree)
    blocks = _blocks_list(params["blocks"])
    lora_blocks = [None] * len(blocks) if lora is None else _blocks_list(lora["blocks"])
    params = dict(gather({k: v for k, v in params.items() if k != "blocks"}, ()),
                  blocks=blocks)
    x, freqs_cis, ada, embedded = _dit_prologue(
        params, cfg, hidden_states, indices_grid, timestep, freqs_cis,
        timestep_tables, rope_split,
    )
    if cross_kv is None:
        if encoder_hidden_states is None:
            raise ValueError("need encoder_hidden_states or cross_kv")
        cross_kv, _ = precompute_cross_attention_kv(
            params, cfg, encoder_hidden_states, dtype=x.dtype, lora=lora,
            lora_scale=lora_scale, tp_axis=tp_axis, gather=gather_params)
    kv_mask = None
    if encoder_attention_mask is not None:
        kv_mask = encoder_attention_mask.to(torch.float32).contiguous()
    x = apply_blocks(
        x, blocks, lora_blocks, cross_kv, cfg, freqs_cis=freqs_cis, ada=ada,
        kv_mask=kv_mask, skip_layer_mask=skip_layer_mask,
        skip_layer_strategy=skip_layer_strategy, attention_impl=attention_impl,
        rope_split=rope_split, lora_scale=lora_scale, remat=remat, sp_axis=sp_axis,
        sp_impl=sp_impl, tp_axis=tp_axis, gather=gather)
    return _dit_epilogue(params, x, embedded)


def create_skip_layer_mask(
    num_layers: int,
    batch_size: int,
    num_conds: int,
    ptb_index: int,
    skip_block_list: Optional[Sequence[int]] = None,
    device="cuda",
) -> Optional[torch.Tensor]:
    """[num_layers, batch_size * num_conds] f32 mask: 0 for the perturbed
    cond (``ptb_index`` of each group of ``num_conds``) in the listed
    blocks, 1 elsewhere; None without a list."""
    if not skip_block_list:
        return None
    mask = torch.ones((num_layers, batch_size * num_conds), dtype=torch.float32,
                      device=device)
    for block_idx in skip_block_list:
        mask[block_idx, ptb_index::num_conds] = 0.0
    return mask


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
    """A new tree whose attn1 q/k output rows (weight or int8 kernel and
    its scale, bias, qk-norm params) are in the split-RoPE layout; every
    other leaf is shared with ``params``. Apply exactly once: permuting
    twice corrupts attention."""
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
