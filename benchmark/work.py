"""Frozen operation and byte counts, and the table of peaks.

Each kernel's work counts every input byte read once and every output byte
written once, and the operations its shapes need, whatever the kernel
reads again; the least time of a call is the larger of its operations at
the peak rate of their type and its bytes at the memory rate. The model's
work (DiT forwards, VAE encodes and decodes) is the operations of its
products, taken from the configuration and the cell's shapes: the DiT's
analytically, the VAE's from its convolutions as the plain reference
makes them (on the meta device: shapes only).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

# Dense peaks of one card at its full power limit, from NVIDIA's data sheets
# (SXM parts): bf16 tensor-core op/s, memory bytes/s, int8 tensor-core op/s.
PEAKS = {"H100": (989e12, 3.35e12, 1979e12), "H200": (989e12, 4.8e12, 1979e12)}


def peaks_for(device_name: str):
    """(bf16 op/s, bytes/s, int8 op/s) of a card by name, or None for a card
    the table does not hold."""
    for key, val in PEAKS.items():
        if key in device_name:
            return val
    return None


def least_s(ops: float, nbytes: float, op_rate: float, mem_rate: float) -> float:
    return max(ops / op_rate, nbytes / mem_rate)


# ---------------------------------------------------------------------------
# Kernels (copied from the program's card checks, chip_smoke.py)
# ---------------------------------------------------------------------------


def attention_work(b, h, lq, lk, d, itemsize=2):
    """Head-major attention forward: QK^T and PV; q, k, v, o once each and
    the f32 lse."""
    return 4.0 * b * h * lq * lk * d, (2 * lq + 2 * lk) * b * h * d * itemsize + b * h * lq * 4


def rope_work(batch, length, width, itemsize=2):
    """A (RoPE fused into self-attention): QK^T and PV over every head; q,
    k, v and o once each, cos and sin (half the width) once each."""
    return (4.0 * batch * length * length * width,
            (4 * batch * length * width + 2 * batch * length * (width // 2)) * itemsize)


def token_work(b, lq, kept, lk, c, itemsize=2):
    """B (token-major attention over a key mask): QK^T and PV per kept key;
    q, o and the mask once each, k and v of the kept keys."""
    return 4.0 * lq * c * kept, (2 * b * lq + 2 * kept) * c * itemsize + b * lk * 4


def attention_backward_work(b, h, lq, lk, d, kept=None):
    """F (copied from chip_smoke ``_bwd_work``): (dK/dV operations, dQ
    operations, dK/dV bytes, dQ bytes) of the flash backward over the keys
    a [b, lk] mask keeps (``kept``, all without one): 4 or 3 products of
    2 Lq D per kept key and head; each input read once and each gradient
    written once."""
    mask_bytes = 0 if kept is None else b * lk * 4
    kept = b * lk if kept is None else kept
    product = 2.0 * h * lq * d * kept
    reads = (2 * b * h * lq * d + 2 * h * kept * d) * 2 + 2 * b * h * lq * 4 + mask_bytes
    return 4 * product, 3 * product, reads + 2 * b * h * lk * d * 2, reads + b * h * lq * d * 2


def w8a8_matmul_work(m, k, n):
    """H: int8 rows [m, k] (f32 scale each) times int8 weights [n, k] (f32
    scale each) plus a bf16 bias, into bf16 [m, n]."""
    return 2.0 * m * n * k, m * k + 4 * m + n * k + 4 * n + 2 * n + 2 * m * n


def row_quant_work(m, k, extra_vectors=0):
    """I, J and K: bf16 rows [m, k] read once, their int8 and f32 scales
    written once (J also reads its modulation vectors, ``extra_vectors`` of
    width k)."""
    return 0.0, 2 * m * k + 2 * extra_vectors * k + m * k + 4 * m


def conv_levels_work(numel, positions, padded_channels):
    """L1: a bf16 activation read once, its int8 levels written once
    channels-last with the channels padded."""
    return 0.0, 2 * numel + positions * padded_channels


def conv_int8_work(positions_in, padded_channels, m, n, k, weight_numel):
    """L2 (copied from chip_smoke ``_conv_work``): the levels, the stored
    weight, its scales and bias read once, the bf16 output written once."""
    return 2.0 * m * n * k, positions_in * padded_channels + weight_numel + 4 * n + 2 * (n + m * n)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@dataclass
class Work:
    """Operations by the type they run in, and least seconds by layer."""

    ops: Dict[str, float] = field(default_factory=lambda: {"bf16": 0.0, "int8": 0.0})
    least: Dict[str, float] = field(default_factory=dict)

    def add(self, kind: str, ops: float) -> None:
        self.ops[kind] += ops

    def add_least(self, layer: str, seconds: float) -> None:
        self.least[layer] = self.least.get(layer, 0.0) + seconds

    def scaled(self, k: float) -> "Work":
        return Work({a: v * k for a, v in self.ops.items()},
                    {a: v * k for a, v in self.least.items()})

    def merged(self, other: "Work") -> "Work":
        out = Work(dict(self.ops), dict(self.least))
        for a, v in other.ops.items():
            out.ops[a] = out.ops.get(a, 0.0) + v
        for a, v in other.least.items():
            out.add_least(a, v)
        return out

    def model_least_s(self, peaks) -> float:
        return self.ops["bf16"] / peaks[0] + self.ops["int8"] / peaks[2]


def dit_forward_work(cfg: dict, batch: int, tokens: int, caption: int, kept: float,
                     int8: bool, peaks) -> Work:
    """One DiT forward over ``batch`` x ``tokens`` latent tokens (the
    caption projection and the cross-attention k / v are made once per
    video: :func:`dit_video_work`). ``kept``: caption tokens the mask keeps,
    summed over the batch. With ``int8`` the eight block linears run W8A8:
    H for each, J before the q/k/v and FF-in products, I before to_out and
    the cross-attention's q and out, K before FF-out."""
    c = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    heads, d = cfg["num_attention_heads"], cfg["attention_head_dim"]
    ff = c * cfg.get("ff_mult", 4)
    layers = cfg["num_layers"]
    m = batch * tokens
    w = Work()
    block = {"attn1.to_q": (c, c), "attn1.to_k": (c, c), "attn1.to_v": (c, c),
             "attn1.to_out": (c, c), "attn2.to_q": (c, c), "attn2.to_out": (c, c),
             "ff.proj_in": (c, ff), "ff.proj_out": (ff, c)}
    kind = "int8" if int8 else "bf16"
    for k_in, n_out in block.values():
        w.add(kind, layers * 2.0 * m * k_in * n_out)
    # patchify and output projections
    w.add("bf16", 2.0 * m * cfg["in_channels"] * c + 2.0 * m * c * cfg["out_channels"])
    self_ops, self_bytes = attention_work(batch, heads, tokens, tokens, d)
    cross_ops, cross_bytes = token_work(batch, tokens, kept, caption, c)
    w.add("bf16", layers * (self_ops + cross_ops))
    if peaks is not None:
        bf, mem, i8 = peaks
        w.add_least("attention", layers * (least_s(self_ops, self_bytes, bf, mem)
                                           + least_s(cross_ops, cross_bytes, bf, mem)))
        if int8:
            per_layer = sum(least_s(*w8a8_matmul_work(m, k_in, n_out), i8, mem)
                            for k_in, n_out in block.values())
            per_layer += 2 * least_s(*row_quant_work(m, c, 2), bf, mem)  # J
            per_layer += 3 * least_s(*row_quant_work(m, c), bf, mem)  # I
            per_layer += least_s(*row_quant_work(m, ff), bf, mem)  # K
            w.add_least("int8", layers * per_layer)
    return w


def dit_video_work(cfg: dict, batch: int, tokens: int, caption: int, kept: float,
                   steps: int, int8: bool, peaks) -> Work:
    """A whole walk of ``steps`` forwards, plus the caption projection and
    every block's cross-attention k / v, made once."""
    c = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    w = dit_forward_work(cfg, batch, tokens, caption, kept, int8, peaks).scaled(steps)
    m = batch * caption
    w.add("bf16", 2.0 * m * cfg["caption_channels"] * c + 2.0 * m * c * c
          + cfg["num_layers"] * 2 * 2.0 * m * c * c)
    return w


class _Recording:
    """A :class:`reference.ltxv.Precision` stand-in that records each
    convolution's shapes on the meta device."""

    def __init__(self, vae_int8_min: Optional[int]):
        self.vae_int8_min = vae_int8_min
        self.convs = []

    def conv3d(self, p, x, stride, padding):
        w = p["weight"]
        self.convs.append((tuple(x.shape), tuple(w.shape), tuple(stride), tuple(padding)))
        return torch.nn.functional.conv3d(x, torch.empty(w.shape, device="meta"),
                                          stride=stride, padding=padding)

    def linear(self, p, x, int8_site=False):
        w = p["weight"]
        return torch.empty(*x.shape[:-1], w.shape[0], device="meta")


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    return torch.empty(tree.shape, device="meta") if torch.is_tensor(tree) else tree


def vae_work(vae_params, vae_cfg: dict, media_shapes, latent_shape, int8_min: Optional[int],
             peaks) -> Work:
    """The VAE's convolutions: an encode of each [B, F, H, W, 3] in
    ``media_shapes`` and a decode of ``latent_shape``. A W8A8 conv (weight
    of at least ``int8_min`` elements) counts as int8 with L1's and L2's
    least times; every other as bf16."""
    from benchmark.reference import ltxv

    meta = _meta(vae_params)
    rec = _Recording(int8_min)
    ts, ss = ltxv.vae_scales(vae_cfg)
    for shape in media_shapes:
        lat = (shape[0], (shape[1] - 1) // ts + 1, shape[2] // ss, shape[3] // ss,
               vae_cfg["latent_channels"])
        ltxv.vae_encode(meta, vae_cfg, torch.empty(shape, device="meta"),
                        torch.empty(lat, device="meta"), rec)
    ltxv.vae_decode(meta, vae_cfg, torch.empty(latent_shape, device="meta"),
                    torch.empty(latent_shape[0], device="meta"), rec)
    w = Work()
    for x_shape, w_shape, stride, padding in rec.convs:
        b, cin, f, h, wd = x_shape
        n, _, kt, kh, kw = w_shape
        fo = (f + 2 * padding[0] - kt) // stride[0] + 1
        ho = (h + 2 * padding[1] - kh) // stride[1] + 1
        wo = (wd + 2 * padding[2] - kw) // stride[2] + 1
        m, k = b * fo * ho * wo, kt * kh * kw * cin
        ops = 2.0 * m * n * k
        quantized = int8_min is not None and n * cin * kt * kh * kw >= int8_min
        w.add("int8" if quantized else "bf16", ops)
        if quantized and peaks is not None:
            bf, mem, i8 = peaks
            cp = -(-cin // 32) * 32
            positions = b * f * h * wd
            w.add_least("int8", least_s(*conv_levels_work(b * cin * f * h * wd, positions, cp),
                                        bf, mem))
            w.add_least("int8", least_s(*conv_int8_work(positions, cp, m, n, k,
                                                        n * kt * kh * kw * cp), i8, mem))
    return w


def dit_train_micro_work(cfg: dict, batch: int, tokens: int, caption: int, kept: float,
                         trained_attention: bool, peaks) -> Work:
    """One micro-step of "full" fine-tuning, as the algorithm needs it, with
    no recompute: the forward (every product, the cross-attention k / v of
    the caption and the caption projection included), dX through every
    product on the way back to the trained leaves, dW of the trained
    products (attention, AdaLN, output and caption projections; the
    feed-forward and the patchify projection are frozen), and attention's
    forward and backward (its backward twice the forward's products: dV,
    dP, dQ, dK)."""
    c = cfg["num_attention_heads"] * cfg["attention_head_dim"]
    heads, d, layers = cfg["num_attention_heads"], cfg["attention_head_dim"], cfg["num_layers"]
    ff = c * cfg.get("ff_mult", 4)
    m, mc = batch * tokens, batch * caption
    w = Work()
    block_tok = 6 * c * c + 2 * c * ff  # per latent token, per layer
    cross_kv = 2 * c * c  # per caption token, per layer
    caption_proj = cfg["caption_channels"] * c + c * c
    out_proj = c * cfg["out_channels"]
    fwd = 2.0 * (m * (layers * block_tok + cfg["in_channels"] * c + out_proj)
                 + mc * (layers * cross_kv + caption_proj))
    dx = 2.0 * (m * (layers * block_tok + out_proj) + mc * (layers * cross_kv + c * c))
    dw = 2.0 * (m * (layers * 6 * c * c + out_proj) + mc * (layers * cross_kv + caption_proj))
    w.add("bf16", fwd + dx + (dw if trained_attention else 0.0))
    self_ops, self_bytes = attention_work(batch, heads, tokens, tokens, d)
    cross_ops, cross_bytes = token_work(batch, tokens, kept, caption, c)
    w.add("bf16", 3 * layers * (self_ops + cross_ops))
    if peaks is not None:
        bf, mem, _ = peaks
        sk, sq, skb, sqb = attention_backward_work(batch, heads, tokens, tokens, d)
        ck, cq, ckb, cqb = attention_backward_work(batch, heads, tokens, caption, d, kept)
        per_layer = (least_s(self_ops, self_bytes, bf, mem) + least_s(cross_ops, cross_bytes, bf, mem)
                     + least_s(sk, skb, bf, mem) + least_s(sq, sqb, bf, mem)
                     + least_s(ck, ckb, bf, mem) + least_s(cq, cqb, bf, mem))
        w.add_least("attention", layers * per_layer)
    return w
