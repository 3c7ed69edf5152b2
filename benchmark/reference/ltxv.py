"""Plain LTX-Video 2B in float32: the DiT, the causal video VAE and the
avatar pipeline's sampling walk, written from the published architecture
(Lightricks/LTX-Video, ``ltxv-2b-0.9.6``) with plain ``torch`` operations.

It imports nothing of the program under test. It reads the weight tree the
benchmark made (``benchmark/weights.py``), in the published, unpermuted
layout, and works out itself whatever the program derives from it at
set-up: the int8 levels and scales of a W8A8 configuration.

Every product goes through a :class:`Precision`: ``f32`` computes in
float32 with TF32 off; ``w8a8`` rounds the operands of the configuration's
int8 products to their int8 levels (per-token activations and per-channel
weights in the DiT's eight block linears, a per-tensor activation and
per-channel weights in the VAE's large convolutions) and multiplies the
levels in float32; ``fp8`` and ``int4`` are the controls: the same
products with every operand rounded to float8 e4m3 (per-tensor scale) or
to int4 levels.

Two departures from a float32 run of the published model follow the
configured working type, bf16, as the upstream pipeline does in it: the
sigma levels of the schedule, and the timestep that the AdaLN embedding
sees (sigma x 1000), are rounded to bf16.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Precision of the products
# ---------------------------------------------------------------------------

DIT_INT8_LINEARS = frozenset({
    ("attn1", "to_q"), ("attn1", "to_k"), ("attn1", "to_v"), ("attn1", "to_out"),
    ("attn2", "to_q"), ("attn2", "to_out"), ("ff", "proj_in"), ("ff", "proj_out"),
})


def _levels(x: torch.Tensor, amax: torch.Tensor, top: int) -> torch.Tensor:
    """Symmetric levels of ``x`` at ``top`` (127 for int8, 7 for int4),
    scale ``amax / top`` (1 where amax is 0), rounded half to even:
    (levels, scale)."""
    scale = amax / top
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(torch.round(x / scale), -top, top), scale


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale; a gradient
    passes the rounding unchanged."""
    with torch.no_grad():
        s = x.abs().amax().clamp_min(1e-30) / 448.0
        q = (x / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach() if x.requires_grad else q


class Precision:
    """How the reference rounds the operands of its products.

    ``mode``: "f32", "w8a8" (the configuration's int8 products), "fp8" or
    "int4" (controls). ``dit_int8`` and ``vae_int8_min`` say which products
    a W8A8 configuration makes int8: the DiT's block linears named in
    :data:`DIT_INT8_LINEARS`, and every VAE conv whose weight has at least
    ``vae_int8_min`` elements (None: none)."""

    def __init__(self, mode: str = "f32", dit_int8: bool = False,
                 vae_int8_min: Optional[int] = None):
        if mode not in ("f32", "w8a8", "fp8", "int4"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode, self.dit_int8, self.vae_int8_min = mode, dit_int8, vae_int8_min

    def _int_top(self, quantized: bool) -> Optional[int]:
        if self.mode == "w8a8" and quantized:
            return 127
        if self.mode == "int4" and quantized:
            return 7
        return None

    def linear(self, p: dict, x: torch.Tensor, int8_site: bool = False) -> torch.Tensor:
        """x [.., in] @ weight [out, in]^T + bias, in float32."""
        w = p["weight"].float()
        b = p.get("bias")
        top = self._int_top(int8_site and self.dit_int8)
        if top is not None:
            xl, xs = _levels(x, x.abs().amax(-1, keepdim=True), top)
            wl, ws = _levels(w, w.abs().amax(1, keepdim=True), top)
            out = (xl @ wl.t()) * xs * ws.reshape(-1)
        elif self.mode == "fp8":
            out = _fp8(x) @ _fp8(w).t()
        else:
            out = x @ w.t()
        return out if b is None else out + b.float()

    def conv3d(self, p: dict, x: torch.Tensor, stride, padding) -> torch.Tensor:
        w = p["weight"].float()
        b = p.get("bias")
        quantized = self.vae_int8_min is not None and w.numel() >= self.vae_int8_min
        top = self._int_top(quantized)
        if top is not None:
            xl, xs = _levels(x, x.abs().amax(), top)
            wl, ws = _levels(w, w.abs().amax(dim=(1, 2, 3, 4), keepdim=True), top)
            out = F.conv3d(xl, wl, stride=stride, padding=padding)
            out = out * (xs * ws.reshape(1, -1, 1, 1, 1))
        elif self.mode == "fp8":
            out = F.conv3d(_fp8(x), _fp8(w), stride=stride, padding=padding)
        else:
            out = F.conv3d(x, w, stride=stride, padding=padding)
        return out if b is None else out + b.float().reshape(1, -1, 1, 1, 1)


def strict_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def bf16_round(x, dtype=torch.bfloat16):
    """``x`` rounded to the working type ``dtype``, as float32."""
    return torch.as_tensor(x, dtype=torch.float32).to(dtype).float()


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def rms_norm(x, eps, scale=None):
    out = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return out if scale is None else out * scale.float()


def layer_norm(x, eps, dim=-1):
    mean = x.mean(dim, keepdim=True)
    var = (x - mean).square().mean(dim, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def timestep_embedding(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """Sinusoidal embedding, cos first (flip_sin_to_cos), max period 1e4."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
    arg = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def timestep_mlp(p, t, prec):
    h = F.silu(prec.linear(p["linear_1"], timestep_embedding(t)))
    return prec.linear(p["linear_2"], h)


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------


def rope_tables(coords: torch.Tensor, dim: int, theta: float, max_pos):
    """(cos, sin) [B, N, dim] of the 3D RoPE, interleaved pairs, for pixel
    coordinates [B, 3, N] whose time axis is already in seconds."""
    frac = torch.stack([coords[:, i] / max_pos[i] for i in range(3)], dim=-1)
    n = dim // 6
    base = theta ** torch.linspace(0.0, 1.0, n, device=coords.device) * (math.pi / 2)
    freqs = base[None, None, None] * (frac[..., None] * 2 - 1)  # [B, N, 3, n]
    freqs = freqs.transpose(-1, -2).reshape(*freqs.shape[:2], -1)
    cos = torch.cos(freqs).repeat_interleave(2, -1)
    sin = torch.sin(freqs).repeat_interleave(2, -1)
    pad = dim % 6
    if pad:
        cos = torch.cat([torch.ones_like(cos[..., :pad]), cos], -1)
        sin = torch.cat([torch.zeros_like(sin[..., :pad]), sin], -1)
    return cos, sin


def rotate(x, cos, sin):
    rot = torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).reshape(x.shape)
    return x * cos + rot * sin


def attention(q, k, v, heads, kv_mask=None, head_chunk=8):
    """Softmax attention over [B, L, heads * d] tensors; keys whose
    ``kv_mask`` [B, Lk] entry is 0 get no weight."""
    b, lq, c = q.shape
    d = c // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2)
    kh = k.reshape(b, -1, heads, d).transpose(1, 2)
    vh = v.reshape(b, -1, heads, d).transpose(1, 2)
    out = torch.empty_like(qh)
    bias = None
    if kv_mask is not None:
        bias = torch.where(kv_mask[:, None, None] > 0.5, 0.0, float("-inf"))
    for h0 in range(0, heads, head_chunk):
        hs = slice(h0, h0 + head_chunk)
        s = qh[:, hs] @ kh[:, hs].transpose(-1, -2) * d**-0.5
        if bias is not None:
            s = s + bias
        out[:, hs] = torch.softmax(s, dim=-1) @ vh[:, hs]
    return out.transpose(1, 2).reshape(b, lq, c)


def caption_kv(P, cfg, embeds, prec):
    """The projected caption and each block's cross-attention (k, v)."""
    cap = P["caption_projection"]
    e = F.gelu(prec.linear(cap["linear_1"], embeds), approximate="tanh")
    e = prec.linear(cap["linear_2"], e)
    kv = []
    for blk in P["blocks"]:
        a2 = blk["attn2"]
        k = rms_norm(prec.linear(a2["to_k"], e), 1e-5, a2["k_norm"]["scale"])
        kv.append((k, prec.linear(a2["to_v"], e)))
    return kv


def dit_forward(P, cfg, tokens, rope, t_model, kv, kv_mask, prec):
    """Velocity [B, N, out] of the DiT at model timestep ``t_model`` [B]
    (sigma x 1000); ``rope`` the (cos, sin) tables, ``kv`` from
    :func:`caption_kv`."""
    heads, inner = cfg["num_attention_heads"], cfg["num_attention_heads"] * cfg["attention_head_dim"]
    eps = cfg["norm_eps"]
    x = prec.linear(P["patchify_proj"], tokens)
    emb = timestep_mlp(P["adaln_single"]["emb"], t_model, prec)  # [B, inner]
    ada = prec.linear(P["adaln_single"]["linear"], F.silu(emb))  # [B, 6 inner]
    cos, sin = rope
    for blk, (k2, v2) in zip(P["blocks"], kv, strict=True):
        m = blk["scale_shift_table"].float()[None] + ada.reshape(-1, 6, inner)
        shift1, scale1, gate1, shift2, scale2, gate2 = (m[:, i, None] for i in range(6))
        a1 = blk["attn1"]
        h = rms_norm(x, eps) * (1 + scale1) + shift1
        q = rms_norm(prec.linear(a1["to_q"], h, True), 1e-5, a1["q_norm"]["scale"])
        k = rms_norm(prec.linear(a1["to_k"], h, True), 1e-5, a1["k_norm"]["scale"])
        v = prec.linear(a1["to_v"], h, True)
        o = attention(rotate(q, cos, sin), rotate(k, cos, sin), v, heads)
        x = x + gate1 * prec.linear(a1["to_out"], o, True)
        a2 = blk["attn2"]
        q = rms_norm(prec.linear(a2["to_q"], x, True), 1e-5, a2["q_norm"]["scale"])
        x = x + prec.linear(a2["to_out"], attention(q, k2, v2, heads, kv_mask), True)
        h = rms_norm(x, eps) * (1 + scale2) + shift2
        h = F.gelu(prec.linear(blk["ff"]["proj_in"], h, True), approximate="tanh")
        x = x + gate2 * prec.linear(blk["ff"]["proj_out"], h, True)
    m = P["scale_shift_table"].float()[None] + emb[:, None]
    x = layer_norm(x, 1e-6) * (1 + m[:, 1, None]) + m[:, 0, None]
    return prec.linear(P["proj_out"], x)


# ---------------------------------------------------------------------------
# VAE (NCDHW inside)
# ---------------------------------------------------------------------------

_UP = {"compress_all": (2, 2, 2), "compress_space": (1, 2, 2), "compress_time": (2, 1, 1)}


def pixel_norm(x):
    return x * torch.rsqrt((x * x).mean(1, keepdim=True) + 1e-8)


def conv(p, x, prec, causal, stride=(1, 1, 1)):
    """3D conv with a temporal pad of repeated edge frames (causal: the
    first frame kt - 1 times in front; else (kt - 1) / 2 at each end) and
    a spatial zero pad of half the kernel."""
    kt, kh, kw = p["weight"].shape[2:]
    if kt > 1:
        if causal:
            x = torch.cat([x[:, :, :1]] * (kt - 1) + [x], dim=2)
        else:
            half = (kt - 1) // 2
            x = torch.cat([x[:, :, :1]] * half + [x] + [x[:, :, -1:]] * half, dim=2)
    return prec.conv3d(p, x, stride, (0, kh // 2, kw // 2))


def _chan(t):
    return t[:, :, None, None, None]


def resnet(p, x, prec, causal, temb=None):
    h = pixel_norm(x)
    if temb is not None:
        c = x.shape[1]
        m = p["scale_shift_table"].float()[None] + temb.reshape(x.shape[0], 4, c)
        h = h * (1 + _chan(m[:, 1])) + _chan(m[:, 0])
    h = conv(p["conv1"], F.silu(h), prec, causal)
    h = pixel_norm(h)
    if temb is not None:
        h = h * (1 + _chan(m[:, 3])) + _chan(m[:, 2])
    h = conv(p["conv2"], F.silu(h), prec, causal)
    short = x
    if "norm3" in p:
        short = layer_norm(short, 1e-6, dim=1) * _chan(p["norm3"]["scale"].float()[None]) \
            + _chan(p["norm3"]["bias"].float()[None])
    if "conv_shortcut" in p:
        w = p["conv_shortcut"]["weight"].float()
        short = torch.einsum("oc,bcfhw->bofhw", w, short) + _chan(
            p["conv_shortcut"]["bias"].float()[None])
    return short + h


def mid_block(p, x, prec, causal, t=None):
    temb = None
    if "time_embedder" in p and t is not None:
        temb = timestep_mlp(p["time_embedder"], t, prec)
    for res in p["res_blocks"]:
        x = resnet(res, x, prec, causal, temb)
    return x


def shuffle(x, f):
    """[B, C p1 p2 p3, F, H, W] -> [B, C, F p1, H p2, W p3] (c-major)."""
    b, c, fr, h, w = x.shape
    p1, p2, p3 = f
    x = x.reshape(b, c // (p1 * p2 * p3), p1, p2, p3, fr, h, w)
    return x.permute(0, 1, 5, 2, 6, 3, 7, 4).reshape(b, -1, fr * p1, h * p2, w * p3)


def patchify_pixels(x, p):
    """[B, C, F, H p, W p] -> [B, C p p, F, H, W], channel order (c, w-sub,
    h-sub) as the published VAE orders it."""
    b, c, f, h, w = x.shape
    x = x.reshape(b, c, f, h // p, p, w // p, p)
    return x.permute(0, 1, 6, 4, 2, 3, 5).reshape(b, c * p * p, f, h // p, w // p)


def unpatchify_pixels(x, p):
    b, cpp, f, h, w = x.shape
    c = cpp // (p * p)
    x = x.reshape(b, c, p, p, f, h, w)  # (c, w-sub, h-sub)
    return x.permute(0, 1, 4, 5, 3, 6, 2).reshape(b, c, f, h * p, w * p)


def vae_scales(vcfg) -> tuple:
    """(temporal, spatial) downscale of the VAE: 2 per compressing block on
    each axis it compresses, times the pixel patch on the spatial axes."""
    names = [n for n, _ in _blocks(vcfg, "encoder_blocks")]
    t = 2 ** sum(n in ("compress_all", "compress_time") for n in names)
    s = 2 ** sum(n in ("compress_all", "compress_space") for n in names)
    return t, s * vcfg["patch_size"]


def _blocks(vcfg, key):
    return [(n, {"num_layers": a} if isinstance(a, int) else dict(a))
            for n, a in vcfg.get(key, vcfg["blocks"])]


def vae_encode(P, vcfg, media, noise, prec):
    """Pixels [B, F, H, W, 3] in [-1, 1] -> per-channel normalized latents
    [B, F', H', W', C], the posterior sampled with ``noise``."""
    E = P["encoder"]
    x = patchify_pixels(media.float().permute(0, 4, 1, 2, 3), vcfg["patch_size"])
    x = conv(E["conv_in"], x, prec, True)
    for blk, (name, a) in zip(E["blocks"], _blocks(vcfg, "encoder_blocks"), strict=True):
        if name == "res_x":
            x = mid_block(blk, x, prec, True)
        elif name == "res_x_y":
            x = resnet(blk, x, prec, True)
        elif name in _UP:
            x = conv(blk, x, prec, True, stride=_UP[name])
        else:
            raise ValueError(name)
    x = conv(E["conv_out"], F.silu(pixel_norm(x)), prec, True)
    c = vcfg["latent_channels"]
    mean, logvar = x[:, :c], x[:, c:c + 1]
    z = mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise.float().permute(0, 4, 1, 2, 3)
    stats = P["per_channel_statistics"]
    z = (z - _chan(stats["mean_of_means"].float()[None])) / _chan(
        stats["std_of_means"].float()[None])
    return z.permute(0, 2, 3, 4, 1)


def vae_decode(P, vcfg, latents, t, prec):
    """Normalized latents [B, F', H', W', C] at decode timestep ``t`` [B]
    -> pixels [B, F, H, W, 3] (unclamped, about [-1, 1])."""
    D = P["decoder"]
    stats = P["per_channel_statistics"]
    z = latents.float().permute(0, 4, 1, 2, 3)
    z = z * _chan(stats["std_of_means"].float()[None]) + _chan(stats["mean_of_means"].float()[None])
    causal = vcfg.get("causal_decoder", False)
    x = conv(D["conv_in"], z, prec, causal)
    st = t.float() * D["timestep_scale_multiplier"].float()
    for blk, (name, a) in zip(D["blocks"], reversed(_blocks(vcfg, "decoder_blocks")),
                              strict=True):
        if name == "res_x":
            x = mid_block(blk, x, prec, causal, st)
        elif name == "res_x_y":
            x = resnet(blk, x, prec, causal)
        elif name in _UP:
            stride = _UP[name]
            x = shuffle(conv(blk["conv"], x, prec, causal), stride)
            if stride[0] == 2:
                x = x[:, :, 1:]
        else:
            raise ValueError(name)
    x = pixel_norm(x)
    emb = timestep_mlp(D["last_time_embedder"], st, prec)
    c = x.shape[1]
    m = D["last_scale_shift_table"].float()[None] + emb.reshape(x.shape[0], 2, c)
    x = x * (1 + _chan(m[:, 1])) + _chan(m[:, 0])
    x = conv(D["conv_out"], F.silu(x), prec, causal)
    return unpatchify_pixels(x, vcfg["patch_size"]).permute(0, 2, 3, 4, 1)


def rgb_to_i420(rgb01: torch.Tensor) -> torch.Tensor:
    """[.., F, H, W, 3] in [0, 1] -> [.., F, H 3/2, W] uint8 I420, with
    OpenCV's BT.601 studio-swing coefficients and chroma from the top-left
    sample of each 2 x 2 block."""
    x = rgb01.float() * 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.256788 * r + 0.504129 * g + 0.097906 * b + 16.0
    u = -0.148223 * r - 0.290993 * g + 0.439216 * b + 128.0
    v = 0.439216 * r - 0.367788 * g - 0.071427 * b + 128.0
    *lead, h, w = y.shape
    planes = torch.cat([y, u[..., 0::2, 0::2].reshape(*lead, h // 4, w),
                        v[..., 0::2, 0::2].reshape(*lead, h // 4, w)], dim=-2)
    return torch.clamp(planes + 0.5, 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# Schedule and the avatar pipeline
# ---------------------------------------------------------------------------


def sigmas(steps: int, tokens: int, terminal: float = 0.1) -> np.ndarray:
    """The rectified-flow schedule: uniform levels 1 .. 1/steps, shifted by
    the SD3 rule for ``tokens`` latent tokens (mu linear in the tokens from
    0.95 at 1024 to 2.05 at 4096) and stretched so the last level is
    ``terminal``."""
    t = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    mu = (2.05 - 0.95) / (4096 - 1024) * tokens + (0.95 - (2.05 - 0.95) / 3072 * 1024)
    s = math.exp(mu) / (math.exp(mu) + (1.0 / t - 1.0))
    one_minus = 1.0 - s
    return 1.0 - one_minus / (one_minus[-1] / (1.0 - terminal))


def avatar_lerp(lat, ref_lat, pose_lat, ref_w=0.85, pose_w=0.5):
    """Frame 0 toward the reference latents, frames 1+ toward the pose
    latents: the model's input, not its state."""
    f0 = lat[:, :1] + ref_w * (ref_lat - lat[:, :1])
    rest = lat[:, 1:] + pose_w * (pose_lat[:, 1:] - lat[:, 1:])
    return torch.cat([f0, rest], dim=1)


def generate(dit_params, dit_cfg, vae_params, vae_cfg, *, embeds, mask, ref_lat, pose_lat,
             init_noise, decode_noise, steps, frame_rate, decode_timestep,
             decode_noise_scale, prec: Precision,
             working_dtype=torch.bfloat16) -> torch.Tensor:
    """One batch of avatar videos at guidance 1: I420 uint8 [B, F, H 3/2, W].

    ``init_noise`` [B, F', H', W', C] starts the walk; ``ref_lat`` and
    ``pose_lat`` are the encoded avatar media; ``decode_noise`` is mixed
    into the final latents by ``decode_noise_scale`` before the decode at
    ``decode_timestep``. The sigma levels and the model's timestep are
    rounded to ``working_dtype``."""
    b, fl, hl, wl, c = init_noise.shape
    n = fl * hl * wl
    dev = init_noise.device
    grid = torch.stack(torch.meshgrid(torch.arange(fl, device=dev), torch.arange(hl, device=dev),
                                      torch.arange(wl, device=dev), indexing="ij")).reshape(3, -1)
    ts, ss = vae_scales(vae_cfg)
    coords = grid[None].float() * torch.tensor([ts, ss, ss], dtype=torch.float32,
                                               device=dev)[None, :, None]
    coords[:, 0] = coords[:, 0] * (1.0 / frame_rate)
    rope = rope_tables(coords.expand(b, -1, -1), dit_cfg["num_attention_heads"]
                       * dit_cfg["attention_head_dim"], dit_cfg["positional_embedding_theta"],
                       dit_cfg["positional_embedding_max_pos"])
    kv = caption_kv(dit_params, dit_cfg, embeds.float(), prec)
    levels = bf16_round(np.append(sigmas(steps, n), 0.0), working_dtype).to(dev)
    lat = init_noise.float()
    for i in range(steps):
        t_model = bf16_round(levels[i] * 1000.0, working_dtype).expand(b)
        x_in = avatar_lerp(lat, ref_lat.float(), pose_lat.float()).reshape(b, n, c)
        v = dit_forward(dit_params, dit_cfg, x_in, rope, t_model, kv, mask.float(), prec)
        lat = lat - (levels[i] - levels[i + 1]) * v.reshape(lat.shape)
    lat = lat * (1 - decode_noise_scale) + decode_noise.float() * decode_noise_scale
    t = torch.full((b,), float(decode_timestep), device=dev)
    pixels = vae_decode(vae_params, vae_cfg, lat, t, prec)
    return rgb_to_i420(torch.clamp(pixels * 0.5 + 0.5, 0.0, 1.0))


def video_gap(out_u8: torch.Tensor, ref_u8: torch.Tensor) -> float:
    """RMS of the difference of two I420 videos, in 8-bit levels."""
    return float((out_u8.float() - ref_u8.to(out_u8.device).float()).square().mean().sqrt())
