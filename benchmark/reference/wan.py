"""Plain Wan2.1-I2V in float32: the DiT (``WanModel``, i2v), the causal
video VAE (``WanVAE_``) and the image-to-video walk, written from the
published code (github.com/Wan-Video/Wan2.1: ``wan/modules/model.py``,
``wan/modules/vae.py``, ``wan/image2video.py``) with plain ``torch``
operations.

It imports nothing of the program under test. It reads the weight tree the
benchmark made, in the published layout (the state dict's names, nested;
interleaved RoPE pairs, q / k rows unpermuted), and computes in float32
with TF32 off (:func:`ltxv.strict_f32`). Every DiT linear goes through a
``ltxv.Precision``: ``f32``, or ``fp8`` for the control (both operands of
each DiT linear rounded to float8 e4m3 under one per-tensor scale).

Departures from the published code, which the configuration file lists:
RoPE rotates in float32 where the published code rotates in float64; the
sampler is Euler over the published shifted schedule where the published
default is UniPC; the latent mean and std of the VAE are 0 and 1.
Attention is computed over chunks of queries and heads, so that a
32,760-token self-attention fits the card.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from benchmark.reference.ltxv import Precision, rgb_to_i420, strict_f32, video_gap  # noqa: F401

CACHE_T = 2

# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------


def _f(t):
    return t.float()


def rms(x, weight, eps):
    """``WanRMSNorm``: x rsqrt(mean x^2 + eps) weight."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * _f(weight)


def layer_norm(x, eps, p=None):
    return F.layer_norm(x, (x.shape[-1],), None if p is None else _f(p["weight"]),
                        None if p is None else _f(p["bias"]), eps)


def attention(q, k, v, heads, q_chunk=4096, head_chunk=8):
    """softmax(q k^T / sqrt(d)) v over [B, L, heads d], in chunks of
    queries and heads."""
    b, lq, c = q.shape
    d = c // heads
    qh = q.reshape(b, lq, heads, d).transpose(1, 2)
    kh = k.reshape(b, -1, heads, d).transpose(1, 2)
    vh = v.reshape(b, -1, heads, d).transpose(1, 2)
    out = torch.empty_like(qh)
    for h0 in range(0, heads, head_chunk):
        hs = slice(h0, h0 + head_chunk)
        for q0 in range(0, lq, q_chunk):
            qs = slice(q0, q0 + q_chunk)
            s = qh[:, hs, qs] @ kh[:, hs].transpose(-1, -2) * d**-0.5
            out[:, hs, qs] = torch.softmax(s, dim=-1) @ vh[:, hs]
    return out.transpose(1, 2).reshape(b, lq, c)


def rope_freqs(head_dim: int, max_len: int = 1024, theta: float = 10000.0):
    """The published ``freqs``: [max_len, head_dim / 2] complex, three
    bands of d - 4 (d // 6), 2 (d // 6) and 2 (d // 6) channels."""
    def params(dim):
        f = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
        ang = torch.outer(torch.arange(max_len, dtype=torch.float64), f)
        return torch.polar(torch.ones_like(ang), ang)

    d = head_dim
    return torch.cat([params(d - 4 * (d // 6)), params(2 * (d // 6)), params(2 * (d // 6))],
                     dim=1)


def rope_apply(x, grid, freqs, heads):
    """``rope_apply`` in float32: x [B, L, heads d] as complex pairs
    (2i, 2i + 1) of each head times the frame / row / column bands."""
    b, seq, c = x.shape
    d = c // heads
    half = d // 2
    f, h, w = grid
    parts = freqs.split([half - 2 * (half // 3), half // 3, half // 3], dim=1)
    fr = torch.cat([parts[0][:f].view(f, 1, 1, -1).expand(f, h, w, -1),
                    parts[1][:h].view(1, h, 1, -1).expand(f, h, w, -1),
                    parts[2][:w].view(1, 1, w, -1).expand(f, h, w, -1)],
                   dim=-1).reshape(seq, 1, -1).to(torch.complex64).to(x.device)
    xc = torch.view_as_complex(x.float().reshape(b, seq, heads, half, 2).contiguous())
    return torch.view_as_real(xc * fr[None]).reshape(b, seq, c)


def sinusoid(t, dim):
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float64, device=t.device) / half)
    arg = torch.outer(t.double(), freqs)
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=1).float()


def context(P, cfg, text, clip, prec):
    """(text context [B, 512, dim], image context [B, 257, dim])."""
    te = P["text_embedding"]
    ctx = prec.linear(te["2"], F.gelu(prec.linear(te["0"], text.float()), approximate="tanh"))
    proj = P["img_emb"]["proj"]
    h = layer_norm(clip.float(), 1e-5, proj["0"])
    h = prec.linear(proj["3"], F.gelu(prec.linear(proj["1"], h)))
    return ctx, layer_norm(h, 1e-5, proj["4"])


def block(p, cfg, x, e0, grid, freqs, ctx, img, prec):
    heads, eps = cfg["num_heads"], cfg["eps"]
    m = (_f(p["modulation"]) + e0).chunk(6, dim=1)  # each [B, 1, dim]
    sa = p["self_attn"]
    h = layer_norm(x, eps) * (1 + m[1]) + m[0]
    q = rms(prec.linear(sa["q"], h), sa["norm_q"]["weight"], eps)
    k = rms(prec.linear(sa["k"], h), sa["norm_k"]["weight"], eps)
    v = prec.linear(sa["v"], h)
    y = attention(rope_apply(q, grid, freqs, heads), rope_apply(k, grid, freqs, heads), v, heads)
    x = x + prec.linear(sa["o"], y) * m[2]
    ca = p["cross_attn"]
    h = layer_norm(x, eps, p["norm3"])
    q = rms(prec.linear(ca["q"], h), ca["norm_q"]["weight"], eps)
    k = rms(prec.linear(ca["k"], ctx), ca["norm_k"]["weight"], eps)
    k_img = rms(prec.linear(ca["k_img"], img), ca["norm_k_img"]["weight"], eps)
    y = attention(q, k_img, prec.linear(ca["v_img"], img), heads)
    y = attention(q, k, prec.linear(ca["v"], ctx), heads) + y
    x = x + prec.linear(ca["o"], y)
    h = layer_norm(x, eps) * (1 + m[4]) + m[3]
    ff = p["ffn"]
    y = prec.linear(ff["2"], F.gelu(prec.linear(ff["0"], h), approximate="tanh"))
    return x + y * m[5]


def dit_forward(P, cfg, x_in, t, ctx, img, prec):
    """``WanModel.forward`` for one batch: x_in [B, 36, F, H, W] (latent,
    mask and y already concatenated), t [B] model timesteps, ctx / img from
    :func:`context`; returns the velocity [B, 16, F, H, W]."""
    dim, out_dim = cfg["dim"], cfg["out_dim"]
    pt, ph, pw = cfg["patch_size"]
    pe = P["patch_embedding"]
    x = F.conv3d(x_in.float(), _f(pe["weight"]), _f(pe["bias"]), stride=(pt, ph, pw))
    grid = tuple(x.shape[2:])
    x = x.flatten(2).transpose(1, 2)
    te = P["time_embedding"]
    e = prec.linear(te["2"], F.silu(prec.linear(te["0"], sinusoid(t, cfg["freq_dim"]))))
    e0 = prec.linear(P["time_projection"]["1"], F.silu(e)).unflatten(1, (6, dim))
    freqs = rope_freqs(dim // cfg["num_heads"])
    for p in P["blocks"]:
        x = block(p, cfg, x, e0, grid, freqs, ctx, img, prec)
    hd = P["head"]
    m = (_f(hd["modulation"]) + e[:, None]).chunk(2, dim=1)
    x = prec.linear(hd["head"], layer_norm(x, cfg["eps"]) * (1 + m[1]) + m[0])
    f, h, w = grid
    b = x.shape[0]
    x = x.view(b, f, h, w, pt, ph, pw, out_dim)
    x = torch.einsum("bfhwpqrc->bcfphqwr", x)
    return x.reshape(b, out_dim, f * pt, h * ph, w * pw)


# ---------------------------------------------------------------------------
# VAE (the published modules as functions; caches as the published lists)
# ---------------------------------------------------------------------------


def rms_c(p, x):
    """``RMS_norm``: F.normalize over channels, times sqrt(C) and gamma."""
    c = x.shape[1]
    g = _f(p["gamma"])
    return F.normalize(x, dim=1) * c**0.5 * g


def causal_conv(p, x, cache_x=None, stride=1, causal=True):
    """``CausalConv3d`` with padding kernel // 2 (``causal``: 2 (kt // 2)
    frames of zeros in front) or, for the downsampler's time conv, none."""
    w = _f(p["weight"])
    kt, kh, kw = w.shape[2:]
    pad_t = 2 * (kt // 2) if causal else 0
    padding = [kw // 2, kw // 2, kh // 2, kh // 2, pad_t, 0]
    if cache_x is not None and pad_t > 0:
        x = torch.cat([cache_x, x], dim=2)
        padding[4] -= cache_x.shape[2]
    return F.conv3d(F.pad(x, padding), w, _f(p["bias"]), stride=stride)


def _cached(p, x, feat_cache, feat_idx):
    idx = feat_idx[0]
    cache_x = x[:, :, -CACHE_T:].clone()
    if cache_x.shape[2] < 2 and feat_cache[idx] is not None:
        cache_x = torch.cat([feat_cache[idx][:, :, -1:], cache_x], dim=2)
    x = causal_conv(p, x, feat_cache[idx])
    feat_cache[idx] = cache_x
    feat_idx[0] += 1
    return x


def residual(p, x, feat_cache, feat_idx):
    h = causal_conv(p["shortcut"], x) if "shortcut" in p else x
    r = p["residual"]
    x = _cached(r["2"], F.silu(rms_c(r["0"], x)), feat_cache, feat_idx)
    x = _cached(r["6"], F.silu(rms_c(r["3"], x)), feat_cache, feat_idx)
    return x + h


def attn_block(p, x):
    identity = x
    b, c, t, h, w = x.shape
    x = x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h, w)
    x = rms_c(p["norm"], x)
    qkv = F.conv2d(x, _f(p["to_qkv"]["weight"]), _f(p["to_qkv"]["bias"]))
    q, k, v = qkv.reshape(b * t, 1, c * 3, -1).permute(0, 1, 3, 2).contiguous().chunk(3, dim=-1)
    s = q @ k.transpose(-1, -2) * c**-0.5
    x = torch.softmax(s, dim=-1) @ v
    x = x.squeeze(1).permute(0, 2, 1).reshape(b * t, c, h, w)
    x = F.conv2d(x, _f(p["proj"]["weight"]), _f(p["proj"]["bias"]))
    return x.reshape(b, t, c, h, w).permute(0, 2, 1, 3, 4) + identity


def resample(p, kind, x, feat_cache, feat_idx):
    b, c, t, h, w = x.shape
    if kind == "up3d":
        idx = feat_idx[0]
        if feat_cache[idx] is None:
            feat_cache[idx] = "Rep"
            feat_idx[0] += 1
        else:
            cache_x = x[:, :, -CACHE_T:].clone()
            rep = isinstance(feat_cache[idx], str)
            if cache_x.shape[2] < 2 and not rep:
                cache_x = torch.cat([feat_cache[idx][:, :, -1:], cache_x], dim=2)
            if cache_x.shape[2] < 2 and rep:
                cache_x = torch.cat([torch.zeros_like(cache_x), cache_x], dim=2)
            x = causal_conv(p["time_conv"], x, None if rep else feat_cache[idx])
            feat_cache[idx] = cache_x
            feat_idx[0] += 1
            x = x.reshape(b, 2, c, t, h, w)
            x = torch.stack((x[:, 0], x[:, 1]), 3).reshape(b, c, t * 2, h, w)
    t = x.shape[2]
    x = x.permute(0, 2, 1, 3, 4).reshape(-1, c, h, w)
    conv = p["resample"]["1"]
    if kind.startswith("up"):
        x = F.interpolate(x, scale_factor=(2.0, 2.0), mode="nearest-exact")
        x = F.conv2d(x, _f(conv["weight"]), _f(conv["bias"]), padding=1)
    else:
        x = F.conv2d(F.pad(x, (0, 1, 0, 1)), _f(conv["weight"]), _f(conv["bias"]), stride=2)
    x = x.reshape(b, t, x.shape[1], x.shape[2], x.shape[3]).permute(0, 2, 1, 3, 4)
    if kind == "down3d":
        idx = feat_idx[0]
        if feat_cache[idx] is None:
            feat_cache[idx] = x.clone()
            feat_idx[0] += 1
        else:
            cache_x = x[:, :, -1:].clone()
            x = causal_conv(p["time_conv"], torch.cat([feat_cache[idx][:, :, -1:], x], 2),
                            stride=(2, 1, 1), causal=False)
            feat_cache[idx] = cache_x
            feat_idx[0] += 1
    return x


def _layout(vcfg, decoder: bool) -> List[str]:
    n, down = len(vcfg["dim_mult"]), vcfg["temperal_downsample"]
    out = []
    for i in range(n):
        out += ["res"] * (vcfg["num_res_blocks"] + (1 if decoder else 0))
        if i != n - 1:
            if decoder:
                out.append("up3d" if down[::-1][i] else "up2d")
            else:
                out.append("down3d" if down[i] else "down2d")
    return out


def _middle(p, x, feat_cache, feat_idx):
    x = residual(p[0], x, feat_cache, feat_idx)
    x = attn_block(p[1], x)
    return residual(p[2], x, feat_cache, feat_idx)


def encoder(P, vcfg, x, feat_cache, feat_idx):
    x = _cached(P["conv1"], x, feat_cache, feat_idx)
    for p, kind in zip(P["downsamples"], _layout(vcfg, False), strict=True):
        x = residual(p, x, feat_cache, feat_idx) if kind == "res" else resample(
            p, kind, x, feat_cache, feat_idx)
    x = _middle(P["middle"], x, feat_cache, feat_idx)
    return _cached(P["head"]["2"], F.silu(rms_c(P["head"]["0"], x)), feat_cache, feat_idx)


def decoder(P, vcfg, x, feat_cache, feat_idx):
    x = _cached(P["conv1"], x, feat_cache, feat_idx)
    x = _middle(P["middle"], x, feat_cache, feat_idx)
    for p, kind in zip(P["upsamples"], _layout(vcfg, True), strict=True):
        x = residual(p, x, feat_cache, feat_idx) if kind == "res" else resample(
            p, kind, x, feat_cache, feat_idx)
    return _cached(P["head"]["2"], F.silu(rms_c(P["head"]["0"], x)), feat_cache, feat_idx)


def vae_encode(P, vcfg, video):
    """``WanVAE_.encode`` with mean 0 and std 1: [B, 3, F, H, W] -> mu."""
    feat_cache = [None] * 512
    outs = []
    for i in range(1 + (video.shape[2] - 1) // 4):
        part = video[:, :, :1] if i == 0 else video[:, :, 1 + 4 * (i - 1):1 + 4 * i]
        outs.append(encoder(P["encoder"], vcfg, part.float(), feat_cache, [0]))
    return causal_conv(P["conv1"], torch.cat(outs, 2))[:, :vcfg["z_dim"]]


def vae_decode(P, vcfg, z):
    """``WanVAE_.decode`` with mean 0 and std 1, clamped to [-1, 1]."""
    feat_cache = [None] * 512
    x = causal_conv(P["conv2"], z.float())
    outs = [decoder(P["decoder"], vcfg, x[:, :, i:i + 1], feat_cache, [0])
            for i in range(x.shape[2])]
    return torch.cat(outs, 2).clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# Image to video
# ---------------------------------------------------------------------------


def flow_sigmas(steps: int, shift: float) -> List[float]:
    """s u / (1 + (s - 1) u) at u = linspace(1, 0, steps + 1)."""
    out = []
    for i in range(steps + 1):
        u = 1.0 - i / steps
        out.append(shift * u / (1.0 + (shift - 1.0) * u))
    return out


def first_frame_mask(frames, lat_h, lat_w, device):
    msk = torch.ones(1, frames, lat_h, lat_w, device=device)
    msk[:, 1:] = 0
    msk = torch.concat([torch.repeat_interleave(msk[:, 0:1], repeats=4, dim=1), msk[:, 1:]],
                       dim=1)
    msk = msk.view(1, msk.shape[1] // 4, 4, lat_h, lat_w)
    return msk.transpose(1, 2)[0]


def generate(dit, cfg, vae, vcfg, *, image, text, clip, noise, steps, shift, guidance=1.0,
             negative_text=None, prec: Optional[Precision] = None,
             return_latents: bool = False):
    """One batch of I2V videos: I420 uint8 [B, F, H 3/2, W]; with
    ``return_latents``, (I420, the denoised latents [B, 16, F', h, w] f32).

    ``image`` [B, 1, H, W, 3] in [-1, 1]; ``text`` [B, 512, 4096] padded
    caption embeddings; ``clip`` [B, 257, 1280]; ``noise`` [B, 16, F', h, w]
    the initial latent; ``negative_text`` the uncond embeddings (zeros when
    absent) where ``guidance`` > 1."""
    prec = prec or Precision("f32")
    b, _, frames_lat, lat_h, lat_w = noise.shape
    frames = 4 * (frames_lat - 1) + 1
    dev = noise.device
    img = image.float().permute(0, 4, 1, 2, 3)  # [B, 3, 1, H, W]
    video = torch.cat([img, torch.zeros(b, 3, frames - 1, *img.shape[3:], device=dev)], dim=2)
    y = vae_encode(vae, vcfg, video)
    msk = first_frame_mask(frames, lat_h, lat_w, dev)[None].expand(b, -1, -1, -1, -1)
    cond = torch.cat([msk, y], dim=1)
    ctx, img_ctx = context(dit, cfg, text, clip, prec)
    if guidance > 1.0:
        neg = torch.zeros_like(text) if negative_text is None else negative_text
        ctx_u, _ = context(dit, cfg, neg, clip, prec)
    sig = flow_sigmas(steps, shift)
    lat = noise.float()
    for i in range(steps):
        t = torch.full((b,), sig[i] * 1000.0, device=dev)
        x_in = torch.cat([lat, cond], dim=1)
        v = dit_forward(dit, cfg, x_in, t, ctx, img_ctx, prec)
        if guidance > 1.0:
            v_u = dit_forward(dit, cfg, x_in, t, ctx_u, img_ctx, prec)
            v = v_u + guidance * (v - v_u)
        lat = lat + (sig[i + 1] - sig[i]) * v
    pixels = vae_decode(vae, vcfg, lat)  # [B, 3, F, H, W]
    video = rgb_to_i420(pixels.permute(0, 2, 3, 4, 1) * 0.5 + 0.5)
    return (video, lat) if return_latents else video


def latent_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """RMS of ``got`` - ``want`` over the RMS of ``want``: the DiT's gap in
    the denoised latents, before the VAE draws them."""
    want = want.double()
    return ((got.double() - want).pow(2).mean() / want.pow(2).mean()).sqrt().item()
