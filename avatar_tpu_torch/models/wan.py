"""Wan2.1 video DiT denoiser (``WanModel`` of github.com/Wan-Video/Wan2.1,
``wan/modules/model.py``), image-to-video variant.

Tokens [B, L, dim] from a (1, 2, 2) patch embedding of the 36-channel
input (noisy latent, first-frame mask, encoded conditioning video); per
block a LayerNorm AdaLN from a learned table plus a shared time projection,
self-attention with a q/k RMS norm over the whole width and per-head 3-axis
RoPE, two cross-attentions from one q (text and CLIP image tokens) whose
outputs are summed, and a gelu-tanh FFN. The residual stream stays in f32,
as the published model keeps it under autocast; the products run in the
activation dtype.

Parameters are the published state dict as a nested tree
(``blocks[i]["self_attn"]["q"]["weight"]`` for ``blocks.i.self_attn.q.weight``,
``utils/weight_import.py:wan_params_from_state_dict``), with the shapes it
has there. The port runs self-attention in the split-RoPE layout: the
self-attention q / k rows and norm weights are permuted once at load
(:func:`permute_wan_params_for_split_rope`), so that the q/k norm, the
rotation and the per-head layout are kernel M (``ops/flash_attention.py:
qk_norm_rope``, its per-head table mode) before the head-major attention
kernels, which take every attention of the block at long lengths.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from avatar_tpu_torch.models.layers import linear
from avatar_tpu_torch.ops.attention import scaled_dot_product_attention
from avatar_tpu_torch.ops.flash_attention import qk_norm_rope
from avatar_tpu_torch.ops.normalization import rms_norm
from avatar_tpu_torch.ops.rope import rope_channel_permutation
from avatar_tpu_torch.utils.profiling import annotate

CLIP_DIM = 1280  # CLIP ViT-H/14's width, the image embedding's input
CLIP_LN_EPS = 1e-5  # torch.nn.LayerNorm's default, which MLPProj keeps


@dataclass(frozen=True)
class WanConfig:
    """Static config; defaults = Wan2.1-I2V-14B-480P's ``config.json``."""

    dim: int = 5120
    ffn_dim: int = 13824
    num_heads: int = 40
    num_layers: int = 40
    in_dim: int = 36
    out_dim: int = 16
    freq_dim: int = 256
    text_len: int = 512
    text_dim: int = 4096
    eps: float = 1e-6
    patch_size: Tuple[int, int, int] = (1, 2, 2)

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @classmethod
    def from_dict(cls, config: dict) -> "WanConfig":
        """Reads the published ``config.json`` schema (and the model's
        constructor defaults where it leaves a key out). The port runs the
        i2v model with its q/k and cross-attention norms on, as published;
        any other variant raises."""
        for key, want in (("model_type", "i2v"), ("qk_norm", True), ("cross_attn_norm", True)):
            if config.get(key, want) != want:
                raise ValueError(f"{key}={config[key]!r}: the port runs {key}={want!r}")
        return cls(
            dim=config["dim"], ffn_dim=config["ffn_dim"], num_heads=config["num_heads"],
            num_layers=config["num_layers"], in_dim=config["in_dim"],
            out_dim=config["out_dim"], freq_dim=config.get("freq_dim", 256),
            text_len=config.get("text_len", 512), text_dim=config.get("text_dim", 4096),
            eps=config.get("eps", 1e-6),
            patch_size=tuple(config.get("patch_size", (1, 2, 2))))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _xavier(out_dim, in_dim, gen, device, dtype):
    bound = math.sqrt(6.0 / (in_dim + out_dim))
    t = torch.empty((out_dim, in_dim), device=device, dtype=torch.float32)
    return t.uniform_(-bound, bound, generator=gen).to(dtype)


def _bias(n, fan_in, gen, device, dtype):
    t = torch.empty((n,), device=device, dtype=torch.float32)
    return t.uniform_(-fan_in**-0.5, fan_in**-0.5, generator=gen).to(dtype)


def _lin(in_dim, out_dim, gen, device, dtype, std=None):
    """A Linear: xavier-uniform weight (``std``: normal of that deviation),
    bias uniform +-1/sqrt(fan_in)."""
    if std is None:
        w = _xavier(out_dim, in_dim, gen, device, dtype)
    else:
        w = torch.empty((out_dim, in_dim), device=device, dtype=torch.float32)
        w = w.normal_(0.0, std, generator=gen).to(dtype)
    return {"weight": w, "bias": _bias(out_dim, in_dim, gen, device, dtype)}


def _ln(dim, device, dtype):
    return {"weight": torch.ones(dim, device=device, dtype=dtype),
            "bias": torch.zeros(dim, device=device, dtype=dtype)}


def init_wan(cfg: WanConfig, seed: int = 0, device="cuda", dtype=torch.bfloat16) -> dict:
    """Seeded random params in the published tree, at the published
    initializers' scales (``WanModel.init_weights``: xavier-uniform linears
    and patch embedding, normal 0.02 text and time embeddings, modulation
    tables normal / sqrt(dim), norms at one), with two departures so that
    every product counts: the biases are drawn uniform +-1/sqrt(fan_in)
    where the published init zeroes them, and the output head is
    xavier-uniform where it is zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(gen=gen, device=device, dtype=dtype)
    d = cfg.dim
    pt, ph, pw = cfg.patch_size
    patch_in = cfg.in_dim * pt * ph * pw

    def attn(cross):
        names = ("q", "k", "v", "o", "k_img", "v_img") if cross else ("q", "k", "v", "o")
        p = {n: _lin(d, d, **kw) for n in names}
        for n in ("norm_q", "norm_k", "norm_k_img") if cross else ("norm_q", "norm_k"):
            p[n] = {"weight": torch.ones(d, device=device, dtype=dtype)}
        return p

    blocks = [{"self_attn": attn(False), "cross_attn": attn(True), "norm3": _ln(d, device, dtype),
               "ffn": {"0": _lin(d, cfg.ffn_dim, **kw), "2": _lin(cfg.ffn_dim, d, **kw)},
               "modulation": (torch.randn((1, 6, d), generator=gen, device=device)
                              * d**-0.5).to(dtype)}
              for _ in range(cfg.num_layers)]
    patch = _xavier(d, patch_in, gen, device, dtype).reshape(d, cfg.in_dim, pt, ph, pw)
    return {
        "patch_embedding": {"weight": patch, "bias": _bias(d, patch_in, **kw)},
        "text_embedding": {"0": _lin(cfg.text_dim, d, std=0.02, **kw),
                           "2": _lin(d, d, std=0.02, **kw)},
        "time_embedding": {"0": _lin(cfg.freq_dim, d, std=0.02, **kw),
                           "2": _lin(d, d, std=0.02, **kw)},
        "time_projection": {"1": _lin(d, 6 * d, **kw)},
        "blocks": blocks,
        "head": {"head": _lin(d, cfg.out_dim * pt * ph * pw, **kw),
                 "modulation": (torch.randn((1, 2, d), generator=gen, device=device)
                                * d**-0.5).to(dtype)},
        "img_emb": {"proj": {"0": _ln(CLIP_DIM, device, dtype),
                             "1": _lin(CLIP_DIM, CLIP_DIM, **kw), "3": _lin(CLIP_DIM, d, **kw),
                             "4": _ln(d, device, dtype)}},
    }


def permute_wan_params_for_split_rope(params: dict, cfg: WanConfig) -> dict:
    """A new tree whose self-attention q / k output rows and q / k norm
    weights are in the split-RoPE layout (``ops/rope.py:
    rope_channel_permutation``: the interleaved pairs (2i, 2i + 1) of every
    head to the global split halves, which kernel M stores back per head as
    [x1_h | x2_h]); every other leaf is shared with ``params``. The RMS norm
    over the whole width does not see the order. Apply exactly once."""
    perm = torch.from_numpy(rope_channel_permutation(cfg.dim))

    def rows(t):
        return t[perm.to(t.device)].contiguous()

    blocks = []
    for block in params["blocks"]:
        sa = dict(block["self_attn"])
        for name in ("q", "k", "norm_q", "norm_k"):
            if name in sa:
                sa[name] = {k: rows(v) for k, v in sa[name].items()}
        blocks.append(dict(block, self_attn=sa))
    return dict(params, blocks=blocks)


# ---------------------------------------------------------------------------
# Tables made once per video
# ---------------------------------------------------------------------------


def rope_bands(head_dim: int) -> Tuple[int, int, int]:
    """Pairs of each RoPE band (frames, rows, columns) of a head: the
    published d - 4 (d // 6) channels on the frame index and 2 (d // 6) on
    each spatial one, in pairs (22 / 21 / 21 at d = 128)."""
    c = head_dim // 2
    return c - 2 * (c // 3), c // 3, c // 3


def rope_tables(frames: int, rows: int, cols: int, head_dim: int, device="cuda",
                dtype=torch.bfloat16, theta: float = 10000.0):
    """(cos, sin) [1, frames rows cols, head_dim / 2] of the per-head 3-axis
    RoPE on the patched grid, token order (frame, row, column): pair j of
    band (t, h or w) of width 2n turns by position / theta^(2j / 2n)."""
    angles = []
    for n, size, axis in zip(rope_bands(head_dim), (frames, rows, cols), range(3)):
        freqs = 1.0 / theta ** (torch.arange(0, 2 * n, 2, device=device,
                                             dtype=torch.float64) / (2 * n))
        pos = torch.arange(size, device=device, dtype=torch.float64)
        ang = pos[:, None] * freqs[None]  # [size, n]
        shape = [1, 1, 1, n]
        shape[axis] = size
        angles.append(ang.reshape(shape).expand(frames, rows, cols, n))
    ang = torch.cat(angles, dim=-1).reshape(1, frames * rows * cols, head_dim // 2)
    return ang.cos().to(dtype), ang.sin().to(dtype)


def sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The published ``sinusoidal_embedding_1d``: [cos | sin] of t times
    10000^(-i / half), in f32."""
    half = dim // 2
    freqs = torch.pow(10000.0, -torch.arange(half, device=t.device, dtype=torch.float64) / half)
    arg = t.double()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=1).float()


def time_tables(params: dict, cfg: WanConfig, sigmas: torch.Tensor):
    """(e [S, dim], e0 [S, 6, dim]) in f32 for the model timesteps
    1000 sigma of each step: the time embedding and its projection, made
    once for the whole schedule in f32, as the published model makes them
    under f32 autocast."""
    t = sigmas.float() * 1000.0
    h = sinusoid(t, cfg.freq_dim)
    te = params["time_embedding"]
    e = linear(te["2"], F.silu(linear(te["0"], h)))
    e0 = linear(params["time_projection"]["1"], F.silu(e))
    return e, e0.reshape(-1, 6, cfg.dim)


def context_kv(params: dict, cfg: WanConfig, text: torch.Tensor, clip: torch.Tensor,
               dtype=torch.bfloat16) -> List[Tuple[torch.Tensor, ...]]:
    """Each block's cross-attention (k, v, k_img, v_img) [B, Lk, dim]: the
    text embedding of the 512 padded rows ([B, text_len, text_dim], no mask)
    and the image embedding of the CLIP rows ([B, 257, 1280]), projected and
    k-normed once per video."""
    te = params["text_embedding"]
    ctx = linear(te["2"], F.gelu(linear(te["0"], text.to(dtype)), approximate="tanh"))
    proj = params["img_emb"]["proj"]
    h = F.layer_norm(clip.float(), (clip.shape[-1],), proj["0"]["weight"].float(),
                     proj["0"]["bias"].float(), CLIP_LN_EPS).to(dtype)
    h = linear(proj["3"], F.gelu(linear(proj["1"], h)))
    img = F.layer_norm(h.float(), (cfg.dim,), proj["4"]["weight"].float(),
                       proj["4"]["bias"].float(), CLIP_LN_EPS).to(dtype)
    out = []
    for block in params["blocks"]:
        ca = block["cross_attn"]
        out.append((_norm(ca, "norm_k", linear(ca["k"], ctx), cfg), linear(ca["v"], ctx),
                    _norm(ca, "norm_k_img", linear(ca["k_img"], img), cfg),
                    linear(ca["v_img"], img)))
    return out


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------


def _norm(p: dict, name: str, x: torch.Tensor, cfg: WanConfig) -> torch.Tensor:
    return rms_norm(x, p[name]["weight"], eps=cfg.eps)


def _modulated(x: torch.Tensor, scale, shift, eps: float, dtype) -> torch.Tensor:
    """LayerNorm(x) (1 + scale) + shift in f32, then cast to the products'
    dtype."""
    h = F.layer_norm(x, (x.shape[-1],), eps=eps)
    return torch.addcmul(shift, h, 1 + scale).to(dtype)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).transpose(1, 2)


def _merged(t: torch.Tensor) -> torch.Tensor:
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _attend(q, k, v, scale):
    """Head-major attention through the router (``scaled_dot_product_attention``:
    the flash kernels at long lengths, which read the head-major views of
    token-major tensors in place); the q/k norms bound the logits, so long
    sequences take C's max-free softmax, as the LTX DiT does."""
    return scaled_dot_product_attention(q, k, v, scale=scale, impl="auto",
                                        bounded_logits=True)


def self_attention(p: dict, h: torch.Tensor, rope, cfg: WanConfig) -> torch.Tensor:
    """q, k, v of ``h`` [B, L, dim] (params in the split-RoPE layout), kernel
    M's q/k norm, per-head RoPE and head-major store, attention, o."""
    heads = cfg.num_heads
    q, k, v = linear(p["q"], h), linear(p["k"], h), linear(p["v"], h)
    q, k, scale = qk_norm_rope(q, k, p["norm_q"]["weight"], p["norm_k"]["weight"], rope[0],
                               rope[1], heads, cfg.head_dim**-0.5, eps=cfg.eps)
    out = _attend(_heads(q, heads), _heads(k, heads), _heads(v, heads), scale)
    return linear(p["o"], _merged(out))


def cross_attention(p: dict, h: torch.Tensor, kv: Sequence[torch.Tensor],
                    cfg: WanConfig) -> torch.Tensor:
    """One normed q of ``h`` to the text (k, v) and to the image (k_img,
    v_img): two softmaxes over the same head-major q, summed, then o."""
    heads = cfg.num_heads
    scale = cfg.head_dim**-0.5
    qh = _heads(_norm(p, "norm_q", linear(p["q"], h), cfg), heads)
    out = _merged(_attend(qh, _heads(kv[0], heads), _heads(kv[1], heads), scale))
    with annotate("dit.attn2.img"):
        out = out + _merged(_attend(qh, _heads(kv[2], heads), _heads(kv[3], heads), scale))
    return linear(p["o"], out)


def block_apply(p: dict, x: torch.Tensor, e0: torch.Tensor, kv, rope, cfg: WanConfig,
                dtype=torch.bfloat16) -> torch.Tensor:
    """``WanAttentionBlock``: x [B, L, dim] f32, e0 [B, 6, dim] f32."""
    with annotate("dit.norm"):
        m = p["modulation"].float() + e0
        shift1, scale1, gate1, shift2, scale2, gate2 = (m[:, i, None] for i in range(6))
        h = _modulated(x, scale1, shift1, cfg.eps, dtype)
    with annotate("dit.attn1"):
        y = self_attention(p["self_attn"], h, rope, cfg)
    x = torch.addcmul(x, y, gate1)
    with annotate("dit.attn2"):
        h = F.layer_norm(x, (cfg.dim,), p["norm3"]["weight"].float(), p["norm3"]["bias"].float(),
                         cfg.eps).to(dtype)
        x = x + cross_attention(p["cross_attn"], h, kv, cfg)
    with annotate("dit.norm"):
        h = _modulated(x, scale2, shift2, cfg.eps, dtype)
    with annotate("dit.ff"):
        ffn = p["ffn"]
        y = linear(ffn["2"], F.gelu(linear(ffn["0"], h), approximate="tanh"))
    return torch.addcmul(x, y, gate2)


def patchify(x: torch.Tensor, patch_size) -> torch.Tensor:
    """[B, C, F, H, W] -> [B, F/pt H/ph W/pw, C pt ph pw] tokens, features in
    the patch embedding's (c, kt, kh, kw) order."""
    b, c, f, h, w = x.shape
    pt, ph, pw = patch_size
    x = x.reshape(b, c, f // pt, pt, h // ph, ph, w // pw, pw)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (f // pt) * (h // ph) * (w // pw), c * pt * ph * pw)


def unpatchify(tokens: torch.Tensor, grid, patch_size, channels: int) -> torch.Tensor:
    """[B, L, pt ph pw c] (the published head's ``fhwpqrc`` order) ->
    [B, c, F, H, W]."""
    b = tokens.shape[0]
    f, h, w = grid
    pt, ph, pw = patch_size
    x = tokens.reshape(b, f, h, w, pt, ph, pw, channels)
    x = x.permute(0, 7, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, channels, f * pt, h * ph, w * pw)


def wan_apply(params: dict, cfg: WanConfig, x_in: torch.Tensor, e: torch.Tensor,
              e0: torch.Tensor, kv, rope, dtype=torch.bfloat16) -> torch.Tensor:
    """Velocity [B, out_dim, F, H, W] f32 of the model input x_in [B, in_dim,
    F, H, W]; ``e`` [B, dim] / ``e0`` [B, 6, dim] the step's rows of
    :func:`time_tables`, ``kv`` from :func:`context_kv`, ``rope`` from
    :func:`rope_tables` on the patched grid; params in the split-RoPE layout."""
    pt, ph, pw = cfg.patch_size
    grid = (x_in.shape[2] // pt, x_in.shape[3] // ph, x_in.shape[4] // pw)
    pe = params["patch_embedding"]
    w = pe["weight"].reshape(cfg.dim, -1)
    x = linear({"weight": w, "bias": pe["bias"]}, patchify(x_in.to(dtype), cfg.patch_size))
    x = x.float()
    for block, block_kv in zip(params["blocks"], kv, strict=True):
        with annotate("dit.block"):
            x = block_apply(block, x, e0, block_kv, rope, cfg, dtype)
    with annotate("dit.norm"):
        hm = params["head"]["modulation"].float() + e[:, None]
        h = torch.addcmul(hm[:, 0, None], F.layer_norm(x, (cfg.dim,), eps=cfg.eps),
                          1 + hm[:, 1, None])
        out = linear(params["head"]["head"], h)
    return unpatchify(out, grid, cfg.patch_size, cfg.out_dim)


def first_frame_mask(frames: int, lat_h: int, lat_w: int, batch: int, temporal_stride: int = 4,
                     device="cuda", dtype=torch.bfloat16) -> torch.Tensor:
    """The published i2v mask [B, 4, F', h, w]: ones at the first of
    ``frames`` frames, that frame repeated ``temporal_stride`` times, viewed
    as channels of each latent frame."""
    msk = torch.zeros(1, frames, lat_h, lat_w, device=device, dtype=dtype)
    msk[:, 0] = 1
    msk = torch.cat([msk[:, :1].repeat_interleave(temporal_stride, dim=1), msk[:, 1:]], dim=1)
    msk = msk.reshape(1, msk.shape[1] // temporal_stride, temporal_stride, lat_h, lat_w)
    return msk.transpose(1, 2).expand(batch, -1, -1, -1, -1)


def flow_sigmas(steps: int, shift: float) -> List[float]:
    """sigma_i = s u / (1 + (s - 1) u) at u = linspace(1, 0, steps + 1): the
    shift ``diffusion/rf.py:time_shift(log s, 1, u)``, with its end at 0."""
    from avatar_tpu_torch.diffusion.rf import time_shift

    out = []
    for i in range(steps + 1):
        u = 1.0 - i / steps
        out.append(float(time_shift(math.log(shift), 1.0, u)) if u > 0 else 0.0)
    return out


def precompute(params: dict, cfg: WanConfig, text: torch.Tensor, clip: torch.Tensor,
               sigmas: torch.Tensor, grid, dtype=torch.bfloat16):
    """(kv, e, e0, rope) of one video: :func:`context_kv`, :func:`time_tables`
    and :func:`rope_tables` on the patched ``grid``."""
    with annotate("dit.precompute"):
        kv = context_kv(params, cfg, text, clip, dtype)
        e, e0 = time_tables(params, cfg, sigmas)
        rope = rope_tables(*grid, cfg.head_dim, device=text.device, dtype=dtype)
    return kv, e, e0, rope
