"""Frozen operation and byte counts of Wan2.1-I2V (``models/wan.py``,
``models/wan_vae.py``), in the terms of ``work.py``: the DiT's products
analytically from the configuration and the cell's shapes, the VAE's from
the plain reference run on the meta device under torch's flop counter
(shapes only), and the least times of the attention kernels and of kernel
M at the card's peaks.
"""

from __future__ import annotations

import torch

from benchmark import work


def block_linear_ops(cfg: dict, tokens: int) -> float:
    """One block's products over ``tokens`` latent tokens: self-attention's
    q, k, v, o and cross-attention's q, o (C x C each) and the FFN (C x F
    twice)."""
    c, f = cfg["dim"], cfg["ffn_dim"]
    return 2.0 * tokens * (6 * c * c + 2 * c * f)


def self_attention_ops(cfg: dict, tokens: int) -> float:
    """QK^T and PV of one block's self-attention over every head."""
    return work.attention_work(1, cfg["num_heads"], tokens, tokens,
                               cfg["dim"] // cfg["num_heads"])[0]


def dit_forward_work(cfg: dict, batch: int, tokens: int, text: int, clip: int,
                     peaks) -> work.Work:
    """One DiT forward over ``batch`` x ``tokens``: the blocks' products and
    attention (self, text and image cross-attention), the patch embedding
    and the head. Least times of the attention (C at head dim 128) and of
    kernel M (its bytes: q and k read and written once, the shared per-head
    tables and the norm weights read once) by layer."""
    c, heads, layers = cfg["dim"], cfg["num_heads"], cfg["num_layers"]
    d = c // heads
    pt, ph, pw = cfg["patch_size"]
    w = work.Work()
    m = batch * tokens
    w.add("bf16", layers * block_linear_ops(cfg, m))
    w.add("bf16", 2.0 * m * cfg["in_dim"] * pt * ph * pw * c
          + 2.0 * m * c * cfg["out_dim"] * pt * ph * pw)
    parts = [work.attention_work(batch, heads, tokens, lk, d) for lk in (tokens, text, clip)]
    w.add("bf16", layers * sum(ops for ops, _ in parts))
    if peaks is not None:
        bf, mem, _ = peaks
        w.add_least("attention", layers * sum(work.least_s(o, b, bf, mem) for o, b in parts))
        w.add_least("qk_norm_rope", layers * work.least_s(0.0, m_bytes(batch, tokens, c, d),
                                                          bf, mem))
    return w


def m_bytes(batch: int, tokens: int, c: int, head_dim: int, itemsize: int = 2) -> float:
    """Kernel M's bytes with per-head tables: q and k read and written once,
    cos and sin [tokens, head_dim / 2] and the two norm weights read once."""
    return (4 * batch * tokens * c + 2 * tokens * head_dim // 2 + 2 * c) * itemsize


def dit_video_work(cfg: dict, batch: int, tokens: int, text: int, clip: int, steps: int,
                   peaks) -> work.Work:
    """A walk of ``steps`` forwards, plus what is made once a video: the text
    and image embeddings, every block's cross-attention k / v of both, and
    the time embedding and projection of each step."""
    c = cfg["dim"]
    w = dit_forward_work(cfg, batch, tokens, text, clip, peaks).scaled(steps)
    w.add("bf16", 2.0 * batch * text * (cfg.get("text_dim", 4096) * c + c * c)
          + 2.0 * batch * clip * (1280 * 1280 + 1280 * c)
          + cfg["num_layers"] * 2 * 2.0 * batch * (text + clip) * c * c
          + steps * 2.0 * (cfg["freq_dim"] * c + c * c + 6 * c * c))
    return w


def vae_ops(vae_params, vcfg: dict, frames: int, height: int, width: int) -> float:
    """Operations of one encode of ``frames`` frames and one decode of its
    latents, counted by torch's flop counter over the plain reference on the
    meta device (convolutions and the attention's products)."""
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import wan as ref

    tree = work._meta(vae_params)
    lat = (1, vcfg["z_dim"], (frames - 1) // 4 + 1, height // 8, width // 8)
    with FlopCounterMode(display=False) as counter:
        ref.vae_encode(tree, vcfg, torch.empty(1, 3, frames, height, width, device="meta"))
        ref.vae_decode(tree, vcfg, torch.empty(lat, device="meta"))
    return float(counter.get_total_flops())


def tokens_of(cfg: dict, mix: dict) -> int:
    pt, ph, pw = cfg["patch_size"]
    return (((mix["frames"] - 1) // 4 + 1) // pt) * (mix["height"] // 8 // ph) * (
        mix["width"] // 8 // pw)


def video_work(cfg: dict, mix: dict, vae_params, peaks) -> work.Work:
    """The model's work of one video of the cell: the DiT's walk (batch 2
    where guidance is on) and the VAE's encode of the conditioning video and
    decode of the result (``vae_params``: the VAE's tree, for its shapes)."""
    batch = 2 if mix.get("guidance", 1.0) > 1.0 else 1
    w = dit_video_work(cfg, batch, tokens_of(cfg, mix), mix["text_tokens"], mix["clip_tokens"],
                       mix["steps"], peaks)
    w.add("bf16", vae_ops(vae_params, cfg["vae"], mix["frames"], mix["height"], mix["width"]))
    return w
