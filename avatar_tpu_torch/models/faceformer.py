"""FaceFormer: audio to 3D face motion (port of
``avatar_tpu/models/faceformer.py``).

wav2vec2 (50 Hz features interpolated to 30 fps) -> linear 768 -> 64 -> a
one-layer transformer decoder with an ALiBi-style temporal bias, periodic
positional encoding (period 30) and a diagonal audio-alignment
cross-attention -> linear 64 -> 15,069 (5,023 FLAME vertices x 3).

The decode is autoregressive. The decoder is causal and frame i's
cross-attention sees only audio frame i, so frame i depends on the
embeddings 0..i and memory[i] alone: :func:`faceformer_decode` computes
each frame with a single-query decoder step over a fixed buffer of all the
frames (the JAX package's ``lax.scan``, here a loop over the frames).

The ALiBi bias has the closed form bias[h, i, j] = -slope_h *
floor((i - j) / period) for j <= i, -inf above.

Params: linears ``{"weight": [out, in], "bias"}``; the decoder layer's
attentions keep torch's ``in_proj_weight`` [3d, d], ``in_proj_bias``,
``out_proj_weight``, ``out_proj_bias``; ``obj_vector`` ``{"weight":
[d, identities]}``. :func:`import_faceformer_state` reads the vocaset
checkpoint's state dict; ``utils/weight_import.py:faceformer_params_from_numpy``
takes the JAX tree.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from avatar_tpu_torch.models.layers import linear
from avatar_tpu_torch.models.wav2vec2 import (
    Wav2Vec2Config, _as_tensor, import_wav2vec2_state, wav2vec2_encode,
)
from avatar_tpu_torch.ops.normalization import layer_norm


@dataclass(frozen=True)
class FaceFormerConfig:
    feature_dim: int = 64
    vertice_dim: int = 5023 * 3
    period: int = 30
    n_head: int = 4
    num_identities: int = 8  # train_subjects "F2 F3 F4 M3 M4 M5" (+pad)
    max_seq_len: int = 600
    output_fps: float = 30.0  # vocaset


def alibi_slopes(n_head: int) -> np.ndarray:
    """The ALiBi slope of each head."""

    def pow2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * start**i for i in range(n)]

    if math.log2(n_head).is_integer():
        return np.asarray(pow2(n_head))
    closest = 2 ** math.floor(math.log2(n_head))
    extra = pow2(2 * closest)[0::2][: n_head - closest]
    return np.asarray(pow2(closest) + extra)


def biased_causal_row(slopes: torch.Tensor, i: int, length: int, period: int) -> torch.Tensor:
    """Row i of the biased causal mask: [n_head, length] additive f32 bias,
    -inf for j > i, else -slope * floor((i - j) / period)."""
    j = torch.arange(length, device=slopes.device)
    dist = torch.floor((i - j) / period)
    bias = -slopes[:, None] * dist[None, :]
    return torch.where(j[None, :] <= i, bias, -math.inf)


def periodic_positional_encoding(d_model: int, period: int, max_seq_len: int) -> np.ndarray:
    """The periodic positional encoding table, [max_seq_len + period,
    d_model] (at most)."""
    pe = np.zeros((period, d_model), dtype=np.float32)
    position = np.arange(period, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    reps = max_seq_len // period + 1
    return np.tile(pe, (reps, 1))[: max_seq_len + period]


# ---------------------------------------------------------------------------
# The decoder layer (nn.TransformerDecoderLayer: post-LN, relu), one query
# ---------------------------------------------------------------------------


def _mha_single_query(p: dict, q_in: torch.Tensor, kv_in: torch.Tensor,
                      bias_row: Optional[torch.Tensor], n_head: int) -> torch.Tensor:
    """torch MultiheadAttention for one query position: q_in [B, d],
    kv_in [B, S, d], bias_row [n_head, S] additive or None -> [B, d]."""
    b, s, d = kv_in.shape
    head = d // n_head
    wq, wk, wv = p["in_proj_weight"].chunk(3, dim=0)
    bq, bk, bv = p["in_proj_bias"].chunk(3, dim=0)
    q = (q_in @ wq.T + bq) * head**-0.5
    k = kv_in @ wk.T + bk
    v = kv_in @ wv.T + bv
    q = q.reshape(b, n_head, head)
    k = k.reshape(b, s, n_head, head).transpose(1, 2)
    v = v.reshape(b, s, n_head, head).transpose(1, 2)
    logits = torch.einsum("bhd,bhsd->bhs", q, k).float()
    if bias_row is not None:
        logits = logits + bias_row[None]
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhs,bhsd->bhd", probs, v).reshape(b, d)
    return out @ p["out_proj_weight"].T + p["out_proj_bias"]


def _decoder_layer_single_query(p: dict, x_i: torch.Tensor, x_all: torch.Tensor,
                                memory_i: torch.Tensor, self_bias_row: torch.Tensor,
                                n_head: int, eps: float = 1e-5) -> torch.Tensor:
    """x_i [B, d] the query position's input, x_all [B, F, d] the buffer
    (positional encoding added), memory_i [B, d] its aligned audio frame."""
    x = x_i + _mha_single_query(p["self_attn"], x_i, x_all, self_bias_row, n_head)
    x = layer_norm(x, p["norm1"]["scale"], p["norm1"]["bias"], eps=eps)
    x = x + _mha_single_query(p["multihead_attn"], x, memory_i[:, None, :], None, n_head)
    x = layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"], eps=eps)
    h = F.relu(linear(p["linear1"], x))
    x = x + linear(p["linear2"], h)
    return layer_norm(x, p["norm3"]["scale"], p["norm3"]["bias"], eps=eps)


def faceformer_decode(params: dict, cfg: FaceFormerConfig, hidden_states: torch.Tensor,
                      style_emb: torch.Tensor) -> torch.Tensor:
    """The autoregressive decode: projected audio features [B, F,
    feature_dim] and the style embedding [B, feature_dim] -> the decoder's
    features [B, F, feature_dim] (before ``vertice_map_r``). Frame i's
    output, mapped to vertices and back (``vertice_map_r`` then
    ``vertice_map``) plus the style, is frame i + 1's embedding."""
    b, frames, d = hidden_states.shape
    ppe = torch.from_numpy(
        periodic_positional_encoding(d, cfg.period, cfg.max_seq_len)[:frames]).to(
        hidden_states.device, hidden_states.dtype)
    slopes = torch.from_numpy(alibi_slopes(cfg.n_head)).to(hidden_states.device,
                                                           torch.float32)
    dec = params["decoder_layer"]
    emb = torch.zeros((b, frames, d), dtype=hidden_states.dtype, device=hidden_states.device)
    emb[:, 0] = style_emb
    outs = []
    for i in range(frames):
        x_all = emb + ppe[None]
        bias_row = biased_causal_row(slopes, i, frames, cfg.period)
        out_i = _decoder_layer_single_query(dec, x_all[:, i], x_all, hidden_states[:, i],
                                            bias_row, cfg.n_head)
        if i + 1 < frames:
            nxt = linear(params["vertice_map"], linear(params["vertice_map_r"], out_i))
            emb[:, i + 1] = nxt + style_emb
        outs.append(out_i)
    return torch.stack(outs, dim=1)


def faceformer_predict(
    params: dict,
    ff_cfg: FaceFormerConfig,
    w2v_cfg: Wav2Vec2Config,
    audio: torch.Tensor,  # [B, S] raw 16 kHz waveform
    template: torch.Tensor,  # [B, vertice_dim]
    one_hot: torch.Tensor,  # [B, num_identities]
    frame_num: Optional[int] = None,
) -> torch.Tensor:
    """Audio -> per-frame FLAME vertices [B, F, vertice_dim]: wav2vec2 at
    the model's fps (or ``frame_num`` frames), the decode with the
    identity's style, the vertex map, plus the template."""
    feats = wav2vec2_encode(params["audio_encoder"], w2v_cfg, audio, output_len=frame_num,
                            output_fps=ff_cfg.output_fps)
    hidden = linear(params["audio_feature_map"], feats)
    style = one_hot.to(hidden.dtype) @ params["obj_vector"]["weight"].T
    features = faceformer_decode(params, ff_cfg, hidden, style)
    return linear(params["vertice_map_r"], features) + template[:, None, :]


def audio_features_to_caption_embeds(features: torch.Tensor,
                                     caption_channels: int = 4096) -> torch.Tensor:
    """FaceFormer features [B, T, feature_dim] placed in the DiT's caption
    input space: zero-padded to ``caption_channels``, so that the trainable
    caption_projection learns the map ("lora_audio" training)."""
    d = features.shape[-1]
    if d > caption_channels:
        raise ValueError(f"{d} feature channels exceed {caption_channels} caption channels")
    return F.pad(features, (0, caption_channels - d))


def extract_audio_motion_features(
    params: dict,
    ff_cfg: FaceFormerConfig,
    w2v_cfg: Wav2Vec2Config,
    audio: torch.Tensor,
    frame_num: Optional[int] = None,
) -> torch.Tensor:
    """The decoder's features [B, F, feature_dim] with a neutral (zero)
    identity: the "audio latents" of audio-conditioned training."""
    feats = wav2vec2_encode(params["audio_encoder"], w2v_cfg, audio, output_len=frame_num,
                            output_fps=ff_cfg.output_fps)
    hidden = linear(params["audio_feature_map"], feats)
    style = torch.zeros((audio.shape[0], ff_cfg.feature_dim), dtype=hidden.dtype,
                        device=hidden.device)
    return faceformer_decode(params, ff_cfg, hidden, style)


# ---------------------------------------------------------------------------
# Weight import (the vocaset checkpoint's state dict)
# ---------------------------------------------------------------------------


def import_faceformer_state(state: Dict[str, object], w2v_cfg: Wav2Vec2Config,
                            device="cuda", dtype: Optional[torch.dtype] = None) -> dict:
    """A torch Faceformer state dict (tensors or numpy arrays) -> the
    port's tree on ``device``; the ``audio_encoder.`` keys go to
    :func:`import_wav2vec2_state`."""
    w2v_state = {k[len("audio_encoder."):]: v for k, v in state.items()
                 if k.startswith("audio_encoder.") and "masked_spec_embed" not in k}

    def t(key):
        return _as_tensor(state[key], device, dtype)

    def lin(key):
        p = {"weight": t(f"{key}.weight")}
        if f"{key}.bias" in state:
            p["bias"] = t(f"{key}.bias")
        return p

    def mha(key):
        return {"in_proj_weight": t(f"{key}.in_proj_weight"),
                "in_proj_bias": t(f"{key}.in_proj_bias"),
                "out_proj_weight": t(f"{key}.out_proj.weight"),
                "out_proj_bias": t(f"{key}.out_proj.bias")}

    def norm(key):
        return {"scale": t(f"{key}.weight"), "bias": t(f"{key}.bias")}

    dec = "transformer_decoder.layers.0"
    return {
        "audio_encoder": import_wav2vec2_state(w2v_state, w2v_cfg, device, dtype),
        "audio_feature_map": lin("audio_feature_map"),
        "vertice_map": lin("vertice_map"),
        "vertice_map_r": lin("vertice_map_r"),
        "obj_vector": {"weight": t("obj_vector.weight")},
        "decoder_layer": {
            "self_attn": mha(f"{dec}.self_attn"),
            "multihead_attn": mha(f"{dec}.multihead_attn"),
            "linear1": lin(f"{dec}.linear1"),
            "linear2": lin(f"{dec}.linear2"),
            "norm1": norm(f"{dec}.norm1"),
            "norm2": norm(f"{dec}.norm2"),
            "norm3": norm(f"{dec}.norm3"),
        },
    }


def load_faceformer(checkpoint_path: str, w2v_cfg: Optional[Wav2Vec2Config] = None,
                    device="cuda"):
    """(FaceFormerConfig(), w2v_cfg, params) from the reference's
    vocaset.pth (a torch pickle of the model or its state dict), read
    straight onto ``device``."""
    state = torch.load(checkpoint_path, map_location=device, weights_only=False)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    w2v_cfg = w2v_cfg or Wav2Vec2Config()
    return FaceFormerConfig(), w2v_cfg, import_faceformer_state(state, w2v_cfg, device)
