"""Parameter trees from the JAX package's layout (port counterpart of
``avatar_tpu/utils/weight_import.py``).

The JAX package stores linear kernels ``[in, out]`` under ``"kernel"`` and
conv kernels ``[kt, kh, kw, in, out]`` (DHWIO). The port stores
``"weight"`` as ``[out, in]`` and ``[out, in, kt, kh, kw]``. Everything
else (biases, norm scales, AdaLN tables, the tree's structure) carries
over as it is.

A quantized linear (``avatar_tpu/utils/quantize.py``) carries over with
its int8 kernel, ``kernel_q`` (weight-only) or ``kernel_q8`` (W8A8), as
int8 ``[out, in]``, the port's layout (``avatar_tpu_torch/utils/quantize.py``
makes the same tree), and its ``scale`` in its own dtype: bf16 for w8, f32
for w8a8. A W8A8 conv3d (the int8 VAE's ``kernel_q8``, DHWIO) carries over
with its f32 ``scale`` as int8 ``[out, kt, kh, kw, in padded to 32]``,
the port's W8A8 conv layout (``ops/causal_conv3d.py:int8_conv_layout``).

The DiT tree must be the **unpermuted** one: the port's pipeline applies
the split-RoPE permutation itself at construction. Its blocks may be a
list or one tree stacked on a leading layer axis (``[L, in, out]`` kernels
become ``[L, out, in]``); the layout carries over.

Single-file checkpoints (the avatar flow's format, and what training
exports): a safetensors file whose ``config`` metadata holds the
transformer, VAE and scheduler configs, with the transformer's state under
``model.diffusion_model.`` and the VAE's under ``vae.``, in the reference's
parameter names and torch layouts (:func:`import_transformer_state`,
:func:`export_transformer_state`, :func:`load_single_file_checkpoint`,
:func:`save_single_file_checkpoint`; the VAE's by :func:`import_vae_state`
and :func:`export_vae_state`; :func:`load_checkpoint` reads both trees
at once). Diffusers directories name their keys otherwise:
:func:`normalize_diffusers_state` renames them to the reference's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from avatar_tpu_torch.models.dit import DiTConfig
from avatar_tpu_torch.models.vae import (
    VAEConfig,
    _decoder_channel_walk,
    _encoder_channel_walk,
)
from avatar_tpu_torch.ops.causal_conv3d import int8_conv_layout
from avatar_tpu_torch.utils.safetensors_io import load_safetensors, save_safetensors


def _swap_last(w: np.ndarray, stacked: bool) -> np.ndarray:
    if not (w.ndim == 2 or (stacked and w.ndim == 3)):
        raise ValueError(f"unexpected linear kernel rank {w.ndim}")
    return np.swapaxes(w, -1, -2)


def _convert(node: Any, device, dtype, stacked: bool = False) -> Any:
    if isinstance(node, dict):
        quantized = "kernel_q" in node or "kernel_q8" in node
        out = {}
        for key, val in node.items():
            if key == "kernel":
                w = np.asarray(val)
                if w.ndim == 5 and not stacked:
                    w = w.transpose(4, 3, 0, 1, 2)
                elif w.ndim == 3 and not stacked:  # a conv1d [K, in, out]
                    w = w.transpose(2, 1, 0)
                else:
                    w = _swap_last(w, stacked)
                out["weight"] = _tensor(w, device, dtype)
            elif key in ("kernel_q", "kernel_q8"):
                w = np.asarray(val)
                if w.ndim == 5 and not stacked:  # a W8A8 conv
                    w = int8_conv_layout(torch.from_numpy(
                        w.astype(np.int8).transpose(4, 3, 0, 1, 2))).numpy()
                else:
                    w = _swap_last(w, stacked)
                out[key] = torch.from_numpy(
                    np.ascontiguousarray(w, dtype=np.int8)).to(device)
            elif quantized and key == "scale":
                # the w8 scale is bf16, the w8a8 scale f32: kept as they are
                a = np.asarray(val)
                keep = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
                out[key] = _tensor(a, device, keep)
            else:
                out[key] = _convert(val, device, dtype, stacked)
        return out
    if isinstance(node, (list, tuple)):
        return [_convert(v, device, dtype, stacked) for v in node]
    return _tensor(np.asarray(node), device, dtype)


def _tensor(a: np.ndarray, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
    return t.to(device=device, dtype=dtype if t.ndim else torch.float32)


def dit_params_from_numpy(tree: dict, cfg: DiTConfig, device="cuda",
                          dtype: torch.dtype = torch.float32) -> dict:
    """Unpermuted JAX DiT params (numpy leaves) -> the port's tree."""
    blocks = tree["blocks"]
    if isinstance(blocks, (list, tuple)):
        n_blocks = len(blocks)
        blocks = _convert(blocks, device, dtype)
    else:
        n_blocks = np.asarray(blocks["scale_shift_table"]).shape[0]
        blocks = _convert(blocks, device, dtype, stacked=True)
    if n_blocks != cfg.num_layers:
        raise ValueError(f"{n_blocks} blocks for a {cfg.num_layers}-layer config")
    rest = {k: v for k, v in tree.items() if k != "blocks"}
    return dict(_convert(rest, device, dtype), blocks=blocks)


def vae_params_from_numpy(tree: dict, cfg: VAEConfig, device="cuda",
                          dtype: torch.dtype = torch.float32) -> dict:
    """JAX VAE params (numpy leaves) -> the port's tree. Scalars (the
    decoder's timestep multiplier) stay f32."""
    return _convert(tree, device, dtype)


def latent_upsampler_params_from_numpy(tree: dict, device="cuda",
                                       dtype: torch.dtype = torch.float32) -> dict:
    """JAX latent-upsampler params (numpy leaves, ``avatar_tpu/models/
    latent_upsampler.py``'s tree) -> the port's: conv kernels [kt, kh, kw,
    in, out] become weights [out, in, kt, kh, kw]."""
    return _convert(tree, device, dtype)


def t5_params_from_numpy(tree: dict, device="cuda",
                         dtype: torch.dtype = torch.float32) -> dict:
    """JAX T5 encoder params (numpy leaves, ``avatar_tpu/models/t5.py``'s
    tree, plain or int8 from ``quantize_t5_params``) -> the port's tree:
    linear kernels [in, out] become weights [out, in], int8 kernels stay
    int8 with their scales in their own dtype."""
    return _convert(tree, device, dtype)


def wav2vec2_params_from_numpy(tree: dict, device="cuda",
                               dtype: torch.dtype = torch.float32) -> dict:
    """JAX wav2vec2 params (numpy leaves, ``avatar_tpu/models/wav2vec2.py``'s
    tree) -> the port's: linear kernels [in, out] become weights [out, in],
    conv1d kernels [K, in / groups, out] weights [out, in / groups, K]."""
    return _convert(tree, device, dtype)


def faceformer_params_from_numpy(tree: dict, device="cuda",
                                 dtype: torch.dtype = torch.float32) -> dict:
    """JAX FaceFormer params (numpy leaves, ``avatar_tpu/models/
    faceformer.py``'s tree, its audio encoder included) -> the port's: as
    :func:`wav2vec2_params_from_numpy`, ``obj_vector``'s [identities, d]
    kernel becomes a [d, identities] weight, and the decoder layer's
    attention weights, torch-laid-out in both, carry over."""
    return _convert(tree, device, dtype)


def video_autoencoder_params_from_numpy(tree: dict, device="cuda",
                                        dtype: torch.dtype = torch.float32) -> dict:
    """JAX legacy VideoAutoencoder params (numpy leaves, ``avatar_tpu/
    models/video_autoencoder.py``'s tree, plain or (2+1)D convs) -> the
    port's: conv kernels [kt, kh, kw, in, out] become weights [out, in, kt,
    kh, kw], the 1x1x1 linears [in, out] weights [out, in]."""
    return _convert(tree, device, dtype)


def lora_from_numpy(tree: dict, device="cuda",
                    dtype: torch.dtype = torch.float32) -> dict:
    """A JAX LoRA tree (numpy leaves, ``{"blocks": [{"attn2": {"to_q":
    {"a": [in, r], "b": [r, out]}}}]}``) -> the port's, which keeps the
    same layout."""
    if isinstance(tree, dict):
        return {k: lora_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lora_from_numpy(v, device, dtype) for v in tree]
    return _tensor(np.asarray(tree), device, dtype)


# ---------------------------------------------------------------------------
# Single-file checkpoints (reference parameter names, torch layouts)
# ---------------------------------------------------------------------------

# diffusers-directory key names -> the reference's, applied by substring
# replacement key by key in table order (the VAE table's longest first)
TRANSFORMER_KEYS_RENAME = {
    "proj_in": "patchify_proj",
    "time_embed": "adaln_single",
    "norm_q": "q_norm",
    "norm_k": "k_norm",
}

VAE_KEYS_RENAME = {
    "decoder.up_blocks.3.conv_in": "decoder.up_blocks.7",
    "decoder.up_blocks.3.upsamplers.0": "decoder.up_blocks.8",
    "decoder.up_blocks.3": "decoder.up_blocks.9",
    "decoder.up_blocks.2.upsamplers.0": "decoder.up_blocks.5",
    "decoder.up_blocks.2.conv_in": "decoder.up_blocks.4",
    "decoder.up_blocks.2": "decoder.up_blocks.6",
    "decoder.up_blocks.1.upsamplers.0": "decoder.up_blocks.2",
    "decoder.up_blocks.1": "decoder.up_blocks.3",
    "decoder.up_blocks.0": "decoder.up_blocks.1",
    "decoder.mid_block": "decoder.up_blocks.0",
    "encoder.down_blocks.3": "encoder.down_blocks.8",
    "encoder.down_blocks.2.downsamplers.0": "encoder.down_blocks.7",
    "encoder.down_blocks.2": "encoder.down_blocks.6",
    "encoder.down_blocks.1.downsamplers.0": "encoder.down_blocks.4",
    "encoder.down_blocks.1.conv_out": "encoder.down_blocks.5",
    "encoder.down_blocks.1": "encoder.down_blocks.3",
    "encoder.down_blocks.0.conv_out": "encoder.down_blocks.2",
    "encoder.down_blocks.0.downsamplers.0": "encoder.down_blocks.1",
    "encoder.down_blocks.0": "encoder.down_blocks.0",
    "encoder.mid_block": "encoder.down_blocks.9",
    "conv_shortcut.conv": "conv_shortcut",
    "resnets": "res_blocks",
    "norm3": "norm3.norm",
    "latents_mean": "per_channel_statistics.mean-of-means",
    "latents_std": "per_channel_statistics.std-of-means",
}


def normalize_diffusers_state(state: Dict[str, Any], kind: str) -> Dict[str, Any]:
    """A diffusers directory's state dict -> the reference's key names
    (``kind``: "transformer" or "vae"), every rule of the table tried on
    every key in order; the values are kept as they are."""
    table = TRANSFORMER_KEYS_RENAME if kind == "transformer" else VAE_KEYS_RENAME
    out = {}
    for key, value in state.items():
        for old, new in table.items():
            key = key.replace(old, new)
        out[key] = value
    return out


TRANSFORMER_PREFIX = "model.diffusion_model."
VAE_PREFIX = "vae."
PER_CHANNEL_STATISTICS_PREFIX = "per_channel_statistics."


class _TrackedState(dict):
    """A dict that records which keys were read."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)

    def unused(self):
        return set(self.keys()) - self.consumed


def _linear_from_state(s, key: str) -> dict:
    p = {"weight": s[f"{key}.weight"]}
    if f"{key}.bias" in s:
        p["bias"] = s[f"{key}.bias"]
    return p


def _attn_from_state(s, prefix: str) -> dict:
    p = {name: _linear_from_state(s, f"{prefix}.{name}")
         for name in ("to_q", "to_k", "to_v")}
    p["to_out"] = _linear_from_state(s, f"{prefix}.to_out.0")
    for norm in ("q_norm", "k_norm"):
        if f"{prefix}.{norm}.weight" in s:
            p[norm] = {"scale": s[f"{prefix}.{norm}.weight"]}
            if f"{prefix}.{norm}.bias" in s:
                p[norm]["bias"] = s[f"{prefix}.{norm}.bias"]
    return p


def import_transformer_state(state: Dict[str, torch.Tensor], cfg: DiTConfig,
                             strict: bool = True, device="cuda",
                             dtype: Optional[torch.dtype] = None) -> dict:
    """A reference-named transformer state dict -> the port's DiT tree
    (unpermuted), each tensor moved to ``device`` and, if given, ``dtype``.
    ``strict``: raise on a key the tree does not take."""
    s = _TrackedState({k: v.to(device=device, dtype=dtype if dtype is not None and v.ndim
                                else None) for k, v in state.items()})
    emb = "adaln_single.emb.timestep_embedder"
    params: Dict[str, Any] = {
        "patchify_proj": _linear_from_state(s, "patchify_proj"),
        "adaln_single": {
            "emb": {"linear_1": _linear_from_state(s, f"{emb}.linear_1"),
                    "linear_2": _linear_from_state(s, f"{emb}.linear_2")},
            "linear": _linear_from_state(s, "adaln_single.linear"),
        },
        "scale_shift_table": s["scale_shift_table"],
        "proj_out": _linear_from_state(s, "proj_out"),
    }
    if "caption_projection.linear_1.weight" in s:
        params["caption_projection"] = {
            "linear_1": _linear_from_state(s, "caption_projection.linear_1"),
            "linear_2": _linear_from_state(s, "caption_projection.linear_2"),
        }
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"transformer_blocks.{i}"
        block: Dict[str, Any] = {
            "attn1": _attn_from_state(s, f"{pre}.attn1"),
            "attn2": _attn_from_state(s, f"{pre}.attn2"),
            "ff": {"proj_in": _linear_from_state(s, f"{pre}.ff.net.0.proj"),
                   "proj_out": _linear_from_state(s, f"{pre}.ff.net.2")},
            "scale_shift_table": s[f"{pre}.scale_shift_table"],
        }
        for norm in ("norm1", "norm2"):
            if f"{pre}.{norm}.weight" in s:
                block[norm] = {"scale": s[f"{pre}.{norm}.weight"]}
        blocks.append(block)
    params["blocks"] = blocks
    if strict and s.unused():
        raise ValueError(
            f"Unconsumed transformer checkpoint keys: {sorted(s.unused())[:10]} ...")
    return params


def export_transformer_state(params: dict, cfg: DiTConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`import_transformer_state`: reference names,
    CPU tensors in their dtypes. ``params`` must be unpermuted and hold
    plain (unquantized) linears."""
    s: Dict[str, torch.Tensor] = {}

    def put_linear(key, p):
        if "weight" not in p:
            raise ValueError(f"{key}: export needs an unquantized linear")
        s[f"{key}.weight"] = p["weight"]
        if "bias" in p:
            s[f"{key}.bias"] = p["bias"]

    emb = "adaln_single.emb.timestep_embedder"
    put_linear("patchify_proj", params["patchify_proj"])
    put_linear(f"{emb}.linear_1", params["adaln_single"]["emb"]["linear_1"])
    put_linear(f"{emb}.linear_2", params["adaln_single"]["emb"]["linear_2"])
    put_linear("adaln_single.linear", params["adaln_single"]["linear"])
    if "caption_projection" in params:
        put_linear("caption_projection.linear_1", params["caption_projection"]["linear_1"])
        put_linear("caption_projection.linear_2", params["caption_projection"]["linear_2"])
    s["scale_shift_table"] = params["scale_shift_table"]
    put_linear("proj_out", params["proj_out"])
    blocks = params["blocks"]
    if not isinstance(blocks, (list, tuple)):
        from avatar_tpu_torch.models.dit import unstack_block_params

        blocks = unstack_block_params(blocks)
    for i, block in enumerate(blocks):
        pre = f"transformer_blocks.{i}"
        for attn_name in ("attn1", "attn2"):
            a = block[attn_name]
            for proj in ("to_q", "to_k", "to_v"):
                put_linear(f"{pre}.{attn_name}.{proj}", a[proj])
            put_linear(f"{pre}.{attn_name}.to_out.0", a["to_out"])
            for norm in ("q_norm", "k_norm"):
                if norm in a:
                    s[f"{pre}.{attn_name}.{norm}.weight"] = a[norm]["scale"]
                    if "bias" in a[norm]:
                        s[f"{pre}.{attn_name}.{norm}.bias"] = a[norm]["bias"]
        put_linear(f"{pre}.ff.net.0.proj", block["ff"]["proj_in"])
        put_linear(f"{pre}.ff.net.2", block["ff"]["proj_out"])
        s[f"{pre}.scale_shift_table"] = block["scale_shift_table"]
        for norm in ("norm1", "norm2"):
            if norm in block:
                s[f"{pre}.{norm}.weight"] = block[norm]["scale"]
    return {k: v.detach().cpu().contiguous() for k, v in s.items()}


# ---------------------------------------------------------------------------
# VAE state (reference names, torch layouts) <-> the port's VAE tree
# ---------------------------------------------------------------------------


def _conv_from_state(s, prefix: str) -> dict:
    """A CausalConv3d (its ``.conv`` submodule) or a plain conv."""
    key = f"{prefix}.conv.weight" if f"{prefix}.conv.weight" in s else f"{prefix}.weight"
    p = {"weight": s[key]}
    bkey = key.replace("weight", "bias")
    if bkey in s:
        p["bias"] = s[bkey]
    return p


def _norm_from_state(s, prefix: str) -> dict:
    p = {}
    if f"{prefix}.weight" in s:
        p["scale"] = s[f"{prefix}.weight"]
    if f"{prefix}.bias" in s:
        p["bias"] = s[f"{prefix}.bias"]
    return p


def _resnet_from_state(s, prefix: str) -> dict:
    p: Dict[str, Any] = {
        "norm1": _norm_from_state(s, f"{prefix}.norm1"),
        "conv1": _conv_from_state(s, f"{prefix}.conv1"),
        "norm2": _norm_from_state(s, f"{prefix}.norm2"),
        "conv2": _conv_from_state(s, f"{prefix}.conv2"),
    }
    if f"{prefix}.conv_shortcut.weight" in s:
        # a 1x1x1 conv, kept as the linear [out, in] it is
        p["conv_shortcut"] = {"weight": s[f"{prefix}.conv_shortcut.weight"][:, :, 0, 0, 0]}
        if f"{prefix}.conv_shortcut.bias" in s:
            p["conv_shortcut"]["bias"] = s[f"{prefix}.conv_shortcut.bias"]
        p["norm3"] = {"scale": s[f"{prefix}.norm3.norm.weight"],
                      "bias": s[f"{prefix}.norm3.norm.bias"]}
    for name in ("scale_shift_table", "per_channel_scale1", "per_channel_scale2"):
        if f"{prefix}.{name}" in s:
            p[name] = s[f"{prefix}.{name}"]
    return p


def _timestep_embedder_from_state(s, prefix: str) -> dict:
    return {name: _linear_from_state(s, f"{prefix}.timestep_embedder.{name}")
            for name in ("linear_1", "linear_2")}


def _mid_block_from_state(s, prefix: str, num_layers: int, has_attn: bool = False) -> dict:
    p: Dict[str, Any] = {"res_blocks": [
        _resnet_from_state(s, f"{prefix}.res_blocks.{j}") for j in range(num_layers)]}
    if f"{prefix}.time_embedder.timestep_embedder.linear_1.weight" in s:
        p["time_embedder"] = _timestep_embedder_from_state(s, f"{prefix}.time_embedder")
    if has_attn or f"{prefix}.attention_blocks.0.to_q.weight" in s:
        attn, j = [], 0
        while f"{prefix}.attention_blocks.{j}.to_q.weight" in s:
            attn.append(_attn_from_state(s, f"{prefix}.attention_blocks.{j}"))
            j += 1
        p["attention_blocks"] = attn
    return p


def import_vae_state(state: Dict[str, torch.Tensor], cfg: VAEConfig,
                     strict: bool = True, device="cuda",
                     dtype: Optional[torch.dtype] = None) -> dict:
    """A reference-named VAE state dict -> the port's VAE tree, each
    tensor moved to ``device`` and, if given, ``dtype`` (scalars stay f32).
    ``strict``: raise on a key the tree does not take."""
    s = _TrackedState({k: v.to(device=device, dtype=dtype if dtype is not None and v.ndim
                                else None) for k, v in state.items()})

    def coder(side: str, walk, blocks_key: str) -> dict:
        p: Dict[str, Any] = {
            "conv_in": _conv_from_state(s, f"{side}.conv_in"),
            "conv_norm_out": _norm_from_state(s, f"{side}.conv_norm_out"),
            "conv_out": _conv_from_state(s, f"{side}.conv_out"),
            "blocks": [],
        }
        for i, (name, bparams, _, _) in enumerate(walk):
            prefix = f"{side}.{blocks_key}.{i}"
            if name in ("res_x", "attn_res_x"):
                p["blocks"].append(_mid_block_from_state(
                    s, prefix, bparams["num_layers"], has_attn=name == "attn_res_x"))
            elif name == "res_x_y":
                p["blocks"].append(_resnet_from_state(s, prefix))
            elif name.startswith("compress") and (name.endswith("_res")
                                                  or side == "decoder"):
                p["blocks"].append({"conv": _conv_from_state(s, f"{prefix}.conv")})
            elif name.startswith("compress"):
                p["blocks"].append(_conv_from_state(s, prefix))  # a strided conv
            else:
                raise ValueError(name)
        return p

    params: Dict[str, Any] = {
        "encoder": coder("encoder", _encoder_channel_walk(cfg), "down_blocks"),
        "decoder": coder("decoder", _decoder_channel_walk(cfg), "up_blocks"),
    }
    dec = params["decoder"]
    if "decoder.timestep_scale_multiplier" in s:
        # a scalar, which some writers store with shape [1]
        dec["timestep_scale_multiplier"] = s["decoder.timestep_scale_multiplier"].float(
            ).reshape(())
    if "decoder.last_time_embedder.timestep_embedder.linear_1.weight" in s:
        dec["last_time_embedder"] = _timestep_embedder_from_state(
            s, "decoder.last_time_embedder")
        dec["last_scale_shift_table"] = s["decoder.last_scale_shift_table"]
    if "latent_norm_out.running_mean" in s:
        params["latent_norm"] = {"running_mean": s["latent_norm_out.running_mean"],
                                 "running_var": s["latent_norm_out.running_var"]}
        if "latent_norm_out.num_batches_tracked" in s:
            _ = s["latent_norm_out.num_batches_tracked"]  # consumed, unused
    stats = {}
    for key, ours in (("std-of-means", "std_of_means"), ("mean-of-means", "mean_of_means")):
        if f"{PER_CHANNEL_STATISTICS_PREFIX}{key}" in s:
            stats[ours] = s[f"{PER_CHANNEL_STATISTICS_PREFIX}{key}"]
    if stats:
        stats.setdefault("mean_of_means", torch.zeros_like(stats["std_of_means"]))
        params["per_channel_statistics"] = stats
    if strict and s.unused():
        raise ValueError(f"Unconsumed VAE checkpoint keys: {sorted(s.unused())[:10]} ...")
    return params


def export_vae_state(params: dict, cfg: VAEConfig) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`import_vae_state`: reference names, CPU
    tensors in their dtypes."""
    s: Dict[str, torch.Tensor] = {}

    def put(key, p, names=(("weight", "weight"), ("bias", "bias"))):
        for ours, theirs in names:
            if ours in p:
                s[f"{key}.{theirs}"] = p[ours]

    def put_conv(key, p):
        put(f"{key}.conv", p)

    def put_norm(key, p):
        put(key, p, (("scale", "weight"), ("bias", "bias")))

    def put_resnet(prefix, p):
        put_norm(f"{prefix}.norm1", p["norm1"])
        put_conv(f"{prefix}.conv1", p["conv1"])
        put_norm(f"{prefix}.norm2", p["norm2"])
        put_conv(f"{prefix}.conv2", p["conv2"])
        if "conv_shortcut" in p:
            s[f"{prefix}.conv_shortcut.weight"] = p["conv_shortcut"]["weight"][
                :, :, None, None, None]
            if "bias" in p["conv_shortcut"]:
                s[f"{prefix}.conv_shortcut.bias"] = p["conv_shortcut"]["bias"]
            put_norm(f"{prefix}.norm3.norm", p["norm3"])
        for name in ("scale_shift_table", "per_channel_scale1", "per_channel_scale2"):
            if name in p:
                s[f"{prefix}.{name}"] = p[name]

    def put_embedder(prefix, p):
        for name in ("linear_1", "linear_2"):
            put(f"{prefix}.timestep_embedder.{name}", p[name])

    def put_mid(prefix, p):
        for j, rb in enumerate(p["res_blocks"]):
            put_resnet(f"{prefix}.res_blocks.{j}", rb)
        if "time_embedder" in p:
            put_embedder(f"{prefix}.time_embedder", p["time_embedder"])
        for j, a in enumerate(p.get("attention_blocks") or []):
            pre = f"{prefix}.attention_blocks.{j}"
            for proj in ("to_q", "to_k", "to_v"):
                put(f"{pre}.{proj}", a[proj])
            put(f"{pre}.to_out.0", a["to_out"])
            for norm in ("q_norm", "k_norm"):
                if norm in a:
                    put_norm(f"{pre}.{norm}", a[norm])

    for side, walk, blocks_key in (
        ("encoder", _encoder_channel_walk(cfg), "down_blocks"),
        ("decoder", _decoder_channel_walk(cfg), "up_blocks"),
    ):
        p = params[side]
        put_conv(f"{side}.conv_in", p["conv_in"])
        put_norm(f"{side}.conv_norm_out", p["conv_norm_out"])
        put_conv(f"{side}.conv_out", p["conv_out"])
        for i, (name, _, _, _) in enumerate(walk):
            prefix, bp = f"{side}.{blocks_key}.{i}", p["blocks"][i]
            if name in ("res_x", "attn_res_x"):
                put_mid(prefix, bp)
            elif name == "res_x_y":
                put_resnet(prefix, bp)
            elif name.startswith("compress") and (name.endswith("_res")
                                                  or side == "decoder"):
                put_conv(f"{prefix}.conv", bp["conv"])
            elif name.startswith("compress"):
                put_conv(prefix, bp)
            else:
                raise ValueError(name)
    dec = params["decoder"]
    if "timestep_scale_multiplier" in dec:
        s["decoder.timestep_scale_multiplier"] = dec["timestep_scale_multiplier"]
    if "last_time_embedder" in dec:
        put_embedder("decoder.last_time_embedder", dec["last_time_embedder"])
        s["decoder.last_scale_shift_table"] = dec["last_scale_shift_table"]
    if "latent_norm" in params:
        s["latent_norm_out.running_mean"] = params["latent_norm"]["running_mean"]
        s["latent_norm_out.running_var"] = params["latent_norm"]["running_var"]
    if "per_channel_statistics" in params:
        st = params["per_channel_statistics"]
        s[f"{PER_CHANNEL_STATISTICS_PREFIX}std-of-means"] = st["std_of_means"]
        s[f"{PER_CHANNEL_STATISTICS_PREFIX}mean-of-means"] = st["mean_of_means"]
    return {k: v.detach().cpu().contiguous() for k, v in s.items()}


def load_single_file_checkpoint(
    path: Union[str, Path],
) -> Tuple[dict, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(configs, transformer_state, vae_state) of a single-file checkpoint,
    prefixes stripped; a key with neither prefix belongs to the
    transformer, except the VAE's bare per-channel statistics."""
    tensors, metadata = load_safetensors(path)
    configs = json.loads(metadata["config"]) if "config" in metadata else {}
    transformer_state, vae_state = {}, {}
    for k, v in tensors.items():
        if k.startswith(TRANSFORMER_PREFIX):
            transformer_state[k[len(TRANSFORMER_PREFIX):]] = v
        elif k.startswith(VAE_PREFIX):
            vae_state[k[len(VAE_PREFIX):]] = v
        elif k.startswith(PER_CHANNEL_STATISTICS_PREFIX):
            vae_state[k] = v
        else:
            transformer_state[k] = v
    return configs, transformer_state, vae_state


def load_checkpoint(path: Union[str, Path], device="cuda",
                    dtype: Optional[torch.dtype] = None):
    """A single-file checkpoint read whole: (dit_cfg, dit_params, vae_cfg,
    vae_params, scheduler_cfg), the trees on ``device`` (in ``dtype`` if
    given; scalars stay f32), the DiT's unpermuted."""
    configs, t_state, v_state = load_single_file_checkpoint(path)
    dit_cfg = DiTConfig.from_dict(configs["transformer"])
    vae_cfg = VAEConfig.from_dict(configs["vae"])
    dit_params = import_transformer_state(t_state, dit_cfg, device=device, dtype=dtype)
    vae_params = import_vae_state(v_state, vae_cfg, device=device, dtype=dtype)
    return dit_cfg, dit_params, vae_cfg, vae_params, configs.get("scheduler")


def save_single_file_checkpoint(
    path: Union[str, Path],
    dit_params: dict,
    dit_cfg: DiTConfig,
    vae_state: Optional[Dict[str, torch.Tensor]] = None,
    vae_config: Optional[dict] = None,
    scheduler_config: Optional[dict] = None,
) -> None:
    """Write a single-file checkpoint: the transformer's state under
    ``model.diffusion_model.``, ``vae_state`` (as read by
    :func:`load_single_file_checkpoint`) under ``vae.``, and the configs as
    JSON in the ``config`` metadata."""
    t_state = export_transformer_state(dit_params, dit_cfg)
    tensors = {f"{TRANSFORMER_PREFIX}{k}": v for k, v in t_state.items()}
    configs: Dict[str, Any] = {"transformer": dit_cfg.to_dict()}
    if vae_state is not None:
        # every VAE key, per-channel statistics included, carries the
        # prefix: a reference loader keeps only "vae." keys once any exist
        tensors.update({f"{VAE_PREFIX}{k}": v for k, v in vae_state.items()})
        configs["vae"] = vae_config
    if scheduler_config is not None:
        configs["scheduler"] = scheduler_config
    save_safetensors(tensors, path, metadata={"config": json.dumps(configs)})


# ---------------------------------------------------------------------------
# Wan2.1 (models/wan.py, models/wan_vae.py): the published state dicts
# ---------------------------------------------------------------------------

# the Sequential / ModuleList names whose children are numbered 0 .. n - 1
WAN_LISTS = frozenset({"blocks", "downsamples", "upsamples", "middle"})


def wan_params_from_state_dict(state: Dict[str, Any], device=None,
                               dtype: Optional[torch.dtype] = None) -> dict:
    """The nested tree of a published Wan2.1 state dict (the DiT's
    ``diffusion_pytorch_model*.safetensors`` or the VAE's ``Wan2.1_VAE.pth``
    keys): ``blocks.3.self_attn.q.weight`` -> ``tree["blocks"][3]["self_attn"]
    ["q"]["weight"]``, every tensor in its published shape (moved to
    ``device`` / ``dtype`` where given). The tree stays unpermuted:
    ``pipelines/wan_i2v.py`` makes the split-RoPE layout of self-attention
    itself, once (``models/wan.py:permute_wan_params_for_split_rope``: the
    per-head interleaved RoPE pairs to split halves)."""
    tree: dict = {}
    for key, value in state.items():
        t = torch.as_tensor(value)
        if device is not None or dtype is not None:
            t = t.to(device=device, dtype=dtype)
        node, parts = tree, key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t

    def lists(node, name=""):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v, k) for k, v in node.items()}
        if name in WAN_LISTS:
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)

