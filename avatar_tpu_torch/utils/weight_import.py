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
for w8a8.

The DiT tree must be the **unpermuted** one: the port's pipeline applies
the split-RoPE permutation itself at construction. Its blocks may be a
list or one tree stacked on a leading layer axis (``[L, in, out]`` kernels
become ``[L, out, in]``); the layout carries over.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from avatar_tpu_torch.models.dit import DiTConfig
from avatar_tpu_torch.models.vae import VAEConfig


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
                else:
                    w = _swap_last(w, stacked)
                out["weight"] = _tensor(w, device, dtype)
            elif key in ("kernel_q", "kernel_q8"):
                w = np.asarray(val)
                if w.ndim == 5:
                    raise NotImplementedError(
                        "int8 conv3d (quantized VAE params) is not ported")
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
    if cfg.normalize_latent_channels and "latent_norm" in tree:
        raise NotImplementedError("normalize_latent_channels is not ported yet")
    return _convert(tree, device, dtype)
