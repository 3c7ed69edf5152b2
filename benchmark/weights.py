"""The benchmark's weights: made on the device from ``--seed``, in the
type they are served in, in a few large draws.

The program's initializers give only the tree's layout (its keys and
shapes) and its constants (norm scales, latent statistics, the decoder's
timestep multiplier); every weight, bias and AdaLN table is then written
from one seeded uniform draw per chunk of the tree, at the published
initializers' scales: weights +-sqrt(3 / fan_in), biases +-1 / sqrt(fan_in),
AdaLN tables of standard deviation 1 / sqrt(width). The same tree goes to
the program and to the plain reference.
"""

from __future__ import annotations

import math

import torch

CHUNK = 1 << 28  # elements of one draw


def _seeded_leaves(tree, out):
    """(tensor, bound) of every leaf the seed writes, in tree order."""
    if isinstance(tree, list):
        for v in tree:
            _seeded_leaves(v, out)
        return out
    if not isinstance(tree, dict):
        return out
    w = tree.get("weight")
    if torch.is_tensor(w) and w.ndim >= 2:
        fan_in = math.prod(w.shape[1:])
        out.append((w, math.sqrt(3.0 / fan_in)))
        if torch.is_tensor(tree.get("bias")):
            out.append((tree["bias"], 1.0 / math.sqrt(fan_in)))
    for key, v in tree.items():
        if key.endswith("scale_shift_table") and torch.is_tensor(v):
            out.append((v, math.sqrt(3.0) * v.shape[-1] ** -0.5))
        elif isinstance(v, (dict, list)):
            _seeded_leaves(v, out)
    return out


def fill(tree, generator: torch.Generator) -> None:
    """Overwrites the tree's weights, biases and AdaLN tables in place with
    seeded uniform draws on their device, in their dtype."""
    leaves = _seeded_leaves(tree, [])
    i = 0
    while i < len(leaves):
        j, n = i, 0
        while j < len(leaves) and (n == 0 or n + leaves[j][0].numel() <= CHUNK):
            n += leaves[j][0].numel()
            j += 1
        t0 = leaves[i][0]
        flat = torch.rand(n, generator=generator, device=t0.device, dtype=t0.dtype)
        flat.mul_(2).sub_(1)
        off = 0
        for t, bound in leaves[i:j]:
            k = t.numel()
            t.copy_(flat[off:off + k].view(t.shape)).mul_(bound)
            off += k
        i = j


def make_models(dit_cfg: dict, vae_cfg: dict, seed: int, device: str = "cuda",
                dtype=torch.bfloat16):
    """(DiTConfig, dit params, VAEConfig, vae params) of the configuration
    file's ``dit`` and ``vae`` entries, weights from ``seed``."""
    from avatar_tpu_torch.models.dit import DiTConfig, init_dit
    from avatar_tpu_torch.models.vae import VAEConfig, init_vae

    dcfg = DiTConfig.from_dict(dit_cfg)
    vcfg = VAEConfig.from_dict(vae_cfg)
    dit = init_dit(dcfg, seed=0, device=device, dtype=dtype)
    vae = init_vae(vcfg, seed=0, device=device, dtype=dtype)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    fill(dit, g)
    fill(vae, g)
    return dcfg, dit, vcfg, vae


def make_dit(dit_cfg: dict, seed: int, device: str = "cuda", dtype=torch.bfloat16):
    """(DiTConfig, dit params) alone, the same weights as :func:`make_models`'s."""
    from avatar_tpu_torch.models.dit import DiTConfig, init_dit

    dcfg = DiTConfig.from_dict(dit_cfg)
    dit = init_dit(dcfg, seed=0, device=device, dtype=dtype)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    fill(dit, g)
    return dcfg, dit
