"""Device mesh and placement rules (port of ``avatar_tpu/parallel/mesh.py``).

One process per device on ``torch.distributed``: a :class:`Mesh` names
axes over the ranks, and device ``i`` of the reference's
``np.asarray(devices).reshape(...)`` is rank ``i``. Every rank of the
world builds the same mesh (its process groups are made collectively);
each axis, and each set of axes, gives this rank an
:class:`~avatar_tpu_torch.parallel.collectives.AxisGroup`.

Axes: ``data`` (batch), ``fsdp`` (parameter and optimizer-state sharding,
ZeRO-2/3), ``tp`` (tensor parallelism over attention heads and FFN
columns), ``sp`` (sequence), ``pp`` (pipeline stages).

The placement rules are functions of shapes: per leaf, the dim (of the
port's layout) that an axis shards, or None. They pick the same logical
axis as the JAX rules: a linear ``weight`` is [out, in] here and its JAX
``kernel`` [in, out], so the size ordering runs over the JAX layout.

Modes (``TrainConfig.sharding_mode``): ``dp`` replicates parameters and
optimizer state; ``zero2`` shards the optimizer state over ``fsdp`` (the
gradients are reduce-scattered, each rank updates its shard, the
parameters are all-gathered); ``fsdp`` shards the parameters too, each
block's gathered on use (``train/train.py``).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from avatar_tpu_torch.parallel.collectives import AxisGroup, chunk_of

MIN_SHARD_SIZE = 2**16


class Mesh:
    """Named axes over global ranks (``devices``: an integer array whose
    shape gives the axis sizes). Make it on every rank of the world, in
    the same order as every other mesh: its process groups are created
    collectively (one per line of every non-empty set of axes)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.shape} devices for axes {self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank() if self.distributed else 0
        if self.distributed and self.devices.size > dist.get_world_size():
            raise ValueError(f"mesh of {self.devices.size} ranks in a world of "
                             f"{dist.get_world_size()}")
        if not self.distributed and self.devices.size != 1:
            raise ValueError(f"a mesh of {self.devices.size} ranks needs an "
                             "initialized process group (parallel.initialize)")
        self._groups: Dict[Tuple[str, ...], AxisGroup] = {}
        n = len(self.axis_names)
        for k in range(1, n + 1):
            for axes in itertools.combinations(range(n), k):
                self._make_groups(axes)

    def _make_groups(self, axes: Tuple[int, ...]):
        names = tuple(self.axis_names[a] for a in axes)
        rest = [a for a in range(self.devices.ndim) if a not in axes]
        lines = np.transpose(self.devices, rest + list(axes)).reshape(
            -1, int(np.prod([self.devices.shape[a] for a in axes])))
        for line in lines:
            ranks = tuple(int(r) for r in line)
            group = dist.new_group(list(ranks)) if self.distributed else None
            if self.rank in ranks:
                self._groups[names] = AxisGroup(group, ranks, ranks.index(self.rank))

    def group(self, axes) -> AxisGroup:
        """This rank's group along ``axes`` (a name or names, in any order;
        empty: a trivial group of this rank alone)."""
        if isinstance(axes, str):
            axes = (axes,)
        names = tuple(a for a in self.axis_names if a in tuple(axes))
        if len(names) != len(tuple(axes)):
            raise ValueError(f"axes {axes} not all in {self.axis_names}")
        if not names:
            return AxisGroup(None, (self.rank,), 0)
        return self._groups[names]

    def size(self, axes=None) -> int:
        if axes is None:
            return int(self.devices.size)
        if isinstance(axes, str):
            axes = (axes,)
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def __repr__(self):
        return f"Mesh({self.shape}, devices={self.devices.tolist()})"


def world_devices() -> list:
    """The ranks of the world, in order (``[0]`` without a process group)."""
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    return [0]


def make_mesh(data: int = -1, fsdp: int = 1, tp: int = 1,
              devices: Optional[Sequence[int]] = None) -> Mesh:
    """A ('data', 'fsdp', 'tp') mesh. data=-1 absorbs the remainder."""
    devices = list(devices if devices is not None else world_devices())
    n = len(devices)
    if data == -1:
        assert n % (fsdp * tp) == 0, (n, fsdp, tp)
        data = n // (fsdp * tp)
    assert data * fsdp * tp == n, f"mesh {data}x{fsdp}x{tp} != {n} devices"
    return Mesh(np.asarray(devices).reshape(data, fsdp, tp), ("data", "fsdp", "tp"))


def replicated():
    """A replicated placement: no axis shards the tensor."""
    return None


def batch_sharding(mesh: Mesh) -> Tuple[str, ...]:
    """The axes the batch dim shards over: data and fsdp (fsdp consumes
    batch too in FSDP training, the ZeRO data layout)."""
    return tuple(a for a in ("data", "fsdp") if a in mesh.shape)


# ---------------------------------------------------------------------------
# Placement rules
# ---------------------------------------------------------------------------


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists (path: keys and
    indices from the root)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def jax_dim_order(path, shape) -> Tuple[int, ...]:
    """For each dim of the JAX layout, the port's dim that holds it: a
    linear ``weight`` is [out, in] here and its ``kernel`` [in, out] there
    (stacked: [L, out, in] against [L, in, out]); other leaves agree."""
    n = len(shape)
    if path and path[-1] == "weight" and n in (2, 3):
        return tuple(range(n - 2)) + (n - 1, n - 2)
    return tuple(range(n))


def largest_divisible_dim(path, shape, axis_size: int,
                          min_size: int = MIN_SHARD_SIZE) -> Optional[int]:
    """The reference's rule: of a leaf of at least ``min_size`` elements,
    the largest dim (of the JAX layout; ties to the lower) that
    ``axis_size`` divides, as a dim of the port's layout; else None."""
    shape = tuple(shape)
    if axis_size == 1 or not shape or int(np.prod(shape)) < min_size:
        return None
    order = jax_dim_order(path, shape)
    logical = [shape[d] for d in order]
    for i in sorted(range(len(logical)), key=lambda i: -logical[i]):
        if logical[i] % axis_size == 0:
            return order[i]
    return None


def param_sharding(mesh: Mesh, params, mode: str = "fsdp", min_size: int = MIN_SHARD_SIZE):
    """Per leaf, the dim sharded over 'fsdp' or None: none in "dp" and
    "zero2" mode (parameters replicated), else the reference's rule."""
    axis = mesh.shape.get("fsdp", 1)

    def spec_for(path, leaf):
        if mode in ("dp", "zero2"):
            return None
        return largest_divisible_dim(path, getattr(leaf, "shape", ()), axis, min_size)

    return map_with_path(spec_for, params)


def opt_state_sharding(mesh: Mesh, opt_state, mode: str = "fsdp",
                       min_size: int = MIN_SHARD_SIZE):
    """Per leaf of an optimizer state tree, the dim sharded over 'fsdp' or
    None: ZeRO-2 shards moments even where the parameters are replicated,
    fsdp mirrors the parameter rule, dp replicates everything."""
    axis = mesh.shape.get("fsdp", 1)
    if mode == "dp" or axis == 1:
        return map_with_path(lambda p, x: None, opt_state)
    return map_with_path(
        lambda path, leaf: largest_divisible_dim(path, getattr(leaf, "shape", ()), axis,
                                                 min_size), opt_state)


def dit_param_sharding(mesh: Mesh, dit_params, mode: str = "fsdp",
                       min_size: int = MIN_SHARD_SIZE):
    """Megatron tensor parallelism over 'tp' composed with the fsdp rule:
    per leaf a tuple with, for each dim of the port's layout, the axis
    that shards it or None.

    - attn to_q/to_k/to_v and ff proj_in: column-parallel (output dim over
      'tp': heads and FFN columns split);
    - attn to_out and ff proj_out: row-parallel (input dim over 'tp', one
      all-reduce after the product);
    - everything else follows :func:`param_sharding`.

    The port's tp forward (:func:`shard_dit_params_tp`, ``dit_apply_tp``)
    slices the unpermuted tree by these specs: there each rank's columns
    are whole heads.
    """
    tp = mesh.shape.get("tp", 1)
    fsdp = mesh.shape.get("fsdp", 1)

    def fsdp_spec(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        d = (None if mode in ("dp", "zero2")
             else largest_divisible_dim(path, shape, fsdp, min_size))
        return tuple("fsdp" if i == d else None for i in range(len(shape)))

    result = map_with_path(fsdp_spec, dit_params)
    if tp == 1:
        return result

    def linear_spec(weight, out_dim: bool):
        # the JAX kernel is [in, out]: column-parallel shards out (port dim
        # 0), row-parallel shards in (port dim 1); fsdp takes the other one
        shape = weight.shape
        tp_dim = 0 if out_dim else 1
        other = 1 - tp_dim
        spec_ = [None, None]
        if shape[tp_dim] % tp == 0:
            spec_[tp_dim] = "tp"
        if mode == "fsdp" and fsdp > 1 and shape[other] % fsdp == 0:
            spec_[other] = "fsdp"
        return tuple(spec_)

    for i, block in enumerate(dit_params["blocks"]):
        specs = result["blocks"][i]
        layers = [(block[a][n], specs[a][n], n != "to_out")
                  for a in ("attn1", "attn2") for n in ("to_q", "to_k", "to_v", "to_out")]
        layers += [(block["ff"][n], specs["ff"][n], n == "proj_in")
                   for n in ("proj_in", "proj_out")]
        for params, spec, column in layers:
            spec["weight"] = linear_spec(params["weight"], column)
            if "bias" in params and column:
                spec["bias"] = ("tp",)
    return result


def _shard_leaf(mesh: Mesh, x, spec):
    """This rank's shard of ``x`` under ``spec`` (an int dim over 'fsdp',
    a tuple of axis names per dim, or None)."""
    if spec is None or not torch.is_tensor(x):
        return x
    if isinstance(spec, int):
        spec = tuple("fsdp" if d == spec else None for d in range(x.ndim))
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = chunk_of(x, mesh.group(axis), dim)
    return x.contiguous()


def shard_pytree(tree, shardings, mesh: Mesh):
    """This rank's shard of every leaf of ``tree`` under ``shardings`` (a
    tree of specs from the rules above)."""
    if isinstance(tree, dict):
        return {k: shard_pytree(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_pytree(v, s, mesh) for v, s in zip(tree, shardings)]
    return _shard_leaf(mesh, tree, shardings)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------


def shard_dit_params_tp(params: dict, cfg, mesh: Mesh, axis: str = "tp",
                        rope_split: bool = True) -> dict:
    """This rank's tensor-parallel share of an UNPERMUTED DiT tree (the
    layout of ``LTXVideoPipeline.raw_dit_params``): the column-parallel
    q/k/v and proj_in rows of its H/tp heads (their bias and q/k norm
    scales too), the row-parallel to_out and proj_out columns (their bias
    whole, added once after the all-reduce), everything else whole; the
    slices are :func:`dit_param_sharding`'s blocks. With ``rope_split``
    the local attn1 q/k rows are then put in the split-RoPE layout of the
    local heads, so each rank's split halves hold only its own heads."""
    import dataclasses

    from avatar_tpu_torch.models.dit import permute_dit_params_for_split_rope

    ag = mesh.group(axis)
    tp = ag.size
    if cfg.num_attention_heads % tp:
        raise ValueError(f"{cfg.num_attention_heads} heads over tp={tp}")

    def col(p):
        return {k: chunk_of(v, ag, 0).contiguous() if k in ("weight", "bias") else v
                for k, v in p.items()}

    def row(p):
        return dict(p, weight=chunk_of(p["weight"], ag, 1).contiguous())

    blocks = []
    for block in params["blocks"]:
        if any("weight" not in block[a][n] for a in ("attn1", "attn2")
               for n in ("to_q", "to_k", "to_v", "to_out")):
            raise ValueError("tensor parallelism takes float weights (no int8 tree)")
        new = dict(block)
        for a in ("attn1", "attn2"):
            attn = dict(block[a])
            for n in ("to_q", "to_k", "to_v"):
                attn[n] = col(attn[n])
            for n in ("q_norm", "k_norm"):
                if n in attn:
                    attn[n] = {k: chunk_of(v, ag, 0).contiguous() for k, v in attn[n].items()}
            attn["to_out"] = row(attn["to_out"])
            new[a] = attn
        new["ff"] = dict(block["ff"], proj_in=col(block["ff"]["proj_in"]),
                         proj_out=row(block["ff"]["proj_out"]))
        blocks.append(new)
    local = dict(params, blocks=blocks)
    if rope_split:
        local_cfg = dataclasses.replace(cfg, num_attention_heads=cfg.num_attention_heads // tp)
        local = permute_dit_params_for_split_rope(local, local_cfg)
    return local


def tp_freqs(freqs_cis, ag, rope_split: bool):
    """This rank's channels of the full (cos, sin) RoPE tables: the
    interleaved tables' contiguous block of its heads, split-half after
    that with ``rope_split``."""
    from avatar_tpu_torch.ops.rope import split_freqs

    local = tuple(chunk_of(f, ag, f.ndim - 1) for f in freqs_cis)
    return split_freqs(local) if rope_split else local


def dit_apply_tp(
    params: dict,  # shard_dit_params_tp's tree
    cfg,
    hidden_states: torch.Tensor,
    indices_grid: Optional[torch.Tensor],
    timestep: Optional[torch.Tensor],
    encoder_hidden_states: Optional[torch.Tensor] = None,
    encoder_attention_mask: Optional[torch.Tensor] = None,
    *,
    mesh: Mesh,
    axis: str = "tp",
    rope_split: bool = True,
    freqs_cis=None,
    cross_kv=None,
    **kwargs,
) -> torch.Tensor:
    """Tensor-parallel ``dit_apply`` (inference): the full inputs on every
    rank of ``axis``, each rank's heads and FFN columns from
    :func:`shard_dit_params_tp`, two all-reduces a block (after to_out and
    proj_out) and one each for the q and k norms' sums; the full output
    on every rank. ``freqs_cis``, if given, is the full interleaved (cos,
    sin) pair; ``cross_kv`` this rank's (from
    ``precompute_cross_attention_kv(..., tp_axis=...)``). Other keywords go
    to ``dit_apply``."""
    from avatar_tpu_torch.models.dit import dit_apply
    from avatar_tpu_torch.ops.rope import precompute_freqs_cis

    ag = mesh.group(axis)
    if freqs_cis is None:
        freqs_cis = precompute_freqs_cis(
            indices_grid, dim=cfg.inner_dim, theta=cfg.positional_embedding_theta,
            max_pos=cfg.positional_embedding_max_pos, out_dtype=hidden_states.dtype)
    with torch.no_grad():
        return dit_apply(params, cfg, hidden_states, indices_grid, timestep,
                         encoder_hidden_states, encoder_attention_mask,
                         freqs_cis=tp_freqs(freqs_cis, ag, rope_split),
                         rope_split=rope_split, cross_kv=cross_kv, tp_axis=ag, **kwargs)
