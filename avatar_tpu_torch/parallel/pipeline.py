"""Pipeline parallelism: GPipe-style stage-sharded DiT over a 'pp' mesh axis
(port of ``avatar_tpu/parallel/pipeline.py``).

The transformer blocks are stacked on a leading layer axis
(:func:`stack_block_params`) and each stage rank holds only its L/S
contiguous blocks (:func:`pp_param_sharding`). Microbatches stream through
the stages: stage i applies its blocks to microbatch j once stage i - 1
has sent it, then sends the result to stage i + 1; after M + S - 1 ticks
all M microbatches have drained (the bubble is (S-1)/(M+S-1)).

Everything outside the blocks (token projection, RoPE tables, AdaLN
embedding, caption projection, output head) runs replicated on every
rank. The last stage's outputs reach every rank through one all-reduce of
the stages' contributions (zeros elsewhere), as the reference's ``psum``.
The schedule is differentiable: the hand-off's backward sends each
activation's gradient back to the stage it came from.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from avatar_tpu_torch.parallel.collectives import (
    AxisGroup,
    all_gather,
    chunk_of,
    psum,
    recv_forward,
    send_forward,
)


def stack_block_params(blocks: Sequence[dict]) -> dict:
    """List of per-block param dicts of one structure -> one tree whose
    leaves carry a leading layer axis [L, ...]."""
    first = blocks[0]
    if isinstance(first, dict):
        return {k: stack_block_params([blk[k] for blk in blocks]) for k in first}
    return torch.stack(list(blocks))


def _layer_slice(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def _num_stacked(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def unstack_block_params(stacked: dict) -> List[dict]:
    """Inverse of :func:`stack_block_params` (the slices are views)."""
    return [_layer_slice(stacked, i) for i in range(_num_stacked(stacked))]


def make_pp_mesh(pp: int, data: int = 1, devices=None):
    """A ('data', 'pp') mesh. Adjacent pipeline stages are adjacent ranks."""
    from avatar_tpu_torch.parallel.mesh import Mesh, world_devices

    devices = list(devices if devices is not None else world_devices())
    assert data * pp == len(devices), (data, pp, len(devices))
    return Mesh(np.asarray(devices).reshape(data, pp), ("data", "pp"))


def pp_param_sharding(mesh, params: dict, axis: str = "pp"):
    """Per leaf of a DiT param tree whose "blocks" are stacked: the spec
    (the axis over each dim) that shards the leading layer axis of every
    block leaf over ``axis``; None (replicated) elsewhere."""
    from avatar_tpu_torch.parallel.mesh import map_with_path

    assert not isinstance(params["blocks"], list), (
        "stack params['blocks'] with stack_block_params first")
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    out = {k: map_with_path(lambda p, x: None, v) for k, v in params.items()}
    out["blocks"] = map_with_path(
        lambda p, x: (axis,) + (None,) * (x.ndim - 1), params["blocks"])
    return out


def _stage_layers(tree, num_layers: int, pg: AxisGroup, dim: int = 0):
    """This stage's L/S layers of a tree stacked on ``dim``: the tree as it
    is when it holds L/S layers already (a stage's params), else its
    slice of the L."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _stage_layers(v, num_layers, pg, dim) for k, v in tree.items()}
    if tree.shape[dim] == num_layers // pg.size:
        return tree
    if tree.shape[dim] != num_layers:
        raise ValueError(f"layer axis {tree.shape[dim]}: expected {num_layers} "
                         f"or {num_layers // pg.size}")
    return chunk_of(tree, pg, dim)


def dit_apply_pp(
    params: dict,  # dit params, params["blocks"] stacked [L or L/S, ...]
    cfg,
    hidden_states: torch.Tensor,  # [B, N, in_channels]
    indices_grid: Optional[torch.Tensor],  # [B, 3, N]
    timestep: Optional[torch.Tensor],  # [B] or [B, N]
    encoder_hidden_states: Optional[torch.Tensor] = None,
    encoder_attention_mask: Optional[torch.Tensor] = None,
    *,
    mesh,
    num_microbatches: Optional[int] = None,
    axis: str = "pp",
    data_axis: Optional[str] = None,
    attention_impl: str = "auto",
    lora: Optional[dict] = None,  # lora["blocks"]: stacked or a list, L or L/S
    lora_scale: float = 1.0,
    remat=False,
    freqs_cis=None,
    rope_split: bool = False,
    skip_layer_mask: Optional[torch.Tensor] = None,  # [num_layers, B]
    skip_layer_strategy=None,
    cross_kv=None,  # per-block [(k, v), ...] or stacked (k [L, ...], v [L, ...])
    timestep_tables=None,
) -> torch.Tensor:
    """Pipeline-parallel ``dit_apply``: the full inputs on every rank in,
    the full output [B, N, out_channels] on every rank out.

    ``params["blocks"]`` (and ``lora["blocks"]``) are stacked and hold all
    L layers or this stage's L/S; so may the layer axis of
    ``skip_layer_mask`` ([L, B]) and of ``cross_kv``. Requirements:
    cfg.num_layers % S == 0, B % num_microbatches == 0. The default
    microbatch count is the largest divisor of B up to S. ``data_axis``:
    each microbatch's rows shard over that axis where it divides them,
    else every rank of it runs them all (the reference's fallback).

    Gradients: the final all-reduce's backward is an all-reduce, so a
    loss that every rank computes on the output counts once per rank of
    the axes; divide it by their size (``train/train.py`` does).
    """
    from avatar_tpu_torch.models.dit import (
        _dit_epilogue,
        _dit_prologue,
        apply_blocks,
        precompute_cross_attention_kv,
    )

    pg = mesh.group(axis)
    stages, sid = pg.size, pg.index
    blocks = params["blocks"]
    assert not isinstance(blocks, list), (
        "dit_apply_pp needs stacked blocks (stack_block_params) so the stage "
        "axis can shard; got a per-block list")
    num_layers = cfg.num_layers
    assert num_layers % stages == 0, (num_layers, stages)
    blocks = unstack_block_params(_stage_layers(blocks, num_layers, pg))
    lora_blocks = None
    if lora is not None:
        lora_blocks = lora["blocks"]
        if isinstance(lora_blocks, (list, tuple)):  # a stage's list, or all L
            per = num_layers // stages
            lora_blocks = list(lora_blocks)
            if len(lora_blocks) != per:
                lora_blocks = lora_blocks[sid * per:(sid + 1) * per]
        else:
            lora_blocks = unstack_block_params(_stage_layers(lora_blocks, num_layers, pg))

    b = hidden_states.shape[0]
    m = num_microbatches or max(d for d in range(1, min(b, stages) + 1) if b % d == 0)
    assert b % m == 0, f"batch {b} not divisible by microbatches {m}"
    b_m = b // m
    dg = mesh.group(data_axis) if data_axis is not None else None
    if dg is not None and b_m % dg.size != 0:
        dg = None  # tiny microbatches replicate over the data axis

    x, freqs_cis, ada, embedded = _dit_prologue(
        params, cfg, hidden_states, indices_grid, timestep, freqs_cis, timestep_tables,
        rope_split)
    kv_mask = None
    if encoder_attention_mask is not None:
        kv_mask = encoder_attention_mask.to(torch.float32).contiguous()
    if cross_kv is None:
        if encoder_hidden_states is None:
            raise ValueError("need encoder_hidden_states or cross_kv")
        cross_kv, _ = precompute_cross_attention_kv(
            dict(params, blocks=blocks), cfg, encoder_hidden_states, dtype=x.dtype,
            lora=None if lora is None else dict(lora, blocks=lora_blocks),
            lora_scale=lora_scale)
    if not torch.is_tensor(cross_kv[0]):  # per-block pairs -> the stacked pair
        cross_kv = (torch.stack([kv[0] for kv in cross_kv]),
                    torch.stack([kv[1] for kv in cross_kv]))
    cross_kv = tuple(_stage_layers(t, num_layers, pg) for t in cross_kv)
    slm = _stage_layers(skip_layer_mask, num_layers, pg)

    def rows(t, j, dim=0):
        """Microbatch j's rows of ``t`` (this rank's share over data)."""
        if t is None:
            return None
        t = t.narrow(dim, j * b_m, b_m)
        return t if dg is None else chunk_of(t, dg, dim)

    def stage(x_in, j):
        return apply_blocks(
            x_in, blocks, lora_blocks, tuple(rows(t, j, 1) for t in cross_kv), cfg,
            freqs_cis=tuple(rows(f, j) for f in freqs_cis), ada=rows(ada, j),
            kv_mask=rows(kv_mask, j), skip_layer_mask=rows(slm, j, 1),
            skip_layer_strategy=skip_layer_strategy, attention_impl=attention_impl,
            rope_split=rope_split, lora_scale=lora_scale, remat=remat)

    prev = pg.ranks[sid - 1] if sid > 0 else None
    nxt = pg.ranks[sid + 1] if sid < stages - 1 else None
    # ties the received activations into the graph, so that their backward
    # sends the gradient to the previous stage
    anchor = (x.new_zeros((), requires_grad=True)
              if torch.is_grad_enabled() and prev is not None else None)
    outs, handed = [], []
    for j in range(m):
        x_j = rows(x, j)
        if prev is not None:
            x_j = recv_forward(x_j, anchor, prev, pg.group, j)
        y = stage(x_j, j)
        if nxt is not None:
            handed.append(send_forward(y, nxt, pg.group, j))
        else:
            outs.append(y)
    if nxt is None:
        out = torch.stack(outs)
    else:
        # this stage's contribution to the broadcast is zeros, tied to the
        # hand-offs so that their backward runs
        out = torch.zeros((m,) + tuple(rows(x, 0).shape), dtype=x.dtype, device=x.device)
        out = out + 0 * torch.stack(handed).sum().to(x.dtype)
    out = psum(out, pg)  # [M, b_m (local), N, inner]
    if dg is not None:
        out = all_gather(out, dg, 1)
    out = out.reshape(b, *out.shape[2:])
    return _dit_epilogue(params, out, embedded)
