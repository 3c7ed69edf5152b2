"""Multi-process execution (port of ``avatar_tpu/parallel/distributed.py``).

One process per device on ``torch.distributed``: NCCL for CUDA tensors,
gloo only when the caller asks for the CPU. Nothing falls back from one
to the other, and an entry point that is not asked for the CPU and finds
no GPU raises.

- :func:`initialize` joins the job from explicit ``--coordinator /
  --num_processes / --process_id`` flags or from the variables a GPU
  launcher sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``); it is a no-op when neither is there.
- every process loads only its own rows (:func:`process_local_slice`);
  in torch a rank's local tensor is its shard
  (:func:`global_batch_from_local` checks the shapes and places it);
- :func:`put_global` / :func:`shard_pytree_global` keep this rank's
  shard of each leaf, :func:`gather_to_host` all-gathers the shards into
  full tensors on every rank (checkpoint export), :func:`sync_processes`
  is a barrier.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from avatar_tpu_torch.parallel.collectives import all_gather_plain
from avatar_tpu_torch.parallel.mesh import Mesh, _shard_leaf

# Variables whose presence means "one process of a multi-process job"
# (torchrun and other GPU launchers set them)
_CLUSTER_ENV_VARS = ("MASTER_ADDR", "WORLD_SIZE")

DEFAULT_TIMEOUT_S = 600.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the multi-process job if one is configured; no-op otherwise.

    Returns True iff a process group is (now) initialized. Explicit
    arguments win; else ``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` from the environment. On the card
    (``device`` "cuda") the backend is NCCL and this process's device is
    ``local_device_ids[0]``, else ``LOCAL_RANK``, else 0; with ``device``
    "cpu" it is gloo. ``timeout_s`` bounds every collective: a rank that
    never arrives fails the job instead of hanging it.
    """
    if dist.is_initialized():
        return True
    explicit = coordinator_address is not None or num_processes is not None
    auto = all(os.environ.get(v) for v in _CLUSTER_ENV_VARS)
    if not explicit and not auto:
        return False
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device (pass "
                               "device='cpu' for gloo on the CPU)")
        local = (local_device_ids[0] if local_device_ids
                 else int(env.get("LOCAL_RANK", device.index or 0)))
        torch.cuda.set_device(local)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=timedelta(seconds=timeout_s))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0 gate for logging and checkpoint export."""
    return process_index() == 0


def process_local_slice(n: int) -> slice:
    """This process's contiguous row range of a global batch of size n:
    rows p*(n/P) .. (p+1)*(n/P), the rank order of the meshes."""
    p, np_ = process_index(), process_count()
    if n % np_ != 0:
        raise ValueError(f"global batch {n} not divisible by {np_} processes")
    per = n // np_
    return slice(p * per, (p + 1) * per)


def local_device() -> torch.device:
    """This process's device: the current CUDA device under NCCL, else the
    CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_batch_from_local(local_data, global_batch: int, axis: int = 0, device=None):
    """This rank's rows of a global batch, as a tensor on its device.

    In torch a rank's local tensor is its shard: ``local_data`` holds this
    process's :func:`process_local_slice` rows of ``axis``; the function
    checks that the processes' rows make up ``global_batch`` and places
    them."""
    local = torch.as_tensor(np.ascontiguousarray(local_data)) if not torch.is_tensor(
        local_data) else local_data
    n = process_count()
    if local.shape[axis] * n != global_batch:
        raise ValueError(f"local rows {local.shape[axis]} x {n} processes != "
                         f"global batch {global_batch}")
    return local.to(device or local_device())


def put_global(x, spec, mesh: Optional[Mesh] = None):
    """This rank's shard of the full host value ``x`` under ``spec`` (see
    :func:`~avatar_tpu_torch.parallel.mesh.shard_pytree`); every process
    supplies the full value."""
    if spec is None:
        return x
    if mesh is None:
        raise ValueError("put_global: a sharded spec needs its mesh")
    return _shard_leaf(mesh, x, spec)


def shard_pytree_global(tree, shardings, mesh: Optional[Mesh] = None):
    """:func:`put_global` over a tree and its tree of specs."""
    if isinstance(tree, dict):
        return {k: shard_pytree_global(v, shardings[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_pytree_global(v, s, mesh) for v, s in zip(tree, shardings)]
    return put_global(tree, shardings, mesh)


def gather_to_host(tree, shardings=None, mesh: Optional[Mesh] = None):
    """The full tensors of ``tree`` on the CPU of every process: each leaf
    that ``shardings`` (a tree of int dims over 'fsdp' or of axis-name
    tuples) shards is all-gathered over its axes first. Every rank must
    call it (collective)."""
    if isinstance(tree, dict):
        return {k: gather_to_host(v, None if shardings is None else shardings[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gather_to_host(v, None if shardings is None else shardings[i], mesh)
                for i, v in enumerate(tree)]
    if not torch.is_tensor(tree):
        return tree
    spec = shardings
    if spec is not None:
        if isinstance(spec, int):
            spec = tuple("fsdp" if d == spec else None for d in range(tree.ndim))
        for dim, axis in enumerate(spec):
            if axis is not None:
                tree = all_gather_plain(tree, mesh.group(axis), dim)
    return tree.detach().cpu()


def sync_processes() -> None:
    """A barrier over every process (before one rank reads what others
    write); a no-op in one process."""
    if process_count() == 1:
        return
    dist.barrier()
