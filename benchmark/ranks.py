"""A cell on several cards: one process per card, joined by
``torch.distributed`` over ``tcp://localhost``, as the program's
``parallel/distributed.py`` expects. :func:`spawn` starts them with the
rank in the environment and waits for all; rank 0 prints the result."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import List, Optional

RANK, WORLD, PORT = "BENCH_RANK", "BENCH_WORLD", "BENCH_PORT"


def rank() -> Optional[int]:
    value = os.environ.get(RANK)
    return None if value is None else int(value)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cmd: List[str], world: int, timeout: Optional[float] = None) -> int:
    """Runs ``cmd`` once per rank and waits for every process; the first
    non-zero exit code, else 0. Rank 0's output passes through; the
    others' standard output is dropped (they print no result)."""
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, **{RANK: str(r), WORLD: str(world), PORT: str(port),
                                  "LOCAL_RANK": str(r)})
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=None if r == 0 else subprocess.DEVNULL))
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((c for c in codes if c), 0)


def init(backend: str):
    """Joins this process to the group its environment names; on CUDA each
    rank takes the card of its rank."""
    import torch
    import torch.distributed as dist

    r, world = int(os.environ[RANK]), int(os.environ[WORLD])
    if backend == "nccl":
        torch.cuda.set_device(r)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{os.environ[PORT]}",
                            world_size=world, rank=r)
    return r, world


def main() -> int:  # pragma: no cover - the CPU test's child
    import torch
    import torch.distributed as dist

    r, world = init("gloo")
    t = torch.tensor([float(r + 1)])
    dist.all_reduce(t)
    print(f"rank {r} of {world}: {t.item()}", file=sys.stderr)
    if r == 0:
        print(t.item(), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
