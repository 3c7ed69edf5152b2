"""Gloo worlds for the port's multi-process tests (not a test module).

``run_world(cases, world, payload)`` starts ``world`` processes of this
file, each joining a gloo process group on a localhost port with a
deadline, running ``torch_parallel_cases.<cases>(rank, world, payload)``
and saving what it returns; the parent reads the results back, rank by
rank. The workers import torch and the port only, never JAX, and run one
thread each. A world that outlives ``timeout`` is killed and fails the
test that asked for it, instead of hanging the suite.
"""

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# every collective of a world fails after this long without its peers
COLLECTIVE_TIMEOUT_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(cases: str, world: int, payload, timeout: float = 120.0):
    """The list of the ranks' results of ``cases`` (a function of
    ``tests/torch_parallel_cases.py``) on a gloo world of ``world``."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch.save(payload, tmp / "payload.pt")
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(REPO), str(HERE), os.environ.get("PYTHONPATH", "")]),
            OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__)), cases, str(rank), str(world), str(port),
             str(tmp)], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for rank in range(world)]
        outputs = []
        try:
            for proc in procs:
                out, _ = proc.communicate(timeout=timeout)
                outputs.append(out)
        except subprocess.TimeoutExpired:
            for proc in procs:
                proc.kill()
            for proc in procs:
                proc.communicate()
            raise AssertionError(f"gloo world {cases!r} of {world} passed its "
                                 f"{timeout:.0f} s deadline")
        for rank, (proc, out) in enumerate(zip(procs, outputs)):
            if proc.returncode != 0:
                raise AssertionError(f"rank {rank} of {cases!r} failed:\n{out[-6000:]}")
        return [torch.load(tmp / f"result_{rank}.pt", weights_only=False)
                for rank in range(world)]


def _worker(cases: str, rank: int, world: int, port: int, tmp: Path) -> None:
    import warnings

    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    from avatar_tpu_torch.parallel import initialize

    assert initialize(f"localhost:{port}", world, rank, device="cpu",
                      timeout_s=COLLECTIVE_TIMEOUT_S)
    import torch_parallel_cases

    payload = torch.load(tmp / "payload.pt", weights_only=False)
    result = getattr(torch_parallel_cases, cases)(rank, world, payload)
    torch.save(result, tmp / f"result_{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
            Path(sys.argv[5]))
