"""Runs of a cell with a fault planted in the program, on the card at the
cell's own size: the readings a limit is held against.

    python3 benchmark/faults.py --workload <cell> --fault <name> --seeds 11 12 13 [--seconds 5]

Faults: ``half_batch`` (a training micro-step's loss taken over the first
half of its rows: half of the batch left out, the mean over the rest),
``unchanged`` (the training step returns its state unchanged). Prints one
JSON line per seed: the run's checks, each beside the cell's limit, and
``correct`` as the benchmark decides it (a fault the check catches reads
false).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def plant(name: str) -> None:
    from avatar_tpu_torch.train import train as program

    if name == "half_batch":
        orig = program.velocity_loss

        def half(trainable, dit_params, dit_cfg, cfg, batch, *args, t=None, noise=None, **kw):
            rows = batch["latents"].shape[0] // 2
            batch = {k: v[:rows] for k, v in batch.items()}
            t = None if t is None else t[:rows]
            noise = None if noise is None else noise[:rows]
            return orig(trainable, dit_params, dit_cfg, cfg, batch, *args, t=t, noise=noise, **kw)

        program.velocity_loss = half
    elif name == "unchanged":
        orig = program.make_train_step

        def make(*args, **kw):
            step = orig(*args, **kw)

            def frozen(trainable, opt_state, *rest, **kwr):
                _, new_state, metrics = step(trainable, opt_state, *rest, **kwr)
                return trainable, new_state, metrics
            return frozen

        program.make_train_step = make
    else:
        raise SystemExit(f"unknown fault {name!r}")


def main(argv=None) -> int:
    from benchmark import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plant(args.fault)
    cell, config, mix, limits, spec = run.load_cell(args.workload)
    for seed in args.seeds:
        rec, _ = run.run_cell(cell, config, mix, limits, spec, seed, args.seconds, False,
                              device=args.device, t_start=time.perf_counter())
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": run.correct_of(rec.checks),
                          "checks": {n: {"value": v, "limit": lim}
                                     for n, v, lim in rec.checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
