"""The readings a cell's check limit is set from, on the card at the cell's
own size: for each seed, the gap of the control (the plain reference in
the precision below the configuration's: fp8 for bf16, int4 for W8A8) from
the reference on the same inputs and draws as the cell's check.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--device cuda]

Prints one JSON line per seed: the cell, the seed, the control's mode,
the numbers the cell's check compares (a video cell: the gap in 8-bit
levels of each video or request; a training cell: the loss, gradient and
change gaps from the reference over the cell's first steps), each beside
the cell's limit, and ``correct`` as the benchmark decides it for a run
whose timed path gave the control's outputs: it has to read false. The
program's own gaps (the lower readings) come from the benchmark's runs,
which print theirs on standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL = {None: "fp8", "w8a8": "int4"}


def control_gaps(cell, config, mix, seed: int, device: str) -> dict:
    """request or video id -> the control's gap from the reference."""
    import torch

    from benchmark import common, weights
    from benchmark.drivers import render, serve
    from benchmark.reference import ltxv

    ctx = common.Ctx(cell=cell, config=config, mix=mix, limits={}, seed=seed, seconds=0,
                     trace=False, device=device)
    _, dit, _, vae = weights.make_models(config["dit"], config["vae"], seed, device,
                                         getattr(torch, config["dtype"]))
    base = common.reference_precision(config)
    ctrl = common.reference_precision(config, CONTROL[common.quantized(config).get("dit")])
    ltxv.strict_f32()
    out = {}
    if mix["driver"] == "render":
        a = render.reference_video(ctx, 0, dit, vae, base)
        b = render.reference_video(ctx, 0, dit, vae, ctrl)
        return {0: ltxv.video_gap(b, a)}
    tr = serve.Traffic(mix, seed, mix.get("control_seconds", 10.0),
                       config["dit"]["caption_channels"])
    for i in range(min(len(tr.due), mix["check_requests"])):
        a = serve.reference_video(ctx, tr, i, dit, vae, (i, 0, 1), base)
        b = serve.reference_video(ctx, tr, i, dit, vae, (i, 0, 1), ctrl)
        out[i] = ltxv.video_gap(b, a)
    return out


def train_control(cell, config, mix, seed: int, device: str) -> dict:
    """The control's loss, gradient and change gaps from the reference over
    the cell's first steps."""
    import torch

    from benchmark import common, weights
    from benchmark.drivers import train
    from benchmark.reference import ltxv
    from benchmark.reference import train as ref

    ctx = common.Ctx(cell=cell, config=config, mix=mix, limits={}, seed=seed, seconds=0,
                     trace=False, device=device)
    _, dit = weights.make_dit(config["dit"], seed, device, getattr(torch, config["dtype"]))
    data = train.Data(ctx, config["dit"]["caption_channels"])
    ltxv.strict_f32()
    steps = []
    for k in range(1, mix["check_steps"] + 1):
        t, noise = data.draws(k)
        steps.append({"batch": {n: torch.from_numpy(v).to(device)
                                for n, v in data.batch(k).items()}, "t": t, "noise": noise})
    a = mix["adamw"]
    args = (dit, config["dit"], steps, torch.from_numpy(data.embeds).to(device),
            torch.from_numpy(data.mask).to(device), mix["trained"],
            mix["train"]["learning_rate"], a["b1"], a["b2"], a["eps"], a["weight_decay"])
    dtype = getattr(torch, config["dtype"])
    rows = mix.get("reference_rows", 0)
    base = ref.train_steps(*args, common.reference_precision(config), dtype, rows)
    ctrl = ref.train_steps(*args, common.reference_precision(config, CONTROL[None]), dtype, rows)
    median = sorted(base["grad_norms"].values())[len(base["grad_norms"]) // 2]
    moved = {k for k, v in base["grad_norms"].items() if v >= 1e-3 * median}
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(ctrl["losses"], base["losses"])),
            "grad_gap": ref.worst_leaf_gap(ctrl["grad_norms"], base["grad_norms"])[0],
            "update_gap": ref.worst_leaf_gap(ctrl["change_norms"], base["change_norms"],
                                             moved)[0]}


def control_checks(cell, config, mix, limits, seed: int, device: str):
    """(the control's readings, the run's check tuples ``(name, value,
    limit)`` with the control in the program's place): a video run compares
    the widest gap of its checked videos, a training run its three gaps."""
    if mix["driver"] == "train":
        gaps = train_control(cell, config, mix, seed, device)
        return gaps, [(n, gaps[n], limits[n]) for n in ("loss_gap", "grad_gap", "update_gap")]
    gaps = control_gaps(cell, config, mix, seed, device)
    return ({"gap_levels": gaps},
            [("video_gap_levels", max(gaps.values()), limits["video_gap_levels"])])


def main(argv=None) -> int:
    from benchmark import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell, config, mix, limits, _ = run.load_cell(args.workload)
    mode = CONTROL[(config.get("quantize") or {}).get("dit")]
    for seed in args.seeds:
        readings, checks = control_checks(cell, config, mix, limits, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": mode,
                          "correct": run.correct_of(checks), **readings,
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
