"""The control readings of the Wan I2V cell's check limits, on the card at
the cell's own size: for each seed, the gaps of the plain reference with
every DiT linear in float8 e4m3 (per-tensor scale; the precision below the
configuration's bf16) from the f32 reference, on the same weights, inputs
and draws as the cell's check of its video 0: the I420 gap in 8-bit levels
(the VAE in f32 on both sides) and the relative RMS gap of the denoised
latents.

    python3 benchmark/control_wan.py --workload wan21-i2v-14b.i2v-480p --seeds 11 12 13 14

Prints one JSON line per seed: the cell, the seed, the control's mode,
each gap beside the cell's limit, and ``correct`` as the benchmark decides
it for a run whose timed path gave the control's video and latents: it has
to read false. The program's own gaps come from the benchmark's
runs, which print theirs on standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL = "fp8"


def control_gaps(cell, config, mix, seed: int, device: str) -> dict:
    """The control's gaps from the reference, by check name."""
    from benchmark import common
    from benchmark.drivers import render_wan
    from benchmark.reference import wan as ref

    ctx = common.Ctx(cell=cell, config=config, mix=mix, limits={}, seed=seed, seconds=0,
                     trace=False, device=device)
    _, dit, _, vae = render_wan.make_models(config, seed, device)
    ref.strict_f32()
    base = render_wan.reference_video(ctx, 0, dit, vae, ref.Precision("f32"))
    ctrl = render_wan.reference_video(ctx, 0, dit, vae, ref.Precision(CONTROL))
    return render_wan.gaps_of(ctrl, base)


def main(argv=None) -> int:
    from benchmark import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell, config, mix, limits, _ = run.load_cell(args.workload)
    for seed in args.seeds:
        gaps = control_gaps(cell, config, mix, seed, args.device)
        checks = [(name, gaps[name], limits[name]) for name in gaps]
        print(json.dumps({"workload": args.workload, "seed": seed, "control": CONTROL,
                          "correct": run.correct_of(checks),
                          "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
