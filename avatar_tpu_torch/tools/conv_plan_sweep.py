"""L2's wgmma kernel (kernel L, ``csrc/int8_conv3d_sm90.cu``) timed under
every tile and K split at the 2B VAE's conv shapes, and the fit of
``ops/causal_conv3d.py:conv_plan``'s cost constants to those times.

    python3 -m avatar_tpu_torch.tools.conv_plan_sweep [--out FILE]

For each shape of :data:`SHAPES` (the stride-1, zero-padded W8A8 convs of
the VAE's video encode and decode and of a served batch-4 decode, bf16,
random levels and weights from a seed) and each plan of tile 128 or 256
positions and split in :data:`SPLITS` (plus ``conv_plan``'s own), the
kernel's and the workspace memset's device time (torch.profiler, 10
launches), each output equal to ``conv_levels``' bit for bit. One JSON line
per shape (to ``--out`` as well), then the fit: each shape's fastest plan,
``conv_plan``'s plan and its time over the fastest, and the constants
(TILE_256, ITEM_STAGES, SPLIT_STAGES) of a grid that pick the plans of
least total log time over the fastest (:func:`fit`).
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
from typing import Dict, List, Tuple

# (input shape [B, C, F, H, W], output channels, causal)
SHAPES = [
    ((1, 48, 1, 64, 64), 128, True), ((1, 128, 1, 64, 64), 128, True),
    ((1, 128, 1, 32, 32), 256, True), ((1, 256, 1, 32, 32), 256, True),
    ((1, 256, 1, 16, 16), 512, True), ((1, 512, 1, 16, 16), 512, True),
    ((1, 512, 1, 8, 8), 512, True), ((1, 512, 1, 8, 8), 129, True),
    ((1, 512, 13, 8, 8), 512, False), ((1, 512, 13, 8, 8), 129, True),
    ((1, 128, 13, 8, 8), 512, False), ((1, 512, 13, 8, 8), 4096, False),
    ((1, 256, 25, 16, 16), 512, True), ((1, 512, 25, 16, 16), 512, False),
    ((1, 512, 25, 16, 16), 256, False), ((1, 256, 25, 16, 16), 256, False),
    ((1, 256, 25, 16, 16), 2048, False), ((1, 256, 49, 32, 32), 128, False),
    ((1, 128, 49, 32, 32), 128, False), ((1, 256, 49, 32, 32), 256, False),
    ((4, 512, 13, 8, 8), 512, False), ((4, 128, 13, 8, 8), 512, False),
    ((4, 512, 13, 8, 8), 4096, False), ((4, 512, 25, 16, 16), 512, False),
]
SPLITS = (1, 2, 3, 4, 5, 6, 8, 9, 12, 18, 27, 36)
TILES = (128, 256)
# the grid fit() searches
GRID = {"TILE_256": (1.2, 1.3, 1.4, 1.5, 1.6, 1.8, 2.0),
        "ITEM_STAGES": (0.0, 1.0, 2.0, 4.0),
        "SPLIT_STAGES": tuple(float(v) for v in range(0, 42, 2))}


def plan_key(tile_m: int, split: int) -> str:
    return f"{tile_m}/{split}"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def model_plan(row: dict, consts: Dict[str, float]) -> str:
    """The plan among ``row``'s timed ones that conv_plan's cost model
    (``causal_conv3d._plan_cost``) picks with ``consts``: least cost, ties
    to fewer slices, then the smaller tile."""
    from avatar_tpu_torch.ops import causal_conv3d as cc

    b, _, f, h, w = row["shape"]
    best = None
    for key in row["ms"]:
        tile_m, split = map(int, key.split("/"))
        if split > max(1, row["steps"] // cc.MIN_SLICE_STEPS):
            continue
        tiles = _cdiv(b * f * h * w, tile_m) * _cdiv(row["n"], cc.TILE_N)
        cost = cc._plan_cost(tiles, row["steps"], split, tile_m, row["chunk"],
                             consts["TILE_256"], consts["ITEM_STAGES"],
                             consts["SPLIT_STAGES"])
        cand = (cost, split, tile_m, key)
        if best is None or cand < best:
            best = cand
    return best[3]


def regret(rows: List[dict], consts: Dict[str, float]) -> Tuple[float, float]:
    """(sum over shapes of log(time of the model's plan / fastest time),
    the largest such ratio)."""
    total, worst = 0.0, 1.0
    for row in rows:
        times = row["ms"]
        pick = model_plan(row, consts)
        ratio = times[pick] / min(times.values())
        total += math.log(ratio)
        worst = max(worst, ratio)
    return total, worst


def fit(rows: List[dict]) -> dict:
    """The constants of :data:`GRID` of least :func:`regret` (ties to the
    grid's first), beside the regret of conv_plan's own constants."""
    from avatar_tpu_torch.ops import causal_conv3d as cc

    current = {"TILE_256": cc.TILE_256, "ITEM_STAGES": cc.ITEM_STAGES,
               "SPLIT_STAGES": cc.SPLIT_STAGES}
    best = None
    for values in itertools.product(*GRID.values()):
        consts = dict(zip(GRID, values))
        score = regret(rows, consts)
        if best is None or score[0] < best[0][0] - 1e-12:
            best = (score, consts)
    cur = regret(rows, current)
    return {"current": current, "current_log_regret": cur[0], "current_worst": cur[1],
            "current_mean": math.exp(cur[0] / len(rows)), "best": best[1],
            "best_log_regret": best[0][0], "best_worst": best[0][1]}


def _device_ms(fn, reps: int = 10) -> Tuple[float, float]:
    """(the kernel's, the memsets') device ms per call of ``fn``. A
    profiling session now and then records no kernel at all: it is taken
    again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernel = memset = 0.0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            if "conv_sm90_kernel" in e.key:
                kernel += e.self_device_time_total
            elif "emset" in e.key:
                memset += e.self_device_time_total
        if kernel > 0:
            return kernel / reps / 1e3, memset / reps / 1e3
    raise RuntimeError("the profiler recorded no conv_sm90_kernel")


def sweep_shape(shape, n: int, causal: bool, gen) -> dict:
    """Every plan of one shape timed, each output checked against
    ``conv_levels``'."""
    import torch

    from avatar_tpu_torch.ops import causal_conv3d as cc
    from avatar_tpu_torch.utils.quantize import quantize_conv3d

    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    w = torch.randn(n, shape[1], 3, 3, 3, generator=gen, device="cuda") * 0.05
    p = quantize_conv3d({"weight": w, "bias": torch.randn(n, generator=gen, device="cuda")})
    s = cc.act_scale(x)
    xq = cc.quantize_levels(x, s)
    args = (xq, s, p["kernel_q8"], p["scale"], p["bias"], torch.bfloat16, 1, causal, "zeros")
    ref = cc.conv_levels(*args)
    plan = cc.conv_plan(tuple(shape), n, (3, 3, 3), (1, 1, 1), causal, "zeros",
                        torch.bfloat16)
    entry = cc._entry("int8_conv3d_sm90", "int8_conv3d_sm90",
                      [cc._P] * 7 + [cc._I] * 4 + [cc._P, cc._P])

    def run(tile_m, split):
        _, out, (cargs, _keep) = cc._conv_args(*args)
        tiles = _cdiv(out[:, 0].numel(), tile_m) * _cdiv(n, cc.TILE_N)
        ws = None if split == 1 else torch.empty(tiles * (tile_m * cc.TILE_N + 1),
                                                 device="cuda", dtype=torch.int32)
        err = entry(*cargs, tile_m, plan.chunk, split,
                    None if ws is None else ws.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"int8_conv3d_sm90 launch failed with cudaError_t {err}")
        return out

    plans = {(t, sp) for t in TILES for sp in SPLITS if sp <= plan.steps}
    plans.add((plan.tile_m, plan.split))
    times, memsets = {}, {}
    for tile_m, split in sorted(plans):
        if not torch.equal(run(tile_m, split), ref):
            raise RuntimeError(f"{shape} -> {n}: plan {tile_m}/{split} differs")
        kernel, memset = _device_ms(lambda: run(tile_m, split))
        times[plan_key(tile_m, split)] = kernel + memset
        memsets[plan_key(tile_m, split)] = memset
    return {"shape": list(shape), "n": n, "causal": causal, "steps": plan.steps,
            "chunk": plan.chunk,
            "conv_plan": plan_key(plan.tile_m, plan.split), "ms": times,
            "memset_ms": memsets}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None, help="also write the JSON lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_plan_sweep: needs the card")
    from avatar_tpu_torch.ops import kernel_build

    kernel_build.build_all(["int8_conv3d_sm90"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = open(args.out, "w") if args.out else None
    rows = []
    for shape, n, causal in SHAPES:
        row = sweep_shape(shape, n, causal, gen)
        best = min(row["ms"], key=row["ms"].get)
        row.update({"fastest": best,
                    "conv_plan_over_fastest": row["ms"][row["conv_plan"]] / row["ms"][best]})
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    result = {"card": torch.cuda.get_device_name(0), "fit": fit(rows)}
    print(json.dumps(result), flush=True)
    if out:
        out.write(json.dumps(result) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
