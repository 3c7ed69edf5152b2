"""One run of one benchmark cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in ``BENCHMARK.json`` at the checkout's root. Its
configuration is the file that ``configs`` names, its traffic the mix file
``benchmark/mixes/<traffic>.json``, whose ``driver`` names the module of
``benchmark/drivers/`` that loads, warms up, measures for ``--seconds``
and checks the outputs. Every metric is read by the module of
``benchmark/metrics/`` of its name, from what the driver recorded: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer ones. The limits of the check are ``benchmark/limits/<cell>.json``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1`` the
device's busy seconds and the traced window), with ``--trace 1`` a
``breakdown`` of the trace, and last the ``checks``: each number compared
beside its limit, which also close standard error. A run on a machine
without CUDA, or with fewer cards than the cell asks for, exits 3 and
prints no result; so does a run whose process holds JAX, its libraries or
the JAX package once the window has closed (exit 4).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the program's and the toolchain's caches live inside the checkout, at fixed paths
CACHE = BENCH / ".cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "avatar_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """Top-level names in ``sys.modules`` that the run must not hold."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def load_cell(name: str, root: Path = ROOT):
    """(cell, configuration file, mix file, limits, the benchmark's spec)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((c for c in spec["workloads"] if c["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    bench = root / "benchmark"
    mix = json.loads((bench / "mixes" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{name}.json").read_text())
    return cell, config, mix, limits, spec


def metrics_of(spec: dict, cell: str, trace: bool) -> list:
    """The metrics this cell reports in this mode."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metrics(rec, metrics: list, bench: Path = BENCH) -> dict:
    """name -> {"value", "unit"} of every metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        reader = load_module(bench / "metrics" / f"{m['name']}.py", f"metric_{m['name']}")
        value = reader.read(rec)
        if value is None:
            print(f"metric {m['name']}: nothing to read", file=sys.stderr)
            continue
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def correct_of(checks: list) -> bool:
    """``correct``: something was compared, and every number compared,
    ``(name, value, limit)``, is finite and within its limit."""
    return bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def result(rec, metrics: dict, chips: int, kind: str, trace: bool) -> dict:
    checks = {name: {"value": value, "limit": limit} for name, value, limit in rec.checks}
    correct = correct_of(rec.checks)
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown()
    out["checks"] = checks
    return out


def run_cell(cell, config, mix, limits, spec, seed, seconds, trace, device="cuda",
             t_start=T_START, bench: Path = BENCH):
    """Drives one run and returns (record, metrics)."""
    from benchmark import common

    ctx = common.Ctx(cell=cell, config=config, mix=mix, limits=limits, seed=seed,
                     seconds=seconds, trace=trace, device=device, t_start=t_start)
    driver = load_module(bench / "drivers" / f"{mix['driver']}.py", f"driver_{mix['driver']}")
    rec = driver.run(ctx)
    return rec, read_metrics(rec, metrics_of(spec, cell["name"], trace), bench)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, mix, limits, spec = load_cell(args.workload)
    chips = int(cell.get("chips", 1))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from benchmark import ranks

    if chips > 1 and ranks.rank() is None:
        return ranks.spawn([sys.executable, str(Path(__file__).resolve()),
                            *(argv if argv is not None else sys.argv[1:])], chips)
    if chips > 1:
        ranks.init("nccl")
    rec, metrics = run_cell(cell, config, mix, limits, spec, args.seed, args.seconds,
                            bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run holds {found}: the port must not load them", file=sys.stderr)
        return 4
    if chips > 1 and ranks.rank() != 0:
        return 0
    out = result(rec, metrics, chips, torch.cuda.get_device_name(0), bool(args.trace))
    print(json.dumps({"setup_s": rec.setup_s, "window_start_to_end_s":
                      rec.units_end - rec.window_start if rec.units_end else None,
                      "counters": rec.counters, "spans": rec.spans}), file=sys.stderr)
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
