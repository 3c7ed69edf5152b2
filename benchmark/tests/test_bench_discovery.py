"""A cell, a configuration, a mix and a metric added as files, with their
entries in ``BENCHMARK.json``, are picked up with no edit of the harness."""

import json
import shutil
import subprocess
import sys

import tiny

ROOT = tiny.ROOT

CHILD = """
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
sys.path.append(sys.argv[2])
from benchmark import run
assert Path(run.__file__).resolve().parent.parent == root.resolve()
cell, config, mix, limits, spec = run.load_cell("tinycfg.tiny-render", root=root)
rec, metrics = run.run_cell(cell, config, mix, limits, spec, 2**40 + 9, 1.0, False,
                            device="cpu", bench=root / "benchmark")
print(json.dumps({"metrics": metrics, "checks": rec.checks, "attempted": rec.attempted}))
"""


def test_new_files_make_a_new_cell_and_metric(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "out"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    (bench / "configs" / "tinycfg.json").write_text(json.dumps(tiny.config()))
    mix = tiny.mix("render-long")
    (bench / "mixes" / "tiny-render.json").write_text(json.dumps(mix))
    (bench / "limits" / "tinycfg.tiny-render.json").write_text('{"video_gap_levels": 4.0}')
    (bench / "metrics" / "videos_done.py").write_text(
        "def read(rec):\n    return float(len(rec.done)) if rec.done else None\n")
    spec["configs"].append({"name": "tinycfg", "source": "https://example.org/tiny",
                            "file": "benchmark/configs/tinycfg.json", "reduced": [],
                            "why": "tiny"})
    spec["workloads"].append({"name": "tinycfg.tiny-render", "config": "tinycfg",
                              "traffic": "tiny-render", "chips": 1, "why": "tiny"})
    spec["end_to_end"].append({"name": "videos_done", "unit": "videos", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["tinycfg.tiny-render"]})
    for m in spec["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append("tinycfg.tiny-render")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path), str(ROOT)],
                          capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out["metrics"]) == {"videos_done", "frames_per_s", "setup_s"}
    assert out["metrics"]["videos_done"]["value"] == out["attempted"] >= 1
    assert out["checks"][0][0] == "video_gap_levels"
