"""The tail and rate arithmetic over synthetic timelines: the whole window,
failures counted as missing, a stall felt by every request behind it."""

import importlib.util
import json
import math
from pathlib import Path

import pytest

from benchmark import common

METRICS = Path(__file__).resolve().parent.parent / "metrics"
SPEC = json.loads((METRICS.parent.parent / "BENCHMARK.json").read_text())


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(**kw):
    ctx = common.Ctx(cell={}, config={"dit": {"num_layers": 28}}, mix={"steps": 40}, limits={},
                     seed=0, seconds=10, trace=False)
    return common.Record(ctx, **kw)


def open_loop(due, service, stall_at=None, stall=0.0):
    """Latencies of a one-at-a-time server fed at ``due`` times, each taking
    ``service`` seconds, with one stall of ``stall`` s at ``stall_at``."""
    free, out = 0.0, []
    for t in due:
        start = max(t, free)
        if stall_at is not None and start >= stall_at:
            start, stall_at = start + stall, None
        free = start + service
        out.append(free - t)
    return out


def test_p90_over_all_requests_feels_a_stall():
    due = [i * 1.0 for i in range(100)]
    calm = open_loop(due, 0.5)
    stalled = open_loop(due, 0.5, stall_at=70.0, stall=10.0)
    p90 = reader("latency_p90_s")
    assert p90(record(latencies=calm)) == pytest.approx(0.5)
    # the stall delays the requests behind it, and the tail shows it
    assert p90(record(latencies=stalled)) > 2.0


def test_p90_counts_a_failed_request_as_missing():
    lat = [1.0] * 95 + [math.inf] * 5
    assert reader("latency_p90_s")(record(latencies=lat)) == 1.0
    lat = [1.0] * 85 + [math.inf] * 15
    assert reader("latency_p90_s")(record(latencies=lat)) == math.inf


def test_percentile_interpolates():
    assert common.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 90) == pytest.approx(4.6)
    assert common.percentile([3.0], 90) == 3.0


def test_rate_is_all_the_work_over_all_the_time():
    # 10 videos of 161 frames, 4 s each, with an 8 s stall after the fifth
    ends, t = [], 0.0
    for i in range(10):
        t += 4.0 + (8.0 if i == 5 else 0.0)
        ends.append((100.0 + t, 161))
    rec = record(window_start=100.0, done=ends)
    assert reader("frames_per_s")(rec) == pytest.approx(1610 / 48.0)
    # the median of per-video rates would hide the stall
    assert reader("frames_per_s")(rec) < 161 / 4.0


def test_readers_with_nothing_to_read_return_none():
    rec = record()
    for name in ("latency_p90_s", "frames_per_s", "peak_mem_gib", "serve.batch_mean",
                 "host.kernels_per_step.serve", "host.kernels_per_step.render",
                 "pipe.denoise_ms_per_step.render", "vae.decode_ms.render", "mfu.render",
                 "attn.roofline.render", "int8.roofline.render", "frames_per_s.w8a8",
                 "host.kernels_per_step.render_w8a8", "pipe.denoise_ms_per_step.render_w8a8",
                 "vae.decode_ms.render_w8a8", "mfu.render_w8a8", "attn.roofline.render_w8a8"):
        assert reader(name)(rec) is None, name


def test_span_readers():
    rec = record(spans={"denoise_s": [3.2, 3.6, 4.0], "decode_s": [0.2, 0.3, 0.25]})
    assert reader("pipe.denoise_ms_per_step.render")(rec) == pytest.approx(90.0)
    assert reader("vae.decode_ms.render")(rec) == pytest.approx(250.0)
    rec = record(counters={"requests": 80, "batches": 32})
    assert reader("serve.batch_mean")(rec) == 2.5


def test_every_metric_has_a_reader_and_every_cell_reports_what_its_metrics_move():
    cells = {c["name"] for c in SPEC["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (METRICS / f"{m['name']}.py").is_file(), m["name"]
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]
    for cell in cells:
        assert "setup_s" in {n for n, ws in e2e.items() if cell in ws}
        assert len([n for n, ws in e2e.items() if cell in ws]) >= 2, cell


@pytest.mark.parametrize("w8a8, plain", [
    ("frames_per_s.w8a8", "frames_per_s"),
    ("pipe.denoise_ms_per_step.render_w8a8", "pipe.denoise_ms_per_step.render"),
    ("vae.decode_ms.render_w8a8", "vae.decode_ms.render"),
    ("mfu.render_w8a8", "mfu.render"),
])
def test_the_w8a8_render_s_readers_read_as_the_bf16_render_s(w8a8, plain):
    rec = record(window_start=100.0, done=[(104.0, 161), (107.5, 161)],
                 spans={"denoise_s": [3.2, 3.6, 4.0], "decode_s": [0.2, 0.3, 0.25]},
                 counters={"model_least_s": 1.5, "video_s": 7.5})
    assert reader(w8a8)(rec) == reader(plain)(rec) is not None
