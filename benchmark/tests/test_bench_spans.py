"""The readers of the program's spans: ``stage_times`` keys, as the render
driver collects them from the program at a tiny size on the CPU, and on
synthetic records."""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

import tiny
from benchmark import common
from benchmark.drivers import render

METRICS = Path(__file__).resolve().parent.parent / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(spans):
    ctx = common.Ctx(cell={}, config={}, mix={"steps": 40}, limits={}, seed=0, seconds=10,
                     trace=True)
    return common.Record(ctx, spans=spans)


def test_ops_ms_per_step_is_the_median_video_s_op_host_time_per_step():
    read = reader("host.ops_ms_per_step.render_w8a8")
    spans = {"pipe.step.n": [40.0, 40.0, 40.0], "pipe.step.host_s": [3.0, 3.1, 9.0],
             "int8.H.host_s": [0.2, 0.3, 0.8], "attn.C.host_s": [0.1, 0.1, 0.4],
             "gemm.bf16.host_s": [0.02, 0.02, 0.02], "conv.L2.host_s": [0.08, 0.08, 0.08],
             "int8.H.self_s": [9.0, 9.0, 9.0], "dit.block.host_s": [2.0, 2.0, 2.0]}
    # per video 0.30, 0.40, 1.20 s of attention and int8 spans over 40 steps;
    # the VAE's conv.* and the plain gemm.* are left out
    assert read(record(spans)) == pytest.approx(10.0)
    assert read(record({})) is None
    assert read(record({"pipe.step.n": [40.0], "denoise_s": [3.0]})) is None
    # keys that do not come from the same videos
    assert read(record(dict(spans, **{"attn.B.host_s": [0.1]}))) is None


@pytest.mark.parametrize("seed", [3, 2**33 + 5])
def test_the_program_hands_the_reader_its_spans(seed):
    config, mix = tiny.config(w8a8=True), tiny.mix("render-long")
    ctx = common.Ctx(cell={}, config=config, mix=mix, limits={}, seed=seed, seconds=0,
                     trace=True, device="cpu")
    pipe, _, dcfg, _, _ = common.make_pipeline(ctx)
    rec = common.Record(ctx)
    for v in range(2):
        kw, _ = render.inputs(ctx, v, dcfg.caption_channels)
        stages = {}
        pipe(render._params(mix, mix["steps"]), torch.Generator().manual_seed(0),
             output_type=mix["output"], stage_times=stages, **kw)
        for name, s in stages.items():
            rec.span(name, s)
    assert rec.spans["pipe.step.n"] == [mix["steps"]] * 2
    value = reader("host.ops_ms_per_step.render_w8a8")(rec)
    assert value is not None and 0 < value < math.inf
