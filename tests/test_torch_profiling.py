"""The port's profiling helpers against the JAX package's, on the CPU:
``StepTimer`` on the same clock readings, ``timed``'s contract (result,
seconds per call, warm-up not timed, a synchronize per call), and
``trace`` / ``annotate`` writing a Chrome trace that holds the range."""

import json
import time
from unittest import mock

import numpy as np
import pytest
import torch

from avatar_tpu.utils import profiling as jprof
from avatar_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("window", [1, 3, 50])
def test_step_timer_matches_jax(window):
    clock = iter(np.cumsum(np.random.default_rng(window).uniform(0.01, 0.5, 12)).tolist())
    readings = list(clock)
    got = {}
    for name, mod in (("j", jprof), ("t", tprof)):
        ticks = iter(readings)
        with mock.patch.object(time, "perf_counter", lambda: next(ticks)):
            timer = mod.StepTimer(window=window)
            assert timer.mean_step_time is None and timer.throughput(8) is None
            got[name] = ([timer.tick() for _ in range(len(readings))],
                         timer.mean_step_time, timer.throughput(8))
    assert got["t"] == got["j"]


def test_timed_counts_calls_and_synchronizes_cuda_results():
    calls = []

    def fn(a, scale=1.0):
        calls.append(a)
        return {"out": [torch.full((2,), a * scale)], "n": a}

    result, seconds = tprof.timed(fn, 3, scale=2.0, iters=4, warmup=2)
    assert len(calls) == 6 and seconds >= 0.0
    assert result["out"][0].tolist() == [6.0, 6.0]
    jres, _ = jprof.timed(lambda a: np.full((2,), a * 2.0), 3, iters=4, warmup=2)
    np.testing.assert_array_equal(result["out"][0].numpy(), jres)
    # a result on the card is synchronized on each device it lives on
    fake = mock.Mock(spec=torch.Tensor)
    fake.device = torch.device("cuda", 1)
    with mock.patch.object(tprof.torch.cuda, "synchronize") as sync:
        tprof.timed(lambda: (fake, [fake], {"x": torch.zeros(1)}), iters=2, warmup=1)
    assert [c.args for c in sync.call_args_list] == [(torch.device("cuda", 1),)] * 3


def test_trace_writes_the_annotated_range(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.annotate("encode"):
            (x @ x).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert [str(f) for f in files] == [prof.trace_path]
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "encode" in names and any(n and "mm" in n for n in names)
    assert "encode" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# The program's spans (annotate / recording)
# ---------------------------------------------------------------------------


def test_annotate_off_reads_no_clock_and_enters_no_range():
    with mock.patch.object(tprof.time, "perf_counter_ns") as clock, \
            mock.patch.object(tprof, "_range") as rf, \
            mock.patch.object(tprof.torch.cuda.nvtx, "range_push") as push:
        spans = [tprof.annotate(f"dit.block{i}") for i in range(3)]
        for span in spans:
            with span:
                pass
        assert tprof.annotated("int8.H")(lambda a, b=0: a + b)(2, b=3) == 5
    assert spans[0] is spans[1] is spans[2]
    assert not clock.called and not rf.called and not push.called
    with pytest.raises(ValueError, match="passes"), tprof.annotate("dit.block"):
        raise ValueError("passes through the span")


def test_spans_nest_with_their_parents_and_self_time(monkeypatch):
    from avatar_tpu_torch.ops import int8_matmul

    @tprof.annotated("int8.H")
    def product():
        monkeypatch.setitem(int8_matmul.launch_counts, "w8a8_matmul",
                            int8_matmul.launch_counts["w8a8_matmul"] + 2)

    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(tprof.time, "perf_counter_ns", lambda: next(ticks))
    with tprof.recording() as rec:
        with tprof.annotate("pipe.step"):  # 0-70
            with tprof.annotate("dit.block"):  # 10-40
                product()  # 20-30
            with tprof.annotate("dit.block"):  # 50-60
                pass
            # recordings do not nest
            with pytest.raises(RuntimeError, match="nest"), tprof.recording():
                pass
    by_name = [(s.name, None if s.parent is None else rec.spans[s.parent].name,
                s.end_ns - s.start_ns) for s in rec.spans]
    assert by_name == [("int8.H", "dit.block", 10), ("dit.block", "pipe.step", 30),
                       ("dit.block", "pipe.step", 10), ("pipe.step", None, 70)]
    summary = rec.summary()
    assert summary["pipe.step"] == {"n": 1, "host_s": pytest.approx(70e-9),
                                    "self_s": pytest.approx(30e-9)}
    assert summary["dit.block"] == {"n": 2, "host_s": pytest.approx(40e-9),
                                    "self_s": pytest.approx(30e-9)}
    assert rec.launches == {"w8a8_matmul": 2}
    flat = rec.flat()
    assert flat["dit.block.n"] == 2.0 and flat["int8.H.self_s"] == pytest.approx(10e-9)
    assert flat["launches.w8a8_matmul"] == 2.0
    assert not any(k.startswith("count.") for k in flat)
    # off again: a span is the no-op and nothing more is kept
    assert tprof.annotate("pipe.step") is tprof._OFF
    with tprof.annotate("pipe.step"):
        pass
    assert len(rec.spans) == 4


def test_threads_lose_no_span_and_no_count():
    import sys
    import threading

    def work():
        for _ in range(300):
            with tprof.annotate("dit.block"):
                with tprof.annotate("int8.H"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tprof.recording() as rec:
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    summary = rec.summary()
    assert summary["dit.block"]["n"] == summary["int8.H"]["n"] == 16 * 300
    # each thread's spans nest in its own spans
    spans = rec.spans
    assert all(spans[s.parent].name == "dit.block" for s in spans if s.name == "int8.H")


def test_a_running_profiler_gets_the_spans_as_ranges():
    with tprof.recording(), mock.patch.object(tprof.torch._C._autograd,
                                              "_profiler_enabled", return_value=True), \
            mock.patch.object(tprof, "_range") as rf:
        with tprof.annotate("dit.attn1"):
            pass
    assert rf.call_args_list == [mock.call("dit.attn1")]
    assert rf.return_value.__enter__.called and rf.return_value.__exit__.called
    with tprof.recording(), mock.patch.object(tprof, "_range") as rf:
        with tprof.annotate("dit.attn1"):
            pass
    assert not rf.called


def test_trace_holds_the_program_spans(tmp_path):
    from avatar_tpu_torch.models.layers import linear

    w, x = torch.randn(32, 16), torch.randn(4, 16)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.annotate("encode"):
            linear({"weight": w}, x)
    names = {e.get("name") for e in json.loads(open(prof.trace_path).read())["traceEvents"]}
    assert {"encode", "gemm.bf16"} <= names
    assert prof.recording.summary()["gemm.bf16"]["n"] == 1
    assert [s.name for s in prof.recording.spans] == ["gemm.bf16", "encode"]


# ---------------------------------------------------------------------------
# The spans of the render path, on a tiny pipeline (plain versions)
# ---------------------------------------------------------------------------

TINY_DIT = {"num_attention_heads": 2, "attention_head_dim": 64, "in_channels": 16,
            "out_channels": 16, "num_layers": 2, "cross_attention_dim": 128,
            "caption_channels": 32, "activation_fn": "gelu-approximate", "qk_norm": "rms_norm",
            "standardization_norm": "rms_norm", "adaptive_norm": "single_scale_shift"}
TINY_VAE = {"latent_channels": 16, "encoder_base_channels": 16,
            "blocks": [["res_x", 1], ["compress_all", 1], ["res_x_y", 1], ["compress_all", 1],
                       ["res_x", 1]],
            "norm_layer": "pixel_norm", "patch_size": 2, "latent_log_var": "uniform",
            "use_quant_conv": False, "causal_decoder": False, "timestep_conditioning": True}
STEPS = 2
# op spans: the calls of a kernel wrapper or a library product, always innermost
OP_PREFIXES = ("attn.", "int8.", "conv.", "gemm.")
# the layer spans an op span may sit in directly
OP_PARENTS = {"attn.": {"dit.attn1", "dit.attn2", "vae.block"},
              "int8.J": {"dit.norm"}, "int8.K": {"dit.ff"},
              "int8.": {"dit.attn1", "dit.attn2", "dit.ff"},
              "conv.": {"vae.block", "vae.encode", "vae.decode"},
              "gemm.": {"dit.attn1", "dit.attn2", "dit.ff", "dit.precompute", "pipe.step",
                        "vae.block", "vae.decode", "vae.encode"}}
LAYER_PARENTS = {"dit.block": {"pipe.step"}, "pipe.rf_step": {"pipe.step"},
                 "vae.encode": {"pipe.encode"}, "vae.decode": {"pipe.decode"},
                 "vae.block": {"vae.encode", "vae.decode"}}


@pytest.fixture(scope="module")
def tiny_render():
    """(pipelines by W8A8 or not, call(pipe, **kw)) of a 9-frame 32 px
    render with reference image and pose frames, as the benchmark's."""
    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.models import vae as tvae
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams, LTXVideoPipeline

    dcfg, vcfg = tdit.DiTConfig.from_dict(TINY_DIT), tvae.VAEConfig.from_dict(TINY_VAE)
    dit, vae = tdit.init_dit(dcfg, 1, device="cpu"), tvae.init_vae(vcfg, 2, device="cpu")
    pipes = {q: LTXVideoPipeline(dcfg, dit, vcfg, vae, device="cpu",
                                 quantize_weights="w8a8" if q else False,
                                 quantize_vae="w8a8" if q else False) for q in (False, True)}
    g = torch.Generator().manual_seed(0)
    inputs = dict(prompt_embeds=torch.randn(1, 8, 32, generator=g),
                  prompt_attention_mask=torch.ones(1, 8),
                  ref_image=torch.rand(1, 1, 32, 32, 3, generator=g) * 2 - 1,
                  pose_frames=torch.rand(1, 9, 32, 32, 3, generator=g) * 2 - 1)
    params = GenerationParams(height=32, width=32, num_frames=8, num_inference_steps=STEPS,
                              guidance_scale=1.0, stg_scale=0.0, decode_timestep=0.05,
                              decode_noise_scale=0.025)

    def call(pipe, **kw):
        return pipe(params, torch.Generator().manual_seed(3), output_type="uint8", **inputs,
                    **kw)

    return pipes, call


@pytest.fixture(params=[False, True], ids=["f32", "w8a8"])
def w8a8(request, monkeypatch):
    if request.param:
        # the tiny DiT's 32 tokens onto the int8 kernels' route (plain versions)
        from avatar_tpu_torch.ops import int8_matmul

        monkeypatch.setattr(int8_matmul, "W8A8_PALLAS_MIN_TOKENS", 16)
    return request.param


def test_stage_times_hold_the_spans_and_leave_the_output_alone(tiny_render, w8a8):
    pipes, call = tiny_render
    stages = {}
    traced = call(pipes[w8a8], stage_times=stages)
    assert torch.equal(traced, call(pipes[w8a8]))
    assert {"encode_s", "denoise_s", "decode_s"} <= set(stages)
    assert stages["pipe.step.n"] == STEPS and stages["dit.block.n"] == 2 * STEPS
    names = {k.rsplit(".", 1)[0] for k in stages if k.endswith(".host_s")}
    assert {"pipe.encode", "pipe.prepare", "pipe.step", "pipe.rf_step", "pipe.decode",
            "pipe.output", "dit.precompute", "dit.block", "dit.norm", "dit.attn1", "dit.attn2",
            "dit.ff", "vae.encode", "vae.decode", "vae.block", "conv.cudnn"} <= names
    assert ({"int8.H", "int8.I", "int8.J", "int8.K", "conv.L1", "conv.L2"} <= names) == w8a8
    for name in names:
        assert 0 <= stages[f"{name}.self_s"] <= stages[f"{name}.host_s"] + 1e-12, name
    # the CPU's plain versions launch nothing
    assert not any(k.startswith("launches.") for k in stages)


def test_every_op_span_sits_under_its_layer(tiny_render, w8a8):
    pipes, call = tiny_render
    with tprof.recording() as rec:
        call(pipes[w8a8])
    spans = rec.spans
    parents = {s.parent for s in spans}
    seen = set()
    for i, s in enumerate(spans):
        parent = None if s.parent is None else spans[s.parent].name
        if s.name.startswith(OP_PREFIXES):
            assert i not in parents, f"{s.name} holds a span"
            allowed = next(v for k, v in OP_PARENTS.items() if s.name.startswith(k))
            assert parent in allowed, (s.name, parent)
            seen.add(s.name)
        elif s.name in LAYER_PARENTS:
            assert parent in LAYER_PARENTS[s.name], (s.name, parent)
        elif s.name.startswith("dit.") and s.name != "dit.precompute":
            assert parent == "dit.block", (s.name, parent)
        else:
            assert parent is None, (s.name, parent)
    assert {"attn.A", "gemm.bf16", "conv.cudnn"} <= seen
