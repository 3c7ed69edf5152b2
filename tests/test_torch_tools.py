"""The port's diagnostic tools run on the CPU and show what they are for:
the bf16 error probe; the SASS counting of ``tools/act_quant_sass.py`` on
listings in ``cuobjdump -sass``'s format; ``tools/conv_plan_sweep.py``'s
cost model against ``conv_plan`` and its fit; the source variants of
``tools/kernel_ab.py`` against the committed sources (a variant whose patch
no longer applies would fail only on the card); ``tools/w8a8_path.py``
refuses to run without a card."""

import json

import pytest

torch = pytest.importorskip("torch")

from avatar_tpu_torch.ops import kernel_build  # noqa: E402
from avatar_tpu_torch.tools import act_quant_sass as sass  # noqa: E402
from avatar_tpu_torch.ops import causal_conv3d as cc  # noqa: E402
from avatar_tpu_torch.tools import bf16_error  # noqa: E402
from avatar_tpu_torch.tools import conv_plan_sweep  # noqa: E402
from avatar_tpu_torch.tools import kernel_ab  # noqa: E402
from avatar_tpu_torch.tools import w8a8_path  # noqa: E402


def test_bf16_error_probe_names_the_timestep_rounding(capsys):
    """A bf16 walk's distance from the f32 walk is the bf16 rounding of
    t = sigma * 1000: the f32 walk fed the rounded t lands where the bf16
    walk does, and the bf16 walk with t from f32 stays near the f32 walk.
    Relative RMS of the final latents; 0.02 is twice what bf16's own
    rounding gives in this 2-layer model (0.005 to 0.009)."""
    assert bf16_error.main(["--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    walks = [ln for ln in lines if "bf16" in ln]
    assert len(walks) == len(bf16_error.GRIDS) * len(bf16_error.SETTINGS)
    for walk in walks:
        assert walk["bf16_exact_t"] < 0.02
        assert abs(walk["f32_rounded_t"] - walk["bf16"]) < 0.01
    # 1280 tokens: the schedule puts t = 673.77 where bf16 gives 672
    worst = [w for w in walks if w["tokens"] == 1280]
    assert all(w["bf16"] > 3 * w["bf16_exact_t"] for w in worst)
    evaluations = {ln["exact_t"]: ln for ln in lines if "exact_t" in ln}
    assert evaluations[True]["guided"] < 0.03 < evaluations[False]["guided"]


# act_work<gelu-approximate, false> of tools/act_quant_work.cu as nvcc 12.8
# builds it for sm_90a (encodings and NOP padding dropped): its loop is
# 0x00f0-0x0160, eight instructions
FRAME_SASS = """
        Function : _ZN12avatar_quant8act_workILi0ELb0EEEvPK13__nv_bfloat16ifPi
        /*0000*/ LDC R1, c[0x0][0x28] ;
        /*0010*/ S2R R0, SR_TID.X ;
        /*0020*/ LDC.64 R4, c[0x0][0x220] ;
        /*0030*/ ULDC.64 UR4, c[0x0][0x208] ;
        /*0040*/ ULDC UR6, c[0x0][0x218] ;
        /*0050*/ BSSY B0, 0x180 ;
        /*0060*/ IMAD.MOV.U32 R7, RZ, RZ, RZ ;
        /*0070*/ IMAD.WIDE.U32 R4, R0.reuse, 0x4, R4 ;
        /*0080*/ ISETP.GE.AND P0, PT, R0, UR6, PT ;
        /*0090*/ STG.E desc[UR4][R4.64+0x80], RZ ;
        /*00a0*/ @P0 BRA 0x170 ;
        /*00b0*/ LDC.64 R2, c[0x0][0x210] ;
        /*00c0*/ HFMA2.MMA R7, -RZ, RZ, 0, 0 ;
        /*00d0*/ IMAD.WIDE R2, R0, 0x2, R2 ;
        /*00e0*/ IMAD.MOV.U32 R6, RZ, RZ, R2 ;
        /*00f0*/ IMAD.MOV.U32 R2, RZ, RZ, R6 ;
        /*0100*/ LDG.E.U16.CONSTANT R2, desc[UR4][R2.64] ;
        /*0110*/ IADD3 R0, R0, 0x20, RZ ;
        /*0120*/ IADD3 R6, P1, R6, 0x40, RZ ;
        /*0130*/ ISETP.GE.AND P0, PT, R0, UR6, PT ;
        /*0140*/ IMAD.X R3, RZ, RZ, R3, P1 ;
        /*0150*/ LOP3.LUT R7, R7, R2, RZ, 0x3c, !PT ;
        /*0160*/ @!P0 BRA 0xf0 ;
        /*0170*/ BSYNC B0 ;
        /*0180*/ STG.E desc[UR4][R4.64], R7 ;
        /*0190*/ EXIT ;
        /*01a0*/ BRA 0x1a0;
        /*01b0*/ NOP;
"""

# a loop of five (0x10-0x50) that branches out to a block of two placed
# after EXIT (0x80-0x90), which branches back into it
OUT_OF_LINE_SASS = """
        Function : k
        /*0000*/ MOV R0, RZ ;
        /*0010*/ LDG.E R1, desc[UR4][R2.64] ;
        /*0020*/ @P0 BRA 0x80 ;
        /*0030*/ FADD R0, R0, R1 ;
        /*0040*/ IADD3 R2, R2, 0x4, RZ ;
        /*0050*/ @!P1 BRA 0x10 ;
        /*0060*/ STG.E desc[UR4][R4.64], R0 ;
        /*0070*/ EXIT ;
        /*0080*/ FMUL R1, R1, 2 ;
        /*0090*/ BRA 0x30 ;
        /*00a0*/ BRA 0xa0;
"""


def _only(text):
    funcs = sass.parse_sass(text)
    assert len(funcs) == 1
    return sass._body(next(iter(funcs.values())))


@pytest.mark.parametrize("text, length", [(FRAME_SASS, 8), (OUT_OF_LINE_SASS, 7)],
                         ids=["frame kernel", "out-of-line block"])
def test_loop_length_of_a_listing(text, length):
    """The loop body is counted from the backward branch's target to the
    branch, with any block it branches out to that branches back; the
    closing self-branch and the NOP padding are not code."""
    body = _only(text)
    assert all(op != "NOP" for _, op, _ in body)
    assert not any(op == "BRA" and args == hex(addr) for addr, op, args in body)
    assert sass._loop_length(body) == length


@pytest.mark.parametrize("text, message", [
    (OUT_OF_LINE_SASS.replace("FADD R0, R0, R1", "CALL.REL.NOINC 0x80"), "a call"),
    (FRAME_SASS.replace("@!P0 BRA 0xf0", "IADD3 R3, R3, 0x1, RZ"), "no loop"),
], ids=["call in the loop", "no loop"])
def test_loop_length_refuses_what_it_cannot_count(text, message):
    with pytest.raises(RuntimeError, match=message):
        sass._loop_length(_only(text))


def test_loop_length_counts_a_call_where_asked():
    """The division's slow-path call counts as one instruction where
    ``calls`` is set; its subroutine is not walked."""
    text = OUT_OF_LINE_SASS.replace("FADD R0, R0, R1", "CALL.REL.NOINC 0x80")
    assert sass._loop_length(_only(text), calls=True) == 7


CURRENT = {"TILE_256": cc.TILE_256, "ITEM_STAGES": cc.ITEM_STAGES,
           "SPLIT_STAGES": cc.SPLIT_STAGES}


def _every_plan(steps):
    return {conv_plan_sweep.plan_key(t, sp): 1.0 for t in conv_plan_sweep.TILES
            for sp in range(1, max(1, steps // cc.MIN_SLICE_STEPS) + 1)}


@pytest.mark.parametrize("shape,n,causal", conv_plan_sweep.SHAPES)
def test_conv_plan_sweep_models_conv_plan(shape, n, causal):
    """Given every plan conv_plan weighs, the sweep's model with
    conv_plan's constants picks conv_plan's own plan."""
    plan = cc.conv_plan(tuple(shape), n, (3, 3, 3), (1, 1, 1), causal, "zeros",
                        torch.bfloat16)
    row = {"shape": shape, "n": n, "steps": plan.steps, "chunk": plan.chunk,
           "ms": _every_plan(plan.steps)}
    assert conv_plan_sweep.model_plan(row, CURRENT) == conv_plan_sweep.plan_key(
        plan.tile_m, plan.split)


def test_conv_plan_sweep_fit_finds_the_constants_times_follow():
    """Times that follow the cost model at a point of the grid leave no
    regret at that point, and conv_plan's constants are scored beside it."""
    consts = {"TILE_256": 1.8, "ITEM_STAGES": 1.0, "SPLIT_STAGES": 8.0}
    rows = []
    for shape, n, causal in conv_plan_sweep.SHAPES[:8]:
        plan = cc.conv_plan(tuple(shape), n, (3, 3, 3), (1, 1, 1), causal, "zeros",
                            torch.bfloat16)
        times = {}
        for key in _every_plan(plan.steps):
            tile_m, split = map(int, key.split("/"))
            tiles = -(-shape[0] * shape[2] * shape[3] * shape[4] // tile_m) * -(-n // 128)
            times[key] = cc._plan_cost(tiles, plan.steps, split, tile_m, plan.chunk,
                                       *consts.values())
        rows.append({"shape": shape, "n": n, "steps": plan.steps, "chunk": plan.chunk,
                     "ms": times})
    assert conv_plan_sweep.regret(rows, consts)[0] == pytest.approx(0.0, abs=1e-12)
    result = conv_plan_sweep.fit(rows)
    assert result["best_log_regret"] == pytest.approx(0.0, abs=1e-12)
    assert result["current"] == CURRENT and result["current_log_regret"] >= 0.0


def test_issue_bound_of_the_gelu_approximate_work():
    """30 instructions for each of 5376 x 8192 elements over an H100's 132
    SMs, each issuing four warp instructions a clock at 1980 MHz: 39.49 us."""
    assert sass.issue_bound_ms(30, 5376 * 8192, 132, 1980.0) == pytest.approx(
        0.0394931129, rel=1e-8)


def test_kernel_ab_families_agree():
    assert set(kernel_ab.VARIANTS) == set(kernel_ab.COMMITTED) == set(kernel_ab.CASES)
    for family, name in kernel_ab.COMMITTED.items():
        assert name in kernel_build.KERNEL_SOURCES, family


@pytest.mark.parametrize("family, name", [
    (f, n) for f, variants in kernel_ab.VARIANTS.items() for n in variants])
def test_kernel_ab_variant_applies_to_the_committed_source(family, name):
    variant = kernel_ab.VARIANTS[family][name]
    assert variant.rule in ("exact", "none")
    source = (kernel_build.CSRC / variant.source).read_text()
    assert kernel_ab._patched(source, variant.subs) != source or variant.header_subs
    header = (kernel_build.CSRC / kernel_ab.HEADER).read_text()
    assert (kernel_ab._patched(header, variant.header_subs) != header) == bool(
        variant.header_subs)


def test_w8a8_path_needs_a_card(monkeypatch, capsys):
    """The path's timing tool measures a card or nothing: without one it
    exits 1 before it imports or builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert w8a8_path.main(["this"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
