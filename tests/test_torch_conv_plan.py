"""Kernel L's plan (``ops/causal_conv3d.py:conv_plan``) over the 2B VAE's
W8A8 conv shapes, on the CPU: every shape gets a route, stride 2 and
replicate padding the gather route, every K slice starts and ends on a tap
x chunk boundary, the int32 bound holds, a grid under half a wave with a
long K is split to at least half a wave and a grid of a wave is not split;
a K split of the plain version's int32 sums over the plan's slices equals
the unsplit sums (NaN and all-zero inputs included); the one-read
activation scale equals the two-pass one bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from avatar_tpu_torch.ops import causal_conv3d as cc
from avatar_tpu_torch.ops.int8_matmul import div127
from avatar_tpu_torch.utils.quantize import quantize_conv3d

# The 2B VAE's W8A8 convs (LTX_VAE_CONFIG with timestep conditioning, all
# 3 x 3 x 3 with zero padding) on the main path: the reference frame's and
# 97 pose frames' encodes at 256 px and the decode of [1, 13, 8, 8, 128]
# latents: (input shape [B, C, F, H, W], C_out, stride, causal, calls).
VIDEO = [
    ((1, 48, 1, 64, 64), 128, 1, True, 1),
    ((1, 128, 1, 64, 64), 128, 1, True, 8),
    ((1, 128, 1, 64, 64), 128, 2, True, 1),
    ((1, 128, 1, 32, 32), 256, 1, True, 1),
    ((1, 256, 1, 32, 32), 256, 1, True, 7),
    ((1, 256, 1, 32, 32), 256, 2, True, 1),
    ((1, 256, 1, 16, 16), 512, 1, True, 1),
    ((1, 512, 1, 16, 16), 512, 1, True, 7),
    ((1, 512, 1, 16, 16), 512, 2, True, 1),
    ((1, 512, 1, 8, 8), 512, 1, True, 14),
    ((1, 512, 1, 8, 8), 129, 1, True, 1),
    ((1, 48, 97, 64, 64), 128, 1, True, 1),
    ((1, 128, 97, 64, 64), 128, 1, True, 8),
    ((1, 128, 97, 64, 64), 128, 2, True, 1),
    ((1, 128, 49, 32, 32), 256, 1, True, 1),
    ((1, 256, 49, 32, 32), 256, 1, True, 7),
    ((1, 256, 49, 32, 32), 256, 2, True, 1),
    ((1, 256, 25, 16, 16), 512, 1, True, 1),
    ((1, 512, 25, 16, 16), 512, 1, True, 7),
    ((1, 512, 25, 16, 16), 512, 2, True, 1),
    ((1, 512, 13, 8, 8), 512, 1, True, 14),
    ((1, 512, 13, 8, 8), 129, 1, True, 1),
    ((1, 128, 13, 8, 8), 512, 1, False, 1),
    ((1, 512, 13, 8, 8), 512, 1, False, 14),
    ((1, 512, 13, 8, 8), 4096, 1, False, 1),
    ((1, 512, 25, 16, 16), 512, 1, False, 6),
    ((1, 512, 25, 16, 16), 256, 1, False, 1),
    ((1, 256, 25, 16, 16), 256, 1, False, 1),
    ((1, 256, 25, 16, 16), 2048, 1, False, 1),
    ((1, 256, 49, 32, 32), 256, 1, False, 6),
    ((1, 256, 49, 32, 32), 128, 1, False, 1),
    ((1, 128, 49, 32, 32), 128, 1, False, 1),
    ((1, 128, 49, 32, 32), 1024, 1, False, 1),
    ((1, 128, 97, 64, 64), 128, 1, False, 8),
    ((1, 128, 97, 64, 64), 48, 1, False, 1),
]
# a served batch of 4 requests decoded at once: the decode's shapes at B = 4
SERVED = [((4, *shape[1:]), n, stride, causal, calls)
          for shape, n, stride, causal, calls in VIDEO if not causal]
SHAPES = VIDEO + SERVED
IDS = [f"{s[0]}->{s[1]} s{s[2]} {'c' if s[3] else 'nc'}" for s in SHAPES]
TAPS = (3, 3, 3)
# a K of at least this many stages is long enough to pay for a split (one
# item's split overhead is SPLIT_STAGES stages)
LONG_K = 54


def _plan(shape, n, stride, causal, mode="zeros", dtype=torch.bfloat16):
    return cc.conv_plan(shape, n, TAPS, cc._triple(stride), causal, mode, dtype)


def test_the_tables_are_the_video_and_the_served_decode():
    """129 int8 convs a video (43 per encode, 43 per decode) in 35 shapes,
    31 by (input, C_out, stride); 13 shapes in a served decode."""
    assert len(VIDEO) == 35 and sum(s[4] for s in VIDEO) == 129
    assert len({s[:3] for s in VIDEO}) == 31
    assert len(SERVED) == 13 and sum(s[4] for s in SERVED) == 43


@pytest.mark.parametrize("shape,n,stride,causal,calls", SHAPES, ids=IDS)
def test_every_shape_gets_its_route(shape, n, stride, causal, calls):
    """Stride 1 takes the wgmma kernel, stride 2 the gather kernel; the
    same shape with replicate padding takes the gather kernel."""
    plan = _plan(shape, n, stride, causal)
    assert plan.route == ("sm90" if stride == 1 else "gather")
    assert _plan(shape, n, stride, causal, "replicate").route == "gather"
    if plan.route == "sm90":
        assert plan.chunk in (64, 128) and cc.padded_channels(shape[1]) % plan.chunk == 0
        assert plan.tile_m in (128, 256) and plan.tile_n == cc.TILE_N


@pytest.mark.parametrize("shape,n,stride,causal,calls", SHAPES, ids=IDS)
def test_k_slices_start_and_end_on_tap_chunk_boundaries(shape, n, stride, causal, calls):
    """The slices cover K in order, each a whole number of stages (one tap's
    channel chunk each) and, split, at least MIN_SLICE_STEPS of them; the
    int32 sums cannot overflow: 127^2 K < 2^31."""
    plan = _plan(shape, n, stride, causal)
    k = 27 * cc.padded_channels(shape[1])
    assert plan.k == k and 127 * 127 * k < 2**31
    ranges = plan.k_ranges()
    assert len(ranges) == plan.split
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    if plan.route == "sm90":
        for k0, k1 in ranges:
            assert k0 % plan.chunk == 0 and k1 % plan.chunk == 0
            assert (k1 - k0) // plan.chunk >= (cc.MIN_SLICE_STEPS if plan.split > 1 else 1)


@pytest.mark.parametrize("shape,n,stride,causal,calls", SHAPES, ids=IDS)
def test_split_grids_fill_the_card_where_k_allows(shape, n, stride, causal, calls):
    """A grid of output tiles under half a wave of the 132 SMs with a long
    K (the 256- and 512-channel convs) is split to between half a wave and
    one; a grid of at least one wave is never split."""
    plan = _plan(shape, n, stride, causal)
    if plan.route != "sm90":
        return
    if plan.tiles >= cc.SMS:
        assert plan.split == 1
    if plan.tiles < cc.SMS // 2 and plan.steps >= LONG_K:
        assert plan.split > 1
        assert cc.SMS // 2 <= plan.items <= cc.SMS


@pytest.mark.parametrize("shape,taps,stride,mode,route", [
    ((1, 64, 5, 12, 10), TAPS, 1, "zeros", "gather"),     # W does not divide 64
    ((1, 32, 5, 16, 16), TAPS, 1, "zeros", "gather"),     # 32 channels: no 64-byte stage
    ((1, 64, 5, 16, 16), TAPS, (1, 2, 2), "zeros", "gather"),
    ((1, 64, 5, 16, 16), (3, 2, 2), 1, "zeros", "gather"),  # even kh, kw
    ((1, 64, 5, 16, 16), (1, 1, 1), 1, "zeros", "sm90"),
    ((1, 96, 5, 8, 8), TAPS, 1, "zeros", "gather"),      # 96 channels
    ((1, 64, 5, 4, 4), TAPS, 1, "zeros", "gather"),      # 16 positions a frame
    ((1, 64, 5, 2, 32), TAPS, 1, "zeros", "sm90"),       # two rows of 32
    ((1, 64, 5, 16, 16), TAPS, 1, "replicate", "gather"),
])
def test_the_wgmma_kernel_takes_what_its_boxes_can_read(shape, taps, stride, mode, route):
    assert cc.conv_plan(shape, 40, taps, cc._triple(stride), True, mode,
                        torch.bfloat16).route == route


def test_f32_takes_128_position_tiles_and_overflowing_k_raises():
    for shape, n, stride, causal, _ in VIDEO:
        plan = _plan(shape, n, stride, causal, dtype=torch.float32)
        assert plan.tile_m == 128
    with pytest.raises(ValueError, match="overflow"):
        cc.conv_plan((1, 5120, 3, 8, 8), 16, TAPS, (1, 1, 1), True, "zeros", torch.bfloat16)


def _conv_case(seed, c, n, shape, kind):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, c, *shape)).astype(np.float32))
    if kind == "zeros":
        x = torch.zeros_like(x)
    elif kind == "nan":
        x[0, c // 2, 0, 1, 2] = float("nan")
    w = torch.from_numpy(rng.standard_normal((n, c, *TAPS)).astype(np.float32) * 0.05)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return x, quantize_conv3d({"weight": w, "bias": bias})


# (channels in, out, F, H, W, causal): grids of one or two tiles; the plan
# splits the long K of 256 and 512 channels (128-byte stages); 64 channels
# (64-byte stages, K too short to pay for a split) are split here by hand
SPLIT_CASES = [(256, 16, 2, 8, 8, True), (64, 40, 3, 8, 8, False), (512, 24, 1, 8, 8, True)]


@pytest.mark.parametrize("kind", ["random", "zeros", "nan"])
@pytest.mark.parametrize("c,n,f,h,w,causal", SPLIT_CASES)
def test_split_sums_equal_the_unsplit_sums(c, n, f, h, w, causal, kind):
    """The plain version's int32 sums over each of the plan's K slices
    (a conv with the kernel zeroed outside the slice), added in int32,
    equal the sums over all of K, and give the plain version's output bit
    for bit; also at other split counts, where slices are uneven."""
    x, p = _conv_case(c + n, c, n, (f, h, w), kind)
    plan = cc.conv_plan(tuple(x.shape), n, TAPS, (1, 1, 1), causal, "zeros", torch.float32)
    assert plan.route == "sm90" and (plan.split > 1) == (plan.steps >= LONG_K)
    s = cc.act_scale(x)
    levels = cc._levels(x, s)
    whole = cc._int8_sums(levels, p["kernel_q8"], 1, causal, "zeros")
    for split in sorted({plan.split, 2, 5, plan.steps // cc.MIN_SLICE_STEPS}):
        ranges = dataclasses.replace(plan, split=split).k_ranges()
        parts = [cc._int8_sums(levels, p["kernel_q8"], 1, causal, "zeros", r) for r in ranges]
        total = torch.zeros_like(whole)
        for part in parts:
            assert part.dtype == torch.int32
            total += part
        assert torch.equal(total, whole)
    out = cc._dequant(whole, s, p["scale"], p["bias"], x.dtype)
    ref = cc._int8_conv3d_plain(x, p["kernel_q8"], p["scale"], p["bias"], 1, causal, "zeros")
    assert torch.equal(out, ref) or (kind == "nan" and torch.isnan(out).all()
                                     and torch.isnan(ref).all())


def _two_pass_scale(x):
    return div127(torch.clamp_min(x.abs().amax().float(), 1e-8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["random", "negative", "zeros", "nan", "inf", "-inf", "tiny"])
def test_one_read_scale_equals_the_two_pass_scale(dtype, kind):
    """max(-min x, max x) is max|x| exactly; a NaN stays NaN; an all-zero
    input takes the 1e-8 floor."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 3, 4, 4)).astype(np.float32))
    if kind == "negative":
        x = -x.abs() - 1.0
    elif kind == "zeros":
        x = torch.zeros_like(x)
    elif kind == "nan":
        x[1, 2, 0, 3, 1] = float("nan")
    elif kind in ("inf", "-inf"):
        x[0, 5, 2, 0, 0] = float(kind)
    elif kind == "tiny":
        x = x * 1e-12
    x = x.to(dtype)
    got, want = cc.act_scale(x), _two_pass_scale(x)
    assert got.dtype == want.dtype == torch.float32 and got.shape == ()
    if kind == "nan":
        assert torch.isnan(got) and torch.isnan(want)
    else:
        assert torch.equal(got, want)
