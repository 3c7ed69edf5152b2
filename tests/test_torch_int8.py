"""Quantized DiT inference of the PyTorch port against the JAX package, on
the CPU: ``utils/quantize.py`` bit for bit, the plain versions of the four
int8 kernels against the Pallas kernels in interpret mode, every branch of
``linear``, a 2-layer ``dit_apply`` on both W8A8 routes and under w8, and a
tiny W8A8 pipeline.

The JAX package takes its int8 kernels only on a TPU backend and above
``W8A8_PALLAS_MIN_TOKENS``. The kernel-route tests patch
``avatar_tpu.ops.attention.tpu_backend`` to true and lower the threshold in
both packages, so the Pallas kernels run in interpret mode on one side and
the port's plain versions on the other; spies count the calls, so neither
side can stay on the short route unnoticed. Inputs are f32 from numpy
seeds unless stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avatar_tpu.ops.attention as jattention
import avatar_tpu.ops.int8_matmul as ji8
from avatar_tpu.models import dit as jdit
from avatar_tpu.models import layers as jlayers
from avatar_tpu.models import vae as jvae
from avatar_tpu.ops import rope as jrope
from avatar_tpu.parallel.pipeline import stack_block_params as jstack
from avatar_tpu.pipelines import pipeline as jpipe
from avatar_tpu.utils import quantize as jquant
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models import layers as tlayers
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.ops import int8_matmul as ti8
from avatar_tpu_torch.pipelines import pipeline as tpipe
from avatar_tpu_torch.utils import quantize as tquant
from avatar_tpu_torch.utils.weight_import import (
    _convert,
    dit_params_from_numpy,
    vae_params_from_numpy,
)
from torch_parity import dit_numpy_params, vae_numpy_params

torch.set_num_threads(2)

# The row quantizations: the scales agree to f32 rounding (rtol 1e-6, the
# JAX package's own tolerance for its kernels), and an int8 may be one
# level off where the two sides' f32 reductions (mean of squares), rsqrt
# against 1 / sqrt, or tanh / erf differ by an ulp and move an element
# across a rounding boundary: at most this fraction of the elements.
SCALE_RTOL = 1e-6
LEVEL_FRACTION = 1e-3
# f32 outputs of one int8 product: the int32 sums are exact on both sides
# and the dequant rounds the same f32 steps; the reference's XLA product
# may still associate the epilogue differently (the JAX package's own test
# holds its kernel to the XLA dot at rtol 1e-6, atol 1e-5).
MATMUL_RTOL, MATMUL_ATOL = 1e-6, 1e-5
# Two W8A8 blocks in f32: the activations are requantized eight times per
# block (about 1e5 roundings here), and where the two sides' f32 results
# differ by an ulp an element lands one int8 level (max|row| / 127) apart;
# a few such flips are expected (an ulp of 1.2e-7 at 127 levels), and
# attention spreads each over every token. So the outputs are held to a
# relative RMS of a few flips and a largest error of two output levels;
# 7e-4 to 8e-4 and 0.2% of max|ref| measured with two weight seeds.
DIT_W8A8_REL_RMS = 3e-3
DIT_W8A8_MAX = 2 / 127

CFG_KW = dict(
    num_attention_heads=4, attention_head_dim=16, in_channels=16,
    out_channels=16, num_layers=2, cross_attention_dim=64, caption_channels=96,
)
LK = 16


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bf16_pair(a):
    """The same bf16 values as a JAX array and a torch tensor."""
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


def _assert_rows_match(q, s, ref_q, ref_s):
    q, s = np.asarray(q).astype(np.int32), np.asarray(s, np.float32)
    ref_q, ref_s = np.asarray(ref_q).astype(np.int32), np.asarray(ref_s, np.float32)
    assert q.shape == ref_q.shape and s.shape == ref_s.shape
    np.testing.assert_allclose(s, ref_s, rtol=SCALE_RTOL, atol=0)
    diff = np.abs(q - ref_q)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= LEVEL_FRACTION


# ---------------------------------------------------------------------------
# utils/quantize.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", [False, True])
def test_quantize_linear_bit_for_bit(act):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    w[:, 5] = 0.0  # a zero column: scale 1
    w[3, 7] = 2.5 * np.abs(w[:, 7]).max()  # an outlier
    bias = rng.standard_normal(80).astype(np.float32)
    ref = jquant.quantize_linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)},
                                 act=act)
    out = tquant.quantize_linear({"weight": _t(w.T), "bias": _t(bias)}, act=act)
    key = "kernel_q8" if act else "kernel_q"
    assert set(out) == set(ref) == {key, "scale", "bias"}
    assert out[key].dtype == torch.int8
    np.testing.assert_array_equal(out[key].numpy().T, np.asarray(ref[key]))
    assert out["scale"].dtype == (torch.float32 if act else torch.bfloat16)
    np.testing.assert_array_equal(out["scale"].float().numpy(),
                                  np.asarray(ref["scale"], np.float32))
    assert out["scale"][5].item() == 1.0


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX unpermuted f32 params, port cfg)."""
    jcfg, tcfg = jdit.DiTConfig(**CFG_KW), tdit.DiTConfig(**CFG_KW)
    return jcfg, jax.tree.map(jnp.asarray, dit_numpy_params(jcfg)), tcfg


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("mode,min_size", [("w8", 2**12), ("w8a8", 2**18)])
def test_quantize_dit_params_bit_for_bit(models, mode, min_size):
    """The port quantizing the carried-across f32 tree == the JAX tree
    quantized in JAX and carried across (int8, scale values and dtypes)."""
    jcfg, jparams, tcfg = models
    ref = dit_params_from_numpy(
        jax.tree.map(np.asarray, jquant.quantize_dit_params(jparams, min_size, mode)),
        tcfg, device="cpu")
    raw = dit_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    out = tquant.quantize_dit_params(raw, min_size, mode)
    ref_leaves, out_leaves = dict(_leaves(ref)), dict(_leaves(out))
    assert ref_leaves.keys() == out_leaves.keys()
    n_int8 = 0
    for path, r in ref_leaves.items():
        o = out_leaves[path]
        assert o.dtype == r.dtype, path
        assert torch.equal(o, r), path
        n_int8 += o.dtype == torch.int8
    # w8: every linear of >= 2^12 elements; w8a8: the eight block linears
    assert n_int8 == (sum(1 for p in out_leaves if p.endswith("kernel_q"))
                      if mode == "w8" else 8 * CFG_KW["num_layers"])
    assert n_int8 > 0


def test_stacked_int8_tree_carries_across(models):
    """A W8A8 tree stacked on the layer axis in JAX imports as the port's
    stack of the imported list: int8 stays int8 ([L, out, in]), the f32
    scales stay f32."""
    jcfg, jparams, tcfg = models
    jq = jquant.quantize_dit_params(jparams, mode="w8a8")
    stacked = dit_params_from_numpy(
        jax.tree.map(np.asarray, dict(jq, blocks=jstack(jq["blocks"]))), tcfg,
        device="cpu")
    listed = dit_params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    ref = dict(_leaves(tdit.stack_block_params(listed["blocks"])))
    out = dict(_leaves(stacked["blocks"]))
    assert out.keys() == ref.keys()
    assert all(out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k]) for k in ref)
    to_q = stacked["blocks"]["attn1"]["to_q"]
    assert to_q["kernel_q8"].dtype == torch.int8 and to_q["scale"].dtype == torch.float32
    assert to_q["kernel_q8"].shape == (CFG_KW["num_layers"], 64, 64)


# ---------------------------------------------------------------------------
# The kernels' plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def test_quantize_rows_plain_matches_pallas():
    x = np.random.default_rng(1).standard_normal((300, 512)).astype(np.float32)
    x[7] = 0.0  # zero row: s = 1e-30 / 127, q = 0
    jx, tx = _bf16_pair(x)
    ref_q, ref_s = ji8.quantize_rows_pallas(jx, interpret=True)
    q, s = ti8.quantize_rows_pallas(tx)
    _assert_rows_match(q, s, ref_q, ref_s)
    assert not q[7].any() and s[7].item() == np.float32(1e-30) / np.float32(127)
    # the plain quantize_rows (the reference's XLA expression, by division)
    ref_q, ref_s = ji8.quantize_rows(jnp.asarray(x))
    q, s = ti8.quantize_rows(_t(x))
    _assert_rows_match(q, s, ref_q, ref_s)


@pytest.mark.parametrize("with_shift", [True, False])
def test_fused_rms_mod_quant_plain_matches_pallas(with_shift):
    rng = np.random.default_rng(2)
    b, n, c = 2, 300, 256
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    x[0, 7] = 0.0  # zero row: quantizes the shift vector
    cvec = (1.0 + 0.3 * rng.standard_normal((b, 1, c))).astype(np.float32)
    shift = (0.2 * rng.standard_normal((b, 1, c))).astype(np.float32)
    (jx, tx), (jc, tc), (js, ts) = (_bf16_pair(a) for a in (x, cvec, shift))
    ref = ji8.fused_rms_mod_quant(jx, jc, js if with_shift else None, eps=1e-6,
                                  interpret=True)
    out = ti8.fused_rms_mod_quant(tx, tc, ts if with_shift else None, eps=1e-6)
    assert out.shape == (b, n, c) and out.dtype == torch.bfloat16
    assert out.q.shape == (b * n, c) and out.s.shape == (b * n, 1)
    _assert_rows_match(out.q, out.s, ref.q, ref.s)


@pytest.mark.parametrize("act", ["geglu", "gelu", "gelu-approximate"])
def test_fused_act_quant_plain_matches_pallas(act):
    h = np.random.default_rng(3).standard_normal((1, 200, 512)).astype(np.float32)
    h[0, 11] = 0.0
    jh, th = _bf16_pair(h)
    ref = ji8.fused_act_quant(jh, act, interpret=True)
    out = ti8.fused_act_quant(th, act)
    width = 256 if act == "geglu" else 512
    assert out.shape == tuple(ref.shape) == (1, 200, width)
    _assert_rows_match(out.q, out.s, ref.q, ref.s)


# Rows that are not finite: one NaN, +inf or -inf element each, beside
# finite rows. The reference keeps a NaN through its max (scale NaN) and
# its cast turns a NaN level into 0; an inf gives scale inf (I, K) and
# level 0 everywhere. The one difference is kept on purpose (ROADMAP §3):
# gelu-erf of -inf (K's gelu, and geglu's gate), where XLA's CPU erf(-inf)
# is not exactly -1, so the reference's gelu is -inf * (1 + erf) = -inf and
# its scale inf, while torch's erf(-inf) is -1 and the port's gelu NaN
# (-inf * 0), its scale NaN.
NONFINITE = {3: np.nan, 5: np.inf, 8: -np.inf}
NONFINITE_CASES = ["quantize_rows", "rms_mod_quant shift", "rms_mod_quant",
                   "gelu-approximate", "gelu", "geglu", "geglu gate"]


@pytest.mark.parametrize("case", NONFINITE_CASES)
def test_nonfinite_rows_plain_match_pallas(case):
    """The port's plain versions of I, J and K against the Pallas kernels in
    interpret mode on rows with one NaN, +inf or -inf element: those rows'
    levels exactly equal (all 0) and their scales equal, NaN to NaN and inf
    to inf (but for K gelu's -inf row, held as it stands); the finite rows
    beside them to the usual rule."""
    rng = np.random.default_rng(4)
    b, n, c = 1, 16, 256
    act = case.split()[0]
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    for row, value in NONFINITE.items():
        # "geglu gate": the element in the gate half (c / 2 on)
        x[0, row, c // 2 + 17 if case == "geglu gate" else 17] = value
    jx, tx = _bf16_pair(x)
    if case == "quantize_rows":
        ref = ji8.quantize_rows_pallas(jx.reshape(n, c), interpret=True)
        q, s = ti8.quantize_rows_pallas(tx.reshape(n, c))
    elif case.startswith("rms_mod_quant"):
        cvec = (1.0 + 0.3 * rng.standard_normal((b, 1, c))).astype(np.float32)
        shift = (0.2 * rng.standard_normal((b, 1, c))).astype(np.float32)
        (jc, tc), (js, ts) = _bf16_pair(cvec), _bf16_pair(shift)
        with_shift = case.endswith("shift")
        r = ji8.fused_rms_mod_quant(jx, jc, js if with_shift else None, eps=1e-6,
                                    interpret=True)
        out = ti8.fused_rms_mod_quant(tx, tc, ts if with_shift else None, eps=1e-6)
        ref, (q, s) = (r.q, r.s), (out.q, out.s)
    else:
        r = ji8.fused_act_quant(jx, act, interpret=True)
        out = ti8.fused_act_quant(tx, act)
        ref, (q, s) = (r.q, r.s), (out.q, out.s)
    q, s = np.asarray(q).astype(np.int32), np.asarray(s, np.float32)[:, 0]
    ref_q, ref_s = np.asarray(ref[0]).astype(np.int32), np.asarray(ref[1], np.float32)[:, 0]
    bad = sorted(NONFINITE)
    finite = [i for i in range(n) if i not in NONFINITE]
    _assert_rows_match(q[finite], s[finite], ref_q[finite], ref_s[finite])
    np.testing.assert_array_equal(q[bad], ref_q[bad])
    assert not q[bad].any()
    expected_s = {  # the scales of the NaN, +inf and -inf rows
        "quantize_rows": (np.nan, np.inf, np.inf),
        "rms_mod_quant shift": (np.nan,) * 3, "rms_mod_quant": (np.nan,) * 3,
        "gelu-approximate": (np.nan, np.inf, np.nan), "gelu": (np.nan, np.inf, np.nan),
        "geglu": (np.nan, np.inf, np.inf), "geglu gate": (np.nan, np.inf, np.nan)}[case]
    np.testing.assert_array_equal(s[bad], np.float32(expected_s))
    if case in ("gelu", "geglu gate"):  # the reference's erf(-inf): inf, the port NaN
        np.testing.assert_array_equal(ref_s[bad], np.float32((np.nan, np.inf, np.inf)))
    else:
        np.testing.assert_array_equal(ref_s[bad], s[bad])


@pytest.mark.parametrize("m,k,n,use_bias,bk", [
    (832, 256, 512, True, None), (100, 512, 256, False, None),
    (320, 2048, 128, True, 512),  # bk: the k-split kernel
])
def test_w8a8_matmul_plain_matches_pallas(m, k, n, use_bias, bk):
    """As ``tests/test_ops.py`` calls the kernel; the port's weight operand
    is the transposed [N, K]."""
    rng = np.random.default_rng(m * n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w_s = (np.abs(w).max(axis=0) / 127.0).astype(np.float32)
    w_q = np.round(w / w_s).astype(np.int8)
    bias = rng.standard_normal(n).astype(np.float32) if use_bias else None
    x_q, x_s = ji8.quantize_rows(jnp.asarray(x))
    ref = ji8.w8a8_matmul(x_q, x_s, jnp.asarray(w_q), jnp.asarray(w_s),
                          bias=None if bias is None else jnp.asarray(bias), bk=bk,
                          out_dtype=jnp.float32, interpret=True)
    out = ti8.w8a8_matmul(torch.from_numpy(np.array(x_q)), _t(x_s),
                          torch.from_numpy(w_q.T.copy()), _t(w_s),
                          None if bias is None else _t(bias), torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=MATMUL_RTOL,
                               atol=MATMUL_ATOL)


@pytest.mark.parametrize("width,dtype,impl", [
    (8192, torch.bfloat16, "sm90"),      # the DiT's FF activation
    (16384, torch.bfloat16, "sm90"),     # the widest row
    (2056, torch.bfloat16, "sm90"),      # 257 chunks of 8
    (1001, torch.bfloat16, "rowblock"),  # not a multiple of 8
    (4096, torch.bfloat16, "sm90"),      # geglu's half of 8192
    (1028, torch.bfloat16, "rowblock"),  # geglu's half of 2056
    (8192, torch.float32, "rowblock"),
])
def test_act_quant_implementation_by_width(width, dtype, impl):
    """K's route on the card: the register kernel for bf16 rows whose
    output width is a multiple of 8, the row-block kernel otherwise."""
    assert ti8.act_quant_impl(width, dtype) == impl


@pytest.mark.parametrize("width,dtype,impl", [
    (2048, torch.bfloat16, "sm90"),      # the DiT's width: a warp a row
    (128, torch.bfloat16, "sm90"),       # the tiny W8A8 DiT's (2 heads of 64)
    (16384, torch.bfloat16, "sm90"),     # the widest row: 8 warps a row
    (2056, torch.bfloat16, "sm90"),      # 257 chunks of 8, not a multiple of 32
    (4096, torch.bfloat16, "sm90"),      # above one warp's 2,048: 2 warps a row
    (1001, torch.bfloat16, "rowblock"),  # not a multiple of 8
    (2052, torch.bfloat16, "rowblock"),
    (2048, torch.float32, "rowblock"),
])
def test_rms_mod_quant_implementation_by_width(width, dtype, impl):
    """J's route on the card: the register kernel for bf16 rows whose width
    is a multiple of 8, the row-block kernel otherwise."""
    assert ti8.rms_mod_quant_impl(width, dtype) == impl


@pytest.mark.parametrize("m,n,sms,tile_n", [
    # the DiT's W8A8 shapes on 132 SMs: 336 and 1,344 tiles of 256 columns
    (5376, 2048, 132, 256), (5376, 8192, 132, 256),
    # the short path and a ragged M: 128 columns fill the SMs
    (832, 2048, 132, 128), (5000, 2048, 132, 128), (3328, 2048, 132, 256),
    # narrow products: half-width tiles run on twice the SMs
    (1, 2, 132, 128), (128, 256, 132, 128), (128, 200, 132, 128),
    # fewer SMs: 42 x 8 tiles fill 8 SMs evenly
    (5376, 2048, 8, 256),
])
def test_matmul_tile_n(m, n, sms, tile_n):
    """128-column tiles where they finish in under 90% of the rounds of
    256-column ones, else 256 (the choice measured on an H100)."""
    assert ti8.matmul_tile_n(m, n, sms) == tile_n


@pytest.mark.parametrize("sms", [132, 114, 7])
def test_matmul_tile_n_rounds_against_a_brute_force_walk(sms):
    """matmul_tile_n picks the tile width that a brute-force walk of the
    kernel's persistent schedule picks (CTA c of min(sms, tiles) takes tiles
    c, c + ctas, ...; a 128-column tile takes half a 256-column one's time):
    128 columns where the busiest CTA finishes in under 90% of its time
    with 256-column tiles. The walk visits every output tile once."""
    for m in (1, 128, 129, 832, 3328, 5000, 5376):
        for n in (2, 200, 256, 520, 2048, 8192):
            busiest = {}
            for tile_n in (128, 256):
                tiles = [(i, j) for i in range(-(-m // 128)) for j in range(-(-n // tile_n))]
                ctas = min(sms, len(tiles))
                walks = [tiles[c::ctas] for c in range(ctas)]
                assert sorted(t for w in walks for t in w) == tiles
                busiest[tile_n] = max(len(w) for w in walks) * tile_n / 256
            want = 128 if busiest[128] < 0.9 * busiest[256] else 256
            assert ti8.matmul_tile_n(m, n, sms) == want, (m, n)


def test_matmul_cpu_route_launches_nothing():
    """On the CPU the wrapper runs the plain version and launches nothing."""
    ti8.reset_launch_counts()
    x_q = torch.ones(4, 32, dtype=torch.int8)
    out = ti8.w8a8_matmul(x_q, torch.ones(4, 1), x_q[:2], torch.ones(2))
    assert torch.equal(out, torch.full((4, 2), 32.0, dtype=torch.bfloat16))
    assert not any(ti8.launch_counts.values())


# ---------------------------------------------------------------------------
# linear, branch by branch
# ---------------------------------------------------------------------------


@pytest.fixture
def kernel_route(monkeypatch):
    """Both packages on their kernel route from 8 tokens on; the JAX one
    believes it runs on a TPU (its Pallas kernels then run in interpret
    mode on the CPU). Returns the calls counted on each side."""
    calls = {"jax": {}, "port": {}}

    def spy(module, name, side):
        fn = getattr(module, name)

        def counted(*a, **kw):
            calls[side][name] = calls[side].get(name, 0) + 1
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)

    for name in ("w8a8_matmul", "quantize_rows_pallas", "fused_rms_mod_quant",
                 "fused_act_quant"):
        spy(ji8, name, "jax")
        spy(ti8, name, "port")
    monkeypatch.setattr(ji8, "W8A8_PALLAS_MIN_TOKENS", 8)
    monkeypatch.setattr(ti8, "W8A8_PALLAS_MIN_TOKENS", 8)
    monkeypatch.setattr(jattention, "tpu_backend", lambda: True)
    return calls


def _linear_params(act, with_bias=True):
    rng = np.random.default_rng(4)
    jp = {"kernel": jnp.asarray(rng.standard_normal((64, 48)).astype(np.float32))}
    if with_bias:
        jp["bias"] = jnp.asarray(rng.standard_normal(48).astype(np.float32))
    jq = jquant.quantize_linear(jp, act=act)
    return jq, _convert(jax.tree.map(np.asarray, jq), "cpu", torch.float32)


@pytest.mark.parametrize("branch", ["kernel_q", "kernel_q8 short", "kernel_q8 long",
                                    "prequant rows"])
def test_linear_branches_match_jax(request, branch):
    jq, tq = _linear_params(act=branch != "kernel_q")
    x = np.random.default_rng(5).standard_normal((2, 24, 64)).astype(np.float32)
    if branch in ("kernel_q8 long", "prequant rows"):
        calls = request.getfixturevalue("kernel_route")
    if branch == "prequant rows":
        jq_rows, js = ji8.quantize_rows_pallas(jnp.asarray(x.reshape(48, 64)))
        jx = ji8.PrequantRows(jq_rows, js, x.shape, jnp.float32)
        tx = ti8.PrequantRows(torch.from_numpy(np.array(jq_rows)), _t(js), x.shape,
                              torch.float32)
    else:
        jx, tx = jnp.asarray(x), _t(x)
    ref = jlayers.linear(jq, jx)
    out = tlayers.linear(tq, tx)
    assert out.shape == tuple(ref.shape) == (2, 24, 48)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=MATMUL_RTOL,
                               atol=MATMUL_ATOL)
    if branch == "kernel_q8 long":
        assert calls["jax"] == calls["port"] == {"quantize_rows_pallas": 1,
                                                 "w8a8_matmul": 1}
    if branch == "prequant rows":
        assert calls["port"] == {"w8a8_matmul": 1}


# ---------------------------------------------------------------------------
# dit_apply on quantized weights
# ---------------------------------------------------------------------------


def _dit_inputs(grid_shape, batch=2):
    rng = np.random.default_rng(6)
    n = int(np.prod(grid_shape))
    tokens = rng.standard_normal((batch, n, 16)).astype(np.float32)
    text = rng.standard_normal((batch, LK, 96)).astype(np.float32)
    mask = np.ones((batch, LK), np.float32)
    mask[0, 10:] = 0.0
    grid = jrope.get_latent_coords(*grid_shape, batch_size=batch)
    t = np.asarray([0.5, 0.25][:batch], np.float32)
    return tokens, text, mask, grid, t


def _dit_both(models, mode, rope_split=True, stacked=False, impl="xla",
              min_size=2**18):
    """The JAX-quantized tree through the JAX ``dit_apply`` and, carried
    across, through the port's; 64 tokens per sample."""
    jcfg, jparams, tcfg = models
    jq = jquant.quantize_dit_params(jparams, min_size, mode)
    tq = dit_params_from_numpy(jax.tree.map(np.asarray, jq), tcfg, device="cpu")
    if rope_split:
        jq = jdit.permute_dit_params_for_split_rope(jq, jcfg)
        tq = tdit.permute_dit_params_for_split_rope(tq, tcfg)
    if stacked:
        jq = dict(jq, blocks=jstack(jq["blocks"]))
        tq = dict(tq, blocks=tdit.stack_block_params(tq["blocks"]))
    tokens, text, mask, grid, t = _dit_inputs((2, 4, 8))
    ref = jdit.dit_apply(jq, jcfg, tokens, grid, t, text, mask,
                         attention_impl=impl, rope_split=rope_split)
    out = tdit.dit_apply(tq, tcfg, _t(tokens), _t(grid), _t(t), _t(text), _t(mask),
                         attention_impl=impl, rope_split=rope_split)
    return out.numpy(), np.asarray(ref)


def _assert_dit_close(out, ref):
    assert out.shape == ref.shape
    diff = out - ref
    assert np.sqrt((diff**2).mean() / (ref**2).mean()) <= DIT_W8A8_REL_RMS
    assert np.abs(diff).max() <= DIT_W8A8_MAX * np.abs(ref).max()


@pytest.mark.parametrize("rope_split,stacked", [(True, False), (False, False),
                                                (True, True)])
def test_dit_apply_w8a8_short_route_matches_jax(models, rope_split, stacked):
    """64 tokens, below the threshold: the library int8 product on the
    port's side, XLA's int8 dot on the JAX side."""
    _assert_dit_close(*_dit_both(models, "w8a8", rope_split, stacked))


def test_dit_apply_w8a8_kernel_route_matches_jax(models, kernel_route):
    """The threshold lowered to 8 tokens in both packages and
    ``attention_impl="xla"`` on both sides: J before attention and before
    the FF, I before attn1.to_out and attn2's q and out products, K between
    the FF products, H for all eight, in the Pallas kernels (interpret mode)
    and in the port's plain versions."""
    _assert_dit_close(*_dit_both(models, "w8a8"))
    per_block = {"fused_rms_mod_quant": 2, "quantize_rows_pallas": 3,
                 "fused_act_quant": 1, "w8a8_matmul": 8}
    layers = CFG_KW["num_layers"]
    expect = {k: v * layers for k, v in per_block.items()}
    assert kernel_route["jax"] == kernel_route["port"] == expect


def test_dit_apply_w8a8_kernel_route_stacked_matches_jax(models, kernel_route):
    _assert_dit_close(*_dit_both(models, "w8a8", stacked=True))
    assert kernel_route["port"]["w8a8_matmul"] == 8 * CFG_KW["num_layers"]


def test_dit_apply_w8_matches_jax(models):
    """Weight-only, every linear of >= 2^12 elements (the precomputed
    cross-attention k/v included), on the kernel attention paths."""
    out, ref = _dit_both(models, "w8", impl="flash", min_size=2**12)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

H = W = 64
PIPE_DIT_KW = dict(num_attention_heads=4, attention_head_dim=8, in_channels=8,
                   out_channels=8, num_layers=2, cross_attention_dim=32,
                   caption_channels=32)


@pytest.fixture(scope="module")
def pipeline_trees():
    jvcfg = dataclasses.replace(jvae.demo_config(latent_channels=8),
                                base_channels=32, decoder_base_channels=32)
    tvcfg = dataclasses.replace(tvae.demo_config(latent_channels=8),
                                base_channels=32, decoder_base_channels=32)
    jdcfg, tdcfg = jdit.DiTConfig(**PIPE_DIT_KW), tdit.DiTConfig(**PIPE_DIT_KW)
    return (jdcfg, jax.tree.map(jnp.asarray, dit_numpy_params(jdcfg, seed=1)), jvcfg,
            vae_numpy_params(jvcfg), tdcfg, tvcfg)


@pytest.mark.parametrize("route", ["short", "kernel"])
def test_w8a8_pipeline_matches_jax(request, pipeline_trees, route):
    """Both pipelines quantize the same f32 weights themselves
    (``quantize_weights="w8a8"``); 9 frames at 64 px, 8 tokens, 3 Euler
    steps, guidance 1, the port fed JAX's initial latents. On the kernel
    route the threshold is 8 tokens in both packages."""
    jdcfg, jdparams, jvcfg, vtree, tdcfg, tvcfg = pipeline_trees
    if route == "kernel":
        calls = request.getfixturevalue("kernel_route")
    ctor = dict(attention_impl="xla", quantize_weights="w8a8")
    jp = jpipe.LTXVideoPipeline(jdcfg, jdparams, jvcfg,
                                jax.tree.map(jnp.asarray, vtree), **ctor)
    tp = tpipe.LTXVideoPipeline(
        tdcfg, dit_params_from_numpy(jax.tree.map(np.asarray, jdparams), tdcfg,
                                     device="cpu"),
        tvcfg, vae_params_from_numpy(vtree, tvcfg, device="cpu"), device="cpu", **ctor)
    rng = np.random.default_rng(7)
    embeds = rng.standard_normal((1, 8, 32)).astype(np.float32)
    mask = np.ones((1, 8), np.float32)
    cond = dict(ref_latents=rng.standard_normal((1, 1, 2, 2, 8)).astype(np.float32),
                pose_latents=rng.standard_normal((1, 2, 2, 2, 8)).astype(np.float32))
    base = dict(height=H, width=W, num_frames=8, frame_rate=25.0,
                num_inference_steps=3, guidance_scale=1.0, stg_scale=0.0)
    key = jax.random.PRNGKey(3)
    ref = jp(jpipe.GenerationParams(**base), key, embeds, mask, **cond,
             output_type="latent", dtype=jnp.float32)
    _, _, k_lat, _, _, _ = jax.random.split(key, 6)
    init = jax.random.normal(jax.random.split(k_lat, 1)[0], (2, 2, 2, 8))[None]
    out = tp(tpipe.GenerationParams(**base), torch.Generator(), _t(embeds), _t(mask),
             **{k: _t(v) for k, v in cond.items()}, init_noise=_t(init),
             output_type="latent", dtype=torch.float32).numpy()
    _assert_dit_close(out, np.asarray(ref))
    if route == "kernel":
        # the JAX walk is traced once (a spy counts traces); the port's runs
        # the model 3 times
        evaluations = 3 * PIPE_DIT_KW["num_layers"]
        assert calls["port"] == {
            "fused_rms_mod_quant": 2 * evaluations, "quantize_rows_pallas": 3 * evaluations,
            "fused_act_quant": evaluations, "w8a8_matmul": 8 * evaluations}
        assert calls["jax"].keys() == calls["port"].keys()


def test_pipeline_quantize_options():
    """True and "w8" are weight-only, "w8a8" quantizes the block linears,
    before the split-RoPE permutation (``raw_dit_params`` stays
    unpermuted); quantize_vae gives the VAE ``quantize_vae_params``' tree."""
    cfg = tdit.DiTConfig(num_attention_heads=8, attention_head_dim=64, in_channels=8,
                         out_channels=8, num_layers=1, cross_attention_dim=512,
                         caption_channels=32)
    vcfg = dataclasses.replace(tvae.demo_config(latent_channels=8), base_channels=8,
                               decoder_base_channels=8)
    params = tdit.init_dit(cfg, seed=0, device="cpu")
    vae = tvae.init_vae(vcfg, seed=0, device="cpu")
    for q in (True, "w8", "w8a8"):
        pipe = tpipe.LTXVideoPipeline(cfg, params, vcfg, vae, quantize_weights=q,
                                      device="cpu")
        mode = "w8a8" if q == "w8a8" else "w8"
        ref = tquant.quantize_dit_params(params, mode=mode)
        raw = dict(_leaves(pipe.raw_dit_params))
        assert raw.keys() == dict(_leaves(ref)).keys()
        assert all(torch.equal(raw[p], v) for p, v in _leaves(ref))
        q_key = "kernel_q8" if mode == "w8a8" else "kernel_q"
        assert q_key in pipe.dit_params["blocks"][0]["attn1"]["to_q"]
    with pytest.raises(ValueError):
        tpipe.LTXVideoPipeline(cfg, params, vcfg, vae, quantize_weights="w4",
                               device="cpu")
    pipe = tpipe.LTXVideoPipeline(cfg, params, vcfg, vae, quantize_vae=True, device="cpu")
    ref = dict(_leaves(tquant.quantize_vae_params(vae)))
    got = dict(_leaves(pipe.vae_params))
    assert got.keys() == ref.keys()
    assert all(torch.equal(got[p], v) for p, v in ref.items())
