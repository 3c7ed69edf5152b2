"""The port's CUDA kernels (attention forward and backward, and int8)
against their plain PyTorch versions, on the card, and autograd through the
attention kernels. Marked ``cuda``; they skip where there is no CUDA device. Run
them on a card with
``python -m pytest tests/test_torch_cuda_kernels.py --noconftest`` (the
shared conftest imports JAX, which the card's machine need not have)."""

import ctypes

import pytest
import torch

from avatar_tpu_torch.ops import causal_conv3d as cc
from avatar_tpu_torch.ops import flash_attention as fa
from avatar_tpu_torch.ops import int8_matmul as i8
from avatar_tpu_torch.utils.quantize import quantize_conv3d

pytestmark = pytest.mark.cuda

HEADS, HD = 4, 64
# bf16 outputs of O(1); see chip_smoke.py's KERNEL_TOL and LSE_TOL
TOL = 1e-2
LSE_TOL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _rows(gen, *shape):
    x = torch.randn(shape, generator=gen, device="cuda")
    return (x * (x.pow(2).mean(-1, keepdim=True) + 1e-6).rsqrt()).bfloat16()


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("length", [64, 150])
def test_rope_kernel_matches_plain(gen, bounded, length):
    c = HEADS * HD
    q, k = _rows(gen, 2, length, c), _rows(gen, 2, length, c)
    v = torch.randn(2, length, c, generator=gen, device="cuda").bfloat16()
    ang = torch.rand(2, length, c // 2, generator=gen, device="cuda") * 6.3
    cos, sin = ang.cos().bfloat16(), ang.sin().bfloat16()
    before = fa.launch_counts["rope_fused_attention"]
    out = fa.rope_fused_attention(q, k, v, cos, sin, HEADS, HD**-0.5, bounded)
    assert fa.launch_counts["rope_fused_attention"] == before + 1
    ref = fa._rope_attention_plain(q, k, v, cos, sin, HEADS, HD**-0.5, bounded)
    assert (out.float() - ref.float()).abs().max().item() < TOL


@pytest.mark.parametrize("bounded", [True, False])
def test_token_kernel_matches_plain_with_masked_row(gen, bounded):
    c = HEADS * HD
    q, k = _rows(gen, 3, 100, c), _rows(gen, 3, 77, c)
    v = torch.randn(3, 77, c, generator=gen, device="cuda").bfloat16()
    mask = torch.ones(3, 77, device="cuda")
    mask[1, 40:] = 0.0
    mask[2] = 0.0
    out = fa.fused_token_attention(q, k, v, mask, HEADS, HD**-0.5, bounded)
    ref = fa._token_attention_plain(q, k, v, mask, HEADS, HD**-0.5, bounded)
    assert (out.float() - ref.float()).abs().max().item() < TOL
    assert bool((out[2] == 0).all())


@pytest.mark.parametrize("lq,lk,bounded,counter", [
    (1100, 1100, True, "flash_bounded"), (1100, 333, False, "flash_online"),
    (637, 637, False, "flash_single"), (1024, 77, True, "flash_single"),
])
def test_flash_kernels_match_plain_with_masked_row(gen, lq, lk, bounded, counter):
    """O and lse of each head-major kernel, ragged lengths, a partly masked
    and a fully masked batch row (O = 0, lse = 1e30)."""
    q, k = _rows(gen, 3, HEADS, lq, HD), _rows(gen, 3, HEADS, lk, HD)
    v = torch.randn(3, HEADS, lk, HD, generator=gen, device="cuda").bfloat16()
    mask = torch.ones(3, lk, device="cuda")
    mask[1, lk // 2:] = 0.0
    mask[2] = 0.0
    mode = fa.flash_mode(lq, lk, bounded)
    assert f"flash_{mode}" == counter
    before = fa.launch_counts[counter]
    out, lse = fa.flash_attention(q, k, v, kv_mask=mask, bounded_logits=bounded,
                                  with_lse=True)
    torch.cuda.synchronize()
    assert fa.launch_counts[counter] == before + 1
    ref, ref_lse = fa._flash_plain(q * HD**-0.5, k, v, mask, 1.0, mode)
    assert (out.float() - ref.float()).abs().max().item() < TOL
    assert (lse[:2] - ref_lse[:2]).abs().max().item() < LSE_TOL
    assert bool((out[2] == 0).all()) and bool((lse[2] == fa.LSE_MASKED).all())


def test_flash_attention_takes_transposed_views_and_a_bias(gen):
    """The DiT hands in [B, L, H, D] tensors transposed to head-major, and a
    [B, 1, 1, Lk] bias for its keep-mask; a dense [B, 1, Lq, Lk] bias runs
    the dense-bias kernel."""
    q = _rows(gen, 1, 1200, HEADS, HD).transpose(1, 2)
    k = _rows(gen, 1, 1200, HEADS, HD).transpose(1, 2)
    v = torch.randn(1, 1200, HEADS, HD, generator=gen, device="cuda"
                    ).bfloat16().transpose(1, 2)
    bias = torch.zeros(1, 1, 1, 1200, device="cuda")
    bias[..., 1000:] = -1e4
    out = fa.flash_attention(q, k, v, bias=bias, bounded_logits=True)
    ref, _ = fa._flash_plain(q * HD**-0.5, k, v, (bias[:, 0, 0] >= -1.0).float(),
                             1.0, "bounded")
    assert (out.float() - ref.float()).abs().max().item() < TOL
    dense = torch.zeros(1, 1, 1200, 1200, device="cuda")
    dense[..., 1000:] = -1e30
    before = fa.launch_counts["flash_dense_forward"]
    out = fa.flash_attention(q, k, v, bias=dense)
    assert fa.launch_counts["flash_dense_forward"] == before + 1
    ref, _ = fa._flash_dense_plain(q, k, v, dense[:, 0], HD**-0.5)
    assert (out.float() - ref.float()).abs().max().item() < TOL


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    """The wrappers raise on the card exactly where the reference's
    predicates refuse: fp16 (no path of either package), a head dim that is
    not a multiple of 8 (16 for A), above 256 (A, B) or above 512 (C-G); and
    on layouts the token-major kernels cannot read (not contiguous, a bool
    mask)."""
    q = _rows(gen, 1, 64, HEADS * HD)
    with pytest.raises(ValueError):  # fp16
        fa.fused_token_attention(q.half(), q.half(), q.half(), None, HEADS, 0.1)
    with pytest.raises(ValueError):  # head_dim 12
        q48 = _rows(gen, 1, 64, 48)
        fa.fused_token_attention(q48, q48, q48, None, 4, 0.1)
    with pytest.raises(ValueError):  # head_dim 264 > 256
        q264 = _rows(gen, 1, 64, 264)
        fa.fused_token_attention(q264, q264, q264, None, 1, 0.1)
    with pytest.raises(ValueError):  # RoPE head_dim 24 (not a multiple of 16)
        q24 = _rows(gen, 1, 64, 48)
        cs = torch.ones(1, 64, 24, device="cuda").bfloat16()
        fa.rope_fused_attention(q24, q24, q24, cs, cs, 2, 0.1)
    with pytest.raises(ValueError):  # not contiguous
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        fa.fused_token_attention(qt, qt, qt, None, HEADS, 0.1)
    with pytest.raises(ValueError):  # the mask must be f32 on the card
        fa.fused_token_attention(q, q, q, torch.ones(1, 64, device="cuda",
                                                     dtype=torch.bool), HEADS, 0.1)
    qh = q.reshape(1, 64, HEADS, HD).transpose(1, 2)
    with pytest.raises(ValueError):  # fp16 head-major
        fa.flash_attention(qh.half(), qh.half(), qh.half())
    with pytest.raises(ValueError):  # head_dim 36
        q36 = _rows(gen, 1, 2, 200, 36)
        fa.flash_attention(q36, q36, q36)
    with pytest.raises(ValueError):  # head_dim 520 > 512
        q520 = _rows(gen, 1, 1, 200, 520)
        fa.flash_attention(q520, q520, q520)


# ---------------------------------------------------------------------------
# Every (dtype, head dim) the reference admits, and the Hopper C and D
# ---------------------------------------------------------------------------

# f32 variants against their plain versions in f32 (TF32 off): 3xTF32
# products, f32 sums in another order (see chip_smoke.py's F32_REL_TOL)
F32_REL = 1e-5


def _close(out, ref, dtype, ulps=2):
    ref = ref.float()
    rel = F32_REL if dtype == torch.float32 else ulps * 2.0**-7
    return (out.float() - ref).abs().max().item() <= rel * ref.abs().max().item()


def _qkv(gen, dtype, b, h, lq, lk, d):
    q, k = (_rows(gen, b, h, n, d).to(dtype) for n in (lq, lk))
    v = torch.randn(b, h, lk, d, generator=gen, device="cuda").to(dtype)
    return q, k, v


def _plain_forward(q, k, v, mask, scale, mode):
    """The plain version fed q and the scale as the wrapper feeds its
    kernel: a power-of-two scale folded into q, any other applied to the
    f32 logits."""
    q, scale = fa.fold_scale(q, scale)
    return fa._flash_plain(q, k, v, mask, scale, mode)


@pytest.fixture
def no_tf32():
    """The plain versions in full f32 on the card."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 128),
                                     (torch.bfloat16, 32), (torch.bfloat16, 128)])
def test_token_major_kernels_take_f32_and_other_head_dims(gen, no_tf32, dtype, d):
    """A and B at f32 and at head dims 32 / 128 against their plain
    versions, B with a fully masked sample."""
    c = 2 * d
    q, k = _rows(gen, 2, 80, c).to(dtype), _rows(gen, 2, 80, c).to(dtype)
    v = torch.randn(2, 80, c, generator=gen, device="cuda").to(dtype)
    ang = torch.rand(2, 80, c // 2, generator=gen, device="cuda") * 6.3
    cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
    out = fa.rope_fused_attention(q, k, v, cos, sin, 2, d**-0.5, True)
    assert out.dtype == dtype
    assert _close(out, fa._rope_attention_plain(q, k, v, cos, sin, 2, d**-0.5, True), dtype)
    mask = torch.ones(2, 80, device="cuda")
    mask[1] = 0.0
    out = fa.fused_token_attention(q, k, v, mask, 2, d**-0.5, False)
    assert _close(out, fa._token_attention_plain(q, k, v, mask, 2, d**-0.5, False), dtype)
    assert bool((out[1] == 0).all())


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 128),
                                     (torch.bfloat16, 32), (torch.bfloat16, 128),
                                     (torch.bfloat16, 256)])
@pytest.mark.parametrize("mode", ["bounded", "online", "single"])
def test_head_major_kernels_take_f32_and_other_head_dims(gen, no_tf32, dtype, d, mode):
    """C, D and E (O and lse) and the backward F from their output, at f32
    and at head dims 32 / 128 / 256, with a fully masked sample; each on
    the route forward_impl names (Hopper at bf16 and 128, else WMMA)."""
    lq, lk = (1030, 150) if mode != "single" else (100, 77)
    q, k, v = _qkv(gen, dtype, 2, 2, lq, lk, d)
    mask = torch.ones(2, lk, device="cuda")
    mask[0, 20:40] = 0.0
    mask[1] = 0.0
    before = dict(fa.launch_counts)
    out, lse = fa.flash_attention(q, k, v, kv_mask=mask, bounded_logits=mode == "bounded",
                                  with_lse=True)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    want = {f"flash_{mode}": 1, f"flash_{mode}_{fa.forward_impl(mode, dtype, d)}": 1}
    assert launched == want
    ref, ref_lse = _plain_forward(q, k, v, mask, d**-0.5, mode)
    assert _close(out, ref, dtype)
    assert (lse[0] - ref_lse[0]).abs().max().item() < (1e-4 if dtype == torch.float32
                                                       else 2e-3)
    assert bool((out[1] == 0).all()) and bool((lse[1] == fa.LSE_MASKED).all())
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    got = fa._flash_backward(q, k, v, mask, out, lse, g, d**-0.5)
    want_grads = fa._flash_backward_plain(q, k, v, mask, out, lse, g, d**-0.5)
    for a, b in zip(got, want_grads):
        assert _close(a, b, dtype, ulps=4)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 32),
                                     (torch.bfloat16, 512)])
def test_dense_bias_kernels_take_f32_and_other_head_dims(gen, no_tf32, dtype, d):
    """G's four kernels at f32 and at head dims 32 / 512."""
    q, k, v = _qkv(gen, dtype, 2, 2, 150, 133, d)
    bias = torch.randn(2, 1, 150, 133, generator=gen, device="cuda")
    bias[..., 40:60] = -1e30
    bias3 = fa._dense_bias3(bias)
    out, lse = fa._flash_dense_forward(q, k, v, bias3, d**-0.5)
    assert _close(out, fa._flash_dense_plain(q, k, v, bias3, d**-0.5)[0], dtype)
    g = torch.randn(out.shape, generator=gen, device="cuda").to(dtype)
    got = fa._flash_dense_backward(q, k, v, bias3, out, lse, g, d**-0.5, True)
    want = fa._flash_dense_backward_plain(q, k, v, bias3, out, lse, g, d**-0.5)
    for a, b in zip(got, want):
        assert _close(a, b, dtype, ulps=4)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("mode", ["bounded", "online"])
@pytest.mark.parametrize("views", [False, True])
def test_hopper_kernel_matches_plain(gen, d, mode, views):
    """The Hopper C and D (bf16, head dim 64 / 128) against their plain
    versions: ragged lengths, a masked band, a fully masked sample, and q,
    k, v given as head-major views of token-major tensors (read in place;
    O comes back in the same layout)."""
    lq, lk = 1100, 1333
    if views:
        q, k = (_rows(gen, 2, n, 3, d).transpose(1, 2) for n in (lq, lk))
        v = torch.randn(2, lk, 3, d, generator=gen, device="cuda").bfloat16().transpose(1, 2)
    else:
        q, k, v = _qkv(gen, torch.bfloat16, 2, 3, lq, lk, d)
    mask = torch.ones(2, lk, device="cuda")
    mask[0, 300:700] = 0.0
    mask[1] = 0.0
    before = fa.launch_counts[f"flash_{mode}_sm90"]
    out, lse = fa.flash_attention(q, k, v, kv_mask=mask, bounded_logits=mode == "bounded",
                                  with_lse=True)
    torch.cuda.synchronize()
    assert fa.launch_counts[f"flash_{mode}_sm90"] == before + 1
    assert out.stride() == q.stride()
    ref, ref_lse = _plain_forward(q, k, v, mask, d**-0.5, mode)
    assert _close(out, ref, torch.bfloat16)
    assert (lse[0] - ref_lse[0]).abs().max().item() < 2e-3
    assert bool((out[1] == 0).all()) and bool((lse[1] == fa.LSE_MASKED).all())


def _rope_inputs(gen, b, length, heads, d):
    c = heads * d
    q, k = _rows(gen, b, length, c), _rows(gen, b, length, c)
    v = torch.randn(b, length, c, generator=gen, device="cuda").bfloat16()
    ang = torch.rand(b, length, c // 2, generator=gen, device="cuda") * 6.3
    return q, k, v, ang.cos().bfloat16(), ang.sin().bfloat16()


def _wmma_rope(q, k, v, cos, sin, heads, scale, bounded):
    """A's WMMA kernel called by its C entry, on the same inputs."""
    d = q.shape[-1] // heads
    suffix, defines = fa.kernel_variant(torch.bfloat16, d)
    fn = fa._c_entry("rope_attention", f"rope_attention_{suffix}", 6, 4, defines=defines)
    out = torch.empty_like(q)
    b, length, _ = q.shape
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
              out.data_ptr(), b, length, heads, d, scale, int(bounded),
              torch.cuda.current_stream().cuda_stream) == 0
    return out


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("b,length", [(1, 80), (3, 80), (8, 80), (1, 1248), (3, 1248),
                                      (8, 1248)])
def test_hopper_rope_kernel_matches_plain_and_wmma(gen, d, bounded, b, length):
    """A on the Hopper kernel (bf16, head dim 64 / 128) against its plain
    version and against the WMMA kernel it replaced, on the same inputs:
    ragged lengths (80, and 1248, the largest the reference's cap admits),
    batch 1 / 3 / 8, bounded and the two-pass whole-row max."""
    assert fa.rope_impl(torch.bfloat16, d) == "sm90"
    q, k, v, cos, sin = _rope_inputs(gen, b, length, HEADS, d)
    before = dict(fa.launch_counts)
    out = fa.rope_fused_attention(q, k, v, cos, sin, HEADS, d**-0.5, bounded)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    assert launched == {"rope_fused_attention": 1, "rope_fused_attention_sm90": 1}
    ref = fa._rope_attention_plain(q, k, v, cos, sin, HEADS, d**-0.5, bounded)
    assert _close(out, ref, torch.bfloat16)
    wmma = _wmma_rope(q, k, v, cos, sin, HEADS, d**-0.5, bounded)
    torch.cuda.synchronize()
    assert _close(out, wmma, torch.bfloat16)


def _wmma_token(q, k, v, mask, heads, scale, bounded):
    """B's WMMA kernel (csrc/token_attention.cu) through its C entry, on the
    inputs the Hopper kernel took."""
    b, lq, c = q.shape
    d = c // heads
    suffix, defines = fa.kernel_variant(q.dtype, d)
    fn = fa._c_entry("token_attention", f"token_attention_{suffix}", 5, 5, defines=defines)
    out = torch.empty_like(q)
    assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if mask is None else mask.data_ptr(), out.data_ptr(), b, lq,
              k.shape[1], heads, d, scale, int(bounded),
              torch.cuda.current_stream().cuda_stream) == 0
    return out


# B's cases (batch, queries, keys, kept keys per sample, -1: every key; 0:
# a fully masked sample): the four the DiT paths give it (short 832 x 256,
# guided batch 3, long 5376 x 256, training 8 x 480 x 256 with one sample's
# caption masked), a ragged 77-key caption and 512 keys (four key tiles)
TOKEN_CASES = {"832x256": (1, 832, 256, (200,)), "batch 3": (3, 832, 256, (120, 200, 200)),
               "5376x256": (1, 5376, 256, (200,)),
               "train 8x480x256": (8, 480, 256, (200,) * 7 + (0,)),
               "ragged Lk=77": (2, 96, 77, (50, 0)), "Lk=512": (2, 1024, 512, (-1, 300))}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("case", list(TOKEN_CASES))
def test_hopper_token_kernel_matches_plain_and_wmma(gen, d, bounded, case):
    """B on the Hopper kernel (bf16, head dim 64 / 128, the DiT's 2,048
    columns) against its plain version within 2 bf16 ulps and against the
    WMMA kernel it replaced on the same inputs; a fully masked sample is
    exactly 0."""
    b, lq, lk, kept = TOKEN_CASES[case]
    heads = 2048 // d
    assert fa.token_impl(torch.bfloat16, d) == "sm90"
    q, k = _rows(gen, b, lq, 2048), _rows(gen, b, lk, 2048)
    v = torch.randn(b, lk, 2048, generator=gen, device="cuda").bfloat16()
    mask = torch.ones(b, lk, device="cuda")
    for i, n in enumerate(kept):
        if n >= 0:
            mask[i, n:] = 0.0
    before = dict(fa.launch_counts)
    out = fa.fused_token_attention(q, k, v, mask, heads, d**-0.5, bounded)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    assert launched == {"fused_token_attention": 1, "fused_token_attention_sm90": 1}
    ref = fa._token_attention_plain(q, k, v, mask, heads, d**-0.5, bounded)
    assert _close(out, ref, torch.bfloat16)
    for i, n in enumerate(kept):
        if n == 0:
            assert bool((out[i] == 0).all())
    wmma = _wmma_token(q, k, v, mask, heads, d**-0.5, bounded)
    torch.cuda.synchronize()
    assert _close(out, wmma, torch.bfloat16)


@pytest.mark.parametrize("lq,lk", [(1, 256), (16, 16), (128, 300)])
def test_hopper_token_kernel_without_a_mask(gen, lq, lk):
    """B on the Hopper kernel without a mask: one query, 16 keys (one
    ragged tile) and 300 keys (the two-pass whole-row max)."""
    q, k = _rows(gen, 1, lq, 2048), _rows(gen, 1, lk, 2048)
    v = torch.randn(1, lk, 2048, generator=gen, device="cuda").bfloat16()
    for bounded in (True, False):
        out = fa.fused_token_attention(q, k, v, None, 32, 0.125, bounded)
        assert _close(out, fa._token_attention_plain(q, k, v, None, 32, 0.125, bounded),
                      torch.bfloat16)


# E's cases: training self-attention, cross-attention to 256 keys with 200
# kept and the last sample fully masked, ragged 100 x 77, a long row whose
# keys stream twice (1000 x 900), head-major views of token-major tensors
SINGLE_CASES = [(8, 480, 480, False, False), (8, 480, 256, True, False),
                (2, 100, 77, False, False), (2, 1000, 900, True, False),
                (2, 637, 700, True, True)]


def _single_inputs(gen, d, b, lq, lk, masked, views):
    if views:
        q, k = (_rows(gen, b, n, HEADS, d).transpose(1, 2) for n in (lq, lk))
        v = torch.randn(b, lk, HEADS, d, generator=gen, device="cuda").bfloat16(
            ).transpose(1, 2)
    else:
        q, k, v = _qkv(gen, torch.bfloat16, b, HEADS, lq, lk, d)
    mask = None
    if masked:
        mask = torch.ones(b, lk, device="cuda")
        mask[:, lk * 4 // 5:] = 0.0
        mask[-1] = 0.0
    return q, k, v, mask


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,lq,lk,masked,views", SINGLE_CASES)
def test_hopper_single_kernel_matches_plain(gen, d, b, lq, lk, masked, views):
    """E on the Hopper kernel against its plain version: O within 2 bf16
    ulps, lse within 2e-3, a fully masked sample O = 0 and lse = 1e30, and
    views read in place (O in q's layout)."""
    assert fa.flash_mode(lq, lk, False) == "single"
    q, k, v, mask = _single_inputs(gen, d, b, lq, lk, masked, views)
    before = dict(fa.launch_counts)
    out, lse = fa.flash_attention(q, k, v, kv_mask=mask, with_lse=True)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    assert launched == {"flash_single": 1, "flash_single_sm90": 1}
    assert out.stride() == q.stride()
    ref, ref_lse = _plain_forward(q, k, v, mask, d**-0.5, "single")
    assert _close(out, ref, torch.bfloat16)
    live = ref_lse < 1e29
    assert (lse - ref_lse)[live].abs().max().item() < 2e-3
    assert bool((lse[~live] == fa.LSE_MASKED).all())
    if masked:
        assert bool((out[-1] == 0).all())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,lq,lk,masked,views", SINGLE_CASES[:4])
def test_hopper_single_kernel_matches_the_wmma_kernel(gen, d, b, lq, lk, masked, views):
    """E on the Hopper kernel against the WMMA kernel it replaced, called by
    its C entry on the same (contiguous, scale-folded) inputs."""
    q, k, v, mask = _single_inputs(gen, d, b, lq, lk, masked, views)
    out, lse = fa.flash_attention(q, k, v, kv_mask=mask, with_lse=True)
    qs = q * d**-0.5
    suffix, defines = fa.kernel_variant(torch.bfloat16, d)
    fn = fa._c_entry("flash_forward", f"flash_single_{suffix}", 6, 5, bounded_flag=False,
                     defines=defines)
    wout, wlse = torch.empty_like(q), torch.empty_like(lse)
    assert fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if mask is None else mask.data_ptr(), wout.data_ptr(), wlse.data_ptr(),
              b, HEADS, lq, lk, d, 1.0, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert _close(out, wout, torch.bfloat16)
    live = wlse < 1e29
    assert (lse - wlse)[live].abs().max().item() < 2e-3
    assert torch.equal(lse[~live], wlse[~live])


# ---------------------------------------------------------------------------
# The flash backward (F) and the attention gradients
# ---------------------------------------------------------------------------


def _ulps_ok(out, ref, ulps=4):
    """Within ``ulps`` bf16 ulps (2^-8 relative) of the largest reference
    value: see chip_smoke.py's BWD_ULPS."""
    ref = ref.float()
    return (out.float() - ref).abs().max().item() <= ulps * 2.0**-8 * ref.abs().max().item()


def _bwd_inputs(gen, dtype, d, lq, lk, masked):
    """q, k, v, an output gradient and, with ``masked``, a keep-mask with
    sample 0 half masked and sample 1 fully masked; then O and lse from the
    forward kernel."""
    q, k = _rows(gen, 2, HEADS, lq, d).to(dtype), _rows(gen, 2, HEADS, lk, d).to(dtype)
    v = torch.randn(2, HEADS, lk, d, generator=gen, device="cuda").to(dtype)
    g = torch.randn(2, HEADS, lq, d, generator=gen, device="cuda").to(dtype)
    mask = None
    if masked:
        mask = torch.ones(2, lk, device="cuda")
        mask[0, lk // 2:] = 0.0
        mask[1] = 0.0
    out, lse = fa.flash_attention(q, k, v, kv_mask=mask, with_lse=True)
    return q, k, v, g, mask, out, lse


# the backward's routes: the Hopper kernels (bf16, head dim 64 / 128) and
# the WMMA variants (every other dtype and head dim)
BWD_ROUTES = [("sm90", torch.bfloat16, 64), ("sm90", torch.bfloat16, 128),
              ("wmma", torch.bfloat16, 32), ("wmma", torch.float32, 64)]
# self-attention, cross-attention with a fully masked sample, ragged
BWD_SHAPES = [(150, 150, False), (96, 77, True), (477, 250, True)]


@pytest.mark.parametrize("route,dtype,d", BWD_ROUTES)
@pytest.mark.parametrize("lq,lk,masked", BWD_SHAPES)
def test_flash_backward_kernels_match_plain(gen, route, dtype, d, lq, lk, masked):
    """dK/dV and dQ against the plain version, from the forward kernel's
    own O and lse, on the route that :func:`backward_impl` names; ragged
    lengths and, with the mask, a fully masked batch row (zero
    gradients)."""
    assert fa.backward_impl(dtype, d) == route
    q, k, v, g, mask, out, lse = _bwd_inputs(gen, dtype, d, lq, lk, masked)
    before = dict(fa.launch_counts)
    dq, dk, dv = fa._flash_backward(q, k, v, mask, out, lse, g, d**-0.5)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    assert launched == {"flash_bwd_dkv": 1, "flash_bwd_dq": 1, f"flash_bwd_dkv_{route}": 1,
                        f"flash_bwd_dq_{route}": 1}
    ref = fa._flash_backward_plain(q, k, v, mask, out, lse, g, d**-0.5)
    for got, want in zip((dq, dk, dv), ref):
        if dtype == torch.float32:
            # 3xTF32 products, f32 sums in another order
            assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        else:
            assert _ulps_ok(got, want)
    if masked:
        assert all(bool((x[1] == 0).all()) for x in (dq, dk, dv))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("lq,lk,masked", BWD_SHAPES)
def test_hopper_backward_matches_the_wmma_kernels(gen, d, lq, lk, masked):
    """The Hopper dK/dV and dQ against the WMMA kernels they replaced,
    called directly on the same bf16 inputs: both round p and dS to bf16 at
    the same places and sum in f32 in other orders."""
    q, k, v, g, mask, out, lse = _bwd_inputs(gen, torch.bfloat16, d, lq, lk, masked)
    dq, dk, dv = fa._flash_backward(q, k, v, mask, out, lse, g, d**-0.5)
    delta = (g.float() * out.float()).sum(-1)
    suffix, defines = fa.kernel_variant(torch.bfloat16, d)
    wdk, wdv, wdq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)
    head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), None if mask is None else mask.data_ptr()]
    tail = [2, HEADS, lq, lk, d, d**-0.5, torch.cuda.current_stream().cuda_stream]
    for kernel, outs in (("dkv", (wdk, wdv)), ("dq", (wdq,))):
        fn = fa._c_entry("flash_backward", f"flash_bwd_{kernel}_{suffix}", 7 + len(outs), 5,
                         bounded_flag=False, defines=defines)
        assert fn(*head, *(t.data_ptr() for t in outs), *tail) == 0
    torch.cuda.synchronize()
    for got, want in zip((dq, dk, dv), (wdq, wdk, wdv)):
        assert _ulps_ok(got, want)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def test_attention_gradients_on_the_card(gen):
    """Autograd through A, B and flash_attention in bf16 on the card
    against autograd through the same functions in f32 on the CPU (plain
    versions): each entry's gradient flows, through its kernels."""
    c, length, lk = HEADS * HD, 128, 128
    q, k = _rows(gen, 2, length, c), _rows(gen, 2, length, c)
    v, g = (torch.randn(2, length, c, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    ang = torch.rand(2, length, c // 2, generator=gen, device="cuda") * 6.3
    cos, sin = ang.cos().bfloat16(), ang.sin().bfloat16()
    mask = torch.ones(2, lk, device="cuda")
    mask[1, 100:] = 0.0
    cases = {
        "rope_fused_attention": lambda q_, k_, v_, m: fa.rope_fused_attention(
            q_, k_, v_, cos.to(q_.device, q_.dtype), sin.to(q_.device, q_.dtype),
            HEADS, HD**-0.5, True),
        "fused_token_attention": lambda q_, k_, v_, m: fa.fused_token_attention(
            q_, k_, v_, m, HEADS, HD**-0.5, True),
        "flash_attention": lambda q_, k_, v_, m: fa.flash_attention(
            *(t.reshape(2, -1, HEADS, HD).transpose(1, 2) for t in (q_, k_, v_)),
            kv_mask=m, bounded_logits=True).transpose(1, 2).reshape(2, -1, c),
    }
    for name, fn in cases.items():
        grads = {}
        before = dict(fa.launch_counts)
        for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            leaves = [t.to(device, dtype).requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, mask.to(device))
            grads[device] = torch.autograd.grad(out, leaves, g.to(device, dtype))
        launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
        assert launched.get("flash_bwd_dkv_sm90") == 1, name
        assert launched.get("flash_bwd_dq_sm90") == 1, name
        # bf16 operands and outputs against f32 throughout
        for got, want in zip(grads["cuda"], grads["cpu"]):
            assert _rel(got.cpu(), want) < 2e-2, name


# ---------------------------------------------------------------------------
# The dense-bias attention (G): forward, dK/dV, dQ, dBias
# ---------------------------------------------------------------------------


def _dense_case(gen, per_head, lq, lk):
    """bf16 q, k, v, an output gradient and an f32 bias [2, 1|H, Lq, Lk]
    with a band of masked keys and, in sample 1, a fully masked query row."""
    q, k = _rows(gen, 2, HEADS, lq, HD), _rows(gen, 2, HEADS, lk, HD)
    v, g = (torch.randn(2, HEADS, n, HD, generator=gen, device="cuda").bfloat16()
            for n in (lk, lq))
    bias = torch.randn(2, HEADS if per_head else 1, lq, lk, generator=gen, device="cuda")
    bias[..., lk // 3:lk // 2] = -1e30
    bias[1, :, 5] = -1e30
    return q, k, v, g, bias


@pytest.mark.parametrize("per_head,lq,lk", [(True, 256, 256), (False, 200, 130),
                                            (False, 150, 333)])
def test_flash_dense_kernels_match_plain(gen, per_head, lq, lk):
    """Each of G's four kernels against its plain version from the same
    inputs (the backward from the forward kernel's O and lse): ragged
    lengths, masked keys, and a fully masked row (O = 0, lse = 1e30, zero
    gradients)."""
    q, k, v, g, bias = _dense_case(gen, per_head, lq, lk)
    bias3 = fa._dense_bias3(bias)
    before = dict(fa.launch_counts)
    out, lse = fa._flash_dense_forward(q, k, v, bias3, HD**-0.5)
    dq, dk, dv, db = fa._flash_dense_backward(q, k, v, bias3, out, lse, g, HD**-0.5,
                                              with_db=True)
    torch.cuda.synchronize()
    for name in ("forward", "bwd_dkv", "bwd_dq", "bwd_db"):
        assert fa.launch_counts[f"flash_dense_{name}"] == before[f"flash_dense_{name}"] + 1
    ref, ref_lse = fa._flash_dense_plain(q, k, v, bias3, HD**-0.5)
    assert _ulps_ok(out, ref, 2)
    live = ref_lse < 1e29
    assert (lse - ref_lse)[live].abs().max().item() < 2e-3
    assert bool((out[1, :, 5] == 0).all()) and bool((lse[1, :, 5] == fa.LSE_MASKED).all())
    want = fa._flash_dense_backward_plain(q, k, v, bias3, out, lse, g, HD**-0.5)
    for got, ref_grad in zip((dq, dk, dv, db), want):
        assert _ulps_ok(got, ref_grad)
    assert bool((dq[1, :, 5] == 0).all())
    assert bool((db.reshape(2, -1, lq, lk)[1, :, 5] == 0).all())


def test_flash_dense_gradients_on_the_card(gen):
    """Autograd through flash_attention(bias=...) in bf16 on the card, the
    bias requiring a gradient, against the plain versions in f32 on the CPU;
    one launch of each of G's kernels, none of the keep-mask kernels."""
    q, k, v, g, bias = _dense_case(gen, False, 256, 192)
    grads = {}
    before = dict(fa.launch_counts)
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        leaves = [t.to(device, dtype).requires_grad_() for t in (q, k, v)]
        b = bias.to(device).requires_grad_()
        out = fa.flash_attention(*leaves, bias=b)
        grads[device] = torch.autograd.grad(out, leaves + [b], g.to(device, dtype))
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    assert launched == {"flash_dense_forward": 1, "flash_dense_bwd_dkv": 1,
                        "flash_dense_bwd_dq": 1, "flash_dense_bwd_db": 1,
                        "flash_dense_fwd_sm90": 1, "flash_dense_bwd_dkv_sm90": 1,
                        "flash_dense_bwd_dq_sm90": 1, "flash_dense_bwd_db_sm90": 1}
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got.shape == want.shape and _rel(got.cpu(), want) < 2e-2


DENSE_KERNELS = ("fwd", "bwd_dkv", "bwd_dq", "bwd_db")


def _dense_inputs(gen, d, per_head, lq, lk):
    """bf16 q, k, v, g at head dim d (2 samples of HEADS heads) and an f32
    bias [2, 1|H, Lq, Lk] with a band of masked keys and, in sample 1, a
    fully masked query row 5."""
    q, k, v = _qkv(gen, torch.bfloat16, 2, HEADS, lq, lk, d)
    g = torch.randn(2, HEADS, lq, d, generator=gen, device="cuda").bfloat16()
    bias = torch.randn(2, HEADS if per_head else 1, lq, lk, generator=gen, device="cuda")
    bias[..., lk // 3:lk // 2] = -1e30
    bias[1, :, 5] = -1e30
    return q, k, v, g, fa._dense_bias3(bias)


def _dense_run(q, k, v, g, bias3, scale):
    """(out, lse, dq, dk, dv, db) through G's four wrappers, on the route
    dense_impl names."""
    out, lse = fa._flash_dense_forward(q, k, v, bias3, scale)
    delta = (g.float() * out.float()).sum(-1)
    dk, dv = fa.flash_dense_bwd_dkv(q, k, v, g, lse, delta, bias3, scale)
    dq = fa.flash_dense_bwd_dq(q, k, v, g, lse, delta, bias3, scale)
    db = fa.flash_dense_bwd_db(q, k, v, g, lse, delta, bias3, scale)
    return out, lse, dq, dk, dv, db


def _dense_c_call(kernel, route, ins, outs, scale):
    """The cudaError_t of G's ``kernel`` on ``route`` called through its C
    entry (no counter) on contiguous head-major ``ins`` (q, k, v, then g,
    lse, delta for the backward, then the bias slabs) into ``outs``."""
    q, k, bias3 = ins[0], ins[1], ins[-1]
    b, heads, lq, d = q.shape
    _, fn = fa._dense_entry(kernel, route, q.dtype, d)
    return fn(*(t.data_ptr() for t in ins + outs), b, heads, lq, k.shape[2],
              b * heads // bias3.shape[0], d, float(scale),
              torch.cuda.current_stream().cuda_stream)


def _wmma_dense_run(q, k, v, g, bias3, scale):
    """(out, lse, dq, dk, dv, db) from the WMMA kernels of
    csrc/flash_dense.cu on the same inputs, whatever route dense_impl
    names."""
    out, lse = torch.empty_like(q), torch.empty(q.shape[:3], device="cuda")
    assert _dense_c_call("fwd", "wmma", (q, k, v, bias3), (out, lse), scale) == 0
    delta = (g.float() * out.float()).sum(-1)
    dq, dk, dv, db = (torch.empty_like(t) for t in (q, k, v, bias3))
    ins = (q, k, v, g, lse, delta, bias3)
    for kernel, outs in (("bwd_dkv", (dk, dv)), ("bwd_dq", (dq,)), ("bwd_db", (db,))):
        assert _dense_c_call(kernel, "wmma", ins, outs, scale) == 0
    return out, lse, dq, dk, dv, db


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("per_head,lq,lk", [(True, 256, 256), (False, 256, 256),
                                            (False, 200, 132), (True, 150, 130)])
def test_hopper_dense_kernels_match_plain_and_wmma(gen, d, per_head, lq, lk):
    """G's four kernels on the route dense_impl names (Hopper at Lk % 4 ==
    0, WMMA at Lk = 130) against their plain versions from the same
    inputs, and against the WMMA kernels called on the same inputs (both
    round p and dS to bf16 at the same places and sum in f32 in other
    orders); the fully masked row gives O = 0, lse = 1e30, dQ = 0 and
    dBias = 0."""
    route = fa.dense_impl(torch.bfloat16, d, lk)
    assert route == ("sm90" if lk % 4 == 0 else "wmma")
    q, k, v, g, bias3 = _dense_inputs(gen, d, per_head, lq, lk)
    before = dict(fa.launch_counts)
    out, lse, dq, dk, dv, db = _dense_run(q, k, v, g, bias3, d**-0.5)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    assert launched == {
        **{f"flash_dense_{n}": 1 for n in ("forward", "bwd_dkv", "bwd_dq", "bwd_db")},
        **{f"flash_dense_{n}_{route}": 1 for n in DENSE_KERNELS}}
    ref, ref_lse = fa._flash_dense_plain(q, k, v, bias3, d**-0.5)
    assert _ulps_ok(out, ref, 2)
    live = ref_lse < 1e29
    assert (lse - ref_lse)[live].abs().max().item() < 2e-3
    want = fa._flash_dense_backward_plain(q, k, v, bias3, out, lse, g, d**-0.5)
    for got, ref_grad in zip((dq, dk, dv, db), want):
        assert _ulps_ok(got, ref_grad)
    assert bool((out[1, :, 5] == 0).all()) and bool((lse[1, :, 5] == fa.LSE_MASKED).all())
    assert bool((dq[1, :, 5] == 0).all())
    assert bool((db.reshape(2, -1, lq, lk)[1, :, 5] == 0).all())
    wmma = _wmma_dense_run(q, k, v, g, bias3, d**-0.5)
    torch.cuda.synchronize()
    assert _ulps_ok(out, wmma[0], 2)
    assert (lse - wmma[1])[live].abs().max().item() < 2e-3
    for got, other in zip((dq, dk, dv, db), wmma[2:]):
        assert _ulps_ok(got, other)


def test_hopper_dense_refuses_a_key_length_its_tensor_maps_cannot_read(gen):
    """Lk % 4 != 0 routes to WMMA; the Hopper entry called there anyway
    refuses it (the f32 bias rows' stride is not a multiple of 16 bytes)."""
    q, k, v, g, bias3 = _dense_inputs(gen, 64, False, 128, 130)
    assert fa.dense_impl(torch.bfloat16, 64, 130) == "wmma"
    out, lse = torch.empty_like(q), torch.empty(q.shape[:3], device="cuda")
    assert _dense_c_call("fwd", "sm90", (q, k, v, bias3), (out, lse), 0.125) != 0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("per_head", [True, False])
def test_hopper_dense_gradients_through_flash_attention(gen, d, per_head):
    """Autograd through flash_attention(bias=...) on the Hopper route, the
    bias requiring a gradient, against autograd through the plain forward
    in f32 on the card from the same inputs."""
    q, k, v, g, bias3 = _dense_inputs(gen, d, per_head, 384, 256)
    bias = bias3.reshape(2, -1, 384, 256)
    before = dict(fa.launch_counts)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    out = fa.flash_attention(*leaves[:3], bias=leaves[3])
    got = (out,) + torch.autograd.grad(out, leaves, g)
    launched = {n: c - before[n] for n, c in fa.launch_counts.items() if c > before[n]}
    assert all(launched.get(f"flash_dense_{n}_sm90") == 1 for n in DENSE_KERNELS)
    leaves32 = [t.detach().float().requires_grad_() for t in (q, k, v, bias)]
    ref = fa._flash_dense_plain(*leaves32[:3], fa._dense_bias3(leaves32[3]), d**-0.5)[0]
    want = (ref,) + torch.autograd.grad(ref, leaves32, g.float())
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel(a, b) < 2e-2


# ---------------------------------------------------------------------------
# The int8 kernels (H, I, J, K)
# ---------------------------------------------------------------------------

# One int8 level on at most this fraction of the elements: the kernels and
# the plain versions round every f32 step alike, but sum the row's squares
# in another order (rms_mod_quant), which can move an element across a
# rounding boundary.
LEVEL_FRACTION = 1e-3


def _int8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                         dtype=torch.int8)


def _assert_rows_match(pq, ref_q, ref_s):
    q, s = (pq.q, pq.s) if isinstance(pq, i8.PrequantRows) else pq
    assert q.dtype == torch.int8 and q.shape == ref_q.shape and s.shape == ref_s.shape
    torch.testing.assert_close(s, ref_s, rtol=1e-6, atol=0)
    diff = (q.int() - ref_q.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= LEVEL_FRACTION


@pytest.mark.parametrize("m,k,n", [(832, 256, 512), (5000, 2048, 128), (100, 512, 256)])
def test_w8a8_matmul_kernel_is_exact_in_int32(gen, m, k, n):
    """Unit scales, f32 output: the kernel returns the int32 sums."""
    x_q, w_q = _int8(gen, m, k), _int8(gen, n, k)
    ones_m = torch.ones(m, 1, device="cuda")
    ones_n = torch.ones(n, device="cuda")
    before = i8.launch_counts["w8a8_matmul"]
    out = i8.w8a8_matmul(x_q, ones_m, w_q, ones_n, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert i8.launch_counts["w8a8_matmul"] == before + 1
    acc = (x_q.double() @ w_q.double().t()).float()
    assert torch.equal(out, acc)


# ragged M, K off the 128-byte step, N off the tile and not a multiple of 8
@pytest.mark.parametrize("m,k,n", [(333, 272, 200), (5000, 2048, 2048), (1, 16, 2),
                                   (130, 4096, 520)])
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_hopper_w8a8_matmul_matches_plain_and_mma(gen, m, k, n, use_bias, out_dtype):
    """The Hopper kernel exact in int32, and with real scales equal to the
    plain version and to the mma.sync kernel of csrc/int8_matmul.cu (called
    through its C entry) on the same inputs: each f32 step of the dequant
    rounds alike."""
    x_q, w_q = _int8(gen, m, k), _int8(gen, n, k)
    ones_m, ones_n = torch.ones(m, 1, device="cuda"), torch.ones(n, device="cuda")
    before = dict(i8.launch_counts)
    acc = i8.w8a8_matmul(x_q, ones_m, w_q, ones_n, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert i8.launch_counts["w8a8_matmul_sm90"] == before["w8a8_matmul_sm90"] + 1
    assert torch.equal(acc, (x_q.double() @ w_q.double().t()).float())
    x_s = torch.rand(m, 1, generator=gen, device="cuda") * 0.02
    w_s = torch.rand(n, generator=gen, device="cuda") * 0.02
    bias = torch.randn(n, generator=gen, device="cuda") if use_bias else None
    out = i8.w8a8_matmul(x_q, x_s, w_q, w_s, bias, out_dtype)
    assert torch.equal(out, i8._w8a8_matmul_plain(x_q, x_s, w_q, w_s, bias, out_dtype))
    mma = torch.empty_like(out)
    fn = i8._entry("w8a8_matmul", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    assert fn(x_q.data_ptr(), x_s.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
              None if bias is None else bias.data_ptr(), mma.data_ptr(), m, n, k,
              int(out_dtype == torch.float32), torch.cuda.current_stream().cuda_stream) == 0
    assert torch.equal(out, mma)


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_w8a8_matmul_kernel_matches_plain(gen, use_bias, out_dtype):
    m, k, n = 300, 1024, 384
    x_q, w_q = _int8(gen, m, k), _int8(gen, n, k)
    x_s = torch.rand(m, 1, generator=gen, device="cuda") * 0.02
    w_s = torch.rand(n, generator=gen, device="cuda") * 0.02
    bias = torch.randn(n, generator=gen, device="cuda") if use_bias else None
    out = i8.w8a8_matmul(x_q, x_s, w_q, w_s, bias, out_dtype)
    ref = i8._w8a8_matmul_plain(x_q, x_s, w_q, w_s, bias, out_dtype)
    # each f32 step rounds alike on both sides: the same values
    assert torch.equal(out, ref)


def test_quantize_rows_kernel_matches_plain(gen):
    x = torch.randn(301, 512, generator=gen, device="cuda").bfloat16()
    x[7] = 0.0  # zero row: s = 1e-30 / 127, q = 0
    ref_q, ref_s = i8._row_quant_plain(x.float())
    _assert_rows_match(i8.quantize_rows_pallas(x), ref_q, ref_s)
    assert bool((ref_q[7] == 0).all())


@pytest.mark.parametrize("with_shift", [True, False])
def test_rms_mod_quant_kernel_matches_plain(gen, with_shift):
    b, n, c = 2, 301, 256
    x = torch.randn(b, n, c, generator=gen, device="cuda").bfloat16()
    x[0, 7] = 0.0  # zero row: quantizes the shift vector
    cvec = (1.0 + 0.3 * torch.randn(b, 1, c, generator=gen, device="cuda")).bfloat16()
    shift = (0.2 * torch.randn(b, 1, c, generator=gen, device="cuda")).bfloat16()
    shift = shift if with_shift else None
    pq = i8.fused_rms_mod_quant(x, cvec, shift, eps=1e-6)
    assert pq.shape == (b, n, c) and pq.dtype == torch.bfloat16
    ref_q, ref_s = i8._row_quant_plain(i8._rms_mod_plain(x, cvec, shift, 1e-6))
    _assert_rows_match(pq, ref_q, ref_s)


@pytest.mark.parametrize("act", ["gelu-approximate", "gelu", "geglu"])
def test_act_quant_kernel_matches_plain(gen, act):
    h = torch.randn(1, 203, 1024, generator=gen, device="cuda").bfloat16()
    pq = i8.fused_act_quant(h, act)
    width = 512 if act == "geglu" else 1024
    assert pq.shape == (1, 203, width) and pq.q.shape == (203, width)
    _assert_rows_match(pq, *i8._row_quant_plain(i8._act_plain(h, act)))


def _rowblock_act_quant(h, act):
    """K's row-block kernel (``act_quant``) through its C entry, on the
    inputs the Hopper route took."""
    fn = i8._entry("act_quant", [i8._P] * 3 + [i8._I] * 4 + [i8._P])
    b, n, c2 = h.shape
    width = c2 // 2 if act == "geglu" else c2
    q = torch.empty((b * n, width), device="cuda", dtype=torch.int8)
    s = torch.empty((b * n, 1), device="cuda", dtype=torch.float32)
    assert fn(h.data_ptr(), q.data_ptr(), s.data_ptr(), b * n, c2, i8.ACTIVATIONS[act], 0,
              torch.cuda.current_stream().cuda_stream) == 0
    return q, s


@pytest.mark.parametrize("act", ["gelu-approximate", "gelu", "geglu"])
@pytest.mark.parametrize("b,n,width", [(2, 1001, 8192), (1, 64, 16384), (1, 37, 2056)])
def test_hopper_act_quant_matches_plain_and_the_rowblock_kernel(gen, act, b, n, width):
    """K on its Hopper route (bf16, output width a multiple of 8): the DiT's
    FF width over a ragged 2 x 1,001 batch with a zero row, the widest row
    (16,384) and a width of 2,056 (257 chunks of 8), geglu over inputs twice
    as wide, against the plain version (one level on at most
    LEVEL_FRACTION, scales within 1e-6) and equal bit for bit to the
    row-block kernel."""
    shape = (b, n, 2 * width if act == "geglu" else width)
    h = (2.0 * torch.randn(shape, generator=gen, device="cuda")).bfloat16()
    h[0, 3] = 0.0
    assert i8.act_quant_impl(width, torch.bfloat16) == "sm90"
    before = dict(i8.launch_counts)
    pq = i8.fused_act_quant(h, act)
    torch.cuda.synchronize()
    launched = {n: c - before[n] for n, c in i8.launch_counts.items() if c > before[n]}
    assert launched == {"act_quant": 1, "act_quant_sm90": 1}
    assert pq.shape == (b, n, width)
    _assert_rows_match(pq, *i8._row_quant_plain(i8._act_plain(h, act)))
    assert bool((pq.q[3] == 0).all())
    q, s = _rowblock_act_quant(h, act)
    assert torch.equal(pq.q, q) and torch.equal(pq.s, s)


@pytest.mark.parametrize("width,dtype", [(1001, torch.bfloat16), (1028, torch.bfloat16),
                                         (8192, torch.float32)])
def test_act_quant_rowblock_route(gen, width, dtype):
    """Widths that are not a multiple of 8, and f32 rows, take the row-block
    kernel (``act_quant_rowblock``), held to the plain version."""
    h = torch.randn(1, 33, width, generator=gen, device="cuda").to(dtype)
    assert i8.act_quant_impl(width, dtype) == "rowblock"
    before = i8.launch_counts["act_quant_rowblock"]
    pq = i8.fused_act_quant(h, "gelu-approximate")
    torch.cuda.synchronize()
    assert i8.launch_counts["act_quant_rowblock"] == before + 1
    _assert_rows_match(pq, *i8._row_quant_plain(i8._act_plain(h, "gelu-approximate")))


def _rowblock_rms_mod_quant(x, cvec, shift, eps=1e-6):
    """J's row-block kernel (``rms_mod_quant``) through its C entry, on
    inputs the Hopper route takes."""
    fn = i8._entry("rms_mod_quant", [i8._P] * 5 + [i8._I] * 3 + [i8._F, i8._I, i8._P])
    b, n, c = x.shape
    cvec = cvec.float().reshape(b, c).contiguous()
    shift = None if shift is None else shift.float().reshape(b, c).contiguous()
    q = torch.empty((b * n, c), device="cuda", dtype=torch.int8)
    s = torch.empty((b * n, 1), device="cuda", dtype=torch.float32)
    assert fn(x.data_ptr(), cvec.data_ptr(), None if shift is None else shift.data_ptr(),
              q.data_ptr(), s.data_ptr(), b, n, c, eps, int(x.dtype == torch.float32),
              torch.cuda.current_stream().cuda_stream) == 0
    return q, s


def _rms_mod_inputs(gen, b, n, c, dtype=torch.bfloat16):
    x = torch.randn(b, n, c, generator=gen, device="cuda").to(dtype)
    cvec = (1.0 + 0.3 * torch.randn(b, 1, c, generator=gen, device="cuda")).bfloat16()
    shift = (0.2 * torch.randn(b, 1, c, generator=gen, device="cuda")).bfloat16()
    return x, cvec, shift


# the DiT's 2 x 1,001 rows of 2,048 (a warp a row), the widest row (16,384:
# 8 warps a row), 2,056 (257 chunks of 8: 2 warps a row, not a multiple of
# 32), 4,096 (above one warp's 2,048: 2 warps a row) and a tiny DiT's 128
@pytest.mark.parametrize("with_shift", [True, False])
@pytest.mark.parametrize("b,n,width", [(2, 1001, 2048), (1, 64, 16384), (1, 37, 2056),
                                       (3, 50, 4096), (2, 17, 128)])
def test_hopper_rms_mod_quant_matches_plain_and_the_rowblock_kernel(gen, with_shift, b, n,
                                                                      width):
    """J on its Hopper route (bf16, width a multiple of 8) with a zero row,
    against the plain version and against the row-block kernel on the same
    inputs, each to one level on at most LEVEL_FRACTION and scales within
    1e-6: the sums of squares are added in another order, so bit equality
    is not expected."""
    x, cvec, shift = _rms_mod_inputs(gen, b, n, width)
    x[0, 7] = 0.0  # zero row: quantizes the shift vector
    shift = shift if with_shift else None
    assert i8.rms_mod_quant_impl(width, torch.bfloat16) == "sm90"
    before = dict(i8.launch_counts)
    pq = i8.fused_rms_mod_quant(x, cvec, shift, eps=1e-6)
    torch.cuda.synchronize()
    launched = {k: c - before[k] for k, c in i8.launch_counts.items() if c > before[k]}
    assert launched == {"rms_mod_quant": 1, "rms_mod_quant_sm90": 1}
    assert pq.shape == (b, n, width) and pq.q.shape == (b * n, width)
    _assert_rows_match(pq, *i8._row_quant_plain(i8._rms_mod_plain(x, cvec, shift, 1e-6)))
    _assert_rows_match(pq, *_rowblock_rms_mod_quant(x, cvec, shift))
    if not with_shift:
        assert bool((pq.q[7] == 0).all())


@pytest.mark.parametrize("width,dtype", [(1001, torch.bfloat16), (2052, torch.bfloat16),
                                         (2048, torch.float32)])
def test_rms_mod_quant_rowblock_route(gen, width, dtype):
    """Widths that are not a multiple of 8, and f32 rows, take J's row-block
    kernel (``rms_mod_quant_rowblock``), held to the plain version."""
    x, cvec, shift = _rms_mod_inputs(gen, 2, 33, width, dtype)
    assert i8.rms_mod_quant_impl(width, dtype) == "rowblock"
    before = dict(i8.launch_counts)
    pq = i8.fused_rms_mod_quant(x, cvec, shift, eps=1e-6)
    torch.cuda.synchronize()
    launched = {k: c - before[k] for k, c in i8.launch_counts.items() if c > before[k]}
    assert launched == {"rms_mod_quant": 1, "rms_mod_quant_rowblock": 1}
    _assert_rows_match(pq, *i8._row_quant_plain(i8._rms_mod_plain(x, cvec, shift, 1e-6)))


# one NaN, +inf and -inf element in rows 3, 5 and 8 of 16
NONFINITE = {3: float("nan"), 5: float("inf"), 8: float("-inf")}
NONFINITE_KERNELS = ["quantize_rows", "rms_mod_quant sm90", "rms_mod_quant rowblock"] + [
    f"act_quant {act}" for act in ("gelu-approximate", "gelu", "geglu")]


@pytest.mark.parametrize("kernel", NONFINITE_KERNELS)
def test_row_quant_kernels_carry_nonfinite_rows(gen, kernel):
    """I, J (both routes) and K (both kernels) on rows with one NaN, +inf or
    -inf element beside finite rows, against the plain version: on those
    rows the levels exactly equal (all 0) and the scales equal, NaN to NaN
    and inf to inf (equal_nan on these rows only); the finite rows to the
    usual rule. K's two kernels equal bit for bit on every row."""
    n, c = 16, 2048
    x = torch.randn(1, n, 2 * c if kernel.endswith("geglu") else c, generator=gen,
                    device="cuda")
    for row, value in NONFINITE.items():
        x[0, row, 17] = value
    x = x.bfloat16()
    _, cvec, shift = _rms_mod_inputs(gen, 1, 1, c)
    if kernel == "quantize_rows":
        out = i8.quantize_rows_pallas(x[0])
        ref = i8._row_quant_plain(x[0].float())
    elif kernel.startswith("rms_mod_quant"):
        ref = i8._row_quant_plain(i8._rms_mod_plain(x, cvec, shift, 1e-6))
        if kernel.endswith("sm90"):
            before = i8.launch_counts["rms_mod_quant_sm90"]
            pq = i8.fused_rms_mod_quant(x, cvec, shift, eps=1e-6)
            assert i8.launch_counts["rms_mod_quant_sm90"] == before + 1
            out = (pq.q, pq.s)
        else:
            out = _rowblock_rms_mod_quant(x, cvec, shift)
    else:
        act = kernel.split()[1]
        pq = i8.fused_act_quant(x, act)
        out = (pq.q, pq.s)
        ref = i8._row_quant_plain(i8._act_plain(x, act))
        block = _rowblock_act_quant(x, act)
        assert torch.equal(out[0], block[0])
        torch.testing.assert_close(out[1], block[1], rtol=0, atol=0, equal_nan=True)
    torch.cuda.synchronize()
    bad = sorted(NONFINITE)
    finite = [i for i in range(n) if i not in NONFINITE]
    _assert_rows_match((out[0][finite], out[1][finite]), ref[0][finite], ref[1][finite])
    assert torch.equal(out[0][bad], ref[0][bad]) and not out[0][bad].any()
    torch.testing.assert_close(out[1][bad], ref[1][bad], rtol=0, atol=0, equal_nan=True)
    assert not torch.isfinite(out[1][bad]).any()


def test_int8_wrappers_reject_what_the_kernels_do_not_take(gen):
    x_q, w_q = _int8(gen, 64, 40), _int8(gen, 32, 40)  # K not a multiple of 16
    ones = torch.ones(64, 1, device="cuda")
    with pytest.raises(ValueError):
        i8.w8a8_matmul(x_q, ones, w_q, torch.ones(32, device="cuda"))
    with pytest.raises(ValueError):  # activations in int8 are not rows to quantize
        i8.quantize_rows_pallas(x_q)
    with pytest.raises(ValueError):  # not contiguous
        i8.quantize_rows_pallas(torch.randn(64, 64, device="cuda").t())
    with pytest.raises(ValueError):
        i8.fused_act_quant(torch.randn(1, 4, 64, device="cuda"), "relu")


# kernel L's gather route (csrc/int8_conv3d.cu: W = 10 is no wgmma box):
# C_in, C_out, kernel size, stride, causal, spatial padding, dtype; C_in 8,
# 33 and 48 are not multiples of 32
CONV_CASES = [
    (8, 8, 3, 1, True, "zeros", torch.float32),
    (48, 128, 3, 1, True, "replicate", torch.bfloat16),
    (33, 40, 3, 2, True, "replicate", torch.bfloat16),
    (128, 128, 3, (2, 1, 1), False, "zeros", torch.bfloat16),
    (64, 48, 3, (1, 2, 2), False, "replicate", torch.float32),
    (128, 64, 1, 1, False, "zeros", torch.bfloat16),
]


def _conv_params(gen, c, n, k, bias=True):
    w = torch.randn(n, c, k, k, k, generator=gen, device="cuda") * 0.05
    return quantize_conv3d({"weight": w, **({"bias": torch.randn(
        n, generator=gen, device="cuda")} if bias else {})})


@pytest.mark.parametrize("c,n,k,stride,causal,mode,dtype", CONV_CASES)
def test_int8_conv3d_matches_plain_bit_for_bit(gen, c, n, k, stride, causal, mode, dtype):
    """L1's levels and L2's outputs equal the plain version's exactly: the
    integer sums are exact and the epilogue is the same arithmetic."""
    x = torch.randn(2, c, 5, 12, 10, generator=gen, device="cuda").to(dtype)
    p = _conv_params(gen, c, n, k, bias=c != 64)
    s = cc.act_scale(x)
    before = dict(cc.launch_counts)
    levels = cc.quantize_levels(x, s)
    ref_levels = cc._levels(x, s).to(torch.int8)
    assert torch.equal(levels[..., :c], ref_levels.permute(0, 2, 3, 4, 1))
    assert not levels[..., c:].any()
    out = cc.int8_conv3d(x, p, stride, causal, mode)
    torch.cuda.synchronize()
    assert cc.launch_counts["int8_conv3d"] == before["int8_conv3d"] + 1
    assert cc.launch_counts["int8_conv3d_quant"] == before["int8_conv3d_quant"] + 2
    ref = cc._int8_conv3d_plain(x, p["kernel_q8"], p["scale"], p.get("bias"), stride,
                                causal, mode)
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, ref)


def test_int8_conv3d_zero_and_nan_inputs(gen):
    """An all-zero input gives the bias (scale 1e-8 / 127, levels 0); a NaN
    makes the scale and so every output NaN, as the reference does."""
    p = _conv_params(gen, 32, 16, 3)
    zero = torch.zeros(1, 32, 3, 8, 8, device="cuda", dtype=torch.bfloat16)
    out = cc.int8_conv3d(zero, p)
    assert torch.equal(out, p["bias"].bfloat16()[None, :, None, None, None].expand_as(out))
    x = torch.randn(1, 32, 3, 8, 8, generator=gen, device="cuda", dtype=torch.bfloat16)
    x[0, 3, 1, 2, 2] = float("nan")
    out = cc.int8_conv3d(x, p)
    ref = cc._int8_conv3d_plain(x, p["kernel_q8"], p["scale"], p["bias"], 1, True, "zeros")
    assert torch.isnan(out).all() and torch.isnan(ref).all()


def test_int8_conv3d_wrapper_refuses_what_it_cannot_run(gen):
    p = _conv_params(gen, 32, 16, 3)
    x = torch.randn(1, 32, 3, 8, 8, generator=gen, device="cuda")
    with pytest.raises(ValueError):  # the kernel as [out, in, kt, kh, kw]
        cc.int8_conv3d(x, dict(p, kernel_q8=cc.int8_kernel_view(p["kernel_q8"], 32)
                               .contiguous()))
    with pytest.raises(ValueError):  # fp16
        cc.int8_conv3d(x.half(), p)
    with pytest.raises(ValueError):  # padding mode
        cc.int8_conv3d(x, p, spatial_padding_mode="reflect")


# kernel L's wgmma route (csrc/int8_conv3d_sm90.cu): batch, C_in, C_out,
# (F, H, W), causal, dtype; W = 8, 16, 32, 64; F = 1 and 2 clamp every tap's
# frame at one or both ends; N = 48 and 129 leave a ragged channel tile;
# C_in 48 and 64 take 64-byte stages
SM90_CASES = [
    (1, 128, 128, (5, 8, 8), True, torch.bfloat16),
    (2, 128, 48, (3, 16, 16), False, torch.bfloat16),
    (1, 64, 129, (3, 32, 32), True, torch.float32),
    (1, 256, 64, (2, 64, 64), False, torch.bfloat16),
    (1, 512, 129, (1, 8, 8), True, torch.bfloat16),
    (1, 512, 512, (2, 8, 8), False, torch.bfloat16),
    (1, 48, 128, (1, 16, 16), True, torch.float32),
]


def _sm90_call(x, p, causal, tile_m, split):
    """L2 on the wgmma kernel through its C entry with a plan of our own."""
    s = cc.act_scale(x)
    xq = cc.quantize_levels(x, s)
    plan, out, (args, _keep) = cc._conv_args(xq, s, p["kernel_q8"], p["scale"], p.get("bias"),
                                             x.dtype, 1, causal, "zeros")
    tiles = -(-out[:, 0].numel() // tile_m) * -(-out.shape[1] // cc.TILE_N)
    ws = None if split == 1 else torch.empty(tiles * (tile_m * cc.TILE_N + 1),
                                             device="cuda", dtype=torch.int32)
    fn = cc._entry("int8_conv3d_sm90", "int8_conv3d_sm90", [cc._P] * 7 + [cc._I] * 4 + [cc._P] * 2)
    assert fn(*args, tile_m, plan.chunk, split, None if ws is None else ws.data_ptr(),
              torch.cuda.current_stream().cuda_stream) == 0
    return plan, out


@pytest.mark.parametrize("b,c,n,fhw,causal,dtype", SM90_CASES)
def test_int8_conv3d_sm90_matches_plain_bit_for_bit(gen, b, c, n, fhw, causal, dtype):
    """The wrapper takes the wgmma route conv_plan names (one launch of
    it, none of the gather kernel), and that route, split K in 2 and 3
    slices, 256-position tiles (bf16) and the gather kernel on the same
    inputs all give the plain version's output exactly."""
    x = torch.randn(b, c, *fhw, generator=gen, device="cuda").to(dtype)
    p = _conv_params(gen, c, n, 3)
    plan = cc.conv_plan(tuple(x.shape), n, (3, 3, 3), (1, 1, 1), causal, "zeros", dtype)
    assert plan.route == "sm90"
    before = dict(cc.launch_counts)
    out = cc.int8_conv3d(x, p, 1, causal)
    torch.cuda.synchronize()
    assert cc.launch_counts["int8_conv3d_sm90"] == before["int8_conv3d_sm90"] + 1
    assert cc.launch_counts["int8_conv3d"] == before["int8_conv3d"]
    ref = cc._int8_conv3d_plain(x, p["kernel_q8"], p["scale"], p["bias"], 1, causal, "zeros")
    assert out.dtype == dtype and torch.equal(out, ref)
    tiles = (128, 256) if dtype == torch.bfloat16 else (128,)
    for tile_m in tiles:
        for split in (1, 2, 3):
            _, forced = _sm90_call(x, p, causal, tile_m, split)
            torch.cuda.synchronize()
            assert torch.equal(forced, ref), (tile_m, split)
    s = cc.act_scale(x)
    xq = cc.quantize_levels(x, s)
    _, gathered, (args, _keep) = cc._conv_args(xq, s, p["kernel_q8"], p["scale"], p["bias"],
                                               dtype, 1, causal, "zeros")
    assert cc.gather_entry()(*args, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(gathered, ref)


def test_int8_conv3d_sm90_split_keeps_nan_and_zero(gen):
    """Split K over a NaN input gives NaN everywhere; over zeros, the bias."""
    p = _conv_params(gen, 512, 129, 3)
    zero = torch.zeros(1, 512, 1, 8, 8, device="cuda", dtype=torch.bfloat16)
    assert cc.conv_plan(tuple(zero.shape), 129, (3, 3, 3), (1, 1, 1), True, "zeros",
                        torch.bfloat16).split > 1
    out = cc.int8_conv3d(zero, p)
    assert torch.equal(out, p["bias"].bfloat16()[None, :, None, None, None].expand_as(out))
    x = torch.randn(1, 512, 1, 8, 8, generator=gen, device="cuda", dtype=torch.bfloat16)
    x[0, 100, 0, 3, 3] = float("nan")
    assert torch.isnan(cc.int8_conv3d(x, p)).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fhw", [(1, 8, 8), (3, 7, 9), (97, 32, 32)])
def test_int8_conv3d_levels_match_plain_with_nonfinite_rows(gen, dtype, fhw):
    """L1 (its 64- and 256-position tiles, 16-byte and, at 189 positions,
    scalar loads) equals _levels and the first design's kernel, NaN and
    +-inf included, under the NaN scale they give and a finite one."""
    x = torch.randn(2, 40, *fhw, generator=gen, device="cuda").to(dtype)
    x[0, 3].view(-1)[::7] = float("nan")
    x[1, 5].view(-1)[::5] = float("inf")
    x[1, 6].view(-1)[::3] = float("-inf")
    for s in (cc.act_scale(x), torch.tensor(0.37, device="cuda")):
        levels = cc.quantize_levels(x, s)
        ref = cc._levels(x, s).to(torch.int8).permute(0, 2, 3, 4, 1)
        assert torch.equal(levels[..., :40], ref) and not levels[..., 40:].any()
        old = torch.empty_like(levels)
        fn = cc._entry("int8_conv3d", "int8_conv3d_quant", [cc._P] * 3 + [cc._I] * 5 + [cc._P])
        assert fn(x.data_ptr(), s.data_ptr(), old.data_ptr(), 2, 40, x[0, 0].numel(), 64,
                  int(dtype == torch.float32), torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(levels, old)


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (2^(e - 8) for x = m 2^e, m in [0.5, 1))."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x).exponent - 8).clamp_min(2.0**-133)


def _pair_ulps(out, ref, heads):
    """|out - ref| of kernel M's outputs in bf16 ulps of each element's
    rotated pair's norm (``chip_smoke.pair_ulps``)."""
    b, length, c = ref.shape
    r = ref.float().reshape(b, length, heads, 2, c // heads // 2)
    norm = r.norm(dim=3, keepdim=True).expand_as(r).reshape(b, length, c)
    return (out.float() - ref.float()).abs() / _bf16_ulp(norm)


def _qk_case(gen, b, length, heads, dtype, table_batch, width=2048):
    def randn(*shape, scale=1.0, offset=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale + offset).to(dtype)

    ang = torch.rand(table_batch, length, width // 2, generator=gen, device="cuda") * 6.3
    return (randn(b, length, width, scale=3.0), randn(b, length, width, scale=3.0),
            randn(width, scale=0.2, offset=1.0), randn(width, scale=0.2, offset=1.0),
            ang.cos().to(dtype), ang.sin().to(dtype), heads)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,length,heads,table_batch", [(1, 5376, 32, 1), (2, 1536, 16, 2)])
def test_qk_norm_rope_kernel_matches_plain(gen, dtype, b, length, heads, table_batch):
    """Kernel M against its plain version (the chain of ``_attention``), at
    the long path's 32 x 64 heads and at 16 x 128 heads, the softmax scale
    folded where it is a power of two: every element within two bf16 ulps
    of its rotated pair's norm, in bf16 at least 99.9% equal. The sums of
    squares run in another order and move a row's f32 rsqrt by an ulp now
    and then; in bf16 that moves a normed value by one ulp where it crosses
    a rounding boundary, which the rotation carries to both outputs of its
    pair, however small (``chip_smoke.QK_PAIR_ULPS``); in f32 it moves
    every element of the row, so there the share is only reported."""
    args = _qk_case(gen, b, length, heads, dtype, table_batch)
    scale = (2048 // heads) ** -0.5
    before = fa.launch_counts["qk_norm_rope"]
    q, k, left = fa.qk_norm_rope(*args, scale)
    assert fa.launch_counts["qk_norm_rope"] == before + 1
    assert left == (1.0 if heads == 32 else scale)
    refs = fa._qk_norm_rope_plain(*args, scale if left == 1.0 else 1.0)
    for name, out, ref in (("q", q, refs[0]), ("k", k, refs[1])):
        share = (out == ref).float().mean().item()
        print(f"qk_norm_rope {dtype} {b}x{length} {name}: {share:.6f} equal")
        assert _pair_ulps(out, ref, heads).max().item() <= 2.0, name
        if dtype == torch.bfloat16:
            assert share >= 0.999, (name, share)


def test_qk_norm_rope_refuses_what_it_cannot_run(gen):
    """A width over heads that M does not take, and tables of another
    length, raise."""
    args = _qk_case(gen, 1, 16, 3, torch.bfloat16, 1)
    with pytest.raises(ValueError):
        fa.qk_norm_rope(*args, 1.0)
    q, k, wq, wk, cos, sin, _ = _qk_case(gen, 1, 16, 32, torch.bfloat16, 1)
    with pytest.raises(ValueError):
        fa.qk_norm_rope(q, k, wq, wk, cos[:, :8], sin[:, :8], 32, 1.0)


def _qk_head_case(gen, length, width, heads):
    """Kernel M's inputs with per-head tables [1, L, d/2] shared by the
    heads (Wan2.1's RoPE)."""
    def randn(*shape, scale=1.0, offset=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + offset).bfloat16()

    ang = torch.rand(1, length, width // heads // 2, generator=gen, device="cuda") * 6.3
    return (randn(1, length, width, scale=3.0), randn(1, length, width, scale=3.0),
            randn(width, scale=0.2, offset=1.0), randn(width, scale=0.2, offset=1.0),
            ang.cos().bfloat16(), ang.sin().bfloat16(), heads)


def test_qk_norm_rope_head_tables_match_plain_at_the_wan_shape(gen):
    """Kernel M's per-head table mode at Wan2.1's [1, 32760, 5120] (40 heads
    of 128, the model's RoPE tables on its 21 x 30 x 52 grid, eps 1e-6, the
    scale 1/sqrt(128) left for the attention) against its plain version:
    every element within 2 sqrt 2 + 1 bf16 ulps of its rotated pair's norm
    (``chip_smoke.WAN_M_PAIR_ULPS``: a 5120-wide row's rsqrt moved by an
    ulp can move both values of a pair, and a pair's norm can cross a power
    of two in rounding), at least 99.9% equal, one launch."""
    from avatar_tpu_torch.models import wan

    args = _qk_head_case(gen, 32760, 5120, 40)[:4] + wan.rope_tables(
        21, 30, 52, 128, device="cuda") + (40,)
    assert fa.head_tables(args[4], 5120, 40)
    before = fa.launch_counts["qk_norm_rope"]
    q, k, left = fa.qk_norm_rope(*args, 128**-0.5, eps=1e-6)
    assert fa.launch_counts["qk_norm_rope"] == before + 1
    assert left == 128**-0.5
    refs = fa._qk_norm_rope_plain(*args, 1.0, eps=1e-6)
    for name, out, ref in (("q", q, refs[0]), ("k", k, refs[1])):
        share = (out == ref).float().mean().item()
        print(f"qk_norm_rope head tables 1x32760x5120 {name}: {share:.6f} equal")
        assert _pair_ulps(out, ref, 40).max().item() <= 2 * 2**0.5 + 1, name
        assert share >= 0.999, (name, share)


def test_qk_norm_rope_modes_agree_bit_for_bit_at_the_ltx_shape(gen):
    """At the LTX long path's [1, 5376, 2048] (32 heads of 64), the
    global-table mode that path runs and the per-head mode on the same
    angles (tables that repeat every head) give the same bits: the new mode
    changes nothing of the old one's arithmetic."""
    q, k, wq, wk, cos, sin, heads = _qk_head_case(gen, 5376, 2048, 32)
    full = (cos.repeat(1, 1, heads).contiguous(), sin.repeat(1, 1, heads).contiguous())
    a = fa.qk_norm_rope(q, k, wq, wk, cos, sin, heads, 0.125)
    b = fa.qk_norm_rope(q, k, wq, wk, *full, heads, 0.125)
    assert a[2] == b[2] == 1.0
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_attention_through_m_matches_the_chain_through_c(gen, monkeypatch):
    """``_attention``'s self-attention at 1536 tokens of the 2B DiT's 32 x 64
    heads (to_out the identity, so the output is C's) through kernel M
    against the same call on the chain (q/k norm, RoPE, head-major copies,
    ``fold_scale``), both through C: within one bf16 ulp of the largest
    output. Where M's k lands one ulp off the chain's, every query of that
    head moves a little, so the share of equal outputs is reported, not
    held."""
    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.ops import rope as trope

    cfg = tdit.DiTConfig(num_attention_heads=32, attention_head_dim=64, num_layers=1)
    p = tdit.permute_dit_params_for_split_rope(
        tdit.init_dit(cfg, 5, device="cuda", dtype=torch.bfloat16), cfg)
    attn1 = dict(p["blocks"][0]["attn1"])
    attn1["to_out"] = {"weight": torch.eye(2048, device="cuda", dtype=torch.bfloat16)}
    for norm in ("q_norm", "k_norm"):
        attn1[norm] = {"scale": (1.0 + 0.2 * torch.randn(2048, generator=gen, device="cuda")
                                 ).bfloat16()}
    coords = trope.get_latent_coords(6, 16, 16, batch_size=1, device="cuda")
    freqs = trope.split_freqs(trope.precompute_freqs_cis(coords, dim=2048,
                                                        out_dtype=torch.bfloat16))
    x = torch.randn(1, 1536, 2048, generator=gen, device="cuda").bfloat16()
    counts = dict(fa.launch_counts)
    out = tdit._attention(attn1, x, cfg, freqs_cis=freqs, rope_split=True)
    assert fa.launch_counts["qk_norm_rope"] == counts["qk_norm_rope"] + 1
    assert fa.launch_counts["flash_bounded_sm90"] == counts["flash_bounded_sm90"] + 1
    monkeypatch.setattr(tdit, "qk_norm_rope_supports", lambda *a: False)
    ref = tdit._attention(attn1, x, cfg, freqs_cis=freqs, rope_split=True)
    assert fa.launch_counts["qk_norm_rope"] == counts["qk_norm_rope"] + 1
    share = (out == ref).float().mean().item()
    print(f"attention through M against the chain: {share:.6f} equal")
    top = ref.float().abs().max()
    assert (out.float() - ref.float()).abs().max() <= _bf16_ulp(top)


# the kernel launch counters of each op span of the render path
SPAN_LAUNCHES = {"attn.A": ("rope_fused_attention",), "attn.B": ("fused_token_attention",),
                 "attn.C": ("flash_bounded",), "attn.D": ("flash_online",),
                 "attn.E": ("flash_single",), "attn.M": ("qk_norm_rope",),
                 "int8.H": ("w8a8_matmul",),
                 "int8.I": ("quantize_rows",), "int8.J": ("rms_mod_quant",),
                 "int8.K": ("act_quant",), "conv.L1": ("int8_conv3d_quant",),
                 "conv.L2": ("int8_conv3d", "int8_conv3d_sm90")}


@pytest.mark.parametrize("w8a8", [False, True])
def test_op_spans_count_the_kernel_launches(gen, monkeypatch, w8a8):
    """A tiny render with ``stage_times``, self-attention on A and then on
    M (A's predicate patched to refuse): each op span's calls equal the
    launches of its kernels, and the output equals the untraced one's."""
    from avatar_tpu_torch.models import dit as tdit
    from avatar_tpu_torch.models import vae as tvae
    from avatar_tpu_torch.pipelines.pipeline import GenerationParams, LTXVideoPipeline

    dcfg = tdit.DiTConfig.from_dict({
        "num_attention_heads": 2, "attention_head_dim": 64, "in_channels": 16,
        "out_channels": 16, "num_layers": 2, "cross_attention_dim": 128, "caption_channels": 32,
        "activation_fn": "gelu-approximate", "qk_norm": "rms_norm",
        "standardization_norm": "rms_norm", "adaptive_norm": "single_scale_shift"})
    vcfg = tvae.VAEConfig.from_dict({
        "latent_channels": 16, "encoder_base_channels": 16,
        "blocks": [["res_x", 1], ["compress_all", 1], ["res_x_y", 1], ["compress_all", 1],
                   ["res_x", 1]],
        "norm_layer": "pixel_norm", "patch_size": 2, "latent_log_var": "uniform",
        "causal_decoder": False, "timestep_conditioning": True})
    if w8a8:
        monkeypatch.setattr(i8, "W8A8_PALLAS_MIN_TOKENS", 16)
    q = "w8a8" if w8a8 else False
    pipe = LTXVideoPipeline(dcfg, tdit.init_dit(dcfg, 1, dtype=torch.bfloat16), vcfg,
                            tvae.init_vae(vcfg, 2, dtype=torch.bfloat16),
                            quantize_weights=q, quantize_vae=q)
    inputs = dict(prompt_embeds=torch.randn(1, 8, 32, generator=gen, device="cuda"),
                  prompt_attention_mask=torch.ones(1, 8, device="cuda"),
                  ref_image=torch.rand(1, 1, 32, 32, 3, generator=gen, device="cuda") * 2 - 1,
                  pose_frames=torch.rand(1, 9, 32, 32, 3, generator=gen, device="cuda") * 2 - 1)
    params = GenerationParams(height=32, width=32, num_frames=8, num_inference_steps=2,
                              guidance_scale=1.0, stg_scale=0.0, decode_timestep=0.05,
                              decode_noise_scale=0.025)

    def call(**kw):
        return pipe(params, torch.Generator(device="cuda").manual_seed(3),
                    output_type="uint8", **inputs, **kw)

    for route in ("A", "M"):
        if route == "M":  # A's predicate refusing, as at 5376 tokens
            monkeypatch.setattr(tdit, "rope_fused_supports", lambda *a: False)
        stages = {}
        assert torch.equal(call(stage_times=stages), call())
        for span, counters in SPAN_LAUNCHES.items():
            launched = sum(stages.get(f"launches.{c}", 0) for c in counters)
            assert stages.get(f"{span}.n", 0) == launched, span
        assert stages[f"attn.{route}.n"] > 0 and (stages.get("int8.H.n", 0) > 0) == w8a8
        assert (stages.get("conv.L2.n", 0) > 0) == w8a8
