"""Which CUDA attention kernel and which build variant each (dtype, head
dim) takes, on the CPU (the decisions are Python, made before a launch):
the Hopper kernels for A, B, C, D, E, the backward F and the dense-bias G
(there with Lk % 4 == 0) at bf16 with head dim 64 or 128, the WMMA tile
code built per (dtype, padded head dim) for everything else; and the head
dims and dtypes the wrappers accept on the card are exactly those the
reference's predicates admit, fp16 excepted (it reaches no path of either
package)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.ops import flash_attention as jfa
from avatar_tpu_torch.ops import flash_attention as tfa

HEAD_DIMS = (8, 12, 16, 24, 32, 40, 64, 72, 80, 96, 120, 128, 136, 200, 256, 264, 384,
             504, 512, 520, 1024)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", ["bounded", "online", "single"])
def test_forward_implementation_by_dtype_and_head_dim(mode, dtype):
    """C, D and E: the Hopper kernel at bf16 with head dim 64 or 128, the
    WMMA variants for f32 and every other head dim."""
    for d in (8, 32, 64, 80, 128, 256, 512):
        hopper = dtype == torch.bfloat16 and d in (64, 128)
        assert tfa.forward_impl(mode, dtype, d) == ("sm90" if hopper else "wmma"), d


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
@pytest.mark.parametrize("d", list(range(16, 257, 16)))
def test_rope_implementation_of_each_admitted_head_dim(dtype, jdtype, d):
    """A at every head dim ``rope_fused_supports`` admits (multiples of 16
    up to 256): the wrapper accepts it, and it runs the Hopper kernel at
    bf16 with head dim 64 or 128 and its WMMA variant otherwise."""
    assert jfa.rope_fused_supports(64, 1, d, jdtype)
    assert _accepts(lambda: tfa._split_heads("A", d, 1, dtype, 16))
    hopper = dtype == torch.bfloat16 and d in (64, 128)
    assert tfa.rope_impl(dtype, d) == ("sm90" if hopper else "wmma")


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
@pytest.mark.parametrize("d", list(range(8, 257, 8)))
def test_token_implementation_of_each_admitted_head_dim(dtype, jdtype, d):
    """B at every head dim ``fused_supports`` admits (multiples of 8 up to
    256): the wrapper accepts it, and it runs the Hopper kernel at bf16 with
    head dim 64 or 128 and its WMMA variant otherwise."""
    assert jfa.fused_supports(64, 64, 1, d, jdtype)
    assert _accepts(lambda: tfa._split_heads("B", d, 1, dtype, 8))
    hopper = dtype == torch.bfloat16 and d in (64, 128)
    assert tfa.token_impl(dtype, d) == ("sm90" if hopper else "wmma")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 80, 128, 256, 512])
def test_backward_implementation_by_dtype_and_head_dim(dtype, d):
    """The flash backward (F): the Hopper kernels at bf16 with head dim 64
    or 128, the WMMA variants for f32 and every other head dim."""
    hopper = dtype == torch.bfloat16 and d in (64, 128)
    assert tfa.backward_impl(dtype, d) == ("sm90" if hopper else "wmma")


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
@pytest.mark.parametrize("d", list(range(8, 513, 8)))
def test_dense_implementation_of_each_admitted_shape(dtype, jdtype, d):
    """G at every head dim ``dense_bias_supported`` admits (multiples of 8
    up to 512) and key lengths 1-600: the Hopper kernels at bf16 with head
    dim 64 or 128 and ``Lk % 4 == 0`` (the f32 bias rows' TMA stride), the
    WMMA variants otherwise; the wrapper accepts the head dim."""
    assert _accepts(lambda: tfa.check_kernel_args("flash", dtype, d, 512))
    for lk in range(1, 601):
        lq = -(-128 * 128 // lk)
        q = np.zeros((1, 1, lq, d), np.float32)
        k = np.zeros((1, 1, lk, d), np.float32)
        assert jfa.dense_bias_supported(q, k, np.zeros((1, 1, lq, lk))), (d, lk)
        hopper = dtype == torch.bfloat16 and d in (64, 128) and lk % 4 == 0
        assert tfa.dense_impl(dtype, d, lk) == ("sm90" if hopper else "wmma"), (d, lk)


@pytest.mark.parametrize("d,padded", [(8, 64), (32, 64), (64, 64), (72, 128),
                                      (128, 128), (136, 256), (256, 256), (264, 512),
                                      (512, 512)])
def test_wmma_variant_of_each_head_dim(d, padded):
    assert tfa.padded_head_dim(d) == padded
    extra = () if padded == 64 else (f"ATTN_D={padded}",)
    assert tfa.kernel_variant(torch.bfloat16, d) == ("bf16", extra)
    assert tfa.kernel_variant(torch.float32, d) == ("f32", ("ATTN_F32=1",) + extra)


def _accepts(check):
    try:
        check()
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_head_major_kernels_accept_what_supports_admits(dtype, jdtype):
    """C-G: the port's check against ``supports`` / ``dense_bias_supported``
    at lengths they take (256 x 256)."""
    for d in HEAD_DIMS:
        q = np.zeros((1, 1, 256, d), np.float32)
        want = jfa.supports(q, q, q)
        assert want == jfa.dense_bias_supported(q, q, np.zeros((1, 1, 256, 256)))
        assert _accepts(lambda: tfa.check_kernel_args("flash", dtype, d, 512)) == want, d


@pytest.mark.parametrize("dtype,jdtype", [(torch.bfloat16, jnp.bfloat16),
                                          (torch.float32, jnp.float32)])
def test_token_major_kernels_accept_what_their_predicates_admit(dtype, jdtype):
    """A and B: ``rope_fused_supports`` / ``fused_supports`` with one head
    and aligned lengths, so that only the head dim and dtype decide."""
    for d in HEAD_DIMS:
        want_b = jfa.fused_supports(64, 64, 1, d, jdtype)
        want_a = jfa.rope_fused_supports(64, 1, d, jdtype)
        assert _accepts(lambda: tfa._split_heads("B", d, 1, dtype, 8)) == want_b, d
        assert _accepts(lambda: tfa._split_heads("A", d, 1, dtype, 16)) == want_a, d


def test_fp16_and_other_dtypes_raise():
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="bf16 or f32"):
            tfa.check_kernel_args("flash", dtype, 64, 512)
        with pytest.raises(ValueError, match="bf16 or f32"):
            tfa._split_heads("B", 128, 2, dtype, 8)


def test_widths_that_do_not_split_over_the_heads_raise():
    with pytest.raises(ValueError, match="split"):
        tfa._split_heads("B", 100, 3, torch.bfloat16, 8)


@pytest.mark.parametrize("shape,perm,readable", [
    # contiguous head-major
    ((2, 4, 100, 64), None, True),
    # a head-major view of token-major [B, L, H, d]: read in place
    ((2, 100, 4, 64), (0, 2, 1, 3), True),
    # the last dim not contiguous
    ((2, 4, 64, 100), (0, 1, 3, 2), False),
    # a row stride of 36 elements (72 bytes): not a multiple of 16 bytes
    ((2, 4, 100, 36), None, False),
])
def test_tma_strides(shape, perm, readable):
    """The Hopper kernel's tensor maps read a view in place when its last
    stride is 1 and the others are multiples of 8 elements (16 bytes);
    other layouts are copied first."""
    t = torch.zeros(shape, dtype=torch.bfloat16)
    if perm is not None:
        t = t.permute(*perm)
    got = tfa._tma_strides(t)
    assert (got is not None) == readable
    if readable:
        assert got == (t.stride(0), t.stride(1), t.stride(2))


def test_a_size_one_dimension_gets_a_stride_tma_accepts():
    """A view whose size-1 dims carry strides TMA refuses (here 1 and 3
    elements) still maps: those strides are never stepped."""
    t = torch.zeros(1, 3, 64, dtype=torch.bfloat16).unsqueeze(2)
    t = t.as_strided((1, 3, 1, 64), (3, 64, 1, 1))
    sb, sh, sl = tfa._tma_strides(t)
    assert (sb, sh, sl) == (3 * 64, 64, 64)


@pytest.mark.parametrize("b,length,heads,d", [
    (2, 832, 32, 64),   # the DiT's queries
    (1, 256, 32, 64),   # batch 1: the caption of one prompt
    (3, 1, 32, 64),     # one token per sample
    (1, 1, 16, 128),    # both
    (8, 480, 16, 128),
    (2, 77, 1, 64),     # one head
    (1, 1, 1, 128),
])
def test_token_major_strides(b, length, heads, d):
    """The strides the Hopper B's tensor maps read a token-major [B, L,
    H*d] tensor with, computed from its shape: those :func:`_tma_strides`
    gives its head-major view, (L*C, d, C) where no dimension is 1."""
    c = heads * d
    t = torch.zeros(b, length, c, dtype=torch.bfloat16)
    view = t.view(b, length, heads, d).transpose(1, 2)
    strides = tfa.token_major_strides(b, length, c, heads)
    assert strides == tfa._tma_strides(view)
    for i in range(3):
        if view.shape[i] > 1:
            assert strides[i] == view.stride(i)
