"""The port's dense-bias flash attention (kernel G's plain versions, what
``csrc/flash_dense.cu`` computes) against the JAX package's
``flash_attention(bias=...)`` on the CPU, in f32, with the Pallas kernels in
interpret mode and 128-row blocks, as ``tests/test_ops.py::TestDenseBiasFlash``
runs them: the forward and lse, per-head and shared biases, -1e30 biases
against the keep-mask route, ragged lengths, the gradients of q, k, v and
the bias, the dispatch through ``scaled_dot_product_attention``, the routing
predicate and the launch counters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.ops import attention as jattn
from avatar_tpu.ops import flash_attention as jfa
from avatar_tpu_torch.ops import attention as tattn
from avatar_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

# the JAX package's own tolerances for this kernel (tests/test_ops.py):
# f32 sums over 128-key blocks with a running max against whole rows
FWD_ATOL, GRAD_ATOL = 3e-5, 2e-4
B, H, D = 2, 2, 32
BLOCK = 128


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _qkv(rng, lq=256, lk=192, b=B):
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, H, lq, D), (b, H, lk, D), (b, H, lk, D)))


def _jax_flash(q, k, v, bias):
    return np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          bias=jnp.asarray(bias), block_q=BLOCK,
                                          block_kv=BLOCK))


@pytest.mark.parametrize("lq,lk", [(256, 192), (250, 130)], ids=["256x192", "ragged"])
@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
def test_forward_and_lse_match_jax_kernel(per_head, lq, lk):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, lq, lk)
    bias = rng.standard_normal((B, H if per_head else 1, lq, lk)).astype(np.float32)
    ref = _jax_flash(q, k, v, bias)
    out, lse = tfa.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias), with_lse=True)
    np.testing.assert_allclose(out.numpy(), ref, atol=FWD_ATOL)
    bias3 = jnp.asarray(bias[:, 0] if not per_head else bias.reshape(B * H, lq, lk))
    _, ref_lse = jfa._flash_dense_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          bias3, D**-0.5, BLOCK, BLOCK, return_lse=True)
    ref_lse = np.asarray(ref_lse)[:, 0, :lq].reshape(B, H, lq)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=FWD_ATOL)


def test_neg_inf_bias_matches_keep_mask_route():
    """A -1e30 bias gives what the keep-mask route gives, and a batch row
    whose keys are all masked gives 0 (lse 1e30) on both, as the JAX kernel
    does."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng)
    keep = (rng.random((B, 192)) > 0.4).astype(np.float32)
    keep[1] = 0.0
    bias = (np.where(keep[:, None, None, :] > 0.5, 0.0, -1e30)
            * np.ones((B, 1, 256, 1))).astype(np.float32)
    out, lse = tfa.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias), with_lse=True)
    by_mask = tfa.flash_attention(_t(q), _t(k), _t(v), kv_mask=_t(keep))
    np.testing.assert_allclose(out.numpy(), by_mask.numpy(), atol=FWD_ATOL)
    np.testing.assert_allclose(out.numpy(), _jax_flash(q, k, v, bias), atol=FWD_ATOL)
    assert bool((out[1] == 0).all()) and bool((lse[1] == tfa.LSE_MASKED).all())
    assert np.isfinite(out.numpy()).all()


def _loss_grads_jax(q, k, v, bias):
    def loss(q_, k_, v_, b_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, bias=b_, block_q=BLOCK,
                                           block_kv=BLOCK) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))


@pytest.mark.parametrize("per_head,lq,lk", [
    (True, 128, 128),
    (False, 128, 128),   # shared bias: dBias sums the heads
    (False, 250, 130),   # ragged: the edges must not leak into dBias
    (True, 256, 192),
], ids=["per_head", "shared", "ragged_shared", "per_head_256x192"])
def test_gradients_match_jax(per_head, lq, lk):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, lq, lk)
    bias = rng.standard_normal((B, H if per_head else 1, lq, lk)).astype(np.float32)
    ref = _loss_grads_jax(q, k, v, bias)
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    tfa.reset_launch_counts()
    out = tfa.flash_attention(*leaves[:3], bias=leaves[3])
    got = torch.autograd.grad(out.pow(2).sum(), leaves)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, err_msg=name)
    assert not any(tfa.launch_counts.values())


def test_backward_plain_version_matches_jax_kernels():
    """The three backward kernels' plain version against the Pallas
    dK/dV, dQ and dBias kernels fed the same O and lse, a shared bias with a
    fully masked query row."""
    rng = np.random.default_rng(3)
    lq, lk = 200, 160
    q, k, v = _qkv(rng, lq, lk)
    g = rng.standard_normal(q.shape).astype(np.float32)
    bias3 = rng.standard_normal((B, lq, lk)).astype(np.float32)
    bias3[1, 7] = -1e30
    jq, jk, jv, jb = (jnp.asarray(a) for a in (q, k, v, bias3))
    out, lse = jfa._flash_dense_forward(jq, jk, jv, jb, D**-0.5, BLOCK, BLOCK,
                                        return_lse=True)
    ref = jfa._flash_dense_backward(jq, jk, jv, jb, out, lse, jnp.asarray(g), D**-0.5,
                                    BLOCK, BLOCK)
    lse_t = _t(np.asarray(lse)[:, 0, :lq].reshape(B, H, lq))
    got = tfa._flash_dense_backward_plain(_t(q), _t(k), _t(v), _t(bias3),
                                          _t(np.asarray(out)), lse_t, _t(g), D**-0.5)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL, err_msg=name)
    assert bool((got[0][1, :, 7] == 0).all()) and bool((got[3][1, 7] == 0).all())


def test_broadcast_bias_gradient_sums_outside():
    """A bias expanded over the batch (as T5 broadcasts its position bias)
    runs the kernel path on a copy, and autograd sums dBias over the
    broadcast: the same gradient as the JAX package's for the [1, H] bias."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 128, 128)
    base = rng.standard_normal((1, H, 128, 128)).astype(np.float32)
    ref = _loss_grads_jax(q, k, v, np.broadcast_to(base, (B, H, 128, 128)))
    leaf = _t(base).requires_grad_()
    out = tfa.flash_attention(_t(q), _t(k), _t(v), bias=leaf.expand(B, H, 128, 128))
    (dbias,) = torch.autograd.grad(out.pow(2).sum(), [leaf])
    np.testing.assert_allclose(dbias.numpy(), np.asarray(ref[3]).sum(0, keepdims=True),
                               atol=GRAD_ATOL)


def test_unsupported_bias_takes_xla_attention():
    """A bias the dense kernels do not take ([1, H, Lq, Lk] under batch 2)
    goes to xla_attention in both packages."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng)
    bias = rng.standard_normal((1, H, 256, 192)).astype(np.float32)
    assert not tfa.dense_bias_supported(_t(q), _t(k), _t(bias))
    tfa.reset_launch_counts()
    out = tfa.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias))
    np.testing.assert_allclose(out.numpy(), _jax_flash(q, k, v, bias), atol=FWD_ATOL)
    with pytest.raises(ValueError, match="with_lse"):
        tfa.flash_attention(_t(q), _t(k), _t(v), bias=_t(bias), with_lse=True)


def test_via_scaled_dot_product_attention():
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng)
    bias = rng.standard_normal((B, 1, 256, 192)).astype(np.float32)
    ref = jattn.scaled_dot_product_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                             mask=jnp.asarray(bias), impl="flash")
    out = tattn.scaled_dot_product_attention(_t(q), _t(k), _t(v), mask=_t(bias),
                                             impl="flash")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL)


# (q [B, H, Lq, D], k length, bias shape)
PREDICATE_SHAPES = [
    ((2, 4, 256, 64), 192, (2, 1, 256, 192)),
    ((2, 4, 256, 64), 192, (2, 4, 256, 192)),
    ((2, 4, 256, 64), 192, (1, 4, 256, 192)),    # bias batch 1 under B = 2
    ((2, 4, 256, 64), 192, (2, 3, 256, 192)),    # 3 heads of 4
    ((2, 4, 100, 64), 100, (2, 1, 100, 100)),    # Lq * Lk < 128^2
    ((2, 4, 128, 64), 128, (2, 1, 128, 128)),    # Lq * Lk = 128^2
    ((2, 4, 256, 12), 192, (2, 1, 256, 192)),    # head_dim % 8 != 0
    ((2, 4, 256, 520), 192, (2, 1, 256, 192)),   # head_dim > 512
    ((2, 4, 256, 64), 192, (2, 1, 1, 192)),      # per-key bias
    ((2, 4, 256, 64), 192, (2, 256, 192)),       # 3-D bias
]


@pytest.mark.parametrize("q_shape,lk,bias_shape", PREDICATE_SHAPES)
def test_dense_bias_supported_matches_jax(q_shape, lk, bias_shape):
    b, h, _, d = q_shape
    args = (np.zeros(q_shape, np.float32), np.zeros((b, h, lk, d), np.float32),
            np.zeros(bias_shape, np.float32))
    want = jfa.dense_bias_supported(*(jnp.asarray(a) for a in args))
    assert tfa.dense_bias_supported(*(_t(a) for a in args)) == want


def test_launch_counters():
    """G's four counters exist and the CPU (plain versions) adds to none."""
    assert {"flash_dense_forward", "flash_dense_bwd_dkv", "flash_dense_bwd_dq",
            "flash_dense_bwd_db"} <= set(tfa.launch_counts)
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 128, 128)
    tfa.reset_launch_counts()
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    bias = _t(rng.standard_normal((B, H, 128, 128))).requires_grad_()
    out = tfa.flash_attention(*leaves, bias=bias)
    torch.autograd.grad(out.sum(), leaves + [bias])
    assert not any(tfa.launch_counts.values())
