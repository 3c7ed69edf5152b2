"""The port's attention gradients against the JAX package's, on the CPU, in
f32.

- The plain version of the flash backward (``_flash_backward_plain``, what
  ``csrc/flash_backward.cu`` computes) against the JAX ``_flash_backward``
  Pallas kernels in interpret mode, fed the same O and lse from each of the
  reference's forward kernels (bounded ``_fwd_kernel_bounded``, online
  ``_fwd_kernel``, whole-row ``_fwd_kernel_single``), with and without a
  mask, a fully masked batch row and ragged lengths.
- Gradients of the port's three differentiable attention entries
  (``rope_fused_attention``, ``fused_token_attention``, ``flash_attention``)
  against ``jax.vjp`` of the JAX functions. The token-major entries' JAX
  backward recomputes through its Pallas flash kernels only on a TPU
  backend; the tests patch ``avatar_tpu.ops.attention.tpu_backend`` true for
  that route and leave it for the XLA recompute, at lengths on both sides
  of the ``lq * lk >= 128 * 128`` rule. The port takes the same route on
  either device, by that rule alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.ops import attention as jattn
from avatar_tpu.ops import flash_attention as jfa
from avatar_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

# f32 against f32: the same products summed in another order (blocks of
# 128 against whole rows) and exp/log an ulp apart, on gradients of O(1-10);
# the JAX package's own kernel tests hold the forward to 2e-5
ATOL, RTOL = 5e-5, 1e-5
B, H, D = 2, 2, 32
SCALE = D**-0.5  # not a power of two: multiplies the f32 logits


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rows(rng, *shape):
    """rms-normed rows, as after the DiT's qk-norm"""
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.sqrt((x * x).mean(-1, keepdims=True))


def _mask(kind, lk, b=B, seed=3):
    if kind == "none":
        return None
    mask = (np.random.default_rng(seed).random((b, lk)) > 0.3).astype(np.float32)
    if kind == "masked_row":
        mask[1] = 0.0  # every key of sample 1 masked: lse 1e30, zero gradients
    return mask


def _close(out, ref, what):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=ATOL, rtol=RTOL,
                               err_msg=what)


# (lq, lk, reference forward block, bounded): 128-row blocks send lengths
# above 128 to the blocked kernels, 1024-row ones to the whole-row kernel
FORWARDS = {
    "bounded (C)": (200, 333, 128, True),
    "online (D)": (200, 333, 128, False),
    "single (E)": (256, 256, 1024, False),
}


@pytest.mark.parametrize("mask_kind", ["none", "masked_row"])
@pytest.mark.parametrize("forward", list(FORWARDS))
def test_backward_plain_version_matches_jax_kernels(forward, mask_kind):
    lq, lk, block, bounded = FORWARDS[forward]
    rng = np.random.default_rng(0)
    q, k = _rows(rng, B, H, lq, D), _rows(rng, B, H, lk, D)
    v = rng.standard_normal((B, H, lk, D)).astype(np.float32)
    g = rng.standard_normal((B, H, lq, D)).astype(np.float32)
    mask = _mask(mask_kind, lk)
    jmask = None if mask is None else jnp.asarray(mask)
    out, lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
                                  SCALE, block, block, with_lse=True, bounded=bounded)
    ref = jfa._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, out,
                              lse, jnp.asarray(g), SCALE, 128, 128)
    lse_t = _t(np.asarray(lse)[:, 0, :lq].reshape(B, H, lq))
    got = tfa._flash_backward_plain(_t(q), _t(k), _t(v), None if mask is None else _t(mask),
                                    _t(out), lse_t, _t(g), SCALE)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _close(a, b, f"{forward} {mask_kind} {name}")
    if mask_kind == "masked_row":
        assert all(bool((x[1] == 0).all()) for x in got)


def _vjp(fn, args, g):
    out, pull = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return np.asarray(out), [np.asarray(x) for x in pull(jnp.asarray(g))]


def _grads(fn, args, g):
    leaves = [_t(a).requires_grad_() for a in args]
    out = fn(*leaves)
    return out.detach().numpy(), [x.numpy() for x in torch.autograd.grad(out, leaves, _t(g))]


@pytest.fixture(params=["xla recompute", "pallas recompute"])
def recompute(request, monkeypatch):
    if request.param == "pallas recompute":
        monkeypatch.setattr(jattn, "tpu_backend", lambda: True)
    return request.param


@pytest.mark.parametrize("length", [64, 128])  # L * L below / at 128 * 128
def test_rope_fused_attention_gradients_match_jax(recompute, length):
    rng = np.random.default_rng(1)
    c = H * D
    q, k = _rows(rng, B, length, c), _rows(rng, B, length, c)
    v, g = (rng.standard_normal((B, length, c)).astype(np.float32) for _ in range(2))
    ang = rng.random((B, length, c // 2)).astype(np.float32) * 6.0
    cos, sin = np.cos(ang), np.sin(ang)
    assert tfa.rope_fused_supports(length, H, D, torch.float32)
    ref_out, ref = _vjp(lambda a, b, c_: jfa.rope_fused_attention(
        a, b, c_, jnp.asarray(cos), jnp.asarray(sin), H, SCALE, True), (q, k, v), g)
    out, got = _grads(lambda a, b, c_: tfa.rope_fused_attention(
        a, b, c_, _t(cos), _t(sin), H, SCALE, True), (q, k, v), g)
    _close(out, ref_out, "out")
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _close(a, b, f"{recompute} L={length} {name}")


@pytest.mark.parametrize("lk", [64, 128])  # 128 * lk below / at 128 * 128
def test_fused_token_attention_gradients_match_jax(recompute, lk):
    rng = np.random.default_rng(2)
    c, lq = H * D, 128
    q, k = _rows(rng, B, lq, c), _rows(rng, B, lk, c)
    v = rng.standard_normal((B, lk, c)).astype(np.float32)
    g = rng.standard_normal((B, lq, c)).astype(np.float32)
    mask = _mask("masked", lk)  # no fully masked row: there the routes differ
    ref_out, ref = _vjp(lambda a, b, c_: jfa.fused_token_attention(
        a, b, c_, jnp.asarray(mask), H, SCALE, True), (q, k, v), g)
    out, got = _grads(lambda a, b, c_: tfa.fused_token_attention(
        a, b, c_, _t(mask), H, SCALE, True), (q, k, v), g)
    _close(out, ref_out, "out")
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _close(a, b, f"{recompute} lk={lk} {name}")


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("mask_kind", ["none", "masked_row"])
def test_flash_attention_gradients_match_jax(mask_kind, bounded):
    """The forward at 1100 keys takes the blocked kernels (C when bounded,
    D else) on both sides; each custom VJP then runs its flash backward."""
    rng = np.random.default_rng(3)
    lq, lk = 136, 1100
    b = 1 + (mask_kind != "none")  # the masked row is sample 1
    q, k = _rows(rng, b, H, lq, D), _rows(rng, b, H, lk, D)
    v = rng.standard_normal((b, H, lk, D)).astype(np.float32)
    g = rng.standard_normal((b, H, lq, D)).astype(np.float32)
    mask = _mask(mask_kind, lk, b=b)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    ref_out, ref = _vjp(lambda a, b_, c_: jfa.flash_attention(
        a, b_, c_, kv_mask=jm, scale=SCALE, bounded_logits=bounded), (q, k, v), g)
    assert tfa.flash_mode(lq, lk, bounded) == ("bounded" if bounded else "online")
    out, got = _grads(lambda a, b_, c_: tfa.flash_attention(
        a, b_, c_, kv_mask=tm, scale=SCALE, bounded_logits=bounded), (q, k, v), g)
    _close(out, ref_out, "out")
    for name, a, b_ in zip(("dq", "dk", "dv"), got, ref):
        _close(a, b_, f"{mask_kind} bounded={bounded} {name}")


def test_power_of_two_scale_gradient_is_the_callers():
    """head_dim 64's scale 0.125 is folded into q inside the forward; dq
    must still be the gradient with respect to the caller's q."""
    rng = np.random.default_rng(4)
    q, k = _rows(rng, 1, 2, 130, 64), _rows(rng, 1, 2, 140, 64)
    v, g = rng.standard_normal((1, 2, 140, 64)), rng.standard_normal((1, 2, 130, 64))
    args = [_t(a).double().requires_grad_() for a in (q, k, v)]

    def plain(q_, k_, v_):
        return torch.softmax(q_ @ k_.transpose(-1, -2) * 0.125, -1) @ v_

    ref = torch.autograd.grad(plain(*args), args, _t(g).double())
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*leaves), leaves, _t(g))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.double(), b, atol=ATOL, rtol=RTOL)


def test_no_grad_saves_nothing_and_grad_takes_the_function():
    rng = np.random.default_rng(5)
    q, k, v = (_t(_rows(rng, 1, 2, 64, 16)) for _ in range(3))
    out = tfa.flash_attention(q, k, v)
    assert out.grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v).grad_fn is None
    assert type(tfa.flash_attention(q, k, v).grad_fn).__name__ == "_FlashFnBackward"
    c = torch.ones(1, 64, 16)
    assert type(tfa.rope_fused_attention(
        q.reshape(1, 64, 32), k.reshape(1, 64, 32), v.reshape(1, 64, 32), c, 0 * c,
        2, 0.25).grad_fn).__name__ == "_RopeFusedFnBackward"
    assert type(tfa.fused_token_attention(
        q.reshape(1, 64, 32), k.reshape(1, 64, 32), v.reshape(1, 64, 32), None,
        2, 0.25).grad_fn).__name__ == "_FusedTokenFnBackward"


def test_int8_kernels_refuse_inputs_that_require_grad():
    from avatar_tpu_torch.ops import int8_matmul as i8

    x = torch.randn(4, 32, requires_grad=True)
    for call in (lambda: i8.quantize_rows_pallas(x),
                 lambda: i8.fused_act_quant(x.reshape(1, 4, 32)),
                 lambda: i8.fused_rms_mod_quant(x.reshape(1, 4, 32), torch.ones(1, 1, 32),
                                                None)):
        with pytest.raises(RuntimeError, match="no gradient"):
            call()
    with torch.no_grad():
        q, s = i8.quantize_rows_pallas(x)
    w = torch.randint(-127, 128, (16, 32), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="no gradient"):
        i8.w8a8_matmul(q, s, w, torch.ones(16, requires_grad=True))
