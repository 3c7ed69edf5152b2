"""The port's head-major flash attention against the JAX package's
``_flash_forward`` kernels, on the CPU, in f32: output and row
log-sum-exp.

The JAX side runs its Pallas kernels in interpret mode with 128-row blocks
(as ``tests/test_ops.py`` does), which sends lengths above 128 to the
blocked kernels (``_fwd_kernel_bounded`` / ``_fwd_kernel``); with the
default 1024-row blocks the same lengths reach the whole-row kernel
(``_fwd_kernel_single``). The port's side runs the plain version of each
kernel, and its own dispatch through ``flash_attention``. The reference
returns lse padded, as [B*H, 1, Lq_pad]; the tests slice it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.ops import attention as jattn
from avatar_tpu.ops import flash_attention as jfa
from avatar_tpu_torch.ops import attention as tattn
from avatar_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

# f32: same products, another summation order (blocks of 128 keys against
# one whole row) -> ~1e-6; the JAX package's own kernel tests use 2e-5
ATOL = 2e-5
B, H, D = 2, 2, 32
SCALE = D**-0.5  # not a power of two: multiplies the f32 logits


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _qkv(lq, lk, seed=0):
    rng = np.random.default_rng(seed)

    def rows(n):  # rms-normed rows, as after the DiT's qk-norm
        x = rng.standard_normal((B, H, n, D)).astype(np.float32)
        return x / np.sqrt((x * x).mean(-1, keepdims=True))

    return rows(lq), rows(lk), rng.standard_normal((B, H, lk, D)).astype(np.float32)


def _mask(kind, lk, seed=3):
    if kind == "none":
        return None
    mask = (np.random.default_rng(seed).random((B, lk)) > 0.3).astype(np.float32)
    if kind == "masked_row":
        mask[1] = 0.0  # every key of sample 1 masked
    return mask


def _reference(q, k, v, mask, scale, block, bounded):
    out, lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), scale, block, block,
        with_lse=True, bounded=bounded)
    lq = q.shape[2]
    return np.asarray(out), np.asarray(lse)[:, 0, :lq].reshape(B, H, lq)


def _check(out, lse, ref_out, ref_lse, mask_kind):
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=1e-6)
    if mask_kind == "masked_row":
        assert np.all(out.numpy()[1] == 0.0)
        assert np.all(lse.numpy()[1] == np.float32(tfa.LSE_MASKED))


@pytest.mark.parametrize("mask_kind", ["none", "masked", "masked_row"])
@pytest.mark.parametrize("lq,lk", [(256, 256), (200, 333)])
@pytest.mark.parametrize("mode", ["bounded", "online"])
def test_blocked_plain_versions_match_jax_kernels(mode, lq, lk, mask_kind):
    q, k, v = _qkv(lq, lk)
    mask = _mask(mask_kind, lk)
    ref_out, ref_lse = _reference(q, k, v, mask, SCALE, 128, mode == "bounded")
    out, lse = tfa._flash_plain(_t(q), _t(k), _t(v),
                                None if mask is None else _t(mask), SCALE, mode)
    _check(out, lse, ref_out, ref_lse, mask_kind)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "masked", "masked_row"])
@pytest.mark.parametrize("lq,lk", [(256, 256), (200, 333), (637, 637)])
def test_single_plain_version_matches_jax_kernel(lq, lk, mask_kind, bounded):
    """Both lengths fit one 1024-row block: the reference takes its
    whole-row kernel, with the row max even when ``bounded`` is set."""
    q, k, v = _qkv(lq, lk, seed=1)
    mask = _mask(mask_kind, lk)
    ref_out, ref_lse = _reference(q, k, v, mask, SCALE, 1024, bounded)
    assert tfa.flash_mode(lq, lk, bounded) == "single"
    out, lse = tfa._flash_plain(_t(q), _t(k), _t(v),
                                None if mask is None else _t(mask), SCALE, "single")
    _check(out, lse, ref_out, ref_lse, mask_kind)


@pytest.mark.parametrize("lq,lk,bounded,mode", [
    (1024, 1024, True, "single"), (1025, 64, True, "bounded"),
    (64, 1025, False, "online"), (5376, 5376, True, "bounded"),
    (5376, 256, False, "online"), (637, 637, False, "single"),
])
def test_dispatch_follows_the_reference(lq, lk, bounded, mode):
    """``flash_mode`` against the block counts the reference's
    ``_pad_inputs`` arrives at with its default 1024-row blocks."""
    assert tfa.flash_mode(lq, lk, bounded) == mode
    bq = jfa._pick_block(lq, jfa.DEFAULT_BLOCK_Q)
    bk = jfa._pick_block(lk, jfa.DEFAULT_BLOCK_KV)
    one_block = jfa._round_up(lq, bq) == bq and jfa._round_up(lk, bk) == bk
    assert one_block == (mode == "single")


@pytest.mark.parametrize("bounded", [True, False])
def test_flash_attention_folds_a_power_of_two_scale(bounded):
    """head_dim 64 gives scale 0.125, which both sides fold into q; a long
    kv (> 1024) sends the port's own dispatch to the blocked kernels."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 2, 136, 64)).astype(np.float32)
    k = rng.standard_normal((1, 2, 1100, 64)).astype(np.float32) * 0.3
    v = rng.standard_normal((1, 2, 1100, 64)).astype(np.float32)
    mask = (rng.random((1, 1100)) > 0.2).astype(np.float32)
    ref_out, ref_lse = jfa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), 0.125,
        1024, 1024, with_lse=True, bounded=bounded)
    out, lse = tfa.flash_attention(_t(q), _t(k), _t(v), kv_mask=_t(mask),
                                   bounded_logits=bounded, with_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL)
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(ref_lse)[:, 0, :136].reshape(1, 2, 136), atol=ATOL)


def test_flash_attention_bias_forms():
    q, k, v = (_t(a) for a in _qkv(130, 140, seed=5))
    mask = _t(_mask("masked", 140))
    ref = tfa.flash_attention(q, k, v, kv_mask=mask, scale=SCALE)
    # a per-key additive bias becomes a keep-mask (bias >= -1 keeps)
    out = tfa.flash_attention(q, k, v, bias=tattn.mask_to_bias(mask, 4), scale=SCALE)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    # a dense bias takes the dense-bias path (its plain version here): -1e30
    # on the masked keys gives what the keep-mask path gives
    dense = torch.where(mask > 0.5, 0.0, -1e30)[:, None, None, :].expand(B, 1, 130, 140)
    assert tfa.dense_bias_supported(q, k, dense)
    out = tfa.flash_attention(q, k, v, bias=dense, scale=SCALE)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "flash", "auto"])
@pytest.mark.parametrize("lq,lk", [(32, 24), (160, 150)])
def test_scaled_dot_product_attention_matches_jax(impl, lq, lk):
    """Against the JAX dispatcher: "xla" vs "xla"; the port's "flash" and
    "auto" (kernel path where ``supports`` holds, on any device) vs the
    reference's "flash" at the large shape and "xla" at the small one,
    where "auto" keeps away from the kernels. The mask has no fully masked
    row, which is where the two paths differ."""
    q, k, v = _qkv(lq, lk, seed=6)
    mask = _mask("masked", lk)
    kernel_path = impl == "flash" or (impl == "auto" and lq * lk >= 128 * 128)
    assert tfa.supports(_t(q), _t(k), _t(v)) == (lq * lk >= 128 * 128)
    ref = jattn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask),
        impl="flash" if kernel_path else "xla", bounded_logits=True)
    out = tattn.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), mask=_t(mask), impl=impl, bounded_logits=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_scaled_dot_product_attention_masked_row_split():
    """A row whose keys are all masked: "xla" gives ordinary attention (the
    same -1e4 on every key), the kernel path gives 0."""
    q, k, v = (_t(a) for a in _qkv(130, 140, seed=7))
    mask = _t(_mask("masked_row", 140))
    flash = tattn.scaled_dot_product_attention(q, k, v, mask=mask, impl="flash")
    xla = tattn.scaled_dot_product_attention(q, k, v, mask=mask, impl="xla")
    assert bool((flash[1] == 0).all())
    # s - 1e4 keeps s only to f32's ulp at 1e4 (~1e-3)
    torch.testing.assert_close(
        xla[1], tattn.xla_attention(q[1:], k[1:], v[1:])[0], atol=2e-3, rtol=0)
    torch.testing.assert_close(flash[0], xla[0], atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        tattn.scaled_dot_product_attention(q, k, v, impl="pallas")
