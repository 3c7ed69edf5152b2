"""The plain versions of the head-major kernels C, D and E against the JAX
package's ``_flash_forward`` Pallas kernels in interpret mode at head dims
32, 128 and 256 (``tests/test_torch_flash.py`` holds 32 at other shapes and
64), in f32 and in bf16. In bf16 the bounded kernel's l follows the
reference's ``fuse_l = d < 128``: the sum of the p rounded to bf16 below
128, of the f32 p from 128 on; its lse is compared tightly enough to tell
the two rules apart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.ops import flash_attention as jfa
from avatar_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

B, H = 2, 2
# f32: the same products summed in another order (blocks of 128 keys
# against one whole row), as tests/test_torch_flash.py
ATOL = 2e-5
# bf16 lse of the bounded mode, row by row: both sides round the same p to
# bf16 and sum in f32 in another order, so most rows agree to an f32 ulp
# (median 0, 99th percentile 4.8e-7 measured); a logit that differs in its
# last bit between the two products can move one p across a bf16 rounding
# boundary, one ulp of p (5.6e-5 on one row of 1,024 measured at d = 64).
# The sum rule not taken at the head dim moves the median row by 9e-5 to
# 1.2e-4 (measured; each case checks that it would miss).
LSE_MEDIAN_ATOL = 1e-6
LSE_P99_ATOL = 2e-5
LSE_MAX_ATOL = 2e-4


def _inputs(lq, lk, d, seed):
    rng = np.random.default_rng(seed)

    def rows(n):  # rms-normed rows, as after the DiT's qk-norm
        x = rng.standard_normal((B, H, n, d)).astype(np.float32)
        return x / np.sqrt((x * x).mean(-1, keepdims=True))

    mask = (rng.random((B, lk)) > 0.3).astype(np.float32)
    mask[1] = 0.0  # every key of sample 1 masked
    return rows(lq), rows(lk), rng.standard_normal((B, H, lk, d)).astype(np.float32), mask


def _reference(q, k, v, mask, scale, block, bounded, dtype=jnp.float32):
    out, lse = jfa._flash_forward(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(mask), scale, block, block, with_lse=True, bounded=bounded)
    lq = q.shape[2]
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(lse)[:, 0, :lq].reshape(B, H, lq))


@pytest.mark.parametrize("d", [32, 128, 256])
@pytest.mark.parametrize("mode", ["bounded", "online", "single"])
def test_plain_versions_match_jax_kernels_at_head_dims(mode, d):
    """f32, ragged lengths, a partly and a fully masked sample; blocks of
    128 for the blocked modes, the default 1024 for the whole-row one."""
    lq, lk = (200, 333) if mode != "single" else (100, 77)
    q, k, v, mask = _inputs(lq, lk, d, seed=d)
    scale = d**-0.5
    block = 128 if mode != "single" else 1024
    ref_out, ref_lse = _reference(q, k, v, mask, scale, block, mode == "bounded")
    out, lse = tfa._flash_plain(*(torch.from_numpy(a) for a in (q, k, v, mask)), scale,
                                mode)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=ATOL, rtol=1e-6)
    assert np.all(out.numpy()[1] == 0.0)
    assert np.all(lse.numpy()[1] == np.float32(tfa.LSE_MASKED))


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_bf16_sum_rule_follows_fuse_l(d):
    """The bounded mode in bf16: output within one bf16 ulp of the
    reference's and lse row by row within the LSE_* limits, where the rule
    not taken at this head dim would miss in the median row."""
    q, k, v, mask = _inputs(256, 300, d, seed=7 + d)
    mask[1] = 1.0  # no empty sample: every row's lse is compared
    scale = 2.0 ** -np.ceil(np.log2(d) / 2)  # a power of two: folded on both sides
    ref_out, ref_lse = _reference(q, k, v, mask, scale, 128, True, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tq = tq * scale
    out, lse = tfa._flash_plain(tq, tk, tv, torch.from_numpy(mask), 1.0, "bounded")
    np.testing.assert_allclose(out.float().numpy(), ref_out,
                               atol=2.0**-8 * np.abs(ref_out).max())
    err = np.abs(lse.numpy() - ref_lse)
    assert np.median(err) <= LSE_MEDIAN_ATOL
    assert np.percentile(err, 99) <= LSE_P99_ATOL and err.max() <= LSE_MAX_ATOL
    # the other rule: l over the f32 p below 128, over the rounded p from 128
    s = torch.einsum("bhqd,bhkd->bhqk", tq.float(), tk.float())
    p = torch.exp(torch.clamp(s, max=tfa.BOUNDED_LOGIT_CLAMP))
    p = p * (torch.from_numpy(mask) > 0.5)[:, None, None, :]
    other = p if d < 128 else p.bfloat16().float()
    lse_other = torch.log(other.sum(-1)).numpy()
    assert np.median(np.abs(lse_other - ref_lse)) > LSE_P99_ATOL
