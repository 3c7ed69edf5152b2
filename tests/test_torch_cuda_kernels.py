"""The port's CUDA attention kernels against their plain PyTorch versions,
on the card. Marked ``cuda``; they skip where there is no CUDA device. Run
them on a card with
``python -m pytest tests/test_torch_cuda_kernels.py --noconftest`` (the
shared conftest imports JAX, which the card's machine need not have)."""

import pytest
import torch

from avatar_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

HEADS, HD = 4, 64
# bf16 outputs of O(1); see chip_smoke.py's KERNEL_TOL
TOL = 1e-2


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


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    q = _rows(gen, 1, 64, HEADS * HD)
    with pytest.raises(ValueError):
        fa.fused_token_attention(q.float(), q.float(), q.float(), None, HEADS, 0.1)
    with pytest.raises(ValueError):  # head_dim 32
        fa.fused_token_attention(q, q, q, None, 2 * HEADS, 0.1)
    with pytest.raises(ValueError):  # not contiguous
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        fa.fused_token_attention(qt, qt, qt, None, HEADS, 0.1)
    with pytest.raises(ValueError):  # the mask must be f32 on the card
        fa.fused_token_attention(q, q, q, torch.ones(1, 64, device="cuda",
                                                     dtype=torch.bool), HEADS, 0.1)
