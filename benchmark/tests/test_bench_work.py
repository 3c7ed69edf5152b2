"""The frozen arithmetic against counts made by hand."""

import pytest
import torch

from benchmark import work
from tiny import VAE

LTX = {"num_attention_heads": 32, "attention_head_dim": 64, "in_channels": 128,
       "out_channels": 128, "num_layers": 28, "caption_channels": 4096}


def test_a_rope_attention_at_832_tokens():
    ops, nbytes = work.rope_work(1, 832, 2048)
    assert ops == 4 * 832 * 832 * 2048 == 5_670_699_008
    assert nbytes == (4 * 832 * 2048 + 2 * 832 * 1024) * 2 == 17_039_360


def test_c_flash_forward_at_5376_tokens():
    ops, nbytes = work.attention_work(1, 32, 5376, 5376, 64)
    assert ops == 236_760_072_192
    assert nbytes == 88_080_384 + 688_128


def test_f_flash_backward_at_the_training_shape():
    dkv, dq, dkv_bytes, dq_bytes = work.attention_backward_work(8, 32, 480, 480, 64)
    assert dkv == 4 * 7_549_747_200 and dq == 3 * 7_549_747_200
    reads = (2 * 8 * 32 * 480 * 64 + 2 * 32 * 3840 * 64) * 2 + 2 * 8 * 32 * 480 * 4
    assert dkv_bytes == reads + 2 * 8 * 32 * 480 * 64 * 2
    assert dq_bytes == reads + 8 * 32 * 480 * 64 * 2


def test_h_w8a8_matmul_ff_in_at_5376_tokens():
    ops, nbytes = work.w8a8_matmul_work(5376, 2048, 8192)
    assert ops == 180_388_626_432
    assert nbytes == 5376 * 2048 + 4 * 5376 + 8192 * 2048 + 4 * 8192 + 2 * 8192 + 2 * 5376 * 8192


def test_dit_operations_a_token():
    n = 1000
    w = work.dit_forward_work(LTX, 1, n, 256, 0.0, False, None)
    attention = 28 * 4.0 * 32 * n * n * 64
    per_token = 28 * 2 * (6 * 2048**2 + 2 * 2048 * 8192) + 2 * 2 * 128 * 2048
    assert per_token == 3_289_382_912
    assert w.ops["bf16"] - attention == pytest.approx(per_token * n, rel=1e-12)
    assert w.ops["int8"] == 0
    q = work.dit_forward_work(LTX, 1, n, 256, 0.0, True, (989e12, 3.35e12, 1979e12))
    assert q.ops["int8"] == 28 * 2.0 * n * (6 * 2048**2 + 2 * 2048 * 8192)
    assert q.least["int8"] > 0 and q.least["attention"] > 0


def test_least_time_is_the_larger_bound():
    assert work.least_s(2e12, 1e9, 1e12, 1e12) == 2.0
    assert work.least_s(1e9, 3e12, 1e12, 1e12) == 3.0
    assert work.peaks_for("NVIDIA H100 80GB HBM3")[0] == 989e12
    assert work.peaks_for("some other card") is None


class Counting:
    """Runs the reference's convolutions for real and counts them."""

    def __init__(self):
        self.ops = 0.0

    def conv3d(self, p, x, stride, padding):
        out = torch.nn.functional.conv3d(x, p["weight"].float(), stride=stride, padding=padding)
        n, cin, kt, kh, kw = p["weight"].shape
        self.ops += 2.0 * out[:, 0].numel() * n * cin * kt * kh * kw
        b = p.get("bias")
        return out if b is None else out + b.float().reshape(1, -1, 1, 1, 1)

    def linear(self, p, x, int8_site=False):
        out = x @ p["weight"].float().t()
        return out if p.get("bias") is None else out + p["bias"].float()


def test_vae_work_on_meta_counts_the_convolutions_the_reference_runs():
    from avatar_tpu_torch.models.vae import VAEConfig, init_vae
    from benchmark.reference import ltxv

    params = init_vae(VAEConfig.from_dict(VAE), seed=0, device="cpu")
    media, lat = (1, 9, 32, 32, 3), (1, 3, 4, 4, 16)
    w = work.vae_work(params, VAE, [media], lat, None, None)
    count = Counting()
    with torch.no_grad():
        ltxv.vae_encode(params, VAE, torch.zeros(media), torch.zeros(lat), count)
        ltxv.vae_decode(params, VAE, torch.zeros(lat), torch.zeros(1), count)
    assert w.ops["bf16"] == pytest.approx(count.ops, rel=1e-12) and count.ops > 0
