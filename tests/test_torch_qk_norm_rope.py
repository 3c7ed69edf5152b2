"""Kernel M's plain version and its route, on the CPU.

``ops/flash_attention.py:qk_norm_rope`` (kernel M) runs self-attention's
q/k RMS norm, split-half RoPE, per-head layout and power-of-two scale in
one pass where ``models/dit.py:_attention`` would run that chain in plain
code before a head-major kernel. Its plain version is held to the JAX
package's chain (``_qk_norm``, ``apply_rotary_emb_split`` and the
head-major relayout of ``avatar_tpu/models/dit.py:_attention``); the route
is held to its conditions, and ``dit_apply`` through it to the chain bit
for bit. The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.models import dit as jdit
from avatar_tpu.ops import rope as jrope
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.ops import flash_attention as tfa
from avatar_tpu_torch.ops import rope as trope
from avatar_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

WIDTH = 256
# 5 x 16 x 16 latent tokens: above A's 6 MiB cap (1254 tokens), so the
# chain runs RoPE in plain code before C
GRID = (5, 16, 16)
TOKENS = 1280


def _jax_chain(x, w, cos, sin, heads):
    """The JAX package's q/k prologue before its head-major kernels."""
    t = jdit._qk_norm({"scale": w}, x, jdit.DiTConfig())
    t = jrope.apply_rotary_emb_split(t, (cos, sin))
    b, n, c = t.shape
    # the relayout of avatar_tpu/models/dit.py:_attention (split_to_head_major)
    t = t.reshape(b, n, 2, heads, c // heads // 2)
    return t.transpose(0, 1, 3, 2, 4).reshape(b, n, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_plain_matches_jax_chain(dtype, batch, head_dim):
    """q' and k' of the plain version against the JAX chain, with the
    softmax scale applied to q on both sides: folded into q' where it is a
    power of two (head dim 64), left for the attention otherwise. f32 to
    summation order; bf16 within 2^-6 of the largest output, since the
    JAX package rounds RoPE's products to bf16 where the port rounds once
    (ROADMAP's parity note)."""
    heads = WIDTH // head_dim
    rng = np.random.default_rng(head_dim + batch)
    x = rng.standard_normal((2, batch, 48, WIDTH)).astype(np.float32) * 3.0
    w = (1.0 + 0.2 * rng.standard_normal((2, WIDTH))).astype(np.float32)
    ang = rng.uniform(0.0, 6.3, (batch, 48, WIDTH // 2)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    scale = head_dim**-0.5
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def t(a):
        return torch.from_numpy(a).to(dtype)

    tq, tk, left = tfa.qk_norm_rope(t(x[0]), t(x[1]), t(w[0]), t(w[1]), t(cos), t(sin),
                                    heads, scale)
    assert left == (1.0 if head_dim == 64 else scale)
    jcos, jsin = jnp.asarray(cos, jdtype), jnp.asarray(sin, jdtype)
    jq, jk = (_jax_chain(jnp.asarray(x[i], jdtype), jnp.asarray(w[i], jdtype), jcos, jsin,
                         heads) for i in (0, 1))
    for out, ref in ((tq * left, jq * jnp.asarray(scale, jdtype)), (tk, jk)):
        out, ref = out.float().numpy(), np.asarray(ref, np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
        else:
            assert np.abs(out - ref).max() <= 2.0**-6 * np.abs(ref).max()


def _tiny(qk_norm="rms_norm", dtype=torch.float32):
    cfg = tdit.DiTConfig(num_attention_heads=2, attention_head_dim=64, in_channels=16,
                         out_channels=16, num_layers=1, cross_attention_dim=128,
                         caption_channels=32, qk_norm=qk_norm)
    params = tdit.permute_dit_params_for_split_rope(
        tdit.init_dit(cfg, 4, device="cpu", dtype=dtype), cfg)
    return cfg, params


def _freqs(cfg, split=True, dtype=torch.float32):
    coords = trope.get_latent_coords(*GRID, batch_size=1, device="cpu")
    freqs = trope.precompute_freqs_cis(coords, dim=cfg.inner_dim, out_dtype=dtype)
    return trope.split_freqs(freqs) if split else freqs


@pytest.mark.parametrize("case", ["kernel", "gradient", "sp_axis", "interleaved",
                                  "no_qk_norm"])
def test_attention_route(monkeypatch, case):
    """``_attention`` at 1280 tokens takes kernel M (span ``attn.M``, then
    C's ``attn.C`` at scale 1), and keeps the chain with a gradient, under
    sequence parallelism, with interleaved RoPE and without a q/k norm."""
    from avatar_tpu_torch.parallel import sequence

    cfg, params = _tiny(qk_norm=None if case == "no_qk_norm" else "rms_norm")
    attn1 = params["blocks"][0]["attn1"]
    x = torch.randn(1, TOKENS, cfg.inner_dim, generator=torch.Generator().manual_seed(1))
    kw = dict(freqs_cis=_freqs(cfg, split=case != "interleaved"),
              rope_split=case != "interleaved")
    if case == "gradient":
        x.requires_grad_()
    if case == "sp_axis":
        monkeypatch.setattr(sequence, "ulysses_attention",
                            lambda q, k, v, axis, **_: torch.zeros_like(q))
        kw["sp_axis"] = object()
    with tprof.recording() as rec:
        tdit._attention(attn1, x, cfg, **kw)
    names = [s.name for s in rec.spans]
    assert names.count("attn.M") == (case == "kernel")
    if case == "kernel":
        assert names.index("attn.M") < names.index("attn.C")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dit_apply_through_m_equals_the_chain(monkeypatch, dtype):
    """``dit_apply`` at 1280 tokens through kernel M's route equals, bit for
    bit, the same call with the route turned off (the chain and
    ``fold_scale``)."""
    cfg, params = _tiny(dtype=dtype)
    g = torch.Generator().manual_seed(2)
    tokens = torch.randn(1, TOKENS, 16, generator=g).to(dtype)
    coords = trope.get_latent_coords(*GRID, batch_size=1, device="cpu")
    text = torch.randn(1, 8, 32, generator=g).to(dtype)
    args = (params, cfg, tokens, coords, torch.tensor([0.6]), text, torch.ones(1, 8))
    with tprof.recording() as rec:
        out = tdit.dit_apply(*args)
    assert sum(s.name == "attn.M" for s in rec.spans) == cfg.num_layers
    monkeypatch.setattr(tdit, "qk_norm_rope_supports", lambda *a: False)
    with tprof.recording() as rec:
        chain = tdit.dit_apply(*args)
    assert not any(s.name == "attn.M" for s in rec.spans)
    assert torch.equal(out, chain)


def test_supported_widths_and_the_dit_route():
    """M's widths, and where the 2B DiT (32 x 64, bf16) takes it: at the
    long path's 5376 tokens and the multi-scale second pass's 1536, not at
    the short path's 832 (A)."""
    bf16, f32 = torch.bfloat16, torch.float32
    for c, heads, dtype, want in ((2048, 32, bf16, True), (2048, 16, f32, True),
                                  (4096, 32, bf16, True), (4096, 32, f32, False),
                                  (256, 32, bf16, False), (256, 32, f32, True),
                                  (2048, 32, torch.float16, False), (100, 3, bf16, False)):
        assert tfa.qk_norm_rope_supports(c, heads, dtype) == want, (c, heads, dtype)
    for tokens, want in ((5376, True), (1536, True), (832, False)):
        assert (not tfa.rope_fused_supports(tokens, 32, 64, bf16)) == want
