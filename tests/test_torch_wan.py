"""Wan2.1-I2V on the port (``models/wan.py``, ``models/wan_vae.py``,
``pipelines/wan_i2v.py``) against the benchmark's plain reference
(``benchmark/reference/wan.py``, written from the published code), on the
CPU in f32 at a tiny size: dim 64, 2 heads of 32 (RoPE bands of 6 / 5 / 5
pairs), 2 blocks, z 4, VAE dim 8, 9 frames at 32 x 48. The port runs its
kernels' plain versions here; kernel M's per-head table mode is held to the
chain it replaces. No JAX: the reference is plain PyTorch."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import wan as ref  # noqa: E402
from avatar_tpu_torch.models import wan, wan_vae  # noqa: E402
from avatar_tpu_torch.ops import flash_attention as fa  # noqa: E402
from avatar_tpu_torch.ops import rope as trope  # noqa: E402
from avatar_tpu_torch.pipelines.wan_i2v import WanGenerationParams, WanI2VPipeline  # noqa: E402
from avatar_tpu_torch.utils import weight_import as wi  # noqa: E402

torch.set_num_threads(2)

CFG = wan.WanConfig(dim=64, ffn_dim=96, num_heads=2, num_layers=2, in_dim=12, out_dim=4,
                    text_len=16, text_dim=32)
VCFG = wan_vae.WanVAEConfig(dim=8, z_dim=4)
CFG_D = {"dim": 64, "ffn_dim": 96, "num_heads": 2, "num_layers": 2, "in_dim": 12,
         "out_dim": 4, "freq_dim": 256, "eps": 1e-6, "patch_size": [1, 2, 2]}
VCFG_D = {"dim": 8, "z_dim": 4, "dim_mult": [1, 2, 4, 4], "num_res_blocks": 2,
          "temperal_downsample": [False, True, True]}
FRAMES, H, W = 9, 32, 48


def _state_dict(params: dict) -> dict:
    """The published state dict of a Wan2.1 tree (the inverse of
    ``wan_params_from_state_dict``)."""
    out = {}

    def walk(node, prefix):
        items = enumerate(node) if isinstance(node, list) else node.items()
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v, f"{prefix}{k}.")
            else:
                out[f"{prefix}{k}"] = v

    walk(params, "")
    return out


def _models(seed=0):
    """A tiny DiT and VAE in the published layout, with norm weights, norm
    biases and the head drawn too, so that every parameter counts."""
    g = torch.Generator().manual_seed(seed + 100)
    dit = wan.init_wan(CFG, seed, device="cpu", dtype=torch.float32)
    vae = wan_vae.init_wan_vae(VCFG, seed, device="cpu", dtype=torch.float32)

    def jitter(tree):
        items = enumerate(tree) if isinstance(tree, list) else tree.items()
        for k, v in items:
            if isinstance(v, (dict, list)):
                jitter(v)
            elif k in ("gamma",) or (k == "weight" and v.ndim == 1):
                tree[k] = v + 0.2 * torch.randn(v.shape, generator=g)
            elif k == "bias" and isinstance(tree, dict) and tree.get("weight") is not None \
                    and tree["weight"].ndim == 1:
                tree[k] = 0.1 * torch.randn(v.shape, generator=g)

    jitter(dit)
    jitter(vae)
    return dit, vae


def _inputs(seed=1, batch=1):
    g = torch.Generator().manual_seed(seed)
    text = torch.randn(batch, CFG.text_len, CFG.text_dim, generator=g)
    text[:, 10:] = 0.0
    return dict(image=torch.rand(batch, 1, H, W, 3, generator=g) * 2 - 1, text=text,
                clip=torch.randn(batch, 257, wan.CLIP_DIM, generator=g),
                noise=torch.randn(batch, VCFG.z_dim, (FRAMES - 1) // 4 + 1, H // 8, W // 8,
                                  generator=g),
                neg=torch.randn(batch, CFG.text_len, CFG.text_dim, generator=g) * 0.5)


def _close(a, b, tol):
    err = (a.float() - b.float()).abs().max().item()
    scale = b.float().abs().max().item()
    assert err <= tol * max(scale, 1e-6), (err, scale)


def test_rope_bands_are_the_published_split():
    assert wan.rope_bands(128) == (22, 21, 21)
    assert wan.rope_bands(32) == (6, 5, 5)
    f = ref.rope_freqs(32)
    cos, sin = wan.rope_tables(3, 2, 3, 32, device="cpu", dtype=torch.float32)
    # token (f=2, h=1, w=2): its angles are the three bands' positions
    idx = (2 * 2 + 1) * 3 + 2
    want = torch.cat([f[2, :6], f[1, 6:11], f[2, 11:16]])
    _close(torch.stack([cos[0, idx], sin[0, idx]]), torch.stack([want.real, want.imag]), 1e-6)


def test_dit_forward_matches_reference():
    dit, _ = _models()
    x = _inputs()
    g = torch.Generator().manual_seed(3)
    x_in = torch.randn(2, CFG.in_dim, 3, H // 8, W // 8, generator=g)
    t = torch.tensor([937.5, 412.0])
    text = torch.cat([x["text"], x["neg"]])
    clip = torch.cat([x["clip"], x["clip"]])
    prec = ref.Precision("f32")
    ctx, img = ref.context(dit, CFG_D, text, clip, prec)
    want = ref.dit_forward(dit, CFG_D, x_in, t, ctx, img, prec)
    params = wan.permute_wan_params_for_split_rope(dit, CFG)
    grid = (3, H // 16, W // 16)
    kv, e, e0, rope = wan.precompute(params, CFG, text, clip, t / 1000.0, grid, torch.float32)
    got = wan.wan_apply(params, CFG, x_in, e, e0, kv, rope, torch.float32)
    assert got.shape == want.shape == (2, CFG.out_dim, 3, H // 8, W // 8)
    _close(got, want, 2e-5)


def test_published_state_dict_import_through_the_permutation():
    """The reference's tree as the published state dict, imported and run by
    the pipeline (which permutes self-attention's q / k rows per head into
    split halves), gives the reference's velocity; running the unpermuted
    tree's interleaved pairs as split halves does not."""
    dit, _ = _models(seed=4)
    x = _inputs(seed=5)
    g = torch.Generator().manual_seed(6)
    x_in = torch.randn(1, CFG.in_dim, 3, H // 8, W // 8, generator=g)
    t = torch.tensor([700.0])
    prec = ref.Precision("f32")
    ctx, img = ref.context(dit, CFG_D, x["text"], x["clip"], prec)
    want = ref.dit_forward(dit, CFG_D, x_in, t, ctx, img, prec)
    state = _state_dict(dit)
    assert "blocks.1.cross_attn.norm_k_img.weight" in state
    assert "img_emb.proj.4.bias" in state and "head.modulation" in state
    tree = wi.wan_params_from_state_dict(state)
    grid = (3, H // 16, W // 16)

    def run(params):
        kv, e, e0, rope = wan.precompute(params, CFG, x["text"], x["clip"], t / 1000.0, grid,
                                         torch.float32)
        return wan.wan_apply(params, CFG, x_in, e, e0, kv, rope, torch.float32)

    _close(run(wan.permute_wan_params_for_split_rope(tree, CFG)), want, 2e-5)
    err = (run(tree) - want).abs().max().item()
    assert err > 1e-3 * want.abs().max().item()


def test_vae_chunked_encode_and_decode_match_reference():
    _, vae = _models(seed=7)
    g = torch.Generator().manual_seed(8)
    video = torch.rand(1, 3, FRAMES, H, W, generator=g) * 2 - 1
    mu = wan_vae.encode(vae, VCFG, video)
    want = ref.vae_encode(vae, VCFG_D, video)
    assert mu.shape == want.shape == (1, 4, 3, H // 8, W // 8)
    _close(mu, want, 2e-5)
    z = torch.randn(1, 4, 3, H // 8, W // 8, generator=g)
    out = wan_vae.decode(vae, VCFG, z)
    want = ref.vae_decode(vae, VCFG_D, z)
    assert out.shape == want.shape == (1, 3, FRAMES, H, W)
    _close(out, want, 2e-5)


@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_i2v_video_matches_reference(guidance):
    """A 2-step video, I420 out, with and without classifier-free guidance:
    within one 8-bit level everywhere (a rounding boundary), and the same
    levels almost everywhere."""
    dit, vae = _models(seed=9)
    x = _inputs(seed=10)
    pipe = WanI2VPipeline(CFG, dit, VCFG, vae, device="cpu", dtype=torch.float32)
    p = WanGenerationParams(height=H, width=W, num_frames=FRAMES, num_inference_steps=2,
                            guidance_scale=guidance, shift=3.0)
    stages = {}
    out = pipe(p, None, x["image"], x["text"], x["clip"], negative_text_embeds=x["neg"],
               init_noise=x["noise"], output_type="yuv420", stage_times=stages)
    want = ref.generate(dit, CFG_D, vae, VCFG_D, image=x["image"], text=x["text"],
                        clip=x["clip"], noise=x["noise"], steps=2, shift=3.0,
                        guidance=guidance, negative_text=x["neg"])
    assert out.shape == want.shape == (1, FRAMES, H * 3 // 2, W)
    diff = (out.int() - want.int()).abs()
    assert diff.max().item() <= 1 and diff.float().mean().item() < 0.01
    assert {"encode_s", "denoise_s", "decode_s"} <= set(stages)
    for span in ("dit.precompute", "dit.block", "dit.attn1", "dit.attn2", "dit.attn2.img",
                 "dit.ff", "dit.norm", "vae.encode", "vae.decode", "vae.block", "vae.chunk",
                 "pipe.encode", "pipe.step", "pipe.decode", "attn.M"):
        assert f"{span}.n" in stages, span
    assert stages.get("launches.qk_norm_rope", 0) == 0  # the plain version: no launch here
    assert stages["dit.block.n"] == 2 * CFG.num_layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_m_plain_per_head_tables_match_the_chain(dtype):
    """Kernel M's plain version with tables [1, L, d/2] that every head
    shares against the chain on the same tables repeated over the heads
    (bit for bit), and against the published interleaved RoPE of each head
    (``rope_apply``) on the unpermuted rows, per head in [x1_h | x2_h]
    order."""
    heads, d, length = 4, 32, 40
    c = heads * d
    g = torch.Generator().manual_seed(11)
    q = (torch.randn(1, length, c, generator=g) * 3).to(dtype)
    k = (torch.randn(1, length, c, generator=g) * 3).to(dtype)
    wq = (1 + 0.2 * torch.randn(c, generator=g)).to(dtype)
    wk = (1 + 0.2 * torch.randn(c, generator=g)).to(dtype)
    cos, sin = wan.rope_tables(2, 4, 5, d, device="cpu", dtype=dtype)
    assert fa.head_tables(cos, c, heads)
    qo, ko, left = fa.qk_norm_rope(q, k, wq, wk, cos, sin, heads, d**-0.5, eps=1e-6)
    assert left == d**-0.5
    full = (cos.repeat(1, 1, heads), sin.repeat(1, 1, heads))
    assert not fa.head_tables(full[0], c, heads)
    cq, ck = fa._qk_norm_rope_plain(q, k, wq, wk, *full, heads, 1.0, eps=1e-6)
    assert torch.equal(qo, cq) and torch.equal(ko, ck)
    if dtype != torch.float32:
        return
    perm = torch.from_numpy(trope.rope_channel_permutation(c))
    inv = torch.argsort(perm)
    # unpermuted rows: interleaved pairs of each head
    q_pub, wq_pub = q[..., inv], wq[inv]
    normed = ref.rms(q_pub, wq_pub, 1e-6)
    rotated = ref.rope_apply(normed, (2, 4, 5), ref.rope_freqs(d), heads)
    per_head = rotated.reshape(1, length, heads, d // 2, 2).transpose(-1, -2).reshape(
        1, length, c)
    _close(qo, per_head, 1e-6)


def test_m_takes_the_wan_width():
    bf16, f32 = torch.bfloat16, torch.float32
    for c, heads, dtype, want in ((5120, 40, bf16, True), (2560, 20, f32, True),
                                  (5120, 40, f32, False), (6144, 48, bf16, False)):
        assert fa.qk_norm_rope_supports(c, heads, dtype) == want, (c, heads, dtype)


STATS = {"latents_mean": [0.3, -0.5, 1.1, 0.0], "latents_std": [2.0, 0.7, 1.5, 3.1]}


def test_vae_latent_statistics_normalise_encode_and_decode():
    """With latent statistics the encoder returns (mu - mean) / std and the
    decoder takes z std + mean, as the published ``WanVAE`` does; the
    published statistics are its 16 channels', and a config of other than
    16 channels cannot take them."""
    _, vae = _models(seed=14)
    g = torch.Generator().manual_seed(15)
    vcfg = wan_vae.WanVAEConfig(dim=8, z_dim=4, **{k: tuple(v) for k, v in STATS.items()})
    mean = torch.tensor(STATS["latents_mean"]).view(1, 4, 1, 1, 1)
    std = torch.tensor(STATS["latents_std"]).view(1, 4, 1, 1, 1)
    video = torch.rand(1, 3, FRAMES, H, W, generator=g) * 2 - 1
    _close(wan_vae.encode(vae, vcfg, video), (wan_vae.encode(vae, VCFG, video) - mean) / std,
           1e-6)
    z = torch.randn(1, 4, 3, H // 8, W // 8, generator=g)
    _close(wan_vae.decode(vae, vcfg, z), wan_vae.decode(vae, VCFG, z * std + mean), 1e-6)
    full = wan_vae.WanVAEConfig().published_stats()
    assert full.latents_mean == wan_vae.PUBLISHED_LATENTS_MEAN
    assert full.latents_std == wan_vae.PUBLISHED_LATENTS_STD
    assert len(full.latents_mean) == len(full.latents_std) == 16
    assert vcfg.published_stats() is vcfg
    with pytest.raises(ValueError):
        VCFG.published_stats()
    with pytest.raises(ValueError):
        wan_vae.WanVAEConfig(dim=8, z_dim=4, latents_mean=(0.0,) * 4)


def test_cli_dispatches_wan_i2v(tmp_path):
    """``cli/infer.py`` with ``pipeline_type: wan-i2v``: the published state
    dicts and config.json on disk, the VAE's latent statistics from the
    yaml's ``vae`` group, the embeddings from ``prompt_embeds_path`` (the
    caption unpadded, its mask zeroing a row), the reference image handed
    over loaded; the frames equal the pipeline's own on the same inputs."""
    import json

    from avatar_tpu_torch.cli import infer
    from avatar_tpu_torch.utils.safetensors_io import save_safetensors

    dit, vae = _models(seed=12)
    x = _inputs(seed=13)
    save_safetensors(_state_dict(dit), tmp_path / "dit.safetensors")
    save_safetensors(_state_dict(vae), tmp_path / "vae.safetensors")
    (tmp_path / "config.json").write_text(json.dumps(dict(CFG_D, model_type="i2v",
                                                          text_len=16, text_dim=32)))
    mask = torch.ones(1, 10)
    mask[0, 9] = 0
    save_safetensors({"prompt_embeds": x["text"][:, :10], "prompt_attention_mask": mask,
                      "clip_embeds": x["clip"]}, tmp_path / "embeds.safetensors")
    pipeline_config = {"pipeline_type": "wan-i2v", "precision": "float32",
                       "checkpoint_path": str(tmp_path / "dit.safetensors"),
                       "config_path": str(tmp_path / "config.json"),
                       "vae_checkpoint_path": str(tmp_path / "vae.safetensors"),
                       "vae": dict(VCFG_D, **STATS), "num_frames": FRAMES, "height": H,
                       "width": W,
                       "num_inference_steps": 2, "guidance_scale": 2.0, "shift": 3.0}
    config = infer.InferenceConfig(prompt_embeds_path=str(tmp_path / "embeds.safetensors"),
                                   device="cpu", seed=5)
    frames = infer.generate(config, pipeline_config, conditioning=[x["image"]])
    assert frames.shape == (1, FRAMES, H, W, 3) and frames.dtype == np.uint8
    assert (config.num_frames, config.height, config.width) == (FRAMES, H, W)
    text = x["text"].clone()
    text[:, 9:] = 0
    vcfg = wan_vae.WanVAEConfig(dim=8, z_dim=4, **{k: tuple(v) for k, v in STATS.items()})
    pipe = WanI2VPipeline(CFG, dit, vcfg, vae, device="cpu", dtype=torch.float32)
    want = pipe(WanGenerationParams(height=H, width=W, num_frames=FRAMES,
                                    num_inference_steps=2, guidance_scale=2.0, shift=3.0),
                torch.Generator().manual_seed(5), x["image"], text, x["clip"],
                output_type="uint8")
    assert np.array_equal(frames, want.numpy())


def test_chip_smoke_wan_phase_expects_the_routes_of_the_cell():
    """``chip_smoke.py``'s ``wan_kernels`` phase holds the card to launch
    counts and shapes; here they are held to the routers' predicates at the
    480p cell's shapes: 81 frames at 480 x 832 patch to 32,760 tokens, M
    takes 5120 wide with the model's per-head tables, B's cap refuses both
    cross-attentions, C's Hopper kernel takes all three at d = 128, and the
    VAE's d = 384 attention runs the WMMA D."""
    import chip_smoke as cs

    bf16 = torch.bfloat16
    cfg = wan.WanConfig()
    assert cs.WAN_GRID == ((81 - 1) // 4 + 1, 480 // 16, 832 // 16)
    assert cs.WAN_TOKENS == math.prod(cs.WAN_GRID) == 32760
    assert (cs.WAN_WIDTH, cs.WAN_HEADS) == (cfg.dim, cfg.num_heads)
    assert cs.WAN_CROSS == (cfg.text_len, 257)
    assert fa.qk_norm_rope_supports(cfg.dim, cfg.num_heads, bf16)
    cos, _ = wan.rope_tables(*cs.WAN_GRID[:1], 2, 3, cfg.head_dim, device="cpu")
    assert fa.head_tables(cos, cfg.dim, cfg.num_heads)
    want = {"qk_norm_rope": 1}
    for lk in (cs.WAN_TOKENS, *cs.WAN_CROSS):
        assert not fa.fused_supports(cs.WAN_TOKENS, lk, cfg.num_heads, cfg.head_dim, bf16)
        mode = fa.flash_mode(cs.WAN_TOKENS, lk, True)
        impl = fa.forward_impl(mode, bf16, cfg.head_dim)
        for name in (f"flash_{mode}", f"flash_{mode}_{impl}"):
            want[name] = want.get(name, 0) + 1
    assert want == cs.WAN_BLOCK_LAUNCHES
    vcfg = wan_vae.WanVAEConfig()
    assert cs.WAN_VAE_DIM == vcfg.dim * vcfg.dim_mult[-1]
    assert cs.WAN_VAE_TOKENS == (480 // vcfg.spatial_stride) * (832 // vcfg.spatial_stride)
    mode = fa.flash_mode(cs.WAN_VAE_TOKENS, cs.WAN_VAE_TOKENS, False)
    impl = fa.forward_impl(mode, bf16, cs.WAN_VAE_DIM)
    assert cs.WAN_VAE_LAUNCHES == {f"flash_{mode}": 2 * cs.WAN_GRID[0],
                                   f"flash_{mode}_{impl}": 2 * cs.WAN_GRID[0]}
