"""``chip_smoke.py``'s training expectations on the CPU:
``train_route_counts`` (the launches the card run expects per micro-step)
against the kernel wrappers' calls, and the literal counts the card run
also holds the counters to against ``train_route_counts``."""

import pytest
import torch

import chip_smoke as cs
from avatar_tpu_torch.core.config import TrainConfig as TConfig
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.train import train as ttrain

torch.set_num_threads(2)


# chip_smoke.py's tiny training DiT: heads of 64, so that the route
# predicates see the 2B model's head dim
SMOKE_DIT_KW = dict(num_attention_heads=2, attention_head_dim=64, in_channels=16,
                    out_channels=16, num_layers=2, cross_attention_dim=128,
                    caption_channels=64)


@pytest.mark.parametrize("mode,remat,keys", [
    ("lora_audio", False, 128), ("lora_audio", "full", 128), ("lora_audio", "dots", 128),
    ("full", False, 128), ("full", "dots", 128), ("lora_audio", False, 136),
    ("lora_audio", "dots", 88), ("full", False, 96),
])
def test_chip_smoke_train_route_counts_match_the_paths(monkeypatch, mode, remat, keys):
    """``chip_smoke.train_route_counts`` (the launches the card run expects
    per micro-step) against the calls of the kernel wrappers in one
    micro-step on the CPU, f32 (whose predicates align to 8 rows where
    bf16's align to 16), 128 tokens: A or B or the head-major forward,
    the backward's recompute and F, under each remat."""
    from avatar_tpu_torch.ops import flash_attention as fa

    calls = {}

    def count(name, fn, key=None):
        def wrapper(*a, **kw):
            n = key(*a) if key else name
            calls[n] = calls.get(n, 0) + 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(fa, "_rope_forward", count("rope_fused_attention", fa._rope_forward))
    monkeypatch.setattr(fa, "_token_forward", count("fused_token_attention",
                                                    fa._token_forward))
    monkeypatch.setattr(fa, "_flash_forward", count(None, fa._flash_forward, key=lambda q, k,
                        v, m, s, bounded: f"flash_{fa.flash_mode(q.shape[2], k.shape[2], bounded)}"))
    monkeypatch.setattr(fa, "_flash_backward", count("flash_bwd", fa._flash_backward))
    dcfg = tdit.DiTConfig(**SMOKE_DIT_KW)
    params = tdit.init_dit(dcfg, 2, device="cpu")
    cfg = TConfig(checkpoint_path="x", train_mode=mode, lora_rank=4, lora_alpha=4)
    trainable = ttrain.init_trainable(params, dcfg, cfg, torch.Generator().manual_seed(1))
    split = mode == "lora_audio"
    run = tdit.permute_dit_params_for_split_rope(params, dcfg) if split else params
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randn(2, f, 8, 8, 16, generator=g)
             for k, f in (("latents", 2), ("pose_latents", 2), ("ref_image_latents", 1))}
    mask = torch.ones(1, keys)
    mask[0, keys - 5:] = 0.0
    leaves = [x.clone().requires_grad_() for x in ttrain.tree_leaves(trainable)]
    loss, _ = ttrain.velocity_loss(
        ttrain.tree_unflatten(trainable, leaves), run, dcfg, cfg, batch,
        torch.randn(1, keys, 64, generator=g), mask, g, mode, remat=remat, rope_split=split)
    torch.autograd.grad(loss, leaves)
    want = cs.train_route_counts(128, keys, mode, remat, layers=2, heads=2,
                                 dtype_name="float32")
    want = {k: n for k, n in want.items() if not k.endswith(("_sm90", "_wmma"))}
    bwd = calls.pop("flash_bwd", 0)
    got = dict(calls, **({"flash_bwd_dkv": bwd, "flash_bwd_dq": bwd} if bwd else {}))
    assert got == want


@pytest.mark.parametrize("key", sorted(cs.PINNED_LAUNCHES, key=repr))
def test_chip_smoke_pinned_launches_match_the_route_counts(key):
    """Each of ``chip_smoke.PINNED_LAUNCHES``'s literal launch counts (the
    training runs' predictions) equals what ``train_route_counts`` derives
    from the route predicates at that run's shape, counter by counter."""
    assert cs.pinned_launches(*key) == cs.train_route_counts(*key)
