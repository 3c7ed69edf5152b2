"""The port's training path against the JAX package's, on the CPU, in f32:
``dit_apply`` with LoRA and ``remat="full"``, the train step (accumulation,
clipping, the learning-rate schedule, bf16 first moments, the EMA) in
"lora_audio" and "full" mode, the dataset's epoch order, safetensors
interchange, the merged export read by the JAX loader, and the CLI's
resume.

The tiny DiT has heads of 16 and 128 tokens, so that on the port's side
self-attention takes the RoPE-fused path (kernel A's plain version),
cross-attention the token-major one (B) over 128 caption keys, and both
backwards the flash route (the flash backward's plain version): 128 * 128
is the route rule's threshold. The JAX side runs its XLA paths on the CPU.
jax.random's draws cannot be made in torch, so the port's step is fed the
t and noise that the JAX ``velocity_loss`` draws from its key.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu.core.config import TrainConfig as JConfig
from avatar_tpu.models import dit as jdit
from avatar_tpu.models.patchifier import patchify as jpatchify
from avatar_tpu.train import lora as jlora
from avatar_tpu.train import train as jtrain
from avatar_tpu_torch.core.config import TrainConfig as TConfig
from avatar_tpu_torch.models import dit as tdit
from avatar_tpu_torch.models.patchifier import patchify as tpatchify
from avatar_tpu_torch.ops import flash_attention as tfa
from avatar_tpu_torch.train import train as ttrain
from avatar_tpu_torch.utils.weight_import import (
    _convert,
    dit_params_from_numpy,
    lora_from_numpy,
)
from torch_parity import dit_numpy_params

torch.set_num_threads(2)

DIT_KW = dict(num_attention_heads=2, attention_head_dim=16, in_channels=8, out_channels=8,
              num_layers=2, cross_attention_dim=32, caption_channels=24)
JDIT, TDIT = jdit.DiTConfig(**DIT_KW), tdit.DiTConfig(**DIT_KW)
ACCUM, MICRO_B, FRAMES, HW, CAPTION = 2, 2, 2, 8, 128
N_TOKENS = FRAMES * HW * HW
# f32 on both sides through two blocks, a backward and two AdamW steps: the
# summation orders of the two attention routes (kernel plain versions
# against XLA) differ by ~1e-6 on the gradients, which Adam's normalised
# update can carry at most to ~lr per step (observed 5e-6)
TREE_ATOL = 2e-5
LOSS_RTOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(jax_tree):
    """A JAX-layout params subtree (or a LoRA tree under "lora") in the
    port's layout, f32 on the CPU."""
    tree = dict(_np_tree(jax_tree))
    lora = tree.pop("lora", None)
    out = _convert(tree, "cpu", torch.float32)
    if lora is not None:
        out["lora"] = lora_from_numpy(lora, device="cpu")
    return out


def _assert_trees_close(got, ref, atol, rtol=0.0):
    """Leaf by leaf, matched by key and index (not by flattening order)."""
    ttrain.tree_map(lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), b.detach().numpy(), atol=atol, rtol=rtol), got, ref)


@pytest.fixture(scope="module")
def params():
    tree = dit_numpy_params(JDIT)
    return tree, jax.tree.map(jnp.asarray, tree), dit_params_from_numpy(tree, TDIT, device="cpu")


@pytest.fixture(scope="module")
def lora_tree():
    """A JAX-layout LoRA with nonzero b, so that it moves the output."""
    rng = np.random.default_rng(3)
    lora = jlora.init_lora(jax.random.PRNGKey(1), JDIT, 4)
    return jax.tree.map(
        lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32), lora)


def _prompt(rng):
    embeds = rng.standard_normal((1, CAPTION, DIT_KW["caption_channels"])).astype(np.float32)
    mask = np.ones((1, CAPTION), np.float32)
    mask[0, 100:] = 0.0
    return embeds, mask


def test_dit_apply_lora_and_remat_match_jax(params, lora_tree, monkeypatch):
    """Forward and gradients with respect to the LoRA and caption_projection,
    split-RoPE layout (the LoRA's to_q/to_k b columns follow the
    permutation where it targets attn1), remat "full" on the port."""
    tree, jparams, tparams = params
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((1, FRAMES, HW, HW, 8)).astype(np.float32)
    embeds, mask = _prompt(rng)
    g = rng.standard_normal((1, N_TOKENS, 8)).astype(np.float32)
    lora = {"blocks": [dict(b, attn1=b["attn2"]) for b in lora_tree["blocks"]]}
    scale = 0.5
    jp = jdit.permute_dit_params_for_split_rope(jparams, JDIT)
    tp = tdit.permute_dit_params_for_split_rope(tparams, TDIT)
    j_tokens, j_coords = jpatchify(jnp.asarray(lat))
    t_tokens, t_coords = tpatchify(torch.from_numpy(lat))
    t_val = 0.37

    def jloss(lora_, cap):
        out = jdit.dit_apply(
            dict(jp, caption_projection=cap), JDIT, j_tokens, j_coords,
            jnp.asarray([t_val]), jnp.asarray(embeds), jnp.asarray(mask),
            lora=lora_, lora_scale=scale, rope_split=True)
        return jnp.sum(out * g), out

    (_, jout), (jg_lora, jg_cap) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, lora), jp["caption_projection"])

    tlora = lora_from_numpy(lora, device="cpu")
    trainable = {"lora": tlora, "caption_projection": tp["caption_projection"]}
    leaves = [x.clone().requires_grad_() for x in ttrain.tree_leaves(trainable)]
    live = ttrain.tree_unflatten(trainable, leaves)
    calls = {}
    for name in ("_rope_forward", "_token_forward", "_flash_backward_plain"):
        monkeypatch.setattr(tfa, name, _counted(getattr(tfa, name), name, calls))
    out = tdit.dit_apply(
        dict(tp, caption_projection=live["caption_projection"]), TDIT, t_tokens, t_coords,
        torch.tensor([t_val]), torch.from_numpy(embeds), torch.from_numpy(mask),
        lora=live["lora"], lora_scale=scale, rope_split=True, remat="full")
    grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=2e-5)
    ref = _to_port({"lora": jg_lora, "caption_projection": jg_cap})
    _assert_trees_close(ttrain.tree_unflatten(trainable, grads), ref, 2e-4, 1e-4)
    # per block: A and B forward, again under remat, and each backward's
    # flash recompute (self- and cross-attention) through F's plain version
    layers = TDIT.num_layers
    assert calls == {"_rope_forward": 2 * layers, "_token_forward": 2 * layers,
                     "_flash_backward_plain": 2 * layers}


def _counted(fn, name, calls):
    def wrapper(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **kw)
    return wrapper


def test_remat_dots_is_not_ported(params):
    """remat "dots" runs: its forward equals the one without remat, and an
    unknown policy raises."""
    _, _, tparams = params
    args = (tparams, TDIT, torch.ones(1, 4, 8), torch.zeros(1, 3, 4), torch.full((1,), 0.3),
            torch.ones(1, 4, 24))
    assert torch.equal(tdit.dit_apply(*args, remat="dots"), tdit.dit_apply(*args))
    with pytest.raises(ValueError, match="remat"):
        tdit.dit_apply(*args, remat="offload")


STEP_CFG = dict(checkpoint_path="x", learning_rate=1e-3, lora_rank=4, lora_alpha=8,
                rf_log_normal_mu=-0.5, rf_log_normal_sigma=1.0,
                gradient_accumulation_steps=ACCUM, batch_size=MICRO_B,
                max_grad_norm=0.05, lr_schedule="cosine", lr_total_steps=3,
                ema_decay=0.9, optimizer_moment_dtype="bfloat16")


def _draws(key):
    """Per micro-batch (t, noise) as the JAX step draws them from ``key``."""
    ts, noises = [], []
    for i in range(ACCUM):
        k_t, k_noise = jax.random.split(jax.random.fold_in(key, i))
        ts.append(np.asarray(jtrain.sample_rf_timesteps(k_t, MICRO_B, -0.5, 1.0,
                                                        0.005, 0.999)))
        noises.append(np.asarray(jax.random.normal(k_noise, (MICRO_B, N_TOKENS, 8))))
    return torch.from_numpy(np.stack(ts)), torch.from_numpy(np.stack(noises))


@pytest.mark.parametrize("mode", ["lora_audio", "full"])
def test_train_step_matches_jax(params, lora_tree, mode):
    """Two optimizer steps with accumulation 2, clipping (global norm 0.05),
    cosine decay, bf16 first moments and an EMA: loss, trainable tree and
    EMA tree after each."""
    tree, jparams, tparams = params
    jcfg, tcfg = JConfig(train_mode=mode, **STEP_CFG), TConfig(train_mode=mode, **STEP_CFG)
    split = mode == "lora_audio"
    if split:
        jp = jdit.permute_dit_params_for_split_rope(jparams, JDIT)
        tp = tdit.permute_dit_params_for_split_rope(tparams, TDIT)
        jtr = {"lora": lora_tree, "caption_projection": jparams["caption_projection"]}
        ttr = {"lora": lora_from_numpy(lora_tree, device="cpu"),
               "caption_projection": tparams["caption_projection"]}
    else:
        jp, tp = jparams, tparams
        jtr = jtrain.split_full_trainable(jparams)
        ttr = ttrain.split_full_trainable(tparams)
    # copies: the JAX step donates its trainable and optimizer state
    jtr = jax.tree.map(jnp.array, jtr)
    jopt, topt = jtrain.make_optimizer(jcfg), ttrain.make_optimizer(tcfg)
    jstate, tstate = jopt.init(jtr), topt.init(ttr)
    jstep = jtrain.make_train_step(JDIT, jcfg, jopt, rope_split=split)
    tstep = ttrain.make_train_step(TDIT, tcfg, topt, rope_split=split)
    rng = np.random.default_rng(0)
    batch = {k: rng.standard_normal((ACCUM, MICRO_B, f, HW, HW, 8)).astype(np.float32)
             for k, f in (("latents", FRAMES), ("pose_latents", FRAMES),
                          ("ref_image_latents", 1))}
    embeds, mask = _prompt(rng)
    for step in range(2):
        key = jax.random.PRNGKey(10 + step)
        t, noise = _draws(key)
        jtr, jstate, jm = jstep(jtr, jstate, jp, jax.tree.map(jnp.asarray, batch),
                                jnp.asarray(embeds), jnp.asarray(mask), key)
        ttr, tstate, tm = tstep(ttr, tstate, tp, {k: torch.from_numpy(v) for k, v in
                                                  batch.items()},
                                torch.from_numpy(embeds), torch.from_numpy(mask),
                                t=t, noise=noise)
        for name in ("loss", "rel_mse", "nrmse"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=LOSS_RTOL)
        _assert_trees_close(ttr, _to_port(jtr), TREE_ATOL)
        _assert_trees_close(ttrain.ema_params(tstate), _to_port(jtrain.ema_params(jstate)),
                            TREE_ATOL)
    assert tstate["count"] == 2 and tstate["ema_count"] == 2


@pytest.mark.parametrize("kind,warmup,total", [("cosine", 3, 10), ("linear", 2, 6),
                                               ("constant", 4, 0)])
def test_lr_schedule_matches_jax(kind, warmup, total):
    kw = dict(checkpoint_path="x", learning_rate=3e-4, lr_schedule=kind,
              lr_warmup_steps=warmup, lr_total_steps=total)
    jfn = jtrain.make_lr_schedule(JConfig(**kw))
    tfn = ttrain.make_lr_schedule(TConfig(**kw))
    for step in range(12):
        np.testing.assert_allclose(tfn(step), float(jfn(step)), rtol=1e-6)


def test_unported_options_raise(params):
    """Nothing is left unported: an unknown optimizer raises, and so do the
    reference's own refusals of the parallel modes (pipeline parallelism in
    "full" mode, a sequence mesh without an 'sp' axis); Adafactor,
    audio-conditioned batches and the parallel modes are ported (held in
    test_torch_adafactor.py, test_torch_train_options.py and
    test_torch_parallel_train.py)."""
    from avatar_tpu_torch.parallel import make_mesh, make_pp_mesh

    _, _, tparams = params
    assert isinstance(ttrain.make_optimizer(TConfig(checkpoint_path="x",
                                                    optimizer="adafactor")),
                      ttrain.Adafactor)
    with pytest.raises(ValueError, match="optimizer"):
        ttrain.make_optimizer(TConfig(checkpoint_path="x", optimizer="sgd"))
    cfg = TConfig(checkpoint_path="x", train_mode="full")
    with pytest.raises(ValueError, match="lora_audio"):
        ttrain.make_train_step(TDIT, cfg, ttrain.make_optimizer(cfg),
                               sharding=ttrain.TrainSharding(make_pp_mesh(1), "pp"))
    with pytest.raises(ValueError, match="lora_audio"):
        ttrain.velocity_loss(ttrain.split_full_trainable(tparams), tparams, TDIT, cfg,
                             {}, None, None, train_mode="full", pp_mesh=make_pp_mesh(1))
    with pytest.raises(ValueError, match="'sp' axis"):
        ttrain.TrainSharding(make_mesh(), "sp")


# ---------------------------------------------------------------------------
# Data, checkpoints and the CLI
# ---------------------------------------------------------------------------


def _write_clips(root, names, rng, suffix=".safetensors"):
    from avatar_tpu_torch.utils.safetensors_io import save_safetensors

    enc, cond = root / "enc", root / "cond"
    enc.mkdir()
    cond.mkdir()
    for name in names:
        for d, stem, f in ((enc, name, FRAMES), (cond, name, FRAMES),
                           (cond, f"{name}_ref", 1)):
            lat = rng.standard_normal((8, f, HW, HW) if f > 1 else (8, HW, HW))
            lat = lat.astype(np.float32)
            if suffix == ".npy":
                np.save(d / f"{stem}.npy", lat)
            else:
                save_safetensors({"latents": torch.from_numpy(lat)}, d / f"{stem}{suffix}")
    return str(cond), str(enc)


def test_epoch_batches_order_matches_jax(tmp_path):
    from avatar_tpu.data import dataset as jdata
    from avatar_tpu_torch.data import dataset as tdata

    dirs = _write_clips(tmp_path, [f"clip{i}" for i in range(7)], np.random.default_rng(5))
    jds, tds = jdata.LatentPairDataset(*dirs), tdata.LatentPairDataset(*dirs)
    assert jds.items == tds.items and len(tds) == 7
    for epoch in (0, 3):
        jb = list(jdata.epoch_batches(jds, 2, 2, seed=11, epoch=epoch))
        tb = list(tdata.prefetch_batches(tdata.epoch_batches(tds, 2, 2, seed=11,
                                                             epoch=epoch)))
        assert [b["stem"] for b in tb] == [b["stem"] for b in jb] and len(tb) == 1
        for a, b in zip(tb, jb):
            for k in ("latents", "pose_latents", "ref_image_latents"):
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("direction", ["port writes", "port reads"])
def test_safetensors_interchange(tmp_path, direction):
    import safetensors.torch as st
    from safetensors import safe_open

    from avatar_tpu_torch.utils import safetensors_io as sio

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g).bfloat16(),
               "b": torch.randn(7, generator=g), "c": torch.arange(6, dtype=torch.int64),
               "d": torch.randint(-128, 127, (2, 2, 2), generator=g).to(torch.int8),
               "e": torch.randn(2, 3, generator=g).half(), "empty": torch.zeros(0, 4)}
    meta = {"config": '{"transformer": {"num_layers": 2}}', "note": "x"}
    path = tmp_path / "t.safetensors"
    if direction == "port writes":
        sio.save_safetensors(tensors, path, metadata=meta)
        back = st.load_file(str(path))
        with safe_open(str(path), framework="pt") as f:
            assert f.metadata() == meta
    else:
        st.save_file(tensors, str(path), metadata=meta)
        back, got_meta = sio.load_safetensors(path)
        assert got_meta == meta
    assert sio.load_config_metadata(path) == {"transformer": {"num_layers": 2}}
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_merged_export_loads_into_the_jax_package(tmp_path, params, lora_tree):
    from avatar_tpu.utils import weight_import as jwi
    from avatar_tpu_torch.train.checkpoints import export_training_checkpoint
    from avatar_tpu_torch.utils import weight_import as twi

    tree, jparams, tparams = params
    cfg = TConfig(checkpoint_path="x", train_mode="lora_audio", lora_rank=4, lora_alpha=8)
    rng = np.random.default_rng(6)
    cap = jax.tree.map(lambda x: x + 0.01 * rng.standard_normal(x.shape).astype(np.float32),
                       tree["caption_projection"])
    trainable = _to_port({"lora": lora_tree, "caption_projection": cap})
    path = export_training_checkpoint(tmp_path / "m.safetensors", tparams, TDIT, trainable,
                                      cfg, metadata={"epoch": "1"}, is_best=True)
    assert path.name == "best_m.safetensors"
    configs, t_state, v_state = jwi.load_single_file_checkpoint(path)
    assert not v_state and configs["scheduler"]["num_train_timesteps"] == 1000
    loaded = jwi.import_transformer_state(t_state, jdit.DiTConfig.from_dict(
        configs["transformer"]))
    ref = jlora.merge_lora(dict(jparams, caption_projection=jax.tree.map(jnp.asarray, cap)),
                           jax.tree.map(jnp.asarray, lora_tree), 2.0)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                         atol=1e-6), loaded, ref)
    # and back into the port, through its own reader
    _, t_state2, _ = twi.load_single_file_checkpoint(path)
    back = twi.import_transformer_state(t_state2, TDIT, device="cpu")
    _assert_trees_close(back, dit_params_from_numpy(_np_tree(ref), TDIT, device="cpu"), 1e-6)


def test_cli_trains_exports_and_resumes(tmp_path, params):
    from avatar_tpu_torch.cli.train import train_loop
    from avatar_tpu_torch.train.checkpoints import TrainStateCheckpointer
    from avatar_tpu_torch.utils.weight_import import save_single_file_checkpoint

    _, _, tparams = params
    ckpt = tmp_path / "base.safetensors"
    save_single_file_checkpoint(ckpt, tparams, TDIT)
    cond, enc = _write_clips(tmp_path, [f"c{i}" for i in range(4)],
                             np.random.default_rng(7), suffix=".npy")
    cfg = TConfig(checkpoint_path=str(ckpt), condition_latents_dir=cond,
                  encoder_latents_dir=enc, val_condition_latents_dir=cond,
                  val_encoder_latents_dir=enc, output_dir=str(tmp_path / "out"),
                  batch_size=2, num_epochs=1, learning_rate=1e-3, lora_rank=4,
                  lora_alpha=4, precision="float32", train_mode="lora_audio",
                  log_every_n_steps=1, wandb_project=None, rf_log_normal_mu=-0.5,
                  rf_log_normal_sigma=1.0)
    first = train_loop(cfg, device="cpu")
    state = TrainStateCheckpointer(tmp_path / "out" / "state")
    assert state.latest_step() == 2
    assert (tmp_path / "out" / "best_model_epoch_1.safetensors").exists()
    # the second call resumes at step 2 and runs epoch 2 only
    second = train_loop(dataclasses.replace(cfg, num_epochs=2), device="cpu")
    assert state.latest_step() == 4
    assert (tmp_path / "out" / "model_epoch_2.safetensors").exists() or (
        tmp_path / "out" / "best_model_epoch_2.safetensors").exists()
    lines = (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()
    steps = [int(s.split('"step": ')[1].split(",")[0]) for s in lines if "train/loss" in s]
    assert steps == [1, 2, 3, 4]
    assert any(not torch.equal(a, b) for a, b in zip(ttrain.tree_leaves(first),
                                                     ttrain.tree_leaves(second)))
