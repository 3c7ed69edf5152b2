"""The port's training CLI in decoder mode and its neighbours, on the CPU in
f32: the decoder loop end to end (its export read back by both packages'
loaders, the resume, the up-front check of the pixel targets), validation
videos on a tiny pipeline, and the training prompt's order of sources.
The tiny VAE is ``tests/test_torch_decoder_train.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avatar_tpu_torch.core.config import TrainConfig as TConfig
from avatar_tpu_torch.models import vae as tvae
from avatar_tpu_torch.train import train as ttrain
from avatar_tpu_torch.utils.weight_import import vae_params_from_numpy
from test_torch_decoder_train import JVCFG, LATENT_CH, PIX, TVCFG, vae  # noqa: F401
from torch_parity import vae_numpy_params

torch.set_num_threads(2)


def _tiny_checkpoint(tmp_path):
    """A tiny DiT and the tiny VAE in one single-file checkpoint written by
    the JAX package, as tests/test_decoder_train.py writes it."""
    from avatar_tpu.models.dit import DiTConfig, init_dit
    from avatar_tpu.utils.weight_import import export_vae_state, save_single_file_checkpoint

    dit_cfg = DiTConfig(num_attention_heads=2, attention_head_dim=8, in_channels=LATENT_CH,
                        out_channels=LATENT_CH, num_layers=1, cross_attention_dim=16,
                        caption_channels=32)
    vtree = vae_numpy_params(JVCFG, seed=9)
    vtree["per_channel_statistics"] = {"std_of_means": np.ones(LATENT_CH, np.float32),
                                       "mean_of_means": np.zeros(LATENT_CH, np.float32)}
    jv = jax.tree.map(jnp.asarray, vtree)
    ckpt = tmp_path / "ckpt.safetensors"
    save_single_file_checkpoint(ckpt, init_dit(jax.random.PRNGKey(0), dit_cfg), dit_cfg,
                                vae_state=export_vae_state(jv, JVCFG),
                                vae_config=JVCFG.to_dict())
    return ckpt, jv


def test_decoder_cli_trains_exports_and_resumes(tmp_path):
    """``--train_mode decoder`` for one epoch: ``vae_epoch_1.safetensors``
    loads into both packages, its DiT leaves unchanged and its decoder
    leaves moved; a second call resumes; a missing pixel target fails up
    front."""
    from avatar_tpu.utils import weight_import as jwi
    from avatar_tpu_torch.cli.train import main
    from avatar_tpu_torch.train.checkpoints import TrainStateCheckpointer
    from avatar_tpu_torch.utils import weight_import as twi

    ckpt, jv = _tiny_checkpoint(tmp_path)
    enc, cond = tmp_path / "enc", tmp_path / "cond"
    enc.mkdir()
    cond.mkdir()
    rng = np.random.default_rng(3)
    for i in range(2):
        for d, stem, shape in ((enc, f"clip_{i}", (LATENT_CH, 2, 2, 2)),
                               (cond, f"clip_{i}", (LATENT_CH, 2, 2, 2)),
                               (cond, f"clip_{i}_ref", (LATENT_CH, 1, 2, 2))):
            np.save(d / f"{stem}.npy", rng.standard_normal(shape).astype(np.float32))
        np.save(enc / f"clip_{i}_pixels.npy", rng.integers(0, 256, PIX, dtype=np.uint8))
    out = tmp_path / "run"
    (tmp_path / "train.yaml").write_text(
        f"checkpoint_path: {ckpt}\nprecision: float32\ntrain:\n"
        f"  condition_latents_dir: {cond}\n  encoder_latents_dir: {enc}\n"
        f"  output_dir: {out}\n  batch_size: 2\n  num_epochs: 1\n  learning_rate: 1e-3\n"
        f"  gradient_checkpointing: true\n  log_every_n_steps: 1\n"
        f"  save_every_n_epochs: 1\n  wandb_project: null\n")
    main(["--config", str(tmp_path / "train.yaml"), "--train_mode", "decoder",
          "--device", "cpu"])
    export = out / "vae_epoch_1.safetensors"
    assert export.exists()
    assert TrainStateCheckpointer(out / "state").latest_step() == 1

    _, dit0, _, _, _ = jwi.load_checkpoint(ckpt)
    jdit_cfg, jdit, jvcfg, jvae_params, _ = jwi.load_checkpoint(export)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 jdit, dit0)
    moved = jax.tree.leaves(jax.tree.map(
        lambda a, b: float(jnp.abs(a - b).max()), jvae_params["decoder"], jv["decoder"]))
    assert max(moved) > 0
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 jvae_params["encoder"], jv["encoder"])
    configs, _, v_state = twi.load_single_file_checkpoint(export)
    port_vae = twi.import_vae_state(v_state, tvae.VAEConfig.from_dict(configs["vae"]),
                                    device="cpu")
    ttrain.tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()),
                    port_vae, vae_params_from_numpy(jax.tree.map(np.asarray, jvae_params),
                                                    TVCFG, device="cpu"))

    # a second call with two epochs resumes at step 1 and runs the second
    (tmp_path / "train.yaml").write_text(
        (tmp_path / "train.yaml").read_text().replace("num_epochs: 1", "num_epochs: 2"))
    main(["--config", str(tmp_path / "train.yaml"), "--train_mode", "decoder",
          "--device", "cpu"])
    assert TrainStateCheckpointer(out / "state").latest_step() == 2
    assert (out / "vae_epoch_2.safetensors").exists()

    (enc / "clip_1_pixels.npy").unlink()
    with pytest.raises(ValueError, match=r"missing for 1/2.*clip_1"):
        main(["--config", str(tmp_path / "train.yaml"), "--train_mode", "decoder",
              "--device", "cpu", "--no_resume"])


def test_validate_video_writes_the_reconstruction(vae, tmp_path, monkeypatch):
    """One validation sample through a tiny f32 pipeline on the CPU; without
    lpips / torchmetrics it warns and writes the video only."""
    from avatar_tpu_torch.data.dataset import LatentPairDataset
    from avatar_tpu_torch.models.dit import DiTConfig
    from avatar_tpu_torch.pipelines.pipeline import LTXVideoPipeline
    from avatar_tpu_torch.train import validation
    from avatar_tpu_torch.utils.weight_import import dit_params_from_numpy
    from torch_parity import PIPE_DIT_KW, dit_numpy_params
    from avatar_tpu.models import dit as jdit

    written = {}
    monkeypatch.setattr("avatar_tpu_torch.data.media.write_video",
                        lambda path, video, fps=25.0: written.update(
                            {str(path): np.asarray(video)}))
    dtree = dit_numpy_params(jdit.DiTConfig(**PIPE_DIT_KW))
    _, tparams = vae
    pipe = LTXVideoPipeline(DiTConfig(**PIPE_DIT_KW),
                            dit_params_from_numpy(dtree, DiTConfig(**PIPE_DIT_KW),
                                                  device="cpu"),
                            TVCFG, tparams, device="cpu")
    enc, cond = tmp_path / "enc", tmp_path / "cond"
    enc.mkdir()
    cond.mkdir()
    rng = np.random.default_rng(1)
    for d, stem, shape in ((enc, "s0", (LATENT_CH, 2, 2, 2)), (cond, "s0", (LATENT_CH, 2, 2, 2)),
                           (cond, "s0_ref", (LATENT_CH, 1, 2, 2))):
        np.save(d / f"{stem}.npy", rng.standard_normal(shape).astype(np.float32))
    embeds = torch.from_numpy(rng.standard_normal((1, 16, 32)).astype(np.float32))
    with pytest.warns(UserWarning, match="lpips"):
        records = validation.validate_video(
            pipe, LatentPairDataset(str(cond), str(enc)), str(tmp_path / "val"), embeds,
            torch.ones(1, 16), videos_dir=str(tmp_path), num_samples=1,
            num_inference_steps=2, generator=torch.Generator().manual_seed(0))
    assert [r["stem"] for r in records] == ["s0"] and "lpips" not in records[0]
    (video,) = written.values()
    assert video.shape == (9, 64, 64, 3) and np.isfinite(video).all()


def test_encode_train_prompt_order(tmp_path, monkeypatch):
    """prompt_embeds_path first; else the port's T5 and a local tokenizer;
    else zeros, all kept."""
    from avatar_tpu_torch.cli import train as tcli
    from avatar_tpu_torch.models import t5
    from avatar_tpu_torch.utils.safetensors_io import save_safetensors

    emb = torch.randn(1, 7, 16)
    save_safetensors({"prompt_embeds": emb, "prompt_attention_mask": torch.ones(1, 7)},
                     tmp_path / "e.safetensors")
    cfg = TConfig(checkpoint_path="x")
    cfg.prompt_embeds_path = str(tmp_path / "e.safetensors")
    got, mask = tcli.encode_train_prompt(cfg, 16, device="cpu")
    assert torch.equal(got, emb) and mask.shape == (1, 7)

    cfg = TConfig(checkpoint_path="x")
    cfg.text_encoder_model_name_or_path = str(tmp_path / "no_t5_here")
    got, mask = tcli.encode_train_prompt(cfg, 16, device="cpu")
    assert got.shape == (1, 256, 16) and not got.any() and mask.all()

    seen = {}

    def fake_load(path, device="cuda"):
        seen["path"] = path
        return "cfg", "params"

    def fake_encode(params, cfg_, tokenizer, prompt):
        seen["prompt"] = prompt
        return torch.ones(1, 256, 16, dtype=torch.float64), torch.ones(1, 256)

    class Tok:
        @staticmethod
        def from_pretrained(path, subfolder, local_files_only):
            assert local_files_only
            return "tok"

    monkeypatch.setattr(t5, "load_t5_encoder", fake_load)
    monkeypatch.setattr(t5, "encode_prompt", fake_encode)
    monkeypatch.setattr("transformers.T5TokenizerFast", Tok)
    got, _ = tcli.encode_train_prompt(cfg, 16, device="cpu")
    assert seen == {"path": str(tmp_path / "no_t5_here"), "prompt": tcli.TRAIN_PROMPT}
    assert got.dtype == torch.float32 and got.eq(1).all()
