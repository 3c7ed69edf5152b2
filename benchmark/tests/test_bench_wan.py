"""The Wan2.1 I2V cell's files: found by name, run whole on the CPU at a tiny
size (the program's plain versions in place of its kernels), the fp8 control
refused by the committed limits, and the work arithmetic against counts made
by hand."""

import copy
import json

import pytest

import tiny
from benchmark import control_wan, run, work, work_wan
from benchmark.drivers import render_wan

WAN = "wan21-i2v-14b.i2v-480p"
NEW_METRICS = {"pipe.denoise_ms_per_step.i2v", "vae.ms.i2v", "attn.roofline.i2v",
               "attn.M.roofline.i2v", "mfu.i2v"}


def wan_tiny(config: dict, mix: dict, **mix_update):
    """The cell's configuration and mix cut to dim 64 (2 heads of 32), 2
    blocks, z 4, VAE dim 8, 9 frames at 32 x 48, in f32."""
    config = copy.deepcopy(config)
    config.update(dim=64, ffn_dim=96, num_heads=2, num_layers=2, in_dim=12, out_dim=4,
                  text_dim=32, dtype="float32")
    config["vae"].update(dim=8, z_dim=4)
    mix = dict(mix, frames=9, height=32, width=48, steps=2, text_tokens=16,
               caption_kept=[4, 16], warmup_steps=1)
    mix.update(mix_update)
    return config, mix


def test_the_wan_cell_is_found_with_its_files_and_metrics():
    cell, config, mix, limits, spec = run.load_cell(WAN)
    assert mix["driver"] == "render_wan" and cell["chips"] == 1
    assert (tiny.BENCH / "drivers" / "render_wan.py").is_file()
    assert "video_gap_levels" in limits
    names = {m["name"] for m in run.metrics_of(spec, WAN, False)}
    assert names == {"frames_per_s", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in run.metrics_of(spec, WAN, True)} == NEW_METRICS
    for m in spec["per_layer"]:
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == [WAN]
            assert (tiny.BENCH / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("seed", [2**40 + 9, 3_000_000_007])
def test_the_wan_cell_runs_whole_on_the_cpu(seed):
    cell, config, mix, limits, spec = run.load_cell(WAN)
    config, mix = wan_tiny(config, mix)
    rec, metrics = run.run_cell(cell, config, mix, limits, spec, seed, 1.0, False,
                                device="cpu")
    assert rec.attempted >= 1 and rec.failed == 0
    assert set(metrics) == {"frames_per_s", "setup_s"}  # no card: no memory peak
    assert run.correct_of(rec.checks), rec.checks
    gaps = {name: value for name, value, _ in rec.checks}
    assert set(gaps) == set(render_wan.CHECKS) == set(limits)
    # f32 against f32: rounding only
    assert gaps["video_gap_levels"] < 0.5 and gaps["latent_gap"] < 1e-4, gaps


@pytest.mark.parametrize("seed", [5, 3_000_000_007])
def test_the_committed_limit_finds_the_wan_control_not_correct(seed):
    """The fp8 control at a tiny size of 4 blocks and the cell's 4 steps
    reads 0.040-0.049 of relative latent gap here, above the committed
    0.01, and 1.2-3.2 levels of I420 gap (0.047-0.055 and 1.53-1.99 at the
    cell's size on the card, where the program reads at most 0.0023 and
    0.69; PERF.md §2). The control's checks are the cell's own."""
    cell, config, mix, limits, _ = run.load_cell(WAN)
    config, mix = wan_tiny(config, mix, steps=4)
    config["num_layers"] = 4
    gaps = control_wan.control_gaps(cell, config, mix, seed, "cpu")
    assert set(gaps) == set(limits)
    assert gaps["latent_gap"] > limits["latent_gap"], gaps
    assert not run.correct_of([(n, v, limits[n]) for n, v in gaps.items()]), gaps


SHAPES = {"dim": 5120, "ffn_dim": 13824, "num_heads": 40, "num_layers": 8, "in_dim": 36,
          "out_dim": 16, "freq_dim": 256, "patch_size": [1, 2, 2], "text_dim": 4096}


def test_wan_block_counts_by_hand():
    tokens = 21 * 30 * 52
    assert tokens == 32760 == work_wan.tokens_of(SHAPES, {"frames": 81, "height": 480,
                                                          "width": 832})
    # q, k, v, o, cross q, cross o: 6 C^2; the FFN: 2 C F; two operations a product
    assert work_wan.block_linear_ops(SHAPES, tokens) == 2 * 32760 * (
        6 * 5120**2 + 2 * 5120 * 13824) == 19_580_269_363_200
    assert work_wan.self_attention_ops(SHAPES, tokens) == 4 * 32760**2 * 5120 \
        == 21_979_496_448_000
    assert work_wan.m_bytes(1, tokens, 5120, 128) == (4 * 32760 * 5120 + 2 * 32760 * 64
                                                      + 2 * 5120) * 2


def test_wan_video_work_sums_its_parts():
    peaks = work.PEAKS["H100"]
    w = work_wan.dit_video_work(SHAPES, 1, 32760, 512, 257, 4, peaks)
    per_step = 8 * (19_580_269_363_200 + 21_979_496_448_000
                    + 4 * 32760 * (512 + 257) * 5120) + 2 * 32760 * 144 * 5120 \
        + 2 * 32760 * 5120 * 64
    once = (2 * 512 * (4096 * 5120 + 5120**2) + 2 * 257 * (1280**2 + 1280 * 5120)
            + 8 * 4 * (512 + 257) * 5120**2 + 4 * 2 * (256 * 5120 + 7 * 5120**2))
    assert w.ops["bf16"] == pytest.approx(4 * per_step + once, rel=1e-12)
    assert w.least["qk_norm_rope"] == pytest.approx(
        4 * 8 * work_wan.m_bytes(1, 32760, 5120, 128) / peaks[1], rel=1e-12)


def test_the_vae_count_is_its_convolutions_and_attention():
    from benchmark.drivers import render_wan

    config = json.loads((tiny.BENCH / "configs" / "wan21-i2v-14b.json").read_text())
    _, _, _, vae = render_wan.make_models(dict(config, num_layers=1, dtype="float32"), 5, "cpu")
    small = work_wan.vae_ops(vae, config["vae"], 5, 32, 32)
    # the encoder's first conv alone: 3 -> 96 channels, 27 taps, every pixel
    assert small > 2 * 5 * 32 * 32 * 96 * 3 * 27
    assert work_wan.vae_ops(vae, config["vae"], 9, 32, 32) > small
