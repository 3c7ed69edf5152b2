"""The port's diagnostic tools run on the CPU and show what they are for."""

import json

import pytest

torch = pytest.importorskip("torch")

from avatar_tpu_torch.tools import bf16_error  # noqa: E402


def test_bf16_error_probe_names_the_timestep_rounding(capsys):
    """A bf16 walk's distance from the f32 walk is the bf16 rounding of
    t = sigma * 1000: the f32 walk fed the rounded t lands where the bf16
    walk does, and the bf16 walk with t from f32 stays near the f32 walk.
    Relative RMS of the final latents; 0.02 is twice what bf16's own
    rounding gives in this 2-layer model (0.005 to 0.009)."""
    assert bf16_error.main(["--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    walks = [ln for ln in lines if "bf16" in ln]
    assert len(walks) == len(bf16_error.GRIDS) * len(bf16_error.SETTINGS)
    for walk in walks:
        assert walk["bf16_exact_t"] < 0.02
        assert abs(walk["f32_rounded_t"] - walk["bf16"]) < 0.01
    # 1280 tokens: the schedule puts t = 673.77 where bf16 gives 672
    worst = [w for w in walks if w["tokens"] == 1280]
    assert all(w["bf16"] > 3 * w["bf16_exact_t"] for w in worst)
    evaluations = {ln["exact_t"]: ln for ln in lines if "exact_t" in ln}
    assert evaluations[True]["guided"] < 0.03 < evaluations[False]["guided"]
