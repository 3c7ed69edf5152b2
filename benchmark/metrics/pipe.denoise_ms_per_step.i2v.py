"""pipe.denoise_ms_per_step.i2v: the Wan I2V pipeline's denoise span
(``stage_times["denoise_s"]``: the per-video precompute and every DiT
step), median over the traced run's videos, over its steps."""

import statistics


def read(rec):
    spans = rec.spans.get("denoise_s")
    return statistics.median(spans) / rec.ctx.mix["steps"] * 1e3 if spans else None
