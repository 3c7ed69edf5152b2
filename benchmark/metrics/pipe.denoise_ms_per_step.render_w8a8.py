"""pipe.denoise_ms_per_step.render_w8a8: pipe.denoise_ms_per_step.render,
read in the W8A8 render: the pipeline's denoise span
(``stage_times["denoise_s"]``), median over the traced run's videos, over
its steps."""

import statistics


def read(rec):
    spans = rec.spans.get("denoise_s")
    return statistics.median(spans) / rec.ctx.mix["steps"] * 1e3 if spans else None
