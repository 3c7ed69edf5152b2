"""vae.decode_ms.render: the pipeline's decode span (VAE decode and the
I420 pass), median over the traced run's videos."""

import statistics


def read(rec):
    spans = rec.spans.get("decode_s")
    return statistics.median(spans) * 1e3 if spans else None
