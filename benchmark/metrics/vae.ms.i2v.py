"""vae.ms.i2v: the Wan VAE's time a video, the pipeline's encode span (the
image and its zero frames) plus its decode span (the decode and the I420
pass), median over the traced run's videos."""

import statistics


def read(rec):
    enc, dec = rec.spans.get("encode_s"), rec.spans.get("decode_s")
    if not enc or not dec or len(enc) != len(dec):
        return None
    return statistics.median(e + d for e, d in zip(enc, dec)) * 1e3
