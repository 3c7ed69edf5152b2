"""mfu.i2v: the model's operations of the run's Wan videos (the DiT's
steps, the text and image embeddings and the VAE's encode and decode) at
the card's bf16 peak (989 TFLOP/s), over those videos' own seconds; the
profiled video is left out."""


def read(rec):
    least, seconds = rec.counters.get("model_least_s"), rec.counters.get("video_s")
    return 100.0 * least / seconds if least and seconds else None
