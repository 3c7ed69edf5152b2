"""mfu.render_w8a8: mfu.render, read in the W8A8 render: the model's
operations of the run's videos (40 DiT forwards, the VAE encodes and the
decode), each product at the card's published peak for the type it runs in
(bf16 989 TFLOP/s, int8 1979 TOP/s), over those videos' own seconds; the
profiled video is left out."""


def read(rec):
    least, seconds = rec.counters.get("model_least_s"), rec.counters.get("video_s")
    return 100.0 * least / seconds if least and seconds else None
