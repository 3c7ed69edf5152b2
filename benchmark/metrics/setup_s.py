"""setup_s: process start to the window's start (build, weights, warm-up)."""


def read(rec):
    return rec.setup_s if rec.setup_s > 0 else None
