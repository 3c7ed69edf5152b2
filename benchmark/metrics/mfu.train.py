"""mfu.train: the operations one optimizer step needs (forward, dX through
every product, dW of the trained weights, attention's forward and
backward, no recompute; work.py) at the card's bf16 peak, over the
window's unprofiled steps' own seconds."""


def read(rec):
    least, seconds = rec.counters.get("model_least_s"), rec.counters.get("step_s")
    return 100.0 * least / seconds if least and seconds else None
