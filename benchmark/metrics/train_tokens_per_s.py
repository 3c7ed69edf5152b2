"""train_tokens_per_s: micro-batch tokens of every optimizer step started
in the window over the time from the window's start to the end of the
last of them (a host read of its loss)."""


def read(rec):
    if not rec.done:
        return None
    end = max(t for t, _ in rec.done)
    return sum(n for _, n in rec.done) / (end - rec.window_start)
