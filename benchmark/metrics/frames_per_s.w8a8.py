"""frames_per_s.w8a8: frames_per_s, read in the W8A8 render: the frames of
every video started in the window over the time from the window's start to
the end of the last of them."""


def read(rec):
    if not rec.done:
        return None
    end = max(t for t, _ in rec.done)
    return sum(n for _, n in rec.done) / (end - rec.window_start)
