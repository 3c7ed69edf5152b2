"""attn.M.roofline.i2v: kernel M's byte bound in one video (q and k
[1, 32760, 5120] read and written once, the per-head tables shared by the
40 heads and the norm weights read once, each DiT forward's self-attention;
work_wan.py) at the card's memory rate, over M's device time in the traced
video. Nothing to read where M did not run."""

PATTERNS = ("qk_norm_rope_kernel",)


def read(rec):
    if rec.trace is None or rec.work is None or "qk_norm_rope" not in rec.work.least:
        return None
    seconds = rec.trace.seconds_matching(PATTERNS)
    return 100.0 * rec.work.least["qk_norm_rope"] / seconds if seconds else None
