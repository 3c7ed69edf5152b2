"""attn.roofline.i2v: the least time of the DiT's attention work in one
video (every forward's self-attention and its text and image
cross-attentions at head dim 128, work_wan.py) over the device time of the
Hopper attention kernel that runs all of them (C, D or E of
``csrc/flash_forward_sm90.cu``) in the traced video. The VAE's attention
(head dim 384) runs another kernel and is not counted."""

PATTERNS = ("flash_sm90",)


def read(rec):
    if rec.trace is None or rec.work is None or "attention" not in rec.work.least:
        return None
    seconds = rec.trace.seconds_matching(PATTERNS)
    return 100.0 * rec.work.least["attention"] / seconds if seconds else None
