"""attn.roofline.train: the least time of the attention work of one
optimizer step (every micro-step's self- and cross-attention forward and
backward, work.py) over the device time of the kernels that do it in the
traced step."""

PATTERNS = ("attention_kernel", "rope_sm90", "token_sm90", "flash_sm90", "flash_forward",
            "flash_bwd", "flash_dense", "fmha", "flash_fwd")


def read(rec):
    if rec.trace is None or rec.work is None or "attention" not in rec.work.least:
        return None
    seconds = rec.trace.seconds_matching(PATTERNS)
    return 100.0 * rec.work.least["attention"] / seconds if seconds else None
