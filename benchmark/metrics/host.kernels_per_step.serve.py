"""host.kernels_per_step.serve: CUDA kernels the profiler records in the
traced sub-window over the DiT forwards in it. A forward launches one
cross-attention kernel (B) a block; the forwards are counted by those
kernels' names in the same trace, so that the sub-window's edges cut both
counts alike."""

CROSS_ATTENTION = ("token_sm90_kernel", "token_attention_kernel")


def read(rec):
    if rec.trace is None:
        return None
    cross = sum(c for name, (c, _) in rec.trace.ops.items()
                if any(p in name for p in CROSS_ATTENTION))
    forwards = cross / rec.ctx.config["dit"]["num_layers"]
    return rec.trace.kernels() / forwards if forwards > 0 else None
