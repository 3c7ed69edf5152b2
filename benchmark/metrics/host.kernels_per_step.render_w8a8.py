"""host.kernels_per_step.render_w8a8: host.kernels_per_step.render, read in
the W8A8 render: CUDA kernels of one whole traced video (encodes, walk and
decode) over its DiT steps."""


def read(rec):
    if rec.trace is None or rec.trace.kernels() == 0:
        return None
    return rec.trace.kernels() / rec.ctx.mix["steps"]
