"""host.kernels_per_step.train: CUDA kernels of the traced optimizer step
over its micro-steps."""


def read(rec):
    if rec.trace is None or rec.trace.kernels() == 0:
        return None
    return rec.trace.kernels() / rec.counters["micro_steps"]
