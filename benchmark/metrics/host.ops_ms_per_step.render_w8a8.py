"""host.ops_ms_per_step.render_w8a8: host milliseconds a DiT step inside the
program's attention and int8 op spans (names beginning "attn." or "int8.":
each call of a kernel wrapper, with the copies it makes), median over the
traced run's videos: the ``<span>.host_s`` and ``pipe.step.n`` keys of
``stage_times``. In the W8A8 render every such span runs under
``pipe.step``; the VAE's ``conv.*`` and the plain ``gemm.*`` products,
which also run in the encode, the walk's precompute and the decode, are
left out. A span's host time includes any wait for room in a full launch
queue, so the number is the host time of the wrappers, not their dispatch
cost alone. None where the run has no such keys, or where they do not
come from the same videos."""

import statistics

OPS = ("attn.", "int8.")


def read(rec):
    steps = rec.spans.get("pipe.step.n")
    ops = [v for k, v in rec.spans.items() if k.startswith(OPS) and k.endswith(".host_s")]
    if not steps or not ops or any(len(v) != len(steps) for v in ops):
        return None
    return statistics.median(sum(v[i] for v in ops) / n * 1e3 for i, n in enumerate(steps))
