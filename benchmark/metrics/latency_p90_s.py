"""latency_p90_s: the 90th percentile over every request due in the
window, each from its due time to its result on the host; a failed or
missing request counts as infinitely late."""

from benchmark.common import percentile


def read(rec):
    return percentile(rec.latencies, 90) if rec.latencies else None
