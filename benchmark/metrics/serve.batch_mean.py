"""serve.batch_mean: the window's requests over the batches the server
formed of them (``AvatarServer.stats``)."""


def read(rec):
    batches = rec.counters.get("batches")
    return rec.counters["requests"] / batches if batches else None
