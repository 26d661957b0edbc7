"""Bytes the service read from disk during the window
(``core/restore.io_counters()["read"]``), MiB per call completed."""


def read(run):
    n = sum(1 for c in run.calls if c.stream.done and c.stream.error is None)
    if not n or not run.extras["w_read"]:
        return None
    return run.extras["w_read"] / 2**20 / n
