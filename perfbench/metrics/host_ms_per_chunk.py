"""Host time of a chunk: its wall time less the time the host sat blocked
in the records' read (the blocking device-to-host copy and any synchronize
in the profiler's trace), averaged over the profiled chunks, in ms."""


def read(ctx):
    red = ctx["trace"]
    if not red["chunk_s"]:
        return None
    host = [c - b for c, b in zip(red["chunk_s"], red["blocked_s"])]
    return 1e3 * sum(host) / len(host)
