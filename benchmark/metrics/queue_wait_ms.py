"""Time a request waits in the dispatcher before its batch starts, p50 of
its ``dispatch_queue_wait`` timer (utils/timing.py STATS), read when the
window closes."""


def read(run):
    s = run.stats.get("dispatch_queue_wait")
    return s["p50_ms"] if s else None
