"""The servicer's PNG encode time, p50 of its ``encode`` timer
(utils/timing.py STATS), read when the window closes."""


def read(run):
    s = run.stats.get("encode")
    return s["p50_ms"] if s else None
