"""Median latency, from a client's send to the last answer, over every
request sent in the window (those in flight at its close waited for)."""

import numpy as np


def read(run):
    lat = run.latencies()
    return float(np.median(lat)) if lat else None
