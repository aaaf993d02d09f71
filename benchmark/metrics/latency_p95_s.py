"""95th percentile of the latency over every request sent in the window
(linear interpolation between ranks), the requests in flight at its close
waited for."""

import numpy as np


def read(run):
    lat = run.latencies()
    return float(np.percentile(lat, 95)) if lat else None
