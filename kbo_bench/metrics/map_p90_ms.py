"""90th percentile of the window's request latencies, send to host bytes
(the highest percentile with ten or more of a window's requests beyond it)."""
import numpy as np


def read(run):
    lat = [r["latency_s"] for r in run.requests]
    return 1e3 * float(np.percentile(lat, 90)) if lat else None
