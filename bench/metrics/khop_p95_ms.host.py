"""95th percentile of submit-to-answer latency, client side, over every
query answered in the window. A query's latency is one reading of the host
clock over a sweep or two (about 10 ms), too short to stand as an
end-to-end metric, so it is read here, in the traced run."""
import numpy as np


def read(r):
    lat = [a.latency_s for a in r.window.answers]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
