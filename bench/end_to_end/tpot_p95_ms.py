"""95th percentile, over every decode step of the window, of the time from
the step's call to its tokens on the host."""
import numpy as np


def read(record):
    times = [1e3 * (u["end"] - u["call"])
             for u in record["units"] if u["kind"] == "decode"]
    return float(np.percentile(times, 95)) if times else None
