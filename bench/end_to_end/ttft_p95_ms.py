"""95th percentile, over every request of the window, of the time from the
start of its batch (its prompts made) to its first token on the host."""
import numpy as np


def read(record):
    times = [1e3 * (u["end"] - u["start"])
             for u in record["units"] if u["kind"] == "prefill"
             for _ in range(u["size"])]
    return float(np.percentile(times, 95)) if times else None
