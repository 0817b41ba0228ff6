"""Prompt tokens prefilled over the whole window, a second."""


def read(record):
    units = [u for u in record["units"] if u["kind"] == "prefill"]
    span = record["window"]["end"] - record["window"]["begin"]
    if not units or span <= 0:
        return None
    return sum(u["size"] * u["n"] for u in units) / span
