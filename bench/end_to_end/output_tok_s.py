"""Tokens generated over the whole window, a second: each prefill's first
tokens and each decode step's, with the prefills' time in the window."""


def read(record):
    span = record["window"]["end"] - record["window"]["begin"]
    if not record["units"] or span <= 0:
        return None
    return sum(u["size"] for u in record["units"]) / span
