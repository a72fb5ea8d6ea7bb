"""The share of the traced window in which no kernel or copy ran on the
card, in percent."""


def read(name, run):
    window = run["trace"]["window_s"]
    if window <= 0 or run["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run["trace"]["busy_s"] / window)
