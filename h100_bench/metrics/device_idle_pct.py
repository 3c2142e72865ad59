"""The traced window's share in which nothing ran on the card: 100 less
the union of every kernel, copy and set interval, on all streams."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
