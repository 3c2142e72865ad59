"""The 90th percentile, over every sequence finished in the window, of
the daemon's own per-file time: the start of its ``Server.dispatch`` to its
SR file renamed into place.  The serving cell works through a backlog,
above the daemon's capacity, so its end-to-end metric is the rate and this
tail is a per-layer reading."""


def read(run):
    return run["metrics"].get("sequence_ms_p90")
