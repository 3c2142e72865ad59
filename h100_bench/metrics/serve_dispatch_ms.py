"""Host ms a sequence spends in the daemon's ``Server.dispatch`` (load,
normalise, phase code, upload, launches): the mean of the benchmark's spans
around the calls that started inside the window."""


def read(run):
    ms = run["layer"].get("dispatch_ms") or []
    return sum(ms) / len(ms) if ms else None
