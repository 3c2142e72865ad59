"""Host ms a timed step waits on the loader for its batch: the mean of the
benchmark's spans around the trainer's request for each window step's
batch."""


def read(run):
    ms = run["layer"].get("loader_wait_ms") or []
    return sum(ms) / len(ms) if ms else None
