"""Window wall time a pc VM dispatch, in ms."""


def read(run):
    n = run["counters"]["vm_dispatches"]
    return run["window_s"] * 1e3 / n if n else None
