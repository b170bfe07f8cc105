"""pc VM dispatches a kernel call: ``last_result.steps`` summed over the
window's calls, over the number of calls."""


def read(run):
    n = run["counters"]["vm_dispatches"]
    return n / run["calls"] if n else None
