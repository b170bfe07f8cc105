"""Window wall time a block execution of the local static batcher, in ms:
``local_stats.block_execs`` summed over the window's calls."""


def read(run):
    n = run["counters"]["block_execs"]
    return run["window_s"] * 1e3 / n if n else None
