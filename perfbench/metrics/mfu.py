"""The whole NUTS step's share of the card's float32 peak, in %: useful
gradient FLOPs (active lanes x ``grads_per_leaf`` x the benchmark's count of
one gradient, ``counts/<target>.py``) over the window's wall time, over the
peak in ``peaks.json``.  Log densities at the leaves are not counted."""


def read(run):
    peaks, c = run["peaks"], run["counters"]
    flops = c["grads"] * run["counts"].grad_flops(run["config"])
    if peaks is None or not flops:
        return None
    key = "tf32_flops" if run["config"].get("tf32") else "float32_flops"
    return 100.0 * flops / run["window_s"] / peaks[key]
