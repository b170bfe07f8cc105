"""Batch utilization of the ``grad`` tag (the paper's Fig. 6), in %: active
lanes over executed lanes (executions x chains) over the window."""


def read(run):
    c = run["counters"]
    execs = c["grad_execs"]
    return 100.0 * c["grad_active"] / (execs * c["chains"]) if execs else None
