"""Share of the traced window in which no operation runs on the device, in
%: one minus the union of the device operations' intervals over the
window."""


def read(run):
    trace = run["trace"]
    if trace is None or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
