"""The leaf gradient's matrix products against their roofline, in %.

The least time the products of the window's useful gradients could take,
``max(FLOPs / peak FLOP/s, bytes / peak bytes/s)`` with FLOPs and bytes of
the active lanes from ``counts/<target>.py``, over the device time of the
traced window's kernels whose names match a pattern of
``grad_matmul_roofline.d/`` (one regular expression a file)."""
import re
from pathlib import Path

_PATTERNS = Path(__file__).with_suffix(".d")


def read(run):
    trace, peaks, c, cfg = run["trace"], run["peaks"], run["counters"], run["config"]
    counts = run["counts"]
    if trace is None or peaks is None or not counts.grad_matmul_flops(cfg):
        return None
    pats = [re.compile(p.read_text().strip()) for p in sorted(_PATTERNS.glob("*.txt"))]
    ns = sum(min(e, trace.t1) - max(s, trace.t0) for name, s, e in trace.ops
             if e > trace.t0 and s < trace.t1 and any(p.search(name) for p in pats))
    if not ns:
        return None
    gpl = c["grads_per_leaf"]
    key = "tf32_flops" if cfg.get("tf32") else "float32_flops"
    t_flops = c["grads"] * counts.grad_matmul_flops(cfg) / peaks[key]
    t_bytes = gpl * counts.matmul_bytes(cfg, c["grad_execs"], c["grad_active"]) \
        / peaks["hbm_bytes_per_s"]
    return 100.0 * max(t_flops, t_bytes) / (ns / 1e9)
