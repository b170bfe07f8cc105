"""Shared test programs and seeded inputs of the port's tests and
``chip_smoke.py``, on the CPU and on the card.

The integer programs are the port's counterparts of ``build_fib``,
``build_pow_loop`` and ``build_mutual`` in tests/test_core.py and
``build_deep_recursion`` in tests/test_fusion.py, written the same way so
both packages lower them to the same blocks.  The LM slice's inputs
(attention operands, a decode cache, prompt batches) are made with numpy
from a seed.
"""
import numpy as np
import torch

from repro_torch.core import frontend, ir
from repro_torch.core.frontend import BOOL, F32, I32


def build_fib():
    pb = frontend.ProgramBuilder()
    fb = pb.function("fib", ["n"], ["out"], {"n": I32}, {"out": I32})
    c = fb.prim(lambda n: n < 2, ["n"], name="lt2")
    with fb.if_(c):
        fb.copy("n", out="out")
        fb.return_()
    t1 = fb.prim(lambda n: n - 1, ["n"])
    fb.call("fib", [t1], out="a")
    t2 = fb.prim(lambda n: n - 2, ["n"])
    fb.call("fib", [t2], out="b")
    fb.assign("out", lambda a, b: a + b, ["a", "b"])
    fb.return_()
    pb.add(fb)
    return pb.build()


def build_pow_loop():
    pb = frontend.ProgramBuilder()
    fb = pb.function("powi", ["x", "k"], ["out"], {"x": F32, "k": I32},
                     {"out": F32})
    fb.const(1.0, torch.float32, out="out")
    fb.copy("k", out="i")
    with fb.while_(lambda i: i > 0, ["i"]):
        fb.assign("out", lambda o, x: o * x, ["out", "x"])
        fb.assign("i", lambda i: i - 1, ["i"])
    fb.return_()
    pb.add(fb)
    return pb.build()


def build_mutual():
    pb = frontend.ProgramBuilder()
    ev = pb.function("is_even", ["n"], ["out"], {"n": I32}, {"out": BOOL})
    c = ev.prim(lambda n: n == 0, ["n"])
    with ev.if_(c):
        ev.const(True, torch.bool, out="out")
        ev.return_()
    t = ev.prim(lambda n: n - 1, ["n"])
    ev.call("is_odd", [t], out="out")
    ev.return_()
    pb.add(ev)
    od = pb.function("is_odd", ["n"], ["out"], {"n": I32}, {"out": BOOL})
    c = od.prim(lambda n: n == 0, ["n"])
    with od.if_(c):
        od.const(False, torch.bool, out="out")
        od.return_()
    t = od.prim(lambda n: n - 1, ["n"])
    od.call("is_even", [t], out="out")
    od.return_()
    pb.add(od)
    return ir.Program(functions=pb.functions, main="is_even")


def build_deep_recursion():
    pb = frontend.ProgramBuilder()
    fb = pb.function("depth", ["n"], ["out"], {"n": I32}, {"out": I32})
    c = fb.prim(lambda n: n <= 0, ["n"])
    with fb.if_(c):
        fb.const(0, torch.int32, out="out")
        fb.return_()
    t = fb.prim(lambda n: n - 1, ["n"])
    fb.call("depth", [t], out="r")
    fb.assign("out", lambda r: r + 1, ["r"])
    fb.return_()
    pb.add(fb)
    return pb.build()


# ---------------------------------------------------------------------------
# Seeded inputs of the LM slice (float32 CPU tensors and numpy arrays, made
# with numpy so that both packages can be fed the same values)
# ---------------------------------------------------------------------------


def attention_inputs(b, s, t, h, hk, dh, seed=0):
    """q ``[B, S, H, Dh]``, k and v ``[B, T, Hkv, Dh]``: standard normals."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 for shape in ((b, s, h, dh), (b, t, hk, dh), (b, t, hk, dh)))


def decode_inputs(b, w, h, hk, dh, seed=0):
    """q ``[B, H, Dh]``, a cache k and v ``[B, W, Hkv, Dh]`` and int32
    ``count [B]`` drawn from 1 to ``W``."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((b, h, dh), (b, w, hk, dh), (b, w, hk, dh)))
    count = torch.from_numpy(rng.integers(1, w + 1, b).astype(np.int32))
    return q, k, v, count


def engine_inputs(ecfg, vocab_size, seed=0, min_len=2):
    """Prompts ``[lanes, R, P]`` of tokens in ``[1, vocab)`` and their
    lengths ``[lanes, R]`` drawn from ``min_len`` to ``P`` (numpy int32)."""
    rng = np.random.default_rng(seed)
    shape = (ecfg.lanes, ecfg.requests_per_lane)
    prompts = rng.integers(1, vocab_size, shape + (ecfg.max_prompt_len,)).astype(np.int32)
    plens = rng.integers(min_len, ecfg.max_prompt_len + 1, shape).astype(np.int32)
    return prompts, plens


def stack_values(rng, shape, dtype: torch.dtype) -> np.ndarray:
    """Seeded values of ``shape`` for a stack of ``dtype``, as numpy (bf16
    as the float32 values it holds exactly)."""
    if dtype == torch.bool:
        return rng.integers(0, 2, shape).astype(bool)
    if dtype == torch.int32:
        return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int64).astype(np.int32)
    x = (rng.normal(size=shape) * 10).astype(np.float32)
    if dtype == torch.bfloat16:
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def stack_group_inputs(specs, lanes, seed=0, mask="random"):
    """Operands of a stack group of ``specs`` (``ops.StackSpec``s) over
    ``lanes`` lanes, as numpy: per spec ``(stack [D, Z, ...], ptr [Z]
    int32 drawn from -2 to D + 1, top [Z, ...], src [Z, ...])``, and a bool
    ``[Z]`` mask that is random, all on (``"on"``) or all off (``"off"``)."""
    rng = np.random.default_rng(seed)
    entries = []
    for s in specs:
        rows = (lanes,) + tuple(s.shape)
        entries.append((stack_values(rng, (s.depth,) + rows, s.dtype),
                        rng.integers(-2, s.depth + 2, lanes).astype(np.int32),
                        stack_values(rng, rows, s.dtype), stack_values(rng, rows, s.dtype)))
    m = {"random": rng.integers(0, 2, lanes).astype(bool),
         "on": np.ones(lanes, bool), "off": np.zeros(lanes, bool)}[mask]
    return entries, m


def to_torch(x: np.ndarray, dtype: torch.dtype, device="cpu") -> torch.Tensor:
    """A numpy array of :func:`stack_values` as a tensor of ``dtype``."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)
