"""Shared test programs and seeded inputs of the port's tests and
``chip_smoke.py``, on the CPU and on the card.

The integer programs are the port's counterparts of ``build_fib``,
``build_pow_loop`` and ``build_mutual`` in tests/test_core.py and
``build_deep_recursion`` in tests/test_fusion.py and ``build_parity`` in
tests/test_pgo.py, written the same way so
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


def build_parity():
    """The port's counterpart of ``build_parity`` in tests/test_pgo.py: a
    loop whose body diverges on parity, both arms calling ``h`` (two call
    sites: only the profile-guided inliner absorbs it) and then ``g`` (one
    call site: the frame merge)."""
    pb = frontend.ProgramBuilder(main="par")
    hb = pb.function("h", ["x"], ["y"], {"x": I32}, {"y": I32})
    hb.assign("y", lambda x: x * 3 + 1, ["x"])
    hb.return_()
    pb.add(hb)
    gb = pb.function("g", ["a"], ["b"], {"a": I32}, {"b": I32})
    gb.assign("b", lambda a: a - 5, ["a"])
    gb.return_()
    pb.add(gb)
    fb = pb.function("par", ["n", "x"], ["out"], {"n": I32, "x": I32}, {"out": I32})
    fb.copy("x", out="acc")
    fb.copy("n", out="i")
    with fb.while_(lambda i: i > 0, ["i"]):
        c = fb.prim(lambda acc: acc % 2 == 0, ["acc"], name="even")
        with fb.if_(c):
            fb.call("h", ["acc"], out="acc")
        with fb.orelse():
            fb.call("h", ["acc"], out="t")
            fb.assign("acc", lambda t: t + 1, ["t"])
        fb.call("g", ["acc"], out="acc")
        fb.assign("i", lambda i: i - 1, ["i"])
    fb.copy("acc", out="out")
    fb.return_()
    pb.add(fb)
    return pb.build()


def parity_inputs(lanes: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """``(n, x)`` of tests/test_pgo.py's ``_parity_inputs``."""
    rng = np.random.default_rng(5)
    n = rng.integers(3, 9, size=lanes).astype(np.int32)
    x = rng.integers(-40, 41, size=lanes).astype(np.int32)
    return n, x


def build_tagged_fib():
    """fib with its leaf tagged ``"leaf"`` (tests/test_core.py's program for
    the pc-beats-local utilization property)."""
    pb = frontend.ProgramBuilder()
    fb = pb.function("fib", ["n"], ["out"], {"n": I32}, {"out": I32})
    c = fb.prim(lambda n: n < 2, ["n"], name="lt2")
    with fb.if_(c):
        fb.prim(lambda n: n, ["n"], out="out", name="leaf", tag="leaf")
        fb.return_()
    t1 = fb.prim(lambda n: n - 1, ["n"])
    fb.call("fib", [t1], out="a")
    t2 = fb.prim(lambda n: n - 2, ["n"])
    fb.call("fib", [t2], out="b")
    fb.assign("out", lambda a, b: a + b, ["a", "b"])
    fb.return_()
    pb.add(fb)
    return pb.build()


# Small int32 arithmetic, as in the scheduler oracle's random programs.
_BINOPS = [
    ("add", lambda a, b: a + b),
    ("sub", lambda a, b: a - b),
    ("xor", lambda a, b: a ^ b),
    ("min", lambda a, b: torch.minimum(a, b)),
    ("max", lambda a, b: torch.maximum(a, b)),
]
_CMPS = [
    ("lt", lambda a, b: a < b),
    ("le", lambda a, b: a <= b),
    ("eq", lambda a, b: (a & 3) == (b & 3)),
]


class RandomProgram:
    """Seeded random control-flow programs ``f(n, x) -> out`` (int32):
    divergent branches, bounded loops and recursion on ``n``; the port's
    copy of tests/test_core_property.py's ``_Gen``, drawing from the
    generator in the same order, so one seed builds the same CFG in both
    packages."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def expr(self, fb, scope):
        a, b = self.rng.choice(scope, 2)
        name, fn = _BINOPS[self.rng.integers(len(_BINOPS))]
        return fb.prim(fn, [a, b], name=name)

    def cond(self, fb, scope):
        a, b = self.rng.choice(scope, 2)
        name, fn = _CMPS[self.rng.integers(len(_CMPS))]
        return fb.prim(fn, [a, b], name=name)

    def stmts(self, fb, scope, depth, allow_call):
        for _ in range(int(self.rng.integers(1, 4))):
            kind = self.rng.integers(4)
            if kind == 0 or depth >= 2:
                scope.append(self.expr(fb, scope))
            elif kind == 1:
                c = self.cond(fb, scope)
                with fb.if_(c):
                    self.stmts(fb, list(scope), depth + 1, allow_call)
                if self.rng.integers(2):
                    with fb.orelse():
                        self.stmts(fb, list(scope), depth + 1, allow_call)
            elif kind == 2:
                # Bounded counter loop (always terminates).
                i = fb.prim(lambda: torch.tensor(3, dtype=torch.int32), (), name="c3")
                with fb.while_(lambda i: i > 0, [i]):
                    self.stmts(fb, list(scope) + [i], depth + 1, False)
                    fb.assign(i, lambda i: i - 1, [i])
            elif allow_call:
                # Structurally decreasing recursion on 'n'.
                t = fb.prim(lambda n: n - 1, ["n"], name="dec")
                arg = self.rng.choice(scope)
                scope.append(fb.call("f", [t, arg]))

    def build(self):
        pb = frontend.ProgramBuilder()
        fb = pb.function("f", ["n", "x"], ["out"], {"n": I32, "x": I32}, {"out": I32})
        c = fb.prim(lambda n: n <= 0, ["n"], name="base")
        with fb.if_(c):
            fb.copy("x", out="out")
            fb.return_()
        scope = ["n", "x"]
        self.stmts(fb, scope, 0, allow_call=True)
        a, b = self.rng.choice(scope, 2)
        fb.assign("out", lambda a, b: a + b, [a, b])
        fb.return_()
        pb.add(fb)
        return pb.build()


def random_program_inputs(seed: int, z: int = 8):
    """The seeded random program and its ``n``, ``x`` int32 inputs, as
    tests/test_scheduler_oracle.py's ``_seeded_inputs`` draws them."""
    rng = np.random.default_rng(seed)
    prog = RandomProgram(rng).build()
    n = rng.integers(0, 5, size=z).astype(np.int32)
    x = rng.integers(-50, 51, size=z).astype(np.int32)
    return prog, n, x


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
