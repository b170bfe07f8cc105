"""Autobatching core on PyTorch: the Fig-2 IR, its two frontends (the
restricted-Python transform of :mod:`.ast_frontend` and the builder of
:mod:`.frontend`), analyses, lowering with the paper's five optimizations,
fusion and DCE passes with executable invariants in :mod:`.verifier`, the
unbatched oracle, local static batching (Algorithm 1) and the
program-counter VM (Algorithm 2) behind :func:`batching.autobatch`."""
from . import (
    analysis,
    api,
    ast_frontend,
    batching,
    frontend,
    fusion,
    ir,
    local_static,
    lowering,
    passes,
    pc_vm,
    reference,
    verifier,
)
from .api import BatchedProgram
from .ast_frontend import Namespace
from .batching import AutobatchedFunction, Batched, Shared, autobatch
from .frontend import BOOL, F32, I32, FunctionBuilder, ProgramBuilder, spec
from .passes import PassError, PassPipeline
from .verifier import VerificationError, verify

__all__ = [
    "analysis",
    "api",
    "ast_frontend",
    "autobatch",
    "AutobatchedFunction",
    "Batched",
    "BatchedProgram",
    "batching",
    "BOOL",
    "F32",
    "frontend",
    "FunctionBuilder",
    "fusion",
    "I32",
    "ir",
    "local_static",
    "lowering",
    "Namespace",
    "PassError",
    "passes",
    "PassPipeline",
    "pc_vm",
    "ProgramBuilder",
    "reference",
    "Shared",
    "spec",
    "VerificationError",
    "verifier",
    "verify",
]
