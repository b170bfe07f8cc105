"""Hand-written CUDA kernels for Hopper (``sm_90a``), built with ``nvcc`` at
first use (:mod:`._build`).

``stack_ops`` — the VM's batched stack push/peek (K1/K2), replacing the
JAX package's Pallas TPU kernels.  Each package ships ``csrc/`` (CUDA),
``kernel.py`` (ctypes binding), ``ops.py`` (checks, device dispatch, launch
counts) and ``ref.py`` (plain PyTorch versions).
"""
