"""Hand-written CUDA kernels for Hopper (``sm_90a``), built with ``nvcc`` at
first use (:mod:`._build`).

``stack_ops`` — the VM's batched stack push/peek (K1/K2), grouped: one
launch per run of a block's pushes or pops;
``flash_attention`` — causal GQA prefill attention (K3; TMA and ``wgmma``
on the tensor cores for bf16 with a head dim of 64 or 128);
``flash_decode`` — one-token attention against the KV cache (K4; split
over the cache window).
Each replaces one of the JAX package's Pallas TPU kernels.  Each package ships ``csrc/`` (CUDA),
``kernel.py`` (ctypes binding), ``ops.py`` (checks, device dispatch, launch
counts) and ``ref.py`` (plain PyTorch versions).
"""
