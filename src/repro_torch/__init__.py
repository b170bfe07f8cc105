"""PyTorch port of the autobatching system, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``kernels``, ``mcmc``) and never imports it or JAX.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""
