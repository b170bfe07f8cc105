"""MCMC workload on PyTorch: ``targets`` (the paper's test densities),
``prng`` (threefry keys, bit-exact with ``jax.random``) and ``nuts`` (the
recursive No-U-Turn Sampler as an autobatchable program)."""
