"""The paper's experiment end to end on the PyTorch port: autobatched NUTS
on Bayesian logistic regression (Section 4.1), plus the Fig-6 utilization
probe.

    PYTHONPATH=src python examples/torch_nuts_logreg.py [--chains 64] [--full] [--device cpu]

Builds the recursive NUTS program in the autobatch IR, runs a batch of
chains through the program-counter VM (on the card unless ``--device``
names another), and reports convergence, the posterior mean's finiteness
and gradient-evaluation throughput and utilization.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.mcmc import nuts, targets


def build_program(dim: int = 20, num_data: int = 1_000, device=None):
    """The recursive NUTS ir.Program this example runs (small default).

    Module-level factory so static tooling can analyze the exact program:
    ``python tools/torch_irlint.py examples/torch_nuts_logreg.py:build_program``.
    """
    target = targets.logistic_regression(num_data=num_data, dim=dim, device=device)
    settings = nuts.NutsSettings(max_tree_depth=8, num_steps=20, steps_per_leaf=4)
    return nuts.build_nuts_program(target, settings)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full", action="store_true",
                    help="paper-scale: 10k points, 100 regressors")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)

    if args.full:
        target = targets.logistic_regression(num_data=10_000, dim=100, device=args.device)
        eps = 0.01
    else:
        target = targets.logistic_regression(num_data=1_000, dim=20, device=args.device)
        eps = 0.05
    settings = nuts.NutsSettings(max_tree_depth=8, num_steps=args.steps, steps_per_leaf=4)
    print(f"target: {target.name}; {args.chains} chains x {args.steps} NUTS trajectories")

    kernel = nuts.make_nuts_kernel(target, settings, backend="pc", batch_size=args.chains,
                                   max_steps=2_000_000, device=args.device)
    theta0, eps_arg, keys = nuts.initial_state(target, args.chains, eps=eps, seed=0,
                                               device=args.device)
    sync = torch.cuda.synchronize if kernel.device.type == "cuda" else (lambda: None)

    t0 = time.perf_counter()
    state = kernel(theta0, eps_arg, keys)  # includes lowering and the VM's set-up
    sync()
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = kernel(theta0, eps_arg, keys)  # a cache hit on the same avals
    sync()
    t_warm = time.perf_counter() - t0
    assert kernel.cache_info().hits >= 1

    res = kernel.last_result
    execs, active = kernel.tag_stats["grad"]
    grads = active * settings.grads_per_leaf
    print(f"device: {kernel.device}")
    print(f"converged: {bool(res.converged)}  VM steps: {res.steps}")
    print(f"cold run (incl. lowering): {t_cold:.2f}s")
    print(f"warm run: {t_warm:.2f}s  ({grads / t_warm:,.0f} member-gradients/sec)")
    print(f"batch utilization of gradient leaves: {kernel.utilization['grad']:.3f}")

    n = args.chains * settings.num_steps
    mean = state["sum_theta"].cpu().numpy().sum(0) / n
    print(f"posterior mean norm: {np.linalg.norm(mean):.3f} "
          f"(finite: {np.isfinite(mean).all()})")


if __name__ == "__main__":
    main()
