"""End-to-end training on the PyTorch port: SmolLM-135M for a few hundred
steps with the whole training substrate — deterministic resumable data,
AdamW with f32 masters, atomic checkpoints and the fault-tolerant restart
loop — on the CUDA card by default.

    PYTHONPATH=src python examples/torch_train_lm.py                     # ~135M smollm
    PYTHONPATH=src python examples/torch_train_lm.py --quick             # reduced config
    PYTHONPATH=src python examples/torch_train_lm.py --quick --device cpu

The default trains the real SmolLM-135M architecture (30 layers, d_model
576) at a short sequence length; ``--quick`` uses the reduced config.  A
simulated failure is injected mid-run to show checkpoint/restart recovery.
"""
import argparse
import shutil
import tempfile

from repro_torch.core.tree import tree_flatten
from repro_torch.launch.train import build_trainer
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import fault_tolerance as ft


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args()

    if args.quick:
        steps = args.steps or 60
        kw = dict(seq_len=64, global_batch=8, smoke=True, lr=3e-3)
    else:
        steps = args.steps or 200
        kw = dict(seq_len=128, global_batch=4, smoke=False, lr=1e-3)

    model, params, opt_state, step, stream = build_trainer(
        "smollm-135m", steps=steps, microbatches=1, remat="none", device=args.device, **kw)
    n_params = sum(x.numel() for x in tree_flatten(params)[0])
    print(f"training smollm-135m ({n_params / 1e6:.1f}M params) on {model.device} "
          f"for {steps} steps, batch {kw['global_batch']}x{kw['seq_len']}")

    def step_fn(state, i):
        p, o = state
        p, o, metrics = step(p, o, stream.batch(i))
        return (p, o), metrics

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    try:
        loop = ft.ResilientLoop(step_fn, ckpt_lib.Checkpointer(ckpt_dir), save_every=25)
        fail_at = {steps // 2}

        def failure_hook(i):
            if i in fail_at:
                fail_at.remove(i)
                print(f"  !! injecting simulated node failure at step {i}")
                raise RuntimeError("simulated failure")

        _, report = loop.run((params, opt_state), steps, failure_hook=failure_hook,
                             log_every=max(1, steps // 10))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"final step {report.final_step}, restarts {report.restarts}")
    print(f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f} "
          f"({'improved' if report.losses[-1] < report.losses[0] else 'NO'})")


if __name__ == "__main__":
    main()
