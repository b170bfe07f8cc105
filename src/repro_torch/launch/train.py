"""Training launcher: ``python -m repro_torch.launch.train --arch smollm-135m``
(a port of the JAX package's ``launch/train.py``).

Wires the training path: config registry -> model -> train step ->
deterministic data stream -> AdamW -> atomic checkpoints -> the resilient
restart loop.  It runs on the CUDA card unless ``--device cpu`` is given;
without a card and without ``--device`` it raises.  The reduced config is
the default; ``--full-size`` trains the published widths.  Under a mesh
(``build_trainer(mesh=)``, one process a rank) the parameters, optimizer
state and every batch are DTensors placed by ``launch.sharding``'s rules.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from .. import configs
from ..configs.base import ShapeSpec
from ..core.tree import tree_flatten
from ..device import resolve_device
from ..distributed import rank_device
from ..models import get_model
from ..train import checkpoint as ckpt_lib
from ..train import data as data_lib
from ..train import fault_tolerance as ft
from ..train import optimizer as opt_lib
from ..train import train_step as ts
from . import sharding as sh
from .mesh import axis_rules


def build_trainer(arch: str, *, seq_len: int, global_batch: int, steps: int, lr: float,
                  microbatches: int, remat: str, smoke: bool, mesh=None,
                  compress_grads: bool = False, device=None):
    """``(model, params, opt_state, step, stream)`` for ``arch`` on ``device``
    (default: the card).  The weights come from a seeded CPU generator, so
    every device starts from the same ones.

    With a ``DeviceMesh`` of dims ``("data", "model")`` or ``("pod",
    "data", "model")`` (``launch.mesh.make_mesh``; every rank calls this),
    the model gets the mesh's ``axis_rules``, the parameters and optimizer
    state are placed by ``param_shardings`` / ``opt_state_shardings``, and
    ``step`` places each batch by ``batch_shardings`` before it runs; the
    default device is then the rank's card (``distributed.rank_device``)."""
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    dev = resolve_device(device) if mesh is None else rank_device(device)
    model = get_model(cfg, device=dev)
    shape = ShapeSpec("cli_train", seq_len, global_batch, "train")
    tcfg = ts.TrainConfig(
        microbatches=microbatches, remat=remat,
        opt=opt_lib.OptimizerConfig(peak_lr=lr, warmup_steps=max(10, steps // 20),
                                    total_steps=steps, compress_grads=compress_grads),
    )
    params = model.init(torch.Generator().manual_seed(0))
    opt_state = opt_lib.init_opt_state(params, tcfg.opt)
    step = ts.make_train_step(model, tcfg)
    if mesh is not None:
        params, opt_state, step = shard_trainer(model, params, opt_state, step, mesh,
                                                global_batch)
    stream = data_lib.SyntheticStream(model, shape)
    return model, params, opt_state, step, stream


def shard_trainer(model, params, opt_state, step, mesh, global_batch: int):
    """``(params, opt_state, step)`` on ``mesh``: the model gets the mesh's
    ``axis_rules`` for batches of ``global_batch`` rows, the parameters and
    optimizer state are placed by the rules (every rank holds the same
    logical arrays), and the step places each batch by ``batch_shardings``
    before it runs."""
    model.axis_rules = axis_rules(mesh, global_batch)
    oshard = sh.opt_state_shardings(opt_state, params, mesh)
    params = sh.distribute(params, sh.param_shardings(params, mesh))
    opt_state = sh.distribute(opt_state, oshard)

    def sharded_step(params, opt_state, batch):
        return step(params, opt_state, sh.distribute(batch, sh.batch_shardings(batch, mesh)))

    return params, opt_state, sharded_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=configs.list_archs())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced smoke)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"),
                    help="checkpoint directory; a run resumes from a checkpoint found there")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    model, params, opt_state, step, stream = build_trainer(
        args.arch, seq_len=args.seq_len, global_batch=args.global_batch,
        steps=args.steps, lr=args.lr, microbatches=args.microbatches,
        remat=args.remat, smoke=not args.full_size, device=args.device,
    )
    n_params = sum(x.numel() for x in tree_flatten(params)[0])
    print(f"arch={model.cfg.name} params={n_params / 1e6:.1f}M device={model.device} "
          f"steps={args.steps} batch={args.global_batch}x{args.seq_len}")

    def step_fn(state, i):
        p, o = state
        p, o, metrics = step(p, o, stream.batch(i))
        return (p, o), metrics

    ckpt = ckpt_lib.Checkpointer(args.ckpt_dir)
    loop = ft.ResilientLoop(step_fn, ckpt, save_every=args.save_every)
    _, report = loop.run((params, opt_state), args.steps, log_every=args.log_every)
    losses = (f"loss: {report.losses[0]:.4f} -> {report.losses[-1]:.4f}" if report.losses
              else "no step ran (resumed at the end)")
    print(f"done: final_step={report.final_step} restarts={report.restarts} {losses}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
