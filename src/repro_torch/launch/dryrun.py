"""Multi-node dry-run on H100 nodes: prove the distribution config is
coherent and derive its roofline terms, with no card (a port of the JAX
package's ``launch/dryrun.py``).

For an (architecture x applicable input shape) cell on a production mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`: 32 x 8 = 256 cards,
or 2 x 32 x 8 = 512), this driver

  1. opens a process group of the ``"fake"`` backend with one process
     standing for every rank (:func:`repro_torch.fake.open_fake_group`),
     never at import, and hides the host's cards from its process;
  2. builds the step (``train_step`` / ``prefill_step`` / ``serve_step``)
     and its arguments as ``meta`` tensors (shape and dtype, no data: the
     fake card, within ``fake.modeling()``, where K1-K4 answer them by
     their shape rule) placed as DTensors by
     :mod:`repro_torch.launch.sharding`'s rules; a sharding the model's
     code cannot run fails here;
  3. runs one step under the op counter (:mod:`.op_cost`), which counts
     what rank 0 runs on its local shards: FLOPs, HBM bytes (the kernels'
     own records for K1-K4), collectives with the mesh dim each crosses, the
     ``attn_core`` scope, and the peak of live storages (the fits-per-card
     proof: ``fits`` says whether ``peak_bytes`` fits in the card's 80 GB);
  4. writes the reference's record (same fields), with the roofline terms
     from the H100 constants below.

The XLA dry-run lowers and compiles a program; the port's step is eager,
so "lowering" here is building the step and placing its arguments
(``lower_s``) and "compiling" is the counted step (``compile_s``).
``unroll`` is accepted and recorded: XLA's layer scans need it to make
``cost_analysis()`` see every layer, and an eager step runs every layer
anyway, so it changes nothing.  Eager PyTorch donates nothing either: the
step's inputs stay live beside its outputs, and ``peak_bytes`` counts both.

Roofline constants are datasheet figures of the NVIDIA H100 80GB HBM3 SXM
card at 700 W, not measurements.  A collective is charged at the
bandwidth of the mesh dim it crosses: NVLink inside a node (``model``),
InfiniBand between nodes (``data`` and ``pod``).

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k --multi-pod
  python -m repro_torch.launch.dryrun --all --out build/dryrun/all.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Any

import torch

from .. import configs, fake
from ..configs.base import SHAPES, applicable_shapes
from ..core.tree import tree_flatten, tree_unflatten
from ..models import get_model
from ..serve.steps import decode_cache_window, make_prefill_step, make_serve_step
from ..train import optimizer as opt_lib
from ..train import train_step as ts
from . import op_cost
from . import sharding as sh
from .mesh import (axis_rules, axis_sizes, batch_axes, make_mesh, make_production_mesh,
                   num_chips)

# ---------------------------------------------------------------------------
# H100 hardware model (roofline constants; NVIDIA H100 80GB HBM3 SXM, 700 W,
# datasheet figures)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
HBM_BYTES = 80e9  # device memory per card
NVLINK_BW = 450e9  # bytes/s each way per card, inside a node (the model dim)
IB_BW = 50e9  # bytes/s per card between nodes (400 Gb/s InfiniBand: data, pod)
LINK_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

#: The card the constants describe, written into every record.
HARDWARE = "NVIDIA H100 80GB HBM3 SXM, 700 W (datasheet constants)"

# effective bytes-on-the-wire multiplier per collective kind (ring algos)
_WIRE_FACTOR = {
    "all-reduce": 2.0,  # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "broadcast": 1.0,
}

#: Ranks of the fake group a dry-run opens: enough for both production
#: meshes, so one process can sweep both.
FAKE_WORLD = 512


def collective_seconds(coll: dict) -> float:
    """Each collective's bytes over the bandwidth of the mesh dim it
    crosses (InfiniBand for a dim no mesh names)."""
    return sum(
        d["bytes"] * _WIRE_FACTOR.get(kind, 1.0) / LINK_BW.get(dim, IB_BW)
        for kind, v in coll.items() for dim, d in v["dims"].items()
    )


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in tuple(mesh.shape))


# ---------------------------------------------------------------------------
# Case construction
# ---------------------------------------------------------------------------


def default_microbatches(arch: str, shape_name: str, mesh) -> int:
    """Gradient-accumulation factor targeting ~8k local tokens per
    microbatch (the production memory lever; recorded per cell), over the
    data ranks the batch shards over (``batch_axes``).  ``mesh`` is a
    ``DeviceMesh`` or a stand-in with ``mesh_dim_names`` and ``shape``."""
    shape = SHAPES[shape_name]
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in batch_axes(mesh, shape.global_batch))
    local_tokens = shape.global_batch * shape.seq_len // dp
    local_seqs = max(1, shape.global_batch // dp)
    mb = max(1, local_tokens // 8192)
    return min(mb, local_seqs)  # cannot split below 1 sequence


def _config(arch: str, cfg_overrides: dict | None):
    cfg = configs.get_config(arch)
    return dataclasses.replace(cfg, **cfg_overrides) if cfg_overrides else cfg


def build_case(arch: str, shape_name: str, mesh, *, unroll: bool = True,
               remat: str = "full", compress_grads: bool = False,
               use_flash: bool = False, microbatches: int = 1,
               cfg_overrides: dict | None = None):
    """Returns ``(name, fn, args, in_shardings, out_shardings)``: ``args``
    are meta tensors of the global shapes, to be placed by
    ``in_shardings``; ``out_shardings`` places the step's result (None:
    as it comes).  Run ``fn`` within ``fake.modeling()``.  ``unroll``
    changes nothing in eager (see the module docstring)."""
    cfg = _config(arch, cfg_overrides)
    shape = SHAPES[shape_name]
    host = get_model(cfg, device="cpu")
    model = get_model(cfg, use_flash=use_flash, device="meta")
    # The decode cache's batch rows shard over ``data`` alone
    # (``sharding.cache_shardings``), the activations' over the data axes
    # that divide the batch (``batch_axes``, as ``batch_shardings`` places it).
    model.axis_rules = dict(axis_rules(mesh, shape.global_batch), cache_batch="data")
    params = fake.build_meta(lambda: host.init(torch.Generator().manual_seed(0)))
    pshard = sh.param_shardings(params, mesh)

    if shape.kind == "train":
        tcfg = ts.TrainConfig(
            microbatches=microbatches, remat=remat,
            opt=opt_lib.OptimizerConfig(compress_grads=compress_grads),
        )
        step = ts.make_train_step(model, tcfg)
        opt_state = opt_lib.init_opt_state(params, tcfg.opt)
        oshard = sh.opt_state_shardings(opt_state, params, mesh)
        batch = model.input_specs(shape)
        bshard = sh.batch_shardings(batch, mesh)
        in_shardings = (pshard, oshard, bshard)
        out_shardings = (pshard, oshard, None)
        return "train_step", step, (params, opt_state, batch), in_shardings, out_shardings

    if shape.kind == "prefill":
        step = make_prefill_step(model)
        batch = model.input_specs(shape)
        bshard = sh.batch_shardings(batch, mesh)
        return "prefill_step", step, (params, batch), (pshard, bshard), None

    # decode
    window = decode_cache_window(cfg, shape)
    b = shape.global_batch
    serve = make_serve_step(model)
    cache = fake.build_meta(lambda: host.init_cache(b, window))
    cshard = sh.cache_shardings(cache, b, mesh)
    tok = torch.empty((b,), dtype=torch.int32, device="meta")
    pos = torch.empty((b,), dtype=torch.int32, device="meta")
    key = torch.empty((2,), dtype=torch.int32, device="meta")
    bshard = sh.batch_shardings({"t": tok, "p": pos}, mesh)
    in_shardings = (pshard, cshard, bshard["t"], bshard["p"], sh.replicated(mesh))
    out_shardings = (bshard["t"], cshard)
    return "serve_step", serve, (params, cache, tok, pos, key), in_shardings, out_shardings


def _place(tree, shardings):
    """Each leaf of a meta ``tree`` as a DTensor placed by its sharding,
    its local shard a tensor of its own (not a view of the whole
    array), as each rank would hold it.  A ``None`` sharding leaves the
    tree as it is."""
    if shardings is None:
        return tree
    from torch.distributed.tensor import DTensor

    leaves, treedef = tree_flatten(tree)
    shards = tree_flatten(shardings)[0]
    out = []
    for x, s in zip(leaves, shards):
        if isinstance(x, DTensor):
            x = x.redistribute(s.mesh, s.placements)
        else:
            x = sh.distribute(x, s)
            x = DTensor.from_local(x.to_local().clone(), s.mesh, x.placements,
                                   run_check=False, shape=x.shape, stride=x.stride())
        out.append(x)
    return tree_unflatten(treedef, out)


def model_flops_per_chip(arch: str, shape_name: str, chips: int) -> float:
    """Useful model FLOPs per chip per step: 6·N_active·tokens for train
    (fwd+bwd), 2·N_active·tokens for inference steps."""
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:  # decode: one token per sequence per step
        tokens = shape.global_batch
        mult = 2.0
    return mult * n * tokens / chips


def bytes_floor_per_chip(arch: str, shape_name: str, chips: int) -> float:
    """Lower bound on HBM traffic per chip per step.

    train:   3 bf16 weight streams (fwd, bwd-dgrad, bwd-wgrad) + AdamW
             state read/write (f32 mu, nu, params);
    prefill: one bf16 weight stream;
    decode:  one bf16 weight stream + one pass over the KV/state cache.
    """
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    n = cfg.active_param_count()
    if shape.kind == "train":
        return (3 * 2 * n + 3 * 2 * 4 * n) / chips
    if shape.kind == "prefill":
        return 2 * n / chips
    # decode: cache bytes from the cache tree, on the meta device
    window = decode_cache_window(cfg, shape)
    cache = get_model(cfg, device="meta").init_cache(shape.global_batch, window)
    cache_bytes = sum(x.numel() * x.element_size() for x in tree_flatten(cache)[0])
    return (2 * n + cache_bytes) / chips


def attn_flash_io_bytes(arch: str, shape_name: str, chips: int,
                        cfg_overrides: dict | None = None) -> float:
    """Per-chip HBM traffic of attention if the flash kernel (K3) ran
    instead of the blocked attention: q,k,v read + o written per
    application (x3 passes for training: fwd, bwd reads + dq/dk/dv)."""
    cfg = _config(arch, cfg_overrides)
    shape = SHAPES[shape_name]
    if cfg.family == "ssm":
        return 0.0
    if cfg.family == "hybrid":
        n_apps = cfg.num_layers // cfg.shared_attn_every
    else:
        n_apps = cfg.num_layers
    dh = cfg.resolved_head_dim
    if shape.kind == "decode":
        tokens = shape.global_batch  # one new token each; cache bytes are
        # already part of the floor — flash-decode reads the cache once.
        passes = 1
    else:
        tokens = shape.global_batch * shape.seq_len
        passes = 3 if shape.kind == "train" else 1
    io = tokens * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) * 2
    return passes * n_apps * io / chips


def _ensure_group(world: int) -> None:
    """Open the fake default group unless one of at least ``world`` ranks
    is open.  A process that opens it models the cards and uses none: it
    hides the host's cards from itself first (unless CUDA is already up),
    so that the ``"cuda"`` mesh sets no real device."""
    import os

    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"the open process group has {dist.get_world_size()} ranks; "
                               f"this mesh needs {world}")
        return
    if not torch.cuda.is_initialized():
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    fake.open_fake_group(max(world, FAKE_WORLD))


def count_step(name: str, fn, args: tuple, in_shardings, out_shardings, mesh
               ) -> tuple[op_cost.Cost, float, float]:
    """Place ``args``, run ``fn`` once under a counter and place its result
    by ``out_shardings``: ``(cost, placing seconds, step seconds)``."""
    t0 = time.time()
    args = tuple(_place(a, s) for a, s in zip(args, in_shardings))
    t_place = time.time() - t0
    counter = op_cost.OpCounter(meshes=[mesh])
    t0 = time.time()
    with torch.no_grad() if name != "train_step" else torch.enable_grad(), counter:
        counter.arguments(args)
        out = fn(*args)
        if out_shardings is not None:
            out = tuple(o if s is None else _place(o, s) for o, s in zip(out, out_shardings))
        counter.outputs(out)
    return counter.close(), t_place, time.time() - t0


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             unroll: bool = False, remat: str = "full",
             compress_grads: bool = False, use_flash: bool = False,
             cfg_overrides: dict | None = None,
             microbatches: int | None = None,
             mesh_shape: tuple | None = None,
             verbose: bool = True) -> dict[str, Any]:
    """Build and count the production configuration (gradient
    accumulation, remat) and derive the roofline terms.

    FLOPs, bytes and collectives are what rank 0 runs in one eager step,
    counted op by op (:mod:`.op_cost`); every layer runs, so no loop
    accounting is needed and ``unroll`` changes nothing.  ``mesh_shape``
    remeshes the same cards logically (e.g. ``(64, 4)``).
    """
    if mesh_shape is not None:
        axes = (("pod", "data", "model") if len(mesh_shape) == 3
                else ("data", "model"))
        _ensure_group(math.prod(mesh_shape))
        mesh = make_mesh(tuple(mesh_shape), axes)
    else:
        _ensure_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
    chips = num_chips(mesh)
    is_train = SHAPES[shape_name].kind == "train"
    if microbatches is None:
        microbatches = (
            default_microbatches(arch, shape_name, mesh) if is_train else 1
        )
    t0 = time.time()
    with fake.modeling():
        name, fn, args, in_sh, out_sh = build_case(
            arch, shape_name, mesh, unroll=unroll, remat=remat,
            compress_grads=compress_grads, use_flash=use_flash,
            microbatches=microbatches, cfg_overrides=cfg_overrides,
        )
        t_build = time.time() - t0
        cost, t_place, t_step = count_step(name, fn, args, in_sh, out_sh, mesh)
    flops, bytes_accessed = cost.flops, cost.bytes_accessed
    coll = cost.collectives
    scope_bytes = cost.scope_bytes
    result = {
        "arch": arch,
        "shape": shape_name,
        "step": name,
        "mesh": mesh_name(mesh),
        "chips": chips,
        "unroll": unroll,
        "remat": remat,
        "microbatches": microbatches,
        # memory (per device)
        "argument_bytes": cost.argument_bytes,
        "output_bytes": cost.output_bytes,
        "temp_bytes": cost.temp_bytes,
        "peak_bytes": cost.peak_bytes,
        "hbm_bytes": HBM_BYTES,
        "fits": cost.peak_bytes <= HBM_BYTES,
        # cost (per device, on the local shards)
        "hlo_flops": flops,
        "hlo_bytes": bytes_accessed,
        "model_flops": model_flops_per_chip(arch, shape_name, chips),
        "collectives": coll,
        "collective_bytes": cost.collective_bytes,
        "kernels": cost.kernels,
        # roofline terms (seconds)
        "t_compute": flops / PEAK_FLOPS,
        "t_memory": bytes_accessed / HBM_BW,
        "t_collective": collective_seconds(coll),
        "lower_s": round(t_build + t_place, 1),
        "compile_s": round(t_step, 1),
        "hardware": HARDWARE,
    }
    terms = {
        "compute": result["t_compute"],
        "memory": result["t_memory"],
        "collective": result["t_collective"],
    }
    result["bottleneck"] = max(terms, key=terms.get)
    result["useful_flops_ratio"] = (
        result["model_flops"] / flops if flops else 0.0
    )
    # roofline fraction: ideal step time (the larger of the useful-FLOPs
    # bound and the bytes-floor bound) over the dominant achieved term
    floor = bytes_floor_per_chip(arch, shape_name, chips)
    result["bytes_floor"] = floor
    t_bound = max(terms.values())
    t_ideal = max(result["model_flops"] / PEAK_FLOPS, floor / HBM_BW)
    result["t_ideal"] = t_ideal
    result["roofline_fraction"] = t_ideal / t_bound if t_bound else 0.0
    # ---- flash-kernel modeling: K3 keeps score blocks on chip, so the
    # attn_core scope's HBM traffic collapses to the q/k/v/o streams ----
    result["scope_bytes"] = scope_bytes
    attn_scope = scope_bytes.get("attn_core", 0.0)
    if attn_scope:
        flash_io = attn_flash_io_bytes(arch, shape_name, chips,
                                       cfg_overrides)
        bytes_flash = bytes_accessed - attn_scope + flash_io
        t_mem_flash = bytes_flash / HBM_BW
        result["t_memory_flash"] = t_mem_flash
        terms_f = dict(terms, memory=t_mem_flash)
        tb_f = max(terms_f.values())
        result["bottleneck_flash"] = max(terms_f, key=terms_f.get)
        result["roofline_fraction_flash"] = (
            t_ideal / tb_f if tb_f else 0.0
        )
    if verbose:
        print(json.dumps(result, indent=2, default=float))
    return result


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def all_cells() -> list[tuple[str, str]]:
    cells = []
    for arch in configs.list_archs():
        for shape in applicable_shapes(configs.get_config(arch)):
            cells.append((arch, shape.name))
    return cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=configs.list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="sweep every applicable cell on this mesh")
    ap.add_argument("--unroll", action="store_true",
                    help="recorded only: an eager step runs every layer anyway")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--use-flash", action="store_true")
    ap.add_argument("--out", help="write JSON result(s) to this path")
    args = ap.parse_args(argv)

    results = []
    if args.all:
        for arch, shape in all_cells():
            print(f"=== {arch} x {shape} ({'2x32x8' if args.multi_pod else '32x8'}) ===",
                  flush=True)
            results.append(run_cell(
                arch, shape, multi_pod=args.multi_pod, unroll=args.unroll,
                remat=args.remat, compress_grads=args.compress_grads,
                use_flash=args.use_flash,
            ))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        results.append(run_cell(
            args.arch, args.shape, multi_pod=args.multi_pod, unroll=args.unroll,
            remat=args.remat, compress_grads=args.compress_grads,
            use_flash=args.use_flash,
        ))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
