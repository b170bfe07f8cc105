"""What tests/test_torch_dryrun.py and test_torch_run.py run in a fresh
process: the dry-run opens a process group of the ``"fake"`` backend,
which is global to its process.  It imports no JAX.

    python -m tests.torch_dryrun_workers OUT.json          # the checks
    python -m tests.torch_dryrun_workers --record OUT.json # a reduced cell's record
"""
import json
import sys

import torch


def sharded_linear() -> dict:
    """A row-parallel linear on a ``(data 2, model 2)`` mesh of meta tensors:
    ``x [8, 64]`` over (data, model), ``w [64, 32]`` rows over model, the
    product's partial sums all-reduced over model."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import op_cost
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    x = DTensor.from_local(torch.empty(4, 32, device="meta"), mesh, [Shard(0), Shard(1)],
                           run_check=False, shape=torch.Size((8, 64)), stride=(64, 1))
    w = DTensor.from_local(torch.empty(32, 32, device="meta"), mesh, [Replicate(), Shard(0)],
                           run_check=False, shape=torch.Size((64, 32)), stride=(32, 1))
    _, cost = op_cost.count(lambda a, b: (a @ b).redistribute(mesh, [Shard(0), Replicate()]),
                            x, w, meshes=[mesh])
    return dict(flops=cost.flops, unsharded_flops=2.0 * 8 * 64 * 32,
                collectives=cost.collectives)


SHARE_ARCH, SHARE_LAYERS, SHARE_MICROBATCHES = "qwen3-14b", 1, (1, 4)


def rank_share() -> dict:
    """One rank's train step of Qwen3-14B at one layer on 32 x 8
    (``train_4k``: 256 x 4,096 tokens, remat ``full``) counted at 1 and 4
    microbatches; the same step unsharded (meta tensors, no mesh, the
    global batch) counted once; and the local rows of each microbatch of
    the placed batch."""
    import dataclasses

    from repro_torch import configs, fake
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import get_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    over = {"num_layers": SHARE_LAYERS}
    out = {"sharded": {n: dryrun.run_cell(SHARE_ARCH, "train_4k", cfg_overrides=over,
                                          microbatches=n, verbose=False)["hlo_flops"]
                       for n in SHARE_MICROBATCHES}}
    cfg = dataclasses.replace(configs.get_config(SHARE_ARCH), **over)
    params = fake.build_meta(
        lambda: get_model(cfg, device="cpu").init(torch.Generator().manual_seed(0)))
    model = get_model(cfg, device="meta")
    tcfg = ts.TrainConfig(microbatches=1, remat="full", opt=opt_lib.OptimizerConfig())
    batch = model.input_specs(SHAPES["train_4k"])
    with fake.modeling():
        out["unsharded"] = op_cost.count(ts.make_train_step(model, tcfg), params,
                                         opt_lib.init_opt_state(params, tcfg.opt),
                                         batch)[1].flops
    mesh = make_production_mesh()
    placed = dryrun._place(batch, sh.batch_shardings(batch, mesh))
    n = SHARE_MICROBATCHES[-1]
    out["local_rows"] = [list(mb["tokens"].to_local().shape)
                         for mb in ts._split_microbatches(placed, n)]
    out["global_rows"] = [batch["tokens"].shape[0], n, mesh.size(0)]
    return out


# ``prefill_32k`` cells (32 sequences) cut in depth: DeepSeek-MoE-16B's
# first layer is dense, so two layers count one MoE layer.
PREFILL_CELLS = {"deepseek-moe-16b": 2, "qwen3-14b": 1}


def multi_pod_prefill() -> dict:
    """Each of ``PREFILL_CELLS`` on both production meshes: the record's
    FLOPs, peak, fits and useful ratio, or the error the cell raised; and
    Qwen3-14B's placed ``tokens`` on a rank of each mesh."""
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import get_model

    out = {}
    for arch, layers in PREFILL_CELLS.items():
        out[arch] = {}
        for multi in (False, True):
            mesh = "2x32x8" if multi else "32x8"
            try:
                rec = dryrun.run_cell(arch, "prefill_32k", multi_pod=multi, verbose=False,
                                      cfg_overrides={"num_layers": layers})
                out[arch][mesh] = {k: rec[k] for k in ("hlo_flops", "peak_bytes", "fits",
                                                       "useful_flops_ratio")}
            except Exception as e:  # the test names the failure
                out[arch][mesh] = {"error": f"{type(e).__name__}: {e}"[:500]}
    batch = get_model(configs.get_config("qwen3-14b"), device="meta").input_specs(
        SHAPES["prefill_32k"])
    out["tokens"] = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        placed = dryrun._place(batch, sh.batch_shardings(batch, mesh))
        out["tokens"][dryrun.mesh_name(mesh)] = list(placed["tokens"].to_local().shape)
    return out


def production() -> dict:
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh, num_chips

    out = {"meshes": {}}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        out["meshes"][str(multi)] = [list(mesh.shape), list(mesh.mesh_dim_names), num_chips(mesh)]
    out["cell"] = dryrun.run_cell("smollm-135m", "decode_32k", verbose=False)
    return out


def main(argv) -> int:
    from repro_torch import fake
    from repro_torch.launch import dryrun

    if argv[0] == "--record":
        rec = dryrun.run_cell("smollm-135m", "decode_32k", cfg_overrides={"num_layers": 2},
                              verbose=False)
        with open(argv[1], "w") as f:
            json.dump([rec], f, default=float)
        return 0
    fake.open_fake_group(dryrun.FAKE_WORLD)
    res = {"linear": sharded_linear(), **production(), "share": rank_share(),
           "prefill": multi_pod_prefill()}
    with open(argv[0], "w") as f:
        json.dump(res, f, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
