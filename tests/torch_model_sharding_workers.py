"""What the ranks of tests/test_torch_model_sharding.py run.

:func:`model_sharding` runs in each of four ranks that
``repro_torch.distributed.spawn`` starts on the CPU (``fn(rank, device,
...)``), on a ``(data 2, model 2)`` mesh and two ``(pod, data, model)``
meshes of the same ranks, and returns plain numpy and
Python values for the test to hold against the JAX package's sharded runs.
This module imports no JAX: with ``spawn`` each rank imports it anew.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import distributed, interop
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as sh
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as moe_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import train_step as ts

ARCHS = ("smollm-135m", "deepseek-moe-16b", "zamba2-7b", "xlstm-350m", "qwen2-vl-2b",
         "hubert-xlarge")
KW = dict(seq_len=32, global_batch=4, steps=100, lr=1e-3, microbatches=1, remat="none",
          smoke=True)
MESH = ((2, 2), ("data", "model"))
EXPERT_WEIGHTS = ("wg", "wu", "wd")


def _whole(tree) -> dict:
    """Every leaf gathered to numpy, keyed by its path (a collective)."""
    out = {}
    for path, x in tree_flatten_with_path(tree)[0]:
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        out["/".join(path)] = x.detach().cpu().numpy()
    return out


def _locals(tree) -> list:
    return [x.to_local().clone() for x in tree_flatten(tree)[0]]


def _trainer(arch, mesh, device, np_params, microbatches: int = 1):
    model, _, opt_state, step, stream = launch_train.build_trainer(
        arch, mesh=mesh, device=device, **dict(KW, microbatches=microbatches))
    params = interop.lm_params_from_numpy(np_params, model.cfg, device)
    return model, sh.distribute(params, sh.param_shardings(params, mesh)), opt_state, step, stream


def _expert_grads(model, params, batch, mesh) -> dict:
    """The loss's gradients w.r.t. the MoE layers' expert weights and
    router, gathered."""
    batch = sh.distribute(batch, sh.batch_shardings(batch, mesh))
    (loss, _), grads = ts._value_and_grad(lambda p, b: model.loss(p, b), params, batch)
    moe = grads["layers"]["moe"]
    return {n: moe[n].full_tensor().cpu().numpy() for n in EXPERT_WEIGHTS + ("router",)}


def _checkpoints(mesh, device, np_params, ckpt_dir) -> dict:
    """SmolLM on the mesh: save after step 2, restore unsharded and back
    onto the mesh, replay step 3; and the restart loop with a failure."""
    model, params, opt_state, step, stream = _trainer("smollm-135m", mesh, device, np_params)
    state = (params, opt_state)
    for i in range(2):
        p, o, _ = step(*state, stream.batch(i))
        state = (p, o)
    ck = ckpt_lib.Checkpointer(ckpt_dir)
    ck.save(2, state)
    _, _, m3 = step(*state, stream.batch(2))
    whole = _whole(state)
    plain = ft.reshard(state, "cpu")  # the unsharded layout, every leaf whole
    unsharded = ck.restore(2, like=plain)
    shardings = (sh.param_shardings(params, mesh),
                 sh.opt_state_shardings(opt_state, params, mesh))
    back = ck.restore(2, like=plain, shardings=shardings)
    _, _, m3b = step(*back, stream.batch(2))
    out = dict(
        unsharded_equal=all(np.array_equal(whole["/".join(k)], v.numpy())
                            for k, v in tree_flatten_with_path(unsharded)[0]),
        sharded_equal=all(torch.equal(a, b) for a, b in zip(_locals(state), _locals(back))),
        same_placements=all(tuple(a.placements) == tuple(b.placements) for a, b in zip(
            tree_flatten(state)[0], tree_flatten(back)[0])),
        loss3=float(m3["loss"]), loss3_replayed=float(m3b["loss"]),
        reshard_equal=all(torch.equal(a, b) for a, b in zip(
            _locals(state), _locals(ft.reshard(plain, shardings)))))

    # The restart loop: a failure at step 2 restores step 1 and replays.
    def run(directory, fail_at):
        def step_fn(s, i):
            p, o, m = step(*s, stream.batch(i))
            return (p, o), m

        def hook(i):
            if i == fail_at and not failed:
                failed.append(i)
                raise RuntimeError("injected")

        failed: list = []
        loop = ft.ResilientLoop(step_fn, ckpt_lib.Checkpointer(directory), save_every=1)
        final, report = loop.run((params, opt_state), 3, failure_hook=hook)
        return _whole(final), report
    clean, r1 = run(f"{ckpt_dir}/clean", None)
    faulty, r2 = run(f"{ckpt_dir}/faulty", 2)
    out.update(loop_restarts=(r1.restarts, r2.restarts), loop_losses=(r1.losses, r2.losses),
               loop_equal=all(np.array_equal(clean[k], faulty[k]) for k in clean))
    return out


def _small_mesh_saves(rank: int, device, ckpt_dir) -> dict:
    """Two ``(1, 2)`` meshes in the four-rank world, ranks 0-1 and ranks
    2-3, each saving a sharded tree on its own: the mesh's first rank
    writes, and the barrier waits for the mesh's ranks alone."""
    from torch.distributed.device_mesh import DeviceMesh

    meshes = (mesh_lib.make_mesh((1, 2), MESH[1], device_type=device.type),
              DeviceMesh(device.type, [[2, 3]], mesh_dim_names=MESH[1]))
    mine = rank // 2
    mesh = meshes[mine]
    w = torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * mine
    tree = sh.distribute({"b": w[0].to(device), "w": w.to(device)},
                         {"b": sh.NamedSharding(mesh, ("model",)),
                          "w": sh.NamedSharding(mesh, (None, "model"))})
    ck = ckpt_lib.Checkpointer(f"{ckpt_dir}/mesh{mine}")
    ck.save(1, tree)
    got = ck.restore(1, like={"b": w[0], "w": w})
    return dict(steps=ck.all_steps(), equal=torch.equal(got["w"], w) and torch.equal(
        got["b"], w[0]))


def _odd_heads(mesh, device) -> dict:
    """SmolLM's smoke config with 3 query heads and 1 KV head, which the
    ``model`` axis does not divide: one step unsharded and on the mesh,
    from the same weights."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import get_model
    from repro_torch.train import data as data_lib
    from repro_torch.train import optimizer as opt_lib

    cfg = dataclasses.replace(configs.get_smoke_config("smollm-135m"), d_model=96, num_heads=3,
                              num_kv_heads=1)
    tcfg = ts.TrainConfig(microbatches=1, remat="none",
                          opt=opt_lib.OptimizerConfig(peak_lr=1e-3, warmup_steps=0,
                                                      total_steps=10))
    out = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        model = get_model(cfg, device=device)
        params = model.init(torch.Generator().manual_seed(0))
        opt_state = opt_lib.init_opt_state(params, tcfg.opt)
        step = ts.make_train_step(model, tcfg)
        if m is not None:
            params, opt_state, step = launch_train.shard_trainer(model, params, opt_state, step, m,
                                                                 4)
        batch = data_lib.SyntheticStream(model, ShapeSpec("odd", 32, 4, "train")).batch(0)
        new_params, new_opt, metrics = step(params, opt_state, batch)
        out[name] = dict(loss=float(metrics["loss"]), lr=float(metrics["lr"]),
                         params=_whole(new_params), mu=_whole(new_opt["mu"]))
    return out


MICROBATCHES = 2


def _microbatched(mesh, device, np_params) -> dict:
    """SmolLM on the mesh at ``MICROBATCHES`` microbatches through
    ``build_trainer(mesh=)`` and unsharded, from the same weights; each
    rank's counted FLOPs for the sharded step at 1 and at
    ``MICROBATCHES``; each microbatch's local rows and whether it holds the
    reference's rows; the last microbatch's loss, unsharded, at the step's
    compute weights (the step's ``ce`` is that microbatch's); and what
    splitting a batch of one row a microbatch over the data ranks raises."""
    from repro_torch.launch import op_cost

    arch = "smollm-135m"
    _, params, opt_state, step, stream = _trainer(arch, mesh, device, np_params, MICROBATCHES)
    batch = stream.batch(0)
    new_params, new_opt, metrics = step(params, opt_state, batch)
    out = dict(sharded=dict(loss=float(metrics["loss"]), ce=float(metrics["ce"]),
                            lr=float(metrics["lr"]), params=_whole(new_params),
                            mu=_whole(new_opt["mu"])))
    flops = {}
    for n in (1, MICROBATCHES):
        counted = _trainer(arch, mesh, device, np_params, n)[3]
        flops[n] = op_cost.count(counted, params, opt_state, batch, meshes=[mesh])[1].flops
    out["flops"] = flops
    placed = sh.distribute(batch, sh.batch_shardings(batch, mesh))
    mbs = ts._split_microbatches(placed, MICROBATCHES)
    rows = batch["tokens"].shape[0] // MICROBATCHES
    out["local_rows"] = [tuple(mb["tokens"].to_local().shape) for mb in mbs]
    out["placements"] = [str(tuple(mb["tokens"].placements)) for mb in mbs]
    out["reference_rows"] = all(
        torch.equal(mb["tokens"].full_tensor(), batch["tokens"][i * rows:(i + 1) * rows])
        for i, mb in enumerate(mbs))
    two = {"tokens": batch["tokens"][:MICROBATCHES]}  # half a row a rank a microbatch
    try:
        ts._split_microbatches(sh.distribute(two, sh.batch_shardings(two, mesh)), MICROBATCHES)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    plain, p0, o0, plain_step, _ = launch_train.build_trainer(
        arch, device=device, **dict(KW, microbatches=MICROBATCHES))
    p0 = interop.lm_params_from_numpy(np_params, plain.cfg, device)
    new_params, new_opt, metrics = plain_step(p0, o0, batch)
    out["unsharded"] = dict(loss=float(metrics["loss"]), ce=float(metrics["ce"]),
                            lr=float(metrics["lr"]), params=_whole(new_params),
                            mu=_whole(new_opt["mu"]))
    last = {k: v[-rows:] for k, v in batch.items()}
    out["last_ce"] = float(plain.loss(plain.cast_for_compute(p0), last)[1]["ce"])
    return out


ROUTER_TOKENS = 4 * 1024  # phase 20's DeepSeek batch: 4 sequences of 1,024


def _router_grads(cfg, x, w, c, rules=None) -> torch.Tensor:
    """The gradient of ``sum(top_p * c) + moe_aux_loss`` (the combine
    weights' and the load-balance loss's paths) with respect to the router
    weight ``w``, under ``rules`` if given; gathered."""
    from repro_torch.models import shard_ctx

    w = w.detach().requires_grad_(True)
    with shard_ctx.use_rules(rules):
        top_p, _, aux = moe_lib.router_probs({"router": w}, x, cfg)
        loss = (top_p * c).sum() + aux["moe_aux_loss"]
    g, = torch.autograd.grad(loss, w)
    return g.full_tensor() if hasattr(g, "full_tensor") else g


def _router_gaps(mesh, device) -> dict:
    """DeepSeek-MoE-16B's router alone at full width (d 2,048, 64
    experts, top 6) on ``ROUTER_TOKENS`` seeded tokens, sharded over the
    mesh (rows over ``data``, the weight whole, as the model's step runs
    it) and unsharded, with the same routing: the router gradient's largest
    difference over its largest magnitude, in float32 (the model's
    arithmetic) and with the route computed in float64."""
    from repro_torch import configs
    from repro_torch.models import shard_ctx

    cfg = configs.get_config("deepseek-moe-16b")
    rules = {"batch": mesh_lib.data_axes(mesh), "tp": "model", "ep": "model",
             "sizes": mesh_lib.axis_sizes(mesh), "mesh": mesh}
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((ROUTER_TOKENS, cfg.d_model), generator=gen, dtype=torch.float64)
    w = torch.randn((cfg.d_model, cfg.num_experts), generator=gen, dtype=torch.float64)
    w = w / cfg.d_model ** 0.5
    c = torch.randn((ROUTER_TOKENS, cfg.top_k), generator=gen, dtype=torch.float64)
    route = moe_lib._route
    out = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        if dtype == torch.float64:  # the route's products and softmax in float64 too
            moe_lib._route = lambda x, r, cfg: route(x, r, cfg) if x.dtype != torch.float64 \
                else _route64(x, r, cfg)
        try:
            xd, wd, cd = (t.to(device, dtype) for t in (x, w, c))
            want = _router_grads(cfg, xd, wd, cd)
            placed = sh.distribute({"x": xd, "w": wd, "c": cd},
                                   {"x": sh.NamedSharding(mesh, ("data", None)),
                                    "w": sh.NamedSharding(mesh, (None, None)),
                                    "c": sh.NamedSharding(mesh, ("data", None))})
            got = _router_grads(cfg, placed["x"], placed["w"], placed["c"], rules)
            with shard_ctx.use_rules(rules):
                ids = moe_lib.router_probs({"router": placed["w"]}, placed["x"], cfg)[1]
        finally:
            moe_lib._route = route
        same = torch.equal(ids.full_tensor(), moe_lib.router_probs({"router": wd}, xd, cfg)[1])
        scale = float(want.abs().max())
        out[name] = dict(gap=float((got - want).abs().max()) / scale, scale=scale,
                         same_routing=bool(same))
    return out


def _route64(x: torch.Tensor, router: torch.Tensor, cfg):
    """``moe._route`` with its product and softmax in float64."""
    probs = torch.softmax(x @ router, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :cfg.top_k], top_e[:, :cfg.top_k]
    if cfg.moe_renorm_topk:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_e


# Prefills whose batch the mesh's pods and data ranks together do not
# divide: ``{arch: (mesh shape, batch, sequence)}``, on ``PREFILL_AXES``.
# SmolLM's 2 rows shard over ``data`` 2 (not ``pod`` x ``data`` 4);
# DeepSeek-MoE's 1 row over ``data`` 1, through the expert-parallel path
# over ``model`` 2.
PREFILLS = {"smollm-135m": ((2, 2, 1), 2, 16), "deepseek-moe-16b": ((2, 1, 2), 1, 16)}
PREFILL_AXES = ("pod", "data", "model")


def prefill_tokens(arch: str) -> np.ndarray:
    """The seeded prompts of ``arch``'s prefill in ``PREFILLS``."""
    from repro_torch import configs

    _, b, s = PREFILLS[arch]
    vocab = configs.get_smoke_config(arch).vocab_size
    return np.random.default_rng(5).integers(0, vocab, (b, s)).astype(np.int32)


def _prefills(device, np_params: dict, ep_calls: list) -> dict:
    """Each of ``PREFILLS`` on its mesh through ``make_prefill_step``, the
    model's rules from ``launch.mesh.axis_rules``: the last position's
    logits gathered, this rank's rows of the placed prompts, and how many
    times the expert-parallel path ran."""
    from repro_torch import configs
    from repro_torch.models import get_model
    from repro_torch.serve.steps import make_prefill_step

    out = {}
    for arch, (shape, b, _) in PREFILLS.items():
        mesh = mesh_lib.make_mesh(shape, PREFILL_AXES, device_type=device.type)
        cfg = configs.get_smoke_config(arch)
        model = get_model(cfg, device=device)
        model.axis_rules = mesh_lib.axis_rules(mesh, b)
        params = interop.lm_params_from_numpy(np_params[arch], cfg, device)
        params = sh.distribute(params, sh.param_shardings(params, mesh))
        batch = {"tokens": torch.from_numpy(prefill_tokens(arch)).to(device)}
        batch = sh.distribute(batch, sh.batch_shardings(batch, mesh))
        before = len(ep_calls)
        with torch.no_grad():
            logits = make_prefill_step(model)(params, batch)
        out[arch] = dict(logits=logits.full_tensor().cpu().numpy(),
                         batch_axes=list(model.axis_rules["batch"]),
                         local_rows=list(batch["tokens"].to_local().shape),
                         ep_calls=len(ep_calls) - before)
    return out


def model_sharding(rank: int, device: torch.device, np_params: dict, ckpt_dir: str) -> dict:
    """Saves on meshes smaller than the world, one train step of each
    family on the mesh, the MoE's expert-weight gradients and its path, the
    checkpoint cases, DeepSeek's router alone at full width, and the
    prefills of ``PREFILLS`` on their three-axis meshes.  DTensor's
    all-gathers take the route the card's gloo ranks take."""
    distributed.route_gloo_all_gather("CPU")
    mesh = mesh_lib.make_mesh(*MESH, device_type=device.type)
    ep_calls = []
    ep = moe_lib._moe_ep

    def counted(*args, **kw):
        ep_calls.append(1)
        return ep(*args, **kw)

    moe_lib._moe_ep = counted
    small = _small_mesh_saves(rank, device, ckpt_dir)
    steps = {}
    for arch in ARCHS:
        model, params, opt_state, step, stream = _trainer(arch, mesh, device, np_params[arch])
        batch = stream.batch(0)
        new_params, new_opt, metrics = step(params, opt_state, batch)
        steps[arch] = dict(loss=float(metrics["loss"]), params=_whole(new_params),
                           mu=_whole(new_opt["mu"]),
                           dtensor=all(hasattr(x, "placements") for x in tree_flatten(
                               new_params)[0]))
        if arch == "deepseek-moe-16b":
            steps[arch]["ep_calls"] = len(ep_calls)
            steps[arch]["grads"] = _expert_grads(model, params, batch, mesh)
    out = dict(rank=rank, small_meshes=small, steps=steps, odd_heads=_odd_heads(mesh, device),
               microbatched=_microbatched(mesh, device, np_params["smollm-135m"]),
               ckpt=_checkpoints(mesh, device, np_params["smollm-135m"], ckpt_dir),
               router=_router_gaps(mesh, device), prefills=_prefills(device, np_params, ep_calls))
    if rank:  # every rank gathered; the first one's copy is enough
        for rec in out["steps"].values():
            rec.pop("params")
            rec.pop("mu")
            rec.pop("grads", None)
        for rec in (out["microbatched"]["sharded"], out["microbatched"]["unsharded"]):
            rec.pop("params")
            rec.pop("mu")
    return out
