"""The port's model sharding (``launch/mesh.py``, ``launch/sharding.py``,
``models/shard_ctx.py``, the MoE's expert-parallel path,
``build_trainer(mesh=)``, resharded restore) against the JAX package's.

* **The rule tables**: every parameter, optimizer, batch and cache leaf's
  spec equals the JAX package's, for every config (smoke and full; shapes
  from ``jax.eval_shape``) on stand-in meshes of (2, 2), (16, 16) and
  (2, 16, 16), so no ranks are needed.
* **One sharded train step of each family**: four gloo ranks on the CPU,
  started once for the module by ``repro_torch.distributed.spawn``, with
  DTensor's all-gathers routed as on the card
  (``distributed.route_gloo_all_gather``), run
  tests/torch_model_sharding_workers.py (which imports no JAX) on a
  ``(data 2, model 2)`` DeviceMesh, from the same weights; the JAX side runs
  ``build_trainer(mesh=)`` on four of tests/conftest.py's host devices.
  Under JAX 0.9 the JAX side needs three things its package does not do: a
  mesh with ``Auto`` axes (``jax.sharding.Mesh``, not ``jax.make_mesh``),
  the step called under ``jax.set_mesh``, and the batch placed on
  ``batch_shardings`` first.  DeepSeek-MoE takes the expert-parallel path
  in both, with its per-shard capacity and drops, so it is held to the
  JAX package's sharded step (not its unsharded one, which drops others).
* **The MoE's gradients** on that path equal ``jax.grad`` of the same
  sharded loss (a double-counted combine would scale them by the ``model``
  size); DeepSeek-MoE-16B's router alone at full width, sharded and
  unsharded in the same ranks, differs by rounding (float64).
* **Microbatches**: SmolLM's step at two microbatches on the mesh equals
  the unsharded one and the JAX package's sharded one; each microbatch
  stays sharded over ``data`` (one row a rank) and is the reference's rows;
  a rank's counted FLOPs do not grow with the microbatches; a split that
  would leave part of a row a rank raises.
* **A batch over ``data`` alone**: a dense prefill on ``(pod 2, data 2,
  model 1)`` at batch 2 and DeepSeek-MoE's on ``(pod 2, data 1, model
  2)`` at batch 1 (the expert-parallel path), in the same four ranks,
  equal the JAX package's unsharded prefill.
* **Checkpoints**: a sharded state saves the logical arrays, restores
  unsharded and back onto the mesh bit-exact, and replays a step with the
  same loss; the restart loop replays a failure bit-exact; meshes smaller
  than the world save on their own.
"""
import concurrent.futures
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.launch import sharding as j_sh  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serve import steps as j_steps  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro_torch import configs, distributed, interop  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from tests import torch_model_sharding_workers as workers  # noqa: E402
from tests import torch_parity as tp  # noqa: E402

LOSS_TOL = dict(rtol=1e-5)  # tests/test_torch_train.py's
UPDATE_TOL = dict(rtol=1e-5, atol=1e-7)
MESHES = [((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


# ---------------------------------------------------------------------------
# The rule tables, on stand-in meshes
# ---------------------------------------------------------------------------


def _stand_ins(shape, axes):
    """A mesh stand-in for each package: the JAX rules read ``axis_names``
    and ``devices.shape``, the port's ``mesh_dim_names`` and ``shape``."""
    j = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, np.int8))
    t = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
    return j, t


def _specs(tree) -> list:
    """Leaves of a tree of either package's shardings, as spec tuples."""
    return [tuple(x.spec) for x in jax.tree.leaves(
        tree, is_leaf=lambda x: hasattr(x, "spec"))]


@pytest.fixture
def j_named(monkeypatch):
    """The JAX rules make ``NamedSharding(mesh, spec)``, which needs real
    devices; on a stand-in mesh they keep the spec."""
    monkeypatch.setattr(j_sh, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", j_configs.list_archs())
def test_rule_tables_match_jax(j_named, arch, mesh):
    jm_, tm_ = _stand_ins(*mesh)
    for smoke in (True, False):
        jcfg = (j_configs.get_smoke_config if smoke else j_configs.get_config)(arch)
        cfg = (configs.get_smoke_config if smoke else configs.get_config)(arch)
        jmodel = j_get_model(jcfg)
        pshape = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        want = [tuple(j_sh.param_spec(j_sh._path_str(p), tuple(x.shape), jm_))
                for p, x in jax.tree_util.tree_flatten_with_path(pshape)[0]]
        got = _specs(sh.param_shardings(pshape, tm_))
        assert got == want, (arch, smoke)
        assert any(any(e is not None for e in s) for s in got)
        oshape = {"step": 0, "mu": pshape, "nu": pshape}
        assert _specs(sh.opt_state_shardings(oshape, pshape, tm_)) == _specs(
            j_sh.opt_state_shardings(oshape, pshape, jm_))
        model = get_model(cfg, device="cpu")
        for b, s, kind in ((4, 32, "train"), (256, 64, "train"), (512, 1, "decode"), (3, 8,
                                                                                    "prefill")):
            tspecs = model.input_specs(ShapeSpec("s", s, b, kind))
            jspecs = jmodel.input_specs(JShapeSpec("s", s, b, kind))
            assert _specs(sh.batch_shardings(tspecs, tm_)) == _specs(
                j_sh.batch_shardings(jspecs, jm_)), (arch, b, kind)
        if cfg.family == "audio":
            continue  # no decode cache
        for b, w in ((4, 32), (256, 1024)):
            cshape = jax.eval_shape(lambda: jmodel.init_cache(b, w))
            assert _specs(sh.cache_shardings(cshape, b, tm_)) == _specs(
                j_sh.cache_shardings(cshape, b, jm_)), (arch, b, w)


def test_port_trees_have_the_reference_paths():
    """The port's own parameter trees (smoke configs) get the specs of the
    JAX package's trees: the same paths, so the same rules."""
    jm_, tm_ = _stand_ins(*MESHES[0])
    for arch in workers.ARCHS:
        params = get_model(configs.get_smoke_config(arch), device="cpu").init(
            torch.Generator().manual_seed(0))
        pshape = jax.eval_shape(j_get_model(j_configs.get_smoke_config(arch)).init,
                                jax.random.PRNGKey(0))
        assert _specs(sh.param_shardings(params, tm_)) == _specs(
            sh.param_shardings(pshape, tm_)), arch


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    _, tm_ = _stand_ins(*MESHES[2])
    assert sh.placements((("pod", "data"), None, "model"), tm_) == [
        Shard(0), Shard(0), Shard(2)]
    assert sh.placements((None, "data"), tm_) == [Replicate(), Shard(1), Replicate()]
    assert sh.placements((), tm_) == [Replicate()] * 3
    with pytest.raises(ValueError, match="twice"):
        sh.placements(("data", "data"), tm_)
    assert mesh_lib.data_axes(tm_) == ("pod", "data") and mesh_lib.num_chips(tm_) == 512


# ---------------------------------------------------------------------------
# Sharded train steps over four ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the JAX package's sharded steps, computed
    side by side (the ranks in their own processes)."""
    if jax.device_count() < 4:
        pytest.skip("needs >= 4 JAX devices (see tests/conftest.py)")
    # The port's seeded weights, as numpy for both sides.
    np_params = {arch: interop.to_numpy(get_model(configs.get_smoke_config(arch), device="cpu")
                                        .init(torch.Generator().manual_seed(0)))
                 for arch in workers.ARCHS}
    ranks: dict = {}

    def start():
        try:
            ranks["out"] = distributed.spawn(
                workers.model_sharding, 4, backend="gloo", devices=["cpu"] * 4, timeout=600,
                args=(np_params, str(tmp_path_factory.mktemp("ckpt"))),
                rendezvous_dir=tmp_path_factory.mktemp("ranks"))
        except BaseException as e:  # raised in the test below
            ranks["error"] = e

    thread = threading.Thread(target=start)
    thread.start()
    try:
        jax_side = dict(_jax_steps(np_params), prefills=_jax_prefills(np_params))
    finally:
        thread.join()
    if "error" in ranks:
        raise ranks["error"]
    return ranks["out"], jax_side


def _jax_steps(np_params) -> dict:
    """Each family's sharded step (and DeepSeek-MoE's gradients), and
    SmolLM's at ``workers.MICROBATCHES`` (keyed ``smollm-135m/mb2``), three
    at a time: XLA compiles them in parallel threads."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))

    def one(job):
        arch, n = job
        model, _, opt_state, step, stream = j_train.build_trainer(
            arch, mesh=mesh, **dict(workers.KW, microbatches=n))
        params = jax.device_put(np_params[arch], j_sh.param_shardings(np_params[arch], mesh))
        batch = stream.batch(0)
        batch = jax.device_put(batch, j_sh.batch_shardings(batch, mesh))
        out = {}
        with jax.set_mesh(mesh):
            if arch == "deepseek-moe-16b":
                grads = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(params, batch)
                out["grads"] = {n: np.asarray(grads["layers"]["moe"][n])
                                for n in workers.EXPERT_WEIGHTS + ("router",)}
            new_params, new_opt, metrics = step(params, opt_state, batch)
        paths = lambda tree: {j_sh._path_str(p): np.asarray(x)  # noqa: E731
                              for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
        out.update(loss=float(metrics["loss"]), lr=float(metrics["lr"]),
                   ce=float(metrics.get("ce", np.nan)), params=paths(new_params),
                   mu=paths(new_opt["mu"]))
        return (arch if n == 1 else f"{arch}/mb{n}"), out

    # The slowest to compile first.
    order = [(arch, 1) for arch in ("xlstm-350m", "deepseek-moe-16b", "zamba2-7b")]
    order += [("smollm-135m", workers.MICROBATCHES)]
    order += [(arch, 1) for arch in ("smollm-135m", "qwen2-vl-2b", "hubert-xlarge")]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        return dict(pool.map(one, order))


def _jax_prefills(np_params) -> dict:
    """The last position's logits of each of ``workers.PREFILLS``,
    unsharded (one JAX device), from the same weights and prompts."""
    out = {}
    for arch in workers.PREFILLS:
        step = jax.jit(j_steps.make_prefill_step(j_get_model(j_configs.get_smoke_config(arch))))
        out[arch] = np.asarray(step(np_params[arch], {"tokens": workers.prefill_tokens(arch)}))
    return out


def _port_key(key: str) -> str:
    """A JAX path string as the port's checkpoint key (list index ``[i]``)."""
    return "/".join(f"[{p}]" if p.isdigit() else p for p in key.split("/"))


def _hold_step(got: dict, want: dict, what: str, key=lambda k: k) -> None:
    """One step's loss, gradient and new parameters held to another's
    (see test_sharded_step_matches_jax_sharded_step)."""
    np.testing.assert_allclose(got["loss"], want["loss"], err_msg=what, **LOSS_TOL)
    assert set(got["params"]) == {key(k) for k in want["params"]}
    ocfg = j_opt.OptimizerConfig()
    skipped = total = 0
    for k, w in want["params"].items():
        mu_t, mu_j = got["mu"][key(k)], want["mu"][k]
        dmu = 1e-5 * max(np.abs(mu_j).max(), 1e-30)
        np.testing.assert_allclose(mu_t, mu_j, rtol=0, atol=dmu, err_msg=f"{what} mu {k}")
        g, dg = np.abs(mu_j) / (1 - ocfg.b1), dmu / (1 - ocfg.b1)
        moves = want["lr"] * ocfg.eps * dg / (g + ocfg.eps) ** 2
        steady = (moves <= UPDATE_TOL["atol"]) | ((mu_j == 0) & (mu_t == 0))
        np.testing.assert_allclose(got["params"][key(k)][steady], w[steady],
                                   err_msg=f"{what} {k}", **UPDATE_TOL)
        skipped += int((~steady).sum())
        total += w.size
    assert skipped < 0.01 * total, (what, skipped, total)


@pytest.mark.parametrize("arch", workers.ARCHS)
def test_sharded_step_matches_jax_sharded_step(runs, arch):
    """The loss within ``LOSS_TOL``; the step's gradient (from AdamW's first
    moment, ``(1 - b1) * g`` after the clip) within 1e-5 of each leaf's
    largest, tests/torch_parity.py's gradient tolerance; the new parameters
    within ``UPDATE_TOL`` wherever that tolerance can hold.  AdamW's first
    update is ``lr * g / (|g| + eps)``: a gradient error ``dg`` moves it by
    ``lr * eps * dg / (|g| + eps)**2``, so where ``|g|`` is within a few
    orders of ``eps`` the last bits of ``g``, which differ with the order of
    the sharded sums, move the update by more than ``UPDATE_TOL``'s atol.
    Those elements (gradients that are rounding noise, as the key bias's)
    are held by the gradient check alone, and are few; a gradient that is
    exactly zero in both, as an unused token's embedding row, is not among
    them."""
    ranks, jax_side = runs
    for r in ranks:
        np.testing.assert_allclose(r["steps"][arch]["loss"], jax_side[arch]["loss"],
                                   err_msg=arch, **LOSS_TOL)
        assert r["steps"][arch]["dtensor"]
    _hold_step(ranks[0]["steps"][arch], jax_side[arch], arch, _port_key)


def test_heads_the_model_axis_does_not_divide(runs):
    """3 query heads and 1 KV head over ``model`` 2: the projections gather
    their columns before the split into heads, and the step equals the
    unsharded step's (the reference's rules at the same shapes)."""
    got = runs[0][0]["odd_heads"]
    _hold_step(got["sharded"], got["unsharded"], "3 heads")


def test_microbatched_sharded_step_matches_unsharded(runs):
    """SmolLM at two microbatches through ``build_trainer(mesh=)`` against
    the same step unsharded, within the one-step limits above."""
    got = runs[0][0]["microbatched"]
    _hold_step(got["sharded"], got["unsharded"], "2 microbatches")


def test_microbatched_sharded_step_matches_jax_sharded_step(runs):
    """SmolLM at two microbatches on the mesh against the JAX package's
    sharded step at two microbatches: the loss and ``ce`` (the last
    microbatch's) on every rank within ``LOSS_TOL``, the step as in
    test_sharded_step_matches_jax_sharded_step."""
    ranks, jax_side = runs
    want = jax_side[f"smollm-135m/mb{workers.MICROBATCHES}"]
    for r in ranks:
        got = r["microbatched"]["sharded"]
        np.testing.assert_allclose(got["loss"], want["loss"], **LOSS_TOL)
        np.testing.assert_allclose(got["ce"], want["ce"], **LOSS_TOL)
    _hold_step(ranks[0]["microbatched"]["sharded"], want, "2 microbatches", _port_key)


def test_microbatches_that_split_rows_raise(runs):
    """A batch of two rows over ``data`` 2 at two microbatches would leave
    half a row a rank: the split raises rather than gather each
    microbatch."""
    for r in runs[0]:
        assert "do not split" in (r["microbatched"]["uneven"] or ""), r["microbatched"]["uneven"]


def test_microbatches_stay_sharded(runs):
    """Each microbatch is the reference's rows ``[i B/n, (i+1) B/n)``,
    placed as the batch is, each rank holding ``B/(n dp) = 4/(2 * 2)`` of
    them; the step's ``ce`` is the last microbatch's (the reference's
    ``aux``); each rank's counted FLOPs at 2 microbatches are within 3 %
    of those at 1 (this mesh is too small to show replication, which the
    32 x 8 count in test_torch_dryrun.py does)."""
    for r in runs[0]:
        mb = r["microbatched"]
        assert mb["local_rows"] == [(1, 32)] * workers.MICROBATCHES, mb["placements"]
        assert mb["reference_rows"]
        assert abs(mb["flops"][2] - mb["flops"][1]) <= 0.03 * mb["flops"][1], mb["flops"]
        np.testing.assert_allclose(mb["sharded"]["ce"], mb["last_ce"], **LOSS_TOL)
        np.testing.assert_allclose(mb["unsharded"]["ce"], mb["last_ce"], **LOSS_TOL)
        assert mb["sharded"]["ce"] != mb["sharded"]["loss"]


def test_moe_takes_the_expert_parallel_path(runs):
    """Its one MoE layer goes through the expert-parallel path; the loss is
    the sharded reference's, apart from the unsharded one's (whose global
    capacity drops other assignments)."""
    ranks, jax_side = runs
    assert all(r["steps"]["deepseek-moe-16b"]["ep_calls"] >= 1 for r in ranks)
    cfg = j_configs.get_smoke_config("deepseek-moe-16b")
    assert cfg.num_experts % 2 == 0
    got = ranks[0]["steps"]["deepseek-moe-16b"]["loss"]
    assert abs(got - jax_side["deepseek-moe-16b"]["loss"]) < 1e-4


def test_moe_expert_gradients_match_jax(runs):
    ranks, jax_side = runs
    got = ranks[0]["steps"]["deepseek-moe-16b"]["grads"]
    for name, w in jax_side["deepseek-moe-16b"]["grads"].items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30), err_msg=name)
        assert np.abs(w).max() > 0


def test_moe_router_alone_sharded_matches_unsharded(runs):
    """DeepSeek-MoE-16B's router alone at full width (d 2,048, 64 experts,
    4,096 tokens), rows over ``data``, against the unsharded router with
    the same routing: its gradient differs by rounding alone, under 1e-9 of
    its largest magnitude with the route in float64 (seen: 7.9e-16) and
    under 1e-5 in float32 (seen: 4.5e-7), so the sharded composition (each
    rank's rows, the load-balance means over DTensor rows, the ``Partial``
    gradient) is exact."""
    for r in runs[0]:
        router = r["router"]
        assert router["float32"]["same_routing"] and router["float64"]["same_routing"]
        assert router["float64"]["gap"] < 1e-9, router
        assert router["float32"]["gap"] < 1e-5, router


@pytest.mark.parametrize("arch", sorted(workers.PREFILLS))
def test_prefill_over_data_alone_matches_jax_unsharded(runs, arch):
    """A batch that ``pod`` x ``data`` does not divide shards over ``data``
    alone (``launch.mesh.batch_axes``): SmolLM's 2 prompts on ``(pod 2,
    data 2, model 1)`` one a data rank, DeepSeek-MoE's 1 prompt on ``(pod
    2, data 1, model 2)`` through the expert-parallel path (its capacity
    from the one prompt, as the unsharded path's).  The logits on every
    rank are within ``tp.TOL`` of the JAX package's unsharded prefill."""
    ranks, jax_side = runs
    want = jax_side["prefills"][arch]
    shape, b, s = workers.PREFILLS[arch]
    for r in ranks:
        got = r["prefills"][arch]
        assert got["batch_axes"] == ["data"], got["batch_axes"]
        assert got["local_rows"] == [b // shape[1], s]
        assert got["ep_calls"] == (1 if arch == "deepseek-moe-16b" else 0)
        assert got["logits"].shape == want.shape == (b, configs.get_smoke_config(
            arch).vocab_size)
        np.testing.assert_allclose(got["logits"], want, err_msg=f"{arch} rank {r['rank']}",
                                   **tp.TOL)


def test_sharded_save_restores_unsharded_and_back_bit_exact(runs):
    for r in runs[0]:
        ck = r["ckpt"]
        assert ck["unsharded_equal"] and ck["sharded_equal"] and ck["same_placements"]
        assert ck["reshard_equal"]


def test_sharded_save_on_meshes_smaller_than_the_world(runs):
    """A ``(1, 2)`` mesh of ranks 0-1 and one of ranks 2-3 save at once:
    each mesh's first rank writes its checkpoint, and each rank restores
    its own mesh's arrays (no rank waits for ranks outside its mesh)."""
    for r in runs[0]:
        assert r["small_meshes"] == dict(steps=[1], equal=True), r["rank"]


def test_restored_state_replays_a_step_bit_exact(runs):
    for r in runs[0]:
        assert r["ckpt"]["loss3_replayed"] == r["ckpt"]["loss3"]


def test_restart_loop_replays_sharded_state_bit_exact(runs):
    for r in runs[0]:
        ck = r["ckpt"]
        assert ck["loop_restarts"] == (0, 1)
        assert ck["loop_losses"][0] == ck["loop_losses"][1] and len(ck["loop_losses"][0]) == 3
        assert ck["loop_equal"]
