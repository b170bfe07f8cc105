"""The port's open-loop serving (``GenerationEngine.serve``), its local
backends and temperature sampling against the JAX package's, on the
float32 SmolLM-135M smoke config with the JAX weights carried across.

Every ``serve`` case runs the same requests through both packages on the
same virtual clock: the completions are equal in ``rid``, ``tokens``,
``lane``, ``status``, ``attempts``, ``fault`` and their arrival, admission
and finish times, and the stats' counters agree.  The cases are
tests/test_serve.py's open-loop and resilience cases, crash-resume
included, and lane sharding over two gloo ranks
(``TestShardedServe``; snapshots under a mesh raise).  ``generate`` runs on
``local`` and ``local_eager`` with the JAX engine's tokens.  Temperature
sampling draws the JAX package's tokens on fixed seeds; its Gumbel noise
goes through PyTorch's ``log``, within an ulp of XLA's, so a token may
differ where two noisy logits nearly tie — the cases count such
mismatches and hold them to a bound.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro.serve import steps as j_steps  # noqa: E402
from repro.train.fault_tolerance import StragglerPolicy as JStragglerPolicy  # noqa: E402
from repro_torch import configs, distributed, interop  # noqa: E402
from repro_torch.mcmc import prng  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402
from repro_torch.serve import steps as t_steps  # noqa: E402
from repro_torch.train.fault_tolerance import StragglerPolicy  # noqa: E402
from tests import torch_mesh_workers as workers  # noqa: E402

ARCH = "smollm-135m"
BASE = dict(max_context=32, max_prompt_len=5, max_new_tokens=6, requests_per_lane=1,
            eos_id=0)


@pytest.fixture(scope="module")
def lm():
    jm = j_get_model(j_configs.get_smoke_config(ARCH))
    params = jm.init(jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(ARCH)
    tparams = interop.lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return jm, params, get_model(cfg, device="cpu"), tparams


@pytest.fixture(scope="module")
def engines(lm):
    """``(jax engine, port engine)`` for an engine config, made once per
    config and shared across cases (``segment_steps`` is a serve()
    argument, so it is not part of it)."""
    jm, params, tm, tparams = lm
    made = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in made:
            cfg = dict(BASE, **kw)
            made[key] = (j_engine.GenerationEngine(jm, params, j_engine.EngineConfig(**cfg)),
                         t_engine.GenerationEngine(tm, tparams, t_engine.EngineConfig(**cfg)))
        return made[key]

    return get


def _clock(tick: float):
    t = {"now": 0.0}

    def now():
        t["now"] += tick
        return t["now"]

    return now


def _reqs(n, seed=5, plen=None, arrival=0.0, gap=0.0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(1, 256, (plen or (1 + i % 4),)).astype(np.int32),
             arrival + gap * i) for i in range(n)]


FIELDS = ("rid", "lane", "status", "attempts", "fault", "arrival", "admitted", "finished")


def _serve_both(engines, reqs, *, segment_steps=8, tick=1.0, serve_kw=None, **cfg):
    j_eng, t_eng = engines(**cfg)
    serve_kw = serve_kw or {}
    out = []
    for mod, eng in ((j_engine, j_eng), (t_engine, t_eng)):
        requests = [mod.Request(rid=r, prompt=p, arrival=a) for r, p, a in reqs]
        kw = {k: v() for k, v in serve_kw.items()}
        out.append(eng.serve(requests, segment_steps=segment_steps, now_fn=_clock(tick), **kw))
    (j_comps, j_stats), (t_comps, t_stats) = out
    assert len(t_comps) == len(j_comps) == len(reqs)
    for j, t in zip(j_comps, t_comps):
        for f in FIELDS:
            assert getattr(t, f) == getattr(j, f), (t.rid, f)
        np.testing.assert_array_equal(t.tokens, j.tokens)
        assert t.tokens.dtype == np.int32
    for f in ("segments", "vm_steps", "completions", "generated_tokens", "ok", "faulted",
              "timeout", "rejected", "retries", "occupancy", "p50_latency", "p99_latency"):
        assert getattr(t_stats, f) == pytest.approx(getattr(j_stats, f), nan_ok=True), f
    return t_comps, t_stats, t_eng


def _oracle(lm, reqs, max_new=6):
    """Each request alone through the port's sequential oracle."""
    _, _, tm, tparams = lm
    z = len(reqs)
    eng = t_engine.GenerationEngine.__new__(t_engine.GenerationEngine)
    eng.model, eng.params = tm, tparams
    eng.cfg = t_engine.EngineConfig(lanes=z, **dict(BASE, max_new_tokens=max_new))
    prompts = np.zeros((z, 1, 5), np.int32)
    plens = np.zeros((z, 1), np.int32)
    for i, (_, p, _) in enumerate(reqs):
        prompts[i, 0, : len(p)] = p
        plens[i, 0] = len(p)
    return eng.reference_generate(prompts, plens)


class TestContinuousServe:
    def test_more_requests_than_lanes_matches_oracle(self, lm, engines):
        reqs = _reqs(5)
        comps, stats, _ = _serve_both(engines, reqs, lanes=2)
        assert [c.rid for c in comps] == [0, 1, 2, 3, 4]
        ref = _oracle(lm, reqs)
        for c in comps:
            np.testing.assert_array_equal(c.tokens, ref["tokens"][c.rid, 0, : ref["lengths"][c.rid, 0]])
        assert stats.completions == 5 and stats.generated_tokens == int(ref["lengths"].sum())
        assert 0.0 < stats.occupancy <= 1.0

    def test_metrics_and_latency_percentiles(self, engines):
        j_eng, t_eng = engines(lanes=2)
        j_eng.metrics, t_eng.metrics = JMetricsRegistry(), MetricsRegistry()
        comps, stats, eng = _serve_both(engines, _reqs(4, seed=7, plen=3), lanes=2)
        assert stats.ok == 4
        lat = sorted(c.latency for c in comps)
        assert 0.0 <= stats.p50_latency <= stats.p99_latency <= lat[-1] + 1e-9
        reg, j_reg = eng.metrics, j_eng.metrics
        for name, labels in (("serve_admissions_total", {}),
                             ("serve_completions_total", {"status": "ok"}),
                             ("serve_generated_tokens_total", {})):
            assert reg.get(name).value(**labels) == j_reg.get(name).value(**labels)
        assert reg.get("serve_segment_seconds").count() >= stats.segments
        lat_h = reg.get("serve_request_latency_seconds")
        assert lat_h.count(status="ok") == j_reg.get(
            "serve_request_latency_seconds").count(status="ok")
        text = reg.render_prometheus()
        assert "# TYPE serve_segment_seconds histogram" in text
        assert 'serve_completions_total{status="ok"}' in text

    def test_streaming_and_lane_reuse(self, engines):
        streamed = {"jax": [], "port": []}
        comps, _, _ = _serve_both(
            engines, _reqs(4, seed=6, plen=3), segment_steps=4, lanes=2,
            serve_kw={"on_finish": lambda: streamed["port" if streamed["jax"] else "jax"].append})
        assert len(streamed["port"]) == len(streamed["jax"]) == 4
        assert [c.rid for c in streamed["port"]] == [c.rid for c in streamed["jax"]]
        assert {c.lane for c in comps} <= {0, 1}

    def test_empty_prompt_request(self, engines):
        reqs = [(0, np.zeros((0,), np.int32), 0.0), (1, np.array([7, 9], np.int32), 0.0)]
        comps, stats, _ = _serve_both(engines, reqs, lanes=1)
        assert comps[0].tokens.size == 0 and comps[1].tokens.size > 0
        assert stats.completions == 2

    def test_late_arrivals_with_virtual_clock(self, lm, engines):
        reqs = _reqs(4, seed=8, gap=2.0)
        comps, _, _ = _serve_both(engines, reqs, segment_steps=4, lanes=2)
        assert all(c.admitted >= c.arrival for c in comps)
        ref = _oracle(lm, reqs)
        for c in comps:
            np.testing.assert_array_equal(c.tokens, ref["tokens"][c.rid, 0, : ref["lengths"][c.rid, 0]])

    def test_full_length_prompts_with_refill(self, lm, engines):
        """A lane that finished a full-length prefill (``t == max_prompt_len``)
        while a refilled lane prefills: the read of the idle lane's prompt
        clamps its index, as JAX's gather does, and its result is dropped."""
        reqs = _reqs(5, seed=10, plen=5, gap=1.0)
        comps, _, _ = _serve_both(engines, reqs, segment_steps=2, lanes=2)
        ref = _oracle(lm, reqs)
        for c in comps:
            np.testing.assert_array_equal(c.tokens, ref["tokens"][c.rid, 0, : ref["lengths"][c.rid, 0]])

    def test_closed_loop_with_full_prompts_and_drained_queues(self, lm):
        """generate: full-length prompts and lanes whose queue drained
        (``req == requests_per_lane``) while others start a request."""
        jm, params, tm, tparams = lm
        kw = dict(lanes=3, max_context=32, max_prompt_len=4, max_new_tokens=3,
                  requests_per_lane=2, eos_id=0)
        prompts = np.random.default_rng(4).integers(1, 256, (3, 2, 4)).astype(np.int32)
        plens = np.array([[4, 4], [1, 4], [4, 1]], np.int32)
        n_req = np.array([1, 2, 2], np.int32)
        want = j_engine.GenerationEngine(jm, params, j_engine.EngineConfig(**kw)).generate(
            prompts, plens, n_req=n_req)
        got = t_engine.GenerationEngine(tm, tparams, t_engine.EngineConfig(**kw)).generate(
            prompts, plens, n_req=n_req)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        np.testing.assert_array_equal(got["lengths"], want["lengths"])

    def test_rejects_oversized_prompt(self, engines):
        _, eng = engines(lanes=1)
        with pytest.raises(ValueError, match="max_prompt_len"):
            eng.serve([t_engine.Request(rid=0, prompt=np.ones((9,), np.int32))])

    def test_serve_requires_pc_backend(self, lm):
        _, _, tm, tparams = lm
        eng = t_engine.GenerationEngine(tm, tparams, t_engine.EngineConfig(
            lanes=1, max_context=16, max_prompt_len=4, max_new_tokens=2,
            requests_per_lane=1, backend="local"))
        with pytest.raises(ValueError, match="pc backend"):
            eng.serve([t_engine.Request(rid=0, prompt=np.ones((2,), np.int32))])

    def test_unported_serve_options_raise(self, lm, engines, tmp_path):
        """Crash-resume is ported: ``resume=True`` needs a checkpoint
        directory, as in the reference, and over an empty one serves the
        requests from the start."""
        _, eng = engines(lanes=1)
        req = [t_engine.Request(rid=0, prompt=np.ones((2,), np.int32))]
        with pytest.raises(ValueError, match="checkpoint_dir"):
            eng.serve(req, resume=True)
        _, _, tm, tparams = lm
        ck = t_engine.GenerationEngine(tm, tparams, t_engine.EngineConfig(
            lanes=1, checkpoint_dir=str(tmp_path), **BASE))
        comps, stats = ck.serve(req, resume=True)
        want, _ = eng.serve(req)
        np.testing.assert_array_equal(comps[0].tokens, want[0].tokens)
        assert stats.checkpoints >= 1 and comps[0].status == "ok"


class TestShardedServe:
    """tests/test_serve.py's test_sharded_serve_matches_unsharded: two lanes
    over two gloo ranks, four requests refilling them on a virtual clock."""

    KW = dict(BASE, lanes=2)
    TICK = 1.0

    @staticmethod
    def _reqs():
        rng = np.random.default_rng(9)
        return [(i, rng.integers(1, 256, (1 + i % 5,)).astype(np.int32), 0.0)
                for i in range(4)]

    @pytest.fixture(scope="class")
    def sharded(self, lm, tmp_path_factory):
        _, params, _, _ = lm
        return distributed.spawn(
            workers.engine_serve, 2, backend="gloo", devices=["cpu"] * 2, timeout=300,
            args=(jax.tree.map(np.asarray, params), self.KW, self._reqs(), 8, self.TICK),
            rendezvous_dir=tmp_path_factory.mktemp("ranks"))

    def test_sharded_serve_matches_unsharded_and_jax(self, lm, sharded):
        """Every rank returns every completion, equal to the JAX engine's
        (sharded and not) and the unsharded port's in tokens, lane, status
        and times: the first rank's clock decides, though the second
        rank's own clock runs twice as fast."""
        jm, params, tm, tparams = lm
        reqs = self._reqs()
        want = []
        for mod, eng in ((j_engine, j_engine.GenerationEngine(
                jm, params, j_engine.EngineConfig(**self.KW))),
                         (j_engine, j_engine.GenerationEngine(
                             jm, params, j_engine.EngineConfig(**self.KW, mesh=2))),
                         (t_engine, t_engine.GenerationEngine(
                             tm, tparams, t_engine.EngineConfig(**self.KW)))):
            comps, stats = eng.serve([mod.Request(rid=r, prompt=p, arrival=a)
                                      for r, p, a in reqs],
                                     segment_steps=8, now_fn=_clock(self.TICK))
            want.append((comps, stats))
        for r in sharded:
            assert r["num_devices"] == 2
            for comps, stats in want:
                assert len(r["comps"]) == len(comps) == 4
                for (fields, tokens), c in zip(r["comps"], comps):
                    assert fields == {f: getattr(c, f) for f in FIELDS}
                    np.testing.assert_array_equal(tokens, c.tokens)
                for f, v in r["stats"].items():
                    assert v == pytest.approx(getattr(stats, f)), f

    def test_snapshots_under_a_mesh_wait_for_item_14(self, lm, tmp_path):
        """Resharded checkpoints come with model sharding: resume=True and
        checkpoint_dir under a mesh raise, before any rank is needed."""
        _, _, tm, tparams = lm
        req = [t_engine.Request(rid=0, prompt=np.ones((2,), np.int32))]
        for extra, kw in (({}, dict(resume=True)),
                          (dict(checkpoint_dir=str(tmp_path)), {})):
            eng = t_engine.GenerationEngine(tm, tparams, t_engine.EngineConfig(
                **self.KW, mesh=2, **extra))
            with pytest.raises(NotImplementedError, match="item 14"):
                eng.serve(req, **kw)


class TestServeResilience:
    def test_bounded_queue_sheds_as_rejected(self, engines):
        comps, stats, _ = _serve_both(engines, _reqs(4), lanes=1, queue_capacity=1)
        assert stats.rejected == 2 and stats.ok == 2 and stats.completions == 4
        rejected = [c for c in comps if c.status == "rejected"]
        assert all(c.lane == -1 and c.tokens.size == 0 for c in rejected)
        assert comps[0].status == "ok"

    def test_deadline_times_out_inflight_and_queued(self, engines):
        comps, stats, _ = _serve_both(engines, _reqs(2, plen=4), tick=0.6, lanes=1,
                                      deadline_s=1.0)
        assert stats.timeout == 2 and all(c.status == "timeout" for c in comps)

    def test_deadline_retries_with_backoff(self, engines):
        comps, stats, _ = _serve_both(engines, _reqs(3, plen=4), tick=0.3, lanes=2,
                                      deadline_s=1.0, max_attempts=3, retry_backoff_s=0.5)
        assert stats.retries > 0 and stats.completions == 3

    def test_watchdog_fault_retries_then_terminal(self, engines):
        comps, stats, _ = _serve_both(engines, _reqs(2, plen=3), lanes=2, lane_step_budget=3,
                                      max_attempts=2, retry_backoff_s=0.0)
        assert stats.retries == 2 and stats.faulted == 2
        for c in comps:
            assert (c.status, c.fault, c.attempts, c.tokens.size) == ("faulted", "watchdog", 2, 0)

    def test_faults_do_not_perturb_healthy_lanes(self, engines):
        healthy = _reqs(3, plen=2)
        clean, _, _ = _serve_both(engines, healthy, lanes=2, lane_step_budget=64)
        hog = (3, np.full((5,), 1, np.int32), 0.0)
        comps, stats, _ = _serve_both(engines, healthy + [hog], lanes=2, lane_step_budget=64)
        by = {c.rid: c for c in comps}
        if stats.faulted:
            assert by[3].status == "faulted"
        for c in clean:
            np.testing.assert_array_equal(by[c.rid].tokens, c.tokens)
            assert by[c.rid].status == "ok"

    def test_nonfinite_and_compaction(self, engines):
        """detect_nonfinite and compaction change nothing on healthy
        requests."""
        comps, stats, _ = _serve_both(engines, _reqs(5, seed=9), segment_steps=3, lanes=2,
                                      detect_nonfinite=True, compact_every=2)
        assert stats.ok == 5

    def test_straggler_policy_wired(self, engines):
        pols = []

        def make(cls):
            pols.append(cls(threshold=3.0, warmup=2))
            return pols[-1]

        _, stats, _ = _serve_both(
            engines, _reqs(3), lanes=2,
            serve_kw={"straggler": lambda: make(StragglerPolicy if pols else JStragglerPolicy)})
        assert stats.straggler_events == len(pols[1].flagged)
        assert pols[1]._n == pols[0]._n == stats.segments > 0


class TestCrashResume:
    @staticmethod
    def _engine(model, params, d, **kw):
        cfg = dict(BASE, lanes=2, segment_steps=4, checkpoint_dir=str(d),
                   checkpoint_every_segments=1, **kw)
        return t_engine.GenerationEngine(model, params, t_engine.EngineConfig(**cfg))

    @staticmethod
    def _crash_then_resume(mk, reqs, tmp_path):
        class Crash(Exception):
            pass

        seen = []

        def boom(c):
            seen.append(c)
            if len(seen) == len(reqs) - 1:
                raise Crash

        with pytest.raises(Crash):
            mk(tmp_path / "a").serve(reqs, on_finish=boom)
        snap = t_engine.Checkpointer(str(tmp_path / "a"))
        done = set(snap.manifest(snap.latest_step())["extra"]["done_rids"])
        comps, stats = mk(tmp_path / "a").serve(reqs, resume=True)
        assert {c.rid for c in seen} | {c.rid for c in comps} == {r.rid for r in reqs}
        # More requests than lanes: the snapshot before the crash holds
        # done requests, and the resume does not serve them again.
        assert done and not done & {c.rid for c in comps} and len(comps) < len(reqs)
        assert all(c.status == "ok" for c in comps) and stats.checkpoints >= 1
        clean, _ = mk(tmp_path / "b").serve(reqs)
        # resume after completion is a no-op: every rid is recorded done
        again, stats2 = mk(tmp_path / "a").serve(reqs, resume=True)
        assert again == [] and stats2.completions == 0
        return comps, {c.rid: c.tokens for c in clean}

    def test_crash_resume_completes_all_requests(self, lm, engines, tmp_path):
        """Kill the host loop at the next-to-last completion, after a
        snapshot that holds done requests; a fresh engine with
        resume=True finishes every remaining request with tokens bit-exact
        with an uninterrupted run of the port and of the JAX engine
        (at-least-once delivery)."""
        _, _, tm, tparams = lm
        reqs = [t_engine.Request(rid=r, prompt=p, arrival=a) for r, p, a in _reqs(5, seed=7)]
        comps, ref = self._crash_then_resume(
            lambda d: self._engine(tm, tparams, d), reqs, tmp_path)
        j_eng, _ = engines(lanes=2)
        j_clean, _ = j_eng.serve([j_engine.Request(rid=r.rid, prompt=r.prompt) for r in reqs],
                                 segment_steps=4)
        for c in j_clean:
            np.testing.assert_array_equal(ref[c.rid], c.tokens)
        for c in comps:
            np.testing.assert_array_equal(c.tokens, ref[c.rid])

    def test_bf16_cache_and_trace_ring_resume_bit_exact(self, lm, tmp_path):
        """A bfloat16 KV cache and the dispatch-trace ring go through the
        snapshot and back bit for bit: the resumed requests' tokens equal
        an uninterrupted bf16 run's."""
        _, _, tm, tparams = lm
        m16 = get_model(dataclasses.replace(tm.cfg, compute_dtype="bfloat16"), device="cpu")
        reqs = [t_engine.Request(rid=r, prompt=p) for r, p, _ in _reqs(5, seed=9)]
        comps, ref = self._crash_then_resume(
            lambda d: self._engine(m16, tparams, d, trace=64), reqs, tmp_path)
        for c in comps:
            np.testing.assert_array_equal(c.tokens, ref[c.rid])
        ck = t_engine.Checkpointer(str(tmp_path / "a"))
        keys = ck.manifest(ck.latest_step())["keys"]
        assert {v["dtype"] for k, v in keys.items() if k.startswith("tops/") and "/cache" in k} == {"bfloat16"}
        assert keys["trace"]["shape"][0] == 64


class TestLocalBackends:
    @pytest.mark.parametrize("backend", ["local", "local_eager"])
    def test_generate_matches_the_jax_engine(self, lm, backend):
        jm, params, tm, tparams = lm
        kw = dict(lanes=4, max_context=32, max_prompt_len=6, max_new_tokens=8,
                  requests_per_lane=2, eos_id=0)
        rng = np.random.default_rng(0)
        prompts = rng.integers(1, 256, (4, 2, 6)).astype(np.int32)
        plens = rng.integers(2, 7, (4, 2)).astype(np.int32)
        want = j_engine.GenerationEngine(jm, params, j_engine.EngineConfig(**kw)).generate(
            prompts, plens)
        eng = t_engine.GenerationEngine(tm, tparams, t_engine.EngineConfig(**kw, backend=backend))
        res = eng.generate(prompts, plens)
        np.testing.assert_array_equal(res["tokens"], want["tokens"])
        np.testing.assert_array_equal(res["lengths"], want["lengths"])
        assert res["utilization"] == pytest.approx(want["utilization"], rel=1e-12)
        ref = eng.reference_generate(prompts, plens)
        np.testing.assert_array_equal(res["tokens"], ref["tokens"])


class TestTemperature:
    def test_gumbel_and_categorical_match_jax(self):
        """Per key: the Gumbel draws within a few ulp of the inner log
        (``-log(-log(u))`` cancels near zero, so the bound is absolute),
        the categorical draw equal except at near-ties (none on these
        seeds)."""
        logits = np.random.default_rng(1).normal(size=(16, 256)).astype(np.float32)
        mismatches = 0
        for seed in range(16):
            jk = jax.random.PRNGKey(seed)
            tk = prng.prng_key(seed)
            jg = np.asarray(jax.random.gumbel(jk, (256,), jnp.float32))
            tg = prng.gumbel(tk, (256,)).numpy()
            np.testing.assert_allclose(tg, jg, rtol=3e-7, atol=5e-7)
            j_tok = np.asarray(j_steps.sample_token(jnp.asarray(logits), jk, 0.7))
            t_tok = t_steps.sample_token(torch.from_numpy(logits), tk, 0.7).numpy()
            mismatches += int((j_tok != t_tok).sum())
        assert mismatches == 0

    def test_serve_step_samples_like_jax(self, lm):
        jm, params, tm, tparams = lm
        tok = np.array([3, 17, 99, 200], np.int32)
        pos = np.zeros(4, np.int32)
        j_tok, _ = j_steps.make_serve_step(jm, 0.8)(
            params, jm.init_cache(4, 8), jnp.asarray(tok), jnp.asarray(pos), jax.random.PRNGKey(3))
        t_tok, _ = t_steps.make_serve_step(tm, 0.8)(
            tparams, tm.init_cache(4, 8), torch.from_numpy(tok), torch.from_numpy(pos),
            prng.prng_key(3))
        assert int((np.asarray(j_tok) != t_tok.numpy()).sum()) == 0

    def test_engine_temperature_sampling_matches_jax(self, lm, engines):
        """Temperature 0.8 through generate and serve: sequences that
        diverge from JAX's (a near-tie changes a token and everything
        after it) are counted; on these seeds there are none."""
        jm, params, tm, tparams = lm
        kw = dict(lanes=4, max_context=32, max_prompt_len=6, max_new_tokens=8,
                  requests_per_lane=2, eos_id=0, temperature=0.8)
        rng = np.random.default_rng(2)
        prompts = rng.integers(1, 256, (4, 2, 6)).astype(np.int32)
        plens = rng.integers(2, 7, (4, 2)).astype(np.int32)
        want = j_engine.GenerationEngine(jm, params, j_engine.EngineConfig(**kw)).generate(
            prompts, plens, seed=11)
        got = t_engine.GenerationEngine(tm, tparams, t_engine.EngineConfig(**kw)).generate(
            prompts, plens, seed=11)
        diverged = int((got["tokens"] != want["tokens"]).any(axis=-1).sum())
        assert diverged == 0
        np.testing.assert_array_equal(got["lengths"], want["lengths"])
        comps, _, _ = _serve_both(engines, _reqs(5, seed=3), lanes=2, temperature=0.8)
        assert all(c.status == "ok" for c in comps)

    def test_oracle_is_greedy_only(self, engines):
        _, eng = engines(lanes=2, temperature=0.8)
        with pytest.raises(ValueError, match="greedy"):
            eng.reference_generate(np.zeros((2, 1, 5), np.int32), np.ones((2, 1), np.int32))
