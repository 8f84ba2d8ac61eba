"""PyTorch port, the telemetry layer's units against the JAX package, live
in one process (JAX on the CPU, the port's tensors on the CPU). Every input
is made with numpy from a seed.

- Each round-metric function of ``telemetry/metrics.py`` against JAX's on
  the same inputs: the count streams (``effective_degree``,
  ``staleness_histogram``, ``inactive_count``) exactly, the others within
  1e-6 relative (``consensus_residual`` within 1e-5: the port reduces in
  another order than XLA); ``spectral_gap_proxy`` on a complete graph, a
  ring, an empty graph and random ER graphs, its ρ = 1 − gap within 1e-6
  relative (the gap is a difference that nears 0, where one ulp of ρ is
  a large share of it); ``flatten_centers`` in the
  pytree leaf order, and a plane passed through without a copy.
- ``make_collector`` on both state layouts, a ``(S, N, X)`` plane and a
  tree of the mlp's ``(S, N, ...)`` leaves, against JAX's: activity
  weights with zeros, staleness past the last bin, sparse masks, static
  bytes, and the streams a missing input turns into NaN.
- ``TelemetryConfig``'s validation, as JAX's.
- Which streams are NaN for each of the 13 ids (JAX's default runs of 2
  rounds on the loop, one module fixture, compiled least optimized as in
  tests/test_torch_variants.py: the pattern does not depend on the
  numbers) against the port's runs on the plane (``param_plane`` unset
  and True) and the pytree engine, on both engines, each at JAX's stream
  shapes; for the 11 baseline ids, whose bytes are static, the streams
  that depend on the config alone against the same JAX runs: bytes,
  degree, the staleness histogram and the inactive count exactly, the
  spectral gap's ρ within 1e-6 relative.

About 45 s in one CPU process, 27 of them JAX's 13 runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import run_method as j_run_method
from repro.models.smallnets import make_classifier as j_classifier
from repro.telemetry import STREAMS as J_STREAMS
from repro.telemetry import TelemetryConfig as JTelemetryConfig
from repro.telemetry import metrics as jm
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import (
    RunConfig,
    TelemetryConfig,
    available_methods,
    run_method,
)
from repro_torch.interop import params_from_numpy
from repro_torch.telemetry import STREAMS
from repro_torch.telemetry import metrics as tm

S, N, X, BINS = 2, 6, 37, 5
EXP = dict(n_clients=N, n_per_client=32, rounds=2, tau=1, batch=8, avg_degree=3.0,
           model="mlp", dim=8, n_classes=3)
DATA = dict(n_clients=N, n_clusters=S, n_per_client=32, dim=8, n_classes=3, seed=7,
            noise=0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0)


def _close_gap(got, want):
    """Gaps held through their ρ = 1 − gap (see the module docstring)."""
    _close(1.0 - np.asarray(got), 1.0 - np.asarray(want))


def _er(rng, n, p):
    a = np.triu((rng.random((n, n)) < p).astype(np.float32), 1)
    return a + a.T + np.eye(n, dtype=np.float32)


def _ring(n):
    a = np.eye(n, dtype=np.float32)
    for i in range(n):
        a[i, (i + 1) % n] = a[i, (i - 1) % n] = 1.0
    return a


# --------------------------------------------------------------------------
# the metric functions
# --------------------------------------------------------------------------


def test_streams_and_their_order_are_jax_s():
    assert STREAMS == J_STREAMS
    shapes = tm.stream_shapes(TelemetryConfig(staleness_bins=7), 3)
    assert list(shapes) == list(STREAMS)
    assert shapes["consensus"] == (3,) and shapes["stale_hist"] == (7,)
    assert all(shapes[k] == () for k in STREAMS if k not in ("consensus", "stale_hist"))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_mixture_entropy_and_drift_match_jax(batch):
    rng = np.random.default_rng(1)
    u_old = rng.dirichlet(np.ones(S + 1), size=batch + (N,)).astype(np.float32)
    u_new = rng.dirichlet(np.ones(S + 1), size=batch + (N,)).astype(np.float32)
    u_new[..., 0, :] = [1.0, 0.0, 0.0]   # a hard row: where(p > 0) drops its zeros
    _close(tm.mixture_entropy(_t(u_new)), jm.mixture_entropy(_j(u_new)))
    _close(tm.mixture_drift(_t(u_old), _t(u_new)), jm.mixture_drift(_j(u_old), _j(u_new)))
    assert float(tm.mixture_drift(_t(u_old), _t(u_old)).sum()) == 0.0


@pytest.mark.parametrize("shape", [(S, N, X), (3, S, N, 1001), (4, 5, 17226)])
def test_consensus_residual_matches_jax(shape):
    plane = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    got = tm.consensus_residual(_t(plane))
    assert got.shape == shape[:-2]
    _close(got, jm.consensus_residual(_j(plane)), rtol=1e-5)


@pytest.mark.parametrize("graph", ["complete", "ring", "empty", "er0", "er1", "er2"])
def test_degree_and_spectral_gap_match_jax(graph):
    rng = np.random.default_rng(3)
    n = 8
    adj = {"complete": np.ones((n, n), np.float32), "ring": _ring(n),
           "empty": np.zeros((n, n), np.float32)}.get(graph)
    if adj is None:
        adj = _er(rng, n, 0.2 + 0.2 * int(graph[-1]))
        # activity weights on the links: only the links' support counts
        adj = adj * rng.uniform(0.1, 1.0, size=(n, n)).astype(np.float32)
    assert np.array_equal(np.asarray(tm.effective_degree(_t(adj))),
                          np.asarray(jm.effective_degree(_j(adj))))
    got = tm.spectral_gap_proxy(_t(adj))
    want = jm.spectral_gap_proxy(_j(adj))
    if graph == "empty":
        assert float(got) == float(want) == 0.0
    else:
        _close_gap(got, want)
    if graph == "complete":
        assert float(got) == pytest.approx(1.0)


def test_spectral_gap_iters_and_batch_match_jax():
    rng = np.random.default_rng(4)
    adj = np.stack([_er(rng, 10, 0.4) for _ in range(3)])
    for iters in (1, 3, 8):
        _close_gap(tm.spectral_gap_proxy(_t(adj), iters), jm.spectral_gap_proxy(_j(adj), iters))
    assert np.array_equal(np.asarray(tm.effective_degree(_t(adj))),
                          np.asarray(jm.effective_degree(_j(adj))))


@pytest.mark.parametrize("graph", ["er", "empty"])
def test_spectral_gap_zero_iters_matches_jax(graph):
    """No power step: ρ keeps its start, 0, so the gap is 1 as JAX's."""
    rng = np.random.default_rng(6)
    adj = (np.stack([_er(rng, 10, 0.4) for _ in range(3)]) if graph == "er"
           else np.zeros((3, 10, 10), np.float32))
    got = tm.spectral_gap_proxy(_t(adj), 0)
    want = np.asarray(jm.spectral_gap_proxy(_j(adj), 0))
    assert got.shape == want.shape == (3,)
    assert np.array_equal(got.numpy(), want) and (want == 1.0).all()


def test_count_streams_match_jax_exactly():
    rng = np.random.default_rng(5)
    stale = rng.integers(0, 9, size=(3, N)).astype(np.int32)   # ages past the last bin
    for bins in (2, BINS, 9):
        got = tm.staleness_histogram(_t(stale), bins)
        assert np.array_equal(np.asarray(got), np.asarray(jm.staleness_histogram(_j(stale), bins)))
        assert np.array_equal(got.sum(-1).numpy(), np.full(3, N, np.float32))
    w = rng.uniform(0.0, 1.0, size=(3, N)).astype(np.float32)
    w[w < 0.4] = 0.0
    assert np.array_equal(np.asarray(tm.inactive_count(_t(w))),
                          np.asarray(jm.inactive_count(_j(w))))


def test_mask_streams_match_jax():
    rng = np.random.default_rng(6)
    old = rng.random((N, 1003)) < 0.2
    new = old.copy()
    flip = rng.random((N, 1003)) < 0.05
    new[flip] = ~new[flip]
    for a, b in ((old, new), (old.astype(np.float32), new.astype(np.float32))):
        _close(tm.mask_density(_t(b)), jm.mask_density(_j(b)))
        _close(tm.mask_churn(_t(a), _t(b)), jm.mask_churn(_j(a), _j(b)))


def _mlp_centers(seed: int) -> dict:
    """The mlp's leaves at (S, N, ...), as a JAX tree of numpy arrays."""
    tree = j_classifier("mlp", jax.random.PRNGKey(seed), 8, 3)[0]
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda leaf: rng.normal(size=(S, N) + leaf.shape).astype(np.float32), tree)


def test_flatten_centers_matches_jax_leaf_order():
    jtree = _mlp_centers(0)
    want = np.asarray(jm.flatten_centers(jax.tree.map(jnp.asarray, jtree)))
    ttree = params_from_numpy(jtree, device="cpu")
    got = tm.flatten_centers(ttree)
    assert np.array_equal(got.numpy(), want)
    assert tm.centers_lead(ttree) == (S, N)
    plane = torch.zeros((S, N, X))
    assert tm.flatten_centers(plane) is plane
    assert tm.flatten_centers({"w": plane}) is plane
    bad = {"a": torch.zeros((S, N, 3)), "b": torch.zeros((S, N + 1, 2))}
    assert tm.centers_lead(bad) is None
    with pytest.raises(ValueError, match="disagree"):
        tm.flatten_centers(bad)


# --------------------------------------------------------------------------
# make_collector on both layouts
# --------------------------------------------------------------------------


class _St:
    """A state-like bag of fields (the collector reads attributes)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _states(layout: str, rng):
    """(old, new) on both packages: u, comm_bytes, masks, centers."""
    if layout == "plane":
        centers = rng.normal(size=(S, N, X)).astype(np.float32)
        jc, tc = jnp.asarray(centers), torch.as_tensor(centers)
    else:
        tree = _mlp_centers(1)
        jc, tc = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, device="cpu")
    width = X if layout == "plane" else 100
    f = {k: rng.dirichlet(np.ones(S), size=N).astype(np.float32) for k in ("u0", "u1")}
    m0 = rng.random((N, width)) < 0.3
    m1 = m0 ^ (rng.random((N, width)) < 0.1)
    b0, b1 = np.float32(1234.0), np.float32(1234.0 + 98765.0)
    jold = _St(u=_j(f["u0"]), comm_bytes=_j(b0), mask=_j(m0))
    jnew = _St(u=_j(f["u1"]), comm_bytes=_j(b1), mask=_j(m1), centers=jc)
    told = _St(u=_t(f["u0"]), comm_bytes=_t(b0), mask=_t(m0))
    tnew = _St(u=_t(f["u1"]), comm_bytes=_t(b1), mask=_t(m1), centers=tc)
    return (jold, jnew), (told, tnew)


COLLECTORS = {
    "fedspd": dict(),
    "fedspd sparse int8": dict(has_mask=True, wire_ratio=5655 / 68904),
    "static bytes": dict(per_round_bytes=33762960.0, has_u=False, has_plane=False),
    "no gap": dict(cfg=dict(spectral_gap=False, staleness_bins=3, power_iters=2)),
}


@pytest.mark.parametrize("case", list(COLLECTORS))
@pytest.mark.parametrize("system", [False, True])
@pytest.mark.parametrize("layout", ["plane", "tree"])
def test_make_collector_matches_jax(layout, system, case):
    rng = np.random.default_rng(7)
    kw = dict(COLLECTORS[case])
    cfg_kw = kw.pop("cfg", {})
    (jold, jnew), (told, tnew) = _states(layout, rng)
    adj = _er(rng, N, 0.5)
    weights = stale = jw = js = None
    if system:
        w = rng.uniform(0.2, 1.0, size=N).astype(np.float32)
        w[[1, 4]] = 0.0
        st = np.array([0, 1, 2, 7, 4, 11], np.int32)   # ages past the last bin
        weights, stale, jw, js = _t(w), _t(st), _j(w), _j(st)
        adj = adj * (w > 0)[:, None] * w[None, :]
    common = dict(n_clusters=S, n_clients=N, **kw)
    jcol = jm.make_collector(JTelemetryConfig(**cfg_kw), **common)
    tcol = tm.make_collector(TelemetryConfig(**cfg_kw), **common)
    want = jcol(jold, jnew, _j(adj), weights=jw, stale=js)
    got = tcol(told, tnew, _t(adj), weights=weights, stale=stale)
    assert list(got) == list(STREAMS) and sorted(want) == sorted(STREAMS)
    for name in STREAMS:
        g, w_ = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w_.shape and g.dtype == np.float32, name
        assert np.array_equal(np.isnan(g), np.isnan(w_)), name
        if name in ("degree", "stale_hist", "n_inactive", "logical_bytes", "wire_bytes"):
            assert np.array_equal(g, w_, equal_nan=True), name
        elif name == "spectral_gap" and not np.isnan(w_).all():
            _close_gap(g, w_)
        elif not np.isnan(w_).all():
            np.testing.assert_allclose(g, w_, rtol=1e-5 if name == "consensus" else 1e-6,
                                       atol=0, err_msg=name)
    if system:
        assert float(got["n_inactive"]) == 2.0
        assert got["stale_hist"].sum() == N


def test_collector_batch_shape_matches_jax():
    """A leading seed axis: (k, N, S) weights, (k, S, N, X) planes."""
    rng = np.random.default_rng(8)
    k = 3
    u0 = rng.dirichlet(np.ones(S), size=(k, N)).astype(np.float32)
    u1 = rng.dirichlet(np.ones(S), size=(k, N)).astype(np.float32)
    c = rng.normal(size=(k, S, N, X)).astype(np.float32)
    adj = np.stack([_er(rng, N, 0.5) for _ in range(k)])
    b = np.arange(k, dtype=np.float32) * 100.0
    want = jm.make_collector(JTelemetryConfig(), batch_shape=(k,), n_clusters=S, n_clients=N)(
        _St(u=_j(u0), comm_bytes=_j(b)), _St(u=_j(u1), comm_bytes=_j(2 * b), centers=_j(c)),
        _j(adj))
    got = tm.make_collector(TelemetryConfig(), batch_shape=(k,), n_clusters=S, n_clients=N)(
        _St(u=_t(u0), comm_bytes=_t(b)), _St(u=_t(u1), comm_bytes=_t(2 * b), centers=_t(c)),
        _t(adj))
    for name in STREAMS:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape, name
        if name == "spectral_gap":
            _close_gap(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5 if name == "consensus" else 1e-6,
                                       atol=0, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("kw", [dict(power_iters=0), dict(staleness_bins=1),
                                dict(power_iters=-3, staleness_bins=0)])
def test_telemetry_config_validates_as_jax(kw):
    with pytest.raises(ValueError):
        JTelemetryConfig(**kw)
    with pytest.raises(ValueError, match="power_iters|staleness_bins"):
        TelemetryConfig(**kw)
    assert TelemetryConfig().enabled and not TelemetryConfig(round_metrics=False).enabled
    assert dataclasses.asdict(TelemetryConfig()) == dataclasses.asdict(JTelemetryConfig())


# --------------------------------------------------------------------------
# which streams are NaN, id by id
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's default (pytree) run of every id: 2 rounds on the loop, one
    evaluation, compiled with ``jax_disable_most_optimizations`` (LLVM at
    -O0; the flag is not part of JAX's compile cache key, so the caches
    are cleared on the way out)."""
    data, exp = j_data(**DATA), JExp(**EXP)
    cfg = JRunConfig(eval_every=10, telemetry=JTelemetryConfig())
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return {m: j_run_method(m, data, exp, cfg=cfg).telemetry
                for m in available_methods()}
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
        jax.clear_caches()


@pytest.mark.parametrize("method", available_methods())
def test_nan_pattern_and_shapes_match_jax(jax_runs, method):
    want = jax_runs[method]
    data, exp = make_mixture_classification(**DATA), PaperExpConfig(**EXP)
    base = RunConfig(device="cpu", eval_every=2, telemetry=TelemetryConfig())
    for kw in ({}, {"param_plane": True}, {"param_plane": False}):
        for scan in (False, True):
            cfg = dataclasses.replace(base, scan_rounds=scan, **kw)
            got = run_method(method, data, exp, cfg=cfg).telemetry
            assert got["rounds"] == want["rounds"] == exp.rounds
            assert sorted(got["streams"]) == sorted(want["streams"]) == sorted(STREAMS)
            for name, w in want["streams"].items():
                g, w = got["streams"][name], np.asarray(w)
                assert g.shape == w.shape and g.dtype == np.float32, (kw, name)
                assert np.array_equal(np.isnan(g), np.isnan(w)), (kw, scan, name)
                if method.startswith("fedspd"):
                    continue   # tracked bytes: the selections differ by RNG
                if name in ("logical_bytes", "wire_bytes", "degree", "stale_hist",
                            "n_inactive"):
                    assert np.array_equal(g, w), (kw, scan, name)
                elif name == "spectral_gap":
                    _close_gap(g, w)
