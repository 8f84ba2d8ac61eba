"""PyTorch port, whole runs of the per-leaf pytree engine
(``RunConfig(param_plane=False)``, the JAX package's default) against the
JAX package, live in one process (JAX on the CPU, the port with
device="cpu"), at the smoke size of tests/test_param_plane_methods.py (N
= 5 clients, 32 points, dim 8, 3 classes, 3 rounds).

- All 13 ids: the port's pytree run against JAX's default (pytree) run
  over seeds 0-9 (JAX's batches compiled least optimized, as in
  tests/test_torch_variants.py): static comm bytes exactly, FedSPD's
  tracked bytes a whole number of models, ``mean_acc`` (and the mean
  largest u) within max(0.02, the JAX runs' seed std); and against the
  port's own plane run of the same seed (equal accuracy, u / choice and
  bytes), as tests/test_param_plane_methods.py holds JAX's two engines.
- ``RunConfig()`` resolves to the plane (the port's default), JAX's to
  the pytree engine.
- A rewired-graph scenario with link dropout on the pytree engine, and
  the replay against the loop bit for bit (FedSPD with DP, FedEM,
  FedAvg).
- ``cluster_plane(state, spec=)`` and ``export_run`` of a pytree-engine
  run: the same plane and artifact bytes as JAX's from the same state.

One round of each step with injected draws is tests/test_torch_pytree.py's.
"""
import contextlib
import dataclasses
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import run_method_batch as j_run_method_batch
from repro.experiments.export import cluster_plane as j_cluster_plane
from repro.experiments.export import export_run as j_export_run
from repro.models.smallnets import make_classifier as j_classifier
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import (
    RunConfig,
    Scenario,
    available_methods,
    export_run,
    run_method,
    run_method_batch,
)
from repro_torch.experiments.export import cluster_plane
from repro_torch.experiments.registry import build_context, get_method
from repro_torch.graphs.topology import rewire_schedule
from repro_torch.utils import pytree as tpt

N, S, DIM, C, M, BATCH = 5, 2, 8, 3, 32, 8
DP = dict(dp_clip=1.0, dp_noise_multiplier=0.5)
SEEDS = tuple(range(10))
DKW = dict(n_clients=N, n_clusters=S, n_per_client=M, dim=DIM, n_classes=C, seed=0,
           noise=0.3)
EKW = dict(n_clients=N, n_per_client=M, rounds=3, tau=1, batch=BATCH, avg_degree=3.0,
           model="mlp", dim=DIM, n_classes=C)
IDS = ("fedspd", "fedspd_permute", "local", "dfl_fedavg", "cfl_fedavg", "dfl_fedem",
       "cfl_fedem", "dfl_ifca", "cfl_ifca", "dfl_fedsoft", "cfl_fedsoft", "dfl_pfedme",
       "cfl_pfedme")
CPU = RunConfig(device="cpu", eval_every=10**9, param_plane=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A JAX or port tree as a nested dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


# --------------------------------------------------------------------------
# whole runs: JAX's default (pytree) runs, the port's own plane runs
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    return j_data(**DKW), JExp(**EKW), make_mixture_classification(**DKW), \
        PaperExpConfig(**EKW)


@contextlib.contextmanager
def _jax_least_optimized():
    """JAX compiles with ``jax_disable_most_optimizations`` inside (LLVM at
    -O0), as tests/test_torch_variants.py does for its batches: the
    compiles are most of these runs' time. The flag is not part of JAX's
    compile cache key, so the caches are cleared on the way out."""
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
        jax.clear_caches()


@pytest.fixture(scope="module")
def jax_runs(smoke):
    """JAX's default runs (the pytree engine, the reference backend), one
    ``run_method_batch`` over SEEDS a method id."""
    jdata, jexp, _, _ = smoke
    with _jax_least_optimized():
        return {m: j_run_method_batch(m, jdata, jexp, seeds=SEEDS,
                                      cfg=JRunConfig(eval_every=10**9)) for m in IDS}


def _largest_u(res) -> float:
    """The mean over clients of each client's largest mixture weight: a
    summary of u that label switching leaves alone."""
    return float(res.extras["u"].max(axis=1).mean())


@pytest.mark.parametrize("method", IDS)
def test_pytree_run_matches_jax_default_run(smoke, jax_runs, method):
    _, _, data, exp = smoke
    jres = jax_runs[method]
    tres = run_method_batch(method, data, exp, seeds=SEEDS, cfg=CPU)
    jacc = np.array([r.mean_acc for r in jres])
    tacc = np.array([r.mean_acc for r in tres])
    tol = max(0.02, float(np.std(jacc)))
    assert abs(jacc.mean() - tacc.mean()) <= tol, (jacc, tacc, tol)
    model_b = build_context(data, exp, torch.device("cpu")).pack_spec.model_bytes
    for r, jr in zip(tres, jres):
        assert np.isfinite(r.mean_acc) and r.acc_per_client.shape == (N,)
        if method.startswith("fedspd"):
            # tracked point-to-point bytes: whole models over matched links
            assert r.comm_bytes > 0 and r.comm_bytes % model_b == 0
            assert jr.comm_bytes % model_b == 0
        else:
            assert r.comm_bytes == jr.comm_bytes
        assert r.wire_bytes == r.comm_bytes
        for k in ("u", "choice"):
            assert (k in r.extras) == (k in jr.extras), k
            if k in r.extras:
                assert r.extras[k].shape == jr.extras[k].shape
    if "u" in jres[0].extras:
        ju = np.array([_largest_u(r) for r in jres])
        tu = np.array([_largest_u(r) for r in tres])
        tol = max(0.02, float(np.std(ju)))
        assert abs(ju.mean() - tu.mean()) <= tol, (ju, tu, tol)


@pytest.mark.parametrize("method", IDS)
def test_pytree_run_equals_the_plane_run_of_the_same_seed(smoke, method):
    """The port's two engines from one seed: the same draws, the same
    updates up to fp32 rounding (tests/test_param_plane_methods.py's
    bounds for JAX's two engines); bytes exactly."""
    _, _, data, exp = smoke
    a = run_method(method, data, exp, cfg=CPU)
    b = run_method(method, data, exp, cfg=dataclasses.replace(CPU, param_plane=None))
    np.testing.assert_allclose(a.acc_per_client, b.acc_per_client, atol=1e-4)
    for k in ("u", "choice"):
        if k in a.extras:
            np.testing.assert_allclose(a.extras[k], b.extras[k], atol=1e-4)
    assert a.comm_bytes == b.comm_bytes


def test_run_config_resolves_to_the_plane_unless_asked():
    """The port's default is the packed plane (JAX's is the pytree engine,
    a difference by design): an unset ``param_plane`` resolves to it."""
    assert "param_plane" not in RunConfig().resolve_options()
    assert JRunConfig().resolve_options().get("param_plane") is None
    ctx = build_context(make_mixture_classification(**DKW), PaperExpConfig(**EKW),
                        torch.device("cpu"), options=RunConfig().resolve_options())
    m = get_method("fedspd")
    assert m.plane_spec(ctx) is ctx.pack_spec
    assert isinstance(m.init(ctx, torch.Generator().manual_seed(0)).centers, torch.Tensor)
    ctx = build_context(make_mixture_classification(**DKW), PaperExpConfig(**EKW),
                        torch.device("cpu"), options=CPU.resolve_options())
    assert m.plane_spec(ctx) is None
    assert isinstance(m.init(ctx, torch.Generator().manual_seed(0)).centers, dict)


@pytest.mark.parametrize("dp", [False, True])
def test_rewired_scenario_on_the_pytree_engine(smoke, dp):
    """A rewired ER schedule with link dropout: the pytree run equals the
    plane run of the same seed (DP off; with DP the engines draw their
    noise differently, as JAX's do), and its replay equals its loop bit
    for bit."""
    _, _, data, exp = smoke
    sched = rewire_schedule("er", N, 3.0, exp.rounds, p_rewire=0.3, seed=2)
    opts = dict(DP, keep_state=True) if dp else {"keep_state": True}
    cfg = dataclasses.replace(CPU, eval_every=1, options=opts,
                              scenario=Scenario(graph_schedule=sched, dropout=0.2, seed=3))
    loop = run_method("fedspd", data, exp, cfg=cfg)
    scan = run_method("fedspd", data, exp, cfg=dataclasses.replace(cfg, scan_rounds=True))
    assert np.array_equal(loop.acc_per_client, scan.acc_per_client)
    assert loop.curve == scan.curve and loop.comm_bytes == scan.comm_bytes
    assert np.array_equal(loop.extras["u"], scan.extras["u"])
    for a, b in zip(tpt.tree_leaves(loop.extras["state"].centers),
                    tpt.tree_leaves(scan.extras["state"].centers)):
        assert torch.equal(a, b)
    assert scan.extras["n_captures"] == 1
    if not dp:
        plane = run_method("fedspd", data, exp, cfg=dataclasses.replace(cfg, param_plane=None))
        np.testing.assert_allclose(loop.acc_per_client, plane.acc_per_client, atol=1e-4)
        assert loop.comm_bytes == plane.comm_bytes


@pytest.mark.parametrize("method", ["fedspd", "dfl_fedem", "dfl_fedavg"])
def test_pytree_replay_equals_the_loop_bit_for_bit(smoke, method):
    _, _, data, exp = smoke
    opts = dict(DP, keep_state=True) if method == "fedspd" else {"keep_state": True}
    cfg = dataclasses.replace(CPU, eval_every=1, options=opts)
    loop = run_method(method, data, exp, cfg=cfg)
    scan = run_method(method, data, exp, cfg=dataclasses.replace(cfg, scan_rounds=True))
    assert np.array_equal(loop.acc_per_client, scan.acc_per_client)
    assert loop.curve == scan.curve and loop.comm_bytes == scan.comm_bytes
    ls, ss = loop.extras["state"], scan.extras["state"]
    assert isinstance(ls, dict) == (method == "dfl_fedavg")
    assert len(tpt.state_tensors(ls)) == len(tpt.state_tensors(ss)) > 3
    for a, b in zip(tpt.state_tensors(ls), tpt.state_tensors(ss)):
        assert torch.equal(a, b)
    assert scan.extras["n_captures"] == 1 and scan.extras["n_dispatches"] == exp.rounds


@pytest.fixture(scope="module")
def kept(smoke):
    _, _, data, exp = smoke
    return run_method("fedspd", data, exp,
                      cfg=dataclasses.replace(CPU, options={"keep_state": True}))


def test_cluster_plane_of_a_pytree_state_equals_jax(kept):
    st = kept.extras["state"]
    assert kept.extras["pack_spec"] is None and isinstance(st.centers, dict)
    jspec = j_make_pack_spec(j_classifier("mlp", jax.random.PRNGKey(0), DIM, C)[0])
    spec = build_context(make_mixture_classification(**DKW), PaperExpConfig(**EKW),
                         torch.device("cpu")).pack_spec
    jst = types.SimpleNamespace(centers=jax.tree.map(jnp.asarray, _np(st.centers)))
    got = cluster_plane(st, spec)
    want = np.asarray(j_cluster_plane(jst, jspec))
    assert got.shape == (S, spec.size) and np.array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="spec"):
        cluster_plane(st)


@pytest.mark.parametrize("codec", ["fp32", "int8"])
def test_pytree_export_run_equals_jax_byte_for_byte(kept, tmp_path, codec):
    st = kept.extras["state"]
    jst = types.SimpleNamespace(centers=jax.tree.map(jnp.asarray, _np(st.centers)),
                                u=jnp.asarray(st.u.numpy()))
    jres = types.SimpleNamespace(extras={"state": jst, "pack_spec": None})
    path, jpath = tmp_path / f"t_{codec}.npz", tmp_path / f"j_{codec}.npz"
    man = export_run(kept, str(path), codec=codec)
    jm = j_export_run(jres, str(jpath), codec=codec)
    assert man.to_json() == jm.to_json()
    assert pathlib.Path(path).read_bytes() == pathlib.Path(jpath).read_bytes()


def test_every_id_runs_on_the_pytree_engine(smoke):
    assert set(IDS) == set(available_methods())
