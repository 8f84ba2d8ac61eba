"""PyTorch port, the round engines: ``RunConfig(scan_rounds=True)`` (one
captured round over static buffers, replayed on the card and called
directly here on the CPU), ``RunConfig(cohort_size=K)`` and
``run_method_batch``, on the JAX package's ``test_scan_rounds.py`` setup
(N = 6 clients, 32 points each, dim 8, 4 rounds).

- The scan engine equals the loop engine bit for bit (accuracies, u, the
  curve, comm bytes, the final plane) for FedSPD plain, DP, int8 with
  error feedback and sparse masks updated every 2 rounds (two captured
  rounds), and for ``dfl_fedavg``, ``dfl_fedem`` and ``local``.
- The port's ``_cohort_step`` against the JAX package's at the seams: the
  same active indices and the JAX step's own draws give the same centers
  and u within the reference's 1e-5; inactive rows stay bit-untouched.
- Both engines run each round inside the runner's profiler span and call
  ``RunConfig.on_round`` after it; the default engine on the CPU is the
  loop (on the card: the replay).
- Each seed of a batch equals its single-seed run bit for bit (shared
  data, stacked data, per-seed graphs), and the port's batch agrees with
  JAX's ``run_method_batch`` within ``max(2 pts, JAX seed std)`` (the
  bound of tests/test_comm.py).

About 60 s in one CPU process, over half of it
JAX's (the cohort step's compile and the batch of 10 seeds)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.core.fedspd import select_clusters as j_select
from repro.data.pipeline import sample_cluster_batch_indices
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import run_method_batch as j_run_method_batch
from repro.experiments.registry import build_context as j_build_context
from repro.experiments.registry import get_method as j_get_method
from repro.experiments.runner import _cohort_step as j_cohort_step
from repro.graphs.topology import make_graph as j_graph
from repro.graphs.topology import union_graph as j_union_graph
from repro_torch.comm.codecs import CommConfig
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.fedspd import make_round_step
from repro_torch.core.gossip import GossipSpec, make_mix_fn
from repro_torch.core.sparse import SparseConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import RunConfig, run_method, run_method_batch
from repro_torch.experiments.registry import build_context, get_method
from repro_torch.experiments.runner import ROUND_SPAN, _cohort_indices, _cohort_step
from repro_torch.graphs.topology import make_graph, union_graph
from repro_torch.interop import state_from_numpy
from repro_torch.kernels.gossip_mix import KERNELS, reset_launch_counts

N, ROUNDS = 6, 4
EXP = dict(n_clients=N, n_per_client=32, rounds=ROUNDS, tau=1, batch=8,
           avg_degree=3.0, model="mlp", dim=8, n_classes=3)
DATA = dict(n_clients=N, n_clusters=2, n_per_client=32, dim=8, n_classes=3,
            seed=7, noise=0.3)
CPU = RunConfig(device="cpu", eval_every=2, options={"keep_state": True})
PATHS = {
    "fedspd": ("fedspd", {}),
    "fedspd-dp": ("fedspd", dict(options={"keep_state": True, "dp_clip": 1.0,
                                          "dp_noise_multiplier": 0.5})),
    "fedspd-int8-ef": ("fedspd", dict(comm=CommConfig(codec="int8",
                                                      error_feedback=True))),
    "fedspd-sparse": ("fedspd", dict(sparse=SparseConfig(density=0.3,
                                                         update_every=2))),
    "dfl_fedavg": ("dfl_fedavg", {}),
    "dfl_fedem": ("dfl_fedem", {}),
    "local": ("local", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    return make_mixture_classification(**DATA), PaperExpConfig(**EXP)


def _state_tensors(state):
    return [v for v in ((state,) if isinstance(state, torch.Tensor) else state)
            if isinstance(v, torch.Tensor)]


def _assert_same_run(a, b):
    assert np.array_equal(a.acc_per_client, b.acc_per_client)
    assert a.curve == b.curve
    assert a.comm_bytes == b.comm_bytes and a.wire_bytes == b.wire_bytes
    if "u" in a.extras:
        assert np.array_equal(a.extras["u"], b.extras["u"])
    if "state" in a.extras:
        for x, y in zip(_state_tensors(a.extras["state"]),
                        _state_tensors(b.extras["state"])):
            assert torch.equal(x, y)


def _pair(setup, path, **kw):
    method, extra = PATHS[path]
    cfg = dataclasses.replace(CPU, **extra, **kw)
    data, exp = setup
    return (run_method(method, data, exp, cfg=cfg),
            run_method(method, data, exp, cfg=dataclasses.replace(cfg, scan_rounds=True)))


@pytest.mark.parametrize("path", list(PATHS))
def test_scan_rounds_equals_the_loop_bit_for_bit(setup, path):
    loop, scan = _pair(setup, path)
    _assert_same_run(loop, scan)
    assert [r for r, _ in scan.curve] == [0, 2, 3]
    assert len(scan.extras["round_ms"]) == ROUNDS


@pytest.mark.parametrize("path,captures", [("fedspd", 1), ("fedspd-sparse", 2),
                                           ("dfl_fedem", 1)])
def test_captures_and_dispatches(setup, path, captures):
    """One captured round per host-side branch (the sparse masks' update
    rounds are the second), one dispatch a round; the loop captures none
    and dispatches one step a round (batches: test_batch_seed_equals_its_single_run)."""
    loop, scan = _pair(setup, path)
    assert (scan.extras["n_captures"], scan.extras["n_dispatches"]) == (captures, ROUNDS)
    assert (loop.extras["n_captures"], loop.extras["n_dispatches"]) == (0, ROUNDS)


@pytest.mark.parametrize("path", ["fedspd-dp", "fedspd-sparse"])
def test_launch_counts_equal_across_engines(setup, path):
    """The counters tick only where a wrapper launches its kernel: on the
    CPU neither engine launches one (their plain versions run), so both
    leave every counter at 0. (On the card a replayed run's counters hold
    its warm-up's and capture's launches; the profiler counts the
    replays', test_torch_gpu.py and chip_smoke.py.)"""
    counts = []
    for scan in (False, True):
        reset_launch_counts()
        method, extra = PATHS[path]
        run_method(method, *setup, cfg=dataclasses.replace(CPU, scan_rounds=scan, **extra))
        counts.append({k.__name__: k.launches for k in KERNELS})
    assert counts[0] == counts[1] == {k.__name__: 0 for k in KERNELS}


@pytest.mark.parametrize("scan", [False, True])
def test_each_round_runs_in_one_profiler_span(setup, scan):
    """Both engines run each round inside one ROUND_SPAN, the window a
    profiler around run_method reads a round's device work from (the
    driver's span, so the cheapest method shows it)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run_method("local", *setup, cfg=dataclasses.replace(CPU, scan_rounds=scan,
                                                             eval_every=10**9))
    spans = [e for e in prof.events() if e.name == ROUND_SPAN]
    assert len(spans) == ROUNDS
    assert all(any(c.name.startswith("aten::") for c in e.cpu_children) for e in spans)


@pytest.mark.parametrize("scan", [False, True])
def test_on_round_sees_every_round(setup, scan):
    """The on_round hook runs once after each round, in order, on both
    engines, and leaves the run as it was."""
    seen = []
    cfg = dataclasses.replace(CPU, scan_rounds=scan, eval_every=10**9)
    r = run_method("local", *setup, cfg=dataclasses.replace(cfg, on_round=seen.append))
    assert seen == list(range(ROUNDS))
    _assert_same_run(r, run_method("local", *setup, cfg=cfg))


def test_the_default_engine_is_the_loop_on_the_cpu(setup):
    """scan_rounds=None (the default) replays on the card and loops on
    the CPU, where nothing is captured."""
    assert RunConfig().scan_rounds is None
    r = run_method("fedspd", *setup, cfg=CPU)
    assert (r.extras["n_captures"], r.extras["n_dispatches"]) == (0, ROUNDS)


# --------------------------------------------------------------------------
# cohort subsampling
# --------------------------------------------------------------------------


def _j_round_draws(state, tau, batch):
    """The JAX packed step's draws for its (sub)state, split as
    core/fedspd.step_full_packed splits them (DP off)."""
    _, k_sel, k_local = jax.random.split(state.key, 3)
    s = j_select(k_sel, state.u)
    n = state.u.shape[0]
    idx = [jax.vmap(lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, batch))(
        jax.random.split(k, n), state.z, s) for k in jax.random.split(k_local, tau)]
    return np.array(s), np.stack([np.asarray(i) for i in idx])


def test_cohort_step_matches_jax_at_the_seams(setup):
    data, exp = setup
    jexp, g = JExp(**EXP), j_graph("er", N, 3.0, seed=0)
    jctx = j_build_context(j_data(**DATA), jexp, graph=g, seed=0,
                           options=JRunConfig(param_plane=True).resolve_options())
    jm = j_get_method("fedspd")
    jstate = jm.init(jctx, jax.random.PRNGKey(0))
    active = np.array([1, 3, 4])
    adj = jnp.asarray(g.adj, jnp.float32)
    jstep = j_cohort_step(jm.make_step(jctx), jm.cohort_axes(jctx, jstate))
    jnew, _ = jax.jit(jstep)(jstate, jctx.train, jax.random.PRNGKey(1),
                             jnp.float32(0.05), adj, jnp.asarray(active))
    jsub = jstate._replace(u=jstate.u[active], z=jstate.z[active])
    s, idx = _j_round_draws(jsub, exp.tau, exp.batch)

    ctx = build_context(data, exp, torch.device("cpu"), graph=make_graph("er", N, 3.0, 0),
                        options=CPU.resolve_options())
    m = get_method("fedspd")
    spec = GossipSpec.from_graph(ctx.graph)
    core = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, m._fcfg(ctx),
                           pack_spec=ctx.pack_spec, mix_fn=make_mix_fn(spec))

    def injected(st, train, gen, lr, sub_adj):
        return core(st, train, sub_adj, s=torch.as_tensor(s), idx=torch.as_tensor(idx))

    state = state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    before = [t.clone() for t in (state.centers, state.u, state.z)]
    step = _cohort_step(injected, m.cohort_axes(ctx, state))
    new, _ = step(state, ctx.train, None, None, torch.as_tensor(g.adj),
                  torch.as_tensor(active))
    np.testing.assert_allclose(new.centers.numpy(), np.asarray(jnew.centers), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(new.u.numpy(), np.asarray(jnew.u), atol=1e-5, rtol=0)
    assert float(new.comm_bytes) == float(jnew.comm_bytes)
    inactive = np.array([0, 2, 5])
    assert torch.equal(new.centers[:, inactive], before[0][:, inactive])
    assert torch.equal(new.u[inactive], before[1][inactive])
    assert torch.equal(new.z[inactive], before[2][inactive])
    assert np.array_equal(new.z.numpy()[inactive], np.asarray(jnew.z)[inactive])
    assert not torch.equal(new.centers[:, active], before[0][:, active])


def test_cohort_indices_sorted_unique():
    gen = torch.Generator().manual_seed(3)
    for _ in range(5):
        idx = _cohort_indices(gen, 64, 16)
        assert idx.shape == (16,) and bool((idx.diff() > 0).all())
        assert 0 <= int(idx.min()) and int(idx.max()) < 64


def test_cohort_bytes_scale_with_k_and_full_cohort_is_the_plain_run(setup):
    """K = 3 of 6: tracked bytes at most R·K·(K−1) messages, below the full
    run's; K = N gathers everyone and runs the cohort-free trajectory; both
    engines pick the same cohorts."""
    data, exp = setup
    g = make_graph("er", N, 3.0, seed=0)
    cfg = dataclasses.replace(CPU, options={})
    full = run_method("fedspd", data, exp, graph=g, cfg=cfg)
    coh = run_method("fedspd", data, exp, graph=g, cfg=dataclasses.replace(cfg, cohort_size=3))
    assert 0.0 < coh.comm_bytes < full.comm_bytes
    model_bytes = full.comm_bytes / (exp.rounds * (float(g.adj.sum()) - N))
    assert coh.comm_bytes <= exp.rounds * 3 * 2 * model_bytes
    _assert_same_run(full, run_method("fedspd", data, exp, graph=g,
                                      cfg=dataclasses.replace(cfg, cohort_size=N)))
    _assert_same_run(coh, run_method("fedspd", data, exp, graph=g,
                                     cfg=dataclasses.replace(cfg, cohort_size=3,
                                                             scan_rounds=True)))


@pytest.mark.parametrize("method,k,what", [("dfl_fedavg", 3, "cohort subsampling"),
                                           ("fedspd", N + 1, "must be in 1..N"),
                                           ("fedspd", 0, "must be in 1..N")])
def test_cohort_validation(setup, method, k, what):
    with pytest.raises(ValueError, match=what):
        run_method(method, *setup, cfg=dataclasses.replace(CPU, cohort_size=k))


# --------------------------------------------------------------------------
# run_method_batch
# --------------------------------------------------------------------------


def test_union_graph_equals_jax():
    adjs = np.stack([make_graph(k, 9, 3.0, seed=s).adj
                     for k, s in (("er", 0), ("ba", 1), ("ring", 2))])
    assert np.array_equal(union_graph(adjs).adj, j_union_graph(adjs).adj)
    assert union_graph(adjs).adj.dtype == j_union_graph(adjs).adj.dtype


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("kind", ["shared", "stacked", "graphs"])
def test_batch_seed_equals_its_single_run(setup, kind, scan):
    data, exp = setup
    seeds = (0, 1, 2)
    g = make_graph("er", N, 3.0, seed=seeds[0])   # the batch's graph: the first seed's
    datas, graphs, graph_arg, data_arg = [data] * 3, [g] * 3, None, data
    if kind == "stacked":
        datas = [make_mixture_classification(**dict(DATA, seed=s)) for s in (7, 8, 9)]
        data_arg = datas
    if kind == "graphs":
        graphs = [make_graph("er", N, 3.0, seed=s) for s in (4, 5, 6)]
        graph_arg = graphs
    cfg = dataclasses.replace(CPU, scan_rounds=scan)
    batch = run_method_batch("fedspd", data_arg, exp, seeds=seeds, graph=graph_arg, cfg=cfg)
    # one captured round for the three seeds, one dispatch a round; the
    # loop dispatches each seed's step
    assert [(r.extras["n_captures"], r.extras["n_dispatches"]) for r in batch] \
        == [(1, ROUNDS) if scan else (0, 3 * ROUNDS)] * 3
    for s, d, gr, r in zip(seeds, datas, graphs, batch):
        _assert_same_run(r, run_method("fedspd", d, exp, graph=gr, seed=s,
                                       cfg=dataclasses.replace(CPU)))


def test_batch_refuses_what_jax_refuses(setup):
    data, exp = setup
    with pytest.raises(ValueError, match="per-seed graphs"):
        run_method_batch("dfl_fedavg", data, exp, seeds=(0, 1), cfg=CPU,
                         graph=[make_graph("er", N, 3.0, seed=s) for s in (0, 1)])
    with pytest.raises(ValueError, match="stacked data: got 2 datasets for 3 seeds"):
        run_method_batch("fedspd", [data, data], exp, seeds=(0, 1, 2), cfg=CPU)
    with pytest.raises(ValueError, match="per-seed graphs: got 1 graphs"):
        run_method_batch("fedspd", data, exp, seeds=(0, 1), cfg=CPU,
                         graph=[make_graph("er", N, 3.0, seed=0)])


def test_batch_matches_jax_within_the_seed_statistical_bound():
    """test_torch_run.py's population (N = 8, 96 points, dim 16), 10
    rounds, seeds 0–9: the port's batch under scan_rounds against JAX's
    batch rolled into one scan, both on the first seed's graph. Ten seeds:
    the seed std of the mean accuracy is about 0.025, so the mean of three
    moves by about 0.015 and two such means can fall past the bound by
    chance; the mean of ten moves by about 0.008."""
    dkw = dict(n_clients=8, n_clusters=2, n_per_client=96, n_classes=4, dim=16)
    ekw = dict(n_clients=8, n_per_client=96, n_classes=4, dim=16, rounds=10,
               avg_degree=3.0)
    seeds = tuple(range(10))
    jres = j_run_method_batch("fedspd", j_data(**dkw), JExp(**ekw), seeds=seeds,
                              cfg=JRunConfig(param_plane=True, eval_every=10**9,
                                             scan_rounds=True))
    tres = run_method_batch("fedspd", make_mixture_classification(**dkw),
                            PaperExpConfig(**ekw), seeds=seeds,
                            cfg=RunConfig(device="cpu", eval_every=10**9,
                                          scan_rounds=True))
    jacc = np.array([r.mean_acc for r in jres])
    tacc = np.array([r.mean_acc for r in tres])
    tol = max(0.02, float(np.std(jacc)))
    assert abs(jacc.mean() - tacc.mean()) <= tol, (jacc, tacc, tol)
    for r in tres:
        assert np.isfinite(r.mean_acc) and r.acc_per_client.shape == (8,)
        assert r.comm_bytes > 0 and r.extras["n_captures"] == 1
