"""PyTorch port, the scenario engine (dynamic topologies, link dropout,
client-system heterogeneity) against the JAX package on the CPU, at the
size of tests/test_heterogeneity.py (N = 6 clients, 32 points, dim 8, 4
rounds):

- the copied numpy helpers (``pod_aware``, ``rewire``,
  ``rewire_schedule``, ``stack_schedule``, ``drop_edges``,
  ``dropout_schedule``, ``symmetric_mask_drop``) and
  ``make_unbalanced_quantity`` equal JAX's bit for bit;
- ``bernoulli_drop`` and the torch ``symmetric_mask_drop`` on JAX-drawn
  uniforms, ``het_round`` on the normals and uniforms JAX draws from
  ``fold_in(key, r)`` over rounds of a Markov chain with gamma < 1
  (weights, ``stale`` and ``avail`` exact), ``apply_client_weights`` and
  ``restore_inactive``, all exact;
- one ``masked_client_step`` round (alone, under a cohort, with sparse
  masks, with DP) against JAX's with every draw injected: plane and u at
  1e-5, ``comm_bytes`` exact, inactive rows bit-untouched;
- the JAX package's invariants: validation errors, an all-down run
  charging 0 bytes with staleness = rounds, always-straggling clients
  keeping a uniform u, zero bytes for dropped links, binarized bytes under
  stale weights, every baseline id refused with a dynamic scenario;
- the replay (``scan_rounds=True``) equal to the loop bit for bit, with
  ``staleness`` equal, for a schedule, dropout, heterogeneity (also with
  DP and with sparse + int8) and the full composition batched over seeds;
- whole runs of scenarios with a rewire schedule and with heterogeneity
  (both with dropout), 10 seeds, against JAX's ``run_method_batch``
  within ``max(2 pts, JAX seed std)`` (the bound of tests/test_comm.py).

About 70 s in one CPU process, most of it JAX's (four round-step compiles
and two batched runs of 10 seeds rolled into one scan each)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.core.fedspd import select_clusters as j_select
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import round_comm_bytes as j_round_comm_bytes
from repro.core.sparse import SparseConfig as JSparse
from repro.data.pipeline import sample_cluster_batch_indices
from repro.data.synthetic import make_mixture_classification as j_data
from repro.data.synthetic import make_unbalanced_quantity as j_unbalanced
from repro.experiments import ClientSystemModel as JSystem
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import Scenario as JScenario
from repro.experiments import run_method_batch as j_run_method_batch
from repro.experiments.heterogeneity import apply_client_weights as j_apply_weights
from repro.experiments.heterogeneity import het_round as j_het_round
from repro.experiments.heterogeneity import masked_client_step as j_masked_step
from repro.experiments.heterogeneity import restore_inactive as j_restore
from repro.experiments.registry import build_context as j_build_context
from repro.experiments.registry import get_method as j_get_method
from repro.experiments.runner import _cohort_step as j_cohort_step
from repro.experiments.scenarios import bernoulli_drop as j_bernoulli_drop
from repro.graphs import topology as jtop
from repro_torch.comm.codecs import CommConfig
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.fedspd import FedSPDState, make_round_step
from repro_torch.core.gossip import GossipSpec, fedspd_weight_matrix, make_mix_fn, round_comm_bytes
from repro_torch.core.sparse import SparseConfig
from repro_torch.data.synthetic import make_mixture_classification, make_unbalanced_quantity
from repro_torch.experiments import (
    ClientSystemModel,
    HetCarry,
    RunConfig,
    Scenario,
    apply_client_weights,
    bernoulli_drop,
    het_round,
    masked_client_step,
    restore_inactive,
    run_method,
    run_method_batch,
)
from repro_torch.experiments.heterogeneity import draw_het
from repro_torch.experiments.registry import available_methods, build_context, get_method
from repro_torch.experiments.runner import _cohort_step
from repro_torch.experiments.scenarios import draw_drop
from repro_torch.graphs import topology as ttop
from repro_torch.interop import state_from_numpy

N, ROUNDS, TOL = 6, 4, 1e-5
EXP = dict(n_clients=N, n_per_client=32, rounds=ROUNDS, tau=1, batch=8,
           avg_degree=3.0, model="mlp", dim=8, n_classes=3)
DATA = dict(n_clients=N, n_clusters=2, n_per_client=32, dim=8, n_classes=3,
            seed=7, noise=0.3)
CPU = RunConfig(device="cpu", eval_every=2, options={"keep_state": True})
# tests/test_heterogeneity.py's models
HET = dict(slow_fraction=0.34, slow_factor=4.0, time_budget=2.0, p_unavailable=0.2,
           staleness_gamma=0.8, seed=3)
MARKOV = dict(slow_fraction=0.34, slow_factor=4.0, time_budget=2.0, jitter=0.3,
              markov=(0.3, 0.7), staleness_gamma=0.9, seed=5)


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
    return (make_mixture_classification(**DATA), PaperExpConfig(**EXP),
            ttop.make_graph("er", N, 3.0, seed=0))


# --------------------------------------------------------------------------
# the copied numpy helpers, bit for bit
# --------------------------------------------------------------------------


def _schedule(mod):
    return mod.rewire_schedule("er", 12, 4.0, 6, p_rewire=0.3, seed=2).adjs


HELPERS = {
    "pod_aware": lambda mod: mod.pod_aware(6, 3, intra_p=0.5, seed=4).adj,
    "rewire": lambda mod: mod.rewire(mod.make_graph("ba", 14, 4.0, seed=1), 0.4, seed=9).adj,
    "rewire_schedule": _schedule,
    "rewire_schedule_rgg": lambda mod: mod.rewire_schedule("rgg", 10, 3.0, 5, seed=3).adjs,
    "stack_schedule_cycle": lambda mod: mod.stack_schedule(_schedule(mod), 14),
    "stack_schedule_crop": lambda mod: mod.stack_schedule(_schedule(mod), 4),
    "schedule_union": lambda mod: mod.GraphSchedule(_schedule(mod)).union().adj,
    "schedule_graph": lambda mod: mod.GraphSchedule(_schedule(mod)).graph(8).adj,
    "drop_edges": lambda mod: mod.drop_edges(mod.make_graph("er", 11, 5.0, seed=0).adj, 0.3,
                                             np.random.default_rng(5)),
    "dropout_schedule": lambda mod: mod.dropout_schedule(mod.make_graph("er", 9, 4.0, seed=1),
                                                         7, 0.25, seed=6).adjs,
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_numpy_helpers_equal_jax_bit_for_bit(name):
    got, want = HELPERS[name](ttop), HELPERS[name](jtop)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_stack_schedule_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="rounds, N, N"):
        ttop.stack_schedule(np.zeros((3, 4, 5), np.float32), 2)


@pytest.mark.parametrize("ratio,seed", [(4.0, 0), (10.0, 3), (0.5, 1)])
def test_make_unbalanced_quantity_equals_jax(ratio, seed):
    base = dict(n_clients=7, n_clusters=2, n_per_client=40, dim=6, n_classes=3, seed=2)
    got = make_unbalanced_quantity(make_mixture_classification(**base), ratio, seed=seed)
    want = j_unbalanced(j_data(**base), ratio, seed=seed)
    for f in ("x", "y", "z_true", "mix_true", "x_test", "y_test"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


# --------------------------------------------------------------------------
# the per-round pieces on JAX's draws, exact
# --------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.0, 0.2, 0.5, 1.0])
def test_bernoulli_drop_on_jax_uniforms_equals_jax(p):
    adj = ttop.make_graph("er", 10, 5.0, seed=3).adj
    for r in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(11), r)
        u = np.asarray(jax.random.uniform(key, (10, 10), jnp.float32))
        want = np.asarray(j_bernoulli_drop(jnp.asarray(adj), key, p))
        got = bernoulli_drop(torch.as_tensor(adj), torch.as_tensor(u), p).numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(got, got.T) and (np.diag(got) == 1).all()


def test_symmetric_mask_drop_torch_and_numpy_equal_jax():
    adj = ttop.make_graph("er", 10, 4.0, seed=3).adj
    u = np.triu(np.random.default_rng(0).random((10, 10)).astype(np.float32), k=1)
    u = u + u.T
    want = np.asarray(jtop.symmetric_mask_drop(jnp.asarray(adj), jnp.asarray(u), 0.4, xp=jnp))
    assert np.array_equal(ttop.symmetric_mask_drop(adj, u, 0.4), want)
    got = ttop.symmetric_mask_drop(torch.as_tensor(adj), torch.as_tensor(u), 0.4)
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)


def test_draws_have_the_shapes_the_rules_read():
    gen = torch.Generator().manual_seed(0)
    u = draw_drop(gen, 7)
    z, v = draw_het(gen, 7)
    assert u.shape == (7, 7) and z.shape == v.shape == (7,)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert float(v.min()) >= 0.0 and float(v.max()) < 1.0


@pytest.mark.parametrize("kw", [MARKOV, HET, dict(staleness_gamma=0.9),
                                dict(time_budget=2.0, jitter=0.5, slow_fraction=0.5)])
def test_het_round_on_jax_draws_equals_jax(kw):
    """Eight rounds from JAX's fold_in(key, r) draws (split into the jitter's
    normals and the availability's uniforms, as JAX's het_round splits
    them): weights, stale and avail exact every round."""
    n = 9
    jm, tm = JSystem(**kw), ClientSystemModel(**kw)
    speeds = tm.resolve_speeds(n)
    assert np.array_equal(speeds, jm.resolve_speeds(n))
    jc, tc = jm.init_carry(n), tm.init_carry(n)
    key = jax.random.fold_in(jax.random.PRNGKey(int(jm.seed)), 0x51AC)
    for r in range(8):
        kr = jax.random.fold_in(key, r)
        k_time, k_avail = jax.random.split(kr)
        z = torch.as_tensor(np.asarray(jax.random.normal(k_time, (n,), jnp.float32)))
        u = torch.as_tensor(np.asarray(jax.random.uniform(k_avail, (n,), jnp.float32)))
        jc, jw = j_het_round(jm, jnp.asarray(speeds), jc, kr)
        tc, tw = het_round(tm, torch.as_tensor(speeds), tc, z, u)
        assert np.array_equal(tw.numpy(), np.asarray(jw)), r
        assert np.array_equal(tc.stale.numpy(), np.asarray(jc.stale)), r
        assert np.array_equal(tc.avail.numpy(), np.asarray(jc.avail)), r
        assert tc.stale.dtype == torch.int32 and tw.dtype == torch.float32


def test_staleness_decay_within_one_ulp_of_jax_at_any_age():
    """gamma**stale: torch's fp32 pow and XLA's agree bit for bit at the
    ages the tests above reach (gamma 0.9 up to 30), and within one ulp at
    any age (they round a few exponents differently, e.g. 0.9**31)."""
    m = ClientSystemModel(staleness_gamma=0.9)
    stale = torch.arange(200, dtype=torch.int32)
    _, w = het_round(m, torch.ones(200), HetCarry(stale, torch.ones(200)),
                     torch.zeros(200), torch.zeros(200))
    want = np.asarray(jnp.power(jnp.float32(0.9), jnp.arange(200).astype(jnp.float32)))
    assert np.array_equal(w.numpy()[:31], want[:31])
    np.testing.assert_array_max_ulp(w.numpy(), want, maxulp=1)


def test_apply_client_weights_and_restore_inactive_equal_jax():
    rng = np.random.default_rng(0)
    adj = ttop.make_graph("er", 8, 4.0, seed=2).adj
    w = np.array([1.0, 0.9, 0.0, 0.5, 1.0, 0.0, 0.7, 1.0], np.float32)
    got = apply_client_weights(torch.as_tensor(adj), torch.as_tensor(w)).numpy()
    assert np.array_equal(got, np.asarray(j_apply_weights(jnp.asarray(adj), jnp.asarray(w))))
    old = FedSPDState(rng.random((2, 8, 5)).astype(np.float32),
                      rng.random((8, 2)).astype(np.float32), rng.integers(0, 2, (8, 4)),
                      3, None, np.float32(7.0))
    new = FedSPDState(rng.random((2, 8, 5)).astype(np.float32),
                      rng.random((8, 2)).astype(np.float32), rng.integers(0, 2, (8, 4)),
                      4, None, np.float32(9.0))
    axes = FedSPDState(1, 0, 0, None, None, None)
    keep = w > 0
    jout = j_restore(*(jax.tree.map(jnp.asarray, s) for s in (old, new)), axes,
                     jnp.asarray(keep))

    def t(s):
        return s._replace(**{f: torch.as_tensor(getattr(s, f))
                             for f in ("centers", "u", "z", "comm_bytes")})

    tout = restore_inactive(t(old), t(new), axes, torch.as_tensor(keep))
    for f in ("centers", "u", "z", "comm_bytes"):
        assert np.array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f))), f
    assert tout.round == 4


# --------------------------------------------------------------------------
# one masked round against JAX's with every draw injected
# --------------------------------------------------------------------------

SP = dict(density=0.3, prune_rate=0.3, update_every=2)
DP = {"dp_clip": 1.0, "dp_noise_multiplier": 0.5}
# case: (the cohort's active clients or None, sparse masks, DP options)
MASKED = {
    "alone": (None, False, {}),
    "cohort": (np.array([0, 1, 2, 4]), False, {}),
    "sparse": (None, True, {}),
    "dp": (None, False, DP),
}


def _j_draws(st, tau, batch, sigma):
    """The JAX packed step's draws for its (sub)state, split as
    core/fedspd.step_full_packed splits them (no codec)."""
    key, k_sel, k_local = jax.random.split(st.key, 3)
    s = j_select(k_sel, st.u)
    n = st.u.shape[0]
    idx = [jax.vmap(lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, batch))(
        jax.random.split(k, n), st.z, s) for k in jax.random.split(k_local, tau)]
    out = dict(s=np.array(s), idx=np.stack([np.asarray(i) for i in idx]))
    if sigma > 0:
        _, k_dp = jax.random.split(key)
        out["noise"] = np.array(jax.random.normal(k_dp, (n, st.centers.shape[-1]),
                                                  jnp.float32))
    return {k: torch.as_tensor(v) for k, v in out.items()}


@pytest.mark.parametrize("case", list(MASKED))
def test_masked_round_matches_jax_with_injected_draws(setup, case):
    """Dropout on JAX's uniforms, then weights with stale (fractional) and
    inactive (0) clients: the plane at 1e-5, bytes exact, the inactive
    clients' rows the old bits, the active ones trained."""
    data, exp, graph = setup
    active, sparse, opts = MASKED[case]
    jexp = JExp(**EXP)
    jopts = JRunConfig(param_plane=True, options=opts,
                       sparse=JSparse(**SP) if sparse else None).resolve_options()
    jctx = j_build_context(j_data(**DATA), jexp, graph=jtop.make_graph("er", N, 3.0, 0),
                           seed=0, options=jopts)
    jm = j_get_method("fedspd")
    jstate = jm.init(jctx, jax.random.PRNGKey(0))
    axes = jm.cohort_axes(jctx, jstate)
    key = jax.random.PRNGKey(21)
    adj = np.asarray(j_bernoulli_drop(jnp.asarray(graph.adj), key, 0.3))
    u_drop = np.asarray(jax.random.uniform(key, (N, N), jnp.float32))
    aw = np.array([1.0, 0.9, 0.0, 0.81, 0.0, 1.0], np.float32)
    jstep = jm.make_step(jctx)
    extra = ()
    if active is not None:
        jstep = j_cohort_step(jstep, axes)
        extra = (jnp.asarray(active),)
    jnew, _ = jax.jit(j_masked_step(jstep, axes))(
        jstate, jctx.train, jax.random.PRNGKey(1), jnp.float32(0.05), jnp.asarray(adj),
        *extra, jnp.asarray(aw))
    jsub = jstate if active is None else jstate._replace(
        u=jstate.u[active], z=jstate.z[active])
    sigma = opts.get("dp_clip", 0.0) * opts.get("dp_noise_multiplier", 0.0)
    draws = _j_draws(jsub, exp.tau, exp.batch, sigma)

    topts = RunConfig(device="cpu", options=opts,
                      sparse=SparseConfig(**SP) if sparse else None).resolve_options()
    ctx = build_context(data, exp, torch.device("cpu"), graph=graph, options=topts)
    m = get_method("fedspd")
    spec = GossipSpec.from_graph(ctx.graph)
    core = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, m._fcfg(ctx),
                           pack_spec=ctx.pack_spec, mix_fn=make_mix_fn(spec),
                           sparse=m._sparse(ctx))

    def injected(st, train, gen, lr, sub_adj):
        return core(st, train, sub_adj, **draws)

    state = state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    taxes = m.cohort_axes(ctx, state)
    step = injected if active is None else _cohort_step(injected, taxes)
    before = [t.clone() for t in (state.centers, state.u, state.z)]
    t_adj = bernoulli_drop(torch.as_tensor(graph.adj), torch.as_tensor(u_drop), 0.3)
    assert np.array_equal(t_adj.numpy(), adj)
    textra = () if active is None else (torch.as_tensor(active),)
    new, _ = masked_client_step(step, taxes)(state, ctx.train, None, None, t_adj, *textra,
                                             torch.as_tensor(aw))
    np.testing.assert_allclose(new.centers.numpy(), np.asarray(jnew.centers), atol=TOL, rtol=0)
    np.testing.assert_allclose(new.u.numpy(), np.asarray(jnew.u), atol=TOL, rtol=0)
    assert float(new.comm_bytes) == float(jnew.comm_bytes)
    if sparse:
        assert np.array_equal(new.mask.numpy(), np.asarray(jnew.mask))
    inactive = [i for i in range(N) if aw[i] == 0 or (active is not None and i not in active)]
    trained = [i for i in range(N) if i not in inactive]
    for i in inactive:
        assert torch.equal(new.centers[:, i], before[0][:, i])
        assert torch.equal(new.u[i], before[1][i]) and torch.equal(new.z[i], before[2][i])
    assert not torch.equal(new.centers[:, trained], before[0][:, trained])


# --------------------------------------------------------------------------
# the JAX package's invariants
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs,field", [
    (dict(slow_fraction=1.5), "slow_fraction"),
    (dict(p_unavailable=-0.1), "p_unavailable"),
    (dict(markov=(1.2, 0.5)), "markov[0]"),
    (dict(markov=(0.5,)), "markov"),
    (dict(p_unavailable=0.2, markov=(0.1, 0.5)), "mutually exclusive"),
    (dict(slow_factor=0.5), "slow_factor"),
    (dict(time_budget=-1.0), "time_budget"),
    (dict(jitter=-0.5), "jitter"),
    (dict(staleness_gamma=0.0), "staleness_gamma"),
    (dict(staleness_gamma=1.5), "staleness_gamma"),
])
def test_client_system_model_validates_as_jax_does(kwargs, field):
    for cls in (ClientSystemModel, JSystem):
        with pytest.raises(ValueError, match=field.replace("[", r"\[")):
            cls(**kwargs)


def test_scenario_validation_and_resolve_equal_jax():
    for p in (1.5, -0.2):
        with pytest.raises(ValueError, match="dropout"):
            Scenario(dropout=p)
    assert Scenario(system=ClientSystemModel()).dynamic and not Scenario().dynamic
    with pytest.raises(ValueError, match="static scenario"):
        Scenario().resolve(None, 3)
    with pytest.raises(ValueError, match="base graph"):
        Scenario(dropout=0.1).resolve(None, 3)
    g = ttop.make_graph("er", 8, 3.0, seed=1)
    sched = ttop.rewire_schedule("er", 8, 3.0, 3, seed=2)
    for kw in (dict(dropout=0.2), dict(graph_schedule=sched), dict(graph_schedule=sched.adjs)):
        jkw = dict(kw)
        if "graph_schedule" in kw:
            jkw["graph_schedule"] = jtop.GraphSchedule(sched.adjs) \
                if isinstance(kw["graph_schedule"], ttop.GraphSchedule) else sched.adjs
        stack, union = Scenario(**kw).resolve(g, 5)
        jstack, junion = JScenario(**jkw).resolve(jtop.Graph(g.adj), 5)
        assert np.array_equal(stack, jstack) and np.array_equal(union.adj, junion.adj)
    m = ClientSystemModel(slow_fraction=0.5, slow_factor=4.0, seed=1)
    assert np.array_equal(m.resolve_speeds(8), JSystem(slow_fraction=0.5, seed=1).resolve_speeds(8))
    with pytest.raises(ValueError, match="shape"):
        ClientSystemModel(speed=[1.0, 0.5]).resolve_speeds(3)
    with pytest.raises(ValueError, match="positive"):
        ClientSystemModel(speed=[1.0, 0.0]).resolve_speeds(2)


def test_dropped_links_charge_zero_and_stale_weights_are_binarized():
    g = ttop.make_graph("er", 6, 3.0, seed=0)
    spec, jspec = GossipSpec.from_graph(g), JSpec.from_graph(jtop.Graph(g.adj))
    s = torch.zeros(6, dtype=torch.int64)

    def both(w):
        t = float(round_comm_bytes(spec, s, 100, adj=apply_client_weights(
            torch.as_tensor(g.adj), torch.as_tensor(w))))
        j = float(j_round_comm_bytes(jspec, jnp.zeros(6, jnp.int32), 100,
                                     adj=j_apply_weights(jnp.asarray(g.adj), jnp.asarray(w))))
        assert t == j
        return t

    full = both(np.ones(6, np.float32))
    assert both(np.array([1.0, 0.5, 0.25, 1.0, 0.9, 0.4], np.float32)) == full
    lost = 2 * float(g.adj[2].sum() - 1)
    assert both(np.array([1, 1, 0, 1, 1, 1], np.float32)) == full - lost * 100
    assert both(np.zeros(6, np.float32)) == 0.0
    # an inactive client's row collapses to e_i; nobody averages it in
    W = fedspd_weight_matrix(spec, s, adj=apply_client_weights(
        torch.as_tensor(g.adj), torch.as_tensor([1.0, 0.9, 0.0, 0.5, 1.0, 0.7]))).numpy()
    np.testing.assert_allclose(W.sum(1), 1.0, atol=1e-6)
    assert np.array_equal(W[2], np.eye(6, dtype=np.float32)[2])
    assert (W[np.arange(6) != 2, 2] == 0).all()


@pytest.mark.parametrize("scan", [False, True])
def test_all_down_run_charges_zero_bytes(setup, scan):
    data, exp, graph = setup
    cfg = dataclasses.replace(CPU, scan_rounds=scan, scenario=Scenario(
        system=ClientSystemModel(p_unavailable=1.0)))
    r = run_method("fedspd", data, exp, graph=graph, cfg=cfg)
    assert r.comm_bytes == 0.0 and r.wire_bytes == 0.0
    assert np.array_equal(r.extras["staleness"], np.full(N, exp.rounds))


def test_always_straggling_clients_never_exchange(setup):
    data, exp, graph = setup
    het = ClientSystemModel(speed=[1, 1, 1, 1, 0.25, 0.25], time_budget=2.0)
    r = run_method("fedspd", data, exp, graph=graph,
                   cfg=dataclasses.replace(CPU, scenario=Scenario(system=het)))
    assert np.array_equal(r.extras["staleness"], [0, 0, 0, 0, exp.rounds, exp.rounds])
    assert np.array_equal(r.extras["u"][4:], np.full_like(r.extras["u"][4:], 0.5))


@pytest.mark.parametrize("method", [m for m in available_methods()
                                    if not m.startswith("fedspd")])
def test_every_baseline_id_is_refused_with_a_dynamic_scenario(setup, method):
    data, exp, graph = setup
    with pytest.raises(ValueError, match="dynamic"):
        run_method(method, data, exp, graph=graph,
                   cfg=dataclasses.replace(CPU, scenario=Scenario(dropout=0.1)))


def test_what_the_runner_refuses(setup):
    data, exp, graph = setup
    with pytest.raises(ValueError, match="telemetry"):
        run_method("fedspd", data, exp, cfg=dataclasses.replace(CPU, telemetry=object()))
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_method_batch("fedspd", data, exp, seeds=(0, 1), graph=[graph, graph],
                         cfg=dataclasses.replace(CPU, scenario=Scenario(dropout=0.1)))
    with pytest.raises(ValueError, match="data_stack"):
        run_method_batch("fedspd", data, exp, seeds=(0, 1), cfg=dataclasses.replace(
            CPU, scenario=Scenario(dropout=0.1, data_stack=True)))
    with pytest.raises(ValueError, match="Scenario"):
        run_method("fedspd", data, exp, cfg=dataclasses.replace(CPU, scenario=JScenario()))
    with pytest.raises(ValueError, match="ClientSystemModel"):
        run_method("fedspd", data, exp, cfg=dataclasses.replace(
            CPU, scenario=Scenario(system=JSystem())))
    with pytest.raises(ValueError, match="7 clients"):
        run_method("fedspd", data, exp, cfg=dataclasses.replace(CPU, scenario=Scenario(
            graph_schedule=ttop.rewire_schedule("er", 7, 3.0, 2))))
    # a static scenario runs the plain path, bit for bit
    plain = run_method("fedspd", data, exp, graph=graph, cfg=CPU)
    static = run_method("fedspd", data, exp, graph=graph,
                        cfg=dataclasses.replace(CPU, scenario=Scenario()))
    assert np.array_equal(plain.acc_per_client, static.acc_per_client)
    assert "staleness" not in static.extras


# --------------------------------------------------------------------------
# the replay against the loop, bit for bit
# --------------------------------------------------------------------------


def _state_tensors(state):
    return [v for v in state if isinstance(v, torch.Tensor)]


def _assert_same_run(a, b):
    assert np.array_equal(a.acc_per_client, b.acc_per_client)
    assert a.curve == b.curve
    assert a.comm_bytes == b.comm_bytes and a.wire_bytes == b.wire_bytes
    assert np.array_equal(a.extras["u"], b.extras["u"])
    assert ("staleness" in a.extras) == ("staleness" in b.extras)
    if "staleness" in a.extras:
        assert np.array_equal(a.extras["staleness"], b.extras["staleness"])
    for x, y in zip(_state_tensors(a.extras["state"]), _state_tensors(b.extras["state"])):
        assert torch.equal(x, y)


SCHEDULE = ttop.rewire_schedule("er", N, 3.0, 3, p_rewire=0.3, seed=2)   # cycles over 4 rounds
ENGINE_CASES = {
    "schedule": dict(scenario=Scenario(graph_schedule=SCHEDULE)),
    "dropout": dict(scenario=Scenario(dropout=0.3, seed=11)),
    "heterogeneity": dict(scenario=Scenario(system=ClientSystemModel(**HET))),
    "heterogeneity-dp": dict(scenario=Scenario(system=ClientSystemModel(**MARKOV)),
                             options=dict(CPU.options, **DP)),
    "heterogeneity-sparse-int8": dict(
        scenario=Scenario(dropout=0.2, system=ClientSystemModel(**MARKOV)),
        sparse=SparseConfig(**SP), comm=CommConfig(codec="int8", error_feedback=True)),
    "composed-cohort-batch": dict(
        scenario=Scenario(graph_schedule=SCHEDULE, dropout=0.2, seed=11,
                          system=ClientSystemModel(**MARKOV)), cohort_size=4),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_replay_equals_the_loop_bit_for_bit(setup, case):
    data, exp, graph = setup
    cfg = dataclasses.replace(CPU, **ENGINE_CASES[case])
    if case.endswith("batch"):
        loop = run_method_batch("fedspd", data, exp, seeds=(0, 1), graph=graph, cfg=cfg)
        scan = run_method_batch("fedspd", data, exp, seeds=(0, 1), graph=graph,
                                cfg=dataclasses.replace(cfg, scan_rounds=True))
        # the streams are shared by the seeds: one staleness for both
        assert np.array_equal(scan[0].extras["staleness"], scan[1].extras["staleness"])
        # seed 1 of the batch is its single run (its own state and cohort stream)
        _assert_same_run(scan[1], run_method("fedspd", data, exp, graph=graph, seed=1,
                                             cfg=cfg))
    else:
        loop = [run_method("fedspd", data, exp, graph=graph, cfg=cfg)]
        scan = [run_method("fedspd", data, exp, graph=graph,
                           cfg=dataclasses.replace(cfg, scan_rounds=True))]
    for a, b in zip(loop, scan):
        _assert_same_run(a, b)
        assert b.extras["n_dispatches"] == ROUNDS
        assert b.extras["n_captures"] == (2 if "sparse" in case else 1)
        assert 0.0 <= b.mean_acc <= 1.0 and b.comm_bytes >= 0.0


def test_dropout_cuts_the_bytes_and_a_static_schedule_is_the_plain_run(setup):
    data, exp, graph = setup
    plain = run_method("fedspd", data, exp, graph=graph, cfg=CPU)
    dropped = run_method("fedspd", data, exp, graph=graph, cfg=dataclasses.replace(
        CPU, scenario=Scenario(dropout=0.5, seed=3)))
    assert dropped.comm_bytes < plain.comm_bytes
    # a one-graph schedule of the base graph is the static run
    same = run_method("fedspd", data, exp, graph=graph, cfg=dataclasses.replace(
        CPU, scenario=Scenario(graph_schedule=graph.adj[None])))
    _assert_same_run(plain, same)


# --------------------------------------------------------------------------
# whole runs against JAX over seeds
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rewire", "system"])
def test_whole_runs_match_jax_within_the_seed_statistical_bound(kind):
    """tests/test_torch_engines.py's batch population (N = 8, 96 points,
    dim 16), 10 rounds, seeds 0-9, with dropout 0.2 and a rewire schedule
    (ER, p_rewire 0.3) or tests/test_heterogeneity.py's Markov model: the
    port's batch against JAX's rolled into one scan."""
    dkw = dict(n_clients=8, n_clusters=2, n_per_client=96, n_classes=4, dim=16)
    ekw = dict(n_clients=8, n_per_client=96, n_classes=4, dim=16, rounds=10, avg_degree=3.0)
    seeds = tuple(range(10))
    if kind == "rewire":
        sched = ttop.rewire_schedule("er", 8, 3.0, 10, p_rewire=0.3, seed=2)
        tsc = Scenario(graph_schedule=sched, dropout=0.2, seed=1)
        jsc = JScenario(graph_schedule=jtop.GraphSchedule(sched.adjs), dropout=0.2, seed=1)
    else:
        tsc = Scenario(dropout=0.2, seed=1, system=ClientSystemModel(**MARKOV))
        jsc = JScenario(dropout=0.2, seed=1, system=JSystem(**MARKOV))
    jres = j_run_method_batch("fedspd", j_data(**dkw), JExp(**ekw), seeds=seeds,
                              cfg=JRunConfig(param_plane=True, eval_every=10**9,
                                             scan_rounds=True, scenario=jsc))
    tres = run_method_batch("fedspd", make_mixture_classification(**dkw),
                            PaperExpConfig(**ekw), seeds=seeds,
                            cfg=RunConfig(device="cpu", eval_every=10**9, scan_rounds=True,
                                          scenario=tsc))
    jacc = np.array([r.mean_acc for r in jres])
    tacc = np.array([r.mean_acc for r in tres])
    tol = max(0.02, float(np.std(jacc)))
    assert abs(jacc.mean() - tacc.mean()) <= tol, (jacc, tacc, tol)
    for r in tres:
        assert np.isfinite(r.mean_acc) and r.acc_per_client.shape == (8,)
        assert r.extras["n_captures"] == 1
    if kind == "system":
        # the slow clients (the same on both sides) never meet the budget
        slow = ClientSystemModel(**MARKOV).resolve_speeds(8) < 1
        assert (tres[0].extras["staleness"][slow] == 10).all()
        assert (jres[0].extras["staleness"][slow] == 10).all()
