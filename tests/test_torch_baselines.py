"""PyTorch port, the paper's baselines against the JAX package, live in one
process (JAX on the CPU, the port with device="cpu").

- ``graphs/mixing.py``: equal arrays (``array_equal``) and equal floats.
- ``gossip_mix_stack_ref`` (kernel 3's plain version) against the JAX
  Pallas kernel in interpret mode, with an ``x_block`` small enough that
  the multi-block path runs, and against ``gossip_avg_stack(backend=
  "reference")``: 1e-5, the tolerance tests/test_kernels.py uses for mixes.
- One round of each baseline id, S = 2 (and S = 3 for the clustered
  methods), from the JAX initial state carried over by ``interop``, with
  the batch indices made in JAX the way the JAX step splits its keys and
  fed to the port: the plane, ``u``, ``y`` at 1e-5 fp32; ``choice``
  equal, or else the JAX loss gap between the two clusters is reported.
  The JAX rounds run the Pallas kernels in interpret mode
  (``gossip_backend="pallas"``); the port's wrappers take their plain
  versions on CPU tensors.
- ``comm_bytes``: exactly equal for all 11 ids.
- Whole runs of ``dfl_fedem`` and ``dfl_pfedme`` over seeds 0, 1, 2: the
  packages draw from different streams, so the seed mean of ``mean_acc``
  must agree within max(0.02, the JAX runs' seed std), the bound of
  tests/test_comm.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.experiments
from repro.baselines.common import gossip_avg_stack as j_gossip_avg_stack
from repro.baselines.common import mixing_matrix as j_mixing_matrix
from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import run_method_batch as j_run_method_batch
from repro.experiments.registry import build_context as j_build_context
from repro.experiments.registry import get_method as j_get_method
from repro.graphs import mixing as j_mixing
from repro.graphs.topology import make_graph as j_graph
from repro.kernels.gossip_mix import gossip_mix_stack as j_stack
from repro_torch.baselines import pfedme
from repro_torch.baselines.common import gossip_avg_comm, mixing_matrix
from repro_torch.comm.codecs import CommConfig, make_channel
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import RunConfig, run_method
from repro_torch.experiments.registry import build_context, get_method
from repro_torch.graphs import mixing
from repro_torch.graphs.topology import make_graph
from repro_torch.interop import baseline_state_from_numpy
from repro_torch.kernels.gossip_mix import (
    KERNELS,
    gossip_mix_dequant_ref,
    gossip_mix_flat,
    gossip_mix_stack,
    gossip_mix_stack_ref,
    reset_launch_counts,
)

TOL = 1e-5
BASELINES = ("local", "dfl_fedavg", "cfl_fedavg", "dfl_fedem", "cfl_fedem",
             "dfl_ifca", "cfl_ifca", "dfl_fedsoft", "cfl_fedsoft",
             "dfl_pfedme", "cfl_pfedme")
SEEDS = (0, 1, 2)


def _small(s: int) -> tuple[dict, dict]:
    """(data kwargs, PaperExpConfig kwargs) at N = 8, S = s, X = 10,692."""
    data = dict(n_clients=8, n_clusters=s, n_per_client=96, n_classes=4, dim=16)
    exp = dict(n_clients=8, n_clusters=s, n_per_client=96, n_classes=4, dim=16,
               avg_degree=3.0)
    return data, exp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# graphs/mixing.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n,deg,seed", [("er", 8, 3.0, 0), ("er", 20, 5.0, 4),
                                             ("ba", 12, 4.0, 1), ("ring", 7, 2.0, 0),
                                             ("complete", 5, 4.0, 0)])
def test_mixing_matrices_bit_identical(kind, n, deg, seed):
    g, jg = make_graph(kind, n, deg, seed=seed), j_graph(kind, n, deg, seed=seed)
    for name in ("metropolis_weights", "uniform_neighbor_weights"):
        a, b = getattr(mixing, name)(g), getattr(j_mixing, name)(jg)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    w = mixing.metropolis_weights(g)
    assert mixing.spectral_gap(w) == j_mixing.spectral_gap(w)
    assert mixing.consensus_rate_p(w) == j_mixing.consensus_rate_p(w)
    probs = np.linspace(0.2, 0.9, n)
    assert (mixing.expected_fedspd_consensus_rate(g, probs, n_rounds=8, seed=seed)
            == j_mixing.expected_fedspd_consensus_rate(jg, probs, n_rounds=8,
                                                       seed=seed))
    for centralized in (False, True):
        assert np.array_equal(mixing_matrix(g, n, centralized),
                              j_mixing_matrix(jg, n, centralized))


# --------------------------------------------------------------------------
# kernel 3's plain version and wrapper
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s,n,x", [(2, 8, 1000), (3, 5, 333), (1, 20, 129),
                                   (2, 37, 257)])
def test_stack_ref_matches_pallas_and_reference(s, n, x):
    rng = np.random.default_rng(s * 100 + n)
    w = rng.random((n, n)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    c = rng.standard_normal((s, n, x)).astype(np.float32)
    got = gossip_mix_stack_ref(torch.as_tensor(w), torch.as_tensor(c)).numpy()
    # x_block 128: several blocks per slab and a ragged last one
    want = j_stack(jnp.asarray(w), jnp.asarray(c), x_block=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)
    want = j_gossip_avg_stack(jnp.asarray(c), jnp.asarray(w), backend="reference")
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0)


def test_stack_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(0)
    w = torch.as_tensor(rng.random((6, 6)).astype(np.float32))
    c = torch.as_tensor(rng.standard_normal((3, 6, 301)).astype(np.float32))
    reset_launch_counts()
    assert torch.equal(gossip_mix_stack(w, c), gossip_mix_stack_ref(w, c))
    mixed, ef = gossip_avg_comm(c, w)
    assert torch.equal(mixed, gossip_mix_stack_ref(w, c)) and ef is None
    assert torch.equal(gossip_avg_comm(c[0], w)[0], torch.einsum("ij,jx->ix", w, c[0]))
    # the exchange behind a codec (refused until the baselines' comm slice)
    # takes the plain versions on the CPU too: the encoded payload's
    # dequant mix on a plane, the decoded stack's mix
    ch = make_channel(CommConfig(codec="int8", block=64), 301)
    u = torch.rand((6, 5, 64), generator=torch.Generator().manual_seed(1))
    enc = ch.encode(c[0], u)
    mixed, _ = gossip_avg_comm(c[0], w, channel=ch, key=u)
    assert torch.equal(mixed, gossip_mix_dequant_ref(w, enc["q"], enc["scale"],
                                                     qblock=64)[:, :301])
    mixed, _ = gossip_avg_comm(c, w, channel=ch, key=u.expand(3, 6, 5, 64))
    assert torch.equal(mixed, gossip_mix_stack_ref(w, ch.roundtrip(c, u.expand(
        3, 6, 5, 64), None)[0].contiguous()))
    assert all(k.launches == 0 for k in KERNELS)
    with pytest.raises(ValueError, match="stack"):
        gossip_mix_stack(w, c[0])
    with pytest.raises(ValueError, match="shape"):
        gossip_mix_stack(w[:5, :5], c)


# --------------------------------------------------------------------------
# one round per baseline, injected draws
# --------------------------------------------------------------------------


def _uniform_idx(key, steps: int, n: int, m: int, batch: int) -> np.ndarray:
    """``local_sgd``'s draws: ``split(key, steps)``, then per step
    ``client_uniform_batches`` (``split(k, n)``, one randint per client).
    Returns ``(steps, n, batch)``."""
    out = []
    for k in jax.random.split(key, steps):
        ks = jax.random.split(k, n)
        out.append(jax.vmap(lambda kk: jax.random.randint(kk, (batch,), 0, m))(ks))
    return np.stack([np.asarray(o) for o in out])


def _fedem_idx(key, s: int, tau: int, n: int, m: int, batch: int) -> np.ndarray:
    """FedEM's M-step draws: ``split(key, S)``, per cluster ``split(k, τ)``,
    per step ``k1, _ = split(kk)`` and ``randint(k1, (n, batch))``.
    Returns ``(S, τ, n, batch)``."""
    out = []
    for k in jax.random.split(key, s):
        out.append([np.asarray(jax.random.randint(jax.random.split(kk)[0],
                                                  (n, batch), 0, m))
                    for kk in jax.random.split(k, tau)])
    return np.asarray(out)


def _draws(method: str, key, s: int, exp: JExp) -> np.ndarray:
    n, m, b, tau = exp.n_clients, exp.n_per_client, exp.batch, exp.tau
    if method.endswith("fedem"):
        return _fedem_idx(key, s, tau, n, m, b)
    if method.endswith("pfedme"):
        # outer split(key, τ), then _inner_solve's split(kk, k_inner) batches
        return np.stack([_uniform_idx(kk, 5, n, m, b)
                         for kk in jax.random.split(key, tau)])
    return _uniform_idx(key, tau, n, m, b)


def _planes(method: str, state) -> dict:
    """The fields a round compares, as numpy: the bare plane (FedAvg,
    Local) or the state's named fields."""
    if not isinstance(state, tuple):
        return {"plane": np.asarray(state)}   # a CPU tensor converts too
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if getattr(state, f) is not None}


def _choice_gap(jm, jctx, state) -> str:
    """The JAX per-client loss gap between the best two clusters."""
    from repro.core.packing import plane_losses

    _, pel = plane_losses(jm._pack_spec(jctx), None, jctx.pel_fn)
    losses = jax.vmap(lambda c: jax.vmap(pel)(c, {"x": jctx.train["inputs"],
                                                  "y": jctx.train["targets"]}))(
        state.centers).mean(axis=-1)
    srt = np.sort(np.asarray(losses), axis=0)
    return f"JAX loss gap per client {srt[1] - srt[0]}"


CASES = [(m, 2) for m in BASELINES] + [("dfl_fedem", 3), ("dfl_ifca", 3),
                                       ("dfl_fedsoft", 3)]


@pytest.mark.parametrize("method,s", CASES)
def test_one_round_matches_jax_with_injected_draws(method, s):
    dkw, ekw = _small(s)
    data, jexp, exp = j_data(**dkw), JExp(**ekw), PaperExpConfig(**ekw)
    jctx = j_build_context(data, jexp, options={"param_plane": True,
                                                "gossip_backend": "pallas"})
    jm = j_get_method(method)
    k_init, k_round, k_eval = jax.random.split(jax.random.PRNGKey(7), 3)
    jstate = jm.init(jctx, k_init)
    ctx = build_context(make_mixture_classification(**dkw), exp, torch.device("cpu"))
    assert np.array_equal(ctx.graph.adj, jctx.graph.adj)
    assert ctx.pack_spec.size == jm._pack_spec(jctx).size
    m = get_method(method)
    state = baseline_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    # the port's own init has the same layout
    own = m.init(ctx, torch.Generator().manual_seed(0))
    assert {k: v.shape for k, v in _planes(method, own).items()} == \
        {k: v.shape for k, v in _planes(method, jstate).items()}

    lr = np.float32(0.05 * 0.98 ** 3)
    idx = torch.as_tensor(_draws(method, k_round, s, jexp))
    jnew, _ = jax.jit(jm.make_step(jctx))(jstate, jctx.train, k_round, jnp.float32(lr))
    reset_launch_counts()
    new, _ = m.make_step(ctx)(state, ctx.train, None, float(lr), idx=idx)
    assert gossip_mix_stack.launches == 0 and gossip_mix_flat.launches == 0

    want = _planes(method, jnew)
    got = _planes(method, new)
    assert sorted(got) == sorted(want)
    if "choice" in want:
        assert np.array_equal(got["choice"], want["choice"]), \
            _choice_gap(jm, jctx, jnew)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)

    # the personalized models' accuracy (pFedMe's draws: the next test)
    if not method.endswith("pfedme"):
        jacc = np.asarray(jm.evaluate(jctx, jnew, k_eval, jctx.test))
        acc = m.evaluate(ctx, new, ctx.test).numpy()
        np.testing.assert_allclose(acc, jacc, atol=1e-6, rtol=0)


def test_pfedme_personalization_matches_jax_with_injected_draws():
    dkw, ekw = _small(2)
    data, jexp, exp = j_data(**dkw), JExp(**ekw), PaperExpConfig(**ekw)
    jctx = j_build_context(data, jexp, options={"param_plane": True})
    jm = j_get_method("dfl_pfedme")
    jstate = jm.init(jctx, jax.random.PRNGKey(3))
    key = jax.random.PRNGKey(11)
    want = jm.personalize(jctx, jstate, key)
    ctx = build_context(make_mixture_classification(**dkw), exp, torch.device("cpu"))
    state = baseline_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    idx = torch.as_tensor(_uniform_idx(key, 10, exp.n_clients, exp.n_per_client,
                                       exp.batch))
    got = pfedme.personalized_params(state, ctx.loss_fn, ctx.train, None,
                                     batch=exp.batch, pack_spec=ctx.pack_spec,
                                     idx=idx)
    for layer in want:
        for leaf in want[layer]:
            np.testing.assert_allclose(got[layer][leaf].numpy(),
                                       np.asarray(want[layer][leaf]),
                                       atol=TOL, rtol=0, err_msg=f"{layer}/{leaf}")


def test_interop_refuses_what_the_port_does_not_hold():
    jctx = j_build_context(j_data(**_small(2)[0]), JExp(**_small(2)[1]),
                           options={"param_plane": True})
    jstate = j_get_method("dfl_fedem").init(jctx, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="ef"):
        baseline_state_from_numpy(jstate._replace(ef=np.zeros(3)), device="cpu")
    with pytest.raises(ValueError, match="packed"):
        baseline_state_from_numpy(jstate._replace(centers=np.zeros((2, 3))),
                                  device="cpu")
    with pytest.raises(ValueError, match=r"\(N, X\)"):
        baseline_state_from_numpy(np.zeros((2, 3, 4)), device="cpu")


# --------------------------------------------------------------------------
# comm accounting and whole runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", BASELINES)
def test_comm_bytes_exactly_equal(method):
    dkw, ekw = _small(2)
    ekw["rounds"] = 2
    data, jexp, exp = j_data(**dkw), JExp(**ekw), PaperExpConfig(**ekw)
    jctx = j_build_context(data, jexp, options={"param_plane": True})
    # the JAX driver's _result: static per-round bytes × rounds
    want = j_get_method(method).comm_model(jctx).per_round_bytes * jexp.rounds
    r = run_method(method, make_mixture_classification(**dkw), exp,
                   cfg=RunConfig(device="cpu", eval_every=10**9))
    assert r.comm_bytes == want and r.wire_bytes == want
    assert np.isfinite(r.mean_acc) and 0.0 <= r.mean_acc <= 1.0
    assert len(r.extras["round_ms"]) == exp.rounds


@pytest.mark.parametrize("method", ["dfl_fedem", "dfl_pfedme"])
def test_whole_run_matches_jax_within_the_seed_statistical_bound(method):
    dkw, ekw = _small(2)
    ekw["rounds"] = 10
    jres = j_run_method_batch(method, j_data(**dkw), JExp(**ekw), seeds=SEEDS,
                              cfg=JRunConfig(param_plane=True, eval_every=10**9))
    data, exp = make_mixture_classification(**dkw), PaperExpConfig(**ekw)
    # run_method_batch builds one graph, from the first seed, for every seed
    graph = make_graph(exp.graph_kind, exp.n_clients, exp.avg_degree, seed=SEEDS[0])
    runs = [run_method(method, data, exp, graph=graph, seed=s,
                       cfg=RunConfig(device="cpu", eval_every=10**9))
            for s in SEEDS]
    jacc = np.array([r.mean_acc for r in jres])
    tacc = np.array([r.mean_acc for r in runs])
    tol = max(0.02, float(np.std(jacc)))
    assert abs(jacc.mean() - tacc.mean()) <= tol, (jacc, tacc, tol)
    for r, jr in zip(runs, jres):
        assert r.comm_bytes == jr.comm_bytes
        assert r.acc_per_client.shape == (8,)


def test_evaluation_does_not_move_the_training_trajectory():
    """pFedMe's personalization draws batches at every evaluation, from a
    copy of the run's stream: evaluating every round leaves the result of
    a run that evaluates only at its end unchanged."""
    dkw, ekw = _small(2)
    ekw["rounds"] = 3
    data, exp = make_mixture_classification(**dkw), PaperExpConfig(**ekw)
    runs = [run_method("dfl_pfedme", data, exp,
                       cfg=RunConfig(device="cpu", eval_every=e)) for e in (1, 10**9)]
    assert [rd for rd, _ in runs[0].curve] == [0, 1, 2]
    assert np.array_equal(runs[0].acc_per_client, runs[1].acc_per_client)


def test_every_baseline_id_is_registered_and_fedspd_permute_is_refused():
    """Every id of the JAX registry: ``fedspd_permute``, refused until its
    slice, is registered now, on the permute wiring."""
    assert set(BASELINES) | {"fedspd", "fedspd_permute"} == set(
        repro_torch.experiments.available_methods())
    assert callable(repro_torch.experiments.run_method_batch)
    assert get_method("fedspd_permute").mode == "permute"
    assert get_method("fedspd").mode == "dense"
