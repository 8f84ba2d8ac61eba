"""PyTorch port, the FedSPD main-path variants against the live JAX package
on the CPU (~2.5 min in one process, most of it three 10-seed JAX
batches' compiles, made least optimized, and their conv runs; the JAX
compiles stay at smoke width):

- ``graphs/coloring`` bit for bit and ``clustering_accuracy`` exactly;
  ``consensus_distance`` within 1e-6 relative;
- ``mix_permute`` against JAX's and against the dense mix within 1e-5
  (tests/test_kernels.py's fp32 bound), a weighted adjacency read as a
  binary mask; the cosine mask of ``fedspd_weight_matrix`` equal to
  JAX's on inputs kept at least 1e-4 from the threshold;
- the conv1d classifier: its ``PackSpec`` and plane equal to JAX's bit for
  bit, the forward and ``flat_grad`` against ``jax.grad`` at 1e-5 on the
  ``(N, B, d)`` and ``(S, N, M, d)`` batchings;
- one full round with every draw injected against JAX's
  ``make_round_step(pack_spec=...)`` (plane 1e-5, u 1e-6, comm_bytes
  exact): the permute wiring on "reference", cosine alignment with DP off
  and on (σ > 0) and with int8; one stream round each (plain, DP, int8 +
  error feedback, sparse d0.2, a per-round adjacency) against JAX's
  ``step_stream_packed``;
- JAX's refusals (sparse with alignment, a cohort on the permute wiring);
  no aligned DP round calls the fused DP kernel, and a DP round without
  alignment calls it once (counted on the wrappers' plain-version calls);
- the replay against the loop bit for bit for the conv model,
  ``fedspd_permute`` and aligned DP; 10-seed runs of ``model="conv"``
  (``fedspd``, ``dfl_fedavg``) and of ``fedspd_permute`` against JAX
  within max(2 pts, the JAX seeds' std); a conv ``export_run`` artifact
  equal to JAX's byte for byte, served by ``ClusterPlaneServer`` with the
  conv forward as the JAX server serves it (1e-5).

The draws are made in JAX the way the JAX step splits its keys and fed to
both packages (the port takes them as overrides)."""
import contextlib
import dataclasses
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.codecs import CommConfig as JComm
from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.core.clustering import clustering_accuracy as j_clustering_accuracy
from repro.core.fedspd import FedSPDConfig as JCfg
from repro.core.fedspd import init_state as j_init_state
from repro.core.fedspd import make_round_step as j_make_round_step
from repro.core.fedspd import seeded_init as j_seeded_init
from repro.core.fedspd import select_clusters as j_select
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import consensus_distance as j_consensus_distance
from repro.core.gossip import fedspd_weight_matrix as j_weights
from repro.core.gossip import make_mix_fn as j_make_mix_fn
from repro.core.gossip import mix_permute as j_mix_permute
from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.core.packing import pack as j_pack
from repro.core.packing import pack_state as j_pack_state
from repro.core.packing import unpack as j_unpack
from repro.core.sparse import SparseConfig as JSparse
from repro.core.sparse import init_masks as j_init_masks
from repro.data.pipeline import sample_cluster_batch_indices
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import run_method_batch as j_run_method_batch
from repro.experiments.export import export_servable as j_export_servable
from repro.graphs import coloring as jcol
from repro.graphs.topology import make_graph as j_graph
from repro.models.smallnets import apply_conv1d_classifier as j_apply_conv1d_classifier
from repro.models.smallnets import make_classifier as j_classifier
from repro.serve import ClusterPlaneServer as JServer
from repro.serve import load_servable as j_load_servable
from repro_torch.comm.codecs import CommConfig, make_channel
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core import gossip as tgossip
from repro_torch.kernels import gossip_mix as tkernels
from repro_torch.core.clustering import clustering_accuracy
from repro_torch.core.fedspd import FedSPDConfig, make_round_step
from repro_torch.core.gossip import (
    GossipSpec,
    consensus_distance,
    fedspd_weight_matrix,
    make_mix_fn,
    mix_dense,
    mix_permute,
)
from repro_torch.core.packing import flat_grad, make_pack_spec, pack, unpack
from repro_torch.core.sparse import SparseConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import RunConfig, export_run, run_method, run_method_batch
from repro_torch.experiments.scenarios import Scenario
from repro_torch.graphs import coloring as tcol
from repro_torch.graphs.topology import make_graph
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.models.smallnets import apply_conv1d_classifier, make_classifier
from repro_torch.serve import ClusterPlaneServer, load_servable

N, S, DIM, C, M, BATCH, TAU = 8, 2, 16, 4, 96, 32, 5
TOL = 1e-5
DP = {"dp_clip": 1.0, "dp_noise_multiplier": 0.5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# host helpers and metrics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n,deg,seed", [("er", 8, 3.0, 0), ("er", 20, 5.0, 3),
                                             ("ba", 16, 4.0, 1), ("ring", 9, 2.0, 0),
                                             ("complete", 6, 5.0, 0)])
def test_coloring_equals_jax_bit_for_bit(kind, n, deg, seed):
    g = make_graph(kind, n, deg, seed=seed)
    jg = j_graph(kind, n, deg, seed=seed)
    assert tcol.greedy_edge_coloring(g) == jcol.greedy_edge_coloring(jg)
    got, want = tcol.permute_schedule(g), jcol.permute_schedule(jg)
    assert len(got) == len(want)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))
    assert tcol.schedule_stats(g) == jcol.schedule_stats(jg)
    assert tcol.validate_coloring(g) and jcol.validate_coloring(jg)
    spec = GossipSpec.from_graph(g, mode="permute")
    assert all(np.array_equal(a, b) for a, b in zip(spec.perms, want))


@pytest.mark.parametrize("s_clusters", [2, 3, 4])
def test_clustering_accuracy_equals_jax(s_clusters):
    rng = np.random.default_rng(s_clusters)
    z_true = rng.integers(0, s_clusters, (N, M))
    z = np.where(rng.random((N, M)) < 0.8, (z_true + 1) % s_clusters,
                 rng.integers(0, s_clusters, (N, M)))
    got = clustering_accuracy(torch.as_tensor(z), torch.as_tensor(z_true), s_clusters)
    want = j_clustering_accuracy(jnp.asarray(z), jnp.asarray(z_true), s_clusters)
    assert got.dtype == torch.float32 and float(got) == float(want)


def test_consensus_distance_equals_jax():
    rng = np.random.default_rng(0)
    plane = rng.normal(size=(N, 300)).astype(np.float32)
    tree = {"b": rng.normal(size=(N, 5)).astype(np.float32),
            "a": {"w": rng.normal(size=(N, 4, 3)).astype(np.float32)}}
    got = float(consensus_distance(torch.as_tensor(plane)))
    assert got == pytest.approx(float(j_consensus_distance(jnp.asarray(plane))), rel=1e-6)
    got = float(consensus_distance(jax.tree.map(torch.as_tensor, tree)))
    assert got == pytest.approx(float(j_consensus_distance(jax.tree.map(jnp.asarray, tree))),
                                rel=1e-6)


# --------------------------------------------------------------------------
# the permute wiring and the cosine mask
# --------------------------------------------------------------------------


def _mix_operands(seed, x=257):
    rng = np.random.default_rng(seed)
    g = make_graph("er", N, 3.0, seed=seed)
    s = rng.integers(0, S, N)
    c = rng.normal(size=(N, x)).astype(np.float32)
    # this round's adjacency: a subgraph of g with weighted entries (a
    # stale sender's decay) and one dropped link
    adj = g.adj * rng.uniform(0.2, 1.0, (N, N)).astype(np.float32)
    adj = np.triu(adj, 1) + np.triu(adj, 1).T + np.eye(N, dtype=np.float32)
    i, j = np.argwhere(np.triu(g.adj, 1) > 0)[0]
    adj[i, j] = adj[j, i] = 0.0
    return g, s, c, adj


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_adj", [False, True])
def test_mix_permute_matches_jax_and_the_dense_mix(seed, with_adj):
    g, s, c, adj = _mix_operands(seed)
    spec, jspec = GossipSpec.from_graph(g, mode="permute"), JSpec.from_graph(
        j_graph("er", N, 3.0, seed=seed), mode="permute")
    a = torch.as_tensor(adj) if with_adj else None
    got = mix_permute(spec, torch.as_tensor(c), torch.as_tensor(s), adj=a)
    want = j_mix_permute(jspec, jnp.asarray(c), jnp.asarray(s),
                         adj=jnp.asarray(adj) if with_adj else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    # the dense mix over the same links (the weighted adjacency read as 0/1)
    binary = torch.as_tensor((adj > 0).astype(np.float32)) if with_adj else None
    dense = mix_dense(spec, torch.as_tensor(c), torch.as_tensor(s), adj=binary)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=TOL, rtol=0)


def test_cosine_mask_equals_jax():
    """Rows whose pairwise cosines all lie at least 1e-4 from the
    threshold: the mask is a comparison, and fp32 Gram sums in two orders
    may differ in the last bits next to it."""
    g, s, c, _ = _mix_operands(4, x=64)
    thr = 0.05
    cos = np.asarray(jax.vmap(lambda a: jax.vmap(
        lambda b: a @ b / jnp.linalg.norm(a) / jnp.linalg.norm(b))(jnp.asarray(c)))(
        jnp.asarray(c)))
    assert np.abs(cos - thr).min() >= 1e-4
    for mode in ("dense", "permute"):
        spec = GossipSpec.from_graph(g, mode=mode, cos_align_threshold=thr)
        jspec = JSpec.from_graph(j_graph("er", N, 3.0, seed=4), mode=mode,
                                 cos_align_threshold=thr)
        w = fedspd_weight_matrix(spec, torch.as_tensor(s), torch.as_tensor(c))
        jw = np.asarray(j_weights(jspec, jnp.asarray(s), jnp.asarray(c)))
        assert np.array_equal(w.numpy() > 0, jw > 0)
        np.testing.assert_allclose(w.numpy(), jw, atol=TOL, rtol=0)
        # the mask drops links: fewer than the selection match alone keeps
        plain = fedspd_weight_matrix(spec, torch.as_tensor(s))
        assert int((w > 0).sum()) < int((plain > 0).sum())
        got = tgossip.mix(spec, torch.as_tensor(c), torch.as_tensor(s))
        np.testing.assert_allclose(got.numpy(), (w @ torch.as_tensor(c)).numpy(),
                                   atol=TOL, rtol=0)


# --------------------------------------------------------------------------
# the conv1d classifier
# --------------------------------------------------------------------------


def _j_conv_init(k):
    return j_classifier("conv", k, DIM, C)[0]


@pytest.fixture(scope="module")
def conv():
    _, j_apply, j_loss, j_pel, _ = j_classifier("conv", jax.random.PRNGKey(0), DIM, C)
    jps = j_make_pack_spec(jax.eval_shape(_j_conv_init, jax.random.PRNGKey(0)))
    _, t_apply, t_loss, t_pel, _ = make_classifier("conv", torch.Generator(), DIM, C)
    tps = make_pack_spec(params_from_numpy(
        jax.tree.map(np.asarray, _j_conv_init(jax.random.PRNGKey(0))), device="cpu"))
    return dict(j_apply=j_apply, j_loss=j_loss, j_pel=j_pel, jps=jps, t_apply=t_apply,
                t_loss=t_loss, t_pel=t_pel, tps=tps)


def test_conv_pack_spec_and_plane_equal_jax(conv):
    jps, tps = conv["jps"], conv["tps"]
    assert (tps.shapes, tps.sizes, tps.offsets, tps.size) == (
        jps.shapes, jps.sizes, jps.offsets, jps.size)
    assert tps.model_bytes == jps.model_bytes and tps.digest == jps.digest
    assert tps.paths == (("conv1",), ("conv2",), ("fc1", "b"), ("fc1", "w"),
                         ("fc2", "b"), ("fc2", "w"))
    params = _j_conv_init(jax.random.PRNGKey(3))
    plane = pack(params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"), tps)
    assert np.array_equal(plane.numpy(), np.asarray(j_pack(params, jps)))
    # the paper-scale width: dim 64, 10 classes
    assert make_pack_spec(make_classifier("conv", torch.Generator(), 64, 10)[0]).size == \
        14720 == j_make_pack_spec(j_classifier("conv", jax.random.PRNGKey(0), 64, 10)[0]).size


def test_conv_forward_and_flat_grad_match_jax(conv):
    jps = conv["jps"]
    keys = jax.random.split(jax.random.PRNGKey(5), S * N)
    jplanes = jnp.stack([j_pack(_j_conv_init(k), jps) for k in keys]).reshape(S, N, -1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, 2 * BATCH, DIM)).astype(np.float32)
    y = rng.integers(0, C, (N, 2 * BATCH))
    tplanes = torch.as_tensor(np.array(jplanes))
    # (S, N, M, d): S×N centers against N clients' points
    want = jax.vmap(lambda ps: jax.vmap(conv["j_apply"])(ps, jnp.asarray(x)))(
        j_unpack(jplanes, jps))
    got = conv["t_apply"](unpack(tplanes, conv["tps"]), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    # (N, B, d): one batch a client, and the gradient of each client's loss
    xb, yb = x[:, :BATCH], y[:, :BATCH]
    want = jax.vmap(jax.grad(lambda f, b: conv["j_loss"](j_unpack(f, jps), b)))(
        jplanes[0], {"x": jnp.asarray(xb), "y": jnp.asarray(yb)})
    got = flat_grad(conv["t_loss"], tplanes[0], {"x": torch.as_tensor(xb),
                                                 "y": torch.as_tensor(yb)}, conv["tps"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# --------------------------------------------------------------------------
# one round with injected draws
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    data = j_data(n_clients=N, n_clusters=S, n_per_client=M, n_classes=C, dim=DIM, seed=0)
    graph = j_graph("er", N, 3.0, seed=0)
    _, _, j_loss, j_pel, _ = j_classifier("mlp", jax.random.PRNGKey(0), DIM, C)

    def j_init(k):
        return j_classifier("mlp", k, DIM, C)[0]

    jps = j_make_pack_spec(jax.eval_shape(j_init, jax.random.PRNGKey(0)))
    _, _, t_loss, t_pel, _ = make_classifier("mlp", torch.Generator(), DIM, C)
    tps = make_pack_spec(params_from_numpy(
        jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0))), device="cpu"))
    jtrain = {"inputs": jnp.asarray(data.x), "targets": jnp.asarray(data.y)}
    ttrain = {"inputs": torch.as_tensor(data.x), "targets": torch.as_tensor(data.y)}
    jcfg = JCfg(n_clients=N, n_clusters=S, batch=BATCH)
    st0 = j_pack_state(jax.jit(lambda k: j_seeded_init(k, j_init, jcfg, j_loss, jtrain))(
        jax.random.PRNGKey(7)), jps)
    rng = np.random.default_rng(1)
    pick = rng.integers(0, M, (N, BATCH))
    rows = np.arange(N)[:, None]
    batch = {"x": data.x[rows, pick], "y": data.y[rows, pick]}
    return dict(data=data, graph=graph, j_loss=j_loss, j_pel=j_pel, j_init=j_init, jps=jps,
                t_loss=t_loss,
                t_pel=t_pel, tps=tps, jtrain=jtrain, ttrain=ttrain, st0=st0, batch=batch)


def _draws(st, x, *, stream=False, comm=None, sigma=0.0):
    """One round's draws, split as the JAX packed steps split their keys."""
    key, k_sel, k_local = jax.random.split(st.key, 3)
    s = j_select(k_sel, st.u)
    out = {"s": s}
    if not stream:
        out["idx"] = jnp.stack([jax.vmap(
            lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, BATCH)
        )(jax.random.split(k, N), st.z, s) for k in jax.random.split(k_local, TAU)])
    if comm is None:
        _, k_dp = jax.random.split(key)
    else:
        _, k_dp, k_comm = jax.random.split(key, 3)
        block = comm.get("block", 256)
        out["comm_u"] = jax.random.uniform(k_comm, (N, -(-x // block), block), jnp.float32)
    if sigma > 0:
        out["noise"] = jax.random.normal(k_dp, (N, x), jnp.float32)
    k_grow, _ = jax.random.split(
        jax.random.fold_in(jax.random.fold_in(st.key, 0x51AB), st.round))
    out["regrow_scores"] = jax.random.uniform(k_grow, (N, x))
    return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}


def _align_threshold(world, st1, kw, comm=None):
    """A threshold that drops some of the round's same-cluster links and
    lies at least 1e-4 from every cosine between them, read off the
    values the port's round mixes (its sanitized rows; with a codec their
    decoded form) without alignment: the local steps do not depend on the
    threshold, and the packages agree on those rows within 1e-5."""
    seen = []

    def spy(c_sel, s, adj=None):
        seen.append((c_sel.clone(), s.clone()))
        return c_sel

    tcfg = FedSPDConfig(**kw)
    step = make_round_step(world["t_loss"], world["t_pel"], GossipSpec.from_graph(
        make_graph("er", N, 3.0, seed=0)), tcfg, pack_spec=world["tps"], mix_fn=spy)
    x = world["jps"].size
    draws = _draws(st1, x, comm=comm, sigma=tcfg.dp_clip * tcfg.dp_noise_multiplier)
    step(state_from_numpy(jax.tree.map(np.asarray, st1), device="cpu"), world["ttrain"],
         **{k: v for k, v in draws.items() if k in ("s", "idx", "noise")})
    c, s = seen[0]
    if comm is not None:
        c, _ = make_channel(CommConfig(**comm), x).roundtrip(c, draws["comm_u"], None)
    cos = tgossip._pairwise_cos(c).numpy()
    same = np.triu((world["graph"].adj > 0) & (s.numpy()[:, None] == s.numpy()[None, :]), 1)
    vals = np.sort(cos[same])
    gaps = np.diff(vals)
    i = int(np.argmax(gaps[: max(1, len(gaps) * 2 // 3)]))
    assert gaps[i] >= 2e-4 and vals[0] < vals[i] < vals[-1], vals
    return float((vals[i] + vals[i + 1]) / 2)


ROUND_CASES = {
    # case: (mode, port backend, JAX backend, comm, dp, aligned)
    "permute-reference": ("permute", "reference", "reference", None, False, False),
    "permute-reference-dp": ("permute", "reference", "reference", None, True, False),
    "aligned": ("dense", "cuda", "pallas", None, False, True),
    "aligned-dp": ("dense", "cuda", "pallas", None, True, True),
    "aligned-int8": ("dense", "cuda", "pallas", dict(codec="int8"), False, True),
    "aligned-permute-reference": ("permute", "reference", "reference", None, False, True),
}


@pytest.fixture(scope="module")
def st1(world):
    """The JAX state entering round 2, from ``init_state``'s independent
    random centers: the clients' rows differ, so their cosines spread
    and a threshold can drop some links with a margin."""
    jcfg = JCfg(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH)
    spec = JSpec.from_graph(world["graph"])
    step = jax.jit(j_make_round_step(world["j_loss"], world["j_pel"], spec, jcfg,
                                     pack_spec=world["jps"],
                                     mix_fn=j_make_mix_fn(spec, "pallas", plane=True)))
    st0 = j_pack_state(j_init_state(jax.random.PRNGKey(9), world["j_init"], jcfg, M),
                       world["jps"])
    return step(st0, world["jtrain"])[0]


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_one_full_round_matches_jax_with_injected_draws(world, st1, case):
    mode, backend, jbackend, comm, dp, aligned = ROUND_CASES[case]
    kw = dict(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH, **(DP if dp else {}))
    thr = _align_threshold(world, st1, kw, comm) if aligned else -1.0
    jspec = JSpec.from_graph(world["graph"], mode=mode, cos_align_threshold=thr)
    tspec = GossipSpec.from_graph(make_graph("er", N, 3.0, seed=0), mode=mode,
                                  cos_align_threshold=thr)
    jcomm = None if comm is None else JComm(**comm)
    tcomm = None if comm is None else CommConfig(**comm)
    jstep = jax.jit(j_make_round_step(
        world["j_loss"], world["j_pel"], jspec, JCfg(**kw), pack_spec=world["jps"],
        mix_fn=j_make_mix_fn(jspec, jbackend, plane=True, comm=jcomm), comm=jcomm))
    want = jax.tree.map(np.asarray, jstep(st1, world["jtrain"])[0])
    draws = _draws(st1, world["jps"].size, comm=comm, sigma=kw.get("dp_clip", 0) * 0.5)
    draws.pop("regrow_scores")
    tstep = make_round_step(world["t_loss"], world["t_pel"], tspec, FedSPDConfig(**kw),
                            pack_spec=world["tps"],
                            mix_fn=make_mix_fn(tspec, backend, comm=tcomm), comm=tcomm)
    got, _ = tstep(state_from_numpy(jax.tree.map(np.asarray, st1), device="cpu"),
                   world["ttrain"], **draws)
    np.testing.assert_allclose(got.centers.numpy(), want.centers, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.u.numpy(), want.u, atol=1e-6, rtol=0)
    assert float(got.comm_bytes) == float(want.comm_bytes)


STREAM_CASES = {
    # case: (comm, dp, sparse, adj)
    "plain": (None, False, False, False),
    "dp": (None, True, False, False),
    "int8-ef": (dict(codec="int8", error_feedback=True), False, False, False),
    "sparse-d0.2": (None, False, True, False),
    "adj": (None, False, False, True),
}
STREAM_SP = dict(density=0.2, prune_rate=0.3, update_every=1)


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_one_stream_round_matches_jax_with_injected_draws(world, case):
    comm, dp, sparse, with_adj = STREAM_CASES[case]
    kw = dict(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH, regime="stream",
              **(DP if dp else {}))
    jspec, tspec = JSpec.from_graph(world["graph"]), GossipSpec.from_graph(
        make_graph("er", N, 3.0, seed=0))
    jcomm = None if comm is None else JComm(**comm)
    tcomm = None if comm is None else CommConfig(**comm)
    jsp = JSparse(**STREAM_SP) if sparse else None
    tsp = SparseConfig(**STREAM_SP) if sparse else None
    jstep = jax.jit(j_make_round_step(
        world["j_loss"], world["j_pel"], jspec, JCfg(**kw), pack_spec=world["jps"],
        mix_fn=j_make_mix_fn(jspec, "pallas", plane=True, comm=jcomm), comm=jcomm,
        sparse=jsp))
    x = world["jps"].size
    st = world["st0"]
    if sparse:
        st = st._replace(mask=j_init_masks(jax.random.PRNGKey(3), N, x, jsp))
    if comm is not None:
        st = st._replace(ef=jnp.zeros((N, x), jnp.float32))
    adj = None
    if with_adj:
        rng = np.random.default_rng(2)
        a = world["graph"].adj * (rng.random((N, N)) > 0.3)
        adj = np.maximum(np.triu(a, 1) + np.triu(a, 1).T, np.eye(N)).astype(np.float32)
    jbatch = jax.tree.map(jnp.asarray, world["batch"])
    st, _ = jstep(st, jbatch)   # round 1, so that u and the planes moved
    draws = _draws(st, x, stream=True, comm=comm, sigma=0.5 if dp else 0.0)
    want = jax.tree.map(np.asarray, jstep(st, jbatch, None if adj is None
                                          else jnp.asarray(adj))[0])
    tstep = make_round_step(world["t_loss"], world["t_pel"], tspec, FedSPDConfig(**kw),
                            pack_spec=world["tps"], comm=tcomm, sparse=tsp)
    tbatch = {k: torch.as_tensor(v) for k, v in world["batch"].items()}
    got, metrics = tstep(state_from_numpy(jax.tree.map(np.asarray, st), device="cpu"),
                         tbatch, None if adj is None else torch.as_tensor(adj), **draws)
    np.testing.assert_allclose(got.centers.numpy(), want.centers, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.u.numpy(), want.u, atol=1e-6, rtol=0)
    assert float(got.comm_bytes) == float(want.comm_bytes)
    assert np.array_equal(got.z.numpy(), np.asarray(st.z))   # z is not used
    assert got.round == int(want.round) == 2
    if comm is not None:
        np.testing.assert_allclose(got.ef.numpy(), want.ef, atol=TOL, rtol=0)
    if sparse:
        assert np.array_equal(got.mask.numpy(), want.mask)
        assert not np.array_equal(want.mask, np.asarray(st.mask))   # RigL ran
    assert torch.equal(metrics["selected"], draws["s"].long())


# --------------------------------------------------------------------------
# refusals and the fused DP kernel
# --------------------------------------------------------------------------


def test_sparse_with_alignment_and_a_permute_cohort_are_refused_as_jax_does(world):
    spec = GossipSpec.from_graph(make_graph("er", N, 3.0, seed=0), cos_align_threshold=0.5)
    jspec = JSpec.from_graph(world["graph"], cos_align_threshold=0.5)
    cfg = dict(n_clients=N, n_clusters=S)
    with pytest.raises(ValueError) as want:
        j_make_round_step(world["j_loss"], world["j_pel"], jspec, JCfg(**cfg),
                          pack_spec=world["jps"], sparse=JSparse(density=0.5))
    with pytest.raises(ValueError) as got:
        make_round_step(world["t_loss"], world["t_pel"], spec, FedSPDConfig(**cfg),
                        pack_spec=world["tps"], sparse=SparseConfig(density=0.5))
    assert str(got.value) == str(want.value)
    data = make_mixture_classification(n_clients=4, n_per_client=16)
    with pytest.raises(ValueError, match="cohort subsampling needs the dense gossip wiring"):
        run_method("fedspd_permute", data, PaperExpConfig(rounds=1),
                   cfg=RunConfig(device="cpu", cohort_size=2))
    with pytest.raises(ValueError, match="unknown gossip mode 'ring'"):
        run_method("fedspd", data, PaperExpConfig(rounds=1),
                   cfg=RunConfig(device="cpu", gossip_mode="ring"))


@pytest.mark.parametrize("aligned", [False, True])
def test_no_aligned_dp_round_calls_the_fused_dp_kernel(monkeypatch, aligned):
    calls = {"gossip_mix_fused_dp": 0, "gossip_mix_flat": 0}
    for name in calls:
        real = getattr(tgossip, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        # the dense mix reaches kernel 1 through gossip_mix_tree, which
        # looks it up in the kernels module: count it there as well
        for module in (tgossip, tkernels):
            monkeypatch.setattr(module, name, counted)
    data = make_mixture_classification(n_clients=6, n_per_client=32, dim=16)
    opts = dict(DP, **({"cos_align_threshold": 0.5} if aligned else {}))
    r = run_method("fedspd", data, PaperExpConfig(rounds=3, n_clients=6, dim=16),
                   cfg=RunConfig(device="cpu", eval_every=10**9, options=opts))
    assert np.isfinite(r.mean_acc)
    assert calls == ({"gossip_mix_fused_dp": 0, "gossip_mix_flat": 3} if aligned
                     else {"gossip_mix_fused_dp": 3, "gossip_mix_flat": 0})


# --------------------------------------------------------------------------
# whole runs: the replay, JAX over seeds, the conv artifact
# --------------------------------------------------------------------------

DKW = dict(n_clients=N, n_clusters=S, n_per_client=M, n_classes=C, dim=DIM)
EKW = dict(n_clients=N, n_per_client=M, n_classes=C, dim=DIM, avg_degree=3.0)


def _same_run(a, b):
    assert np.array_equal(a.acc_per_client, b.acc_per_client)
    assert a.curve == b.curve and a.comm_bytes == b.comm_bytes
    assert np.array_equal(a.extras["u"], b.extras["u"])
    sa, sb = a.extras["state"], b.extras["state"]
    for x, y in zip(sa, sb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["conv", "fedspd_permute", "aligned-dp",
                                  "permute-reference-dropout"])
def test_replay_equals_the_loop_bit_for_bit(case):
    """The last case runs the permute wiring's gathers under link dropout:
    each round's adjacency masks the colouring of the context's graph."""
    method = "fedspd" if case in ("conv", "aligned-dp") else "fedspd_permute"
    exp = PaperExpConfig(rounds=4, model="conv" if case == "conv" else "mlp", **EKW)
    opts = {"keep_state": True}
    if case == "aligned-dp":
        opts.update(DP, cos_align_threshold=0.9)
    cfg = RunConfig(device="cpu", eval_every=2, options=opts)
    if case == "permute-reference-dropout":
        cfg = dataclasses.replace(cfg, gossip_backend="reference",
                                  scenario=Scenario(dropout=0.3, seed=11))
    data = make_mixture_classification(**DKW)
    loop = run_method(method, data, exp, cfg=cfg)
    scan = run_method(method, data, exp, cfg=dataclasses.replace(cfg, scan_rounds=True))
    _same_run(loop, scan)
    assert scan.extras["n_captures"] == 1 and scan.extras["n_dispatches"] == 4


RUN_CASES = {
    # case: (method, model)
    "conv-fedspd": ("fedspd", "conv"),
    "conv-dfl_fedavg": ("dfl_fedavg", "conv"),
    "fedspd_permute": ("fedspd_permute", "mlp"),
}


@contextlib.contextmanager
def _jax_least_optimized():
    """JAX compiles with ``jax_disable_most_optimizations`` inside (LLVM at
    -O0; XLA's HLO passes, and so the fusions, as by default): the 10-seed
    batches compile many small programs (their eager, vmapped inits), and
    LLVM's optimization is most of each compile. The flag is not part of
    JAX's compile cache key, so the caches are cleared on the way out and
    no later test reuses a program compiled here."""
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
        jax.clear_caches()


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_whole_runs_match_jax_within_the_seed_statistical_bound(case):
    """The batch population (N = 8, 96 points, dim 16), 5 rounds (as
    tests/test_torch_sparse.py's runs), seeds 0-9: the port's batch
    (replayed) against JAX's batch on its loop engine (the scan's results;
    its conv scan compiles for 3× as long), compiled least optimized."""
    method, model = RUN_CASES[case]
    seeds = tuple(range(10))
    ekw = dict(EKW, rounds=5, model=model)
    with _jax_least_optimized():
        jres = j_run_method_batch(method, j_data(**DKW), JExp(**ekw), seeds=seeds,
                                  cfg=JRunConfig(param_plane=True, eval_every=10**9))
    tres = run_method_batch(method, make_mixture_classification(**DKW),
                            PaperExpConfig(**ekw), seeds=seeds,
                            cfg=RunConfig(device="cpu", eval_every=10**9, scan_rounds=True))
    jacc = np.array([r.mean_acc for r in jres])
    tacc = np.array([r.mean_acc for r in tres])
    tol = max(0.02, float(np.std(jacc)))
    assert abs(jacc.mean() - tacc.mean()) <= tol, (jacc, tacc, tol)
    for r in tres:
        assert np.isfinite(r.mean_acc) and r.acc_per_client.shape == (N,)
    if method != "fedspd":
        # the static formula (dfl_fedavg) or the tracked bytes, per seed
        assert all(r.comm_bytes > 0 for r in tres)


@pytest.fixture(scope="module")
def conv_run():
    return run_method("fedspd", make_mixture_classification(**DKW),
                      PaperExpConfig(rounds=2, model="conv", **EKW),
                      cfg=RunConfig(device="cpu", eval_every=10**9,
                                    options={"keep_state": True}))


def test_conv_export_run_equals_jax_byte_for_byte(conv_run, tmp_path):
    st = conv_run.extras["state"]
    jps = j_make_pack_spec(_j_conv_init(jax.random.PRNGKey(0)))
    jstate = types.SimpleNamespace(centers=jnp.asarray(st.centers.numpy()),
                                   u=jnp.asarray(st.u.numpy()))
    for codec in ("fp32", "int8"):
        path, jpath = tmp_path / f"t_{codec}.npz", tmp_path / f"j_{codec}.npz"
        man = export_run(conv_run, str(path), arch="conv", codec=codec)
        jm = j_export_servable(jstate, jps, str(jpath), arch="conv", codec=codec)
        assert man.to_json() == jm.to_json()
        assert pathlib.Path(path).read_bytes() == pathlib.Path(jpath).read_bytes()


@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
def test_conv_artifact_serves_as_jax_serves_it(conv_run, tmp_path, codec):
    """The port's conv artifact through ``ClusterPlaneServer.predict``
    with ``apply_conv1d_classifier`` (the plain versions of kernels 4 and 7
    here) against the JAX server on the same file."""
    path = str(tmp_path / f"{codec}.npz")
    export_run(conv_run, path, arch="conv", codec=codec, qblock=64)
    spec = conv_run.extras["pack_spec"]
    srv = ClusterPlaneServer.from_artifact(load_servable(path, spec, device="cpu"), spec,
                                           apply_fn=apply_conv1d_classifier, device="cpu")
    jps = j_make_pack_spec(_j_conv_init(jax.random.PRNGKey(0)))
    jart = j_load_servable(path, jps)
    jsrv = JServer.from_artifact(jart, jps, apply_fn=j_apply_conv1d_classifier)
    rng = np.random.default_rng(3)
    u = rng.dirichlet(np.ones(S), size=16).astype(np.float32)
    x = rng.normal(size=(16, DIM)).astype(np.float32)
    got = srv.predict(u, x)
    want = np.asarray(jsrv.predict(jnp.asarray(u), jnp.asarray(x)))
    assert got.shape == (16, C) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
