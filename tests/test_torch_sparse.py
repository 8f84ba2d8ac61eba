"""PyTorch port, DisPFL sparse training and the compressed exchange on the
packed plane, against the JAX package on the CPU:

- ``core/sparse``: counts, ``init_masks`` from injected scores,
  ``rigl_update`` (tied inputs included), ``maybe_update_mask`` gating and
  ``column_activity`` equal to JAX's exactly;
- kernels 5 and 6's plain versions against the JAX Pallas kernels in
  interpret mode at 1e-5 (tests/test_sparse.py's bound), a dead 128-column
  region giving exact zeros, and a mask narrower than Xp;
- one round of ``make_round_step(sparse=..., comm=...)`` with the draws
  taken from the JAX step's own key splits: plane, ``ef`` and ``u`` at
  1e-5, masks and ``comm_bytes`` equal;
- density 1.0 bit for bit the dense run; exactly ``k_active`` ones per
  mask row after every round; ``wire_bytes`` exact against the JAX
  ``sparse_wire_model_bytes``; whole 5-round runs within max(0.02, the
  JAX seeds' std) of JAX (tests/test_torch_run.py's bound)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.codecs import CommConfig as JComm
from repro.comm.codecs import make_channel as j_make_channel
from repro.comm.codecs import sparse_wire_model_bytes as j_sparse_wire
from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.core.fedspd import FedSPDConfig as JCfg
from repro.core.fedspd import make_round_step as j_make_round_step
from repro.core.fedspd import seeded_init as j_seeded_init
from repro.core.fedspd import select_clusters as j_select
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import make_mix_fn as j_make_mix_fn
from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.core.packing import pack_state as j_pack_state
from repro.core.sparse import SparseConfig as JSparse
from repro.core.sparse import column_activity as j_column_activity
from repro.core.sparse import init_masks as j_init_masks
from repro.core.sparse import maybe_update_mask as j_maybe_update_mask
from repro.core.sparse import rigl_update as j_rigl_update
from repro.data.pipeline import sample_cluster_batch_indices
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import run_method_batch as j_run_method_batch
from repro.graphs.topology import make_graph as j_graph
from repro.kernels.gossip_mix import gossip_mix_dequant_masked as j_mix_dequant_masked
from repro.kernels.gossip_mix import gossip_mix_sparse as j_mix_sparse
from repro.models.smallnets import make_classifier as j_classifier
from repro_torch.comm.codecs import Channel, CommConfig, sparse_wire_model_bytes
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.fedspd import FedSPDConfig, make_round_step
from repro_torch.core.gossip import GossipSpec
from repro_torch.core.packing import make_pack_spec
from repro_torch.core.sparse import (
    SparseConfig,
    column_activity,
    init_masks,
    maybe_update_mask,
    rigl_update,
    top_k,
)
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import RunConfig, run_method
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.kernels.gossip_mix import (
    gossip_mix_dequant_masked,
    gossip_mix_dequant_masked_ref,
    gossip_mix_sparse,
    gossip_mix_sparse_ref,
    reset_launch_counts,
)
from repro_torch.models.smallnets import make_classifier

N, S, DIM, C, M, BATCH, TAU = 8, 2, 16, 4, 96, 32, 5
SP = dict(density=0.25, prune_rate=0.3, update_every=2)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ core/sparse


@pytest.mark.parametrize("density,prune_rate,x", [
    (0.25, 0.3, 10692), (0.2, 0.2, 17226), (0.2, 0.5, 100), (0.9, 0.9, 10),
    (0.01, 0.3, 7), (1.0, 0.2, 50), (0.5, 0.0, 33)])
def test_counts_equal_jax(density, prune_rate, x):
    t, j = SparseConfig(density, prune_rate), JSparse(density, prune_rate)
    assert (t.k_active(x), t.n_prune(x), t.enabled) == (j.k_active(x), j.n_prune(x),
                                                        j.enabled)


@pytest.mark.parametrize("bad", [dict(density=0.0), dict(density=1.5),
                                 dict(prune_rate=1.0), dict(prune_rate=-0.1),
                                 dict(regrow="magnitude"), dict(update_every=0)])
def test_config_validation_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        JSparse(**bad)
    with pytest.raises(ValueError):
        SparseConfig(**bad)


def test_top_k_breaks_ties_to_the_lower_index_as_jax_does():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (6, 50)).astype(np.float32)  # many ties
    scores[0, :] = 1.0                                      # all tied
    scores[1, ::3] = -np.inf
    for k in (1, 7, 50):
        _, want = jax.lax.top_k(jnp.asarray(scores), k)
        assert np.array_equal(top_k(torch.as_tensor(scores), k).numpy(), np.asarray(want))


@pytest.mark.parametrize("density", [0.25, 0.5, 1.0])
def test_init_masks_from_injected_scores_equal_jax(density):
    key, n, x = jax.random.PRNGKey(3), 8, 1001
    want = np.asarray(j_init_masks(key, n, x, JSparse(density=density)))
    scores = torch.as_tensor(np.array(jax.random.uniform(key, (n, x))))
    got = init_masks(scores, n, x, SparseConfig(density=density))
    assert np.array_equal(got.numpy(), want)
    assert (got.sum(dim=1) == SparseConfig(density=density).k_active(x)).all()


@pytest.mark.parametrize("case", ["rigl", "random", "tied"])
def test_rigl_update_equals_jax(case):
    n, x = 6, 400
    cfg = dict(density=0.3, prune_rate=0.4, regrow="random" if case == "random" else "rigl")
    key = jax.random.PRNGKey(5)
    mask = np.asarray(j_init_masks(jax.random.fold_in(key, 1), n, x, JSparse(**cfg)))
    rng = np.random.default_rng(1)
    w = rng.standard_normal((n, x)).astype(np.float32)
    g = rng.standard_normal((n, x)).astype(np.float32)
    if case == "tied":
        # few distinct magnitudes, both signs: prune and regrow both cut
        # through runs of equal scores
        w = rng.integers(-2, 3, (n, x)).astype(np.float32)
        g = rng.integers(-2, 3, (n, x)).astype(np.float32)
    w *= mask
    k_grow = jax.random.fold_in(key, 2)
    want = np.asarray(jax.jit(j_rigl_update, static_argnums=4)(
        jnp.asarray(mask), jnp.asarray(w), jnp.asarray(g), k_grow, JSparse(**cfg)))
    scores = torch.as_tensor(np.array(jax.random.uniform(k_grow, (n, x))))
    got = rigl_update(torch.as_tensor(mask.copy()), torch.as_tensor(w), torch.as_tensor(g),
                      scores, SparseConfig(**cfg))
    assert np.array_equal(got.numpy(), want)
    assert (got.sum(dim=1) == SparseConfig(**cfg).k_active(x)).all()
    assert not np.array_equal(want, mask)


def test_maybe_update_mask_gating_equals_jax():
    n, x, cfg = 4, 40, dict(density=0.3, prune_rate=0.5, update_every=3)
    key = jax.random.PRNGKey(9)
    mask = j_init_masks(key, n, x, JSparse(**cfg))
    rng = np.random.default_rng(2)
    w = rng.standard_normal((n, x)).astype(np.float32) * np.asarray(mask)
    g = rng.standard_normal((n, x)).astype(np.float32)
    j_gated = jax.jit(j_maybe_update_mask, static_argnums=5)
    for rnd in range(8):
        want = np.asarray(j_gated(mask, jnp.asarray(w), jnp.asarray(g), key,
                                  jnp.int32(rnd), JSparse(**cfg)))
        got = maybe_update_mask(torch.as_tensor(np.asarray(mask)), torch.as_tensor(w),
                                torch.as_tensor(g), None, rnd, SparseConfig(**cfg))
        assert np.array_equal(got.numpy(), want), rnd
        assert SparseConfig(**cfg).update_due(rnd) == (rnd in (3, 6))


def test_column_activity_equals_jax():
    rng = np.random.default_rng(3)
    m = (rng.random((2, 5, 300)) < 0.1).astype(np.float32)
    m[:, :, 100:200] = 0.0
    want = np.asarray(j_column_activity(jnp.asarray(m)))
    got = column_activity(torch.as_tensor(m))
    assert np.array_equal(got.numpy(), want) and not want[:, 100:200].any()


# ------------------------------------------------- kernels 5 and 6 (plain)


def _sparse_operands(n, x, density, seed):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    mask = (rng.random((n, x)) < density).astype(np.float32)
    mask[:, 128:256] = 0.0   # one 128-column region dead for every client
    c = rng.standard_normal((n, x)).astype(np.float32) * mask
    return w, mask, c


@pytest.mark.parametrize("n,x", [(8, 10692), (5, 1001), (20, 333), (37, 300)])
def test_sparse_ref_matches_pallas(n, x):
    w, mask, c = _sparse_operands(n, x, 0.3, seed=n + x)
    act = np.asarray(j_column_activity(jnp.asarray(mask)))
    # 128-column slabs: the dead region is one whole slab of the JAX kernel
    want = np.asarray(j_mix_sparse(jnp.asarray(w), jnp.asarray(c), jnp.asarray(act),
                                   x_block=128, interpret=True))
    got = gossip_mix_sparse_ref(torch.as_tensor(w), torch.as_tensor(c),
                                torch.as_tensor(act)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (got[:, 128:256] == 0.0).all() and (want[:, 128:256] == 0.0).all()


# the square W at the edges of the card's routes: the narrow kernel from
# N = 1 to 32 (the main path's exchange at N = 20), one-column past it (N = 33)
@pytest.mark.parametrize("m,n,x,qblock", [(5, 5, 203, 32), (20, 20, 17226, 256),
                                          (3, 6, 640, 64), (1, 1, 64, 64), (32, 32, 999, 3),
                                          (33, 33, 1010, 10)])
def test_dequant_masked_ref_matches_pallas(m, n, x, qblock):
    """The mask is (N, X), narrower than the payload's Xp."""
    w, mask, c = _sparse_operands(n, x, 0.25, seed=m + x)
    w = np.random.default_rng(x).random((m, n)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    ch = j_make_channel(JComm(codec="int8", block=qblock), x)
    enc = ch.encode(jnp.asarray(c), jax.random.PRNGKey(x))
    assert enc["q"].shape[1] > x or x % qblock == 0
    want = np.asarray(j_mix_dequant_masked(jnp.asarray(w), enc["q"], enc["scale"],
                                           jnp.asarray(mask), qblock=qblock,
                                           interpret=True))
    q, sc = torch.as_tensor(np.array(enc["q"])), torch.as_tensor(np.array(enc["scale"]))
    mask = torch.as_tensor(mask)
    got = gossip_mix_dequant_masked_ref(torch.as_tensor(w), q, sc, mask,
                                        column_activity(mask), qblock=qblock).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (got[:, 128:256] == 0.0).all() and (got[:, x:] == 0.0).all()


def test_sparse_wrappers_take_the_plain_version_on_cpu_and_refuse_bad_shapes():
    w, mask, c = (torch.as_tensor(a) for a in _sparse_operands(4, 300, 0.3, seed=0))
    act = column_activity(mask)
    ch = Channel(CommConfig(codec="int8", block=64), 300)
    enc = ch.encode(c, rounding="nearest")
    reset_launch_counts()
    assert torch.equal(gossip_mix_sparse(w, c, act), gossip_mix_sparse_ref(w, c, act))
    q, sc = enc["q"], enc["scale"]
    assert torch.equal(gossip_mix_dequant_masked(w, q, sc, mask, act, qblock=64),
                       gossip_mix_dequant_masked_ref(w, q, sc, mask, act, qblock=64))
    assert gossip_mix_sparse.launches == 0 and gossip_mix_dequant_masked.launches == 0
    with pytest.raises(ValueError, match="column activity"):
        gossip_mix_sparse(w, c, act[:-1])
    with pytest.raises(ValueError, match="column activity"):
        gossip_mix_dequant_masked(w, q, sc, mask, act[:-1], qblock=64)
    with pytest.raises(ValueError, match="mask"):
        gossip_mix_dequant_masked(w, q, sc, mask[:3], act, qblock=64)
    with pytest.raises(ValueError, match="mask"):
        gossip_mix_dequant_masked(w, q, sc, torch.ones(4, q.shape[1] + 1), act, qblock=64)
    with pytest.raises(ValueError, match="tile"):
        gossip_mix_dequant_masked(w, q, sc, mask, act, qblock=32)


# ------------------------------------------------------------- one round


@pytest.fixture(scope="module")
def world():
    data = j_data(n_clients=N, n_clusters=S, n_per_client=M, n_classes=C,
                  dim=DIM, seed=0)
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
    # the JAX run's initial state: seeded init, packed, with its masks
    key, jcfg = jax.random.PRNGKey(7), JCfg(n_clients=N, n_clusters=S, batch=BATCH)
    st0 = j_pack_state(jax.jit(lambda k: j_seeded_init(k, j_init, jcfg, j_loss, jtrain))(key),
                       jps)
    st0 = st0._replace(mask=j_init_masks(jax.random.fold_in(key, 0x3A5C), N, jps.size,
                                         JSparse(**SP)))
    return dict(graph=graph, j_loss=j_loss, j_pel=j_pel, j_init=j_init, jps=jps,
                t_loss=t_loss, t_pel=t_pel, tps=tps, jtrain=jtrain, ttrain=ttrain,
                st0=st0, steps={})


# case: (comm, dp_clip, dp_noise_multiplier, the round tested)
ROUNDS = {
    "sparse-fp32": (None, 0.0, 0.0, 1),
    "sparse-int8-ef": (dict(codec="int8", error_feedback=True), 0.0, 0.0, 1),
    "sparse-dp": (None, 1.0, 0.5, 1),
    "mask-update": (dict(codec="int8", error_feedback=True), 0.0, 0.0, 2),
}


def _draws(st, x, comm, sigma):
    """One round's draws, split as core/fedspd.step_full_packed and its
    sparse_mask_update split them."""
    key, k_sel, k_local = jax.random.split(st.key, 3)
    s = j_select(k_sel, st.u)
    idx = []
    for k in jax.random.split(k_local, TAU):
        idx.append(jax.vmap(
            lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, BATCH)
        )(jax.random.split(k, N), st.z, s))
    if comm is None:
        _, k_dp = jax.random.split(key)
        k_comm = None
    else:
        _, k_dp, k_comm = jax.random.split(key, 3)
    k_grow, k_batch = jax.random.split(
        jax.random.fold_in(jax.random.fold_in(st.key, 0x51AB), st.round))
    rigl_idx = jax.vmap(
        lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, BATCH)
    )(jax.random.split(k_batch, N), st.z, s)
    out = dict(s=s, idx=jnp.stack(idx), rigl_idx=rigl_idx,
               regrow_scores=jax.random.uniform(k_grow, (N, x)))
    if sigma > 0:
        out["noise"] = jax.random.normal(k_dp, (N, x), jnp.float32)
    if comm is not None and comm["codec"] in ("int8", "int4"):
        block = comm.get("block", 256)
        out["comm_u"] = jax.random.uniform(k_comm, (N, -(-x // block), block), jnp.float32)
    return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}


def _steps(world, comm, clip, mult):
    """The JAX step (jitted, kept across cases) and the port's."""
    kw = dict(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH, dp_clip=clip,
              dp_noise_multiplier=mult)
    jcomm = JComm(**comm) if comm is not None else None
    jspec, tspec = JSpec.from_graph(world["graph"]), GossipSpec.from_graph(world["graph"])
    cache_key = (jcomm, clip, mult)
    if cache_key not in world["steps"]:
        world["steps"][cache_key] = jax.jit(j_make_round_step(
            world["j_loss"], world["j_pel"], jspec, JCfg(**kw), pack_spec=world["jps"],
            mix_fn=j_make_mix_fn(jspec, "pallas", plane=True, comm=jcomm), comm=jcomm,
            sparse=JSparse(**SP)))
    tcomm = CommConfig(**comm) if comm is not None else None
    tstep = make_round_step(world["t_loss"], world["t_pel"], tspec, FedSPDConfig(**kw),
                            pack_spec=world["tps"], comm=tcomm, sparse=SparseConfig(**SP))
    return world["steps"][cache_key], tstep


@pytest.mark.parametrize("case", list(ROUNDS))
def test_one_round_matches_jax_with_injected_draws(world, case):
    comm, clip, mult, rnd = ROUNDS[case]
    jstep, tstep = _steps(world, comm, clip, mult)
    st = world["st0"]
    if comm is not None and comm.get("error_feedback"):
        st = st._replace(ef=jnp.zeros((N, world["jps"].size), jnp.float32))
    for _ in range(rnd):
        st, _ = jstep(st, world["jtrain"])
    draws = _draws(st, world["jps"].size, comm, clip * mult)
    want, _ = jstep(st, world["jtrain"])
    want = jax.tree.map(np.asarray, want)
    st = jax.tree.map(np.asarray, st)
    reset_launch_counts()
    got, _ = tstep(state_from_numpy(st, device="cpu"), world["ttrain"], **draws)
    np.testing.assert_allclose(got.centers.numpy(), want.centers, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.u.numpy(), want.u, atol=TOL, rtol=0)
    assert float(got.comm_bytes) == float(want.comm_bytes)
    assert np.array_equal(got.mask.numpy(), want.mask)
    assert (want.ef is None) == (got.ef is None)
    if got.ef is not None:
        np.testing.assert_allclose(got.ef.numpy(), want.ef, atol=TOL, rtol=0)
        assert not got.ef.numpy()[st.mask == 0].any()
    # the mask moved exactly on the update round, and kept its density
    assert (case == "mask-update") == (not np.array_equal(want.mask, st.mask))
    k = SparseConfig(**SP).k_active(world["jps"].size)
    assert (got.mask.sum(dim=1) == k).all()
    # the plane's selected rows stay on the (old) support
    rows = got.centers[draws["s"].long(), torch.arange(N)]
    assert not rows[torch.as_tensor(st.mask) == 0].any()


# ------------------------------------------------------------- whole runs

DATA = dict(n_clients=N, n_clusters=S, n_per_client=M, n_classes=C, dim=DIM)
EXP = dict(n_clients=N, n_per_client=M, n_classes=C, dim=DIM, rounds=5, avg_degree=3.0)


def _run(seed=0, **kw):
    data, exp = make_mixture_classification(**DATA), PaperExpConfig(**EXP)
    return run_method("fedspd", data, exp, seed=seed,
                      cfg=RunConfig(device="cpu", eval_every=10**9,
                                    options={"keep_state": True}, **kw))


@pytest.mark.parametrize("comm", [None, "int8"])
def test_density_one_is_bit_identical_to_the_dense_run(comm):
    kw = {} if comm is None else dict(comm=CommConfig(codec=comm, error_feedback=True))
    dense = _run(**kw)
    full = _run(sparse=SparseConfig(density=1.0, update_every=2), **kw)
    assert np.array_equal(dense.acc_per_client, full.acc_per_client)
    st_d, st_f = dense.extras["state"], full.extras["state"]
    assert torch.equal(st_d.centers, st_f.centers) and torch.equal(st_d.u, st_f.u)
    assert bool((st_f.mask == 1.0).all())
    assert dense.comm_bytes == full.comm_bytes and dense.wire_bytes == full.wire_bytes


@pytest.mark.parametrize("regrow", ["rigl", "random"])
def test_masks_keep_k_active_ones_per_row_after_every_round(regrow):
    sp = SparseConfig(**SP, regrow=regrow)
    data, exp = make_mixture_classification(**DATA), PaperExpConfig(**EXP)
    from repro_torch.experiments.registry import build_context, get_method

    ctx = build_context(data, exp, torch.device("cpu"),
                        options=RunConfig(sparse=sp, device="cpu").resolve_options())
    m = get_method("fedspd")
    state = m.init(ctx, torch.Generator().manual_seed(0))
    step = m.make_step(ctx)
    k, masks = sp.k_active(ctx.pack_spec.size), [state.mask.clone()]
    for _ in range(5):
        state, _ = step(state, ctx.train, None, None)
        assert (state.mask.sum(dim=1) == k).all()
        assert set(state.mask.unique().tolist()) <= {0.0, 1.0}
        masks.append(state.mask.clone())
    moved = [not torch.equal(a, b) for a, b in zip(masks, masks[1:])]
    # the mask moves when round 2 and round 4 end, and only then
    assert moved == [False, False, True, False, True]


@pytest.mark.parametrize("codec", [None, "fp32", "int8", "int4", "topk"])
def test_wire_bytes_exact_against_jax_formula(codec):
    x = 10692
    for k_active in (1, 100, 2673, x):
        for block in (32, 256):
            t = CommConfig(codec=codec, block=block) if codec else None
            j = JComm(codec=codec, block=block) if codec else None
            assert sparse_wire_model_bytes(t, x, k_active) == j_sparse_wire(j, x, k_active)
    r = _run(sparse=SparseConfig(**SP),
             comm=CommConfig(codec=codec) if codec else None)
    k_act = SparseConfig(**SP).k_active(x)
    jc = JComm(codec=codec) if codec else None
    assert r.wire_bytes == r.comm_bytes * (j_sparse_wire(jc, x, k_act) / (4.0 * x))
    assert r.wire_bytes < r.comm_bytes


def test_whole_run_matches_jax_within_the_seed_statistical_bound():
    """Sparse d0.25 with int8 + error feedback, 5 rounds, seeds 0, 1, 2
    (JAX's rounds rolled into one scan: one compile, the loop's results)."""
    seeds = (0, 1, 2)
    jres = j_run_method_batch(
        "fedspd", j_data(**DATA), JExp(**EXP), seeds=seeds,
        cfg=JRunConfig(param_plane=True, eval_every=10**9, sparse=JSparse(**SP),
                       comm=JComm(codec="int8", error_feedback=True), scan_rounds=True))
    tres = [_run(seed=s, sparse=SparseConfig(**SP),
                 comm=CommConfig(codec="int8", error_feedback=True)) for s in seeds]
    jacc = np.array([r.mean_acc for r in jres])
    tacc = np.array([r.mean_acc for r in tres])
    tol = max(0.02, float(np.std(jacc)))
    assert abs(jacc.mean() - tacc.mean()) <= tol, (jacc, tacc, tol)
    for jr, tr in zip(jres, tres):
        assert np.isfinite(tr.mean_acc) and tr.acc_per_client.shape == (N,)
        assert tr.wire_bytes / tr.comm_bytes == pytest.approx(jr.wire_bytes / jr.comm_bytes,
                                                              rel=1e-12)
