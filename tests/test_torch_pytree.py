"""PyTorch port, the per-leaf pytree engine (``RunConfig(param_plane=False)``,
the JAX package's default) against the JAX package, live in one process
(JAX on the CPU, the port with device="cpu"), at the smoke size of
tests/test_param_plane_methods.py (N = 5 clients, 32 points, dim 8, 3
classes, 3 rounds).

- ``utils/pytree.py``: every helper against JAX's on the same nested
  tree (1e-6; sizes, bytes and structure exactly).
- ``gossip_mix_tree``: its plain version (and the wrapper on CPU tensors,
  which launches nothing) against JAX's ``gossip_mix_tree`` in interpret
  mode at the mlp's and the conv's leaf shapes (N = 20, dim 64, 10
  classes) and at 1- and 10-column leaves, within 1e-5.
- One round of the pytree ``step_full`` / ``step_stream`` from a JAX
  pytree state carried over by ``interop``, with JAX's selections, batch
  indices and per-leaf DP noise injected: DP off and on, the dense and
  the permute wiring, cosine alignment; centers within 1e-5, u 1e-6,
  comm bytes exactly. ``seeded_init`` (1e-4), ``final_phase`` (1e-4) and
  ``personalize`` (1e-6) with ``pack_spec=None``.
- One round of each baseline class on the pytree engine with JAX's draws
  (1e-5): FedEM's exchange is kernel 3 a leaf against JAX's einsum.
- The refusals JAX shares: a codec, sparse masks, a cohort and a
  ``Scenario.system`` on the pytree engine.

Whole runs (JAX's default runs, the port's own plane runs, scenarios,
the replay and export) are tests/test_torch_pytree_runs.py's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils.pytree as jpt
from repro.comm.codecs import CommConfig as JCommConfig
from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.core.fedspd import FedSPDConfig as JCfg
from repro.core.fedspd import final_phase as j_final_phase
from repro.core.fedspd import make_round_step as j_make_round_step
from repro.core.fedspd import personalize as j_personalize
from repro.core.fedspd import seeded_init as j_seeded_init
from repro.core.fedspd import select_clusters as j_select
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import make_mix_fn as j_make_mix_fn
from repro.core.sparse import SparseConfig as JSparseConfig
from repro.data.pipeline import sample_cluster_batch_indices
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments import ClientSystemModel as JSystem
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import Scenario as JScenario
from repro.experiments import run_method as j_run_method
from repro.experiments.registry import build_context as j_build_context
from repro.experiments.registry import get_method as j_get_method
from repro.graphs.topology import make_graph as j_graph
from repro.kernels.gossip_mix import gossip_mix_tree as j_gossip_mix_tree
from repro.models.smallnets import make_classifier as j_classifier
from repro_torch.comm.codecs import CommConfig
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core import gossip as tgossip
from repro_torch.core.fedspd import (
    FedSPDConfig,
    final_phase,
    make_round_step,
    personalize,
    seeded_init,
)
from repro_torch.core.gossip import GossipSpec, make_mix_fn
from repro_torch.core.sparse import SparseConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import ClientSystemModel, RunConfig, Scenario, run_method
from repro_torch.experiments.registry import build_context, get_method
from repro_torch.graphs.topology import make_graph
from repro_torch.interop import baseline_state_from_numpy, params_from_numpy, state_from_numpy
from repro_torch.kernels.gossip_mix import (
    KERNELS,
    gossip_mix_flat,
    gossip_mix_fused_dp,
    gossip_mix_tree,
    gossip_mix_tree_ref,
    reset_launch_counts,
)
from repro_torch.models.smallnets import make_classifier
from repro_torch.utils import pytree as tpt

TOL = 1e-5
N, S, DIM, C, M, BATCH, TAU = 5, 2, 8, 3, 32, 8, 2
DP = dict(dp_clip=1.0, dp_noise_multiplier=0.5)
DKW = dict(n_clients=N, n_clusters=S, n_per_client=M, dim=DIM, n_classes=C, seed=0,
           noise=0.3)
EKW = dict(n_clients=N, n_per_client=M, rounds=3, tau=1, batch=BATCH, avg_degree=3.0,
           model="mlp", dim=DIM, n_classes=C)
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


def _assert_trees_close(got, want, atol, what="", rtol=0.0):
    """Same keys at every level and every leaf within ``atol`` (+ ``rtol``
    of the value)."""
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _assert_trees_close(got[k], want[k], atol, f"{what}/{k}", rtol)
        return
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


# --------------------------------------------------------------------------
# utils/pytree.py
# --------------------------------------------------------------------------


def _trees(seed=0):
    """(JAX tree, port tree, second JAX tree, second port tree) of nested
    fp32 leaves with a leading axis of 3, keys out of sorted order."""
    rng = np.random.default_rng(seed)
    shapes = {"z": {"w": (3, 4, 2), "b": (3, 2)}, "a": (3, 5), "m": {"k": (3,)}}

    def draw(sh):
        if isinstance(sh, dict):
            return {k: draw(v) for k, v in sh.items()}
        return rng.standard_normal(sh).astype(np.float32)

    a, b = draw(shapes), draw(shapes)
    j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    return j(a), params_from_numpy(a, device="cpu"), j(b), params_from_numpy(b, device="cpu")


PYTREE_CASES = {
    "tree_map": lambda m, a, b: m.tree_map(lambda x: x * 2.0 + 1.0, a),
    "tree_map_two": lambda m, a, b: m.tree_map(lambda x, y: x * y - x, a, b),
    "tree_zeros_like": lambda m, a, b: m.tree_zeros_like(a),
    "tree_add": lambda m, a, b: m.tree_add(a, b),
    "tree_sub": lambda m, a, b: m.tree_sub(a, b),
    "tree_scale": lambda m, a, b: m.tree_scale(a, 0.37),
    "tree_axpy": lambda m, a, b: m.tree_axpy(0.3, a, b),
    "tree_weighted_sum": lambda m, a, b: m.tree_weighted_sum(
        a, (jnp.asarray if m is jpt else torch.as_tensor)(
            np.array([0.2, 0.5, 0.3], np.float32))),
    "tree_vdot": lambda m, a, b: m.tree_vdot(a, b),
    "tree_sq_norm": lambda m, a, b: m.tree_sq_norm(a),
    "tree_norm": lambda m, a, b: m.tree_norm(a),
    "tree_cosine_similarity": lambda m, a, b: m.tree_cosine_similarity(a, b),
    "tree_ravel": lambda m, a, b: m.tree_ravel(a),
    "tree_stack": lambda m, a, b: m.tree_stack([a, b]),
    "tree_index": lambda m, a, b: m.tree_index(a, 1),
    "tree_dynamic_index": lambda m, a, b: m.tree_dynamic_index(
        a, (jnp.asarray if m is jpt else torch.as_tensor)(2)),
    "tree_dynamic_update": lambda m, a, b: m.tree_dynamic_update(
        a, (jnp.asarray if m is jpt else torch.as_tensor)(1), m.tree_index(b, 0)),
}


@pytest.mark.parametrize("name", list(PYTREE_CASES))
def test_pytree_helpers_match_jax(name):
    """1e-6, and 1e-6 of the value for the reductions (fp32 sums taken in
    another order)."""
    ja, ta, jb, tb = _trees()
    want = PYTREE_CASES[name](jpt, ja, jb)
    got = PYTREE_CASES[name](tpt, ta, tb)
    _assert_trees_close(got, want, 1e-6, name, rtol=1e-6)


def test_pytree_host_helpers_and_cast_match_jax():
    ja, ta, _, _ = _trees()
    assert tpt.tree_size(ta) == jpt.tree_size(ja) == 3 * 8 + 3 * 2 + 15 + 3
    assert tpt.tree_bytes(ta) == jpt.tree_bytes(ja)
    assert tpt.global_shape_summary(ta) == jpt.global_shape_summary(ja)
    # leaf order: sorted keys at every level, as jax.tree.leaves
    order = [leaf.shape for leaf in tpt.tree_leaves(ta)]
    assert order == [tuple(leaf.shape) for leaf in jax.tree.leaves(ja)]
    # a bf16 cast leaves an integer leaf as it is
    ja["n"], ta["n"] = jnp.arange(3, dtype=jnp.int32), torch.arange(3, dtype=torch.int32)
    jc, tc = jpt.tree_cast(ja, jnp.bfloat16), tpt.tree_cast(ta, torch.bfloat16)
    assert tc["n"].dtype == torch.int32 and tc["a"].dtype == torch.bfloat16
    _assert_trees_close(tpt.tree_cast(tc, torch.float32),
                        jax.tree.map(lambda x: np.asarray(x, np.float32), jc), 0.0)
    # the dynamic update leaves its input alone
    before = ta["a"].clone()
    tpt.tree_dynamic_update(ta, torch.as_tensor(0), tpt.tree_index(ta, 1))
    assert torch.equal(ta["a"], before)


# --------------------------------------------------------------------------
# gossip_mix_tree
# --------------------------------------------------------------------------


def _leaf_tree(model, n, seed, dim=64, n_classes=10):
    """A tree of ``(n, ...)`` leaves of the model's shapes, random values."""
    params = jax.tree.map(np.asarray, j_classifier(model, jax.random.PRNGKey(0), dim,
                                                   n_classes)[0])
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda leaf: rng.standard_normal((n,) + leaf.shape)
                        .astype(np.float32), params)


def _w(n, seed):
    rng = np.random.default_rng(seed)
    w = rng.random((n, n)).astype(np.float32)
    return w / w.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("case", ["mlp", "conv", "edges"])
def test_gossip_mix_tree_matches_jax_interpret(case):
    n = 20
    if case == "edges":
        rng = np.random.default_rng(3)
        tree = {"one": rng.standard_normal((n, 1)).astype(np.float32),
                "ten": {"b": rng.standard_normal((n, 10)).astype(np.float32)}}
    else:
        tree = _leaf_tree(case, n, seed=1)
    widths = sorted(int(np.prod(leaf.shape[1:])) for leaf in jax.tree.leaves(tree))
    if case == "mlp":
        assert widths == [10, 64, 128, 640, 8192, 8192]
    if case == "conv":
        assert widths == [10, 50, 80, 500, 1280, 12800]
    w = _w(n, 2)
    want = j_gossip_mix_tree(jnp.asarray(w), jax.tree.map(jnp.asarray, tree), interpret=True)
    ttree = params_from_numpy(tree, device="cpu")
    reset_launch_counts()
    ref = gossip_mix_tree_ref(torch.as_tensor(w), ttree)
    got = gossip_mix_tree(torch.as_tensor(w), ttree)
    assert all(k.launches == 0 for k in KERNELS)
    _assert_trees_close(ref, want, TOL, case)
    for a, b in zip(tpt.tree_leaves(ref), tpt.tree_leaves(got)):
        assert torch.equal(a, b)


def test_gossip_mix_tree_takes_a_non_contiguous_leaf_by_its_values():
    rng = np.random.default_rng(4)
    base = torch.as_tensor(rng.standard_normal((6, 7, 5)).astype(np.float32))
    leaf = base.transpose(1, 2)   # (6, 5, 7), not contiguous
    assert not leaf.is_contiguous()
    w = torch.as_tensor(_w(6, 5))
    got = gossip_mix_tree(w, {"v": leaf})["v"]
    want = gossip_mix_flat(w, leaf.contiguous().reshape(6, -1)).reshape(6, 5, 7)
    assert got.shape == (6, 5, 7) and torch.equal(got, want)


# --------------------------------------------------------------------------
# one round of the pytree steps, injected draws
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    data = j_data(**DKW)
    graph = j_graph("er", N, 3.0, seed=0)
    _, _, j_loss, j_pel, _ = j_classifier("mlp", jax.random.PRNGKey(0), DIM, C)

    def j_init(k):
        return j_classifier("mlp", k, DIM, C)[0]

    _, _, t_loss, t_pel, _ = make_classifier("mlp", torch.Generator(), DIM, C)
    jtrain = {"inputs": jnp.asarray(data.x), "targets": jnp.asarray(data.y)}
    ttrain = {"inputs": torch.as_tensor(data.x), "targets": torch.as_tensor(data.y)}
    jcfg = JCfg(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH)
    j_seed = jax.jit(lambda k: j_seeded_init(k, j_init, jcfg, j_loss, jtrain))
    st0 = j_seed(jax.random.PRNGKey(7))
    rng = np.random.default_rng(1)
    pick = rng.integers(0, M, (N, BATCH))
    rows = np.arange(N)[:, None]
    batch = {"x": data.x[rows, pick], "y": data.y[rows, pick]}
    return dict(data=data, graph=graph, j_loss=j_loss, j_pel=j_pel, j_init=j_init,
                t_loss=t_loss, t_pel=t_pel, jtrain=jtrain, ttrain=ttrain, st0=st0,
                batch=batch, j_seed=j_seed, st1={})


def _st1(world, kw, jdata):
    """The JAX pytree state after one dense round of ``kw``'s regime and
    DP setting (so that u and the centers moved), one compile a setting."""
    key = (kw["regime"], "dp_clip" in kw)
    if key not in world["st1"]:
        spec = JSpec.from_graph(world["graph"])
        step = jax.jit(j_make_round_step(world["j_loss"], world["j_pel"], spec, JCfg(**kw),
                                         mix_fn=j_make_mix_fn(spec, "pallas")))
        world["st1"][key] = step(world["st0"], jdata)[0]
    return world["st1"][key]


def _leaf_noise(k_dp, c_tree):
    """JAX's pytree DP draws: ``split(k_dp, N)`` one key a client, then one
    ``normal`` a leaf from ``split(k_i, L)`` in leaf order. Returns the
    tree of ``(N, ...)`` leaves."""
    leaves, treedef = jax.tree.flatten(c_tree)

    def one(k):
        keys = jax.random.split(k, len(leaves))
        return [jax.random.normal(kk, leaf.shape[1:]) for kk, leaf in zip(keys, leaves)]

    per = jax.vmap(one)(jax.random.split(k_dp, N))
    return jax.tree.unflatten(treedef, [np.asarray(p) for p in per])


def _draws(st, *, stream=False, sigma=0.0):
    """One round's draws, split as the JAX pytree steps split their keys."""
    key, k_sel, k_local = jax.random.split(st.key, 3)
    s = j_select(k_sel, st.u)
    out = {"s": torch.as_tensor(np.array(s))}
    if not stream:
        out["idx"] = torch.as_tensor(np.stack([np.asarray(jax.vmap(
            lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, BATCH)
        )(jax.random.split(k, N), st.z, s)) for k in jax.random.split(k_local, TAU)]))
    if sigma > 0:
        _, k_dp = jax.random.split(key)
        sel = jax.tree.map(lambda leaf: leaf[s, jnp.arange(N)], st.centers)
        out["noise"] = params_from_numpy(_leaf_noise(k_dp, sel), device="cpu")
    return out


def _align_threshold(world, st, kw):
    """A threshold that drops some of the round's same-cluster links and
    lies at least 1e-4 from every cosine between them, read off the
    models the port's round mixes without alignment (the local steps do
    not depend on the threshold)."""
    seen = []

    def spy(c_sel, s, adj=None):
        seen.append((c_sel, s))
        return c_sel

    step = make_round_step(world["t_loss"], world["t_pel"],
                           GossipSpec.from_graph(make_graph("er", N, 3.0, seed=0)),
                           FedSPDConfig(**kw), mix_fn=spy)
    d = _draws(st, sigma=kw.get("dp_clip", 0) * 0.5)
    step(state_from_numpy(jax.tree.map(np.asarray, st), device="cpu"), world["ttrain"], **d)
    c, s = seen[0]
    cos = tgossip._pairwise_cos(c).numpy()
    same = np.triu((world["graph"].adj > 0) & (s.numpy()[:, None] == s.numpy()[None, :]), 1)
    vals = np.sort(cos[same])
    gaps = np.diff(vals)
    i = int(np.argmax(gaps))
    assert gaps[i] >= 2e-4, vals
    return float((vals[i] + vals[i + 1]) / 2)


ROUND_CASES = {
    # case: (mode, port backend, JAX backend, dp, aligned, regime)
    "dense": ("dense", "cuda", "pallas", False, False, "full"),
    "dense-dp": ("dense", "cuda", "pallas", True, False, "full"),
    "permute": ("permute", "reference", "reference", False, False, "full"),
    "permute-dp": ("permute", "reference", "reference", True, False, "full"),
    "aligned-dp": ("dense", "cuda", "pallas", True, True, "full"),
    "stream": ("dense", "cuda", "pallas", False, False, "stream"),
    "stream-dp": ("dense", "cuda", "pallas", True, False, "stream"),
}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_one_pytree_round_matches_jax_with_injected_draws(world, case):
    mode, backend, jbackend, dp, aligned, regime = ROUND_CASES[case]
    kw = dict(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH, regime=regime,
              **(DP if dp else {}))
    stream = regime == "stream"
    jdata = jax.tree.map(jnp.asarray, world["batch"]) if stream else world["jtrain"]
    tdata = ({k: torch.as_tensor(v) for k, v in world["batch"].items()} if stream
             else world["ttrain"])
    st1 = _st1(world, kw, jdata)
    thr = _align_threshold(world, st1, kw) if aligned else -1.0
    jspec = JSpec.from_graph(world["graph"], mode=mode, cos_align_threshold=thr)
    tspec = GossipSpec.from_graph(make_graph("er", N, 3.0, seed=0), mode=mode,
                                  cos_align_threshold=thr)
    jstep = jax.jit(j_make_round_step(world["j_loss"], world["j_pel"], jspec, JCfg(**kw),
                                      mix_fn=j_make_mix_fn(jspec, jbackend)))
    want = jax.tree.map(np.asarray, jstep(st1, jdata)[0])
    draws = _draws(st1, stream=stream, sigma=0.5 if dp else 0.0)
    tstep = make_round_step(world["t_loss"], world["t_pel"], tspec, FedSPDConfig(**kw),
                            mix_fn=make_mix_fn(tspec, backend, plane=False))
    state = state_from_numpy(jax.tree.map(np.asarray, st1), device="cpu")
    centers = state.centers
    reset_launch_counts()
    got, metrics = tstep(state, tdata, **draws)
    assert gossip_mix_fused_dp.launches == 0
    _assert_trees_close(got.centers, want.centers, TOL, case)
    np.testing.assert_allclose(got.u.numpy(), want.u, atol=1e-6, rtol=0)
    assert float(got.comm_bytes) == float(want.comm_bytes)
    assert got.round == int(want.round) == 2
    assert torch.equal(metrics["selected"], draws["s"].long())
    np.testing.assert_allclose(metrics["consensus"].numpy(),
                               np.asarray(jstep(st1, jdata)[1]["consensus"]),
                               atol=1e-5, rtol=1e-4)
    # the scatter wrote the state's own leaves in place
    assert got.centers["layer0"]["w"] is centers["layer0"]["w"]


def test_pytree_seeded_init_final_phase_and_personalize_match_jax(world):
    jcfg = JCfg(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH)
    tcfg = FedSPDConfig(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH)
    key = jax.random.PRNGKey(11)
    want = world["j_seed"](key)
    # seeded_init's draws, split as the JAX function splits them
    k_pick, k_run = jax.random.split(jax.random.fold_in(key, 1))
    seeds = np.array(jax.random.choice(k_pick, N, (S,), replace=False))
    steps = 15 * max(1, M // BATCH)
    inits, tapes = [], []
    for s in range(S):
        k_model, k_scan = jax.random.split(jax.random.fold_in(k_run, s))
        inits.append(jax.tree.map(np.asarray, world["j_init"](k_model)))
        tapes.append([np.asarray(jax.random.randint(k, (BATCH,), 0, M))
                      for k in jax.random.split(k_scan, steps)])
    init_tree = params_from_numpy(jax.tree.map(lambda *ls: np.stack(ls), *inits),
                                  device="cpu")
    got = seeded_init(torch.Generator(), None, tcfg, world["t_loss"], world["ttrain"],
                      seeds=torch.as_tensor(seeds), init_params=init_tree,
                      idx_tape=torch.as_tensor(np.array(tapes)))
    _assert_trees_close(got.centers, want.centers, 1e-4, "seeded_init")
    assert all(leaf.is_contiguous() for leaf in tpt.tree_leaves(got.centers))

    st = jax.tree.map(np.asarray, want._replace(
        u=jnp.asarray(np.random.default_rng(2).dirichlet(np.ones(S), N).astype(np.float32))))
    jst = jax.tree.map(jnp.asarray, st)
    _assert_trees_close(personalize(state_from_numpy(st, device="cpu")),
                        j_personalize(jst), 1e-6, "personalize")
    fsteps = jcfg.tau_final * max(1, M // BATCH)
    tape = np.stack([np.stack([np.asarray(jax.random.randint(ki, (BATCH,), 0, M))
                               for ki in jax.random.split(k, N)])
                     for k in jax.random.split(jst.key, fsteps)])
    got = final_phase(state_from_numpy(st, device="cpu"), world["t_loss"], world["ttrain"],
                      tcfg, idx_tape=torch.as_tensor(tape))
    want = jax.jit(lambda st: j_final_phase(st, world["j_loss"], world["jtrain"], jcfg))(jst)
    _assert_trees_close(got, want, 1e-4, "final_phase")


# --------------------------------------------------------------------------
# one round of each baseline class on the pytree engine
# --------------------------------------------------------------------------


def _uniform_idx(key, steps, n, m, batch):
    """``local_sgd``'s draws: ``split(key, steps)``, then per step one
    ``randint`` a client from ``split(k, n)``. Returns ``(steps, n, batch)``."""
    return np.stack([np.asarray(jax.vmap(lambda kk: jax.random.randint(kk, (batch,), 0, m))(
        jax.random.split(k, n))) for k in jax.random.split(key, steps)])


def _baseline_draws(method, key, exp):
    n, m, b, tau = exp.n_clients, exp.n_per_client, exp.batch, exp.tau
    if method.endswith("fedem"):
        # split(key, S); per cluster split(k, τ); per step split(kk)[0]
        return np.asarray([[np.asarray(jax.random.randint(jax.random.split(kk)[0],
                                                          (n, b), 0, m))
                            for kk in jax.random.split(k, tau)]
                           for k in jax.random.split(key, S)])
    if method.endswith("pfedme"):
        return np.stack([_uniform_idx(kk, 5, n, m, b) for kk in jax.random.split(key, tau)])
    return _uniform_idx(key, tau, n, m, b)


def _fields(state):
    """A state's tensor fields (trees and tensors) by name; a bare tree is
    ``params``."""
    if not isinstance(state, tuple):
        return {"params": state}
    return {f: v for f in state._fields
            if isinstance(v := getattr(state, f), (torch.Tensor, dict, np.ndarray))
            or hasattr(v, "shape")}


@pytest.mark.parametrize("method", ["local", "dfl_fedavg", "dfl_fedem", "dfl_ifca",
                                    "dfl_fedsoft", "dfl_pfedme"])
def test_one_pytree_baseline_round_matches_jax_with_injected_draws(method):
    ekw = dict(EKW, tau=2)
    data, jexp, exp = j_data(**DKW), JExp(**ekw), PaperExpConfig(**ekw)
    jctx = j_build_context(data, jexp, options={"gossip_backend": "pallas"})
    jm = j_get_method(method)
    k_init, k_round = jax.random.split(jax.random.PRNGKey(7))
    jstate = jm.init(jctx, k_init)
    ctx = build_context(make_mixture_classification(**DKW), exp, torch.device("cpu"),
                        options={"param_plane": False})
    m = get_method(method)
    state = baseline_state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    lr = np.float32(0.05 * 0.98 ** 3)
    jnew, _ = jax.jit(jm.make_step(jctx))(jstate, jctx.train, k_round, jnp.float32(lr))
    reset_launch_counts()
    new, _ = m.make_step(ctx)(state, ctx.train, None, float(lr),
                              idx=torch.as_tensor(_baseline_draws(method, k_round, jexp)))
    assert all(k.launches == 0 for k in KERNELS)
    want, got = _fields(jnew), _fields(new)
    assert sorted(got) == sorted(want)
    if "choice" in want:
        assert np.array_equal(got["choice"].numpy(), np.asarray(want["choice"]))
    for k in want:
        _assert_trees_close(got[k], want[k], TOL, k)


# --------------------------------------------------------------------------
# the refusals JAX shares
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    return j_data(**DKW), JExp(**EKW), make_mixture_classification(**DKW), \
        PaperExpConfig(**EKW)



REFUSALS = {
    # case: (port RunConfig fields, JAX RunConfig fields, message)
    "codec": (dict(comm=CommConfig(codec="int8")),
              dict(comm=JCommConfig(codec="int8")), "param_plane"),
    "sparse": (dict(sparse=SparseConfig(density=0.5)),
               dict(sparse=JSparseConfig(density=0.5)), "param_plane"),
    "sparse-dense": (dict(sparse=SparseConfig(density=1.0)),
                     dict(sparse=JSparseConfig(density=1.0)), "param_plane=True"),
    "cohort": (dict(cohort_size=3), dict(cohort_size=3), "param_plane=True"),
    "system": (dict(scenario=Scenario(system=ClientSystemModel())),
               dict(scenario=JScenario(system=JSystem())), "param_plane=True"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_what_jax_refuses_on_the_pytree_engine_is_refused(smoke, case):
    """The port's run raises; so does JAX's. Where JAX's runner reaches
    the refusal only after an eager ``seeded_init`` that costs seconds
    (sparse at density 1.0 in FedSPD's ``_sparse``; a cohort and a
    client-system model in its ``cohort_axes``), that function is called
    on a pytree context instead."""
    jdata, jexp, data, exp = smoke
    tkw, jkw, what = REFUSALS[case]
    with pytest.raises(ValueError, match=what):
        run_method("fedspd", data, exp, cfg=dataclasses.replace(CPU, **tkw))
    jcfg = JRunConfig(param_plane=False, eval_every=10**9, **jkw)
    jctx = j_build_context(jdata, jexp, options=jcfg.resolve_options()) \
        if case in ("sparse-dense", "cohort", "system") else None
    with pytest.raises(ValueError, match=what):
        if case == "sparse-dense":
            j_get_method("fedspd")._sparse(jctx)
        elif jctx is not None:
            j_get_method("fedspd").cohort_axes(jctx, None)
        else:
            j_run_method("fedspd", jdata, jexp, cfg=jcfg)


def test_the_pytree_step_and_mix_refuse_a_codec_and_sparse_masks(world):
    spec = GossipSpec.from_graph(make_graph("er", N, 3.0, seed=0))
    cfg = FedSPDConfig(n_clients=N, n_clusters=S)
    int8 = CommConfig(codec="int8")
    with pytest.raises(ValueError, match="plane=True"):
        make_mix_fn(spec, comm=int8, plane=False)
    with pytest.raises(ValueError, match="pack_spec"):
        make_round_step(world["t_loss"], world["t_pel"], spec, cfg, comm=int8)
    with pytest.raises(ValueError, match="pack_spec"):
        make_round_step(world["t_loss"], world["t_pel"], spec, cfg,
                        sparse=SparseConfig(density=0.5))
    # fp32 is no codec; the pytree mix carries neither kernel 2 nor the sparse products
    mix = make_mix_fn(spec, comm=CommConfig(), plane=False)
    assert not hasattr(mix, "fused_dp") and not hasattr(mix, "sparse_matmul")
