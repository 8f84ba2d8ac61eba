"""The port's train launcher slice against the live JAX package on the CPU
(smoke configs; JAX compiled least optimized, caches cleared after):

- ``data/synthetic.make_mixture_tokens`` bit for bit;
- the LM bundles on FedSPD's client axes: ``per_example_loss`` on ``(N,)``
  and ``(S, N)`` model axes against ``jax.vmap`` of JAX's ``attn_mode="ref"``
  bundle (2e-5, the LM tests' fp32 bound), and ``flat_grad`` of the
  stream regime's masked loss against ``jax.vmap(jax.grad)`` (atol 2e-5
  plus 1e-4 of the value: two fp32 layers, backward sums in other
  orders) for olmo-1b, gemma3-1b (per-layer windows), mamba2-370m,
  zamba2-1.2b and olmoe-1b-7b (each client's tokens routed with its own
  capacity), params carried across as numpy;
- one stream round of ``launch/steps.make_fedspd_train_step`` against
  JAX's with JAX's draws injected (fp32, int8 + error feedback, sparse
  d0.2, the pytree engine, the heterogeneity wrapper): plane 1e-5, u
  1e-6, comm bytes exact;
- ``arch_for_shape`` / ``supports_shape`` equal to JAX's for every arch
  and input shape; one ``make_plain_train_step`` AdamW step against
  JAX's;
- ``launch/train.main`` with ``--device cpu --smoke``: its JSONL log read
  by JAX's ``read_events`` and rendered by JAX's ``summary_table``, the
  ``--save`` manifest equal to the one JAX's launcher writes, the int8
  artifact answered by the port's ``launch/serve``, ``fl_perplexity``
  equal to JAX's on the same personalized params, injected draws, and
  the refusals by name.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.comm.codecs import CommConfig as JComm
from repro.configs import base as jbase
from repro.core.fedspd import FedSPDConfig as JCfg
from repro.core.fedspd import FedSPDState as JState
from repro.core.fedspd import init_state as j_init_state
from repro.core.fedspd import select_clusters as j_select
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import make_mix_fn as j_make_mix_fn
from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.core.packing import pack as j_pack
from repro.core.packing import pack_state as j_pack_state
from repro.core.sparse import SparseConfig as JSparse
from repro.core.sparse import init_masks as j_init_masks
from repro.data.synthetic import make_mixture_tokens as j_tokens
from repro.experiments.heterogeneity import apply_client_weights as j_apply_weights
from repro.experiments.heterogeneity import restore_inactive as j_restore
from repro.graphs.topology import make_graph as j_graph
from repro.launch import steps as jsteps
from repro.launch.train import fl_perplexity as j_fl_perplexity
from repro.models import registry as jregistry
from repro.optim.sgd import make_optimizer as j_make_optimizer
from repro.telemetry import read_events as j_read_events
from repro.telemetry import summary_table as j_summary_table
from repro_torch.comm.codecs import CommConfig
from repro_torch.configs import base as tbase
from repro_torch.core.fedspd import FedSPDConfig, FedSPDState
from repro_torch.core.gossip import GossipSpec, round_comm_bytes
from repro_torch.core.packing import flat_grad, make_pack_spec, pack
from repro_torch.core.sparse import SparseConfig
from repro_torch.data.synthetic import make_mixture_tokens
from repro_torch.experiments.heterogeneity import masked_client_step
from repro_torch.graphs.topology import make_graph
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch import train as ttrain
from repro_torch.models import registry as tregistry
from repro_torch.utils.pytree import tree_leaves

N, S, B, L = 4, 2, 2, 16
TOL = 1e-5
ARCHS = ("olmo-1b", "gemma3-1b", "mamba2-370m", "zamba2-1.2b", "olmoe-1b-7b")
ROUND_ARCH = "gemma3-1b"   # the smallest smoke plane (X = 279,168)


@contextlib.contextmanager
def _jax_least_optimized():
    """JAX compiles with ``jax_disable_most_optimizations`` (LLVM at -O0):
    the compiles are most of this file's time. The flag is not part of
    JAX's compile cache key, so the caches are cleared on the way out."""
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
        jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def least_optimized():
    with _jax_least_optimized():
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the test workers share the host's
    cores, and torch's default thread count in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _models(arch, lead, seed=1):
    """(JAX bundle, port bundle, JAX params with ``lead`` model axes)."""
    jc = jbase.get_smoke_config(arch)
    jb = jregistry.build_model(jc, attn_mode="ref")
    keys = jax.random.split(jax.random.PRNGKey(seed), int(np.prod(lead)))
    params = jax.vmap(jb.init)(keys)
    params = jax.tree.map(lambda a: a.reshape(lead + a.shape[1:]), params)
    tb = tregistry.build_model(tbase.get_smoke_config(arch), train=True)
    return jb, tb, params


def test_make_mixture_tokens_matches_jax():
    kw = dict(n_clients=3, n_clusters=2, docs_per_client=8, seq_len=12, vocab=32, seed=5)
    got, want = make_mixture_tokens(**kw), j_tokens(**kw)
    assert got.keys() == want.keys()
    for k in ("tokens", "z_true", "mix_true"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grad_on_client_axes_match_jax_vmap(arch):
    jb, tb, jp = _models(arch, (S, N))
    toks = _tokens((N, B, L))
    batch = {"tokens": jnp.asarray(toks)}
    tp = params_from_numpy(_np(jp), device="cpu")
    # (S, N): the clustering forward, tokens broadcast over S
    want = jax.jit(jax.vmap(lambda c: jax.vmap(jb.per_example_loss)(c, batch)))(jp)
    got = tb.per_example_loss(tp, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (S, N, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    # (N,): the local steps, the stream regime's masked loss and its gradient
    jp1 = jax.tree.map(lambda a: a[1], jp)
    tp1 = params_from_numpy(_np(jp1), device="cpu")
    np.testing.assert_allclose(
        tb.per_example_loss(tp1, {"tokens": torch.as_tensor(toks)}).numpy(),
        np.asarray(jax.jit(jax.vmap(jb.per_example_loss))(jp1, batch)), atol=2e-5, rtol=0)
    mask = (np.random.default_rng(2).random((N, B)) > 0.3).astype(np.float32)

    def j_masked(p, b, m):
        return jnp.sum(jb.per_example_loss(p, b) * m) / jnp.maximum(jnp.sum(m), 1.0)

    jg = jax.jit(jax.vmap(jax.grad(j_masked)))(jp1, {"tokens": batch["tokens"]},
                                                 jnp.asarray(mask))
    jspec = j_make_pack_spec(jax.eval_shape(jb.init, jax.random.PRNGKey(0)))
    want_g = np.asarray(j_pack(jg, jspec))
    tspec = make_pack_spec(tb.init(None))

    def t_masked(p, b):
        pel = tb.per_example_loss(p, b)
        return (pel * b["mask"]).sum(-1) / b["mask"].sum(-1).clamp_min(1.0)

    got_g = flat_grad(t_masked, pack(tp1, tspec), {"tokens": torch.as_tensor(toks),
                                                   "mask": torch.as_tensor(mask)}, tspec)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def world():
    jc = jbase.get_smoke_config(ROUND_ARCH)
    jb = jregistry.build_model(jc, attn_mode="ref")
    tb = tregistry.build_model(tbase.get_smoke_config(ROUND_ARCH), train=True)
    jps = j_make_pack_spec(jax.eval_shape(jb.init, jax.random.PRNGKey(0)))
    tps = make_pack_spec(tb.init(None))
    graph = j_graph("er", N, 2.0, seed=0)
    tgraph = make_graph("er", N, 2.0, seed=0)
    assert np.array_equal(graph.adj, tgraph.adj)
    jcfg = JCfg(n_clients=N, n_clusters=S, tau=2, batch=B, regime="stream")
    st0 = j_init_state(jax.random.PRNGKey(3), jb.init, jcfg, data_m=1)
    return dict(jb=jb, tb=tb, jps=jps, tps=tps, graph=graph, tgraph=tgraph, st0=st0,
                tokens=_tokens((N, B, L), seed=4))


def _stream_draws(st, x, comm=None):
    """The selections (and the codec's uniforms and RigL's scores), split as
    JAX's stream steps split their keys."""
    key, k_sel, _ = jax.random.split(st.key, 3)
    out = {"s": j_select(k_sel, st.u)}
    if comm is not None:
        _, _, k_comm = jax.random.split(key, 3)
        block = comm.get("block", 256)
        out["comm_u"] = jax.random.uniform(k_comm, (N, -(-x // block), block), jnp.float32)
    k_grow, _ = jax.random.split(
        jax.random.fold_in(jax.random.fold_in(st.key, 0x51AB), st.round))
    out["regrow_scores"] = jax.random.uniform(k_grow, (N, x))
    return {k: torch.as_tensor(np.array(v)) for k, v in out.items()}


ROUND_CASES = {
    # case: (comm, sparse, pytree, het weights)
    "fp32": (None, False, False, None),
    "int8-ef": (dict(codec="int8", error_feedback=True), False, False, None),
    "sparse-d0.2": (None, True, False, None),
    "pytree": (None, False, True, None),
    "het": (None, False, False, (1.0, 0.0, 0.5, 1.0)),
}
ROUND_SP = dict(density=0.2, prune_rate=0.3, update_every=1)


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_one_train_step_round_matches_jax_with_injected_draws(world, case):
    comm, sparse, pytree, het = ROUND_CASES[case]
    jb, tb, jps, tps = world["jb"], world["tb"], world["jps"], world["tps"]
    kw = dict(n_clients=N, n_clusters=S, tau=2, batch=B, regime="stream")
    jspec, tspec = JSpec.from_graph(world["graph"]), GossipSpec.from_graph(world["tgraph"])
    jcomm = None if comm is None else JComm(**comm)
    tcomm = None if comm is None else CommConfig(**comm)
    jsp = JSparse(**ROUND_SP) if sparse else None
    tsp = SparseConfig(**ROUND_SP) if sparse else None
    jstep = jax.jit(jsteps.make_fedspd_train_step(
        jb, jspec, JCfg(**kw), mix_fn=j_make_mix_fn(jspec, "reference", plane=not pytree,
                                                    comm=jcomm),
        pack_spec=None if pytree else jps, comm=jcomm, sparse=jsp))
    x = jps.size
    st = world["st0"] if pytree else j_pack_state(world["st0"], jps)
    if sparse:
        st = st._replace(mask=j_init_masks(jax.random.PRNGKey(5), N, x, jsp))
    if comm is not None:
        st = st._replace(ef=jnp.zeros((N, x), jnp.float32))
    jbatch = {"tokens": jnp.asarray(world["tokens"])}
    st, _ = jstep(st, jbatch)   # round 1, so that u and the plane moved
    draws = _stream_draws(st, x, comm)
    tstep = tsteps.make_fedspd_train_step(tb, tspec, FedSPDConfig(**kw),
                                          pack_spec=None if pytree else tps, comm=tcomm,
                                          sparse=tsp)
    tstate = state_from_numpy(_np(st), device="cpu")
    tbatch = {"tokens": torch.as_tensor(world["tokens"])}
    if het is None:
        want = _np(jstep(st, jbatch)[0])
        got, _ = tstep(tstate, tbatch, **draws)
    else:
        aw = np.asarray(het, np.float32)
        adj = np.asarray(world["graph"].adj, np.float32)
        new, _ = jstep(st, jbatch, j_apply_weights(jnp.asarray(adj), jnp.asarray(aw)))
        axes = JState(centers=1, u=0, z=0, round=None, key=None, comm_bytes=None)
        want = _np(j_restore(st, new, axes, jnp.asarray(aw) > 0.0))
        taxes = FedSPDState(centers=1, u=0, z=0, round=None, gen=None, comm_bytes=None)
        steph = masked_client_step(
            lambda s_, b_, _g, _lr, a_: tstep(s_, b_, a_, s=draws["s"]), taxes)
        got, _ = steph(tstate, tbatch, None, None, torch.as_tensor(adj), torch.as_tensor(aw))
        # inactive clients' rows of every cluster carried bit for bit
        for i in np.flatnonzero(aw == 0):
            assert np.array_equal(got.centers[:, i].numpy(), np.asarray(st.centers)[:, i])
    if pytree:
        for g_, w_ in zip(tree_leaves(got.centers), jax.tree.leaves(want.centers)):
            np.testing.assert_allclose(g_.numpy(), w_, atol=TOL, rtol=0)
    elif comm is None:
        np.testing.assert_allclose(got.centers.numpy(), want.centers, atol=TOL, rtol=0)
    else:
        _close_but_rounding_flips(got.centers.numpy(), want.centers, np.asarray(st.centers))
        _close_but_rounding_flips(got.ef.numpy(), want.ef, np.asarray(st.centers))
    np.testing.assert_allclose(got.u.numpy(), want.u, atol=1e-6, rtol=0)
    assert float(got.comm_bytes) == float(want.comm_bytes)
    if sparse:
        assert np.array_equal(got.mask.numpy(), want.mask)


def _close_but_rounding_flips(got, want, plane):
    """Within 1e-5 but where the int8 codec's stochastic rounding fell one
    quantum apart (a value the two frameworks compute 1e-7 apart, on the
    other side of its uniform draw): such coordinates must be a few in a
    million, and each off by at most one quantum (two, in a received
    mean) at the plane's largest scale, max |c| / 127."""
    d = np.abs(got - want)
    flips = d > TOL
    assert flips.sum() <= max(4, flips.size // 200_000), flips.sum()
    assert d.max() <= 2 * np.abs(plane).max() / 127


def test_arch_for_shape_and_supports_shape_match_jax():
    assert sorted(tbase.INPUT_SHAPES) == sorted(jbase.INPUT_SHAPES)
    for arch in sorted(jbase.ARCH_ALIASES):
        for shape in jbase.INPUT_SHAPES:
            tcfg, tnote = tsteps.arch_for_shape(tbase.get_config(arch), shape)
            jcfg, jnote = jsteps.arch_for_shape(jbase.get_config(arch), shape)
            assert tnote == jnote and dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
            assert (tsteps.supports_shape(tbase.get_config(arch), shape)
                    == jsteps.supports_shape(jbase.get_config(arch), shape))


def test_plain_train_step_adamw_matches_jax():
    jb, tb, jp = _models("olmo-1b", (1,))
    jp = jax.tree.map(lambda a: a[0], jp)
    toks = _tokens((B, L), seed=6)
    lr = 3e-4
    jstep = jsteps.make_plain_train_step(jb, "adamw", lr=lr)
    jp2, jopt, jloss = jax.jit(jstep)(jp, j_make_optimizer("adamw").init(jp),
                                      {"tokens": jnp.asarray(toks)})
    tstep = tsteps.make_plain_train_step(tb, "adamw", lr=lr)
    tp = params_from_numpy(_np(jp), device="cpu")
    tp2, opt_state, tloss = tstep(tp, tstep.init(tp), {"tokens": torch.as_tensor(toks)})
    assert abs(float(tloss) - float(jloss)) <= 2e-5
    spec = make_pack_spec(tb.init(None))
    jspec = j_make_pack_spec(jax.eval_shape(jb.init, jax.random.PRNGKey(0)))
    states = _adam_states(opt_state)
    assert all(int(s.count) == 1 for s in states)
    # the first moment is 0.1·g: the gradients at the LM tests' bound
    mu = torch.cat([s.mu.flatten() for s in _in_spec_order(opt_state, spec)]).numpy()
    j_mu = np.asarray(j_pack(jopt.mu, jspec))
    np.testing.assert_allclose(mu, j_mu, atol=2e-6, rtol=1e-4)
    # the step is lr·g/(|g| + 1e-8): exact to 1e-6 where |g| >= 1e-5, and
    # at most lr anywhere (where |g| is near eps its ratio is ill-posed)
    got, want = pack(tp2, spec).numpy(), np.asarray(j_pack(jp2, jspec))
    firm = np.abs(j_mu) >= 1e-6
    np.testing.assert_allclose(got[firm], want[firm], atol=1e-6, rtol=0)
    assert np.abs(got - want).max() <= lr


def _adam_states(state) -> list:
    """The AdamState of every leaf of the port's per-leaf optimizer state."""
    if isinstance(state, dict):
        return [s for v in state.values() for s in _adam_states(v)]
    return [state]


def _in_spec_order(state, spec) -> list:
    """The per-leaf states in the pack spec's leaf order."""
    out = []
    for path in spec.paths:
        node = state
        for k in path:
            node = node[k]
        out.append(node)
    return out


MAIN = ["--arch", "mamba2-370m", "--smoke", "--rounds", "3", "--clients", str(N),
        "--batch", "2", "--seq", "16", "--device", "cpu", "--eval-every", "100"]


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    files = {k: str(tmp / n) for k, n in (("log", "t.jsonl"), ("ckpt", "c.npz"),
                                          ("art", "a.npz"))}
    res = ttrain.main(MAIN + ["--telemetry-out", files["log"], "--save", files["ckpt"],
                              "--export-servable", files["art"], "--export-codec", "int8"])
    return res, files


def test_main_jsonl_is_read_and_rendered_by_jax(main_run):
    res, files = main_run
    events = j_read_events(files["log"])
    assert [e["event"] for e in events] == ["run_meta"] + ["round"] * 3 + ["summary"]
    assert events[0]["arch"] == "mamba2-370m" and events[0]["codec"] == "fp32"
    assert events[-1]["final_loss"] == res["final_loss"]
    table = j_summary_table(events)
    assert "| consensus |" in table and "| lr |" in table


def test_main_save_manifest_is_jax_launchers(main_run):
    res, files = main_run
    jc = jbase.get_smoke_config("mamba2-370m")
    jspec = j_make_pack_spec(jax.eval_shape(jregistry.build_model(jc).init,
                                            jax.random.PRNGKey(0)))
    want = jckpt.CkptManifest(kind="checkpoint", arch=jc.name, n_clients=N, n_clusters=S,
                              pack_digest=jspec.digest)
    assert jckpt.read_manifest(files["ckpt"]) == want
    # JAX's reader restores the port's arrays under JAX's key paths
    like = {"personalized": jax.tree.map(lambda t: t.detach().numpy(), res["personalized"]),
            "u": res["state"].u.numpy()}
    tree, _ = jckpt.restore(files["ckpt"], like)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(like)):
        assert np.array_equal(np.asarray(a), b)


def test_main_artifact_is_served_by_the_port(main_run):
    from repro_torch.launch.serve import main as serve_main

    _, files = main_run
    toks = serve_main(["--arch", "mamba2-370m", "--smoke", "--artifact", files["art"],
                       "--codec", "int8", "--client", "0", "--gen", "2", "--device", "cpu"])
    assert tuple(toks.shape) == (4, 2)


def test_fl_perplexity_matches_jax(main_run):
    res, _ = main_run
    jb = jregistry.build_model(jbase.get_smoke_config("mamba2-370m"), attn_mode="ref")
    params = {k: v for k, v in res["personalized"].items()}
    jparams = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params)
    batch = res["eval_batch"]["tokens"].numpy()
    want = j_fl_perplexity(jb, jparams, {"tokens": jnp.asarray(batch)})
    assert abs(res["final_loss"] - want) <= 2e-5
    assert ttrain.fl_perplexity(res["bundle"], params, res["eval_batch"]) == res["final_loss"]


def test_main_takes_injected_draws():
    """Round r's selections and batch indices from ``draws``: two runs with
    the same draws are equal, and the bytes are the injected selections'."""
    rng = np.random.default_rng(8)
    s = [torch.as_tensor(rng.integers(0, S, N)) for _ in range(2)]
    idx = [torch.as_tensor(rng.integers(0, 32, (N, 2))) for _ in range(2)]

    def draws(r):
        return {"s": s[r], "idx": idx[r]}

    argv = MAIN + ["--rounds", "2"]
    a, b = ttrain.main(argv, draws=draws), ttrain.main(argv, draws=draws)
    assert torch.equal(a["state"].centers, b["state"].centers)
    spec = GossipSpec.from_graph(make_graph("er", N, 4, seed=0))
    want = sum(float(round_comm_bytes(spec, s_, a["pack_spec"].model_bytes)) for s_ in s)
    assert a["comm_bytes"] == want


def test_main_replay_closure_equals_the_loop():
    argv = MAIN + ["--rounds", "2", "--codec", "int8", "--error-feedback"]
    a, b = ttrain.main(argv), ttrain.main(argv + ["--scan-rounds"])
    assert torch.equal(a["state"].centers, b["state"].centers)
    assert torch.equal(a["state"].ef, b["state"].ef) and a["final_loss"] == b["final_loss"]
    assert a["wire_bytes"] == a["comm_bytes"] * a["wire_ratio"] and a["wire_ratio"] < 0.26


@pytest.mark.parametrize("argv, needle", [
    (["--mesh", "pod", "--pytree"], "--mesh requires the packed plane"),
    (["--mesh", "2pod", "--sparse-density", "0.5"], "not available with --mesh"),
    (["--gossip-backend", "pallas"], "pallas"),
    (["--codec", "int8", "--pytree"], "'int8'"),
])
def test_main_refuses_by_name(argv, needle):
    with pytest.raises(SystemExit, match=needle):
        ttrain.main(MAIN + argv)


def test_mesh_forms_and_the_card_are_refused_by_name(capsys):
    # the mesh forms run since the mesh slice (tests/test_torch_mesh.py);
    # what they still refuse, they refuse by name
    spec = GossipSpec.from_graph(make_graph("er", N, 4, seed=0))
    with pytest.raises(ValueError, match="one client per data row"):
        tsteps.make_ppermute_gossip_mix(spec, MeshShape.of((2, 1), ("data", "model")))
    with pytest.raises(ValueError, match="requires the packed parameter plane"):
        tsteps.make_fedspd_train_step(None, None, None, mesh=object())
    ttrain.main(MAIN + ["--rounds", "1", "--no-donate"])
    assert "--no-donate: a no-op" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.main([a for a in MAIN if a not in ("--device", "cpu")])
