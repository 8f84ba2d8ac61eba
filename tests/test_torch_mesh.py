"""PyTorch port, the mesh on ``torch.distributed`` against the JAX package:
``launch/mesh.py``, ``launch/sharding.py``, the edge-coloured send/recv
gossip (``make_ppermute_gossip_mix``, ``gossip_backend="ppermute"``), the
sharded plane round (``make_fedspd_train_step(mesh=...)``), ``train.py
--mesh`` and ``decode_attention(axis_name=...)``.

The multi-rank cases run in one world of 6 gloo ranks on the CPU, spawned
once by a module fixture (a ``file://`` store in ``tmp_path``, no port).
The parent writes the inputs and JAX's draws, starts the ranks, computes
JAX's single-device references while they run (compiled least
optimized), and reads back what each rank wrote. The ranks import
neither JAX nor the JAX package, so this module imports JAX only inside
functions. The tolerances are JAX's own ``tests/test_ppermute_backend.py``
ones: 1e-5 for a mix, centers 2e-5 / u 1e-5 / bytes exact for the
sharded round, 1e-4 for the registry run.

The in-process cases hold the sharding rules to JAX's for every ported
arch at full width (meta-device trees and caches against
``jax.eval_shape``, on a ``(16, 16)`` and a ``(2, 16, 16)`` mesh shape)
and the error contracts. The module is slow-marked: it spawns processes.
"""
import datetime
import os
import pickle
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.comm.codecs import CommConfig
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.fedspd import FedSPDConfig, make_round_step
from repro_torch.core.gossip import MIX_BACKENDS, GossipSpec, make_mix_fn
from repro_torch.core.packing import make_pack_spec
from repro_torch.core.sparse import SparseConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import RunConfig, run_method
from repro_torch.experiments.registry import get_method
from repro_torch.graphs.topology import complete, make_graph
from repro_torch.interop import state_from_numpy
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_fedspd_train_step, make_ppermute_gossip_mix
from repro_torch.models.attention import decode_attention
from repro_torch.models.smallnets import make_classifier

pytestmark = pytest.mark.slow

WORLD = 6
N, S, DIM, C, M, BATCH, TAU = 6, 2, 8, 4, 32, 8, 2
CODECS = {"int8-ef": dict(codec="int8", block=8, error_feedback=True),
          "int4": dict(codec="int4", block=8),
          "topk-ef": dict(codec="topk", k=5, error_feedback=True)}
ROUND_COMMS = {"fp32": None, "int8-ef": dict(codec="int8", block=8, error_feedback=True)}
REG_EXP = dict(n_clients=5, n_per_client=32, rounds=3, tau=1, batch=8, avg_degree=3.0,
               model="mlp", dim=8, n_classes=3)
TRAIN = ["--arch", "gemma3-1b", "--smoke", "--rounds", "2", "--clients", str(N),
         "--batch", "2", "--seq", "16", "--device", "cpu", "--eval-every", "100"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the ranks (no JAX here)
# --------------------------------------------------------------------------


def _t(a):
    return None if a is None else torch.as_tensor(np.array(a))


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return None if x is None else x.detach().cpu().numpy()


def _classifier():
    params, _, loss, pel, _ = make_classifier("mlp", torch.Generator().manual_seed(0), DIM, C)
    return (types.SimpleNamespace(loss=loss, per_example_loss=pel),
            make_pack_spec(params))


def _rank_mix(rank, inp, meshes):
    """The ppermute mix over the (6, 1) mesh: the whole input on every
    rank (the registry's form) and this rank's row (the mesh round's)."""
    spec = GossipSpec.from_graph(make_graph("er", N, 3.0, seed=0), mode="permute")
    tree = {k: _t(v) for k, v in inp["tree"].items()}
    plane, s, adj = _t(inp["plane"]), _t(inp["s"]), _t(inp["adj"])
    mix = make_ppermute_gossip_mix(spec, meshes["6x1"])
    i = slice(rank, rank + 1)
    out = {"tree": _np(mix(tree, s)), "plane": _np(mix(plane, s)),
           "adj": _np(mix(plane, s, adj=adj)),
           "tree_row": _np(mix({k: v[i] for k, v in tree.items()}, s[i])),
           "plane_row": _np(mix(plane[i], s[i])),
           "adj_row": _np(mix(plane[i], s[i], adj=adj))}
    for name, kw in CODECS.items():
        mixc = make_ppermute_gossip_mix(spec, meshes["6x1"], comm=CommConfig(**kw))
        u = _t(inp["codec_u"][name])
        ef = _t(inp["ef0"]) if kw.get("error_feedback") else None
        out[name] = _np(mixc(plane, s, u, ef))
        out[name + "_row"] = _np(mixc(plane[i], s[i], None if u is None else u[i],
                                      None if ef is None else ef[i]))
    return out


def _rank_round(rank, inp, meshes):
    """The sharded plane round on the (6, 1) mesh with JAX's draws
    injected, fp32 and int8 + EF; then fp32 with the selections drawn by
    the mesh round itself."""
    bundle, tps = _classifier()
    gossip = GossipSpec.from_graph(make_graph("er", N, 3.0, seed=0))
    fcfg = FedSPDConfig(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH)
    data = {"inputs": _t(inp["x"]), "targets": _t(inp["y"])}
    out = {"digest": tps.digest}
    for name, kw in ROUND_COMMS.items():
        comm = None if kw is None else CommConfig(**kw)
        state = state_from_numpy(types.SimpleNamespace(**inp["st0"]), device="cpu")
        if comm is not None:
            state = state._replace(ef=torch.zeros((N, tps.size)))
        placed = tshd.shard_plane_state(state, meshes["6x1"])
        step = make_fedspd_train_step(bundle, gossip, fcfg, pack_spec=tps,
                                      mesh=meshes["6x1"], comm=comm)
        d = inp["draws"][name]
        new, metrics = step(placed, data, s=_t(d["s"]), idx=_t(d["idx"]),
                            comm_u=_t(d.get("comm_u")))
        full = tshd.gather_plane_state(new)
        out[name] = {"centers": _np(full.centers), "u": _np(full.u), "ef": _np(full.ef),
                     "comm_bytes": float(full.comm_bytes), "round": full.round,
                     "consensus": _np(metrics["consensus"]),
                     "local_shape": tuple(new.centers.to_local().shape)}
    state = state_from_numpy(types.SimpleNamespace(**inp["st0"]), device="cpu", seed=5)
    step = make_fedspd_train_step(bundle, gossip, fcfg, pack_spec=tps, mesh=meshes["6x1"])
    new, metrics = step(tshd.shard_plane_state(state, meshes["6x1"]), data,
                        idx=_t(inp["draws"]["fp32"]["idx"]))
    out["own_s"] = {"selected": _np(metrics["selected"]),
                    "centers": _np(tshd.gather_plane_state(new).centers)}
    return out


def _rank_registry(rank, inp, meshes):
    """run_method on gossip_backend="ppermute": 5 clients on the first 5
    of the 6 ranks, every rank running the whole run."""
    data = make_mixture_classification(n_clients=5, n_clusters=2, n_per_client=32, dim=8,
                                       n_classes=3, seed=0, noise=0.3)
    r = run_method("fedspd", data, PaperExpConfig(**REG_EXP), seed=0,
                   cfg=RunConfig(device="cpu", eval_every=100, gossip_mode="permute",
                                 gossip_backend="ppermute"))
    return {"acc": np.asarray(r.acc_per_client), "u": r.extras["u"],
            "comm_bytes": r.comm_bytes}


def _rank_decode(rank, inp, meshes):
    """decode_attention over the (2, 3) mesh's "data" dim: each rank holds
    half the cache, by its data coordinate."""
    mesh = meshes["2x3"]
    q, kc, vc = _t(inp["q"]), _t(inp["kc"]), _t(inp["vc"])
    half = kc.shape[1] // 2
    d = mesh.get_local_rank("data")
    rows = slice(d * half, (d + 1) * half)
    out = {}
    with tmesh.use_mesh(mesh):
        for w in (None, 8):
            out[w] = _np(decode_attention(q, kc[:, rows], vc[:, rows], 30, window=w,
                                          axis_name="data"))
    return out


def _rank_2x2(rank, inp, meshes):
    """A (2, 2) mesh over ranks 0-3: two clients, each on two model
    replicas; the mix and a round on each rank's client."""
    if rank >= 4:
        return None
    mesh = meshes["2x2"]
    i = tshd.client_index(mesh)
    spec = GossipSpec.from_graph(complete(2), mode="permute")
    plane, s = _t(inp["plane2"]), _t(inp["s2"])
    mixed = make_ppermute_gossip_mix(spec, mesh)(plane[i:i + 1], s[i:i + 1])
    bundle, tps = _classifier()
    fcfg = FedSPDConfig(n_clients=2, n_clusters=S, tau=TAU, batch=BATCH)
    state = state_from_numpy(types.SimpleNamespace(**inp["st2"]), device="cpu")
    step = make_fedspd_train_step(bundle, spec, fcfg, pack_spec=tps, mesh=mesh)
    new, _ = step(tshd.shard_plane_state(state, mesh),
                  {"inputs": _t(inp["x2"]), "targets": _t(inp["y2"])},
                  s=s, idx=_t(inp["idx2"]))
    local = tshd.local_state(new)
    return {"client": i, "mixed": _np(mixed), "centers": _np(local.centers),
            "u": _np(local.u), "comm_bytes": float(new.comm_bytes)}


def _rank_train(rank, inp, meshes):
    """train.main --mesh on the (6, 1) mesh (loop, then the closure the
    replay calls on the CPU)."""
    out = {}
    try:
        ttrain.main(TRAIN + ["--mesh", "pod", "--time-budget", "1.0"], mesh=meshes["6x1"])
    except SystemExit as e:
        out["het"] = str(e)
    for extra in ([], ["--scan-rounds"]):
        r = ttrain.main(TRAIN + ["--mesh", "pod"] + extra, mesh=meshes["6x1"])
        full = tshd.gather_plane_state(r["state"])
        out[" ".join(extra) or "loop"] = {
            "centers": _np(full.centers), "u": _np(full.u), "final_loss": r["final_loss"],
            "comm_bytes": r["comm_bytes"]}
    return out


RANK_CASES = {"mix": _rank_mix, "round": _rank_round, "registry": _rank_registry,
              "decode": _rank_decode, "2x2": _rank_2x2, "train": _rank_train}


def _rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    # every rank makes every mesh, in one order (their groups are collective)
    meshes = {"6x1": tmesh.make_test_mesh((6, 1), device_type="cpu"),
              "2x3": tmesh.make_test_mesh((2, 3), device_type="cpu"),
              "2x2": tmesh.make_test_mesh((2, 2), device_type="cpu")}
    out, seconds = {}, {}
    for name, case in RANK_CASES.items():
        t = time.perf_counter()
        out[name] = case(rank, inp, meshes)
        seconds[name] = time.perf_counter() - t
    out["seconds"] = seconds
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the parent: inputs, JAX's references, the world
# --------------------------------------------------------------------------


def _jax_round_draws(st, x_width, comm):
    """One full round's draws, split as the JAX packed step splits its key."""
    import jax
    import jax.numpy as jnp
    from repro.core.fedspd import select_clusters
    from repro.data.pipeline import sample_cluster_batch_indices

    key, k_sel, k_local = jax.random.split(st.key, 3)
    s = select_clusters(k_sel, st.u)
    idx = jnp.stack([jax.vmap(
        lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, BATCH)
    )(jax.random.split(k, st.u.shape[0]), st.z, s) for k in jax.random.split(k_local, TAU)])
    out = {"s": np.asarray(s), "idx": np.asarray(idx)}
    if comm is not None:
        _, _, k_comm = jax.random.split(key, 3)
        out["comm_u"] = np.asarray(jax.random.uniform(
            k_comm, (st.u.shape[0], -(-x_width // comm["block"]), comm["block"]),
            jnp.float32))
    return out


def _jax_state(rng, n, x, seed):
    """A JAX packed state of independent random centers (as ``init_state``
    draws them, without its per-model compiles)."""
    import jax
    import jax.numpy as jnp
    from repro.core.fedspd import FedSPDState as JState

    return JState(centers=jnp.asarray(0.3 * rng.standard_normal((S, n, x)), jnp.float32),
                  u=jnp.full((n, S), 1.0 / S, jnp.float32),
                  z=jnp.zeros((n, M), jnp.int32), round=jnp.int32(0),
                  key=jax.random.PRNGKey(seed), comm_bytes=jnp.float32(0.0))


def _jax_world():
    """The inputs (numpy), with JAX's states and draws, and the closure
    that computes JAX's references."""
    import jax
    import jax.numpy as jnp
    from repro.core.fedspd import FedSPDConfig as JCfg
    from repro.core.packing import make_pack_spec as j_make_pack_spec
    from repro.data.synthetic import make_mixture_classification as j_data
    from repro.models.smallnets import make_classifier as j_classifier

    rng = np.random.default_rng(3)
    inp = {"tree": {"a": rng.standard_normal((N, 5, 3)).astype(np.float32),
                    "b": rng.standard_normal((N, 17)).astype(np.float32)},
           "plane": rng.standard_normal((N, 37)).astype(np.float32),
           "s": rng.integers(0, 2, N).astype(np.int64),
           "ef0": (0.05 * rng.standard_normal((N, 37))).astype(np.float32)}
    # a subgraph: the graph less two links, one of them between clients
    # that selected the same cluster (so the mix changes)
    g, s = make_graph("er", N, 3.0, seed=0), inp["s"]
    links = [(i, j) for i in range(N) for j in range(i + 1, N) if g.adj[i, j] > 0]
    same = [e for e in links if s[e[0]] == s[e[1]]]
    adj = g.adj.copy()
    for i, j in (same[0], next(e for e in links if e != same[0])):
        adj[i, j] = adj[j, i] = 0.0
    inp["adj"] = adj.astype(np.float32)
    inp["codec_u"] = {}
    for name, kw in CODECS.items():
        inp["codec_u"][name] = None if kw["codec"] == "topk" else np.asarray(
            jax.random.uniform(jax.random.PRNGKey(11), (N, -(-37 // kw["block"]),
                                                        kw["block"]), jnp.float32))

    data = j_data(n_clients=N, n_clusters=S, n_per_client=M, dim=DIM, n_classes=C, seed=0)
    inp["x"], inp["y"] = data.x, data.y

    def j_init(k):
        return j_classifier("mlp", k, DIM, C)[0]

    _, _, j_loss, j_pel, _ = j_classifier("mlp", jax.random.PRNGKey(0), DIM, C)
    jps = j_make_pack_spec(jax.eval_shape(j_init, jax.random.PRNGKey(0)))
    jcfg = JCfg(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH)
    st0 = _jax_state(rng, N, jps.size, 4)
    inp["st0"] = {f: np.asarray(getattr(st0, f)) for f in ("centers", "u", "z", "round",
                                                           "comm_bytes")}
    inp["draws"] = {name: _jax_round_draws(st0, jps.size, kw)
                    for name, kw in ROUND_COMMS.items()}

    # the (2, 2) mesh's two clients
    data2 = j_data(n_clients=2, n_clusters=S, n_per_client=M, dim=DIM, n_classes=C, seed=1)
    st2 = _jax_state(rng, 2, jps.size, 6)
    inp["st2"] = {f: np.asarray(getattr(st2, f)) for f in ("centers", "u", "z", "round",
                                                           "comm_bytes")}
    inp["x2"], inp["y2"] = data2.x, data2.y
    inp["s2"] = np.array([1, 1])
    inp["idx2"] = rng.integers(0, M, (TAU, 2, BATCH))
    inp["plane2"] = rng.standard_normal((2, 37)).astype(np.float32)

    inp["q"] = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    inp["kc"], inp["vc"] = (rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
                            for _ in range(2))

    def references():
        from repro.comm import CommConfig as JComm
        from repro.core.fedspd import make_round_step as j_make_round_step
        from repro.core.gossip import GossipSpec as JSpec
        from repro.core.gossip import _make_comm_mix_fn, mix
        from repro.graphs.topology import make_graph as j_graph
        from repro.models import attention as jattn

        dense = JSpec.from_graph(j_graph("er", N, 3.0, seed=0), mode="dense")
        tree = jax.tree.map(jnp.asarray, inp["tree"])
        plane, s = jnp.asarray(inp["plane"]), jnp.asarray(inp["s"])
        ref = {"tree": jax.tree.map(np.asarray, mix(dense, tree, s)),
               "plane": np.asarray(mix(dense, plane, s)),
               "adj": np.asarray(mix(dense, plane, s, adj=jnp.asarray(inp["adj"])))}
        for name, kw in CODECS.items():
            fn = _make_comm_mix_fn(dense, "reference", comm=JComm(**kw))
            ef = jnp.asarray(inp["ef0"]) if kw.get("error_feedback") else None
            mixed, ef = fn(plane, s, jax.random.PRNGKey(11), ef)
            ref[name] = (np.asarray(mixed), None if ef is None else np.asarray(ef))
        spec = JSpec.from_graph(j_graph("er", N, 3.0, seed=0))
        train = {"inputs": jnp.asarray(data.x), "targets": jnp.asarray(data.y)}
        ref["round"] = {"digest": jps.digest}
        jax.config.update("jax_disable_most_optimizations", True)
        try:
            for name, kw in ROUND_COMMS.items():
                jcomm = None if kw is None else JComm(**kw)
                st = st0
                if jcomm is not None:
                    st = st._replace(ef=jnp.zeros((N, jps.size), jnp.float32))
                step = jax.jit(j_make_round_step(j_loss, j_pel, spec, jcfg, pack_spec=jps,
                                                 comm=jcomm))
                new, metrics = step(st, train)
                ref["round"][name] = {
                    "centers": np.asarray(new.centers), "u": np.asarray(new.u),
                    "ef": None if new.ef is None else np.asarray(new.ef),
                    "comm_bytes": float(new.comm_bytes), "round": int(new.round),
                    "consensus": np.asarray(metrics["consensus"])}
        finally:
            jax.config.update("jax_disable_most_optimizations", False)
            jax.clear_caches()
        ref["decode"] = {w: np.asarray(jattn.decode_attention(
            jnp.asarray(inp["q"]), jnp.asarray(inp["kc"]), jnp.asarray(inp["vc"]),
            jnp.int32(30), window=w)) for w in (None, 8)}
        return ref

    return inp, references


def _port_references(inp):
    """The port's own one-device runs the multi-rank ones are held to."""
    bundle, tps = _classifier()
    reg = run_method("fedspd", make_mixture_classification(
        n_clients=5, n_clusters=2, n_per_client=32, dim=8, n_classes=3, seed=0, noise=0.3),
        PaperExpConfig(**REG_EXP), seed=0,
        cfg=RunConfig(device="cpu", eval_every=100, gossip_mode="permute",
                      gossip_backend="reference"))
    spec2 = GossipSpec.from_graph(complete(2), mode="permute")
    step2 = make_round_step(bundle.loss, bundle.per_example_loss, spec2,
                            FedSPDConfig(n_clients=2, n_clusters=S, tau=TAU, batch=BATCH),
                            pack_spec=tps, mix_fn=make_mix_fn(spec2, "reference"))
    new2, _ = step2(state_from_numpy(types.SimpleNamespace(**inp["st2"]), device="cpu"),
                    {"inputs": _t(inp["x2"]), "targets": _t(inp["y2"])},
                    s=_t(inp["s2"]), idx=_t(inp["idx2"]))
    gossip = GossipSpec.from_graph(make_graph("er", N, 3.0, seed=0))
    step = make_round_step(bundle.loss, bundle.per_example_loss, gossip,
                           FedSPDConfig(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH),
                           pack_spec=tps)
    own, metrics = step(state_from_numpy(types.SimpleNamespace(**inp["st0"]), device="cpu",
                                         seed=5),
                        {"inputs": _t(inp["x"]), "targets": _t(inp["y"])},
                        idx=_t(inp["draws"]["fp32"]["idx"]))
    train = {extra or "loop": ttrain.main(TRAIN + ([extra] if extra else []))
             for extra in ("", "--scan-rounds")}
    return {"registry": {"acc": np.asarray(reg.acc_per_client), "u": reg.extras["u"],
                         "comm_bytes": reg.comm_bytes},
            "2x2": {"centers": new2.centers.numpy(), "u": new2.u.numpy(),
                    "comm_bytes": float(new2.comm_bytes),
                    "mixed": make_mix_fn(spec2, "reference")(_t(inp["plane2"]),
                                                             _t(inp["s2"])).numpy()},
            "own_s": {"selected": metrics["selected"].numpy(),
                      "centers": own.centers.numpy()},
            "train": {k: {"centers": v["state"].centers.numpy(), "u": v["state"].u.numpy(),
                          "final_loss": v["final_loss"], "comm_bytes": v["comm_bytes"]}
                      for k, v in train.items()}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every rank's outputs, JAX's references and the port's one-device
    runs, with the seconds each part took."""
    tmp = str(tmp_path_factory.mktemp("mesh_world"))
    t0 = time.perf_counter()
    inp, references = _jax_world()
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    ctx = mp.start_processes(_rank_main, args=(WORLD, tmp), nprocs=WORLD, join=False,
                             start_method="spawn")
    try:
        ref = references()
        port = _port_references(inp)
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError("the gloo world did not finish in 300 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return {"inp": inp, "ref": ref, "port": port, "outs": outs,
            "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------------------
# multi-rank cases
# --------------------------------------------------------------------------


def test_ppermute_mix_matches_jax_dense_mix(world):
    """Pytree and plane, the whole input on every rank and each rank's own
    row, and a traced subgraph adjacency: JAX's dense Eq. (1) at 1e-5."""
    ref, outs = world["ref"], world["outs"]
    for r, out in enumerate(outs):
        mix = out["mix"]
        for k in ("a", "b"):
            np.testing.assert_allclose(mix["tree"][k], ref["tree"][k], atol=1e-5, rtol=0)
            np.testing.assert_allclose(mix["tree_row"][k], ref["tree"][k][r:r + 1],
                                       atol=1e-5, rtol=0)
        for k in ("plane", "adj"):
            np.testing.assert_allclose(mix[k], ref[k], atol=1e-5, rtol=0)
            np.testing.assert_allclose(mix[k + "_row"], ref[k][r:r + 1], atol=1e-5, rtol=0)
        assert mix["tree"]["a"].shape == (N, 5, 3) and mix["plane_row"].shape == (1, 37)
    # the dropped links change the mix; every rank returns the same rows
    assert not np.allclose(ref["adj"], ref["plane"], atol=1e-3)
    for out in outs[1:]:
        assert np.array_equal(out["mix"]["plane"], outs[0]["mix"]["plane"])


@pytest.mark.parametrize("codec", list(CODECS))
def test_ppermute_mix_ships_the_codec_payload_and_matches_jax(world, codec):
    """The encoded row crosses the link; the result and the residual
    equal JAX's dense comm mix W·decode(encode(C)) under the same draws."""
    want, want_ef = world["ref"][codec]
    for r, out in enumerate(world["outs"]):
        got, ef = out["mix"][codec]
        row, ef_row = out["mix"][codec + "_row"]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(row, want[r:r + 1], atol=1e-5, rtol=0)
        if want_ef is None:
            assert ef is None and ef_row is None
        else:
            np.testing.assert_allclose(ef, want_ef, atol=1e-6, rtol=0)
            np.testing.assert_allclose(ef_row, want_ef[r:r + 1], atol=1e-6, rtol=0)


@pytest.mark.parametrize("comm", list(ROUND_COMMS))
def test_sharded_plane_round_matches_jax_single_device(world, comm):
    """The (6, 1) mesh round on shard_plane_state, JAX's draws injected,
    against JAX's one-device make_round_step(pack_spec=...)."""
    want = world["ref"]["round"][comm]
    for out in world["outs"]:
        assert out["round"]["digest"] == world["ref"]["round"]["digest"]
        got = out["round"][comm]
        assert got["local_shape"] == (S, 1, want["centers"].shape[-1])
        np.testing.assert_allclose(got["centers"], want["centers"], atol=2e-5, rtol=0)
        np.testing.assert_allclose(got["u"], want["u"], atol=1e-5, rtol=0)
        assert got["comm_bytes"] == want["comm_bytes"] > 0
        assert got["round"] == want["round"] == 1
        np.testing.assert_allclose(got["consensus"], want["consensus"], rtol=1e-5)
        if want["ef"] is None:
            assert got["ef"] is None
        else:
            np.testing.assert_allclose(got["ef"], want["ef"], atol=1e-5, rtol=0)


def test_mesh_round_draws_the_selections_as_the_one_device_round(world):
    """Without injected selections the mesh round draws them from the
    state's generator over the gathered u: the one-device round's."""
    want = world["port"]["own_s"]
    for out in world["outs"]:
        assert np.array_equal(out["round"]["own_s"]["selected"], want["selected"])
        np.testing.assert_allclose(out["round"]["own_s"]["centers"], want["centers"],
                                   atol=2e-5, rtol=0)


def test_ppermute_registry_round_trip(world):
    """run_method on gossip_backend="ppermute" (5 clients, 6 ranks: the
    first 5 mix) against the port's own reference run, at 1e-4."""
    want = world["port"]["registry"]
    for out in world["outs"]:
        got = out["registry"]
        np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got["u"], want["u"], atol=1e-4, rtol=0)
        assert got["comm_bytes"] == want["comm_bytes"]


def test_decode_attention_combines_sequence_shards_over_a_mesh_axis(world):
    """Each of the "data" dim's two ranks holds half the cache: the
    combined partials equal JAX's decode_attention on the whole cache."""
    for out in world["outs"]:
        for w in (None, 8):
            np.testing.assert_allclose(out["decode"][w], world["ref"]["decode"][w],
                                       atol=1e-5, rtol=0)


def test_two_by_two_mesh_exchanges_within_a_model_coordinate(world):
    """On a (2, 2) mesh the exchange runs between the ranks of one model
    coordinate; a client's two model replicas agree bit for bit, and
    equal the one-device permute mix and round."""
    outs = [o["2x2"] for o in world["outs"]]
    assert [o["client"] for o in outs[:4]] == [0, 0, 1, 1] and outs[4] is outs[5] is None
    want = world["port"]["2x2"]
    for a, b in ((0, 1), (2, 3)):
        for k in ("mixed", "centers", "u"):
            assert np.array_equal(outs[a][k], outs[b][k])
        i = outs[a]["client"]
        np.testing.assert_allclose(outs[a]["mixed"], want["mixed"][i:i + 1], atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(outs[a]["centers"], want["centers"][:, i:i + 1],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(outs[a]["u"], want["u"][i:i + 1], atol=1e-6, rtol=0)
        assert outs[a]["comm_bytes"] == want["comm_bytes"]


@pytest.mark.parametrize("engine", ["loop", "--scan-rounds"])
def test_train_main_on_a_mesh_matches_the_one_device_run(world, engine):
    """train.main --mesh on the (6, 1) mesh against the same run on one
    device: the selections and batches are the same draws, so the runs
    differ only by the exchange's arithmetic. The heterogeneity flags are
    refused on the mesh with the JAX launcher's message."""
    want = world["port"]["train"][engine]
    for out in world["outs"]:
        assert out["train"]["het"] == ("client heterogeneity is not available with --mesh "
                                       "(the ppermute schedule reads a binary adjacency)")
        got = out["train"][engine]
        np.testing.assert_allclose(got["centers"], want["centers"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["u"], want["u"], atol=1e-6, rtol=0)
        assert abs(got["final_loss"] - want["final_loss"]) < 1e-5
        assert got["comm_bytes"] == want["comm_bytes"] > 0


# --------------------------------------------------------------------------
# in-process: the sharding rules and the error contracts
# --------------------------------------------------------------------------

PORTED = ["olmo-1b", "gemma3-1b", "granite-3-8b", "h2o-danube-1.8b", "chameleon-34b",
          "mamba2-370m", "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b", "whisper-base"]
MESH_SHAPES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]


def _port_specs(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_specs(v, prefix + (k,)))
        return out
    return {tshd._path_str(prefix): tree}


def _jax_specs(tree):
    import jax
    from jax.sharding import PartitionSpec
    from repro.launch import sharding as jshd

    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {jshd._path_str(p): tuple(v) for p, v in leaves}


@pytest.mark.parametrize("arch", PORTED)
def test_sharding_rules_equal_jax_for_every_arch_at_full_width(arch):
    """param_spec / params_pspecs over the meta-device parameter tree and
    _cache_leaf_spec / cache_pspecs over the meta-device cache, against
    JAX's rules on jax.eval_shape's trees, on both production shapes."""
    import jax
    from repro.configs import base as jbase
    from repro.launch import sharding as jshd
    from repro.models import registry as jreg

    from repro_torch.configs import base as tbase
    from repro_torch.models import registry as treg

    tb, jb = treg.build_model(tbase.get_config(arch)), jreg.build_model(jbase.get_config(arch))
    params = tb.init(None)
    jparams = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    for batch, length in ((16, 4096), (1, 32768)):
        cache = tb.init_cache(batch, length, device="meta")
        jcache = jax.eval_shape(lambda: jb.init_cache(batch, length))
        for shape, axes in MESH_SHAPES:
            jm = types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)
            tm = tmesh.MeshShape.of(shape, axes)
            assert _port_specs(tshd.cache_pspecs(cache, tm)) == \
                _jax_specs(jshd.cache_pspecs(jcache, jm))
            got = _port_specs(tshd.params_pspecs(params, tm))
            assert got == _jax_specs(jshd.params_pspecs(jparams, jm))
            assert any("model" in spec for spec in got.values())


def test_state_and_batch_specs_and_placements():
    """The FedSPD state and batch rules against JAX's, and the DTensor
    placements a spec becomes."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec
    from repro.core.fedspd import FedSPDState as JState
    from repro.launch import sharding as jshd
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.core.fedspd import FedSPDState

    for shape, axes in MESH_SHAPES:
        jm = types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)
        tm = tmesh.MeshShape.of(shape, axes)
        jst = JState(centers=jnp.zeros((2, 16, 8)), u=jnp.zeros((16, 2)), z=jnp.zeros((16, 3)),
                     round=0, key=None, comm_bytes=jnp.zeros(()), ef=jnp.zeros((16, 8)))
        tst = FedSPDState(centers=torch.zeros((2, 16, 8)), u=torch.zeros((16, 2)),
                          z=torch.zeros((16, 3)), round=0, gen=None,
                          comm_bytes=torch.zeros(()), ef=torch.zeros((16, 8)))
        jspec, tspec = jshd.plane_state_pspecs(jst, jm), tshd.fedspd_state_pspecs(tst, tm)
        for f in ("centers", "u", "z", "ef"):
            assert getattr(tspec, f) == tuple(getattr(jspec, f)), f
        tree_j = JState(centers={"w": jnp.zeros((2, 16, 512, 256))}, u=None, z=None, round=0,
                        key=None, comm_bytes=None)
        tree_t = FedSPDState(centers={"w": torch.zeros((2, 16, 512, 256), device="meta")},
                             u=None, z=None, round=0, gen=None, comm_bytes=None)
        assert tshd.fedspd_state_pspecs(tree_t, tm).centers["w"] == \
            tuple(jshd.fedspd_state_pspecs(tree_j, jm).centers["w"])
        batch = {"tokens": torch.zeros((16, 4, 8), device="meta")}
        want = jshd.batch_pspecs({"tokens": jnp.zeros((16, 4, 8))}, jm)["tokens"]
        assert tshd.batch_pspecs(batch, tm)["tokens"] == tuple(want)
        assert isinstance(want, PartitionSpec)
    two = tmesh.MeshShape.of((2, 16, 16), ("pod", "data", "model"))
    assert tshd.placements((None, ("pod", "data"), "model"), two) == \
        [Shard(1), Shard(1), Shard(2)]
    assert tshd.placements((None, None), two) == [Replicate()] * 3
    sh = tshd.to_shardings(tshd.plane_state_pspecs(
        FedSPDState(torch.zeros(1), torch.zeros(1), torch.zeros(1), 0, None,
                    torch.zeros(())), two), two)
    assert sh.centers == [Shard(1), Shard(1), Replicate()] and sh.ef is None
    assert sh.comm_bytes == [Replicate()] * 3


def test_mesh_constants_and_axes():
    one, two = (tmesh.MeshShape.of(*a) for a in MESH_SHAPES)
    assert (tmesh.dp_axes(one), tmesh.dp_size(one), tmesh.model_size(one),
            tmesh.n_chips(one)) == (("data",), 16, 16, 256)
    assert (tmesh.dp_axes(two), tmesh.dp_size(two), tmesh.n_chips(two)) == \
        (("pod", "data"), 32, 512)
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12
    assert tmesh.ICI_BW == tmesh.NVLINK_BW == 450e9 and tmesh.HBM_BYTES > 80e9
    with pytest.raises(RuntimeError, match="no current mesh"):
        tmesh.current_mesh()
    with tmesh.use_mesh(one):
        assert tmesh.current_mesh() is one


def test_error_contracts():
    """Each refusal of the mesh paths, with JAX's wording where JAX makes
    it."""
    assert MIX_BACKENDS == ("cuda", "reference", "ppermute")
    assert not dist.is_initialized()
    spec = GossipSpec.from_graph(make_graph("er", 64, 3.0, seed=0))
    with pytest.raises(RuntimeError, match="one device per client"):
        make_mix_fn(spec, "ppermute")
    aligned = GossipSpec.from_graph(make_graph("er", 4, 2.0, seed=0), cos_align_threshold=0.5)
    with pytest.raises(ValueError, match="cosine-alignment"):
        make_mix_fn(aligned, "ppermute")
    with pytest.raises(ValueError, match="one client per data row"):
        make_ppermute_gossip_mix(spec, tmesh.MeshShape.of((2, 1), ("data", "model")))
    data = make_mixture_classification(n_clients=4, n_per_client=16)
    exp = PaperExpConfig(rounds=1, n_clients=4)
    with pytest.raises(ValueError, match="sparse training is not available on the ppermute"):
        run_method("fedspd", data, exp, cfg=RunConfig(
            device="cpu", gossip_backend="ppermute", sparse=SparseConfig(density=0.5)))
    ctx = types.SimpleNamespace(pack_spec=object(),
                                opt=lambda k, d=None: {"gossip_backend": "ppermute"}.get(k, d))
    with pytest.raises(ValueError, match="cohort subsampling is not available on the ppermute"):
        get_method("fedspd").cohort_axes(ctx, None)
    with pytest.raises(ValueError, match="unknown baseline gossip backend 'ppermute'"):
        run_method("dfl_fedavg", data, exp, cfg=RunConfig(device="cpu",
                                                          gossip_backend="ppermute"))
    bundle, _ = _classifier()
    with pytest.raises(ValueError, match="requires the packed parameter plane"):
        make_fedspd_train_step(bundle, spec, FedSPDConfig(n_clients=64, n_clusters=2),
                               mesh=object())
    with pytest.raises(ValueError, match="sparse training is not available on the mesh"):
        make_fedspd_train_step(bundle, spec, FedSPDConfig(n_clients=64, n_clusters=2),
                               mesh=object(), sparse=SparseConfig(density=0.5))
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="torchrun"):
            tmesh.make_production_mesh(multi_pod=multi)
    with pytest.raises(RuntimeError, match="need 4 ranks"):
        tmesh.make_test_mesh((2, 2), device_type="cpu")
    argv = ["--arch", "gemma3-1b", "--smoke", "--rounds", "1", "--clients", "16",
            "--batch", "2", "--seq", "16", "--device", "cpu"]
    with pytest.raises(RuntimeError, match="mesh \\(16, 16\\) needs 256 ranks"):
        ttrain.main(argv + ["--mesh", "pod"])


def test_train_mesh_refusals_use_jax_wording():
    """--mesh with --pytree, with sparse masks and with the heterogeneity
    flags: SystemExit with the JAX launcher's messages (read from its
    source, so the wording cannot drift)."""
    import inspect

    from repro.launch import train as jtrain

    src = inspect.getsource(jtrain.main)
    argv = ["--arch", "gemma3-1b", "--smoke", "--rounds", "1", "--clients", "2",
            "--batch", "2", "--seq", "16", "--device", "cpu", "--mesh", "pod"]
    for extra, needle in ((["--pytree"], "--mesh requires the packed plane (drop --pytree)"),
                          (["--sparse-density", "0.5"],
                           "--sparse-density < 1 is not available with --mesh")):
        assert needle in src
        with pytest.raises(SystemExit, match=needle.replace("(", "\\(").replace(")", "\\)")):
            ttrain.main(argv + extra)
    assert "client heterogeneity is not available with --mesh" in src
    with pytest.raises(SystemExit, match="capturing NCCL send/recv in a CUDA graph"):
        ttrain.main([a for a in argv if a not in ("--device", "cpu")] + ["--scan-rounds"])
