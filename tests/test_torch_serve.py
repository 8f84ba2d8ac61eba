"""PyTorch port, the serving slice against the JAX package: the two
dequant mixes' plain versions against the Pallas kernels (interpret mode)
at 1e-5, PackSpec digests, checkpoints and servable artifacts read and
written across the two packages (arrays equal), ClusterPlaneServer
predictions and personalized leaves at 1e-5 for fp32, int8 and int4, the
train → export → serve slice end to end, and an import audit: the port
and chip_smoke.py import neither ``jax`` nor ``repro``."""
import ast
import collections
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.comm.codecs import Channel as JChannel
from repro.comm.codecs import CommConfig as JCommConfig
from repro.comm.codecs import int4_pack as j_int4_pack
from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.core.packing import pack as j_pack
from repro.experiments.export import export_servable as j_export_servable
from repro.kernels.gossip_mix import gossip_mix_dequant as j_dequant
from repro.kernels.gossip_mix import mixture_mix_dequant4 as j_dequant4
from repro.models.smallnets import make_classifier as j_make_classifier
from repro.serve import ClusterPlaneServer as JServer
from repro.serve import load_servable as j_load_servable
from repro.serve import save_servable as j_save_servable
from repro.telemetry import LatencyStats as JLatencyStats
from repro_torch.checkpoint import ckpt
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.packing import make_pack_spec, unpack
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import RunConfig, export_run, run_method
from repro_torch.experiments.export import cluster_plane, export_servable
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.kernels.gossip_mix import (
    gossip_mix_dequant,
    gossip_mix_dequant_ref,
    mixture_mix_dequant4,
    mixture_mix_dequant4_ref,
    reset_launch_counts,
)
from repro_torch.models.smallnets import make_classifier
from repro_torch.serve import ClusterPlaneServer, load_servable, save_servable
from repro_torch.telemetry.counters import LatencyStats

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
S, DIM, NC, QB, B = 3, 16, 4, 16, 5   # tests/test_serve.py's _mlp_plane sizes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """S mlp models packed by the JAX package into an (S, X) plane (X is
    not a multiple of QB), both packages' specs and forwards, and B
    requests (Dirichlet rows, Gaussian inputs) drawn with numpy."""
    key = jax.random.PRNGKey(0)
    _, j_apply, *_ = j_make_classifier("mlp", key, DIM, NC)

    def j_init(k):
        return j_make_classifier("mlp", k, DIM, NC)[0]

    jspec = j_make_pack_spec(jax.eval_shape(j_init, key))
    plane = np.stack([np.asarray(j_pack(j_init(jax.random.PRNGKey(i)), jspec))
                      for i in range(S)])
    params, t_apply, *_ = make_classifier("mlp", torch.Generator(), DIM, NC)
    tspec = make_pack_spec(params)
    rng = np.random.default_rng(2)
    u = rng.dirichlet(np.ones(S), size=B).astype(np.float32)
    x = rng.normal(size=(B, DIM)).astype(np.float32)
    ut = rng.dirichlet(np.ones(S), size=7).astype(np.float32)
    assert jspec.size == tspec.size and jspec.size % QB
    return types.SimpleNamespace(plane=plane, jspec=jspec, tspec=tspec, j_apply=j_apply,
                                 t_apply=t_apply, u=u, x=x, u_table=ut)


# ------------------------------------------------------------------
# the two serving kernels' plain versions vs the Pallas kernels
# ------------------------------------------------------------------

# (M, N, Xp, qblock): serving (B over S), gossip (M = N), M > N, one
# scale block per row, an odd qblock; then the square W at the edges of
# the card's route (the narrow kernel from N = 1 to 32, the main path's
# exchange at N = 20; the serving template at N = 33); one request over
# S = 2 (the card's stream kernel), two at a qblock that is not a
# multiple of 4
DEQUANT_SHAPES = [(5, 3, 160, 16), (20, 2, 1024, 64), (8, 8, 512, 256),
                  (37, 5, 1010, 10), (4, 1, 64, 64), (6, 3, 999, 3),
                  (1, 1, 64, 64), (20, 20, 17408, 256), (32, 32, 999, 3), (33, 33, 1010, 10),
                  (1, 2, 1024, 64), (2, 2, 1010, 10)]


def _dequant_operands(m, n, xp, qblock, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(n), size=m).astype(np.float32)
    q = rng.integers(-127, 128, (n, xp)).astype(np.int8)
    packed = rng.integers(0, 256, (n, xp // 2)).astype(np.uint8)
    scales = (rng.random((n, xp // qblock)) / 64).astype(np.float32)
    return w, q, packed, scales


@pytest.mark.parametrize("m,n,xp,qblock", DEQUANT_SHAPES)
def test_dequant_plain_matches_pallas(m, n, xp, qblock):
    w, q, _, sc = _dequant_operands(m, n, xp, qblock)
    want = np.asarray(j_dequant(jnp.asarray(w), jnp.asarray(q), jnp.asarray(sc),
                                qblock=qblock, interpret=True))
    got = gossip_mix_dequant_ref(*map(torch.as_tensor, (w, q, sc)), qblock=qblock)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("m,n,xp,qblock",
                         [s for s in DEQUANT_SHAPES if s[2] % 2 == 0 and s[3] % 2 == 0])
def test_dequant4_plain_matches_pallas(m, n, xp, qblock):
    u, _, p, sc = _dequant_operands(m, n, xp, qblock, seed=1)
    want = np.asarray(j_dequant4(jnp.asarray(u), jnp.asarray(p), jnp.asarray(sc),
                                 qblock=qblock, interpret=True))
    got = mixture_mix_dequant4_ref(*map(torch.as_tensor, (u, p, sc)), qblock=qblock)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_dequant_wrappers_on_cpu_run_the_plain_versions_and_refuse_bad_shapes():
    w, q, p, sc = map(torch.as_tensor, _dequant_operands(5, 3, 160, 16))
    reset_launch_counts()
    assert torch.equal(gossip_mix_dequant(w, q, sc, qblock=16),
                       gossip_mix_dequant_ref(w, q, sc, qblock=16))
    assert torch.equal(mixture_mix_dequant4(w, p, sc, qblock=16),
                       mixture_mix_dequant4_ref(w, p, sc, qblock=16))
    assert gossip_mix_dequant.launches == 0 and mixture_mix_dequant4.launches == 0
    # the JAX kernels' shape errors, raised on the same inputs
    for fn, args in ((gossip_mix_dequant, (w[:, :2], q, sc)),
                     (j_dequant, (jnp.asarray(w[:, :2]), jnp.asarray(q), jnp.asarray(sc)))):
        with pytest.raises(ValueError, match="plane rows"):
            fn(*args, qblock=16)
    for fn, args in ((gossip_mix_dequant, (w, q, sc)),
                     (j_dequant, (jnp.asarray(w), jnp.asarray(q), jnp.asarray(sc)))):
        with pytest.raises(ValueError, match="tile"):
            fn(*args, qblock=32)
    for fn, args in ((mixture_mix_dequant4, (w, p, sc)),
                     (j_dequant4, (jnp.asarray(w), jnp.asarray(p), jnp.asarray(sc)))):
        with pytest.raises(ValueError, match="even qblock"):
            fn(*args, qblock=64)
    for fn, args in ((mixture_mix_dequant4, (w[:, :2], p, sc)),
                     (j_dequant4, (jnp.asarray(w[:, :2]), jnp.asarray(p), jnp.asarray(sc)))):
        with pytest.raises(ValueError, match="mixture weights"):
            fn(*args, qblock=16)


# ------------------------------------------------------------------
# PackSpec digest and checkpoints across packages
# ------------------------------------------------------------------


@pytest.mark.parametrize("model,dim,nc", [("mlp", 16, 4), ("mlp", 64, 10), ("linear", 16, 4)])
def test_pack_digest_equals_jax(model, dim, nc):
    jp = j_make_classifier(model, jax.random.PRNGKey(0), dim, nc)[0]
    tp = make_classifier(model, torch.Generator(), dim, nc)[0]
    assert make_pack_spec(tp).digest == j_make_pack_spec(jp).digest
    tree = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert make_pack_spec(tree).digest == j_make_pack_spec(jp).digest


NT = collections.namedtuple("NT", "b a")


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"u": rng.random((4, 3)).astype(np.float32),
            "plane": rng.standard_normal((3, 9)).astype(np.float32),
            "z": {"y": [np.arange(3), np.int8(5) * np.ones(2, np.int8)],
                  "x": NT(np.float32(1.5) * np.ones(1, np.float32),
                          rng.integers(0, 9, (2, 2)))},
            "skip": None}


def _assert_trees_equal(a, b):
    fa, fb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    tree = _tree(0)
    man = ckpt.CkptManifest(kind="servable", arch="mlp", n_clients=4, n_clusters=3,
                            plane_shape=(3, 9), pack_digest="ab", codec="int4",
                            qblock=16, extra={"note": "hi"})
    torn = dict(tree, plane=torch.as_tensor(tree["plane"]))   # tensors write too
    ckpt.save(path, torn, manifest=man)
    with np.load(path) as data:
        assert set(data.files) == {"__manifest__", "['u']", "['plane']", "['z']|['x']|.b",
                                   "['z']|['x']|.a", "['z']|['y']|[0]", "['z']|['y']|[1]"}
    back, jm = j_ckpt.restore(path, tree)
    _assert_trees_equal(back, tree)
    assert j_ckpt.read_manifest(path) == j_ckpt.CkptManifest(**vars(man))
    assert jm.to_json() == man.to_json()


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    tree = _tree(1)
    jm = j_ckpt.CkptManifest(kind="checkpoint", n_clients=4, extra={"round": 3})
    j_ckpt.save(path, tree, manifest=jm)
    back, man = ckpt.restore(path, tree)
    _assert_trees_equal(back, tree)
    assert isinstance(back["z"]["x"], NT) and back["skip"] is None
    assert man.to_json() == jm.to_json() and ckpt.read_manifest(path) == man
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(path, dict(tree, u=np.zeros((5, 3), np.float32)))
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(path, dict(tree, w=np.zeros(1)))


def test_manifest_errors_legacy_reader_and_latest(tmp_path):
    with pytest.raises(KeyError, match=r"\['n_clients', 'pack_digest'\]"):
        ckpt.CkptManifest().need("n_clients", "pack_digest")
    with pytest.raises(ValueError, match="plane_shape"):
        ckpt.CkptManifest(plane_shape=(2, 10)).check(plane_shape=(2, 11))
    path = str(tmp_path / "ckpt_3.npz")
    with pytest.warns(DeprecationWarning, match="manifest=CkptManifest"):
        ckpt.save(path, {"a": np.arange(3.0)}, metadata={"round": 7, "n_clients": 9})
    _, m = j_ckpt.restore(path, {"a": np.arange(3.0)})
    assert m.n_clients == 9 and m.extra["round"] == 7 and m.version == 2
    with pytest.raises(ValueError, match="not both"):
        with pytest.warns(DeprecationWarning):
            ckpt.save(path, {"a": 1}, manifest=ckpt.CkptManifest(), metadata={"x": 1})
    ckpt.save(str(tmp_path / "ckpt_12.npz"), {"a": np.ones(1)})
    assert ckpt.latest(str(tmp_path)) == str(tmp_path / "ckpt_12.npz")
    assert ckpt.latest(str(tmp_path / "none")) is None


# ------------------------------------------------------------------
# servable artifacts across packages
# ------------------------------------------------------------------


def _art_arrays(art) -> dict:
    names = ("u_table", "plane", "plane_q", "plane_scale", "plane_packed")
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k in names if (v := getattr(art, k)) is not None}


@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
def test_artifact_saved_by_jax_loads_in_the_port(world, tmp_path, codec):
    path = str(tmp_path / f"j_{codec}.npz")
    jm = j_save_servable(path, world.plane, world.jspec, arch="mlp", u=world.u_table,
                         codec=codec, qblock=QB)
    art = load_servable(path, world.tspec, device="cpu")
    want = _art_arrays(j_load_servable(path, world.jspec))
    got = _art_arrays(art)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert art.manifest.to_json() == jm.to_json()
    assert art.n_clusters == S and art.codec == codec


@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
def test_artifact_saved_by_the_port_loads_in_jax(world, tmp_path, codec):
    path, jpath = str(tmp_path / f"t_{codec}.npz"), str(tmp_path / f"j_{codec}.npz")
    man = save_servable(path, torch.as_tensor(world.plane), world.tspec, arch="mlp",
                        u=world.u_table, codec=codec, qblock=QB)
    jm = j_save_servable(jpath, world.plane, world.jspec, arch="mlp", u=world.u_table,
                         codec=codec, qblock=QB)
    assert man.to_json() == jm.to_json()
    got = _art_arrays(j_load_servable(path, world.jspec))
    want = _art_arrays(j_load_servable(jpath, world.jspec))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with np.load(path) as a, np.load(jpath) as b:   # the stored arrays, byte for byte
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        if codec != "fp32":
            ch = JChannel(JCommConfig(codec=codec, block=QB), world.jspec.size)
            assert a["['plane_wire']"].nbytes == S * ch.wire_model_bytes


def test_artifact_guards(world, tmp_path):
    path = str(tmp_path / "plane.npz")
    save_servable(path, world.plane, world.tspec, arch="mlp")
    other = make_pack_spec(make_classifier("linear", torch.Generator(), DIM, NC)[0])
    with pytest.raises(ValueError, match="pack_digest"):
        load_servable(path, other, device="cpu")
    ck = str(tmp_path / "ck.npz")
    j_ckpt.save(ck, {"a": np.ones(3)}, manifest=j_ckpt.CkptManifest(kind="checkpoint"))
    with pytest.raises(ValueError, match="kind"):
        load_servable(ck, device="cpu")
    with pytest.raises(ValueError, match="shipping format"):
        save_servable(path, world.plane, world.tspec, arch="mlp", codec="topk")
    with pytest.raises(ValueError, match=r"\(S, X="):
        save_servable(path, world.plane[:, :-1], world.tspec, arch="mlp")
    with pytest.raises(ValueError, match=r"\(N, S="):
        save_servable(path, world.plane, world.tspec, arch="mlp", u=world.u_table[:, :2])


# ------------------------------------------------------------------
# ClusterPlaneServer against the JAX server
# ------------------------------------------------------------------


def _servers(world, codec):
    kw = {}
    if codec != "fp32":
        enc = JChannel(JCommConfig(codec=codec, block=QB), world.jspec.size).encode(
            jnp.asarray(world.plane), None, rounding="nearest")
        q, sc = np.asarray(enc["q"]), np.asarray(enc["scale"])
        kw = ({"plane_q": q} if codec == "int8"
              else {"plane_packed": np.asarray(j_int4_pack(jnp.asarray(q)))})
        kw["plane_scale"] = sc
    else:
        kw["plane"] = world.plane
    jsrv = JServer(world.jspec, codec=codec, qblock=QB, apply_fn=world.j_apply, **kw)
    tsrv = ClusterPlaneServer(world.tspec, codec=codec, qblock=QB, apply_fn=world.t_apply,
                              device="cpu", **kw)
    return jsrv, tsrv


@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
def test_server_predict_and_personalized_equal_jax(world, codec):
    jsrv, tsrv = _servers(world, codec)
    want = np.asarray(jsrv.predict(world.u, world.x))
    got = tsrv.predict(world.u, world.x)
    assert got.shape == (B, NC) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    jleaves = jax.tree.leaves(jsrv.personalized(world.u))
    tleaves = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                           tsrv.personalized(torch.as_tensor(world.u))))
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, np.asarray(a), atol=TOL, rtol=0)
    assert tsrv.n_dispatches == jsrv.n_dispatches == 2
    assert tsrv.dequant_calls == jsrv.dequant_calls == (0 if codec == "fp32" else 2)
    assert tsrv.plane_bytes == jsrv.plane_bytes
    snap, jsnap = tsrv.telemetry_snapshot(), jsrv.telemetry_snapshot()
    assert snap.keys() == jsnap.keys() and snap["n_compiles"] == 0
    assert snap["requests"] == 2 * B and snap["batches"] == 2


def test_server_refuses_what_needs_the_lm_zoo_and_bad_planes(world):
    _, tsrv = _servers(world, "fp32")
    # the LM zoo is ported (tests/test_torch_lm_serve.py): a server takes a
    # bundle, and generation without one is refused
    for call in (lambda: tsrv.generate(world.u, np.zeros((B, 4)), gen=2),
                 lambda: tsrv.serve_client(0, np.zeros((B, 4)), gen=2)):
        with pytest.raises(ValueError, match="needs (bundle|u_table)= at construction"):
            call()
    assert ClusterPlaneServer(world.tspec, plane=world.plane, bundle=object(),
                              device="cpu").bundle is not None
    with pytest.raises(ValueError, match="apply_fn"):
        ClusterPlaneServer(world.tspec, plane=world.plane, device="cpu").predict(world.u, world.x)
    with pytest.raises(ValueError, match="plane_q"):
        ClusterPlaneServer(world.tspec, codec="int8", device="cpu")
    with pytest.raises(ValueError, match="shipping format"):
        ClusterPlaneServer(world.tspec, codec="topk", device="cpu")
    with pytest.raises(ValueError, match=r"\(S, X="):
        ClusterPlaneServer(world.tspec, plane=world.plane[:, 1:], device="cpu")


def test_entry_points_default_to_the_card(world, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    path = str(tmp_path / "plane.npz")
    save_servable(path, world.plane, world.tspec, arch="mlp")
    tree = {"w": np.ones(2, np.float32)}
    for call in (lambda: load_servable(path),
                 lambda: ClusterPlaneServer(world.tspec, plane=world.plane),
                 lambda: params_from_numpy(tree),
                 lambda: state_from_numpy(types.SimpleNamespace(
                     centers=np.zeros((2, 3, 4)), u=np.ones((3, 2)), z=np.zeros((3, 5)),
                     round=0, comm_bytes=0.0))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_latency_stats_equal_jax():
    ours, theirs = LatencyStats(), JLatencyStats()
    for i, s in enumerate((0.004, 0.001, 0.003, 0.010, 0.002)):
        ours.record(s, batch=i + 1)
        theirs.record(s, batch=i + 1)
    for p in (0, 50, 95, 99, 100):
        assert ours.percentile(p) == theirs.percentile(p)
    a, b = ours.snapshot(), theirs.snapshot()
    assert a.keys() == b.keys() and a["requests"] == 15 and a["qps"] > 0
    assert all(a[k] == b[k] for k in ("batches", "requests", "p50_ms", "p95_ms", "p99_ms"))
    assert np.isnan(LatencyStats().percentile(50)) and LatencyStats().qps == 0.0


# ------------------------------------------------------------------
# the slice end to end: train → export → artifact → serve
# ------------------------------------------------------------------

EXP = dict(n_clients=5, n_per_client=32, rounds=3, tau=1, batch=8, avg_degree=3.0,
           model="mlp", dim=8, n_classes=3)
DATA = dict(n_clients=5, n_clusters=2, n_per_client=32, dim=8, n_classes=3, seed=0,
            noise=0.3)


@pytest.fixture(scope="module")
def kept_run():
    return run_method("fedspd", make_mixture_classification(**DATA), PaperExpConfig(**EXP),
                      cfg=RunConfig(device="cpu", eval_every=100,
                                    options={"keep_state": True}))


def test_train_export_serve_end_to_end(kept_run, tmp_path):
    data = make_mixture_classification(**DATA)
    st = kept_run.extras["state"]
    assert st.centers.shape[:2] == (2, 5) and kept_run.extras["pack_spec"].size == \
        st.centers.shape[2]
    path = str(tmp_path / "servable.npz")
    man = export_run(kept_run, path, codec="int4", qblock=16)
    assert man.n_clients == 5 and man.n_clusters == 2 and man.codec == "int4"
    params, apply, *_ = make_classifier("mlp", torch.Generator(), 8, 3)
    spec = make_pack_spec(params)
    art = load_servable(path, spec, device="cpu")
    server = ClusterPlaneServer.from_artifact(art, spec, apply_fn=apply, device="cpu")
    reset_launch_counts()
    out = server.predict(art.u_table, data.x[:, 0])
    assert out.shape == (5, 3) and bool(torch.isfinite(out).all())
    assert server.n_dispatches == 1 and server.dequant_calls == 1
    assert mixture_mix_dequant4.launches == 0      # CPU tensors: the plain version
    # the JAX server answers the same artifact the same way
    jspec = j_make_pack_spec(j_make_classifier("mlp", jax.random.PRNGKey(0), 8, 3)[0])
    jart = j_load_servable(path, jspec)
    jsrv = JServer.from_artifact(jart, jspec,
                                 apply_fn=j_make_classifier("mlp", jax.random.PRNGKey(0),
                                                            8, 3)[1])
    want = np.asarray(jsrv.predict(jart.u_table, jnp.asarray(data.x[:, 0])))
    np.testing.assert_allclose(out.numpy(), want, atol=TOL, rtol=0)
    with pytest.raises(ValueError, match="pack_digest"):
        ClusterPlaneServer.from_artifact(art, make_pack_spec(
            make_classifier("linear", torch.Generator(), 8, 3)[0]), device="cpu")


def test_export_matches_jax_export_of_the_same_state(kept_run, tmp_path):
    st = kept_run.extras["state"]
    spec = kept_run.extras["pack_spec"]
    jspec = j_make_pack_spec(j_make_classifier("mlp", jax.random.PRNGKey(0), 8, 3)[0])
    jstate = types.SimpleNamespace(centers=jnp.asarray(st.centers.numpy()),
                                   u=jnp.asarray(st.u.numpy()))
    path, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    man = export_servable(st, spec, path, arch="mlp")
    jm = j_export_servable(jstate, jspec, jpath, arch="mlp")
    assert man.to_json() == jm.to_json()
    got, want = load_servable(path, spec, device="cpu"), j_load_servable(jpath, jspec)
    # the mean over N sums in another order in each package
    np.testing.assert_allclose(got.plane.numpy(), want.plane, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.u_table.numpy(), want.u_table)
    assert cluster_plane(st).shape == (2, spec.size)
    with pytest.raises(ValueError, match="pytree engine"):
        cluster_plane(types.SimpleNamespace(centers={"w": st.centers}))


def test_export_without_keep_state_names_it(tmp_path):
    res = run_method("fedspd", make_mixture_classification(**DATA),
                     PaperExpConfig(**dict(EXP, rounds=1)),
                     cfg=RunConfig(device="cpu", eval_every=100))
    assert "state" not in res.extras and "pack_spec" not in res.extras
    with pytest.raises(ValueError, match="keep_state"):
        export_run(res, str(tmp_path / "never.npz"))
    assert not (tmp_path / "never.npz").exists()


def test_personalized_is_u_times_plane_through_views(world):
    _, tsrv = _servers(world, "fp32")
    leaves = tsrv.personalized(world.u)
    flat = torch.as_tensor(world.u) @ torch.as_tensor(world.plane)
    want = unpack(flat, world.tspec)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), leaves)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), want))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------
# the port stands alone
# ------------------------------------------------------------------


def _imports(path: pathlib.Path) -> list:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.append((node.module, node.lineno))
    return out


def test_the_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = [f"{f.relative_to(REPO)}:{line} imports {mod}"
           for f in files for mod, line in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, "\n".join(bad)
