"""PyTorch port, the baselines' compressed exchange against the JAX package,
live in one process (JAX on the CPU, the port with device="cpu").

- One compressed step of each of the 5 baseline families (FedAvg, FedEM,
  IFCA, FedSoft, pFedMe), ``dfl_`` and ``cfl_``, under int8 + error
  feedback, int4 and top-k + error feedback: from the JAX state after one
  JAX step (its residual non-zero) carried over by ``interop``, with the
  batch indices and the codec's uniform rounding draw made in JAX the way
  the JAX step splits its keys and fed to the port. The JAX steps run on
  the ``"pallas"`` backend in interpret mode (FedAvg and pFedMe under
  int8/int4 through the fused dequantize+mix kernel); the port's wrappers
  take their plain versions on CPU tensors. Planes, centers and ``ef`` at
  1e-5, ``u`` at 1e-6, ``choice`` equal.
- ``wire_bytes`` of ``run_method`` equal to what the JAX driver reports
  (its ``_wire_bytes`` of the logical bytes), exactly, for a ``dfl_`` and
  a ``cfl_`` id.
- ``dfl_fedavg`` and ``dfl_fedem`` under int8 + error feedback over seeds
  0, 1, 2 within max(2 pts, the fp32 runs' seed std) of the port's own
  fp32 runs (the bound of tests/test_comm.py), at lr0 0.5 (10 rounds at
  the paper's 0.05 leave every run at chance, 0.25, where the bound
  tells nothing).
- ``run_method`` under int8 + error feedback on every baseline id (and
  ``local``): ``wire_bytes`` the channel's ratio of ``comm_bytes``,
  ``codec="fp32"`` the uncompressed run bit for bit.
- ``run_method_batch`` over 2 seeds under a codec: each seed equals its
  single ``run_method`` run bit for bit, on the loop and on the replay.
- The replay equals the loop bit for bit under a codec, and the refusals
  that stay: ``sparse`` on a baseline, ``comm`` with ``param_plane=False``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.codecs import CommConfig as JCommConfig
from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments.registry import build_context as j_build_context
from repro.experiments.registry import get_method as j_get_method
from repro.experiments.runner import _wire_bytes as j_wire_bytes
from repro_torch.comm.codecs import CommConfig, WithEF, make_channel
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.sparse import SparseConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import RunConfig, run_method, run_method_batch
from repro_torch.experiments.registry import build_context, get_method
from repro_torch.graphs.topology import make_graph
from repro_torch.interop import baseline_state_from_numpy
from repro_torch.kernels.gossip_mix import KERNELS, reset_launch_counts

FAMILIES = ("fedavg", "fedem", "ifca", "fedsoft", "pfedme")
CODECS = {"int8+ef": ("int8", True), "int4": ("int4", False), "topk+ef": ("topk", True)}
BLOCK = 256   # CommConfig's default
SEEDS = (0, 1, 2)
DATA = dict(n_clients=8, n_clusters=2, n_per_client=96, n_classes=4, dim=16)
EXP = dict(DATA, avg_degree=3.0, tau=2)


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
    """Both packages' data and, per codec, one JAX context (on the Pallas
    backend) and one port context, shared by the cases of that codec; the
    JAX initial state of each family, shared by its cases."""
    jdata, jexp = j_data(**DATA), JExp(**EXP)
    jctx, ctx = {}, {}
    for codec, (name, ef) in CODECS.items():
        jctx[codec] = j_build_context(jdata, jexp, options={
            "param_plane": True, "gossip_backend": "pallas",
            "comm": JCommConfig(codec=name, error_feedback=ef)})
        ctx[codec] = build_context(make_mixture_classification(**DATA),
                                   PaperExpConfig(**EXP), torch.device("cpu"),
                                   options={"comm": CommConfig(codec=name, error_feedback=ef)})
    return dict(jdata=jdata, jexp=jexp, jctx=jctx, ctx=ctx, init={})


# --------------------------------------------------------------------------
# the JAX step's draws
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1, 2))
def _client_randint(keys, batch: int, m: int):
    """One randint of ``(batch,)`` in [0, m) per key: a client's batch."""
    return jax.vmap(lambda kk: jax.random.randint(kk, (batch,), 0, m))(keys)


def _uniform_idx(key, steps: int, n: int, m: int, batch: int) -> np.ndarray:
    """``local_sgd``'s draws: ``split(key, steps)``, then per step
    ``client_uniform_batches`` (``split(k, n)``, one randint per client).
    Returns ``(steps, n, batch)``."""
    return np.stack([np.asarray(_client_randint(jax.random.split(k, n), batch, m))
                     for k in jax.random.split(key, steps)])


def _batch_idx(family: str, key, exp: JExp) -> np.ndarray:
    n, m, b, tau = exp.n_clients, exp.n_per_client, exp.batch, exp.tau
    if family == "fedem":
        # split(key, S), per cluster split(k, τ), per step randint(split(kk)[0])
        return np.asarray([[np.asarray(jax.random.randint(jax.random.split(kk)[0],
                                                          (n, b), 0, m))
                            for kk in jax.random.split(k, tau)]
                           for k in jax.random.split(key, exp.n_clusters)])
    if family == "pfedme":
        # outer split(key, τ), then the inner solve's split(kk, k_inner)
        return np.stack([_uniform_idx(kk, 5, n, m, b) for kk in jax.random.split(key, tau)])
    return _uniform_idx(key, tau, n, m, b)


def _compiled(step, *args):
    """``jax.jit(step)`` compiled for ``args`` at LLVM's optimization level
    0: XLA's HLO passes (the fusions) run as they do by default, and the
    30 compiles of these cases take a third less time."""
    return jax.jit(step).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _fields(state) -> dict:
    """A state's tensors by field name (a bare plane as "plane")."""
    if not isinstance(state, tuple):
        return {"plane": np.asarray(state)}
    return {f: np.asarray(getattr(state, f)) for f in state._fields
            if getattr(state, f) is not None}


# --------------------------------------------------------------------------
# one compressed step per family and variant
# --------------------------------------------------------------------------


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("variant", ["dfl", "cfl"])
@pytest.mark.parametrize("family", FAMILIES)
def test_one_compressed_step_matches_jax_with_injected_draws(world, family, variant, codec):
    name, ef = CODECS[codec]
    method = f"{variant}_{family}"
    jexp, jctx, cctx = world["jexp"], world["jctx"][codec], world["ctx"][codec]
    jm, m = j_get_method(method), get_method(method)
    lr = np.float32(0.05 * 0.98 ** 3)
    if family not in world["init"]:
        # with a residual (every codec's ef starts as zeros of one shape)
        world["init"][family] = jm.init(world["jctx"]["int8+ef"], jax.random.PRNGKey(7))
    st1 = world["init"][family]
    if not ef:
        st1 = st1.x if family == "fedavg" else st1._replace(ef=None)
    # FedSoft's y is both stored and encoded: under jit, XLA's fusion can
    # leave the y it encodes an ulp from the y it stores, and int4 rounds
    # its scales through fp16, where that ulp can round one scale the other
    # way and move a whole block's quanta. Op by op, there is one y.
    eager = name == "int4" and family == "fedsoft"
    args = (jctx.train, jax.random.PRNGKey(1), jnp.float32(lr))
    jstep = jm.make_step(jctx) if eager else _compiled(jm.make_step(jctx), st1, *args)
    if ef:
        # one JAX step first, so the residual entering is non-zero
        st1, _ = jstep(st1, *args)
    key = jax.random.PRNGKey(2)
    st2, _ = jstep(st1, jctx.train, key, jnp.float32(lr))
    # the step's split: (local key, codec key)
    k_local, k_comm = jax.random.split(key)
    idx = torch.as_tensor(_batch_idx(family, k_local, jexp))
    comm_u = None
    if name != "topk":
        x = cctx.pack_spec.size
        prefix = (jexp.n_clusters,) if family == "fedem" else ()
        comm_u = torch.as_tensor(np.array(jax.random.uniform(
            k_comm, prefix + (jexp.n_clients, -(-x // BLOCK), BLOCK), jnp.float32)))

    state = baseline_state_from_numpy(jax.tree.map(np.asarray, st1), device="cpu")
    own = m.init(cctx, torch.Generator().manual_seed(0))
    assert type(own).__name__ == type(state).__name__
    assert {k: v.shape for k, v in _fields(own).items()} == \
        {k: v.shape for k, v in _fields(state).items()}
    reset_launch_counts()
    new, _ = m.make_step(cctx)(state, cctx.train, None, float(lr), idx=idx, comm_u=comm_u)
    assert all(k.launches == 0 for k in KERNELS)

    want, got = _fields(st2), _fields(new)
    assert sorted(got) == sorted(want)
    assert ("ef" in got) == ef
    if "choice" in want:
        assert np.array_equal(got["choice"], want["choice"])
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6 if k == "u" else 1e-5,
                                   rtol=0, err_msg=k)


def test_interop_carries_the_residual_and_refuses_a_mismatched_one(world):
    jctx = j_build_context(world["jdata"], world["jexp"], options={
        "param_plane": True, "comm": JCommConfig(codec="int8", error_feedback=True)})
    st = jax.tree.map(np.asarray, j_get_method("dfl_fedavg").init(jctx, jax.random.PRNGKey(0)))
    got = baseline_state_from_numpy(st, device="cpu")
    assert isinstance(got, WithEF) and got.ef.shape == got.x.shape
    with pytest.raises(ValueError, match="residual"):
        baseline_state_from_numpy(st._replace(ef=st.ef[:, :5]), device="cpu")
    fedem = jax.tree.map(np.asarray, j_get_method("dfl_fedem").init(jctx, jax.random.PRNGKey(0)))
    assert baseline_state_from_numpy(fedem, device="cpu").ef.shape == fedem.centers.shape
    with pytest.raises(ValueError, match="residual"):
        baseline_state_from_numpy(fedem._replace(ef=fedem.ef[0]), device="cpu")


# --------------------------------------------------------------------------
# whole runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["dfl_fedavg", "cfl_fedem"])
def test_wire_bytes_equal_jax_exactly(world, method):
    """The port's ``run_method`` against what the JAX driver's
    ``_result`` reports for the same configuration: the static per-round
    bytes × rounds, and ``_wire_bytes`` of them."""
    rounds, comm = 2, dict(codec="int8", error_feedback=True)
    jexp = JExp(**dict(EXP, rounds=rounds))
    jctx = j_build_context(world["jdata"], jexp, options={
        "param_plane": True, "comm": JCommConfig(**comm)})
    jm = j_get_method(method)
    jm._channel(jctx)   # the driver's make_step resolves the channel first
    logical = jm.comm_model(jctx).per_round_bytes * rounds
    got = run_method(method, make_mixture_classification(**DATA),
                     PaperExpConfig(**dict(EXP, rounds=rounds)),
                     cfg=RunConfig(device="cpu", eval_every=10**9, comm=CommConfig(**comm)))
    assert got.comm_bytes == logical
    assert got.wire_bytes == j_wire_bytes(jctx, logical) < got.comm_bytes
    assert np.isfinite(got.mean_acc)


@pytest.mark.parametrize("method", ["dfl_fedavg", "dfl_fedem"])
def test_int8_ef_runs_match_the_fp32_runs_within_the_seed_bound(method):
    exp = PaperExpConfig(**dict(EXP, rounds=10, tau=5, lr0=0.5))
    data = make_mixture_classification(**DATA)
    graph = make_graph(exp.graph_kind, exp.n_clients, exp.avg_degree, seed=SEEDS[0])
    acc = {}
    for label, comm in (("fp32", None), ("int8+ef", CommConfig(codec="int8",
                                                               error_feedback=True))):
        acc[label] = np.array([run_method(method, data, exp, graph=graph, seed=s,
                                          cfg=RunConfig(device="cpu", eval_every=10**9,
                                                        comm=comm)).mean_acc
                               for s in SEEDS])
    tol = max(0.02, float(np.std(acc["fp32"])))
    assert abs(acc["fp32"].mean() - acc["int8+ef"].mean()) <= tol, (acc, tol)


@pytest.mark.parametrize("method,codec", [("dfl_fedavg", "int8"), ("dfl_fedem", "topk"),
                                          ("cfl_pfedme", "int4"), ("dfl_ifca", "int8")])
def test_replay_equals_the_loop_under_a_codec(method, codec):
    data = make_mixture_classification(**DATA)
    exp = PaperExpConfig(**dict(EXP, rounds=3))
    runs = [run_method(method, data, exp, cfg=RunConfig(
        device="cpu", scan_rounds=scan, options={"keep_state": True},
        comm=CommConfig(codec=codec, error_feedback=codec != "int4"))) for scan in (False, True)]
    loop, scan = runs
    assert scan.extras["n_captures"] == 1 and loop.extras["n_captures"] == 0
    assert np.array_equal(loop.acc_per_client, scan.acc_per_client)
    assert loop.wire_bytes == scan.wire_bytes and loop.curve == scan.curve
    a, b = _fields(loop.extras["state"]), _fields(scan.extras["state"])
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("scan", [False, True], ids=["loop", "replay"])
@pytest.mark.parametrize("method,codec", [("dfl_fedavg", "int8"), ("cfl_fedem", "topk")])
def test_run_method_batch_equals_each_single_run_under_a_codec(method, codec, scan):
    """``run_method_batch`` over 2 seeds under a codec with error feedback:
    each seed's result equals its own ``run_method`` run on the batch's
    graph, bit for bit, on either engine (each seed carries its own
    residual and rounding draws)."""
    data = make_mixture_classification(**DATA)
    exp = PaperExpConfig(**dict(EXP, rounds=3))
    graph = make_graph(exp.graph_kind, exp.n_clients, exp.avg_degree, seed=0)
    cfg = RunConfig(device="cpu", scan_rounds=scan, options={"keep_state": True},
                    comm=CommConfig(codec=codec, error_feedback=True))
    batch = run_method_batch(method, data, exp, seeds=(0, 1), graph=graph, cfg=cfg)
    assert len(batch) == 2
    for seed, got in zip((0, 1), batch):
        one = run_method(method, data, exp, graph=graph, seed=seed, cfg=cfg)
        assert np.array_equal(got.acc_per_client, one.acc_per_client)
        assert got.wire_bytes == one.wire_bytes < got.comm_bytes == one.comm_bytes
        assert got.curve == one.curve
        a, b = _fields(got.extras["state"]), _fields(one.extras["state"])
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
        assert np.any(a["ef"] != 0)


@pytest.mark.parametrize("method", ["local"] + [f"{v}_{f}" for f in FAMILIES
                                                for v in ("dfl", "cfl")])
def test_run_method_takes_int8_ef_on_every_baseline_id(method):
    """``run_method`` under int8 + error feedback on every baseline id:
    ``wire_bytes`` the channel's static ratio of ``comm_bytes``; and
    ``codec="fp32"`` is no channel (the uncompressed run, bit for bit).
    ``local`` exchanges nothing: its run is the uncompressed one."""
    data = make_mixture_classification(**DATA)
    exp = PaperExpConfig(**dict(EXP, rounds=2))
    plain, fp32, int8 = (run_method(method, data, exp, cfg=RunConfig(
        device="cpu", eval_every=10**9, comm=comm)) for comm in (
            None, CommConfig(), CommConfig(codec="int8", error_feedback=True)))
    assert np.array_equal(plain.acc_per_client, fp32.acc_per_client)
    assert fp32.wire_bytes == fp32.comm_bytes == int8.comm_bytes
    spec = build_context(data, exp, torch.device("cpu")).pack_spec
    ratio = make_channel(CommConfig(codec="int8"), spec.size).wire_ratio(spec.model_bytes)
    assert int8.wire_bytes == int8.comm_bytes * ratio
    assert np.isfinite(int8.mean_acc) and 0.0 <= int8.mean_acc <= 1.0
    if method == "local":
        assert np.array_equal(plain.acc_per_client, int8.acc_per_client)
        assert int8.wire_bytes == 0.0


@pytest.mark.parametrize("cfg,what", [
    (RunConfig(sparse=SparseConfig(density=0.5)), "sparse.*dfl_fedsoft"),
    (RunConfig(comm=CommConfig(codec="int8"), param_plane=False), "param_plane"),
])
def test_the_refusals_that_stay(cfg, what):
    with pytest.raises(ValueError, match=what):
        run_method("dfl_fedsoft", make_mixture_classification(**DATA),
                   PaperExpConfig(**dict(EXP, rounds=1)),
                   cfg=dataclasses.replace(cfg, device="cpu"))
