"""PyTorch port, the telemetry streams of whole runs, the JSONL event log,
its renderers and the profiler hooks, on the JAX package's
tests/test_telemetry.py setup (N = 6 clients, 32 points, dim 8, 4 rounds),
live beside the JAX package in one process.

- Every stream of the replay (``scan_rounds=True``: on the CPU the
  captured round's closure, called directly) equals the loop's bit for
  bit, and telemetry on leaves ``acc_per_client``, ``u``, ``comm_bytes``,
  ``n_captures`` and ``n_dispatches`` as telemetry off leaves them, on
  both engines, for FedSPD (plain, DP, int8 + error feedback, sparse masks
  in two captured branches, a cohort, the fully composed scenario B),
  the pytree engine and two baselines.
- ``run_method_batch`` gives each seed its own streams, equal to that
  seed's ``run_method``; ``round_metrics=False`` gives None.
- The deterministic streams of a static-graph run under int8 equal JAX's
  run of the same config: bytes (wire bytes too), degree, the staleness
  histogram and the inactive count exactly, the spectral gap's ρ within
  1e-6 relative (every id without a codec: tests/test_torch_telemetry.py).
- One FedSPD round on the injected draws of tests/test_torch_fedspd.py:
  the port's collector on the port's round equals JAX's ``make_collector``
  on JAX's round (``u_entropy``, ``u_drift``, ``consensus`` within 1e-5).
- The pytree engine's real ``consensus`` (the plane run's of the same
  seed), ``local``'s NaN ``u_entropy``.
- The JSONL round trip is exact; JAX's ``summary_table`` and ``main``
  render the port's run and serve logs, as the port's do; the profiler
  hooks write a trace and name their spans.

About 35 s in one CPU process, half of it JAX's compiles.
"""
import contextlib
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_fedspd as tf
import torch
from test_torch_fedspd import world  # noqa: F401  (the injected-draw round's fixture)

from repro.comm.codecs import CommConfig as JCommConfig
from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.core.fedspd import make_round_step as j_make_round_step
from repro.core.fedspd import seeded_init as j_seeded_init
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import make_mix_fn as j_make_mix_fn
from repro.core.packing import pack_state as j_pack_state
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import run_method as j_run_method
from repro.telemetry import TelemetryConfig as JTelemetryConfig
from repro.telemetry import metrics as jm
from repro.telemetry import read_events as j_read_events
from repro.telemetry import summary as j_summary
from repro_torch.comm.codecs import CommConfig
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.fedspd import make_round_step
from repro_torch.core.gossip import GossipSpec, make_mix_fn
from repro_torch.core.sparse import SparseConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import (
    ClientSystemModel,
    RunConfig,
    Scenario,
    TelemetryConfig,
    run_method,
    run_method_batch,
)
from repro_torch.experiments.runner import ROUND_SPAN
from repro_torch.graphs.topology import make_graph
from repro_torch.interop import state_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.telemetry import (
    STREAMS,
    annotate,
    compile_count,
    read_events,
    run_events,
    step_annotation,
    streams_from_events,
    summary,
    trace_session,
    write_events,
    write_run_jsonl,
)
from repro_torch.telemetry import metrics as tm

N, ROUNDS = 6, 4
EXP = dict(n_clients=N, n_per_client=32, rounds=ROUNDS, tau=1, batch=8, avg_degree=3.0,
           model="mlp", dim=8, n_classes=3)
DATA = dict(n_clients=N, n_clusters=2, n_per_client=32, dim=8, n_classes=3, seed=7,
            noise=0.3)
CPU = RunConfig(device="cpu", eval_every=2, options={"keep_state": True})
TEL = TelemetryConfig()
INT8 = CommConfig(codec="int8", error_feedback=True)
HET = dict(slow_fraction=0.34, slow_factor=4.0, time_budget=1.5, jitter=0.3,
           p_unavailable=0.2, staleness_gamma=0.7, seed=11)
PATHS = {
    "fedspd": ("fedspd", {}),
    "fedspd dp": ("fedspd", dict(options={"keep_state": True, "dp_clip": 1.0,
                                          "dp_noise_multiplier": 0.5})),
    "fedspd int8+ef": ("fedspd", dict(comm=INT8)),
    "fedspd sparse": ("fedspd", dict(sparse=SparseConfig(density=0.3, update_every=2))),
    "fedspd cohort 4": ("fedspd", dict(cohort_size=4)),
    "fedspd composed": ("fedspd", dict(
        param_plane=True, cohort_size=4, comm=INT8,
        scenario=Scenario(dropout=0.2, seed=11, system=ClientSystemModel(**HET)))),
    "fedspd pytree dp": ("fedspd", dict(param_plane=False, options={
        "keep_state": True, "dp_clip": 1.0, "dp_noise_multiplier": 0.5})),
    "dfl_fedem pytree": ("dfl_fedem", dict(param_plane=False)),
    "dfl_fedavg int8+ef": ("dfl_fedavg", dict(comm=INT8)),
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


@contextlib.contextmanager
def _jax_least_optimized():
    """JAX compiles with ``jax_disable_most_optimizations`` inside (LLVM at
    -O0), as in tests/test_torch_variants.py; the flag is not part of JAX's
    compile cache key, so the caches are cleared on the way out."""
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", False)
        jax.clear_caches()


def _streams_equal(a: dict, b: dict) -> None:
    assert sorted(a["streams"]) == sorted(b["streams"]) == sorted(STREAMS)
    for name, v in a["streams"].items():
        assert np.array_equal(v, b["streams"][name], equal_nan=True), name


def _training_equal(a, b) -> None:
    """What telemetry must not change: accuracies, u, bytes, counts."""
    assert np.array_equal(a.acc_per_client, b.acc_per_client) and a.curve == b.curve
    assert a.comm_bytes == b.comm_bytes and a.wire_bytes == b.wire_bytes
    if "u" in a.extras:
        assert np.array_equal(a.extras["u"], b.extras["u"])
    for k in ("n_captures", "n_compiles", "n_dispatches"):
        assert a.extras[k] == b.extras[k], k


# --------------------------------------------------------------------------
# the engines
# --------------------------------------------------------------------------


@pytest.mark.parametrize("label", list(PATHS))
def test_streams_equal_on_both_engines_and_leave_training_as_it_was(setup, label):
    data, exp = setup
    method, kw = PATHS[label]
    runs = {}
    for scan in (False, True):
        for tel in (None, TEL):
            cfg = dataclasses.replace(CPU, scan_rounds=scan, telemetry=tel, **kw)
            runs[scan, tel is not None] = run_method(method, data, exp, cfg=cfg)
    for scan in (False, True):
        _training_equal(runs[scan, False], runs[scan, True])
        assert runs[scan, False].telemetry is None
    loop, scan = runs[False, True], runs[True, True]
    assert loop.telemetry["rounds"] == scan.telemetry["rounds"] == ROUNDS
    _streams_equal(loop.telemetry, scan.telemetry)
    assert (loop.extras["n_compiles"], loop.extras["n_dispatches"]) == (0, ROUNDS)
    assert scan.extras["n_compiles"] == scan.extras["n_captures"] \
        == (2 if "sparse" in label else 1)
    assert scan.extras["n_dispatches"] == ROUNDS
    s = loop.telemetry["streams"]
    assert np.array_equal(loop.extras["staleness"], scan.extras["staleness"])
    assert np.all(s["stale_hist"].sum(-1) == N)
    moved = s["logical_bytes"] > 0
    if "int8" in label or "composed" in label:
        # int8 ships fewer bytes on every round that moved any (an
        # all-inactive round, or one whose links all dropped, moves none)
        assert np.all(s["wire_bytes"][moved] < s["logical_bytes"][moved])
        assert not s["wire_bytes"][~moved].any()
    if "composed" in label:
        assert float(s["n_inactive"].sum()) > 0
    else:
        assert moved.all() == (method != "local")
        # no system model: every client active, the all-zero counters
        assert np.array_equal(loop.extras["staleness"], np.zeros(N, np.int32))
        assert not s["n_inactive"].any() and np.all(s["stale_hist"][:, 0] == N)
        assert "staleness" not in runs[False, False].extras
    assert np.isfinite(s["density"]).all() == ("sparse" in label)
    if "sparse" in label:   # RigL updates the masks at round 2 only
        assert s["mask_churn"][2] > 0 and not s["mask_churn"][[0, 1, 3]].any()


@pytest.mark.parametrize("scan", [False, True])
def test_batch_gives_each_seed_its_own_streams(setup, scan):
    data, exp = setup
    cfg = dataclasses.replace(CPU, scan_rounds=scan, telemetry=TEL)
    batch = run_method_batch("fedspd", data, exp, seeds=(0, 1), cfg=cfg)
    # the batch's graph is its first seed's
    graph = make_graph(exp.graph_kind, N, exp.avg_degree, seed=0)
    for seed, r in zip((0, 1), batch):
        _streams_equal(r.telemetry, run_method("fedspd", data, exp, graph=graph, seed=seed,
                                               cfg=cfg).telemetry)
        assert r.telemetry["streams"]["u_entropy"].shape == (ROUNDS,)
        assert r.telemetry["streams"]["consensus"].shape == (ROUNDS, 2)
        assert r.telemetry["streams"]["stale_hist"].shape == (ROUNDS, TEL.staleness_bins)
    assert not np.array_equal(batch[0].telemetry["streams"]["u_drift"],
                              batch[1].telemetry["streams"]["u_drift"])


def test_round_metrics_off_gives_none_and_a_bad_config_raises(setup):
    data, exp = setup
    off = dataclasses.replace(CPU, telemetry=TelemetryConfig(round_metrics=False))
    r = run_method("fedspd", data, exp, cfg=off)
    assert r.telemetry is None and "staleness" not in r.extras
    with pytest.raises(ValueError, match="TelemetryConfig, got object"):
        run_method("fedspd", data, exp, cfg=dataclasses.replace(CPU, telemetry=object()))
    with pytest.raises(ValueError, match="TelemetryConfig, got TelemetryConfig"):
        run_method("fedspd", data, exp,
                   cfg=dataclasses.replace(CPU, telemetry=JTelemetryConfig()))


STATIC = {"dfl_fedavg": "int8"}


@pytest.fixture(scope="module")
def jax_static():
    """JAX's loop run of each STATIC id (on the plane where a codec needs
    it), compiled least optimized: the streams compared depend on the
    config alone."""
    out = {}
    with _jax_least_optimized():
        for method, codec in STATIC.items():
            jkw = {} if codec is None else dict(param_plane=True, comm=JCommConfig(codec=codec))
            out[method] = j_run_method(method, j_data(**DATA), JExp(**EXP), cfg=JRunConfig(
                eval_every=10, telemetry=JTelemetryConfig(), **jkw)).telemetry["streams"]
    return out


@pytest.mark.parametrize("method", list(STATIC))
def test_static_graph_streams_equal_jax_s(setup, jax_static, method):
    """The streams that depend on the config alone, against JAX's run of
    the same config."""
    data, exp = setup
    codec, want = STATIC[method], jax_static[method]
    tkw = {} if codec is None else dict(comm=CommConfig(codec=codec))
    for scan in (False, True):
        got = run_method(method, data, exp, cfg=dataclasses.replace(
            CPU, scan_rounds=scan, telemetry=TEL, **tkw)).telemetry["streams"]
        for name in ("logical_bytes", "wire_bytes", "degree", "stale_hist", "n_inactive"):
            assert np.array_equal(got[name], np.asarray(want[name])), name
        np.testing.assert_allclose(1.0 - got["spectral_gap"],
                                   1.0 - np.asarray(want["spectral_gap"]), rtol=1e-6, atol=0)
    if codec is not None:
        assert np.all(got["wire_bytes"] < got["logical_bytes"])


@pytest.fixture(scope="module")
def jax_round(world):  # noqa: F811
    """On test_torch_fedspd's world: the JAX state entering round 2, its
    round-2 draws, and the JAX state after it (DP off; compiled least
    optimized)."""
    jcfg, tcfg = tf._cfgs("off")
    spec = JSpec.from_graph(world["graph"])
    with _jax_least_optimized():
        step = jax.jit(j_make_round_step(
            world["j_loss"], world["j_pel"], spec, jcfg, pack_spec=world["jps"],
            mix_fn=j_make_mix_fn(spec, "pallas", plane=True)))
        st0 = j_pack_state(j_seeded_init(jax.random.PRNGKey(7), world["j_init"], jcfg,
                                         world["j_loss"], world["jtrain"]), world["jps"])
        st1, _ = step(st0, world["jtrain"])
        draws = tf._round_draws(st1, world["jps"].size, 0.0)
        st2, _ = step(st1, world["jtrain"])
    return world, tcfg, jax.tree.map(np.asarray, st1), draws, jax.tree.map(np.asarray, st2)


def test_collector_on_an_injected_draw_round_equals_jax_s(jax_round):
    world, tcfg, st1, (s, idx, _), st2 = jax_round
    adj = np.asarray(world["graph"].adj, np.float32)
    want = jm.make_collector(JTelemetryConfig(), n_clusters=tf.S, n_clients=tf.N)(
        jax.tree.map(jnp.asarray, st1), jax.tree.map(jnp.asarray, st2), jnp.asarray(adj))
    spec = GossipSpec.from_graph(world["graph"])
    step = make_round_step(world["t_loss"], world["t_pel"], spec, tcfg,
                           pack_spec=world["tps"], mix_fn=make_mix_fn(spec, "cuda"))
    state = state_from_numpy(st1, device="cpu")
    # the runner's snapshot: the step writes the plane in place
    old = types.SimpleNamespace(u=state.u.clone(), comm_bytes=state.comm_bytes.clone())
    new, _ = step(state, world["ttrain"], s=torch.as_tensor(s), idx=torch.as_tensor(idx))
    got = tm.make_collector(TEL, n_clusters=tf.S, n_clients=tf.N)(old, new, torch.as_tensor(adj))
    for name in ("u_entropy", "u_drift", "consensus"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=0, err_msg=name)
    for name in ("logical_bytes", "wire_bytes", "degree", "stale_hist", "n_inactive"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name
    assert float(got["u_drift"]) > 0 and float(got["logical_bytes"]) > 0


def test_pytree_engine_reports_the_plane_s_consensus_and_local_nan_entropy(setup):
    data, exp = setup
    cfg = dataclasses.replace(CPU, telemetry=TEL)
    tree = run_method("fedspd", data, exp, cfg=dataclasses.replace(cfg, param_plane=False))
    plane = run_method("fedspd", data, exp, cfg=cfg)
    c = tree.telemetry["streams"]["consensus"]
    assert c.shape == (ROUNDS, 2) and np.isfinite(c).all() and (c > 0).all()
    # the pytree engine's run of a seed is the plane's (the same numbers,
    # flattened in the plane's leaf order)
    np.testing.assert_allclose(c, plane.telemetry["streams"]["consensus"], rtol=1e-5, atol=0)
    local = run_method("local", data, exp, cfg=dataclasses.replace(cfg, param_plane=False))
    assert np.isnan(local.telemetry["streams"]["u_entropy"]).all()


# --------------------------------------------------------------------------
# the event log and its renderers
# --------------------------------------------------------------------------


def test_jsonl_round_trip_and_both_renderers(setup, tmp_path, capsys):
    data, exp = setup
    r = run_method("fedspd", data, exp,
                   cfg=dataclasses.replace(CPU, scan_rounds=True, telemetry=TEL))
    path = str(tmp_path / "telemetry.jsonl")
    write_run_jsonl(path, r, meta={"seed": 0, "n_clients": N})
    events = read_events(path)
    assert events == j_read_events(path)
    kinds = [e["event"] for e in events]
    assert kinds[0] == "run_meta" and kinds[-1] == "summary" and kinds.count("round") == ROUNDS
    assert events[0]["streams"] == sorted(STREAMS)
    parsed = streams_from_events(events)
    for name, orig in r.telemetry["streams"].items():
        # fp32 -> JSON -> float64 widens exactly
        assert np.array_equal(parsed[name], np.asarray(orig, np.float64), equal_nan=True), name
    assert events[-1]["n_compiles"] == 1 and events[-1]["n_dispatches"] == ROUNDS
    assert events[-1]["mean_acc"] == r.mean_acc
    assert events[-1]["staleness"] == [0] * N
    assert run_events(r, meta={"seed": 0, "n_clients": N}) is not None
    with open(path) as f:
        for line in f:
            json.loads(line)
    port_table, jax_table = summary.summary_table(events), j_summary.summary_table(events)
    assert port_table == jax_table
    for name in STREAMS:
        assert f"| {name} |" in jax_table
    assert "n_compiles=1" in jax_table and f"n_dispatches={ROUNDS}" in jax_table
    assert summary.main([path]) == 0 and j_summary.main([path]) == 0
    printed = capsys.readouterr().out
    assert printed.count("| stream |") == 2 and printed.count("| consensus |") == 2


def test_a_run_without_streams_logs_its_curve(setup, tmp_path):
    data, exp = setup
    r = run_method("fedspd", data, exp, cfg=CPU)
    events = run_events(r)
    rounds = [e for e in events if e["event"] == "round"]
    assert [e["round"] for e in rounds] == [c[0] for c in r.curve]
    assert all("train_acc" in e for e in rounds)
    path = str(tmp_path / "curve.jsonl")
    write_events(path, events)
    assert "train_acc" in j_summary.summary_table(j_read_events(path))


def test_launch_serve_telemetry_and_profile_read_by_jax(tmp_path, capsys):
    out, prof = tmp_path / "serve.jsonl", tmp_path / "prof"
    launch_serve.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--codec", "int8",
                       "--gen", "3", "--batch", "2", "--mixture", "0.6,0.4",
                       "--telemetry-out", str(out), "--profile-dir", str(prof)])
    events = j_read_events(str(out))
    assert [e["event"] for e in events] == ["serve_meta", "serve_batch", "serve_summary"]
    assert events[2]["n_compiles"] == 1 and events[2]["dequant_calls"] == 1
    table = j_summary.summary_table(events)
    assert table == summary.summary_table(read_events(str(out)))
    assert "## telemetry — gemma3-1b" in table and "| int8 | 2 |" in table
    trace = json.loads((prof / "serve_trace.json").read_text())
    assert trace["traceEvents"]
    capsys.readouterr()


# --------------------------------------------------------------------------
# the profiler hooks and the program count
# --------------------------------------------------------------------------


def test_profile_hooks_write_a_trace_and_name_their_spans(setup, tmp_path):
    data, exp = setup
    with trace_session(None) as off:
        assert off is None
    assert not list(tmp_path.iterdir())
    with trace_session(str(tmp_path / "t")) as prof:
        with annotate("repro_torch.test"), step_annotation("repro_torch.step", 3):
            torch.ones(3).sum()
        run_method("local", data, dataclasses.replace(exp, rounds=2), cfg=CPU)
    names = {e.name for e in prof.events()}
    assert {"repro_torch.test", "repro_torch.step#3", ROUND_SPAN} <= names
    assert json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]


def test_compile_count_counts_the_programs_held():
    assert compile_count({}) == 0 and compile_count({None: 1, True: 2}) == 2
    assert compile_count([object()]) == 1
