"""PyTorch port, host side: the numpy-only copies, the packed-plane layout,
and the entry points' device and feature refusals (and the features that
were refused until their slice, which now run), held against the JAX
package (JAX on the CPU, the port with device="cpu")."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.core.packing import pack as j_pack
from repro.core.packing import unpack as j_unpack
from repro.data.synthetic import make_mixture_classification as j_data
from repro.graphs.topology import make_graph as j_graph
from repro.models.smallnets import make_classifier as j_classifier
from repro_torch.comm.codecs import CommConfig
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.core.packing import make_pack_spec, pack, unpack
from repro_torch.core.sparse import SparseConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.device import resolve_device
from repro_torch.experiments import RunConfig, run_method, run_method_batch
from repro_torch.graphs.topology import make_graph
from repro_torch.interop import params_from_numpy

SMALL = dict(n_clients=8, n_clusters=2, n_per_client=96, n_classes=4, dim=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kw", [
    SMALL,
    dict(n_clients=5, n_clusters=4, n_per_client=40, n_classes=6, dim=12,
         mode="both", seed=3),
    dict(n_clients=6, n_clusters=2, n_per_client=32, mode="label_split",
         seed=7, noise=0.3),
])
def test_mixture_classification_bit_identical(kw):
    a, b = j_data(**kw), make_mixture_classification(**kw)
    for f in ("x", "y", "z_true", "mix_true", "x_test", "y_test", "z_test"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert (a.n_classes, a.n_clusters) == (b.n_classes, b.n_clusters)


@pytest.mark.parametrize("kind", ["er", "ba", "rgg", "ring", "complete"])
@pytest.mark.parametrize("n,deg,seed", [(8, 3.0, 0), (20, 5.0, 4)])
def test_make_graph_bit_identical(kind, n, deg, seed):
    a, b = j_graph(kind, n, deg, seed=seed), make_graph(kind, n, deg, seed=seed)
    assert a.adj.dtype == b.adj.dtype
    assert np.array_equal(a.adj, b.adj)
    assert b.is_connected() and np.array_equal(b.adj, b.adj.T)


def test_paper_config_copy_matches():
    assert dataclasses.asdict(PaperExpConfig()) == dataclasses.asdict(JExp())


def _jax_mlp(dim=16, n_classes=4, seed=0):
    params, *_ = j_classifier("mlp", jax.random.PRNGKey(seed), dim, n_classes)
    return params


@pytest.mark.parametrize("dim,n_classes,x", [(16, 4, 10692), (64, 10, 17226)])
def test_pack_spec_matches_jax_layout(dim, n_classes, x):
    jp = _jax_mlp(dim, n_classes)
    js = j_make_pack_spec(jp)
    ts = make_pack_spec(params_from_numpy(_np_tree(jp), device="cpu"))
    assert ts.size == js.size == x
    assert ts.offsets == js.offsets
    assert ts.sizes == js.sizes
    assert ts.shapes == js.shapes
    assert ts.model_bytes == js.model_bytes == 4 * x
    # b before w within a layer: jax.tree.flatten sorts dict keys
    assert ts.paths[:2] == (("layer0", "b"), ("layer0", "w"))


def test_pack_unpack_roundtrip_and_views():
    jp = _jax_mlp()
    spec = make_pack_spec(params_from_numpy(_np_tree(jp), device="cpu"))
    rng = np.random.default_rng(0)
    plane = torch.as_tensor(rng.standard_normal((2, 3, spec.size)),
                            dtype=torch.float32)
    tree = unpack(plane, spec)
    assert tree["layer1"]["w"].shape == (2, 3, 128, 64)
    assert torch.equal(pack(tree, spec), plane)
    # unpack returns views: a write through a leaf lands in the plane
    assert tree["layer0"]["w"].data_ptr() == plane[..., 128:].data_ptr()
    tree["layer2"]["b"][1, 2, 0] = 42.0
    assert plane[1, 2, spec.offsets[4]] == 42.0


def test_jax_plane_unpacked_by_port_equals_jax_unpack():
    jp = _jax_mlp()
    js = j_make_pack_spec(jp)
    stacked = jax.tree.map(lambda l: np.stack([l, 2 * l + 1]), jp)
    jplane = np.array(j_pack(stacked, js))
    ts = make_pack_spec(params_from_numpy(_np_tree(jp), device="cpu"))
    got = unpack(torch.as_tensor(jplane), ts)
    want = j_unpack(jplane, js)
    for layer in want:
        for k in want[layer]:
            assert np.array_equal(got[layer][k].numpy(), np.asarray(want[layer][k]))


def test_run_method_without_device_raises_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    data = make_mixture_classification(n_clients=4, n_per_client=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_method("fedspd", data, PaperExpConfig(rounds=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


# what = "comm" / "sparse" / "cohort_size" / "scan_rounds" / "permute" /
# "cos_align", and "param_plane" alone (the pytree engine): a feature
# once refused, which now runs; "ppermute": accepted, and without a
# process group refused as JAX refuses it without its devices; any other (param_plane=False beside a
# codec or sparse masks among them): the refusal's message names it
@pytest.mark.parametrize("cfg,what", [
    (RunConfig(param_plane=False), "param_plane"),
    (RunConfig(gossip_mode="permute"), "permute"),
    (RunConfig(gossip_backend="pallas"), "pallas"),
    (RunConfig(gossip_backend="ppermute"), "ppermute"),
    (RunConfig(comm=CommConfig(codec="int8", error_feedback=True)), "comm"),
    (RunConfig(sparse=SparseConfig(density=0.5, update_every=1)), "sparse"),
    (RunConfig(scenario=object()), "scenario"),
    (RunConfig(cohort_size=4), "cohort_size"),
    (RunConfig(scan_rounds=True), "scan_rounds"),
    (RunConfig(telemetry=object()), "telemetry"),
    (RunConfig(options={"cos_align_threshold": 0.5}), "cos_align"),
    (RunConfig(options={"comm": CommConfig(codec="topk")}), "comm"),
    (RunConfig(sparse=SparseConfig(density=0.5), param_plane=False), "param_plane"),
    (RunConfig(comm=CommConfig(codec="int8"), param_plane=False), "param_plane"),
    (RunConfig(comm=object()), "CommConfig"),
    (RunConfig(sparse=object()), "SparseConfig"),
])
def test_unported_features_are_refused(cfg, what):
    data = make_mixture_classification(n_clients=4, n_per_client=16)
    cfg = dataclasses.replace(cfg, device="cpu")
    if what in ("comm", "sparse"):
        r = run_method("fedspd", data, PaperExpConfig(rounds=2), cfg=cfg)
        assert np.isfinite(r.mean_acc) and 0 < r.wire_bytes < r.comm_bytes
        return
    if what in ("cohort_size", "scan_rounds"):
        r = run_method("fedspd", data, PaperExpConfig(rounds=2), cfg=cfg)
        assert np.isfinite(r.mean_acc) and r.comm_bytes > 0
        assert r.extras["n_captures"] == (what == "scan_rounds")
        return
    if what == "ppermute":
        # accepted since the mesh slice: without a process group it needs
        # one rank a client (tests/test_torch_mesh.py runs it over gloo)
        with pytest.raises(RuntimeError, match="one device per client"):
            run_method("fedspd", data, PaperExpConfig(rounds=1), cfg=cfg)
        return
    pytree = what == "param_plane" and cfg.comm is None and cfg.sparse is None
    if what in ("permute", "cos_align") or pytree:
        r = run_method("fedspd", data, PaperExpConfig(rounds=2), cfg=cfg)
        assert np.isfinite(r.mean_acc) and r.comm_bytes > 0
        return
    with pytest.raises(ValueError, match=what):
        run_method("fedspd", data, PaperExpConfig(rounds=1), cfg=cfg)


@pytest.mark.parametrize("case", ["dfl_fedavg-comm", "fedspd_permute",
                                  "run_method_batch", "cfl_fedem-sparse",
                                  "local-comm-fp32"])
def test_unported_method_ids_are_refused(case):
    """What the slices so far leave out stays refused, naming itself:
    sparse masks on a baseline (the JAX baselines would ignore ``sparse``
    and still charge sparse wire bytes), and per-seed graphs in the
    multi-seed batch driver on a baseline (its step takes no per-round
    adjacency). The permute wiring's id and a wire codec on a baseline,
    refused until their slices, now run (``local`` sends nothing)."""
    data = make_mixture_classification(n_clients=4, n_per_client=16)
    if case in ("dfl_fedavg-comm", "local-comm-fp32"):
        method = case.split("-")[0]
        comm = CommConfig(codec="int8" if method == "dfl_fedavg" else "fp32")
        r = run_method(method, data, PaperExpConfig(rounds=2),
                       cfg=RunConfig(device="cpu", comm=comm))
        assert np.isfinite(r.mean_acc)
        assert (0 < r.wire_bytes < r.comm_bytes) if method == "dfl_fedavg" else \
            (r.wire_bytes == r.comm_bytes == 0.0)
        return
    if case == "fedspd_permute":
        r = run_method("fedspd_permute", data, PaperExpConfig(rounds=2),
                       cfg=RunConfig(device="cpu"))
        assert np.isfinite(r.mean_acc) and r.comm_bytes > 0
        return
    if case == "run_method_batch":
        graphs = [make_graph("er", 4, 2.0, seed=s) for s in (0, 1)]
        with pytest.raises(ValueError, match="dfl_fedavg.*per-seed graphs"):
            run_method_batch("dfl_fedavg", data, PaperExpConfig(rounds=1), seeds=(0, 1),
                             graph=graphs, cfg=RunConfig(device="cpu"))
        return
    with pytest.raises(ValueError, match="sparse.*cfl_fedem"):
        run_method("cfl_fedem", data, PaperExpConfig(rounds=1),
                   cfg=RunConfig(device="cpu", sparse=SparseConfig(density=0.5)))


def test_unknown_method_id_is_a_key_error():
    data = make_mixture_classification(n_clients=4, n_per_client=16)
    with pytest.raises(KeyError, match="fedspd"):
        run_method("no_such_method", data, PaperExpConfig(rounds=1),
                   cfg=RunConfig(device="cpu"))


def test_conv_model_is_refused():
    """The conv classifier, refused until its slice, now runs; a model the
    port does not have is refused, naming itself."""
    data = make_mixture_classification(n_clients=4, n_per_client=16, dim=16)
    r = run_method("fedspd", data, PaperExpConfig(rounds=1, model="conv"),
                   cfg=RunConfig(device="cpu"))
    assert np.isfinite(r.mean_acc) and r.comm_bytes > 0
    with pytest.raises(ValueError, match="cnn2d"):
        run_method("fedspd", data, PaperExpConfig(rounds=1, model="cnn2d"),
                   cfg=RunConfig(device="cpu"))
