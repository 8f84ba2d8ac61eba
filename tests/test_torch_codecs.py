"""PyTorch port, wire codecs (comm/codecs.py) against the JAX package:
nearest and stochastic quantization (with the uniform draw injected from
JAX's own key) bit for bit, int4 nibble packing, the serialized wire
image byte for byte with its size contract, topk with JAX's tie order,
error feedback (its telescoping sum, ``encode_stream``'s ``need_hat``),
``exchange``, and one dense FedSPD round with an int8, int4 or topk codec
and error feedback (and int8 under DP) against the JAX round step at
1e-5, with the draws taken from the JAX step's own key splits."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as J
from repro.core.fedspd import FedSPDConfig as JCfg
from repro.core.fedspd import make_round_step as j_make_round_step
from repro.core.fedspd import seeded_init as j_seeded_init
from repro.core.fedspd import select_clusters as j_select
from repro.core.gossip import GossipSpec as JSpec
from repro.core.gossip import make_mix_fn as j_make_mix_fn
from repro.core.packing import make_pack_spec as j_make_pack_spec
from repro.core.packing import pack_state as j_pack_state
from repro.data.pipeline import sample_cluster_batch_indices
from repro.data.synthetic import make_mixture_classification as j_data
from repro.graphs.topology import make_graph as j_graph
from repro.models.smallnets import make_classifier as j_classifier
from repro_torch.comm import codecs as T
from repro_torch.core.fedspd import FedSPDConfig, make_round_step
from repro_torch.core.gossip import GossipSpec, make_mix_fn
from repro_torch.core.packing import make_pack_spec
from repro_torch.interop import params_from_numpy, state_from_numpy
from repro_torch.kernels.gossip_mix import KERNELS, reset_launch_counts
from repro_torch.models.smallnets import make_classifier


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the test workers share the host's
    cores, and torch's default thread count in each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (codec, block, S, X): the paper-scale mlp's width with the serving and
# gossip blocks, and small widths that are not a multiple of the block
CASES = [("int8", 64, 2, 17226), ("int8", 256, 2, 17226), ("int4", 64, 2, 17226),
         ("int8", 16, 3, 1001), ("int4", 16, 3, 1001), ("int4", 10, 4, 37)]


def _plane(s, x, seed=0):
    rng = np.random.default_rng(seed)
    return (0.05 * rng.standard_normal((s, x))).astype(np.float32)


def _channels(codec, block, x):
    return (J.Channel(J.CommConfig(codec=codec, block=block), x),
            T.Channel(T.CommConfig(codec=codec, block=block), x))


@pytest.mark.parametrize("codec,block,s,x", CASES)
def test_nearest_encode_and_wire_bytes_equal_jax(codec, block, s, x):
    plane = _plane(s, x)
    jc, tc = _channels(codec, block, x)
    je = jc.encode(jnp.asarray(plane), jax.random.PRNGKey(0), rounding="nearest")
    te = tc.encode(torch.as_tensor(plane), rounding="nearest")
    assert np.array_equal(te["q"].numpy(), np.asarray(je["q"]))
    assert np.array_equal(te["scale"].numpy(), np.asarray(je["scale"]))
    assert te["q"].dtype == torch.int8 and te["scale"].dtype == torch.float32
    wire = tc.serialize_payload(te)
    assert wire == jc.serialize_payload(je)
    assert len(wire) == s * tc.wire_model_bytes == s * jc.wire_model_bytes
    assert tc.scale_bytes == jc.scale_bytes
    np.testing.assert_array_equal(tc.decode(te).numpy(), np.asarray(jc.decode(je)))


@pytest.mark.parametrize("codec,block,s,x", CASES[3:])
def test_stochastic_encode_with_jax_draw_equals_jax(codec, block, s, x):
    plane = _plane(s, x, seed=1)
    jc, tc = _channels(codec, block, x)
    key = jax.random.PRNGKey(7)
    nq = -(-x // block)
    # the draw JAX's quant_encode makes from this key, injected into the port
    u = np.array(jax.random.uniform(key, (s, nq, block), jnp.float32))
    je = jc.encode(jnp.asarray(plane), key)
    te = tc.encode(torch.as_tensor(plane), torch.as_tensor(u))
    assert np.array_equal(te["q"].numpy(), np.asarray(je["q"]))
    assert np.array_equal(te["scale"].numpy(), np.asarray(je["scale"]))


def test_stochastic_encode_with_a_generator_rounds_to_a_neighbour():
    plane = torch.as_tensor(_plane(3, 1001, seed=2))
    ch = T.Channel(T.CommConfig(codec="int8", block=16), 1001)
    a = ch.encode(plane, torch.Generator().manual_seed(3))
    b = ch.encode(plane, torch.Generator().manual_seed(3))
    assert torch.equal(a["q"], b["q"])
    near = ch.encode(plane, rounding="nearest")
    assert int((a["q"].int() - near["q"].int()).abs().max()) <= 1
    y = plane / a["scale"].repeat_interleave(16, dim=1)[:, :1001]
    q = a["q"][:, :1001].float()
    assert bool(((q >= torch.floor(y) - 1e-6) & (q <= torch.ceil(y) + 1e-6)).all())
    with pytest.raises(ValueError, match="key"):
        ch.encode(plane)


@pytest.mark.parametrize("width", [1, 2, 7, 64, 1001])
def test_int4_pack_unpack_equal_jax(width):
    rng = np.random.default_rng(width)
    q = rng.integers(-8, 8, (3, width)).astype(np.int8)
    packed = T.int4_pack(torch.as_tensor(q))
    want = np.asarray(J.int4_pack(jnp.asarray(q)))
    assert packed.dtype == torch.uint8 and np.array_equal(packed.numpy(), want)
    back = T.int4_unpack(packed, width)
    assert np.array_equal(back.numpy(), q)
    assert np.array_equal(back.numpy(), np.asarray(J.int4_unpack(jnp.asarray(want), width)))


@pytest.mark.parametrize("codec,block,s,x", CASES[3:])
def test_wire_images_deserialize_across_packages(codec, block, s, x):
    plane = _plane(s, x, seed=4)
    jc, tc = _channels(codec, block, x)
    je = jc.encode(jnp.asarray(plane), None, rounding="nearest")
    te = tc.encode(torch.as_tensor(plane), rounding="nearest")
    from_jax = tc.deserialize_payload(jc.serialize_payload(je), batch_prefix=(s,))
    from_port = jc.deserialize_payload(tc.serialize_payload(te), batch_prefix=(s,))
    for enc in (from_jax, {k: torch.as_tensor(np.asarray(v)) for k, v in from_port.items()}):
        assert np.array_equal(enc["q"].numpy(), np.asarray(je["q"]))
        assert np.array_equal(enc["scale"].numpy(), np.asarray(je["scale"]))
    with pytest.raises(ValueError, match="bytes"):
        tc.deserialize_payload(tc.serialize_payload(te)[:-1], batch_prefix=(s,))


@pytest.mark.parametrize("codec", ["fp32", "int8", "int4", "topk"])
def test_wire_model_bytes_equal_jax(codec):
    for x in (1, 37, 17226):
        jc, tc = _channels(codec, 64, x)
        assert tc.wire_model_bytes == jc.wire_model_bytes
        assert tc.wire_ratio(4 * x) == jc.wire_ratio(4 * x)


def test_fp32_has_no_encoded_form_or_wire_format():
    ch = T.Channel(T.CommConfig(), 10)
    with pytest.raises(ValueError, match="no encoded form"):
        ch.encode(torch.zeros(2, 10), rounding="nearest")
    with pytest.raises(ValueError, match="wire format"):
        ch.serialize_payload({"q": torch.zeros(2, 10), "scale": torch.zeros(2, 1)})
    with pytest.raises(ValueError, match="unknown codec"):
        T.CommConfig(codec="zip")
    with pytest.raises(ValueError, match="rounding"):
        T.quant_encode(torch.zeros(2, 10), bits=8, block=4, rounding="up")
    with pytest.raises(ValueError, match="k must be positive"):
        T.CommConfig(codec="topk", k=0)
    assert T.make_channel(T.CommConfig(), 10) is None and T.make_channel(None, 10) is None
    assert J.make_channel(J.CommConfig(), 10) is None


def _np(v):
    """A codec result as nested numpy / Python values, for comparison."""
    if v is None or isinstance(v, (int, float, bool, str)):
        return v
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, dict):
        return {k: _np(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_np(x) for x in v)
    if dataclasses.is_dataclass(v):
        return _np(dataclasses.astuple(v))
    if isinstance(v, (J.Channel, T.Channel)):
        return _np((v.cfg, v.x, v.wire_model_bytes, v.fused, v.has_ef, v.k))
    return np.asarray(v)


def _equal(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


_VEC = np.array([[0.5, -2.0, 2.0, 0.1, -0.5, 2.0, 0.0, 1.0],
                 [1.0, 1.0, -1.0, 1.0, 0.0, 0.0, -3.0, 0.2]], np.float32)


def _arr(m, a):
    return torch.as_tensor(a) if m is T else jnp.asarray(a)


def _ef_channel(m, codec="int8"):
    return m.make_channel(m.CommConfig(codec=codec, error_feedback=True), 8)


def _residual(m):
    ch = m.Channel(m.CommConfig(codec="int8", error_feedback=True), 8)
    return ch.init_residual((2,), device="cpu") if m is T else ch.init_residual((2,))


@pytest.mark.parametrize("call,what", [
    (lambda m: m.CommConfig(codec="topk"), "topk"),
    (lambda m: m.CommConfig(codec="int8", k=4), "top-k"),
    (lambda m: m.CommConfig(codec="int8", error_feedback=True), "error_feedback"),
    (lambda m: m.topk_encode(_arr(m, _VEC), 2), "topk_encode"),
    (lambda m: m.make_channel(m.CommConfig(codec="int8"), 8), "make_channel"),
    (lambda m: m.sparse_wire_model_bytes(m.CommConfig(codec="int8"), 8, 4),
     "sparse_wire_model_bytes"),
    (lambda m: m.exchange(None, _arr(m, _VEC), lambda x: 2 * x, None, None), "exchange"),
    (lambda m: m.split_ef(m.WithEF(_arr(m, _VEC), _arr(m, -_VEC)), _ef_channel(m)),
     "split_ef"),
    (lambda m: m.join_ef(_arr(m, _VEC), _arr(m, -_VEC), _ef_channel(m)), "join_ef"),
    (_residual, "init_residual"),
    (lambda m: _ef_channel(m, "topk").encode_stream(_arr(m, _VEC), None,
                                                    _arr(m, 0.1 * _VEC)),
     "encode_stream"),
])
def test_codec_features_of_the_comm_slice_are_refused(call, what):
    """Refused until the comm slice; each now runs, equal to the JAX
    package's result."""
    got, want = call(T), call(J)
    assert _equal(got, want), what


@pytest.mark.parametrize("k", [1, 3, 9, 16])
@pytest.mark.parametrize("shape", [(40,), (3, 40), (2, 3, 17)])
def test_topk_encode_decode_equal_jax(shape, k):
    rng = np.random.default_rng(len(shape) * 100 + k)
    x = rng.integers(-3, 4, shape).astype(np.float32)   # many tied magnitudes
    x[..., 0] = 0.25
    want = J.topk_encode(jnp.asarray(x), k)
    got = T.topk_encode(torch.as_tensor(x), k)
    assert got["i"].dtype == torch.int32 and _equal(got, want)
    dec = T.topk_decode(got, x_width=shape[-1])
    assert np.array_equal(dec.numpy(), np.asarray(J.topk_decode(want, x_width=shape[-1])))


@pytest.mark.parametrize("codec", ["int8", "int4", "topk"])
def test_error_feedback_telescopes_and_equals_jax(codec):
    """Σ_t decode_t = Σ_t x_t − e_T: what EF defers reaches the receivers
    later; the port's residual stream equals JAX's under the same draws."""
    n, x, block, rounds = 3, 300, 64, 4
    jch = J.make_channel(J.CommConfig(codec=codec, block=block, error_feedback=True), x)
    tch = T.make_channel(T.CommConfig(codec=codec, block=block, error_feedback=True), x)
    rng = np.random.default_rng(0)
    j_ef, t_ef = jch.init_residual((n,)), tch.init_residual((n,), device="cpu")
    sent, got = np.zeros((n, x), np.float32), np.zeros((n, x), np.float64)
    for r in range(rounds):
        msg = (0.05 * rng.standard_normal((n, x))).astype(np.float32)
        key = jax.random.PRNGKey(r)
        u = torch.as_tensor(np.array(jax.random.uniform(key, (n, -(-x // block), block))))
        j_hat, j_ef = jch.roundtrip(jnp.asarray(msg), key, j_ef)
        t_hat, t_ef = tch.roundtrip(torch.as_tensor(msg), u, t_ef)
        np.testing.assert_allclose(t_hat.numpy(), np.asarray(j_hat), atol=1e-6, rtol=0)
        np.testing.assert_allclose(t_ef.numpy(), np.asarray(j_ef), atol=1e-6, rtol=0)
        sent += msg
        got += t_hat.numpy()
    np.testing.assert_allclose(got, sent - t_ef.numpy(), atol=1e-5, rtol=0)


def test_encode_stream_decodes_only_when_needed():
    x = torch.as_tensor(_VEC)
    plain = T.make_channel(T.CommConfig(codec="int8", block=4), 8)
    enc, hat, ef = plain.encode_stream(x, torch.full((2, 2, 4), 0.5), None)
    assert hat is None and ef is None and enc["q"].shape == (2, 8)
    enc2, hat, ef = plain.encode_stream(x, torch.full((2, 2, 4), 0.5), None, need_hat=True)
    assert torch.equal(enc2["q"], enc["q"]) and torch.equal(hat, plain.decode(enc))
    assert ef is None
    with_ef = T.make_channel(T.CommConfig(codec="int8", block=4, error_feedback=True), 8)
    e0 = torch.full((2, 8), 0.01)
    enc, hat, ef = with_ef.encode_stream(x, torch.full((2, 2, 4), 0.5), e0)
    assert torch.equal(hat, with_ef.decode(enc)) and torch.equal(ef, x + e0 - hat)
    out, ef2 = T.exchange(with_ef, x, lambda v: 3 * v, torch.full((2, 2, 4), 0.5), e0)
    assert torch.equal(out, 3 * hat) and torch.equal(ef2, ef)


# ------------------------------------------- one dense round with a codec

N, S, DIM, C, M, BATCH, TAU = 8, 2, 16, 4, 96, 32, 5
# case: (codec, dp_clip, dp_noise_multiplier)
COMM_ROUNDS = {"int8-ef": ("int8", 0.0, 0.0), "int4-ef": ("int4", 0.0, 0.0),
               "topk-ef": ("topk", 0.0, 0.0), "int8-ef-dp": ("int8", 1.0, 0.5)}


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
    jcfg = JCfg(n_clients=N, n_clusters=S, batch=BATCH)
    st0 = j_pack_state(jax.jit(lambda k: j_seeded_init(k, j_init, jcfg, j_loss, jtrain))(
        jax.random.PRNGKey(7)), jps)
    return dict(graph=graph, j_loss=j_loss, j_pel=j_pel, jps=jps, t_loss=t_loss,
                t_pel=t_pel, tps=tps, jtrain=jtrain, st0=st0,
                ttrain={"inputs": torch.as_tensor(data.x),
                        "targets": torch.as_tensor(data.y)})


@pytest.mark.parametrize("case", list(COMM_ROUNDS))
def test_dense_comm_round_matches_jax_with_injected_draws(world, case):
    codec, clip, mult = COMM_ROUNDS[case]
    kw = dict(n_clients=N, n_clusters=S, tau=TAU, batch=BATCH, dp_clip=clip,
              dp_noise_multiplier=mult)
    jcomm = J.CommConfig(codec=codec, error_feedback=True)
    jspec = JSpec.from_graph(world["graph"])
    jstep = jax.jit(j_make_round_step(
        world["j_loss"], world["j_pel"], jspec, JCfg(**kw), pack_spec=world["jps"],
        mix_fn=j_make_mix_fn(jspec, "pallas", plane=True, comm=jcomm), comm=jcomm))
    x = world["jps"].size
    st1, _ = jstep(world["st0"]._replace(ef=jnp.zeros((N, x), jnp.float32)), world["jtrain"])
    # the round's draws, split as core/fedspd.step_full_packed splits them
    key, k_sel, k_local = jax.random.split(st1.key, 3)
    s = j_select(k_sel, st1.u)
    idx = jnp.stack([jax.vmap(
        lambda kk, zi, si: sample_cluster_batch_indices(kk, zi, si, BATCH)
    )(jax.random.split(k, N), st1.z, s) for k in jax.random.split(k_local, TAU)])
    _, k_dp, k_comm = jax.random.split(key, 3)
    draws = {"s": s, "idx": idx}
    if clip * mult > 0:
        draws["noise"] = jax.random.normal(k_dp, (N, x), jnp.float32)
    if codec != "topk":
        draws["comm_u"] = jax.random.uniform(k_comm, (N, -(-x // 256), 256), jnp.float32)
    st2, _ = jstep(st1, world["jtrain"])
    st1, st2 = jax.tree.map(np.asarray, st1), jax.tree.map(np.asarray, st2)

    tspec = GossipSpec.from_graph(world["graph"])
    tcomm = T.CommConfig(codec=codec, error_feedback=True)
    step = make_round_step(world["t_loss"], world["t_pel"], tspec, FedSPDConfig(**kw),
                           pack_spec=world["tps"], mix_fn=make_mix_fn(tspec, comm=tcomm),
                           comm=tcomm)
    reset_launch_counts()
    got, _ = step(state_from_numpy(st1, device="cpu"), world["ttrain"],
                  **{k: torch.as_tensor(np.array(v)) for k, v in draws.items()})
    np.testing.assert_allclose(got.centers.numpy(), st2.centers, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.u.numpy(), st2.u, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.ef.numpy(), st2.ef, atol=1e-5, rtol=0)
    assert float(got.comm_bytes) == float(st2.comm_bytes)
    assert got.mask is None and all(k.launches == 0 for k in KERNELS)


def test_round_step_refuses_a_mix_for_another_codec(world):
    spec = GossipSpec.from_graph(world["graph"])
    cfg = FedSPDConfig(n_clients=N, n_clusters=S)
    int8 = T.CommConfig(codec="int8")
    for mix, comm in ((make_mix_fn(spec), int8), (make_mix_fn(spec, comm=int8), None)):
        with pytest.raises(ValueError, match="make_mix_fn"):
            make_round_step(world["t_loss"], world["t_pel"], spec, cfg,
                            pack_spec=world["tps"], mix_fn=mix, comm=comm)
    fp32 = make_round_step(world["t_loss"], world["t_pel"], spec, cfg, pack_spec=world["tps"],
                           mix_fn=make_mix_fn(spec), comm=T.CommConfig())
    assert callable(fp32)
