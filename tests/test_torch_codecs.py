"""PyTorch port, wire codecs (comm/codecs.py, the plane-shipping subset)
against the JAX package: nearest and stochastic quantization (with the
uniform draw injected from JAX's own key) bit for bit, int4 nibble
packing, the serialized wire image byte for byte with its size contract,
and the refusal of the codec features that wait for the comm slice."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import codecs as J
from repro_torch.comm import codecs as T

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


@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
def test_wire_model_bytes_equal_jax(codec):
    for x in (1, 37, 17226):
        jc, tc = _channels(codec, 64, x)
        assert tc.wire_model_bytes == jc.wire_model_bytes


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


@pytest.mark.parametrize("call,what", [
    (lambda: T.CommConfig(codec="topk"), "topk"),
    (lambda: T.CommConfig(codec="int8", k=4), "top-k"),
    (lambda: T.CommConfig(codec="int8", error_feedback=True), "error_feedback"),
    (lambda: T.topk_encode(torch.zeros(4), 2), "topk_encode"),
    (lambda: T.make_channel(T.CommConfig(codec="int8"), 8), "make_channel"),
    (lambda: T.sparse_wire_model_bytes(T.CommConfig(codec="int8"), 8, 4),
     "sparse_wire_model_bytes"),
    (lambda: T.exchange(None, torch.zeros(2, 8), None, None, None), "exchange"),
    (lambda: T.split_ef(None, None), "split_ef"),
    (lambda: T.join_ef(None, None, None), "join_ef"),
    (lambda: T.Channel(T.CommConfig(codec="int8"), 8).init_residual((2,)), "init_residual"),
    (lambda: T.Channel(T.CommConfig(codec="int8"), 8).encode_stream(None, None, None),
     "encode_stream"),
])
def test_codec_features_of_the_comm_slice_are_refused(call, what):
    with pytest.raises(ValueError, match=f"{what}.*not ported yet"):
        call()
