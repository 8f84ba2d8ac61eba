"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors (max abs error 1e-5, TF32 off for both
matmul and cuDNN), the wrappers' checks and launch counters, a short run
of the main path through the kernels, a short run of each baseline family
through its exchange kernel, a short train → export → serve run through
the dequant kernels, and a short run of each codec and sparse path
through its kernels.

Marked ``gpu``: each test asks a fixture for the card and skips without
one. Run on a machine with an H100: ``python -m pytest -q -m gpu
tests/test_torch_gpu.py``. This file imports no JAX, so it runs where
only PyTorch is installed."""
import pytest
import torch

from repro_torch.comm.codecs import Channel, CommConfig
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.core.packing import make_pack_spec
from repro_torch.experiments import RunConfig, export_run, run_method
from repro_torch.core.sparse import SparseConfig, column_activity, init_masks
from repro_torch.kernels.gossip_mix import (
    KERNELS,
    gossip_mix_dequant,
    gossip_mix_dequant_masked,
    gossip_mix_dequant_masked_ref,
    gossip_mix_dequant_ref,
    gossip_mix_flat,
    gossip_mix_flat_ref,
    gossip_mix_fused_dp,
    gossip_mix_fused_dp_ref,
    gossip_mix_sparse,
    gossip_mix_sparse_ref,
    gossip_mix_stack,
    gossip_mix_stack_ref,
    mixture_mix_dequant4,
    mixture_mix_dequant4_ref,
    reset_launch_counts,
)
from repro_torch.models.smallnets import make_classifier
from repro_torch.serve import ClusterPlaneServer, load_servable

pytestmark = pytest.mark.gpu

TOL = 1e-5
# the main path's shape, the CPU tests' shape, odd X, N above one 32-row
# chunk of the kernel, N = 64 (the straggler lane's population), N = 1
SHAPES = [(20, 17226), (8, 10692), (5, 1001), (37, 129), (64, 4099), (1, 7)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operands(dev, n, x, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((n, n), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    c_old = torch.randn((n, x), generator=g, device=dev)
    c_new = c_old + 0.3 * torch.randn((n, x), generator=g, device=dev)
    scale = 0.2 + 0.8 * torch.rand((n, 1), generator=g, device=dev)
    noise = torch.randn((n, x), generator=g, device=dev)
    return w, c_old, c_new, scale, noise


def _max_err(a, b):
    torch.cuda.synchronize()
    return float((a - b).abs().max())


@pytest.mark.parametrize("n,x", SHAPES)
def test_flat_kernel_matches_plain(cuda, n, x):
    w, c, *_ = _operands(cuda, n, x)
    before = gossip_mix_flat.launches
    out = gossip_mix_flat(w, c)
    assert gossip_mix_flat.launches == before + 1
    assert out.device == c.device and out.shape == c.shape
    assert _max_err(out, gossip_mix_flat_ref(w, c)) <= TOL


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("n,x", SHAPES)
def test_fused_dp_kernel_matches_plain(cuda, n, x, sigma):
    w, co, cn, sc, nz = _operands(cuda, n, x, seed=1)
    noise = nz if sigma > 0 else None
    before = gossip_mix_fused_dp.launches
    out = gossip_mix_fused_dp(w, co, cn, sc, noise, sigma)
    assert gossip_mix_fused_dp.launches == before + 1
    want = gossip_mix_fused_dp_ref(w, co, cn, sc, noise, sigma)
    assert _max_err(out, want) <= TOL


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w, c, *_ = _operands(cuda, 8, 64)
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix_flat(w, c.t().contiguous().t())
    with pytest.raises(TypeError, match="float32"):
        gossip_mix_flat(w.double(), c.double())
    with pytest.raises(ValueError, match="shape"):
        gossip_mix_flat(w[:4, :4].contiguous(), c)
    with pytest.raises(ValueError, match="devices"):
        gossip_mix_flat(w.cpu(), c)


@pytest.mark.parametrize("dp", [False, True])
def test_main_path_launches_one_kernel_per_round(cuda, dp):
    data = make_mixture_classification(n_clients=8, n_per_client=64, dim=16,
                                       n_classes=4)
    exp = PaperExpConfig(n_clients=8, n_per_client=64, dim=16, n_classes=4,
                         rounds=3, avg_degree=3.0)
    opts = {"dp_clip": 1.0, "dp_noise_multiplier": 0.5} if dp else {}
    reset_launch_counts()
    r = run_method("fedspd", data, exp, cfg=RunConfig(gossip_backend="cuda",
                                                      options=opts))
    launched = gossip_mix_fused_dp if dp else gossip_mix_flat
    idle = gossip_mix_flat if dp else gossip_mix_fused_dp
    assert launched.launches == exp.rounds and idle.launches == 0
    assert 0.0 <= r.mean_acc <= 1.0 and r.comm_bytes > 0


@pytest.mark.parametrize("x", [1001, 4098])   # odd; X % 4 = 2
@pytest.mark.parametrize("n", [1, 5, 20, 33])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_stack_kernel_matches_plain(cuda, s, n, x):
    g = torch.Generator(device=cuda).manual_seed(s * 1000 + n)
    w = torch.rand((n, n), generator=g, device=cuda)
    w = w / w.sum(dim=1, keepdim=True)
    c = torch.randn((s, n, x), generator=g, device=cuda)
    before = gossip_mix_stack.launches
    out = gossip_mix_stack(w, c)
    assert gossip_mix_stack.launches == before + 1
    assert out.shape == c.shape and out.dtype == torch.float32
    assert _max_err(out, gossip_mix_stack_ref(w, c)) <= TOL


def test_stack_kernel_past_2_to_the_31_elements(cuda):
    """S·N·X = 2,147,483,776 > 2^31: the last slab's offsets need int64
    (8.6 GB each way). Checked slab by slab against the flat plain mix."""
    s, n, x = 4, 32, 16_777_217
    g = torch.Generator(device=cuda).manual_seed(5)
    w = torch.rand((n, n), generator=g, device=cuda)
    w = w / w.sum(dim=1, keepdim=True)
    c = torch.randn((s, n, x), generator=g, device=cuda)
    out = gossip_mix_stack(w, c)
    torch.cuda.synchronize()
    for k in range(s):
        assert _max_err(out[k], gossip_mix_flat_ref(w, c[k])) <= TOL, k


def test_stack_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    w = torch.rand((6, 6), generator=g, device=cuda)
    c = torch.randn((2, 6, 64), generator=g, device=cuda)
    with pytest.raises(ValueError, match="stack"):
        gossip_mix_stack(w, c[0])
    with pytest.raises(ValueError, match="shape"):
        gossip_mix_stack(w[:4, :4].contiguous(), c)
    with pytest.raises(TypeError, match="float32"):
        gossip_mix_stack(w.double(), c.double())
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix_stack(w, c.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="devices"):
        gossip_mix_stack(w.cpu(), c)


@pytest.mark.parametrize("method,kernel", [
    ("dfl_fedem", gossip_mix_stack), ("cfl_fedem", gossip_mix_stack),
    ("dfl_fedavg", gossip_mix_flat), ("cfl_pfedme", gossip_mix_flat),
    ("dfl_ifca", gossip_mix_flat)])
def test_baselines_launch_their_exchange_kernel_once_per_round(cuda, method, kernel):
    data = make_mixture_classification(n_clients=8, n_per_client=64, dim=16,
                                       n_classes=4)
    exp = PaperExpConfig(n_clients=8, n_per_client=64, dim=16, n_classes=4,
                         rounds=3, avg_degree=3.0)
    reset_launch_counts()
    r = run_method(method, data, exp)
    assert kernel.launches == exp.rounds
    other = gossip_mix_flat if kernel is gossip_mix_stack else gossip_mix_stack
    assert other.launches == 0
    assert 0.0 <= r.mean_acc <= 1.0 and r.comm_bytes > 0


# (M, N, Xp, qblock) for the dequant kernels: serving (B=20 and 256 over
# S=2, the mlp's Xp), gossip (N=20, qblock 256), M above one 32-row block
# and N above one 16-row chunk, N = 1, one scale block (Xp/qblock = 1),
# and widths that rule out 16-byte (Xp % 4 = 2) and 8-byte (odd Xp) rows
DEQUANT_SHAPES = [(20, 2, 17280, 64), (256, 2, 17280, 64), (20, 20, 17408, 256),
                  (37, 33, 4096, 64), (70, 1, 640, 16), (5, 3, 16, 16),
                  (9, 4, 1030, 10), (6, 5, 333, 3)]


def _dequant_operands(dev, m, n, xp, qblock, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((m, n), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    q = torch.randint(-127, 128, (n, xp), generator=g, device=dev).to(torch.int8)
    packed = torch.randint(0, 256, (n, xp // 2), generator=g,
                           device=dev).to(torch.uint8)
    scales = torch.rand((n, xp // qblock), generator=g, device=dev) / 64
    return w, q, packed, scales


@pytest.mark.parametrize("m,n,xp,qblock", DEQUANT_SHAPES)
def test_dequant_kernel_matches_plain(cuda, m, n, xp, qblock):
    w, q, _, scales = _dequant_operands(cuda, m, n, xp, qblock)
    before = gossip_mix_dequant.launches
    out = gossip_mix_dequant(w, q, scales, qblock=qblock)
    assert gossip_mix_dequant.launches == before + 1
    assert out.shape == (m, xp) and out.dtype == torch.float32
    assert _max_err(out, gossip_mix_dequant_ref(w, q, scales, qblock=qblock)) <= TOL


@pytest.mark.parametrize("m,n,xp,qblock",
                         [s for s in DEQUANT_SHAPES if s[2] % 2 == 0 and s[3] % 2 == 0])
def test_dequant4_kernel_matches_plain(cuda, m, n, xp, qblock):
    u, _, packed, scales = _dequant_operands(cuda, m, n, xp, qblock, seed=1)
    before = mixture_mix_dequant4.launches
    out = mixture_mix_dequant4(u, packed, scales, qblock=qblock)
    assert mixture_mix_dequant4.launches == before + 1
    assert out.shape == (m, xp) and out.dtype == torch.float32
    want = mixture_mix_dequant4_ref(u, packed, scales, qblock=qblock)
    assert _max_err(out, want) <= TOL


def test_dequant_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w, q, packed, scales = _dequant_operands(cuda, 4, 3, 128, 16)
    with pytest.raises(ValueError, match="plane rows"):
        gossip_mix_dequant(w[:, :2].contiguous(), q, scales, qblock=16)
    with pytest.raises(ValueError, match="tile"):
        gossip_mix_dequant(w, q, scales, qblock=32)
    with pytest.raises(TypeError, match="int8"):
        gossip_mix_dequant(w, q.to(torch.int16), scales, qblock=16)
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix_dequant(w.t().contiguous().t(), q, scales, qblock=16)
    with pytest.raises(ValueError, match="even qblock"):
        mixture_mix_dequant4(w, packed, scales[:, :1].contiguous(), qblock=64)
    with pytest.raises(ValueError, match="mixture weights"):
        mixture_mix_dequant4(w[:, :2].contiguous(), packed, scales, qblock=16)
    with pytest.raises(TypeError, match="uint8"):
        mixture_mix_dequant4(w, packed.to(torch.int8), scales, qblock=16)


def test_train_export_serve_through_the_dequant_kernels(cuda, tmp_path):
    data = make_mixture_classification(n_clients=8, n_per_client=64, dim=16,
                                       n_classes=4)
    exp = PaperExpConfig(n_clients=8, n_per_client=64, dim=16, n_classes=4,
                         rounds=2, avg_degree=3.0)
    res = run_method("fedspd", data, exp,
                     cfg=RunConfig(options={"keep_state": True}))
    params, apply, *_ = make_classifier("mlp", torch.Generator(), 16, 4)
    spec = make_pack_spec(params)
    x = torch.as_tensor(data.x[:, 0])
    for codec, kernel in (("int8", gossip_mix_dequant), ("int4", mixture_mix_dequant4)):
        path = str(tmp_path / f"{codec}.npz")
        export_run(res, path, codec=codec, qblock=64)
        art = load_servable(path, spec)
        assert art.plane_scale.device.type == "cuda"
        srv = ClusterPlaneServer.from_artifact(art, spec, apply_fn=apply)
        reset_launch_counts()
        out = srv.predict(art.u_table, x)
        assert kernel.launches == 1
        cpu = ClusterPlaneServer.from_artifact(art, spec, apply_fn=apply, device="cpu")
        want = cpu.predict(art.u_table.cpu(), x)
        assert out.shape == (8, 4) and bool(torch.isfinite(out).all())
        assert float((out.cpu() - want).abs().max()) <= 1e-4


# --------------------------------------- kernels 5 and 6: sparse exchange

# (N, X, mask): the main path's shape, an odd X, N one more than a 32-row
# chunk of kernel 5 (and past kernel 6's 16-row chunks), and all-dead,
# all-live and one-band masks
SPARSE_SHAPES = [(20, 17226, "random"), (5, 1001, "random"), (33, 4099, "random"),
                 (20, 17226, "dead"), (20, 17226, "live"), (8, 10692, "band")]


def _sparse_operands(dev, n, x, layout, m=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((m or n, n), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    if layout == "random":
        mask = init_masks(g, n, x, SparseConfig(density=0.2))
    else:
        mask = torch.full((n, x), 1.0 if layout == "live" else 0.0, device=dev)
        if layout == "band":
            mask[:, x // 3: x // 3 + x // 5] = 1.0
    c = torch.randn((n, x), generator=g, device=dev) * mask
    return w, mask, c, column_activity(mask), g


@pytest.mark.parametrize("n,x,layout", SPARSE_SHAPES)
def test_sparse_kernel_matches_plain(cuda, n, x, layout):
    w, mask, c, act, _ = _sparse_operands(cuda, n, x, layout, seed=n + x)
    before = gossip_mix_sparse.launches
    out = gossip_mix_sparse(w, c, act)
    assert gossip_mix_sparse.launches == before + 1
    assert out.shape == c.shape and out.dtype == torch.float32
    assert _max_err(out, gossip_mix_sparse_ref(w, c, act)) <= TOL
    assert bool((out[:, act == 0] == 0).all())   # exact zeros, not roundoff
    den = gossip_mix_sparse(w, mask, act)          # the exchange's W·M
    assert _max_err(den, gossip_mix_sparse_ref(w, mask, act)) <= TOL


def test_sparse_kernel_past_2_to_the_31_elements(cuda):
    """N·X = 2,181,038,080 > 2^31: the last row's offsets need int64
    (8.7 GB each way). Four slabs of five are dead; checked in column
    chunks against the plain version."""
    n, x = 32, 2**26 + 2**20
    g = torch.Generator(device=cuda).manual_seed(7)
    w = torch.rand((n, n), generator=g, device=cuda)
    w = w / w.sum(dim=1, keepdim=True)
    act = ((torch.arange(x, device=cuda) // 128) % 5 == 0).float()
    c = torch.randn((n, x), generator=g, device=cuda) * act
    out = gossip_mix_sparse(w, c, act)
    torch.cuda.synchronize()
    step = 2**23
    for lo in range(0, x, step):
        sl = slice(lo, min(lo + step, x))
        assert _max_err(out[:, sl], gossip_mix_sparse_ref(w, c[:, sl], act[sl])) <= TOL, lo
    assert bool((out[:, act == 0] == 0).all())


# (M, N, X, qblock, mask): the main path's shape (Xp = 17,408), M != N
# with X < Xp, M and N past one 32-row chunk, odd widths, all-dead,
# all-live and band masks
DEQUANT_MASKED_SHAPES = [(20, 20, 17226, 256, "random"), (7, 20, 1001, 16, "random"),
                         (40, 17, 4099, 64, "random"), (9, 33, 4099, 64, "random"),
                         (9, 4, 999, 3, "random"),
                         (20, 20, 17226, 256, "dead"), (20, 20, 17226, 256, "live"),
                         (5, 8, 10692, 256, "band")]


@pytest.mark.parametrize("m,n,x,qblock,layout", DEQUANT_MASKED_SHAPES)
def test_dequant_masked_kernel_matches_plain(cuda, m, n, x, qblock, layout):
    w, mask, c, act, g = _sparse_operands(cuda, n, x, layout, m=m, seed=m + x)
    enc = Channel(CommConfig(codec="int8", block=qblock), x).encode(c, g)
    q, sc = enc["q"], enc["scale"]
    xp = q.shape[1]
    before = gossip_mix_dequant_masked.launches
    out = gossip_mix_dequant_masked(w, q, sc, mask, act, qblock=qblock)
    assert gossip_mix_dequant_masked.launches == before + 1
    assert out.shape == (m, xp) and out.dtype == torch.float32
    want = gossip_mix_dequant_masked_ref(w, q, sc, mask, act, qblock=qblock)
    assert _max_err(out, want) <= TOL
    assert bool((out[:, :x][:, act == 0] == 0).all()) and bool((out[:, x:] == 0).all())


def test_sparse_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w, mask, c, act, g = _sparse_operands(cuda, 6, 300, "random")
    enc = Channel(CommConfig(codec="int8", block=64), 300).encode(c, g)
    q, sc = enc["q"], enc["scale"]
    with pytest.raises(ValueError, match="column activity"):
        gossip_mix_sparse(w, c, act[:-1].contiguous())
    with pytest.raises(TypeError, match="float32"):
        gossip_mix_sparse(w, c, act.double())
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix_sparse(w, c.t().contiguous().t(), act)
    with pytest.raises(ValueError, match="shape"):
        gossip_mix_sparse(w[:4, :4].contiguous(), c, act)
    with pytest.raises(ValueError, match="devices"):
        gossip_mix_sparse(w, c, act.cpu())
    with pytest.raises(ValueError, match="mask"):
        gossip_mix_dequant_masked(w, q, sc, mask[:4].contiguous(), act, qblock=64)
    with pytest.raises(TypeError, match="float32"):
        gossip_mix_dequant_masked(w, q, sc, mask.bool(), act, qblock=64)
    with pytest.raises(TypeError, match="float32"):
        gossip_mix_dequant_masked(w, q, sc, mask, act.double(), qblock=64)
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix_dequant_masked(w, q, sc, mask.t().contiguous().t(), act, qblock=64)
    with pytest.raises(TypeError, match="int8"):
        gossip_mix_dequant_masked(w, q.to(torch.int16), sc, mask, act, qblock=64)
    with pytest.raises(ValueError, match="tile"):
        gossip_mix_dequant_masked(w, q, sc, mask, act, qblock=128)
    with pytest.raises(ValueError, match="column activity"):
        gossip_mix_dequant_masked(w, q, sc, mask, act[:-1].contiguous(), qblock=64)


SP = SparseConfig(density=0.25, prune_rate=0.3, update_every=2)
INT8 = CommConfig(codec="int8", error_feedback=True)


@pytest.mark.parametrize("label,kw,want", [
    ("int8-ef", dict(comm=INT8), {"gossip_mix_dequant": 1}),
    ("int4-ef", dict(comm=CommConfig(codec="int4", error_feedback=True)),
     {"gossip_mix_dequant": 1}),
    ("topk-ef", dict(comm=CommConfig(codec="topk", error_feedback=True)),
     {"gossip_mix_flat": 1}),
    ("sparse", dict(sparse=SP), {"gossip_mix_sparse": 2}),
    ("sparse-int8-ef", dict(sparse=SP, comm=INT8),
     {"gossip_mix_dequant_masked": 1, "gossip_mix_sparse": 1}),
    ("sparse-topk-ef", dict(sparse=SP, comm=CommConfig(codec="topk", error_feedback=True)),
     {"gossip_mix_sparse": 2}),
    ("sparse-int8-dp", dict(sparse=SP, comm=INT8,
                            options={"dp_clip": 1.0, "dp_noise_multiplier": 0.5}),
     {"gossip_mix_dequant_masked": 1, "gossip_mix_sparse": 1}),
])
def test_codec_and_sparse_paths_launch_their_kernels(cuda, label, kw, want):
    data = make_mixture_classification(n_clients=8, n_per_client=64, dim=16,
                                       n_classes=4)
    exp = PaperExpConfig(n_clients=8, n_per_client=64, dim=16, n_classes=4,
                         rounds=3, avg_degree=3.0)
    reset_launch_counts()
    r = run_method("fedspd", data, exp, cfg=RunConfig(**kw))
    counts = {k.__name__: k.launches for k in KERNELS}
    expect = {k: exp.rounds * want.get(k, 0) for k in counts}
    assert counts == expect, label
    assert 0.0 <= r.mean_acc <= 1.0 and 0 < r.wire_bytes < r.comm_bytes
