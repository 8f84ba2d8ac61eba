"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors (max abs error 1e-5 for the mixes, TF32
off for both matmul and cuDNN; flash attention 2e-5 fp32 / 2e-2 bf16, the
SSD scan 2e-3 and, on a bf16 y, one bf16 step), the wrappers' checks and launch counters, a short run
of the main path through the kernels, a short run of each baseline family
through its exchange kernel, a short train → export → serve run through
the dequant kernels, a short run of each codec and sparse path
through its kernels, LM generation through kernels 8 and 9 (the MoE and
hybrid families too, with an MoE layer against the CPU), the
round engines: every path replayed from its captured round
(``scan_rounds``) equal bit for bit to the eager loop, and the per-leaf
pytree engine (``param_plane=False``): kernel 1 once a leaf, never
kernel 2, kernel 3 once a leaf in FedEM.

Marked ``gpu``: each test asks a fixture for the card and skips without
one. Run on a machine with an H100: ``python -m pytest -q -m gpu
tests/test_torch_gpu.py``. This file imports no JAX, so it runs where
only PyTorch is installed."""
import dataclasses
import pathlib
import re

import pytest
import torch

from repro_torch.comm.codecs import Channel, CommConfig
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.configs.base import get_smoke_config
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
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
from repro_torch.launch.serve import encode_plane, random_plane
from repro_torch.models.registry import build_model
from repro_torch.models.smallnets import make_classifier
from repro_torch.models.layers import cast_params_for_compute
from repro_torch.serve import ClusterPlaneServer, load_servable
from repro_torch.serve.server import decode_eager
from repro_torch.utils.pytree import state_tensors

pytestmark = pytest.mark.gpu

TOL = 1e-5
# The width below which the flat and sparse mixes of N <= 32 rows take
# mix_kernel_narrow (kNarrowMaxX in the kernel's source).
NARROW_MAX_X = int(re.search(
    r"constexpr int64_t kNarrowMaxX = (\d+);",
    (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
     / "gossip_mix.cu").read_text()).group(1))
# The width from which the fused DP mix at an even X takes its vector
# kernel rather than the narrow one (kDpVecMinX in the kernel's source).
DP_VEC_MIN_X = int(re.search(
    r"constexpr int64_t kDpVecMinX = (\d+);",
    (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
     / "gossip_mix.cu").read_text()).group(1))
# N and X on both sides of that width: N across the narrow chunks (NB = N
# rounded up to 4: 4 and 8, a thread a column; 20, 24 and 32, four), X
# from one column to past the width
NARROW_N = [1, 5, 8, 20, 24, 32]
NARROW_X = [1, 7, 127, 129, 1001, 17226, NARROW_MAX_X - 1, NARROW_MAX_X, NARROW_MAX_X + 1]
# the main path's shape, the CPU tests' shape, odd X, N in the 40-row chunk
# of the kernel, N = 64 (the straggler lane's population, one 64-row
# chunk), N = 1; then N at each edge of the chunks past 32: 33 and 40
# (40 rows), 65 and 100 (two chunks of 64 rows); then the narrow grid
SHAPES = [(20, 17226), (8, 10692), (5, 1001), (37, 129), (64, 4099), (1, 7),
          (33, 1001), (40, 4099), (65, 999), (100, 1031)] + [
    (n, x) for n in NARROW_N for x in NARROW_X if (n, x) not in ((20, 17226), (1, 7))]


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


def _mix_kernel_witness(w, c):
    """W·C by mix_kernel: the stack mix of one slab never takes the narrow
    or vector kernels (mix_kernel_wide past 32 rows, the same bits)."""
    return gossip_mix_stack(w, c[None])[0]


@pytest.mark.parametrize("x", [7, 1001, 17226, NARROW_MAX_X - 1])
@pytest.mark.parametrize("n", NARROW_N)
def test_narrow_flat_kernel_is_mix_kernel_bit_for_bit(cuda, n, x):
    """Below kNarrowMaxX the flat mix runs mix_kernel_narrow, the one-slab
    stack mix mix_kernel: both sum each output over j ascending from 0 in
    fp32 FMAs, so the two agree bit for bit."""
    w, c, *_ = _operands(cuda, n, x, seed=2)
    out = gossip_mix_flat(w, c)
    old = _mix_kernel_witness(w, c)
    torch.cuda.synchronize()
    assert torch.equal(out, old)


# kernel 2 at each of its routes: N <= 32, the narrow kernel below
# kDpVecMinX and, at an odd X, below kNarrowMaxX; from kDpVecMinX at an
# even X (X % 4 = 0 and 2, 8-byte aligned) the vector kernel; mix_kernel
# past kNarrowMaxX at an odd X or with planes one float off alignment; and
# past 32 rows mix_kernel_wide; (N, X, offset of the planes in floats)
DP_BITS = [(n, x, 0) for n in NARROW_N
           for x in (7, 1001, 17226, DP_VEC_MIN_X - 2, DP_VEC_MIN_X, DP_VEC_MIN_X + 1,
                     NARROW_MAX_X - 1, NARROW_MAX_X, NARROW_MAX_X + 1)] + [
    (20, NARROW_MAX_X + 2, 0), (1, 100000, 0), (7, 100000, 0), (20, 100000, 0),
    (32, 100000, 0), (20, 100002, 0), (20, 100000, 1), (20, 1001, 1), (33, 1001, 0),
    (33, 100000, 0)]


@pytest.mark.parametrize("sigma", [0.0, 0.5])
@pytest.mark.parametrize("n,x,offset", DP_BITS)
def test_fused_dp_kernel_is_mix_kernel_bit_for_bit(cuda, n, x, offset, sigma):
    """Kernel 2 on every route equals mix_kernel fed the plane that torch
    sanitized on the card, one op a step (each step rounded alone, as the
    kernels' prologue rounds it), bit for bit, and its plain version
    within 1e-5."""
    w, co, cn, sc, nz = _operands(cuda, n, x, seed=3)

    def shifted(t):   # contiguous, its data `offset` floats into a buffer
        buf = torch.empty(t.numel() + offset, device=cuda)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    co, cn, nz = shifted(co), shifted(cn), shifted(nz)
    noise = nz if sigma > 0 else None
    out = gossip_mix_fused_dp(w, co, cn, sc, noise, sigma)
    sanitized = co + sc * (cn - co)
    if sigma > 0:
        sanitized = sanitized + sigma * nz
    witness = _mix_kernel_witness(w, sanitized)
    torch.cuda.synchronize()
    assert torch.equal(out, witness)
    assert _max_err(out, gossip_mix_fused_dp_ref(w, co, cn, sc, noise, sigma)) <= TOL


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
    # the loop engine: one launch a call (the default, the replay, is
    # test_scan_rounds_replay_equals_the_eager_loop's)
    r = run_method("fedspd", data, exp, cfg=RunConfig(gossip_backend="cuda",
                                                      scan_rounds=False, options=opts))
    launched = gossip_mix_fused_dp if dp else gossip_mix_flat
    idle = gossip_mix_flat if dp else gossip_mix_fused_dp
    assert launched.launches == exp.rounds and idle.launches == 0
    assert 0.0 <= r.mean_acc <= 1.0 and r.comm_bytes > 0


@pytest.mark.parametrize("x", [1001, 4098])   # odd; X % 4 = 2
@pytest.mark.parametrize("n", [1, 5, 20, 33, 40, 64, 65, 100])   # chunks of 32, 40, 64, 2 × 64
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
    r = run_method(method, data, exp, cfg=RunConfig(scan_rounds=False))
    assert kernel.launches == exp.rounds
    other = gossip_mix_flat if kernel is gossip_mix_stack else gossip_mix_stack
    assert other.launches == 0
    assert 0.0 <= r.mean_acc <= 1.0 and r.comm_bytes > 0


# (M, N, Xp, qblock) for the dequant kernels: serving (B=20 and 256 over
# S=2, the mlp's Xp), gossip (N=20, qblock 256), M above one 32-row block
# and N above one 16-row chunk, N = 1, one scale block (Xp/qblock = 1),
# and widths that rule out 16-byte (Xp % 4 = 2) and 8-byte (odd Xp) rows;
# one and two requests over S = 2 (the stream kernel; M = 2 also the
# square W on the narrow kernel) and three (the template), a width past
# the L2 with a ragged last tile, at M = 1 a qblock that is not a multiple of 4 and the widths
# without 16-byte rows (the general template), S = 3 and 4 (four plane
# rows a group) and S = 5 (the template); then the square W at both sides of its route (the narrow
# kernel up to N = 32 below kNarrowMaxX, the serving template at N = 33
# and from kNarrowMaxX) with Xp % 4 = 0, Xp % 4 = 2 and odd Xp
DEQUANT_SHAPES = [(20, 2, 17280, 64), (256, 2, 17280, 64), (20, 20, 17408, 256),
                  (37, 33, 4096, 64), (70, 1, 640, 16), (5, 3, 16, 16),
                  (9, 4, 1030, 10), (6, 5, 333, 3),
                  (1, 2, 17280, 64), (2, 2, 17280, 64), (3, 2, 4096, 64),
                  (1, 2, 16778304, 64), (3, 2, 16778304, 64), (1, 2, 1020, 6),
                  (1, 2, 1030, 10), (1, 2, 999, 3), (1, 3, 4096, 64), (2, 4, 1024, 4),
                  (1, 5, 1024, 64)] + [
    (n, n, xp, qb) for n in (1, 4, 7, 20, 32, 33)
    for xp, qb in ((1024, 64), (1010, 10), (999, 3))] + [
    (20, 20, NARROW_MAX_X - 1, 3), (20, 20, NARROW_MAX_X + 2, 3), (32, 32, NARROW_MAX_X, 64)]


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
    if m == n > 1:
        # M = N - 1 takes the serving template: whichever kernel a square W
        # takes, each output sums the same products in the same order
        assert torch.equal(out[:-1], gossip_mix_dequant(w[:-1].contiguous(), q, scales,
                                                        qblock=qblock))


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


# requests in one call of a serving kernel over S = 2: a row's bits must
# not depend on M (M picks the rows a block, the column groups a thread
# and, at 256 rows, the persistent grid's split) or on the route
ROW_COUNTS = (1, 4, 8, 9, 256)


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("xp", [17280, 4195392])
def test_dequant_rows_do_not_depend_on_m(cuda, codec, xp):
    u, q, packed, scales = _dequant_operands(cuda, max(ROW_COUNTS), 2, xp, 64, seed=2)
    kernel, plane = ((gossip_mix_dequant, q) if codec == "int8"
                     else (mixture_mix_dequant4, packed))
    outs = {k: kernel(u[:k].contiguous(), plane, scales, qblock=64) for k in ROW_COUNTS}
    for k in ROW_COUNTS:
        for k2 in ROW_COUNTS:
            rows = min(k, k2)
            assert torch.equal(outs[k][:rows], outs[k2][:rows]), (k, k2)


# one request over S = 2 past 2^31 columns, where each block of the stream
# kernel strides on by the grid (olmoe-1b-7b's plane is 6.9e9 wide), with a
# ragged last tile
WIDE_XP = 2**31 + 3 * 512 + 64


@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_dequant_stream_past_one_grid_step(cuda, codec):
    g = torch.Generator(device=cuda).manual_seed(5)
    u = torch.tensor([[0.3, 0.7]], device=cuda)
    if codec == "int8":
        kernel, plain = gossip_mix_dequant, gossip_mix_dequant_ref
        plane = torch.randint(-127, 128, (2, WIDE_XP), generator=g, device=cuda,
                              dtype=torch.int8)
    else:
        kernel, plain = mixture_mix_dequant4, mixture_mix_dequant4_ref
        plane = torch.randint(0, 256, (2, WIDE_XP // 2), generator=g, device=cuda,
                              dtype=torch.uint8)
    scales = torch.rand((2, WIDE_XP // 64), generator=g, device=cuda) / 64
    out = kernel(u, plane, scales, qblock=64)
    step = 2**26
    # the first chunks, one across 2^31 (the grid's step is 2^31 - 512
    # columns) and the last, each against the plain version and, bit for
    # bit, the kernel on that chunk alone
    for c0 in (0, step, 2**31 - step + 1024, WIDE_XP - 4096):
        c1 = min(c0 + step, WIDE_XP)
        part = (plane[:, c0:c1] if codec == "int8" else plane[:, c0 // 2:c1 // 2]).contiguous()
        sc = scales[:, c0 // 64:c1 // 64].contiguous()
        assert _max_err(out[:, c0:c1], plain(u, part, sc, qblock=64)) <= TOL
        assert torch.equal(out[:, c0:c1], kernel(u, part, sc, qblock=64)), c0


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


def test_conv_export_serves_through_the_dequant_kernels(cuda, tmp_path):
    """The conv classifier's plane (X = 4,814 at dim 16) exported as int8
    and int4 and served with its forward: one kernel 4 / kernel 7 launch a
    predict, within 1e-4 of the same artifact served on the CPU."""
    from repro_torch.models.smallnets import apply_conv1d_classifier

    data = make_mixture_classification(n_clients=8, n_per_client=64, dim=16,
                                       n_classes=4)
    exp = PaperExpConfig(n_clients=8, n_per_client=64, dim=16, n_classes=4,
                         rounds=2, avg_degree=3.0, model="conv")
    res = run_method("fedspd", data, exp, cfg=RunConfig(options={"keep_state": True}))
    spec = res.extras["pack_spec"]
    x = torch.as_tensor(data.x[:, 0])
    for codec, kernel in (("int8", gossip_mix_dequant), ("int4", mixture_mix_dequant4)):
        path = str(tmp_path / f"conv_{codec}.npz")
        export_run(res, path, arch="conv", codec=codec, qblock=64)
        art = load_servable(path, spec)
        srv = ClusterPlaneServer.from_artifact(art, spec, apply_fn=apply_conv1d_classifier)
        reset_launch_counts()
        out = srv.predict(art.u_table, x)
        assert kernel.launches == 1
        cpu = ClusterPlaneServer.from_artifact(art, spec, apply_fn=apply_conv1d_classifier,
                                               device="cpu")
        want = cpu.predict(art.u_table.cpu(), x)
        assert out.shape == (8, 4) and bool(torch.isfinite(out).all())
        assert float((out.cpu() - want).abs().max()) <= 1e-4


# --------------------------------------- kernels 5 and 6: sparse exchange

# (N, X, mask): the main path's shape, an odd X, N one more than a 32-row
# chunk of kernel 5, and all-dead, all-live and one-band masks; then N at
# the edges of the 40- and 64-row chunks and past them (65, 100: two
# chunks of 64 rows); then the narrow grid with every layout, "single"
# one live column
SPARSE_SHAPES = [(20, 17226, "random"), (5, 1001, "random"), (33, 4099, "random"),
                 (20, 17226, "dead"), (20, 17226, "live"), (8, 10692, "band"),
                 (40, 1001, "random"), (64, 4099, "band"), (65, 999, "random"),
                 (100, 4099, "random")] + [
    (n, x, layout) for n in NARROW_N for x in NARROW_X
    for layout in ("dead", "live", "band", "random", "single")
    if (n, x, layout) not in ((20, 17226, "random"), (20, 17226, "dead"), (20, 17226, "live"))]


def _sparse_operands(dev, n, x, layout, m=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.rand((m or n, n), generator=g, device=dev)
    w = w / w.sum(dim=1, keepdim=True)
    if layout in ("random", "unaligned"):
        mask = init_masks(g, n, x, SparseConfig(density=0.2))
        if layout == "unaligned":   # the same masks in a view 4 bytes off 16-byte alignment
            mask = torch.empty(n * x + 1, device=dev)[1:].view(n, x).copy_(mask)
    else:
        mask = torch.full((n, x), 1.0 if layout == "live" else 0.0, device=dev)
        if layout == "band":
            mask[:, x // 3: x // 3 + x // 5] = 1.0
        elif layout == "single":
            mask[n // 2, x // 2] = 1.0
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
# all-live and band masks; then M, N at the edges of the 40- and 64-row
# chunks and past them (65, 100: two chunks of 64 rows); then the narrow
# kernel (M = N <= 32, Xp < kNarrowMaxX) with every layout, Xp just below
# and just above kNarrowMaxX at qblock 3; then past it the 4-column kernel
# (X, Xp and qblock multiples of 4, M != N too) and its fallbacks to the
# one-column kernel: X % 4 != 0, qblock 3, a mask view off 16-byte alignment
DEQUANT_MASKED_SHAPES = [(20, 20, 17226, 256, "random"), (7, 20, 1001, 16, "random"),
                         (40, 17, 4099, 64, "random"), (9, 33, 4099, 64, "random"),
                         (9, 4, 999, 3, "random"),
                         (20, 20, 17226, 256, "dead"), (20, 20, 17226, 256, "live"),
                         (5, 8, 10692, 256, "band"),
                         (33, 33, 1001, 16, "random"), (40, 40, 4099, 64, "random"),
                         (64, 64, 4099, 64, "random"), (65, 65, 999, 3, "random"),
                         (100, 100, 4099, 64, "random"), (20, 100, 1001, 16, "random")] + [
    (n, n, x, qb, layout) for n in (1, 7, 20, 32) for x, qb in ((1001, 7), (17226, 256))
    for layout in ("random", "dead", "live", "band")] + [
    (20, 20, NARROW_MAX_X - 1, 3, "random"), (20, 20, NARROW_MAX_X + 2, 3, "random"),
    (20, 20, 100000, 64, "random"), (20, 20, 100000, 64, "band"), (32, 32, 65536, 256, "dead"),
    (4, 20, 100000, 64, "random"), (20, 20, 100002, 64, "random"),
    (20, 20, 100008, 3, "random"), (20, 20, 100000, 64, "unaligned")]


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
    r = run_method("fedspd", data, exp, cfg=RunConfig(scan_rounds=False, **kw))
    counts = {k.__name__: k.launches for k in KERNELS}
    expect = {k: exp.rounds * want.get(k, 0) for k in counts}
    assert counts == expect, label
    assert 0.0 <= r.mean_acc <= 1.0 and 0 < r.wire_bytes < r.comm_bytes


# kernel 8: the CPU sweep's shapes (tests/test_kernels.py), then the card's
# own: olmo-1b's prefill, a danube-like GQA 32/8 hd-80 layer with a window
# shorter than L, hd 256 over one kv head (gemma3), the smoke widths (hd
# 16, 32), Lq != Lkv both ways, and fully masked rows (Lq > Lkv + window).
# Then the tensor-core kernel's edges: GQA 8 (and 4 at hd 256, whose kv
# tile is 32 keys), windows shorter than one kv tile (16 < 64, 20 < 32),
# L = 48 and 96 (not multiples of its 64 rows or 64 keys), Lq != Lkv both
# ways under GQA, and fully masked rows folded with GQA
FLASH_SHAPES = [
    (2, 256, 256, 4, 2, 64, None), (1, 256, 256, 4, 4, 64, 128),
    (2, 128, 128, 8, 2, 32, None), (1, 512, 512, 2, 1, 64, 256),
    (1, 384, 384, 4, 4, 128, None),
    (4, 512, 512, 16, 16, 128, None), (2, 1024, 1024, 32, 8, 80, 300),
    (2, 512, 512, 4, 1, 256, None), (2, 32, 32, 8, 2, 16, 64), (1, 96, 96, 4, 1, 32, 32),
    (1, 128, 256, 4, 2, 96, None), (1, 512, 128, 4, 2, 64, 64),
    (2, 256, 256, 8, 1, 64, None), (1, 256, 256, 16, 2, 128, 16),
    (1, 128, 128, 4, 1, 256, 20), (2, 48, 48, 4, 1, 64, None), (1, 48, 48, 2, 2, 80, 16),
    (2, 96, 96, 8, 1, 96, None), (1, 96, 256, 8, 1, 16, None), (1, 256, 96, 2, 1, 256, None),
    (1, 256, 48, 8, 1, 128, 16), (1, 96, 48, 4, 2, 32, 8),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(dev, b, lq, lkv, hq, hkv, hd, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((b, lq, hq, hd), generator=g, device=dev).to(dtype),
            torch.randn((b, lkv, hkv, hd), generator=g, device=dev).to(dtype),
            torch.randn((b, lkv, hkv, hd), generator=g, device=dev).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,window", FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, b, lq, lkv, hq, hkv, hd, window, dtype):
    q, k, v = _qkv(cuda, b, lq, lkv, hq, hkv, hd, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=True, window=window)
    assert _max_err(out.float(), want.float()) <= FLASH_TOL[dtype]
    if window is not None and lq > lkv + window:   # rows with no live key are 0
        assert bool((out[:, lkv + window:] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_without_causal_mask(cuda, dtype):
    q, k, v = _qkv(cuda, 2, 128, 384, 4, 2, 64, dtype, seed=1)
    out = flash_attention(q, k, v, causal=False)
    want = flash_attention_ref(q, k, v, causal=False)
    assert _max_err(out.float(), want.float()) <= FLASH_TOL[dtype]


def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 256, 256, 4, 2, 64, torch.float32)
    # a ragged length is taken since whisper's slice (its kernel row: the
    # ragged cases below)
    assert flash_attention(q[:, :200].contiguous(), k, v).shape == (1, 200, 4, 64)
    with pytest.raises(ValueError, match=">= 1"):
        flash_attention(q[:, :0], k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*_qkv(cuda, 1, 64, 64, 2, 1, 48, torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(TypeError, match="dtypes"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):   # 2 bytes past a 16-byte line
        flash_attention(flat[1:1 + q.numel()].view(q.shape), k.bfloat16(), v.bfloat16())


# kernel 8 at ragged lengths, (B, Lq, Lkv, Hq, Hkv, hd, causal): whisper's
# encoder layer (1,500 frames, 8/8 heads, hd 64, bidirectional), its cross
# attention (64 decoder tokens over 1,500 frames), a causal 1,500, an odd
# length at hd 80 and 256 both ways, GQA over a ragged tail, and lengths
# under one 64-row tile with Lq != Lkv
RAGGED_SHAPES = [
    (4, 1500, 1500, 8, 8, 64, False), (4, 64, 1500, 8, 8, 64, False),
    (2, 1500, 1500, 8, 8, 64, True), (2, 77, 77, 4, 4, 80, True), (2, 77, 77, 4, 4, 80, False),
    (1, 77, 77, 2, 2, 256, True), (1, 77, 77, 2, 2, 256, False), (2, 200, 200, 8, 2, 64, True),
    (1, 13, 1500, 4, 1, 128, False), (1, 1500, 13, 2, 1, 32, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,lq,lkv,hq,hkv,hd,causal", RAGGED_SHAPES)
def test_flash_kernel_at_ragged_lengths_matches_plain(cuda, b, lq, lkv, hq, hkv, hd, causal,
                                                      dtype):
    q, k, v = _qkv(cuda, b, lq, lkv, hq, hkv, hd, dtype, seed=lq + lkv)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, causal=causal)
    assert bool(torch.isfinite(out).all())
    assert _max_err(out.float(), want.float()) <= FLASH_TOL[dtype]


def test_whisper_on_the_card_matches_the_cpu(cuda):
    """Whisper at smoke width (fp32): the forward (kernel 8 in the encoder,
    the decoder's causal self and cross attention), the cross prefill and
    teacher-forced decode on the card against the same steps on the CPU
    (plain versions), kernel 8's launches counted."""
    cfg = get_smoke_config("whisper-base")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 10), generator=g),
             "frames": torch.randn((2, cfg.encoder_frames, cfg.encoder_d_model), generator=g)}
    on = {dev: (_to(params, dev), {k: v.to(dev) for k, v in batch.items()})
          for dev in ("cpu", cuda)}
    flash_attention.launches = 0
    logits = {dev: bundle.forward(p, bt)[0] for dev, (p, bt) in on.items()}
    assert flash_attention.launches == cfg.encoder_layers + 2 * cfg.n_layers
    assert _max_err(logits[cuda].cpu(), logits["cpu"]) <= 1e-4
    flash_attention.launches = 0
    steps = {}
    for dev, (p, bt) in on.items():
        cache = bundle.prefill(p, bt, bundle.init_cache(2, 12, device=dev))
        steps[dev] = [bundle.decode_step(p, cache, bt["tokens"][:, t:t + 1])[0].cpu()
                      for t in range(10)]
    assert flash_attention.launches == cfg.encoder_layers
    for t in range(10):
        assert _max_err(steps[cuda][t], steps["cpu"][t]) <= 1e-4
        assert _max_err(steps[cuda][t][:, 0], logits[cuda][:, t].cpu()) <= 1e-4


def _to(node, dev):
    if isinstance(node, dict):
        return {k: _to(v, dev) for k, v in node.items()}
    return node.to(dev)


# kernel 9: the CPU sweep's shapes, then mamba2-370m's prefill layer (H =
# 32, P = 64, N = 128, L = 512, chunk 128) at B = 1 and 4, a prompt shorter
# than one chunk, and groups < heads; then the tensor-core kernels' edges
# (bf16): Q = 5 (under one 16-token step), Q = 16, Q = 80 alone and over
# two chunks (a ragged query tile), Q = 192 (three query and key tiles), P
# = 128 (two passes of 64 columns) and N = 16, 64, 128 at G = 1, 2, 4; and
# P = 24, N = 40, which bf16 runs on the CUDA-core kernels
SSD_SHAPES = [
    (1, 128, 8, 2, 32, 16, 64), (2, 256, 4, 1, 64, 64, 128),
    (2, 256, 4, 4, 64, 128, 128), (1, 512, 2, 1, 64, 64, 128),
    (4, 512, 32, 1, 64, 128, 128), (1, 512, 32, 1, 64, 128, 128),
    (2, 16, 8, 1, 32, 16, 128), (2, 384, 16, 4, 64, 128, 128),
    (2, 10, 4, 2, 32, 16, 5), (2, 64, 8, 4, 32, 64, 16), (1, 80, 4, 1, 64, 128, 128),
    (2, 160, 4, 2, 64, 64, 80), (1, 192, 4, 2, 64, 128, 192), (1, 128, 2, 1, 128, 64, 128),
    (1, 64, 4, 2, 24, 40, 32),
]


def _ssd_inputs(dev, b, l, h, g, p, n, dtype, seed=0, state=False, per_request=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, l, h, p), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen, device=dev)) * 0.1
    a = -torch.exp(torch.rand((b, h) if per_request else (h,), generator=gen, device=dev))
    bm = torch.randn((b, l, g, n), generator=gen, device=dev).to(dtype)
    cm = torch.randn((b, l, g, n), generator=gen, device=dev).to(dtype)
    s0 = torch.randn((b, h, p, n), generator=gen, device=dev) if state else None
    return x, dt, a, bm, cm, s0


def _assert_ssd_close(got, want, dtype):
    """fp32: 2e-3 abs + rel (tests/test_kernels.py's SSD bound). bf16: y
    is rounded to bf16 on both sides from fp32 sums taken in other orders,
    so it may also differ by one bf16 step (at most 2^-7 of the value:
    8 significant bits); the fp32 final state is held at 2e-3."""
    (y, s), (yr, sr) = got, want
    torch.cuda.synchronize()
    rtol = 2e-3 if dtype == torch.float32 else 2e-3 + 2.0 ** -7
    torch.testing.assert_close(y.float(), yr.float(), atol=2e-3, rtol=rtol)
    torch.testing.assert_close(s, sr, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,g,p,n,chunk", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, b, l, h, g, p, n, chunk, dtype):
    x, dt, a, bm, cm, _ = _ssd_inputs(cuda, b, l, h, g, p, n, dtype)
    before = ssd_scan.launches
    y, s = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    assert ssd_scan.launches == before + 3      # chunk states, state pass, outputs
    assert y.dtype == dtype and y.shape == x.shape and s.dtype == torch.float32
    _assert_ssd_close((y, s), ssd_chunked(x, dt, a, bm, cm, min(chunk, l)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_request", [False, True])
def test_ssd_kernel_with_an_initial_state(cuda, per_request, dtype):
    x, dt, a, bm, cm, s0 = _ssd_inputs(cuda, 4, 512, 32, 1, 64, 128, dtype, seed=3,
                                       state=True, per_request=per_request)
    got = ssd_scan(x, dt, a, bm, cm, chunk=128, initial_state=s0)
    _assert_ssd_close(got, ssd_chunked(x, dt, a, bm, cm, 128, s0), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_gives_the_same_bits_twice(cuda, dtype):
    """No atomics: two identical calls agree bit for bit."""
    x, dt, a, bm, cm, s0 = _ssd_inputs(cuda, 2, 384, 16, 4, 64, 128, dtype, seed=4,
                                       state=True)
    (y1, s1), (y2, s2) = (ssd_scan(x, dt, a, bm, cm, chunk=128, initial_state=s0)
                          for _ in range(2))
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, a, bm, cm, _ = _ssd_inputs(cuda, 1, 512, 4, 1, 64, 128, torch.float32)
    with pytest.raises(ValueError, match="not divisible"):
        ssd_scan(x, dt, a, bm, cm, chunk=96)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_scan(x, dt, a, bm, cm, chunk=256)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(torch.zeros((1, 512, 4, 128), device=cuda)[..., :64], dt, a, bm, cm)
    with pytest.raises(TypeError, match="dtypes"):
        ssd_scan(x, dt, a, bm.bfloat16(), cm)
    flat = torch.zeros(x.numel() + 8, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):   # 2 bytes past a 16-byte line
        ssd_scan(flat[1:1 + x.numel()].view(x.shape), dt, a, bm.bfloat16(), cm.bfloat16())


@pytest.mark.parametrize("arch,launches", [("olmo-1b", 1), ("gemma3-1b", 1),
                                           ("mamba2-370m", 3)])
@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
def test_lm_generate_runs_the_kernels_and_matches_the_cpu(cuda, arch, launches, codec):
    """Generation on the card (kernels 8/9, and 4/7 for int8/int4) gives
    the CPU's tokens (plain versions) on the smoke arch in fp32: one
    flash launch, or three SSD-scan launches, per layer per generate."""
    cfg = get_smoke_config(arch)
    bundle = build_model(cfg, attn_mode="cuda")
    spec = make_pack_spec(bundle.init(None))
    plane = random_plane(bundle, spec, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(1))
    u = torch.tensor([[0.7, 0.3], [0.5, 0.5], [0.0, 1.0], [0.2, 0.8]])
    toks = {}
    for dev in ("cpu", "cuda"):
        server = ClusterPlaneServer(spec, codec=codec, bundle=bundle, device=dev,
                                    **encode_plane(plane, codec))
        reset_launch_counts()
        flash_attention.launches = ssd_scan.launches = 0
        toks[dev] = server.generate(u, prompts, gen=8).cpu()
        kernel = ssd_scan if cfg.family == "ssm" else flash_attention
        assert kernel.launches == (cfg.n_layers * launches if dev == "cuda" else 0)
    assert torch.equal(toks["cpu"], toks["cuda"])


def _lm_server(dev, arch, codec, compute="float32"):
    cfg = get_smoke_config(arch).with_overrides(compute_dtype=compute)
    bundle = build_model(cfg, attn_mode="cuda")
    spec = make_pack_spec(bundle.init(None))
    plane = random_plane(bundle, spec, seed=0, device=dev)
    server = ClusterPlaneServer(spec, codec=codec, bundle=bundle, device=dev,
                                **encode_plane(plane, codec))
    prompts = torch.randint(0, cfg.vocab, (4, 64),
                            generator=torch.Generator().manual_seed(1)).to(dev)
    u = torch.tensor([[0.7, 0.3], [0.5, 0.5], [0.0, 1.0], [0.2, 0.8]], device=dev)
    return cfg, server, prompts, u


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("arch,compute,launches", [
    ("olmo-1b", "float32", 1), ("olmo-1b", "bfloat16", 1), ("gemma3-1b", "float32", 1),
    ("mamba2-370m", "float32", 3), ("mamba2-370m", "bfloat16", 3)])
def test_captured_generate_equals_the_eager_decode_bit_for_bit(
        cuda, arch, compute, launches, codec, temperature):
    """generate replays its captured decode step; the tokens and the last
    logits equal ``decode_eager``'s (the same steps launched one by one)
    bit for bit. The mix and the prefill stay eager: kernels 8 / 9 launch
    once (three times) a layer and 4 / 7 once per generate."""
    cfg, server, prompts, u = _lm_server(cuda, arch, codec, compute)
    gen = 8
    noise = None
    if temperature > 0:
        uni = torch.rand((gen, 4, cfg.vocab), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
        noise = -torch.log(-torch.log(uni.clamp_min(1e-20)))
    kernel = ssd_scan if cfg.family == "ssm" else flash_attention
    outs = []
    for _ in range(2):
        reset_launch_counts()
        flash_attention.launches = ssd_scan.launches = 0
        outs.append(server.generate(u, prompts, gen=gen, temperature=temperature,
                                    noise=noise))
        assert kernel.launches == cfg.n_layers * launches
        assert gossip_mix_dequant.launches == (codec == "int8")
        assert mixture_mix_dequant4.launches == (codec == "int4")
    assert server.n_compiles == 1 and torch.equal(outs[0], outs[1])
    engine = server.engines[(4, 64, gen, temperature)]
    assert engine.graph is not None
    params = cast_params_for_compute(server.personalized(u), cfg.compute_dtype_torch())
    want, last = decode_eager(server.bundle, params, prompts, gen=gen,
                              temperature=temperature, noise=noise)
    assert torch.equal(outs[1], want)
    assert torch.equal(engine.logits, last)


# the MoE and hybrid families (olmoe-1b-7b, phi3.5-moe, zamba2-1.2b at
# smoke width): generate through kernels 8 and 9 gives the CPU's tokens,
# its captured decode the eager decode's bits, and an MoE layer on the
# card the CPU's output and drops
MOE_HYBRID = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "zamba2-1.2b"]


def _lm_kernel_launches(cfg) -> dict:
    """Kernels 8 and 9 in one generate: the eager prefill launches one
    flash kernel per attention layer (per shared-block invocation) and
    three SSD-scan kernels per Mamba2 layer; the decode launches neither."""
    if cfg.family == "hybrid":
        return {"flash": cfg.n_layers // cfg.attn_every, "ssd": 3 * cfg.n_layers}
    return {"flash": cfg.n_layers, "ssd": 0}


@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("arch", MOE_HYBRID)
def test_moe_and_hybrid_generate_run_the_kernels_and_match_the_cpu(cuda, arch, codec):
    cfg = get_smoke_config(arch)
    bundle = build_model(cfg, attn_mode="cuda")
    spec = make_pack_spec(bundle.init(None))
    plane = random_plane(bundle, spec, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(1))
    u = torch.tensor([[0.7, 0.3], [0.5, 0.5], [0.0, 1.0], [0.2, 0.8]])
    toks = {}
    for dev in ("cpu", "cuda"):
        server = ClusterPlaneServer(spec, codec=codec, bundle=bundle, device=dev,
                                    **encode_plane(plane, codec))
        flash_attention.launches = ssd_scan.launches = 0
        toks[dev] = server.generate(u, prompts, gen=8).cpu()
        want = _lm_kernel_launches(cfg) if dev == "cuda" else {"flash": 0, "ssd": 0}
        assert {"flash": flash_attention.launches, "ssd": ssd_scan.launches} == want
    assert torch.equal(toks["cpu"], toks["cuda"])


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("codec", ["fp32", "int8", "int4"])
@pytest.mark.parametrize("arch,compute", [
    ("olmoe-1b-7b", "float32"), ("olmoe-1b-7b", "bfloat16"), ("phi3.5-moe-42b-a6.6b", "float32"),
    ("zamba2-1.2b", "float32"), ("zamba2-1.2b", "bfloat16")])
def test_moe_and_hybrid_captured_generate_equals_the_eager_decode_bit_for_bit(
        cuda, arch, compute, codec, temperature):
    """The MoE routing (stable sort, scatter-add dispatch, gather combine)
    and the hybrid's per-invocation k/v rows replay from the captured
    decode step to ``decode_eager``'s bits."""
    cfg, server, prompts, u = _lm_server(cuda, arch, codec, compute)
    gen = 8
    noise = None
    if temperature > 0:
        uni = torch.rand((gen, 4, cfg.vocab), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
        noise = -torch.log(-torch.log(uni.clamp_min(1e-20)))
    outs = []
    for _ in range(2):
        reset_launch_counts()
        flash_attention.launches = ssd_scan.launches = 0
        outs.append(server.generate(u, prompts, gen=gen, temperature=temperature,
                                    noise=noise))
        assert {"flash": flash_attention.launches, "ssd": ssd_scan.launches} == \
            _lm_kernel_launches(cfg)
        assert gossip_mix_dequant.launches == (codec == "int8")
        assert mixture_mix_dequant4.launches == (codec == "int4")
    assert server.n_compiles == 1 and torch.equal(outs[0], outs[1])
    engine = server.engines[(4, 64, gen, temperature)]
    assert engine.graph is not None
    params = cast_params_for_compute(server.personalized(u), cfg.compute_dtype_torch())
    want, last = decode_eager(server.bundle, params, prompts, gen=gen,
                              temperature=temperature, noise=noise)
    assert torch.equal(outs[1], want)
    assert torch.equal(engine.logits, last)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dispatch", ["cumsum", "sort", "grouped"])
def test_moe_layer_on_the_card_equals_the_cpu(cuda, dispatch, batched, monkeypatch):
    """One MoE layer at olmoe's routing (64 experts, top-8) on a small
    width, fp32: out and aux within 1e-5 of the CPU's, the same drops
    (capacity factor 1.0 forces some), one decode token drop-free."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(3)
    b, l, d, f, e, k = 2, 96, 64, 32, 64, 8
    params = moe.init_moe(g, d, f, e, "silu", torch.float32)
    if batched:
        params = {n: torch.stack([w, w * 0.5]) for n, w in params.items()}
    x = torch.randn((b, l, d), generator=g)
    real, calls = moe._slots, []

    def counting(fe, ne, cap, mode):
        keep, slot = real(fe, ne, cap, mode)
        calls.append(int((~keep).sum()))
        return keep, slot

    monkeypatch.setattr(moe, "_slots", counting)
    outs, drops = {}, {}
    for dev in ("cpu", "cuda"):
        p = {n: w.to(dev) for n, w in params.items()}
        calls.clear()
        outs[dev] = moe.apply_moe(p, x.to(dev), top_k=k, capacity_factor=1.0, act="silu",
                                  dispatch=dispatch)
        tok = moe.apply_moe(p, x[:, :1].to(dev), top_k=k, capacity_factor=1.0, act="silu",
                            dispatch=dispatch)
        drops[dev] = list(calls)
        assert drops[dev][-1] == 0 and bool(torch.isfinite(tok[0]).all())
    assert drops["cpu"] == drops["cuda"] and drops["cpu"][0] > 0
    torch.testing.assert_close(outs["cuda"][0].cpu(), outs["cpu"][0], atol=1e-5, rtol=0)
    torch.testing.assert_close(outs["cuda"][1].cpu(), outs["cpu"][1], atol=1e-5, rtol=0)


# the round engines: the card's default engine replays one captured round
# (a CUDA graph for each host-side branch); every path the loop runs must
# capture and replay to the loop's bits, and its replays must launch as
# many exchange kernels as the loop's counters (counted in the trace)
ENGINE_DP = {"dp_clip": 1.0, "dp_noise_multiplier": 0.5}
ENGINE_PATHS = {
    "fedspd": ("fedspd", {}),
    "fedspd-dp": ("fedspd", dict(options=ENGINE_DP)),
    "fedspd-int8-ef": ("fedspd", dict(comm=INT8)),
    "fedspd-int4-ef": ("fedspd", dict(comm=CommConfig(codec="int4", error_feedback=True))),
    "fedspd-topk-ef": ("fedspd", dict(comm=CommConfig(codec="topk", error_feedback=True))),
    "fedspd-int8-dp": ("fedspd", dict(comm=INT8, options=ENGINE_DP)),
    "fedspd-sparse": ("fedspd", dict(sparse=SP)),
    "fedspd-sparse-random": ("fedspd", dict(sparse=SparseConfig(
        density=0.25, prune_rate=0.3, regrow="random", update_every=2))),
    "fedspd-sparse-int8-ef": ("fedspd", dict(sparse=SP, comm=INT8)),
    "fedspd-sparse-dp": ("fedspd", dict(sparse=SP, options=ENGINE_DP)),
    "fedspd-cohort": ("fedspd", dict(cohort_size=5)),
    "fedspd-cohort-sparse": ("fedspd", dict(cohort_size=5, sparse=SP)),
    **{m: (m, {}) for m in ("local", "dfl_fedavg", "cfl_fedavg", "dfl_fedem", "cfl_fedem",
                            "dfl_ifca", "cfl_ifca", "dfl_fedsoft", "cfl_fedsoft",
                            "dfl_pfedme", "cfl_pfedme")},
}


def _engine_setup():
    data = make_mixture_classification(n_clients=8, n_per_client=64, dim=16, n_classes=4)
    exp = PaperExpConfig(n_clients=8, n_per_client=64, dim=16, n_classes=4, rounds=4,
                         avg_degree=3.0)
    return data, exp


def _assert_same_run(a, b):
    assert (a.acc_per_client == b.acc_per_client).all()
    assert a.curve == b.curve
    assert a.comm_bytes == b.comm_bytes and a.wire_bytes == b.wire_bytes
    if "u" in a.extras:
        assert (a.extras["u"] == b.extras["u"]).all()
    for x, y in zip(state_tensors(a.extras["state"]), state_tensors(b.extras["state"])):
        assert torch.equal(x, y)


def _replayed_exchange_kernels(prof) -> list:
    """Each round's exchange kernels (kernels 1-6) in a profiled run: the
    kernels of the graph launches inside one of the runner's ROUND_SPAN
    spans, matched by the runtime's correlation id."""
    from repro_torch.experiments.runner import ROUND_SPAN

    events = prof.events()
    spans = [e.time_range for e in events
             if e.name == ROUND_SPAN and e.device_type.name == "CPU"]
    launch = {e.id: i for e in events if e.name == "cudaGraphLaunch"
              for i, t in enumerate(spans) if t.start <= e.time_range.start <= t.end}
    per_round = [0] * len(spans)
    for e in events:
        if (e.device_type.name == "CUDA" and e.id in launch
                and ("mix_kernel" in e.name or "mix_dequant_kernel" in e.name)):
            per_round[launch[e.id]] += 1
    return per_round


@pytest.mark.parametrize("label", list(ENGINE_PATHS))
def test_scan_rounds_replay_equals_the_eager_loop(cuda, label):
    method, kw = ENGINE_PATHS[label]
    kw = dict(kw, options=dict(kw.get("options", {}), keep_state=True))
    data, exp = _engine_setup()
    reset_launch_counts()
    loop = run_method(method, data, exp, cfg=RunConfig(eval_every=1, scan_rounds=False, **kw))
    counts = {k.__name__: k.launches for k in KERNELS}
    # the default engine on the card: the replay
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        scan = run_method(method, data, exp, cfg=RunConfig(eval_every=1, **kw))
    _assert_same_run(loop, scan)
    per_round = _replayed_exchange_kernels(prof)
    assert len(per_round) == exp.rounds and sum(per_round) == sum(counts.values())
    # local and FedSoft (a torch.matmul aggregation) launch no kernel
    assert (sum(counts.values()) > 0) == (method not in ("local", "dfl_fedsoft",
                                                         "cfl_fedsoft"))
    assert scan.extras["n_dispatches"] == exp.rounds
    # the sparse paths' masks update at round 2: a second graph
    assert scan.extras["n_captures"] == (2 if "sparse" in label else 1)


def test_batch_replay_equals_each_seed_run(cuda):
    """One graph holds every seed's round; each seed equals its own eager
    run (per-seed graphs ride the step's adjacency)."""
    from repro_torch.experiments import run_method_batch
    from repro_torch.graphs.topology import make_graph

    data, exp = _engine_setup()
    graphs = [make_graph("er", 8, 3.0, seed=s) for s in (4, 5)]
    cfg = RunConfig(eval_every=1, scan_rounds=False, options={"keep_state": True})
    batch = run_method_batch("fedspd", data, exp, seeds=(0, 1), graph=graphs,
                             cfg=dataclasses.replace(cfg, scan_rounds=True))
    assert batch[0].extras["n_captures"] == 1
    for s, g, r in zip((0, 1), graphs, batch):
        _assert_same_run(run_method("fedspd", data, exp, graph=g, seed=s, cfg=cfg), r)


def test_a_failed_decode_capture_raises_and_never_falls_back(cuda, monkeypatch):
    """A host read inside the decode step (here a forced one, only while
    the stream captures) fails the capture: generate raises naming the
    arch and the shape key and builds no engine; with the step repaired
    the same server captures and generates."""
    from repro_torch.models import transformer

    real = transformer.decode_attention

    def reads_the_host(q, *args, **kw):
        if torch.cuda.is_current_stream_capturing():
            float(q.sum())
        return real(q, *args, **kw)

    _, server, prompts, u = _lm_server(cuda, "olmo-1b", "fp32")
    monkeypatch.setattr(transformer, "decode_attention", reads_the_host)
    with pytest.raises(RuntimeError, match=r"olmo-1b's decode step .* = \(4, 64, 4, 0\.0\) "
                                           r"could not be captured"):
        server.generate(u, prompts, gen=4)
    assert server.n_compiles == 0
    monkeypatch.undo()
    toks = server.generate(u, prompts, gen=4)
    assert server.n_compiles == 1 and tuple(toks.shape) == (4, 4)


# the scenario engine on the card: a round of scenario B (dropout and a
# Markov heterogeneity model with stragglers and stale-gossip decay) on
# the card against the same round on the CPU with the same injected draws,
# and the replay of a scenario run (a schedule tape, the dropout stream,
# the heterogeneity carry) against its loop
SCEN_SYSTEM = dict(slow_fraction=0.34, slow_factor=4.0, time_budget=2.0, jitter=0.3,
                   markov=(0.3, 0.7), staleness_gamma=0.9, seed=5)


def _fedspd_state_to(st, dev):
    return st._replace(**{f: getattr(st, f).to(dev, copy=True)
                          for f in ("centers", "u", "z", "comm_bytes", "ef", "mask")
                          if getattr(st, f) is not None},
                       gen=torch.Generator(device=dev))


@pytest.mark.parametrize("dp", [False, True])
def test_scenario_round_on_the_card_equals_the_cpu(cuda, dp):
    from repro_torch.core.fedspd import make_round_step
    from repro_torch.core.gossip import GossipSpec, make_mix_fn
    from repro_torch.experiments.heterogeneity import (
        ClientSystemModel, HetCarry, draw_het, het_round, masked_client_step)
    from repro_torch.experiments.registry import build_context, get_method
    from repro_torch.experiments.scenarios import bernoulli_drop, draw_drop

    data, exp = _engine_setup()
    n, m_pts, cpu = data.n_clients, data.x.shape[1], torch.device("cpu")
    opts = RunConfig(options=ENGINE_DP if dp else {}).resolve_options()
    m, model = get_method("fedspd"), ClientSystemModel(**SCEN_SYSTEM)
    st0 = m.init(build_context(data, exp, cpu, options=opts), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    adj_u, (z, u) = draw_drop(g, n), draw_het(g, n)
    carry = HetCarry(stale=torch.tensor([0, 1, 2, 0, 3, 0, 1, 0], dtype=torch.int32),
                     avail=torch.tensor([1.0, 1.0, 0.0, 1.0, 0.0, 1.0, 1.0, 1.0]))
    x = st0.centers.shape[-1]
    draws = dict(s=torch.randint(0, 2, (n,), generator=g),
                 idx=torch.randint(0, m_pts, (exp.tau, n, exp.batch), generator=g),
                 noise=torch.randn((n, x), generator=g))
    out = {}
    for dev in (cpu, cuda):
        ctx = build_context(data, exp, dev, options=opts)
        spec = GossipSpec.from_graph(ctx.graph)
        core = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, m._fcfg(ctx),
                               pack_spec=ctx.pack_spec, mix_fn=make_mix_fn(spec))
        d = {k: v.to(dev) for k, v in draws.items()}
        st = _fedspd_state_to(st0, dev)
        step = masked_client_step(lambda s_, tr, gen, lr, a: core(s_, tr, a, **d),
                                  m.cohort_axes(ctx, st))
        adj = bernoulli_drop(torch.as_tensor(ctx.graph.adj, device=dev), adj_u.to(dev), 0.2)
        speeds = torch.as_tensor(model.resolve_speeds(n), device=dev)
        new_carry, aw = het_round(model, speeds, HetCarry(*(t.to(dev) for t in carry)),
                                  z.to(dev), u.to(dev))
        reset_launch_counts()
        new, _ = step(st, ctx.train, None, None, adj, aw)
        kernel = gossip_mix_fused_dp if dp else gossip_mix_flat
        assert kernel.launches == (1 if dev.type == "cuda" else 0)
        out[dev.type] = [t.cpu() for t in (new.centers, new.u, new.comm_bytes, aw,
                                           *new_carry)]
    (pc, uc, bc, wc, sc, ac), (pg, ug, bg, wg, sg, ag) = out["cpu"], out["cuda"]
    assert torch.equal(sc, sg) and torch.equal(ac, ag) and torch.equal(wc > 0, wg > 0)
    torch.testing.assert_close(wg, wc, rtol=2.4e-7, atol=0)
    assert bool((wc > 0).any()) and bool((wc == 0).any()) and bool(((wc > 0) & (wc < 1)).any())
    assert _max_err(pg, pc) <= TOL and _max_err(ug, uc) <= TOL
    assert float(bg) == float(bc)


@pytest.mark.parametrize("dp", [False, True])
def test_scenario_replay_equals_the_eager_loop(cuda, dp):
    """A schedule tape, the dropout stream and a heterogeneity carry: the
    replay equals the loop bit for bit (staleness too), one exchange
    kernel in every replayed round."""
    from repro_torch.experiments.heterogeneity import ClientSystemModel
    from repro_torch.experiments.scenarios import Scenario
    from repro_torch.graphs.topology import rewire_schedule

    data, exp = _engine_setup()
    scenario = Scenario(graph_schedule=rewire_schedule("er", 8, 3.0, exp.rounds, seed=2),
                        dropout=0.2, seed=1, system=ClientSystemModel(**SCEN_SYSTEM))
    opts = dict(ENGINE_DP if dp else {}, keep_state=True)
    reset_launch_counts()
    loop = run_method("fedspd", data, exp, cfg=RunConfig(eval_every=1, scan_rounds=False,
                                                         scenario=scenario, options=opts))
    counts = {k.__name__: k.launches for k in KERNELS}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        scan = run_method("fedspd", data, exp, cfg=RunConfig(eval_every=1, scenario=scenario,
                                                             options=opts))
    _assert_same_run(loop, scan)
    assert (loop.extras["staleness"] == scan.extras["staleness"]).all()
    assert counts["gossip_mix_fused_dp" if dp else "gossip_mix_flat"] == exp.rounds
    assert _replayed_exchange_kernels(prof) == [1] * exp.rounds
    assert (scan.extras["n_captures"], scan.extras["n_dispatches"]) == (1, exp.rounds)


# the main-path variants on the card: a conv round and an aligned DP round
# against the same round on the CPU with the same injected draws, and the
# conv, permute-wiring and aligned-DP replays against their loops
VARIANT_ROUNDS = {
    "conv": ("conv", {}),
    "aligned-dp": ("mlp", dict(ENGINE_DP, cos_align_threshold=0.0)),
}


@pytest.mark.parametrize("label", list(VARIANT_ROUNDS))
def test_variant_round_on_the_card_equals_the_cpu(cuda, label):
    from repro_torch.core.fedspd import make_round_step
    from repro_torch.experiments.registry import build_context, get_method

    model, options = VARIANT_ROUNDS[label]
    data, exp = _engine_setup()
    exp = dataclasses.replace(exp, model=model)
    n, m_pts, cpu = data.n_clients, data.x.shape[1], torch.device("cpu")
    opts = RunConfig(options=options).resolve_options()
    m = get_method("fedspd")
    st0 = m.init(build_context(data, exp, cpu, options=opts), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = st0.centers.shape[-1]
    draws = dict(s=torch.randint(0, 2, (n,), generator=g),
                 idx=torch.randint(0, m_pts, (exp.tau, n, exp.batch), generator=g),
                 noise=torch.randn((n, x), generator=g))
    out = {}
    for dev in (cpu, cuda):
        ctx = build_context(data, exp, dev, options=opts)
        spec = m._spec(ctx)
        step = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, m._fcfg(ctx),
                               pack_spec=ctx.pack_spec)
        reset_launch_counts()
        new, _ = step(_fedspd_state_to(st0, dev), ctx.train,
                      **{k: v.to(dev) for k, v in draws.items()})
        # an aligned DP round sanitizes, then mixes in kernel 1: never kernel 2
        assert gossip_mix_fused_dp.launches == 0
        assert gossip_mix_flat.launches == (1 if dev.type == "cuda" else 0)
        out[dev.type] = [t.cpu() for t in (new.centers, new.u, new.comm_bytes)]
    (pc, uc, bc), (pg, ug, bg) = out["cpu"], out["cuda"]
    assert _max_err(pg, pc) <= TOL and _max_err(ug, uc) <= TOL
    assert float(bg) == float(bc)


VARIANT_REPLAYS = {
    "conv": ("fedspd", "conv", {}),
    "conv-dp": ("fedspd", "conv", dict(options=ENGINE_DP)),
    "fedspd_permute": ("fedspd_permute", "mlp", {}),
    "permute-reference": ("fedspd_permute", "mlp", dict(gossip_backend="reference")),
    "aligned-dp": ("fedspd", "mlp", dict(options=dict(ENGINE_DP, cos_align_threshold=0.0))),
}


@pytest.mark.parametrize("label", list(VARIANT_REPLAYS))
def test_variant_replay_equals_the_eager_loop(cuda, label):
    """Each replay equals its loop bit for bit, with one exchange kernel in
    every replayed round on the kernels' backend (the permute wiring on
    "reference" mixes by gathers: no exchange kernel)."""
    method, model, kw = VARIANT_REPLAYS[label]
    kw = dict(kw, options=dict(kw.get("options", {}), keep_state=True))
    data, exp = _engine_setup()
    exp = dataclasses.replace(exp, model=model)
    reset_launch_counts()
    loop = run_method(method, data, exp, cfg=RunConfig(eval_every=1, scan_rounds=False, **kw))
    counts = {k.__name__: k.launches for k in KERNELS}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        scan = run_method(method, data, exp, cfg=RunConfig(eval_every=1, **kw))
    _assert_same_run(loop, scan)
    per_round = 0 if label == "permute-reference" else 1
    assert _replayed_exchange_kernels(prof) == [per_round] * exp.rounds
    assert sum(counts.values()) == per_round * exp.rounds
    fused = label == "conv-dp"
    assert counts["gossip_mix_fused_dp"] == (exp.rounds if fused else 0)
    assert (scan.extras["n_captures"], scan.extras["n_dispatches"]) == (1, exp.rounds)


# the baselines' compressed exchange: each replay against its loop, one
# exchange kernel (the one named) in every replayed round
BASELINE_COMM = {
    "dfl_fedavg-int8-ef": ("dfl_fedavg", INT8, "gossip_mix_dequant"),
    "dfl_fedavg-int4": ("dfl_fedavg", CommConfig(codec="int4"), "gossip_mix_dequant"),
    "dfl_fedavg-topk-ef": ("dfl_fedavg", CommConfig(codec="topk", error_feedback=True),
                           "gossip_mix_flat"),
    "dfl_fedem-int8-ef": ("dfl_fedem", INT8, "gossip_mix_stack"),
    "dfl_fedem-topk-ef": ("dfl_fedem", CommConfig(codec="topk", error_feedback=True),
                          "gossip_mix_stack"),
}


@pytest.mark.parametrize("label", list(BASELINE_COMM))
def test_compressed_baseline_replay_equals_the_eager_loop(cuda, label):
    method, comm, kernel = BASELINE_COMM[label]
    data, exp = _engine_setup()
    cfg = RunConfig(eval_every=1, comm=comm, options={"keep_state": True})
    reset_launch_counts()
    loop = run_method(method, data, exp, cfg=dataclasses.replace(cfg, scan_rounds=False))
    counts = {k.__name__: k.launches for k in KERNELS}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        scan = run_method(method, data, exp, cfg=cfg)
    _assert_same_run(loop, scan)
    assert counts == {k: (exp.rounds if k == kernel else 0) for k in counts}
    assert _replayed_exchange_kernels(prof) == [1] * exp.rounds
    assert 0 < scan.wire_bytes < scan.comm_bytes
    assert (scan.extras["n_captures"], scan.extras["n_dispatches"]) == (1, exp.rounds)


def test_optimizer_round_on_the_card_equals_the_cpu(cuda):
    """One FedSPD round driven by AdamW (eps 1e-3, as in
    tests/test_torch_optim.py) and a cosine schedule, and ``local_sgd``
    with momentum, on the card against the CPU with the same draws."""
    from repro_torch.baselines.common import local_sgd
    from repro_torch.core.fedspd import make_round_step
    from repro_torch.experiments.registry import build_context, get_method
    from repro_torch.optim import adamw, cosine_with_warmup, momentum

    data, exp = _engine_setup()
    n, m_pts, cpu = data.n_clients, data.x.shape[1], torch.device("cpu")
    m = get_method("fedspd")
    st0 = m.init(build_context(data, exp, cpu), torch.Generator().manual_seed(0))
    st0 = st0._replace(round=3)
    g = torch.Generator().manual_seed(1)
    s = torch.randint(0, 2, (n,), generator=g)
    idx = torch.randint(0, m_pts, (exp.tau, n, exp.batch), generator=g)
    out = {}
    for dev in (cpu, cuda):
        ctx = build_context(data, exp, dev)
        step = make_round_step(ctx.loss_fn, ctx.pel_fn, m._spec(ctx), m._fcfg(ctx),
                               pack_spec=ctx.pack_spec, optimizer=adamw(eps=1e-3),
                               lr_schedule=cosine_with_warmup(exp.lr0, warmup=2, total=6))
        new, met = step(_fedspd_state_to(st0, dev), ctx.train, s=s.to(dev), idx=idx.to(dev))
        plane = local_sgd(ctx.loss_fn, st0.centers[0].to(dev, copy=True), ctx.train, None,
                          exp.tau, exp.batch, exp.lr0, pack_spec=ctx.pack_spec,
                          optimizer=momentum(), idx=idx.to(dev))
        assert met["lr"].device.type == dev.type
        out[dev.type] = [t.cpu() for t in (new.centers, new.u, plane)]
    (pc, uc, qc), (pg, ug, qg) = out["cpu"], out["cuda"]
    assert _max_err(pg, pc) <= TOL and _max_err(ug, uc) <= TOL and _max_err(qg, qc) <= TOL


# --------------------------------------------------------------------------
# the per-leaf pytree engine (RunConfig(param_plane=False))
# --------------------------------------------------------------------------

# the mlp's leaf widths at dim 64 and 10 classes, and a one-column leaf
TREE_WIDTHS = [1, 10, 64, 640, 8192]


@pytest.mark.parametrize("x", TREE_WIDTHS)
def test_tree_mix_launches_kernel_1_once_a_leaf(cuda, x):
    """``gossip_mix_tree`` at N = 20 over a contiguous ``(20, x)`` leaf, a
    column slice of a wider plane (the view ``unpack`` gives: its rows are
    not contiguous) and a transposed ``(20, 2, x)`` leaf: one launch a
    leaf, each against its plain version, and the views' results equal to
    the kernel on their contiguous copies bit for bit."""
    from repro_torch.kernels.gossip_mix import gossip_mix_tree, gossip_mix_tree_ref

    g = torch.Generator(device=cuda).manual_seed(x)
    w, c, _, _, _ = _operands(cuda, 20, x, seed=x)
    wide = torch.randn((20, x + 7), generator=g, device=cuda)
    base = torch.randn((20, x, 2), generator=g, device=cuda)
    tree = {"a": c, "b": {"slice": wide[:, 3:3 + x], "t": base.transpose(1, 2)}}
    # (the transposed view of a one-column leaf is contiguous by torch's rule)
    assert not tree["b"]["slice"].is_contiguous()
    assert tree["b"]["t"].is_contiguous() == (x == 1)
    reset_launch_counts()
    out = gossip_mix_tree(w, tree)
    assert gossip_mix_flat.launches == 3
    assert all(k.launches == 0 for k in KERNELS if k is not gossip_mix_flat)
    ref = gossip_mix_tree_ref(w, tree)
    for key, got, want in (("a", out["a"], ref["a"]),
                           ("slice", out["b"]["slice"], ref["b"]["slice"]),
                           ("t", out["b"]["t"], ref["b"]["t"])):
        assert got.shape == want.shape and _max_err(got, want) <= TOL, key
    assert torch.equal(out["b"]["slice"],
                       gossip_mix_flat(w, wide[:, 3:3 + x].contiguous()))
    assert torch.equal(out["b"]["t"], gossip_mix_flat(
        w, base.transpose(1, 2).contiguous().reshape(20, -1)).reshape(20, 2, x))


PYTREE_RUNS = {
    # label: (method, options, the kernel a leaf launches)
    "fedspd": ("fedspd", {}, "gossip_mix_flat"),
    "fedspd-dp": ("fedspd", {"dp_clip": 1.0, "dp_noise_multiplier": 0.5}, "gossip_mix_flat"),
    "dfl_fedavg": ("dfl_fedavg", {}, "gossip_mix_flat"),
    "dfl_fedem": ("dfl_fedem", {}, "gossip_mix_stack"),
}


@pytest.mark.parametrize("label", list(PYTREE_RUNS))
def test_pytree_replay_equals_the_eager_loop(cuda, label):
    """The pytree engine's replay equals its loop bit for bit; the loop
    launches the exchange kernel once a leaf a round (6 leaves: the mlp's
    three layers' w and b) and kernel 2 never, DP or not; every replayed
    round launches 6 exchange kernels."""
    method, opts, kernel = PYTREE_RUNS[label]
    data, exp = _engine_setup()
    cfg = RunConfig(eval_every=1, param_plane=False, options=dict(opts, keep_state=True))
    reset_launch_counts()
    loop = run_method(method, data, exp, cfg=dataclasses.replace(cfg, scan_rounds=False))
    counts = {k.__name__: k.launches for k in KERNELS}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        scan = run_method(method, data, exp, cfg=cfg)
    _assert_same_run(loop, scan)
    st = scan.extras["state"]
    assert isinstance(st if isinstance(st, dict) else st.centers, dict)
    assert counts == {k: (6 * exp.rounds if k == kernel else 0) for k in counts}
    assert _replayed_exchange_kernels(prof) == [6] * exp.rounds
    assert (scan.extras["n_captures"], scan.extras["n_dispatches"]) == (1, exp.rounds)


@pytest.mark.parametrize("dp", [False, True])
def test_pytree_round_on_the_card_equals_the_cpu(cuda, dp):
    """One pytree FedSPD round on the card (kernel 1 a leaf) against the
    same round on the CPU (the plain versions), with the same selections,
    batch indices and per-leaf DP noise."""
    from repro_torch.core.fedspd import make_round_step
    from repro_torch.core.gossip import make_mix_fn
    from repro_torch.experiments.registry import build_context, get_method
    from repro_torch.utils.pytree import tree_leaves, tree_map

    data, exp = _engine_setup()
    opts = {"param_plane": False}
    if dp:
        opts.update(dp_clip=1.0, dp_noise_multiplier=0.5)
    n, m_pts, cpu = data.n_clients, data.x.shape[1], torch.device("cpu")
    m = get_method("fedspd")
    st0 = m.init(build_context(data, exp, cpu, options=opts), torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    s = torch.randint(0, 2, (n,), generator=g)
    idx = torch.randint(0, m_pts, (exp.tau, n, exp.batch), generator=g)
    noise = tree_map(lambda leaf: torch.randn(leaf.shape[1:], generator=g), st0.centers)
    out = {}
    for dev in (cpu, cuda):
        ctx = build_context(data, exp, dev, options=opts)
        spec = m._spec(ctx)
        step = make_round_step(ctx.loss_fn, ctx.pel_fn, spec, m._fcfg(ctx),
                               mix_fn=make_mix_fn(spec, plane=False))
        st = st0._replace(centers=tree_map(lambda leaf: leaf.to(dev, copy=True), st0.centers),
                          u=st0.u.to(dev), z=st0.z.to(dev), comm_bytes=st0.comm_bytes.to(dev),
                          gen=torch.Generator(device=dev))
        reset_launch_counts()
        new, _ = step(st, ctx.train, s=s.to(dev), idx=idx.to(dev),
                      noise=tree_map(lambda t: t.to(dev), noise) if dp else None)
        if dev.type == "cuda":
            assert gossip_mix_flat.launches == 6 and gossip_mix_fused_dp.launches == 0
        out[dev.type] = [t.cpu() for t in tree_leaves(new.centers)] + [new.u.cpu()]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _max_err(a, b) <= TOL



# --------------------------------------------------------------------------
# the telemetry streams on the card
# --------------------------------------------------------------------------


def test_telemetry_collector_on_the_card_equals_the_cpu_s(cuda):
    """The collector at the main path's shape (N = 20, S = 2, X = 17,226),
    with activity weights, staleness past the last bin and masks: the count
    streams exactly, the others within 1e-5 (reductions in another order),
    the spectral gap through its ρ within 1e-6."""
    from types import SimpleNamespace

    from repro_torch.telemetry import TelemetryConfig, make_collector

    n, s, x = 20, 2, 17226
    g = torch.Generator().manual_seed(0)
    u0, u1 = (torch.softmax(torch.randn((n, s), generator=g), -1) for _ in range(2))
    m0 = torch.rand((n, x), generator=g) < 0.2
    m1 = m0 ^ (torch.rand((n, x), generator=g) < 0.05)
    adj = (torch.rand((n, n), generator=g) < 0.3).float()
    adj = ((adj + adj.T) > 0).float() + torch.eye(n)
    w = torch.rand(n, generator=g)
    w[w < 0.3] = 0.0
    adj = adj * (w > 0)[:, None] * w[None, :]
    stale = torch.randint(0, 9, (n,), generator=g, dtype=torch.int32)
    bag = dict(old=dict(u=u0, comm_bytes=torch.tensor(1.0e6), mask=m0),
               new=dict(u=u1, comm_bytes=torch.tensor(2.5e6), mask=m1,
                        centers=torch.randn((s, n, x), generator=g)))
    col = make_collector(TelemetryConfig(), n_clusters=s, n_clients=n, has_mask=True,
                         wire_ratio=5655 / 68904)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        st = {k: SimpleNamespace(**{f: t.to(dev) for f, t in v.items()}) for k, v in bag.items()}
        got = col(st["old"], st["new"], adj.to(dev), weights=w.to(dev), stale=stale.to(dev))
        out[dev.type] = {k: v.cpu() for k, v in got.items()}
    for name, want in out["cpu"].items():
        got = out["cuda"][name]
        if name in ("logical_bytes", "wire_bytes", "degree", "stale_hist", "n_inactive"):
            assert torch.equal(got, want), name
        elif name == "spectral_gap":
            torch.testing.assert_close(1.0 - got, 1.0 - want, rtol=1e-6, atol=0)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0, msg=name)


TELEMETRY_PATHS = {
    "fedspd": ("fedspd", {}),
    "fedspd dp": ("fedspd", dict(options=dict(ENGINE_DP))),
    "fedspd pytree": ("fedspd", dict(param_plane=False)),
    "fedspd sparse int8+ef": ("fedspd", dict(comm=CommConfig(codec="int8", error_feedback=True),
                                              sparse=SparseConfig(density=0.3,
                                                                  update_every=2))),
    "dfl_fedem": ("dfl_fedem", {}),
}


@pytest.mark.parametrize("label", list(TELEMETRY_PATHS))
def test_telemetry_replay_streams_equal_the_loop_s(cuda, label):
    """The streams inside the captured round: the replay's equal the loop's
    bit for bit, and telemetry changes nothing of the replayed run (its
    accuracies, bytes, final state, captures and dispatches)."""
    import numpy as np

    from repro_torch.telemetry import TelemetryConfig

    method, kw = TELEMETRY_PATHS[label]
    kw = dict(kw, options=dict(kw.get("options", {}), keep_state=True))
    data, exp = _engine_setup()
    tel = TelemetryConfig()
    loop = run_method(method, data, exp, cfg=RunConfig(eval_every=1, scan_rounds=False,
                                                       telemetry=tel, **kw))
    scan = run_method(method, data, exp, cfg=RunConfig(eval_every=1, telemetry=tel, **kw))
    off = run_method(method, data, exp, cfg=RunConfig(eval_every=1, **kw))
    _assert_same_run(loop, scan)
    _assert_same_run(off, scan)
    for k in ("n_captures", "n_compiles", "n_dispatches"):
        assert scan.extras[k] == off.extras[k], k
    assert scan.extras["n_compiles"] == (2 if "sparse" in label else 1)
    assert loop.extras["n_compiles"] == 0
    for name, v in loop.telemetry["streams"].items():
        assert np.array_equal(v, scan.telemetry["streams"][name], equal_nan=True), name
    assert np.isfinite(scan.telemetry["streams"]["consensus"]).all()


# --------------------------------------------------------------------------
# launch/train.py on the card (the train launcher slice)
# --------------------------------------------------------------------------

TRAIN_SMOKE = ["--smoke", "--rounds", "4", "--clients", "4", "--clusters", "2", "--batch",
               "4", "--seq", "64", "--graph", "er", "--avg-degree", "2", "--eval-every",
               "100", "--mask-update-every", "2"]
TRAIN_HET = ["--time-budget", "1.5", "--slow-fraction", "0.5", "--p-unavailable", "0.2",
             "--staleness-gamma", "0.5"]
TRAIN_CASES = {
    # label: (arch, flags, launches of the 4 loop rounds; None: kernel 1 a leaf)
    "olmo": ("olmo-1b", [], {"gossip_mix_flat": 4}),
    "zamba2": ("zamba2-1.2b", [], {"gossip_mix_flat": 4}),
    "olmoe": ("olmoe-1b-7b", [], {"gossip_mix_flat": 4}),
    "mamba2 int8+ef": ("mamba2-370m", ["--codec", "int8", "--error-feedback"],
                       {"gossip_mix_dequant": 4}),
    "sparse int8+ef": ("olmo-1b", ["--sparse-density", "0.2", "--codec", "int8",
                                   "--error-feedback"],
                       {"gossip_mix_sparse": 4, "gossip_mix_dequant_masked": 4}),
    "pytree": ("olmo-1b", ["--pytree"], None),
    "het": ("gemma3-1b", TRAIN_HET, {"gossip_mix_flat": 4}),
    "whisper": ("whisper-base", [], {"gossip_mix_flat": 4}),
}


@pytest.mark.parametrize("label", list(TRAIN_CASES))
def test_train_launcher_replay_equals_the_loop(cuda, label):
    """``python -m repro_torch.launch.train`` at smoke size on the card: the
    loop's exchange kernels counted (none of kernels 8 and 9: the training
    route), and ``--scan-rounds`` (one captured round replayed; two graphs
    where the sparse masks update) equal to the loop bit for bit."""
    from repro_torch.kernels import gossip_mix
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.launch.train import main
    from repro_torch.utils.pytree import tree_leaves

    arch, flags, want = TRAIN_CASES[label]
    argv = ["--arch", arch] + TRAIN_SMOKE + flags
    gossip_mix.reset_launch_counts()
    flash_attention.launches = ssd_scan.launches = 0
    loop = main(argv)
    if want is None:
        want = {"gossip_mix_flat": 4 * len(tree_leaves(loop["state"].centers))}
    for k in gossip_mix.KERNELS:
        assert k.launches == want.get(k.__name__, 0), k.__name__
    assert flash_attention.launches == ssd_scan.launches == 0
    scan = main(argv + ["--scan-rounds"])
    assert scan["n_captures"] == (2 if "sparse" in label else 1)
    for a, b in zip(state_tensors(loop["state"]), state_tensors(scan["state"])):
        assert torch.equal(a, b)
    assert loop["final_loss"] == scan["final_loss"]
    assert scan["round_ms"] and all(v > 0 for v in scan["round_ms"])


def test_flat_kernel_at_the_lm_exchange_matches_plain(cuda):
    """Kernel 1 at the full-width mamba2-370m exchange, (N, X) = (4,
    420,136,448): 13.44 GB of operands, byte offsets past 2^32."""
    n, x = 4, 420_136_448
    g = torch.Generator(device=cuda).manual_seed(0)
    w = torch.rand((n, n), generator=g, device=cuda)
    w = w / w.sum(dim=1, keepdim=True)
    c = torch.randn((n, x), generator=g, device=cuda)
    out = gossip_mix_flat(w, c)
    assert _max_err(out, gossip_mix_flat_ref(w, c)) <= TOL
    # the last columns, past 2^32 bytes of the plane, against their own mix
    tail = slice(x - 4096, x)
    assert _max_err(out[:, tail], w @ c[:, tail]) <= TOL
    del out, c
    torch.cuda.empty_cache()


@pytest.fixture
def nccl_world(cuda, tmp_path):
    """A process group of one rank over NCCL on the card (a file store in
    ``tmp_path``), destroyed after the test."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield dist
    finally:
        dist.destroy_process_group()


def test_mesh_round_at_world_one_equals_the_one_device_round(nccl_world):
    """The mesh round (``make_fedspd_train_step(mesh=...)`` on
    ``shard_plane_state``) over a (1, 1) NCCL mesh, 3 full-regime rounds of
    the mlp plane at N = 1, S = 2: plane, u and comm_bytes bit for bit the
    one-device round's on a copy of the state, the selections drawn alike;
    the registry's ppermute backend runs the loop there."""
    import types

    from repro_torch.core.fedspd import FedSPDConfig, init_state, make_round_step
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.experiments.runner import _copy_state
    from repro_torch.graphs.topology import make_graph
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_fedspd_train_step

    assert nccl_world.get_backend() == "nccl"
    mesh = make_test_mesh((1, 1), device_type="cuda")
    dev = torch.device("cuda")
    data = make_mixture_classification(n_clients=1, n_per_client=64, dim=16, n_classes=4)
    train = {"inputs": torch.as_tensor(data.x, device=dev),
             "targets": torch.as_tensor(data.y, device=dev)}
    params, _, loss, pel, _ = make_classifier("mlp", torch.Generator(device=dev), 16, 4)
    spec = make_pack_spec(params)
    fcfg = FedSPDConfig(n_clients=1, n_clusters=2, batch=16)
    gossip = GossipSpec.from_graph(make_graph("er", 1, 3.0, seed=0))
    state = init_state(torch.Generator(device=dev).manual_seed(0),
                       lambda g: make_classifier("mlp", g, 16, 4)[0], fcfg, data_m=64, spec=spec)
    one, placed = _copy_state(state), shd.shard_plane_state(state, mesh)
    single = make_round_step(loss, pel, gossip, fcfg, pack_spec=spec)
    step = make_fedspd_train_step(types.SimpleNamespace(loss=loss, per_example_loss=pel),
                                  gossip, fcfg, pack_spec=spec, mesh=mesh)
    g = torch.Generator(device=dev).manual_seed(1)
    for _ in range(3):
        idx = torch.randint(0, 64, (fcfg.tau, 1, fcfg.batch), generator=g, device=dev)
        one, a = single(one, train, idx=idx)
        placed, b = step(placed, train, idx=idx)
        assert torch.equal(a["selected"], b["selected"])
        assert torch.equal(a["consensus"], b["consensus"])
    loc = shd.local_state(placed)
    assert loc.centers.is_cuda and loc.centers.shape == one.centers.shape
    for f in ("centers", "u", "comm_bytes"):
        assert torch.equal(getattr(loc, f), getattr(one, f)), f
    full = shd.gather_plane_state(placed)
    assert torch.equal(full.centers, one.centers)
    exp = PaperExpConfig(n_clients=1, n_per_client=64, dim=16, n_classes=4, rounds=2)
    r = run_method("fedspd", data, exp, cfg=RunConfig(gossip_backend="ppermute"))
    ref = run_method("fedspd", data, exp, cfg=RunConfig(gossip_backend="reference",
                                                        scan_rounds=False))
    assert r.extras["n_captures"] == 0 and r.acc_per_client.tolist() == \
        ref.acc_per_client.tolist()


def test_ppermute_registry_refuses_a_replay_on_the_card(cuda):
    """scan_rounds=True with the ppermute backend on CUDA raises by name:
    capturing NCCL send/recv in a CUDA graph waits for a multi-card run."""
    data = make_mixture_classification(n_clients=4, n_per_client=16)
    with pytest.raises(ValueError, match="capturing NCCL send/recv in a CUDA graph"):
        run_method("fedspd", data, PaperExpConfig(rounds=1, n_clients=4),
                   cfg=RunConfig(gossip_backend="ppermute", scan_rounds=True))
