"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors (max abs error 1e-5, TF32 off for both
matmul and cuDNN), the wrappers' checks and launch counters, and a short
run of the main path through the kernels.

Marked ``gpu``: each test asks a fixture for the card and skips without
one. Run on a machine with an H100: ``python -m pytest -q -m gpu
tests/test_torch_gpu.py``. This file imports no JAX, so it runs where
only PyTorch is installed."""
import pytest
import torch

from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import RunConfig, run_method
from repro_torch.kernels.gossip_mix import (
    gossip_mix_flat,
    gossip_mix_flat_ref,
    gossip_mix_fused_dp,
    gossip_mix_fused_dp_ref,
    reset_launch_counts,
)

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
