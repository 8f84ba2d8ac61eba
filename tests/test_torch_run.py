"""PyTorch port, the whole run: ``run_method("fedspd")`` in both packages
over seeds 0, 1, 2 for 10 rounds (JAX through ``run_method_batch``, one
compile). The two packages draw from different random streams, so the
runs are compared statistically: the mean of ``mean_acc`` over the seeds
must agree within max(0.02, the JAX runs' seed std) — the bound of
tests/test_comm.py."""
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import PaperExpConfig as JExp
from repro.data.synthetic import make_mixture_classification as j_data
from repro.experiments import RunConfig as JRunConfig
from repro.experiments import run_method_batch as j_run_method_batch
from repro_torch.configs.paper_cnn import PaperExpConfig
from repro_torch.data.synthetic import make_mixture_classification
from repro_torch.experiments import RunConfig, run_method
from repro_torch.kernels.gossip_mix import (
    gossip_mix_flat,
    gossip_mix_fused_dp,
    reset_launch_counts,
)

SEEDS = (0, 1, 2)
DATA = dict(n_clients=8, n_clusters=2, n_per_client=96, n_classes=4, dim=16)
EXP = dict(n_clients=8, n_per_client=96, n_classes=4, dim=16, rounds=10,
           avg_degree=3.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tensors are tiny: torch's intra-op thread pool only spins on
    them and takes CPU from the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_runs():
    data, exp = make_mixture_classification(**DATA), PaperExpConfig(**EXP)
    return [run_method("fedspd", data, exp, seed=s,
                       cfg=RunConfig(device="cpu", gossip_backend="cuda",
                                     eval_every=10**9))
            for s in SEEDS]


def test_whole_run_matches_jax_within_the_seed_statistical_bound(port_runs):
    jres = j_run_method_batch(
        "fedspd", j_data(**DATA), JExp(**EXP), seeds=SEEDS,
        cfg=JRunConfig(param_plane=True, eval_every=10**9))
    jacc = np.array([r.mean_acc for r in jres])
    tacc = np.array([r.mean_acc for r in port_runs])
    tol = max(0.02, float(np.std(jacc)))
    assert abs(jacc.mean() - tacc.mean()) <= tol, (jacc, tacc, tol)
    for r in port_runs:
        assert np.isfinite(r.mean_acc) and r.acc_per_client.shape == (8,)
        assert r.comm_bytes > 0 and r.comm_bytes == r.wire_bytes
        assert len(r.extras["round_ms"]) == 10
        assert [rd for rd, _ in r.curve] == [0, 9]
        np.testing.assert_allclose(r.extras["u"].sum(axis=1), 1.0, atol=1e-6)


def test_cuda_backend_on_cpu_runs_the_plain_versions(port_runs):
    """On CPU tensors the "cuda" backend takes the kernels' plain versions
    and launches nothing; "reference" and the default name the same path."""
    data, exp = make_mixture_classification(**DATA), PaperExpConfig(**EXP)
    for dp in ({}, {"dp_clip": 1.0, "dp_noise_multiplier": 0.5}):
        reset_launch_counts()
        runs = [run_method("fedspd", data, exp, seed=0,
                           cfg=RunConfig(device="cpu", gossip_backend=b,
                                         eval_every=10**9, options=dp))
                for b in ("cuda", "reference", None)]
        assert gossip_mix_flat.launches == 0
        assert gossip_mix_fused_dp.launches == 0
        if not dp:
            assert runs[0].mean_acc == port_runs[0].mean_acc
        for r in runs[1:]:
            assert np.array_equal(runs[0].acc_per_client, r.acc_per_client)
            assert runs[0].comm_bytes == r.comm_bytes
