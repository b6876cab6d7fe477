"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and nvcc;
elsewhere they skip. On a machine with a card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepaco_tpu_torch.aco import batched_tsp as bt
from deepaco_tpu_torch.aco.problems.tsp import tour_cost
from deepaco_tpu_torch.core.graph import topk_smallest
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.ops import fused_gnn
from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "checkpoints"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def instance(dev):
    coords = uniform_coords(100, torch.Generator().manual_seed(0), batch=3, device=dev)
    return coords, distance_matrix(coords)


def test_dense_heuristic_kernel_matches_plain(dev, instance):
    coords, dist = instance
    net = Net.from_jax_variables(
        load_checkpoint(str(CKPT / "tsp100_selftrained.msgpack"))).to(dev)
    before = fused_gnn.tsp_dense_heuristic.launches
    got = fused_gnn.tsp_dense_heuristic(net, coords, dist, 10)
    ref = fused_gnn.tsp_dense_heuristic_plain(net, coords, dist, 10)
    assert fused_gnn.tsp_dense_heuristic.launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)   # sum order
    support = topk_smallest(dist, 10)[1]          # the score reads log(heu)
    torch.testing.assert_close(got.gather(2, support).log(),
                               ref.gather(2, support).log(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sweep_kernel_greedy_equal_and_stochastic_permutations(dev, instance, dtype):
    _, dist = instance
    score = (3 * torch.log(1.0 / dist)).to(dtype)
    gen = torch.Generator(device=dev).manual_seed(1)
    start = torch.randint(0, 100, (3, 8), generator=gen, device=dev)
    greedy = bt.dense_sweep_fused(score, start, gen, stochastic=False)
    assert torch.equal(greedy, bt.dense_sweep(score, start, gen, stochastic=False))
    paths = bt.dense_sweep_fused(score, start, gen)
    assert torch.equal(paths[:, 0], start)
    assert torch.equal(torch.sort(paths, dim=1).values,
                       torch.arange(100, device=dev)[None, :, None].expand_as(paths))
    assert tour_cost(dist, greedy).mean() < tour_cost(dist, paths).mean()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sweep_kernel_takes_nan_as_the_maximum(dev, instance, dtype):
    _, dist = instance
    score = 3 * torch.log(1.0 / dist)
    score[:, 5] = float("nan")                    # whole rows
    score[:, :, 3] = float("nan")                 # a whole column
    score = score.to(dtype)
    gen = torch.Generator(device=dev).manual_seed(3)
    start = torch.randint(0, 100, (3, 8), generator=gen, device=dev)
    greedy = bt.dense_sweep_fused(score, start, gen, stochastic=False)
    assert torch.equal(greedy, bt.dense_sweep(score, start, gen, stochastic=False))
    ident = torch.arange(100, device=dev)[None, :, None]
    for paths in (greedy, bt.dense_sweep_fused(score, start, gen)):
        assert torch.equal(torch.sort(paths, dim=1).values, ident.expand_as(paths))


@pytest.mark.parametrize("symmetric", [True, False])
def test_update_kernel_matches_plain(dev, instance, symmetric):
    _, dist = instance
    gen = torch.Generator(device=dev).manual_seed(2)
    paths = torch.stack([torch.stack([torch.randperm(100, generator=gen, device=dev)
                                      for _ in range(8)], dim=1) for _ in range(3)])
    tau = 0.5 + torch.rand((3, 100, 100), generator=gen, device=dev)
    got = bt.fused_tsp_update(tau, paths, dist, decay=0.9, q=1.0, symmetric=symmetric)
    ref = bt.fused_tsp_update_plain(tau, paths, dist, decay=0.9, q=1.0, symmetric=symmetric)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=0)


def test_update_kernel_stops_on_a_tour_that_is_not_a_permutation(dev):
    # a device-side assert ends the CUDA context, so it runs in a child
    code = """
import torch
from deepaco_tpu_torch.aco import batched_tsp as bt
dev = torch.device("cuda")
paths = torch.arange(50, device=dev).repeat(2, 1).T[None].contiguous()
paths[0, 7, 1] = 3            # ant 1 visits city 3 twice and never city 7
tau = torch.ones((1, 50, 50), device=dev)
bt.fused_tsp_update(tau, paths, tau, decay=0.9, q=1.0)
torch.cuda.synchronize()
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "device-side assert" in proc.stdout + proc.stderr
