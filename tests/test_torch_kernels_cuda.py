"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and nvcc;
elsewhere they skip. On a machine with a card:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepaco_tpu_torch.aco import batched_tsp as bt
from deepaco_tpu_torch.aco.problems.tsp import tour_cost
from deepaco_tpu_torch.core.builders import start_node_features
from deepaco_tpu_torch.core.graph import topk_smallest
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.ops import _build, fused_gnn, two_opt
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


@pytest.fixture(scope="module", params=[500, 1100])
def ls_case(request, dev):
    """Coordinates, the real asymmetric NLS metric heuristic_dist(heu) from the
    tsp_nls500 weights, tours and budgets. N=500: tours that K2 samples from
    city 0 on that heuristic, the NLS protocol's budgets; N=1100 (the range of
    the TPU's tiled kernels): random permutations and small budgets."""
    n = request.param
    b, a = (2, 8) if n == 500 else (1, 2)
    coords = uniform_coords(n, torch.Generator().manual_seed(n), batch=b, device=dev)
    dist = distance_matrix(coords)
    net = Net.from_jax_variables(
        load_checkpoint(str(CKPT / "tsp_nls500_selftrained.msgpack"))).to(dev)
    heu = fused_gnn.tsp_dense_heuristic(net, start_node_features(coords), dist, 50)
    gen = torch.Generator(device=dev).manual_seed(4)
    if n == 500:
        score = torch.log(heu).to(torch.bfloat16)
        start = torch.zeros((b, a), dtype=torch.int64, device=dev)
        tours = bt.dense_sweep_fused(score, start, gen).transpose(1, 2)
        budgets = (10000, 10, 20)
    else:
        tours = torch.stack([torch.randperm(n, generator=gen, device=dev)
                             for _ in range(a)])[None]
        budgets = (50, 1, 5)
    return coords, two_opt.heuristic_dist(heu), tours.contiguous(), budgets


def _assert_permutations(tours):
    n = tours.shape[-1]
    assert torch.equal(torch.sort(tours, dim=-1).values,
                       torch.arange(n, device=tours.device).expand_as(tours))


def test_two_opt_kernel_equals_plain(ls_case):
    coords, _, tours, (budget, _, _) = ls_case
    before = two_opt.batched_two_opt_euclid.launches
    got = two_opt.batched_two_opt_euclid(coords, tours, budget)
    assert two_opt.batched_two_opt_euclid.launches == before + 1
    assert torch.equal(got, two_opt.batched_two_opt_euclid_plain(coords, tours, budget))
    _assert_permutations(got)
    assert not torch.equal(got, tours)


def test_nls_kernel_equals_plain(ls_case):
    coords, hd, tours, (budget, t_nls, t_p) = ls_case
    assert not torch.equal(hd, hd.transpose(1, 2))
    before = two_opt.batched_nls_euclid.launches
    got = two_opt.batched_nls_euclid(coords, hd, tours, budget, t_nls, t_p)
    assert two_opt.batched_nls_euclid.launches == before + 1
    want = two_opt.batched_nls_euclid_plain(coords, hd, tours, budget, t_nls, t_p)
    assert torch.equal(got, want)
    _assert_permutations(got)


EUCLID_PAIRS = r"""
#include "two_opt.cu"

// All pairs of coords [B, n, 2] through euclid(), the distance K4 and K5 use.
__global__ void all_pairs(const float* coords, float* out, int B, int n) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)B * n * n) return;
  const float* c = coords + idx / ((long)n * n) * n * 2;
  const int i = (int)(idx / n % n), j = (int)(idx % n);
  out[idx] = deepaco::euclid(c[2 * i], c[2 * i + 1], c[2 * j], c[2 * j + 1]);
}

extern "C" int euclid_pairs(const float* coords, float* out, int B, int n, void* stream) {
  const long total = (long)B * n * n;
  all_pairs<<<(unsigned)((total + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      coords, out, B, n);
  return cudaGetLastError();
}
"""


def test_kernel_distance_is_distance_matrix_bit_for_bit(dev, tmp_path):
    """K4 and K5's pair distance, built here into a library of the test's own
    over all pairs, equals ``distance_matrix`` off the diagonal bit for bit."""
    src, lib = tmp_path / "euclid_pairs.cu", tmp_path / "libeuclid_pairs.so"
    src.write_text(EUCLID_PAIRS)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared",
                           "-I", str(_build.CSRC), str(src), "-o", str(lib)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    fn = ctypes.CDLL(str(lib)).euclid_pairs
    fn.argtypes = [_build.P, _build.P, _build.I, _build.I, _build.P]
    fn.restype = ctypes.c_int
    coords = uniform_coords(700, torch.Generator().manual_seed(9), batch=2, device=dev)
    got = torch.empty((2, 700, 700), device=dev)
    _build.check(fn(coords.data_ptr(), got.data_ptr(), 2, 700, _build.stream_ptr(dev)),
                 "euclid_pairs")
    want = distance_matrix(coords)
    off = ~torch.eye(700, dtype=torch.bool, device=dev)
    assert torch.equal(got[:, off], want[:, off])


def test_ls_wrappers_refuse_tensors_off_the_card(dev):
    coords = uniform_coords(30, torch.Generator().manual_seed(0), batch=1, device=dev)
    tours = torch.arange(30)[None, None]                  # on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        two_opt.batched_two_opt_euclid(coords, tours, 5)
    with pytest.raises(ValueError, match="CUDA"):
        two_opt.batched_nls_euclid(coords, torch.ones(1, 30, 30), tours, 5)
