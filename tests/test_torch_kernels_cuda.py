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
from deepaco_tpu_torch.aco.runner import ACOConfig, track_best
from deepaco_tpu_torch.core.builders import start_node_features
from deepaco_tpu_torch.core.graph import topk_smallest
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.ops import _build, fused_gnn, two_opt
from deepaco_tpu_torch.ops import cvrp_construct as cc
from deepaco_tpu_torch.ops import philox
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


@pytest.mark.parametrize("n,k,b,node_update", [
    (100, 1, 3, True),        # one edge a node: one row of a 16-row tile
    (100, 13, 3, True),       # one ragged tile a node
    (100, 50, 3, True),       # the main path's K: three whole tiles and two rows
    (64, 64, 3, True),        # K = N: four whole tiles
    (3072, 50, 1, True),      # K1's largest N, one instance
    (100, 13, 3, False),      # no node update
])
def test_dense_heuristic_kernel_at_tile_ragged_shapes(dev, n, k, b, node_update):
    """K1 against its plain version where K is not a multiple of the
    edge pass's and the head's 16-row tiles, with the tsp500 weights:
    rtol 1e-4, atol 1e-5, and log(heu) on the support within 1e-4 (sums in
    another order; the products in 3xTF32)."""
    net = Net.from_jax_variables(
        load_checkpoint(str(CKPT / "tsp500_selftrained.msgpack"))).to(dev)
    net.emb_net.node_update = node_update
    coords = uniform_coords(n, torch.Generator().manual_seed(n + k), batch=b, device=dev)
    dist = distance_matrix(coords)
    before = fused_gnn.tsp_dense_heuristic.launches
    got = fused_gnn.tsp_dense_heuristic(net, coords, dist, k)
    assert fused_gnn.tsp_dense_heuristic.launches == before + 1
    ref = fused_gnn.tsp_dense_heuristic_plain(net, coords, dist, k)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    support = topk_smallest(dist, k)[1]
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


def _sweep_case(dev, n, a, b, seed):
    """Scores on a grid of halves (ties are common, so the first maximum is
    tested) and random start cities."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    score = torch.randint(-8, 8, (b, n, n), generator=gen, device=dev).float() / 2
    start = torch.randint(0, n, (b, a), generator=gen, device=dev)
    return score, start, gen


def _assert_sweep_matches_plain(score, start, gen):
    b, n, _ = score.shape
    greedy = bt.dense_sweep_fused(score, start, gen, stochastic=False)
    assert torch.equal(greedy, bt.dense_sweep(score, start, gen, stochastic=False))
    paths = bt.dense_sweep_fused(score, start, gen)
    assert torch.equal(paths[:, 0], start)
    ident = torch.arange(n, device=score.device)[None, :, None]
    assert torch.equal(torch.sort(paths, dim=1).values, ident.expand_as(paths))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("a", [1, 3])
@pytest.mark.parametrize("n", [2, 33, 129, 1001, 3000])
def test_sweep_kernel_at_ragged_shapes(dev, n, a, dtype):
    """K2 takes every N: a thread owns several groups of 4 columns past
    128 columns a warp, odd N loads column by column, and few columns run on
    fewer warps."""
    score, start, gen = _sweep_case(dev, n, a, 2, n + a)
    _assert_sweep_matches_plain(score.to(dtype), start, gen)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sweep_kernel_at_n_4096(dev, dtype):
    score, start, gen = _sweep_case(dev, 4096, 2, 1, 5)
    _assert_sweep_matches_plain(score.to(dtype), start, gen)


def _update_case(dev, b, n, a, seed):
    """Random permutation tours over a seeded instance, tau in [0.5, 1.5),
    a log heuristic and a best-so-far state that instance 0 beats and the
    others do not (from B=3 the last ties its cheapest tour, which keeps it)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dist = distance_matrix(uniform_coords(n, torch.Generator().manual_seed(seed), batch=b,
                                          device=dev))
    paths = torch.argsort(torch.rand((b, a, n), generator=gen, device=dev), dim=-1)
    paths = paths.transpose(1, 2).contiguous()
    tau = 0.5 + torch.rand((b, n, n), generator=gen, device=dev)
    log_heu = torch.log(torch.rand((b, n, n), generator=gen, device=dev) + 1e-3)
    state = bt._batched_init(b, n, ACOConfig(n_ants=a), dev)
    cheapest = tour_cost(dist, paths).min(-1).values
    best = cheapest - 1.0
    best[0] = cheapest[0] + 1.0
    if b > 2:
        best[-1] = cheapest[-1]
    best_path = torch.randint(0, n, (b, n), generator=gen, device=dev)
    state = state._replace(phe=state.phe._replace(tau=tau), best_cost=best,
                           best_path=best_path)
    return state, paths, dist, log_heu


def _assert_update_matches_plain(state, paths, dist, log_heu, **kw):
    """K3 against its plain version: tau' and costs at rtol 1e-6 (the plain
    version sums in other orders), the best state what ``track_best`` makes
    of the kernel's costs and the score what ``next_score`` makes of the
    kernel's tau', both bit for bit."""
    before = bt.fused_tsp_update.launches
    got, costs, score = bt.fused_tsp_update(state, paths, dist, log_heu=log_heu, **kw)
    assert bt.fused_tsp_update.launches == before + 1
    ref, ref_costs, _ = bt.fused_tsp_update_plain(state, paths, dist, log_heu=log_heu, **kw)
    torch.testing.assert_close(got.phe.tau, ref.phe.tau, rtol=1e-6, atol=0)
    torch.testing.assert_close(costs, ref_costs, rtol=1e-6, atol=0)
    want = track_best(state, paths, costs)
    assert torch.equal(got.best_cost, want.best_cost)
    assert torch.equal(got.best_path, want.best_path)
    if log_heu is None:
        assert score is None
    else:
        dtype = kw.get("score_dtype", torch.bfloat16)
        assert torch.equal(score, bt.next_score(got.phe.tau, log_heu, kw.get("alpha", 1.0),
                                                dtype))


@pytest.mark.parametrize("symmetric", [True, False])
def test_update_kernel_matches_plain(dev, instance, symmetric):
    _, dist = instance
    gen = torch.Generator(device=dev).manual_seed(2)
    paths = torch.stack([torch.stack([torch.randperm(100, generator=gen, device=dev)
                                      for _ in range(8)], dim=1) for _ in range(3)])
    tau = 0.5 + torch.rand((3, 100, 100), generator=gen, device=dev)
    state = bt._batched_init(3, 100, ACOConfig(n_ants=8), dev)
    state = state._replace(phe=state.phe._replace(tau=tau))
    _assert_update_matches_plain(state, paths, dist, None, decay=0.9, q=1.0,
                                 symmetric=symmetric)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,a,symmetric,floor", [
    (100, 500, 20, True, 0.0),     # the main path's shape
    (16, 500, 20, True, 0.0),      # the NLS path's
    (2, 2, 3, True, 0.0), (3, 33, 5, False, 0.0), (2, 129, 40, True, 0.7),
    (2, 1001, 20, False, 0.7), (1, 1000, 33, True, 0.0)])
def test_update_kernel_at_ragged_shapes(dev, b, n, a, symmetric, floor, dtype):
    """K3 with the score at the main and NLS shapes, at N that is not a
    multiple of 4 (the row pass reads column by column there), more than 32
    ants and a floor."""
    state, paths, dist, log_heu = _update_case(dev, b, n, a, n + a)
    _assert_update_matches_plain(state, paths, dist, log_heu, decay=0.9, q=1.0,
                                 symmetric=symmetric, floor=floor, alpha=1.5,
                                 score_dtype=dtype)


def test_update_kernel_stops_on_a_tour_that_is_not_a_permutation(dev):
    # a device-side assert ends the CUDA context, so it runs in a child
    code = """
import torch
from deepaco_tpu_torch.aco import batched_tsp as bt
from deepaco_tpu_torch.aco.runner import ACOConfig
dev = torch.device("cuda")
paths = torch.arange(50, device=dev).repeat(2, 1).T[None].contiguous()
paths[0, 7, 1] = 3            # ant 1 visits city 3 twice and never city 7
tau = torch.ones((1, 50, 50), device=dev)
state = bt._batched_init(1, 50, ACOConfig(n_ants=2), dev)
bt.fused_tsp_update(state, paths, tau, decay=0.9, q=1.0, log_heu=tau)
torch.cuda.synchronize()
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "device-side assert" in proc.stdout + proc.stderr


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,a,symmetric,floor", [
    (100, 500, 20, True, 0.0), (2, 2, 3, True, 0.0), (3, 33, 5, False, 0.0),
    (2, 129, 40, True, 0.7), (2, 1001, 20, False, 0.7), (1, 1000, 33, True, 0.0),
    (1, 70, 2, True, 0.0)])
def test_update_kernel_unstaged_variant_equals_staged(dev, b, n, a, symmetric, floor, dtype):
    """K3's unstaged variant (every N past the staged limit; ``staged=False``
    here) gives the staged variant's bits: tau', costs, best state and
    score, at the main shape, ragged N, more than 32 ants and a floor."""
    state, paths, dist, log_heu = _update_case(dev, b, n, a, n + a)
    kw = dict(decay=0.9, q=1.0, symmetric=symmetric, floor=floor, log_heu=log_heu,
              alpha=1.5, score_dtype=dtype)
    before = bt.fused_tsp_update.launches
    got, costs, score = bt.fused_tsp_update(state, paths, dist, staged=False, **kw)
    assert bt.fused_tsp_update.launches == before + 1
    ref, ref_costs, ref_score = bt.fused_tsp_update(state, paths, dist, staged=True, **kw)
    assert torch.equal(got.phe.tau, ref.phe.tau) and torch.equal(costs, ref_costs)
    assert torch.equal(got.best_cost, ref.best_cost)
    assert torch.equal(got.best_path, ref.best_path) and torch.equal(score, ref_score)
    got, costs, score = bt.fused_tsp_update(state, paths, dist, staged=False,
                                            **{**kw, "log_heu": None})
    assert score is None and torch.equal(got.phe.tau, ref.phe.tau)


def test_update_kernel_unstaged_variant_stops_on_a_tour_that_is_not_a_permutation(dev):
    # the unstaged row pass finds the city that no tour reached
    code = """
import torch
from deepaco_tpu_torch.aco import batched_tsp as bt
from deepaco_tpu_torch.aco.runner import ACOConfig
dev = torch.device("cuda")
paths = torch.arange(50, device=dev).repeat(2, 1).T[None].contiguous()
paths[0, 7, 1] = 3            # ant 1 visits city 3 twice and never city 7
tau = torch.ones((1, 50, 50), device=dev)
state = bt._batched_init(1, 50, ACOConfig(n_ants=2), dev)
bt.fused_tsp_update(state, paths, tau, decay=0.9, q=1.0, log_heu=tau, staged=False)
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


@pytest.fixture(scope="module")
def grid_case(dev):
    """A tie-heavy instance: 500 cities on a 20 x 25 grid, where many moves
    change the length by the same amount, random tours, and the metric of
    heuristic_dist(1/d), whose bf16 rounding ties more entries still."""
    ii, jj = torch.meshgrid(torch.arange(20), torch.arange(25), indexing="ij")
    coords = (torch.stack([ii, jj], -1).reshape(1, 500, 2).float() / 25).to(dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    tours = torch.stack([torch.randperm(500, generator=gen, device=dev)
                         for _ in range(4)])[None].contiguous()
    return coords, two_opt.heuristic_dist(1.0 / distance_matrix(coords)), tours


def test_ls_kernels_on_a_grid_keep_the_first_of_tied_moves(grid_case):
    """K4 and K5 on the grid: tours exactly equal to the plain versions',
    which take the first flat argmin among equal deltas."""
    coords, hd, tours = grid_case
    got = two_opt.batched_two_opt_euclid(coords, tours, 10000)
    assert torch.equal(got, two_opt.batched_two_opt_euclid_plain(coords, tours, 10000))
    got = two_opt.batched_nls_euclid(coords, hd, tours, 10000, 2, 5)
    assert torch.equal(got, two_opt.batched_nls_euclid_plain(coords, hd, tours, 10000, 2, 5))
    _assert_permutations(got)


def test_nls_kernel_on_a_metric_with_negative_entries_equals_plain(dev):
    """K5 prices only the pairs that can improve when every entry of the
    metric is non-negative; an instance with a negative entry walks every
    pair. A batch of one instance of each kind: tours exactly equal to the
    plain version's."""
    coords = uniform_coords(200, torch.Generator().manual_seed(5), batch=2, device=dev)
    g = torch.Generator(device=dev).manual_seed(6)
    hd = torch.rand((2, 200, 200), generator=g, device=dev)
    hd[1] -= 0.25                                          # negative entries in instance 1
    tours = torch.stack([torch.stack([torch.randperm(200, generator=g, device=dev)
                                      for _ in range(3)]) for _ in range(2)]).contiguous()
    got = two_opt.batched_nls_euclid(coords, hd, tours, 1000, 3, 10)
    assert torch.equal(got, two_opt.batched_nls_euclid_plain(coords, hd, tours, 1000, 3, 10))
    _assert_permutations(got)


def test_heuristic_past_k1_cap_takes_the_k9_route_on_the_card(dev):
    """batched_tsp_heuristic at n = 3073 (one past K1's cap) with the
    tsp500 weights: K1 does not launch, K9 does once, and the heuristic
    matches the plain route's at rtol 1e-4 / atol 1e-5 (sums in another
    order over 12 layers)."""
    from deepaco_tpu_torch.eval.anytime import batched_tsp_heuristic

    net = Net.from_jax_variables(
        load_checkpoint(str(CKPT / "tsp500_selftrained.msgpack"))).to(dev)
    coords = uniform_coords(3073, torch.Generator().manual_seed(3), batch=1, device=dev)
    before = (fused_gnn.tsp_dense_heuristic.launches, fused_gnn.embnet_layers.launches)
    heu, dist = batched_tsp_heuristic(net, coords, 50)
    assert (fused_gnn.tsp_dense_heuristic.launches,
            fused_gnn.embnet_layers.launches) == (before[0], before[1] + 1)
    want, _ = batched_tsp_heuristic(net, coords, 50, _ops=bt.PLAIN_OPS)
    torch.testing.assert_close(heu, want, rtol=1e-4, atol=1e-5)
    assert torch.equal(dist, distance_matrix(coords))


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


# ------------------------------------------------------ training kernels ---
@pytest.fixture(scope="module")
def layer_case(dev):
    """K6's inputs at B=2, N=200, K=20 on k-NN neighbours, and cotangents."""
    from deepaco_tpu_torch.ops import gnn_layer

    b, n, k, u = 2, 200, 20, 32
    coords = uniform_coords(n, torch.Generator().manual_seed(5), batch=b, device=dev)
    nbr = topk_smallest(distance_matrix(coords), k)[1]
    g = torch.Generator(device=dev).manual_seed(6)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    tensors = {"x2": rnd(b, n, u), "x3": rnd(b, n, u), "x4": rnd(b, n, u),
               "w": rnd(b, n, k, u), "ew": rnd(u, u) * 0.1, "eb": rnd(u) * 0.1}
    return tensors, nbr, gnn_layer.reverse_adjacency(nbr), rnd(b, n, u), rnd(b, n, k, u)


def _layer_args(t, nbr, index):
    return (t["x2"], t["x3"], t["x4"], nbr, t["w"], t["ew"], t["eb"], index)


def test_gnn_layer_kernel_forward_matches_plain(layer_case):
    from deepaco_tpu_torch.ops import gnn_layer

    t, nbr, index, _, _ = layer_case
    before = gnn_layer.fused_gnn_layer.launches
    with torch.no_grad():
        got = gnn_layer.fused_gnn_layer(*_layer_args(t, nbr, index))
        want = gnn_layer.fused_gnn_layer_plain(*_layer_args(t, nbr, index))
    assert gnn_layer.fused_gnn_layer.launches == before + 1
    for a, r in zip(got, want):                    # sum order
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def test_gnn_layer_kernel_backward_matches_plain(layer_case):
    """The backward entry on the same cotangents, and every input gradient
    through autograd; rtol 1e-4 and atol 1e-5 of the largest entry (sums of
    up to 4,000 terms, the plain scatter with atomics)."""
    from deepaco_tpu_torch.ops import gnn_layer

    t, nbr, index, ca, cp = layer_case
    before = gnn_layer.fused_gnn_layer_backward.launches
    got = gnn_layer.fused_gnn_layer_backward(t["x2"], index, t["w"], t["ew"], ca, cp)
    assert gnn_layer.fused_gnn_layer_backward.launches == before + 1
    want = gnn_layer.fused_gnn_layer_backward_plain(t["x2"], nbr, t["w"], t["ew"], ca, cp)
    for a, r in zip(got, want):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5 * r.abs().max().item())
    assert torch.equal(got[0], gnn_layer.fused_gnn_layer_backward(
        t["x2"], index, t["w"], t["ew"], ca, cp)[0])          # no atomics

    def grads(layer):
        leaves = {name: v.clone().requires_grad_(True) for name, v in t.items()}
        agg, pre = layer(*_layer_args(leaves, nbr, index))
        ((agg * ca).sum() + (torch.tanh(pre) * cp).sum()).backward()
        return [v.grad for v in leaves.values()]

    for a, r in zip(grads(gnn_layer.fused_gnn_layer), grads(gnn_layer.fused_gnn_layer_plain)):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5 * r.abs().max().item())


@pytest.mark.parametrize("n,k,b,graph", [
    (100, 1, 3, "knn"),       # one edge a row: one row of a 16-row tile
    (100, 13, 3, "knn"),      # one ragged tile a row
    (90, 37, 2, "knn"),       # two whole tiles and a ragged one
    (70, 70, 2, "dense"),     # K = N with self-loops (the CVRP graph's shape)
])
def test_gnn_layer_kernel_at_ragged_shapes(dev, n, k, b, graph):
    """K6 forward (and row 8), the backward entry and autograd's gradients
    where K is not a multiple of the edge loop's 16-row tiles, and on a dense
    graph with self-loops: forward rtol 1e-5 / atol 1e-5, gradients rtol
    1e-4 / atol 1e-5 of the largest entry (sums in other orders, the
    products in 3xTF32); a second call of each gives the same bits (no
    atomics)."""
    from deepaco_tpu_torch.ops import gnn_layer

    u = gnn_layer.UNITS
    coords = uniform_coords(n, torch.Generator().manual_seed(n + k), batch=b, device=dev)
    if graph == "dense":
        nbr = torch.arange(n, device=dev).expand(b, n, n)
    else:
        nbr = topk_smallest(distance_matrix(coords), k)[1]
    index = gnn_layer.reverse_adjacency(nbr)
    g = torch.Generator(device=dev).manual_seed(n * k)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    t = {"x2": rnd(b, n, u), "x3": rnd(b, n, u), "x4": rnd(b, n, u),
         "w": rnd(b, n, k, u), "ew": rnd(u, u) * 0.1, "eb": rnd(u) * 0.1}
    ca, cp = rnd(b, n, u), rnd(b, n, k, u)
    args = _layer_args(t, nbr, index)
    with torch.no_grad():
        got = gnn_layer.fused_gnn_layer(*args)
        again = gnn_layer.fused_gnn_layer(*args)
        want = gnn_layer.fused_gnn_layer_plain(*args)
        row8 = gnn_layer.gated_mean_aggregate(t["x2"], nbr, t["w"])
    for a, a2, r in zip(got, again, want):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        assert torch.equal(a, a2)
    torch.testing.assert_close(row8, want[0], rtol=1e-5, atol=1e-5)
    close = lambda a, r: torch.testing.assert_close(a, r, rtol=1e-4,
                                                    atol=1e-5 * r.abs().max().item())
    got = gnn_layer.fused_gnn_layer_backward(t["x2"], index, t["w"], t["ew"], ca, cp)
    again = gnn_layer.fused_gnn_layer_backward(t["x2"], index, t["w"], t["ew"], ca, cp)
    want = gnn_layer.fused_gnn_layer_backward_plain(t["x2"], nbr, t["w"], t["ew"], ca, cp)
    for a, a2, r in zip(got, again, want):
        close(a, r)
        assert torch.equal(a, a2)

    def grads(layer):
        leaves = {name: v.clone().requires_grad_(True) for name, v in t.items()}
        agg, pre = layer(*_layer_args(leaves, nbr, index))
        ((agg * ca).sum() + (torch.tanh(pre) * cp).sum()).backward()
        return [v.grad for v in leaves.values()]

    for a, r in zip(grads(gnn_layer.fused_gnn_layer), grads(gnn_layer.fused_gnn_layer_plain)):
        close(a, r)


def test_gated_mean_aggregate_kernel_matches_plain(layer_case):
    """Row 8 through K6's forward without pre, R=150 rows over N=200 nodes."""
    from deepaco_tpu_torch.ops import gnn_layer

    t, nbr, _, _, _ = layer_case
    x, rows_nbr, w = t["x2"], nbr[:, :150].contiguous(), t["w"][:, :150].contiguous()
    before = gnn_layer.gated_mean_aggregate.launches
    got = gnn_layer.gated_mean_aggregate(x, rows_nbr, w)
    assert gnn_layer.gated_mean_aggregate.launches == before + 1
    torch.testing.assert_close(got, gnn_layer.gated_mean_aggregate_plain(x, rows_nbr, w),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", [-1, 200])
def test_gated_mean_aggregate_refuses_an_id_out_of_range(layer_case, bad):
    """An id outside [0, N) raises before K6 reads x out of bounds."""
    from deepaco_tpu_torch.ops import gnn_layer

    t, nbr, _, _, _ = layer_case
    bad_nbr = nbr.clone()
    bad_nbr[1, 7, 3] = bad
    before = gnn_layer.gated_mean_aggregate.launches
    with pytest.raises(IndexError, match="outside"):
        gnn_layer.gated_mean_aggregate(t["x2"], bad_nbr, t["w"])
    assert gnn_layer.gated_mean_aggregate.launches == before


def test_pick_kernel_matches_plain(dev):
    """K7 on 96 rows of 300 with a third visited: actions exact, logp and
    the backward within 1e-5; ties go to the lowest index, NaN first."""
    from deepaco_tpu_torch.aco.engine import gumbel
    from deepaco_tpu_torch.ops import pick

    g = torch.Generator(device=dev).manual_seed(7)
    score = torch.randn((96, 300), generator=g, device=dev)
    mask = (torch.rand((96, 300), generator=g, device=dev) > 0.33).float()
    mask[:, 0] = 1.0
    noise = gumbel((96, 300), g, dev)
    before = pick.fused_pick.launches
    act, logp = pick.fused_pick(score, mask, noise)
    assert pick.fused_pick.launches == before + 1
    act_p, logp_p = pick.fused_pick_plain(score, mask, noise)
    assert torch.equal(act, act_p)
    torch.testing.assert_close(logp, logp_p, rtol=1e-5, atol=1e-5)
    c = torch.randn(96, generator=g, device=dev)

    def grad(fn):
        s = score.clone().requires_grad_(True)
        (fn(s, mask, noise)[1] * c).sum().backward()
        return s.grad

    torch.testing.assert_close(grad(pick.fused_pick), grad(pick.fused_pick_plain),
                               rtol=1e-5, atol=1e-6)
    ties = torch.zeros((2, 64), device=dev)
    ties[1, 40] = float("nan")
    tie_mask = torch.ones_like(ties)
    tie_mask[0, :3] = 0.0
    assert pick.fused_pick(ties, tie_mask, torch.zeros_like(ties))[0].tolist() == [3, 40]


def test_train_tsp_runs_on_the_card_through_the_kernels(dev):
    """One NLS-shaped step of train_tsp at N=60 on the default device:
    finite, and K6 (12 launches a direction at depth 12), K7 (N-1) and K5
    launched."""
    from deepaco_tpu_torch.ops import gnn_layer, pick
    from deepaco_tpu_torch.train import config, reinforce as tr

    cfg = config.ProblemConfig(n_nodes=60, k_sparse=6, aco=config.ACOSettings(n_ants=8),
                               train=config.TrainConfig(batch_size=2, cosine_schedule=True))
    counters = (gnn_layer.fused_gnn_layer, gnn_layer.fused_gnn_layer_backward,
                pick.fused_pick, two_opt.batched_nls_euclid)
    before = [fn.launches for fn in counters]
    infos = []
    state = tr.train_tsp(Net(feats=1), cfg, local_search=tr.nls_local_search(),
                         max_steps=1, progress=lambda i, info: infos.append(info))
    assert state.step == 1 and next(state.net.parameters()).is_cuda
    assert all(torch.isfinite(v).all() for v in infos[0])
    assert [fn.launches - b for fn, b in zip(counters, before)] == [12, 12, 59, 1]


def _deposit_case(dev, cyclic):
    """Paths [B=3, L, A=6] over n=120: permutation tours (cyclic), or CVRP
    routes that park on the depot for their last 100 steps (open)."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, n, a = 3, 120, 6
    if cyclic:
        paths = torch.stack([torch.stack([torch.randperm(n, generator=g, device=dev)
                                          for _ in range(a)], dim=1) for _ in range(b)])
    else:
        paths = torch.randint(0, n, (b, 2 * n + 1, a), generator=g, device=dev)
        paths[:, 0] = 0
        paths[:, -100:] = 0
    return paths, 0.01 + torch.rand((b, a), generator=g, device=dev), n


@pytest.mark.parametrize("cyclic", [True, False])
def test_tour_deposit_kernel_matches_plain(dev, cyclic):
    """K8 adds the ants in order: it equals scatter_add_ on the CPU (ant
    after ant, one add at a time) bit for bit and gives the same bits
    twice. scatter_add_ on the card adds with atomics in any order, so an
    entry that sums k positive terms may differ by the rounding of two such
    sums, 2 k 2^-24 of its value (k reaches 600 on the parked depot)."""
    from deepaco_tpu_torch.ops import deposit

    paths, amounts, n = _deposit_case(dev, cyclic)
    before = deposit.tour_deposit.launches
    got = deposit.tour_deposit(paths, amounts, n, cyclic=cyclic)
    assert deposit.tour_deposit.launches == before + 1
    assert torch.equal(got, deposit.tour_deposit(paths, amounts, n, cyclic=cyclic))
    cpu = deposit.tour_deposit_plain(paths.cpu(), amounts.cpu(), n, cyclic=cyclic)
    assert torch.equal(got.cpu(), cpu)
    plain = deposit.tour_deposit_plain(paths, amounts, n, cyclic=cyclic)
    k = deposit.tour_deposit_plain(paths, torch.ones_like(amounts), n, cyclic=cyclic)
    assert bool(((got - plain).abs() <= 2 * k * 2.0 ** -24 * got).all())


def _deposit_layout(dev, n, a, l, cyclic, seed):
    """Paths [2, L, A] over n nodes with amounts: permutation tours when
    cyclic; else routes from node 0 whose ants park on their last node for
    tails of every length from 0 to the whole path (ant 0 never leaves the
    depot, ant 1 does not park)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if cyclic:
        paths = torch.stack([torch.stack([torch.randperm(n, generator=g, device=dev)[:l]
                                          for _ in range(a)], dim=1) for _ in range(2)])
    else:
        paths = torch.randint(0, n, (2, l, a), generator=g, device=dev)
        paths[:, 0] = 0
        for ant in range(a):
            tail = 0 if ant == 1 else l - 1 if ant == 0 else (ant * 37) % l
            paths[:, l - 1 - tail:, ant] = paths[:, l - 1 - tail, ant][:, None].clone()
    return paths, 0.01 + torch.rand((2, a), generator=g, device=dev)


@pytest.mark.parametrize("n,a,l,cyclic", [
    (121, 6, 121, True),      # rows of 121 floats: every row starts off a 16-byte boundary
    (7, 3, 15, False),        # tails parked on nodes other than the depot
    (501, 20, 1001, False),   # the CVRP path's layout: 501 columns, 1001 steps
    (300, 100, 601, False),   # paths too long to stage in shared memory
    (3000, 20, 3000, True),   # 60,000 (row, ant) counts: past shared memory, kept in the scratch
    (1000, 60, 1001, False),  # the same at the CVRP layout with 60 ants, unstaged
    (40, 2500, 81, False),    # 2,500 ants: 12 bits of ant in a record
])
def test_tour_deposit_kernel_layouts(dev, n, a, l, cyclic):
    """K8 at several row and path layouts: bit-equal to scatter_add_ on the
    CPU (ant-major, one add at a time) and to itself on a second launch."""
    from deepaco_tpu_torch.ops import deposit

    paths, amounts = _deposit_layout(dev, n, a, l, cyclic, n + a)
    got = deposit.tour_deposit(paths, amounts, n, cyclic=cyclic)
    assert torch.equal(got, deposit.tour_deposit(paths, amounts, n, cyclic=cyclic))
    cpu = deposit.tour_deposit_plain(paths.cpu(), amounts.cpu(), n, cyclic=cyclic)
    assert torch.equal(got.cpu(), cpu)


def test_tour_deposit_kernel_stops_on_an_id_out_of_range(dev):
    # a device-side assert ends the CUDA context, so it runs in a child
    code = """
import torch
from deepaco_tpu_torch.ops import deposit
dev = torch.device("cuda")
paths = torch.zeros((2, 41, 4), dtype=torch.int64, device=dev)
paths[1, 5, 2] = 20           # n = 20: one id past the last node
deposit.tour_deposit(paths, torch.ones((2, 4), device=dev), 20, cyclic=False)
torch.cuda.synchronize()
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "device-side assert" in proc.stdout + proc.stderr


def test_evaluate_family_cvrp_runs_on_the_card_through_the_kernels(dev):
    """evaluate_family("cvrp") at n=20 on the card: finite, valid best
    routes, and K9 (the eval-mode net's folded layer stack, once), K7c (one
    an iteration, in place of K7's 2n steps) and K8 (one an iteration)
    launched, K6 and K7 not at all."""
    from deepaco_tpu_torch.aco.problems.cvrp import validate_routes
    from deepaco_tpu_torch.families import CVRP_CAPACITY, get_family
    from deepaco_tpu_torch.ops import deposit, gnn_layer, pick
    from deepaco_tpu_torch.train.drivers import evaluate_family, family_model
    from deepaco_tpu_torch.utils.golden import cvrp_test

    ds = {k: v[:4] for k, v in cvrp_test(20).items()}
    net = family_model(get_family("cvrp"),
                       load_checkpoint(str(CKPT / "cvrp20_selftrained.msgpack")))
    counters = (fused_gnn.embnet_layers, gnn_layer.fused_gnn_layer, pick.fused_pick,
                deposit.tour_deposit, cc.cvrp_construct)
    before = [fn.launches for fn in counters]
    means, curves, state = evaluate_family("cvrp", ds, n_nodes=20, net=net, n_ants=8,
                                           t_values=(1, 3), return_state=True)
    assert curves.is_cuda and bool(torch.isfinite(curves).all())
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 0, 0, 3, 3]
    demand = torch.from_numpy(ds["demand"]).to(dev)
    assert bool(validate_routes(state.best_path[..., None], demand, CVRP_CAPACITY).all())


@pytest.mark.parametrize("n,k,edge_feats,node_update", [
    (97, 20, 2, False),       # N not a multiple of 32, two edge features, no node update
    (70, 70, 1, True),        # a dense graph: every node its own neighbour too, K = N
    (130, 13, 4, True),       # the most edge features K9 takes
])
def test_embnet_layers_kernel_matches_plain(dev, n, k, edge_feats, node_update):
    """K9 against embnet_layers_plain: rtol 1e-4, atol 1e-5 on the edge
    state and on both heads (sums in another order over 12 layers)."""
    from deepaco_tpu_torch.models.gnn import init_like_flax

    net = init_like_flax(Net(edge_feats=edge_feats, node_update=node_update,
                             dual_heads=True).to(dev),
                         torch.Generator(device=dev).manual_seed(0)).eval()
    g = torch.Generator(device=dev).manual_seed(n)
    coords = torch.rand((3, n, 2), generator=g, device=dev)
    if k == n:
        nbr = torch.arange(n, device=dev).expand(3, n, n).contiguous()
    else:
        nbr = topk_smallest(distance_matrix(coords), k)[1]
    edge = torch.rand((3, n, k, edge_feats), generator=g, device=dev)
    f = fused_gnn.fold_embnet_params(net.emb_net)
    x = fused_gnn._node_embedding(f, coords)
    before = fused_gnn.embnet_layers.launches
    got = fused_gnn.embnet_layers(f, x, nbr, edge, k=k, node_update=node_update)
    assert fused_gnn.embnet_layers.launches == before + 1
    want = fused_gnn.embnet_layers_plain(f, x, nbr, edge, k=k, node_update=node_update)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    heads = fused_gnn.net_forward_fast(net, coords, nbr, edge, heads=("phe", "heu"))
    plain = fused_gnn.net_forward_fast(net, coords, nbr, edge, heads=("phe", "heu"),
                                       layers=fused_gnn.embnet_layers_plain)
    for a, b in zip(heads, plain):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,k,b,edge_feats", [
    (2000, 200, 1, 1),        # the sparse path's N and K: 12 whole tiles and 8 rows
    (130, 17, 3, 3),          # a tile and one row, three edge features
])
def test_embnet_layers_kernel_at_tile_ragged_shapes(dev, n, k, b, edge_feats):
    """K9 against embnet_layers_plain where K is not a multiple of the edge
    pass's 16-row tiles: rtol 1e-4, atol 1e-5 on the edge state and both
    heads (sums in another order over 12 layers; the products in 3xTF32).
    With one edge feature the weights are the sparse path's (tsp500) and the
    edge feature the neighbour distance; else Flax-law random weights. At
    K = 200 random weights let the edge state grow to about 250, where the
    plain f32 version itself is 8e-5 from float64, and a kernel summing in
    another order misses atol 1e-5 near zero (an edge pass on f32 FMAs on 4
    of 12.8 million entries): the next test holds that case against
    float64."""
    from deepaco_tpu_torch.aco.large_tsp import knn_support, sparse_tsp_graph
    from deepaco_tpu_torch.models.gnn import init_like_flax

    g = torch.Generator(device=dev).manual_seed(n + k)
    coords = torch.rand((b, n, 2), generator=g, device=dev)
    if edge_feats == 1:
        net = Net.from_jax_variables(
            load_checkpoint(str(CKPT / "tsp500_selftrained.msgpack"))).to(dev)
        graph = sparse_tsp_graph(coords, knn_support(coords, k))
        nbr, edge = graph.nbr, graph.edge
    else:
        net = init_like_flax(Net(edge_feats=edge_feats, dual_heads=True).to(dev),
                             torch.Generator(device=dev).manual_seed(k)).eval()
        nbr = topk_smallest(distance_matrix(coords), k)[1]
        edge = torch.rand((b, n, k, edge_feats), generator=g, device=dev)
    heads = ("phe", "heu") if net.dual_heads else ("heu",)
    f = fused_gnn.fold_embnet_params(net.emb_net)
    x = fused_gnn._node_embedding(f, coords)
    before = fused_gnn.embnet_layers.launches
    got = fused_gnn.embnet_layers(f, x, nbr, edge, k=k)
    assert fused_gnn.embnet_layers.launches == before + 1
    torch.testing.assert_close(got, fused_gnn.embnet_layers_plain(f, x, nbr, edge, k=k),
                               rtol=1e-4, atol=1e-5)
    out = fused_gnn.net_forward_fast(net, coords, nbr, edge, heads=heads)
    plain = fused_gnn.net_forward_fast(net, coords, nbr, edge, heads=heads,
                                       layers=fused_gnn.embnet_layers_plain)
    for a, r in zip(*((out, plain) if len(heads) > 1 else ((out,), (plain,)))):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)


def test_embnet_layers_kernel_with_random_weights_against_float64(dev):
    """K9 at the sparse path's N and K on one instance with Flax-law random
    weights, where the edge state grows to about 250 and the f32 function's
    own rounding exceeds atol 1e-5: the kernel (3xTF32 products, sums in
    another order) and the plain f32 version are both held against the
    plain version's steps run in float64, at atol 1e-4, the plain f32
    version's own error there (8.3e-5) rounded up."""
    from deepaco_tpu_torch.aco.large_tsp import knn_support, sparse_tsp_graph
    from deepaco_tpu_torch.models.gnn import init_like_flax

    n, k = 2000, 200
    coords = torch.rand((1, n, 2), generator=torch.Generator(device=dev).manual_seed(n + k),
                        device=dev)
    net = init_like_flax(Net().to(dev), torch.Generator(device=dev).manual_seed(k)).eval()
    g = sparse_tsp_graph(coords, knn_support(coords, k))
    f = fused_gnn.fold_embnet_params(net.emb_net)
    x = fused_gnn._node_embedding(f, coords)
    f64 = fused_gnn.FoldedEmbNet._make(t.double() for t in f)
    ref = fused_gnn._layer_stack_plain(
        f64, x.double(), torch.nn.functional.silu(g.edge.double() @ f64.we_in + f64.be_in),
        g.nbr, k, True)
    got = fused_gnn.embnet_layers(f, x, g.nbr, g.edge, k=k)
    plain = fused_gnn.embnet_layers_plain(f, x, g.nbr, g.edge, k=k)
    errors = {name: (out.double() - ref).abs().max().item()
              for name, out in (("kernel", got), ("plain f32", plain))}
    assert max(errors.values()) <= 1e-4, errors


def test_embnet_layers_kernel_refuses_what_it_does_not_take(dev):
    f = fused_gnn.fold_embnet_params(Net(edge_feats=5, depth=1).to(dev).emb_net)
    x = torch.zeros((1, 10, 32), device=dev)
    nbr = torch.zeros((1, 10, 3), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="E <= 4"):
        fused_gnn.embnet_layers(f, x, nbr, torch.zeros((1, 10, 3, 5), device=dev), k=3)
    f = fused_gnn.fold_embnet_params(Net(depth=1).to(dev).emb_net)
    with pytest.raises(ValueError, match=r"\[0, 10\)"):
        fused_gnn.embnet_layers(f, x, nbr + 10, torch.zeros((1, 10, 3, 1), device=dev), k=3)
    with pytest.raises(ValueError, match="K <= N"):
        fused_gnn.embnet_layers(f, x[:, :2], nbr[:, :2], torch.zeros((1, 2, 3, 1), device=dev),
                                k=3)


def test_tsp_sweep_construct_greedy_equals_dense_sweep(dev, instance):
    """Row 9 through K2 at B=1 with f32 scores: greedy tours exactly equal to
    dense_sweep's, stochastic ones permutations from the start cities."""
    _, dist = instance
    score = torch.log(1.0 / dist[0])
    gen = torch.Generator(device=dev).manual_seed(4)
    start = torch.randint(0, 100, (8,), generator=gen, device=dev)
    before = bt.tsp_sweep_construct.launches
    greedy = bt.tsp_sweep_construct(score, start, gen, stochastic=False)
    assert bt.tsp_sweep_construct.launches == before + 1
    assert torch.equal(greedy, bt.dense_sweep(score[None], start[None], gen,
                                              stochastic=False)[0])
    paths = bt.tsp_sweep_construct(score, start, gen)
    assert torch.equal(paths[0], start)
    assert torch.equal(torch.sort(paths, dim=0).values,
                       torch.arange(100, device=dev)[:, None].expand(100, 8))


def _cvrp_case(dev, b, n, seed, capacity):
    """Scores on a grid of halves (ties are common, so the first maximum is
    tested) and integer demands 1-9 with the depot at 0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    score = torch.randint(-8, 8, (b, n, n), generator=gen, device=dev).float() / 2
    demand = torch.randint(1, 10, (b, n), generator=gen, device=dev).float()
    demand[:, 0] = 0.0
    return score, demand


def _assert_cvrp_construct_matches_plain(score, demand, capacity, a, seed):
    """K7c's paths bit-equal to its plain version's from equal generator
    states, stochastic and greedy; the routes valid."""
    from deepaco_tpu_torch.aco.problems.cvrp import validate_routes

    dev = score.device
    for stochastic in (True, False):
        gens = [torch.Generator(device=dev).manual_seed(seed) for _ in range(2)]
        before = cc.cvrp_construct.launches
        got = cc.cvrp_construct(score, demand, capacity, a, gens[0], stochastic=stochastic)
        assert cc.cvrp_construct.launches == before + 1
        want = cc.cvrp_construct_plain(score, demand, capacity, a, gens[1],
                                       stochastic=stochastic)
        assert torch.equal(got, want)
        if bool((score[:, 0, 0] >= -1e30).all()):
            assert bool(validate_routes(got, demand, capacity).all())


@pytest.mark.parametrize("capacity", [50.0, 12.0])
@pytest.mark.parametrize("n,b,a", [(2, 3, 4), (21, 3, 1), (21, 4, 40), (101, 3, 7),
                                   (101, 50, 20), (501, 2, 40), (501, 40, 20),
                                   (1000, 2, 3), (4096, 1, 2)])
def test_cvrp_construct_kernel_equals_plain_bit_for_bit(dev, n, b, a, capacity):
    """K7c at N from 2 to 4096 (one to 8 groups of 4 columns a thread, 1 to
    4 warps an ant, row loads by column and, at N = 1000, by 4), A from 1 to
    40, capacity 50 and a tight one: paths equal to the plain version's."""
    score, demand = _cvrp_case(dev, b, n, n + a, capacity)
    _assert_cvrp_construct_matches_plain(score, demand, capacity, a, n * a)


def test_cvrp_construct_kernel_on_nan_and_a_depot_loop_below_minus_1e30(dev):
    """NaN rows and columns win as in torch.argmax; with -inf on an
    instance's depot self-loop a finished ant does not park: paths equal to
    the plain version's."""
    score, demand = _cvrp_case(dev, 3, 101, 9, 15.0)
    score[0, 7] = float("nan")
    score[1, :, 5] = float("nan")
    score[2, 0, 0] = float("-inf")
    _assert_cvrp_construct_matches_plain(score, demand, 15.0, 9, 11)


def test_cvrp_construct_kernel_refuses_what_it_does_not_take(dev):
    score, demand = _cvrp_case(dev, 1, 4097, 1, 50.0)
    gen = torch.Generator(device=dev)
    with pytest.raises(ValueError, match="4096"):
        cc.cvrp_construct(score, demand, 50.0, 2, gen)
    with pytest.raises(ValueError, match="f32"):
        cc.cvrp_construct(score[:, :8, :8].double(), demand[:, :8].double(), 50.0, 2, gen)
    with pytest.raises(ValueError, match="one CUDA device"):
        cc.cvrp_construct(score[:, :8, :8], demand[:, :8].cpu(), 50.0, 2, gen)


def _philox_sweep(score, start, key):
    """K2's sweep in PyTorch with K2's own noise: the Philox words of each
    step (``ops/philox.philox_bits``) through the bf16 table law or the
    f32 law, the plain sweep's mask and first maximum."""
    b, n, _ = score.shape
    a = start.shape[1]
    cur = start.reshape(-1)
    base = torch.arange(b, device=score.device).repeat_interleave(a) * n
    visited = torch.zeros((b * a, n), dtype=torch.bool, device=score.device)
    visited.scatter_(1, cur[:, None], True)
    steps = [cur]
    for s in range(n - 1):
        bits = philox.philox_bits(key, s, 1, b * a, n, score.device)[0]
        logits = torch.where(visited, torch.tensor(bt.NEG_INF, dtype=score.dtype,
                                                   device=score.device),
                             score.reshape(b * n, n).index_select(0, base + cur))
        if score.dtype == torch.bfloat16:
            logits = (logits.float() + philox.gumbel_bf16_from_bits(bits).float()).to(torch.bfloat16)
        else:
            logits = logits + philox.gumbel_f32_from_bits(bits)
        cur = torch.argmax(logits, dim=-1)
        visited.scatter_(1, cur[:, None], True)
        steps.append(cur)
    return torch.stack(steps, dim=1).reshape(b, a, n).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,a", [(33, 3), (500, 20)])
def test_sweep_kernel_draws_the_shared_philox_noise(dev, n, a, dtype):
    """K2's sampled paths equal a PyTorch sweep fed the words of the Philox
    that K2 and K7c share (``csrc/common.cuh``) under the seed its wrapper
    draws, in bf16 (the table law) and in f32: K2's noise stream is that
    Philox, word c % 4 of the counter (c // 4, step, ant, 0)."""
    score, start, gen = _sweep_case(dev, n, a, 2, n + 17)
    score = score.to(dtype)
    key = int(philox.draw_seed(torch.Generator(device=dev).manual_seed(n), dev).item())
    got = bt.dense_sweep_fused(score, start, torch.Generator(device=dev).manual_seed(n))
    assert torch.equal(got, _philox_sweep(score, start, key))


def test_main_path_past_k3_limit_takes_the_plain_update_on_the_card(dev):
    """run_anytime_batched at B=1, N = 19,001 (one past K3's staged limit),
    A=2, T=1: the update is one K3 launch (its unstaged variant), and the
    curve equals that of the same run with the plain update at K3's rtol
    1e-6; K3 at that N then holds against its plain version with the next
    score, and its staged variant refuses the N."""
    n = bt.K3_STAGED_MAX_N + 1
    coords = uniform_coords(n, torch.Generator().manual_seed(0), batch=1, device=dev)
    dist = distance_matrix(coords)
    heu = 1.0 / dist
    cfg = ACOConfig(n_ants=2)
    before = bt.fused_tsp_update.launches
    got = bt.run_anytime_batched(heu, dist, cfg, torch.Generator(device=dev).manual_seed(1), 1)
    assert bt.fused_tsp_update.launches == before + 1
    want = bt.run_anytime_batched(heu, dist, cfg, torch.Generator(device=dev).manual_seed(1), 1,
                                  _ops=bt.KERNEL_OPS._replace(update=bt.fused_tsp_update_plain))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    del heu, dist, coords
    state, paths, dist, log_heu = _update_case(dev, 1, n, 2, 3)
    _assert_update_matches_plain(state, paths, dist, log_heu, decay=0.9, q=1.0)
    with pytest.raises(ValueError, match="19000"):
        bt.fused_tsp_update(state, paths, dist, decay=0.9, q=1.0, staged=True)
