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
from deepaco_tpu_torch.utils import metrics
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


def _traced_nls(*args, plain=False):
    """An NLS call inside a ``local_search`` span with tracing on: its tours
    and the span's ``nls.*`` counters."""
    metrics.reset()
    fn = two_opt.batched_nls_euclid_plain if plain else two_opt.batched_nls_euclid
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with metrics.phase("local_search"):
            out = fn(*args)
    counters = metrics.report()["local_search"]["counters"]
    metrics.reset()
    return out, counters


def test_nls_kernel_counts_equal_plain(ls_case):
    """K5's scans and moves equal the plain version's on tours where both
    return the same tours; the call's shape is counted on the host."""
    coords, hd, tours, (budget, t_nls, t_p) = ls_case
    got, counted = _traced_nls(coords, hd, tours, budget, t_nls, t_p)
    want, plain = _traced_nls(coords, hd, tours, budget, t_nls, t_p, plain=True)
    assert torch.equal(got, want)
    assert counted == plain
    b, a, n = tours.shape
    assert counted["nls.tours"] == b * a and counted["nls.n"] == n
    assert counted["nls.euclid_scans"] >= b * a * (1 + t_nls) and counted["nls.moves"] > 0


def test_nls_kernel_tours_with_and_without_counters_are_bit_equal(ls_case):
    coords, hd, tours, (budget, t_nls, t_p) = ls_case
    off = two_opt.batched_nls_euclid(coords, hd, tours, budget, t_nls, t_p)
    on, counted = _traced_nls(coords, hd, tours, budget, t_nls, t_p)
    assert torch.equal(on, off) and counted["nls.calls"] == 1


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


@pytest.mark.parametrize("b,parts", [(1, 2), (1, 8), (3, 2), (3, 8)])
def test_gnn_layer_rows_kernel_on_a_row_shard_matches_plain(dev, b, parts):
    """K6's forward on each of ``parts`` row shards (R = N/parts rows
    against the N-node tables, the row-sharded GNN's call) against the
    plain layer on the shard and against the whole layer's rows: rtol 1e-5,
    atol 1e-5 (sums in another order, products in 3xTF32); one launch a
    shard, and a second call gives the same bits."""
    from deepaco_tpu_torch.ops import gnn_layer

    n, k, u = 256, 20, gnn_layer.UNITS
    coords = uniform_coords(n, torch.Generator().manual_seed(b + parts), batch=b, device=dev)
    nbr = topk_smallest(distance_matrix(coords), k)[1]
    g = torch.Generator(device=dev).manual_seed(parts)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x2, x3, x4, w = rnd(b, n, u), rnd(b, n, u), rnd(b, n, u), rnd(b, n, k, u)
    ew, eb = rnd(u, u) * 0.1, rnd(u) * 0.1
    with torch.no_grad():
        whole = gnn_layer.fused_gnn_layer_plain(x2, x3, x4, nbr, w, ew, eb)
    r = n // parts
    for i in range(parts):
        rows = slice(i * r, (i + 1) * r)
        args = (x2, x3[:, rows], x4, nbr[:, rows], w[:, rows], ew, eb)
        before = gnn_layer.fused_gnn_layer_rows.launches
        got = gnn_layer.fused_gnn_layer_rows(*args)
        assert gnn_layer.fused_gnn_layer_rows.launches == before + 1
        again = gnn_layer.fused_gnn_layer_rows(*args)
        want = gnn_layer.fused_gnn_layer_plain(*args)
        for a, a2, p, full in zip(got, again, want, whole):
            assert a.shape == p.shape
            torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(a, full[:, rows], rtol=1e-5, atol=1e-5)
            assert torch.equal(a, a2)


def test_gnn_layer_rows_refuses_an_id_out_of_range(dev):
    """An id outside the N-node tables raises before K6 reads them."""
    from deepaco_tpu_torch.ops import gnn_layer

    u = gnn_layer.UNITS
    x = torch.zeros(1, 40, u, device=dev)
    nbr = torch.zeros(1, 10, 4, dtype=torch.int64, device=dev)
    nbr[0, 3, 1] = 40
    before = gnn_layer.fused_gnn_layer_rows.launches
    with pytest.raises(IndexError, match="outside"):
        gnn_layer.fused_gnn_layer_rows(x, x[:, :10], x, nbr, torch.zeros(1, 10, 4, u, device=dev),
                                       torch.zeros(u, u, device=dev), torch.zeros(u, device=dev))
    assert gnn_layer.fused_gnn_layer_rows.launches == before


def test_sharded_embnet_forward_on_a_one_rank_nccl_group(dev):
    """``parallel.sharded_embnet_forward`` on a one-rank NCCL group (the
    world a single card gives) with the tsp500 weights on a k-NN graph of
    N=500, K=50: eval and train mode against the unsharded ``EmbNet`` with
    the plain layer (train mode on a copy, whose running statistics move;
    the sharded forward's do not), within 1e-4 of the largest entry (12
    layers of K6 in 3xTF32 against f32 products); 12 K6 launches a call."""
    import copy

    import torch.distributed as dist

    from deepaco_tpu_torch.core.graph import knn_graph
    from deepaco_tpu_torch.ops import gnn_layer
    from deepaco_tpu_torch.parallel import make_mesh, sharded_embnet_forward
    from deepaco_tpu_torch.parallel.multihost import init_distributed

    net = Net.from_jax_variables(
        load_checkpoint(str(CKPT / "tsp500_selftrained.msgpack"))).to(dev)
    emb = net.emb_net.eval()
    coords = uniform_coords(500, torch.Generator().manual_seed(3), batch=1, device=dev)
    g = knn_graph(coords, distance_matrix(coords), 50)
    assert not dist.is_initialized()
    init_distributed(num_processes=1)
    try:
        mesh = make_mesh(1, 1)
        before = {k: v.clone() for k, v in emb.state_dict().items()}
        for train in (False, True):
            launches = gnn_layer.fused_gnn_layer_rows.launches
            got = sharded_embnet_forward(emb, g.x[0], g.nbr[0], g.edge[0], mesh, train=train)
            assert gnn_layer.fused_gnn_layer_rows.launches == launches + emb.depth
            ref_net = copy.deepcopy(emb).train(train)
            with torch.no_grad():
                want = ref_net(g, gnn_layer.fused_gnn_layer_plain)[0]
            scale = want.abs().max().item()
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)
        assert all(torch.equal(v, emb.state_dict()[k]) for k, v in before.items())
    finally:
        dist.destroy_process_group()


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


def _rollout_case(dev, kind, b, n, a, capacity=None, seed=0):
    """K7r's inputs: a score matrix ``log(heu)`` of a random heuristic, the
    starts (uniform for ``"tsp"`` and MKP's real items, city 0 for
    ``"tsp0"`` and SOP, the depot for CVRP), noise for every step, and the
    shape: CVRP demands 1-9, or k/150 at capacity 1 (CVRP-NLS), or BPP's
    sizes 20-100 at capacity 150; SOP's precedences of ``families.gen_sop``
    (N nodes); MKP's weights of ``families.gen_mkp`` (N - 1 items in 5
    dimensions and the dummy, capacity (N - 1) // 2); OP's distances of
    ``families.gen_op`` (N - 1 nodes and the dummy; ``"op_rand"``: uniform
    distances, no metric, so that a column out of reach once can fit later)
    with a budget of 1-4 an instance; PCTSP's prizes of ``families.gen_pctsp``
    (the depot and N - 1 customers) with the gate (N - 1) / 4; MKP-items'
    weights of ``families.gen_mkp_items`` (N - 1 items in 5 dimensions and
    the dummy, capacity 1) under one score row an instance, every ant on
    the dummy; RCPSP's direct evaluation on seeded ProGen instances of N
    activities, ``p = exp(score) * heu^2`` with the classic heuristic and
    the score ``where(p > 0, log p, -1e30)`` on ``prec = adj^T``
    (``"rcpsp_zero"``: 40% of p set to 0; ``"rcpsp_dead"``: the rows of
    activities 3-8 at 0, so that an ant on one has every open activity at p
    = 0 and the pick takes column 0 again); RCPSP's summation blend
    (``"blend"``, gamma 0.5, c 0.6; ``"blend_sum"``: c 0; ``"blend_half"``:
    alpha 0.5; ``"blend_zero"``, ``"blend_dead"``: the heuristic's entries
    and rows of ``"rcpsp_zero"`` and ``"rcpsp_dead"``) through ``rcpsp_spec``
    on a pheromone in (0.5, 1.5) and the classic heuristic."""
    import numpy as np

    from deepaco_tpu_torch.aco.engine import gumbel
    from deepaco_tpu_torch.aco.problems.op import extend_op_instance
    from deepaco_tpu_torch.core import rcpsp as core
    from deepaco_tpu_torch.families import gen_mkp, gen_mkp_items, gen_op, gen_pctsp, gen_sop
    from deepaco_tpu_torch.ops import rollout

    g = torch.Generator(device=dev).manual_seed(seed)
    score = torch.log(0.01 + torch.rand((b, n, n), generator=g, device=dev))
    rng = np.random.default_rng(seed)
    if kind == "sop":
        prec = torch.as_tensor(np.stack([gen_sop(rng, n)["prec"] for _ in range(b)]),
                               device=dev)
        start = torch.zeros((b, a), dtype=torch.int64, device=dev)
        shape, t = rollout.RolloutShape("sop", prec=prec), n - 1
    elif kind == "mkp":
        w = torch.as_tensor(np.stack([gen_mkp(rng, n - 1)["weight"] for _ in range(b)]),
                            device=dev)
        weight = torch.cat([w, torch.zeros((b, 1, w.shape[-1]), device=dev)], dim=1)
        start = torch.randint(0, n - 1, (b, a), generator=g, device=dev)
        shape, t = rollout.RolloutShape("mkp", capacity=(n - 1) // 2, weight=weight,
                                        dummy=n - 1), n
    elif kind.startswith("op"):
        dist = (np.stack([gen_op(rng, n - 1)["dist"] for _ in range(b)]) if kind == "op"
                else (0.05 + rng.random((b, n - 1, n - 1))).astype(np.float32))
        dist = torch.as_tensor(dist, device=dev)
        dist = extend_op_instance(dist, dist[..., 0], dist)[0]
        max_len = torch.as_tensor(rng.uniform(1.0, 4.0, b).astype(np.float32), device=dev)
        start = torch.zeros((b, a), dtype=torch.int64, device=dev)
        shape, t = rollout.RolloutShape("op", dist=dist, max_len=max_len, dummy=n - 1), n
    elif kind == "items":
        w = torch.as_tensor(np.stack([gen_mkp_items(rng, n - 1)["weight"] for _ in range(b)]),
                            device=dev)
        weight = torch.cat([w, torch.zeros((b, 1, w.shape[-1]), device=dev)], dim=1)
        score = score[:, 0].contiguous()
        start = torch.full((b, a), n - 1, dtype=torch.int64, device=dev)
        shape, t = rollout.RolloutShape("items", capacity=1.0, weight=weight, dummy=n - 1), n
    elif kind.startswith("blend"):
        from deepaco_tpu_torch.aco.problems import rcpsp as apr

        data = core.stack_rcpsp([core.parse_rcp(core.progen_rcp(rng, jobs=n - 2))
                                 for _ in range(b)], device=dev)
        heu = core.default_rcpsp_heuristic(data)
        if kind == "blend_zero":
            heu = heu * (torch.rand(heu.shape, generator=g, device=dev) >= 0.4)
        if kind == "blend_dead":
            heu[:, 3:9, :] = 0.0
        phe = 0.5 + torch.rand((b, n, n), generator=g, device=dev)
        cfg = apr.RCPSPConfig(n_ants=a, gamma=0.5, c=0.0 if kind == "blend_sum" else 0.6,
                              alpha=0.5 if kind == "blend_half" else 1.0)
        score, shape = apr.rcpsp_spec(phe, heu, data, cfg).fused
        start, t = torch.zeros((b, a), dtype=torch.int64, device=dev), n - 1
    elif kind.startswith("rcpsp"):
        data = core.stack_rcpsp([core.parse_rcp(core.progen_rcp(rng, jobs=n - 2))
                                 for _ in range(b)], device=dev)
        p = torch.exp(score) * core.default_rcpsp_heuristic(data) ** 2
        if kind == "rcpsp_zero":
            p = p * (torch.rand(p.shape, generator=g, device=dev) >= 0.4)
        if kind == "rcpsp_dead":
            p[:, 3:9, :] = 0.0
        score = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-30)), -1e30)
        start = torch.zeros((b, a), dtype=torch.int64, device=dev)
        shape, t = rollout.RolloutShape("sop", prec=data.adj.transpose(-1, -2)), n - 1
    elif kind == "pctsp":
        prizes = torch.as_tensor(np.stack([gen_pctsp(rng, n - 1)["prizes"] for _ in range(b)]),
                                 device=dev)
        start = torch.zeros((b, a), dtype=torch.int64, device=dev)
        shape, t = rollout.RolloutShape("pctsp", prizes=prizes, min_prizes=(n - 1) / 4.0), n + 1
    elif kind.startswith("tsp"):
        start = (torch.randint(0, n, (b, a), generator=g, device=dev) if kind == "tsp"
                 else torch.zeros((b, a), dtype=torch.int64, device=dev))
        shape, t = rollout.TSP_SHAPE, n - 1
    else:
        lo, hi, scale = {"cvrp": (1, 10, 1.0), "cvrp_nls": (1, 10, 150.0),
                         "bpp": (20, 101, 1.0)}[kind]
        demand = torch.randint(lo, hi, (b, n), generator=g, device=dev).float() / scale
        demand[:, 0] = 0.0
        start = torch.zeros((b, a), dtype=torch.int64, device=dev)
        shape, t = rollout.RolloutShape("cvrp", demand, capacity), 2 * (n - 1)
    return score, start, gumbel((t, b, a, n), g, dev), shape


ROLLOUT_CASES = [("tsp", 3, 50, 6, None), ("tsp0", 2, 33, 5, None), ("cvrp", 3, 51, 5, 50.0),
                 ("cvrp_nls", 2, 101, 6, 1.0), ("bpp", 2, 121, 8, 150.0),
                 ("tsp", 1, 1500, 3, None), ("tsp0", 1, 4096, 2, None), ("tsp", 2, 2, 3, None),
                 ("cvrp", 1, 2, 2, 50.0),
                 ("tsp0", 20, 500, 30, None), ("cvrp", 1, 501, 50, 50.0),
                 ("sop", 3, 20, 5, None), ("sop", 1, 100, 50, None), ("sop", 1, 700, 3, None),
                 ("mkp", 3, 31, 6, None), ("mkp", 1, 301, 50, None), ("mkp", 1, 2048, 2, None),
                 ("tsp0", 1, 501, 50, None),
                 ("op", 3, 31, 6, None), ("op", 1, 302, 20, None), ("op", 1, 302, 50, None),
                 ("op", 100, 302, 20, None), ("op_rand", 2, 41, 8, None),
                 ("op", 1, 4096, 2, None),
                 ("pctsp", 3, 21, 5, None), ("pctsp", 1, 501, 20, None),
                 ("pctsp", 1, 501, 50, None), ("pctsp", 100, 501, 20, None),
                 ("pctsp", 1, 4096, 2, None),
                 ("items", 3, 31, 6, None), ("items", 1, 501, 20, None),
                 ("items", 1, 501, 50, None), ("items", 100, 501, 20, None),
                 ("items", 1, 2048, 2, None), ("items", 2, 301, 50, None),
                 ("rcpsp", 3, 33, 6, None), ("rcpsp", 1, 122, 20, None),
                 ("rcpsp", 1, 122, 50, None), ("rcpsp", 100, 122, 20, None),
                 ("rcpsp_zero", 2, 122, 20, None), ("rcpsp_dead", 2, 122, 20, None),
                 ("rcpsp_dead", 3, 33, 16, None),
                 ("blend", 3, 33, 6, None), ("blend", 1, 122, 20, None),
                 ("blend", 100, 122, 20, None), ("blend_sum", 2, 122, 20, None),
                 ("blend_half", 2, 122, 20, None), ("blend_zero", 2, 122, 20, None),
                 ("blend_dead", 2, 122, 20, None), ("blend_dead", 3, 33, 16, None),
                 ("blend", 1, 700, 3, None)]


def _grad_inputs(score, shape):
    """The leaves K7r's gradient reaches: the score, and for RCPSP's blend
    also its heuristic and pheromone, put into the shape."""
    leaf = score.clone().requires_grad_(True)
    if shape.kind != "blend":
        return (leaf,), shape
    heu, phe = (x.clone().requires_grad_(True) for x in (shape.heu, shape.phe))
    return (leaf, heu, phe), shape._replace(heu=heu, phe=phe)


def _plain_grads(score, paths, g, shape):
    """rollout_backward_plain's gradient in ``_grad_inputs``'s leaves (the
    blend's gradient in ``heu ** beta`` chained to ``heu``)."""
    from deepaco_tpu_torch.ops import rollout

    d = rollout.rollout_backward_plain(score, paths, g, shape)
    if shape.kind != "blend":
        return (d,)
    heu = shape.heu.detach().requires_grad_(True)
    d_heu, = torch.autograd.grad(heu ** shape.beta, heu, d[1])
    return d[0], d_heu, d[2]


@pytest.mark.parametrize("kind,b,n,a,capacity", ROLLOUT_CASES)
def test_rollout_kernel_matches_plain(dev, kind, b, n, a, capacity):
    """K7r forward against fused_rollout_plain on the same noise (paths
    exact at every warp count, log-probabilities rtol 1e-5 / atol 1e-6; the
    untraced forward's paths, inference's, bit-equal to them, one launch of
    ``fused_rollout_paths``), and its backward through autograd against
    rollout_backward_plain (rtol 1e-4, atol 1e-5 of the largest entry),
    equal bits on a repeat; one launch each way. Among the cases are
    TSP500-NLS training's, CVRP500's, SOP100's, MKP300's and SMTWTP500's
    (TSP's walk from job 0) shapes, and OP300's and PCTSP500's at their
    training (B=1, A=20 and 50) and inference (B=100, A=20) shapes, and
    MKP-items 500's and RCPSP j120's (SOP's kind on its score) at theirs,
    RCPSP with zero entries and with steps where every open activity has p
    = 0, MKP-items at its limit (N = 2048) and odd N, and RCPSP's summation
    blend (the ``"blend"`` kind: its gradient also in the heuristic and the
    pheromone) at j120's training (B=1) and inference (B=100) shapes, with
    c 0, alpha 0.5, zero entries and dead rows."""
    from deepaco_tpu_torch.ops import rollout

    score, start, noise, shape = _rollout_case(dev, kind, b, n, a, capacity)
    want_paths, want_logp = rollout.fused_rollout_plain(score, start, noise, shape)
    for warps in (1, 2, 4, 8):
        if n <= (256 if kind in ("mkp", "items") else 512) * warps:
            paths, logp, _ = rollout.fused_rollout_forward(score, start, noise, shape,
                                                           warps=warps)
            assert torch.equal(paths, want_paths), warps
            torch.testing.assert_close(logp, want_logp, rtol=1e-5, atol=1e-6)
            untraced, none, _ = rollout.fused_rollout_forward(score, start, noise, shape,
                                                              warps=warps, trace=False)
            assert torch.equal(untraced, want_paths) and none is None, warps
    before = rollout.fused_rollout_paths.launches
    assert torch.equal(rollout.fused_rollout_paths(score, start, noise, shape), want_paths)
    assert rollout.fused_rollout_paths.launches == before + 1
    leaves, grad_shape = _grad_inputs(score, shape)
    fwd, bwd = rollout.fused_rollout.launches, rollout.fused_rollout_backward.launches
    paths, logp = rollout.fused_rollout(leaves[0], start, noise, grad_shape)
    assert torch.equal(paths, want_paths)
    g = torch.randn(logp.shape, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    d1 = torch.autograd.grad(logp, leaves, g, retain_graph=True)
    d2 = torch.autograd.grad(logp, leaves, g)
    assert (rollout.fused_rollout.launches - fwd, rollout.fused_rollout_backward.launches
            - bwd) == (1, 2)
    for got, again, want in zip(d1, d2, _plain_grads(score, want_paths, g, shape)):
        assert torch.equal(got, again)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())


def test_rollout_kernel_takes_nan_first_and_refuses_what_it_cannot_take(dev):
    """A NaN score is picked before every number, as torch.argmax orders it;
    N past 4096, f64 scores and a CPU tensor mixed in raise."""
    from deepaco_tpu_torch.ops import rollout

    score, start, noise, shape = _rollout_case(dev, "tsp0", 2, 40, 3)
    score[:, 0, 17] = float("nan")
    paths, _ = rollout.fused_rollout(score, start, noise, shape)
    want, _ = rollout.fused_rollout_plain(score, start, noise, shape)
    assert torch.equal(paths, want) and bool((paths[:, 1] == 17).all())
    with pytest.raises(ValueError, match="f32"):
        rollout.fused_rollout(score.double(), start, noise, shape)
    with pytest.raises(ValueError):
        rollout.fused_rollout(score, start.cpu(), noise, shape)
    big = torch.zeros((1, 4097, 4097), device=dev)
    with pytest.raises(ValueError, match="4096"):
        rollout.fused_rollout(big, torch.zeros((1, 1), dtype=torch.int64, device=dev),
                              torch.zeros((1, 1, 1, 4097), device=dev), shape)


def test_engine_routes_training_rollouts_through_the_rollout_kernel(dev):
    """``rollout(require_prob=True)`` on the TSP plug-in launches K7r once
    and K7 never; without log-probabilities it launches K7r's untraced
    forward once, on the same paths; a plug-in without ``fused`` steps
    through K7."""
    from deepaco_tpu_torch.aco.engine import rollout as run
    from deepaco_tpu_torch.aco.problems.tsp import tsp_spec
    from deepaco_tpu_torch.ops import pick, rollout

    heu = 0.01 + torch.rand((2, 30, 30), device=dev)
    spec = tsp_spec(torch.ones_like(heu), heu, 4)
    counters = (pick.fused_pick, rollout.fused_rollout, rollout.fused_rollout_paths)
    before = [fn.launches for fn in counters]
    out = run(spec, torch.Generator(device=dev).manual_seed(0), require_prob=True)
    assert out.log_probs.shape == (2, 29, 4) and out.state is None
    paths = run(spec, torch.Generator(device=dev).manual_seed(0)).paths
    assert torch.equal(paths, out.paths)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 1, 1]
    run(spec._replace(fused=None), torch.Generator(device=dev).manual_seed(0))
    assert [fn.launches - b for fn, b in zip(counters, before)] == [29, 1, 1]


def test_train_tsp_runs_on_the_card_through_the_kernels(dev):
    """One NLS-shaped step of train_tsp at N=60 on the default device:
    finite, and K6 (12 launches a direction at depth 12), K7r (one launch
    forward, one backward), K5 launched, and K7 not at all."""
    from deepaco_tpu_torch.ops import gnn_layer, pick, rollout
    from deepaco_tpu_torch.train import config, reinforce as tr

    cfg = config.ProblemConfig(n_nodes=60, k_sparse=6, aco=config.ACOSettings(n_ants=8),
                               train=config.TrainConfig(batch_size=2, cosine_schedule=True))
    counters = (gnn_layer.fused_gnn_layer, gnn_layer.fused_gnn_layer_backward,
                pick.fused_pick, rollout.fused_rollout, rollout.fused_rollout_backward,
                two_opt.batched_nls_euclid)
    before = [fn.launches for fn in counters]
    infos = []
    state = tr.train_tsp(Net(feats=1), cfg, local_search=tr.nls_local_search(),
                         max_steps=1, progress=lambda i, info: infos.append(info))
    assert state.step == 1 and next(state.net.parameters()).is_cuda
    assert all(torch.isfinite(v).all() for v in infos[0])
    assert [fn.launches - b for fn, b in zip(counters, before)] == [12, 12, 0, 1, 1, 1]


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


@pytest.mark.parametrize("name", ["tsp", "cvrp", "sop", "bpp", "mkp"])
def test_family_train_step_launches_k6_and_k7_on_the_card(dev, name):
    """One step of make_family_train_step on the card (TSP n=50, k=5; CVRP
    20 customers, K = N = 21; SOP, BPP and MKP at n=20 on their dense
    graphs, SOP's masked; 12-layer Net, 2 instances, 4 ants): 12 K6
    forward and 12 backward launches, the rollout as one K7r launch forward
    and one backward, no K7, K7c or K9; finite loss, cost and gradient
    norm; the weights move."""
    import numpy as np

    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.ops import gnn_layer, pick, rollout
    from deepaco_tpu_torch.train import drivers
    from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig

    family = get_family(name)
    n = 50 if name == "tsp" else 20
    cfg = ProblemConfig(name=name, n_nodes=n, k_sparse=5, aco=ACOSettings(n_ants=4),
                        train=TrainConfig(batch_size=2))
    rng = np.random.default_rng(0)
    state = drivers.init_family_state(family, cfg, rng,
                                      torch.Generator(device=dev).manual_seed(0))
    start = {k: v.clone() for k, v in state.net.state_dict().items()}
    counted = (gnn_layer.fused_gnn_layer, gnn_layer.fused_gnn_layer_backward, pick.fused_pick,
               rollout.fused_rollout, rollout.fused_rollout_backward, cc.cvrp_construct,
               fused_gnn.embnet_layers)
    before = [fn.launches for fn in counted]
    state, info = drivers.make_family_train_step(family, cfg)(
        state, drivers.gen_batch(family, rng, n, 2), torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    launched = [fn.launches - b for fn, b in zip(counted, before)]
    assert launched == [12, 12, 0, 1, 1, 0, 0]
    assert all(bool(torch.isfinite(v)) for v in info)
    assert all(not torch.equal(start[k], v) for k, v in state.net.state_dict().items()
               if v.dim() == 2)


@pytest.mark.parametrize("name", ["mkp_items", "rcpsp", "rcpsp_blend"])
def test_engine_routes_items_and_rcpsp_through_the_rollout_kernel(dev, name):
    """``engine.rollout`` on the card: MKP-items (20 items, 2 instances, 6
    ants, the classic heuristic) and RCPSP's direct evaluation and its blend
    (gamma 0.5, c 0.6; 2 seeded instances of 32 activities, the classic
    heuristic) launch K7r once each way with ``require_prob`` and its
    untraced forward once without, and no K7. The paths are the plain
    route's on the same seed."""
    import numpy as np

    from deepaco_tpu_torch.aco.engine import rollout as run
    from deepaco_tpu_torch.aco.problems import rcpsp as apr
    from deepaco_tpu_torch.core import rcpsp as core
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.ops import pick, rollout
    from deepaco_tpu_torch.train.drivers import instance_tensors

    rng = np.random.default_rng(0)
    if name == "mkp_items":
        fam = get_family(name)
        inst = fam.prepare(instance_tensors(
            {k: np.stack([v, v[::-1].copy()]) for k, v in fam.gen(rng, 20).items()}, dev))
        heu = fam.classic_heu(inst, 0).clone().requires_grad_(True)
        spec = fam.spec(torch.ones_like(heu), heu, inst, 6)
    else:
        data = core.stack_rcpsp([core.parse_rcp(core.progen_rcp(rng)) for _ in range(2)],
                                device=dev)
        heu = core.default_rcpsp_heuristic(data)
        cfg = apr.RCPSPConfig(n_ants=6, gamma=0.5 if name == "rcpsp_blend" else 0.0)
        spec = apr.rcpsp_spec(torch.ones_like(heu), heu.clone().requires_grad_(True), data, cfg)
    counted = (pick.fused_pick, rollout.fused_rollout, rollout.fused_rollout_backward,
               rollout.fused_rollout_paths)
    before = [fn.launches for fn in counted]
    ro = run(spec, torch.Generator(device=dev).manual_seed(2), require_prob=True)
    ro.log_probs.sum().backward()
    paths = run(spec, torch.Generator(device=dev).manual_seed(2)).paths
    torch.cuda.synchronize()
    launched = [fn.launches - b for fn, b in zip(counted, before)]
    assert launched == [0, 1, 1, 1]
    plain = run(spec, torch.Generator(device=dev).manual_seed(2), pick=pick.fused_pick_plain)
    assert torch.equal(paths, ro.paths) and torch.equal(paths, plain.paths)
    assert bool(torch.isfinite(ro.log_probs).all())


def test_embnet_layers_kernel_without_node_update_at_the_smtwtp_shape(dev):
    """K9 with ``node_update=0`` on SMTWTP500's dense job graph (B=4 golden
    instances, K = N = 501, the processing time as the edge feature) with
    the ``smtwtp500_selftrained`` weights, against embnet_layers_plain: the
    edge state and the head's output at rtol 1e-4 / atol 1e-5."""
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.train.drivers import family_model, instance_tensors
    from deepaco_tpu_torch.utils.golden import smtwtp_test

    fam = get_family("smtwtp")
    net = family_model(fam, load_checkpoint(str(CKPT / "smtwtp500_selftrained.msgpack"))).to(dev)
    assert not net.emb_net.node_update
    inst = instance_tensors({k: v[:4] for k, v in smtwtp_test(500).items()}, dev)
    g = fam.graph(inst, 0)
    f = fused_gnn.fold_embnet_params(net.emb_net)
    x = fused_gnn._node_embedding(f, g.x)
    before = fused_gnn.embnet_layers.launches
    got = fused_gnn.embnet_layers(f, x, g.nbr, g.edge, k=501, node_update=False)
    assert fused_gnn.embnet_layers.launches == before + 1
    want = fused_gnn.embnet_layers_plain(f, x, g.nbr, g.edge, k=501, node_update=False)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    heu = fused_gnn.net_forward_fast(net, g.x, g.nbr, g.edge)
    plain = fused_gnn.net_forward_fast(net, g.x, g.nbr, g.edge,
                                       layers=fused_gnn.embnet_layers_plain)
    torch.testing.assert_close(heu, plain, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,n", [("op", 300), ("pctsp", 500)])
def test_pick_kernel_on_op_and_pctsp_rows(dev, name, n):
    """K7 on the rows of an OP300 and a PCTSP500 rollout (B=4 golden
    instances, 20 ants, the classic heuristic): the family's own score rows,
    masks (OP's budget and dummy node, PCTSP's depot gate and parking) and
    noise at the start, a third and two thirds of the horizon, actions
    exactly equal to the plain pick's and allowed, logp within 1e-5."""
    _check_pick_on_family_rows(dev, name, n)


@pytest.mark.parametrize("name,n", [("sop", 100), ("mkp", 300)])
def test_pick_kernel_on_sop_and_mkp_rows(dev, name, n):
    """K7 on the rows of a SOP100 and an MKP300 rollout, held as on OP's and
    PCTSP's: SOP's precedence masks, MKP's knapsack masks and the dummy
    item it parks on."""
    _check_pick_on_family_rows(dev, name, n)


def _check_pick_on_family_rows(dev, name, n):
    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.ops import pick
    from deepaco_tpu_torch.train.drivers import instance_tensors
    from deepaco_tpu_torch.utils import golden

    fam = get_family(name)
    inst = fam.prepare(instance_tensors({k: v[:4] for k, v in golden.GOLDEN[name](n).items()},
                                        dev))
    heu = fam.classic_heu(inst, fam.k_sparse(n))
    spec = fam.spec(torch.ones_like(heu), heu, inst, 20)
    at = {0, spec.horizon // 3, 2 * spec.horizon // 3}
    steps, seen = iter(range(spec.horizon)), []

    def check(score, mask, noise):
        got = pick.fused_pick(score, mask, noise)
        if next(steps) in at:
            want = pick.fused_pick_plain(score, mask, noise)
            assert torch.equal(got[0], want[0])
            assert bool((mask.gather(1, got[0][:, None]) > 0).all())
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
            seen.append(int((mask > 0).sum(1).min()))
        return got

    before = pick.fused_pick.launches
    rollout(spec, torch.Generator(device=dev).manual_seed(0), pick=check)
    assert pick.fused_pick.launches == before + spec.horizon and len(seen) == 3


def test_deposit_kernel_on_parked_pctsp_routes(dev):
    """K8 on PCTSP500 routes that park on the depot (its self-loop repeated
    to the horizon; B=4 golden instances, 20 ants, L = 503): equal bits to
    scatter_add_ on the CPU, and within 2 k 2^-24 of each entry of
    scatter_add_ on the card (k its terms)."""
    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.ops import deposit
    from deepaco_tpu_torch.train.drivers import instance_tensors
    from deepaco_tpu_torch.utils.golden import pctsp_test

    fam = get_family("pctsp")
    inst = instance_tensors({k: v[:4] for k, v in pctsp_test(500).items()}, dev)
    heu = fam.classic_heu(inst, 50)
    paths = rollout(fam.spec(torch.ones_like(heu), heu, inst, 20),
                    torch.Generator(device=dev).manual_seed(1)).paths
    assert bool((paths[:, -2:] == 0).all())             # every ant parked at the end
    amounts = 1.0 / fam.cost(paths, inst)
    got = deposit.tour_deposit(paths, amounts, 501, cyclic=False)
    cpu = deposit.tour_deposit_plain(paths.cpu(), amounts.cpu(), 501, cyclic=False)
    assert torch.equal(got.cpu(), cpu)
    plain = deposit.tour_deposit_plain(paths, amounts, 501, cyclic=False)
    k = deposit.tour_deposit_plain(paths, torch.ones_like(amounts), 501, cyclic=False)
    assert bool(((got - plain).abs() <= 2 * k * 2.0 ** -24 * got).all())


@pytest.mark.parametrize("name,n,ckpt", [("op", 100, "op100"), ("pctsp", 20, "pctsp20"),
                                         ("smtwtp", 50, "smtwtp50"), ("sop", 20, "sop20"),
                                         ("mkp", 50, "mkp300")])
def test_evaluate_family_runs_the_per_step_families_on_the_card(dev, name, n, ckpt):
    """evaluate_family on 4 golden instances on the card: finite curves
    that move one way, valid best solutions, and K9 once, K8 once an
    iteration, and the construction K7r's untraced forward once an
    iteration (OP and PCTSP since they took K7r's kinds; SMTWTP, SOP,
    MKP); K6, K7 and K7c never."""
    from deepaco_tpu_torch.aco.problems.mkp import validate_mkp
    from deepaco_tpu_torch.aco.problems.op import validate_op
    from deepaco_tpu_torch.aco.problems.pctsp import validate_pctsp
    from deepaco_tpu_torch.aco.problems.smtwtp import validate_smtwtp
    from deepaco_tpu_torch.aco.problems.sop import validate_sop
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.ops import deposit, gnn_layer, pick, rollout
    from deepaco_tpu_torch.train.drivers import evaluate_family, family_model, instance_tensors
    from deepaco_tpu_torch.utils import golden

    fam = get_family(name)
    ds = {k: v[:4] for k, v in golden.GOLDEN[name](n).items()}
    net = family_model(fam, load_checkpoint(str(CKPT / f"{ckpt}_selftrained.msgpack")))
    counters = (fused_gnn.embnet_layers, gnn_layer.fused_gnn_layer, pick.fused_pick,
                deposit.tour_deposit, cc.cvrp_construct, rollout.fused_rollout_paths)
    before = [fn.launches for fn in counters]
    _, curves, state = evaluate_family(name, ds, n_nodes=n, net=net, n_ants=8,
                                       t_values=(1, 3), return_state=True)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 0, 0, 3, 0, 3]
    sign = -1.0 if fam.aco.maximize else 1.0
    assert curves.is_cuda and bool(torch.isfinite(curves).all())
    assert bool((sign * curves[:, 1:] <= sign * curves[:, :-1]).all())
    inst = fam.prepare(instance_tensors(ds, dev))
    best = state.best_path[..., None]
    valid = {"op": lambda: validate_op(best, inst["dist"], inst["max_len"]),
             "pctsp": lambda: validate_pctsp(best, inst["prizes"], n / 4.0),
             "smtwtp": lambda: validate_smtwtp(best),
             "sop": lambda: validate_sop(best, inst["prec"]),
             "mkp": lambda: validate_mkp(best, inst["weight"], n // 2)}[name]()
    assert bool(valid.all())


def test_embnet_layers_kernel_on_the_masked_sop_graph(dev):
    """K9 on SOP100's masked dense block (B=4 golden instances, K = N = 100,
    the ``sop100_selftrained`` weights, no node update): the heuristic that
    ``_forward_heu`` routes through K9 and then masks equals the plain
    ``Net`` forward on the masked graph (eval mode), masked the same way, at
    rtol 1e-4 / atol 1e-5 on the head; K9 launches once."""
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.ops import gnn_layer
    from deepaco_tpu_torch.train import drivers
    from deepaco_tpu_torch.utils.golden import sop_test

    fam = get_family("sop")
    net = drivers.family_model(fam, load_checkpoint(str(CKPT / "sop100_selftrained.msgpack")))
    net = net.to(dev).eval()
    inst = drivers.instance_tensors({k: v[:4] for k, v in sop_test(100).items()}, dev)
    g = fam.graph(inst, 0)
    assert g.mask is not None and not net.emb_net.node_update
    before = fused_gnn.embnet_layers.launches
    with torch.no_grad():
        heu = drivers._forward_heu(fam, net, inst, 0)
        plain = net(g, gnn_layer.fused_gnn_layer_plain)
    assert fused_gnn.embnet_layers.launches == before + 1
    torch.testing.assert_close(heu, fam.heu_matrix(g, plain, inst), rtol=1e-4, atol=1e-5)
    assert bool((heu[g.mask == 0] == 1e-10).all())


def test_cvrp_construct_kernel_on_bpp120_at_capacity_150(dev):
    """K7c on BPP120's golden sizes (B=8, N = 121, capacity 150, A=20; a bin
    holds 1-7 items, so the "all packed, back at the separator" stop comes
    at other steps than on CVRP) on the classic heuristic and on a random
    one: paths bit-equal to the plain version's, stochastic and greedy, and
    every item packed once with no bin above 150."""
    from deepaco_tpu_torch.aco.problems.bpp import validate_bpp
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.families import BPP_CAPACITY, get_family
    from deepaco_tpu_torch.train.drivers import instance_tensors
    from deepaco_tpu_torch.utils.golden import bpp_test

    inst = instance_tensors({k: v[:8] for k, v in bpp_test(120).items()}, dev)
    heu = get_family("bpp").classic_heu(inst, 0)
    noise = torch.rand(heu.shape, generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev)
    for h in (heu, heu * (0.5 + noise)):
        score = score_matrix(torch.ones_like(h), h, 1.0, 1.0)
        _assert_cvrp_construct_matches_plain(score, inst["demand"], BPP_CAPACITY, 20, 5)
        paths = cc.cvrp_construct(score, inst["demand"], BPP_CAPACITY, 20,
                                  torch.Generator(device=dev).manual_seed(6))
        assert bool(validate_bpp(paths, inst["demand"], BPP_CAPACITY).all())
        assert bool((paths[:, -1] == 0).all())


def test_deposit_kernel_on_parked_bpp_routes(dev):
    """K8 on BPP120 routes (K7c on the classic heuristic; B=8, 20 ants,
    L = 241) that end in long runs of (0, 0) self-loops, with the amounts
    ``fitness / A``: equal bits to scatter_add_ on the CPU, and within 2 k
    2^-24 of each entry of scatter_add_ on the card (k its terms)."""
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.families import BPP_CAPACITY, get_family
    from deepaco_tpu_torch.ops import deposit
    from deepaco_tpu_torch.train.drivers import instance_tensors
    from deepaco_tpu_torch.utils.golden import bpp_test

    fam = get_family("bpp")
    inst = instance_tensors({k: v[:8] for k, v in bpp_test(120).items()}, dev)
    heu = fam.classic_heu(inst, 0)
    paths = cc.cvrp_construct(score_matrix(torch.ones_like(heu), heu, 1.0, 1.0),
                              inst["demand"], BPP_CAPACITY, 20,
                              torch.Generator(device=dev).manual_seed(1))
    assert bool((paths[:, -40:] == 0).all())            # long parked tails
    amounts = fam.cost(paths, inst) / 20
    got = deposit.tour_deposit(paths, amounts, 121, cyclic=False)
    cpu = deposit.tour_deposit_plain(paths.cpu(), amounts.cpu(), 121, cyclic=False)
    assert torch.equal(got.cpu(), cpu)
    plain = deposit.tour_deposit_plain(paths, amounts, 121, cyclic=False)
    k = deposit.tour_deposit_plain(paths, torch.ones_like(amounts), 121, cyclic=False)
    assert bool(((got - plain).abs() <= 2 * k * 2.0 ** -24 * got).all())


def test_evaluate_family_bpp_runs_k7c_on_the_card(dev):
    """evaluate_family("bpp") on 4 golden BPP120 instances with the
    ``bpp120_selftrained`` weights: finite curves that do not fall (the
    fitness is maximized), valid best packings, and K9 once, K7c and K8
    once an iteration; K6 and K7 never."""
    from deepaco_tpu_torch.aco.problems.bpp import validate_bpp
    from deepaco_tpu_torch.families import BPP_CAPACITY, get_family
    from deepaco_tpu_torch.ops import deposit, gnn_layer, pick
    from deepaco_tpu_torch.train.drivers import evaluate_family, family_model, instance_tensors
    from deepaco_tpu_torch.utils.golden import bpp_test

    fam = get_family("bpp")
    ds = {k: v[:4] for k, v in bpp_test(120).items()}
    net = family_model(fam, load_checkpoint(str(CKPT / "bpp120_selftrained.msgpack")))
    counters = (fused_gnn.embnet_layers, gnn_layer.fused_gnn_layer, pick.fused_pick,
                deposit.tour_deposit, cc.cvrp_construct)
    before = [fn.launches for fn in counters]
    _, curves, state = evaluate_family("bpp", ds, n_nodes=120, net=net, n_ants=8,
                                       t_values=(1, 3), return_state=True)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 0, 0, 3, 3]
    assert curves.is_cuda and bool(torch.isfinite(curves).all())
    assert bool((curves[:, 1:] >= curves[:, :-1]).all())
    inst = instance_tensors(ds, dev)
    assert bool(validate_bpp(state.best_path[..., None], inst["demand"], BPP_CAPACITY).all())


def test_cvrp_construct_kernel_at_the_cvrp_nls500_shape(dev):
    """K7c at capacity 1.0 on the golden CVRP-NLS500 instances (B=4, N =
    501, A=20; demands k/150 in f32, so the loads are sums of rounded
    fractions compared with 1.0), on ``1/d`` and on a random heuristic:
    paths bit-equal to the plain version's (the same f32 additions in the
    same order), stochastic and greedy, and every route within 1 + 1e-6."""
    from deepaco_tpu_torch.aco.problems.cvrp import validate_routes
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.train.drivers import instance_tensors
    from deepaco_tpu_torch.utils.golden import cvrp_nls_test

    ds = cvrp_nls_test(500, count=4)
    inst = instance_tensors({"dist": ds["dist"], "demand": ds["demand"]}, dev)
    heu = 1.0 / inst["dist"]
    noise = torch.rand(heu.shape, generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev)
    for h in (heu, heu * (0.5 + noise)):
        score = score_matrix(torch.ones_like(h), h, 1.0, 1.0)
        _assert_cvrp_construct_matches_plain(score, inst["demand"], 1.0, 20, 7)
        paths = cc.cvrp_construct(score, inst["demand"], 1.0, 20,
                                  torch.Generator(device=dev).manual_seed(8))
        assert bool(validate_routes(paths, inst["demand"], 1.0).all())


def test_deposit_kernel_on_ls_rewritten_cvrp_nls_routes(dev):
    """K8 on CVRP-NLS500 routes (K7c on ``1/d``, B=1, A=20, L = 1001) whose
    8 cheapest ants the native engine rewrote (fewer, fuller trips, then a
    longer parked tail): equal bits to scatter_add_ on the CPU, within 2 k
    2^-24 of each entry of scatter_add_ on the card; and CVRPNLSACO.run(2)
    on the card launches K7c and K8 once an iteration, K7 never."""
    import numpy as np

    from deepaco_tpu_torch.aco.problems.cvrp import route_cost
    from deepaco_tpu_torch.aco.problems.cvrp_nls import CVRPNLSACO
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.ls import hgs
    from deepaco_tpu_torch.ops import deposit, pick
    from deepaco_tpu_torch.utils.golden import cvrp_nls_test

    ds = cvrp_nls_test(500, count=1)
    dist = torch.as_tensor(ds["dist"], device=dev)
    demand = torch.as_tensor(ds["demand"], device=dev)
    paths = cc.cvrp_construct(score_matrix(torch.ones_like(dist), 1.0 / dist, 1.0, 1.0),
                              demand, 1.0, 20, torch.Generator(device=dev).manual_seed(1))
    host = paths[0].cpu().numpy().copy()
    idx = np.argsort(route_cost(dist, paths)[0].cpu().numpy())[:8]
    host[:, idx] = hgs.multiple_swap_star(ds["demand"][0].astype(np.float64),
                                          ds["dist"][0].astype(np.float64), host[:, idx],
                                          count=1000)
    rewritten = torch.from_numpy(host).to(dev)[None]
    assert not torch.equal(rewritten, paths)
    amounts = 1.0 / route_cost(dist, rewritten)
    got = deposit.tour_deposit(rewritten, amounts, 501, cyclic=False)
    cpu = deposit.tour_deposit_plain(rewritten.cpu(), amounts.cpu(), 501, cyclic=False)
    assert torch.equal(got.cpu(), cpu)
    plain = deposit.tour_deposit_plain(rewritten, amounts, 501, cyclic=False)
    k = deposit.tour_deposit_plain(rewritten, torch.ones_like(amounts), 501, cyclic=False)
    assert bool(((got - plain).abs() <= 2 * k * 2.0 ** -24 * got).all())
    aco = CVRPNLSACO(ds["dist"][0], ds["demand"][0], n_ants=20, seed=0, device=dev)
    before = (cc.cvrp_construct.launches, deposit.tour_deposit.launches,
              pick.fused_pick.launches)
    aco.run(2)
    assert (cc.cvrp_construct.launches - before[0], deposit.tour_deposit.launches - before[1],
            pick.fused_pick.launches - before[2]) == (2, 2, 0)


def test_pick_kernel_on_mkp_items_rows(dev):
    """K7 on the ``[B*A, n+1]`` rows of an MKP-items 500 rollout (B=4 golden
    instances, 20 ants, the classic vector heuristic broadcast to every
    ant, the knapsack masks at capacity 1 and the dummy item), held as on
    OP's and PCTSP's rows."""
    _check_pick_on_family_rows(dev, "mkp_items", 500)


def _rcpsp_j120(dev, count=4):
    """``count`` seeded j120-shaped instances (122 activities, 4 resources)
    stacked on the card, and their classic prior."""
    import numpy as np

    from deepaco_tpu_torch.core import rcpsp as core

    rng = np.random.default_rng(120)
    datas = [core.parse_rcp(core.progen_rcp(rng, jobs=120)) for _ in range(count)]
    data = core.stack_rcpsp(datas, device=dev)
    return datas, data, core.default_rcpsp_heuristic(data)


def test_pick_kernel_on_rcpsp_rows(dev):
    """K7 on the rows of a j120 RCPSP rollout through ``probs_fn`` (B=4
    instances, 20 ants, the classic prior, the summation blend at gamma 0.5):
    scores ``log(max(p, 1e-30))`` and the mask ``p > 0``, at the start, a
    third and two thirds of the 121 steps: actions exactly equal to the
    plain pick's and allowed, logp within 1e-5; one launch a step."""
    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.problems.rcpsp import RCPSPConfig, rcpsp_spec
    from deepaco_tpu_torch.ops import pick

    _, data, heu = _rcpsp_j120(dev)
    spec = rcpsp_spec(torch.ones_like(heu), heu, data, RCPSPConfig(n_ants=20, gamma=0.5))
    at = {0, spec.horizon // 3, 2 * spec.horizon // 3}
    steps, seen = iter(range(spec.horizon)), []

    def check(score, mask, noise):
        got = pick.fused_pick(score, mask, noise)
        if next(steps) in at:
            want = pick.fused_pick_plain(score, mask, noise)
            assert torch.equal(got[0], want[0])
            assert bool((mask.gather(1, got[0][:, None]) > 0).all())
            torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
            seen.append(int((mask > 0).sum(1).min()))
        return got

    before = pick.fused_pick.launches
    paths = rollout(spec, torch.Generator(device=dev).manual_seed(0), pick=check).paths
    assert pick.fused_pick.launches == before + 121 and len(seen) == 3
    assert bool((torch.sort(paths, dim=1).values
                 == torch.arange(122, device=dev)[None, :, None]).all())


def test_deposit_kernel_on_rcpsp_paths_and_best(dev):
    """K8 on the update of a j120 RCPSP iteration: the 20 ants' activity
    lists and the best-so-far list (directed, no wraparound, n = 122, B=4,
    A = 21): bit-equal to ``scatter_add_`` on the CPU, within 2 k 2^-24 of
    each entry of ``scatter_add_`` on the card (k its terms, atomics in any
    order), and ``rcpsp_update`` through it (one launch) bit-equal to the
    plain update on the CPU."""
    from deepaco_tpu_torch.aco import pheromone as ph
    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.problems.rcpsp import (RCPSPConfig, init_rcpsp_search,
                                                      makespans, rcpsp_spec, rcpsp_update)
    from deepaco_tpu_torch.ops import deposit

    _, data, heu = _rcpsp_j120(dev)
    cfg = RCPSPConfig(n_ants=20, elitist=False, min_max=True)
    paths = rollout(rcpsp_spec(torch.ones_like(heu), heu, data, cfg),
                    torch.Generator(device=dev).manual_seed(1)).paths
    costs = makespans(data, paths)
    best = paths[..., :1]
    both = torch.cat([best, paths], dim=-1)
    amounts = torch.cat([1.0 / costs[:, :1], 1.0 / costs], dim=-1)
    got = deposit.tour_deposit(both, amounts, 122, cyclic=False)
    assert torch.equal(got.cpu(), deposit.tour_deposit_plain(both.cpu(), amounts.cpu(), 122,
                                                             cyclic=False))
    plain = deposit.tour_deposit_plain(both, amounts, 122, cyclic=False)
    k = deposit.tour_deposit_plain(both, torch.ones_like(amounts), 122, cyclic=False)
    assert bool(((got - plain).abs() <= 2 * k * 2.0 ** -24 * got).all())
    state = init_rcpsp_search(4, 122, cfg, device=dev)
    before = deposit.tour_deposit.launches
    ours = rcpsp_update(cfg, state, paths, costs)
    assert deposit.tour_deposit.launches == before + 1
    cpu = lambda t: t.cpu()
    ref = rcpsp_update(cfg, type(state)(*map(cpu, state)), paths.cpu(), costs.cpu(),
                       deposit=ph.deposit_plain)
    for a, b in zip(ours, ref):
        assert torch.equal(a.cpu(), b)


def test_sparse_runner_launches_k1_and_k3_and_matches_its_plain_arm(dev):
    """``run_anytime_sparse`` on 4 TSP100 instances (k=10, 20 ants, T=3) on
    K1's heuristic: K1 once and K3 an iteration, no K2; the same noise as
    the plain arm (plain heuristic and update), so cost@T1 within 1e-4 of
    it; every best tour a permutation of its own length."""
    coords = uniform_coords(100, torch.Generator().manual_seed(0), batch=4, device=dev)
    dist = distance_matrix(coords)
    net = Net.from_jax_variables(load_checkpoint(str(CKPT / "tsp100_selftrained.msgpack")))
    net = net.to(dev)
    nbr = topk_smallest(dist, 10)[1]
    curves = {}
    for arm, ops in (("kernel", bt.KERNEL_OPS), ("plain", bt.PLAIN_OPS)):
        for fn in (fused_gnn.tsp_dense_heuristic, bt.dense_sweep_fused, bt.fused_tsp_update):
            fn.launches = 0
        stats = {}
        heu = ops.heuristic(net, coords, dist, 10)
        curves[arm] = bt.run_anytime_sparse(heu, dist, nbr, ACOConfig(n_ants=20),
                                            torch.Generator(device=dev).manual_seed(0), 3,
                                            stats=stats, _ops=ops)
        want = (1, 0, 3) if arm == "kernel" else (0, 0, 0)
        assert (fused_gnn.tsp_dense_heuristic.launches, bt.dense_sweep_fused.launches,
                bt.fused_tsp_update.launches) == want
        assert bool((torch.sort(stats["best"], dim=1).values
                     == torch.arange(100, device=dev)).all())
    torch.testing.assert_close(curves["kernel"][:, 0], curves["plain"][:, 0], rtol=1e-4, atol=0)


def test_adaptive_cvrp_on_the_card(dev):
    """``AdaptiveCVRPACO`` on one golden CVRP100 instance (20 ants, T=5):
    K7c every iteration and K8 once an improving one; a valid best route
    that costs what the run reports."""
    from deepaco_tpu_torch.aco.adaptive_cvrp import AdaptiveCVRPACO
    from deepaco_tpu_torch.aco.problems.cvrp import route_cost, validate_routes
    from deepaco_tpu_torch.ops import deposit
    from deepaco_tpu_torch.utils.golden import cvrp_test

    ds = cvrp_test(100)
    aco = AdaptiveCVRPACO(ds["dist"][0], ds["demand"][0], n_ants=20, seed=0, device=dev)
    cc.cvrp_construct.launches = deposit.tour_deposit.launches = 0
    improved = 0
    for _ in range(5):
        before = aco.best_cost.item()
        aco.run(1)
        improved += aco.best_cost.item() < before
    assert cc.cvrp_construct.launches == 5 and deposit.tour_deposit.launches == improved >= 1
    best = aco.best_path[None, :, None]
    assert bool(validate_routes(best, aco.demand, 50.0).all())
    torch.testing.assert_close(route_cost(aco.distances, best)[0, 0], aco.best_cost,
                               rtol=1e-4, atol=0)
