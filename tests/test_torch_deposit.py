"""Port parity: the all-ant deposit (ops/deposit.py, K8's boundary) and the
pheromone deposit (aco/pheromone.py) against the JAX package's
tour_deposit_pallas (interpret mode on the CPU) and deposit(use_pallas=True),
at rtol 1e-6 as tests/test_pallas_kernels.py holds them (the MXU contraction
sums in another order than the scatter)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepaco_tpu.aco import pheromone as jph
from deepaco_tpu.ops.pallas_kernels import tour_deposit_pallas
from deepaco_tpu_torch.aco import pheromone as ph
from deepaco_tpu_torch.ops import deposit as dep


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _case(kind, seed):
    """``paths [B, L, A]`` int32 and ``amounts [B, A]``: permutation tours,
    or CVRP-like routes whose last 12 steps park on the depot (the edge
    (0, 0) repeats), with random repeats inside too."""
    rng = np.random.default_rng(seed)
    b, n, a = 3, 20, 5
    if kind == "tours":
        paths = np.stack([np.stack([rng.permutation(n) for _ in range(a)], axis=1)
                          for _ in range(b)])
    else:
        paths = rng.integers(0, n, (b, 41, a))
        paths[:, 0] = 0
        paths[:, -12:] = 0
    amounts = rng.uniform(0.01, 2.0, (b, a)).astype(np.float32)
    return paths.astype(np.int32), amounts, n


@pytest.mark.parametrize("kind", ["tours", "routes"])
@pytest.mark.parametrize("cyclic", [True, False])
def test_tour_deposit_plain_matches_pallas(kind, cyclic):
    paths, amounts, n = _case(kind, 0)
    ref = jax.jit(jax.vmap(lambda p, w: tour_deposit_pallas(p, w, n, cyclic=cyclic)))(
        jnp.asarray(paths), jnp.asarray(amounts))
    got = dep.tour_deposit_plain(torch.from_numpy(paths), torch.from_numpy(amounts), n,
                                 cyclic=cyclic)
    assert got.shape == (3, n, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    if kind == "routes":               # every parked step deposits again
        per_ant = (paths[:, :-1] == 0) & (paths[:, 1:] == 0)
        if cyclic:
            per_ant = (paths == 0) & (np.roll(paths, 1, axis=1) == 0)
        want = (per_ant.sum(axis=1) * amounts).sum(axis=1)
        np.testing.assert_allclose(got[:, 0, 0].numpy(), want, rtol=1e-6)


def test_tour_deposit_wrapper_takes_the_plain_version_on_cpu_tensors():
    paths, amounts, n = _case("routes", 1)
    p, w = torch.from_numpy(paths), torch.from_numpy(amounts)
    before = dep.tour_deposit.launches
    got = dep.tour_deposit(p, w, n, cyclic=False)
    assert torch.equal(got, dep.tour_deposit_plain(p, w, n, cyclic=False))
    assert dep.tour_deposit.launches == before       # only a kernel launch counts
    # no leading axis: [L, A] -> [n, n]
    assert torch.equal(dep.tour_deposit(p[1], w[1], n, cyclic=False), got[1])
    with pytest.raises(RuntimeError):                # scatter_add_ checks the ids
        dep.tour_deposit(p + n, w, n, cyclic=False)


@pytest.mark.parametrize("cyclic,symmetric", [(True, True), (False, False),
                                              (True, False)])
def test_pheromone_deposit_matches_jax_pallas_route(cyclic, symmetric):
    paths, amounts, n = _case("routes" if not cyclic else "tours", 2)
    tau = (0.5 + np.random.default_rng(3).random((3, n, n))).astype(np.float32)
    ref = jax.jit(jax.vmap(lambda t, p, w: jph.deposit(
        t, p, w, cyclic=cyclic, symmetric=symmetric, use_pallas=True)))(
        jnp.asarray(tau), jnp.asarray(paths), jnp.asarray(amounts))
    args = (torch.from_numpy(tau), torch.from_numpy(paths), torch.from_numpy(amounts))
    got = ph.deposit(*args, cyclic=cyclic, symmetric=symmetric)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    assert torch.equal(got, ph.deposit_plain(*args, cyclic=cyclic, symmetric=symmetric))
