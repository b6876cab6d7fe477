"""Port parity in law: the anytime protocol (eval/anytime.py) on the CPU
against the JAX evaluate_tsp, neural and classic, without and with local
search."""
from pathlib import Path

import numpy as np
import pytest
import torch

from deepaco_tpu.aco.runner import ACOConfig as JConfig
from deepaco_tpu.eval.anytime import evaluate_tsp as jevaluate
from deepaco_tpu.models.gnn import Net as JNet
from deepaco_tpu_torch.aco.runner import ACOConfig
from deepaco_tpu_torch.eval.anytime import evaluate_tsp
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.utils.checkpoint import load_checkpoint


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


CKPT = Path(__file__).resolve().parent.parent / "checkpoints"
B, N, K, ANTS, T = 20, 100, 10, 16, (1, 5)


@pytest.mark.parametrize("arm", ["neural", "classic"])
def test_anytime_matches_jax_in_law(arm):
    coords = np.random.default_rng(11).random((B, N, 2)).astype(np.float32)
    net = jnet = variables = None
    if arm == "neural":
        v = load_checkpoint(str(CKPT / "tsp100_selftrained.msgpack"))
        variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
        jnet = JNet(dual_heads=True, use_pallas=False)
        net = Net.from_jax_variables(variables)
    ref, _ = jevaluate(coords, model=jnet, variables=variables, k_sparse=K,
                       cfg=JConfig(n_ants=ANTS), t_values=T, seed=0)
    got, curves = evaluate_tsp(coords, net=net, k_sparse=K, cfg=ACOConfig(n_ants=ANTS),
                               t_values=T, seed=0, device="cpu")
    assert curves.shape == (B, max(T))
    assert bool(torch.isfinite(curves).all())
    assert bool((curves[:, 1:] <= curves[:, :-1]).all())        # never rises
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.02)


@pytest.mark.parametrize("ls,arm", [("nls", "neural"), ("2opt", "classic")])
def test_local_search_matches_jax_in_law(ls, arm):
    """The TSP-NLS protocol, evaluate_tsp(ls=...), against JAX at N=50. On the
    CPU the JAX package takes its XLA NLS with the f32 perturbation metric,
    the port the K5 semantics with that metric rounded to bf16; the sampling
    streams differ too, hence agreement in law within 2%."""
    b, n, ants, t_values = 8, 50, 8, (1, 3)
    coords = np.random.default_rng(12).random((b, n, 2)).astype(np.float32)
    net = jnet = variables = None
    if arm == "neural":
        v = load_checkpoint(str(CKPT / "tsp_nls100_selftrained.msgpack"))
        variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
        jnet = JNet(dual_heads=False, use_pallas=False)
        net = Net.from_jax_variables(variables)
    ref, _ = jevaluate(coords, model=jnet, variables=variables, k_sparse=n // 10,
                       cfg=JConfig(n_ants=ants), t_values=t_values, seed=0, ls=ls)
    got, curves = evaluate_tsp(coords, net=net, k_sparse=n // 10,
                               cfg=ACOConfig(n_ants=ants), t_values=t_values,
                               seed=0, ls=ls, device="cpu")
    assert curves.shape == (b, max(t_values))
    assert bool(torch.isfinite(curves).all())
    assert bool((curves[:, 1:] <= curves[:, :-1]).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0.02)


def test_local_search_takes_2opt_or_nls_with_coords():
    """``ls`` is 2-opt or NLS; without coordinates the runner takes the
    dense descent on ``dist`` instead of raising, as the JAX package does."""
    from deepaco_tpu_torch.aco.batched_tsp import run_anytime_batched
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    coords = np.random.default_rng(0).random((2, 20, 2)).astype(np.float32)
    with pytest.raises(ValueError, match="nls"):
        evaluate_tsp(coords, k_sparse=5, ls="3opt", device="cpu")
    heu = torch.ones(2, 20, 20)
    dist = distance_matrix(torch.from_numpy(coords))
    run = lambda c: run_anytime_batched(heu, dist, ACOConfig(n_ants=4),
                                        torch.Generator().manual_seed(0), 1,
                                        coords=c, ls="2opt")
    np.testing.assert_array_equal(run(None).numpy(), run(torch.from_numpy(coords)).numpy())
