"""Port parity in law: the anytime protocol (eval/anytime.py) on the CPU
against the JAX evaluate_tsp, neural and classic."""
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


def test_local_search_is_not_ported_yet():
    coords = np.random.default_rng(0).random((2, 20, 2)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        evaluate_tsp(coords, k_sparse=5, ls="2opt", device="cpu")
