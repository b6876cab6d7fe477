"""The port stands alone: it imports no JAX and no deepaco_tpu, and it never
moves to the CPU on its own."""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

BLOCKER = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "deepaco_tpu")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import deepaco_tpu_torch
for mod in pkgutil.walk_packages(deepaco_tpu_torch.__path__, "deepaco_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("isolated", len([m for m in sys.modules if m.startswith("deepaco_tpu_torch")]))
"""


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run([sys.executable, "-c", BLOCKER], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_entry_point_without_device_raises_when_cuda_is_absent(monkeypatch):
    from deepaco_tpu_torch.device import resolve_device
    from deepaco_tpu_torch.eval.anytime import evaluate_tsp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coords = np.random.default_rng(0).random((2, 12, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_tsp(coords, k_sparse=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_train_tsp_without_device_raises_when_cuda_is_absent(monkeypatch):
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.train.config import ProblemConfig
    from deepaco_tpu_torch.train.reinforce import train_tsp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_tsp(Net(depth=1), ProblemConfig(n_nodes=12, k_sparse=4))


def test_kernel_wrappers_refuse_non_cuda_devices():
    from deepaco_tpu_torch.ops import _build, two_opt

    with pytest.raises(ValueError):
        _build.require_cuda("k", torch.zeros(2, device="meta"))
    coords = torch.zeros(1, 20, 2, device="meta")
    tours = torch.zeros(1, 3, 20, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        two_opt.batched_two_opt_euclid(coords, tours, 5)
    with pytest.raises(ValueError, match="CUDA"):
        two_opt.batched_nls_euclid(coords, torch.zeros(1, 20, 20, device="meta"), tours, 5)


def test_training_kernel_wrappers_refuse_meta_tensors():
    """K6 (forward, backward, aggregate) and K7 take CPU tensors (the plain
    versions) or CUDA tensors (the kernels), nothing else."""
    from deepaco_tpu_torch.ops import gnn_layer, pick

    meta = lambda *shape: torch.zeros(shape, device="meta")
    x, w, ew, eb = meta(1, 20, 32), meta(1, 20, 4, 32), meta(32, 32), meta(32)
    nbr = torch.zeros(1, 20, 4, dtype=torch.int64, device="meta")
    index = gnn_layer.GraphIndex(nbr.int(), torch.zeros(1, 21, dtype=torch.int32, device="meta"),
                                 torch.zeros(1, 80, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        gnn_layer.fused_gnn_layer(x, x, x, nbr, w, ew, eb, index)
    with pytest.raises(ValueError, match="CUDA"):
        gnn_layer.fused_gnn_layer_backward(x, index, w, ew, x, w)
    with pytest.raises(ValueError, match="CUDA"):
        gnn_layer.gated_mean_aggregate(x, nbr, w)
    with pytest.raises(ValueError, match="CUDA"):
        pick.fused_pick(meta(3, 20), meta(3, 20), meta(3, 20))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Run where torch sees no CUDA device, from the repository and from a
    directory that holds chip_smoke.py alone: non-zero, and no ok line."""
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
