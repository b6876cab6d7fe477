"""The port stands alone: it imports no JAX and no deepaco_tpu, and it never
moves to the CPU on its own."""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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
    from deepaco_tpu_torch.families import gen_cvrp
    from deepaco_tpu_torch.train.drivers import evaluate_family

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coords = np.random.default_rng(0).random((2, 12, 2)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_tsp(coords, k_sparse=4)
    batch = {k: v[None] for k, v in gen_cvrp(np.random.default_rng(0), 10).items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_family("cvrp", batch, n_nodes=10)
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


def test_cvrp_training_and_cli_without_device_raise_when_cuda_is_absent(monkeypatch):
    """train_family, the CLI's test cvrp and train cvrp, and CVRPACO."""
    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.problems.cvrp import CVRPACO
    from deepaco_tpu_torch.families import gen_cvrp
    from deepaco_tpu_torch.train.config import ProblemConfig
    from deepaco_tpu_torch.train.drivers import train_family

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_family("cvrp", ProblemConfig(name="cvrp", n_nodes=12, k_sparse=4))
    for argv in (["test", "cvrp", "-n", "20", "--classic", "--limit", "1"],
                 ["train", "cvrp", "-n", "12", "-e", "1", "-s", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    inst = gen_cvrp(np.random.default_rng(0), 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        CVRPACO(inst["dist"], inst["demand"])


@pytest.mark.parametrize("name", ["op", "pctsp", "smtwtp", "sop", "bpp", "mkp", "mkp_items"])
def test_family_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch, name):
    """evaluate_family, train_family, the CLI's test and train, and the
    family's facade (OPACO, PCTSPACO, SMTWTPACO, SOPACO, BPPACO, MKPACO,
    MKPItemsACO)."""
    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.problems.bpp import BPPACO
    from deepaco_tpu_torch.aco.problems.mkp import MKPACO, MKPItemsACO
    from deepaco_tpu_torch.aco.problems.op import OPACO
    from deepaco_tpu_torch.aco.problems.pctsp import PCTSPACO
    from deepaco_tpu_torch.aco.problems.smtwtp import SMTWTPACO
    from deepaco_tpu_torch.aco.problems.sop import SOPACO
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.train.config import ProblemConfig
    from deepaco_tpu_torch.train.drivers import evaluate_family, gen_batch, train_family

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = gen_batch(get_family(name), np.random.default_rng(0), 12, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_family(name, batch, n_nodes=12)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_family(name, ProblemConfig(name=name, n_nodes=12, k_sparse=4))
    n = {"op": 100, "pctsp": 20, "smtwtp": 50, "sop": 20, "bpp": 12, "mkp": 12,
         "mkp_items": 300}[name]
    for argv in (["test", name, "-n", str(n), "--classic", "--limit", "1"],
                 ["train", name, "-n", "12", "-e", "1", "-s", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    one = {k: v[0] for k, v in batch.items()}
    facade = {"op": lambda: OPACO(one["dist"], one["prizes"], 4.0, k_sparse=4),
              "pctsp": lambda: PCTSPACO(one["dist"], one["prizes"], one["penalties"]),
              "smtwtp": lambda: SMTWTPACO(one["processing"], one["due"], one["weights"]),
              "sop": lambda: SOPACO(one["dist"], one["prec"]),
              "bpp": lambda: BPPACO(one["demand"]),
              "mkp": lambda: MKPACO(one["prize"], one["weight"]),
              "mkp_items": lambda: MKPItemsACO(one["prize"], one["weight"])}
    with pytest.raises(RuntimeError, match="CUDA"):
        facade[name]()


def test_cvrp_nls_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch, tmp_path):
    """CVRPNLSACO, train_cvrp_nls and the CLI's test and train cvrp
    --local-search swapstar and solve-cvrp raise without a card; the host
    engine (ls.hgs) and the transformer need none."""
    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.problems.cvrp_nls import CVRPNLSACO
    from deepaco_tpu_torch.ls import hgs
    from deepaco_tpu_torch.models.transformer import TransformerModel
    from deepaco_tpu_torch.train.special import train_cvrp_nls
    from deepaco_tpu_torch.utils.golden import cvrp_nls_test

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = cvrp_nls_test(10, count=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        CVRPNLSACO(ds["dist"][0], ds["demand"][0])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cvrp_nls(10, epochs=1, steps_per_epoch=1)
    vrp = tmp_path / "t.vrp"
    vrp.write_text("CAPACITY : 5\nNODE_COORD_SECTION\n1 0 0\n2 1 1\nDEMAND_SECTION\n"
                   "1 0\n2 1\nDEPOT_SECTION\n1\n-1\nEOF\n")
    for argv in (["test", "cvrp", "-n", "10", "--local-search", "swapstar", "--limit", "1"],
                 ["train", "cvrp", "--local-search", "swapstar", "-n", "10", "-e", "1",
                  "-s", "1"],
                 ["solve-cvrp", str(vrp)]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    routes = hgs.path_to_routes(np.array([0, 1, 2, 0, 3, 0, 0]))
    out = hgs.swapstar(ds["demand"][0][:4] * 0 + 0.1, ds["dist"][0][:4, :4], routes, 10)
    assert sorted(np.concatenate(out).tolist()) == [1, 2, 3]
    src = torch.rand(1, 7, 6, generator=torch.Generator().manual_seed(0))
    assert TransformerModel()(src).shape == (1, 7)


def test_rcpsp_and_tsp_facade_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    """evaluate_rcpsp, train_rcpsp, RCPSPACO, the ACO facade, and the CLI's
    test and train rcpsp and test tsp (family, batched and per-instance
    local search) raise without a card before they read any data; the
    instance layer (parser, priors, graph, decoder) needs none."""
    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.problems.rcpsp import RCPSPACO, makespans
    from deepaco_tpu_torch.aco.runner import ACO
    from deepaco_tpu_torch.core import rcpsp as core
    from deepaco_tpu_torch.core.builders import rcpsp_graph
    from deepaco_tpu_torch.eval.rcpsp import evaluate_rcpsp
    from deepaco_tpu_torch.train.special import train_rcpsp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = core.parse_rcp(core.progen_rcp(np.random.default_rng(0), jobs=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_rcpsp([data], t_values=(1,))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_rcpsp([data], epochs=1, steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        RCPSPACO(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        ACO(np.ones((5, 5), np.float32))
    for argv in (["test", "rcpsp", "-n", "30"], ["train", "rcpsp", "-n", "30"],
                 ["test", "tsp", "-n", "20"], ["test", "tsp", "-n", "20", "--local-search",
                                               "nls", "--per-instance", "--classic"],
                 ["test", "tsp", "-n", "20", "--local-search", "2opt", "--classic"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    batch = core.stack_rcpsp([data])
    assert rcpsp_graph(batch).x.shape == (1, 10, 5)
    paths = torch.arange(10)[None, :, None]
    assert makespans(batch, paths).shape == (1, 1)


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
    """K6 (forward, backward, aggregate), K7 and K8 take CPU tensors (the
    plain versions) or CUDA tensors (the kernels), nothing else."""
    from deepaco_tpu_torch.ops import deposit, gnn_layer, pick

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
    paths = torch.zeros(2, 21, 4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        deposit.tour_deposit(paths, meta(2, 4), 20, cyclic=False)


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


def test_sparse_path_without_device_raises_when_cuda_is_absent(monkeypatch):
    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.large_tsp import classic_knn_heuristic, knn_support, run_anytime_knn
    from deepaco_tpu_torch.aco.runner import ACOConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coords = torch.from_numpy(np.random.default_rng(0).random((1, 20, 2)).astype(np.float32))
    nbr = knn_support(coords, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_anytime_knn(coords, nbr, classic_knn_heuristic(coords, nbr), ACOConfig(n_ants=2),
                        1, None, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["test", "tsp", "--sparse", "-n", "1001", "--classic"])


def test_embnet_layers_refuses_meta_tensors():
    """K9 takes CPU tensors (the plain version) or CUDA tensors (the kernel)."""
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.ops import fused_gnn

    folded = fused_gnn.fold_embnet_params(Net(depth=1).emb_net)
    nbr = torch.zeros(1, 20, 4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_gnn.embnet_layers(folded, torch.zeros(1, 20, 32, device="meta"), nbr,
                                torch.zeros(1, 20, 4, 1, device="meta"), k=4)
