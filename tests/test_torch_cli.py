"""The port's command line (deepaco_tpu_torch/cli.py): ``test tsp --sparse``,
``test cvrp`` (with and without ``--local-search swapstar``) print the JAX
CLI's three output lines, ``train`` writes checkpoints that the port reads
back, ``solve-cvrp`` prints the engine's routes; what cannot run exits
with its reason (``test|train rcpsp`` and ``test tsp`` in
tests/test_torch_rcpsp.py and tests/test_torch_tsp_facade.py)."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deepaco_tpu_torch import cli


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
SMALL = ["test", "tsp", "--sparse", "-n", "1001", "--limit", "1", "-a", "4", "-t", "1"]


@pytest.mark.parametrize("arm", [["--classic"],
                                 ["--ckpt", "checkpoints/tsp500_selftrained.msgpack"]])
def test_sparse_protocol_prints_the_jax_cli_lines(arm, capsys, monkeypatch):
    """n=1001 (k=100), one instance, 4 ants, T=1, on the CPU: the lines of
    cli.py:332-339, and the means the call returns."""
    monkeypatch.chdir(ROOT)
    means, curves = cli.main(SMALL + arm, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert re.fullmatch(r"total duration: \d+\.\d\ds", lines[0])
    assert lines[1] == f"T=1, average cost is {means[0]:.6f}."
    out = json.loads(lines[2])
    assert out["problem"] == "tsp_sparse" and out["n"] == 1001 and out["instances"] == 1
    assert out["t_aco"] == [1] and out["means"] == [float(means[0])]
    assert set(out) == {"problem", "n", "instances", "t_aco", "means", "duration_s"}
    assert curves.shape == (1, 1) and np.isfinite(means).all()


@pytest.mark.parametrize("argv,match", [
    (["test", "tsp", "--sparse", "-n", "1000", "--classic"], "set DEEPACO_REFERENCE_DATA"),
    (["test", "cvrp", "-n", "1001"], r"scales \(20, 100, 500\)"),
    (["test", "op", "-n", "50"], r"scales \(100, 200, 300\)"),
    (["test", "tsp", "-n", "1001"], r"empty/tsp/testDataset-1001\.pt does not exist"),
    (["test", "tsp", "--sparse", "-n", "1001", "--b-chunk", "4"], "--b-chunk is a TPU watchdog"),
    (["test", "rcpsp"], "set DEEPACO_REFERENCE_ROOT"),
    (["test", "tsp", "--sparse", "-n", "1001", "--ckpt", "x.pt"],
     r"cannot read checkpoint x\.pt: .*No such file"),
    (["test", "tsp", "--sparse", "-n", "1003"], r"checkpoints/tsp1003\.msgpack"),
    (["test", "tsp", "-n", "20", "--per-instance"], "--per-instance applies to test tsp with"),
    (["test", "cvrp", "-n", "20", "--b-chunk", "4"], "--b-chunk is a TPU watchdog"),
    (["train", "rcpsp"], "set DEEPACO_REFERENCE_ROOT"),
    (["test", "tsp", "-n", "100", "--local-search", "nls"], "set DEEPACO_REFERENCE_DATA"),
], ids=[f"argv{i}-{m}" for i, m in enumerate((   # each case keeps its first id
    "golden TSP sets", r"scales \(20, 100, 500\)", r"scales \(100, 200, 300\)",
    "ROADMAP.md §1 item 10", "--b-chunk .*item 10", "test rcpsp .*item 10", "unreadable .pt",
    r"checkpoints/tsp1003\.msgpack", "--per-instance .*item 10", "--b-chunk .*item 10",
    "train rcpsp .*item 10", "test tsp .*item 10"))])
def test_what_is_not_ported_exits_with_a_reason(argv, match, monkeypatch, tmp_path):
    """What the port cannot run exits with its reason: the reference's
    data without the variable that points at them (named), or a missing
    golden file (named, ``-n 1001`` with the variable set to an empty
    directory), ``--b-chunk``, a flag where it does not apply, a missing
    checkpoint, or a ``.pt`` one that cannot be read (named, with the
    error)."""
    monkeypatch.chdir(ROOT)
    for var in ("DEEPACO_REFERENCE_DATA", "DEEPACO_REFERENCE_ROOT"):
        monkeypatch.delenv(var, raising=False)
    if argv[:4] == ["test", "tsp", "-n", "1001"]:
        (tmp_path / "empty").mkdir()
        monkeypatch.setenv("DEEPACO_REFERENCE_DATA", str(tmp_path / "empty"))
    with pytest.raises(SystemExit, match=match):
        cli.main(argv, device="cpu")


def _three_lines(capsys, problem, n, t_values, means):
    """The lines of cli.py:546-549 for ``means``: the duration, one line a
    T, the JSON record."""
    lines = capsys.readouterr().out.strip().splitlines()[-2 - len(t_values):]
    assert re.fullmatch(r"total duration: \d+\.\d\ds", lines[0])
    assert lines[1:-1] == [f"T={t}, average cost is {v:.6f}." for t, v in zip(t_values, means)]
    out = json.loads(lines[-1])
    assert set(out) == {"problem", "n", "t_aco", "means", "duration_s"}
    assert out["problem"] == problem and out["n"] == n and out["t_aco"] == t_values
    assert out["means"] == [float(v) for v in means]


@pytest.mark.parametrize("arm", [["--classic"],
                                 ["-c", "checkpoints/cvrp20_selftrained.msgpack"]])
def test_cvrp_protocol_prints_the_jax_cli_lines(arm, capsys, monkeypatch):
    """``test cvrp`` on the golden CVRP20 set, 3 instances, 4 ants, T=1 and 2,
    on the CPU: the JAX CLI's lines, and a curve that does not rise."""
    monkeypatch.chdir(ROOT)
    means, curves = cli.main(["test", "cvrp", "-n", "20", "--limit", "3", "-a", "4",
                              "-t", "1", "2"] + arm, device="cpu")
    _three_lines(capsys, "cvrp", 20, [1, 2], means)
    assert curves.shape == (3, 2) and bool((curves[:, 1] <= curves[:, 0]).all())


def test_train_cvrp_writes_a_checkpoint_that_test_cvrp_reads(tmp_path, capsys):
    """``train cvrp`` at n=12 (1 epoch of 2 steps, batch 2, 4 ants, 2
    validation instances): the JAX CLI's epoch and ``saved`` lines, the
    checkpoint and its ``-best`` / ``-last`` files; ``test cvrp -c`` reads it
    (the net is size-free, so at the golden scale 20)."""
    out = tmp_path / "cvrp12.msgpack"
    state = cli.main(["train", "cvrp", "-n", "12", "-a", "4", "-e", "1", "-s", "2", "-b", "2",
                      "--val-instances", "2", "-o", str(out)], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"epoch 0: mean cost \d+\.\d{4}, val best@T=10 \d+\.\d{4} "
                        r"\(\d+\.\ds\)", lines[0])
    assert lines[-1] == f"saved {out}" and state.step == 2
    assert all((tmp_path / f"cvrp12{s}.msgpack").exists() for s in ("", "-best", "-last"))
    means, _ = cli.main(["test", "cvrp", "-n", "20", "--limit", "2", "-a", "4", "-t", "1",
                         "-c", str(out)], device="cpu")
    _three_lines(capsys, "cvrp", 20, [1], means)


@pytest.mark.parametrize("problem,n", [("op", 100), ("pctsp", 20), ("smtwtp", 50)])
def test_family_protocol_prints_the_jax_cli_lines(problem, n, capsys, monkeypatch):
    """``test op|pctsp|smtwtp`` on the smallest golden scale with its
    committed checkpoint, 2 instances, 4 ants, T=1 and 2, on the CPU: the
    JAX CLI's lines, and a curve that moves one way (OP maximizes the prize
    it collects)."""
    monkeypatch.chdir(ROOT)
    means, curves = cli.main(["test", problem, "-n", str(n), "--limit", "2", "-a", "4",
                              "-t", "1", "2", "-c",
                              f"checkpoints/{problem}{n}_selftrained.msgpack"], device="cpu")
    _three_lines(capsys, problem, n, [1, 2], means)
    sign = -1.0 if problem == "op" else 1.0
    assert curves.shape == (2, 2) and bool((sign * curves[:, 1] <= sign * curves[:, 0]).all())


def test_train_op_writes_a_checkpoint_that_test_op_reads(tmp_path, capsys):
    """``train op`` at n=20 (1 epoch of 2 steps, batch 2, 4 ants, 2
    validation instances), then ``test op -c`` at the golden scale 100."""
    out = tmp_path / "op20.msgpack"
    state = cli.main(["train", "op", "-n", "20", "-a", "4", "-e", "1", "-s", "2", "-b", "2",
                      "--val-instances", "2", "-o", str(out)], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"epoch 0: mean cost \d+\.\d{4}, val best@T=10 \d+\.\d{4} "
                        r"\(\d+\.\ds\)", lines[0])
    assert lines[-1] == f"saved {out}" and state.step == 2
    means, _ = cli.main(["test", "op", "-n", "100", "--limit", "2", "-a", "4", "-t", "1",
                         "-c", str(out)], device="cpu")
    _three_lines(capsys, "op", 100, [1], means)


@pytest.mark.parametrize("argv,feats", [(["tsp"], 2), (["tsp", "--local-search", "2opt"], 1)])
def test_train_tsp_writes_a_checkpoint(argv, feats, tmp_path, capsys):
    """``train tsp`` (the family trainer, the k-NN graph on coordinates) and
    ``train tsp --local-search 2opt`` (``train_tsp`` with 2-opt on every ant,
    the one-hot start graph) at n=20, 2 epochs of 1 step: a line an epoch,
    and a checkpoint that restores in the port and runs ``evaluate_tsp``."""
    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.eval.anytime import evaluate_tsp
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
    from deepaco_tpu_torch.utils.datasets import uniform_coords

    out = tmp_path / "tsp20.msgpack"
    state = cli.main(["train", *argv, "-n", "20", "-a", "4", "-e", "2", "-s", "1", "-b", "2",
                      "-o", str(out)], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines[:2]] == ["epoch 0", "epoch 1"]
    assert lines[-1] == f"saved {out}" and state.step == 2
    tree = load_checkpoint(str(out))
    assert int(tree["step"]) == 2
    net = Net.from_jax_variables(tree)
    assert net.emb_net.v_lin0.in_features == feats
    ls = "2opt" if feats == 1 else None
    means, _ = evaluate_tsp(uniform_coords(20, torch.Generator().manual_seed(0), batch=2),
                            net=net, k_sparse=5, cfg=ACOConfig(n_ants=4), t_values=(1,),
                            ls=ls, device="cpu")
    assert bool(torch.isfinite(means).all())


def test_a_corrupt_checkpoint_surfaces_its_decode_error(tmp_path):
    bad = tmp_path / "bad.msgpack"
    bad.write_bytes(b"\x82\xa6params\xc1")             # 0xc1 is no msgpack type
    with pytest.raises(SystemExit, match="0xc1") as info:
        cli.main(SMALL + ["--ckpt", str(bad)], device="cpu")
    assert isinstance(info.value.__cause__, ValueError)


def test_the_sparse_path_refuses_a_local_search_it_does_not_run(monkeypatch):
    monkeypatch.chdir(ROOT)
    with pytest.raises(ValueError, match="2opt"):
        cli.main(SMALL + ["--classic", "--local-search", "nls"], device="cpu")


def test_python_dash_m_runs_the_cli():
    """``python -m deepaco_tpu_torch test rcpsp`` where torch sees no card
    exits non-zero with its reason: the command runs on the card unless
    asked otherwise, and says so before it reads any data."""
    env = {k: v for k, v in os.environ.items() if k != "DEEPACO_REFERENCE_ROOT"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "-m", "deepaco_tpu_torch", "test", "rcpsp"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 1 and "none is available; pass device='cpu'" in out.stderr


def test_cvrp_nls_protocol_prints_the_jax_cli_lines(capsys, monkeypatch):
    """``test cvrp --local-search swapstar`` at n=20 with the default
    checkpoint (cvrp_nls100_selftrained, the fallback for 20), 2 instances,
    4 ants, T=1 and 2: a line an instance, then the JAX CLI's three lines
    with the record of cli.py:434-436, and curves that do not rise."""
    monkeypatch.chdir(ROOT)
    means, curves = cli.main(["test", "cvrp", "-n", "20", "--local-search", "swapstar",
                              "--limit", "2", "-a", "4", "-t", "1", "2"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [re.fullmatch(r"inst \d: \d+\.\ds", line) is not None for line in lines[:2]] == [
        True, True]
    assert re.fullmatch(r"total duration: \d+\.\d\ds", lines[2])
    assert lines[3:5] == [f"T={t}, average cost is {v:.6f}." for t, v in zip((1, 2), means)]
    out = json.loads(lines[5])
    assert out["problem"] == "cvrp_nls" and out["n"] == 20 and out["instances"] == 2
    assert curves.shape == (2, 2) and bool((curves[:, 1] <= curves[:, 0]).all())


def test_train_cvrp_swapstar_writes_a_checkpoint_that_test_reads(tmp_path, capsys):
    """``train cvrp --local-search swapstar`` at n=12 (1 epoch of 2 steps, 4
    ants): the epoch and ``saved`` lines and a checkpoint that ``test cvrp
    --local-search swapstar --ckpt`` reads at n=20."""
    out = tmp_path / "nls12.msgpack"
    state = cli.main(["train", "cvrp", "--local-search", "swapstar", "-n", "12", "-a", "4",
                      "-e", "1", "-s", "2", "-o", str(out)], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"epoch 0: mean cost \d+\.\d{4} \(\d+\.\ds\)", lines[0])
    assert lines[-1] == f"saved {out}" and state.step == 2
    means, curves = cli.main(["test", "cvrp", "-n", "20", "--local-search", "swapstar",
                              "--limit", "1", "-a", "4", "-t", "1", "--ckpt", str(out)],
                             device="cpu")
    assert curves.shape == (1, 1) and np.isfinite(means).all()


def test_solve_cvrp_prints_valid_routes(tmp_path, capsys):
    """``solve-cvrp`` on a 12-customer CVRPLib file the test writes (depot
    node 1, capacity 20), 50 iterations: ``Route #i`` lines that cover every
    customer once within the capacity, the ``Cost`` of those routes and a
    ``Time`` line."""
    rng = np.random.default_rng(4)
    coords = rng.integers(0, 100, (13, 2))
    demands = np.concatenate([[0], rng.integers(1, 8, 12)])
    text = ["NAME : t13", "TYPE : CVRP", "DIMENSION : 13", "EDGE_WEIGHT_TYPE : EUC_2D",
            "CAPACITY : 20", "NODE_COORD_SECTION"]
    text += [f"{i + 1} {x} {y}" for i, (x, y) in enumerate(coords)]
    text += ["DEMAND_SECTION"] + [f"{i + 1} {d}" for i, d in enumerate(demands)]
    text += ["DEPOT_SECTION", "1", "-1", "EOF"]
    path = tmp_path / "t13.vrp"
    path.write_text("\n".join(text) + "\n")
    routes, cost = cli.main(["solve-cvrp", str(path), "--max-iters", "50", "--no-improve",
                             "20"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:-2] == [f"Route #{i + 1}: " + " ".join(str(int(c)) for c in r)
                          for i, r in enumerate(routes)]
    assert lines[-2] == f"Cost {cost:.2f}" and re.fullmatch(r"Time \d+\.\d\d", lines[-1])
    served = np.sort(np.concatenate(routes))
    np.testing.assert_array_equal(served, np.arange(1, 13))
    assert all(demands[r].sum() <= 20 for r in routes)
    dist = np.linalg.norm(coords[:, None] - coords[None], axis=-1)
    total = sum(dist[0, r[0]] + dist[r[:-1], r[1:]].sum() + dist[r[-1], 0] for r in routes)
    assert abs(total - cost) < 1e-6 * total
