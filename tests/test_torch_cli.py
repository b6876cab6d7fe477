"""The port's command line (deepaco_tpu_torch/cli.py): ``test tsp --sparse``
prints the JAX CLI's three output lines; everything not ported exits."""
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deepaco_tpu_torch import cli

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
    (["test", "tsp", "--sparse", "-n", "1000", "--classic"], "golden TSP sets"),
    (["test", "cvrp", "-n", "1001"], "ROADMAP.md §1 item 10"),
    (["test", "tsp", "-n", "1001"], "ROADMAP.md §1 item 10"),
    (["test", "tsp", "--sparse", "-n", "1001", "--b-chunk", "4"], "--b-chunk .*item 10"),
    (["train", "tsp"], "train .*item 10"),
    (["test", "tsp", "--sparse", "-n", "1001", "--ckpt", "x.pt"], r"\.pt loader"),
    (["test", "tsp", "--sparse", "-n", "1003"], r"checkpoints/tsp1003\.msgpack"),
])
def test_what_is_not_ported_exits_with_a_reason(argv, match, monkeypatch):
    monkeypatch.chdir(ROOT)
    with pytest.raises(SystemExit, match=match):
        cli.main(argv, device="cpu")


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
    out = subprocess.run([sys.executable, "-m", "deepaco_tpu_torch", "test", "op"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1 and "item 10" in out.stderr
