"""What a run loads: in a fresh interpreter, a tiny CPU run of the harness
(the port included) loads no module whose top-level name is jax, jaxlib,
flax or deepaco_tpu, and the plain reference loads nothing of the port."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from acobench_tiny import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "deepaco_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=ROOT / "acobench" / "tests", capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    top = _loaded("from acobench_tiny import run_tiny\nassert run_tiny('tsp500.solve-t10')")
    assert "deepaco_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded("import acobench_tiny\nimport acobench.reference.check, acobench.control")
    assert not top & set(FORBIDDEN + ("deepaco_tpu_torch",))


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "acobench", "--workload", "tsp500.solve-t10",
                          "--seed", "3", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
