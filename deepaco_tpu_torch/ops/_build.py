"""Builds ``deepaco_tpu_torch/csrc/*.cu`` into one shared library at first use.

Each source is compiled by its own ``nvcc`` process, all started together,
and the objects are linked into ``build/kernels/libdeepaco_kernels.so`` at
the repository root. The library exposes a plain C interface and is loaded
with ``ctypes``: pointers and the stream are ``c_void_p``, and every entry
returns ``cudaGetLastError()``, which :func:`check` turns into an exception.
The library is rebuilt when it is missing or older than any source.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_PATH = BUILD_DIR / "libdeepaco_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = _sources() + sorted(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def build() -> dict:
    """Compile every source in parallel and link the library. Returns the
    wall seconds and the compiler's output (``-Xptxas -v`` resource lines);
    raises with that output if a step fails."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_PATH.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *[str(o) for _, o, _ in procs],
             "-o", str(tmp_lib)], capture_output=True, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        os.replace(tmp_lib, LIB_PATH)
    text = "\n".join(log)
    (BUILD_DIR / "build.log").write_text(text)
    return {"seconds": time.perf_counter() - t0, "log": text}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing or stale."""
    if _stale():
        build()
    return ctypes.CDLL(str(LIB_PATH))


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """The kernels take CUDA tensors only, all on one device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: expected tensors on one CUDA device, got {devs}")
