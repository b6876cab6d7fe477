#!/usr/bin/env python3
"""Times K1, K2, K3, K4, K5, K6, K7, K8 and K9 of this tree against the same
kernels built from another tree's sources, on one card, in turns (other,
this, this, other).

    python3 scripts/compare_kernels.py --other path/to/deepaco_tpu_torch/csrc \
        [--kernels K1 K2 K3 K4 K5 K6 K7 K7r K8 K9] [--k8-variant DIR ...]
        [--k7-variant DIR ...] [--k7r-variant DIR ...] [--out FILE]

``--other`` is the ``csrc`` directory of another checkout (for example the
parent commit unpacked with ``git archive``); its ``two_opt.cu`` and
``tour_deposit.cu`` are built into a library of their own under
``build/compare/``, its ``sweep.cu`` into a second one, its
``dense_heuristic.cu`` and ``embnet_layers.cu`` (with the
``embnet_passes.cuh`` and ``common.cuh`` beside them) into a third, and each
is called through its C entries, which must have the parent's signatures
(``deepaco_tour_deposit`` without scratch). ``--kernels`` picks the checks
(K4 and K5 run together). Inputs:

- K1 (``deepaco_dense_heuristic``) at the main path's shape (tsp500
  weights, B=100, N=500, K=50) and the NLS path's (tsp_nls500 weights with
  the start-node feature, its first 16 instances), and K9
  (``deepaco_embnet_layers``) at the sparse path's (tsp500 weights, the
  CLI's 30 TSP2000 instances, k=200, both heads): each build's max abs
  error and ``log(heu)`` error on the support (for K9 on the heu head)
  against the plain version and against the other build, their times as
  medians of 6 alternating turns of a few launches each, and each build's
  device time by kernel name under the profiler; for K9 also each build's
  and the plain f32 version's error against a float64 run with random
  weights at the same N and K (``float64_errors``). This tree's
  builds must hold their plain versions at rtol 1e-4 / atol 1e-5 and
  ``log(heu)`` within 1e-4, or the script exits 1 (the two builds sum in
  other orders, so they are not held to each other bit for bit). The
  tensor-core and shuffle instructions (``HMMA``, ``HGMMA``, ``SHFL``) of
  each K1 and K9 kernel are counted in ``cuobjdump -sass`` of both
  libraries;

- K2 (``deepaco_sweep``): its paths from both builds must be equal, with
  the same seed and Gumbel table, in bf16 and f32, stochastic and greedy, at
  the main path's shape (B=100, N=500, A=20, log of K1's heuristic), the NLS
  path's (its first 16 instances and their NLS heuristic, every ant from city
  0), row 9's (B=1, N=500, A=20), at N in {2, 33, 129, 1001, 3000} with A in
  {1, 3} (B=2, scores on a grid of halves, so that ties are common; a NaN
  row and column at N=129) and at N=4096, B=1. This tree's ``sweep.cu`` is
  also built with ``-DDEEPACO_SWEEP_WARPS=`` 1, 2 and 4 (W fixed, not chosen
  from the ants per SM), each held to the other build the same way, and all
  of them are timed in alternating turns (bf16, stochastic) at the main
  shape, at its first 50 instances, at the NLS shape, greedy at the main
  shape, and at row 9's (f32), each turn a mean of 5 launches, reported as
  medians of the turns. The noise
  floor counts the SASS instructions (``cuobjdump -sass``) of a probe kernel
  around ``sweep.cu``'s ``philox4x32_10``, less those of the same kernel
  without it, times the main shape's B*A*(N-1)*ceil(N/4) calls, over
  132 SMs x 64 INT32 lanes at the card's maximum SM clock;

- K4 and K5 on the NLS path's shape: the first 16 of ``chip_smoke.py``'s
  seeded TSP500 instances, the ``tsp_nls500_selftrained`` heuristic (K1),
  20 tours per instance that K2 samples from city 0, budget 10000, t_nls 10,
  t_p 20; K5 also with t_nls 0 (its first Euclidean descent alone), with
  budget 0 (its scans on the metric alone), and each ant launched alone, to
  show whether the slowest ant sets the batch's time;
- K8 at the CVRP path's shape (routes that K7 samples on ``1/d`` over the
  golden CVRP500 set, B=100, L=1001, A=20, n=501) and at the main path's
  (K2's tours, B=100, N=500, A=20, cyclic), beside ``torch.scatter_add``;
  each ``--k8-variant`` directory holds a ``tour_deposit.cu`` (and the
  ``common.cuh`` it includes) with this tree's C entry, timed against this
  tree's K8 in turns the same way.

- K3: the other tree's ``as_update.cu`` (an entry ``deepaco_as_update``
  that computes tau' and the costs alone, built into
  ``build/compare/libother_update_kernels.so``) followed by the PyTorch
  steps that the runner ran after such a K3 (the floor clamp,
  ``track_best``, the next score), against this tree's ``fused_tsp_update``,
  which does all of it: tau', costs, best cost and tour and score must be
  bit-equal at the main shape (K2's tours on K1's heuristic, B=100, N=500,
  A=20) and the NLS shape (its first 16 instances and heuristic, ants from
  city 0) in the main path's configuration (bf16 score, no floor), and at
  the main shape and N in {2, 33, 129, 1001} (B=3, A up to 40, ``1/d``)
  also with an f32 score and with a floor, alpha 1.5 and asymmetric
  deposits; the two arms are timed at the main and NLS shapes, medians of
  6 alternating turns of 20 launches, with their device time by kernel
  name and K3's bound (``chip_smoke.k3_work``). This tree's unstaged
  variant (``staged=False``, the one past 19,000 cities) must give the
  staged variant's bits at every one of those cases; the two are timed in
  turns at the main shape, and the unstaged one at B=1, N = 19,001, A=20
  beside its plain version and bound, where it must match the plain
  version's tau' and costs at rtol 1e-6.

- K6: the other tree's ``gnn_layer.cu`` (built into
  ``build/compare/libother_layer_kernels.so``) against this tree's, both
  through their C entries (``deepaco_gnn_layer_fwd``,
  ``deepaco_gnn_layer_bwd``, the same signatures) on the same inputs
  (random node tables, edge state and cotangents, ``ew`` scaled by 0.1):
  forward, backward and row 8 (the forward without ``pre``) at the TSP-NLS
  training shape (B=20, N=500, K=50 on k-NN neighbours), the forward at the
  CVRP inference shape (B=100, K = N = 501, the dense graph with
  self-loops) and forward and backward at the CVRP training shape (B=20,
  K = N = 501); medians of 6 alternating turns, each build's device time
  by kernel name, the plain version's time and the bound
  (``chip_smoke.k6_forward_work``, ``k6_backward_work``; the backward's
  design floor, the bytes its two passes stream, beside it). This tree's
  outputs must hold the plain versions (forward and row 8 rtol 1e-5 / atol
  1e-5, backward rtol 1e-4 / atol 1e-5 of the largest entry) and a second
  call must give the same bits, or the script exits 1; the other build's
  errors are reported.

- K7: one iteration's construction on the CVRP path (the golden CVRP500
  set, the ``cvrp500_selftrained`` heuristic, tau of ones, A=20, capacity
  50): the other tree's per-step route (``rollout`` over ``cvrp_spec``,
  each of its 1,000 steps one launch of the other build's ``pick.cu``, K7)
  against this tree's ``cvrp_construct`` (the score matrix and one launch
  of K7c), medians of 6 alternating turns, with each arm's mean route
  cost, its device time by kernel name and K7c's time alone (one launch
  through its C entry, medians of 6 alternating turns of 10); K7c's paths
  must equal its plain version's, stochastic and greedy. Each
  ``--k7-variant`` directory holds a ``cvrp_sweep.cu`` (and the
  ``common.cuh`` it includes) with this tree's C entry, timed beside K7c
  in the same turns, its equality to K7c's paths reported, not required.

- K7r (``--kernels K7r``; ``--other`` is not read): the training rollout
  with its log-probabilities at TSP500-NLS's shape (B=20, 30 ants from
  city 0, the ``tsp_nls500_selftrained`` heuristic), CVRP500's (B=1, 50
  ants, capacity 50) and BPP120's (B=1, 120 ants, capacity 150): the
  per-step route (K7 and the plug-in's glue a step, autograd's backward)
  against the fused route (one K7r launch each way), forward and backward
  together, medians of 6 alternating turns; each ``--k7r-variant``
  directory holds a ``rollout.cu`` (and the ``common.cuh`` it includes)
  with this tree's C entries, its forward and backward timed beside this
  tree's in the same turns (5 launches a turn), its paths' and gradient's
  equality to this build's reported, not required. This build's paths
  must equal ``fused_rollout_plain``'s. Beside them RCPSP's summation blend
  (``rcpsp_blend``: one seeded j120-shaped instance, the classic
  heuristic, tau of ones, 20 ants, ``chip_smoke.RCPSP_BLEND``): its
  rollout through ``engine.rollout`` on the per-step route (the spec
  without ``fused``: ``probs_fn`` and K7 a step, autograd's backward) and
  on the one-launch route (K7r's ``"blend"`` kind), with log-probabilities
  and their backward and without, medians of 6 alternating turns, with each
  route's launches; the one-launch route's paths must equal the plain
  step loop's on the same noise.

Both builds of K2, K3, K4, K5 and K8 must give equal outputs, K3's two
variants too, K7c its plain version's, and this tree's K6 its plain
version's within the tolerances above, and K7r's paths its plain
version's: the script exits 1 on any inequality.
Prints one JSON object and writes it to ``--out`` when given. Needs a CUDA
device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from profile_torch_main_path import HEURISTIC_KERNELS  # noqa: E402


def build_other(csrc: Path, sources=("two_opt.cu", "tour_deposit.cu"),
                name: str = "other", flags=()) -> ctypes.CDLL:
    from deepaco_tpu_torch.ops import _build

    out = ROOT / "build" / "compare"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}_kernels.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-shared", "-I", str(csrc),
           *[str(csrc / src) for src in sources], "-o", str(lib)]
    subprocess.run(cmd, check=True)
    return ctypes.CDLL(str(lib))


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps):
    """Device ms a call of each kernel that ``fn`` launches, under the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if us:
            out[evt.key[:60]] = us / 1e3 / reps
    return out


def turns(other_fn, this_fn, reps):
    """other, this, this, other: each a mean over ``reps`` launches."""
    o1, t1, t2, o2 = (cuda_ms(f, reps) for f in (other_fn, this_fn, this_fn, other_fn))
    return {"other_ms": [o1, o2], "this_ms": [t1, t2],
            "speedup": (o1 + o2) / (t1 + t2)}


def medians_of_turns(fns: dict, reps: int, rounds: int) -> dict:
    """Each function timed ``rounds`` times, in the order of ``fns`` and then
    in reverse, alternately; each time a mean over ``reps`` launches. Returns
    every name's times and their median."""
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(cuda_ms(fns[name], reps))
    return {name: {"median_ms": statistics.median(ts), "ms": ts} for name, ts in times.items()}


def compare_ls(result, same, other, dev, stream):
    """K4 and K5 on the NLS path's inputs."""
    import torch

    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.core.builders import start_node_features
    from deepaco_tpu_torch.ops import _build, fused_gnn, two_opt
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    P, I = _build.P, _build.I
    o_two_opt = other.deepaco_two_opt
    o_two_opt.argtypes, o_two_opt.restype = [P] * 3 + [I] * 4 + [P], ctypes.c_int
    o_nls = other.deepaco_nls
    o_nls.argtypes, o_nls.restype = [P] * 6 + [I] * 6 + [P, P], ctypes.c_int
    nls_net, coords = cs.main_path_inputs(ROOT, dev, ls="nls")
    dist = distance_matrix(coords)
    heu = fused_gnn.tsp_dense_heuristic(nls_net, start_node_features(coords), dist, cs.K)
    hd = two_opt.heuristic_dist(heu)
    metric = hd.to(torch.bfloat16).contiguous()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    b, n, a = coords.shape[0], cs.N, cs.A
    start = torch.zeros((b, a), dtype=torch.int64, device=dev)
    score = torch.log(torch.clamp(heu, min=1e-30)).to(torch.bfloat16)
    tours = bt.dense_sweep_fused(score, start, gen).transpose(1, 2).contiguous()
    budget = cs.LS_BUDGET

    def other_k4(c=coords, t=tours):
        out = torch.empty_like(t)
        _build.check(o_two_opt(c.data_ptr(), t.data_ptr(), out.data_ptr(), c.shape[0],
                               t.shape[1], n, budget, stream()), "other two_opt")
        return out

    def other_k5(t_nls, c=coords, m=metric, t=tours, max_it=budget):
        out = torch.empty_like(t)
        keys = torch.empty((c.shape[0], 2, n, 16), dtype=torch.int32, device=dev)
        negative = torch.empty(c.shape[0], dtype=torch.int32, device=dev)
        _build.check(o_nls(c.data_ptr(), m.data_ptr(), keys.data_ptr(), negative.data_ptr(),
                           t.data_ptr(), out.data_ptr(), c.shape[0], t.shape[1], n, max_it,
                           t_nls, 20, None, stream()), "other nls")
        return out

    result["ls_shape"] = {"B": b, "N": n, "A": a, "budget": budget, "t_p": 20}
    same.update({
        "two_opt": torch.equal(other_k4(), two_opt.batched_two_opt_euclid(coords, tours, budget)),
        "nls": torch.equal(other_k5(10), two_opt.batched_nls_euclid(coords, hd, tours, budget)),
        "nls_t0": torch.equal(other_k5(0), two_opt.batched_nls_euclid(coords, hd, tours,
                                                                      budget, 0)),
    })
    result["K4"] = turns(other_k4, lambda: two_opt.batched_two_opt_euclid(coords, tours, budget), 3)
    result["K5"] = turns(lambda: other_k5(10),
                         lambda: two_opt.batched_nls_euclid(coords, hd, tours, budget), 3)
    result["K5_t_nls_0"] = turns(lambda: other_k5(0),
                                 lambda: two_opt.batched_nls_euclid(coords, hd, tours, budget, 0),
                                 3)
    # budget 0: no Euclidean scan at all, only the 10 x 20 scans on the metric
    result["K5_metric_only"] = turns(lambda: other_k5(10, max_it=0),
                                     lambda: two_opt.batched_nls_euclid(coords, hd, tours, 0), 3)

    def per_ant(fn):
        """Each ant launched alone: its ms, in (instance, ant) order."""
        times = []
        for i in range(b):
            for j in range(a):
                c, m, t = coords[i:i + 1], metric[i:i + 1], tours[i:i + 1, j:j + 1].contiguous()
                times.append(cuda_ms(lambda: fn(c, m, t), 1))
        return times

    for name, fn in (("other", lambda c, m, t: other_k5(10, c, m, t)),
                     ("this", lambda c, m, t: two_opt.batched_nls_euclid(c, m.float(), t,
                                                                         budget))):
        times = per_ant(fn)
        result[f"K5_alone_{name}"] = {"max_ms": max(times), "mean_ms": sum(times) / len(times),
                                     "min_ms": min(times),
                                     "slowest": divmod(times.index(max(times)), a)}


def compare_k8(result, same, other, variants, dev, stream):
    """K8 at the CVRP and TSP shapes, beside ``scatter_add`` and each
    ``--k8-variant``."""
    import torch

    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.problems.tsp import tour_cost
    from deepaco_tpu_torch.ops import _build, deposit, fused_gnn
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    P, I = _build.P, _build.I
    o_dep = other.deepaco_tour_deposit
    o_dep.argtypes, o_dep.restype = [P] * 3 + [I] * 5 + [P], ctypes.c_int
    n, a = cs.N, cs.A
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    _, cvrp_ds = cs.family_inputs(ROOT, dev, "cvrp")
    cvrp_paths, cvrp_amounts, _ = cs.cvrp_rollout(dev, cvrp_ds)
    main_net, main_coords = cs.main_path_inputs(ROOT, dev)
    main_dist = distance_matrix(main_coords)
    main_heu = fused_gnn.tsp_dense_heuristic(main_net, main_coords, main_dist, cs.K)
    main_start = torch.randint(0, n, (main_coords.shape[0], a), generator=gen, device=dev)
    tsp_paths = bt.dense_sweep_fused(torch.log(main_heu).to(torch.bfloat16), main_start, gen)
    tsp_amounts = 1.0 / tour_cost(main_dist, tsp_paths)
    for name, (p, w, nn, cyclic) in {"K8_cvrp": (cvrp_paths, cvrp_amounts, cs.CVRP_N + 1, False),
                                     "K8_tsp": (tsp_paths, tsp_amounts, n, True)}.items():
        pb, pl, pa = p.shape
        p, w = p.contiguous(), w.float().contiguous()

        def other_k8(p=p, w=w, nn=nn, cyclic=cyclic, pb=pb, pl=pl, pa=pa):
            out = torch.empty((pb, nn, nn), device=dev)
            _build.check(o_dep(p.data_ptr(), w.data_ptr(), out.data_ptr(), pb, pl, pa, nn,
                               int(cyclic), stream()), "other tour_deposit")
            return out

        this_k8 = lambda p=p, w=w, nn=nn, cyclic=cyclic: deposit.tour_deposit(p, w, nn,
                                                                            cyclic=cyclic)
        u, v = deposit.tour_edges(p, cyclic)
        index = (u * nn + v).flatten(-2)
        values = w[..., None].expand(u.shape).flatten(-2)
        zeros = torch.zeros((pb, nn * nn), device=dev)
        result[name] = {"B": pb, "L": pl, "A": pa, "n": nn, "equal": torch.equal(other_k8(),
                                                                             this_k8()),
                        **turns(other_k8, this_k8, 50),
                        "library_ms": cuda_ms(lambda: torch.scatter_add(zeros, -1, index,
                                                                        values), 50),
                        "this_kernels_ms": kernel_ms(this_k8, 10)}
        same[name] = result[name]["equal"]
        for vname, fn in variants.items():
            def variant_k8(p=p, w=w, nn=nn, cyclic=cyclic, pb=pb, pl=pl, pa=pa, fn=fn):
                out = torch.empty((pb, nn, nn), device=dev)
                rec = torch.empty((pb, pl * pa, 2), dtype=torch.int32, device=dev)
                ends = torch.empty((pb, nn * pa + pa), dtype=torch.int32, device=dev)
                _build.check(fn(p.data_ptr(), w.data_ptr(), out.data_ptr(), rec.data_ptr(),
                                ends.data_ptr(), pb, pl, pa, nn, int(cyclic), stream()),
                             "variant tour_deposit")
                return out

            equal = torch.equal(variant_k8(), this_k8())
            result[name][f"variant_{vname}"] = {"equal": equal,
                                                **turns(variant_k8, this_k8, 50)}
            same[f"{name}_{vname}"] = equal


PHILOX_PROBE = """
#include "sweep.cu"
__global__ void philox_probe(const uint4* c, const uint2* k, uint4* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = deepaco::philox4x32_10(c[i], k[i]);
}
__global__ void philox_probe_base(const uint4* c, const uint2* k, uint4* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint4 x = c[i];
  const uint2 y = k[i];
  out[i] = make_uint4(x.x ^ y.x, x.y, x.z ^ y.y, x.w);
}
"""


def sass_ops(binary: Path) -> dict:
    """Each function's SASS opcodes in an object or library, from
    ``cuobjdump -sass``, predicates left out."""
    from deepaco_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(binary)], capture_output=True, text=True,
                          check=True).stdout
    return {part.split()[0]: [m.group(1) for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", part)]
        for part in sass.split("Function : ")[1:]}


def philox_sass_count(csrc: Path) -> dict:
    """SASS instructions (NOPs left out) of one ``philox4x32_10`` call: a
    probe kernel around it, less the same kernel without it, both built from
    ``csrc/sweep.cu`` with the port's flags and read with ``cuobjdump -sass``."""
    from deepaco_tpu_torch.ops import _build

    out = ROOT / "build" / "compare"
    out.mkdir(parents=True, exist_ok=True)
    src, obj = out / "philox_probe.cu", out / "philox_probe.o"
    src.write_text(PHILOX_PROBE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-c", str(src),
                    "-o", str(obj)], check=True)
    counts = {name: {"instructions": sum(op != "NOP" for op in ops),
                     "uniform": sum(op.startswith("U") for op in ops)}
              for name, ops in sass_ops(obj).items()}
    probe, base = counts["_Z12philox_probePK5uint4PK5uint2PS_"], counts[
        "_Z17philox_probe_basePK5uint4PK5uint2PS_"]
    return {"per_call": probe["instructions"] - base["instructions"],
            "uniform_per_call": probe["uniform"] - base["uniform"], "kernels": counts}


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def compare_k2(result, same, other_csrc: Path, variants: list, dev, stream):
    """K2: paths equal to the other build's at every shape, dtype and mode;
    W in {1, 2, 4} and each ``--k2-variant`` timed against the other build
    in turns; the noise floor. A variant's equality is reported, not
    required: a variant may change the noise to show what it costs."""
    import torch

    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.core.builders import start_node_features
    from deepaco_tpu_torch.ops import _build, fused_gnn
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    P, I = _build.P, _build.I

    def entry(lib):
        fn = lib.deepaco_sweep
        fn.argtypes, fn.restype = [P] * 5 + [I] * 5 + [P], ctypes.c_int
        return fn

    this_csrc = _build.CSRC
    jobs = {"other": (other_csrc, "other_sweep", ())}
    jobs.update({f"W{w}": (this_csrc, f"this_sweep_w{w}", (f"-DDEEPACO_SWEEP_WARPS={w}",))
                 for w in (1, 2, 4)})
    jobs.update({f"variant_{path.name}": (path, f"k2_variant{k}", ())
                 for k, path in enumerate(variants)})
    with ThreadPoolExecutor(len(jobs) + 1) as pool:  # one nvcc each, all together
        sass = pool.submit(philox_sass_count, this_csrc)
        libs = {k: pool.submit(build_other, csrc, ("sweep.cu",), name, flags)
                for k, (csrc, name, flags) in jobs.items()}
        builds = {k: entry(f.result()) for k, f in libs.items()}
        sass = sass.result()
    builds["this"] = _build.function("deepaco_sweep", [P] * 5 + [I] * 5 + [P])
    seed = torch.tensor([0x5EED0123456789], dtype=torch.int64, device=dev)
    table = bt._gumbel_table(dev)

    def sweep(fn, score, start, stochastic):
        b, n, _ = score.shape
        a = start.shape[1]
        paths = torch.empty((b, n, a), dtype=torch.int64, device=dev)
        _build.check(fn(score.data_ptr(), start.data_ptr(), paths.data_ptr(), seed.data_ptr(),
                        table.data_ptr(), b, n, a, int(score.dtype == torch.bfloat16),
                        int(stochastic), stream()), "deepaco_sweep")
        return paths

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 8)
    main_net, main_coords = cs.main_path_inputs(ROOT, dev)
    main_heu = fused_gnn.tsp_dense_heuristic(main_net, main_coords, distance_matrix(main_coords),
                                             cs.K)
    main_score = torch.log(torch.clamp(main_heu, min=1e-30))
    nls_net, nls_coords = cs.main_path_inputs(ROOT, dev, ls="nls")
    nls_heu = fused_gnn.tsp_dense_heuristic(nls_net, start_node_features(nls_coords),
                                            distance_matrix(nls_coords), cs.K)
    n = cs.N
    cases = {
        "main": (main_score, torch.randint(0, n, (main_score.shape[0], cs.A), generator=gen,
                                           device=dev)),
        "nls": (torch.log(torch.clamp(nls_heu, min=1e-30)),
                torch.zeros((nls_heu.shape[0], cs.A), dtype=torch.int64, device=dev)),
        "row9": (main_score[:1].contiguous(), torch.randint(0, n, (1, cs.A), generator=gen,
                                                            device=dev)),
    }
    for rn in (2, 33, 129, 1001, 3000):
        for ra in (1, 3):
            grid = torch.randint(-8, 8, (2, rn, rn), generator=gen, device=dev).float() / 2
            if rn == 129:
                grid[0, 7] = float("nan")        # a whole row
                grid[1, :, 5] = float("nan")     # a whole column
            cases[f"N{rn}_A{ra}"] = (grid, torch.randint(0, rn, (2, ra), generator=gen,
                                                         device=dev))
    cases["N4096_B1"] = (torch.randn((1, 4096, 4096), generator=gen, device=dev),
                         torch.randint(0, 4096, (1, 2), generator=gen, device=dev))
    equal = {}
    for name, (score, start) in cases.items():
        dtypes = (torch.float32,) if name == "row9" else (torch.bfloat16, torch.float32)
        for dtype in dtypes:
            s = score.to(dtype).contiguous()
            for stochastic in (True, False):
                want = sweep(builds["other"], s, start, stochastic)
                for bname in builds:
                    if bname == "other":
                        continue
                    key = f"{name}_{str(dtype)[6:]}_{'stoch' if stochastic else 'greedy'}_{bname}"
                    equal[key] = bool(torch.equal(sweep(builds[bname], s, start, stochastic),
                                                  want))
    result["K2_equal"] = {k: v for k, v in equal.items() if "variant_" not in k}
    result["K2_variants_equal"] = {k: v for k, v in equal.items() if "variant_" in k}
    same["K2"] = all(result["K2_equal"].values())

    timed = {}
    main_b = main_score.shape[0]
    for name, case, dtype, stochastic, b in (
            ("main", "main", torch.bfloat16, True, main_b),
            ("main_greedy", "main", torch.bfloat16, False, main_b),
            ("main_B50", "main", torch.bfloat16, True, main_b // 2),
            ("nls", "nls", torch.bfloat16, True, cs.B_NLS),
            ("row9", "row9", torch.float32, True, 1)):
        score, start = cases[case]
        s, st = score[:b].to(dtype).contiguous(), start[:b].contiguous()
        fns = {bname: (lambda fn=fn: sweep(fn, s, st, stochastic)) for bname, fn in builds.items()}
        timed[name] = {"B": b, "N": n, "A": cs.A, "dtype": str(dtype)[6:],
                       "stochastic": stochastic, **medians_of_turns(fns, reps=5, rounds=6)}
        timed[name]["speedup"] = timed[name]["other"]["median_ms"] / timed[name]["this"]["median_ms"]
    result["K2_times"] = timed
    calls = main_b * cs.A * (n - 1) * -(-n // 4)
    clock = max_sm_clock_hz()
    result["K2_noise_floor"] = {
        "philox_sass": sass, "calls": calls, "max_sm_clock_hz": clock,
        "int32_lanes": 132 * 64,
        "noise_floor_ms": sass["per_call"] * calls / (132 * 64 * clock) * 1e3}


def sass_counts(lib: Path, names=HEURISTIC_KERNELS, ops=("HMMA", "HGMMA", "SHFL")) -> dict:
    """Per kernel of ``lib`` whose name holds one of ``names``: how many of
    its SASS instructions start with each of ``ops``. Each translation unit
    keeps its own copy of a shared kernel, so the mangled names stay apart."""
    return {fname: {op: sum(f.startswith(op) for f in found) for op in ops}
            for fname, found in sass_ops(lib).items() if any(n in fname for n in names)}


def other_entry(lib, name: str, argtypes: list):
    """The C entry ``name`` of another build, with the package's argument
    types for it."""
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def embnet_layers_with(fn):
    """A ``layers=`` argument of ``fused_gnn.net_forward_fast`` that runs K9
    through the C entry ``fn`` with the package's own scratch and packing."""
    from deepaco_tpu_torch.ops import fused_gnn

    def layers(f, x_emb, nbr, edge, *, k, node_update=True):
        return fused_gnn._launch_layers(f, x_emb, nbr, edge, node_update, entry=fn)

    return layers


def float64_errors(other_layers, dev) -> dict:
    """K9 at the sparse path's N and K on one instance with Flax-law random
    weights, the case of the card test
    ``test_embnet_layers_kernel_with_random_weights_against_float64``: each
    build's and the plain f32 version's max abs error against the plain
    version's steps run in float64, and how many entries of each build miss
    rtol 1e-4 / atol 1e-5 against the plain f32 version."""
    import torch

    from deepaco_tpu_torch.aco.large_tsp import knn_support, sparse_tsp_graph
    from deepaco_tpu_torch.models.gnn import Net, init_like_flax
    from deepaco_tpu_torch.ops import fused_gnn

    n, k = cs.SPARSE_N, cs.SPARSE_N // 10
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
    plain = fused_gnn.embnet_layers_plain(f, x, g.nbr, g.edge, k=k)
    out = {"N": n, "K": k, "max_abs_edge_state": ref.abs().max().item(),
           "plain_f32": {"max_abs_err": (plain.double() - ref).abs().max().item()}}
    for name, fn in (("this", fused_gnn.embnet_layers), ("other", other_layers)):
        got = fn(f, x, g.nbr, g.edge, k=k)
        miss = (got - plain).abs() > 1e-5 + 1e-4 * plain.abs()
        out[name] = {"max_abs_err": (got.double() - ref).abs().max().item(),
                     "entries_missing_plain_f32": int(miss.sum().item()),
                     "entries": miss.numel()}
    return out


def compare_k1_k9(result, same, other_csrc: Path, picked: set, dev):
    """K1 at the main and NLS shapes and K9 at the sparse shape: errors
    against the plain versions and the other build, times in turns, and
    the kernels' SASS counts."""
    import torch

    from deepaco_tpu_torch.core.builders import start_node_features
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.ops import _build, fused_gnn
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    other = build_other(other_csrc, ("dense_heuristic.cu", "embnet_layers.cu"), "other_gnn")
    result["K1_K9_sass"] = {"this": sass_counts(_build.LIB_PATH),
                            "other": sass_counts(ROOT / "build" / "compare" /
                                                 "libother_gnn_kernels.so")}
    log_err = lambda a, b: (a.log() - b.log()).abs().max().item()
    holds = lambda got, want, lerr: bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5)
                                         and lerr <= 1e-4)
    if "K1" in picked:
        o_k1 = other_entry(other, "deepaco_dense_heuristic", fused_gnn.K1_ARGTYPES)
        main_net, main_coords = cs.main_path_inputs(ROOT, dev)
        nls_net, nls_coords = cs.main_path_inputs(ROOT, dev, ls="nls")
        nls_coords = nls_coords[:cs.B_NLS]
        for name, net, x, coords in (
                ("K1_main", main_net, main_coords, main_coords),
                ("K1_nls", nls_net, start_node_features(nls_coords), nls_coords)):
            dist = distance_matrix(coords)
            support = topk_smallest(dist, cs.K)[1]
            this_fn = lambda: fused_gnn.tsp_dense_heuristic(net, x, dist, cs.K)
            other_fn = lambda: fused_gnn._launch(net, "heu", x, dist, cs.K, 1e-10, entry=o_k1)
            outs = {"this": this_fn(), "other": other_fn(),
                    "plain": fused_gnn.tsp_dense_heuristic_plain(net, x, dist, cs.K)}
            on = {key: v.gather(2, support) for key, v in outs.items()}
            entry = {"B": dist.shape[0], "N": cs.N, "K": cs.K}
            for a, b in (("this", "plain"), ("other", "plain"), ("this", "other")):
                entry[f"{a}_vs_{b}"] = {"max_abs_err": (outs[a] - outs[b]).abs().max().item(),
                                        "max_log_err_on_support": log_err(on[a], on[b])}
            same[f"{name}_holds_plain"] = holds(outs["this"], outs["plain"],
                                                entry["this_vs_plain"]["max_log_err_on_support"])
            del outs, on
            entry.update(medians_of_turns({"other": other_fn, "this": this_fn}, reps=5,
                                          rounds=6))
            entry["speedup"] = entry["other"]["median_ms"] / entry["this"]["median_ms"]
            entry["kernels_ms"] = {"other": kernel_ms(other_fn, 3), "this": kernel_ms(this_fn, 3)}
            result[name] = entry
    if "K9" in picked:
        o_layers = embnet_layers_with(other_entry(other, "deepaco_embnet_layers",
                                                  fused_gnn.K9_ARGTYPES))
        net, g = cs.sparse_inputs(ROOT, dev)
        f = fused_gnn.fold_embnet_params(net.emb_net)
        x = fused_gnn._node_embedding(f, g.x)
        k = g.nbr.shape[-1]
        heads = ("phe", "heu")
        builds = {"this": fused_gnn.embnet_layers, "other": o_layers,
                  "plain": fused_gnn.embnet_layers_plain}
        outs = {key: fused_gnn.net_forward_fast(net, g.x, g.nbr, g.edge, heads=heads,
                                                layers=fn) for key, fn in builds.items()}
        entry = {"B": g.nbr.shape[0], "N": g.nbr.shape[1], "K": k, "heads": heads}
        for a, b in (("this", "plain"), ("other", "plain"), ("this", "other")):
            entry[f"{a}_vs_{b}"] = {
                "max_abs_err": max((p - q).abs().max().item() for p, q in zip(outs[a], outs[b])),
                "max_log_heu_err": log_err(outs[a][1] + 1e-10, outs[b][1] + 1e-10)}
        same["K9_sparse_holds_plain"] = all(
            holds(p, q, entry["this_vs_plain"]["max_log_heu_err"])
            for p, q in zip(outs["this"], outs["plain"]))
        del outs
        fns = {"other": lambda: o_layers(f, x, g.nbr, g.edge, k=k),
               "this": lambda: fused_gnn.embnet_layers(f, x, g.nbr, g.edge, k=k)}
        entry.update(medians_of_turns(fns, reps=3, rounds=6))
        entry["speedup"] = entry["other"]["median_ms"] / entry["this"]["median_ms"]
        entry["kernels_ms"] = {key: kernel_ms(fn, 2) for key, fn in fns.items()}
        entry["random_weights_vs_float64"] = float64_errors(o_layers, dev)
        result["K9_sparse"] = entry


def other_update(entry, stream, state, paths, dist, *, decay, q, symmetric, floor, log_heu,
                 alpha, score_dtype):
    """The other tree's K3 (``deepaco_as_update(tau, paths, dist, tau_out,
    costs, pos, B, N, A, decay, q, symmetric, stream)``: tau' and the costs)
    and the PyTorch steps that the runner ran around such a K3: the floor
    clamp, ``track_best`` and the next score, as ``_batched_update`` and
    ``run_anytime_batched`` wrote them."""
    import torch

    from deepaco_tpu_torch.aco.runner import track_best
    from deepaco_tpu_torch.ops import _build

    b, n, a = paths.shape
    tau = state.phe.tau
    tau_out = torch.empty_like(tau)
    costs = torch.empty((b, a), dtype=torch.float32, device=tau.device)
    pos = torch.empty((b, a, n), dtype=torch.int32, device=tau.device)
    _build.check(entry(tau.data_ptr(), paths.data_ptr(), dist.data_ptr(), tau_out.data_ptr(),
                       costs.data_ptr(), pos.data_ptr(), b, n, a, decay, q, int(symmetric),
                       stream()), "other deepaco_as_update")
    if floor > 0.0:
        tau_out = torch.clamp(tau_out, min=floor)
    state = track_best(state, paths, costs)
    state = state._replace(phe=state.phe._replace(tau=tau_out))
    score = (alpha * torch.log(torch.clamp(state.phe.tau, min=1e-30))
             + log_heu).to(score_dtype)
    return state, costs, score


def compare_k3(result, same, other_csrc: Path, dev, stream):
    """K3: the other tree's kernel plus its PyTorch steps against this tree's
    one pass, bit for bit (tau', costs, best cost and tour, score), at the main
    and NLS shapes in the main path's configuration and with the score in
    f32, a floor, asymmetric deposits and ragged N; timed in alternating
    turns at the main and NLS shapes (bf16 score, no floor), with each
    arm's device time by kernel name."""
    import torch

    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.problems.tsp import tour_cost
    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.core.builders import start_node_features
    from deepaco_tpu_torch.ops import _build, fused_gnn
    from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

    P, I, F = _build.P, _build.I, _build.F
    lib = build_other(other_csrc, ("as_update.cu",), "other_update")
    entry = other_entry(lib, "deepaco_as_update", [P] * 6 + [I] * 3 + [F, F, I, P])
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 10)

    def case(b, n, coords, x, net, start):
        """K2's tours on K1's heuristic, tau in [0.5, 1.5), the heuristic's
        log and a best state that instance 0 beats, the others not, and the
        last ties its cheapest tour."""
        dist = distance_matrix(coords)
        if net is None:
            heu = 1.0 / dist
        else:
            heu = fused_gnn.tsp_dense_heuristic(net, x, dist, min(cs.K, n - 1))
        log_heu = torch.log(torch.clamp(heu, min=1e-30))
        paths = bt.dense_sweep_fused(log_heu.to(torch.bfloat16), start, gen)
        cheapest = tour_cost(dist, paths).min(-1).values
        best = cheapest - 1.0
        best[0] = cheapest[0] + 1.0
        best[-1] = cheapest[-1]
        state = bt._batched_init(b, n, ACOConfig(n_ants=start.shape[1]), dev)
        state = state._replace(
            phe=state.phe._replace(tau=0.5 + torch.rand((b, n, n), generator=gen, device=dev)),
            best_cost=best, best_path=torch.randint(0, n, (b, n), generator=gen, device=dev))
        return state, paths, dist, log_heu

    main_net, main_coords = cs.main_path_inputs(ROOT, dev)
    nls_net, nls_coords = cs.main_path_inputs(ROOT, dev, ls="nls")
    a = cs.A
    cases = {
        "main": case(cs.B, cs.N, main_coords, main_coords, main_net,
                     torch.randint(0, cs.N, (cs.B, a), generator=gen, device=dev)),
        "nls": case(cs.B_NLS, cs.N, nls_coords, start_node_features(nls_coords), nls_net,
                    torch.zeros((cs.B_NLS, a), dtype=torch.int64, device=dev)),
    }
    for rn, ra in ((2, 3), (33, 5), (129, 40), (1001, 20)):
        c = uniform_coords(rn, torch.Generator().manual_seed(rn), batch=3, device=dev)
        cases[f"N{rn}_A{ra}"] = case(3, rn, c, c, None,
                                     torch.randint(0, rn, (3, ra), generator=gen, device=dev))
    configs = {"main_path": dict(symmetric=True, floor=0.0, alpha=1.0,
                                 score_dtype=torch.bfloat16),
               "f32_score": dict(symmetric=True, floor=0.0, alpha=1.0,
                                 score_dtype=torch.float32),
               "floor_asymmetric": dict(symmetric=False, floor=0.7, alpha=1.5,
                                        score_dtype=torch.bfloat16)}
    equal = {}
    for name, (state, paths, dist, log_heu) in cases.items():
        for cname, cfg in configs.items():
            if cname != "main_path" and name == "nls":
                continue
            kw = dict(decay=0.9, q=1.0, log_heu=log_heu, **cfg)
            want = other_update(entry, stream, state, paths, dist, **kw)
            got = bt.fused_tsp_update(state, paths, dist, **kw)
            parts = {"tau": (got[0].phe.tau, want[0].phe.tau), "costs": (got[1], want[1]),
                     "best_cost": (got[0].best_cost, want[0].best_cost),
                     "best_path": (got[0].best_path, want[0].best_path),
                     "score": (got[2], want[2])}
            equal[f"{name}_{cname}"] = {k: bool(torch.equal(x, y)) for k, (x, y) in parts.items()}
            if not equal[f"{name}_{cname}"]["score"]:
                equal[f"{name}_{cname}"]["score_entries_differing"] = int(
                    (got[2] != want[2]).sum().item())
            del got, want
    result["K3_equal"] = equal
    same["K3"] = all(all(v for k, v in e.items() if k != "score_entries_differing")
                     for e in equal.values())
    timed = {}
    for name in ("main", "nls"):
        state, paths, dist, log_heu = cases[name]
        kw = dict(decay=0.9, q=1.0, log_heu=log_heu, **configs["main_path"])
        fns = {"other": lambda: other_update(entry, stream, state, paths, dist, **kw),
               "this": lambda: bt.fused_tsp_update(state, paths, dist, **kw)}
        b = paths.shape[0]
        timed[name] = {"B": b, "N": cs.N, "A": a, **medians_of_turns(fns, reps=20, rounds=6),
                       "kernels_ms": {k: kernel_ms(fn, 10) for k, fn in fns.items()},
                       "bound_ms": cs.bound(*cs.k3_work(b, cs.N, a, 2))[0]}
        timed[name]["speedup"] = timed[name]["other"]["median_ms"] / timed[name]["this"]["median_ms"]
    result["K3_times"] = timed
    compare_k3_unstaged(result, same, cases, configs, dev, gen)


def compare_k3_unstaged(result, same, cases, configs, dev, gen):
    """K3's unstaged variant (every N past the staged limit) against the
    staged one, bit for bit at every case and configuration of
    :func:`compare_k3`; the two timed in alternating turns at the main
    shape, and the unstaged variant alone at B=1, N = 19,001 (one past the
    staged limit), A as the main path, beside its plain version and bound."""
    import torch

    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

    equal = {}
    for name, (state, paths, dist, log_heu) in cases.items():
        for cname, cfg in configs.items():
            kw = dict(decay=0.9, q=1.0, log_heu=log_heu, **cfg)
            got = bt.fused_tsp_update(state, paths, dist, staged=False, **kw)
            want = bt.fused_tsp_update(state, paths, dist, staged=True, **kw)
            equal[f"{name}_{cname}"] = bool(
                torch.equal(got[0].phe.tau, want[0].phe.tau) and torch.equal(got[1], want[1])
                and torch.equal(got[0].best_cost, want[0].best_cost)
                and torch.equal(got[0].best_path, want[0].best_path)
                and torch.equal(got[2], want[2]))
            del got, want
    result["K3_unstaged_equal"] = equal
    same["K3_unstaged"] = all(equal.values())
    state, paths, dist, log_heu = cases["main"]
    kw = dict(decay=0.9, q=1.0, log_heu=log_heu, **configs["main_path"])
    fns = {"staged": lambda: bt.fused_tsp_update(state, paths, dist, staged=True, **kw),
           "unstaged": lambda: bt.fused_tsp_update(state, paths, dist, staged=False, **kw)}
    timed = {"main": {**medians_of_turns(fns, reps=20, rounds=6),
                      "kernels_ms": {k: kernel_ms(fn, 10) for k, fn in fns.items()}}}
    del state, paths, dist, log_heu
    n, a = bt.K3_STAGED_MAX_N + 1, cs.A
    dist = distance_matrix(uniform_coords(n, torch.Generator().manual_seed(n), batch=1,
                                          device=dev))
    log_heu = -torch.log(dist)
    paths = bt.dense_sweep_fused(log_heu.to(torch.bfloat16),
                                 torch.randint(0, n, (1, a), generator=gen, device=dev), gen)
    state = bt._batched_init(1, n, ACOConfig(n_ants=a), dev)
    state = state._replace(phe=state.phe._replace(
        tau=0.5 + torch.rand((1, n, n), generator=gen, device=dev)))
    kw = dict(decay=0.9, q=1.0, log_heu=log_heu, **configs["main_path"])
    got = bt.fused_tsp_update(state, paths, dist, **kw)
    want = bt.fused_tsp_update_plain(state, paths, dist, **kw)
    big_ok = bool(torch.allclose(got[0].phe.tau, want[0].phe.tau, rtol=1e-6, atol=0)
                  and torch.allclose(got[1], want[1], rtol=1e-6, atol=0))
    del got, want
    fns = {"unstaged": lambda: bt.fused_tsp_update(state, paths, dist, **kw)}
    timed[f"N{n}"] = {"B": 1, "N": n, "A": a, "matches_plain_rtol_1e-6": big_ok,
                      **medians_of_turns(fns, reps=5, rounds=6),
                      "kernels_ms": {"unstaged": kernel_ms(fns["unstaged"], 5)},
                      "plain_ms": cuda_ms(lambda: bt.fused_tsp_update_plain(
                          state, paths, dist, **kw), 3),
                      "bound_ms": cs.bound(*cs.k3_work(1, n, a, 2))[0]}
    same["K3_unstaged"] = same["K3_unstaged"] and big_ok
    result["K3_unstaged_times"] = timed


def k6_inputs(dev, b: int, n: int, k: int, seed: int, backward: bool) -> dict:
    """K6's inputs: ``b`` instances of ``n`` uniform cities with their ``k``
    nearest neighbours (``k = n``: the dense graph with self-loops, the CVRP
    graph's), random node tables, edge state and, with ``backward``, the
    cotangents."""
    import torch

    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.ops import gnn_layer
    from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

    u = gnn_layer.UNITS
    if k == n:
        nbr = torch.arange(n, device=dev).expand(b, n, n)
    else:
        coords = uniform_coords(n, torch.Generator().manual_seed(seed), batch=b, device=dev)
        nbr = topk_smallest(distance_matrix(coords), k)[1]
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    t = {"nbr": nbr, "index": gnn_layer.reverse_adjacency(nbr),
         "x2": rnd(b, n, u), "x3": rnd(b, n, u), "x4": rnd(b, n, u), "w": rnd(b, n, k, u),
         "ew": rnd(u, u) * 0.1, "eb": rnd(u) * 0.1}
    if backward:
        t.update(d_agg=rnd(b, n, u), d_pre=rnd(b, n, k, u))
    return t


def k6_calls(fwd, bwd, t: dict, stream):
    """Launches of one build's K6 entries on ``t`` into outputs of their own:
    ``(forward, row 8, backward)``, each returning its outputs (the
    backward's allocated only when ``t`` holds cotangents)."""
    import torch

    from deepaco_tpu_torch.ops import _build

    idx = t["index"]
    b, n, k = idx.nbr32.shape
    e = lambda *shape: torch.empty(shape, dtype=torch.float32, device=t["w"].device)
    agg, pre, agg8 = e(b, n, 32), e(b, n, k, 32), e(b, n, 32)
    if "d_pre" in t:
        d_w, d_x3, d_x2, d_x4 = e(b, n, k, 32), e(b, n, 32), e(b, n, 32), e(b, n, 32)
    ptr = {key: v.data_ptr() for key, v in t.items() if torch.is_tensor(v)}

    def forward():
        _build.check(fwd(ptr["x2"], ptr["x3"], ptr["x4"], idx.nbr32.data_ptr(), ptr["w"],
                         ptr["ew"], ptr["eb"], agg.data_ptr(), pre.data_ptr(), b, n, n, k, 1,
                         stream()), "deepaco_gnn_layer_fwd")
        return agg, pre

    def row8():
        _build.check(fwd(ptr["x2"], None, None, idx.nbr32.data_ptr(), ptr["w"], None, None,
                         agg8.data_ptr(), None, b, n, n, k, 0, stream()),
                     "deepaco_gnn_layer_fwd")
        return (agg8,)

    def backward():
        _build.check(bwd(ptr["x2"], idx.nbr32.data_ptr(), idx.offsets.data_ptr(),
                         idx.edges.data_ptr(), ptr["w"], ptr["ew"], ptr["d_agg"], ptr["d_pre"],
                         d_w.data_ptr(), d_x3.data_ptr(), d_x2.data_ptr(), d_x4.data_ptr(),
                         b, n, k, stream()), "deepaco_gnn_layer_bwd")
        return d_x2, d_x3, d_x4, d_w

    return forward, row8, backward


def compare_k6(result, same, other_csrc: Path, dev, stream):
    """K6: the other tree's ``gnn_layer.cu`` against this tree's, through
    their C entries on the same inputs; this tree's outputs held to the
    plain versions and to themselves on a second call."""
    import torch

    from deepaco_tpu_torch.ops import _build, gnn_layer

    P, I = _build.P, _build.I
    fwd_args, bwd_args = [P] * 9 + [I] * 5 + [P], [P] * 12 + [I] * 3 + [P]
    lib = build_other(other_csrc, ("gnn_layer.cu",), "other_layer")
    builds = {"other": (other_entry(lib, "deepaco_gnn_layer_fwd", fwd_args),
                        other_entry(lib, "deepaco_gnn_layer_bwd", bwd_args)),
              "this": (_build.function("deepaco_gnn_layer_fwd", fwd_args),
                       _build.function("deepaco_gnn_layer_bwd", bwd_args))}
    u = gnn_layer.UNITS
    # (name, B, N, K, parts, launches a turn)
    cases = (("train", cs.B_TRAIN, cs.N, cs.K, ("forward", "row8", "backward"), 20),
             ("cvrp_infer", 100, cs.CVRP_N + 1, cs.CVRP_N + 1, ("forward",), 5),
             ("cvrp_train", cs.B_TRAIN, cs.CVRP_N + 1, cs.CVRP_N + 1,
              ("forward", "backward"), 5))
    err = lambda a, r: (a - r).abs().max().item()
    for name, b, n, k, parts, reps in cases:
        t = k6_inputs(dev, b, n, k, cs.SEED + n + k, "backward" in parts)
        calls = {key: dict(zip(("forward", "row8", "backward"), k6_calls(*fns, t, stream)))
                 for key, fns in builds.items()}
        with torch.no_grad():
            layer_args = (t["x2"], t["x3"], t["x4"], t["nbr"], t["w"], t["ew"], t["eb"])
            plain = {"forward": lambda: gnn_layer.fused_gnn_layer_plain(*layer_args),
                     "row8": lambda: (gnn_layer.gated_mean_aggregate_plain(
                         t["x2"], t["nbr"], t["w"]),),
                     "backward": lambda: gnn_layer.fused_gnn_layer_backward_plain(
                         t["x2"], t["nbr"], t["w"], t["ew"], t["d_agg"], t["d_pre"])[:4]}
            for part in parts:
                want = plain[part]()
                if part == "backward":    # d_x2, d_x3, d_x4, d_w
                    holds = lambda a, r: bool(torch.allclose(
                        a, r, rtol=1e-4, atol=1e-5 * r.abs().max().item()))
                else:
                    holds = lambda a, r: bool(torch.allclose(a, r, rtol=1e-5, atol=1e-5))
                entry = {"B": b, "N": n, "K": k}
                for key, fns in calls.items():
                    got = [v.clone() for v in fns[part]()]
                    again = fns[part]()
                    entry[f"{key}_vs_plain"] = {
                        "max_abs_err": max(err(a, r) for a, r in zip(got, want)),
                        "holds": all(holds(a, r) for a, r in zip(got, want)),
                        "repeat_bit_equal": all(torch.equal(a, a2) for a, a2 in zip(got, again))}
                    del got, again
                same[f"K6_{name}_{part}"] = (entry["this_vs_plain"]["holds"]
                                             and entry["this_vs_plain"]["repeat_bit_equal"])
                del want
                entry["plain_ms"] = cuda_ms(plain[part], 1)
                entry.update(medians_of_turns({key: c[part] for key, c in calls.items()},
                                              reps=reps, rounds=6))
                entry["speedup"] = entry["other"]["median_ms"] / entry["this"]["median_ms"]
                entry["kernels_ms"] = {key: kernel_ms(c[part], 3) for key, c in calls.items()}
                if part == "backward":
                    work = cs.k6_backward_work(b, n, k, u)
                    # the design streams w and d_pre twice (edge and node
                    # passes) and writes d_w once
                    entry["design_floor_ms"] = 5 * 4 * b * n * k * u / cs.HBM_BYTES_PER_S * 1e3
                else:
                    work = cs.k6_forward_work(b, n, n, k, u, part == "forward")
                entry.update(zip(("bound_ms", "bound_by"), cs.bound(*work)))
                result[f"K6_{name}_{part}"] = entry
        del t, calls
        torch.cuda.empty_cache()


def compare_k7(result, same, other_csrc: Path, variants: list, dev, stream):
    """K7: one CVRP500 iteration's construction, the other tree's per-step
    route (``rollout`` over ``cvrp_spec``, each step one launch of the other
    build's ``deepaco_pick``, K7) against this tree's ``cvrp_construct``
    (the score matrix, then one launch of K7c), in turns; K7c's paths must
    equal its plain version's, stochastic and greedy."""
    import torch

    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.problems.cvrp import cvrp_spec, route_cost
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.families import CVRP_CAPACITY, get_family
    from deepaco_tpu_torch.ops import _build
    from deepaco_tpu_torch.ops import cvrp_construct as cc
    from deepaco_tpu_torch.train.drivers import _forward_heu

    P, I = _build.P, _build.I
    entry = build_other(other_csrc, ("pick.cu",), "other_pick").deepaco_pick
    entry.argtypes, entry.restype = [P] * 5 + [I] * 2 + [P], ctypes.c_int

    def other_pick(score_rows, mask, gumbel):
        r, n = score_rows.shape
        action = torch.empty((r,), dtype=torch.int64, device=dev)
        logp = torch.empty((r,), dtype=torch.float32, device=dev)
        _build.check(entry(score_rows.contiguous().data_ptr(), mask.contiguous().data_ptr(),
                           gumbel.contiguous().data_ptr(), action.data_ptr(), logp.data_ptr(),
                           r, n, stream()), "deepaco_pick")
        return action, logp

    entry_args = [P] * 4 + [_build.F] + [I] * 4 + [P]
    builds = {"this": _build.function("deepaco_cvrp_sweep", entry_args)}
    for k, path in enumerate(variants):
        fn = build_other(path, ("cvrp_sweep.cu",), f"k7_variant{k}").deepaco_cvrp_sweep
        fn.argtypes, fn.restype = entry_args, ctypes.c_int
        builds[f"variant_{path.name}"] = fn
    seed = torch.tensor([0x5EED0123456789], dtype=torch.int64, device=dev)

    def k7c(fn, score, demand):
        b, n, _ = score.shape
        paths = torch.empty((b, 2 * (n - 1) + 1, cs.A), dtype=torch.int64, device=dev)
        _build.check(fn(score.data_ptr(), demand.data_ptr(), paths.data_ptr(), seed.data_ptr(),
                        CVRP_CAPACITY, b, n, cs.A, 1, stream()), "deepaco_cvrp_sweep")
        return paths

    # the first iteration of the CVRP path's kernel arm: tau of ones and the
    # cvrp500_selftrained heuristic over the golden CVRP500 set
    net, ds = cs.family_inputs(ROOT, dev, "cvrp")
    inst = {k: torch.as_tensor(v, device=dev) for k, v in ds.items()}
    with torch.no_grad():
        heu = _forward_heu(get_family("cvrp"), net.eval(), inst, 0)
    tau = torch.ones_like(heu)
    demand, dist = inst["demand"], inst["dist"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 10)
    per_step = lambda: rollout(cvrp_spec(tau, heu, demand, CVRP_CAPACITY, cs.A), gen,
                               pick=other_pick).paths
    one_pass = lambda: cc.cvrp_construct(score_matrix(tau, heu, 1.0, 1.0), demand,
                                         CVRP_CAPACITY, cs.A, gen)
    score = score_matrix(tau, heu, 1.0, 1.0)
    equal = {}
    for stochastic in (True, False):
        gens = [torch.Generator(device=dev).manual_seed(cs.SEED + 11) for _ in range(2)]
        got = cc.cvrp_construct(score, demand, CVRP_CAPACITY, cs.A, gens[0],
                                stochastic=stochastic)
        want = cc.cvrp_construct_plain(score, demand, CVRP_CAPACITY, cs.A, gens[1],
                                       stochastic=stochastic)
        equal["stochastic" if stochastic else "greedy"] = bool(torch.equal(got, want))
    same["K7c"] = all(equal.values())
    with torch.no_grad():
        costs = {"per_step_other": route_cost(dist, per_step()).mean().item(),
                 "one_pass_this": route_cost(dist, one_pass()).mean().item()}
        times = medians_of_turns({"other": per_step, "this": one_pass}, reps=1, rounds=6)
        k7c_alone = medians_of_turns(
            {name: (lambda fn=fn: k7c(fn, score, demand)) for name, fn in builds.items()},
            reps=10, rounds=6)
        want = k7c(builds["this"], score, demand)
        for name, fn in builds.items():
            k7c_alone[name]["paths_equal_this"] = bool(torch.equal(k7c(fn, score, demand), want))
        device = {"other": kernel_ms(per_step, 1), "this": kernel_ms(one_pass, 5)}
    result["K7"] = {
        "B": heu.shape[0], "N": heu.shape[-1], "A": cs.A, "capacity": CVRP_CAPACITY,
        "paths_equal_plain": equal, "mean_route_cost": costs, **times,
        "speedup": times["other"]["median_ms"] / times["this"]["median_ms"],
        "k7c_alone": k7c_alone, "device_ms_by_kernel": device}


def k7r_cases(dev):
    """K7r's inputs at the training shapes, name -> (score, start, noise,
    shape): TSP500-NLS (``tsp_nls500_selftrained``'s heuristic on the main
    path's first 20 instances, 30 ants from city 0), CVRP500
    (``cvrp500_selftrained`` on the first golden instance, 50 ants, capacity
    50) and BPP120 (``bpp120_selftrained``, 120 ants, capacity 150)."""
    import torch

    from deepaco_tpu_torch.aco.engine import gumbel
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.core.builders import start_node_features
    from deepaco_tpu_torch.families import BPP_CAPACITY, CVRP_CAPACITY, get_family
    from deepaco_tpu_torch.ops import fused_gnn
    from deepaco_tpu_torch.ops.rollout import TSP_SHAPE, RolloutShape
    from deepaco_tpu_torch.train.drivers import _forward_heu, instance_tensors
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    nls_net, _ = cs.main_path_inputs(ROOT, dev, ls="nls")
    _, coords = cs.main_path_inputs(ROOT, dev)
    c = coords[:cs.B_TRAIN]
    with torch.no_grad():
        heu = fused_gnn.tsp_dense_heuristic(nls_net, start_node_features(c), distance_matrix(c),
                                            cs.K)
    a = cs.A_TRAIN_NLS
    # the score contiguous, as the wrapper passes it (a family's heuristic
    # may come transposed)
    cases = {"tsp500_nls": (score_matrix(torch.ones_like(heu), heu, 1.0, 1.0).contiguous(),
                            torch.zeros((c.shape[0], a), dtype=torch.int64, device=dev),
                            gumbel((cs.N - 1, c.shape[0], a, cs.N), gen, dev), TSP_SHAPE)}
    for name, capacity, ants in (("cvrp", CVRP_CAPACITY, cs.A_TRAIN),
                                 ("bpp", BPP_CAPACITY, cs.FAMILY_PATHS["bpp"][2])):
        net, ds = cs.family_inputs(ROOT, dev, name)
        inst = instance_tensors({k: v[:1] for k, v in ds.items()}, dev)
        with torch.no_grad():
            heu = _forward_heu(get_family(name), net.eval(), inst, 0)
        n = heu.shape[-1]
        cases[f"{name}{n - 1}"] = (
            score_matrix(torch.ones_like(heu), heu, 1.0, 1.0).contiguous(),
            torch.zeros((1, ants), dtype=torch.int64, device=dev),
            gumbel((2 * (n - 1), 1, ants, n), gen, dev),
            RolloutShape("cvrp", inst["demand"], capacity))
    return cases


def compare_k7r(result, same, variants: list, dev):
    """K7r at the training shapes (``k7r_cases``): the training rollout,
    forward and backward, through the per-step route (the plug-in's step
    loop, K7 and PyTorch's glue a step, autograd's backward) against the
    fused route (one K7r launch each way), medians of 6 turns; and each
    ``--k7r-variant`` build of another ``rollout.cu`` against this tree's,
    forward and backward apart, medians of 6 turns of 5 launches, with its
    paths' and gradient's equality to this build's. This build's paths must
    equal ``fused_rollout_plain``'s."""
    import torch

    from deepaco_tpu_torch.ops import _build
    from deepaco_tpu_torch.ops import rollout as ro
    from deepaco_tpu_torch.ops.pick import fused_pick

    P, I, F = _build.P, _build.I, _build.F
    fwd_args, bwd_args = [P] * 4 + [F] + [I] * 6 + [P] * 8, [P] * 9 + [I] * 5 + [P] * 2
    entries = {"this": (_build.function("deepaco_rollout_fwd", fwd_args),
                        _build.function("deepaco_rollout_bwd", bwd_args))}
    for k, path in enumerate(variants):
        lib = build_other(path, ("rollout.cu",), f"k7r_variant{k}")
        lib.deepaco_rollout_fwd.argtypes, lib.deepaco_rollout_bwd.argtypes = fwd_args, bwd_args
        lib.deepaco_rollout_fwd.restype = lib.deepaco_rollout_bwd.restype = ctypes.c_int
        entries[f"variant_{path.name}"] = (lib.deepaco_rollout_fwd, lib.deepaco_rollout_bwd)
    stream = _build.stream_ptr(dev)
    ptr = lambda x: None if x is None else x.data_ptr()

    def forward(entry, score, start, noise, shape):
        """One launch of a build's forward entry: (paths, logp, trace)."""
        cvrp = shape.kind == "cvrp"
        b, n, _ = score.shape
        a, t = start.shape[1], noise.shape[0]
        new = lambda shape_, dtype: torch.empty(shape_, dtype=dtype, device=dev)
        paths, logp, lse = new((b, t + 1, a), torch.int64), new((b, t, a), torch.float32), \
            new((b, t, a), torch.float32)
        pos = new((b, a, n), torch.int32)
        rem = new((b, t, a), torch.float32) if cvrp else None
        dep = new((b, a, t), torch.int32) if cvrp else None
        ndep = new((b, a), torch.int32) if cvrp else None
        _build.check(entry(score.data_ptr(), start.data_ptr(), noise.data_ptr(),
                           ptr(shape.demand) if cvrp else None, float(shape.capacity), b, n, a,
                           t, int(cvrp), 0, paths.data_ptr(), logp.data_ptr(), lse.data_ptr(),
                           pos.data_ptr(), ptr(rem), ptr(dep), ptr(ndep), stream),
                     "deepaco_rollout_fwd")
        return paths, logp, ro.RolloutTrace(paths, lse, pos, rem, dep, ndep)

    def backward(entry, score, trace, g, shape):
        cvrp = shape.kind == "cvrp"
        b, n, _ = score.shape
        d = torch.empty_like(score)
        _build.check(entry(score.data_ptr(), trace.paths.data_ptr(), g.data_ptr(),
                           trace.lse.data_ptr(), trace.pos.data_ptr(), ptr(trace.rem),
                           ptr(trace.dep), ptr(trace.ndep), ptr(shape.demand) if cvrp else None,
                           b, n, g.shape[2], g.shape[1], int(cvrp), d.data_ptr(), stream),
                     "deepaco_rollout_bwd")
        return d

    def route(score, start, noise, shape, fused):
        """The training rollout and its backward: K7r, or K7 a step with
        the plug-in's glue, on the same score, starts and noise."""
        leaf = score.clone().requires_grad_(True)
        if fused:
            _, logp = ro.fused_rollout(leaf, start, noise, shape)
        else:
            _, logp = ro._step_loop(leaf, start, noise, shape, fused_pick)
        logp.sum().backward()
        return leaf.grad

    out = {}
    for name, (score, start, noise, shape) in k7r_cases(dev).items():
        g = torch.randn((score.shape[0], noise.shape[0], start.shape[1]),
                        generator=torch.Generator(device=dev).manual_seed(cs.SEED + 21),
                        device=dev)
        with torch.no_grad():
            want, _ = ro.fused_rollout_plain(score, start, noise, shape)
        runs = {k: forward(fwd, score, start, noise, shape) for k, (fwd, _) in entries.items()}
        d = {k: backward(entries[k][1], score, runs[k][2], g, shape) for k in entries}
        same[f"K7r_{name}"] = bool(torch.equal(runs["this"][0], want))
        case = {"B": score.shape[0], "N": score.shape[-1], "A": start.shape[1],
                "T": noise.shape[0], "paths_equal_plain": same[f"K7r_{name}"],
                "route": medians_of_turns(
                    {"per_step": lambda: route(score, start, noise, shape, False),
                     "fused": lambda: route(score, start, noise, shape, True)}, reps=1, rounds=6),
                "forward": medians_of_turns(
                    {k: (lambda fwd=fwd: forward(fwd, score, start, noise, shape))
                     for k, (fwd, _) in entries.items()}, reps=5, rounds=6),
                "backward": medians_of_turns(
                    {k: (lambda k=k: backward(entries[k][1], score, runs[k][2], g, shape))
                     for k in entries}, reps=5, rounds=6)}
        case["route"]["speedup"] = (case["route"]["per_step"]["median_ms"]
                                    / case["route"]["fused"]["median_ms"])
        for k in entries:
            case["forward"][k]["paths_equal_this"] = bool(torch.equal(runs[k][0], runs["this"][0]))
            case["forward"][k]["logp_max_abs_diff"] = (runs[k][1] - runs["this"][1]).abs().max().item()
            case["backward"][k]["d_max_abs_diff"] = (d[k] - d["this"]).abs().max().item()
            case["backward"][k]["d_equal_this"] = bool(torch.equal(d[k], d["this"]))
        out[name] = case
    out["rcpsp_blend"] = compare_k7r_blend(same, dev)
    result["K7r"] = out


def compare_k7r_blend(same, dev) -> dict:
    """RCPSP's summation blend (``chip_smoke.RCPSP_BLEND``) on one seeded
    j120-shaped instance (122 activities), the classic heuristic and tau of
    ones, 20 ants: the rollout with log-probabilities and their backward
    (training) and without (inference), on the per-step route (the spec
    without ``fused``) and on K7r's, medians of 6 alternating turns, each
    route's launches in one run; the K7r route's paths must equal the plain
    step loop's (``fused_pick_plain``'s route) on the same seed."""
    import numpy as np
    import torch

    from deepaco_tpu_torch.aco import engine
    from deepaco_tpu_torch.aco.problems import rcpsp as apr
    from deepaco_tpu_torch.core import rcpsp as core
    from deepaco_tpu_torch.ops import rollout as ro
    from deepaco_tpu_torch.ops.pick import fused_pick, fused_pick_plain

    data = core.stack_rcpsp([core.parse_rcp(core.progen_rcp(np.random.default_rng(cs.SEED),
                                                            jobs=120))], device=dev)
    heu = core.default_rcpsp_heuristic(data)
    tau = torch.ones_like(heu)
    cfg = apr.RCPSPConfig(n_ants=cs.A, **cs.RCPSP_BLEND)
    gen = lambda: torch.Generator(device=dev).manual_seed(cs.SEED)

    def spec(fused, h=heu):
        s = apr.rcpsp_spec(tau, h, data, cfg)
        return s if fused else s._replace(fused=None)

    def train(fused):
        leaf = heu.clone().requires_grad_(True)
        engine.rollout(spec(fused, leaf), gen(), require_prob=True).log_probs.sum().backward()
        return leaf.grad

    def infer(fused, pick=fused_pick):
        with torch.no_grad():
            return engine.rollout(spec(fused), gen(), pick=pick).paths

    counted = (fused_pick, ro.fused_rollout, ro.fused_rollout_backward, ro.fused_rollout_paths)

    def launches(fn):
        before = [f.launches for f in counted]
        fn()
        torch.cuda.synchronize()
        return {f.__name__: f.launches - b for f, b in zip(counted, before)}

    equal = bool(torch.equal(infer(True), infer(True, fused_pick_plain)))
    same["K7r_rcpsp_blend"] = equal
    out = {"B": 1, "N": data.n, "A": cs.A, "T": data.n - 1, **cs.RCPSP_BLEND,
           "paths_equal_plain": equal}
    for name, fn in (("train", train), ("infer", infer)):
        case = medians_of_turns({"per_step": lambda: fn(False), "fused": lambda: fn(True)},
                                reps=1, rounds=6)
        case["speedup"] = case["per_step"]["median_ms"] / case["fused"]["median_ms"]
        case["launches"] = {"per_step": launches(lambda: fn(False)),
                            "fused": launches(lambda: fn(True))}
        out[name] = case
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--kernels", nargs="+",
                    default=["K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9"],
                    help="the checks to run (K4 and K5 run together)")
    ap.add_argument("--k8-variant", type=Path, action="append", default=[])
    ap.add_argument("--k2-variant", type=Path, action="append", default=[],
                    help="a directory with a sweep.cu (and the common.cuh it includes)")
    ap.add_argument("--k7-variant", type=Path, action="append", default=[],
                    help="a directory with a cvrp_sweep.cu (and the common.cuh it includes)")
    ap.add_argument("--k7r-variant", type=Path, action="append", default=[],
                    help="a directory with a rollout.cu (and the common.cuh it includes)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    picked = set(args.kernels)

    from deepaco_tpu_torch.ops import _build

    dev = torch.device("cuda")
    _build.library()
    P, I = _build.P, _build.I
    stream = lambda: _build.stream_ptr(dev)
    result = {"card": cs.card_line(), "device": torch.cuda.get_device_name(0)}
    same = {}
    if picked & {"K4", "K5", "K8"}:
        other = build_other(args.other.resolve())
        if picked & {"K4", "K5"}:
            compare_ls(result, same, other, dev, stream)
        if "K8" in picked:
            variants = {}
            for k, path in enumerate(args.k8_variant):
                fn = build_other(path.resolve(), ("tour_deposit.cu",),
                                 f"variant{k}").deepaco_tour_deposit
                fn.argtypes, fn.restype = [P] * 5 + [I] * 5 + [P], ctypes.c_int
                variants[path.name] = fn
            compare_k8(result, same, other, variants, dev, stream)
    if picked & {"K1", "K9"}:
        compare_k1_k9(result, same, args.other.resolve(), picked, dev)
    if "K2" in picked:
        compare_k2(result, same, args.other.resolve(),
                   [p.resolve() for p in args.k2_variant], dev, stream)
    if "K3" in picked:
        compare_k3(result, same, args.other.resolve(), dev, stream)
    if "K6" in picked:
        compare_k6(result, same, args.other.resolve(), dev, stream)
    if "K7" in picked:
        compare_k7(result, same, args.other.resolve(), [p.resolve() for p in args.k7_variant],
                   dev, stream)
    if "K7r" in picked:
        compare_k7r(result, same, [p.resolve() for p in args.k7r_variant], dev)
    result["outputs_equal"] = same
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
