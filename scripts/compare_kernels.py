#!/usr/bin/env python3
"""Times K4, K5 and K8 of this tree against the same kernels built from
another tree's sources, on one card, in turns (other, this, this, other).

    python3 scripts/compare_kernels.py --other path/to/deepaco_tpu_torch/csrc \
        [--k8-variant DIR ...] [--out FILE]

``--other`` is the ``csrc`` directory of another checkout (for example the
parent commit unpacked with ``git archive``); its ``two_opt.cu`` and
``tour_deposit.cu`` are built into a library of their own under
``build/compare/`` and called through their C entries, which must have the
parent's signatures (``deepaco_tour_deposit`` without scratch). Inputs:

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

Both builds must give equal outputs. Prints one JSON object and writes it to
``--out`` when given. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def build_other(csrc: Path, sources=("two_opt.cu", "tour_deposit.cu"),
                name: str = "other") -> ctypes.CDLL:
    from deepaco_tpu_torch.ops import _build

    out = ROOT / "build" / "compare"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"lib{name}_kernels.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-I", str(csrc),
           *[str(csrc / src) for src in sources], "-o", str(lib)]
    subprocess.run(cmd, check=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--k8-variant", type=Path, action="append", default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()

    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.problems.tsp import tour_cost
    from deepaco_tpu_torch.core.builders import start_node_features
    from deepaco_tpu_torch.ops import _build, deposit, fused_gnn, two_opt
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    dev = torch.device("cuda")
    _build.library()
    other = build_other(args.other.resolve())
    P, I = _build.P, _build.I
    o_two_opt = other.deepaco_two_opt
    o_two_opt.argtypes, o_two_opt.restype = [P] * 3 + [I] * 4 + [P], ctypes.c_int
    o_nls = other.deepaco_nls
    o_nls.argtypes, o_nls.restype = [P] * 4 + [I] * 6 + [P], ctypes.c_int
    o_dep = other.deepaco_tour_deposit
    o_dep.argtypes, o_dep.restype = [P] * 3 + [I] * 5 + [P], ctypes.c_int
    variants = {}
    for k, path in enumerate(args.k8_variant):
        fn = build_other(path.resolve(), ("tour_deposit.cu",), f"variant{k}").deepaco_tour_deposit
        fn.argtypes, fn.restype = [P] * 5 + [I] * 5 + [P], ctypes.c_int
        variants[path.name] = fn
    stream = lambda: _build.stream_ptr(dev)

    def cuda_ms(fn, reps):
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

    # ---- K4 and K5 on the NLS path's inputs
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
        _build.check(o_nls(c.data_ptr(), m.data_ptr(), t.data_ptr(), out.data_ptr(),
                           c.shape[0], t.shape[1], n, max_it, t_nls, 20, stream()), "other nls")
        return out

    result = {"card": cs.card_line(), "device": torch.cuda.get_device_name(0),
              "ls_shape": {"B": b, "N": n, "A": a, "budget": budget, "t_p": 20}}
    same = {
        "two_opt": torch.equal(other_k4(), two_opt.batched_two_opt_euclid(coords, tours, budget)),
        "nls": torch.equal(other_k5(10), two_opt.batched_nls_euclid(coords, hd, tours, budget)),
        "nls_t0": torch.equal(other_k5(0), two_opt.batched_nls_euclid(coords, hd, tours,
                                                                      budget, 0)),
    }
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

    # ---- K8 at the CVRP and TSP shapes
    _, cvrp_ds = cs.cvrp_inputs(ROOT, dev)
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
    result["outputs_equal"] = same
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
