"""The solve cells: a closed loop of requests to the program's anytime
entry, ``deepaco_tpu_torch.eval.anytime.evaluate_tsp`` (neural, a
configuration's k-NN heuristic, ``ACOConfig(n_ants)``, ``t_values=(T,)``,
its local search or none, ``stats`` for the best tours).

One client hands request ``i`` its batch of instances (a host array) and its
sampling seed, and sends the next once the best costs and tours of the last
are back on the host. A request's wall runs from the hand-off to that
read-back. The requests that the check compares in full run with the
program's private ``_ops`` hooks wrapped so that they keep, beside the same
kernels' outputs, the heuristic and every iteration's tours; the traced run
also wraps each phase (``heuristic``, ``construction``, ``local_search``,
``update``) in a pair of CUDA events and a profiler range.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

from acobench import traffic
from acobench.profile import REQUEST
from acobench.spec import root


class EventTimer:
    """The program's ``timer(name)`` hook: CUDA events around each phase
    (no synchronisation), and a profiler range of the same name."""

    def __init__(self):
        self.pairs = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name):
        import torch

        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"acobench.{name}"):
            start.record()
            yield
            end.record()
        self.pairs[name].append((start, end))

    def totals_ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in self.pairs.items()}


def capturing(ops, rec: dict):
    """``ops`` with the heuristic, the sweep and the local search wrapped:
    each returns what the kernel returned, and ``rec`` keeps the heuristic
    and every iteration's tours (``[B, N, A]`` as int16)."""
    import torch

    rec.update(sweeps=[], ls=[])

    def heuristic(*args, **kwargs):
        out = ops.heuristic(*args, **kwargs)
        rec["heu"] = out
        return out

    def sweep(*args, **kwargs):
        out = ops.sweep(*args, **kwargs)
        rec["sweeps"].append(out.to(torch.int16))
        return out

    def nls(*args, **kwargs):
        out = ops.nls(*args, **kwargs)
        rec["ls"].append(out.transpose(1, 2).to(torch.int16))
        return out

    return ops._replace(heuristic=heuristic, sweep=sweep, nls=nls)


class Cell:
    """Set-up, window and check of one solve cell on ``device``."""

    def __init__(self, spec: dict, seed: int, device: str = "cuda"):
        import torch

        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        cfg, tr, wl = spec["config"], spec["traffic"], spec["workload"]
        self.cfg, self.tr, self.wl = cfg, tr, wl
        if tr["law"] != traffic.LAW:
            raise ValueError(f"the generator draws {traffic.LAW!r}, not {tr['law']!r}")
        self.b, self.n, self.t = tr["batch"], cfg["n_nodes"], tr["iterations"]
        self.ls = None if cfg.get("local_search") is None else "nls"
        self.pool = traffic.instance_pool(seed, tr["pool"], self.b, self.n)
        self.samples = set(traffic.sample_requests(seed, wl["check"]["samples"],
                                                   wl["check"]["sample_span"]))
        self.records = []          # per request: (t0, t1, best costs, best tours)
        self.captures = {}         # sampled request -> capture

    # ------------------------------------------------------------ set-up ---
    def setup(self, trace: bool = False):
        """Build or load the kernels, load the weights through the program's
        own loader, and run the cell's own shape once, as the window runs it
        (plain and capturing)."""
        import torch

        from deepaco_tpu_torch.aco.batched_tsp import KERNEL_OPS
        from deepaco_tpu_torch.aco.runner import ACOConfig
        from deepaco_tpu_torch.eval.anytime import evaluate_tsp
        from deepaco_tpu_torch.models.gnn import Net
        from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

        if self.device.type == "cuda":
            from deepaco_tpu_torch.ops import _build

            _build.library()
        aco = self.cfg["aco"]
        self.acfg = ACOConfig(n_ants=aco["n_ants"], decay=aco["decay"], alpha=aco["alpha"],
                              beta=aco["beta"], q=aco["q"])
        tree = load_checkpoint(str(root() / self.cfg["checkpoint"]))
        self.net = Net.from_jax_variables(tree).to(self.device)
        self.evaluate, self.base_ops = evaluate_tsp, KERNEL_OPS
        warm = traffic.request_seed(self.seed, 0, stream=3)
        self._request(-1, self.base_ops, warm)
        self._request(-1, capturing(self.base_ops, {}), warm)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _request(self, i: int, ops, seed: int):
        """One request: ``(best costs [B], best tours [B, N], curve [B, T])``
        on the host."""
        stats = {}
        _, curves = self.evaluate(self.pool[i % len(self.pool)], net=self.net,
                                  k_sparse=self.cfg["k_sparse"], cfg=self.acfg,
                                  t_values=(self.t,), seed=seed, ls=self.ls,
                                  device=self.device, stats=stats, _ops=ops)
        curve = curves.cpu()
        return curve[:, -1].numpy(), stats["best"].cpu().numpy(), curve

    # ------------------------------------------------------------ window ---
    def window(self, seconds: float, trace: bool):
        """The closed loop for ``seconds``; with ``trace`` the phase timer on
        every request and the profiler over the cell's stretch. Returns the
        window's ``(start, end)`` on the host clock."""
        import torch

        ops, timer, prof = self.base_ops, None, None
        stretch = self.wl["trace"]
        if trace:
            timer = EventTimer()
            ops = ops._replace(timer=timer)
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
        first, last = stretch["skip"], stretch["skip"] + stretch["requests"] - 1
        # the window runs at least through the sampled requests and the
        # traced stretch
        least = max(max(self.samples, default=-1), last if trace else -1)
        start = time.perf_counter()
        i = 0
        while True:
            if time.perf_counter() - start >= seconds and i > least:
                break
            if trace and i == first:
                prof.start()
            rec = {}
            use = capturing(ops, rec) if i in self.samples else ops
            seed = traffic.request_seed(self.seed, i)
            t0 = time.perf_counter()
            with (torch.profiler.record_function(REQUEST) if trace
                  else contextlib.nullcontext()):
                cost, tours, curve = self._request(i, use, seed)
            t1 = time.perf_counter()
            self.records.append((t0, t1, cost, tours.astype(np.int16)))
            if i in self.samples:
                rec["curve"] = curve
                rec["best"] = tours
                self.captures[i] = rec
            if trace and i == last:
                prof.stop()
            i += 1
        self.timer, self.prof = timer, prof
        return self.records[0][0], self.records[-1][1]

    def release(self):
        """Free the program's net and cache once the window has closed; the
        reference's f32 products run without TF32."""
        import torch

        self.net = None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check ---
    def check(self) -> tuple[int, dict]:
        """``(failed requests, numbers)``: every request's best tours and
        costs on the host, then the sampled requests in full against the
        plain reference (on the same device, after the window)."""
        import torch

        from acobench.reference import check, msgpack

        failed, gap = 0, 0.0
        for i, (_, _, cost, tours) in enumerate(self.records):
            wrong, g = check.validate(self.pool[i % len(self.pool)], tours, cost)
            failed += wrong > 0
            gap = max(gap, g)
        numbers = {"cost_gap": gap}
        tree = msgpack.load(str(root() / self.cfg["checkpoint"]))
        for i in sorted(self.samples):
            if i not in self.captures:
                numbers["sampled_missing"] = check.SENTINEL
                continue
            coords = torch.as_tensor(self.pool[i % len(self.pool)], device=self.device)
            got = check.judge(self.captures.pop(i), coords, tree, self.cfg,
                              traffic.request_seed(self.seed, i))
            for k, v in got.items():
                numbers[k] = max(numbers.get(k, 0.0), v)
        return failed, numbers

    # ----------------------------------------------------------- metrics ---
    def context(self, window, setup_s: float) -> dict:
        """What the metric readers read."""
        from acobench.spec import load_module

        model = self.cfg["model"]
        shape = {"B": self.b, "N": self.n, "K": self.cfg["k_sparse"],
                 "A": self.cfg["aco"]["n_ants"], "T": self.t, "feats": model["feats"],
                 "layers": model["depth"], "units": model["units"],
                 "ls": self.cfg.get("local_search")}
        least = {k: load_module(root() / spec["work"]).request_least_ms(shape)
                 for k, spec in self.spec["kernels"].items()}
        ctx = {"kind": "solve", "setup_s": setup_s, "window_s": window[1] - window[0],
               "requests": len(self.records), "instances": self.b * len(self.records),
               "walls_ms": [(t1 - t0) * 1e3 for t0, t1, _, _ in self.records],
               "least_ms": least}
        if self.timer is not None:
            from acobench.profile import reduce

            ctx["spans_ms"] = self.timer.totals_ms()
            ctx["profile"] = reduce(self.prof.events(), self.spec["kernels"])
        return ctx
