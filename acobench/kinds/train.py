"""The training cells: REINFORCE steps of the program's TSP trainer,
``deepaco_tpu_torch.train.reinforce.make_tsp_train_step`` with its NLS hook
(``nls_local_search()``), back to back.

Set-up loads the configuration's weights through the program's own loader
(training goes on from the served checkpoint; ``--seed`` draws the
instances and the sampling), builds one training step and its state, and
drives it through its first three steps: they are the warm-up of the
cell's shapes, and what the check compares. The generator's state before
each of them is kept, from which the reference draws the step's instances
again; their local-search hook keeps the tours the program sampled, its
heuristic and its LS lengths; the state's weights after the three and
AdamW's first moments after the first are kept too. The window then runs the same step on the same state; each step draws
its own instances from the step's generator. ``train_step_ms`` is the
window's wall, ended by a ``synchronize()``, over its steps.
"""
from __future__ import annotations

import contextlib
import time

from acobench import traffic
from acobench.kinds.solve import EventTimer
from acobench.profile import REQUEST
from acobench.spec import load_module, root

CHECK_STEPS = 3


def flax_path(name: str) -> str:
    """A parameter of the program's net (``emb_net.v_lins1.3.weight``) by
    its Flax path (``emb_net/v_lins1_3/kernel``); a norm is a path's own."""
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    if parts[0] == "emb_net" and len(parts) == 4:
        mod = f"{parts[1]}_{parts[2]}"
        if parts[1].endswith("bns"):
            leaf = {"kernel": "scale", "bias": "bias"}[leaf]
        return f"emb_net/{mod}/{leaf}"
    if parts[0] == "emb_net":
        return f"emb_net/{parts[1]}/{leaf}"
    return f"{parts[0]}/lin_{parts[2]}/{leaf}"


class Cell:
    """Set-up, window and check of one training cell on ``device``."""

    def __init__(self, spec: dict, seed: int, device: str = "cuda"):
        import torch

        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        self.cfg, self.tr, self.wl = spec["config"], spec["traffic"], spec["workload"]
        self.records = []          # per window step: host end time
        self.timer = self.prof = None

    def problem(self):
        from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig

        tr, aco = self.tr, self.cfg["aco"]
        return ProblemConfig(
            name="tsp_nls", n_nodes=self.cfg["n_nodes"], k_sparse=self.cfg["k_sparse"],
            aco=ACOSettings(n_ants=tr["n_ants"], decay=aco["decay"], alpha=aco["alpha"],
                            beta=aco["beta"]),
            train=TrainConfig(lr=tr["lr"], weight_decay=tr["weight_decay"],
                              grad_clip=tr["grad_clip"], epochs=tr["epochs"],
                              steps_per_epoch=tr["steps_per_epoch"], batch_size=tr["batch"],
                              cosine_schedule=tr["cosine_schedule"], eps=tr["eps"]))

    # ------------------------------------------------------------ set-up ---
    def setup(self, trace: bool = False):
        import torch

        from deepaco_tpu_torch.models.gnn import Net
        from deepaco_tpu_torch.train import reinforce
        from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

        if self.device.type == "cuda":
            from deepaco_tpu_torch.ops import _build

            _build.library()
        ls = self.cfg["local_search"]
        tree = load_checkpoint(str(root() / self.cfg["checkpoint"]))
        net = Net.from_jax_variables(tree).to(self.device)
        problem = self.problem()
        state = reinforce.TrainState(net, reinforce.make_optimizer(net, problem), 0,
                                     problem.train.cosine_schedule)
        base = reinforce.nls_local_search(ls["t_nls"], ls["t_p"])
        self.captures = []

        def local_search(dist, heu, paths, coords):
            out = base(dist, heu, paths, coords)
            if len(self.captures) < CHECK_STEPS:
                self.captures.append({"paths": paths, "heu": heu, "ls": out})
            return out

        ops = reinforce.KERNEL_OPS
        if trace:
            self.timer = EventTimer()
            ops = ops._replace(timer=self.timer)
        self.step = reinforce.make_tsp_train_step(problem, local_search=local_search,
                                                  nls_w=self.tr["nls_w"], _ops=ops)
        self.gen = torch.Generator(device=self.device).manual_seed(
            traffic.request_seed(self.seed, 0, stream=5))
        params = dict(net.named_parameters())
        self.losses, self.gen_states = [], []
        for k in range(CHECK_STEPS):
            self.gen_states.append(self.gen.get_state())
            state, info = self.step(state, self.gen)
            self.losses.append(float(info.loss))
            if k == 0:
                # a parameter AdamW holds no moment for reads as one not moved
                self.first_moment = {
                    flax_path(n): state.optimizer.state.get(p, {}).get(
                        "exp_avg", torch.zeros_like(p)).clone()
                    for n, p in params.items()}
        self.after = {flax_path(n): p.detach().clone() for n, p in params.items()}
        self.state = state
        if self.timer is not None:
            self.timer.pairs.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------ window ---
    def window(self, seconds: float, trace: bool):
        """Steps back to back for ``seconds``; with ``trace`` the profiler over
        the cell's stretch of steps, the last of them ended by a
        synchronize inside its range."""
        import torch

        stretch = self.wl["trace"]
        first, last = stretch["skip"], stretch["skip"] + stretch["requests"] - 1
        if trace:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA])
        sync = (lambda: torch.cuda.synchronize()) if self.device.type == "cuda" else (lambda: None)
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds or (trace and i <= last):
            if trace and i == first:
                self.prof.start()
            with (torch.profiler.record_function(REQUEST) if trace
                  else contextlib.nullcontext()):
                self.state, _ = self.step(self.state, self.gen)
                if trace and i == last:
                    sync()
            if trace and i == last:
                self.prof.stop()
            self.records.append(time.perf_counter())
            i += 1
        sync()
        return start, time.perf_counter()

    def release(self):
        import torch

        self.state = self.step = None
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check ---
    def check(self) -> tuple[int, dict]:
        from acobench.reference import msgpack
        from acobench.reference import train as ref

        tree = msgpack.load(str(root() / self.cfg["checkpoint"]))
        for cap, gen_state in zip(self.captures, self.gen_states):
            cap["gen_state"] = gen_state
        cfg = {"k_sparse": self.cfg["k_sparse"], "local_search": self.cfg["local_search"],
               "aco": {**self.cfg["aco"], "n_ants": self.tr["n_ants"]}, "train": self.tr}
        return ref.judge(self.captures, self.losses, self.first_moment, self.after,
                         tree, cfg, self.device)

    # ----------------------------------------------------------- metrics ---
    def context(self, window, setup_s: float) -> dict:
        m = self.cfg["model"]
        shape = {"B": self.tr["batch"], "N": self.cfg["n_nodes"], "K": self.cfg["k_sparse"],
                 "A": self.tr["n_ants"], "feats": m["feats"], "layers": m["depth"],
                 "units": m["units"], "ls": self.cfg["local_search"]}
        least = {k: load_module(root() / spec["work"]).step_least_ms(shape)
                 for k, spec in self.spec["kernels"].items()}
        ctx = {"kind": "train", "setup_s": setup_s, "window_s": window[1] - window[0],
               "steps": len(self.records), "requests": len(self.records), "least_ms": least}
        if self.timer is not None:
            from acobench.profile import reduce

            ctx["spans_ms"] = self.timer.totals_ms()
            ctx["profile"] = reduce(self.prof.events(), self.spec["kernels"])
        return ctx
