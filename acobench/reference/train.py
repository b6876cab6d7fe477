"""The plain reference of a TSP-NLS training step, DeepACO's tsp_nls/train.py
(train_instance, 15-44) with its envelope, in plain PyTorch and f32.

One step on instances ``coords [B, N, 2]`` that it draws itself from the
state of the step's generator, with the tours ``paths [B, N, A]`` that the
program sampled and the lengths ``ls [B, A]`` its local search gave them
(the reference reads them only to judge them): the net in train mode (each
instance's own BatchNorm statistics) on the 50-NN graph with the one-hot
start feature, the heuristic ``scatter + 1e-10``; each step's
log-probability of the tours under the softmax of ``beta*log(heu)`` over
the unvisited cities; the tours' lengths; the advantage ``W (ls - mean ls)
+ (1-W) (raw - mean raw)``, ``W = 0.95``; the loss ``mean_b sum_a adv
sum_t log p / A``; its gradient; the clip by the global norm at 3.0 (scaled
when the norm is at least 3); AdamW (betas 0.9, 0.999, eps 1e-8, weight
decay 1e-2 decoupled, torch's order) at the cosine rate ``lr (1 + cos(pi k
/ K)) / 2`` of update ``k``.

The local search's lengths are the program's own state, which the step
follows; :func:`nls_lengths` judges that stage by itself twice: NLS (budget
``N // 4``, ``t_nls`` 10, ``t_p`` 20, the metric ``1 / (heu / rowmax +
1e-5)`` in bf16) from each sampled tour, on the program's heuristic (the
lengths agree to round-off) and on the reference's own (the bf16 metric
rounds apart wherever the two heuristics sit on a rounding boundary, a
perturbation move flips, and that ant ends in another local optimum: a few
ants in a thousand part, PERF.md's findings).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from acobench.reference import gnn, nls

BETAS, EPS = (0.9, 0.999), 1e-8


def leaves(tree: dict) -> dict:
    """The parameters of a Flax tree as ``{"emb_net/v_lin0/kernel": array}``."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out["/".join(path + (k,))] = np.asarray(v, dtype=np.float32)

    walk(tree["params"], ())
    return out


class Model:
    """The net's parameters (by Flax path, as tensors that take gradients)
    and BatchNorm running statistics, in ``dtype``."""

    def __init__(self, tree: dict, device, dtype=torch.float32):
        self.dtype = dtype
        self.params = {k: torch.tensor(v, device=device, dtype=torch.float32,
                                       requires_grad=True)
                       for k, v in leaves(tree).items()}
        stats = tree["batch_stats"]["emb_net"]
        self.stats = {k: {s: torch.tensor(np.asarray(v[s], np.float32), device=device)
                          for s in ("mean", "var")} for k, v in stats.items()}
        self.depth = sum(1 for k in self.params if k.startswith("emb_net/v_lins1_")
                         and k.endswith("kernel"))
        self.heads = sum(1 for k in self.params if k.startswith("par_net_heu/")
                         and k.endswith("kernel"))

    def p(self, name: str) -> torch.Tensor:
        return self.params[name].to(self.dtype)

    def dense(self, mod: str, x):
        return x @ self.p(f"{mod}/kernel") + self.p(f"{mod}/bias")

    def norm(self, mod: str, x, momentum: float = 0.1, eps: float = 1e-5):
        """Train-mode BatchNorm, each instance its own statistics over every
        axis but the first and the last (biased variance to normalise), the
        running statistics moved by each instance's (unbiased) and averaged."""
        axes = tuple(range(1, x.dim() - 1))
        count = math.prod(x.shape[1:-1])
        mean = x.mean(dim=axes, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
        with torch.no_grad():
            st = self.stats[mod.split("/")[-1]]
            flat = lambda t: t.reshape(x.shape[0], x.shape[-1]).float()
            unbiased = flat(var) * count / max(count - 1, 1)
            st["mean"] = torch.mean((1 - momentum) * st["mean"] + momentum * flat(mean), dim=0)
            st["var"] = torch.mean((1 - momentum) * st["var"] + momentum * unbiased, dim=0)
        name = mod.split("/")[-1]
        return (x - mean) * torch.rsqrt(var + eps) * self.p(f"emb_net/{name}/scale") \
            + self.p(f"emb_net/{name}/bias")

    def heuristic(self, coords: torch.Tensor, k: int, eps: float) -> torch.Tensor:
        """The train-mode heuristic ``[B, N, N]`` (f32; f64 in a model of
        f64) on the 50-NN graph."""
        dist = gnn.distance_matrix(coords)
        vals, nbr = gnn.knn(dist, k)
        x = gnn.node_features(coords, "start_onehot").to(self.dtype)
        v = F.silu(self.dense("emb_net/v_lin0", x))
        w = F.silu(self.dense("emb_net/e_lin0", vals[..., None].to(self.dtype)))
        for i in range(self.depth):
            x1, x2, x3, x4 = (self.dense(f"emb_net/v_lins{j}_{i}", v) for j in (1, 2, 3, 4))
            agg = torch.mean(torch.sigmoid(w) * gnn._gather_nodes(x2, nbr), dim=-2)
            pre = self.dense(f"emb_net/e_lins0_{i}", w) + x3[..., None, :] \
                + gnn._gather_nodes(x4, nbr)
            v = v + F.silu(self.norm(f"emb_net/v_bns_{i}", x1 + agg))
            w = w + F.silu(self.norm(f"emb_net/e_bns_{i}", pre))
        h = w
        for i in range(self.heads - 1):
            h = F.silu(self.dense(f"par_net_heu/lin_{i}", h))
        o = torch.sigmoid(self.dense(f"par_net_heu/lin_{self.heads - 1}", h))[..., 0]
        o = o.to(torch.promote_types(self.dtype, torch.float32))
        dense = torch.zeros(dist.shape, dtype=o.dtype, device=dist.device)
        return dense.scatter(-1, nbr, o) + eps


def log_probs(heu: torch.Tensor, paths: torch.Tensor, alpha: float, beta: float) -> torch.Tensor:
    """``[B, N-1, A]``: each step's log-probability of ``paths [B, N, A]``
    under the softmax of ``alpha*log(1) + beta*log(heu)`` over the
    unvisited cities (differentiable in ``heu``)."""
    b, n, a = paths.shape
    score = beta * torch.log(torch.clamp(heu, min=1e-30))
    cur = paths[:, 0]
    visited = torch.zeros((b, a, n), dtype=torch.bool, device=heu.device)
    visited.scatter_(-1, cur[..., None], True)
    out = []
    for t in range(1, n):
        rows = torch.gather(score, 1, cur[..., None].expand(b, a, n))
        lp = torch.log_softmax(rows.masked_fill(visited, float("-inf")), dim=-1)
        nxt = paths[:, t]
        out.append(lp.gather(-1, nxt[..., None])[..., 0])
        visited = visited.scatter(-1, nxt[..., None], True)
        cur = nxt
    return torch.stack(out, dim=1)


def lengths(dist: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Cyclic f32 lengths ``[B, A]`` of ``paths [B, N, A]``."""
    nxt = torch.roll(paths, -1, dims=1)
    idx = torch.arange(dist.shape[0], device=dist.device)[:, None, None]
    return dist[idx, paths, nxt].sum(dim=1)


def nls_lengths(coords: torch.Tensor, heu: torch.Tensor, paths: torch.Tensor, cfg: dict,
                dist_dtype=torch.float32, metric_dtype=torch.bfloat16) -> torch.Tensor:
    """The lengths ``[B, A]`` of the tours NLS makes of ``paths [B, N, A]``
    with the perturbation metric of ``heu``."""
    from acobench.reference.aco import rnd

    n = coords.shape[1]
    dist = gnn.distance_matrix(coords)
    ls = cfg["local_search"]
    with torch.no_grad():
        tours = nls.nls(rnd(dist, dist_dtype), rnd(nls.perturbation_metric(heu), metric_dtype),
                        paths.transpose(1, 2), max(n // 4, 1), ls["t_nls"], ls["t_p"])
    return lengths(dist, tours.transpose(1, 2))


def instances(gen_state: torch.Tensor, batch: int, n: int, device) -> torch.Tensor:
    """A step's ``[batch, n, 2]`` f32 instances, U(0,1)^2, drawn anew from
    the state its generator held before the step (the law of
    ``tsp/utils.py``: one ``torch.rand`` of the whole batch)."""
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    return torch.rand((batch, n, 2), generator=gen, device=device, dtype=torch.float32)


def objective(model: Model, coords: torch.Tensor, paths: torch.Tensor, ls: torch.Tensor,
              cfg: dict):
    """The loss of one step, its terms ``[B, A]`` and the heuristic."""
    tr, aco = cfg["train"], cfg["aco"]
    heu = model.heuristic(coords, cfg["k_sparse"], tr["eps"])
    lp = log_probs(heu, paths, aco["alpha"], aco["beta"])
    raw = lengths(gnn.distance_matrix(coords), paths)
    ls = ls.float()
    w = tr["nls_w"]
    adv = w * (ls - ls.mean(dim=-1, keepdim=True)) + (1 - w) * (raw - raw.mean(dim=-1, keepdim=True))
    terms = adv * lp.sum(dim=1) / aco["n_ants"]
    return terms.sum(dim=-1).mean(), terms, heu


def gradients(model: Model, loss: torch.Tensor) -> dict:
    """The loss's gradient by leaf; a parameter the loss does not reach (the
    last layer's node update) gets a zero gradient, and weight decay still
    moves it."""
    grads = torch.autograd.grad(loss, list(model.params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(model.params.items(), grads)}


def step(model: Model, opt: dict, coords: torch.Tensor, paths: torch.Tensor,
         ls: torch.Tensor, cfg: dict, count: int) -> dict:
    """One training step of ``model`` (updated in place) on the program's
    ``paths`` and LS lengths ``ls``; ``opt`` holds AdamW's moments. Returns
    the loss, its scale (``mean_b sum_a |adv sum_t log p| / A``, which the
    loss's gap is taken against), the clipped gradients and the heuristic."""
    tr = cfg["train"]
    loss, terms, heu = objective(model, coords, paths.long(), ls, cfg)
    grads = gradients(model, loss)
    with torch.no_grad():
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if norm >= tr["grad_clip"]:
            grads = {k: g / norm * tr["grad_clip"] for k, g in grads.items()}
        total = tr["epochs"] * tr["steps_per_epoch"]
        lr = tr["lr"] * 0.5 * (1 + math.cos(math.pi * min(count, total) / total))
        k = count + 1
        for name, p in model.params.items():
            g = grads[name]
            m, v = opt.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
            p.mul_(1 - lr * tr["weight_decay"])
            m = BETAS[0] * m + (1 - BETAS[0]) * g
            v = BETAS[1] * v + (1 - BETAS[1]) * g * g
            opt[name] = (m, v)
            denom = (v.sqrt() / math.sqrt(1 - BETAS[1] ** k)) + EPS
            p.sub_(lr / (1 - BETAS[0] ** k) * m / denom)
    return {"loss": float(loss.detach()), "scale": float(terms.detach().abs().sum(dim=-1).mean()),
            "grads": grads, "heu": heu.detach()}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(got: dict, want: dict, keep) -> list:
    """``|got - want| / max(want, median of want)`` for each of the leaves
    ``keep``: the gap between two norms, leaf by leaf."""
    med = float(np.median([want[k] for k in keep]))
    return [abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keep]


@torch.no_grad()
def _tours_ok(paths: torch.Tensor) -> int:
    """Tours of ``paths [B, N, A]`` that are no permutation from city 0."""
    n = paths.shape[1]
    ident = torch.arange(n, device=paths.device)[None, :, None]
    bad = ~(torch.sort(paths, dim=1).values == ident).all(dim=1) | (paths[:, 0] != 0)
    return int(bad.sum())


FLIP = 1e-5


def judge(captures: list, losses: list, first_moment: dict, after: dict, tree: dict,
          cfg: dict, device) -> tuple[int, dict]:
    """:func:`_judge` with torch's deterministic algorithms: the backward of
    a gather adds by atomics on the card otherwise, and two checks of one
    run would differ by round-off."""
    prior = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _judge(captures, losses, first_moment, after, tree, cfg, device)
    finally:
        torch.use_deterministic_algorithms(prior)


def _judge(captures: list, losses: list, first_moment: dict, after: dict, tree: dict,
           cfg: dict, device) -> tuple[int, dict]:
    """The numbers of a training cell's first steps: ``captures`` (each
    step's generator state ``gen_state`` before it drew its instances, the
    ``paths`` it sampled, its heuristic ``heu`` and its LS lengths ``ls``),
    the program's ``losses``, AdamW's first moments after the first step
    (``first_moment``, by Flax path) and the weights after the last
    (``after``, by Flax path, torch's layout) against the reference's steps
    from the same first weights ``tree`` on instances it draws itself from
    each ``gen_state``. Returns ``(failed steps, numbers)``:

    - ``heu_log_gap``: the first step's train-mode heuristic (both from the
      same weights), ``|log heu - log heu_ref|`` at its largest;
    - ``ls_gap``: the mean relative gap of the LS lengths to the reference's
      NLS of the same tours on the program's heuristic;
    - ``ls_flip_share``: the share of ants whose LS length parts (by more
      than ``FLIP`` relative) from the reference's NLS of the same tours on
      the reference's own heuristic, where a bf16 metric entry that the two
      heuristics round apart flips a move;
    - ``loss_gap``: each step's ``|loss - loss_ref|`` over the loss's scale;
    - ``grad_gap``: the first step's clipped gradient, leaf by leaf, its norm
      worked out from the first moment (``m / (1 - beta1)``);
    - ``change_gap``: each leaf's change over the steps, its norm, the gap
      of the worst leaf. Left out, by the first gradient as the reference
      takes it in f64: the leaves whose gradient's norm is under a
      thousandth of the median leaf's (it is nought: BatchNorm takes out
      what they add), and in each leaf the elements under a thousandth of
      its root mean square. AdamW moves such an element by about the rate
      in the sign of its f32 round-off, whatever the round-off's size;
    - ``invalid_tours``: sampled tours that are no permutation from city 0.
    """
    from acobench.reference.check import SENTINEL, finite

    names = ("heu_log_gap", "ls_gap", "ls_flip_share", "loss_gap", "grad_gap", "change_gap",
             "invalid_tours")
    if len(captures) < len(losses) or not captures:
        return 1, {k: SENTINEL for k in names}
    model = Model(tree, device)
    start = {k: v.detach().clone() for k, v in model.params.items()}
    opt = {}
    out = {"heu_log_gap": 0.0, "ls_gap": 0.0, "loss_gap": 0.0, "invalid_tours": 0.0}
    failed, flips, ants = 0, 0, 0
    for k, cap in enumerate(captures):
        paths = cap["paths"].to(device).long()
        b, n, _ = paths.shape
        coords = instances(cap["gen_state"], b, n, device)
        heu = cap["heu"].to(device).float()
        ls = cap["ls"].to(device)
        bad = _tours_ok(paths)
        out["invalid_tours"] += bad
        if bad:
            failed += 1
            out.update(ls_gap=SENTINEL, loss_gap=SENTINEL)
            continue
        want = nls_lengths(coords, heu, paths, cfg).double()
        gap = (ls.double() - want).abs() / want
        out["ls_gap"] = max(out["ls_gap"], finite(float(gap.mean())))
        if k == 0:
            exact = Model(tree, device, torch.float64)
            g64 = gradients(exact, objective(exact, coords, paths, ls, cfg)[0])
            del exact
        r = step(model, opt, coords, paths, ls, cfg, k)
        own = nls_lengths(coords, r["heu"], paths, cfg).double()
        flips += int(((ls.double() - own).abs() > FLIP * own).sum())
        ants += own.numel()
        if k == 0:
            out["heu_log_gap"] = finite(float(
                (torch.log(torch.clamp(heu, min=1e-30)) - torch.log(r["heu"])).abs().max()))
            g_ref = {name: _norm(g) for name, g in r["grads"].items()}
        out["loss_gap"] = max(out["loss_gap"], finite(abs(losses[k] - r["loss"]) / r["scale"]))
    out["ls_flip_share"] = flips / ants if ants else SENTINEL
    if failed:
        return failed, {**out, "grad_gap": SENTINEL, "change_gap": SENTINEL}
    g_prog = {name: _norm(first_moment[name] / (1 - BETAS[0])) for name in g_ref}
    out["grad_gap"] = finite(max(_leaf_gaps(g_prog, g_ref, list(g_ref))))
    n64 = {name: _norm(g) for name, g in g64.items()}
    med = float(np.median(list(n64.values())))
    keep = [name for name in g64 if n64[name] >= 1e-3 * med]
    elems = {name: g64[name].abs() >= 1e-3 * n64[name] / g64[name].numel() ** 0.5
             for name in keep}
    as_flax = lambda t: t.T if t.dim() == 2 else t
    d_ref = {name: _norm((model.params[name].detach() - start[name])[elems[name]])
             for name in keep}
    d_prog = {name: _norm((as_flax(after[name].to(device)) - start[name])[elems[name]])
              for name in keep}
    out["change_gap"] = finite(max(_leaf_gaps(d_prog, d_ref, keep)))
    return 0, out


def control_steps(tree: dict, cfg: dict, steps: int, seed: int, device) -> dict:
    """The reference put in the program's place one precision lower (the
    control): the net in bf16; ``steps`` steps, each on instances drawn as a
    program's step draws them (from a generator seeded with ``seed``), tours
    sampled from its heuristic (the score and the noise in bf16, every ant
    from city 0), NLS on bf16 distances with the metric in float8, then its
    update. Returns what :func:`judge` takes of the program."""
    from acobench.reference import aco

    tr = cfg["train"]
    model = Model(tree, device, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed)
    opt, captures, losses = {}, [], []
    for k in range(steps):
        state = gen.get_state()
        c = torch.rand((tr["batch"], cfg["n_nodes"], 2), generator=gen, device=device,
                       dtype=torch.float32)
        with torch.no_grad():
            heu = model.heuristic(c, cfg["k_sparse"], tr["eps"])
            sc = aco.score(torch.ones_like(heu), heu, cfg["aco"]["alpha"], cfg["aco"]["beta"],
                           torch.bfloat16)
            start = torch.zeros((c.shape[0], cfg["aco"]["n_ants"]), dtype=torch.int64,
                                device=device)
            paths = aco.sample(sc, start, gen, torch.bfloat16)
            ls = nls_lengths(c, heu, paths, cfg, torch.bfloat16, torch.float8_e4m3fn)
        r = step(model, opt, c, paths, ls, cfg, k)
        captures.append({"gen_state": state, "paths": paths, "heu": r["heu"], "ls": ls})
        losses.append(r["loss"])
        if k == 0:
            first = {n: opt[n][0].clone() for n in model.params}
    after = {n: (p.detach().T if p.dim() == 2 else p.detach()).clone()
             for n, p in model.params.items()}
    return {"captures": captures, "losses": losses, "first_moment": first, "after": after}
