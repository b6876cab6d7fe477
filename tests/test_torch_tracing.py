"""The program's tracer (``utils/metrics``) on the CPU: spans and counters are
recorded exactly while a ``torch.profiler`` records, the solve request and
the TSP-NLS training step record the span tree their docstrings name, the
profiler's ``deepaco.*`` ranges nest as the tracer's records do, and the
plain NLS reports K5's counters from its own scan counts."""
from collections import Counter

import pytest
import torch

from deepaco_tpu_torch.aco.runner import ACOConfig
from deepaco_tpu_torch.eval.anytime import evaluate_tsp
from deepaco_tpu_torch.models.gnn import Net
from deepaco_tpu_torch.ops import two_opt
from deepaco_tpu_torch.train import config
from deepaco_tpu_torch.train import reinforce as tr
from deepaco_tpu_torch.utils import metrics
from deepaco_tpu_torch.utils.datasets import uniform_coords


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for torch while this module runs: the tier-1
    command runs six pytest workers at once, and an OpenMP pool as wide as
    the host in each of them oversubscribes its cores many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fresh_tracer():
    metrics.reset()
    yield
    metrics.reset()


N, K, A = 20, 5, 4
SOLVE_TREE = {"request": None, "request.prologue": "request", "heuristic": "request",
              "heuristic.distance": "heuristic", "heuristic.prepare": "heuristic",
              "heuristic.k1": "heuristic", "construction": "request",
              "update": "request", "request.epilogue": "request"}
STEP_TREE = {"step": None, "step.data": "step", "heuristic": "step",
             "heuristic.graph": "heuristic", "heuristic.net": "heuristic",
             "heuristic.scatter": "heuristic", "rollout": "step", "local_search": "step",
             "loss": "step", "backward": "step", "optimizer": "step",
             "optimizer.clip": "optimizer", "optimizer.adamw": "optimizer"}


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _solve(seed=0, ls=None):
    coords = torch.rand(2, N, 2, generator=torch.Generator().manual_seed(seed))
    net = Net(feats=1 if ls else 2, depth=2)
    return evaluate_tsp(coords, net=net, k_sparse=K, cfg=ACOConfig(n_ants=A),
                        t_values=(2,), seed=seed, ls=ls, device="cpu")


def _train_step():
    cfg = config.ProblemConfig(
        n_nodes=N, k_sparse=K, model=config.ModelConfig(depth=2),
        aco=config.ACOSettings(n_ants=A),
        train=config.TrainConfig(epochs=1, steps_per_epoch=2, batch_size=2))
    gen = torch.Generator().manual_seed(0)
    state = tr.init_train_state(Net(feats=1, depth=2, dual_heads=False), cfg, gen)
    step = tr.make_tsp_train_step(cfg, local_search=tr.nls_local_search(2, 5))
    return step(state, gen)


def _parent_names():
    spans = metrics.TRACER.spans
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None) for s in spans]


def _profiler_tree(prof):
    """``(range, enclosing deepaco range)`` of every ``deepaco.*`` range of
    the profile, by the profiler's own parents."""
    out = []
    for ev in prof.events():
        if not ev.name.startswith("deepaco."):
            continue
        up = ev.cpu_parent
        while up is not None and not up.name.startswith("deepaco."):
            up = up.cpu_parent
        out.append((ev.name[len("deepaco."):],
                    None if up is None else up.name[len("deepaco."):]))
    return out


def _assert_self_times(report, tree):
    """A span's self time is its own less its children's, which follow one
    another inside it."""
    for name, tot in report.items():
        kids = [k for k, parent in tree.items() if parent == name]
        if not kids:
            assert tot["self_host_ms"] == pytest.approx(tot["host_ms"], rel=1e-9)
            continue
        inner = sum(report[k]["host_ms"] for k in kids if k in report)
        assert tot["self_host_ms"] == pytest.approx(tot["host_ms"] - inner,
                                                    rel=1e-6, abs=1e-6)
        assert 0 <= tot["self_host_ms"] < tot["host_ms"]


def test_phase_records_nothing_without_a_profiler():
    entered = []

    def hook(name):
        entered.append(name)
        return metrics.phase("never recorded")

    assert not metrics.tracing()
    with metrics.phase("heuristic", hook):
        pass
    _solve(ls="nls")
    _train_step()
    assert entered == ["heuristic"]
    assert metrics.TRACER.spans == [] and metrics.report() == {}
    assert metrics.counter_buffer("nls", two_opt.NLS_COUNTERS, "cpu") is None


def test_phase_enters_the_hook_while_tracing():
    entered = []

    def hook(name):
        entered.append(name)
        return metrics.phase(f"{name}.hooked")

    with _profiled():
        assert metrics.tracing()
        with metrics.phase("update", hook):
            pass
    assert not metrics.tracing()
    assert entered == ["update"]
    assert _parent_names() == [("update", None), ("update.hooked", None)]


def test_solve_records_its_span_tree_one_id_a_request():
    with _profiled() as prof:
        _solve(seed=1)
        _solve(seed=2)
    spans = metrics.TRACER.spans
    assert Counter(s.name for s in spans) == Counter(
        {**{n: 2 for n in SOLVE_TREE}, "construction": 6, "update": 4})
    assert all(parent == SOLVE_TREE[name] for name, parent in _parent_names())
    roots = [i for i, s in enumerate(spans) if s.name == "request"]
    assert [spans[i].rid for i in roots] == [1, 2]
    for i, s in enumerate(spans):
        assert s.rid == (1 if i < roots[1] else 2)
    assert Counter(_profiler_tree(prof)) == Counter(_parent_names())
    rep = metrics.report()
    assert list(rep) == list(SOLVE_TREE)
    assert rep["request"]["count"] == 2 and rep["construction"]["count"] == 6
    _assert_self_times(rep, SOLVE_TREE)
    assert metrics.report() is rep


def test_train_step_records_its_span_tree():
    with _profiled() as prof:
        _train_step()
    assert Counter(n for n, _ in _parent_names()) == Counter(STEP_TREE.keys())
    assert all(parent == STEP_TREE[name] for name, parent in _parent_names())
    assert {s.rid for s in metrics.TRACER.spans} == {1}
    assert Counter(_profiler_tree(prof)) == Counter(_parent_names())
    rep = metrics.report()
    _assert_self_times(rep, STEP_TREE)
    counters = rep["local_search"]["counters"]
    assert counters["nls.calls"] == 1 and counters["nls.tours"] == 2 * A
    assert counters["nls.euclid_scans"] >= 3 * 2 * A
    metrics.reset()
    assert metrics.report() == {} and metrics.TRACER.spans == []


@pytest.mark.parametrize("t_nls, t_p", [(0, 5), (3, 5)])
def test_plain_nls_counters_equal_its_scans(t_nls, t_p):
    b, n, a = 2, 30, 3
    gen = torch.Generator().manual_seed(5)
    coords = uniform_coords(n, gen, batch=b)
    hd = torch.rand(b, n, n, generator=gen) + 0.01
    tours = torch.stack([torch.stack([torch.randperm(n, generator=gen) for _ in range(a)])
                         for _ in range(b)])
    scans = {}
    want = two_opt.batched_nls_euclid_plain(coords, hd, tours, 100, t_nls, t_p, scans=scans)
    with _profiled():
        with metrics.phase("local_search"):
            got = two_opt.batched_nls_euclid(coords, hd, tours, 100, t_nls, t_p)
    assert torch.equal(got, want)
    counters = metrics.report()["local_search"]["counters"]
    assert counters == {"nls.calls": 1, "nls.instances": b, "nls.tours": b * a, "nls.n": n,
                        "nls.euclid_scans": scans["true"],
                        "nls.metric_scans": scans.get("perturb", 0),
                        "nls.moves": scans["moves"]}
    assert scans["true"] >= b * a * (1 + t_nls) and scans["moves"] > 0
    assert scans.get("perturb", 0) <= b * a * t_nls * t_p


def test_dense_descent_past_the_cap_reports_the_counters(monkeypatch):
    """Above K5's cap the wrapper takes the dense descent on the unrounded
    metric, and reports the same counters from its scans."""
    b, n, a = 1, 24, 3
    monkeypatch.setitem(two_opt.LS_CAPS, "nls", n - 1)
    gen = torch.Generator().manual_seed(7)
    coords = uniform_coords(n, gen, batch=b)
    hd = torch.rand(b, n, n, generator=gen) + 0.01
    tours = torch.stack([torch.randperm(n, generator=gen) for _ in range(a)])[None]
    scans = {}
    want = two_opt.batched_nls(two_opt.distance_matrix(coords), hd, tours, 100, 2, 5,
                               scans=scans)
    with _profiled():
        with metrics.phase("local_search"):
            got = two_opt.batched_nls_euclid(coords, hd, tours, 100, 2, 5)
    assert torch.equal(got, want)
    assert metrics.report()["local_search"]["counters"] == {
        "nls.calls": 1, "nls.instances": b, "nls.tours": b * a, "nls.n": n,
        "nls.euclid_scans": scans["true"], "nls.metric_scans": scans.get("perturb", 0),
        "nls.moves": scans["moves"]}
