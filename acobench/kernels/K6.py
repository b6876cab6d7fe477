"""K6's least time in a training step: each GNN layer's forward and
backward, ``layers`` of each, over B instances of N nodes, K edges a node."""
from acobench.work import k6_backward_work, k6_forward_work, least_ms


def step_least_ms(s: dict) -> float:
    b, n, k, u = s["B"], s["N"], s["K"], s["units"]
    return s["layers"] * (least_ms(k6_forward_work(b, n, n, k, u))
                          + least_ms(k6_backward_work(b, n, k, u)))
