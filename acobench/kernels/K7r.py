"""K7r's least time in a training step: the TSP rollout of every ant
through all N-1 steps with its log-probabilities, forward and backward."""
from acobench.work import least_ms, rollout_work


def step_least_ms(s: dict) -> float:
    fwd, bwd = rollout_work(s["B"], s["N"], s["A"], s["N"] - 1)
    return least_ms(fwd) + least_ms(bwd)
