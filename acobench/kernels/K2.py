"""K2's least time in a solve request: one sweep an iteration."""
from acobench.work import k2_work, least_ms


def request_least_ms(s: dict) -> float:
    return s["T"] * least_ms(k2_work(s["B"], s["N"], s["A"]))
