"""K3's least time in a solve request: an update an iteration, each but
the last writing the next bf16 score."""
from acobench.work import k3_work, least_ms


def request_least_ms(s: dict) -> float:
    b, n, a, t = s["B"], s["N"], s["A"], s["T"]
    return (t - 1) * least_ms(k3_work(b, n, a, 2)) + least_ms(k3_work(b, n, a, 0))
