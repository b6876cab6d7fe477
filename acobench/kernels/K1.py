"""K1's least time in a solve request: one launch over the batch."""
from acobench.work import k1_work, least_ms


def request_least_ms(s: dict) -> float:
    return least_ms(k1_work(s["B"], s["N"], s["K"], s["feats"], s["layers"], s["units"]))
