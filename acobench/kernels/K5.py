"""K5's least time in a solve request (an NLS call an iteration) and in a
training step (one call), over every ant's tour. The scans a descent takes depend on the tours, and the program
does not count them; so this counts the fewest the function can take, one
scan for each of the 1 + 2 t_nls descents of a tour, a lower bound."""
from acobench.work import least_ms, ls_work


def call_least_ms(s: dict) -> float:
    b, n, a = s["B"], s["N"], s["A"]
    scans = b * a * (1 + 2 * s["ls"]["t_nls"])
    return least_ms(ls_work(n, b, a, scans, 2 * b * n * n))


def request_least_ms(s: dict) -> float:
    return s["T"] * call_least_ms(s)


def step_least_ms(s: dict) -> float:
    return call_least_ms(s)
