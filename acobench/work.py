"""The yardstick's arithmetic: one NVIDIA H100's peaks and the least time of
a kernel's work.

Frozen copies of ``chip_smoke.py``'s work counts, so that a later change to
the program cannot move the yardstick. Each count is of the function's
inputs and outputs (and of the operations the function needs), so it stays
the same whatever implements the function.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit
# (chip_smoke.py:451-454)
HBM_BYTES_PER_S = 3.35e12          # device memory
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
TF32X3_OPS_PER_S = 495e12 / 3      # f32 products as three TF32 products


def bound(bytes_moved: float, ops: float, product_ops: float = 0.0) -> tuple[float, str]:
    """The least time in ms for the work, and what bounds it: its bytes at
    the memory rate, or its f32 operations, ``product_ops`` of them in
    matrix products that the tensor cores take in 3xTF32 and the rest at
    the f32 rate (chip_smoke.py:472-479)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S + product_ops / TF32X3_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k1_work(b: int, n: int, k: int, feats: int, layers: int, u: int):
    """K1 (the dense heuristic: k-NN, the EmbNet layers, the head, the
    scatter): bytes, f32 operations and tensor-core product operations
    (chip_smoke.py:3460-3465). Bytes: dist read and heu written, the node
    features read. Operations: each layer's node pass (2 U 4U a node) and
    one compare per candidate column for the top-K selection; products:
    each layer's per-edge 32x32 product and the head's two."""
    ops = layers * 2 * b * n * u * 4 * u + b * n * n
    products = layers * 2 * b * n * k * u * u + 4 * b * n * k * u * u
    nbytes = 4 * (2 * b * n * n + b * n * feats)
    return nbytes, ops, products


def k2_work(b: int, n: int, a: int):
    """K2 (one construction sweep, bf16 scores): bytes and f32 operations
    (chip_smoke.py:3500-3501): the score read once at 2 bytes, the starts
    and the tours at 4 bytes a city id; a select and a compare a column a
    step."""
    return 2 * b * n * n + 4 * b * a + 4 * b * n * a, 2 * b * a * (n - 1) * n


def k3_work(b: int, n: int, a: int, score_bytes: int):
    """K3 (costs, Ant System update, best state, next score): bytes and f32
    operations (chip_smoke.py:482-492): tau and log_heu read once, tau' and
    the score (``score_bytes`` an entry, 0 when none is written) written
    once, the B*A*N distances of the tours' edges, the tours at 4 bytes a
    city id, the costs, the best cost and tour read and written; the
    update's multiply and add, the score's clamp, log, multiply and add,
    and each edge's cost and two deposit adds."""
    nbytes = (4 * 3 + score_bytes) * b * n * n + 4 * b * a * n + 4 * b * n * a + 4 * b * a \
        + 2 * 4 * (b + b * n)
    return nbytes, 6 * b * n * n + 3 * b * a * n


def ls_work(n: int, b: int, a: int, scans: float, metric_bytes: int):
    """K4/K5 (2-opt, NLS) for ``scans`` scans of a tour (chip_smoke.py:1219-1229):
    each scan evaluates (n-1)(n-2)/2 pairs at 3 add/sub and a compare; the
    instance's distance matrix built once at 7 operations a distance.
    Bytes: the metric, the distance matrix, the coordinates, and the tours
    read and written at 4 bytes a city."""
    pairs = (n - 1) * (n - 2) / 2
    ops = 4 * pairs * scans + 7 * b * n * n
    return metric_bytes + 4 * b * n * n + 4 * b * n * 2 + 2 * 4 * b * a * n, ops


def k6_forward_work(b: int, r: int, n: int, k: int, u: int):
    """K6's forward (one GNN layer's edge pass) over ``b`` instances of ``r``
    rows (``n`` nodes): bytes, f32 operations and tensor-core product
    operations (chip_smoke.py:494-505): w and pre, x2 and x4 (``n`` rows),
    x3 and agg (``r`` rows), nbr, ew, eb; the edge product (2 U^2 an edge,
    3xTF32) and the gate, mean and sums (5 U an edge)."""
    edges = b * r * k
    return (4 * (2 * edges * u + 2 * b * n * u + 2 * b * r * u + edges + u * u + u),
            5 * edges * u, 2 * edges * u * u)


def k6_backward_work(b: int, n: int, k: int, u: int):
    """K6's backward (chip_smoke.py:508-517): w, d_pre, x2, d_agg, nbr and
    the reverse adjacency in; d_w, d_x2, d_x3, d_x4, d_ew, d_eb out;
    d_pre @ ew^T (2 U^2 an edge, 3xTF32), w^T d_pre (2 U^2 an edge, f32)
    and about 10 U an edge for the gate, sums and scatters."""
    edges = b * n * k
    return (4 * (3 * edges * u + 5 * b * n * u + 2 * edges + b * (n + 1) + 2 * u * u + 2 * u),
            2 * edges * u * u + 10 * edges * u, 2 * edges * u * u)


def rollout_work(b: int, n: int, a: int, t: int):
    """K7r's TSP rollout of ``t`` steps, traced (chip_smoke.py:837-883, the
    TSP kind): forward, the score read, each step's noise, the starts, the
    paths and log-probabilities written, a select, compare, exp and add for
    the logsumexp and an add and compare for the maximum a column a step;
    backward, score, g and paths read, d_score written, an exp, subtract,
    multiply and add a column a step. Returns ``(forward, backward)``."""
    score_bytes = 4 * b * n * n
    steps = b * a * t
    out_bytes = 8 * b * (t + 1) * a + 4 * b * t * a
    fwd = (score_bytes + 4 * steps * n + 8 * b * a + out_bytes, 6 * steps * n)
    bwd = (2 * score_bytes + 4 * b * t * a + 8 * b * (t + 1) * a, 4 * steps * n)
    return fwd, bwd


def least_ms(work) -> float:
    """The least time in ms of a ``(bytes, ops[, products])`` count."""
    return bound(*work)[0]
