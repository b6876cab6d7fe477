"""CVRPLib instance reader (the port's own copy of
``deepaco_tpu/utils/convert.py:33-82``, ``parse_cvrplib``)."""
from __future__ import annotations

import numpy as np


def parse_cvrplib(text: str) -> dict:
    """Read a CVRPLib ``.vrp`` file → ``{coords [n, 2] f64, demands [n]
    f64, capacity}`` with the depot first (the reader of the reference's
    HGS-CVRP-main/Program/InstanceCVRPLIB.cpp): node ids are remapped so
    that the DEPOT_SECTION node sits at index 0, the others follow in
    increasing id order, and a node without a demand line gets 0."""
    capacity = None
    coords: dict[int, list[float]] = {}
    demands: dict[int, float] = {}
    depot = 1
    section = None
    for line in text.splitlines():
        token = line.strip()
        if not token:
            continue
        upper = token.upper()
        if upper.startswith("CAPACITY"):
            capacity = float(token.split(":")[-1])
            continue
        if upper.startswith("NODE_COORD_SECTION"):
            section = "coord"
            continue
        if upper.startswith("DEMAND_SECTION"):
            section = "demand"
            continue
        if upper.startswith("DEPOT_SECTION"):
            section = "depot"
            continue
        if upper.startswith("EOF") or ":" in token and section is None:
            continue
        parts = token.split()
        if section == "coord" and len(parts) >= 3:
            coords[int(parts[0])] = [float(parts[1]), float(parts[2])]
        elif section == "demand" and len(parts) >= 2:
            demands[int(parts[0])] = float(parts[1])
        elif section == "depot":
            v = int(parts[0])
            if v >= 0:
                depot = v
            section = None
    if capacity is None or not coords:
        raise ValueError("not a CVRPLib instance (CAPACITY/NODE_COORD missing)")
    order = [depot] + sorted(k for k in coords if k != depot)
    return {"coords": np.asarray([coords[i] for i in order], np.float64),
            "demands": np.asarray([demands.get(i, 0.0) for i in order], np.float64),
            "capacity": capacity}
