"""Instance converters (the port's own copy of
``deepaco_tpu/utils/convert.py``): the TSPLIB/Concorde coordinate reader
:func:`parse_tsplib`, :func:`normalize_coords` and :func:`convert_file`
(convert.py:12-31, 85-98), which write a ``.npy`` of coordinates, and the
CVRPLib reader :func:`parse_cvrplib` (convert.py:33-82)."""
from __future__ import annotations

import numpy as np


def parse_tsplib(text: str) -> np.ndarray:
    """A TSPLIB/Concorde file's ``NODE_COORD_SECTION`` → ``[n, 2]`` f32
    coordinates, read up to ``EOF``, a blank line or a ``TOUR`` section;
    ``ValueError`` when the file has none."""
    coords = []
    in_section = False
    for line in text.splitlines():
        token = line.strip()
        if token.upper().startswith("NODE_COORD_SECTION"):
            in_section = True
            continue
        if not in_section:
            continue
        if token.upper() in ("EOF", "") or token.upper().startswith("TOUR"):
            break
        parts = token.split()
        coords.append([float(parts[1]), float(parts[2])])
    if not coords:
        raise ValueError("no NODE_COORD_SECTION found")
    return np.asarray(coords, np.float32)


def normalize_coords(coords: np.ndarray) -> np.ndarray:
    """Shift to the origin and scale by the larger span into the unit
    square (the training distribution)."""
    lo = coords.min(axis=0)
    span = coords.max(axis=0) - lo
    return (coords - lo) / max(float(span.max()), 1e-9)


def convert_file(path: str, out_path: str, normalize: bool = True) -> np.ndarray:
    """Read the TSPLIB file ``path``, normalise it unless told not to, save
    the coordinates with ``np.save`` to ``out_path`` and return them."""
    with open(path) as f:
        coords = parse_tsplib(f.read())
    if normalize:
        coords = normalize_coords(coords)
    np.save(out_path, coords)
    return coords


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
