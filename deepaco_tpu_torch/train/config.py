"""Typed configuration layer (the port's own copy of
``deepaco_tpu/train/config.py``, same dataclasses and defaults).

Replaces the reference's scattered notebook constants + per-CLI argparse
(SURVEY §5 "Config / flag system": tsp/train.ipynb cell 0, tsp_nls/train.py:130-145)
with one dataclass tree: problem, model, aco, train, eval sections.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    depth: int = 12
    units: int = 32
    node_update: bool = True        # False for SOP/SMTWTP
    dual_heads: bool = False        # tsp/, rcpsp/
    pad_feats: int = 0              # rcpsp pads node feats


@dataclasses.dataclass(frozen=True)
class ACOSettings:
    n_ants: int = 20
    decay: float = 0.9
    alpha: float = 1.0
    beta: float = 1.0
    elitist: bool = False
    min_max: bool = False
    tau_min: float = 0.1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Reference envelopes: TSP 5 epochs x 128 steps x 1 instance, lr 3e-4
    (tsp/train.ipynb cells 5-9); NLS: 20-50 epochs x 20 steps x batch 20,
    lr 6e-4/1e-4 cosine, grad-clip 3.0 (tsp_nls/train.py:43,99,138-141)."""

    lr: float = 3e-4
    weight_decay: float = 1e-2      # torch AdamW default
    grad_clip: float = 3.0
    epochs: int = 5
    steps_per_epoch: int = 128
    batch_size: int = 1
    cosine_schedule: bool = False
    eps: float = 1e-10              # heuristic offset (train.ipynb cell 1)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Anytime protocol: best-so-far at cumulative T (BASELINE.md)."""

    t_values: tuple[int, ...] = (1, 10, 20, 30, 40, 50, 100)
    n_ants: int = 20


@dataclasses.dataclass(frozen=True)
class ProblemConfig:
    name: str = "tsp"
    n_nodes: int = 100
    k_sparse: int = 20
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    aco: ACOSettings = dataclasses.field(default_factory=ACOSettings)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
