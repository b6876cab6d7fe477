"""The check on the CPU at a tiny size: a sound run is correct; a run with
the timed path broken underneath is not, for each fault a solve cell can
have; the control (the reference one precision lower) is not."""
from __future__ import annotations

import pytest
import torch

from acobench_tiny import SEED, run_tiny, tiny_spec

CELLS = ["tsp500.solve-t10", "tsp500_nls.solve-t10"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"instances_per_s", "solve_p95_ms", "setup_s"} <= set(out["metrics"])
    assert list(out)[-1] == "checks"


def _state_unchanged(ops):
    def update(state, *args, **kwargs):
        _, costs, score = ops.update(state, *args, **kwargs)
        return state, costs, score
    return ops._replace(update=update)


def _answer_altered(ops):
    def sweep(*args, **kwargs):
        paths = ops.sweep(*args, **kwargs).clone()
        paths[:, 1] = paths[:, 2]           # every tour visits one city twice
        return paths
    return ops._replace(sweep=sweep)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from deepaco_tpu_torch.aco import batched_tsp
    from deepaco_tpu_torch.eval import anytime

    if fault == "half_batch":
        whole = anytime.evaluate_tsp

        def half(coords, **kwargs):
            return whole(coords[: len(coords) // 2], **kwargs)
        monkeypatch.setattr(anytime, "evaluate_tsp", half)
    else:
        broken = {"state_unchanged": _state_unchanged,
                  "answer_altered": _answer_altered}[fault](batched_tsp.KERNEL_OPS)
        monkeypatch.setattr(batched_tsp, "KERNEL_OPS", broken)
    out = run_tiny(cell)
    assert not out["correct"], out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("precision", ["lower", "stated"])
def test_control_is_not_correct_and_the_reference_is(cell, precision):
    """The reference one precision lower fails the check; at the stated
    precisions, put in the program's place, it passes."""
    from acobench.control import judge_control

    torch.set_num_threads(2)
    got = judge_control(tiny_spec(cell), SEED, precision, "cpu")
    assert got["correct"] == (precision == "stated"), got


TRAIN = "tsp500_nls.train-b20"


def test_sound_training_run_is_correct():
    out = run_tiny(TRAIN)
    assert out["correct"], out["checks"]
    assert {"train_step_ms", "setup_s"} <= set(out["metrics"])


def plant_training_fault(fault: str, monkeypatch) -> None:
    """Break the program's training step underneath the harness: AdamW's
    update skipped (the state returned unchanged), the loss averaged over
    half of the batch, or every sampled tour altered where it is produced."""
    from deepaco_tpu_torch.train import reinforce

    if fault == "state_unchanged":
        def frozen(state, cfg):
            grads = [p.grad for p in state.net.parameters() if p.grad is not None]
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            state.optimizer.zero_grad(set_to_none=True)
            return state._replace(step=state.step + 1), norm
        monkeypatch.setattr(reinforce, "optimizer_update", frozen)
    elif fault == "half_batch":
        whole = reinforce.reinforce_loss

        def half(*args, **kwargs):
            per_instance = whole(*args, **kwargs)
            return per_instance[: len(per_instance) // 2]
        monkeypatch.setattr(reinforce, "reinforce_loss", half)
    else:
        sample = reinforce.rollout

        def altered(*args, **kwargs):
            # every ant's second and third cities swapped after sampling: still
            # tours (the kernels refuse others), no longer the sampled ones
            ro = sample(*args, **kwargs)
            return ro._replace(paths=ro.paths[:, [0, 2, 1, *range(3, ro.paths.shape[1])]])
        monkeypatch.setattr(reinforce, "rollout", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_broken_training_step_is_not_correct(fault, monkeypatch):
    plant_training_fault(fault, monkeypatch)
    out = run_tiny(TRAIN)
    assert not out["correct"], out


def test_training_control_is_not_correct():
    from acobench.control import judge_control

    torch.set_num_threads(2)
    assert not judge_control(tiny_spec(TRAIN), SEED, "lower", "cpu")["correct"]
