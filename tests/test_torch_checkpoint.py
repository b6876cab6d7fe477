"""Port parity: the pure-Python msgpack reader against flax.serialization."""
from pathlib import Path

import numpy as np
import pytest

import jax
from flax import serialization

from deepaco_tpu_torch.utils import checkpoint

CKPT = Path(__file__).resolve().parent.parent / "checkpoints"


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _assert_bit_equal(got, ref):
    a, b = _leaves(ref), _leaves(got)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert x.tobytes() == y.tobytes(), path


@pytest.mark.parametrize("name", ["tsp100_selftrained", "tsp500_selftrained"])
def test_checkpoint_leaves_bit_equal_to_flax(name):
    data = (CKPT / f"{name}.msgpack").read_bytes()
    got = checkpoint.load_checkpoint(str(CKPT / f"{name}.msgpack"))
    _assert_bit_equal(got, serialization.msgpack_restore(data))
    assert set(got) == {"params", "batch_stats", "opt_state", "step"}
    assert len(got["params"]["emb_net"]) == 86
    assert "par_net_phe" in got["params"]


def test_decoder_covers_flax_types():
    """Every msgpack type that flax writes: small and large ints of both
    signs, floats, bools, None, str, numpy scalars and arrays of several
    dtypes, long maps and lists stored as maps."""
    tree = {
        "ints": {"a": 5, "b": -3, "c": 200, "d": -200, "e": 70000,
                 "f": -70000, "g": 2 ** 40, "h": -2 ** 40},
        "floats": {"x": 1.5, "y": -2.25e-30},
        "flags": {"t": True, "f": False, "none": None},
        "text": {"s": "x" * 40, "long": "y" * 300},
        "scalars": {"f32": np.float32(3.5), "i64": np.int64(-7)},
        "arrays": {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
                   "i32": np.array([1, -2, 3], np.int32),
                   "u8": np.arange(300, dtype=np.uint8),
                   "empty": np.zeros((0, 2), np.float32),
                   "scalar": np.array(4.0, np.float64)},
        "many": {str(i): i for i in range(20)},
        "tuple": (np.float32(1.0), 2),
    }
    data = serialization.to_bytes(tree)
    _assert_bit_equal(checkpoint.msgpack_restore(data),
                      serialization.msgpack_restore(data))


def test_decoder_rejects_truncated_data():
    data = (CKPT / "tsp100_selftrained.msgpack").read_bytes()
    with pytest.raises(ValueError):
        checkpoint.msgpack_restore(data[:-10])


# ---------------------------------------------------------------- writer ---
def _train_configs(cosine):
    from deepaco_tpu.train import config as jconfig
    from deepaco_tpu_torch.train import config

    return [mod.ProblemConfig(
        n_nodes=16, k_sparse=4, model=mod.ModelConfig(depth=2),
        aco=mod.ACOSettings(n_ants=4),
        train=mod.TrainConfig(epochs=1, steps_per_epoch=4, batch_size=2,
                              cosine_schedule=cosine)) for mod in (config, jconfig)]


def _port_state(cfg, steps, generator=None):
    """A dual-head depth-2 net trained ``steps`` steps on the CPU."""
    import torch

    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.train import reinforce as tr

    gen = generator or torch.Generator().manual_seed(0)
    state = tr.init_train_state(Net(depth=2, dual_heads=True), cfg, gen)
    step = tr.make_tsp_train_step(cfg)
    for _ in range(steps):
        state, _ = step(state, gen)
    return state, gen


def _structure(tree):
    return {jax.tree_util.keystr(p): (np.shape(v), np.asarray(v).dtype)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("cosine", [False, True])
def test_written_layout_is_the_jax_train_state(cosine, tmp_path):
    """The port's tree has the leaves, shapes and dtypes of
    ``to_state_dict`` of the JAX TrainState for the same config, empty
    optimizer states included; JAX's ``load_checkpoint`` restores the file
    the port wrote, every leaf bit for bit."""
    from deepaco_tpu.models.gnn import Net as JNet
    from deepaco_tpu.train.reinforce import init_train_state
    from deepaco_tpu.utils.checkpoint import load_checkpoint as jload

    cfg, jcfg = _train_configs(cosine)
    template = init_train_state(JNet(depth=2, dual_heads=True), jcfg,
                                jax.random.PRNGKey(0))
    state, _ = _port_state(cfg, 2)
    tree = state.tree()
    expected = serialization.to_state_dict(template)
    assert _structure(tree) == _structure(expected)
    assert tree["opt_state"]["0"] == {} and tree["opt_state"]["1"]["1"] == {}
    assert (tree["opt_state"]["1"]["2"] == {}) != cosine
    path = tmp_path / "port.msgpack"
    checkpoint.save_checkpoint(str(path), state)
    restored = serialization.to_state_dict(jload(str(path), template))
    _assert_bit_equal(restored, tree)
    assert int(restored["step"]) == 2


def test_port_restores_a_jax_checkpoint(tmp_path):
    """A JAX TrainState after one step, written by the JAX package, restores
    into the port: weights, statistics, Adam moments and counts bit for bit
    through the port's own tree."""
    import torch

    from deepaco_tpu.models.gnn import Net as JNet
    from deepaco_tpu.train.reinforce import init_train_state, make_tsp_train_step
    from deepaco_tpu.utils.checkpoint import save_checkpoint as jsave
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.train import reinforce as tr

    cfg, jcfg = _train_configs(True)
    jmodel = JNet(depth=2, dual_heads=True)
    jstate = init_train_state(jmodel, jcfg, jax.random.PRNGKey(0))
    jstate, _ = make_tsp_train_step(jmodel, jcfg)(jstate, jax.random.PRNGKey(1))
    path = tmp_path / "jax.msgpack"
    jsave(str(path), jstate)
    tree = checkpoint.load_checkpoint(str(path))
    state = tr.restore_train_state(tree, Net(depth=2, dual_heads=True), cfg)
    assert state.step == 1 and state.cosine
    _assert_bit_equal(state.tree(), serialization.to_state_dict(jstate))
    assert set(state.optimizer.state) == set(state.net.parameters())
    assert all(float(s["step"]) == 1.0 for s in state.optimizer.state.values())
    assert all(p.dtype == torch.float32 for p in state.net.parameters())


def test_resume_continues_bit_for_bit(tmp_path):
    """Three steps in one run equal two steps, a save, a restore into a
    fresh net and optimizer, and a third step (the generator carries on):
    every weight, statistic and moment bit for bit on the CPU."""
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.train import reinforce as tr

    cfg, _ = _train_configs(True)
    whole, _ = _port_state(cfg, 3)
    half, gen = _port_state(cfg, 2)
    path = tmp_path / "half.msgpack"
    checkpoint.save_checkpoint(str(path), half)
    resumed = tr.restore_train_state(checkpoint.load_checkpoint(str(path)),
                                     Net(depth=2, dual_heads=True), cfg)
    resumed, _ = tr.make_tsp_train_step(cfg)(resumed, gen)
    _assert_bit_equal(resumed.tree(), whole.tree())


def test_writer_refuses_what_flax_would_not_write_alike():
    with pytest.raises(TypeError):
        checkpoint.packb({"x": object()})
    data = checkpoint.packb({"a": [1, -40, 3.5, None, True, "s" * 300, b"\x00" * 70000],
                             "e": {}, "n": np.float32(2.5)})
    assert checkpoint.unpackb(data)["a"][:5] == [1, -40, 3.5, None, True]
