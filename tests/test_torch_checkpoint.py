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
