"""Port parity: the TSPLIB converter (deepaco_tpu_torch/utils/convert.py:
parse_tsplib, normalize_coords, convert_file) against the JAX package's, on
tests/test_convert.py's instance and a few more TSPLIB forms: equal arrays,
and ``.npy`` files equal byte for byte."""
import numpy as np
import pytest

from deepaco_tpu.utils import convert as jconvert
from deepaco_tpu_torch.utils import convert

TSPLIB = """NAME : toy5
TYPE : TSP
DIMENSION : 5
EDGE_WEIGHT_TYPE : EUC_2D
NODE_COORD_SECTION
1 0.0 0.0
2 10.0 0.0
3 10.0 10.0
4 0.0 10.0
5 5.0 5.0
EOF
"""
# a Concorde-style file: lower-case section names, integer coordinates,
# a TOUR_SECTION after the coordinates, no EOF
CONCORDE = """name: c4
node_coord_section
1 12 7
2 3 40
3 25 25
4 -6 18
TOUR_SECTION
1 2 3 4
-1
"""
# the section ends at a blank line; what follows is not read
BLANK = "NODE_COORD_SECTION\n1 1.5 2.5\n2 0.25 4\n\n3 9 9\n"


@pytest.mark.parametrize("text", [TSPLIB, CONCORDE, BLANK], ids=["tsplib", "concorde", "blank"])
def test_parse_and_normalize_equal_jax(text):
    got, want = convert.parse_tsplib(text), jconvert.parse_tsplib(text)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    norm = convert.normalize_coords(got)
    assert norm.dtype == jconvert.normalize_coords(want).dtype
    np.testing.assert_array_equal(norm, jconvert.normalize_coords(want))
    assert norm.min() >= 0.0 and norm.max() <= 1.0 + 1e-7


def test_parse_tsplib_coords():
    coords = convert.parse_tsplib(TSPLIB)
    assert coords.shape == (5, 2)
    np.testing.assert_allclose(coords[4], [5.0, 5.0])
    np.testing.assert_allclose(convert.normalize_coords(coords)[2], [1.0, 1.0])
    assert convert.parse_tsplib(BLANK).shape == (2, 2)


def test_a_file_without_coordinates_raises_as_in_jax():
    for parse in (convert.parse_tsplib, jconvert.parse_tsplib):
        with pytest.raises(ValueError, match="NODE_COORD_SECTION"):
            parse("NAME : x\nEOF\n")


@pytest.mark.parametrize("normalize", [True, False])
def test_convert_file_writes_jax_npy_byte_for_byte(normalize, tmp_path):
    src = tmp_path / "toy.tsp"
    src.write_text(CONCORDE)
    got = convert.convert_file(str(src), str(tmp_path / "port.npy"), normalize=normalize)
    want = jconvert.convert_file(str(src), str(tmp_path / "jax.npy"), normalize=normalize)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), got)
    assert (tmp_path / "port.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
