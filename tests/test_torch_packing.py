"""The port's host packing against the JAX package's: every integer and
float array the packers produce must be equal, array for array."""

import numpy as np
import pytest

from repro_torch.core import hflex as port_hflex
from repro_torch.core import sparse as port_sparse
from repro_torch.data import matrices as port_matrices

MATRICES = {
    "random": lambda: port_sparse.random_sparse(300, 500, 0.02, seed=1),
    "power_law": lambda: port_sparse.power_law_sparse(400, 400, 6, seed=2),
    "banded": lambda: port_sparse.banded_sparse(300, 300, 4, seed=3),
    "mesh": lambda: port_sparse.mesh_2d_sparse(17, seed=4),
}
REF_GENERATORS = {
    "random": ("random_sparse", (300, 500, 0.02), dict(seed=1)),
    "power_law": ("power_law_sparse", (400, 400, 6), dict(seed=2)),
    "banded": ("banded_sparse", (300, 300, 4), dict(seed=3)),
    "mesh": ("mesh_2d_sparse", (17,), dict(seed=4)),
}


@pytest.fixture
def ref():
    pytest.importorskip("jax")
    from repro.core import hflex, sparse

    return hflex, sparse


def _ref_matrix(ref_sparse, family):
    fn, args, kw = REF_GENERATORS[family]
    return getattr(ref_sparse, fn)(*args, **kw)


def _assert_same_coo(x, y):
    assert x.shape == y.shape
    for f in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


@pytest.mark.parametrize("family", sorted(MATRICES))
def test_generators_match(ref, family):
    _assert_same_coo(MATRICES[family](), _ref_matrix(ref[1], family))


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("family", sorted(MATRICES))
def test_pack_block_slabs_equal(ref, family, interleave, bucket):
    ref_hflex, ref_sparse = ref
    a = MATRICES[family]()
    kw = dict(tm=32, k0=64, chunk=8, interleave=interleave, bucket=bucket)
    got = port_hflex.pack_block_slabs(a, **kw)
    want = ref_hflex.pack_block_slabs(_ref_matrix(ref_sparse, family), **kw)
    for f in ("vals", "cols", "rows", "q", "nse"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert getattr(got, f).dtype == getattr(want, f).dtype
    for f in ("m", "k", "tm", "k0", "chunk", "nnz", "interleaved"):
        assert getattr(got, f) == getattr(want, f)


@pytest.mark.parametrize("mode", ["vectorized", "greedy"])
@pytest.mark.parametrize("family", sorted(MATRICES))
def test_pack_pe_streams_equal(ref, family, mode):
    ref_hflex, ref_sparse = ref
    from repro.core.partition import SextansParams as RefParams
    from repro_torch.core.partition import SextansParams

    a = MATRICES[family]()
    got = port_hflex.pack_pe_streams(a, SextansParams(K0=128, P=8), mode=mode)
    want = ref_hflex.pack_pe_streams(_ref_matrix(ref_sparse, family),
                                     RefParams(K0=128, P=8), mode=mode)
    assert got.total_cycles == want.total_cycles
    assert got.bubble_fraction == want.bubble_fraction
    assert len(got.streams) == len(want.streams)
    for s_got, s_want, q_got, q_want in zip(got.streams, want.streams,
                                            got.q, want.q):
        np.testing.assert_array_equal(s_got, s_want)
        np.testing.assert_array_equal(q_got, q_want)
    _assert_same_coo(port_hflex.unpack_pe_streams(got), a.sorted_column_major())


@pytest.mark.parametrize("geom", [(1, 1, 1, 1), (3, 5, 17, 9), (64, 7, 1000, 513),
                                  (938, 30, 3864, 512)])
def test_bucket_geometry_equal(ref, geom):
    assert port_hflex.bucket_geometry(*geom) == ref[0].bucket_geometry(*geom)


def test_encode_decode_a64_roundtrip_equal(ref):
    rng = np.random.default_rng(0)
    row = rng.integers(0, 1 << 18, 200).astype(np.int32)
    col = rng.integers(0, 1 << 14, 200).astype(np.int32)
    val = rng.standard_normal(200).astype(np.float32)
    words = port_hflex.encode_a64(row, col, val)
    np.testing.assert_array_equal(words, ref[0].encode_a64(row, col, val))
    for x, y in zip(port_hflex.decode_a64(words), (row, col, val)):
        np.testing.assert_array_equal(x, y)


def test_suite_small_matches(ref):
    from repro.data import matrices as ref_matrices

    got = port_matrices.suite("small")
    want = ref_matrices.suite("small")
    assert [e.name for e in got] == [e.name for e in want]
    for g, w in zip(got, want):
        assert g.family == w.family
        _assert_same_coo(g.matrix, w.matrix)
