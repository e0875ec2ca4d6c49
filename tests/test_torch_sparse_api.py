"""The port's sparse front-end end to end against the JAX package's.

The same matrices and dense operands, made from a numpy seed, go through
``repro.sparse_api`` (``from_sparse_matrix`` + ``spmm``) and through
``repro_torch.sparse_api`` with ``device="cpu"``, backend for backend:
``pallas`` <-> ``cuda``, ``jnp`` <-> ``torch``, ``spmv`` <-> ``spmv``.
Float results agree within ``rtol=2e-4``, ``atol=2e-4*max(1, max|ref|)``;
packed arrays and routing decisions are equal.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import repro_torch.sparse_api as tsp
from repro_torch.core import sparse as tsparse
from repro_torch.kernels import sextans_spmm as kspmm
from repro_torch.kernels import spmv_vector as kspmv
from repro_torch.sparse_api.backends import _default_auto_policy

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKEND_PAIRS = [("pallas", "cuda"), ("jnp", "torch"), ("spmv", "spmv")]
PORT_NAME = {"pallas": "cuda", "spmv": "spmv", "jnp": "torch",
             "spmv_jnp": "spmv_torch"}
PLATFORM = {"tpu": "cuda", "cpu": "cpu"}
FAMILIES = {
    "random": (tsparse.random_sparse, (150, 260, 0.04)),
    "power_law": (tsparse.power_law_sparse, (300, 500, 6)),
    "banded": (tsparse.banded_sparse, (200, 200, 5)),
}
PACK = dict(tm=64, k0=64, chunk=8)


@pytest.fixture
def ref_sp():
    """The reference front-end, kept on the CPU: on a GPU machine JAX would
    run its f32 matmuls in TF32."""
    jax = pytest.importorskip("jax")
    import repro.sparse_api as sp

    with jax.default_device(jax.devices("cpu")[0]):
        yield sp


def _assert_close(got, want, tol=2e-4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _dense(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ref_opts(ref_name):
    return dict(tn=32) if ref_name == "pallas" else {}


def _port_opts(port_name):
    return dict(tn=32) if port_name == "cuda" else {}


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (0.5, 2.0)])
@pytest.mark.parametrize("ref_name,port_name", BACKEND_PAIRS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_spmm_matches_reference(ref_sp, family, ref_name, port_name, alpha,
                                beta, interleave):
    gen, args = FAMILIES[family]
    a = gen(*args, seed=5)
    m, k = a.shape
    rng = np.random.default_rng(1)
    n = 5 if ref_name == "spmv" else 20
    b, c = _dense(rng, (k, n)), _dense(rng, (m, n))
    ref_a = ref_sp.from_sparse_matrix(a, interleave=interleave, **PACK)
    want = ref_sp.spmm(ref_a, b, c, alpha, beta, backend=ref_name,
                       **_ref_opts(ref_name))
    A = tsp.from_sparse_matrix(a, interleave=interleave, device="cpu", **PACK)
    got = tsp.spmm(A, b, c, alpha, beta, backend=port_name,
                   **_port_opts(port_name))
    assert got.device.type == "cpu" and got.dtype == torch.float32
    _assert_close(got, want)
    _assert_close(got, tsparse.spmm_reference(a, b, c, alpha, beta))


@pytest.mark.parametrize("ref_name,port_name", BACKEND_PAIRS)
def test_spmm_bf16_b_matches_reference(ref_sp, ref_name, port_name):
    import jax.numpy as jnp

    a = tsparse.power_law_sparse(300, 500, 6, seed=2)
    rng = np.random.default_rng(2)
    n = 8 if ref_name == "spmv" else 16
    b32 = np.asarray(torch.from_numpy(_dense(rng, (500, n)))
                     .to(torch.bfloat16).float())
    want = ref_sp.spmm(ref_sp.from_sparse_matrix(a, **PACK),
                       jnp.asarray(b32, jnp.bfloat16), backend=ref_name,
                       **_ref_opts(ref_name))
    got = tsp.spmm(tsp.from_sparse_matrix(a, device="cpu", **PACK),
                   torch.from_numpy(b32).to(torch.bfloat16), backend=port_name,
                   **_port_opts(port_name))
    assert got.dtype == torch.bfloat16
    _assert_close(got.float(), np.asarray(want, np.float32), tol=5e-2)


def test_spmm_on_suite_matrix_matches_reference(ref_sp):
    """A matrix of the benchmark suite at its default packing geometry."""
    from repro_torch.data.matrices import suite

    entry = next(e for e in suite("small") if e.name == "ss_band_24696")
    a = entry.matrix
    rng = np.random.default_rng(3)
    b, c = _dense(rng, (a.shape[1], 64)), _dense(rng, (a.shape[0], 64))
    want = ref_sp.spmm(ref_sp.from_sparse_matrix(a), b, c, 1.0, 0.5,
                       backend="jnp")
    for be in ("cuda", "torch"):
        got = tsp.spmm(tsp.from_sparse_matrix(a, device="cpu"), b, c, 1.0,
                       0.5, backend=be)
        _assert_close(got, want)


@pytest.mark.parametrize("bucket", [False, True])
@pytest.mark.parametrize("interleave", [False, True])
def test_from_reference_arrays_roundtrip(ref_sp, interleave, bucket):
    a = tsparse.power_law_sparse(300, 500, 6, seed=7)
    kw = dict(interleave=interleave, bucket=bucket, **PACK)
    ref_t = ref_sp.from_sparse_matrix(a, device=False, **kw)
    d = ref_t.data
    arrays = {f: getattr(d, f) for f in ("vals", "cols", "rows", "q", "nse")}
    t = tsp.from_reference_arrays(
        arrays, m=d.m, k=d.k, tm=d.tm, k0=d.k0, chunk=d.chunk,
        interleaved=d.interleaved, nnz=d.nnz, device="cpu")
    own = tsp.from_sparse_matrix(a, device="cpu", **kw)
    for f, x in arrays.items():
        np.testing.assert_array_equal(getattr(t.data, f).numpy(), x)
        np.testing.assert_array_equal(getattr(own.data, f).numpy(), x)
    assert t.geometry == own.geometry == ref_t.geometry
    assert (t.shape, t.nnz, t.density) == (ref_t.shape, ref_t.nnz,
                                           ref_t.density)
    np.testing.assert_array_equal(t.todense().numpy(),
                                  np.asarray(ref_t.to_device().todense()))
    b = _dense(np.random.default_rng(0), (500, 12))
    _assert_close(t @ b, ref_sp.spmm(ref_t.to_device(), b, backend="jnp"))


def test_from_reference_arrays_rejects_bad_arrays(ref_sp):
    d = ref_sp.from_sparse_matrix(tsparse.random_sparse(100, 100, 0.05),
                                  device=False, **PACK).data
    arrays = {f: getattr(d, f) for f in ("vals", "cols", "rows", "q", "nse")}
    kw = dict(m=d.m, k=d.k, tm=d.tm, k0=d.k0, chunk=d.chunk,
              interleaved=d.interleaved, nnz=d.nnz, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        tsp.from_reference_arrays({"vals": arrays["vals"]}, **kw)
    with pytest.raises(TypeError):
        tsp.from_reference_arrays({**arrays, "q": arrays["q"].astype(np.int64)},
                                  **kw)
    with pytest.raises(ValueError):
        tsp.from_reference_arrays(arrays, **{**kw, "tm": 32})


def _policy_tensors(ref_sp, density):
    rng = np.random.default_rng(4)
    dense = np.where(rng.random((64, 64)) < density,
                     rng.standard_normal((64, 64)), 0).astype(np.float32)
    return (ref_sp.from_dense(dense, tm=32, k0=32, device=False),
            tsp.from_dense(dense, tm=32, k0=32, device="cpu"))


@pytest.mark.parametrize("n", [1, 4, 8, 9, 64])
@pytest.mark.parametrize("density", [0.05, 0.5])
@pytest.mark.parametrize("platform", ["tpu", "cpu"])
def test_auto_policy_table_matches_reference(ref_sp, platform, density, n):
    from repro.sparse_api.backends import _default_auto_policy as ref_policy

    ref_a, a = _policy_tensors(ref_sp, density)
    want = ref_policy(ref_a, np.zeros((64, n), np.float32), platform)
    got = _default_auto_policy(a, torch.zeros(64, n), PLATFORM[platform])
    assert got == PORT_NAME[want]


@pytest.mark.parametrize("env", ["0", "16", "junk"])
def test_skinny_threshold_env_matches_reference(ref_sp, monkeypatch, env):
    from repro.sparse_api.backends import skinny_n_max as ref_skinny

    monkeypatch.setenv("SEXTANS_SKINNY_N_MAX", env)
    assert tsp.skinny_n_max() == ref_skinny()
    _, a = _policy_tensors(ref_sp, 0.05)
    got = tsp.resolve_backend("auto", a, n=12, platform="cuda")
    assert got == ("spmv" if env == "16" else "cuda")


def test_auto_resolves_by_the_tensors_device():
    a = tsp.from_dense(np.eye(40, dtype=np.float32), tm=32, k0=32,
                       device="cpu")
    assert tsp.resolve_backend("auto", a, torch.zeros(40, 64)) == "torch"
    assert tsp.resolve_backend("auto", a, n=4) == "spmv_torch"
    assert sorted(tsp.list_backends()) == ["cuda", "spmv", "spmv_torch",
                                           "torch"]


def _small():
    a = tsparse.random_sparse(40, 30, 0.1, seed=3)
    return a, tsp.from_sparse_matrix(a, device="cpu", tm=16, k0=16)


def test_error_paths():
    _, A = _small()
    b = np.ones((30, 4), np.float32)
    with pytest.raises(KeyError, match="unknown backend"):
        tsp.spmm(A, b, backend="nope")
    with pytest.raises(ValueError, match="B rows"):
        tsp.spmm(A, np.ones((29, 4), np.float32))
    with pytest.raises(ValueError, match="2-D"):
        tsp.spmm(A, np.ones((2, 30, 4), np.float32))
    with pytest.raises(ValueError, match="c must have shape"):
        tsp.spmm(A, b, np.ones((40, 5), np.float32))
    with pytest.raises(ValueError, match="vector alpha"):
        tsp.spmm(A, b, alpha=np.ones(2, np.float32))
    with pytest.raises(ValueError, match="vector beta"):
        tsp.spmm(A, b, beta=torch.ones(3))
    with pytest.raises(TypeError):
        tsp.spmm(np.eye(3), b)
    with pytest.raises(ValueError, match="reserved"):
        tsp.register_backend("auto", lambda *a, **k: None)
    with pytest.raises(ValueError, match="already registered"):
        tsp.register_backend("torch", lambda *a, **k: None)


def test_matvec_and_sugar(ref_sp):
    a, A = _small()
    v = np.random.default_rng(0).standard_normal(30).astype(np.float32)
    y = A @ v
    assert y.shape == (40,)
    _assert_close(y, tsp.spmm(A, v[:, None])[:, 0])
    _assert_close(y, np.asarray(ref_sp.from_sparse_matrix(a, tm=16, k0=16)
                                @ v))
    _assert_close(A.spmm(v[:, None], alpha=2.0), 2 * np.asarray(y)[:, None])


@pytest.mark.parametrize("port_name", ["cuda", "spmv", "torch", "spmv_torch"])
def test_zero_nnz_matrix(ref_sp, port_name):
    z = np.zeros((20, 30), np.float32)
    A = tsp.from_dense(z, tm=16, k0=16, device="cpu")
    assert A.nnz == 0 and A.density == 0.0
    rng = np.random.default_rng(0)
    b, c = _dense(rng, (30, 3)), _dense(rng, (20, 3))
    want = ref_sp.spmm(ref_sp.from_dense(z, tm=16, k0=16), b, c, 1.0, 0.5,
                       backend="jnp")
    got = tsp.spmm(A, b, c, 1.0, 0.5, backend=port_name)
    _assert_close(got, want)
    _assert_close(got, 0.5 * c)


def test_with_values_and_to():
    a, A = _small()
    v = A.values * 2
    _assert_close(A.with_values(v).todense(), 2 * tsparse.to_dense(a))
    with pytest.raises(ValueError):
        A.with_values(v[:, :, :1])
    B = A.to("cpu")
    assert B.device.type == "cpu" and B.geometry == A.geometry


def test_flat_path_is_deterministic():
    a = tsparse.power_law_sparse(300, 500, 6, seed=9)
    A = tsp.from_sparse_matrix(a, device="cpu", **PACK)
    b = _dense(np.random.default_rng(0), (500, 16))
    assert torch.equal(tsp.spmm(A, b, backend="torch"),
                       tsp.spmm(A, b, backend="torch"))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


@pytest.mark.parametrize("entry", ["from_sparse_matrix", "from_coo",
                                   "from_dense", "pack_hflex", "to"])
def test_device_defaults_to_cuda_and_raises_without_it(no_cuda, entry):
    a, A = _small()
    calls = {
        "from_sparse_matrix": lambda: tsp.from_sparse_matrix(a),
        "from_coo": lambda: tsp.from_coo(a.shape, a.row, a.col, a.val),
        "from_dense": lambda: tsp.from_dense(tsparse.to_dense(a)),
        "pack_hflex": lambda: tsp.pack_hflex(a),
        "to": lambda: A.to("cuda"),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,kernel", [(64, "spmm"), (5, "spmv")])
def test_auto_on_the_card_launches_the_kernel(cuda, n, kernel):
    a = tsparse.power_law_sparse(2000, 3000, 6, seed=1)
    A = tsp.from_sparse_matrix(a, tm=128, k0=512)
    assert A.device.type == "cuda"
    rng = np.random.default_rng(0)
    b, c = _dense(rng, (3000, n)), _dense(rng, (2000, n))
    mod = kspmm if kernel == "spmm" else kspmv
    before = mod.LAUNCHES
    y = tsp.spmm(A, b, c, 1.0, 0.5)
    assert mod.LAUNCHES == before + 1
    assert y.device.type == "cuda"
    want = tsp.spmm(A, b, c, 1.0, 0.5, backend="torch")
    _assert_close(y.cpu(), want.cpu())
    _assert_close(y.cpu(), tsparse.spmm_reference(a, b, c, 1.0, 0.5))
