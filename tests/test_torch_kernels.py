"""The port's Sextans kernels on their padded slab operands.

On the CPU each plain version (``sextans_spmm_torch``,
``sextans_spmv_torch``) is held against the TPU kernel it replaces, run in
Pallas interpret mode on the same operands. On a card the CUDA kernels are
held against the plain versions. Tolerance: the reference's kernel
tolerance, ``rtol=2e-4`` and ``atol=2e-4*max(1, max|ref|)``; 5e-2 for bf16
``b``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.hflex import pack_block_slabs
from repro_torch.core.partition import cdiv
from repro_torch.core.sparse import SparseMatrix, power_law_sparse, random_sparse
from repro_torch.kernels import sextans_spmm as kspmm
from repro_torch.kernels import spmv_vector as kspmv
from repro_torch.kernels.ref import spmm_slabs_ref
from repro_torch.sparse_api.backends import _permute_rows_fwd

SHAPE_SWEEP = [
    # (M, K, N, density, tm, k0, tn), as tests/test_kernels.py sweeps them
    (64, 64, 8, 0.3, 32, 32, 8),
    (128, 128, 16, 0.1, 128, 128, 16),
    (200, 300, 40, 0.05, 64, 128, 32),
    (513, 257, 17, 0.02, 128, 64, 128),
    (33, 1000, 100, 0.01, 32, 256, 64),
    (1000, 33, 7, 0.2, 128, 32, 8),
]
ALPHA_BETA = [(1.0, 0.0), (0.5, 2.0)]


def _empty_windows():
    """Windows 1..2 of K hold no non-zero; rows 2..62 are empty too."""
    row = np.array([0, 1, 63], np.int32)
    col = np.array([0, 1, 255], np.int32)
    val = np.array([1.0, 2.0, 3.0], np.float32)
    return SparseMatrix((64, 256), row, col, val).sorted_column_major()


def _operands(a, n, tm, k0, width, interleave=True, bf16=False, seed=0):
    """Slabs plus b/c padded to ``width`` columns in the slabs' row
    layout, as numpy arrays. b stays float32; with ``bf16`` its values are
    rounded to bfloat16 first, so that both sides see the same b."""
    rng = np.random.default_rng(seed)
    m, k = a.shape
    s = pack_block_slabs(a, tm=tm, k0=k0, chunk=8, interleave=interleave)
    b = np.zeros((s.nw * k0, width), np.float32)
    b[:k, :n] = rng.standard_normal((k, n))
    if bf16:
        b = np.asarray(torch.from_numpy(b).to(torch.bfloat16).float())
    c = np.zeros((s.mb * tm, width), np.float32)
    c[:m, :n] = rng.standard_normal((m, n))
    if s.interleaved:
        c = _permute_rows_fwd(torch.from_numpy(c), s.mb, tm).numpy()
    return dict(vals=s.vals, cols=s.cols, rows=s.rows, q=s.q, b=b, c=c)


def _torch_ops(ops, device="cpu", b_dtype=torch.float32):
    t = {f: torch.from_numpy(np.ascontiguousarray(x)).to(device)
         for f, x in ops.items()}
    t["b"] = t["b"].to(b_dtype)
    return t


def _ab(alpha, beta, device="cpu"):
    return torch.tensor([alpha, beta], dtype=torch.float32, device=device)


def _assert_close(got, want, tol=2e-4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.fixture
def jax_cpu():
    """JAX, with the reference kept on the CPU. On a GPU machine JAX would
    run its f32 matmuls (the Pallas one-hot scatter among them) in TF32."""
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax


@pytest.fixture
def ref_kernels(jax_cpu):
    import jax.numpy as jnp
    from repro.kernels.sextans_spmm import sextans_spmm_pallas
    from repro.kernels.spmv_vector import sextans_spmv_pallas

    return jnp, sextans_spmm_pallas, sextans_spmv_pallas


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _spmm_both(ref_kernels, ops, alpha, beta, tm, k0, tn, b_dtype="f32"):
    jnp, pallas, _ = ref_kernels
    jb = jnp.asarray(ops["b"], jnp.bfloat16 if b_dtype == "bf16" else jnp.float32)
    want = pallas(*(jnp.asarray(ops[f]) for f in ("vals", "cols", "rows", "q")),
                  jb, jnp.asarray(ops["c"]), alpha, beta, tm=tm, k0=k0, chunk=8,
                  tn=tn, interpret=True)
    t = _torch_ops(ops, b_dtype=torch.bfloat16 if b_dtype == "bf16"
                   else torch.float32)
    got = kspmm.sextans_spmm_torch(t["vals"], t["cols"], t["rows"], t["q"],
                                   t["b"], t["c"], _ab(alpha, beta),
                                   tm=tm, k0=k0, tn=tn)
    assert got.dtype == t["b"].dtype
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("alpha,beta", ALPHA_BETA)
@pytest.mark.parametrize("m,k,n,d,tm,k0,tn", SHAPE_SWEEP)
def test_spmm_plain_matches_pallas(ref_kernels, m, k, n, d, tm, k0, tn,
                                   alpha, beta):
    a = random_sparse(m, k, d, seed=m + k)
    ops = _operands(a, n, tm, k0, cdiv(n, tn) * tn)
    _assert_close(*_spmm_both(ref_kernels, ops, alpha, beta, tm, k0, tn))


@pytest.mark.parametrize("interleave", [False, True])
def test_spmm_plain_matches_pallas_layouts(ref_kernels, interleave):
    a = power_law_sparse(300, 500, 6, seed=1)
    ops = _operands(a, 20, 64, 64, 32, interleave=interleave)
    _assert_close(*_spmm_both(ref_kernels, ops, 1.25, -0.5, 64, 64, 32))


def test_spmm_plain_matches_pallas_bf16(ref_kernels):
    a = random_sparse(96, 96, 0.1, seed=7)
    ops = _operands(a, 16, 32, 32, 16, bf16=True)
    _assert_close(*_spmm_both(ref_kernels, ops, 1.0, 0.0, 32, 32, 16, "bf16"),
                  tol=5e-2)


def test_spmm_plain_matches_pallas_empty_windows(ref_kernels):
    ops = _operands(_empty_windows(), 8, 32, 64, 8)
    assert (ops["q"] == 0).any()
    _assert_close(*_spmm_both(ref_kernels, ops, 1.0, 0.0, 32, 64, 8))


def _spmv_both(ref_kernels, ops, alpha, beta, tm, k0, b_dtype="f32"):
    jnp, _, pallas = ref_kernels
    jb = jnp.asarray(ops["b"], jnp.bfloat16 if b_dtype == "bf16" else jnp.float32)
    want = pallas(*(jnp.asarray(ops[f]) for f in ("vals", "cols", "rows", "q")),
                  jb, jnp.asarray(ops["c"]), alpha, beta, tm=tm, k0=k0, chunk=8,
                  nv=ops["b"].shape[1], interpret=True)
    t = _torch_ops(ops, b_dtype=torch.bfloat16 if b_dtype == "bf16"
                   else torch.float32)
    got = kspmv.sextans_spmv_torch(t["vals"], t["cols"], t["rows"], t["q"],
                                   t["b"], t["c"], _ab(alpha, beta),
                                   tm=tm, k0=k0)
    assert got.dtype == t["b"].dtype
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("alpha,beta", ALPHA_BETA)
@pytest.mark.parametrize("m,k,n,d,tm,k0,tn", SHAPE_SWEEP)
def test_spmv_plain_matches_pallas(ref_kernels, m, k, n, d, tm, k0, tn,
                                   alpha, beta):
    a = random_sparse(m, k, d, seed=m + k)
    ops = _operands(a, n, tm, k0, cdiv(n, 8) * 8)
    _assert_close(*_spmv_both(ref_kernels, ops, alpha, beta, tm, k0))


@pytest.mark.parametrize("interleave", [False, True])
def test_spmv_plain_matches_pallas_layouts(ref_kernels, interleave):
    a = power_law_sparse(300, 500, 6, seed=1)
    ops = _operands(a, 5, 64, 64, 8, interleave=interleave)
    _assert_close(*_spmv_both(ref_kernels, ops, 1.25, -0.5, 64, 64))


def test_spmv_plain_matches_pallas_bf16_and_empty_windows(ref_kernels):
    ops = _operands(_empty_windows(), 3, 32, 64, 8, bf16=True)
    _assert_close(*_spmv_both(ref_kernels, ops, 0.5, 2.0, 32, 64, "bf16"),
                  tol=5e-2)


def test_plain_matches_slab_oracle():
    """Walking only the slots below q equals summing every slot: the
    padding slots past q hold val == 0."""
    a = power_law_sparse(200, 300, 5, seed=4)
    t = _torch_ops(_operands(a, 24, 32, 64, 32))
    got = kspmm.sextans_spmm_torch(t["vals"], t["cols"], t["rows"], t["q"],
                                   t["b"], t["c"], _ab(0.5, 2.0), tm=32, k0=64,
                                   tn=32)
    want = spmm_slabs_ref(t["vals"], t["cols"], t["rows"], t["q"], t["b"],
                          t["c"], 64, 32, 0.5, 2.0)
    _assert_close(got, want)


def test_cpu_wrappers_take_plain_versions_and_do_not_count():
    t = _torch_ops(_operands(random_sparse(64, 64, 0.2, seed=1), 8, 32, 32, 8))
    before = (kspmm.LAUNCHES, kspmv.LAUNCHES)
    y1 = kspmm.sextans_spmm_cuda(t["vals"], t["cols"], t["rows"], t["q"],
                                 t["b"], t["c"], _ab(1.0, 0.5), tm=32, k0=32,
                                 tn=8)
    y2 = kspmv.sextans_spmv_cuda(t["vals"], t["cols"], t["rows"], t["q"],
                                 t["b"], t["c"], _ab(1.0, 0.5), tm=32, k0=32)
    assert (kspmm.LAUNCHES, kspmv.LAUNCHES) == before
    _assert_close(y1, y2)


@pytest.mark.parametrize("bad", ["vals_dtype", "q_shape", "b_rows", "b_width",
                                 "c_dtype", "b_dtype", "ab_shape"])
def test_wrappers_reject_bad_operands(bad):
    t = _torch_ops(_operands(random_sparse(64, 64, 0.2, seed=1), 8, 32, 32, 8))
    ab = _ab(1.0, 0.0)
    if bad == "vals_dtype":
        t["vals"] = t["vals"].double()
    elif bad == "q_shape":
        t["q"] = t["q"][:1]
    elif bad == "b_rows":
        t["b"] = t["b"][:-1]
    elif bad == "b_width":
        t["b"] = t["b"][:, :5]
    elif bad == "c_dtype":
        t["c"] = t["c"].to(torch.bfloat16)
    elif bad == "b_dtype":
        t["b"] = t["b"].half()
    else:
        ab = ab[:1]
    args = (t["vals"], t["cols"], t["rows"], t["q"], t["b"], t["c"], ab)
    with pytest.raises((TypeError, ValueError)):
        kspmm.sextans_spmm_cuda(*args, tm=32, k0=32, tn=8)
    with pytest.raises((TypeError, ValueError)):
        kspmv.sextans_spmv_cuda(*args, tm=32, k0=32)


# -- on the card: CUDA kernel against its plain version -----------------------


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["spmm", "spmv"])
@pytest.mark.parametrize("alpha,beta", ALPHA_BETA)
@pytest.mark.parametrize("m,k,n,d,tm,k0,tn", SHAPE_SWEEP)
def test_cuda_kernel_matches_plain(cuda, kernel, m, k, n, d, tm, k0, tn,
                                   alpha, beta):
    a = random_sparse(m, k, d, seed=m + k)
    width = cdiv(n, tn) * tn if kernel == "spmm" else cdiv(n, 8) * 8
    t = _torch_ops(_operands(a, n, tm, k0, width), device=cuda)
    args = (t["vals"], t["cols"], t["rows"], t["q"], t["b"], t["c"],
            _ab(alpha, beta, cuda))
    if kernel == "spmm":
        before = kspmm.LAUNCHES
        got = kspmm.sextans_spmm_cuda(*args, tm=tm, k0=k0, tn=tn)
        want = kspmm.sextans_spmm_torch(*args, tm=tm, k0=k0, tn=tn)
        assert kspmm.LAUNCHES == before + 1
    else:
        before = kspmv.LAUNCHES
        got = kspmv.sextans_spmv_cuda(*args, tm=tm, k0=k0)
        want = kspmv.sextans_spmv_torch(*args, tm=tm, k0=k0)
        assert kspmv.LAUNCHES == before + 1
    torch.cuda.synchronize()
    _assert_close(got.cpu(), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["spmm", "spmv"])
def test_cuda_kernel_bf16_empty_windows_deterministic(cuda, kernel):
    t = _torch_ops(_operands(_empty_windows(), 8, 32, 64, 8), device=cuda,
                   b_dtype=torch.bfloat16)
    args = (t["vals"], t["cols"], t["rows"], t["q"], t["b"], t["c"],
            _ab(0.5, 2.0, cuda))
    if kernel == "spmm":
        run = lambda: kspmm.sextans_spmm_cuda(*args, tm=32, k0=64, tn=8)
        want = kspmm.sextans_spmm_torch(*args, tm=32, k0=64, tn=8)
    else:
        run = lambda: kspmv.sextans_spmv_cuda(*args, tm=32, k0=64)
        want = kspmv.sextans_spmv_torch(*args, tm=32, k0=64)
    got = run()
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, run())
    _assert_close(got.float().cpu(), want.float().cpu(), tol=5e-2)


@pytest.mark.parametrize("oracle", ["dense", "coo", "slabs"])
def test_oracles_match_reference(jax_cpu, oracle):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(5)
    a = power_law_sparse(120, 90, 4, seed=5)
    b = rng.standard_normal((90, 12)).astype(np.float32)
    c = rng.standard_normal((120, 12)).astype(np.float32)
    T = torch.from_numpy
    if oracle == "dense":
        dense = np.zeros(a.shape, np.float32)
        np.add.at(dense, (a.row, a.col), a.val)
        got = tref.spmm_dense_ref(T(dense), T(b), T(c), 0.5, 2.0)
        want = jref.spmm_dense_ref(jnp.asarray(dense), b, c, 0.5, 2.0)
    elif oracle == "coo":
        got = tref.spmm_coo_ref(T(a.row), T(a.col), T(a.val), T(b), T(c),
                                120, 0.5, 2.0)
        want = jref.spmm_coo_ref(a.row, a.col, a.val, jnp.asarray(b), c, 120,
                                 0.5, 2.0)
    else:
        ops = _operands(a, 12, 32, 64, 12)
        t = _torch_ops(ops)
        got = tref.spmm_slabs_ref(t["vals"], t["cols"], t["rows"], t["q"],
                                  t["b"], t["c"], 64, 32, 0.5, 2.0)
        want = jref.spmm_slabs_ref(*(jnp.asarray(ops[f]) for f in
                                     ("vals", "cols", "rows", "q", "b", "c")),
                                   64, 32, 0.5, 2.0)
    _assert_close(got, np.asarray(want))
