"""The port's out-of-core tier against the JAX package's.

``SparseTensor.windows``/``nbytes``, the kernels' accumulate mode (plain
versions against the Pallas kernels run with ``interpret=True``), the
plans' tiling decisions and ``PLAN_STATS`` counts, and streamed results:
bit-identical to the port's resident result on the same backend, and
within ``rtol=2e-4``, ``atol=2e-4*max(1, max|ref|)`` of the reference's.
Inputs come from numpy with a seed; the reference runs on the CPU.
"""

import warnings

import numpy as np
import pytest
import torch

import repro_torch.sparse_api as tsp
from repro_torch.core.hflex import pack_block_slabs
from repro_torch.core.partition import cdiv
from repro_torch.core.sparse import power_law_sparse, random_sparse
from repro_torch.kernels import sextans_spmm as kspmm
from repro_torch.kernels import spmv_vector as kspmv
from repro_torch.sparse_api import backends as tbk
from repro_torch.sparse_api.backends import _permute_rows_fwd

PACK = dict(tm=64, k0=64, chunk=8)
M, K, N = 300, 500, 16
SHAPE_SWEEP = [
    # (M, K, N, density, tm, k0, tn), as tests/test_kernels.py sweeps them
    (64, 64, 8, 0.3, 32, 32, 8),
    (128, 128, 16, 0.1, 128, 128, 16),
    (200, 300, 40, 0.05, 64, 128, 32),
    (513, 257, 17, 0.02, 128, 64, 128),
    (33, 1000, 100, 0.01, 32, 256, 64),
    (1000, 33, 7, 0.2, 128, 32, 8),
]
# (reference backend, port backend, reference opts, port opts)
PAIRS = [("jnp", "torch", {}, {}),
         ("pallas", "cuda", dict(tn=8, interpret=True), dict(tn=8)),
         ("spmv", "spmv", dict(interpret=True), {}),
         ("spmv_jnp", "spmv_torch", {}, {})]
PORT_BACKENDS = [("torch", {}), ("cuda", dict(tn=8)), ("spmv", {}),
                 ("spmv_torch", {})]


@pytest.fixture
def jax_cpu():
    """JAX, with the reference kept on the CPU. On a GPU machine JAX would
    run its f32 matmuls (the Pallas one-hot scatter among them) in TF32."""
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax


@pytest.fixture
def ref_sp(jax_cpu):
    import repro.sparse_api as sp

    return sp


def _assert_close(got, want, tol=2e-4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _problem(seed=1, interleave=True, n=N, m=M, k=K, **pack):
    """A power-law matrix packed by the port on the CPU, plus b and c."""
    rng = np.random.default_rng(seed)
    a = power_law_sparse(m, k, 6, seed=seed)
    A = tsp.from_sparse_matrix(a, interleave=interleave, device="cpu",
                               **{**PACK, **pack})
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    return a, A, b, c


# -- SparseTensor.windows / nbytes --------------------------------------------


@pytest.mark.parametrize("interleave", [False, True])
@pytest.mark.parametrize("w0,w1", [(0, 1), (2, 5), (5, 8), (0, 8)])
def test_windows_match_reference(ref_sp, interleave, w0, w1):
    a = power_law_sparse(M, K, 6, seed=3)
    ref_a = ref_sp.from_sparse_matrix(a, interleave=interleave, **PACK)
    A = tsp.from_sparse_matrix(a, interleave=interleave, device="cpu", **PACK)
    assert A.num_windows == ref_a.num_windows == 8
    want, got = ref_a.windows(w0, w1), A.windows(w0, w1)
    for f in ("vals", "cols", "rows", "q", "nse"):
        np.testing.assert_array_equal(getattr(got.data, f).numpy(),
                                      np.asarray(getattr(want.data, f)))
    assert got.shape == want.shape
    assert (got.nnz, got.data.k) == (want.nnz, want.data.k)
    np.testing.assert_array_equal(got.todense().numpy(),
                                  np.asarray(want.todense()))


def test_nbytes_on_host_and_bounds(ref_sp):
    a = power_law_sparse(M, K, 6, seed=3)
    A = tsp.from_sparse_matrix(a, device="cpu", **PACK)
    assert A.nbytes == ref_sp.from_sparse_matrix(a, **PACK).nbytes
    assert A.on_host and A.to_device("cpu") is A
    for w0, w1 in ((-1, 2), (0, 0), (2, 1), (0, A.num_windows + 1)):
        with pytest.raises(ValueError, match="out of range"):
            A.windows(w0, w1)


# -- the kernels' accumulate mode ---------------------------------------------


def _slab_operands(a, n, tm, k0, width, interleave=True, seed=0):
    """Slabs plus b and a random f32 starting accumulator, padded to
    ``width`` columns in the slabs' row layout, as numpy arrays."""
    rng = np.random.default_rng(seed)
    m, k = a.shape
    s = pack_block_slabs(a, tm=tm, k0=k0, chunk=8, interleave=interleave)
    b = np.zeros((s.nw * k0, width), np.float32)
    b[:k, :n] = rng.standard_normal((k, n))
    acc = np.zeros((s.mb * tm, width), np.float32)
    acc[:m, :n] = rng.standard_normal((m, n))
    if s.interleaved:
        acc = _permute_rows_fwd(torch.from_numpy(acc), s.mb, tm).numpy()
    return dict(vals=s.vals, cols=s.cols, rows=s.rows, q=s.q, b=b, acc=acc)


def _t(ops):
    return {f: torch.from_numpy(np.ascontiguousarray(x)) for f, x in
            ops.items()}


def _plain(kernel, t, tm, k0, tn, acc=None):
    """The plain version in accumulate mode, on a copy of the acc."""
    acc = t["acc"].clone() if acc is None else acc
    args = (t["vals"], t["cols"], t["rows"], t["q"], t["b"], acc)
    if kernel == "spmm":
        return kspmm.sextans_spmm_torch(*args, tm=tm, k0=k0, tn=tn,
                                        accumulate=True)
    return kspmv.sextans_spmv_torch(*args, tm=tm, k0=k0, accumulate=True)


@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("kernel", ["spmm", "spmv"])
@pytest.mark.parametrize("m,k,n,d,tm,k0,tn", SHAPE_SWEEP)
def test_accumulate_plain_matches_pallas(jax_cpu, m, k, n, d, tm, k0, tn,
                                         kernel, interleave):
    import jax.numpy as jnp
    from repro.kernels.sextans_spmm import sextans_spmm_pallas
    from repro.kernels.spmv_vector import sextans_spmv_pallas

    a = random_sparse(m, k, d, seed=m + k)
    width = cdiv(n, tn) * tn if kernel == "spmm" else cdiv(n, 8) * 8
    ops = _slab_operands(a, n, tm, k0, width, interleave=interleave)
    jops = [jnp.asarray(ops[f]) for f in ("vals", "cols", "rows", "q", "b",
                                          "acc")]
    if kernel == "spmm":
        want = sextans_spmm_pallas(*jops, tm=tm, k0=k0, chunk=8, tn=tn,
                                   interpret=True, accumulate=True)
    else:
        want = sextans_spmv_pallas(*jops, tm=tm, k0=k0, chunk=8, nv=width,
                                   interpret=True, accumulate=True)
    t = _t(ops)
    acc = t["acc"].clone()
    got = _plain(kernel, t, tm, k0, tn, acc=acc)
    assert got.dtype == torch.float32 and got is acc     # in place
    _assert_close(got, np.asarray(want))


@pytest.mark.parametrize("kernel", ["spmm", "spmv"])
def test_accumulate_chain_equals_one_call_bitwise(kernel):
    """Accumulate steps over consecutive window chunks add exactly what one
    accumulate call adds, and chunks + the shared epilogue equal one
    resident call."""
    a = power_law_sparse(M, K, 6, seed=2)
    tm, k0, tn, width = 64, 64, 8, 16
    t = _t(_slab_operands(a, 11, tm, k0, width))
    whole = _plain(kernel, t, tm, k0, tn)
    zero = torch.zeros_like(t["acc"])
    for wc in (1, 3):
        acc = t["acc"].clone()
        nw = t["vals"].shape[1]
        for w0 in range(0, nw, wc):
            w1 = min(nw, w0 + wc)
            chunk = {f: t[f][:, w0:w1].contiguous() for f in
                     ("vals", "cols", "rows", "q")}
            chunk["b"] = t["b"][w0 * k0:w1 * k0]
            _plain(kernel, chunk, tm, k0, tn, acc=acc)
        assert torch.equal(acc, whole)
        raw = _plain(kernel, t, tm, k0, tn, acc=zero.clone())
        ab = torch.tensor([1.25, -0.5])
        args = (t["vals"], t["cols"], t["rows"], t["q"], t["b"], t["acc"], ab)
        resident = (kspmm.sextans_spmm_torch(*args, tm=tm, k0=k0, tn=tn)
                    if kernel == "spmm" else
                    kspmv.sextans_spmv_torch(*args, tm=tm, k0=k0))
        assert torch.equal(
            tsp.stream_finish(raw, t["acc"], ab[0], ab[1], torch.float32),
            resident)


def test_accumulate_wrappers_count_nothing_on_the_cpu():
    t = _t(_slab_operands(random_sparse(64, 64, 0.2, seed=1), 8, 32, 32, 8))
    before = (kspmm.ACCUMULATE_LAUNCHES, kspmv.ACCUMULATE_LAUNCHES)
    args = (t["vals"], t["cols"], t["rows"], t["q"], t["b"])
    y1 = kspmm.sextans_spmm_cuda(*args, t["acc"].clone(), tm=32, k0=32, tn=8,
                                 accumulate=True)
    y2 = kspmv.sextans_spmv_cuda(*args, t["acc"].clone(), tm=32, k0=32,
                                 accumulate=True)
    assert (kspmm.ACCUMULATE_LAUNCHES, kspmv.ACCUMULATE_LAUNCHES) == before
    _assert_close(y1, y2)
    with pytest.raises(TypeError, match="c_in must be float32"):
        kspmm.sextans_spmm_cuda(*args, t["acc"].double(), tm=32, k0=32, tn=8,
                                accumulate=True)
    with pytest.raises(ValueError, match="ab must be"):
        kspmm.sextans_spmm_cuda(*args, t["acc"], tm=32, k0=32, tn=8)


# -- plan decisions ------------------------------------------------------------


def _decisions(p):
    return (p.n_tile, p.n_tiles, p.window_chunk, p.steps, p.window_dispatches,
            p.chunk_payload_bytes, p.peak_payload_bytes)


@pytest.fixture
def ref_plan_no_compile(ref_sp, monkeypatch):
    """The reference's plan module with its ahead-of-time compile stubbed
    out: the tiling decisions are made before it, and compiling a Pallas
    step in interpret mode for every budget would take most of a minute."""
    import importlib

    # The package's ``plan`` attribute is the function, not the module.
    ref_plan = importlib.import_module("repro.sparse_api.plan")
    monkeypatch.setattr(ref_plan, "_aot_compile", lambda *a, **k: None)
    return ref_plan


@pytest.mark.parametrize("ref_name,port_name,ref_opts,port_opts",
                         [PAIRS[0], PAIRS[1]])
def test_streaming_tiling_matches_reference(ref_sp, ref_plan_no_compile,
                                            ref_name, port_name, ref_opts,
                                            port_opts):
    a = power_law_sparse(M, K, 6, seed=1)
    ref_a = ref_sp.from_sparse_matrix(a, **PACK)
    A = tsp.from_sparse_matrix(a, device="cpu", **PACK)
    cases = [dict(), dict(window_chunk=3), dict(n_tile=5),
             dict(window_chunk=2, n_tile=4)]
    for budget in (None, A.nbytes // 5, A.nbytes // 2, 2 * A.nbytes,
                   40_000, 300_000):
        for n in (16, 100):
            for pin in cases:
                kw = dict(stream=True, device_bytes=budget, **pin)
                with warnings.catch_warnings(record=True) as w_ref:
                    warnings.simplefilter("always")
                    want = ref_sp.plan(ref_a, n, backend=ref_name, **kw,
                                       **ref_opts)
                with warnings.catch_warnings(record=True) as w_port:
                    warnings.simplefilter("always")
                    got = tsp.plan(A, n, backend=port_name, device="cpu",
                                   **kw, **port_opts)
                assert isinstance(got, tsp.StreamingPlan)
                assert _decisions(got) == _decisions(want), (budget, n, pin)
                assert len(w_port) == len(w_ref), (budget, n, pin)
                assert got.payload_bytes == want.payload_bytes


def test_overrun_warning_matches_reference(ref_sp, ref_plan_no_compile):
    a = power_law_sparse(M, K, 6, seed=1)
    ref_a = ref_sp.from_sparse_matrix(a, **PACK)
    A = tsp.from_sparse_matrix(a, device="cpu", **PACK)
    with pytest.warns(UserWarning, match="exceeds device_bytes=1000") as rec:
        got = tsp.plan(A, 16, backend="torch", device="cpu", device_bytes=1000)
    with pytest.warns(UserWarning) as ref_rec:
        want = ref_sp.plan(ref_a, 16, backend="jnp", device_bytes=1000)
    assert _decisions(got) == _decisions(want)
    assert str(rec[0].message) == str(ref_rec[0].message)


@pytest.mark.parametrize("n", [1, 8, 64])
def test_tier_choice_matches_reference(ref_sp, ref_plan_no_compile, n):
    a = power_law_sparse(M, K, 6, seed=1)
    ref_a = ref_sp.from_sparse_matrix(a, **PACK)
    A = tsp.from_sparse_matrix(a, device="cpu", **PACK)
    for budget in (None, A.nbytes // 4, A.nbytes, 2 * A.nbytes, 1 << 30):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = ref_sp.plan(ref_a, n, backend="jnp", device_bytes=budget)
            got = tsp.plan(A, n, backend="torch", device="cpu",
                           device_bytes=budget)
        assert isinstance(want, ref_sp.StreamingPlan) == isinstance(
            got, tsp.StreamingPlan), budget
        assert isinstance(got, (tsp.SpmmPlan, tsp.StreamingPlan))


def test_plan_stats_match_reference(ref_sp):
    a, A, b, c = _problem(seed=2)
    ref_a = ref_sp.from_sparse_matrix(a, **PACK)
    runs = [dict(stream=True, window_chunk=3), dict(stream=True, n_tile=5),
            dict(stream=False)]

    def deltas(sp, tensor, backend, device):
        before = dict(sp.PLAN_STATS)
        for kw in runs:
            p = sp.plan(tensor, N, backend=backend, **kw, **device)
            p.run(b, c, 1.0, 0.5)
            p.run(b)
        return {k: sp.PLAN_STATS[k] - before[k]
                for k in ("dispatches", "window_dispatches")}

    assert deltas(tsp, A, "torch", dict(device="cpu")) == deltas(
        ref_sp, ref_a, "jnp", {})


# -- streamed results ----------------------------------------------------------


@pytest.mark.parametrize("backend,opts", PORT_BACKENDS)
def test_streamed_bit_identical_to_resident(backend, opts):
    """The port's own invariant, for every (window_chunk, n_tile) in a small
    grid, through StreamingPlan and spmm_streaming."""
    _, A, b, c = _problem(seed=4)
    want = tsp.spmm(A, b, c, 1.25, -0.5, backend=backend, **opts)
    for wc in (1, 2, 3, 8):
        for nt in (None, 5, 16):
            P = tsp.plan(A, N, backend=backend, stream=True, window_chunk=wc,
                         n_tile=nt, device="cpu", **opts)
            assert torch.equal(P.run(b, c, 1.25, -0.5), want), (wc, nt)
            got = tsp.spmm_streaming(A, b, c, 1.25, -0.5, window_chunk=wc,
                                     n_tile=nt, backend=backend, **opts)
            assert torch.equal(got, want), (wc, nt)


@pytest.mark.parametrize("ref_name,port_name,ref_opts,port_opts", PAIRS)
def test_streaming_plan_matches_reference(ref_sp, ref_name, port_name,
                                          ref_opts, port_opts):
    a, A, b, c = _problem(seed=5)
    ref_a = ref_sp.from_sparse_matrix(a, **PACK)
    kw = dict(stream=True, window_chunk=3, n_tile=8)
    want = ref_sp.plan(ref_a, N, backend=ref_name, **kw, **ref_opts).run(
        b, c, 1.5, -0.25)
    got = tsp.plan(A, N, backend=port_name, device="cpu", **kw,
                   **port_opts).run(b, c, 1.5, -0.25)
    assert got.device.type == "cpu"
    _assert_close(got, want)
    _assert_close(got, tsp.spmm(A, b, c, 1.5, -0.25, backend="torch"))


def test_spmm_streaming_matches_reference(ref_sp):
    a, A, b, c = _problem(seed=6)
    ref_a = ref_sp.from_sparse_matrix(a, **PACK)
    want = ref_sp.spmm_streaming(ref_a, b, c, 0.75, 2.0, window_chunk=2,
                                 n_tile=6, backend="jnp")
    got = tsp.spmm_streaming(A, b, c, 0.75, 2.0, window_chunk=2, n_tile=6,
                             backend="cuda", tn=8)
    _assert_close(got, want)


@pytest.mark.parametrize("backend,opts", [("torch", {}), ("cuda", dict(tn=8))])
def test_values_substitution(ref_sp, backend, opts):
    a, A, b, _ = _problem(seed=7)
    v2 = A.values.numpy() * 3.0
    P = tsp.plan(A, N, backend=backend, stream=True, window_chunk=3,
                 n_tile=8, device="cpu", **opts)
    got = P.run(b, values=v2)
    want = tsp.spmm(A.with_values(torch.from_numpy(v2)), b, backend=backend,
                    **opts)
    assert torch.equal(got, want)
    ref_a = ref_sp.from_sparse_matrix(a, **PACK)
    ref = ref_sp.plan(ref_a, N, backend="jnp", stream=True,
                      window_chunk=3).run(b, values=v2)
    _assert_close(got, ref)
    R = tsp.plan(A, N, backend=backend, device="cpu", **opts)
    assert torch.equal(R.run(b, values=v2), want)


def test_alpha_beta_are_runtime_values():
    _, A, b, c = _problem(seed=8)
    P = tsp.plan(A, N, backend="cuda", stream=True, window_chunk=4,
                 device="cpu", tn=8)
    for alpha, beta in ((1.0, 0.0), (0.5, 0.5), (torch.tensor(2.0), -1.0)):
        assert torch.equal(P.run(b, c, alpha, beta),
                           tsp.spmm(A, b, c, alpha, beta, backend="cuda",
                                    tn=8))


@pytest.mark.parametrize("backend,opts", PORT_BACKENDS)
def test_block_major_tail_pad(backend, opts):
    """Row-major (non-interleaved) packing, a window chunk that leaves an
    inert tail, and a ragged K: the padded windows add nothing."""
    _, A, b, c = _problem(seed=9, interleave=False, k=470)
    assert not A.data.interleaved and A.num_windows == 8
    want = tsp.spmm(A, b, c, 1.0, 0.5, backend=backend, **opts)
    for wc in (3, 5):
        P = tsp.plan(A, N, backend=backend, stream=True, window_chunk=wc,
                     device="cpu", **opts)
        assert P.steps * wc > A.num_windows
        assert torch.equal(P.run(b, c, 1.0, 0.5), want)


def test_resident_plan_bit_identical_and_counts():
    _, A, b, c = _problem(seed=10)
    for backend, opts in PORT_BACKENDS:
        P = tsp.plan(A, N, backend=backend, device="cpu", **opts)
        assert isinstance(P, tsp.SpmmPlan) and P.backend == backend
        before = tsp.PLAN_STATS["dispatches"]
        assert torch.equal(P(b, c, 2.0, 0.5),
                           tsp.spmm(A, b, c, 2.0, 0.5, backend=backend,
                                    **opts))
        assert tsp.PLAN_STATS["dispatches"] == before + 1
    assert tsp.plan(A, N, device="cpu").backend == "torch"
    assert tsp.plan(A, 4, device="cpu").backend == "spmv_torch"


def test_tiled_plan_returns_host_tensor_and_2d_counts():
    _, A, b, c = _problem(seed=11)
    P = tsp.plan(A, N, backend="torch", stream=True, window_chunk=2,
                 n_tile=5, device="cpu")
    assert (P.n_tiles, P.steps, P.window_dispatches) == (4, 4, 16)
    before = dict(tsp.PLAN_STATS)
    y = P.run(b, c, 1.0, 0.5)
    assert y.device.type == "cpu" and tuple(y.shape) == (M, N)
    assert tsp.PLAN_STATS["window_dispatches"] - before[
        "window_dispatches"] == 16
    assert tsp.PLAN_STATS["dispatches"] - before["dispatches"] == 20
    assert P.h2d_bytes == 16 * (A.data.mb * 2 * A.data.lw * 12
                                + 2 * A.data.mb * 2 * 4 + 2 * 64 * 5 * 4)


def test_validation_messages(ref_sp):
    _, A, b, c = _problem(seed=12)
    nw = A.num_windows
    for kw, msg in ((dict(window_chunk=0), f"window_chunk must be in \\[1, "
                     f"NW={nw}\\], got 0"),
                    (dict(window_chunk=nw + 1), "window_chunk must be in"),
                    (dict(n_tile=0), f"n_tile must be in \\[1, N={N}\\], "
                     f"got 0"),
                    (dict(n_tile=N + 1), "n_tile must be in")):
        with pytest.raises(ValueError, match=msg):
            tsp.spmm_streaming(A, b, **kw)
        with pytest.raises(ValueError, match=msg):
            tsp.plan(A, N, stream=True, device="cpu", **kw)
    with pytest.raises(ValueError, match="B rows"):
        tsp.spmm_streaming(A, b[:-1])
    with pytest.raises(ValueError, match="2-D"):
        tsp.spmm_streaming(A, b[None])
    with pytest.raises(ValueError, match="c must have shape"):
        tsp.spmm_streaming(A, b, c[:, :3])
    with pytest.raises(TypeError, match="expects a SparseTensor"):
        tsp.spmm_streaming(np.eye(3), b)
    with pytest.raises(ValueError, match="n_tile applies to streaming"):
        tsp.plan(A, N, n_tile=4, device="cpu")
    P = tsp.plan(A, N, stream=True, device="cpu")
    with pytest.raises(ValueError, match="plan expects b of shape"):
        P.run(b[:, :3])
    with pytest.raises(ValueError, match="values must have the packed shape"):
        P.run(b, values=np.zeros(3, np.float32))
    tbk.register_backend("no_stream_hooks", tbk._backend_torch)
    try:
        with pytest.raises(ValueError, match="has no streaming hooks"):
            tsp.spmm_streaming(A, b, backend="no_stream_hooks")
        with pytest.raises(ValueError, match="has no streaming hooks"):
            tsp.plan(A, N, stream=True, backend="no_stream_hooks",
                     device="cpu")
    finally:
        tbk._REGISTRY.pop("no_stream_hooks")


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


def test_streaming_plan_needs_a_card(no_cuda):
    _, A, _, _ = _problem(seed=13)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.plan(A, N, stream=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.plan(A, N, device_bytes=A.nbytes // 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.plan(A, N, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.plan(A, N, device_bytes="auto")
    assert tsp.device_memory_budget() is None
    P = tsp.plan(A, N, device="cpu", device_bytes="auto")
    assert isinstance(P, tsp.SpmmPlan) and P.device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(device_bytes=1 << 40),
                                dict(device_bytes=1 << 40, stream=False),
                                dict(device_bytes=1, stream=False)])
def test_budgeted_plan_computes_on_the_card_unless_asked(no_cuda, kw):
    """A device-memory budget asks for the card: a host-packed A whose
    working set fits still gets no CPU plan unless device="cpu" is given."""
    _, A, _, _ = _problem(seed=13)
    assert A.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsp.plan(A, N, **kw)
    P = tsp.plan(A, N, device="cpu", **kw)
    assert isinstance(P, tsp.SpmmPlan) and P.device.type == "cpu"
    # Without a budget a plan computes where A lies, as spmm does.
    assert tsp.plan(A, N).device.type == "cpu"


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["spmm", "spmv"])
@pytest.mark.parametrize("m,k,n,d,tm,k0,tn", SHAPE_SWEEP)
def test_cuda_accumulate_matches_plain(cuda, m, k, n, d, tm, k0, tn, kernel):
    a = random_sparse(m, k, d, seed=m + k)
    width = cdiv(n, tn) * tn if kernel == "spmm" else cdiv(n, 8) * 8
    t = {f: x.to(cuda) for f, x in
         _t(_slab_operands(a, n, tm, k0, width)).items()}
    args = (t["vals"], t["cols"], t["rows"], t["q"], t["b"])
    mod = kspmm if kernel == "spmm" else kspmv
    kw = dict(tm=tm, k0=k0, accumulate=True)
    if kernel == "spmm":
        kw["tn"] = tn
    kern = (kspmm.sextans_spmm_cuda if kernel == "spmm"
            else kspmv.sextans_spmv_cuda)
    plain = (kspmm.sextans_spmm_torch if kernel == "spmm"
             else kspmv.sextans_spmv_torch)
    before = mod.ACCUMULATE_LAUNCHES
    acc = t["acc"].clone()
    got = kern(*args, acc, **kw)
    assert got is acc and mod.ACCUMULATE_LAUNCHES == before + 1
    want = plain(*args, t["acc"].clone(), **kw)
    torch.cuda.synchronize()
    _assert_close(got.cpu(), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("backend,opts", [("cuda", dict(tn=32)), ("spmv", {})])
def test_streaming_on_the_card_bit_identical(cuda, backend, opts):
    a = power_law_sparse(3000, 5000, 6, seed=1)
    A = tsp.from_sparse_matrix(a, tm=128, k0=512)
    A_h = tsp.from_sparse_matrix(a, tm=128, k0=512, device="cpu")
    rng = np.random.default_rng(0)
    n = 40 if backend == "cuda" else 5
    b = rng.standard_normal((5000, n)).astype(np.float32)
    c = rng.standard_normal((3000, n)).astype(np.float32)
    want = tsp.spmm(A, b, c, 1.25, -0.5, backend=backend, **opts)
    for wc, nt in ((1, None), (3, 16 if backend == "cuda" else 2)):
        got = tsp.spmm_streaming(A, b, c, 1.25, -0.5, window_chunk=wc,
                                 n_tile=nt, backend=backend, **opts)
        assert torch.equal(got, want)
        P = tsp.plan(A_h, n, backend=backend, stream=True, window_chunk=wc,
                     n_tile=nt, **opts)
        assert torch.equal(P.run(b, c, 1.25, -0.5).to(cuda), want)
