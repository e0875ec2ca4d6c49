"""Gradients of the port's ``spmm`` and ``spmm_streaming`` against the JAX
package's ``jax.grad`` and a float64 dense oracle.

The same matrix, dense operands and cotangent weights, made from a numpy
seed, go through both packages. Gradients with respect to the values, b,
c, alpha and beta agree within ``rtol=2e-4``,
``atol=2e-4*max(1, max|ref|)`` (bf16 b: 5e-2); padding slots get exactly
zero.
"""

import numpy as np
import pytest
import torch

import repro_torch.sparse_api as tsp
from repro_torch.core.sparse import power_law_sparse, to_dense

PACK = dict(tm=32, k0=64, chunk=8)
M, K, N = 150, 260, 12
ALPHA, BETA = 1.3, -0.4
PORT_BACKENDS = [("torch", {}), ("cuda", dict(tn=8)), ("spmv", {}),
                 ("spmv_torch", {})]


@pytest.fixture
def jax_cpu():
    """JAX, with the reference kept on the CPU. On a GPU machine JAX would
    run its f32 matmuls in TF32."""
    jax = pytest.importorskip("jax")
    with jax.default_device(jax.devices("cpu")[0]):
        yield jax


def _assert_close(got, want, tol=2e-4):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _inputs(seed=0, interleave=True, n=N):
    rng = np.random.default_rng(seed)
    a = power_law_sparse(M, K, 5, seed=seed + 1)
    return dict(a=a, interleave=interleave,
                b=rng.standard_normal((K, n)).astype(np.float32),
                c=rng.standard_normal((M, n)).astype(np.float32),
                w=rng.standard_normal((M, n)).astype(np.float32))


def _port_grads(inp, fn=None, b_dtype=torch.float32, **kw):
    """Gradients of ``sum(w * y)`` for y = spmm(A.with_values(v), b, c,
    alpha, beta), in the order (values, b, c, alpha, beta)."""
    fn = fn or tsp.spmm
    A = tsp.from_sparse_matrix(inp["a"], interleave=inp["interleave"],
                               device="cpu", **PACK)
    v = A.values.clone().requires_grad_()
    b = torch.from_numpy(inp["b"]).to(b_dtype).requires_grad_()
    c = torch.from_numpy(inp["c"]).requires_grad_()
    alpha = torch.tensor(ALPHA, requires_grad=True)
    beta = torch.tensor(BETA, requires_grad=True)
    y = fn(A.with_values(v), b, c, alpha, beta, **kw)
    (y.float() * torch.from_numpy(inp["w"])).sum().backward()
    return A, [x.grad for x in (v, b, c, alpha, beta)]


def _ref_grads(inp, streaming=False, b_dtype=None, **kw):
    import jax
    import jax.numpy as jnp
    import repro.sparse_api as sp

    A = sp.from_sparse_matrix(inp["a"], interleave=inp["interleave"], **PACK)
    fn = sp.spmm_streaming if streaming else sp.spmm
    b = jnp.asarray(inp["b"], b_dtype or jnp.float32)
    w = jnp.asarray(inp["w"])

    def loss(v, b_, c_, al, be):
        y = fn(A.with_values(v), b_, c_, al, be, **kw)
        return jnp.sum(w * y.astype(jnp.float32))

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        A.values, b, jnp.asarray(inp["c"]), jnp.float32(ALPHA),
        jnp.float32(BETA))
    return [np.asarray(g, np.float32) for g in grads]


def _dense_oracle(inp):
    """Gradients in float64 through the dense product."""
    a = torch.from_numpy(to_dense(inp["a"]).astype(np.float64))
    b = torch.from_numpy(inp["b"].astype(np.float64)).requires_grad_()
    c = torch.from_numpy(inp["c"].astype(np.float64)).requires_grad_()
    alpha = torch.tensor(ALPHA, dtype=torch.float64, requires_grad=True)
    beta = torch.tensor(BETA, dtype=torch.float64, requires_grad=True)
    y = alpha * a @ b + beta * c
    (y * torch.from_numpy(inp["w"].astype(np.float64))).sum().backward()
    return [x.grad.numpy() for x in (b, c, alpha, beta)]


def _live(A):
    d = A.data
    return torch.arange(d.lw) < d.nse[..., None]


@pytest.mark.parametrize("interleave", [True, False])
@pytest.mark.parametrize("backend,opts", PORT_BACKENDS)
def test_spmm_grads_match_reference_and_oracle(jax_cpu, backend, opts,
                                               interleave):
    inp = _inputs(interleave=interleave)
    A, got = _port_grads(inp, backend=backend, **opts)
    want = _ref_grads(inp, backend="jnp")
    for g, r in zip(got, want):
        _assert_close(g, r)
    for g, r in zip(got[1:], _dense_oracle(inp)):
        _assert_close(g, r)
    assert bool((got[0][~_live(A)] == 0).all())


@pytest.mark.parametrize("wc,nt", [(1, None), (2, 5), (3, 12)])
@pytest.mark.parametrize("backend,opts", [("torch", {}), ("cuda", dict(tn=8))])
def test_spmm_streaming_grads_match_reference(jax_cpu, backend, opts, wc, nt):
    inp = _inputs(seed=2)
    A, got = _port_grads(inp, fn=tsp.spmm_streaming, window_chunk=wc,
                         n_tile=nt, backend=backend, **opts)
    want = _ref_grads(inp, streaming=True, window_chunk=wc, n_tile=nt,
                      backend="jnp")
    for g, r in zip(got, want):
        _assert_close(g, r)
    _, resident = _port_grads(inp, backend=backend, **opts)
    for g, r in zip(got, resident):
        _assert_close(g, r)
    for g, r in zip(got[1:], _dense_oracle(inp)):
        _assert_close(g, r)
    assert bool((got[0][~_live(A)] == 0).all())


def test_bf16_b_grads_match_reference(jax_cpu):
    import jax.numpy as jnp

    inp = _inputs(seed=3)
    inp["b"] = np.asarray(torch.from_numpy(inp["b"]).to(torch.bfloat16)
                          .float())
    _, got = _port_grads(inp, b_dtype=torch.bfloat16, backend="cuda", tn=8)
    want = _ref_grads(inp, b_dtype=jnp.bfloat16, backend="jnp")
    assert got[1].dtype == torch.bfloat16
    for g, r in zip(got, want):
        _assert_close(g.float(), r, tol=5e-2)


def test_matmul_sugar_carries_gradients():
    inp = _inputs(seed=4)
    A = tsp.from_sparse_matrix(inp["a"], device="cpu", **PACK)
    v = A.values.clone().requires_grad_()
    b = torch.from_numpy(inp["b"]).requires_grad_()
    (A.with_values(v) @ b).square().sum().backward()
    v2 = A.values.clone().requires_grad_()
    b2 = torch.from_numpy(inp["b"]).requires_grad_()
    tsp.spmm(A.with_values(v2), b2).square().sum().backward()
    assert torch.equal(v.grad, v2.grad) and torch.equal(b.grad, b2.grad)
    assert bool((v.grad[~_live(A)] == 0).all())
    x = torch.from_numpy(inp["b"][:, 0].copy()).requires_grad_()
    (A @ x).sum().backward()
    _assert_close(x.grad, to_dense(inp["a"]).sum(0))


def test_only_requested_grads_and_repeatable():
    inp = _inputs(seed=5)
    A = tsp.from_sparse_matrix(inp["a"], device="cpu", **PACK)
    b = torch.from_numpy(inp["b"]).requires_grad_()
    y = tsp.spmm(A, b, inp["c"], ALPHA, BETA, backend="cuda", tn=8)
    assert y.requires_grad and A.values.grad is None
    (db,) = torch.autograd.grad(y.sum(), b)
    y = tsp.spmm(A, b, inp["c"], ALPHA, BETA, backend="cuda", tn=8)
    (db2,) = torch.autograd.grad(y.sum(), b)
    assert torch.equal(db, db2)
    assert not tsp.spmm(A, inp["b"]).requires_grad


def test_gradcheck_float64_flat_path():
    """The hand-written backward against finite differences, on values and
    b, with the float64 operands the flat path accepts."""
    a = power_law_sparse(20, 30, 3, seed=6)
    A = tsp.from_sparse_matrix(a, tm=8, k0=16, device="cpu")
    rng = np.random.default_rng(6)
    b = torch.from_numpy(rng.standard_normal((30, 3))).requires_grad_()
    live = _live(A)

    def f(v_live, b_):
        v = torch.zeros(A.values.shape, dtype=torch.float64)
        v[live] = v_live
        return tsp.spmm(A.with_values(v.float()), b_.float(),
                        backend="torch").double()

    v0 = A.values[live].double().requires_grad_()
    assert torch.autograd.gradcheck(f, (v0, b), eps=1e-3, atol=1e-2,
                                    rtol=1e-2)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("backend,opts", [("cuda", dict(tn=8)), ("spmv", {})])
def test_grads_on_the_card(cuda, backend, opts):
    inp = _inputs(seed=7)
    A = tsp.from_sparse_matrix(inp["a"], **PACK)
    v = A.values.clone().requires_grad_()
    b = torch.from_numpy(inp["b"]).to(cuda).requires_grad_()
    c = torch.from_numpy(inp["c"]).to(cuda).requires_grad_()
    y = tsp.spmm(A.with_values(v), b, c, ALPHA, BETA, backend=backend, **opts)
    (y * torch.from_numpy(inp["w"]).to(cuda)).sum().backward()
    for g, r in zip((b.grad, c.grad), _dense_oracle(inp)):
        _assert_close(g.cpu(), r)
    _, cpu = _port_grads(inp, backend=backend, **opts)
    _assert_close(v.grad.cpu(), cpu[0])
