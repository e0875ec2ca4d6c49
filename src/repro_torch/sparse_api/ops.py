"""The differentiable SpMM entry points.

``spmm(A, b, c=None, alpha=1.0, beta=0.0, backend="auto")`` computes
``alpha * A @ b + beta * c`` on the device A lies on, through the backend
registry. ``b`` and ``c`` are moved to that device. ``alpha`` and ``beta``
reach the kernels as a device buffer, so sweeping them never syncs the
host.

Both ``spmm`` and ``spmm_streaming`` are ``torch.autograd.Function`` s,
twins of the reference's ``jax.custom_vjp`` s: gradients flow to ``b``,
``c``, ``alpha``, ``beta`` and the packed non-zero values (``A.values``,
or ``v`` in ``A.with_values(v)``), whichever backend ran the forward. The
backward is the gradient of the flat path, computed over the live slots
only (no kernel has a backward). Padding slots (position >= ``nse``) get
exactly zero: the sparsity structure is constant, as when training a
pruned layer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ref import ordered_scatter_add

from . import backends as _bk
from .tensor import SparseTensor

__all__ = ["spmm", "spmm_raw", "spmm_streaming"]


def as_dense(x, device: torch.device) -> torch.Tensor:
    """A dense operand as a tensor on ``device``. Host arrays keep their
    dtype, except float64, which becomes float32 as in the reference (JAX
    with 64-bit types off)."""
    if not isinstance(x, torch.Tensor):
        arr = np.asarray(x)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(arr))
    return x.to(device)


def _coefficient(x, device: torch.device) -> torch.Tensor:
    """alpha or beta as a float32 tensor on ``device``; a Python number is
    written there by a fill, with no host-to-device copy to wait for."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    arr = np.asarray(x, np.float32)
    if arr.ndim:
        return torch.from_numpy(arr).to(device)
    return torch.full((), float(arr), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Gradients of the flat path
# ---------------------------------------------------------------------------


def _cotangent(g32, alpha, b):
    """``alpha * g`` rounded to b's dtype, as the reference casts it to the
    raw product's dtype before its VJP."""
    return (alpha * g32).to(b.dtype).float()


def _flat_vjp(a: SparseTensor, b, ct, need_vals: bool, need_b: bool):
    """The VJP of ``raw = A @ b`` (the flat path) for the f32 cotangent
    ``ct`` of shape (M, N), over the live slots only.

    Returns ``(dvals, db)``: ``dvals`` of A's slab shape, zero on every
    padding slot, and ``db`` of b's shape in f32, summed through the
    ordered scatter-add (the same bits on every run). The reference
    differentiates its scatter over every slab slot; at full width that is
    MB*NW*LW slots times N, so only the live ones are gathered here.
    Either is None when not needed.
    """
    d = a.data
    live, rows_g, cols_g = _bk._hflex_global_ids(d)
    ct_rows = ct[rows_g]
    dvals = db = None
    if need_vals:
        dvals = torch.zeros(d.vals.shape, dtype=torch.float32,
                            device=ct.device)
        dvals[live] = (ct_rows * b[cols_g].float()).sum(-1)
    if need_b:
        db = torch.zeros((b.shape[0], ct.shape[1]), dtype=torch.float32,
                         device=ct.device)
        ordered_scatter_add(db, cols_g,
                            d.vals[live].float()[:, None] * ct_rows)
    return dvals, db


def _flat_raw(a: SparseTensor, b):
    """``A @ b`` through the flat path, in b's dtype (what the reference's
    backward re-derives as the primal of its VJP)."""
    d = a.data
    live, rows_g, cols_g = _bk._hflex_global_ids(d)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=b.device)
    contrib = d.vals[live].float()[:, None] * b[cols_g].float()
    return ordered_scatter_add(acc, rows_g, contrib).to(b.dtype)


def _epilogue_grads(ctx, g32, raw, c, alpha, beta):
    """``(d c, d alpha, d beta)``, each None where it is not needed."""
    need = ctx.needs_input_grad[-3:]
    dc = (beta * g32).to(c.dtype) if need[0] else None
    dalpha = (g32 * raw.float()).sum().to(alpha.dtype) if need[1] else None
    dbeta = (g32 * c.float()).sum().to(beta.dtype) if need[2] else None
    return dc, dalpha, dbeta


class _Spmm(torch.autograd.Function):
    """The resident SpMM: forward through the backend, backward through
    the flat path's gradient."""

    @staticmethod
    def forward(ctx, name, opts, a, values, b, c, alpha, beta):
        ctx.a = a
        ctx.save_for_backward(values, b, c, alpha, beta)
        return _bk.get_backend(name).fn(a.with_values(values), b, c, alpha,
                                        beta, **opts)

    @staticmethod
    def backward(ctx, g):
        values, b, c, alpha, beta = ctx.saved_tensors
        a = ctx.a.with_values(values)
        need_vals, need_b = ctx.needs_input_grad[3:5]
        g32 = g.float()
        dvals, db = _flat_vjp(a, b, _cotangent(g32, alpha, b), need_vals,
                              need_b)
        raw = _flat_raw(a, b) if ctx.needs_input_grad[6] else None
        dc, dalpha, dbeta = _epilogue_grads(ctx, g32, raw, c, alpha, beta)
        return (None, None, None,
                None if dvals is None else dvals.to(values.dtype),
                None if db is None else db.to(b.dtype), dc, dalpha, dbeta)


def spmm_raw(backend_name: str, a: SparseTensor, b, c, alpha, beta, **opts):
    """Dispatch core without the input checks (still differentiable):
    ``b`` and ``c`` are dense tensors on A's device, and ``alpha``/``beta``
    scalars."""
    dev = a.device
    return _Spmm.apply(backend_name, opts, a, a.values, b, c,
                       _coefficient(alpha, dev), _coefficient(beta, dev))


def spmm(
    a: SparseTensor,
    b,
    c=None,
    alpha=1.0,
    beta=0.0,
    *,
    backend: str = "auto",
    **opts,
) -> torch.Tensor:
    """``alpha * A @ b + beta * c`` for a SparseTensor ``A``.

    Args:
      a: SparseTensor of shape (M, K).
      b: dense (K, N) array or tensor.
      c: optional dense (M, N) array or tensor (defaults to zeros in b's
        dtype).
      alpha, beta: epilogue scalars (numbers or 0-d tensors).
      backend: a registered backend name, or "auto" (see
        :mod:`repro_torch.sparse_api.backends`).
      **opts: backend options (e.g. ``tn`` for ``cuda``, ``nv`` for
        ``spmv``).

    The result has b's dtype and lies on A's device. It is
    differentiable in ``A.values``, ``b``, ``c``, ``alpha`` and ``beta``.
    """
    if not isinstance(a, SparseTensor):
        raise TypeError(f"spmm expects a SparseTensor, got {type(a).__name__}")
    dev = a.device
    b = as_dense(b, dev)
    m, k = a.shape
    if b.dim() != 2:
        raise ValueError(f"b must be 2-D (K, N), got shape {tuple(b.shape)}")
    if b.shape[-2] != k:
        raise ValueError(f"B rows {b.shape[-2]} != A cols {k}")
    cshape = (m, b.shape[-1])
    c_ = (torch.zeros(cshape, dtype=b.dtype, device=dev) if c is None
          else as_dense(c, dev))
    if tuple(c_.shape) != cshape:
        raise ValueError(f"c must have shape {cshape}, got {tuple(c_.shape)}")
    alpha_ = _coefficient(alpha, dev)
    beta_ = _coefficient(beta, dev)
    for nm, x in (("alpha", alpha_), ("beta", beta_)):
        if x.dim():
            raise ValueError(
                f"vector {nm} needs a batched tensor; got shape "
                f"{tuple(x.shape)} on an unbatched spmm")
    name = _bk.resolve_backend(backend, a, b)
    return _Spmm.apply(name, opts, a, a.values, b, c_, alpha_, beta_)


# ---------------------------------------------------------------------------
# Out-of-core streaming (differentiable)
# ---------------------------------------------------------------------------


def _stream_bounds(nw: int, wchunk: int):
    return [(w0, min(nw, w0 + wchunk)) for w0 in range(0, nw, wchunk)]


def _tile_bounds(n: int, ntile: int):
    return [(n0, min(n, n0 + ntile)) for n0 in range(0, n, ntile)]


def _stream_raw(stream, opts, wchunk, ntile, a, b):
    """Raw accumulated ``A @ b`` (logical (M, N) f32) through the backend's
    streaming hooks over the 2-D (N-tile x K-window-chunk) grid, column
    tiles outer and window chunks inner, the walk a ``StreamingPlan``
    makes. Each column's add sequence is the resident path's, so the
    result is bit-identical for every (wchunk, ntile)."""
    k0 = a.data.k0
    stripes = []
    for j, (n0, n1) in enumerate(_tile_bounds(b.shape[1], ntile)):
        b_t = b[:, n0:n1]
        acc = stream.init(a, n1 - n0, tile=j, **opts)
        for w0, w1 in _stream_bounds(a.data.nw, wchunk):
            a_w = a.windows(w0, w1)
            acc = stream.step(a_w, b_t[w0 * k0:w0 * k0 + a_w.k], acc, tile=j,
                              **opts)
        stripes.append(stream.collect(a, acc, n1 - n0, tile=j, **opts))
    return stripes[0] if len(stripes) == 1 else torch.cat(stripes, dim=-1)


class _SpmmStreaming(torch.autograd.Function):
    """The streamed SpMM. Its backward walks the same 2-D grid chunk by
    chunk, so no step needs more than one tile-chunk of the slabs and of
    ``b``; each chunk's ``d values`` is masked by its own ``nse``, tiles
    give disjoint columns of ``d b`` and sum into ``d values``."""

    @staticmethod
    def forward(ctx, name, opts, wchunk, ntile, a, values, b, c, alpha,
                beta):
        a = a.with_values(values)
        raw = _stream_raw(_bk.get_backend(name).stream, opts, wchunk, ntile,
                          a, b)
        ctx.a, ctx.grid = a, (wchunk, ntile)
        ctx.save_for_backward(values, b, c, alpha, beta, raw)
        return _bk.stream_finish(raw, c, alpha, beta, b.dtype)

    @staticmethod
    def backward(ctx, g):
        values, b, c, alpha, beta, raw = ctx.saved_tensors
        a = ctx.a.with_values(values)
        wchunk, ntile = ctx.grid
        need_vals, need_b = ctx.needs_input_grad[5:7]
        g32 = g.float()
        ct_full = _cotangent(g32, alpha, b)
        k0 = a.data.k0
        dvals = (torch.zeros(values.shape, dtype=torch.float32,
                             device=g.device) if need_vals else None)
        db = (torch.zeros(b.shape, dtype=torch.float32, device=g.device)
              if need_b else None)
        if need_vals or need_b:
            for n0, n1 in _tile_bounds(b.shape[1], ntile):
                for w0, w1 in _stream_bounds(a.data.nw, wchunk):
                    a_w = a.windows(w0, w1)
                    r0, r1 = w0 * k0, w0 * k0 + a_w.k
                    dv, db_w = _flat_vjp(a_w, b[r0:r1, n0:n1],
                                         ct_full[:, n0:n1], need_vals, need_b)
                    if need_vals:
                        dvals[:, w0:w1] += dv
                    if need_b:
                        db[r0:r1, n0:n1] = db_w
        dc, dalpha, dbeta = _epilogue_grads(ctx, g32, raw, c, alpha, beta)
        return (None, None, None, None, None,
                None if dvals is None else dvals.to(values.dtype),
                None if db is None else db.to(b.dtype), dc, dalpha, dbeta)


def spmm_streaming(
    a: SparseTensor,
    b,
    c=None,
    alpha=1.0,
    beta=0.0,
    *,
    window_chunk: int = 1,
    n_tile: Optional[int] = None,
    backend: str = "auto",
    **opts,
) -> torch.Tensor:
    """``alpha * A @ b + beta * c`` executed as a 2-D (K-window x N-tile)
    stream, differentiable: the twin of ``StreamingPlan`` for training.

    A is consumed ``window_chunk`` K0-windows at a time against a carried
    f32 accumulator, per column tile of ``n_tile`` columns of ``b``
    (default: all of them), with the epilogue applied once per tile at the
    end of its window walk. The result is bit-identical to :func:`spmm` on
    the same backend for every (window_chunk, n_tile). The backward walks
    the same grid chunk by chunk.

    A, ``b`` and the saved residuals stay whole on A's device; for a
    matrix that does not fit there, use ``plan(..., device_bytes=)``. The
    backend must have streaming hooks (every built-in one has).
    """
    if not isinstance(a, SparseTensor):
        raise TypeError(
            f"spmm_streaming expects a SparseTensor, got {type(a).__name__}")
    dev = a.device
    b = as_dense(b, dev)
    m, k = a.shape
    if b.dim() != 2:
        raise ValueError(f"b must be 2-D (K, N), got shape {tuple(b.shape)}")
    if b.shape[0] != k:
        raise ValueError(f"B rows {b.shape[0]} != A cols {k}")
    wchunk = int(window_chunk)
    if not 1 <= wchunk <= a.data.nw:
        raise ValueError(
            f"window_chunk must be in [1, NW={a.data.nw}], got {wchunk}")
    ntile = b.shape[1] if n_tile is None else int(n_tile)
    if not 1 <= ntile <= b.shape[1]:
        raise ValueError(
            f"n_tile must be in [1, N={b.shape[1]}], got {ntile}")
    cshape = (m, b.shape[1])
    c_ = (torch.zeros(cshape, dtype=b.dtype, device=dev) if c is None
          else as_dense(c, dev))
    if tuple(c_.shape) != cshape:
        raise ValueError(f"c must have shape {cshape}, got {tuple(c_.shape)}")
    name = _bk.resolve_backend(backend, a, b)
    if _bk.get_backend(name).stream is None:
        raise ValueError(f"backend {name!r} has no streaming hooks")
    return _SpmmStreaming.apply(name, opts, wchunk, ntile, a, a.values, b, c_,
                                _coefficient(alpha, dev),
                                _coefficient(beta, dev))
