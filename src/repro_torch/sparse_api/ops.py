"""The SpMM entry point, forward only.

``spmm(A, b, c=None, alpha=1.0, beta=0.0, backend="auto")`` computes
``alpha * A @ b + beta * c`` on the device A lies on, through the backend
registry. ``b`` and ``c`` are moved to that device. ``alpha`` and ``beta``
reach the kernels as a device buffer, so sweeping them never syncs the
host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import backends as _bk
from .tensor import SparseTensor

__all__ = ["spmm", "spmm_raw"]


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


def spmm_raw(backend_name: str, a: SparseTensor, b, c, alpha, beta, **opts):
    """Dispatch core without the input checks: ``b`` and ``c`` are dense
    tensors on A's device, and ``alpha``/``beta`` scalars."""
    dev = a.device
    return _bk.get_backend(backend_name).fn(
        a, b, c, _coefficient(alpha, dev), _coefficient(beta, dev), **opts)


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

    The result has b's dtype and lies on A's device.
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
    return _bk.get_backend(name).fn(a, b, c_, alpha_, beta_, **opts)
