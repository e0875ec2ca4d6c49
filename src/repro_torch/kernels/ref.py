"""Plain PyTorch oracles for the SpMM kernels, twins of
``repro/kernels/ref.py``.

Every sum is taken in fp32 and the result is cast to b's dtype. Every
scatter-add goes through :func:`ordered_scatter_add`, which adds in one
fixed order on every run, on the CPU and on the card.
"""

from __future__ import annotations

import torch

__all__ = ["ordered_scatter_add", "spmm_dense_ref", "spmm_coo_ref",
           "spmm_slabs_ref"]


def ordered_scatter_add(acc: torch.Tensor, index: torch.Tensor,
                        src: torch.Tensor) -> torch.Tensor:
    """``acc[index[i]] += src[i]`` in place, each row of ``acc`` summed in
    the order of ``i``, the same on every run.

    On the card ``index_put_(..., accumulate=True)`` sorts the indices
    stably and sums each run of equal indices in order, while
    ``index_add_`` uses float atomics. On the CPU it is the other way
    round: ``index_put_`` adds from several threads at once and
    ``index_add_`` walks ``index`` in order.
    """
    if acc.is_cuda:
        return acc.index_put_((index,), src, accumulate=True)
    return acc.index_add_(0, index, src)


def spmm_dense_ref(a_dense, b, c, alpha=1.0, beta=0.0):
    """C = alpha * A @ B + beta * C with fp32 accumulation."""
    acc = a_dense.float() @ b.float()
    return (alpha * acc + beta * c.float()).to(b.dtype)


def spmm_coo_ref(row, col, val, b, c, m, alpha=1.0, beta=0.0, *, acc=None):
    """COO SpMM: one gather, one ordered scatter-add over the rows, fused
    epilogue. ``alpha``/``beta`` may be floats or 0-d tensors. Every SpMM
    oracle, the flat path and its stream step end here.

    ``acc``, an f32 ``(m, N)`` starting accumulator, selects accumulate
    mode: the contributions are added onto it in place, in the same order
    as from zeros, and it is returned raw (no epilogue; ``c``, ``alpha``
    and ``beta`` are not read). A chain of such calls over consecutive
    parts of the slots adds exactly what one call over all of them adds.
    """
    contrib = val.float()[:, None] * b[col.long()].float()
    if acc is not None:
        return ordered_scatter_add(acc, row.long(), contrib)
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=b.device)
    ordered_scatter_add(acc, row.long(), contrib)
    return (alpha * acc + beta * c.float()).to(b.dtype)


def spmm_slabs_ref(vals, cols, rows, q, b, c_in, k0, tm, alpha=1.0, beta=0.0,
                   *, below_q=False, accumulate=False):
    """Oracle on the *packed slab format*: what the kernels must produce on
    their padded (and, if interleaved, row-permuted) operands.

    vals/cols/rows: (MB, NW, LW); q: (MB, NW); b: (NW*K0, N) padded;
    c_in: (MB*TM, N) padded. Every slot is summed (padding slots hold
    val == 0 and contribute nothing), or with ``below_q`` only the slots
    below ``q``, as the kernels walk them. With ``accumulate`` the f32
    ``c_in`` is the starting accumulator, updated in place and returned raw
    (see :func:`spmm_coo_ref`).
    """
    mb, nw, lw = vals.shape
    dev = vals.device
    if below_q:
        live = torch.arange(lw, device=dev) < q.clamp(max=lw)[..., None]
    else:
        live = torch.ones(vals.shape, dtype=torch.bool, device=dev)
    bi = torch.arange(mb, device=dev).view(mb, 1, 1).expand_as(live)[live]
    wi = torch.arange(nw, device=dev).view(1, nw, 1).expand_as(live)[live]
    return spmm_coo_ref(bi * tm + rows[live].long(),
                        wi * k0 + cols[live].long(), vals[live], b, c_in,
                        mb * tm, alpha, beta,
                        acc=c_in if accumulate else None)
