"""SpMM backend registry: execution strategies for a SparseTensor.

A *backend* is a callable ``fn(A, b, c, alpha, beta, **opts) -> Tensor``
computing ``alpha * A @ b + beta * c`` on A's device, where ``alpha`` and
``beta`` are 0-d float32 tensors on that device (so sweeping them never
syncs the host). Backends declare the :class:`Format` s they support and
are registered by name:

* ``cuda``       — the Sextans SpMM kernel (``csrc/sextans_spmm.cu``);
                   the reference's ``pallas``.
* ``spmv``       — the skinny-N Sextans kernel (``csrc/sextans_spmv.cu``)
                   for N <= :func:`skinny_n_max`; the reference's ``spmv``.
* ``torch``      — flat gather / ordered scatter-add over the slab slots;
                   the reference's ``jnp``.
* ``spmv_torch`` — the flat path under the skinny lane's name; the
                   reference's ``spmv_jnp``.
* ``auto``       — resolves to one of the above from A's device, density
                   and the dense width N (override with
                   :func:`set_auto_policy`).

On a CPU tensor the kernel backends run their kernels' plain versions.
Every built-in backend also carries out-of-core streaming hooks
(:class:`StreamOps`), which ``spmm_streaming`` and ``StreamingPlan`` walk.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, FrozenSet, List, Optional

import torch

from repro_torch.core.partition import cdiv
from repro_torch.kernels.ref import spmm_coo_ref
from repro_torch.kernels.sextans_spmm import sextans_spmm_cuda
from repro_torch.kernels.spmv_vector import sextans_spmv_cuda

from .tensor import Format, SparseTensor

__all__ = [
    "Backend",
    "StreamOps",
    "stream_finish",
    "register_backend",
    "get_backend",
    "list_backends",
    "resolve_backend",
    "set_auto_policy",
    "SKINNY_N_MAX",
    "skinny_n_max",
]

# Default skinny-N routing width: HFLEX requests with N at or below it go
# to the SpMV lane ("spmv" on the card, its flat twin elsewhere).
SKINNY_N_MAX = 8

def skinny_n_max() -> int:
    """The auto policy's skinny-N routing threshold:
    ``$SEXTANS_SKINNY_N_MAX`` if set to an integer, else ``SKINNY_N_MAX``.
    ``0`` turns the skinny lane off."""
    env = os.environ.get("SEXTANS_SKINNY_N_MAX")
    if env:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return SKINNY_N_MAX


@dataclasses.dataclass(frozen=True)
class StreamOps:
    """Out-of-core K0-window streaming hooks of a backend.

    A streamed run carries a raw f32 accumulator in the backend's layout
    across window-chunk steps and applies the alpha/beta epilogue once at
    the end. That is the only split that keeps every output element's add
    sequence that of the resident run, so the result is bit-identical:

    * ``init(a, n, *, device=None, **opts) -> acc``: a zero accumulator
      for a dense width ``n`` on ``device`` (A's device by default), f32,
      in the backend's layout: logical ``(M, n)`` for ``torch``, padded and
      row-interleaved kernel layout for ``cuda``/``spmv``.
    * ``step(a_chunk, b_chunk, acc, **opts) -> acc``: add one window
      chunk (``a_chunk = a.windows(w0, w1)`` or a staged chunk of the
      same form, ``b_chunk`` the matching rows of ``b``) onto ``acc``, in
      place.
    * ``collect(a, acc, n, **opts) -> raw``: the accumulator as the
      logical ``(M, n)`` f32 tensor.

    2-D (K-window x N-tile) streaming calls each hook once per column
    tile, with ``n`` the tile's width; ``spmm_streaming`` also passes the
    tile's index as ``tile=``, which hooks may ignore. The epilogue is
    shared (:func:`stream_finish`).
    """

    init: Callable
    step: Callable
    collect: Callable


def stream_finish(raw, c, alpha, beta, dtype):
    """The streaming epilogue on the collected raw accumulator, rounded as
    the resident paths' epilogues round: ``alpha * raw`` and ``beta * c``
    each rounded, then their sum, cast to ``dtype`` (b's dtype)."""
    return (alpha * raw + beta * c.float()).to(dtype)


@dataclasses.dataclass(frozen=True)
class Backend:
    name: str
    fn: Callable
    formats: FrozenSet[Format]
    description: str = ""
    stream: Optional[StreamOps] = None


_REGISTRY: Dict[str, Backend] = {}


def register_backend(
    name: str,
    fn: Callable,
    formats=(Format.HFLEX,),
    description: str = "",
    overwrite: bool = False,
    stream: Optional[StreamOps] = None,
) -> Backend:
    """Register an SpMM execution strategy under ``name``:
    ``fn(A: SparseTensor, b, c, alpha, beta, **opts) -> Tensor``.
    ``stream`` optionally provides the out-of-core streaming hooks
    (:class:`StreamOps`); backends without them reject streaming."""
    if name == "auto":
        raise ValueError("'auto' is reserved; use set_auto_policy to change "
                         "auto dispatch")
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} already registered "
                         f"(pass overwrite=True to replace)")
    be = Backend(name=name, fn=fn, formats=frozenset(formats),
                 description=description, stream=stream)
    _REGISTRY[name] = be
    return be


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def list_backends() -> List[str]:
    return sorted(_REGISTRY)


def _operand_width(b) -> Optional[int]:
    """Trailing (column) width of a dense operand, or None when unknowable;
    a 1-D ``b`` (the ``A @ v`` path) counts as width 1."""
    shape = getattr(b, "shape", None)
    if shape is None or len(shape) == 0:
        return None
    return 1 if len(shape) == 1 else int(shape[-1])


def _default_auto_policy(a: SparseTensor, b, platform: Optional[str] = None
                         ) -> str:
    """Pick a backend from the platform (A's device type unless given),
    density and dense width N — the reference's policy with ``cuda`` in the
    place of ``tpu``:

    * HFLEX requests with N <= :func:`skinny_n_max` take the skinny lane,
      ``spmv`` on the card and its flat twin elsewhere, unless on the card
      density already rules the slab format out (below);
    * off the card the flat ``torch`` path is the production one;
    * dense-ish matrices (density > 0.25) blow up slab padding, so they go
      to the flat path too.
    """
    platform = platform or a.device.type
    n = _operand_width(b)
    if (a.format is Format.HFLEX and n is not None and n <= skinny_n_max()
            and not (platform == "cuda" and a.density > 0.25)):
        return "spmv" if platform == "cuda" else "spmv_torch"
    if platform != "cuda":
        return "torch"
    if a.density > 0.25:
        return "torch"
    return "cuda"


_AUTO_POLICY = _default_auto_policy


def set_auto_policy(policy: Optional[Callable]) -> None:
    """Replace the ``auto`` dispatch heuristic (None restores the default).
    ``policy(a, b, platform=None) -> name`` must tolerate ``b=None``."""
    global _AUTO_POLICY
    _AUTO_POLICY = policy or _default_auto_policy


def resolve_backend(name: str, a: SparseTensor, b=None,
                    platform: Optional[str] = None,
                    n: Optional[int] = None) -> str:
    """Resolve a requested backend name ('auto' included) for tensor ``a``,
    validating format support. When only the dense width is known, pass
    ``n=``; a shape-only stand-in for ``b`` is then given to the policy."""
    if name == "auto":
        if b is None and n is not None:
            b = torch.empty((a.shape[1], int(n)), device="meta")
        name = _AUTO_POLICY(a, b, platform)
    be = get_backend(name)
    if a.format not in be.formats:
        raise ValueError(
            f"backend {name!r} does not support format {a.format}; "
            f"supported: {sorted(f.value for f in be.formats)}")
    return name


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------


def _permute_rows_fwd(x: torch.Tensor, mb: int, tm: int) -> torch.Tensor:
    """true-row layout -> interleaved block layout (r -> (r%mb)*tm + r//mb)
    on the trailing (rows, n) axes."""
    lead, n = x.shape[:-2], x.shape[-1]
    x = x.reshape(*lead, tm, mb, n)
    return x.transpose(-3, -2).reshape(*lead, mb * tm, n)


def _permute_rows_inv(x: torch.Tensor, mb: int, tm: int) -> torch.Tensor:
    lead, n = x.shape[:-2], x.shape[-1]
    x = x.reshape(*lead, mb, tm, n)
    return x.transpose(-3, -2).reshape(*lead, tm * mb, n)


def _hflex_global_ids(d):
    """The live slab slots (position < ``nse``) and their global (row, col).

    Returns ``(live, rows_g, cols_g)``: ``live`` is the (MB, NW, LW) mask,
    and ``rows_g``/``cols_g`` are int64 ids of the live slots in slab
    order, so ``d.vals[live]`` lines up with them. Padding slots are never
    gathered: on power-law matrices they are almost all of the slab.
    """
    mb, nw, lw = d.vals.shape
    dev = d.vals.device
    live = torch.arange(lw, device=dev) < d.nse[..., None]
    bi = torch.arange(mb, device=dev).view(mb, 1, 1).expand_as(live)[live]
    wi = torch.arange(nw, device=dev).view(1, nw, 1).expand_as(live)[live]
    rows = d.rows[live].long()
    if d.interleaved:
        rows_g = rows * mb + bi            # undo the block interleave
    else:
        rows_g = bi * d.tm + rows
    cols_g = d.cols[live].long() + wi * d.k0
    return live, rows_g, cols_g


def _hflex_flat_exec(vals, cols_g, rows_g, b, c, alpha, beta, m):
    """The flat SpMM body: one gather, one ordered scatter-add (the same
    order on every run, on the card too), fused epilogue."""
    return spmm_coo_ref(rows_g, cols_g, vals, b, c, m, alpha, beta)


def _padded_operands(d, b, c, width: int):
    """b padded to (NW*K0, width) and c to (MB*TM, width) as f32, in the
    slabs' row layout: the operands the kernels take."""
    n = b.shape[-1]
    bp = torch.zeros((d.nw * d.k0, width), dtype=b.dtype, device=b.device)
    bp[:d.k, :n] = b
    cp = torch.zeros((d.mb * d.tm, width), dtype=torch.float32,
                     device=b.device)
    cp[:d.m, :n] = c
    if d.interleaved:
        cp = _permute_rows_fwd(cp, d.mb, d.tm)
    return bp, cp


def _slab_kernel(kernel, a: SparseTensor, b, c, alpha, beta, width: int,
                 **kw):
    """Launch a Sextans kernel on b and c padded to ``width`` columns, then
    undo the padding and the row interleave."""
    d = a.data
    bp, cp = _padded_operands(d, b, c, width)
    out = kernel(d.vals, d.cols, d.rows, d.q, bp, cp,
                 torch.stack([alpha, beta]), tm=d.tm, k0=d.k0, **kw)
    if d.interleaved:
        out = _permute_rows_inv(out, d.mb, d.tm)
    return out[:d.m, :b.shape[-1]]


def _backend_cuda(a, b, c, alpha, beta, *, tn=128, **_unused):
    return _slab_kernel(sextans_spmm_cuda, a, b, c, alpha, beta,
                        cdiv(b.shape[-1], tn) * tn, tn=tn)


def _backend_spmv(a, b, c, alpha, beta, *, nv=8, **_unused):
    """Skinny-N lane: the dense operands are padded to a multiple of ``nv``
    columns, not to the tall kernel's TN."""
    return _slab_kernel(sextans_spmv_cuda, a, b, c, alpha, beta,
                        cdiv(b.shape[-1], nv) * nv)


def _backend_torch(a, b, c, alpha, beta, **_unused):
    d = a.data
    live, rows_g, cols_g = _hflex_global_ids(d)
    return _hflex_flat_exec(d.vals[live], cols_g, rows_g, b, c, alpha, beta,
                            d.m)


# -- out-of-core streaming hooks (K0-window chunk accumulation) -------------


def _hflex_torch_stream_init(a, n: int, *, device=None, **_unused):
    return torch.zeros((a.shape[0], n), dtype=torch.float32,
                       device=device or a.device)


def _hflex_torch_stream_step(a_chunk, b_chunk, acc, **_unused):
    """Add one window chunk's live slots onto the carried ``(M, N)`` acc
    with the flat path's ordered scatter-add, in slot order, so a chain of
    chunks adds exactly what the resident path adds. Only slots below the
    chunk's ``nse`` are gathered: the inert tail windows a streaming plan
    pads with (``nse`` = 0, rows past ``MB*TM``) contribute nothing, where
    the reference drops their out-of-range rows in its scatter."""
    d = a_chunk.data
    live, rows_g, cols_g = _hflex_global_ids(d)
    return spmm_coo_ref(rows_g, cols_g, d.vals[live], b_chunk, None,
                        acc.shape[0], acc=acc)


def _hflex_torch_stream_collect(a, acc, n: int, **_unused):
    return acc


def _kernel_stream_init(a, width: int, device):
    d = a.data
    return torch.zeros((d.mb * d.tm, width), dtype=torch.float32,
                       device=device or a.device)


def _kernel_stream_step(kernel, a_chunk, b_chunk, acc, **kw):
    """One accumulate-mode launch over the chunk's windows: ``b_chunk``
    padded to the chunk's ``NW*K0`` rows and the acc's width, the carried
    acc in kernel layout (padded rows, row interleave) updated in place."""
    d = a_chunk.data
    shape = (d.nw * d.k0, acc.shape[-1])
    if tuple(b_chunk.shape) == shape and b_chunk.is_contiguous():
        bp = b_chunk
    else:
        bp = torch.zeros(shape, dtype=b_chunk.dtype, device=b_chunk.device)
        bp[:b_chunk.shape[0], :b_chunk.shape[1]] = b_chunk
    slabs = (d.vals.contiguous(), d.cols.contiguous(), d.rows.contiguous(),
             d.q.contiguous())
    return kernel(*slabs, bp, acc, tm=d.tm, k0=d.k0, accumulate=True, **kw)


def _kernel_stream_collect(a, acc, n: int, **_unused):
    d = a.data
    if d.interleaved:
        acc = _permute_rows_inv(acc, d.mb, d.tm)
    return acc[:a.shape[0], :n]


def _hflex_cuda_stream_init(a, n: int, *, tn=128, device=None, **_unused):
    return _kernel_stream_init(a, cdiv(n, tn) * tn, device)


def _hflex_cuda_stream_step(a_chunk, b_chunk, acc, *, tn=128, **_unused):
    return _kernel_stream_step(sextans_spmm_cuda, a_chunk, b_chunk, acc,
                               tn=tn)


def _hflex_spmv_stream_init(a, n: int, *, nv=8, device=None, **_unused):
    return _kernel_stream_init(a, cdiv(n, nv) * nv, device)


def _hflex_spmv_stream_step(a_chunk, b_chunk, acc, **_unused):
    return _kernel_stream_step(sextans_spmv_cuda, a_chunk, b_chunk, acc)


_TORCH_STREAM = StreamOps(init=_hflex_torch_stream_init,
                          step=_hflex_torch_stream_step,
                          collect=_hflex_torch_stream_collect)
_CUDA_STREAM = StreamOps(init=_hflex_cuda_stream_init,
                         step=_hflex_cuda_stream_step,
                         collect=_kernel_stream_collect)
_SPMV_STREAM = StreamOps(init=_hflex_spmv_stream_init,
                         step=_hflex_spmv_stream_step,
                         collect=_kernel_stream_collect)


register_backend(
    "cuda", _backend_cuda,
    description="Sextans SpMM kernel (CUDA, sm_90a)",
    stream=_CUDA_STREAM)
register_backend(
    "spmv", _backend_spmv,
    description="skinny-N Sextans kernel (CUDA, sm_90a)",
    stream=_SPMV_STREAM)
register_backend(
    "torch", _backend_torch,
    description="flat gather / ordered scatter-add (CPU path and reference)",
    stream=_TORCH_STREAM)
register_backend(
    "spmv_torch", _backend_torch,
    description="skinny-N lane, flat twin (the same function as 'torch')",
    stream=_TORCH_STREAM)
