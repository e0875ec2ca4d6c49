"""Sparse tensors on the card: the HFLEX half of ``repro/sparse_api/tensor.py``.

``SparseTensor`` wraps the paper's HFlex slab packing (:class:`PackedSpMM`):
per-(TM-row-block, K0-window) non-zero slabs plus the pointer matrix ``q``
that gives each slab's trip count. It executes through
:func:`repro_torch.sparse_api.spmm` (``C = alpha * A @ B + beta * C``),
dispatched through the backend registry.

Packing runs on the host (numpy); the packed payload then lies on the
device the caller names, ``"cuda"`` unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.hflex import pack_block_slabs
from repro_torch.core.partition import cdiv
from repro_torch.core.sparse import SparseMatrix
from repro_torch.core.sparse import from_dense as _coo_from_dense
from repro_torch.kernels.ref import ordered_scatter_add

__all__ = [
    "Format",
    "PackedSpMM",
    "SparseTensor",
    "pack_hflex",
    "from_sparse_matrix",
    "from_coo",
    "from_dense",
    "from_reference_arrays",
]

Device = Union[str, torch.device]

_SLAB_FIELDS = ("vals", "cols", "rows", "q", "nse")


class Format(enum.Enum):
    """Packed device format of a :class:`SparseTensor`."""

    HFLEX = "hflex"   # Sextans slab packing: unstructured sparsity


def _device(device: Device) -> torch.device:
    """The device to place a payload on; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to keep the "
            "packed tensor on the host")
    return dev


@dataclasses.dataclass(frozen=True)
class PackedSpMM:
    """HFlex-packed sparse matrix (slab format) as tensors on one device."""

    vals: torch.Tensor  # (MB, NW, LW) f32
    cols: torch.Tensor  # (MB, NW, LW) i32, window-local columns
    rows: torch.Tensor  # (MB, NW, LW) i32, block-local rows
    q: torch.Tensor     # (MB, NW) i32, chunk-ceiled counts (kernel trips)
    nse: torch.Tensor   # (MB, NW) i32, true counts
    m: int
    k: int
    tm: int
    k0: int
    chunk: int
    interleaved: bool
    nnz: int

    @property
    def mb(self) -> int:
        return self.vals.shape[-3]

    @property
    def nw(self) -> int:
        return self.vals.shape[-2]

    @property
    def lw(self) -> int:
        return self.vals.shape[-1]

    @property
    def geometry(self) -> Tuple[int, int, int]:
        return (self.mb, self.nw, self.lw)

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device: Device) -> "PackedSpMM":
        """The same payload on ``device``."""
        dev = _device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev) for f in _SLAB_FIELDS})


# ---------------------------------------------------------------------------
# Host-side packing
# ---------------------------------------------------------------------------


def _payload(arrays: Dict[str, np.ndarray], device: torch.device, **statics
             ) -> PackedSpMM:
    tensors = {f: torch.from_numpy(np.ascontiguousarray(arrays[f])).to(device)
               for f in _SLAB_FIELDS}
    return PackedSpMM(**tensors, **statics)


def pack_hflex(
    a: SparseMatrix,
    tm: int = 128,
    k0: int = 4096,
    chunk: int = 8,
    interleave: bool = True,
    bucket: bool = False,
    device: Device = "cuda",
) -> PackedSpMM:
    """Host preprocessing -> packed slab tensors on ``device``.
    ``bucket=True`` rounds LW up to a power of two, as the reference does
    so that matrices of similar density share one compiled kernel."""
    dev = _device(device)
    slabs = pack_block_slabs(a, tm=tm, k0=k0, chunk=chunk,
                             interleave=interleave, bucket=bucket)
    return _payload(
        dict(vals=slabs.vals, cols=slabs.cols, rows=slabs.rows, q=slabs.q,
             nse=slabs.nse),
        dev, m=slabs.m, k=slabs.k, tm=tm, k0=k0, chunk=chunk,
        interleaved=bool(slabs.interleaved), nnz=slabs.nnz)


# ---------------------------------------------------------------------------
# SparseTensor
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """Sparse matrix ``A`` of shape ``(M, K)`` in a packed device format.

    Execute ``C = alpha * A @ B + beta * C`` via
    :func:`repro_torch.sparse_api.spmm` or simply ``A @ B``; it runs on the
    device the payload lies on.
    """

    data: PackedSpMM
    format: Format
    shape: Tuple[int, int]

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return self.data.nnz

    @property
    def density(self) -> float:
        m, k = self.shape
        return self.nnz / float(max(m * k, 1))

    @property
    def geometry(self) -> Tuple:
        """Bucketable kernel geometry."""
        d = self.data
        return (*d.geometry, d.tm, d.k0, d.chunk, d.interleaved)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device: Device) -> "SparseTensor":
        return dataclasses.replace(self, data=self.data.to(device))

    @property
    def nbytes(self) -> int:
        """Total bytes of the packed payload (every payload tensor): what
        the out-of-core threshold of ``plan(..., device_bytes=)`` compares
        against a device-memory budget."""
        return int(sum(getattr(self.data, f).numel()
                       * getattr(self.data, f).element_size()
                       for f in _SLAB_FIELDS))

    @property
    def on_host(self) -> bool:
        """True when every payload tensor lies on the CPU, as
        ``device="cpu"`` packs it: a streaming plan reads such a payload
        window chunk by window chunk and never commits it whole."""
        return all(getattr(self.data, f).device.type == "cpu"
                   for f in _SLAB_FIELDS)

    def to_device(self, device: Device = "cuda") -> "SparseTensor":
        """The payload committed to ``device`` (one copy per tensor); the
        tensor itself when it lies there already."""
        dev = _device(device)
        if all(getattr(self.data, f).device == dev for f in _SLAB_FIELDS):
            return self
        return self.to(dev)

    # -- K0-window structure (out-of-core streaming) -------------------------

    @property
    def num_windows(self) -> int:
        """Number of K0 windows along K (the slab NW axis)."""
        return self.data.nw

    def windows(self, w0: int, w1: int) -> "SparseTensor":
        """The sub-matrix covering K0-windows ``[w0, w1)``.

        A view over the window axis: the ``(MB, w1-w0, LW)`` slabs with
        ``q``/``nse`` sliced along, logical shape
        ``(M, min(K, w1*K0) - w0*K0)``, i.e. column block
        ``[w0*K0, w1*K0)`` of ``A`` re-based to column 0. Slab ``cols`` are
        window-local, so ``A.windows(w0, w1) @ b[w0*K0 : w1*K0]`` is exactly
        those windows' contribution to ``A @ b``. The slab views are not
        contiguous. ``nnz`` is the slice's true count when ``nse`` lies on
        the CPU, and the parent's (an upper bound) on the card, where
        counting would wait for the device.
        """
        d = self.data
        w0, w1 = int(w0), int(w1)
        if not 0 <= w0 < w1 <= d.nw:
            raise ValueError(f"window slice [{w0}, {w1}) out of range for "
                             f"NW={d.nw}")
        nse_w = d.nse[:, w0:w1]
        nnz_w = int(nse_w.sum()) if nse_w.device.type == "cpu" else d.nnz
        k_w = min(self.k, w1 * d.k0) - w0 * d.k0
        data_w = dataclasses.replace(
            d, vals=d.vals[:, w0:w1], cols=d.cols[:, w0:w1],
            rows=d.rows[:, w0:w1], q=d.q[:, w0:w1], nse=nse_w, k=k_w,
            nnz=nnz_w)
        return dataclasses.replace(self, data=data_w, shape=(self.m, k_w))

    @property
    def values(self) -> torch.Tensor:
        """The non-zero payload (the vals slab)."""
        return self.data.vals

    def with_values(self, v: torch.Tensor) -> "SparseTensor":
        """Same sparsity structure, new non-zero values."""
        if tuple(v.shape) != tuple(self.data.vals.shape):
            raise ValueError(f"values must have shape "
                             f"{tuple(self.data.vals.shape)}, got "
                             f"{tuple(v.shape)}")
        return dataclasses.replace(
            self, data=dataclasses.replace(self.data, vals=v))

    def spmm(self, b, c=None, alpha=1.0, beta=0.0, *, backend: str = "auto",
             **opts) -> torch.Tensor:
        from .ops import spmm as _spmm

        return _spmm(self, b, c, alpha, beta, backend=backend, **opts)

    def __matmul__(self, b) -> torch.Tensor:
        from .ops import as_dense

        b = as_dense(b, self.device)
        if b.dim() == 1:
            return self.spmm(b[:, None])[:, 0]
        return self.spmm(b)

    def todense(self) -> torch.Tensor:
        """A as a dense (M, K) f32 tensor (oracle/debug path)."""
        from .backends import _hflex_global_ids

        live, rows_g, cols_g = _hflex_global_ids(self.data)
        m, k = self.shape
        out = torch.zeros(m * k, dtype=torch.float32, device=self.device)
        ordered_scatter_add(out, rows_g * k + cols_g,
                            self.data.vals[live].float())
        return out.view(m, k)


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def from_sparse_matrix(
    a: SparseMatrix,
    format: Format = Format.HFLEX,
    *,
    tm: int = 128,
    k0: int = 4096,
    chunk: int = 8,
    interleave: bool = True,
    bucket: bool = True,
    device: Device = "cuda",
) -> SparseTensor:
    """Pack a host COO :class:`SparseMatrix` into a SparseTensor on
    ``device``."""
    if format is not Format.HFLEX:
        raise ValueError(f"unsupported format {format}")
    packed = pack_hflex(a, tm=tm, k0=k0, chunk=chunk, interleave=interleave,
                        bucket=bucket, device=device)
    return SparseTensor(data=packed, format=Format.HFLEX, shape=a.shape)


def from_coo(
    shape: Tuple[int, int],
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    format: Format = Format.HFLEX,
    **kwargs,
) -> SparseTensor:
    """Build from raw COO triples (host arrays)."""
    sm = SparseMatrix(
        tuple(shape),
        np.asarray(row, np.int32),
        np.asarray(col, np.int32),
        np.asarray(val, np.float32),
    ).sorted_column_major()
    return from_sparse_matrix(sm, format=format, **kwargs)


def from_dense(a: np.ndarray, format: Format = Format.HFLEX, **kwargs
               ) -> SparseTensor:
    """Build from a dense (M, K) array; zeros are dropped."""
    a = np.asarray(a)
    if a.ndim != 2:
        raise ValueError("from_dense expects a 2-D matrix")
    return from_sparse_matrix(_coo_from_dense(a), format=format, **kwargs)


def from_reference_arrays(
    arrays: Dict[str, np.ndarray],
    *,
    m: int,
    k: int,
    tm: int,
    k0: int,
    chunk: int,
    interleaved: bool,
    nnz: int,
    device: Device = "cuda",
) -> SparseTensor:
    """A SparseTensor from the slab arrays of the JAX package's
    ``PackedSpMM`` (host numpy, as ``pack_hflex(device=False)`` leaves
    them): ``vals`` f32 and ``cols``/``rows`` i32 of shape (MB, NW, LW),
    ``q``/``nse`` i32 of shape (MB, NW)."""
    missing = [f for f in _SLAB_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"missing slab arrays: {missing}")
    arrs = {f: np.asarray(arrays[f]) for f in _SLAB_FIELDS}
    geom = (cdiv(m, tm), cdiv(k, k0))
    if arrs["vals"].ndim != 3 or arrs["vals"].shape[:2] != geom:
        raise ValueError(f"vals must be (MB, NW, LW) with (MB, NW) = {geom}, "
                         f"got {arrs['vals'].shape}")
    dtypes = dict(vals=np.float32, cols=np.int32, rows=np.int32, q=np.int32,
                  nse=np.int32)
    for f, dt in dtypes.items():
        want = arrs["vals"].shape if f in ("vals", "cols", "rows") else geom
        if arrs[f].shape != tuple(want):
            raise ValueError(f"{f} must have shape {tuple(want)}, got "
                             f"{arrs[f].shape}")
        if arrs[f].dtype != dt:
            raise TypeError(f"{f} must be {np.dtype(dt).name}, got "
                            f"{arrs[f].dtype}")
    packed = _payload(arrs, _device(device), m=m, k=k, tm=tm, k0=k0,
                      chunk=chunk, interleaved=bool(interleaved), nnz=int(nnz))
    return SparseTensor(data=packed, format=Format.HFLEX, shape=(m, k))
