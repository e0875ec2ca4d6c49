"""Sextans SpMM on HFlex slabs: the CUDA kernel's wrapper and its plain
PyTorch version.

``sextans_spmm_cuda`` launches ``csrc/sextans_spmm.cu``, the Hopper port of
the TPU kernel ``repro/kernels/sextans_spmm.py:sextans_spmm_pallas`` (one
matrix, row gather). Both take the same padded operands: slabs
``(MB, NW, LW)``, trip counts ``q`` ``(MB, NW)``, ``b`` ``(NW*K0, NPAD)``
with ``NPAD`` a multiple of ``tn``, ``c_in`` ``(MB*TM, NPAD)`` in the
slabs' row layout, and ``ab = [alpha, beta]`` as an f32 tensor, so that
sweeping the epilogue never syncs the host. The result has b's dtype.

``accumulate=True`` is the out-of-core stream step: ``c_in`` is the
carried f32 accumulator, the slots are added onto it **in place** (the
counterpart of the reference's donated accumulator), and it is returned
raw, f32 whatever b's dtype, with no epilogue; ``ab`` is not read and may
be ``None``. A chain of such calls over consecutive window chunks adds
exactly what one resident call adds.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import spmm_slabs_ref

__all__ = ["LAUNCHES", "ACCUMULATE_LAUNCHES", "sextans_spmm_cuda",
           "sextans_spmm_torch"]

#: Resident-mode kernel launches made by :func:`sextans_spmm_cuda` in this
#: process.
LAUNCHES = 0
#: Accumulate-mode (stream step) kernel launches.
ACCUMULATE_LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCTIONS = {
    "sextans_spmm_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
}
_SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
_STAGE_SLOTS = 512            # kStage of csrc/sextans_spmm.cu
_B_DTYPES = (torch.float32, torch.bfloat16)


def sextans_spmm_torch(vals, cols, rows, q, b, c_in, ab=None, *, tm: int,
                       k0: int, tn: int = 128, accumulate: bool = False):
    """Plain PyTorch version of the kernel on the same operands: fp32, over
    the slab slots below ``q``; with ``accumulate``, onto ``c_in`` in
    place."""
    _check(vals, cols, rows, q, b, c_in, ab, tm=tm, k0=k0, tn=tn,
           accumulate=accumulate)
    alpha, beta = (None, None) if accumulate else (ab[0], ab[1])
    return spmm_slabs_ref(vals, cols, rows, q, b, c_in, k0, tm, alpha, beta,
                          below_q=True, accumulate=accumulate)


def _check(vals, cols, rows, q, b, c_in, ab, *, tm, k0, tn, accumulate):
    if vals.dim() != 3:
        raise ValueError(f"vals must be (MB, NW, LW), got {tuple(vals.shape)}")
    mb, nw, lw = vals.shape
    if cols.shape != vals.shape or rows.shape != vals.shape:
        raise ValueError("vals, cols and rows must share one (MB, NW, LW) shape")
    if tuple(q.shape) != (mb, nw):
        raise ValueError(f"q must be ({mb}, {nw}), got {tuple(q.shape)}")
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    for nm, x in (("cols", cols), ("rows", rows), ("q", q)):
        if x.dtype != torch.int32:
            raise TypeError(f"{nm} must be int32, got {x.dtype}")
    if b.dtype not in _B_DTYPES:
        raise TypeError(f"b must be float32 or bfloat16, got {b.dtype}")
    if b.dim() != 2 or b.shape[0] != nw * k0:
        raise ValueError(f"b must be (NW*K0={nw * k0}, NPAD), got "
                         f"{tuple(b.shape)}")
    if tn < 1 or b.shape[1] % tn:
        raise ValueError(f"b's width {b.shape[1]} is not a multiple of tn={tn}")
    if c_in.dtype != torch.float32:
        raise TypeError(f"c_in must be float32, got {c_in.dtype}")
    if tuple(c_in.shape) != (mb * tm, b.shape[1]):
        raise ValueError(f"c_in must be ({mb * tm}, {b.shape[1]}), got "
                         f"{tuple(c_in.shape)}")
    if accumulate:
        return
    if ab is None or ab.dtype != torch.float32 or tuple(ab.shape) != (2,):
        raise ValueError("ab must be a float32 tensor [alpha, beta]")


def _check_cuda(tensors, device):
    for x in tensors:
        if x.device != device:
            raise ValueError(f"all operands must lie on {device}, one is on "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError("operands must be contiguous")


def sextans_spmm_cuda(vals, cols, rows, q, b, c_in, ab=None, *, tm: int,
                      k0: int, tn: int = 128, accumulate: bool = False):
    """Launch the Sextans SpMM kernel (see the module docstring for the
    operands and ``accumulate``). CPU tensors take
    :func:`sextans_spmm_torch`."""
    global LAUNCHES, ACCUMULATE_LAUNCHES
    if vals.device.type == "cpu":
        return sextans_spmm_torch(vals, cols, rows, q, b, c_in, ab, tm=tm,
                                  k0=k0, tn=tn, accumulate=accumulate)
    if vals.device.type != "cuda":
        raise ValueError(f"no Sextans kernel for device {vals.device}")
    _check(vals, cols, rows, q, b, c_in, ab, tm=tm, k0=k0, tn=tn,
           accumulate=accumulate)
    ops = (vals, cols, rows, q, b, c_in) + (() if accumulate else (ab,))
    _check_cuda(ops, vals.device)
    if not 1 <= tn <= 1024:
        raise ValueError(f"tn={tn} threads per block is outside [1, 1024]")
    # The fp32 accumulator tile plus the staged slots (val, col, row).
    smem = tm * tn * 4 + _STAGE_SLOTS * 12
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a {tm}x{tn} fp32 tile needs {smem} bytes of shared "
                         f"memory, more than the {_SMEM_LIMIT} a block has")
    lib = _build.load("sextans_spmm", _FUNCTIONS)
    mb, nw, lw = vals.shape
    npad = b.shape[1]
    out = (c_in if accumulate else
           torch.empty((mb * tm, npad), dtype=b.dtype, device=b.device))
    if out.numel() == 0:
        return out
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        # Accumulating, the kernel seeds from out and writes it in place;
        # it reads neither c_in nor ab.
        err = lib.sextans_spmm_launch(
            *(x.data_ptr() for x in ops[:5]),
            *((None, None) if accumulate else (c_in.data_ptr(),
                                               ab.data_ptr())),
            out.data_ptr(),
            mb, nw, lw, tm, k0, npad, tn, int(b.dtype == torch.bfloat16),
            int(accumulate), stream)
    if err:
        raise RuntimeError(f"sextans_spmm launch failed: CUDA error {err}")
    if accumulate:
        ACCUMULATE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
