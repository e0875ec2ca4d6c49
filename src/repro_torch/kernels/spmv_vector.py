"""Skinny-N Sextans lane: the CUDA kernel's wrapper and its plain PyTorch
version.

``sextans_spmv_cuda`` launches ``csrc/sextans_spmv.cu``, the Hopper port of
the TPU kernel ``repro/kernels/spmv_vector.py:sextans_spmv_pallas`` (one
matrix, row gather). The operands, and ``accumulate`` (the stream step,
adding onto the f32 ``c_in`` in place), are those of
:mod:`repro_torch.kernels.sextans_spmm` with the dense width ``NV`` in
place of ``NPAD``: ``b`` is ``(NW*K0, NV)`` and ``c_in`` ``(MB*TM, NV)``,
``NV`` a multiple of 8.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import spmm_slabs_ref
from .sextans_spmm import _check, _check_cuda

__all__ = ["LAUNCHES", "ACCUMULATE_LAUNCHES", "sextans_spmv_cuda",
           "sextans_spmv_torch"]

#: Resident-mode kernel launches made by :func:`sextans_spmv_cuda` in this
#: process.
LAUNCHES = 0
#: Accumulate-mode (stream step) kernel launches.
ACCUMULATE_LAUNCHES = 0

# The kernel handles the dense columns in groups of this many.
_NV_MULTIPLE = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCTIONS = {
    "sextans_spmv_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P),
}


def _check_spmv(vals, cols, rows, q, b, c_in, ab, *, tm, k0, accumulate):
    _check(vals, cols, rows, q, b, c_in, ab, tm=tm, k0=k0, tn=_NV_MULTIPLE,
           accumulate=accumulate)


def sextans_spmv_torch(vals, cols, rows, q, b, c_in, ab=None, *, tm: int,
                       k0: int, accumulate: bool = False):
    """Plain PyTorch version of the kernel on the same operands: fp32, over
    the slab slots below ``q``; with ``accumulate``, onto ``c_in`` in
    place."""
    _check_spmv(vals, cols, rows, q, b, c_in, ab, tm=tm, k0=k0,
                accumulate=accumulate)
    alpha, beta = (None, None) if accumulate else (ab[0], ab[1])
    return spmm_slabs_ref(vals, cols, rows, q, b, c_in, k0, tm, alpha, beta,
                          below_q=True, accumulate=accumulate)


def sextans_spmv_cuda(vals, cols, rows, q, b, c_in, ab=None, *, tm: int,
                      k0: int, accumulate: bool = False):
    """Launch the skinny-N Sextans kernel (see the module docstring for the
    operands and ``accumulate``). CPU tensors take
    :func:`sextans_spmv_torch`."""
    global LAUNCHES, ACCUMULATE_LAUNCHES
    if vals.device.type == "cpu":
        return sextans_spmv_torch(vals, cols, rows, q, b, c_in, ab, tm=tm,
                                  k0=k0, accumulate=accumulate)
    if vals.device.type != "cuda":
        raise ValueError(f"no Sextans kernel for device {vals.device}")
    _check_spmv(vals, cols, rows, q, b, c_in, ab, tm=tm, k0=k0,
                accumulate=accumulate)
    ops = (vals, cols, rows, q, b, c_in) + (() if accumulate else (ab,))
    _check_cuda(ops, vals.device)
    if not 1 <= tm <= 1024:
        raise ValueError(f"tm={tm}: the kernel runs one thread per block row, "
                         f"at most 1024")
    lib = _build.load("sextans_spmv", _FUNCTIONS)
    mb, nw, lw = vals.shape
    nv = b.shape[1]
    out = (c_in if accumulate else
           torch.empty((mb * tm, nv), dtype=b.dtype, device=b.device))
    if out.numel() == 0:
        return out
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        # Accumulating, the kernel seeds from out and writes it in place;
        # it reads neither c_in nor ab.
        err = lib.sextans_spmv_launch(
            *(x.data_ptr() for x in ops[:5]),
            *((None, None) if accumulate else (c_in.data_ptr(),
                                               ab.data_ptr())),
            out.data_ptr(),
            mb, nw, lw, tm, k0, nv, int(b.dtype == torch.bfloat16),
            int(accumulate), stream)
    if err:
        raise RuntimeError(f"sextans_spmv launch failed: CUDA error {err}")
    if accumulate:
        ACCUMULATE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
