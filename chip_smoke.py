#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). Phases:

1. the card's name and power limit;
2. build both CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on small shapes (both
   row layouts, two epilogues, bf16 b, empty windows), and ``spmm`` on
   the card against the float64 numpy oracle;
4. the main path, ``from_sparse_matrix(device="cuda")`` + ``spmm(backend=
   "auto")``, on three cases at the benchmark suite's full size. Each case
   zeroes the launch counters, drives the path, reads the counters, checks
   the result against the flat PyTorch path and the kernel against its
   plain version, times kernel, plain version and the library SpMM, and
   prints one JSON line;
5. one JSON line for all kernels, then the card's name and power limit,
   then ``{"ok": true, "device": {...}}`` as the last line.

Any failure exits non-zero before the last line is printed.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
RTOL = 2e-4                 # the reference's kernel tolerance
BF16_TOL = 5e-2
PACK = dict(tm=128, k0=4096, chunk=8, bucket=True)
ALPHA, BETA = 1.0, 0.5

# NVIDIA H100 SXM data sheet: HBM bandwidth and fp32 rate outside the
# tensor cores, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SHAPE_SWEEP = [
    # (M, K, N, density, tm, k0, tn), as tests/test_kernels.py sweeps them
    (64, 64, 8, 0.3, 32, 32, 8),
    (128, 128, 16, 0.1, 128, 128, 16),
    (200, 300, 40, 0.05, 64, 128, 32),
    (513, 257, 17, 0.02, 128, 64, 128),
    (33, 1000, 100, 0.01, 32, 256, 64),
    (1000, 33, 7, 0.2, 128, 32, 8),
]

KERNELS = {
    "sextans_spmm": dict(source="src/repro_torch/csrc/sextans_spmm.cu",
                         replaces="src/repro/kernels/sextans_spmm.py:163",
                         backend="cuda"),
    "sextans_spmv": dict(source="src/repro_torch/csrc/sextans_spmv.cu",
                         replaces="src/repro/kernels/spmv_vector.py:137",
                         backend="spmv"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    line = out.strip().splitlines()[0].strip()
    check(line, "nvidia-smi printed no card")
    return line


def tolerance(ref: torch.Tensor, tol: float = RTOL) -> float:
    return tol * max(1.0, ref.float().abs().max().item())


def assert_close(got, want, what, tol=RTOL) -> float:
    got, want = got.float(), want.float()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > tolerance(want, tol) + tol * want.abs()
    check(not bool(bad.any()),
          f"{what}: max |err| {err.max().item():.3e} beyond tolerance")
    return err.max().item()


def time_ms(fn, reps=10, warmup=2) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events. A
    short device-side sleep before each start event keeps the host's
    enqueue time out of the measurement."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_call(name, mods):
    return (mods["spmm"].sextans_spmm_cuda if name == "sextans_spmm"
            else mods["spmv"].sextans_spmv_cuda)


def plain_call(name, mods):
    return (mods["spmm"].sextans_spmm_torch if name == "sextans_spmm"
            else mods["spmv"].sextans_spmv_torch)


def kernel_operands(A, b, c, width, alpha, beta, bk):
    d = A.data
    bp, cp = bk._padded_operands(d, b, c, width)
    ab = torch.tensor([alpha, beta], dtype=torch.float32, device=b.device)
    return (d.vals, d.cols, d.rows, d.q, bp, cp, ab)


def kernel_kwargs(name, A, tn):
    kw = dict(tm=A.data.tm, k0=A.data.k0)
    if name == "sextans_spmm":
        kw["tn"] = tn
    return kw


def phase_kernels_vs_plain(dev, mods):
    """Every kernel against its plain version on small shapes."""
    sp, tsparse, bk = mods["sp"], mods["sparse"], mods["backends"]
    rng = np.random.default_rng(SEED)
    cases = []
    for (m, k, n, d, tm, k0, tn) in SHAPE_SWEEP:
        a = tsparse.random_sparse(m, k, d, seed=m + k)
        for interleave in (True, False):
            for alpha, beta in ((1.0, 0.0), (0.5, 2.0)):
                cases.append((f"sweep{m}x{k}x{n}", a, n, tm, k0, tn,
                              interleave, alpha, beta, torch.float32))
        cases.append((f"sweep{m}x{k}x{n}-bf16", a, n, tm, k0, tn, True,
                      0.5, 2.0, torch.bfloat16))
    empty = tsparse.SparseMatrix(
        (64, 256), np.array([0, 1, 63], np.int32),
        np.array([0, 1, 255], np.int32),
        np.array([1.0, 2.0, 3.0], np.float32)).sorted_column_major()
    for dt in (torch.float32, torch.bfloat16):
        cases.append(("empty-windows", empty, 8, 32, 64, 8, True, 1.0, 0.5,
                      dt))
    worst = {name: 0.0 for name in KERNELS}
    for label, a, n, tm, k0, tn, interleave, alpha, beta, dt in cases:
        A = sp.from_sparse_matrix(a, tm=tm, k0=k0, interleave=interleave,
                                  device=dev)
        b = torch.from_numpy(rng.standard_normal(
            (a.shape[1], n)).astype(np.float32)).to(dev, dt)
        c = torch.from_numpy(rng.standard_normal(
            (a.shape[0], n)).astype(np.float32)).to(dev)
        tol = BF16_TOL if dt == torch.bfloat16 else RTOL
        for name in KERNELS:
            width = (-(-n // tn) * tn if name == "sextans_spmm"
                     else -(-n // 8) * 8)
            ops = kernel_operands(A, b, c, width, alpha, beta, bk)
            kw = kernel_kwargs(name, A, tn)
            got = kernel_call(name, mods)(*ops, **kw)
            again = kernel_call(name, mods)(*ops, **kw)
            want = plain_call(name, mods)(*ops, **kw)
            torch.cuda.synchronize()
            check(got.dtype == dt, f"{name} {label}: dtype {got.dtype}")
            check(torch.equal(got, again),
                  f"{name} {label}: two runs differ (add order not fixed)")
            err = assert_close(got, want, f"{name} {label}", tol)
            worst[name] = max(worst[name], err)
        if dt == torch.float32:
            for be in ("cuda", "spmv"):
                y = sp.spmm(A, b, c, alpha, beta, backend=be,
                            **({"tn": tn} if be == "cuda" else {}))
                ref = tsparse.spmm_reference(a, b.cpu().numpy(),
                                             c.cpu().numpy(), alpha, beta)
                assert_close(y.cpu(), torch.from_numpy(ref),
                             f"spmm[{be}] {label} vs numpy oracle")
    torch.cuda.synchronize()
    emit({"phase": "kernels_vs_plain", "comparisons": len(cases) * 2,
          "max_abs_err": worst})


def byte_flop_bound(A, n, b_itemsize, out_itemsize, beta):
    """The least time the card could take: the larger of the bytes that
    must move (each non-zero's value, column and row once; B, C and the
    output once) over the HBM rate and the SpMM's flops over the fp32
    rate. Chunk padding below ``q`` holds zeros an SpMM does not need, so
    the slot bytes count the non-zeros, not the slots the kernels walk."""
    m, k = A.shape
    nbytes = (12 * A.nnz + k * n * b_itemsize + (m * n * 4 if beta else 0)
              + m * n * out_itemsize)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = 2 * A.nnz * n / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def library_spmm(a, dev):
    """torch.sparse.mm on a CSR copy of A: the yardstick, timed only."""
    order = np.lexsort((a.col, a.row))
    crow = np.zeros(a.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(a.row, minlength=a.shape[0]), out=crow[1:])
    return torch.sparse_csr_tensor(
        torch.from_numpy(crow).to(dev),
        torch.from_numpy(a.col[order].astype(np.int64)).to(dev),
        torch.from_numpy(a.val[order]).to(dev), size=a.shape)


def run_case(label, a, A, n, expect, dev, mods):
    sp, bk = mods["sp"], mods["backends"]
    rng = np.random.default_rng(SEED)
    m, k = a.shape
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(dev)
    c = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(dev)
    name = next(nm for nm, kk in KERNELS.items() if kk["backend"] == expect)
    counter = mods["spmm"] if name == "sextans_spmm" else mods["spmv"]

    resolved = sp.resolve_backend("auto", A, b)
    check(resolved == expect, f"case {label}: auto resolved {resolved!r}, "
                              f"expected {expect!r}")
    torch.cuda.synchronize()
    mods["spmm"].LAUNCHES = 0
    mods["spmv"].LAUNCHES = 0
    y = sp.spmm(A, b, c, ALPHA, BETA, backend="auto")
    torch.cuda.synchronize()
    launches = {"sextans_spmm": mods["spmm"].LAUNCHES,
                "sextans_spmv": mods["spmv"].LAUNCHES}
    check(launches[name] >= 1,
          f"case {label}: the main path launched {name} {launches[name]} "
          f"times")

    check(tuple(y.shape) == (m, n) and y.device == b.device,
          f"case {label}: result {tuple(y.shape)} on {y.device}")
    flat = sp.spmm(A, b, c, ALPHA, BETA, backend="torch")
    assert_close(y, flat, f"case {label}: spmm[auto] vs flat path")
    check(torch.equal(flat, sp.spmm(A, b, c, ALPHA, BETA, backend="torch")),
          f"case {label}: two runs of the flat path differ")

    tn = 128
    width = -(-n // tn) * tn if name == "sextans_spmm" else -(-n // 8) * 8
    ops = kernel_operands(A, b, c, width, ALPHA, BETA, bk)
    kw = kernel_kwargs(name, A, tn)
    kern, plain = kernel_call(name, mods), plain_call(name, mods)
    got, want = kern(*ops, **kw), plain(*ops, **kw)
    torch.cuda.synchronize()
    err = assert_close(got, want, f"case {label}: {name} vs plain version")
    check(torch.equal(got, kern(*ops, **kw)),
          f"case {label}: two kernel runs differ")

    csr = library_spmm(a, dev)
    lib_y = torch.sparse.mm(csr, b)
    assert_close(ALPHA * lib_y + BETA * c, flat,
                 f"case {label}: torch.sparse.mm vs flat path")
    bound, bound_by = byte_flop_bound(A, n, 4, 4, BETA)
    block_slots = A.data.q.sum(dim=1)      # slots one row block walks
    row = dict(
        case=label, kernel=name, backend=resolved, m=m, k=k, nnz=a.nnz, n=n,
        slab_geometry=list(A.data.geometry),
        sum_q=int(A.data.q.sum().item()),
        block_slots_max=int(block_slots.max().item()),
        block_slots_mean=block_slots.float().mean().item(),
        row_nnz_max=int(np.bincount(a.row, minlength=m).max()),
        slab_bytes=sum(getattr(A.data, f).numel() * 4
                       for f in ("vals", "cols", "rows", "q", "nse")),
        launches=launches[name], max_abs_err=err,
        kernel_ms=time_ms(lambda: kern(*ops, **kw), reps=20),
        plain_ms=time_ms(lambda: plain(*ops, **kw)),
        library_ms=time_ms(lambda: torch.sparse.mm(csr, b)),
        e2e_ms=time_ms(lambda: sp.spmm(A, b, c, ALPHA, BETA)),
        bound_ms=bound, bound_by=bound_by)
    emit(row)
    return row


def phase_main_path(dev, mods):
    sp, tsparse = mods["sp"], mods["sparse"]
    t0 = time.perf_counter()
    snap = tsparse.power_law_sparse(120000, 120000, 5, seed=3)
    band = tsparse.banded_sparse(60000, 60000, 6, seed=12)
    t1 = time.perf_counter()
    A_snap = sp.from_sparse_matrix(snap, device=dev, **PACK)
    A_band = sp.from_sparse_matrix(band, device=dev, **PACK)
    torch.cuda.synchronize()
    emit({"phase": "pack", "generate_s": t1 - t0,
          "pack_and_copy_s": time.perf_counter() - t1})
    rows = [
        run_case("a:snap_pl_120000", snap, A_snap, 512, "cuda", dev, mods),
        run_case("b:ss_band_60000", band, A_band, 64, "cuda", dev, mods),
        run_case("c:snap_pl_120000", snap, A_snap, 8, "spmv", dev, mods),
    ]
    emit({"phase": "main_path",
          "peak_device_bytes": torch.cuda.max_memory_allocated()})
    return rows


def kernels_line(rows):
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        check(mine, f"no main-path case ran {name}")
        main = max(mine, key=lambda r: r["kernel_ms"])
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(r["launches"] for r in mine),
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main["kernel_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], case=main["case"]))
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout: src/repro_torch is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch.sparse_api as sp
    from repro_torch.core import sparse as tsparse
    from repro_torch.kernels import _build
    from repro_torch.kernels import sextans_spmm as kspmm
    from repro_torch.kernels import spmv_vector as kspmv
    from repro_torch.sparse_api import backends

    mods = dict(sp=sp, sparse=tsparse, spmm=kspmm, spmv=kspmv,
                backends=backends)
    dev = torch.device("cuda", 0)
    try:
        card = card_line()
        print(card, flush=True)
        emit({"phase": "device", "name": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda})
        t0 = time.perf_counter()
        report = _build.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "compiled": {k: v["compiled"] for k, v in report.items()}})
        for name, r in report.items():
            for line in r["log"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
        phase_kernels_vs_plain(dev, mods)
        rows = phase_main_path(dev, mods)
        emit(kernels_line(rows))
        print(card_line(), flush=True)
    except Exception:                      # noqa: BLE001 - report, then fail
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
