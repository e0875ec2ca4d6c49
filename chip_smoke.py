#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). Phases:

1. the card's name and power limit;
2. build both CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on small shapes (both
   row layouts, two epilogues, bf16 b, empty windows), and ``spmm`` on
   the card against the float64 numpy oracle; each kernel's accumulate
   mode against its plain version, a chain of accumulate launches over
   window chunks plus the streaming epilogue against one resident launch
   (bit for bit), and ``spmm``'s gradients on the card against the float64
   numpy oracle;
4. the main path, ``from_sparse_matrix(device="cuda")`` + ``spmm(backend=
   "auto")``, on three cases at the benchmark suite's full size. Each case
   zeroes the launch counters, drives the path, reads the counters, checks
   the result against the flat PyTorch path and the kernel against its
   plain version, times kernel, plain version and the library SpMM, and
   prints one JSON line;
5. the streaming path on the same matrix, packed on the host: cases (d)
   and (e) run ``plan(..., device_bytes=)`` on its own choice of tier (on
   the card either way; case (d)'s budget keeps it resident, and that
   plan runs too), then ``StreamingPlan.run``, each zeroing the counters
   first, and check every result bit for bit against the resident
   ``spmm`` with the same backend; they time the run and the two halves
   it composes, staging alone and compute alone, and print one JSON line
   each. Case
   (f) runs ``spmm_streaming`` forward (bit for bit against ``spmm``) and
   backward (gradients within tolerance of ``spmm``'s);
6. one JSON line for all kernels, then the card's name and power limit,
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

# Packing this host's payload takes a few seconds; each streamed run moves
# it over PCIe in window chunks, so the repetitions stay few.
STREAM_REPS = 5

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


def phase_accumulate_vs_plain(dev, mods):
    """Each kernel's accumulate mode against its plain version, and a chain
    of accumulate launches over window chunks, finished by the streaming
    epilogue, against one resident launch, bit for bit."""
    sp, tsparse, bk = mods["sp"], mods["sparse"], mods["backends"]
    rng = np.random.default_rng(SEED)
    worst = {name: 0.0 for name in KERNELS}
    chains = 0
    for (m, k, n, d, tm, k0, tn) in SHAPE_SWEEP:
        a = tsparse.random_sparse(m, k, d, seed=m + k)
        for interleave in (True, False):
            A = sp.from_sparse_matrix(a, tm=tm, k0=k0, interleave=interleave,
                                      device=dev)
            for dt in (torch.float32, torch.bfloat16):
                b = torch.from_numpy(rng.standard_normal(
                    (k, n)).astype(np.float32)).to(dev, dt)
                c = torch.from_numpy(rng.standard_normal(
                    (m, n)).astype(np.float32)).to(dev)
                tol = BF16_TOL if dt == torch.bfloat16 else RTOL
                label = (f"sweep{m}x{k}x{n} interleave={interleave} "
                         f"{str(dt)[6:]}")
                for name in KERNELS:
                    width = (-(-n // tn) * tn if name == "sextans_spmm"
                             else -(-n // 8) * 8)
                    vals, cols, rows, q, bp, cp, ab = kernel_operands(
                        A, b, c, width, 0.5, 2.0, bk)
                    kw = kernel_kwargs(name, A, tn)
                    kern, plain = kernel_call(name, mods), plain_call(name,
                                                                      mods)
                    acc0 = torch.from_numpy(rng.standard_normal(
                        tuple(cp.shape)).astype(np.float32)).to(dev)
                    slabs = (vals, cols, rows, q, bp)
                    got = kern(*slabs, acc0.clone(), accumulate=True, **kw)
                    want = plain(*slabs, acc0.clone(), accumulate=True, **kw)
                    torch.cuda.synchronize()
                    check(got.dtype == torch.float32,
                          f"{name} accumulate {label}: dtype {got.dtype}")
                    err = assert_close(got, want,
                                       f"{name} accumulate {label}", tol)
                    worst[name] = max(worst[name], err)
                    resident = kern(*slabs[:4], bp, cp, ab, **kw)
                    for wc in (1, 2):
                        acc = torch.zeros_like(cp)
                        for w0 in range(0, A.data.nw, wc):
                            w1 = min(A.data.nw, w0 + wc)
                            kern(*(x[:, w0:w1].contiguous()
                                   for x in slabs[:4]),
                                 bp[w0 * k0:w1 * k0], acc, accumulate=True,
                                 **kw)
                        fin = bk.stream_finish(acc, cp, ab[0], ab[1], dt)
                        torch.cuda.synchronize()
                        check(torch.equal(fin, resident),
                              f"{name} {label}: accumulate chain of "
                              f"{wc}-window chunks + epilogue differs from "
                              f"one resident launch")
                        chains += 1
    emit({"phase": "accumulate_vs_plain", "chains_bit_identical": chains,
          "max_abs_err": worst})


def phase_gradients(dev, mods):
    """``spmm``'s gradients on the card against the float64 numpy dense
    oracle at a small size, through both kernels."""
    sp, tsparse, bk = mods["sp"], mods["sparse"], mods["backends"]
    a = tsparse.power_law_sparse(300, 500, 6, seed=2)
    dense = tsparse.to_dense(a).astype(np.float64)
    worst = 0.0
    for be, n in (("cuda", 20), ("spmv", 5)):
        rng = np.random.default_rng(SEED)
        b, c, w = (rng.standard_normal(s) for s in ((500, n), (300, n),
                                                     (300, n)))
        A = sp.from_sparse_matrix(a, tm=64, k0=64, device=dev)
        v = A.values.detach().clone().requires_grad_()
        leaves = [torch.tensor(x, dtype=torch.float32, device=dev,
                               requires_grad=True)
                  for x in (b, c, ALPHA, BETA)]
        w_d = torch.tensor(w, dtype=torch.float32, device=dev)
        y = sp.spmm(A.with_values(v), *leaves, backend=be)
        first = torch.autograd.grad((y * w_d).sum(), [v, *leaves])
        y = sp.spmm(A.with_values(v), *leaves, backend=be)
        (y * w_d).sum().backward()
        check(all(torch.equal(g, x.grad) for g, x in zip(first, [v, *leaves])),
              f"spmm[{be}]: two backward runs differ")
        bq = leaves[0].detach().double().cpu().numpy()   # b as f32 held it
        d_dense = ALPHA * w @ bq.T
        live, rows_g, cols_g = bk._hflex_global_ids(A.data)
        want = dict(
            values=d_dense[rows_g.cpu().numpy(), cols_g.cpu().numpy()],
            b=ALPHA * dense.T @ w, c=BETA * w,
            alpha=np.sum(w * (dense @ bq)), beta=np.sum(w * c))
        got = dict(values=v.grad[live], b=leaves[0].grad,
                   c=leaves[1].grad, alpha=leaves[2].grad,
                   beta=leaves[3].grad)
        check(bool((v.grad[~live] == 0).all()),
              f"spmm[{be}]: non-zero gradient on a padding slot")
        for key, ref in want.items():
            worst = max(worst, assert_close(
                got[key].cpu(), torch.from_numpy(np.asarray(ref)),
                f"spmm[{be}] d {key} vs float64 oracle"))
    emit({"phase": "gradients_vs_oracle", "max_abs_err": worst})


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
    del A_band
    return rows, snap, A_snap


def measure_h2d_gbps(dev, nbytes=1 << 30) -> float:
    """Host-to-device rate of one large copy from pinned memory, on this
    card, in GB/s: what the staging bound divides by."""
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: dst.copy_(src, non_blocking=True), reps=5)
    return nbytes / (ms * 1e-3) / 1e9


def stream_step_bound(P):
    """The least time the card could take for a run's window steps, summed
    over the steps: per step, the chunk's non-zeros (12 B each), its block
    of b and the C stripe read and written once over the HBM rate, against
    2 * nnz * width flops over the fp32 rate. Returns (ms, bound_by)."""
    d = P.a.data
    nse = d.nse.sum(dim=0).tolist()            # live slots per window
    t_bytes = t_flops = total = 0.0
    for j in range(P.n_tiles):
        width = min(P.n, (j + 1) * P.n_tile) - j * P.n_tile
        for i in range(P.steps):
            w0, w1 = i * P.window_chunk, min(d.nw, (i + 1) * P.window_chunk)
            nnz = sum(nse[w0:w1])
            rows_b = min(P.k, w1 * d.k0) - w0 * d.k0
            tb = (12 * nnz + rows_b * width * 4 + 2 * P.m * width * 4
                  ) / HBM_BYTES_PER_S * 1e3
            tf = 2 * nnz * width / FP32_FLOPS_PER_S * 1e3
            t_bytes, t_flops = t_bytes + tb, t_flops + tf
            total += max(tb, tf)
    return total, "bytes" if t_bytes >= t_flops else "operations"


def run_halves(P, b_h, c, dev, mods):
    """The two halves that ``StreamingPlan.run`` composes, apart: returns
    (copy_fn, compute_fn, steps_fn, plain_fn). ``copy_fn`` runs the
    staging half (``_chunks``) with nothing computed; ``compute_fn`` the
    compute half (``_compute``) over chunks staged on the card beforehand;
    ``steps_fn`` only the run's accumulate launches on those chunks, and
    ``plain_fn`` the plain version of the first tile's."""
    vals_h = P.a.data.vals

    def copy_fn():
        for _ in P._chunks(b_h, vals_h):
            pass

    staged = [(pos, {f: x.clone() for f, x in chunk.items()})
              for pos, chunk in P._chunks(b_h, vals_h)]
    alpha = torch.tensor(ALPHA, device=dev)
    beta = torch.tensor(BETA, device=dev)

    def compute_fn():
        P._compute(iter(staged), c, alpha, beta)

    name = next(nm for nm, kk in KERNELS.items()
                if kk["backend"] == P.backend)
    kern, plain = kernel_call(name, mods), plain_call(name, mods)
    d = P.a.data
    kw = dict(tm=d.tm, k0=d.k0)
    width = -(-P.n_tile // 8) * 8
    if name == "sextans_spmm":
        kw["tn"] = P.opts.get("tn", 128)
        width = -(-P.n_tile // kw["tn"]) * kw["tn"]
    acc = torch.zeros((d.mb * d.tm, width), dtype=torch.float32, device=dev)
    args = []
    for _, ch in staged:
        bp = ch["b"]
        if bp.shape[1] != width:               # the kernels' padded width
            bp = torch.zeros((bp.shape[0], width), dtype=bp.dtype,
                             device=dev)
            bp[:, :ch["b"].shape[1]] = ch["b"]
        args.append((ch["vals"], ch["cols"], ch["rows"], ch["q"], bp, acc))

    def steps_fn():
        for a in args:
            kern(*a, accumulate=True, **kw)

    def plain_fn():
        for a in args[:P.steps]:
            plain(*a, accumulate=True, **kw)

    return copy_fn, compute_fn, steps_fn, plain_fn


def zero_counts(mods):
    for mod in (mods["spmm"], mods["spmv"]):
        mod.LAUNCHES = mod.ACCUMULATE_LAUNCHES = 0


def read_counts(mods):
    return {nm: {"resident": mods[key].LAUNCHES,
                 "accumulate": mods[key].ACCUMULATE_LAUNCHES}
            for nm, key in (("sextans_spmm", "spmm"), ("sextans_spmv", "spmv"))}


def run_stream_case(label, A_h, A_dev, n, budget, backend, dev, mods, gbps):
    """``plan(A_h, n, device_bytes=budget)`` as a user calls it, on its own
    choice of tier; then the streaming tier, forced where the budget keeps
    the matrix resident. Both results must equal the resident ``spmm``'s
    bit for bit."""
    sp = mods["sp"]
    rng = np.random.default_rng(SEED)
    m, k = A_h.shape
    b_h = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    c_h = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    b_d, c_d = b_h.to(dev), c_h.to(dev)
    working = A_h.nbytes + (k * n + 2 * m * n) * 4
    name = next(nm for nm, kk in KERNELS.items() if kk["backend"] == backend)
    y_res = sp.spmm(A_dev, b_d, c_d, ALPHA, BETA, backend=backend)

    chosen = sp.plan(A_h, n, device_bytes=budget, backend=backend)
    check(chosen.device.type == "cuda",
          f"case {label}: plan() computes on {chosen.device}")
    plan_line = {"phase": "stream_plan", "case": label,
                 "resident_plan_launches": 0,
                 "chosen": repr(chosen), "device_bytes": budget,
                 "resident_working_set": working}
    if isinstance(chosen, sp.SpmmPlan):
        # The budget keeps A resident: drive that tier on the card too.
        torch.cuda.synchronize()
        zero_counts(mods)
        y = chosen.run(b_h, c_h, ALPHA, BETA)
        torch.cuda.synchronize()
        counts = read_counts(mods)
        check(counts[name]["resident"] >= 1,
              f"case {label}: the resident plan launched {name} "
              f"{counts[name]['resident']} times")
        check(torch.equal(y, y_res),
              f"case {label}: resident plan differs from spmm")
        plan_line.update(
            resident_plan_launches=counts[name]["resident"],
            resident_plan_ms=time_ms(
                lambda: chosen.run(b_d, c_d, ALPHA, BETA)))
        P = sp.plan(A_h, n, device_bytes=budget, backend=backend, stream=True)
    else:
        P = chosen
    del chosen
    check(isinstance(P, sp.StreamingPlan), f"case {label}: {P!r}")
    plan_line.update(
        plan=repr(P), n_tile=P.n_tile, n_tiles=P.n_tiles,
        window_chunk=P.window_chunk, steps=P.steps,
        window_dispatches=P.window_dispatches,
        chunk_payload_bytes=P.chunk_payload_bytes,
        peak_payload_bytes=P.peak_payload_bytes)
    emit(plan_line)

    torch.cuda.synchronize()
    zero_counts(mods)
    y = P.run(b_h, c_h, ALPHA, BETA)
    torch.cuda.synchronize()
    launches = read_counts(mods)
    check(launches[name]["accumulate"] == P.window_dispatches,
          f"case {label}: {launches[name]['accumulate']} accumulate launches "
          f"of {name}, expected {P.window_dispatches}")
    check(tuple(y.shape) == (m, n), f"case {label}: shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), f"case {label}: non-finite values")
    check(torch.equal(y.to(dev), y_res),
          f"case {label}: streamed result differs from the resident one "
          f"(max |diff| {(y.to(dev) - y_res).abs().max().item():.3e})")

    stream_ms = time_ms(lambda: P.run(b_h, c_h, ALPHA, BETA),
                        reps=STREAM_REPS, warmup=1)
    resident_ms = time_ms(
        lambda: sp.spmm(A_dev, b_d, c_d, ALPHA, BETA, backend=backend))
    copy_fn, compute_fn, steps_fn, plain_fn = run_halves(
        P, b_h, c_d if P.n_tiles == 1 else c_h, dev, mods)
    copy_ms = time_ms(copy_fn, reps=STREAM_REPS, warmup=1)
    compute_ms = time_ms(compute_fn, reps=STREAM_REPS, warmup=1)
    steps_ms = time_ms(steps_fn, reps=STREAM_REPS, warmup=1)
    plain_ms = time_ms(plain_fn, reps=3, warmup=1)
    del copy_fn, compute_fn, steps_fn, plain_fn
    bound, bound_by = stream_step_bound(P)
    h2d = P.h2d_bytes
    staging_bound_ms = h2d / (gbps * 1e9) * 1e3
    row = dict(
        case=label, kernel=name, backend=backend, m=m, k=k, n=n,
        slab_geometry=list(A_h.data.geometry), payload_bytes=A_h.nbytes,
        bit_identical_to_resident=True, launches=launches,
        resident_plan_launches=plan_line["resident_plan_launches"],
        stream_ms=stream_ms, resident_ms=resident_ms,
        copy_only_ms=copy_ms, compute_only_ms=compute_ms,
        h2d_bytes=h2d, h2d_gbps=gbps, staging_bound_ms=staging_bound_ms,
        overlap=1.0 - stream_ms / (copy_ms + compute_ms),
        step_ms=steps_ms / P.window_dispatches,
        step_plain_ms=plain_ms / P.steps,
        step_bound_ms=bound / P.window_dispatches, step_bound_by=bound_by)
    emit(row)
    return row


def run_streaming_grad_case(label, A_dev, n, dev, mods):
    """``spmm_streaming`` forward and backward against ``spmm``'s."""
    sp, bk = mods["sp"], mods["backends"]
    rng = np.random.default_rng(SEED)
    m, k = A_dev.shape
    b, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
            for s in ((k, n), (m, n)))
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (m, n)).astype(np.float32)).to(dev)
    backend = "cuda"

    def forward(fn, **kw):
        v = A_dev.values.detach().clone().requires_grad_()
        leaves = [x.detach().clone().requires_grad_() for x in
                  (b, c, torch.tensor(ALPHA, device=dev),
                   torch.tensor(BETA, device=dev))]
        y = fn(A_dev.with_values(v), *leaves, backend=backend, **kw)
        return y, [v, *leaves]

    def backward_ms(fn, **kw):
        times = []
        for _ in range(3):
            y, leaves = forward(fn, **kw)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            y.backward(w)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), y.detach(), [x.grad for x in leaves]

    grid = dict(window_chunk=8, n_tile=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mods["spmm"].ACCUMULATE_LAUNCHES = mods["spmv"].ACCUMULATE_LAUNCHES = 0
    s_ms, y_s, g_s = backward_ms(sp.spmm_streaming, **grid)
    peak = torch.cuda.max_memory_allocated() - base
    acc_launches = (mods["spmm"].ACCUMULATE_LAUNCHES
                    + mods["spmv"].ACCUMULATE_LAUNCHES)
    check(acc_launches >= 1, f"case {label}: no accumulate launch")
    torch.cuda.reset_peak_memory_stats()
    r_ms, y_r, g_r = backward_ms(sp.spmm)
    peak_res = torch.cuda.max_memory_allocated() - base
    check(torch.equal(y_s, y_r),
          f"case {label}: spmm_streaming forward differs from spmm")
    live = bk._hflex_global_ids(A_dev.data)[0]
    check(bool((g_s[0][~live] == 0).all()),
          f"case {label}: non-zero gradient on a padding slot")
    errs = {}
    for key, gs, gr in zip(("values", "b", "c", "alpha", "beta"), g_s, g_r):
        errs[key] = assert_close(gs, gr, f"case {label}: d {key} "
                                         f"streaming vs resident")
    row = dict(case=label, backend=backend, n=n, **grid,
               forward_bit_identical=True, grad_max_abs_err=errs,
               accumulate_launches=acc_launches,
               backward_ms=s_ms, resident_backward_ms=r_ms,
               peak_device_bytes=peak, resident_peak_device_bytes=peak_res)
    emit(row)
    return row


def phase_stream(snap, A_snap, dev, mods):
    sp = mods["sp"]
    t0 = time.perf_counter()
    A_h = sp.from_sparse_matrix(snap, device="cpu", **PACK)
    gbps = measure_h2d_gbps(dev)
    emit({"phase": "stream_setup", "pack_host_s": time.perf_counter() - t0,
          "h2d_gbps": gbps, "payload_bytes": A_h.nbytes})
    rows = [
        run_stream_case("d:snap_pl_120000", A_h, A_snap, 512, 4 << 30,
                        "cuda", dev, mods, gbps),
        run_stream_case("e:snap_pl_120000", A_h, A_snap, 8, 1 << 30,
                        "spmv", dev, mods, gbps),
    ]
    grad = run_streaming_grad_case("f:snap_pl_120000", A_snap, 64, dev, mods)
    return rows, grad


def kernels_line(rows, stream_rows):
    """One entry per kernel. ``launches`` counts both modes over every
    main-path case; ``ms``/``plain_ms``/``bound_ms`` are the resident mode's
    on its slowest case, ``accumulate_*`` the stream step's, per window
    step, on its stream case."""
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        streamed = [r for r in stream_rows if r["kernel"] == name]
        check(mine, f"no main-path case ran {name}")
        check(streamed, f"no stream case ran {name}")
        main = max(mine, key=lambda r: r["kernel_ms"])
        st = streamed[0]
        by_mode = {
            "resident": sum(r["launches"] for r in mine) + sum(
                r["launches"][name]["resident"] + r["resident_plan_launches"]
                for r in streamed),
            "accumulate": sum(r["launches"][name]["accumulate"]
                              for r in stream_rows)}
        check(by_mode["accumulate"] >= 1,
              f"the main path launched {name}'s accumulate mode no time")
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(by_mode.values()), launches_by_mode=by_mode,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=main["kernel_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], case=main["case"],
            accumulate_ms=st["step_ms"],
            accumulate_plain_ms=st["step_plain_ms"],
            accumulate_bound_ms=st["step_bound_ms"],
            accumulate_bound_by=st["step_bound_by"],
            accumulate_case=st["case"]))
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
        phase_accumulate_vs_plain(dev, mods)
        phase_gradients(dev, mods)
        rows, snap, A_snap = phase_main_path(dev, mods)
        stream_rows, _ = phase_stream(snap, A_snap, dev, mods)
        emit(kernels_line(rows, stream_rows))
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
