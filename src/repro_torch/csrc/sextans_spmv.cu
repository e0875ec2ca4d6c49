// Skinny-N Sextans lane on Hopper: out = alpha * A @ B + beta * C_in for a
// handful of dense columns, over HFlex slabs, or, in accumulate mode,
// acc += A @ B on a carried f32 accumulator.
//
// Replaces src/repro/kernels/spmv_vector.py:_kernel / sextans_spmv_pallas
// (one matrix, gather="gather"), both modes: accumulate=False (resident)
// and accumulate=True (the out-of-core stream step).
//
// Operands are those of the TPU kernel, already padded by the caller:
//   vals f32, cols i32, rows i32 : (MB, NW, LW) slab slots
//   q    i32                     : (MB, NW) slots to walk per slab
//   b    f32 | bf16              : (NW*K0, NV), NV a multiple of 8
//   c_in f32                     : (MB*TM, NV), in the slabs' row layout
//   ab   f32                     : (2,) device buffer [alpha, beta]
//   out  b's type                : (MB*TM, NV)
// In accumulate mode out is the f32 accumulator in this same padded,
// interleaved layout, updated in place: thread r seeds its 8 register
// accumulators from its own row segment of out and writes them back raw,
// with no epilogue. c_in and ab are not read (the wrapper passes null).
// No other thread reads or writes that row segment, and no two pointers
// alias, so all keep __restrict__.
//
// Design. One CTA per (row block m, group of 8 columns); for N <= 8 that
// is one CTA per row block, and each B window is read once by it. The CTA
// walks the windows in order, skipping slabs with q == 0, and stages slot
// metadata through shared memory. A thread per column would give only 8
// threads, so thread r owns output row r of the block instead and holds
// its 8 accumulators in registers. Every thread walks all staged slots in
// slot order and applies only those of its own row: no atomics, and one
// fixed add order on every run, so a chain of accumulate launches over
// window chunks adds exactly what one resident launch adds. The epilogue
// rounds each product and the sum on its own (__fmul_rn, __fadd_rn), as
// PyTorch's separate operations do, so a streamed result finished by
// PyTorch is bit-identical to a resident one.
//
// What bounds it. The useful work is 16 flops per slot against a 4..32
// byte B row, so bytes bound it in principle. Measured on the H100
// (PERF.md section 5), time instead follows the longest row: the thread
// that owns a power-law hub row applies its slots one after another, each
// a dependent B load and add, while every thread of the block scans every
// staged slot. On the main path's power-law matrix one thread walks about
// 18k slots in series and the kernel runs hundreds of times its byte
// bound. A stream step (accumulate mode) walks one window chunk of every
// block, and the hub row's slots in that chunk set its time the same way:
// on the H100 at PERF.md case (e), two windows per step, 0.27 ms against a
// 0.0025 ms bound. What the design does: nothing yet beyond staging slot
// metadata in shared memory; partitioning a block's slots by row ahead of
// time, and splitting hub rows over several threads with a fixed-order
// reduction, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStage = 1024;  // slots staged into shared memory per pass
constexpr int kCols = 8;      // dense columns per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// OutT is T in resident mode and float in accumulate mode (out is the
// accumulator).
template <typename T, typename OutT, bool kAccumulate>
__global__ void sextans_spmv_kernel(const float* __restrict__ vals,
                                    const int* __restrict__ cols,
                                    const int* __restrict__ rows,
                                    const int* __restrict__ q,
                                    const T* __restrict__ b,
                                    const float* __restrict__ c_in,
                                    const float* __restrict__ ab,
                                    OutT* __restrict__ out,
                                    int nw, int lw, int tm, int k0, int nv) {
  __shared__ float s_val[kStage];
  __shared__ int s_col[kStage];
  __shared__ int s_row[kStage];
  const int r = threadIdx.x;          // this thread's row of the block
  const int m = blockIdx.x;
  const int v0 = blockIdx.y * kCols;
  const int64_t o = (static_cast<int64_t>(m) * tm + r) * nv + v0;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = kAccumulate ? to_f32(out[o + i]) : 0.f;

  for (int w = 0; w < nw; ++w) {
    const int count = min(q[m * nw + w], lw);
    if (count <= 0) continue;                         // empty slab: skipped
    const int64_t slab = (static_cast<int64_t>(m) * nw + w) * lw;
    const T* b_win = b + static_cast<int64_t>(w) * k0 * nv + v0;
    for (int base = 0; base < count; base += kStage) {
      const int len = min(kStage, count - base);
      __syncthreads();                                // stage free again
      for (int j = r; j < len; j += blockDim.x) {
        const int rr = rows[slab + base + j];
        const int c = cols[slab + base + j];
        // A slot outside the tile is dropped (row -1 matches no thread),
        // as the TPU kernel's one-hot row scatter drops it.
        const bool ok = static_cast<unsigned>(rr) < static_cast<unsigned>(tm) &&
                        static_cast<unsigned>(c) < static_cast<unsigned>(k0);
        s_val[j] = vals[slab + base + j];
        s_row[j] = ok ? rr : -1;
        s_col[j] = ok ? c : 0;
      }
      __syncthreads();
      for (int j = 0; j < len; ++j) {
        if (s_row[j] != r) continue;
        const T* bp = b_win + static_cast<int64_t>(s_col[j]) * nv;
        const float v = s_val[j];
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[i] += v * to_f32(bp[i]);
      }
    }
  }

  if (kAccumulate) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) out[o + i] = acc[i];
    return;
  }
  const float alpha = ab[0];
  const float beta = ab[1];
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    store(out + o + i, __fadd_rn(__fmul_rn(alpha, acc[i]),
                                 __fmul_rn(beta, c_in[o + i])));
}

template <typename T, typename OutT, bool kAccumulate>
int launch(const float* vals, const int* cols, const int* rows, const int* q,
           const void* b, const float* c_in, const float* ab, void* out,
           int mb, int nw, int lw, int tm, int k0, int nv,
           cudaStream_t stream) {
  dim3 grid(mb, nv / kCols);
  sextans_spmv_kernel<T, OutT, kAccumulate><<<grid, tm, 0, stream>>>(
      vals, cols, rows, q, static_cast<const T*>(b), c_in, ab,
      static_cast<OutT*>(out), nw, lw, tm, k0, nv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// b_bf16 selects the bf16 instantiation for b (and, resident, for out),
// else f32. accumulate selects the stream step: out is the accumulator,
// and c_in and ab may be null.
extern "C" int sextans_spmv_launch(const float* vals, const int* cols,
                                   const int* rows, const int* q,
                                   const void* b, const float* c_in,
                                   const float* ab, void* out,
                                   int mb, int nw, int lw, int tm, int k0,
                                   int nv, int b_bf16, int accumulate,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (accumulate) {
    if (b_bf16)
      return launch<bf16, float, true>(vals, cols, rows, q, b, c_in, ab, out,
                                       mb, nw, lw, tm, k0, nv, s);
    return launch<float, float, true>(vals, cols, rows, q, b, c_in, ab, out,
                                      mb, nw, lw, tm, k0, nv, s);
  }
  if (b_bf16)
    return launch<bf16, bf16, false>(vals, cols, rows, q, b, c_in, ab, out, mb,
                                     nw, lw, tm, k0, nv, s);
  return launch<float, float, false>(vals, cols, rows, q, b, c_in, ab, out, mb,
                                     nw, lw, tm, k0, nv, s);
}
