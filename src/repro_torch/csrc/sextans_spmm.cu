// Sextans SpMM on Hopper: out = alpha * A @ B + beta * C_in over HFlex slabs,
// or, in accumulate mode, acc += A @ B on a carried f32 accumulator.
//
// Replaces src/repro/kernels/sextans_spmm.py:_kernel / sextans_spmm_pallas
// (one matrix, gather="gather"), both modes: accumulate=False (resident)
// and accumulate=True (the out-of-core stream step).
//
// Operands are those of the TPU kernel, already padded by the caller:
//   vals f32, cols i32, rows i32 : (MB, NW, LW) slab slots
//   q    i32                     : (MB, NW) slots to walk per slab
//   b    f32 | bf16              : (NW*K0, NPAD), NPAD a multiple of TN
//   c_in f32                     : (MB*TM, NPAD), in the slabs' row layout
//   ab   f32                     : (2,) device buffer [alpha, beta]
//   out  b's type                : (MB*TM, NPAD)
// In accumulate mode out is the f32 accumulator in this same padded,
// interleaved layout, updated in place: each CTA seeds its tile from out,
// adds its slots and writes the raw f32 tile back, with no epilogue. c_in
// and ab are not read (the wrapper passes null). A CTA reads every element
// of its own tile before it writes any, and no other CTA touches that
// tile. No two pointers alias, so all keep __restrict__.
//
// Design. One CTA owns the TM x TN output tile (m, n-tile) and walks the
// windows w = 0..NW-1 in order: the loop takes the place of the TPU grid's
// sequential window axis. Slabs with q == 0 are skipped. Slot metadata is
// staged through shared memory kStage slots at a time. Thread t owns
// column t of the tile and walks the staged slots in slot order,
// acc[row][t] += val * B[w*K0 + col][n0 + t], with the fp32 accumulator
// tile in shared memory (TM*TN*4 bytes). Each thread touches only its own
// column of the tile, so no atomics are needed and every output element is
// summed in one fixed order on every run. A chain of accumulate launches
// over consecutive window chunks therefore adds exactly what one resident
// launch adds. The epilogue rounds each product and the sum on its own
// (__fmul_rn, __fadd_rn, never contracted into an FMA), as PyTorch's
// separate multiply, multiply and add do: a streamed result, finished by
// PyTorch, is then bit-identical to a resident one.
//
// What bounds it. Per slot a CTA reads one B row segment of TN values,
// coalesced across the warp, and does TN multiply-adds: about 2 flops per
// 4 bytes of B, so bytes would bound a balanced matrix. Measured on the
// H100 (PERF.md section 5), time instead follows the row block that walks
// the most slots: the CTAs of a power-law hub block walk about 38 times
// the mean block's slots one after another while the rest of the grid has
// finished, and on an even banded matrix the kernel is latency-bound at
// three CTAs per SM (70 KiB of shared memory each). A stream step
// (accumulate mode) also reads and writes the whole f32 accumulator once:
// on the H100 at PERF.md case (d), one window of 938 row blocks against a
// 128-column tile, a step took 0.097 ms against a 0.037 ms bound that is
// almost all that 123 MB round trip. The streamed run as a whole is bound
// by staging on the host, not by this kernel (PERF.md section 5). What the
// design does: each thread issues kUnroll independent B loads before it
// applies them in slot order, so the gathers of one CTA overlap.
// Splitting a hub block over several CTAs (with a fixed-order second
// pass), wgmma and TMA staging of B windows are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStage = 512;   // slots staged into shared memory per pass
constexpr int kUnroll = 8;    // B loads in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// OutT is T in resident mode and float in accumulate mode (out is the
// accumulator).
template <typename T, typename OutT, bool kAccumulate>
__global__ void sextans_spmm_kernel(const float* __restrict__ vals,
                                    const int* __restrict__ cols,
                                    const int* __restrict__ rows,
                                    const int* __restrict__ q,
                                    const T* __restrict__ b,
                                    const float* __restrict__ c_in,
                                    const float* __restrict__ ab,
                                    OutT* __restrict__ out,
                                    int nw, int lw, int tm, int k0, int npad) {
  extern __shared__ float smem[];
  const int tn = blockDim.x;
  const int t = threadIdx.x;
  const int m = blockIdx.x;
  const int n0 = blockIdx.y * tn;
  float* acc = smem;                                  // (TM, TN)
  float* s_val = acc + tm * tn;                       // (kStage,)
  int* s_col = reinterpret_cast<int*>(s_val + kStage);
  int* s_row = s_col + kStage;

  const int64_t tile0 = static_cast<int64_t>(m) * tm * npad + n0 + t;
  for (int r = 0; r < tm; ++r)
    acc[r * tn + t] =
        kAccumulate ? to_f32(out[tile0 + static_cast<int64_t>(r) * npad]) : 0.f;

  const T* b_col = b + n0 + t;
  for (int w = 0; w < nw; ++w) {
    const int count = min(q[m * nw + w], lw);
    if (count <= 0) continue;                         // empty slab: skipped
    const int64_t slab = (static_cast<int64_t>(m) * nw + w) * lw;
    const T* b_win = b_col + static_cast<int64_t>(w) * k0 * npad;
    for (int base = 0; base < count; base += kStage) {
      const int len = min(kStage, count - base);
      __syncthreads();                                // stage free again
      for (int j = t; j < len; j += tn) {
        const int r = rows[slab + base + j];
        const int c = cols[slab + base + j];
        // A slot outside the tile is dropped, as the TPU kernel's one-hot
        // row scatter drops it.
        const bool ok = static_cast<unsigned>(r) < static_cast<unsigned>(tm) &&
                        static_cast<unsigned>(c) < static_cast<unsigned>(k0);
        s_val[j] = ok ? vals[slab + base + j] : 0.f;
        s_row[j] = ok ? r : 0;
        s_col[j] = ok ? c : 0;
      }
      __syncthreads();
      int j = 0;
      for (; j + kUnroll <= len; j += kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          x[u] = to_f32(b_win[static_cast<int64_t>(s_col[j + u]) * npad]);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          acc[s_row[j + u] * tn + t] += s_val[j + u] * x[u];
      }
      for (; j < len; ++j)
        acc[s_row[j] * tn + t] +=
            s_val[j] * to_f32(b_win[static_cast<int64_t>(s_col[j]) * npad]);
    }
  }

  if (kAccumulate) {
    for (int r = 0; r < tm; ++r)
      out[tile0 + static_cast<int64_t>(r) * npad] = acc[r * tn + t];
    return;
  }
  const float alpha = ab[0];
  const float beta = ab[1];
  for (int r = 0; r < tm; ++r) {
    const int64_t o = tile0 + static_cast<int64_t>(r) * npad;
    store(out + o, __fadd_rn(__fmul_rn(alpha, acc[r * tn + t]),
                             __fmul_rn(beta, c_in[o])));
  }
}

template <typename T, typename OutT, bool kAccumulate>
int launch(const float* vals, const int* cols, const int* rows, const int* q,
           const void* b, const float* c_in, const float* ab, void* out,
           int mb, int nw, int lw, int tm, int k0, int npad, int tn,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tm) * tn * sizeof(float) +
                      kStage * (sizeof(float) + 2 * sizeof(int));
  auto kernel = sextans_spmm_kernel<T, OutT, kAccumulate>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(mb, npad / tn);
  kernel<<<grid, tn, smem, stream>>>(vals, cols, rows, q,
                                     static_cast<const T*>(b), c_in, ab,
                                     static_cast<OutT*>(out), nw, lw, tm, k0,
                                     npad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// b_bf16 selects the bf16 instantiation for b (and, resident, for out),
// else f32. accumulate selects the stream step: out is the accumulator,
// and c_in and ab may be null.
extern "C" int sextans_spmm_launch(const float* vals, const int* cols,
                                   const int* rows, const int* q,
                                   const void* b, const float* c_in,
                                   const float* ab, void* out,
                                   int mb, int nw, int lw, int tm, int k0,
                                   int npad, int tn, int b_bf16,
                                   int accumulate, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (accumulate) {
    if (b_bf16)
      return launch<bf16, float, true>(vals, cols, rows, q, b, c_in, ab, out,
                                       mb, nw, lw, tm, k0, npad, tn, s);
    return launch<float, float, true>(vals, cols, rows, q, b, c_in, ab, out,
                                      mb, nw, lw, tm, k0, npad, tn, s);
  }
  if (b_bf16)
    return launch<bf16, bf16, false>(vals, cols, rows, q, b, c_in, ab, out, mb,
                                     nw, lw, tm, k0, npad, tn, s);
  return launch<float, float, false>(vals, cols, rows, q, b, c_in, ab, out, mb,
                                     nw, lw, tm, k0, npad, tn, s);
}
