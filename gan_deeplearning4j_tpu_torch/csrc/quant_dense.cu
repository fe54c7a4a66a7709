// quant_dense: the int8 dense layer of a quantized serving bundle, one launch.
//
//   y[i, j] = float(sum_k x_q[i, k] * W_q[k, j]) * (w_scale[j] * act_scale) + b[j]
//   x_q     = int8(clip(rint(x * inv_act_scale), -127, 127))
//
// Replaces gan_deeplearning4j_tpu/ops/linear.py::quant_dense (lines 34-66),
// which XLA lowers (it is not a Pallas kernel). Built by nvcc for sm_90a into
// a shared library with a plain C interface and loaded with ctypes
// (gan_deeplearning4j_tpu_torch/ops/_native.py); the wrapper and the plain
// PyTorch version are gan_deeplearning4j_tpu_torch/ops/linear.py.
//
// Numerics, equal bit for bit to the plain version:
// - the reciprocal is the wrapper's float32(1.0 / act_scale), multiplied in
//   fp32 (__fmul_rn), as the reference's x * (1.0 / act_scale) does; x /
//   act_scale would move some codes by one;
// - rintf rounds half to even, as jnp.round and torch.round do (roundf would
//   round half away from zero); the clip is to +-127;
// - the sum is an exact int32 (dp4a): |acc| reaches 127 * 127 * 1152 =
//   18,580,608 > 2^24 on dis_dense_layer_6, which an fp32 sum would round;
// - the epilogue is scale = w_scale * act_scale, then float(acc) * scale,
//   then + b, each rounded on its own (__fmul_rn / __fadd_rn, and the library
//   is built with -fmad=false): no FMA contraction.
//
// Bound on an H100 SXM (3.35 TB/s, 1,979 int8 TOP/s): for dis_dense_layer_6
// (K = 1152, N = 1024) at n = 128 the call must move x (590 KB fp32), W_q
// (1.18 MB) and y (524 KB), about 2.30 MB, 0.69 us, against 2 * 128 * 1152 *
// 1024 = 302 M int8 operations, 0.15 us: memory-bound. At n = 1 the bound is
// the 1.18 MB weight read, about 0.36 us. So the design reads W_q from device
// memory once per row tile, in whole 32-byte sectors, and keeps everything
// else on chip:
// - a block owns a tile of ROWS rows x 64 output columns and quantizes its x
//   rows once into shared memory, packed four k per 32-bit word;
// - its 256 threads split the tile as 16 column groups of 4 columns x 16
//   slices of k: a thread reads a 4 x 4 byte patch of W_q (four k rows of its
//   four columns) per step, transposes it in registers (__byte_perm) and
//   issues one dp4a per row and column, keeping ROWS x 4 int32 sums in
//   registers; a warp's loads cover two rows of 64 contiguous bytes;
// - the 16 k slices are summed exactly (shuffles, then shared memory), and
//   the epilogue (dequantize, bias) is fused into the same launch.
// This is the simple first design: it issues dp4a on the CUDA cores, not
// IMMA / wgmma on the tensor cores, and uses no TMA. Its times sit beside
// the bound in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                         // 8 warps
constexpr int kColGroups = 16;                        // column groups of a tile
constexpr int kTileCols = 4 * kColGroups;             // 64 output columns
constexpr int kKSlices = kThreads / kColGroups;       // 16 slices of k
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned quantize_byte(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

// Four k rows (t = 0..3) of four columns (c = 0..3) of W_q, as one 32-bit
// word per column whose byte t is W_q[k0 + t, j0 + c] (the byte order of the
// packed x words, so dp4a pairs k with k).
__device__ __forceinline__ void load_patch(const int8_t* __restrict__ w, int K, int N,
                                           int k0, int j0, bool vec, unsigned col[4]) {
  if (vec && k0 + 3 < K && j0 + 3 < N) {
    // rows are 4-byte aligned (N % 4 == 0, aligned base): one word per row
    const int8_t* p = w + static_cast<size_t>(k0) * N + j0;
    const unsigned r0 = __ldg(reinterpret_cast<const unsigned*>(p));
    const unsigned r1 = __ldg(reinterpret_cast<const unsigned*>(p + N));
    const unsigned r2 = __ldg(reinterpret_cast<const unsigned*>(p + 2 * static_cast<size_t>(N)));
    const unsigned r3 = __ldg(reinterpret_cast<const unsigned*>(p + 3 * static_cast<size_t>(N)));
    const unsigned lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
    const unsigned hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
    const unsigned lo23 = __byte_perm(r2, r3, 0x5140);
    const unsigned hi23 = __byte_perm(r2, r3, 0x7362);
    col[0] = __byte_perm(lo01, lo23, 0x5410);  // r0.b0 r1.b0 r2.b0 r3.b0
    col[1] = __byte_perm(lo01, lo23, 0x7632);  // r0.b1 r1.b1 r2.b1 r3.b1
    col[2] = __byte_perm(hi01, hi23, 0x5410);
    col[3] = __byte_perm(hi01, hi23, 0x7632);
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    unsigned word = 0;
    const int j = j0 + c;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = k0 + t;
      if (k < K && j < N) {
        const unsigned byte = static_cast<unsigned>(
            static_cast<uint8_t>(__ldg(w + static_cast<size_t>(k) * N + j)));
        word |= byte << (8 * t);
      }
    }
    col[c] = word;
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
quant_dense_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, const float* __restrict__ bias,
                   float* __restrict__ y, int n, int K, int N, float inv_act_scale,
                   float act_scale, bool vec) {
  // phase 1: x_q[ROWS][K4] packed four k per word; phase 2: the partial sums
  // of the 8 warps, [kWarps][ROWS][kTileCols]
  extern __shared__ int smem[];
  const int K4 = (K + 3) / 4;
  const int row0 = blockIdx.y * ROWS;
  const int col0 = blockIdx.x * kTileCols;
  const int tid = threadIdx.x;

  // 1. quantize the block's rows once (rows past n and k past K are zero)
  for (int idx = tid; idx < ROWS * K4; idx += kThreads) {
    const int r = idx / K4;
    const int g = idx - r * K4;
    const int row = row0 + r;
    unsigned packed = 0;
    if (row < n) {
      const float* xr = x + static_cast<size_t>(row) * K;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = 4 * g + t;
        if (k < K) packed |= quantize_byte(xr[k], inv_act_scale) << (8 * t);
      }
    }
    smem[idx] = static_cast<int>(packed);
  }
  __syncthreads();

  // 2. exact int32 sums: thread = (k slice, column group of 4 columns)
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = lane & (kColGroups - 1);
  const int kslice = warp * (32 / kColGroups) + lane / kColGroups;
  const int j0 = col0 + 4 * cg;
  int acc[ROWS][4];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

#pragma unroll 2
  for (int g = kslice; g < K4; g += kKSlices) {
    unsigned col[4];
    load_patch(w, K, N, 4 * g, j0, vec, col);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int xa = smem[r * K4 + g];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(xa, static_cast<int>(col[c]), acc[r][c]);
    }
  }

  // 3. sum the k slices: lanes l and l ^ 16 hold the same columns
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] += __shfl_xor_sync(0xffffffffu, acc[r][c], 16);
  __syncthreads();  // every thread is done reading x_q
  int* part = smem;
  if (lane < kColGroups) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[(warp * ROWS + r) * kTileCols + 4 * cg + c] = acc[r][c];
  }
  __syncthreads();

  // 4. fused epilogue: dequantize once, then the bias, each rounded alone
  for (int o = tid; o < ROWS * kTileCols; o += kThreads) {
    const int r = o / kTileCols;
    const int cc = o - r * kTileCols;
    const int row = row0 + r;
    const int col = col0 + cc;
    if (row >= n || col >= N) continue;
    int s = 0;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += part[(wp * ROWS + r) * kTileCols + cc];
    const float scale = __fmul_rn(w_scale[col], act_scale);
    float v = __fmul_rn(__int2float_rn(s), scale);
    if (bias != nullptr) v = __fadd_rn(v, bias[col]);
    y[static_cast<size_t>(row) * N + col] = v;
  }
}

template <int ROWS>
cudaError_t launch(const float* x, const int8_t* w, const float* w_scale, const float* bias,
                   float* y, int n, int K, int N, float inv_act_scale, float act_scale,
                   bool vec, cudaStream_t stream) {
  const int K4 = (K + 3) / 4;
  const int words = ROWS * K4 > kWarps * ROWS * kTileCols ? ROWS * K4 : kWarps * ROWS * kTileCols;
  const size_t smem = static_cast<size_t>(words) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quant_dense_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((N + kTileCols - 1) / kTileCols, (n + ROWS - 1) / ROWS);
  quant_dense_kernel<ROWS><<<grid, kThreads, smem, stream>>>(
      x, w, w_scale, bias, y, n, K, N, inv_act_scale, act_scale, vec);
  return cudaGetLastError();
}

}  // namespace

// x (n, K) fp32, w (K, N) int8, w_scale (N,) fp32, bias (N,) fp32 or null,
// y (n, N) fp32: all contiguous, on the current device. Returns the launch's
// cudaGetLastError() (0 on success); cudaErrorInvalidValue for a shape the
// grid cannot hold.
extern "C" int gdt_quant_dense_f32(const void* x, const void* w, const void* w_scale,
                                   const void* bias, void* y, int n, int K, int N,
                                   float inv_act_scale, float act_scale, int vec,
                                   void* stream) {
  if (n <= 0 || K <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n >= 16 ? 16 : n >= 8 ? 8 : n >= 4 ? 4 : n >= 2 ? 2 : 1;
  if ((n + rows - 1) / rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* ws = static_cast<const float*>(w_scale);
  const float* bf = static_cast<const float*>(bias);
  float* yf = static_cast<float*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  cudaError_t err;
  switch (rows) {
    case 16: err = launch<16>(xf, wq, ws, bf, yf, n, K, N, inv_act_scale, act_scale, v, s); break;
    case 8: err = launch<8>(xf, wq, ws, bf, yf, n, K, N, inv_act_scale, act_scale, v, s); break;
    case 4: err = launch<4>(xf, wq, ws, bf, yf, n, K, N, inv_act_scale, act_scale, v, s); break;
    case 2: err = launch<2>(xf, wq, ws, bf, yf, n, K, N, inv_act_scale, act_scale, v, s); break;
    default: err = launch<1>(xf, wq, ws, bf, yf, n, K, N, inv_act_scale, act_scale, v, s); break;
  }
  return static_cast<int>(err);
}
