// quant_dense: the int8 dense layer of a quantized serving bundle, one launch.
//
//   y[i, j] = float(sum_k x_q[i, k] * W_q[k, j]) * (w_scale[j] * act_scale) + b[j]
//   x_q     = int8(clip(rint(x * inv_act_scale), -127, 127))
//
// Replaces gan_deeplearning4j_tpu/ops/linear.py::quant_dense (lines 34-66),
// which XLA lowers (it is not a Pallas kernel). Built by nvcc for sm_90a into
// a shared library with a plain C interface and loaded with ctypes
// (gan_deeplearning4j_tpu_torch/ops/_native.py); the wrapper, the launch plan
// and the plain PyTorch version are gan_deeplearning4j_tpu_torch/ops/linear.py.
//
// Numerics, equal bit for bit to the plain version:
// - the reciprocal is the wrapper's float32(1.0 / act_scale), multiplied in
//   fp32 (__fmul_rn), as the reference's x * (1.0 / act_scale) does; x /
//   act_scale would move some codes by one;
// - rintf rounds half to even, as jnp.round and torch.round do (roundf would
//   round half away from zero); the clip is to +-127;
// - the sum is an exact int32: |acc| reaches 127 * 127 * 1152 = 18,580,608
//   > 2^24 on dis_dense_layer_6, which an fp32 sum would round. Integer sums
//   are exact in any order, so the split of k across the CTAs of a cluster
//   and the tensor cores' order give the same bits;
// - the epilogue is scale = w_scale * act_scale, then float(acc) * scale,
//   then + b, each rounded on its own (__fmul_rn / __fadd_rn, and the library
//   is built with -fmad=false): no FMA contraction.
//
// What bounds it on an H100 SXM (132 SMs, 3.35 TB/s HBM3, 1,979 int8 TOP/s).
// For dis_dense_layer_6 (K = 1152, N = 1024) at n = 128 the call must move
// x (590 KB fp32), W_q (1.18 MB) and y (524 KB), about 2.30 MB, 0.69 us,
// against 2 * 128 * 1152 * 1024 = 302 M int8 operations, 0.15 us; at n = 1
// the bound is the 1.18 MB weight read, 0.36 us. Bytes bound it, and at
// these sizes in practice the latency of a few dependent round trips to HBM
// and the launch. The first design (a dp4a k-walk of 18 dependent steps per
// thread, 16 CTAs at n <= 8, CUDA cores only) took 13-24 us cold. This
// design, item by item:
// 1. every W_q byte a CTA needs is requested before its first wait: one
//    thread issues the CTA's W_q tile (a K-chunk of rows x a strip of output
//    columns) as one TMA 2D copy (cp.async.bulk.tensor over W_q as stored,
//    (K, N) int8) where N is a multiple of 16 bytes (TMA's stride rule), or
//    as one cp.async.bulk of the chunk's full-width rows, which are one
//    contiguous run, where it is not (dis_output_layer_7, N = 10). Both
//    complete on one mbarrier. While they fly, every thread loads its share
//    of x's chunk (up to 8 float4 loads in flight each) and the epilogue's
//    w_scale and bias, and quantizes x into shared memory. (x landed by one
//    bulk copy per row needed a 40-80 KB landing zone, which cut the CTAs an
//    SM holds until a 128-row tile ran in two waves: 39.6 us.)
// 2. a thread-block cluster of up to 8 CTAs (the portable limit) owns one
//    output strip of 16, 32 or 64 columns and splits K: each CTA takes one
//    K-chunk (a multiple of 32; the last one is ragged, and TMA zero-fills
//    rows past K). The int32 partial sums are reduced exactly through
//    distributed shared memory: each CTA owns a slice of the strip's
//    outputs, the others store their partials of it into its shared memory
//    16 bytes at a time, and it sums them and runs the fused epilogue on its
//    slice. One launch, no global scratch, no atomics, a deterministic
//    result. dis_dense_layer_6 at n = 1 runs 16 strips x 8 CTAs = 128 CTAs.
//    Row tiles are 8-64 rows (the plan keeps >= 128 CTAs before it grows
//    one past 8 rows); rows past a tile add a grid dimension;
// 3. the product runs on the int8 tensor cores: mma.sync m16n8k32 s8 with
//    swapped operands (W_q's output features are the 16-row side, x's rows
//    the 8-column side; rows past n are zero codes). The fragments need 4
//    contiguous k bytes per feature, and W_q is stored N-contiguous, so the
//    landed tile is transposed once in shared memory by 4 x 4 byte patches
//    (__byte_perm), and W_q's stored layout does not change. No .satfinite:
//    |acc| <= 18.6 M is far inside int32. mma.sync rather than wgmma: int8
//    wgmma takes only K-major shared-memory operands, which would need W_q
//    re-laid out, and the kernel is bound by bytes and latency, not by the
//    tensor cores' rate.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py (m), PERF.md
// section 6): 5.9-11.8 us cold on dis_dense_layer_6 and
// 4.5-4.9 us on dis_output_layer_7 at n = 1-128, against bounds of 0.36-0.69
// and 0.004-0.16 us: a launch, one HBM round trip, the transposes and two
// cluster barriers.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may use on sm_90

enum Route { kTma = 0, kBulk = 1 };

// Everything a launch needs but the tensor map: the layer's constants (set
// once per layer) and the call's (x, y, n, the row tile).
struct Args {
  const float* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  float* y;
  int n, K, N;
  float inv_act_scale, act_scale;
  int route, strip, cluster, kc, box_k, boxes;
  int ld;     // words per row of the k-contiguous code tiles (kc / 4 + pad)
  int ws_ld;  // bytes per row of the landed W_q tile
  int slice;  // outputs of a strip's row tile that each CTA of the cluster reduces
  int off_wt, off_xs, off_stage, off_part, off_ep, off_bar;  // shared-memory offsets, bytes
};

struct Layer {
  CUtensorMap tmap;  // first: 64-byte aligned by the allocation
  Args args;
};

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// words per row of a k-contiguous tile of kc bytes, padded so that the
// fragment loads of a warp (8 rows x 4 words) fall in 32 different banks
__host__ __device__ inline int padded_words(int kc) {
  const int w = kc / 4;
  return w + ((12 - w) & 31);
}

// The shared-memory layout for a row tile of 8 * nt rows; the wrapper's
// plan (ops/linear.py::_smem_bytes) computes the same total.
int layout(Args& a, int nt) {
  const int rt = 8 * nt;
  // a bulk tile is the chunk's full-width rows; its transpose reads up to a
  // strip past the last row's first column
  const int w_bytes = a.route == kTma ? a.boxes * a.box_k * a.strip : a.kc * a.N + a.strip;
  a.ld = padded_words(a.kc);
  a.ws_ld = a.route == kTma ? a.strip : a.N;
  a.off_wt = round_up(w_bytes, 128);
  a.off_xs = a.off_wt + round_up(a.strip * a.ld * 4, 128);
  a.off_stage = a.off_xs + round_up(rt * a.ld * 4, 128);
  a.off_part = a.off_stage + round_up(rt * (a.strip + 4) * 4, 128);
  a.slice = round_up((rt * a.strip + a.cluster - 1) / a.cluster, 4);
  a.off_ep = a.off_part + round_up(a.slice * a.cluster * 4, 128);
  a.off_bar = a.off_ep + round_up(2 * a.strip * 4, 128);
  return a.off_bar + 16;
}

__device__ __forceinline__ unsigned quantize_byte(float v, float inv) {
  float q = rintf(__fmul_rn(v, inv));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<unsigned>(static_cast<int>(q)) & 0xffu;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_parity0(unsigned bar) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(0u) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mma_s8(int c[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One CTA: K-chunk `rank` of output strip `strip_idx`, rows
// [row0, row0 + 8 * NT). Grid: (strips * cluster, row tiles); cluster
// (cluster, 1, 1).
template <int NT>
__global__ void __launch_bounds__(kThreads, 3)
quant_dense_kernel(const __grid_constant__ CUtensorMap tmap, const Args a) {
  constexpr int RT = 8 * NT;
  constexpr int PAIRS = (4 * NT + kWarps - 1) / kWarps;  // 8-row tiles a warp owns, at most
  constexpr int U = 8;                                    // x loads in flight per thread
  extern __shared__ __align__(1024) unsigned char smem[];
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);
  unsigned* wt = reinterpret_cast<unsigned*>(smem + a.off_wt);  // [strip][ld] k-contiguous W_q
  unsigned* xs = reinterpret_cast<unsigned*>(smem + a.off_xs);  // [RT][ld] x codes
  int* stage = reinterpret_cast<int*>(smem + a.off_stage);      // [RT][strip + 4] partial sums
  int* part = reinterpret_cast<int*>(smem + a.off_part);        // [cluster][slice] partial sums
  float* ep = reinterpret_cast<float*>(smem + a.off_ep);        // the strip's scales, then biases
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + a.off_bar);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int strip_idx = blockIdx.x / a.cluster;
  const int k0 = rank * a.kc;
  const int kn = min(a.kc, a.K - k0);  // > 0: the plan makes no empty chunk
  const int j0 = strip_idx * a.strip;
  const int row0 = blockIdx.y * RT;
  const int rows = min(RT, a.n - row0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kcw = a.kc / 4;
  const int sld = a.strip + 4;  // stage row stride: a warp's stores hit 32 banks
  const unsigned bar_a = smem_addr(bar);
  const unsigned w_bulk_bytes = a.route == kBulk ? static_cast<unsigned>(kn * a.N) & ~15u : 0u;

  // this CTA has started: the others may store into its shared memory once
  // they have waited for that (step 5)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // 1. one thread requests the CTA's whole W_q tile
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const unsigned w_bytes = a.route == kTma ? static_cast<unsigned>(a.boxes * a.box_k * a.strip)
                                             : w_bulk_bytes;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar_a), "r"(w_bytes) : "memory");
    if (a.route == kTma) {
      for (int b = 0; b < a.boxes; ++b)
        tma_load_2d(smem_addr(w_s + b * a.box_k * a.strip), &tmap, j0, k0 + b * a.box_k, bar_a);
    } else if (w_bulk_bytes > 0) {
      bulk_load(smem_addr(w_s), a.w + static_cast<size_t>(k0) * a.N, w_bulk_bytes, bar_a);
    }
  }
  // the epilogue's per-column w_scale and bias (strip <= 64 < kThreads),
  // loaded now and stored once x's loads are in flight too
  const int ep_col = j0 + tid;
  const bool ep_mine = tid < a.strip && ep_col < a.N;
  const float ep_scale = ep_mine ? __ldg(a.w_scale + ep_col) : 0.0f;
  const float ep_bias = ep_mine && a.bias != nullptr ? __ldg(a.bias + ep_col) : 0.0f;
  if (a.route == kBulk) {
    // the chunk's last (< 16) bytes, which a bulk copy cannot carry
    const int tail = kn * a.N - static_cast<int>(w_bulk_bytes);
    for (int i = tid; i < tail; i += kThreads)
      w_s[w_bulk_bytes + i] = a.w[static_cast<size_t>(k0) * a.N + w_bulk_bytes + i];
  }

  // 2. while W_q flies, quantize the chunk of x's rows into k-contiguous
  //    codes (zero past n and past the chunk), U float4 loads in flight a
  //    thread (scalar loads where K % 4 or x's alignment forbid float4)
  const bool x_vec = (a.K % 4 == 0) && ((reinterpret_cast<uintptr_t>(a.x) & 15) == 0);
  const float* xb = a.x + static_cast<size_t>(row0) * a.K + k0;
  for (int base = tid; base < RT * kcw; base += U * kThreads) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * kThreads;
      const int r = idx / kcw;
      const int k = 4 * (idx - r * kcw);
      v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (idx < RT * kcw && r < rows && k < kn) {
        const float* src = xb + static_cast<size_t>(r) * a.K + k;
        if (x_vec) {
          v[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          v[u].x = __ldg(src);
          if (k + 1 < kn) v[u].y = __ldg(src + 1);
          if (k + 2 < kn) v[u].z = __ldg(src + 2);
          if (k + 3 < kn) v[u].w = __ldg(src + 3);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * kThreads;
      if (idx < RT * kcw) {
        const int r = idx / kcw;
        const int q = idx - r * kcw;
        xs[r * a.ld + q] = quantize_byte(v[u].x, a.inv_act_scale) |
                           quantize_byte(v[u].y, a.inv_act_scale) << 8 |
                           quantize_byte(v[u].z, a.inv_act_scale) << 16 |
                           quantize_byte(v[u].w, a.inv_act_scale) << 24;
      }
    }
  }
  if (tid < a.strip) {
    ep[tid] = __fmul_rn(ep_scale, a.act_scale);
    ep[a.strip + tid] = ep_bias;
  }
  __syncthreads();  // the mbarrier's init, the tail bytes and the epilogue's columns
  wait_parity0(bar_a);

  // 3. transpose the landed W_q tile (k rows x features, feature-contiguous)
  //    into k-contiguous words per feature, 4 x 4 bytes at a time. Rows past
  //    the chunk meet zero x codes, columns past N are never stored.
  if (a.ws_ld % 4 == 0) {
    const int groups = a.strip / 4;
    const int row_words = a.ws_ld / 4;
    const unsigned* ws32 = reinterpret_cast<const unsigned*>(w_s);
    for (int idx = tid; idx < kcw * groups; idx += kThreads) {
      const int q = idx / groups;
      const int c = idx - q * groups;
      const int base = 4 * q * row_words + c;
      const unsigned r0 = ws32[base];
      const unsigned r1 = ws32[base + row_words];
      const unsigned r2 = ws32[base + 2 * row_words];
      const unsigned r3 = ws32[base + 3 * row_words];
      const unsigned lo01 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const unsigned hi01 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const unsigned lo23 = __byte_perm(r2, r3, 0x5140);
      const unsigned hi23 = __byte_perm(r2, r3, 0x7362);
      wt[(4 * c + 0) * a.ld + q] = __byte_perm(lo01, lo23, 0x5410);  // k 4q..4q+3 of feature 4c
      wt[(4 * c + 1) * a.ld + q] = __byte_perm(lo01, lo23, 0x7632);
      wt[(4 * c + 2) * a.ld + q] = __byte_perm(hi01, hi23, 0x5410);
      wt[(4 * c + 3) * a.ld + q] = __byte_perm(hi01, hi23, 0x7632);
    }
  } else {
    // full-width rows of a ragged N are not word-aligned: byte by byte
    const uint8_t* wb = reinterpret_cast<const uint8_t*>(w_s);
    for (int idx = tid; idx < kcw * a.strip; idx += kThreads) {
      const int f = idx / kcw;
      const int q = idx - f * kcw;
      unsigned word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) word |= static_cast<unsigned>(wb[(4 * q + t) * a.ws_ld + f]) << (8 * t);
      wt[f * a.ld + q] = word;
    }
  }
  __syncthreads();

  // 4. the product on the int8 tensor cores. The strip is 16, 32 or 64
  //    features (mt = 1, 2 or 4 tiles of 16), so warp w keeps feature tile
  //    w % mt, loads its A fragment once a k-step, and takes the 8-row tiles
  //    w / mt, w / mt + 8 / mt, ...
  const int mt = a.strip / 16;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int m_tile = warp % mt;
  const int n_first = warp / mt;
  const int n_step = kWarps / mt;
  int acc[PAIRS][4];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  const unsigned* fa = wt + (16 * m_tile + g) * a.ld + t4;
  for (int ks = 0; ks < kcw; ks += 8) {
    const unsigned a0 = fa[ks], a1 = fa[ks + 8 * a.ld], a2 = fa[ks + 4], a3 = fa[ks + 8 * a.ld + 4];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int n_tile = n_first + n_step * i;
      if (n_tile < NT) {
        const unsigned* fb = xs + (8 * n_tile + g) * a.ld + ks + t4;
        mma_s8(acc[i], a0, a1, a2, a3, fb[0], fb[4]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int n_tile = n_first + n_step * i;
    if (n_tile < NT) {
      const int f = 16 * m_tile + g;
      const int r = 8 * n_tile + 2 * t4;
      stage[r * sld + f] = acc[i][0];
      stage[(r + 1) * sld + f] = acc[i][1];
      stage[r * sld + f + 8] = acc[i][2];
      stage[(r + 1) * sld + f + 8] = acc[i][3];
    }
  }
  __syncthreads();

  // 5. exact reduction over the cluster's K-chunks through distributed shared
  //    memory: the strip's RT x strip outputs (in row-major order) are cut
  //    into slices of `slice`, and CTA q owns slice q. Every CTA copies its
  //    partial sums of slice q into CTA q's slot for it, 16 bytes a store
  //    (remote stores do not wait), then each CTA sums its slots and runs
  //    the fused epilogue on its slice.
  const int total = RT * a.strip;
  const int slice = a.slice;
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every CTA has started
  for (int v = tid; v < total / 4; v += kThreads) {
    const int o = 4 * v;
    const int r = o / a.strip;
    const int f = o - r * a.strip;
    const int owner = o / slice;
    *reinterpret_cast<int4*>(cluster.map_shared_rank(part, owner) + rank * slice + o - owner * slice) =
        *reinterpret_cast<const int4*>(stage + r * sld + f);
  }
  cluster.sync();
  const int first = rank * slice;
  for (int j = tid; j < slice && first + j < total; j += kThreads) {
    const int o = first + j;
    const int r = o / a.strip;
    const int f = o - r * a.strip;
    const int row = row0 + r;
    const int col = j0 + f;
    if (r >= rows || col >= a.N) continue;
    int s = 0;
    for (int q = 0; q < a.cluster; ++q) s += part[q * slice + j];
    float v = __fmul_rn(__int2float_rn(s), ep[f]);
    if (a.bias != nullptr) v = __fadd_rn(v, ep[a.strip + f]);
    a.y[static_cast<size_t>(row) * a.N + col] = v;
  }
}

template <int NT>
cudaError_t launch(const Layer& layer, const Args& a, int row_tiles, int smem, cudaStream_t stream) {
  static bool attribute_set = false;  // idempotent: a race only sets it twice
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        quant_dense_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attribute_set = true;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((a.N + a.strip - 1) / a.strip * a.cluster, row_tiles, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = a.cluster;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, quant_dense_kernel<NT>, layer.tmap, a);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda call, reached through the runtime's entry
// point: the library needs no -lcuda
cudaError_t encode_tiled(CUtensorMap* map, const void* w, int K, int N, int strip, int box_k) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                     cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess) return err;
  if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N)};  // bytes, a multiple of 16
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(strip), static_cast<cuuint32_t>(box_k)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = reinterpret_cast<EncodeTiled>(fn)(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // NONE: out-of-bound elements read as zero
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// A layer's constant part: W_q (K, N) int8, w_scale (N,) fp32 and bias (N,)
// fp32 or null, contiguous, 16-byte aligned, on the current device; the
// wrapper's plan (route 0 = TMA, 1 = bulk; strip; cluster; K-chunk; TMA box
// rows and count). Encodes the TMA tensor map once. Returns the handle, or
// null with *err set.
extern "C" void* gdt_quant_dense_layer_new(const void* w, const void* w_scale, const void* bias,
                                           int K, int N, float inv_act_scale, float act_scale,
                                           int route, int strip, int cluster, int kc, int box_k,
                                           int boxes, int* err) {
  *err = static_cast<int>(cudaErrorInvalidValue);
  if (K <= 0 || N <= 0 || (strip != 16 && strip != 32 && strip != 64) || cluster < 1 || cluster > 8 ||
      kc % 32 != 0 || (reinterpret_cast<uintptr_t>(w) & 15) != 0 ||
      (route == kTma && (N % 16 != 0 || box_k <= 0 || box_k > 256 || strip > 256 ||
                         boxes * box_k < kc)) ||
      (route == kBulk && strip < N) || (route != kTma && route != kBulk) ||
      (cluster - 1) * kc >= K || cluster * kc < K)
    return nullptr;
  Layer* layer = static_cast<Layer*>(aligned_alloc(128, round_up(sizeof(Layer), 128)));
  if (layer == nullptr) return nullptr;
  memset(layer, 0, sizeof(Layer));
  Args& a = layer->args;
  a.w = static_cast<const int8_t*>(w);
  a.w_scale = static_cast<const float*>(w_scale);
  a.bias = static_cast<const float*>(bias);
  a.K = K;
  a.N = N;
  a.inv_act_scale = inv_act_scale;
  a.act_scale = act_scale;
  a.route = route;
  a.strip = strip;
  a.cluster = cluster;
  a.kc = kc;
  a.box_k = box_k;
  a.boxes = boxes;
  if (route == kTma) {
    const cudaError_t e = encode_tiled(&layer->tmap, w, K, N, strip, box_k);
    if (e != cudaSuccess) {
      free(layer);
      *err = static_cast<int>(e);
      return nullptr;
    }
  }
  *err = 0;
  return layer;
}

extern "C" void gdt_quant_dense_layer_free(void* layer) { free(layer); }

// One launch: x (n, K) fp32 and y (n, N) fp32, contiguous, on the layer's
// device; nt (1, 2, 4 or 8) rows of 8 per row tile, row_tiles of them;
// smem the plan's shared-memory bytes, checked against this file's layout.
// Returns the launch's cudaError_t (0 on success).
extern "C" int gdt_quant_dense_run(const void* layer_handle, const void* x, void* y, int n, int nt,
                                   int row_tiles, int smem, void* stream) {
  const Layer& layer = *static_cast<const Layer*>(layer_handle);
  Args a = layer.args;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.n = n;
  if (n <= 0 || row_tiles <= 0 || row_tiles > 65535 || (row_tiles - 1) * 8 * nt >= n ||
      row_tiles * 8 * nt < n || layout(a, nt) != smem || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 1: return static_cast<int>(launch<1>(layer, a, row_tiles, smem, s));
    case 2: return static_cast<int>(launch<2>(layer, a, row_tiles, smem, s));
    case 4: return static_cast<int>(launch<4>(layer, a, row_tiles, smem, s));
    case 8: return static_cast<int>(launch<8>(layer, a, row_tiles, smem, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
