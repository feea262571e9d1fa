// Device code shared by the fused layer kernels (fused_text_layer.cu and
// fused_rect_layer.cu), for Hopper (sm_90a), bf16 only: the tensor-core
// products over fragment-major weights, the f32 LayerNorm of a block's rows,
// and the instructions of a cp.async ring.
//
// Numerics are the TPU kernels' (rpo_tpu/ops/fused_text_layer.py
// _layer_kernel, rpo_tpu/ops/fused_rect_layer.py _attn_half_kernel and
// _mlp_half_kernel): LayerNorm in f32, two-pass, with the scale and bias
// bf16 values taken to f32 and the result rounded to bf16; every projection
// accumulated in f32 and rounded to bf16 BEFORE its bf16 bias is added (two
// roundings).  Each file that includes this header compiles on its own into
// its own library, so nothing here is shared at link time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused_layer {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;            // a 16x16 output tile: two m16n8k16 products
constexpr int kMaxWidth = 768;
constexpr int kPadBf16 = 8;          // row padding of bf16 ldmatrix operands
constexpr int kPadF32 = 4;           // row padding of the f32 accumulator
constexpr int kDepth = 4;            // B fragments a warp loads before their products

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16(x)); }
__device__ __forceinline__ float f(bf16 x) { return __bfloat162float(x); }

// A fragment of mma.m16n8k16 (16x16 bf16, row-major) from shared memory:
// lane l gives the address of row l % 16, columns (l / 16) * 8 ...
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Four 8x8 matrices from shared memory, each transposed on the way: lane l
// receives elements (2 (l % 4), l / 4) and (2 (l % 4) + 1, l / 4) of matrix
// r for register r, the B fragment of m16n8k16 taken from a row-major (k, n)
// matrix.  Lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// c += a (16x16) . b (16x8), bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_16x8x16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory by 32-bit address (one register where a pointer takes two),
// and the instructions of a cp.async ring.  In a namespace of their own:
// fused_text_layer.cu still defines copies of some of them under the same
// names.
namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from device memory into shared memory, or src_bytes of them (0:
// zeros, nothing read) and zeros after.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most kPending of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
// fused_layer::ldmatrix_x4 by address.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

}  // namespace ptx

// One warp's share of C = A @ B over a block's row tiles, on the tensor cores
// (mma.sync m16n8k16, f32 accumulators): the warps split the mt row tiles
// into kGroups groups (at most kGroupTiles tiles each), and each of the
// kWarps / kGroups warps of a group takes the output column tiles t = w, w +
// kWarps / kGroups, ... < n_tiles, each 16 wide, for its group's row tiles
// (so kGroups warps load each B fragment).  A is (mt * 16, K) bf16
// row-major at lda in shared memory.  B
// is a (K, nb * 16) bf16 matrix in device memory in the fragment-major
// layout the wrapper builds: its 16x16 tile (kt, n) is 512 contiguous bytes
// at (kt * nb + n) * 256 elements, 16 per lane, in the order of that lane's
// two m16n8k16 B fragments, so each lane loads a k-step's B with one 16-byte
// load.  Output tile t reads B's column tile col(t).  B is loaded kDepth
// k-steps ahead of its products, into registers: the loads' latency from
// L2, not the tensor cores, is what this loop has to hide.  With acc !=
// nullptr the accumulators start from and go back to the f32 matrix acc (ld
// ld_acc, column tile t at t * 16); otherwise they start at 0 and each lane
// hands its finished pairs of adjacent columns to epi(row, t, column in the
// tile, value, value of the next column).
template <int kGroups, int kGroupTiles, typename Col, typename Epi>
__device__ __forceinline__ void gemm_tiles(const bf16* A, int lda, const bf16* B, int nb, int K,
                                           int n_tiles, int mt, Col col, float* acc, int ld_acc,
                                           Epi epi) {
  constexpr int kColWarps = kWarps / kGroups;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;  // the accumulators' row and column pair
  const int per_group = (mt + kGroups - 1) / kGroups;
  const int i0 = warp / kColWarps * per_group;  // this warp's first row tile
  const int ni = min(per_group, mt - i0);       // and how many
  if (ni <= 0) return;
  const bf16* a_lane = A + (size_t)(i0 * kTile + lane % 16) * lda + (lane / 16) * 8;
  const int nk = K / kTile;
  const size_t k_stride = (size_t)nb * kTile * kTile / 8;  // uint4s from one k-step to the next
  for (int t = warp % kColWarps; t < n_tiles; t += kColWarps) {
    float c[kGroupTiles][2][4];
#pragma unroll
    for (int ii = 0; ii < kGroupTiles; ++ii) {
      const int i = i0 + ii;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ii < ni && acc != nullptr) {
          const float* a0 = acc + (size_t)(i * kTile + g) * ld_acc + t * kTile + h * 8 + q * 2;
          const float2 lo = *reinterpret_cast<const float2*>(a0);
          const float2 hi = *reinterpret_cast<const float2*>(a0 + 8 * ld_acc);
          c[ii][h][0] = lo.x; c[ii][h][1] = lo.y; c[ii][h][2] = hi.x; c[ii][h][3] = hi.y;
        } else {
          c[ii][h][0] = c[ii][h][1] = c[ii][h][2] = c[ii][h][3] = 0.f;
        }
      }
    }
    const uint4* b_lane = reinterpret_cast<const uint4*>(B + (size_t)col(t) * kTile * kTile) + lane;
    uint4 next[kDepth];
#pragma unroll
    for (int s = 0; s < kDepth; ++s)
      if (s < nk) next[s] = __ldg(b_lane + s * k_stride);
    for (int k = 0; k < nk; k += kDepth) {
      uint4 cur[kDepth];
#pragma unroll
      for (int s = 0; s < kDepth; ++s) cur[s] = next[s];
#pragma unroll
      for (int s = 0; s < kDepth; ++s)
        if (k + kDepth + s < nk) next[s] = __ldg(b_lane + (k + kDepth + s) * k_stride);
#pragma unroll
      for (int s = 0; s < kDepth; ++s) {
        if (k + s < nk) {
#pragma unroll
          for (int ii = 0; ii < kGroupTiles; ++ii) {
            if (ii < ni) {
              uint32_t a[4];
              ldmatrix_x4(a, a_lane + (size_t)ii * kTile * lda + (k + s) * kTile);
              mma_16x8x16(c[ii][0], a, cur[s].x, cur[s].y);
              mma_16x8x16(c[ii][1], a, cur[s].z, cur[s].w);
            }
          }
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < kGroupTiles; ++ii) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (ii < ni) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = (i0 + ii) * kTile + g + half * 8, cl = h * 8 + q * 2;
            const float v0 = c[ii][h][2 * half], v1 = c[ii][h][2 * half + 1];
            if (acc != nullptr)
              *reinterpret_cast<float2*>(acc + (size_t)r * ld_acc + t * kTile + cl) =
                  make_float2(v0, v1);
            else
              epi(r, t, cl, v0, v1);
          }
        }
      }
    }
  }
}

// LayerNorm of the block's valid rows of src (device memory, row stride d)
// into Y (bf16, ld ldy); rows past n_valid up to the padded count are zero.
__device__ inline void layer_norm_rows(const bf16* src, int n_valid, int rows, int d,
                                       const bf16* scale, const bf16* bias, float eps, bf16* Y,
                                       int ldy) {
  constexpr int kPairs = kMaxWidth / 64;  // bf16 pairs per lane at most
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pairs = d / 64;               // d is a multiple of 32: d / 2 pairs over 32 lanes
  const int tail = (d / 2) % 32;          // lanes holding one more pair
  for (int r = warp; r < rows; r += kWarps) {
    bf16* y = Y + (size_t)r * ldy;
    if (r >= n_valid) {
      for (int c = lane; c < d; c += 32) y[c] = __float2bfloat16(0.f);
      continue;
    }
    const __nv_bfloat162* row = reinterpret_cast<const __nv_bfloat162*>(src + (size_t)r * d);
    float2 v[kPairs + 1];
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p <= kPairs; ++p) {
      if (p < pairs || (p == pairs && lane < tail)) {
        v[p] = __bfloat1622float2(row[p * 32 + lane]);
        sum += v[p].x + v[p].y;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum / d;
    float sq = 0.f;
#pragma unroll
    for (int p = 0; p <= kPairs; ++p) {
      if (p < pairs || (p == pairs && lane < tail)) {
        const float a = __fsub_rn(v[p].x, mean), b = __fsub_rn(v[p].y, mean);
        sq = __fadd_rn(sq, __fmul_rn(a, a));
        sq = __fadd_rn(sq, __fmul_rn(b, b));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rstd = rsqrtf(__fadd_rn(sq / d, eps));
#pragma unroll
    for (int p = 0; p <= kPairs; ++p) {
      if (p < pairs || (p == pairs && lane < tail)) {
        const int c = 2 * (p * 32 + lane);
        const float a = __fmul_rn(__fsub_rn(v[p].x, mean), rstd);
        const float b = __fmul_rn(__fsub_rn(v[p].y, mean), rstd);
        y[c] = __float2bfloat16(__fadd_rn(__fmul_rn(a, f(scale[c])), f(bias[c])));
        y[c + 1] = __float2bfloat16(__fadd_rn(__fmul_rn(b, f(scale[c + 1])), f(bias[c + 1])));
      }
    }
  }
}

// The body of a LayerNorm launch (fused_rect_layer.cu's LN1 and LN2): rows
// of x (rows, d) into z (rows, d), both row-major at d, kWarps rows a block
// of kThreads, one warp a row.
__device__ __forceinline__ void layer_norm_launch(const bf16* x, bf16* z, const bf16* scale,
                                                  const bf16* bias, int rows, int d, float eps) {
  const int first = blockIdx.x * kWarps, n = min(kWarps, rows - first);
  layer_norm_rows(x + (size_t)first * d, n, n, d, scale, bias, eps, z + (size_t)first * d, d);
}

}  // namespace fused_layer
