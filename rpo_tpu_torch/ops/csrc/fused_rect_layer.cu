// The two halves of a bias-free rect transformer layer, each one launch, for
// Hopper (sm_90a), plain C interface, bf16 only.
//
// Replaces the TPU kernels of rpo_tpu/ops/fused_rect_layer.py:
//   fused_rect_attn_half (pallas_call at :185, body _attn_half_kernel
//     :62-107) and fused_mlp_half (pallas_call at :225, body _mlp_half_kernel
//     :110-126), composed by fused_rect_residual_block (:237-249): the RPO
//     eval vision tower's layer (rect_residual_block), x (100, 221, 768) with
//     n_kv = 197 frozen rows, 12 heads of 64, at ViT-B/16.
//
// What each computes, per token row, in this order (the order of the TPU bodies):
//   attention half, x (B, L, d):
//   y  = LN1(x): f32 two-pass (mean, then mean((x - mean)^2)), times
//        rsqrt(var + eps), times the scale and plus the bias (both bf16 values
//        taken to f32), three separate roundings; y rounded to bf16
//   q  = y @ Wq for all L rows; k, v = y @ W{k,v} for the rows < n_kv only
//        (the rows past n_kv are never projected): f32 accumulation rounded
//        to bf16, THEN + bias in bf16 (two roundings)
//   per head: s = (q . k) in f32, times dh^-1/2 (one rounding); s - max, exp,
//        divided by the sum, all f32, normalised BEFORE the cast to bf16;
//        o = p . v accumulated in f32 and rounded to bf16; heads concatenated
//   out = x + (o @ Wout rounded, + bias rounded), the residual add in bf16
//   MLP half, x flattened to (B * L, d) rows:
//   z  = LN2(x) as LN1
//   h  = z @ Wfc rounded, + bias rounded; QuickGELU with a bf16 rounding after
//        every op: t = 1.703125 * h (1.702 in bf16), e = exp(-t), den = 1 + e,
//        sig = 1 / den, h = h * sig
//   out = x + (h @ Wproj rounded, + bias rounded)
// Every row of a sequence reads only the keys of its own sequence.
//
// Bound at (100, 221, 768), n_kv 197, 12 heads, from the H100 SXM data sheet
// (989 TFLOP/s dense bf16, 3.35 TB/s): attention half 98.6 GFLOP of
// projections + 13.4 GFLOP of attention = 112.0 GFLOP -> 0.113 ms by
// operations (its 72.6 MB of x, out and weights alone take 0.022 ms); MLP
// half 208.6 GFLOP -> 0.211 ms by operations (77.3 MB: 0.023 ms).
// chip_smoke.py recomputes both for the card it runs on.
//
// Design: right and simple first.  The TPU kernel holds two whole (221, 768)
// sequences in VMEM; one sequence's LN1 output alone (340 KB) is over a
// block's 227 KB of shared memory here.  So one block of 512 threads (16
// warps) takes one sequence and walks it in 64-row chunks, three times:
//   1. LN1 of the chunk into shared memory, then its q (all rows) and k, v
//      (rows < n_kv) on the tensor cores (gemm_tiles of
//      fused_layer_common.cuh: mma.sync m16n8k16 over fragment-major weights
//      from L2, each warp a 16-column tile for all four row tiles of the
//      chunk, so that a block loads each weight fragment once), rounded
//      with their biases into a (B * L, 3d) scratch;
//   2. per head, K_h and V_h (n_kv x 64, zero-padded to a multiple of 16
//      rows) in shared memory; per 64-row chunk of Q_h, the f32 scores on
//      the tensor cores (A = Q_h, B = K_h by ldmatrix), the softmax in f32
//      in shared memory, p rounded to bf16 (exactly the A operand of the next
//      product), o = p . v on the tensor cores (B = V_h by ldmatrix.trans),
//      rounded into the scratch over Q_h's columns of those rows (Q_h's tile
//      is in shared memory by then);
//   3. the chunk's head outputs into shared memory, the out projection, and
//      the residual add into the output.
// At 100 sequences that is 100 blocks on 132 SMs.  Attention is 12% of this
// half's operations, hence the tensor cores there too.
// The MLP half is the second half of the whole-layer text kernel on 64-row
// blocks of the flattened rows (mlp_passes of fused_layer_common.cuh): LN2
// in shared memory, 256-wide hidden chunks (16 column tiles, one per warp,
// each for all four row tiles: one load of each weight fragment a block;
// 12-20% faster than the text kernel's 128-wide chunks and split row tiles
// at the RPO shape, the same outputs), an f32 down-projection accumulator
// in shared memory, in column passes where it does not fit (two at d = 768,
// which recompute the fc products once more; 227 KB exactly).  No TMA, no
// wgmma and no shared-memory pipeline yet: a later PR's work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (rpo_tpu_torch/ops/_build.py).

#include "fused_layer_common.cuh"

namespace {

using namespace fused_layer;

constexpr int kChunk = 64;                    // rows a block works on at a time
constexpr int kChunkTiles = kChunk / kTile;
constexpr int kHidden = 256;                  // MLP hidden columns per chunk: 16 column tiles
constexpr int kDh = 64;                       // the head dim the attention half takes
constexpr int kLdh = kDh + kPadBf16;          // row stride of K_h, V_h and the q tile
constexpr int kMaxKeys = 256;

// Error codes beside cudaError_t's (which are >= 0).
constexpr int kErrShape = -1;
constexpr int kErrSharedMemory = -3;

struct AttnParams {
  const bf16* x;       // (B, L, d)
  bf16* out;           // (B, L, d)
  bf16* qkv;           // (B * L, 3d) scratch: q | k | v, then the head outputs over q
  const bf16* ln1_s; const bf16* ln1_b;
  const bf16* qkv_w; const bf16* qkv_b;   // (d, 3d) fragment-major, (3d,)
  const bf16* out_w; const bf16* out_b;   // (d, d) fragment-major, (d,)
  int L, d, n_heads, n_kv;
  float scale, eps;
};

struct AttnLayout {  // byte offsets into dynamic shared memory
  int ldy, nkp, lds, ldp;
  size_t kh, vh, qt, s, p, total;
};

__host__ __device__ inline AttnLayout attn_layout(int d, int n_kv) {
  AttnLayout o;
  o.ldy = d + kPadBf16;  // phases 1 and 3: one chunk of LN1 output or head outputs
  o.nkp = round_up(n_kv, kTile);
  o.lds = o.nkp + kPadF32;
  o.ldp = o.nkp + kPadBf16;
  // phase 2, over the same bytes
  o.kh = 0;
  o.vh = o.kh + sizeof(bf16) * o.nkp * kLdh;
  o.qt = o.vh + sizeof(bf16) * o.nkp * kLdh;
  o.s = o.qt + sizeof(bf16) * kChunk * kLdh;
  o.p = o.s + sizeof(float) * kChunk * o.lds;
  const size_t attn_end = o.p + sizeof(bf16) * kChunk * o.ldp;
  const size_t y_end = sizeof(bf16) * kChunk * o.ldy;
  o.total = attn_end > y_end ? attn_end : y_end;
  return o;
}

__device__ __forceinline__ void store_pair(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__global__ void __launch_bounds__(kThreads) fused_rect_attn_half_kernel(const AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = p.L, d = p.d, n_kv = p.n_kv, ld3 = 3 * d;
  const AttnLayout lay = attn_layout(d, n_kv);
  const size_t row0 = (size_t)blockIdx.x * L;
  const bf16* x = p.x + row0 * d;
  bf16* out = p.out + row0 * d;
  bf16* qkv = p.qkv + row0 * ld3;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q4 = lane % 4;  // the accumulators' row and column pair
  bf16* Y = reinterpret_cast<bf16*>(smem);
  const int ldy = lay.ldy;

  // ---- 1. LN1, q for every row, k and v for the rows < n_kv -------------
  for (int r0 = 0; r0 < L; r0 += kChunk) {
    const int nq = min(kChunk, L - r0), nkv = min(kChunk, n_kv - r0);
    layer_norm_rows(x + (size_t)r0 * d, nq, round_up(nq, kTile), d, p.ln1_s, p.ln1_b, p.eps, Y,
                    ldy);
    __syncthreads();
    bf16* dst = qkv + (size_t)r0 * ld3;
    gemm_tiles<1, kChunkTiles>(
        Y, ldy, p.qkv_w, ld3 / kTile, d, d / kTile, round_up(nq, kTile) / kTile,
        [](int t) { return t; }, nullptr, 0, [&](int r, int t, int cl, float v0, float v1) {
          if (r >= nq) return;
          const int c = t * kTile + cl;
          store_pair(dst + (size_t)r * ld3 + c, bf(v0) + f(p.qkv_b[c]), bf(v1) + f(p.qkv_b[c + 1]));
        });
    if (nkv > 0)
      gemm_tiles<1, kChunkTiles>(
          Y, ldy, p.qkv_w, ld3 / kTile, d, 2 * d / kTile, round_up(nkv, kTile) / kTile,
          [&](int t) { return d / kTile + t; }, nullptr, 0,
          [&](int r, int t, int cl, float v0, float v1) {
            if (r >= nkv) return;
            const int c = d + t * kTile + cl;
            store_pair(dst + (size_t)r * ld3 + c, bf(v0) + f(p.qkv_b[c]),
                       bf(v1) + f(p.qkv_b[c + 1]));
          });
    __syncthreads();
  }

  // ---- 2. per head: scores, softmax, p . v --------------------------------
  bf16* Kh = reinterpret_cast<bf16*>(smem + lay.kh);
  bf16* Vh = reinterpret_cast<bf16*>(smem + lay.vh);
  bf16* Qt = reinterpret_cast<bf16*>(smem + lay.qt);
  float* S = reinterpret_cast<float*>(smem + lay.s);
  bf16* P = reinterpret_cast<bf16*>(smem + lay.p);
  const int nkp = lay.nkp, nkt = nkp / kTile, lds = lay.lds, ldp = lay.ldp;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int h = 0; h < p.n_heads; ++h) {
    // K_h and V_h, zero past n_kv (p is zero there, and 0 x garbage may be NaN)
    for (int idx = tid; idx < 2 * nkp * (kDh / 8); idx += kThreads) {
      const int which = idx / (nkp * (kDh / 8)), j = idx / (kDh / 8) % nkp, seg = idx % (kDh / 8);
      uint4 v = zero;
      if (j < n_kv)
        v = *reinterpret_cast<const uint4*>(qkv + (size_t)j * ld3 + (1 + which) * d + h * kDh +
                                            seg * 8);
      *reinterpret_cast<uint4*>((which ? Vh : Kh) + j * kLdh + seg * 8) = v;
    }
    for (int r0 = 0; r0 < L; r0 += kChunk) {
      const int nq = min(kChunk, L - r0), mt = round_up(nq, kTile) / kTile;
      bf16* qrows = qkv + (size_t)r0 * ld3 + h * kDh;
      for (int idx = tid; idx < kChunk * (kDh / 8); idx += kThreads) {
        const int r = idx / (kDh / 8), seg = idx % (kDh / 8);
        uint4 v = zero;
        if (r < nq) v = *reinterpret_cast<const uint4*>(qrows + (size_t)r * ld3 + seg * 8);
        *reinterpret_cast<uint4*>(Qt + r * kLdh + seg * 8) = v;
      }
      __syncthreads();
      // s = (q . k) * dh^-1/2, one 16x16 tile of (rows, keys) per warp at a time
      for (int t = warp; t < mt * nkt; t += kWarps) {
        const int i = t / nkt, n = t % nkt;
        float c[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kDh / kTile; ++kk) {
          uint32_t a[4], b[4];
          ldmatrix_x4(a, Qt + (i * kTile + lane % 16) * kLdh + kk * kTile + (lane / 16) * 8);
          ldmatrix_x4(b, Kh + (n * kTile + (lane / 16) * 8 + lane % 8) * kLdh + kk * kTile +
                             (lane / 8) % 2 * 8);
          mma_16x8x16(c[0], a, b[0], b[1]);
          mma_16x8x16(c[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int hn = 0; hn < 2; ++hn)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = i * kTile + g + half * 8, col = n * kTile + hn * 8 + 2 * q4;
            *reinterpret_cast<float2*>(S + r * lds + col) =
                make_float2(__fmul_rn(c[hn][2 * half], p.scale),
                            __fmul_rn(c[hn][2 * half + 1], p.scale));
          }
      }
      __syncthreads();
      // softmax per row in f32, normalised, then rounded to bf16; zero past
      // n_kv and on the padded rows
      for (int r = warp; r < mt * kTile; r += kWarps) {
        float* srow = S + r * lds;
        bf16* prow = P + r * ldp;
        if (r >= nq) {
          for (int j = lane; j < nkp; j += 32) prow[j] = __float2bfloat16(0.f);
          continue;
        }
        float m = -3.402823466e+38f;
        for (int j = lane; j < n_kv; j += 32) m = fmaxf(m, srow[j]);
#pragma unroll
        for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float sum = 0.f;
        for (int j = lane; j < n_kv; j += 32) {
          const float e = expf(srow[j] - m);
          srow[j] = e;
          sum += e;
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        for (int j = lane; j < nkp; j += 32)
          prow[j] = __float2bfloat16(j < n_kv ? srow[j] / sum : 0.f);
      }
      __syncthreads();
      // o = p . v, f32 accumulation, rounded, over q_h's columns of these rows
      for (int t = warp; t < mt * (kDh / kTile); t += kWarps) {
        const int i = t / (kDh / kTile), n = t % (kDh / kTile);
        float c[2][4] = {};
        for (int kk = 0; kk < nkt; ++kk) {
          uint32_t a[4], b[4];
          ldmatrix_x4(a, P + (i * kTile + lane % 16) * ldp + kk * kTile + (lane / 16) * 8);
          ldmatrix_x4_trans(b, Vh + (kk * kTile + (lane / 8) % 2 * 8 + lane % 8) * kLdh +
                                   n * kTile + (lane / 16) * 8);
          mma_16x8x16(c[0], a, b[0], b[1]);
          mma_16x8x16(c[1], a, b[2], b[3]);
        }
#pragma unroll
        for (int hn = 0; hn < 2; ++hn)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = i * kTile + g + half * 8;
            if (r < nq)
              store_pair(qrows + (size_t)r * ld3 + n * kTile + hn * 8 + 2 * q4, c[hn][2 * half],
                         c[hn][2 * half + 1]);
          }
      }
      // the next chunk's q tile goes to Qt, read last before the sync above;
      // P and V_h are read here and written again only after two more syncs
    }
    __syncthreads();  // K_h and V_h are free for the next head
  }

  // ---- 3. out projection and the residual add: out = x + (o @ Wout + b) ---
  for (int r0 = 0; r0 < L; r0 += kChunk) {
    const int nq = min(kChunk, L - r0), rows = round_up(nq, kTile);
    for (int idx = tid; idx < rows * (d / 8); idx += kThreads) {
      const int r = idx / (d / 8), c = idx % (d / 8) * 8;
      uint4 v = zero;
      if (r < nq) v = *reinterpret_cast<const uint4*>(qkv + (size_t)(r0 + r) * ld3 + c);
      *reinterpret_cast<uint4*>(Y + (size_t)r * ldy + c) = v;
    }
    __syncthreads();
    gemm_tiles<1, kChunkTiles>(
        Y, ldy, p.out_w, d / kTile, d, d / kTile, rows / kTile, [](int t) { return t; }, nullptr,
        0, [&](int r, int t, int cl, float v0, float v1) {
          if (r >= nq) return;
          const int c = t * kTile + cl;
          const size_t e = (size_t)(r0 + r) * d + c;
          const float o0 = bf(bf(v0) + f(p.out_b[c])), o1 = bf(bf(v1) + f(p.out_b[c + 1]));
          store_pair(out + e, f(x[e]) + o0, f(x[e + 1]) + o1);
        });
    __syncthreads();
  }
}

struct MlpParams {
  const bf16* x;       // (rows, d)
  bf16* out;           // (rows, d)
  const bf16* ln2_s; const bf16* ln2_b;
  const bf16* fc_w; const bf16* fc_b;     // (d, 4d) fragment-major, (4d,)
  const bf16* proj_w; const bf16* proj_b; // (4d, d) fragment-major, (d,)
  int rows, d, passes;
  float eps;
};

__host__ __device__ inline size_t mlp_y_bytes(int d) {
  return sizeof(bf16) * kChunk * (d + kPadBf16);
}

__global__ void __launch_bounds__(kThreads) fused_mlp_half_kernel(const MlpParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int d = p.d, ldy = d + kPadBf16;
  const int first = blockIdx.x * kChunk;
  const size_t row0 = first;
  const int n_valid = min(kChunk, p.rows - first);
  const int rows = round_up(n_valid, kTile);
  bf16* Y = reinterpret_cast<bf16*>(smem);
  float* ACC = reinterpret_cast<float*>(smem + mlp_y_bytes(d));
  bf16* H = reinterpret_cast<bf16*>(smem + mlp_y_bytes(d) +
                                    sizeof(float) * kChunk * (d / p.passes + kPadF32));
  const bf16* x = p.x + row0 * d;
  layer_norm_rows(x, n_valid, rows, d, p.ln2_s, p.ln2_b, p.eps, Y, ldy);
  __syncthreads();
  mlp_passes<1, 1, kChunkTiles, kHidden>(
      Y, ldy, rows, n_valid, d, p.passes, p.fc_w, p.fc_b, p.proj_w, p.proj_b, ACC, H, x,
      p.out + row0 * d);
}

cudaError_t max_shared_memory(int device, int* bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

}  // namespace

extern "C" {

// x, out: (B, L, d) bf16, contiguous; qkv: (B * L, 3d) bf16 scratch; LayerNorm
// parameters and biases bf16; qkv_w (d, 3d) and out_w (d, d) bf16 (in, out) in
// the fragment-major layout of gemm_tiles, 16-byte aligned.  Takes head dim 64,
// d = 64 * n_heads <= 768, 1 <= n_kv <= min(L, 256), B >= 1.  Returns 0, a
// cudaError_t code (> 0), or one of the negative codes above.
int fused_rect_attn_half_forward(int device, const void* x, void* out, void* qkv,
                                 const void* ln1_s, const void* ln1_b, const void* qkv_w,
                                 const void* qkv_b, const void* out_w, const void* out_b, int B,
                                 int L, int d, int n_heads, int n_kv, float scale, float eps,
                                 void* stream) {
  if (B < 1 || L < 1 || n_kv < 1 || n_kv > L || n_kv > kMaxKeys || n_heads < 1 ||
      d != n_heads * kDh || d > kMaxWidth)
    return kErrShape;
  int max_smem = 0;
  cudaError_t err = max_shared_memory(device, &max_smem);
  if (err != cudaSuccess) return err;
  const AttnLayout lay = attn_layout(d, n_kv);
  if (lay.total > (size_t)max_smem) return kErrSharedMemory;
  AttnParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.qkv = static_cast<bf16*>(qkv);
  p.ln1_s = static_cast<const bf16*>(ln1_s); p.ln1_b = static_cast<const bf16*>(ln1_b);
  p.qkv_w = static_cast<const bf16*>(qkv_w); p.qkv_b = static_cast<const bf16*>(qkv_b);
  p.out_w = static_cast<const bf16*>(out_w); p.out_b = static_cast<const bf16*>(out_b);
  p.L = L; p.d = d; p.n_heads = n_heads; p.n_kv = n_kv;
  p.scale = scale; p.eps = eps;
  err = cudaFuncSetAttribute(fused_rect_attn_half_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return err;
  fused_rect_attn_half_kernel<<<B, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// x, out: (rows, d) bf16, contiguous; LayerNorm parameters and biases bf16;
// fc_w (d, 4d) and proj_w (4d, d) bf16 (in, out) in the fragment-major layout
// of gemm_tiles, 16-byte aligned.  Takes d a multiple of 64 up to 768, rows >=
// 1.  Returns as above.
int fused_mlp_half_forward(int device, const void* x, void* out, const void* ln2_s,
                           const void* ln2_b, const void* fc_w, const void* fc_b,
                           const void* proj_w, const void* proj_b, int rows, int d, float eps,
                           void* stream) {
  if (rows < 1 || d < 64 || d % 64 || d > kMaxWidth) return kErrShape;
  int max_smem = 0;
  cudaError_t err = max_shared_memory(device, &max_smem);
  if (err != cudaSuccess) return err;
  int passes = 0;  // the least column-pass count whose accumulator fits
  for (int pc = 1; pc <= d / kTile && passes == 0; ++pc)
    if ((d / kTile) % pc == 0 &&
        mlp_y_bytes(d) + mlp_bytes(kChunk, d, pc, kHidden) <= (size_t)max_smem)
      passes = pc;
  if (passes == 0) return kErrSharedMemory;
  const size_t smem = mlp_y_bytes(d) + mlp_bytes(kChunk, d, passes, kHidden);
  MlpParams p;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.ln2_s = static_cast<const bf16*>(ln2_s); p.ln2_b = static_cast<const bf16*>(ln2_b);
  p.fc_w = static_cast<const bf16*>(fc_w); p.fc_b = static_cast<const bf16*>(fc_b);
  p.proj_w = static_cast<const bf16*>(proj_w); p.proj_b = static_cast<const bf16*>(proj_b);
  p.rows = rows; p.d = d; p.passes = passes;
  p.eps = eps;
  err = cudaFuncSetAttribute(fused_mlp_half_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + kChunk - 1) / kChunk;
  fused_mlp_half_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

const char* fused_rect_layer_error_string(int code) {
  switch (code) {
    case kErrShape:
      return "unsupported shape (attention: head dim 64, d <= 768, 1 <= n_kv <= min(L, 256); "
             "MLP: d a multiple of 64 up to 768)";
    case kErrSharedMemory: return "no block layout fits shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
