// The two halves of a bias-free rect transformer layer, for Hopper (sm_90a),
// plain C interface, bf16 only: the attention half one launch, the MLP half
// three (LN2, fc, proj).
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
// The MLP half is three launches, two of them tensor-core GEMMs with the
// contract's epilogues fused, over the flattened rows and a (rows, 5d) bf16
// scratch the wrapper allocates:
//   1. z = LN2(x) into the scratch, one warp a row (layer_norm_rows).  LN2
//      is not folded into fc's prologue: fc's 128-row block would have to
//      hold its z rows for all of K (128 x 776 x 2 = 198,656 B), one block
//      an SM and no room for the ring, or normalise every A stage again on
//      its way in, which cp.async cannot do;
//   2. h = QuickGELU(bf(z @ Wfc) + b_fc) into the scratch, (rows, 4d);
//   3. out = x + bf(bf(h @ Wproj) + b_proj).
// Both products run fused_mlp_half_gemm_kernel: a 128 x 128 output tile a
// block of 8 warps, 64 x 32 a warp (4 x 2 tiles of 16, 64 f32 accumulators
// a thread in registers for the whole K loop), two blocks an SM (128
// registers a thread).  A (row-major, rows padded by 8 bf16 so that
// ldmatrix meets no bank conflict) and B (the fragment-major 512-byte tiles
// the wrapper hands over: a lane's B fragments one 16-byte shared load)
// come through a ring of 3 stages of 64 k-columns (104,448 B a block),
// 16-byte cp.async copies issued by every thread, one cp.async.wait_group
// and one barrier a stage.  Per 16 k-columns a warp loads 4 A and 2 B
// fragments for 16 mma.sync: 192 B of shared memory read a product, and
// the ring writes 64 B more.  The epilogues work from the accumulators in
// bf16x2 ops, two columns an instruction, each rounding once to bf16 (the
// f32 op's value rounded, since f32 carries more than 2 x 8 + 2 bits): the
// QuickGELU fc takes 0.42 ms that way, 0.50 in f32 ops and roundings.
// Ragged rows load zeros (a copy of source size 0) and store nothing.
// Every output element adds its k-steps in ascending order, one mma.sync
// m16n8k16 a k-step, from 0, as the 64-row column-pass kernel before it did
// (whose f32 accumulator went through shared memory, exactly), so the
// output is the same bit for bit.
// At (22100, 768): fc is 173 x 24 = 4,152 tiles, proj 173 x 6 = 1,038, on
// 264 block slots.  Bound: 208.6 GFLOP at 989 TFLOP/s, 0.211 ms; z and h
// add 170 MB written and read once (0.10 ms at 3.35 TB/s), less than the
// recompute and the shared-memory traffic that keeping h on chip cost the
// 64-row kernel.  What bounds it (PERF.md; tools/time_fused.py's split by
// kernel, on an H100 SXM at 700 W): fc takes 0.42 ms, proj 0.33 ms, LN2 0.036 ms; each
// GEMM is 104.3 GFLOP, so proj runs at 314 TFLOP/s and fc, with its
// QuickGELU and 136 MB of h to store, at 248.  mma.sync and the shared-
// memory traffic above each allow about half the dense peak at this tile;
// deeper rings, an L2 prefetch hint, 64 x 64 warp tiles (8 warps an SM)
// and 256-wide block tiles were no faster.  No TMA, no wgmma, no
// persistent grid yet.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (rpo_tpu_torch/ops/_build.py).

#include "fused_layer_common.cuh"

namespace {

using namespace fused_layer;
using namespace fused_layer::ptx;

constexpr int kChunk = 64;                    // rows a block works on at a time
constexpr int kChunkTiles = kChunk / kTile;
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

// ---- the MLP half: LN2, then two tensor-core GEMMs with fused epilogues --

// The GEMM core (mlp_launch_plan in ops/fused_rect_layer.py mirrors these
// constants): a block of kGemmThreads takes a kGemmRows x kGemmCols output
// tile; its 8 warps, 2 down by 4 across, take 64 x 32 each (4 row tiles by
// 2 column tiles of 16, 64 f32 accumulators a thread).  A and B come through
// a ring of kGemmStages stages of kGemmK k-columns each.
constexpr int kGemmRows = 128;
constexpr int kGemmCols = 128;
constexpr int kGemmK = 64;
constexpr int kGemmStages = 3;
constexpr int kGemmThreads = 256;
constexpr int kGemmBlocksPerSm = 2;  // __launch_bounds__' minimum: 128 registers a thread
constexpr int kGemmWarpRows = 64;
constexpr int kGemmWarpCols = 32;
constexpr int kGemmColWarps = kGemmCols / kGemmWarpCols;
constexpr int kWarpRowTiles = kGemmWarpRows / kTile;
constexpr int kWarpColTiles = kGemmWarpCols / kTile;
constexpr int kLda = kGemmK + kPadBf16;  // A's row stride in a stage: ldmatrix without conflicts
constexpr int kTileElems = kTile * kTile;  // one fragment-major B tile, 512 bytes
constexpr int kStageA = sizeof(bf16) * kGemmRows * kLda;
constexpr int kStageB = sizeof(bf16) * kGemmK * kGemmCols;
constexpr int kStageBytes = kStageA + kStageB;
constexpr int kGemmSmem = kGemmStages * kStageBytes;
constexpr int kLnRows = kWarps;  // rows of an LN2 block of kThreads: one warp a row

static_assert(kGemmThreads / 32 == (kGemmRows / kGemmWarpRows) * kGemmColWarps,
              "the warps cover the block tile");
static_assert(kGemmRows * kGemmK / 8 % kGemmThreads == 0, "A's 16-byte copies split evenly");
static_assert(kGemmK * kGemmCols / 8 % kGemmThreads == 0, "B's 16-byte copies split evenly");

enum Epilogue { kFcGelu, kProjResidual };

struct GemmParams {
  const bf16* A;     // (M, K) row-major
  const bf16* B;     // (K, N) fragment-major
  const bf16* bias;  // (N,)
  const bf16* res;   // (M, N), the residual (proj only)
  bf16* C;           // (M, N)
  int M, N, K;
};

// z = LN2(x), kLnRows rows a block, one warp a row.
__global__ void __launch_bounds__(kThreads) fused_mlp_half_ln2_kernel(
    const bf16* x, bf16* z, const bf16* scale, const bf16* bias, int rows, int d, float eps) {
  const int first = blockIdx.x * kLnRows, n = min(kLnRows, rows - first);
  layer_norm_rows(x + (size_t)first * d, n, n, d, scale, bias, eps, z + (size_t)first * d, d);
}

// One kGemmRows x kGemmCols tile of C = epilogue(A @ B).  Tile t of the
// grid is row panel t / n_tiles, column block t % n_tiles: the blocks in
// flight share their A rows in L2.  Ragged rows load zeros and store
// nothing.  N is a multiple of 64: where it is not one of 128 (proj at d
// an odd multiple of 64), the last column block's right-hand warps have no
// products.  Every output element sums its k-steps in ascending order, one
// mma.sync a k-step, from 0.
template <int kEpi>
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm)
    fused_mlp_half_gemm_kernel(const GemmParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_tiles = (p.N + kGemmCols - 1) / kGemmCols;
  const int row0 = blockIdx.x / n_tiles * kGemmRows, col0 = blockIdx.x % n_tiles * kGemmCols;
  const int ncols = min(kGemmCols, p.N - col0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kGemmColWarps, wn = warp % kGemmColWarps;
  const bool active = wn * kGemmWarpCols < ncols;
  const int nk = p.K / kGemmK, nb = p.N / kTile;
  const uint32_t base = smem_addr(smem);

  // stage kt into its slot: A's kGemmRows rows of kGemmK columns, 16 bytes
  // a copy; B's kGemmK / 16 k-steps of the block's column tiles, each run
  // of tiles contiguous in the fragment-major layout
  auto load = [&](int kt) {
    const uint32_t a_dst = base + kt % kGemmStages * kStageBytes, b_dst = a_dst + kStageA;
#pragma unroll
    for (int it = 0; it < kGemmRows * kGemmK / 8 / kGemmThreads; ++it) {
      const int i = tid + it * kGemmThreads;
      const int r = i / (kGemmK / 8), c = i % (kGemmK / 8), gr = row0 + r;
      const bf16* src = p.A + (size_t)(gr < p.M ? gr : 0) * p.K + kt * kGemmK + c * 8;
      cp_async16(a_dst + (r * kLda + c * 8) * 2, src, gr < p.M ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < kGemmK * kGemmCols / 8 / kGemmThreads; ++it) {
      const int i = tid + it * kGemmThreads;
      const int ks = i / (kGemmCols * kTile / 8), piece = i % (kGemmCols * kTile / 8);
      const size_t tile = (size_t)(kt * (kGemmK / kTile) + ks) * nb + col0 / kTile;
      if (piece / (kTileElems / 8) * kTile < ncols)
        cp_async16(b_dst + i * 16, p.B + tile * kTileElems + piece * 8);
    }
  };

  float c[kWarpRowTiles][2 * kWarpColTiles][4];
#pragma unroll
  for (int i = 0; i < kWarpRowTiles; ++i)
#pragma unroll
    for (int j = 0; j < 2 * kWarpColTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) c[i][j][e] = 0.f;
  const uint32_t a_lane =
      base + ((wm * kGemmWarpRows + lane % 16) * kLda + (lane / 16) * 8) * 2;
  const uint32_t b_lane = base + kStageA + wn * kWarpColTiles * kTileElems * 2 + lane * 16;

#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt has landed, and every warp is done with the slot that
    // stage kt + kGemmStages - 1 takes
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();
    if (kt + kGemmStages - 1 < nk) load(kt + kGemmStages - 1);
    cp_async_commit();
    if (!active) continue;
    const uint32_t slot = kt % kGemmStages * kStageBytes;
#pragma unroll
    for (int ks = 0; ks < kGemmK / kTile; ++ks) {
      uint4 b[kWarpColTiles];
#pragma unroll
      for (int j = 0; j < kWarpColTiles; ++j)
        b[j] = lds128(b_lane + slot + (ks * (kGemmCols / kTile) + j) * kTileElems * 2);
#pragma unroll
      for (int i = 0; i < kWarpRowTiles; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, a_lane + slot + (i * kTile * kLda + ks * kTile) * 2);
#pragma unroll
        for (int j = 0; j < kWarpColTiles; ++j) {
          mma_16x8x16(c[i][2 * j], a, b[j].x, b[j].y);
          mma_16x8x16(c[i][2 * j + 1], a, b[j].z, b[j].w);
        }
      }
    }
  }
  if (!active) return;

  // the epilogue, from the accumulators: lane (g, q) holds rows g and g + 8
  // of each row tile, columns 2q and 2q + 1 of each 8-column half
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < kWarpRowTiles; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm * kGemmWarpRows + i * kTile + g + half * 8;
      if (r >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 2 * kWarpColTiles; ++j) {
        const int col = col0 + wn * kGemmWarpCols + j * 8 + 2 * q;
        const size_t e = (size_t)r * p.N + col;
        // two columns a bf16x2 op, each op rounded once to bf16: the same
        // value as the f32 op rounded, since f32 carries more than 2 x 8 + 2
        // significant bits
        const __nv_bfloat162 acc =
            __floats2bfloat162_rn(c[i][j][2 * half], c[i][j][2 * half + 1]);
        const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p.bias + col);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p.C + e);
        if constexpr (kEpi == kFcGelu) {
          // h = QuickGELU(bf(z @ Wfc) + b_fc), rounded after every op: t =
          // 1.703125 h (1.702 in bf16), e = exp(-t), den = 1 + e, sig =
          // 1 / den (correctly rounded in f32, as 1.f / den), h * sig
          const __nv_bfloat162 hv = __hadd2(acc, b);
          const float2 t1 = __bfloat1622float2(__hmul2(__float2bfloat162_rn(1.703125f), hv));
          const __nv_bfloat162 ex = __floats2bfloat162_rn(expf(-t1.x), expf(-t1.y));
          const float2 den = __bfloat1622float2(__hadd2(__float2bfloat162_rn(1.f), ex));
          *dst = __hmul2(hv, __floats2bfloat162_rn(__frcp_rn(den.x), __frcp_rn(den.y)));
        } else {
          // out = x + bf(bf(h @ Wproj) + b_proj)
          *dst = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(p.res + e), __hadd2(acc, b));
        }
      }
    }
}

// The grids of the MLP half's three launches at (rows, d); 0 or kErrShape.
struct MlpPlan {
  int ln2_grid, fc_grid, proj_grid;
};
int mlp_plan(int rows, int d, MlpPlan* plan) {
  if (rows < 1 || d < 64 || d % 64 || d > kMaxWidth) return kErrShape;
  const int m_tiles = (rows + kGemmRows - 1) / kGemmRows;
  plan->ln2_grid = (rows + kLnRows - 1) / kLnRows;
  plan->fc_grid = m_tiles * ((4 * d + kGemmCols - 1) / kGemmCols);
  plan->proj_grid = m_tiles * ((d + kGemmCols - 1) / kGemmCols);
  return 0;
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

// x, out: (rows, d) bf16, contiguous; scratch: rows x 5d bf16 (z = LN2(x),
// rows x d, then h, rows x 4d); LayerNorm parameters and biases bf16; fc_w
// (d, 4d) and proj_w (4d, d) bf16 (in, out) in the fragment-major layout of
// gemm_tiles, 16-byte aligned.  Takes d a multiple of 64 up to 768, rows >=
// 1.  Three launches on the stream: LN2, fc, proj.  Returns as above.
int fused_mlp_half_forward(int device, const void* x, void* out, void* scratch,
                           const void* ln2_s, const void* ln2_b, const void* fc_w,
                           const void* fc_b, const void* proj_w, const void* proj_b, int rows,
                           int d, float eps, void* stream) {
  MlpPlan plan;
  int rc = mlp_plan(rows, d, &plan);
  if (rc != 0) return rc;
  int max_smem = 0;
  cudaError_t err = max_shared_memory(device, &max_smem);
  if (err != cudaSuccess) return err;
  if (kGemmSmem > max_smem) return kErrSharedMemory;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* z = static_cast<bf16*>(scratch);
  bf16* h = z + (size_t)rows * d;
  fused_mlp_half_ln2_kernel<<<plan.ln2_grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), z, static_cast<const bf16*>(ln2_s),
      static_cast<const bf16*>(ln2_b), rows, d, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const GemmParams fc{z, static_cast<const bf16*>(fc_w), static_cast<const bf16*>(fc_b), nullptr,
                      h, rows, 4 * d, d};
  err = cudaFuncSetAttribute(fused_mlp_half_gemm_kernel<kFcGelu>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return err;
  fused_mlp_half_gemm_kernel<kFcGelu><<<plan.fc_grid, kGemmThreads, kGemmSmem, s>>>(fc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const GemmParams pr{h, static_cast<const bf16*>(proj_w), static_cast<const bf16*>(proj_b),
                      static_cast<const bf16*>(x), static_cast<bf16*>(out), rows, d, 4 * d};
  err = cudaFuncSetAttribute(fused_mlp_half_gemm_kernel<kProjResidual>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (err != cudaSuccess) return err;
  fused_mlp_half_gemm_kernel<kProjResidual><<<plan.proj_grid, kGemmThreads, kGemmSmem, s>>>(pr);
  return cudaGetLastError();
}

// The launch plan of fused_mlp_half_forward at (rows, d), into out[11]: the
// launches; grid, threads and dynamic shared bytes of LN2, of fc and of
// proj; the scratch elements (mlp_launch_plan in ops/fused_rect_layer.py
// is its mirror).  Returns 0 or kErrShape.
int fused_mlp_half_plan(int rows, int d, long long* out) {
  MlpPlan plan;
  const int rc = mlp_plan(rows, d, &plan);
  if (rc != 0) return rc;
  const long long v[] = {3,
                         plan.ln2_grid, kThreads, 0,
                         plan.fc_grid, kGemmThreads, kGemmSmem,
                         plan.proj_grid, kGemmThreads, kGemmSmem,
                         5LL * rows * d};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
  return 0;
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
