// The two halves of a bias-free rect transformer layer, for Hopper (sm_90a),
// plain C interface, bf16 only: the attention half four launches (LN1, q/k/v,
// attention, out), the MLP half three (LN2, fc, proj).
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
// Design.  The attention half is four launches on the call's stream, over
// the flattened rows and a (B * L, 4d) bf16 scratch the wrapper allocates:
// z, (B * L, d), then q | k | v, (B * L, 3d):
//   1. z = LN1(x), one warp a row (layer_norm_launch, LN2's body);
//   2. q | k | v in one launch of the GEMM core below, with the bias
//      epilogue bf(acc) + b: its grid holds the q tiles (all B * L rows, d
//      columns) and then the k/v tiles (the B * n_kv rows < n_kv of every
//      sequence, gathered: row r reads and writes sequence row
//      (r / n_kv) * L + r % n_kv; 2d columns of Wqkv from column tile d / 16).
//      The rows past n_kv are never projected, as in the TPU kernel;
//   3. the attention: attention_tc.cuh's body (rect_attention.cu's bf16
//      kernel) at the score width its dispatch picks for n_kv (13 tiles at
//      197), reading q, k and v in place at strides (L * 3d, 64, 3d) and
//      writing o over z, which is dead by then, at (L * d, 64, d): one block
//      of 4 warps a (b, h), 1,200 blocks at the RPO layer, three an SM;
//   4. out = x + bf(bf(o @ Wout) + b_out) on the GEMM core with the residual
//      epilogue, as the MLP's proj.
// The TPU kernel holds two whole (221, 768) sequences in VMEM; one
// sequence's LN1 output alone (340 KB) is over a block's 227 KB of shared
// memory here, so the half goes through device memory (z, q, k, v and o
// written and read once: 9.6 x 34 MB at the RPO layer, 0.10 ms at 3.35
// TB/s, less what L2 keeps) in exchange for launches that each fill the
// card.  Every product sums its k-steps as gemm_tiles did in the one-launch
// kernel before it (one m16n8k16 a k-step, ascending, from 0), so q, k, v
// and, given the same o, the output are the same bits as that kernel's; the
// softmax's row sum is taken in another order (per lane over its
// accumulators, then across the quad, against a lane-strided sum and a
// 5-step xor tree), so a p or an output element may differ by a rounding
// flip.
// The MLP half is three launches, two of them tensor-core GEMMs with the
// contract's epilogues fused, over the flattened rows and a (rows, 5d) bf16
// scratch the wrapper allocates:
//   1. z = LN2(x) into the scratch, one warp a row (layer_norm_launch).  LN2
//      is not folded into fc's prologue: fc's 128-row block would have to
//      hold its z rows for all of K (128 x 776 x 2 = 198,656 B), one block
//      an SM and no room for the ring, or normalise every A stage again on
//      its way in, which cp.async cannot do;
//   2. h = QuickGELU(bf(z @ Wfc) + b_fc) into the scratch, (rows, 4d);
//   3. out = x + bf(bf(h @ Wproj) + b_proj).
// Both products, and the attention half's two, run one GEMM core (gemm_tile
// below, behind a thin kernel of each half's name): a 128 x 128 output tile a
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
#include "attention_tc.cuh"

namespace {

using namespace fused_layer;
using namespace fused_layer::ptx;

constexpr int kDh = 64;                       // the head dim the attention half takes
constexpr int kMaxKeys = 256;

// Error codes beside cudaError_t's (which are >= 0).
constexpr int kErrShape = -1;
constexpr int kErrSharedMemory = -3;

// The GEMM core (mlp_launch_plan and attn_launch_plan in
// ops/fused_rect_layer.py mirror these constants): a block of kGemmThreads
// takes a kGemmRows x kGemmCols output tile; its 8 warps, 2 down by 4
// across, take 64 x 32 each (4 row tiles by 2 column tiles of 16, 64 f32
// accumulators a thread).  A and B come through a ring of kGemmStages
// stages of kGemmK k-columns each.
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
constexpr int kLnRows = kWarps;  // rows of a LayerNorm block of kThreads: one warp a row

static_assert(kGemmThreads / 32 == (kGemmRows / kGemmWarpRows) * kGemmColWarps,
              "the warps cover the block tile");
static_assert(kGemmRows * kGemmK / 8 % kGemmThreads == 0, "A's 16-byte copies split evenly");
static_assert(kGemmK * kGemmCols / 8 % kGemmThreads == 0, "B's 16-byte copies split evenly");

// C = bf(acc) + b (q, k, v); QuickGELU of that (fc); res + (bf(acc) + b) (proj, out)
enum Epilogue { kBias, kFcGelu, kProjResidual };

struct GemmParams {
  const bf16* A;     // (M, K) row-major: row r at A + map(r) * K
  const bf16* B;     // (K, N) of a fragment-major matrix of nb column tiles
  const bf16* bias;  // (N,)
  const bf16* res;   // the residual, row r at res + map(r) * ldc (kProjResidual only)
  bf16* C;           // row r at C + map(r) * ldc, N columns
  int M, N, K;
  int ldc, nb;
  int seg, L;        // kGather: map(r) = (r / seg) * L + r % seg; otherwise map(r) = r
};

// One kGemmRows x kGemmCols tile of C = epilogue(A @ B), tile t of a
// problem: row panel t / n_tiles, column block t % n_tiles, so that the
// blocks in flight share their A rows in L2.  Ragged rows load zeros and
// store nothing.  N is a multiple of 64: where it is not one of 128 (proj
// at d an odd multiple of 64), the last column block's right-hand warps
// have no products.  Every output element sums its k-steps in ascending
// order, one mma.sync a k-step, from 0.
template <int kEpi, bool kGather>
__device__ __forceinline__ void gemm_tile(const GemmParams& p, int t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_tiles = (p.N + kGemmCols - 1) / kGemmCols;
  const int row0 = t / n_tiles * kGemmRows, col0 = t % n_tiles * kGemmCols;
  const int ncols = min(kGemmCols, p.N - col0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kGemmColWarps, wn = warp % kGemmColWarps;
  const bool active = wn * kGemmWarpCols < ncols;
  const int nk = p.K / kGemmK, nb = p.nb;
  const uint32_t base = smem_addr(smem);
  auto map = [&](int r) { return kGather ? r / p.seg * p.L + r % p.seg : r; };
  // kGather: the source row of each of this thread's A copies, the same in
  // every stage, or -1 past M (the row map's divisions once a tile, not once
  // a stage: 14% of the q/k/v GEMM's time)
  constexpr int kACopies = kGemmRows * kGemmK / 8 / kGemmThreads;
  int a_row[kACopies];
  if constexpr (kGather) {
#pragma unroll
    for (int it = 0; it < kACopies; ++it) {
      const int gr = row0 + (tid + it * kGemmThreads) / (kGemmK / 8);
      a_row[it] = gr < p.M ? map(gr) : -1;
    }
  }

  // stage kt into its slot: A's kGemmRows rows of kGemmK columns, 16 bytes
  // a copy; B's kGemmK / 16 k-steps of the block's column tiles, each run
  // of tiles contiguous in the fragment-major layout
  auto load = [&](int kt) {
    const uint32_t a_dst = base + kt % kGemmStages * kStageBytes, b_dst = a_dst + kStageA;
#pragma unroll
    for (int it = 0; it < kGemmRows * kGemmK / 8 / kGemmThreads; ++it) {
      const int i = tid + it * kGemmThreads;
      const int r = i / (kGemmK / 8), c = i % (kGemmK / 8), gr = row0 + r;
      if constexpr (kGather) {
        const bf16* src = p.A + (size_t)(a_row[it] < 0 ? 0 : a_row[it]) * p.K + kt * kGemmK + c * 8;
        cp_async16(a_dst + (r * kLda + c * 8) * 2, src, a_row[it] < 0 ? 0 : 16);
      } else {
        const bf16* src = p.A + (size_t)(gr < p.M ? gr : 0) * p.K + kt * kGemmK + c * 8;
        cp_async16(a_dst + (r * kLda + c * 8) * 2, src, gr < p.M ? 16 : 0);
      }
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
      const size_t row = (size_t)map(r) * p.ldc;
#pragma unroll
      for (int j = 0; j < 2 * kWarpColTiles; ++j) {
        const int col = col0 + wn * kGemmWarpCols + j * 8 + 2 * q;
        const size_t e = row + col;
        // two columns a bf16x2 op, each op rounded once to bf16: the same
        // value as the f32 op rounded, since f32 carries more than 2 x 8 + 2
        // significant bits
        const __nv_bfloat162 acc =
            __floats2bfloat162_rn(c[i][j][2 * half], c[i][j][2 * half + 1]);
        const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p.bias + col);
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(p.C + e);
        if constexpr (kEpi == kBias) {
          // q, k, v = bf(y @ W) + b
          *dst = __hadd2(acc, b);
        } else if constexpr (kEpi == kFcGelu) {
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

// ---- the attention half: LN1, q/k/v, the attention, out -----------------

__global__ void __launch_bounds__(kThreads) fused_rect_attn_half_ln1_kernel(
    const bf16* x, bf16* z, const bf16* scale, const bf16* bias, int rows, int d, float eps) {
  layer_norm_launch(x, z, scale, bias, rows, d, eps);
}

// The q tiles (blocks < q_tiles), then the gathered k/v tiles.
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm)
    fused_rect_attn_half_qkv_kernel(const GemmParams q, const GemmParams kv, int q_tiles) {
  if ((int)blockIdx.x < q_tiles)
    gemm_tile<kBias, false>(q, blockIdx.x);
  else
    gemm_tile<kBias, true>(kv, blockIdx.x - q_tiles);
}

template <int NT>
__global__ void __launch_bounds__(attention_tc::kTcThreads, attention_tc::min_blocks(kDh, NT))
    fused_rect_attn_half_attention_kernel(const attention_tc::Params p, int H, long long n_bh,
                                          int pack) {
  attention_tc::attention_body<kDh, false, NT>(p, H, n_bh, pack);
}

__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm)
    fused_rect_attn_half_out_kernel(const GemmParams p) {
  gemm_tile<kProjResidual, false>(p, blockIdx.x);
}

// ---- the MLP half: LN2, fc, proj ------------------------------------------

__global__ void __launch_bounds__(kThreads) fused_mlp_half_ln2_kernel(
    const bf16* x, bf16* z, const bf16* scale, const bf16* bias, int rows, int d, float eps) {
  layer_norm_launch(x, z, scale, bias, rows, d, eps);
}

template <int kEpi>
__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSm)
    fused_mlp_half_gemm_kernel(const GemmParams p) {
  gemm_tile<kEpi, false>(p, blockIdx.x);
}

int gemm_tiles_of(int M, int N) {
  return (M + kGemmRows - 1) / kGemmRows * ((N + kGemmCols - 1) / kGemmCols);
}

// The grids of the MLP half's three launches at (rows, d); 0 or kErrShape.
struct MlpPlan {
  int ln2_grid, fc_grid, proj_grid;
};
int mlp_plan(int rows, int d, MlpPlan* plan) {
  if (rows < 1 || d < 64 || d % 64 || d > kMaxWidth) return kErrShape;
  plan->ln2_grid = (rows + kLnRows - 1) / kLnRows;
  plan->fc_grid = gemm_tiles_of(rows, 4 * d);
  plan->proj_grid = gemm_tiles_of(rows, d);
  return 0;
}

// The attention half's four launches at (B, L, d, n_heads, n_kv) on a card
// whose blocks take max_smem bytes; 0, kErrShape or kErrSharedMemory.
struct AttnPlan {
  int ln1_grid, q_tiles, qkv_grid, score_tiles, pack, attn_grid, out_grid;
  size_t attn_smem;
};
int attn_plan(int B, int L, int d, int n_heads, int n_kv, int max_smem, AttnPlan* plan) {
  if (B < 1 || L < 1 || n_kv < 1 || n_kv > L || n_kv > kMaxKeys || n_heads < 1 ||
      d != n_heads * kDh || d > kMaxWidth)
    return kErrShape;
  const int rows = B * L;
  plan->ln1_grid = (rows + kLnRows - 1) / kLnRows;
  plan->q_tiles = gemm_tiles_of(rows, d);
  plan->qkv_grid = plan->q_tiles + gemm_tiles_of(B * n_kv, 2 * d);
  plan->score_tiles = attention_tc::d64_score_tiles(n_kv);
  plan->pack = attention_tc::tc_pack(kDh, L, n_kv, max_smem);
  plan->attn_smem = attention_tc::tc_smem_bytes(kDh, n_kv, plan->pack);
  plan->attn_grid = (B * n_heads + plan->pack - 1) / plan->pack;
  plan->out_grid = plan->q_tiles;
  if (kGemmSmem > max_smem || plan->attn_smem > (size_t)max_smem) return kErrSharedMemory;
  return 0;
}

cudaError_t max_shared_memory(int device, int* bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int grid, int threads, size_t smem, cudaStream_t s,
                   Args... args) {
  if (smem > 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: (B, L, d) bf16, contiguous; scratch: B * L x 4d bf16 (z = LN1(x),
// B * L x d, later o; then q | k | v, B * L x 3d); LayerNorm parameters and
// biases bf16; qkv_w (d, 3d) and out_w (d, d) bf16 (in, out) in the
// fragment-major layout of gemm_tiles, 16-byte aligned.  Takes head dim 64,
// d = 64 * n_heads <= 768, 1 <= n_kv <= min(L, 256), B >= 1.  Four launches
// on the stream: LN1, q/k/v, the attention, out.  Returns 0, a cudaError_t
// code (> 0), or one of the negative codes above.
int fused_rect_attn_half_forward(int device, const void* x, void* out, void* scratch,
                                 const void* ln1_s, const void* ln1_b, const void* qkv_w,
                                 const void* qkv_b, const void* out_w, const void* out_b, int B,
                                 int L, int d, int n_heads, int n_kv, float scale, float eps,
                                 void* stream) {
  int max_smem = 0;
  cudaError_t err = max_shared_memory(device, &max_smem);
  if (err != cudaSuccess) return err;
  AttnPlan plan;
  const int rc = attn_plan(B, L, d, n_heads, n_kv, max_smem, &plan);
  if (rc != 0) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * L, ld3 = 3 * d;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* w = static_cast<const bf16*>(qkv_w);
  const bf16* b = static_cast<const bf16*>(qkv_b);
  bf16* z = static_cast<bf16*>(scratch);
  bf16* qkv = z + (size_t)rows * d;
  err = launch(fused_rect_attn_half_ln1_kernel, plan.ln1_grid, kThreads, 0, s, xb, z,
               static_cast<const bf16*>(ln1_s), static_cast<const bf16*>(ln1_b), rows, d, eps);
  if (err != cudaSuccess) return err;
  // q over every row; k | v over the rows < n_kv of each sequence, from
  // Wqkv's column tile d / 16 on
  const GemmParams q{z, w, b, nullptr, qkv, rows, d, d, ld3, ld3 / kTile, 0, 0};
  const GemmParams kv{z, w + (size_t)(d / kTile) * kTileElems, b + d, nullptr, qkv + d,
                      B * n_kv, 2 * d, d, ld3, ld3 / kTile, n_kv, L};
  err = launch(fused_rect_attn_half_qkv_kernel, plan.qkv_grid, kGemmThreads, kGemmSmem, s, q, kv,
               plan.q_tiles);
  if (err != cudaSuccess) return err;
  // the attention, q, k and v in place, o over z
  const long long sb = (long long)L * ld3, ob = (long long)L * d;
  const attention_tc::Params ap{qkv, qkv + d, qkv + 2 * d, z, L, n_kv,
                                sb, kDh, ld3, sb, kDh, ld3, sb, kDh, ld3, ob, kDh, d,
                                scale, nullptr, 0, 0};
  const long long n_bh = (long long)B * n_heads;
  const int threads = attention_tc::kTcThreads;
  switch (plan.score_tiles) {
    case 2:
      err = launch(fused_rect_attn_half_attention_kernel<2>, plan.attn_grid, threads,
                   plan.attn_smem, s, ap, n_heads, n_bh, plan.pack);
      break;
    case 5:
      err = launch(fused_rect_attn_half_attention_kernel<5>, plan.attn_grid, threads,
                   plan.attn_smem, s, ap, n_heads, n_bh, plan.pack);
      break;
    case 13:
      err = launch(fused_rect_attn_half_attention_kernel<13>, plan.attn_grid, threads,
                   plan.attn_smem, s, ap, n_heads, n_bh, plan.pack);
      break;
    default:
      err = launch(fused_rect_attn_half_attention_kernel<16>, plan.attn_grid, threads,
                   plan.attn_smem, s, ap, n_heads, n_bh, plan.pack);
  }
  if (err != cudaSuccess) return err;
  // out = x + bf(bf(o @ Wout) + b_out)
  const GemmParams o{z, static_cast<const bf16*>(out_w), static_cast<const bf16*>(out_b), xb,
                     static_cast<bf16*>(out), rows, d, d, d, d / kTile, 0, 0};
  return launch(fused_rect_attn_half_out_kernel, plan.out_grid, kGemmThreads, kGemmSmem, s, o);
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
  err = launch(fused_mlp_half_ln2_kernel, plan.ln2_grid, kThreads, 0, s,
               static_cast<const bf16*>(x), z, static_cast<const bf16*>(ln2_s),
               static_cast<const bf16*>(ln2_b), rows, d, eps);
  if (err != cudaSuccess) return err;
  const GemmParams fc{z, static_cast<const bf16*>(fc_w), static_cast<const bf16*>(fc_b), nullptr,
                      h, rows, 4 * d, d, 4 * d, 4 * d / kTile, 0, 0};
  err = launch(fused_mlp_half_gemm_kernel<kFcGelu>, plan.fc_grid, kGemmThreads, kGemmSmem, s, fc);
  if (err != cudaSuccess) return err;
  const GemmParams pr{h, static_cast<const bf16*>(proj_w), static_cast<const bf16*>(proj_b),
                      static_cast<const bf16*>(x), static_cast<bf16*>(out), rows, d, 4 * d,
                      d, d / kTile, 0, 0};
  return launch(fused_mlp_half_gemm_kernel<kProjResidual>, plan.proj_grid, kGemmThreads, kGemmSmem,
                s, pr);
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
