// One whole pre-LN transformer layer of a short causal text tower, for
// Hopper (sm_90a), plain C interface, bf16 only.
//
// Replaces the TPU kernel of rpo_tpu/ops/fused_text_layer.py:
//   fused_text_layer (pallas_call at :215, body _layer_kernel :90-157), the
//   CoCoOp eval path's per-image text towers: N = chunk * n_cls sequences of
//   L = text_len tokens (510 x 16 x 512, 8 heads, at ViT-B/16, n_cls 51,
//   chunk 10).
//
// What it computes, per token row, in this order (the order of _layer_kernel):
//   y  = LN1(x): f32 two-pass (mean, then mean((x - mean)^2)), times
//        rsqrt(var + eps), times the scale and plus the bias (both bf16 values
//        taken to f32), three separate roundings; y rounded to bf16
//   q, k, v = y @ W{q,k,v}: f32 accumulation rounded to bf16, THEN + bias in
//        bf16 (two roundings), Q, K, V the three (d, d) column blocks of qkv_w
//   per head: s = (q . k) in f32, times dh^-1/2, plus the f32 mask (two
//        roundings, never one fused multiply-add); s - max, exp, divided by
//        the sum, all f32, normalised BEFORE the cast to bf16; o = p . v
//        accumulated in f32 and rounded to bf16; heads concatenated
//   x  = x + (o @ Wout rounded, + bias rounded), the residual add in bf16
//   z  = LN2(x) as LN1
//   h  = z @ Wfc rounded, + bias rounded; QuickGELU with a bf16 rounding after
//        every op, as the TPU body spells it: t = 1.703125 * h (1.702 in
//        bf16), e = exp(-t), den = 1 + e, sig = 1 / den, h = h * sig
//   x  = x + (h @ Wproj rounded, + bias rounded)
// Sequences never mix: attention reads only the keys of its own sequence.
//
// Bound at (510, 16, 512), 8 heads, from the H100 SXM data sheet (989 TFLOP/s
// dense bf16, 3.35 TB/s): 2 * 8160 rows * 3,145,728 weight MACs = 51.3 GFLOP of
// projections (+0.27 GFLOP of attention) -> 0.052 ms by operations; the bytes
// (8.4 MB in, 8.4 MB out, 6.3 MB of weights) alone would take 0.0069 ms.
// chip_smoke.py recomputes the bound for the card it runs on.
//
// Design.  One block of 512 threads (four warpgroups of four warps) takes S
// whole sequences (S * L <= 64 rows, or one sequence of up to 80 rows), so
// attention never crosses a block, and the last block masks ragged N
// itself.  The four projections run on wgmma (sm_90a: m64nNk16, bf16 in,
// f32 accumulators in registers), one row block of 64 rows (wgmma's M) at a
// time; every product accumulates each output element over k in order, one
// wgmma a k-step, whatever the split over warpgroups or the ring's stages
// (the outputs equal the mma.sync design's bit for bit at the selftest's
// shapes).
// - Weights.  The block streams the layer's weights (6.3 MB at d = 512)
//   through a double-buffered ring in shared memory, each weight byte from
//   L2 once per block and row block.  The wrapper hands the four matrices
//   over in core matrices (with_text_kernel_layout: each 16x16 tile 512
//   contiguous bytes, four 8x8 core matrices of 8 columns by 8 k, the column
//   half outer), wgmma's K-major B without swizzle: a stage is whole tiles,
//   and one descriptor covers a warpgroup's columns of a k-step (core
//   matrices 128 bytes apart along k, 256 along the columns, each one 128
//   contiguous bytes read without a bank conflict).  A stage holds an even
//   number of k-steps of one product, as many as its slot (up to 128 tiles)
//   takes.  Per stage: cp.async.wait_group, a proxy fence (the copies are
//   generic writes, wgmma reads through the async proxy) and a barrier hand
//   it over; each warpgroup issues the stage's first two wgmmas, then every
//   thread copies its share of the next stage into the slot just freed (a
//   warp 512 contiguous bytes a copy), then the warpgroups run the rest and
//   wait for their last wgmma before the next barrier.  The ring runs on
//   across products: the next product's first stage loads during this
//   one's last stage, the attention, LN2 or the epilogues.  The schedule
//   (segment()) lists the products in the order the block runs them; each
//   block writes it into a table at the start of shared memory.  Spare
//   tiles follow the ring only where a product's tiles do not fill its
//   warpgroups (spare_tiles()), so that at d = 512 a slot takes four k-steps
//   of the out projection and of proj.
// - A from registers (ldmatrix, the m16n8k16 A fragment of each warp's 16
//   rows), not from a descriptor: the A operands (LN1's and LN2's output Y,
//   the head outputs copied into Y, the hidden chunk H) stay row-major at a
//   padded stride, as layer_norm_rows of fused_layer_common.cuh writes them
//   and the epilogues and the attention use them; a descriptor would need
//   them in core matrices.  A warpgroup takes k-steps in pairs: A into one
//   of two register sets, a fence, the wgmma, a commit, and a wait until the
//   one before has finished (wgmma.wait_group 1); the second of a pair past
//   a stage's last k-step is a zero A on the last k-step's B, which adds
//   zeros.  No branch leads to a wgmma but warp-uniform ones (uniform()).
// - Column splits, each warpgroup kNT 16-column tiles, N = 16 kNT a wgmma:
//   q, k, v of a head (3 dh / 16 tiles): 3 each (n48, all four warpgroups
//   at dh = 64); the out projection and proj, in column blocks of 32 tiles:
//   8 each (n128); fc, a hidden chunk of 256 columns: 4 each (n64).  Every
//   warpgroup runs every product's wgmmas: one whose tiles lie past the
//   product's (only at other shapes than the CoCoOp chunk's) multiplies the
//   stage's first tiles, and tiles past the end in a partly filled one read
//   the spare tiles, into accumulators that are never read.
// - The MLP's f32 down-projection accumulator stays in registers for the
//   whole hidden-chunk loop (64 floats a thread at d = 512, a 64 x 128 wgmma
//   accumulator per warpgroup): per chunk, H = QuickGELU(z @ Wfc[:, chunk] +
//   b) into shared memory, then the accumulators take H @ Wproj[chunk, :];
//   the epilogue reads them straight.  Where a block has more rows than 64
//   (L = 80) or d more column tiles than 32 (d = 768), the products run in
//   passes over 64-row blocks (the rows past the block's given as zeros)
//   times column blocks, the fc chunks recomputed for each column block.
// - The epilogues round pairs of values with one conversion (two values to a
//   bf16x2): the same roundings as one at a time, at half the conversions;
//   QuickGELU runs exp and 1 / den on the fast instructions (quick_gelu()).
// - Shared memory (dynamic, above 48 KB): the segment table, LN1's output Y
//   (rows x d bf16) for the whole layer; then, over one region, one head's
//   q, k, v and f32 scores, or one hidden chunk of 64 rows; then the ring.
//   The residual stream x lives in the output tensor in device memory, the
//   concatenated head outputs in a scratch tensor the wrapper allocates ((N
//   * L + kMaxRows) x d bf16), copied into Y (dead by then) for the out
//   projection.
// - Attention itself is plain f32 FMAs (0.5% of the work), each query row
//   by one warp, two rows a warp (a half-warp each) at L <= 16, so that the
//   block meets at no barrier between the scores, the softmax and p . v;
//   q and k rows are read 16 bytes a load, v two columns a load.
// What bounds it (PERF.md §6; time_fused.py --phases at the CoCoOp
// chunk, H100): the products and their epilogues take 67% of the clocks
// (q/k/v 23.7%, fc 20.3%, proj 14.5%, the out projection 8.5%), the ring's
// waits and barriers 1.9%; then the attention (14.3%), QuickGELU (9.0%), LN1
// (4.1%), the MLP's epilogue (3.4%) and LN2 (2.2%), serial phases of the
// block.  The products run at 17-37% of an SM's share of the peak: each
// k-step's B passes through shared memory twice (the copy, the wgmma) and
// its A four times (one ldmatrix a warpgroup), which at 64 rows a block asks
// up to 333 bytes a clock at full rate of the 128 an SM has (q/k/v's 192
// columns the worst), and a stage's copies wait on L2 behind one stage of
// work.  The kernel's SASS holds 16 HGMMA (four products, two register
// sets, two call sites each) and no HMMA.  ptxas serialises the wgmmas for
// want of registers (C7512: the MLP's 64 + 32 accumulators beside the
// ring's state), which leaves one in flight a warpgroup.  No TMA and no
// warp specialisation.  LayerNorm comes from fused_layer_common.cuh, shared
// with fused_rect_layer.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (rpo_tpu_torch/ops/_build.py).

#include "fused_layer_common.cuh"

extern __shared__ __align__(128) unsigned char fused_text_smem[];

namespace {

using namespace fused_layer;

constexpr int kWgThreads = 128;                     // a warpgroup: four warps
constexpr int kWarpgroups = kThreads / kWgThreads;
constexpr int kRowBlock = 64;        // wgmma's M: the rows of one product
constexpr int kHidden = 256;         // MLP hidden columns per chunk
constexpr int kTargetRows = 64;      // rows per block when L <= 64
constexpr int kMaxRows = 80;         // one sequence of L <= 80
constexpr int kTileElems = kTile * kTile;  // one B tile: four core matrices
constexpr int kTileBytes = kTileElems * 2;
constexpr int kCoreBytes = kTileBytes / 4;  // an 8 x 8 core matrix
constexpr int kPieces = kTileBytes / 16;    // 16-byte copies a tile
constexpr int kStages = 2;                  // the weight ring: a double buffer
// a warpgroup's 16-column output tiles in each product (one m64n(16 kNT)k16
// wgmma a k-step)
constexpr int kQkvTiles = 3, kOutTiles = 8, kFcTiles = 4, kProjTiles = 8;
// the out projection and the MLP run in column blocks of kColTiles tiles
constexpr int kColTiles = kWarpgroups * kOutTiles;
static_assert(kColTiles == kWarpgroups * kProjTiles, "one column block for both");
static_assert(kHidden == kWarpgroups * kFcTiles * kTile, "fc: a chunk over the warpgroups");

// Error codes beside cudaError_t's (which are >= 0).
constexpr int kErrShape = -1;
constexpr int kErrSharedMemory = -3;

struct Weights {
  const bf16* ln1_s; const bf16* ln1_b;
  const bf16* qkv_w; const bf16* qkv_b;   // (d, 3d), (3d,)
  const bf16* out_w; const bf16* out_b;   // (d, d), (d,)
  const bf16* ln2_s; const bf16* ln2_b;
  const bf16* fc_w; const bf16* fc_b;     // (d, 4d), (4d,)
  const bf16* proj_w; const bf16* proj_b; // (4d, d), (d,)
};

struct Params {
  const bf16* x;       // (N, L, d)
  bf16* out;           // (N, L, d): the residual stream
  bf16* heads;         // (N * L + kMaxRows, d) scratch: concatenated head outputs
  const float* mask;   // (L, L) additive
  Weights w;
  int N, L, d, n_heads, seqs;
  int n_segs, slot_tiles, spare;  // the weight stream (segments()) and its ring
  float scale, eps;
};

// One product's B operand in the weight stream: output tile t (of n_tiles)
// reads column tile col0 + t + (t / run) * run_stride (t < 3 run) of the
// tiled matrix B (nb column tiles, from its first k-step on), over nk
// k-steps, ksteps of them a stage of the ring.
struct Segment {
  const bf16* B;
  short nb, nk, n_tiles, col0, run, run_stride, ksteps;  // 24 bytes an entry
};

struct Layout {  // byte offsets into dynamic shared memory
  int rows, ldy, ldh;
  size_t y, q, k, v, s, hid, ring, total;
};

// The segment table first (at offset 0), then Y, then one region for the
// attention or the MLP, then the ring and its spare tiles.
__host__ __device__ inline Layout layout(int seqs, int L, int d, int dh, int n_segs,
                                         int slot_tiles, int spare) {
  Layout o;
  o.rows = round_up(seqs * L, kTile);
  o.ldy = d + kPadBf16;
  o.ldh = dh + 8;  // 16-byte rows, 4 banks apart: q, k rows read 16 bytes a load
  const size_t R = o.rows;
  o.y = round_up((int)(n_segs * sizeof(Segment)), 128);
  const size_t region = o.y + sizeof(bf16) * R * o.ldy;
  // attention phase
  o.q = region;
  o.k = o.q + round_up((int)(sizeof(bf16) * R * o.ldh), 128);
  o.v = o.k + round_up((int)(sizeof(bf16) * R * o.ldh), 128);
  o.s = o.v + round_up((int)(sizeof(bf16) * R * o.ldh), 128);
  const size_t attn_end = o.s + sizeof(float) * R * L;
  // MLP phase, over the same bytes: one hidden chunk of a row block
  o.hid = region;
  const size_t mlp_end = o.hid + sizeof(bf16) * kRowBlock * (kHidden + kPadBf16);
  o.ring = round_up((int)(attn_end > mlp_end ? attn_end : mlp_end), 128);
  o.total = o.ring + (size_t)(kStages * slot_tiles + spare) * kTileBytes;
  return o;
}

// The passes of the products: row blocks of kRowBlock rows, column blocks
// of kColTiles tiles (the out projection and the MLP), hidden chunks.
struct Blocks {
  int n_rb, n_cb, n_chunks;
};
__host__ __device__ inline Blocks blocks_of(int rows, int d) {
  return {(rows + kRowBlock - 1) / kRowBlock, (d / kTile + kColTiles - 1) / kColTiles,
          (4 * d + kHidden - 1) / kHidden};
}

// Shared memory by 32-bit address: one register where a pointer takes two.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wgmma's instructions.  B's shared-memory descriptor, K-major in core
// matrices with no swizzle: the start address, the two core matrices of a
// k-step kCoreBytes apart (the leading byte offset), the column groups of 8
// 2 kCoreBytes apart (the stride byte offset), all in 16-byte units.
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(kCoreBytes >> 4) << 16 |
         (uint64_t)(2 * kCoreBytes >> 4) << 32;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// v as lane 0 of the warp has it: the same value, which the compiler then
// knows to be the same across the warp.  A wgmma that only warp-uniform
// branches lead to is not serialised by ptxas.
__device__ __forceinline__ int uniform(int v) { return __shfl_sync(0xffffffffu, v, 0); }
// The accumulators stay where they are across the asynchronous products.
template <int kN>
__device__ __forceinline__ void keep(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FTL_ACC8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 48, f32) += a (this warp's 16 rows x 16, the m16n8k16 A fragment)
// . B (16 x 48 at the descriptor b)
__device__ __forceinline__ void wgmma(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
      "}\n"
      : FTL_ACC8(d, 0), FTL_ACC8(d, 8), FTL_ACC8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 64) += a . B (16 x 64)
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : FTL_ACC8(d, 0), FTL_ACC8(d, 8), FTL_ACC8(d, 16), FTL_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 128) += a . B (16 x 128)
__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : FTL_ACC8(d, 0), FTL_ACC8(d, 8), FTL_ACC8(d, 16), FTL_ACC8(d, 24), FTL_ACC8(d, 32),
        FTL_ACC8(d, 40), FTL_ACC8(d, 48), FTL_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef FTL_ACC8

// The block's products in the order it runs them: q, k, v of each head, a
// row block at a time; the out projection's row and column blocks; per MLP
// row and column block, fc then proj of each hidden chunk.
__host__ __device__ inline int segments(int n_heads, int rows, int d) {
  const Blocks b = blocks_of(rows, d);
  return b.n_rb * (n_heads + b.n_cb * (1 + 2 * b.n_chunks));
}

__device__ Segment segment(const Params& p, int rows, int s) {
  const int nt = p.d / kTile, ht = nt / p.n_heads;
  const Blocks b = blocks_of(rows, p.d);
  const int n_qkv = p.n_heads * b.n_rb, n_out = b.n_rb * b.n_cb;
  const bf16* B;
  int nb, nk, n_tiles, col0, run, run_stride = 0;
  if (s < n_qkv) {
    B = p.w.qkv_w, nb = 3 * nt, nk = nt, n_tiles = 3 * ht, col0 = s / b.n_rb * ht, run = ht;
    run_stride = nt - ht;
  } else if (s < n_qkv + n_out) {
    col0 = (s - n_qkv) % b.n_cb * kColTiles;
    B = p.w.out_w, nb = nt, nk = nt, n_tiles = run = min(kColTiles, nt - col0);
  } else {
    const int m = s - n_qkv - n_out, chunk = m / 2 % b.n_chunks;
    const int c0 = m / (2 * b.n_chunks) % b.n_cb * kColTiles, nc = min(kColTiles, nt - c0);
    const int h0 = chunk * (kHidden / kTile), hn = min(kHidden / kTile, 4 * nt - h0);
    if (m % 2 == 0)
      B = p.w.fc_w, nb = 4 * nt, nk = nt, n_tiles = run = hn, col0 = h0;
    else
      B = p.w.proj_w + (size_t)h0 * kTile * p.d, nb = nt, nk = hn, n_tiles = run = nc, col0 = c0;
  }
  // an even count where two fit: wg_product takes k-steps in pairs
  const int fit = p.slot_tiles / n_tiles, ksteps = min(nk, fit > 1 ? fit & ~1 : fit);
  return {B, (short)nb, (short)nk, (short)n_tiles, (short)col0, (short)run, (short)run_stride,
          (short)ksteps};
}

// The segment table, built once per block at the start of shared memory.
__device__ __forceinline__ const Segment* table() {
  return reinterpret_cast<const Segment*>(fused_text_smem);
}

// The weight ring: kStages slots of p.slot_tiles B tiles each.  A stage is
// ksteps k-steps of one segment's tiles, tile (k-step ks, output tile t)
// at ks * n_tiles + t.  Every thread makes the same calls: the producer side
// (next_stage, copy) keeps the next stage in flight while the consumer side
// (acquire) works on this one; past the last segment it commits empty
// groups.
struct Ring {
  uint32_t base;           // shared address of slot 0
  int p_seg, p_k, p_slot;  // the producer: segment, its next k-step, slot
  int c_seg, c_slot;       // the consumer
};

// This thread's share of one stage's 16-byte copies: piece off (< row) of
// k-step ks goes to byte 16 (ks * row + off) of the slot, for off = t and t
// + kThreads (n_off of them); a k-step's output tiles are runs of
// contiguous column tiles in B, and only a row under kThreads pieces has
// more than one run.  A warp's copies are 512 contiguous bytes.
struct Stage {
  const uint4* src;  // piece t of k-step 0
  uint32_t dst;
  int n_off, nks, row;
  size_t src_step;  // one k-step of B, in pieces
};
static_assert(kColTiles * kPieces <= 2 * kThreads, "a k-step is two pieces a thread at most");

// The next stage of the schedule, advancing the producer (an empty one
// past the last segment).
__device__ __forceinline__ Stage next_stage(const Params& p, Ring& r) {
  Stage c{nullptr, 0, 0, 0, 0, 0};
  if (r.p_seg < p.n_segs) {
    const Segment& g = table()[r.p_seg];
    const int off = threadIdx.x, run = g.run * kPieces;
    c.row = g.n_tiles * kPieces;
    c.n_off = off < c.row ? (off + kThreads < c.row ? 2 : 1) : 0;
    c.nks = min(g.ksteps, g.nk - r.p_k);
    c.src_step = (size_t)g.nb * kPieces;
    c.src = reinterpret_cast<const uint4*>(g.B) + ((size_t)r.p_k * g.nb + g.col0) * kPieces +
            off + ((off >= run) + (off >= 2 * run)) * g.run_stride * kPieces;
    c.dst = r.base + r.p_slot * p.slot_tiles * kTileBytes + off * 16;
    r.p_k += g.ksteps;
    if (r.p_k >= g.nk) {
      r.p_k = 0;
      ++r.p_seg;
    }
  }
  r.p_slot ^= 1;
  return c;
}

// This thread's copies of the stage.
__device__ __forceinline__ void copy(const Stage& c) {
  if (c.n_off == 0) return;
  for (int ks = 0; ks < c.nks; ++ks) {
    cp_async16(c.dst + ks * c.row * 16, c.src + ks * c.src_step);
    if (c.n_off == 2)
      cp_async16(c.dst + (ks * c.row + kThreads) * 16, c.src + ks * c.src_step + kThreads);
  }
}

// The next stage, copied whole as one cp.async group.
__device__ __forceinline__ void issue(const Params& p, Ring& r) {
  const Stage c = next_stage(p, r);
  copy(c);
  cp_async_commit();
}

#ifdef FUSED_TEXT_PHASES
// block 0's thread 0: clocks in the ring's waits and barriers (within the
// product phases), then in the attention's scores and softmax (within it)
enum Extra { kRingWait, kScores, kSoftmax, kExtras };
__shared__ long long extra_clocks[kExtras];
#define EXTRA_START(t) const long long t = clock64()
#define EXTRA_END(k, t) \
  if (blockIdx.x == 0 && threadIdx.x == 0) extra_clocks[k] += clock64() - t
#else
#define EXTRA_START(t)
#define EXTRA_END(k, t)
#endif

// The next stage's slot, once the stage has landed and every warp is done
// with the one before (whose slot the caller's next stage refills).
__device__ __forceinline__ uint32_t acquire(const Params& p, Ring& r) {
  EXTRA_START(t_wait);
  cp_async_wait_all();
  // this thread's copies, written through the generic proxy, before the
  // wgmma reads of every warpgroup, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  EXTRA_END(kRingWait, t_wait);
  const uint32_t s = r.base + r.c_slot * p.slot_tiles * kTileBytes;
  r.c_slot ^= 1;
  return s;
}

// Two adjacent bf16 values (4-byte aligned) as floats, and two floats
// rounded to bf16 into two adjacent values.
__device__ __forceinline__ float2 pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// bf() of two values at once: one paired conversion where bf() takes two
__device__ __forceinline__ float2 bf2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// QuickGELU of two bf16 values hv as the TPU body rounds it, after every op:
// t = 1.703125 hv (1.702 in bf16), e = exp(-t), den = 1 + e, sig = 1 / den,
// hv * sig (this last rounding the caller's).  exp and 1 / den run on the
// fast instructions (ex2.approx, rcp.approx without flushing subnormals):
// on every one of the 65536 bf16 inputs the chain's values equal those of
// expf and of a correctly rounded 1 / den, which tests/test_torch_port_gpu.py
// checks on the card through fused_text_layer_quick_gelu.
__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float2 quick_gelu(float2 hv) {
  const float2 t = bf2(1.703125f * hv.x, 1.703125f * hv.y);
  const float2 e = bf2(__expf(-t.x), __expf(-t.y));
  const float2 den = bf2(1.f + e.x, 1.f + e.y);
  const float2 sig = bf2(rcp_approx(den.x), rcp_approx(den.y));
  return make_float2(hv.x * sig.x, hv.y * sig.y);
}

template <int kN>
__device__ __forceinline__ void zero(float (&c)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) c[i] = 0.f;
}

// acc += A @ B for the next segment of the ring, on this warpgroup's output
// tiles wg * kNT ... wg * kNT + kNT - 1: one m64n(16 kNT)k16 wgmma a k-step,
// its B (those tiles of the k-step, contiguous in the slot) by descriptor.
// A: the 64 rows of a row block, bf16 row-major at lda in shared memory, of
// which the first a_rows exist (the warps past them give zeros).  A
// warpgroup with no tile below the segment's n_tiles multiplies the
// k-step's first tiles instead, and tiles at or past n_tiles in one that
// has some read what the slot or the spare tiles hold there: into
// accumulators that are never read.  Every thread must call it (the ring's
// barriers).  The k-steps reach each accumulator in order.
template <int kNT>
__device__ __forceinline__ void wg_product(const Params& p, Ring& r, const bf16* A, int lda,
                                           int a_rows, float (&acc)[kNT * 8]) {
  const Segment& g = table()[r.c_seg++];
  const int wg = uniform(threadIdx.x / kWgThreads), warp = uniform(threadIdx.x / 32 % 4);
  const int lane = threadIdx.x % 32, n_tiles = uniform(g.n_tiles);
  const int nk = uniform(g.nk), kst = uniform(g.ksteps);
  const bool on = wg * kNT < n_tiles, rows_on = warp * kTile < uniform(a_rows);
  // a warp past A's rows loads row 0's fragment and zeroes it: no branch
  // before a wgmma, which ptxas would serialise
  const uint32_t a_lane =
      smem_addr(A + ((rows_on ? warp * kTile : 0) + lane % 16) * lda + (lane / 16) * 8);
  const uint32_t a_keep = rows_on ? ~0u : 0u;
  const uint32_t step_bytes = n_tiles * kTileBytes;
  keep(acc);
  for (int k0 = 0; k0 < nk; k0 += kst) {
    if (k0 > 0) wgmma_wait<0>();  // done with the slot the next stage refills
    const uint32_t b = acquire(p, r) + (on ? wg * kNT : 0) * kTileBytes;
    const int nks = min(kst, nk - k0);
    uint32_t a0[4], a1[4];  // the A fragments of two k-steps: one loads, one in flight
    // k-step ks: A into a (zeros where keep is 0), then its wgmma, and wait
    // for the one before
    auto step = [&](uint32_t (&a)[4], int ks, uint32_t keep) {
      ldmatrix_x4(a, a_lane + (k0 + ks) * kTile * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] &= keep;
      wgmma_fence();
      wgmma(acc, a, b_descriptor(b + ks * step_bytes));
      wgmma_commit();
      wgmma_wait<1>();
    };
    // k-steps ks and ks + 1; past the stage's last, the second is a zero A on
    // the last k-step's B, which adds zeros: no branch around a wgmma, which
    // ptxas would serialise
    auto two_steps = [&](int ks) {
      step(a0, ks, a_keep);
      const bool real = ks + 1 < nks;
      step(a1, real ? ks + 1 : ks, real ? a_keep : 0u);
    };
    // the next stage, into the slot this barrier freed: its copies go out
    // while this stage's first wgmmas run
    const Stage next = next_stage(p, r);
    two_steps(0);
    copy(next);
    cp_async_commit();
#pragma unroll 1
    for (int ks = 2; ks < nks; ks += 2) two_steps(ks);
  }
  wgmma_wait<0>();
  keep(acc);
}

// Each finished pair of adjacent columns of this warpgroup's accumulators
// (wg_product's, tiles below n_tiles) to fn(row in the row block, output
// tile, column in the tile, value, value of the next column): wgmma's
// accumulator layout, warp w of the warpgroup rows 16 w ... 16 w + 15, each
// 8 columns as an m16n8 accumulator.
template <int kNT, typename Fn>
__device__ __forceinline__ void for_each_pair(int n_tiles, const float (&c)[kNT * 8], Fn fn) {
  const int wg = threadIdx.x / kWgThreads, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int j = 0; j < 2 * kNT; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = wg * kNT + j / 2;
      if (t < n_tiles)
        fn(warp * kTile + g + half * 8, t, (j % 2) * 8 + q * 2, c[4 * j + 2 * half],
           c[4 * j + 2 * half + 1]);
    }
}

// Phase clocks, compiled in only with -DFUSED_TEXT_PHASES (time_fused.py
// --phases): thread 0 of block 0 sums its SM clock (clock64) by phase over
// the layer and writes the sums (kPhases int64, then the kExtras clocks
// inside some of them) after the N * L rows of the heads scratch.  A phase
// ends where the thread leaves it, so a barrier's wait counts in the phase
// that starts with it.
enum Phase { kSetUp, kQkv, kAttend, kOutProj, kLn2, kFc, kGelu, kProj, kMlpOut, kPhases };
#ifdef FUSED_TEXT_PHASES
#define PHASE_END(k)                                   \
  if (phase_on) {                                      \
    const long long now = clock64();                   \
    phase_sum[k] += now - phase_mark;                  \
    phase_mark = now;                                  \
  }
#else
#define PHASE_END(k)
#endif

__global__ void __launch_bounds__(kThreads, 1) fused_text_layer_kernel(const Params p) {
#ifdef FUSED_TEXT_PHASES
  __shared__ long long phase_sum[kPhases];
  const bool phase_on = blockIdx.x == 0 && threadIdx.x == 0;
  long long phase_mark = clock64();
  if (phase_on) {
    for (int k = 0; k < kPhases; ++k) phase_sum[k] = 0;
    for (int k = 0; k < kExtras; ++k) extra_clocks[k] = 0;
  }
#endif
  unsigned char* smem = fused_text_smem;
  const int L = p.L, d = p.d, dh = d / p.n_heads;
  const Layout lay = layout(p.seqs, L, d, dh, p.n_segs, p.slot_tiles, p.spare);
  const int seq0 = blockIdx.x * p.seqs;
  const int n_valid = min(p.seqs, p.N - seq0) * L;  // real rows of this block
  const int rows = lay.rows;
  const size_t row0 = (size_t)seq0 * L;
  const bf16* x = p.x + row0 * d;
  bf16* out = p.out + row0 * d;
  bf16* heads = p.heads + row0 * d;
  const int tid = threadIdx.x, warp = tid / 32;

  bf16* Y = reinterpret_cast<bf16*>(smem + lay.y);
  bf16* Q = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* K = reinterpret_cast<bf16*>(smem + lay.k);
  bf16* V = reinterpret_cast<bf16*>(smem + lay.v);
  float* S = reinterpret_cast<float*>(smem + lay.s);
  bf16* H = reinterpret_cast<bf16*>(smem + lay.hid);
  const int ldh = lay.ldh, ldy = lay.ldy;

  // the weight stream's schedule, then its first stages, which load during LN1
  for (int i = tid; i < p.n_segs; i += kThreads)
    reinterpret_cast<Segment*>(smem)[i] = segment(p, rows, i);
  __syncthreads();
  Ring ring{smem_addr(smem + lay.ring), 0, 0, 0, 0, 0};
  issue(p, ring);

  // ---- attention half: x + out_proj(attend(LN1(x))) ----------------------
  layer_norm_rows(x, n_valid, rows, d, p.w.ln1_s, p.w.ln1_b, p.eps, Y, ldy);
  PHASE_END(kSetUp);
  const int head_tiles = dh / kTile;
  for (int h = 0; h < p.n_heads; ++h) {
    // q, k, v of head h: 3 * dh / 16 column tiles of qkv_w, a row block at
    // a time (the ring's first barrier orders LN1's Y, and the last head's
    // attention, before them)
    for (int r0 = 0; r0 < rows; r0 += kRowBlock) {
      float c[kQkvTiles * 8];
      zero(c);
      wg_product<kQkvTiles>(p, ring, Y + (size_t)r0 * ldy, ldy, rows - r0, c);
      for_each_pair<kQkvTiles>(3 * head_tiles, c, [&](int r, int t, int cl, float v0, float v1) {
        r += r0;
        if (r >= rows) return;
        const int which = t / head_tiles, col = (t % head_tiles) * kTile + cl;
        const float2 b = pair(p.w.qkv_b + which * d + h * dh + col), o = bf2(v0, v1);
        store_pair((which == 0 ? Q : which == 1 ? K : V) + r * ldh + col, o.x + b.x, o.y + b.y);
      });
    }
    PHASE_END(kQkv);
    __syncthreads();
    // attention, each valid row by one warp, so that the block meets at no
    // barrier until the next head's products: the scores of the keys of the
    // row's own sequence; the softmax in f32 across the row's lanes,
    // normalised, rounded to bf16; then o = p . v, f32 accumulation,
    // rounded, into head h's columns.  Each element's arithmetic and each
    // reduction's order are those of a block-wide pass per step.  Butterfly
    // steps whose partner lanes are all >= L (off >= L) would combine with
    // the identity (-max float, 0) and are skipped, as they change no value.
    const int lane = tid % 32;
    if (L <= 16) {
      // two rows a warp: lanes 0-15 row r, lanes 16-31 row r + kWarps; lane
      // hl the key hl, then the column pairs hl, hl + 16, ...
      const int hl = lane % 16;
      for (int r0 = warp; r0 < n_valid; r0 += 2 * kWarps) {
        const int r = r0 + lane / 16 * kWarps;
        const bool on = r < n_valid, key = on && hl < L;
        const int i = r % L, base = r - i;
        float* row = S + r * L;
        EXTRA_START(t_scores);
        if (key) {
          const uint4* qr = reinterpret_cast<const uint4*>(Q + r * ldh);
          const uint4* kr = reinterpret_cast<const uint4*>(K + (base + hl) * ldh);
          float s = 0.f;
#pragma unroll 4
          for (int c8 = 0; c8 < dh / 8; ++c8) {  // dh / 8 is 4 or 8; 8 columns in order
            const uint4 qv = qr[c8], kv = kr[c8];
            const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w}, kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qw[e]));
              const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kw[e]));
              s = fmaf(a.x, b.x, s);
              s = fmaf(a.y, b.y, s);
            }
          }
          row[hl] = __fadd_rn(__fmul_rn(s, p.scale), p.mask[i * L + hl]);
        }
        EXTRA_END(kScores, t_scores);
        EXTRA_START(t_softmax);
        float m = -3.402823466e+38f;
        if (key) m = fmaxf(m, row[hl]);
#pragma unroll
        for (int off = 8; off > 0; off /= 2)
          if (off < L) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float sum = 0.f;
        if (key) {
          const float e = expf(row[hl] - m);
          row[hl] = e;
          sum += e;
        }
#pragma unroll
        for (int off = 8; off > 0; off /= 2)
          if (off < L) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (key) row[hl] = bf(row[hl] / sum);
        __syncwarp();
        EXTRA_END(kSoftmax, t_softmax);
        if (on) {
          for (int c2 = hl; c2 < dh / 2; c2 += 16) {  // the columns 2 c2 and 2 c2 + 1
            float o0 = 0.f, o1 = 0.f;
#pragma unroll 8
            for (int j = 0; j < L; ++j) {
              const float pj = row[j];
              const float2 v = __bfloat1622float2(
                  reinterpret_cast<const __nv_bfloat162*>(V + (base + j) * ldh)[c2]);
              o0 = fmaf(pj, v.x, o0);
              o1 = fmaf(pj, v.y, o1);
            }
            *reinterpret_cast<__nv_bfloat162*>(heads + (size_t)r * d + h * dh + 2 * c2) =
                __floats2bfloat162_rn(o0, o1);
          }
        }
        __syncwarp();
      }
    } else {
      // one row a warp: lane j the keys j, j + 32, ...; lane c the columns
      // c, c + 32
      for (int r = warp; r < n_valid; r += kWarps) {
        const int i = r % L, base = r - i;
        float* row = S + r * L;
        const uint4* qr = reinterpret_cast<const uint4*>(Q + r * ldh);
        EXTRA_START(t_scores);
        for (int j = lane; j < L; j += 32) {
          const uint4* kr = reinterpret_cast<const uint4*>(K + (base + j) * ldh);
          float s = 0.f;
#pragma unroll 4
          for (int c8 = 0; c8 < dh / 8; ++c8) {  // dh / 8 is 4 or 8; 8 columns in order
            const uint4 qv = qr[c8], kv = kr[c8];
            const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w}, kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qw[e]));
              const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&kw[e]));
              s = fmaf(a.x, b.x, s);
              s = fmaf(a.y, b.y, s);
            }
          }
          row[j] = __fadd_rn(__fmul_rn(s, p.scale), p.mask[i * L + j]);
        }
        EXTRA_END(kScores, t_scores);
        EXTRA_START(t_softmax);
        float m = -3.402823466e+38f;
        for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          if (off < L) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        float sum = 0.f;
        for (int j = lane; j < L; j += 32) {
          const float e = expf(row[j] - m);
          row[j] = e;
          sum += e;
        }
#pragma unroll
        for (int off = 16; off > 0; off /= 2)
          if (off < L) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        for (int j = lane; j < L; j += 32) row[j] = bf(row[j] / sum);
        __syncwarp();
        EXTRA_END(kSoftmax, t_softmax);
        for (int col = lane; col < dh; col += 32) {
          float o = 0.f;
#pragma unroll 8
          for (int j = 0; j < L; ++j) o = fmaf(row[j], f(V[(base + j) * ldh + col]), o);
          heads[(size_t)r * d + h * dh + col] = __float2bfloat16(o);
        }
      }
    }
    // the next head's q, k, v overwrite Q, K, V and S only after the ring's
    // next barrier
    PHASE_END(kAttend);
  }
  __syncthreads();  // every head's output in the scratch
  // the head outputs into Y (LN1's output is dead), so that the out
  // projection reads its A fragments from shared memory
  for (int idx = tid; idx < rows * (d / 8); idx += kThreads) {
    const int r = idx / (d / 8), col = (idx % (d / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n_valid) v = *reinterpret_cast<const uint4*>(heads + (size_t)r * d + col);
    *reinterpret_cast<uint4*>(Y + (size_t)r * ldy + col) = v;
  }
  // out projection and the residual add, out = x + (heads @ Wout + b), in
  // blocks of 64 rows by at most 32 column tiles
  for (int r0 = 0; r0 < rows; r0 += kRowBlock) {
    for (int c0 = 0; c0 < d / kTile; c0 += kColTiles) {
      const int nc = min(kColTiles, d / kTile - c0);
      float c[kOutTiles * 8];
      zero(c);
      wg_product<kOutTiles>(p, ring, Y + (size_t)r0 * ldy, ldy, rows - r0, c);
      for_each_pair<kOutTiles>(nc, c, [&](int r, int t, int cl, float v0, float v1) {
        r += r0;
        if (r >= n_valid) return;
        const int col = (c0 + t) * kTile + cl;
        const size_t e = (size_t)r * d + col;
        const float2 b = pair(p.w.out_b + col), xe = pair(x + e), o = bf2(v0, v1);
        const float2 ob = bf2(o.x + b.x, o.y + b.y);
        store_pair(out + e, xe.x + ob.x, xe.y + ob.y);
      });
    }
  }
  __syncthreads();

  // ---- MLP half: x + proj(QuickGELU(fc(LN2(x)))) -------------------------
  PHASE_END(kOutProj);
  layer_norm_rows(out, n_valid, rows, d, p.w.ln2_s, p.w.ln2_b, p.eps, Y, ldy);
  PHASE_END(kLn2);
  const int ldhid = kHidden + kPadBf16;
  for (int r0 = 0; r0 < rows; r0 += kRowBlock) {
    const bf16* Yb = Y + (size_t)r0 * ldy;
    for (int c0 = 0; c0 < d / kTile; c0 += kColTiles) {
      const int nc = min(kColTiles, d / kTile - c0);
      // the down-projection's accumulators, in registers for all chunks
      float acc[kProjTiles * 8];
      zero(acc);
      for (int chunk = 0; chunk < 4 * d; chunk += kHidden) {
        // H = QuickGELU(Y @ Wfc[:, chunk] + b), rounding after every op; the
        // ring's barriers order it after the last chunk's reads of H
        float hc[kFcTiles * 8];
        zero(hc);
        wg_product<kFcTiles>(p, ring, Yb, ldy, rows - r0, hc);
        PHASE_END(kFc);
        const int hw = min(kHidden, 4 * d - chunk);  // this chunk's columns
        for_each_pair<kFcTiles>(hw / kTile, hc, [&](int r, int t, int cl, float v0, float v1) {
          const int col = t * kTile + cl;
          const float2 b = pair(p.w.fc_b + chunk + col), o = bf2(v0, v1);
          const float2 g = quick_gelu(bf2(o.x + b.x, o.y + b.y));
          store_pair(H + r * ldhid + col, g.x, g.y);
        });
        // acc += H @ Wproj[chunk, block] (the ring's first barrier orders H)
        PHASE_END(kGelu);
        wg_product<kProjTiles>(p, ring, H, ldhid, rows - r0, acc);
        PHASE_END(kProj);
      }
      // out = x + (acc rounded, + bias rounded), straight from the registers
      for_each_pair<kProjTiles>(nc, acc, [&](int r, int t, int cl, float v0, float v1) {
        r += r0;
        if (r >= n_valid) return;
        const int col = (c0 + t) * kTile + cl;
        const size_t e = (size_t)r * d + col;
        const float2 b = pair(p.w.proj_b + col), xe = pair(out + e), o = bf2(v0, v1);
        const float2 ob = bf2(o.x + b.x, o.y + b.y);
        store_pair(out + e, xe.x + ob.x, xe.y + ob.y);
      });
      PHASE_END(kMlpOut);
    }
  }
#ifdef FUSED_TEXT_PHASES
  if (phase_on) {
    long long* tail = reinterpret_cast<long long*>(p.heads + (size_t)p.N * L * d);
    for (int k = 0; k < kPhases; ++k) tail[k] = phase_sum[k];
    for (int k = 0; k < kExtras; ++k) tail[kPhases + k] = extra_clocks[k];
  }
#endif
}

constexpr int kMaxSlotTiles = 128;  // 64 KB a stage

// The tiles a warpgroup reads past the end of a stage, into the spare tiles
// after the ring: in a product whose output tiles do not fill its
// warpgroups, the last one that has some runs past them.
int spare_tiles(int d, int n_heads) {
  const int nt = d / kTile;
  int spare = 0;
  auto past = [&spare](int n_tiles, int wg_tiles) {
    const int over = (wg_tiles - n_tiles % wg_tiles) % wg_tiles;
    if (spare < over) spare = over;
  };
  past(3 * nt / n_heads, kQkvTiles);
  if (nt % kColTiles) past(nt % kColTiles, kOutTiles);  // the out projection's and proj's last block
  if (4 * d % kHidden) past(4 * d % kHidden / kTile, kFcTiles);  // the last hidden chunk
  return spare;
}

// The most sequences per block whose ring slots, as large as what is left
// allows up to kMaxSlotTiles, hold every segment's tiles of a k-step; 0
// with the layout on success.
int plan(int N, int L, int d, int n_heads, int max_smem, int* seqs, int* n_segs, int* slot_tiles,
         int* spare, Layout* lay) {
  const int dh = d / n_heads, nt = d / kTile;
  int need = 3 * dh / kTile;  // the widest k-step of a segment, in tiles
  const int cols = nt < kColTiles ? nt : kColTiles;
  const int hidden = (4 * d < kHidden ? 4 * d : kHidden) / kTile;
  if (need < cols) need = cols;
  if (need < hidden) need = hidden;
  *spare = spare_tiles(d, n_heads);
  for (int s = L <= kTargetRows ? kTargetRows / L : 1; s >= 1; --s) {
    const int seq = s < N ? s : N, rows = round_up(seq * L, kTile);
    const int segs = segments(n_heads, rows, d);
    const size_t fixed = layout(seq, L, d, dh, segs, 0, *spare).total;
    if ((size_t)max_smem < fixed) continue;
    int tiles = (int)((max_smem - fixed) / (kStages * kTileBytes));
    if (tiles > kMaxSlotTiles) tiles = kMaxSlotTiles;
    if (tiles < need) continue;
    *seqs = seq;
    *n_segs = segs;
    *slot_tiles = tiles;
    *lay = layout(seq, L, d, dh, segs, tiles, *spare);
    return 0;
  }
  return kErrSharedMemory;
}

// The dynamic shared bytes a block may take: the device's opt-in limit less
// the kernel's static shared memory (the phase clocks' build has some).
cudaError_t smem_budget(int device, int* bytes) {
  cudaError_t err = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fused_text_layer_kernel);
  if (err != cudaSuccess) return err;
  *bytes -= (int)attr.sharedSizeBytes;
  return cudaSuccess;
}

// QuickGELU (quick_gelu(), rounded to bf16) of n bf16 values, two a thread.
__global__ void quick_gelu_kernel(const bf16* x, bf16* y, int n) {
  const int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i < n) {
    const float2 g = quick_gelu(pair(x + i));
    store_pair(y + i, g.x, g.y);
  }
}

int check_shape(int N, int L, int d, int n_heads) {
  if (N < 1 || L < 1 || L > kMaxRows || n_heads < 1 || d % n_heads || d > kMaxWidth)
    return kErrShape;
  const int dh = d / n_heads;
  return dh == 32 || dh == 64 ? 0 : kErrShape;
}

}  // namespace

extern "C" {

// x, out: (N, L, d) bf16, contiguous; heads: (N * L + 80, d) bf16 scratch;
// mask: (L, L) f32 contiguous; LayerNorm parameters and biases bf16; the
// four weight matrices bf16 (in, out) in core matrices (each 16x16 tile's
// 512 bytes contiguous as four 8x8 core matrices, column half outer, k half
// inner, each 8 columns of 8 contiguous k), 16-byte aligned.  Takes head dim
// 32 or 64, d <= 768, L <= 80, N >= 1.  Returns 0, a cudaError_t code (>
// 0), or one of the negative codes above.
int fused_text_layer_forward(int device, const void* x, void* out, void* heads, const float* mask,
                             const void* ln1_s, const void* ln1_b, const void* qkv_w,
                             const void* qkv_b, const void* out_w, const void* out_b,
                             const void* ln2_s, const void* ln2_b, const void* fc_w,
                             const void* fc_b, const void* proj_w, const void* proj_b, int N,
                             int L, int d, int n_heads, float scale, float eps, void* stream) {
  int rc = check_shape(N, L, d, n_heads);
  if (rc != 0) return rc;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = smem_budget(device, &max_smem);
  if (err != cudaSuccess) return err;
  Params p;
  Layout lay;
  rc = plan(N, L, d, n_heads, max_smem, &p.seqs, &p.n_segs, &p.slot_tiles, &p.spare, &lay);
  if (rc != 0) return rc;
  p.x = static_cast<const bf16*>(x);
  p.out = static_cast<bf16*>(out);
  p.heads = static_cast<bf16*>(heads);
  p.mask = mask;
  p.w = Weights{static_cast<const bf16*>(ln1_s), static_cast<const bf16*>(ln1_b),
                static_cast<const bf16*>(qkv_w), static_cast<const bf16*>(qkv_b),
                static_cast<const bf16*>(out_w), static_cast<const bf16*>(out_b),
                static_cast<const bf16*>(ln2_s), static_cast<const bf16*>(ln2_b),
                static_cast<const bf16*>(fc_w), static_cast<const bf16*>(fc_b),
                static_cast<const bf16*>(proj_w), static_cast<const bf16*>(proj_b)};
  p.N = N; p.L = L; p.d = d; p.n_heads = n_heads;
  p.scale = scale; p.eps = eps;
  err = cudaFuncSetAttribute(fused_text_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)lay.total);
  if (err != cudaSuccess) return err;
  const int blocks = (N + p.seqs - 1) / p.seqs;
  fused_text_layer_kernel<<<blocks, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The launch plan of a call at (N, L, d, n_heads) on the device, into
// out[5]: sequences a block, blocks, MLP passes, weight-ring stages and
// dynamic shared bytes a block.  Returns as the forward does.
int fused_text_layer_plan(int device, int N, int L, int d, int n_heads, int* out) {
  int rc = check_shape(N, L, d, n_heads);
  if (rc != 0) return rc;
  int max_smem = 0;
  const cudaError_t err = smem_budget(device, &max_smem);
  if (err != cudaSuccess) return err;
  int seqs = 0, n_segs = 0, slot_tiles = 0, spare = 0;
  Layout lay;
  rc = plan(N, L, d, n_heads, max_smem, &seqs, &n_segs, &slot_tiles, &spare, &lay);
  if (rc != 0) return rc;
  const Blocks b = blocks_of(lay.rows, d);
  out[0] = seqs;
  out[1] = (N + seqs - 1) / seqs;
  out[2] = b.n_rb * b.n_cb;
  out[3] = kStages;
  out[4] = (int)lay.total;
  return 0;
}

// The layout of the weight matrices the forward takes: 1, core matrices
// (ops/fused_text_layer.py with_text_kernel_layout).  Builds without this
// function took them fragment-major (with_kernel_layout).
int fused_text_layer_weight_layout() { return 1; }

// The epilogue's QuickGELU alone: y = QuickGELU(x) for n (even) bf16
// values, 4-byte aligned, on the stream.  Returns a cudaError_t code.
int fused_text_layer_quick_gelu(const void* x, void* y, int n, void* stream) {
  const int threads = 256, blocks = (n / 2 + threads - 1) / threads;
  quick_gelu_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(y), n);
  return cudaGetLastError();
}

const char* fused_text_layer_error_string(int code) {
  switch (code) {
    case kErrShape: return "unsupported shape (head dim 32 or 64, d <= 768, L <= 80, N >= 1)";
    case kErrSharedMemory: return "no block layout fits shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
