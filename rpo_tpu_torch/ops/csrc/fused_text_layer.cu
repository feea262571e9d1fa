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
// Design.  One block of 512 threads (16 warps) takes S whole sequences (S * L
// <= 64 rows, or one sequence of up to 80 rows), so attention never crosses
// a block, and the last block masks ragged N itself.  The four projections
// run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators in
// registers), their A fragments from shared memory (ldmatrix); every
// product accumulates each output element over k in order, one mma a
// k-step, whatever the warp split, the ring or the register blocking.
// - Weights.  The block streams the layer's weights (6.3 MB at d = 512)
//   through a ring in shared memory, each weight byte from L2 once per
//   block.  The ring is a double buffer of two slots of up to 128 tiles (64
//   KB each at the CoCoOp chunk): after one barrier a stage, all 512
//   threads issue the 16-byte cp.async copies of the next stage, then the
//   warps work on this one; cp.async.wait_group and the next barrier hand
//   it over.  The wrapper hands the four matrices over fragment-major (each
//   16x16 tile 512 contiguous bytes, each lane's share of a k-step 16 of
//   them), so a stage is whole tiles, copied and read without a bank
//   conflict, a lane's B fragments one 16-byte shared load.  A stage holds
//   as many k-steps of one product as fit its slot.  The ring runs on
//   across products: the first stage of the next product (the next head's
//   q, k, v, the out projection, the MLP's next chunk) loads while the
//   block works on this one's last stage, on the attention or on LN2.  The
//   schedule (segment()) lists the products in the order the block runs
//   them; each block writes it into a table at the start of shared memory.
//   Fewer, larger stages matter more than a deeper ring here: the fixed
//   cost of a stage (the barrier, the copy loop's set-up) is paid by all
//   16 warps.
// - Warp splits, each output tile's f32 accumulators in registers:
//   q, k, v of a head (3 dh / 16 column tiles): 4 row groups x 4 column
//   warps, each warp 3 column tiles; the out projection: 2 row groups x 8
//   column warps, 2 column tiles each, in rounds of 16 column tiles; the
//   MLP's down-projection: each warp 2 column tiles for the 4 row tiles of
//   a 64-row block; fc: 2 row groups x 8 column warps, one 16-column tile
//   of a 128-wide hidden chunk each.  The products of a row tile follow its
//   A fragments' load in program order (mma_in_order), which keeps one row
//   tile's fragments in registers at a time beside the 64 accumulators.
// - The MLP's f32 down-projection accumulator stays in registers for the
//   whole hidden-chunk loop (64 floats a thread at d = 512): per chunk,
//   H = QuickGELU(z @ Wfc[:, chunk] + b) into shared memory, then the
//   accumulators take H @ Wproj[chunk, :]; the epilogue reads them
//   straight.  Where a block has more rows than 64 (L = 80) or d more
//   column tiles than 32 (d = 768), the MLP runs in passes over 64-row
//   blocks times column blocks, the fc chunks recomputed for each column
//   block (and the out projection in 64-row blocks).
// - Shared memory (dynamic, above 48 KB): LN1's output Y (rows x d bf16)
//   for the whole layer; then, over one region, one head's q, k, v and f32
//   scores, or one hidden chunk; then the weight ring.  The residual stream
//   x lives in the output tensor in device memory, the concatenated head
//   outputs in a scratch tensor the wrapper allocates ((N * L + kMaxRows) x
//   d bf16), copied into Y (dead by then) for the out projection.
// - Attention itself is plain f32 FMAs (0.5% of the work), each query row
//   by one warp, two rows a warp (a half-warp each) at L <= 16, so that the
//   block meets at no barrier between the scores, the softmax and p . v;
//   q and k rows are read 16 bytes a load, v two columns a load.
// What bounds it (PERF.md, PR 9, from the phase clocks below): the products
// on mma.sync at 17-30 SM clocks an instruction per sub-partition, against
// about 8 for mma.sync and 11-12 for the fragment loads from shared memory
// (A re-read for every k-step of every column tile), then the QuickGELU
// epilogue and the attention, each a serial phase of the block; the ring's
// waits and barriers are 2% of the time.  No wgmma, no TMA and no warp
// specialisation yet.  LayerNorm comes from fused_layer_common.cuh, shared
// with fused_rect_layer.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (rpo_tpu_torch/ops/_build.py).

#include "fused_layer_common.cuh"

extern __shared__ __align__(128) unsigned char fused_text_smem[];

namespace {

using namespace fused_layer;

constexpr int kHidden = 128;         // MLP hidden columns per chunk
constexpr int kTargetRows = 64;      // rows per block when L <= 64
constexpr int kMaxRows = 80;         // one sequence of L <= 80
constexpr int kTileElems = kTile * kTile;  // one fragment-major B tile
constexpr int kTileBytes = kTileElems * 2;
constexpr int kPieces = kTileBytes / 16;  // 16-byte copies a tile
constexpr int kStages = 2;                 // the weight ring: a double buffer
// The out projection and the MLP run in passes over blocks of their output,
// kBlockRowTiles row tiles by at most kBlockColTiles column tiles: warp w
// takes the block's column tiles w and w + kWarps for all its row tiles.
constexpr int kBlockRowTiles = 4;
constexpr int kBlockCols = 2;
constexpr int kBlockColTiles = kWarps * kBlockCols;
// the out projection: 2 row groups of a row block, 2 column tiles a warp,
// in rounds of kOutColTiles column tiles
constexpr int kOutGroups = 2, kOutRowTiles = 2, kOutCols = 2;
constexpr int kOutColTiles = kWarps / kOutGroups * kOutCols;
// q, k, v of a head: 4 row groups, 3 column tiles a warp (3 dh / 16 <= 12)
constexpr int kQkvGroups = 4, kQkvRowTiles = 2, kQkvCols = 3;
// fc: 2 row groups of a row block, one column tile a warp (kHidden / 16)
constexpr int kFcGroups = 2, kFcRowTiles = 2, kFcCols = 1;

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
  int n_segs, slot_tiles;  // the weight stream (segments()) and its ring's slots
  float scale, eps;
};

// One product's B operand in the weight stream: output tile t (of n_tiles)
// reads column tile col0 + t + (t / run) * run_stride (t < 3 run) of the
// fragment-major matrix B (nb column tiles, from its first k-step on), over
// nk k-steps, ksteps of them a stage of the ring.
struct Segment {
  const bf16* B;
  int nb, nk, n_tiles, col0, run, run_stride, ksteps;
};

struct Layout {  // byte offsets into dynamic shared memory
  int rows, ldy, ldh;
  size_t y, q, k, v, s, hid, ring, total;
};

// The segment table first (at offset 0), then Y, then one region for the
// attention or the MLP, then the ring.
__host__ __device__ inline Layout layout(int seqs, int L, int d, int dh, int n_segs,
                                         int slot_tiles) {
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
  const size_t block_rows = R < kBlockRowTiles * kTile ? R : kBlockRowTiles * kTile;
  const size_t mlp_end = o.hid + sizeof(bf16) * block_rows * (kHidden + kPadBf16);
  o.ring = round_up((int)(attn_end > mlp_end ? attn_end : mlp_end), 128);
  o.total = o.ring + (size_t)kStages * slot_tiles * kTileBytes;
  return o;
}

// The passes of the out projection and the MLP: row blocks of
// kBlockRowTiles tiles times column blocks of cbt tiles (the last may be
// narrower).
struct Blocks {
  int n_rb, n_cb, cbt;  // the MLP's
  int n_ob, obt;        // the out projection's column rounds
};
__host__ __device__ inline Blocks blocks_of(int mt, int d) {
  Blocks b;
  const int nt = d / kTile;
  b.n_rb = (mt + kBlockRowTiles - 1) / kBlockRowTiles;
  b.n_cb = (nt + kBlockColTiles - 1) / kBlockColTiles;
  b.cbt = (nt + b.n_cb - 1) / b.n_cb;
  b.n_ob = (nt + kOutColTiles - 1) / kOutColTiles;
  b.obt = (nt + b.n_ob - 1) / b.n_ob;
  return b;
}

// c += a (16x16) . b (16x8), as mma_16x8x16, kept in program order beside the
// loads (volatile), so that a warp holds one row tile's A fragments at a time.
__device__ __forceinline__ void mma_in_order(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared memory by 32-bit address: one register where a pointer takes two.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
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

// The block's products in the order it runs them: q, k, v of each head;
// the out projection's passes; per MLP pass, fc then proj of each chunk.
__host__ __device__ inline int segments(int n_heads, int mt, int d) {
  const Blocks b = blocks_of(mt, d);
  return n_heads + b.n_rb * (b.n_ob + b.n_cb * 2 * (4 * d / kHidden));
}

__device__ Segment segment(const Params& p, int mt, int s) {
  const int nt = p.d / kTile, ht = nt / p.n_heads;
  Segment g;
  const Blocks b = blocks_of(mt, p.d);
  const int n_out = b.n_rb * b.n_ob, n_chunks = 4 * p.d / kHidden;
  if (s < p.n_heads) {
    g = {p.w.qkv_w, 3 * nt, nt, 3 * ht, s * ht, ht, nt - ht, 0};
  } else if (s < p.n_heads + n_out) {
    const int c0 = (s - p.n_heads) % b.n_ob * b.obt, nc = min(b.obt, nt - c0);
    g = {p.w.out_w, nt, nt, nc, c0, nc, 0, 0};
  } else {
    const int m = s - p.n_heads - n_out, chunk = m / 2 % n_chunks;
    const int c0 = m / (2 * n_chunks) % b.n_cb * b.cbt, nc = min(b.cbt, nt - c0);
    if (m % 2 == 0)
      g = {p.w.fc_w, 4 * nt, nt, kHidden / kTile, chunk * (kHidden / kTile), kHidden / kTile, 0,
           0};
    else
      g = {p.w.proj_w + (size_t)chunk * kHidden * p.d, nt, kHidden / kTile, nc, c0, nc, 0, 0};
  }
  g.ksteps = min(g.nk, p.slot_tiles / g.n_tiles);
  return g;
}

// The segment table, built once per block at the start of shared memory.
__device__ __forceinline__ const Segment* table() {
  return reinterpret_cast<const Segment*>(fused_text_smem);
}

// The weight ring: kStages slots of p.slot_tiles B tiles each.  A stage is
// ksteps k-steps of one segment's tiles, tile (k-step ks, output tile t)
// at ks * n_tiles + t.  Every thread makes the same calls: the producer side
// (issue) keeps the next stage in flight while the consumer side (acquire)
// works on this one; past the last segment it commits empty groups.
struct Ring {
  uint32_t base;           // shared address of slot 0
  int p_seg, p_k, p_slot;  // the producer: segment, its next k-step, slot
  int c_seg, c_slot;       // the consumer
};

// Copy the next stage of the schedule into its slot as one cp.async group.
// The stage's 16-byte pieces go in slot order: piece i, at byte 16 i, is
// piece off (< row) of k-step ks; a k-step's output tiles are runs of
// contiguous column tiles in B.
__device__ __forceinline__ void issue(const Params& p, Ring& r) {
  if (r.p_seg < p.n_segs) {
    const Segment& g = table()[r.p_seg];
    const int row = g.n_tiles * kPieces, run = g.run * kPieces;
    const int n = min(g.ksteps, g.nk - r.p_k) * row;
    const int src_row = g.nb * kPieces, stride = g.run_stride * kPieces;
    const uint4* src =
        reinterpret_cast<const uint4*>(g.B) + ((size_t)r.p_k * g.nb + g.col0) * kPieces;
    const uint32_t dst = r.base + r.p_slot * p.slot_tiles * kTileBytes;
    int ks = 0, off = threadIdx.x;
    while (off >= row) off -= row, ++ks;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      cp_async16(dst + i * 16, src + ks * src_row + off + ((off >= run) + (off >= 2 * run)) * stride);
      off += kThreads;
      while (off >= row) off -= row, ++ks;
    }
    r.p_k += g.ksteps;
    if (r.p_k >= g.nk) {
      r.p_k = 0;
      ++r.p_seg;
    }
  }
  cp_async_commit();
  r.p_slot ^= 1;
}

// The next stage, once it has landed and every warp is done with the one
// before (whose slot then takes the stage after this one).
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

__device__ __forceinline__ uint32_t acquire(const Params& p, Ring& r) {
  EXTRA_START(t_wait);
  cp_async_wait_all();
  __syncthreads();
  EXTRA_END(kRingWait, t_wait);
  const uint32_t s = r.base + r.c_slot * p.slot_tiles * kTileBytes;
  r.c_slot ^= 1;
  issue(p, r);
  return s;
}

// This warp's row tiles i0 ... i0 + ni - 1 and first column tile in a split
// of mt row tiles into kGroups groups.
template <int kGroups>
struct Split {
  int i0, ni, tc;
  __device__ __forceinline__ explicit Split(int mt) {
    constexpr int kColWarps = kWarps / kGroups;
    const int warp = threadIdx.x / 32, per_group = (mt + kGroups - 1) / kGroups;
    i0 = warp / kColWarps * per_group;
    ni = min(per_group, mt - i0);
    tc = warp % kColWarps;
  }
};

template <int kRT, int kCT>
__device__ __forceinline__ void zero(float (&c)[kRT][kCT][2][4]) {
#pragma unroll
  for (int ii = 0; ii < kRT; ++ii)
#pragma unroll
    for (int j = 0; j < kCT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[ii][j][h][e] = 0.f;
}

// c += A @ B for the next segment of the ring: the mt row tiles of A (bf16,
// row-major at lda in shared memory) split into kGroups groups; a warp takes
// its group's row tiles (at most kRT) times the output tiles tc + j *
// kWarps / kGroups (j < kCT) below the segment's n_tiles.  Every thread
// must call it (the ring's barriers).  The k-steps reach each accumulator
// in order.
template <int kGroups, int kRT, int kCT>
__device__ __forceinline__ void ring_gemm(const Params& p, Ring& r, const bf16* A, int lda, int mt,
                                          float (&c)[kRT][kCT][2][4]) {
  constexpr int kColWarps = kWarps / kGroups;
  const Segment& g = table()[r.c_seg++];
  const int nk = g.nk, n_tiles = g.n_tiles, kst = g.ksteps, lane = threadIdx.x % 32;
  const Split<kGroups> w(mt);
  const uint32_t a_lane =
      smem_addr(A + (w.i0 * kTile + lane % 16) * lda + (lane / 16) * 8);
  for (int k0 = 0; k0 < nk; k0 += kst) {
    const uint32_t b_slot = acquire(p, r) + lane * 16;
    const int nks = min(kst, nk - k0);
#pragma unroll 1
    for (int ks = 0; ks < nks; ++ks) {
      uint4 b[kCT];
#pragma unroll
      for (int j = 0; j < kCT; ++j) {
        const int t = w.tc + j * kColWarps;
        if (t < n_tiles) b[j] = lds128(b_slot + (ks * n_tiles + t) * kTileBytes);
      }
#pragma unroll
      for (int ii = 0; ii < kRT; ++ii) {
        if (ii >= w.ni) continue;
        uint32_t a[4];
        ldmatrix_x4(a, a_lane + (ii * kTile * lda + (k0 + ks) * kTile) * 2);
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
          if (w.tc + j * kColWarps >= n_tiles) continue;
          mma_in_order(c[ii][j][0], a, b[j].x, b[j].y);
          mma_in_order(c[ii][j][1], a, b[j].z, b[j].w);
        }
      }
    }
  }
  // the callers' epilogues load biases and residuals: not before the
  // products are done, where they would hold registers beside them
  asm volatile("" ::: "memory");
}

// Each finished pair of adjacent columns of this warp's accumulators (the
// split of ring_gemm) to fn(row of A, output tile, column in the tile,
// value, value of the next column).
template <int kGroups, int kRT, int kCT, typename Fn>
__device__ __forceinline__ void for_each_pair(int mt, int n_tiles,
                                              const float (&c)[kRT][kCT][2][4], Fn fn) {
  constexpr int kColWarps = kWarps / kGroups;
  const int lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const Split<kGroups> w(mt);
#pragma unroll
  for (int ii = 0; ii < kRT; ++ii)
#pragma unroll
    for (int j = 0; j < kCT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = w.tc + j * kColWarps;
          if (ii < w.ni && t < n_tiles)
            fn((w.i0 + ii) * kTile + g + half * 8, t, h * 8 + q * 2, c[ii][j][h][2 * half],
               c[ii][j][h][2 * half + 1]);
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

__global__ void __launch_bounds__(kThreads) fused_text_layer_kernel(const Params p) {
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
  const Layout lay = layout(p.seqs, L, d, dh, p.n_segs, p.slot_tiles);
  const int seq0 = blockIdx.x * p.seqs;
  const int n_valid = min(p.seqs, p.N - seq0) * L;  // real rows of this block
  const int rows = lay.rows, mt = rows / kTile;
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
  const Blocks blk = blocks_of(mt, d);

  // the weight stream's schedule, then its first stages, which load during LN1
  for (int i = tid; i < p.n_segs; i += kThreads)
    reinterpret_cast<Segment*>(smem)[i] = segment(p, mt, i);
  __syncthreads();
  Ring ring{smem_addr(smem + lay.ring), 0, 0, 0, 0, 0};
  issue(p, ring);

  // ---- attention half: x + out_proj(attend(LN1(x))) ----------------------
  layer_norm_rows(x, n_valid, rows, d, p.w.ln1_s, p.w.ln1_b, p.eps, Y, ldy);
  PHASE_END(kSetUp);
  const int head_tiles = dh / kTile;
  for (int h = 0; h < p.n_heads; ++h) {
    // q, k, v of head h: 3 * dh / 16 column tiles of qkv_w (the ring's
    // first barrier orders LN1's Y before the products)
    float c[kQkvRowTiles][kQkvCols][2][4];
    zero(c);
    ring_gemm<kQkvGroups>(p, ring, Y, ldy, mt, c);
    for_each_pair<kQkvGroups>(mt, 3 * head_tiles, c, [&](int r, int t, int cl, float v0, float v1) {
      const int which = t / head_tiles, col = (t % head_tiles) * kTile + cl;
      bf16* dst = (which == 0 ? Q : which == 1 ? K : V) + r * ldh + col;
      const bf16* b = p.w.qkv_b + which * d + h * dh + col;
      dst[0] = __float2bfloat16(bf(v0) + f(b[0]));
      dst[1] = __float2bfloat16(bf(v1) + f(b[1]));
    });
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
  for (int r0 = 0; r0 < rows; r0 += kBlockRowTiles * kTile) {
    const int mt_b = min(kBlockRowTiles, (rows - r0) / kTile);
    for (int c0 = 0; c0 < d / kTile; c0 += blk.obt) {
      const int nc = min(blk.obt, d / kTile - c0);
      float c[kOutRowTiles][kOutCols][2][4];
      zero(c);
      ring_gemm<kOutGroups>(p, ring, Y + (size_t)r0 * ldy, ldy, mt_b, c);
      for_each_pair<kOutGroups>(mt_b, nc, c, [&](int r, int t, int cl, float v0, float v1) {
        r += r0;
        if (r >= n_valid) return;
        const int col = (c0 + t) * kTile + cl;
        const size_t e = (size_t)r * d + col;
        const float o0 = bf(bf(v0) + f(p.w.out_b[col])), o1 = bf(bf(v1) + f(p.w.out_b[col + 1]));
        out[e] = __float2bfloat16(f(x[e]) + o0);
        out[e + 1] = __float2bfloat16(f(x[e + 1]) + o1);
      });
    }
  }
  __syncthreads();

  // ---- MLP half: x + proj(QuickGELU(fc(LN2(x)))) -------------------------
  PHASE_END(kOutProj);
  layer_norm_rows(out, n_valid, rows, d, p.w.ln2_s, p.w.ln2_b, p.eps, Y, ldy);
  PHASE_END(kLn2);
  const int ldhid = kHidden + kPadBf16;
  for (int r0 = 0; r0 < rows; r0 += kBlockRowTiles * kTile) {
    const int mt_b = min(kBlockRowTiles, (rows - r0) / kTile);
    const bf16* Yb = Y + (size_t)r0 * ldy;
    for (int c0 = 0; c0 < d / kTile; c0 += blk.cbt) {
      const int nc = min(blk.cbt, d / kTile - c0);
      // the down-projection's accumulators, in registers for all chunks
      float acc[kBlockRowTiles][kBlockCols][2][4];
      zero(acc);
      for (int chunk = 0; chunk < 4 * d; chunk += kHidden) {
        // H = QuickGELU(Y @ Wfc[:, chunk] + b), rounding after every op; the
        // ring's barriers order it after the last chunk's reads of H
        float hc[kFcRowTiles][kFcCols][2][4];
        zero(hc);
        ring_gemm<kFcGroups>(p, ring, Yb, ldy, mt_b, hc);
        PHASE_END(kFc);
        for_each_pair<kFcGroups>(mt_b, kHidden / kTile, hc,
                                 [&](int r, int t, int cl, float v0, float v1) {
          const int col = t * kTile + cl;
          const float v[2] = {v0, v1};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float hv = bf(bf(v[e]) + f(p.w.fc_b[chunk + col + e]));
            const float t1 = bf(1.703125f * hv);  // 1.702 in bf16
            const float ex = bf(expf(-t1));
            const float den = bf(1.f + ex);
            const float sig = bf(__frcp_rn(den));  // 1 / den, correctly rounded
            H[r * ldhid + col + e] = __float2bfloat16(hv * sig);
          }
        });
        // acc += H @ Wproj[chunk, block] (the ring's first barrier orders H)
        PHASE_END(kGelu);
        ring_gemm<1>(p, ring, H, ldhid, mt_b, acc);
        PHASE_END(kProj);
      }
      // out = x + (acc rounded, + bias rounded), straight from the registers
      for_each_pair<1>(mt_b, nc, acc, [&](int r, int t, int cl, float v0, float v1) {
        r += r0;
        if (r >= n_valid) return;
        const int col = (c0 + t) * kTile + cl;
        const size_t e = (size_t)r * d + col;
        const float o0 = bf(bf(v0) + f(p.w.proj_b[col]));
        const float o1 = bf(bf(v1) + f(p.w.proj_b[col + 1]));
        out[e] = __float2bfloat16(f(out[e]) + o0);
        out[e + 1] = __float2bfloat16(f(out[e + 1]) + o1);
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

// The most sequences per block whose ring slots, as large as what is left
// allows up to kMaxSlotTiles, hold every segment's tiles of a k-step; 0
// with the layout on success.
int plan(int N, int L, int d, int n_heads, int max_smem, int* seqs, int* n_segs, int* slot_tiles,
         Layout* lay) {
  const int dh = d / n_heads;
  for (int s = L <= kTargetRows ? kTargetRows / L : 1; s >= 1; --s) {
    const int seq = s < N ? s : N, mt = round_up(seq * L, kTile) / kTile;
    const int segs = segments(n_heads, mt, d);
    const Blocks b = blocks_of(mt, d);
    int need = 3 * dh / kTile > b.cbt ? 3 * dh / kTile : b.cbt;  // b.obt <= b.cbt
    if (need < kHidden / kTile) need = kHidden / kTile;
    const size_t ring = layout(seq, L, d, dh, segs, 0).ring;
    if ((size_t)max_smem < ring) continue;
    int tiles = (int)((max_smem - ring) / (kStages * kTileBytes));
    if (tiles > kMaxSlotTiles) tiles = kMaxSlotTiles;
    if (tiles < need) continue;
    *seqs = seq;
    *n_segs = segs;
    *slot_tiles = tiles;
    *lay = layout(seq, L, d, dh, segs, tiles);
    return 0;
  }
  return kErrSharedMemory;
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
// four weight matrices bf16 (in, out) fragment-major (each 16x16 tile's 512
// bytes contiguous, lane by lane, in the order of the lane's two m16n8k16 B
// fragments), 16-byte aligned.  Takes head dim 32 or 64, d <= 768, L <= 80,
// N >= 1.  Returns 0, a cudaError_t code (> 0), or one of the negative
// codes above.
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
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  Params p;
  Layout lay;
  rc = plan(N, L, d, n_heads, max_smem, &p.seqs, &p.n_segs, &p.slot_tiles, &lay);
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
  const cudaError_t err =
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  int seqs = 0, n_segs = 0, slot_tiles = 0;
  Layout lay;
  rc = plan(N, L, d, n_heads, max_smem, &seqs, &n_segs, &slot_tiles, &lay);
  if (rc != 0) return rc;
  const Blocks b = blocks_of(lay.rows / kTile, d);
  out[0] = seqs;
  out[1] = (N + seqs - 1) / seqs;
  out[2] = b.n_rb * b.n_cb;
  out[3] = kStages;
  out[4] = (int)lay.total;
  return 0;
}

const char* fused_text_layer_error_string(int code) {
  switch (code) {
    case kErrShape: return "unsupported shape (head dim 32 or 64, d <= 768, L <= 80, N >= 1)";
    case kErrSharedMemory: return "no block layout fits shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
