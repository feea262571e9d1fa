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
// Design: right and simple first.  The TPU kernel's 64-row block grid and its
// padding of N are tiling artifacts; here one block of 512 threads (16 warps)
// takes S whole sequences (S * L <= 64 rows, or one sequence of up to 80
// rows), so attention never crosses a block, and the last block masks ragged
// N itself.  The four projections run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulators in registers): each warp owns a
// 16-column tile of the output for half the row tiles of the block, takes its A
// fragments from shared memory (ldmatrix) and its B fragments straight from
// the weights in device memory, L2-resident (every block reads the layer's
// 6.3 MB once).  Those loads' latency is what bounds this design, so the
// wrapper hands the four weight matrices over fragment-major (each lane's
// share of a 16x16 tile is 16 contiguous bytes, one load), and each warp
// keeps kDepth k-steps of B in flight in registers ahead of its products.
// The epilogues (bf16 roundings, bias adds, QuickGELU, residual adds) work
// element by element on the accumulators' registers.
// Shared memory (dynamic, above 48 KB) holds the LayerNorm output Y (rows x d
// bf16) for the whole layer and, in turn, one head's q, k, v and f32 scores,
// then the MLP's f32 down-projection accumulator beside one 128-wide hidden
// chunk.  Where that accumulator does not fit (d = 768, or L = 80) the MLP
// runs in P passes over column blocks of the output, recomputing the hidden
// chunks (the host picks the least P that fits).  The residual stream x lives
// in the output tensor in device memory, and the concatenated head outputs
// in a scratch tensor the wrapper allocates ((N * L + kMaxRows) x d bf16),
// copied into Y (dead by then) for the out projection.
// Attention itself is plain f32 FMAs: 0.5% of the work.  No TMA, no wgmma and
// no shared-memory pipeline yet: a later PR's work.
// The products (gemm_tiles), the LayerNorm and the MLP half (mlp_passes) are
// in fused_layer_common.cuh, shared with fused_rect_layer.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (rpo_tpu_torch/ops/_build.py).

#include "fused_layer_common.cuh"

namespace {

using namespace fused_layer;

constexpr int kRowGroups = 2;        // warps that share an output column tile
constexpr int kHidden = 128;         // MLP hidden columns per chunk
constexpr int kTargetRows = 64;      // rows per block when L <= 64
constexpr int kMaxRows = 80;         // one sequence of L <= 80
constexpr int kMaxRowTiles = kMaxRows / kTile;
constexpr int kMaxGroupTiles = (kMaxRowTiles + kRowGroups - 1) / kRowGroups;

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
  int N, L, d, n_heads, seqs, passes;
  float scale, eps;
};

struct Layout {  // byte offsets into dynamic shared memory
  int rows, ldy, ldh;
  size_t y, q, k, v, s, acc, hid, total;
};

__host__ __device__ inline Layout layout(int seqs, int L, int d, int dh, int passes) {
  Layout o;
  o.rows = round_up(seqs * L, kTile);
  o.ldy = d + kPadBf16;
  o.ldh = dh + 2;  // odd word count: the keys one warp reads fall in distinct banks
  const size_t R = o.rows;
  o.y = 0;
  const size_t region = o.y + sizeof(bf16) * R * o.ldy;
  // attention phase
  o.q = region;
  o.k = o.q + round_up((int)(sizeof(bf16) * R * o.ldh), 128);
  o.v = o.k + round_up((int)(sizeof(bf16) * R * o.ldh), 128);
  o.s = o.v + round_up((int)(sizeof(bf16) * R * o.ldh), 128);
  const size_t attn_end = o.s + sizeof(float) * R * L;
  // MLP phase, over the same bytes: its f32 accumulator, then a hidden chunk
  o.acc = region;
  o.hid = o.acc + sizeof(float) * R * (d / passes + kPadF32);
  const size_t mlp_end = region + mlp_bytes(o.rows, d, passes, kHidden);
  o.total = attn_end > mlp_end ? attn_end : mlp_end;
  return o;
}

__global__ void __launch_bounds__(kThreads) fused_text_layer_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int L = p.L, d = p.d, dh = d / p.n_heads;
  const Layout lay = layout(p.seqs, L, d, dh, p.passes);
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
  float* ACC = reinterpret_cast<float*>(smem + lay.acc);
  bf16* H = reinterpret_cast<bf16*>(smem + lay.hid);
  const int ldh = lay.ldh, ldy = lay.ldy;

  // ---- attention half: x + out_proj(attend(LN1(x))) ----------------------
  layer_norm_rows(x, n_valid, rows, d, p.w.ln1_s, p.w.ln1_b, p.eps, Y, ldy);
  __syncthreads();
  const int head_tiles = dh / kTile;
  for (int h = 0; h < p.n_heads; ++h) {
    // q, k, v of head h: 3 * dh / 16 column tiles of qkv_w
    gemm_tiles<kRowGroups, kMaxGroupTiles>(
        Y, ldy, p.w.qkv_w, 3 * d / kTile, d, 3 * head_tiles, mt,
        [&](int t) { return ((t / head_tiles) * d + h * dh) / kTile + t % head_tiles; },
        nullptr, 0, [&](int r, int t, int cl, float v0, float v1) {
          const int which = t / head_tiles, c = (t % head_tiles) * kTile + cl;
          bf16* dst = (which == 0 ? Q : which == 1 ? K : V) + r * ldh + c;
          const bf16* b = p.w.qkv_b + which * d + h * dh + c;
          dst[0] = __float2bfloat16(bf(v0) + f(b[0]));
          dst[1] = __float2bfloat16(bf(v1) + f(b[1]));
        });
    __syncthreads();
    // scores of each valid row against the keys of its own sequence
    for (int idx = tid; idx < n_valid * L; idx += kThreads) {
      const int r = idx / L, j = idx % L;
      const int i = r % L, key = r - i + j;
      const __nv_bfloat162* qr = reinterpret_cast<const __nv_bfloat162*>(Q + r * ldh);
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(K + key * ldh);
      float s = 0.f;
      for (int c = 0; c < dh / 2; ++c) {
        const float2 a = __bfloat1622float2(qr[c]), b = __bfloat1622float2(kr[c]);
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
      }
      S[r * L + j] = __fadd_rn(__fmul_rn(s, p.scale), p.mask[i * L + j]);
    }
    __syncthreads();
    // softmax per row in f32, normalised, then rounded to bf16
    const int lane = tid % 32;
    for (int r = warp; r < n_valid; r += kWarps) {
      float* row = S + r * L;
      float m = -3.402823466e+38f;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int j = lane; j < L; j += 32) row[j] = bf(row[j] / sum);
    }
    __syncthreads();
    // o = p . v, f32 accumulation, rounded, into head h's columns
    for (int idx = tid; idx < n_valid * dh; idx += kThreads) {
      const int r = idx / dh, c = idx % dh;
      const int base = r - r % L;
      float o = 0.f;
      for (int j = 0; j < L; ++j) o = fmaf(S[r * L + j], f(V[(base + j) * ldh + c]), o);
      heads[(size_t)r * d + h * dh + c] = __float2bfloat16(o);
    }
    __syncthreads();
  }
  // the head outputs into Y (LN1's output is dead), so that the out
  // projection reads its A fragments from shared memory
  for (int idx = tid; idx < rows * (d / 8); idx += kThreads) {
    const int r = idx / (d / 8), c = (idx % (d / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n_valid) v = *reinterpret_cast<const uint4*>(heads + (size_t)r * d + c);
    *reinterpret_cast<uint4*>(Y + (size_t)r * ldy + c) = v;
  }
  __syncthreads();
  // out projection and the residual add: out = x + (heads @ Wout + b)
  gemm_tiles<kRowGroups, kMaxGroupTiles>(
      Y, ldy, p.w.out_w, d / kTile, d, d / kTile, mt, [](int t) { return t; }, nullptr, 0,
      [&](int r, int t, int cl, float v0, float v1) {
        if (r >= n_valid) return;
        const int c = t * kTile + cl;
        const size_t e = (size_t)r * d + c;
        const float o0 = bf(bf(v0) + f(p.w.out_b[c])), o1 = bf(bf(v1) + f(p.w.out_b[c + 1]));
        out[e] = __float2bfloat16(f(x[e]) + o0);
        out[e + 1] = __float2bfloat16(f(x[e + 1]) + o1);
      });
  __syncthreads();

  // ---- MLP half: x + proj(QuickGELU(fc(LN2(x)))) -------------------------
  layer_norm_rows(out, n_valid, rows, d, p.w.ln2_s, p.w.ln2_b, p.eps, Y, ldy);
  __syncthreads();
  mlp_passes<kRowGroups, kRowGroups, kMaxRowTiles, kHidden>(
      Y, ldy, rows, n_valid, d, p.passes, p.w.fc_w, p.w.fc_b, p.w.proj_w, p.w.proj_b, ACC, H, out,
      out);
}

// The least MLP pass count that fits, at the most sequences per block that
// fit; 0 with the layout on success.
int plan(int N, int L, int d, int dh, int max_smem, int* seqs, int* passes, Layout* lay) {
  for (int s = L <= kTargetRows ? kTargetRows / L : 1; s >= 1; --s) {
    for (int pc = 1; pc <= d / kTile; ++pc) {
      if ((d / kTile) % pc) continue;
      const Layout l = layout(s, L, d, dh, pc);
      if (l.total <= (size_t)max_smem) {
        *seqs = s < N ? s : N;
        *passes = pc;
        *lay = layout(*seqs, L, d, dh, pc);
        return 0;
      }
    }
  }
  return kErrSharedMemory;
}

}  // namespace

extern "C" {

// x, out: (N, L, d) bf16, contiguous; heads: (N * L + 80, d) bf16 scratch;
// mask: (L, L) f32 contiguous; LayerNorm parameters and biases bf16; the
// four weight matrices bf16 (in, out) in the fragment-major layout of
// gemm_tiles, 16-byte aligned.  Takes head dim 32 or 64, d <= 768, L <= 80, N >= 1.
// Returns 0, a cudaError_t code (> 0), or one of the negative codes above.
int fused_text_layer_forward(int device, const void* x, void* out, void* heads, const float* mask,
                             const void* ln1_s, const void* ln1_b, const void* qkv_w,
                             const void* qkv_b, const void* out_w, const void* out_b,
                             const void* ln2_s, const void* ln2_b, const void* fc_w,
                             const void* fc_b, const void* proj_w, const void* proj_b, int N,
                             int L, int d, int n_heads, float scale, float eps, void* stream) {
  if (N < 1 || L < 1 || L > kMaxRows || n_heads < 1 || d % n_heads || d > kMaxWidth)
    return kErrShape;
  const int dh = d / n_heads;
  if (dh != 32 && dh != 64) return kErrShape;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  Params p;
  Layout lay;
  const int rc = plan(N, L, d, dh, max_smem, &p.seqs, &p.passes, &lay);
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

const char* fused_text_layer_error_string(int code) {
  switch (code) {
    case kErrShape: return "unsupported shape (head dim 32 or 64, d <= 768, L <= 80, N >= 1)";
    case kErrSharedMemory: return "no block layout fits shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
