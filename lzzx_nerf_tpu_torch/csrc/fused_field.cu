// The serving field for one frame, hand-written for Hopper (sm_90a): the
// triplane lookup, the SH-4 basis and the folded-weight MLP stack in one
// kernel, the MLP on tensor cores in 3xTF32 (near float32).
//
// Replaces: lzzx_nerf_tpu/ops/fused_field.py::_field_kernel, the Pallas
// TPU kernel behind fused_field_eval, together with the XLA ops the JAX
// package runs in front of it (NeRFField.encode_x: three packed_lookup
// calls; sh_encode). Same function, per sample (pts, dirs):
//   enc_x  = packed_lookup(xy) | packed_lookup(yz) | packed_lookup(xz) [36]
//   sh     = SH-4 basis of dirs                                       [16]
//   h_ae   = relu(enc_x @ [aud0 | eye0])                              [80]
//   att    = h_ae[:64] @ aud1                                         [32]
//   eye    = sigmoid(h_ae[64:80] . eye1)                              scalar
//   h      = relu(enc_x @ sig0x + att @ sig0a_f + eye * v_eye)
//   h      = relu(h @ sig1);  o = h @ sig2                            [65]
//   sigma  = exp(o[0]);  geo = o[1:]
//   hc     = relu(geo @ col0g + sh @ col0s + bias_c)
//   rgb    = sigmoid(hc @ col1) * 1.002 - 0.001
// out[n] = (sigma, r, g, b).
//
// A second entry, field_enc_kernel (fused_field_enc_launch), computes the
// Pallas kernel's own function: it reads enc_x [n, 36] float32 in place of
// the three lookups (the hash head's encoding, computed outside the
// kernel by grid_encode) and shares the SH basis and the MLP (mlp_tile).
//
// What bounds it on the H100: arithmetic. The MLP is 22,928 multiply-adds
// (45.9 kFLOP) per sample; a sample reads 24 B (pts, dirs) and writes 16 B,
// and the three bf16 tables (22.8 MB) stay in the 50 MB L2. The features
// and the SH basis never reach device memory.
//
// Design:
// - Tensor cores, near float32 accuracy: mma.sync m16n8k8 TF32 with the
//   3xTF32 split. Each operand x becomes hi = rna_tf32(x) and
//   lo = rna_tf32(x - hi) (round to nearest, ties away, as cvt.rna.tf32.f32
//   does); a product tile sums lo*hi + hi*lo + hi*hi into float32
//   accumulators (lo*lo, below 2^-22 relative, is dropped). hi + lo keep
//   about 22 of float32's 24 bits, and the tensor cores' float32 sums
//   appear to truncate, so the result is not float32's: over 8 frames of
//   the trained state the colours differ from the plain float32 version
//   by up to 8.4e-6 (an all-float32 kernel: about 5e-7), within the 1e-5
//   the port holds it to. Summing each k-tile into a fresh accumulator
//   cuts that to 2.3e-6 but spills at 128 registers and runs 30 % slower.
//   The weights
//   arrive split (ops/fused_field.py pack_frame_weights); the activations
//   are split here, two integer operations per rounding.
// - A warp owns 16 samples (one m16 tile) at a time. Its 32 lanes look up
//   the 48 (sample, plane) rows, one or two each, into the warp's staging
//   tile in shared memory (16 rows x 40 floats: enc_x and 4 zeros), which
//   the MLP reads as A fragments. The SH basis is computed in fragment
//   layout directly from dirs. More warps hide more latency: 16 warps of
//   one m-tile ran faster than 8 warps of two m-tiles sharing each weight
//   fragment.
// - Activations stay in registers from layer to layer. In m16n8k8 the
//   accumulator registers c0..c3 hold (row g, col 2t), (g, 2t+1),
//   (g+8, 2t), (g+8, 2t+1) and the A registers a0..a3 hold (g, k t),
//   (g+8, t), (g, t+4), (g+8, t+4) (g = lane/4, t = lane%4). Reading the
//   k-slots of every 8-wide k-tile as the physical columns 2t (slot t) and
//   2t+1 (slot t+4), layer i's accumulators {c0, c2, c1, c3} are layer
//   i+1's A fragment with no data movement. The weights are packed to the
//   same reading: the B fragment of lane (g, t) for k-tile j and n-tile m
//   is (W[8j+2t][8m+g], W[8j+2t+1][8m+g]), hi then lo, stored as one
//   lane-contiguous float4, so a warp reads it in one conflict-free load.
//   sig2's geo columns (1..64) form their own 64 x 64 block, whose n-tiles
//   are color layer 0's A fragment as they stand; its sigma column is a
//   float32 dot (a quad reduction), which takes a mostly empty n-tile off
//   the tensor cores and out of shared memory.
// - The per-frame weights (47,568 floats, 190,272 B: hi and lo, zero-padded
//   to the tile sizes) are copied once into shared memory by each
//   persistent block (one per SM), which walks 16-sample steps in a
//   grid-stride loop. With the 16 warps' staging tiles the block takes
//   231,232 B of the 232,448 allowed: one block of 16 warps per SM, at up
//   to 128 registers a thread.
// - The weight loads are indexed from an offset the compiler cannot see
//   through, so it cannot hoist them out of the sample loop (a fully
//   unrolled earlier design spilled 91 KB of stack when it did).
// - The lookup rounds like packed_lookup (the file is built with
//   -fmad=false): u = (q + bound) / (2 bound), clip, per-level cell and
//   fraction, and the bilinear combine in the order of the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;  // samples per warp step: one m16 tile
constexpr int kLd = 40;    // staging row: enc_x [0, 36), zeros [36, 40)

// triplane tables: DenseTriplaneSpec() — levels 64/128/256/512 with 4/3/3/2
// channels, packed at 256² into rows of 58 bf16 (29 words)
constexpr int kPack = 256;
constexpr int kRowWords = 29;

// weight layout, offsets in floats; must match _W_LAYOUT in
// lzzx_nerf_tpu_torch/ops/fused_field.py (a CPU test compares them).
// Matrices are in fragment order, [k-tile][n-tile][lane][hi 2, lo 2].
constexpr int O_WAE = 0;        // [40 x 80]  aud0 | eye0, K padded
constexpr int O_AUD1 = 6400;    // [64 x 32]
constexpr int O_SIG0X = 10496;  // [40 x 64]  K padded
constexpr int O_SIG0A = 15616;  // [32 x 64]  enc_a folded in
constexpr int O_SIG1 = 19712;   // [64 x 64]
constexpr int O_SIG2 = 27904;   // [64 x 64]  sig2's geo columns 1..64
constexpr int O_COL0G = 36096;  // [64 x 64]
constexpr int O_COL0S = 44288;  // [16 x 64]
constexpr int O_COL1 = 46336;   // [64 x 8]   N padded
constexpr int O_EYE1 = 47360;   // [16]
constexpr int O_SIGMA = 47376;  // [64]       sig2's sigma column 0
constexpr int O_VEYE = 47440;   // [64]       eye * sig0e
constexpr int O_BIASC = 47504;  // [64]       ind @ col0i
constexpr int W_TOTAL = 47568;

constexpr int SMEM_BYTES = (W_TOTAL + kWarps * kRows * kLd) * 4;

static_assert(W_TOTAL % 4 == 0, "weights are copied as float4");
static_assert(SMEM_BYTES <= 232448, "over a Hopper block's shared memory");

// round to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[m] += a @ W[k-tile j, n-tile m] for every n-tile m, in 3xTF32.
// `a` is one A fragment in float32; `wl` the layer's weights.
template <int NT>
__device__ __forceinline__ void ktile(float (&c)[NT][4], const float (&a)[4],
                                      const float* wl, int j, int lane) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) split(a[q], ah[q], al[q]);
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    const float4 b =
        *reinterpret_cast<const float4*>(wl + ((j * NT + m) * 32 + lane) * 4);
    const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
    mma(c[m], al, bh0, bh1);
    mma(c[m], ah, __float_as_uint(b.z), __float_as_uint(b.w));
    mma(c[m], ah, bh0, bh1);
  }
}

// c[m] += act[:, :8 KT] @ W for a layer whose input is (the first KT
// n-tiles of) a previous layer's accumulators: k-tile j's A fragment is
// that layer's n-tile j read as {c0, c2, c1, c3}
template <int KT, int NA, int NT>
__device__ __forceinline__ void layer(float (&c)[NT][4],
                                      const float (&act)[NA][4],
                                      const float* wl, int lane) {
  static_assert(KT <= NA, "input narrower than the layer");
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const float a[4] = {act[j][0], act[j][2], act[j][1], act[j][3]};
    ktile<NT>(c, a, wl, j, lane);
  }
}

// c[m] += enc_x @ W, enc_x read from the warp's staging tile
template <int NT>
__device__ __forceinline__ void layer_staged(float (&c)[NT][4],
                                             const float* tile,
                                             const float* wl, int g, int t,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < kLd / 8; ++j) {
    const float* p = tile + g * kLd + 8 * j + 2 * t;
    const float2 r0 = *reinterpret_cast<const float2*>(p);
    const float2 r8 = *reinterpret_cast<const float2*>(p + 8 * kLd);
    const float a[4] = {r0.x, r8.x, r0.y, r8.y};
    ktile<NT>(c, a, wl, j, lane);
  }
}

// c[m] = (rows g, g+8) x v[8m + 2t, 8m + 2t + 1]: an outer product (s0, s8
// per row) or a bias (s0 = s8 = 1), the accumulators' initial value
template <int NT>
__device__ __forceinline__ void init_acc(float (&c)[NT][4], const float* v,
                                         float s0, float s8, int t) {
#pragma unroll
  for (int m = 0; m < NT; ++m) {
    const float2 b = *reinterpret_cast<const float2*>(v + 8 * m + 2 * t);
    c[m][0] = s0 * b.x;
    c[m][1] = s0 * b.y;
    c[m][2] = s8 * b.x;
    c[m][3] = s8 * b.y;
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&c)[NT][4]) {
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[m][q] = 0.0f;
}

template <int NT>
__device__ __forceinline__ void relu(float (&c)[NT][4]) {
#pragma unroll
  for (int m = 0; m < NT; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[m][q] = fmaxf(c[m][q], 0.0f);
}

// the sum over the lane's quad (the four lanes of rows g, g+8)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float color(float v) {
  return sigmoid(v) * 1.002f - 0.001f;
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// bf16 element I of the row's 40 leading elements (levels 64/128/256)
template <int I>
__device__ __forceinline__ float elem(const uint32_t (&wd)[20]) {
  return (I & 1) ? bf_hi(wd[I >> 1]) : bf_lo(wd[I >> 1]);
}

__device__ __forceinline__ float bilerp(float c00, float c10, float c01,
                                        float c11, float fx, float fy) {
  return c00 * (1.0f - fx) * (1.0f - fy) + c10 * fx * (1.0f - fy)
         + c01 * (1.0f - fx) * fy + c11 * fx * fy;
}

__device__ __forceinline__ int cell_of(float v, int r) {
  return min(max((int)floorf(v), 0), r - 1);
}

// one coarse level (R <= 256): the row holds the 4 corners of the level's
// cell, C channels each, from element OFF; features go to f[OC, OC + C)
template <int R, int C, int OFF, int OC, int CH = 0>
__device__ __forceinline__ void coarse_level(const uint32_t (&wd)[20],
                                             float ux, float uy,
                                             float (&f)[12]) {
  const float vx = ux * R, vy = uy * R;
  const float fx = vx - (float)cell_of(vx, R);
  const float fy = vy - (float)cell_of(vy, R);
  f[OC + CH] = bilerp(elem<OFF + CH>(wd), elem<OFF + C + CH>(wd),
                      elem<OFF + 2 * C + CH>(wd), elem<OFF + 3 * C + CH>(wd),
                      fx, fy);
  if constexpr (CH + 1 < C) coarse_level<R, C, OFF, OC, CH + 1>(wd, ux, uy, f);
}

// packed_lookup of one plane: (qx, qy) in [-bound, bound] -> 12 features
// written to dst (16-byte aligned); zeros outside the box or for NaN
__device__ __forceinline__ void lookup(float qx, float qy,
                                       const uint32_t* __restrict__ table,
                                       float bound, float* dst) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  float ux = (qx + bound) / (2.0f * bound);
  float uy = (qy + bound) / (2.0f * bound);
  if (!(ux >= 0.0f && ux <= 1.0f && uy >= 0.0f && uy <= 1.0f)) {
    d4[0] = d4[1] = d4[2] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  float f[12];
  ux = fminf(fmaxf(ux, 0.0f), 1.0f);
  uy = fminf(fmaxf(uy, 0.0f), 1.0f);
  const int px = cell_of(ux * kPack, kPack), py = cell_of(uy * kPack, kPack);
  const uint32_t* row = table + (size_t)(px * kPack + py) * kRowWords;
  uint32_t wd[20];
#pragma unroll
  for (int i = 0; i < 20; ++i) wd[i] = __ldg(row + i);
  coarse_level<64, 4, 0, 0>(wd, ux, uy, f);
  coarse_level<128, 3, 16, 4>(wd, ux, uy, f);
  coarse_level<256, 3, 28, 7>(wd, ux, uy, f);
  // level 512: the row holds 3x3 points (words 20-28, 2 channels each);
  // the cell's corners are picked by its offset inside the packing cell
  const float vx = ux * 512.0f, vy = uy * 512.0f;
  const int cx = cell_of(vx, 512), cy = cell_of(vy, 512);
  const float fx = vx - (float)cx, fy = vy - (float)cy;
  const int k00 = (cx - 2 * px) * 3 + (cy - 2 * py);
  const uint32_t p00 = __ldg(row + 20 + k00), p10 = __ldg(row + 23 + k00);
  const uint32_t p01 = __ldg(row + 21 + k00), p11 = __ldg(row + 24 + k00);
  f[10] = bilerp(bf_lo(p00), bf_lo(p10), bf_lo(p01), bf_lo(p11), fx, fy);
  f[11] = bilerp(bf_hi(p00), bf_hi(p10), bf_hi(p01), bf_hi(p11), fx, fy);
  d4[0] = make_float4(f[0], f[1], f[2], f[3]);
  d4[1] = make_float4(f[4], f[5], f[6], f[7]);
  d4[2] = make_float4(f[8], f[9], f[10], f[11]);
}

// real SH basis, degree 4, in the order and rounding of ops/sh.py
__device__ __forceinline__ void sh4(float x, float y, float z, float (&s)[16]) {
  const float xy = x * y, yz = y * z, xz = x * z;
  const float x2 = x * x, y2 = y * y, z2 = z * z;
  s[0] = 0.28209479177387814f;
  s[1] = -0.48860251190291987f * y;
  s[2] = 0.48860251190291987f * z;
  s[3] = -0.48860251190291987f * x;
  s[4] = 1.0925484305920792f * xy;
  s[5] = -1.0925484305920792f * yz;
  s[6] = 0.94617469575755997f * z2 - 0.31539156525251999f;
  s[7] = -1.0925484305920792f * xz;
  s[8] = 0.54627421529603959f * (x2 - y2);
  s[9] = 0.59004358992664352f * y * (-3.0f * x2 + y2);
  s[10] = 2.8906114426405538f * xy * z;
  s[11] = 0.45704579946446572f * y * (1.0f - 5.0f * z2);
  s[12] = 0.3731763325901154f * z * (5.0f * z2 - 3.0f);
  s[13] = 0.45704579946446572f * x * (1.0f - 5.0f * z2);
  s[14] = 1.4453057213202769f * z * (x2 - y2);
  s[15] = 0.59004358992664352f * x * (-x2 + 3.0f * y2);
}

// s[B + 2t] for a compile-time B and the lane's t, without indexing the
// register array at run time
template <int B>
__device__ __forceinline__ float pick(const float (&s)[16], int t) {
  return t == 0 ? s[B] : t == 1 ? s[B + 2] : t == 2 ? s[B + 4] : s[B + 6];
}

// the SH basis of rows g and g+8 (directions d0, d8) as the two A
// fragments of color layer 0
__device__ __forceinline__ void sh_fragments(const float (&d0)[3],
                                             const float (&d8)[3], int t,
                                             float (&a)[2][4]) {
  float s0[16], s8[16];
  sh4(d0[0], d0[1], d0[2], s0);
  sh4(d8[0], d8[1], d8[2], s8);
  a[0][0] = pick<0>(s0, t);
  a[0][1] = pick<0>(s8, t);
  a[0][2] = pick<1>(s0, t);
  a[0][3] = pick<1>(s8, t);
  a[1][0] = pick<8>(s0, t);
  a[1][1] = pick<8>(s8, t);
  a[1][2] = pick<9>(s0, t);
  a[1][3] = pick<9>(s8, t);
}

// The MLP stack on the warp's 16 staged samples base .. base + 15; lane
// t == 0 of each quad writes (sigma, r, g, b) of rows g and g + 8. Sample
// indices are unsigned (n < 2^31, so base + 15 cannot wrap) and scaled in
// 64 bits (3 n passes 2^31 from n = 715,827,883).
__device__ __forceinline__ void mlp_tile(const float* tile, const float* w,
                                         const float* __restrict__ dirs,
                                         float* __restrict__ out,
                                         unsigned base, unsigned n,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  const unsigned s0 = base + g, s8 = base + g + 8;
  float d0[3] = {0.0f, 0.0f, 0.0f}, d8[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (s0 < n) d0[i] = dirs[3 * (size_t)s0 + i];
    if (s8 < n) d8[i] = dirs[3 * (size_t)s8 + i];
  }

  // shared first layer: [att hidden (n-tiles 0-7) | eye hidden (8-9)]
  float h_ae[10][4];
  zero_acc<10>(h_ae);
  layer_staged<10>(h_ae, tile, w + O_WAE, g, t, lane);
  relu<10>(h_ae);

  // eye attention: the 16-wide dot as a quad reduction
  const float2 e_lo = *reinterpret_cast<const float2*>(w + O_EYE1 + 2 * t);
  const float2 e_hi = *reinterpret_cast<const float2*>(w + O_EYE1 + 8 + 2 * t);
  const float e0 = sigmoid(quad_sum(h_ae[8][0] * e_lo.x + h_ae[8][1] * e_lo.y
                                    + h_ae[9][0] * e_hi.x
                                    + h_ae[9][1] * e_hi.y));
  const float e8 = sigmoid(quad_sum(h_ae[8][2] * e_lo.x + h_ae[8][3] * e_lo.y
                                    + h_ae[9][2] * e_hi.x
                                    + h_ae[9][3] * e_hi.y));

  // audio channel attention (linear out)
  float att[4][4];
  zero_acc<4>(att);
  layer<8, 10, 4>(att, h_ae, w + O_AUD1, lane);

  // sigma_net layer 0 as a K-split sum (== concat([enc_x, enc_w, e]) @ W)
  float h[8][4];
  init_acc<8>(h, w + O_VEYE, e0, e8, t);
  layer_staged<8>(h, tile, w + O_SIG0X, g, t, lane);
  layer<4, 4, 8>(h, att, w + O_SIG0A, lane);
  relu<8>(h);

  // sigma_net layer 1, then layer 2: sigma as a float32 dot (a quad
  // reduction over the lane's 16 columns), geo on the tensor cores
  float h2[8][4];
  zero_acc<8>(h2);
  layer<8, 8, 8>(h2, h, w + O_SIG1, lane);
  relu<8>(h2);
  float a0 = 0.0f, a8 = 0.0f;
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const float2 v = *reinterpret_cast<const float2*>(w + O_SIGMA + 8 * m
                                                      + 2 * t);
    a0 = fmaf(h2[m][0], v.x, fmaf(h2[m][1], v.y, a0));
    a8 = fmaf(h2[m][2], v.x, fmaf(h2[m][3], v.y, a8));
  }
  const float sig0 = expf(quad_sum(a0));
  const float sig8 = expf(quad_sum(a8));
  float geo[8][4];
  zero_acc<8>(geo);
  layer<8, 8, 8>(geo, h2, w + O_SIG2, lane);

  // color_net layer 0 as a K-split sum (== concat([sh, geo, ind]) @ W)
  float hc[8][4];
  init_acc<8>(hc, w + O_BIASC, 1.0f, 1.0f, t);
  layer<8, 8, 8>(hc, geo, w + O_COL0G, lane);
  {
    float a[2][4];
    sh_fragments(d0, d8, t, a);
    ktile<8>(hc, a[0], w + O_COL0S, 0, lane);
    ktile<8>(hc, a[1], w + O_COL0S, 1, lane);
  }
  relu<8>(hc);
  float rgb[1][4];
  zero_acc<1>(rgb);
  layer<8, 8, 1>(rgb, hc, w + O_COL1, lane);

  // lane t == 1 holds blue (column 2) of both rows
  const float b0 = __shfl_down_sync(0xffffffffu, rgb[0][0], 1);
  const float b8 = __shfl_down_sync(0xffffffffu, rgb[0][2], 1);
  if (t == 0) {
    float4* out4 = reinterpret_cast<float4*>(out);
    if (s0 < n)
      out4[s0] = make_float4(sig0, color(rgb[0][0]), color(rgb[0][1]),
                             color(b0));
    if (s8 < n)
      out4[s8] = make_float4(sig8, color(rgb[0][2]), color(rgb[0][3]),
                             color(b8));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
field_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
             const uint32_t* __restrict__ t_xy,
             const uint32_t* __restrict__ t_yz,
             const uint32_t* __restrict__ t_xz,
             const float* __restrict__ wpack, float* __restrict__ out,
             unsigned n, float bound) {
  extern __shared__ float4 smem4[];
  float* const w = reinterpret_cast<float*>(smem4);
  const float4* wsrc = reinterpret_cast<const float4*>(wpack);
  for (int i = threadIdx.x; i < W_TOTAL / 4; i += blockDim.x) smem4[i] = wsrc[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const tile = w + W_TOTAL + warp * kRows * kLd;
  const float nan = __int_as_float(0x7fffffff);  // looks up as zeros
  // base < n < 2^31 and step < 2^31: base + step cannot wrap
  const unsigned step = gridDim.x * kWarps * kRows;
  for (unsigned base = (blockIdx.x * kWarps + warp) * kRows; base < n;
       base += step) {
    // an offset the compiler cannot see through keeps the weight loads
    // inside the loop
    int wofs = 0;
    asm volatile("" : "+r"(wofs));
    // the 3 kRows (sample, plane) lookups, spread over the lanes; a row
    // past n looks up NaN, which gives zeros
    for (int task = lane; task < 3 * kRows; task += 32) {
      const int r = task % kRows, plane = task / kRows;  // xy, yz, xz
      const unsigned s = base + r;
      const float* p = pts + 3 * (size_t)s;
      const float x = s < n ? p[0] : nan;
      const float y = s < n ? p[1] : nan;
      const float z = s < n ? p[2] : nan;
      lookup(plane == 1 ? y : x, plane == 0 ? y : z,
             plane == 0 ? t_xy : plane == 1 ? t_yz : t_xz, bound,
             tile + r * kLd + 12 * plane);
    }
    if (lane < kRows)
      *reinterpret_cast<float4*>(tile + lane * kLd + 36) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();
    mlp_tile(tile, w + wofs, dirs, out, base, n, lane);
    __syncwarp();  // the next step's staging writes come after these reads
  }
}

// The enc_x entry: as field_kernel, with each warp's 16 rows of enc_x
// [n, 36] (16-byte aligned rows of 9 float4) copied into the staging tile
// in place of the lookups; rows past n stage zeros.
__global__ void __launch_bounds__(kThreads, 1)
field_enc_kernel(const float* __restrict__ enc_x,
                 const float* __restrict__ dirs,
                 const float* __restrict__ wpack, float* __restrict__ out,
                 unsigned n) {
  extern __shared__ float4 smem4[];
  float* const w = reinterpret_cast<float*>(smem4);
  const float4* wsrc = reinterpret_cast<const float4*>(wpack);
  for (int i = threadIdx.x; i < W_TOTAL / 4; i += blockDim.x) smem4[i] = wsrc[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const tile = w + W_TOTAL + warp * kRows * kLd;
  const float4* enc4 = reinterpret_cast<const float4*>(enc_x);
  const unsigned step = gridDim.x * kWarps * kRows;
  for (unsigned base = (blockIdx.x * kWarps + warp) * kRows; base < n;
       base += step) {
    int wofs = 0;
    asm volatile("" : "+r"(wofs));
    for (int task = lane; task < kRows * 9; task += 32) {
      const int r = task / 9, q = task % 9;
      const unsigned s = base + r;
      *reinterpret_cast<float4*>(tile + r * kLd + 4 * q) =
          s < n ? __ldg(enc4 + 9 * (size_t)s + q)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    if (lane < kRows)
      *reinterpret_cast<float4*>(tile + lane * kLd + 36) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncwarp();
    mlp_tile(tile, w + wofs, dirs, out, base, n, lane);
    __syncwarp();
  }
}

// each entry's SM count per device, 0 until its first launch there
int sm_field[64], sm_enc[64];

// The shared-memory opt-in of `kernel` and the SM count, set at its first
// launch on each device (cached in sm_count): later launches (a CUDA
// graph's capture among them) make no runtime call besides cudaGetDevice.
// Returns the device's SM count in *sms, or a CUDA status.
template <typename Kernel>
int prepare(Kernel kernel, int (&sm_count)[64], int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sm_count[dev] = count;
  }
  *sms = sm_count[dev];
  return 0;
}

int blocks_for(int n, int sms) {
  const int steps = (n + kWarps * kRows - 1) / (kWarps * kRows);
  return steps < sms ? steps : sms;
}

// What the compiled kernel takes on this device: out[0] registers per
// thread, out[1] local (spill) bytes per thread, out[2] shared memory bytes
// per block, out[3] resident warps per SM. Returns a CUDA status.
template <typename Kernel>
int kernel_info(Kernel kernel, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess)
    return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, SMEM_BYTES);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = SMEM_BYTES + (int)attr.sharedSizeBytes;
  out[3] = blocks * kWarps;
  return (int)err;
}

}  // namespace

// pts, dirs [n, 3] f32; t_xy, t_yz, t_xz [256², 58] bf16 packed tables
// (4-byte aligned); wpack [47568] f32 (pack_frame_weights); out [n, 4] f32;
// all contiguous, wpack and out 16-byte aligned, 0 <= n < 2^31 (the
// Python wrapper checks). Returns the CUDA status of the launch.
extern "C" int fused_field_launch(const void* pts, const void* dirs,
                                  const void* t_xy, const void* t_yz,
                                  const void* t_xz, const void* wpack,
                                  void* out, int n, float bound,
                                  void* stream) {
  if (n <= 0) return 0;
  int sms = 0;
  const int err = prepare(field_kernel, sm_field, &sms);
  if (err != 0) return err;
  field_kernel<<<blocks_for(n, sms), kThreads, SMEM_BYTES,
                 (cudaStream_t)stream>>>(
      static_cast<const float*>(pts), static_cast<const float*>(dirs),
      static_cast<const uint32_t*>(t_xy), static_cast<const uint32_t*>(t_yz),
      static_cast<const uint32_t*>(t_xz), static_cast<const float*>(wpack),
      static_cast<float*>(out), (unsigned)n, bound);
  return (int)cudaGetLastError();
}

// enc_x [n, 36] f32, dirs [n, 3] f32, wpack [47568] f32, out [n, 4] f32;
// all contiguous, enc_x, wpack and out 16-byte aligned, 0 <= n < 2^31 (the
// Python wrapper checks). Returns the CUDA status of the launch.
extern "C" int fused_field_enc_launch(const void* enc_x, const void* dirs,
                                      const void* wpack, void* out, int n,
                                      void* stream) {
  if (n <= 0) return 0;
  int sms = 0;
  const int err = prepare(field_enc_kernel, sm_enc, &sms);
  if (err != 0) return err;
  field_enc_kernel<<<blocks_for(n, sms), kThreads, SMEM_BYTES,
                     (cudaStream_t)stream>>>(
      static_cast<const float*>(enc_x), static_cast<const float*>(dirs),
      static_cast<const float*>(wpack), static_cast<float*>(out),
      (unsigned)n);
  return (int)cudaGetLastError();
}

// kernel_info of each entry's kernel (out: registers, spill bytes, shared
// memory bytes, warps per SM)
extern "C" int fused_field_info(int* out) {
  return kernel_info(field_kernel, out);
}
extern "C" int fused_field_enc_info(int* out) {
  return kernel_info(field_enc_kernel, out);
}
