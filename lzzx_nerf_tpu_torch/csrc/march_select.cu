// Block-march candidate select + first-S scan, hand-written for Hopper
// (sm_90a).
//
// Replaces: lzzx_nerf_tpu/ops/march_select_pallas.py::_select_kernel, the
// Pallas TPU kernel behind march_select_pallas (march variant "nb5wp").
// Same function, per ray r of 2x2-pixel block b and per candidate
// k = 2g + j of candidate group g:
//   t    = t_start[r] + k * dt                 (f32, rounded per op)
//   cell = int(clip((clip(o + t*d, -bound, bound) / bound + 1) * (H/2),
//                   0, H - 1))                  per axis, truncating
//   nb   = (clip(cx - gx[b,g], -2, 2) + 2) * 5 + clip(cy - gy[b,g], -2, 2) + 2
//   word = table[((gx*H + gy) * W32 + w0[b,g]) * 50
//                + nb * 2 + clip((cz >> 5) - w0[b,g], 0, 1)]
//   valid = bit (cz & 31) of word, t < t_end[r], k < num_cand, slot_valid[r]
// and sel[r, s] = the (s+1)-th valid k, or -1.
//
// Unlike the TPU kernel it also does the row fetch itself: the JAX path
// gathers a [Bb*G, 50] u32 row tensor first (about 290 MB at 512^2); here
// each candidate reads its one word from the table (13 MB at grid 128,
// L2-resident on the H100's 50 MB L2).
//
// What bounds it on the H100: by bytes, memory traffic, and little of it —
// the ray attributes and anchors in, S indices out, one table word per
// tested candidate (cached). In practice it is bound by instruction issue:
// the bit-exact per-candidate arithmetic is some sixty instructions (three
// rounded cells, the neighbourhood index, the word address, the bit test),
// and a warp issues them for all its lanes until its block's last ray is
// done. Fetching the words of several chunks at once, which would help a
// latency-bound scan, made it slower. The scan is data-dependent: a ray
// stops at its S-th sample, at t >= t_end or at k >= num_cand (t is
// non-decreasing in k, so no later candidate can be valid), so the work
// follows the samples the frame has.
//
// Design: one warp per 2x2 block, eight lanes per ray. The warp first
// copies the block's anchors (gx, gy, w0 for every group) into shared
// memory with coalesced loads. Then the lanes of a ray test candidates
// k = k0 + lane, a chunk of eight at a time, so a ray's table words are
// fetched eight at once rather than one after another. A ballot over the
// chunk gives each candidate its rank: the ray's count so far plus the
// valid candidates of lower lanes, cut at the chunk's first candidate that
// ends the scan (as the sequential scan stops there). Lanes whose rank is
// below S write k into the block's [4, S] output tile in shared memory,
// and the warp stores the tile, -1 where no sample, as 4*S contiguous
// words. Exactness: every product and sum is rounded separately
// (__fmul_rn / __fadd_rn, and the file is built with -fmad=false), in the
// JAX order, and the clip-clip-truncate cell quantization is kept, so the
// sample sets equal the reference bit for bit. The one shortcut: where the
// bound is a power of two (1 in the serving frame), the division by it is a
// multiplication by its reciprocal, which rounds to the same value.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // blocks of rays per thread block
constexpr int kMaxS = 32;
constexpr int kSmemLimit = 48 * 1024;

// inv_bound is 1 / bound where bound is a power of two (then pc * inv_bound
// is pc / bound exactly: both round the same real number) and 0 otherwise
__device__ __forceinline__ int cell(float p, float bound, float inv_bound,
                                    float half_h, float hmax) {
  float pc = fminf(fmaxf(p, -bound), bound);
  const float s = inv_bound != 0.0f ? __fmul_rn(pc, inv_bound)
                                    : __fdiv_rn(pc, bound);
  float v = __fmul_rn(__fadd_rn(s, 1.0f), half_h);
  v = fminf(fmaxf(v, 0.0f), hmax);
  return __float2int_rz(v);
}

__global__ void __launch_bounds__(kWarps * 32)
select_kernel(const uint32_t* __restrict__ table,
              const int32_t* __restrict__ gx, const int32_t* __restrict__ gy,
              const int32_t* __restrict__ w0,
              const float* __restrict__ rays_o, const float* __restrict__ rays_d,
              const float* __restrict__ t_start, const float* __restrict__ t_end,
              const uint8_t* __restrict__ slot_valid,
              int32_t* __restrict__ sel, int n_blocks, int G, int H,
              float bound, float inv_bound, float dt, int num_cand, int S) {
  extern __shared__ int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= n_blocks) return;  // whole warps leave; no block barrier below
  int32_t* const anc = smem + warp * (3 * G + 4 * S);  // [3][G]
  int32_t* const tile = anc + 3 * G;                    // [4][S]
  for (int i = lane; i < G; i += 32) {
    anc[i] = gx[(size_t)b * G + i];
    anc[G + i] = gy[(size_t)b * G + i];
    anc[2 * G + i] = w0[(size_t)b * G + i];
  }
  for (int i = lane; i < 4 * S; i += 32) tile[i] = -1;

  const int q = lane >> 3, sub = lane & 7;  // ray of the block, its lane
  const int r = 4 * b + q;
  const int W32 = H >> 5;
  const float half_h = 0.5f * (float)H;
  const float hmax = (float)(H - 1);
  const float ox = rays_o[3 * r], oy = rays_o[3 * r + 1], oz = rays_o[3 * r + 2];
  const float dx = rays_d[3 * r], dy = rays_d[3 * r + 1], dz = rays_d[3 * r + 2];
  const float ts = t_start[r];
  const float te = t_end[r];
  const int Kp = 2 * G;
  bool done = !slot_valid[r];  // the same in the ray's eight lanes
  int cnt = 0;
  __syncwarp();

  for (int k0 = 0; !__all_sync(0xffffffffu, done); k0 += 8) {
    const int k = k0 + sub;
    bool go = false, occ = false;
    if (!done) {
      const float t = __fadd_rn(ts, __fmul_rn((float)k, dt));
      go = k < num_cand && k < Kp && t < te;
      if (go) {
        const int g = k >> 1;
        const int ax = anc[g], ay = anc[G + g], aw = anc[2 * G + g];
        const int cx = cell(__fadd_rn(ox, __fmul_rn(t, dx)), bound,
                            inv_bound, half_h, hmax);
        const int cy = cell(__fadd_rn(oy, __fmul_rn(t, dy)), bound,
                            inv_bound, half_h, hmax);
        const int cz = cell(__fadd_rn(oz, __fmul_rn(t, dz)), bound,
                            inv_bound, half_h, hmax);
        const int nb = (min(max(cx - ax, -2), 2) + 2) * 5
                       + (min(max(cy - ay, -2), 2) + 2);
        const int widx = min(max((cz >> 5) - aw, 0), 1);
        const uint32_t word = __ldg(
            table + ((size_t)(ax * H + ay) * W32 + aw) * 50 + nb * 2 + widx);
        occ = (word >> (cz & 31)) & 1u;
      }
    }
    const unsigned stop = (__ballot_sync(0xffffffffu, !go) >> (8 * q)) & 0xffu;
    // the sequential scan ends at the chunk's first stopping candidate
    const unsigned upto = stop ? (1u << (__ffs(stop) - 1)) - 1u : 0xffu;
    const unsigned hit =
        (__ballot_sync(0xffffffffu, occ) >> (8 * q)) & upto;
    if (!done) {
      const int rank = cnt + __popc(hit & ((1u << sub) - 1u));
      if (((hit >> sub) & 1u) && rank < S) tile[q * S + rank] = k;
      cnt += __popc(hit);
      done = stop != 0 || cnt >= S;
    }
  }
  __syncwarp();
  int32_t* dst = sel + (size_t)b * 4 * S;
  for (int i = lane; i < 4 * S; i += 32) dst[i] = tile[i];
}

}  // namespace

// table [H*H*(H/32), 50] u32; gx/gy/w0 [n_rays/4, G] i32; rays_o/rays_d
// [n_rays, 3] f32; t_start/t_end [n_rays] f32; slot_valid [n_rays] bool
// (one byte); sel [n_rays, S] i32 out. n_rays is a multiple of 4. Returns
// the CUDA status of the launch.
extern "C" int march_select_launch(const void* table, const void* gx,
                                   const void* gy, const void* w0,
                                   const void* rays_o, const void* rays_d,
                                   const void* t_start, const void* t_end,
                                   const void* slot_valid, void* sel,
                                   int n_rays, int G, int H, float bound,
                                   float dt, int num_cand, int S,
                                   void* stream) {
  const int smem = kWarps * (3 * G + 4 * S) * 4;
  if (S < 1 || S > kMaxS || H % 32 != 0 || n_rays % 4 != 0 || G < 0
      || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (n_rays <= 0) return 0;
  const int n_blocks = n_rays / 4;
  int e = 0;
  const float inv_bound = frexpf(bound, &e) == 0.5f ? ldexpf(1.0f, 1 - e) : 0.0f;
  const int grid = (n_blocks + kWarps - 1) / kWarps;
  select_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(table), static_cast<const int32_t*>(gx),
      static_cast<const int32_t*>(gy), static_cast<const int32_t*>(w0),
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(t_start), static_cast<const float*>(t_end),
      static_cast<const uint8_t*>(slot_valid), static_cast<int32_t*>(sel),
      n_blocks, G, H, bound, inv_bound, dt, num_cand, S);
  return (int)cudaGetLastError();
}

// What the compiled kernel takes on this device when launched with G
// candidate groups and S samples: out[0] registers per thread, out[1]
// local (spill) bytes per thread, out[2] shared memory bytes per block,
// out[3] resident warps per SM. Returns a CUDA status.
extern "C" int march_select_info(int* out, int G, int S) {
  const int smem = kWarps * (3 * G + 4 * S) * 4;
  if (S < 1 || S > kMaxS || G < 0 || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, select_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, select_kernel,
                                                      kWarps * 32, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = smem + (int)attr.sharedSizeBytes;
  out[3] = blocks * kWarps;
  return (int)err;
}
