// Gradient on w of the fused 3x3 conv (wgrad), for Hopper (sm_90a).
//
// Replaces the w half of the XLA backward that the JAX package's custom_vjp
// wrappers of the Pallas kernel footprints_tpu/ops/pallas_conv.py:fused_conv3x3
// run (_up_bwd :221, _s2d_bwd :243, _s2d_res_bwd :265; for small outputs
// the single contraction of ops/wgrad.py:conv3x3_valid_small_co :42, _bwd :62).
// It computes
//     gw[co, ci, dy, dx] = sum over n, h, w of gz[n, h, w, co] * xpad[n, h + dy, w + dx, ci]
// from the pre-activation cotangent gz [N,Ho,Wo,Co] and x [N,H,W,Ci], both
// NHWC, with xpad read through the reflect (or, at up2_reflect, the nearest-up
// and edge) index map, never materialised; gw is OIHW [Co,Ci,3,3] in x's dtype.
//
// What bounds it: the forward's MACs on the tensor cores (3 TF32 products per
// MAC in f32, 3xTF32; 1 bf16 product in bf16) over a reduction of N x H x W
// terms (1,474,560 for the decoder's last conv at batch 12): bound by
// operations in f32, by bytes in bf16 at the decoder's shapes.  What keeps
// such a kernel far from that: bf16 operands converted to f32 for the TF32
// tensor cores (half the rate, one element at a time), x re-split at each of
// its 9 uses in f32, small channel blocks that each stage a pixel tile for
// themselves (4 times at 64 x 64 with 32 x 32 blocks, and at the up sites
// once per output phase), and every thread issuing each tile's 16-byte
// copies and their index math.
//
// What the design does about it:
//   * implicit GEMM per tap with M = output channels, N = input channels,
//     K = pixels.  A block of 8 warps (4 when Co and Ci are both <= 32) covers
//     64 x 32 or 32 x 64 (co x ci; 32 x 32) channels for all 9 taps, or all 16
//     phase taps at up2_reflect; each warp 32 co x 8 ci of every tap, so an A
//     fragment of the cotangent feeds all the taps before it is dropped.  The
//     block's 9 (16) x 2048 f32 sums stay in registers (72 or 128 a thread):
//     64 x 64 x 9 with the tile sums beside them would not fit an SM's
//     register file;
//   * each block stages each pixel tile once (32 columns by 4 rows, 2 in f32
//     at 32 output channels; at up2_reflect 1 low-res row in f32, 2 in
//     bf16), the next tile's (bf16: the next two tiles', a ring of 3) while
//     this one is summed.  The cotangent's pixels are plain boxes: thread 0
//     brings them in by TMA (a 4-d tensor map over gz; at up2_reflect one box
//     per output phase, every other output pixel of each axis, so one block
//     takes all 4 phases of a low-res tile and reads gz once), completing on
//     the buffer's mbarrier; past a ragged edge the box's zeros are what the
//     sum needs.  TMA writes each pixel's channels unpadded (boxes of up to
//     128 bytes) with the hardware swizzle, which the operand reads follow.
//     x's halo goes through the reflect (edge) index map, so it stays on
//     16-byte cp.async, staged once for all 4 phases;
//   * bf16 runs bf16 mma.sync m16n8k16 on operands read by ldmatrix.trans
//     from [pixel][channel] rows (a tap's 1-pixel shift moves whole 16-byte
//     rows of x; the cotangent's 8 consecutive pixels fall in 8 bank groups
//     through the swizzle), no conversion.  f32 runs 3xTF32 mma.sync m16n8k8
//     (TF32 wgmma cannot take these operands: it needs both K-major, and a
//     tap's shift of x along K is one 4-byte element): each landed tile is
//     split once into hi and lo planes, x's halo and the cotangent alike (one
//     conversion an element: lo = v - hi stays in f32, the tensor cores read
//     its TF32 bits), and fragments are read from them by scalar loads with
//     the fragments' k index t on pixel 2t and t + 4 on pixel 2t + 1, which
//     puts the 32 lanes on 32 distinct banks through the cotangent's swizzle
//     and x's 4-word pad;
//   * the reduction is split over blocks by a fixed, shape-only schedule: a
//     grid of about one block per SM (132, or 264 of the 4-warp blocks), each
//     summing a fixed run of consecutive tiles.  The tensor cores' f32
//     accumulation truncates, so each tile's sums start from zero in the MMA
//     accumulators and are then added, rounded to nearest, into the block's
//     f32 sums; each block writes its [taps][Ci][Co] partial into scratch the
//     wrapper allocates.  The second kernel sums the partials in block order
//     (at up2_reflect folding the phase taps back to 3x3) and writes gw.  No
//     atomics: the same bits every run;
//   * paths chosen by shape, never by failure: x by cp.async when Ci is a
//     multiple of 16 bytes and x 16-byte aligned, the cotangent by TMA when
//     Co is and gz is, else each by plain loads into the same layout;
//   * ragged H, W, Ci, Co are masked: no divisibility rule.
//
// Plain C interface (no PyTorch headers) for ctypes; see ops/build.py.

#include "fused_conv3x3_common.cuh"

namespace {

constexpr int WTC = 32;          // tile columns
constexpr int WHC = WTC + 2;     // x halo columns

template <typename T, int MODE, int COT, int CIT>
struct Wg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int WARPS = COT * CIT / 256;           // each 32 co x 8 ci
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MG = COT / 32;                      // warps along co
  // tile rows (low-res rows at up2_reflect): as many as the shared memory
  // holds (f32 keeps three planes of a tile, bf16 a ring of three tiles),
  // and in f32 at 32 x 64 and 32 x 32 few enough for two blocks an SM
  static constexpr int TR = MODE == kReflect ? (kF32 && COT == 32 ? 2 : 4) : (kF32 ? 1 : 2);
  static constexpr int TP = TR * WTC;                      // tile pixels (low-res at up2)
  static constexpr int HPIX = (TR + 2) * WHC;              // x halo pixels
  static constexpr int PH = MODE == kReflect ? 1 : 4;      // output phases a tile holds
  static constexpr int BT = MODE == kReflect ? 9 : 4;      // taps per phase
  static constexpr int TAPS = PH * BT;
  // smem elements per x pixel: bf16's ldmatrix rows need 16 bytes of pad,
  // f32's scalar loads of pixel pairs (2 t, 2 t + 1) 4 words
  static constexpr int SX = CIT + (kF32 ? 4 : 8);
  // the cotangent as TMA writes it: per phase, boxes of GCH channels (GB
  // bytes: a swizzle row of up to 128) over the tile's TP pixels
  static constexpr int GB = COT * (int)sizeof(T) < 128 ? COT * (int)sizeof(T) : 128;
  static constexpr int GCH = GB / (int)sizeof(T);          // channels a box
  static constexpr int GH = COT / GCH;                     // boxes across the channels
  static constexpr int G_BYTES = PH * GH * TP * GB;        // a multiple of 1024
  static constexpr int X_BYTES = HPIX * SX * (int)sizeof(T);
  static constexpr int BUF = (int)align1024(G_BYTES + X_BYTES);  // bytes a tile buffer
  static constexpr int KSTEP = kF32 ? 8 : 16;
  // blocks the reduction is split into over all (co, ci) tiles: about one
  // per SM of an H100 (132); a constant, so that the order of the sums, and
  // the result's bits, depend on the shapes only
  static constexpr int TARGET_BLOCKS = 132 * 8 / WARPS;
  // f32: the landing buffer, then the hi and lo planes; bf16: a ring of
  // three; their mbarriers; past up to 1023 bytes that align the base
  static constexpr size_t smem() { return 1024 + 3 * (size_t)BUF + 3 * 8; }
  // offset in a buffer of channel c of cotangent pixel k of phase ph: TMA's
  // swizzled image
  static __device__ __forceinline__ uint32_t goff(int ph, int k, int c) {
    return swizzled<GB>(static_cast<uint32_t>(((ph * GH + c / GCH) * TP + k) * GB +
                                              (c % GCH) * (int)sizeof(T)));
  }
};

struct Tiling {
  int tiles;      // pixel tiles of the whole batch
  int per_block;  // tiles a block sums
  int blocks;     // partial sums per (co, ci) tile
};

template <typename T, int MODE, int COT, int CIT>
Tiling wgrad_tiling(int N, int H, int W, int Ci, int Co) {
  using G = Wg<T, MODE, COT, CIT>;
  const int tiles = N * ((H + G::TR - 1) / G::TR) * ((W + WTC - 1) / WTC);
  const int others = ((Co + COT - 1) / COT) * ((Ci + CIT - 1) / CIT);
  int blocks = (G::TARGET_BLOCKS + others - 1) / others;
  blocks = blocks < tiles ? blocks : tiles;
  const int per_block = blocks > 0 ? (tiles + blocks - 1) / blocks : 1;
  blocks = (tiles + per_block - 1) / per_block;
  return {tiles, per_block, blocks > 0 ? blocks : 1};
}

template <typename T, int MODE, int COT, int CIT>
__global__ void __launch_bounds__(Wg<T, MODE, COT, CIT>::THREADS, 1)
fused_conv3x3_wgrad_partial_kernel(const T* __restrict__ gz, const T* __restrict__ x,
                                   float* __restrict__ partial, int H, int W, int Ci, int Co,
                                   int tiles, int per_block, bool vec_x,
                                   const __grid_constant__ CUtensorMap gz_map, bool tma) {
  using G = Wg<T, MODE, COT, CIT>;
  constexpr bool kF32 = G::kF32;
  constexpr int GE = 16 / sizeof(T);  // channels per 16-byte group

  extern __shared__ __align__(128) uint8_t smem_raw[];
  // per buffer (1024-aligned): the cotangent's image [G_BYTES], then x's halo
  // [HPIX][SX] in x's dtype
  uint8_t* s_buf = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_buf + 3 * G::BUF);  // one a buffer

  Probe probe;
  PROBE_BEGIN(probe);
  const int Ho = MODE == kReflect ? H : 2 * H;
  const int Wo = MODE == kReflect ? W : 2 * W;
  const int co_tile = blockIdx.y * COT;
  const int ci_tile = blockIdx.z * CIT;
  const int tiles_x = (W + WTC - 1) / WTC;
  const int tiles_img = tiles_x * ((H + G::TR - 1) / G::TR);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int co_w = (warp % G::MG) * 32;  // this warp's 32 output channels
  const int ci_w = (warp / G::MG) * 8;   // and 8 input channels

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&s_bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // One tile into buffer `b`: x's halo through the index map, by 16-byte
  // cp.async groups where the channel count and address allow, else by
  // plain loads (one commit group); and the cotangent of all PH phases
  // (zero past a ragged edge, so those pixels add nothing): by TMA (thread
  // 0, completing on the buffer's mbarrier) or by plain loads.
  auto stage = [&](int tile, int b) {
    const int n = tile / tiles_img, rem = tile - n * tiles_img;
    const int y0 = (rem / tiles_x) * G::TR, x0 = (rem % tiles_x) * WTC;
    uint8_t* dst = s_buf + b * G::BUF;
    T* s_x = reinterpret_cast<T*>(dst + G::G_BYTES);
    const T* xn = x + (size_t)n * H * W * Ci;
    const T* gn = gz + (size_t)n * Ho * Wo * Co;
    if (vec_x) {  // Ci % GE == 0 and x 16-byte aligned: whole groups in or out
      constexpr int GR = CIT / GE;
      for (int i = tid; i < G::HPIX * GR; i += G::THREADS) {
        const int p = i / GR, c = (i % GR) * GE;
        const int sy = source_index<MODE>(y0 - 1 + p / WHC, H);
        const int sx = source_index<MODE>(x0 - 1 + p % WHC, W);
        const bool in = ci_tile + c < Ci;
        cp_async16(s_x + p * G::SX + c, in ? xn + ((size_t)sy * W + sx) * Ci + ci_tile + c : xn,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < G::HPIX * CIT; i += G::THREADS) {
        const int p = i / CIT, c = i % CIT;
        const int sy = source_index<MODE>(y0 - 1 + p / WHC, H);
        const int sx = source_index<MODE>(x0 - 1 + p % WHC, W);
        s_x[p * G::SX + c] = ci_tile + c < Ci ? xn[((size_t)sy * W + sx) * Ci + ci_tile + c]
                                              : from_float<T>(0.f);
      }
    }
    cp_async_commit();
    // the cotangent, each pixel at its phase's slot [phase][low-res pixel]
    constexpr int F = MODE == kReflect ? 1 : 2;
    if (tma) {  // plain boxes: one per phase and GCH channels
      if (tid == 0) {
        mbar_arrive_expect_tx(&s_bar[b], G::G_BYTES);
#pragma unroll
        for (int ph = 0; ph < G::PH; ++ph)
#pragma unroll
          for (int h = 0; h < G::GH; ++h)
            tma_load_4d(dst + (ph * G::GH + h) * G::TP * G::GB, &gz_map, co_tile + h * G::GCH,
                        F * x0 + (ph & 1), F * y0 + (ph >> 1), n, &s_bar[b]);
      }
    } else {  // in output order: contiguous rows of output pixels
      constexpr int OC = F * WTC;  // output columns of the tile
      for (int i = tid; i < F * G::TR * OC * COT; i += G::THREADS) {
        const int p = i / COT, c = i % COT;
        const int orow = p / OC, ocol = p % OC;
        const int oy = F * y0 + orow, ox = F * x0 + ocol;
        const int phase = MODE == kReflect ? 0 : (orow & 1) * 2 + (ocol & 1);
        *reinterpret_cast<T*>(dst + G::goff(phase, (orow / F) * WTC + ocol / F, c)) =
            oy < Ho && ox < Wo && co_tile + c < Co
                ? gn[((size_t)oy * Wo + ox) * Co + co_tile + c]
                : from_float<T>(0.f);
      }
    }
  };

  float sum[G::TAPS][2][4];
#pragma unroll
  for (int k = 0; k < G::TAPS; ++k)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) sum[k][f][q] = 0.f;

  // The tile's sums, phase by phase: acc[tap][f] = D[co][ci] of the warp's
  // m16 fragment f and its n8 fragment, restarted from zero per phase, then
  // added into sum.  f32 reads the hi and lo planes h and l; bf16 the buffer h.
  // This lane's cotangent operand offsets at phase 0, k-step 0: a k-step
  // (and a phase) moves them by whole 1024-byte swizzle periods, so the
  // swizzle is applied once here.  f32: the fragment's a0..a3 (k index t on
  // pixel 2t, t + 4 on pixel 2t + 1); bf16: the ldmatrix.trans row of
  // matrix q (pixels (q >> 1) * 8.., channels (q & 1) * 8..), per m16 half f.
  static_assert(G::KSTEP * G::GB % 1024 == 0, "a k-step moves whole swizzle periods");
  uint32_t a_off[2][4];
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    if constexpr (kF32) {
      const int c = co_w + f * 16 + g;
      a_off[f][0] = G::goff(0, 2 * t4, c);
      a_off[f][1] = G::goff(0, 2 * t4, c + 8);
      a_off[f][2] = G::goff(0, 2 * t4 + 1, c);
      a_off[f][3] = G::goff(0, 2 * t4 + 1, c + 8);
    } else {
      const int q = lane >> 3;
      a_off[f][0] = G::goff(0, (q >> 1) * 8 + (lane & 7), co_w + f * 16 + (q & 1) * 8);
    }
  }

  auto sum_tile = [&](const uint8_t* h, const uint8_t* l) {
    const T* hx = reinterpret_cast<const T*>(h + G::G_BYTES);  // x's halo (hi in f32)
    // f32: x's lo plane, both x planes as words
    const float* fhx = reinterpret_cast<const float*>(hx);
    const float* flx = reinterpret_cast<const float*>(l + G::G_BYTES);
#pragma unroll
    for (int ph = 0; ph < G::PH; ++ph) {
      const int pa = ph >> 1, pb = ph & 1;
      float acc[G::BT][2][4];
#pragma unroll
      for (int k = 0; k < G::BT; ++k)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[k][f][q] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < G::TP; k0 += G::KSTEP) {
        const int r = k0 / WTC, c0 = k0 % WTC;
        const uint32_t step = (ph * G::GH * G::TP + k0) * G::GB;  // whole swizzle periods
        if constexpr (kF32) {
          // k index t of the m16n8k8 fragments is pixel k0 + 2t, index t + 4
          // pixel k0 + 2t + 1 (the sum over k is order-free): the 32 lanes'
          // loads then hit 32 distinct banks through the cotangent's swizzle
          // and x's 4-word pad.  A[m = co][k]: a0 (co g, k t), a1 (g + 8, t),
          // a2 (g, t + 4), a3 (g + 8, t + 4)
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              ah[f][j] = *reinterpret_cast<const uint32_t*>(h + step + a_off[f][j]);
              al[f][j] = *reinterpret_cast<const uint32_t*>(l + step + a_off[f][j]);
            }
#pragma unroll
          for (int k = 0; k < G::BT; ++k) {
            // the tap's shift into the halo (reflect: dy, dx; up2: pa + ty, pb + tx)
            const int oy = MODE == kReflect ? k / 3 : pa + (k >> 1);
            const int ox = MODE == kReflect ? k % 3 : pb + (k & 1);
            // B[k = pixel 2t, 2t + 1][n = channel g]
            const int bp = ((r + oy) * WHC + c0 + ox + 2 * t4) * G::SX + ci_w + g;
            const int bq = bp + G::SX;
            const uint32_t bh0 = __float_as_uint(fhx[bp]), bh1 = __float_as_uint(fhx[bq]);
            const uint32_t bl0 = __float_as_uint(flx[bp]), bl1 = __float_as_uint(flx[bq]);
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              mma_tf32(acc[k][f], al[f], bh0, bh1);
              mma_tf32(acc[k][f], ah[f], bl0, bl1);
              mma_tf32(acc[k][f], ah[f], bh0, bh1);
            }
          }
        } else {
          // A by ldmatrix.trans from [pixel][co] rows: matrix q covers pixels
          // k0 + (q >> 1) * 8.., channels (q & 1) * 8.. of the fragment
          const int q = lane >> 3, rr = lane & 7;
          uint32_t a[2][4];
#pragma unroll
          for (int f = 0; f < 2; ++f) ldmatrix_x4_trans(smem_u32(h) + step + a_off[f][0], a[f]);
#pragma unroll
          for (int k = 0; k < G::BT; ++k) {
            const int oy = MODE == kReflect ? k / 3 : pa + (k >> 1);
            const int ox = MODE == kReflect ? k % 3 : pb + (k & 1);
            // B by ldmatrix.trans from x's [pixel][ci] rows, pixels k0 + (q & 1) * 8..
            const int bpx = (r + oy) * WHC + c0 + ox + (q & 1) * 8 + rr;
            uint32_t b0, b1;
            ldmatrix_x2_trans(smem_u32(hx + bpx * G::SX + ci_w), b0, b1);
#pragma unroll
            for (int f = 0; f < 2; ++f) mma_bf16(acc[k][f], a[f], b0, b1);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < G::BT; ++k)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int q = 0; q < 4; ++q) sum[ph * G::BT + k][f][q] += acc[k][f][q];
    }
  };

  const int first = blockIdx.x * per_block;
  const int count = max(0, min(first + per_block, tiles) - first);
  if constexpr (kF32) {
    uint8_t* s_r = s_buf;                // the landing buffer
    uint8_t* s_h = s_buf + G::BUF;       // hi
    uint8_t* s_l = s_buf + 2 * G::BUF;   // lo
    if (count > 0) stage(first, 0);
    for (int it = 0; it < count; ++it) {
      cp_async_wait_all();
      if (tma) mbar_wait(&s_bar[0], it & 1);
      __syncthreads();  // this tile has landed; every warp is done with the last one's planes
      PROBE_MARK(probe, wait);
      // split once, 16 bytes at a time (element-wise: the images stay as they are)
#pragma unroll 4
      for (int i = tid; i < G::BUF / 16; i += G::THREADS) {
        uint4 r = reinterpret_cast<const uint4*>(s_r)[i], h, l;
        split_tf32_landed(__uint_as_float(r.x), h.x, l.x);
        split_tf32_landed(__uint_as_float(r.y), h.y, l.y);
        split_tf32_landed(__uint_as_float(r.z), h.z, l.z);
        split_tf32_landed(__uint_as_float(r.w), h.w, l.w);
        reinterpret_cast<uint4*>(s_h)[i] = h;
        reinterpret_cast<uint4*>(s_l)[i] = l;
      }
      fence_proxy_async();  // the landing buffer's reads before the next TMA into it
      PROBE_MARK(probe, stage);
      __syncthreads();  // the planes are complete; the landing buffer is free
      PROBE_MARK(probe, wait);
      if (it + 1 < count) stage(first + it + 1, 0);
      PROBE_MARK(probe, stage);
      sum_tile(s_h, s_l);
      PROBE_MARK(probe, mma);
    }
  } else {
    // a ring of 3 buffers: the next two tiles load while this one is summed
    for (int j = 0; j < 2; ++j)
      if (j < count) stage(first + j, j);
    for (int it = 0; it < count; ++it) {
      if (it + 1 < count) cp_async_wait<1>(); else cp_async_wait<0>();
      if (tma) mbar_wait(&s_bar[it % 3], (it / 3) & 1);
      fence_proxy_async();  // the last tile's reads before the TMA into its buffer
      // this tile's buffer is complete for every thread, and every warp is
      // done with the buffer of tile it - 1, which tile it + 2 fills
      __syncthreads();
      PROBE_MARK(probe, wait);
      if (it + 2 < count) stage(first + it + 2, (it + 2) % 3);
      PROBE_MARK(probe, stage);
      const uint8_t* b = s_buf + (it % 3) * G::BUF;
      sum_tile(b, b);
      PROBE_MARK(probe, mma);
    }
  }

  // this block's partial [tap][ci][co]: D[m = co][n = ci] of each fragment
#pragma unroll
  for (int k = 0; k < G::TAPS; ++k)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int co = co_tile + co_w + f * 16 + g + (q >= 2 ? 8 : 0);
        const int ci = ci_tile + ci_w + 2 * t4 + (q & 1);
        if (co < Co && ci < Ci)
          partial[(((size_t)blockIdx.x * G::TAPS + k) * Ci + ci) * Co + co] = sum[k][f][q];
      }
  PROBE_MARK(probe, epi);
  PROBE_END(probe, (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
}

// Whether 3x3 row (column) d was summed into phase-tap row t of phase a
// (up2_phase_weights: phase 0 = (w0, w1 + w2), phase 1 = (w0 + w1, w2)).
__device__ __forceinline__ bool covers(int a, int t, int d) {
  return a == 0 ? (t == 0 ? d == 0 : d >= 1) : (t == 0 ? d <= 1 : d == 2);
}

// The second pass: gw[co][ci][dy][dx] = the partials summed in block order
// (at up2_reflect per phase tap, then those of the tap's phase taps added).
template <typename T, int MODE>
__global__ void fused_conv3x3_wgrad_reduce_kernel(const float* __restrict__ partial,
                                                  T* __restrict__ gw, int blocks, int Ci,
                                                  int Co) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // (k * Ci + ci) * Co + co
  if (idx >= 9 * Ci * Co) return;
  const int co = idx % Co, ci = (idx / Co) % Ci, k = idx / (Co * Ci);
  const size_t slice = (size_t)Ci * Co;
  const size_t stride = taps_of<MODE>() * slice;  // between blocks' partials
  const float* p = partial + (size_t)ci * Co + co;
  auto sum_blocks = [&](int tap) {
    float s = 0.f;
#pragma unroll 8
    for (int b = 0; b < blocks; ++b) s += p[b * stride + tap * slice];
    return s;
  };
  float s = 0.f;
  if constexpr (MODE == kReflect) {
    s = sum_blocks(k);
  } else {
    const int dy = k / 3, dx = k % 3;
    for (int a = 0; a < 2; ++a)
      for (int ty = 0; ty < 2; ++ty) {
        if (!covers(a, ty, dy)) continue;
        for (int b = 0; b < 2; ++b)
          for (int tx = 0; tx < 2; ++tx)
            if (covers(b, tx, dx)) s += sum_blocks(((a * 2 + b) * 2 + ty) * 2 + tx);
      }
  }
  gw[((size_t)co * Ci + ci) * 9 + k] = from_float<T>(s);
}

template <typename T, int MODE, int COT, int CIT>
struct Launch {
  static long long scratch(int N, int H, int W, int Ci, int Co) {
    return (long long)wgrad_tiling<T, MODE, COT, CIT>(N, H, W, Ci, Co).blocks *
           taps_of<MODE>() * Ci * Co;
  }
  // the partial kernel's blocks
  static long long grid(int N, int H, int W, int Ci, int Co) {
    return (long long)wgrad_tiling<T, MODE, COT, CIT>(N, H, W, Ci, Co).blocks *
           ((Co + COT - 1) / COT) * ((Ci + CIT - 1) / CIT);
  }
  static int run(const void* gz, const void* x, float* partial, long long capacity, void* gw,
                 int N, int H, int W, int Ci, int Co, cudaStream_t stream) {
    using G = Wg<T, MODE, COT, CIT>;
    const Tiling tl = wgrad_tiling<T, MODE, COT, CIT>(N, H, W, Ci, Co);
    if ((long long)tl.blocks * G::TAPS * Ci * Co > capacity)
      return static_cast<int>(cudaErrorInvalidValue);
    constexpr size_t smem = G::smem();
    auto kernel = fused_conv3x3_wgrad_partial_kernel<T, MODE, COT, CIT>;
    static std::atomic<uint64_t> smem_set{0};
    if (const int err = smem_limit_once(kernel, smem, smem_set)) return err;
    constexpr int GE = 16 / sizeof(T);  // channels per 16-byte cp.async group
    const bool vec_x = Ci % GE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    // the cotangent by TMA when its rows are whole 16-byte groups and gz is
    // 16-byte aligned, else by plain loads
    const bool tma = Co % GE == 0 && reinterpret_cast<uintptr_t>(gz) % 16 == 0;
    CUtensorMap map{};
    if (tma) {
      const uint32_t step = MODE == kReflect ? 1 : 2;  // up2: one output phase a box
      const uint32_t box[4] = {G::GCH, step * WTC, step * G::TR, 1};
      if (const int err = nhwc_tensor_map<T, G::GB>(&map, gz, N, MODE == kReflect ? H : 2 * H,
                                                    MODE == kReflect ? W : 2 * W, Co, box, step))
        return err;
    }
    const dim3 grid(tl.blocks, (Co + COT - 1) / COT, (Ci + CIT - 1) / CIT);
    kernel<<<grid, G::THREADS, smem, stream>>>(static_cast<const T*>(gz),
                                               static_cast<const T*>(x), partial, H, W, Ci, Co,
                                               tl.tiles, tl.per_block, vec_x, map, tma);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int outputs = 9 * Ci * Co;
    fused_conv3x3_wgrad_reduce_kernel<T, MODE><<<(outputs + 255) / 256, 256, 0, stream>>>(
        partial, static_cast<T*>(gw), tl.blocks, Ci, Co);
    return static_cast<int>(cudaGetLastError());
  }
};

// fn(Launch<T, MODE, COT, CIT>{}).  The probe's build instantiates only the
// tiles its sites run (reflect at 64 x 64 channels: 64 x 32; up2_reflect at
// 32 x 64: 32 x 64); the others return -1 there.
template <typename T, int MODE, int COT, int CIT, typename Fn>
auto call_built(Fn fn) -> decltype(fn(Launch<T, MODE, COT, CIT>{})) {
#ifdef FOOTPRINTS_PROBE
  if constexpr (MODE == kReflect ? COT != 64 : CIT != 64) return -1;
  else
#endif
    return fn(Launch<T, MODE, COT, CIT>{});
}

// The block's channel tile by shape: 32 output channels when Co <= 32 (with
// 64 input channels when Ci > 32), else 64 x 32.
template <typename T, int MODE, typename Fn>
auto by_tile(int Ci, int Co, Fn fn) {
  if (Co <= 32)
    return Ci > 32 ? call_built<T, MODE, 32, 64>(fn) : call_built<T, MODE, 32, 32>(fn);
  return call_built<T, MODE, 64, 32>(fn);
}
template <typename Fn>
auto by_kind(int dtype, int pad_mode, int Ci, int Co, Fn fn) {
  if (dtype == 0)
    return pad_mode == kReflect ? by_tile<float, kReflect>(Ci, Co, fn)
                                : by_tile<float, kUp2Reflect>(Ci, Co, fn);
  return pad_mode == kReflect ? by_tile<__nv_bfloat16, kReflect>(Ci, Co, fn)
                              : by_tile<__nv_bfloat16, kUp2Reflect>(Ci, Co, fn);
}

bool valid_kind(int dtype, int pad_mode) {
  return (dtype == 0 || dtype == 1) && (pad_mode == kReflect || pad_mode == kUp2Reflect);
}

}  // namespace

// The f32 scratch (elements) fused_conv3x3_wgrad_launch needs for these
// shapes (dtype 0 = float32, 1 = bfloat16): one [taps][Ci][Co] partial per
// block of the split reduction; -1 for an invalid dtype or mode.
extern "C" long long fused_conv3x3_wgrad_scratch(int dtype, int N, int H, int W, int Ci, int Co,
                                                 int pad_mode) {
  if (!valid_kind(dtype, pad_mode)) return -1;
  return by_kind(dtype, pad_mode, Ci, Co,
                 [&](auto l) { return decltype(l)::scratch(N, H, W, Ci, Co); });
}

// dtype: 0 = float32, 1 = bfloat16.  pad_mode: 0 = reflect, 1 = up2_reflect.
// gz is NHWC [N,Ho,Wo,Co] (Ho x Wo = H x W at reflect, 2H x 2W at
// up2_reflect), x NHWC [N,H,W,Ci], both contiguous; partial is f32 scratch
// of `capacity` elements (at least fused_conv3x3_wgrad_scratch's); gw is a
// contiguous OIHW [Co,Ci,3,3], every element written.  Two launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int fused_conv3x3_wgrad_launch(int dtype, const void* gz, const void* x,
                                          void* partial, long long capacity, void* gw, int N,
                                          int H, int W, int Ci, int Ho, int Wo, int Co,
                                          int pad_mode, void* stream) {
  if (!valid_kind(dtype, pad_mode)) return static_cast<int>(cudaErrorInvalidValue);
  const int f = pad_mode == kReflect ? 1 : 2;
  if (Ho != f * H || Wo != f * W || (pad_mode == kReflect && (H < 2 || W < 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)Ci * Co == 0) return 0;
  float* p = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_kind(dtype, pad_mode, Ci, Co, [&](auto l) {
    return decltype(l)::run(gz, x, p, capacity, gw, N, H, W, Ci, Co, s);
  });
}

#ifdef FOOTPRINTS_PROBE
// The probe build: the partial kernel's blocks for these shapes (-1 for an
// invalid dtype or mode).
extern "C" long long fused_conv3x3_wgrad_probe_blocks(int dtype, int N, int H, int W, int Ci,
                                                      int Co, int pad_mode) {
  if (!valid_kind(dtype, pad_mode)) return -1;
  return by_kind(dtype, pad_mode, Ci, Co,
                 [&](auto l) { return decltype(l)::grid(N, H, W, Ci, Co); });
}

// The probe build: where the partial kernel's blocks write their stamps
// (PROBE_FIELDS 64-bit words each, in block order, the first `blocks`
// blocks), or null for none.
extern "C" int fused_conv3x3_wgrad_probe_set(void* buf, long long blocks) {
  return probe_set(buf, blocks);
}
#endif
