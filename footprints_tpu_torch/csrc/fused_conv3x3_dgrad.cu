// Gradient on x of the fused 3x3 conv (dgrad), for Hopper (sm_90a).
//
// Replaces the x half of the XLA backward that the JAX package's custom_vjp
// wrappers of the Pallas kernel footprints_tpu/ops/pallas_conv.py:fused_conv3x3
// run (_up_bwd :221, _s2d_bwd :243, _s2d_res_bwd :265): at reflect the VALID
// conv plus edge strips of ops/s2d.py:_s2d_reflect_conv_bwd :320 /
// _dxp_presliced :283, at the up sites the phase form of
// ops/s2d.py:_edge_conv_phase_bwd :354.  It computes
//     gx = (pad o [nearest_up2])^T ( conv3x3^T(gz, w) )
// straight into x's NHWC layout [N,H,W,Ci] from the pre-activation cotangent
// gz [N,Ho,Wo,Co]; no padded or upsampled gradient is materialised.
//
// What bounds it: the forward's MACs (9 taps x Co per x pixel at reflect, 16
// phase taps x Co per low-res pixel at up2_reflect) on the tensor cores, 3 TF32
// products per MAC in f32 (3xTF32) and 1 bf16 product in bf16: bound by
// operations in f32, by bytes in bf16 at the decoder's shapes.  What keeps
// such a kernel far from that: weights staged and folded by every block,
// synchronously; the cotangent re-split at each of its 9 (16) uses in f32;
// a cotangent tile staged once per slice of input channels; every thread
// issuing 16-byte copies and their index math for each stage; and mma.sync,
// which is not the tensor cores' full-rate path.
//
// What the design does about it:
//   * a pre-pack kernel (fused_conv3x3_dgrad_pack_kernel) runs once per call
//     before the main kernel: it transposes w to B[k = co][n = ci] per tap,
//     folds the 16 phase taps at up2_reflect (fold_taps), splits hi and lo in
//     f32, and writes each stage's B tiles in wgmma's shared-memory image into
//     scratch.  The image needs no swizzle: B is laid out as 8-row x 16-byte
//     core matrices, each one contiguous 128-byte line, which the tensor
//     cores read without bank conflicts (the no-swizzle K-major descriptor);
//   * the main kernel, 2 warpgroups a block, is persistent: one block an SM
//     in f32 at N = 64 (its ring fills 208 KB of shared memory), two
//     otherwise, each walking a fixed set of tiles (every gridDim-th), so
//     that one tile's epilogue and the next tile's first loads overlap.  A
//     tile is 16 rows x 16 columns of x pixels (low-res pixels at
//     up2_reflect: as deep as reflect's) and all of up to 64 input channels
//     (N = 32 or 64, masked past Ci).  Its K loop runs over stages: one
//     cotangent plane (4 at up2_reflect, one per output phase) times one
//     chunk of Co (16 channels; 8 in f32 at N = 32).  Each stage's B tiles
//     come in by one bulk async copy (cp.async.bulk) and its cotangent halo
//     by one TMA box (4-d tensor map over gz; at up2_reflect every other
//     output pixel of each axis, one phase), both completing on the mbarrier
//     of a ring slot (2 slots in f32, 3 in bf16), 1 or 2 stages ahead: thread
//     0 issues two instructions a stage.  The box's out-of-range pixels and
//     channels land as zeros, which is the transposed conv's zero padding and
//     the ragged edges' mask, so border tiles need no other path.  TMA writes
//     a halo pixel's 32 or 64 bytes unpadded, with the hardware swizzle of
//     rows that size (16-byte chunks XORed by the 128-byte line's index), and
//     each lane's ldmatrix address follows the same swizzle: 8 consecutive
//     pixels at one k column land in 8 distinct bank groups, as the padded
//     rows of a cp.async layout did.  Each cotangent element is staged once
//     per tile for all of Ci, and in f32 split once into hi and lo planes
//     when it lands (element-wise, so the swizzled image is kept);
//   * the products are wgmma m64nNk8 (tf32: lo.hi, hi.lo, hi.hi) and m64nNk16
//     (bf16), B from the packed tile's descriptor, A from registers: each
//     warp's 16 pixels of one tile row, loaded by ldmatrix with one row
//     address per lane (the next step's A is loaded into a second register
//     set while this step's wgmmas run), so a lane may read any halo pixel
//     or a zero row:
//       - reflect: pixel a reads cotangent row a + 1 - dy for weight row dy
//         (the zero-padded transposed conv).  The reflect pad copied x row 1
//         to padded row -1 and row H-2 to padded row H, so x row 1 also reads
//         cotangent row 0 through weight row 0, and row H-2 reads row H-1
//         through weight row 2; the same for the columns, and both at the 4
//         corners.  These folds run as extra wgmmas only in tiles that hold a
//         border row or column, under block-uniform conditions (a wgmma in a
//         branch the compiler cannot prove uniform serialises them all),
//         each lane masked to a zero row unless its pixel folds;
//       - up2_reflect, the phase form: output phase (pa, pb) is a 2x2 conv of
//         the edge-padded low-res input with phase-summed weights, so low-res
//         pixel s gathers phase (pa, pb)'s cotangent at low-res row
//         s + 1 - pa - ty, column s + 1 - pb - tx, through its 2x2 weights: 16
//         (phase, tap) pairs per low-res pixel.  The edge pad's adjoint folds
//         low-res row -1 onto row 0 (phase 0, tap 0) and row Hi onto row Hi-1
//         (phase 1, tap 1), as extra wgmmas like reflect's;
//   * paths chosen by shape, never by failure: the cotangent halo comes in by
//     TMA when Co is a multiple of 16 bytes and gz is 16-byte aligned (a
//     tensor map's rule), else by plain loads into the same swizzled image;
//     gx is stored 4 channels at once when Ci is a multiple of 4 and gx
//     aligned, else one by one; N = 32 when Ci <= 32, else 64 (a grid row
//     per 64 input channels past 64);
//   * each block owns its outputs and sums them in a fixed order: no atomics,
//     the same bits every run.  Ragged H, W, Ci, Co are masked: no
//     divisibility rule; w may be an input-channel slice view (read through
//     its output-channel stride by the pre-pack).
//
// Plain C interface (no PyTorch headers) for ctypes; see ops/build.py.

#include "fused_conv3x3_common.cuh"

namespace {

constexpr int DG_WARPS = 8;  // 2 warpgroups
constexpr int DG_THREADS = 32 * DG_WARPS;

template <typename T, int MODE, int NP>
struct Dg {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int R = 16;                               // tile rows (M space)
  static constexpr int WR = R / DG_WARPS;                    // rows per warp
  static constexpr int KSTEP = kF32 ? 8 : 16;                // K of one wgmma
  // k-steps per stage: 2 in f32 at N = 64 (one block an SM), else 1
  static constexpr int KSTEPS = kF32 && NP == 64 ? 2 : 1;
  static constexpr int CK = KSTEP * KSTEPS;                  // output channels per stage
  static constexpr int NSTEP = (MODE == kReflect ? 9 : 4) * KSTEPS;  // (tap, k-step) a stage
  // blocks per SM: f32 at N = 64 fills the shared memory with one (208 KB
  // at reflect); the others run two, so one block's staging overlaps the
  // other's products
  static constexpr int MIN_BLOCKS = kF32 && NP == 64 ? 1 : 2;
  // the ring's slots of halo and B: stages in flight (bf16: 3, f32: 2)
  static constexpr int RING = kF32 ? 2 : 3;
  static constexpr int RB = CK * (int)sizeof(T);             // bytes of a halo pixel: 32 or 64
  static constexpr int PLANES = MODE == kReflect ? 1 : 4;    // cotangent planes
  static constexpr int TP = MODE == kReflect ? 9 : 4;        // taps per plane
  static constexpr int PLANE_PIX = (R + 2) * HC;             // halo pixels per plane
  static constexpr int KB = CK * (int)sizeof(T) / 16;        // 16-byte k blocks a B row
  static constexpr int BPLANES = kF32 ? 2 : 1;               // hi, lo
  static constexpr int B_TAP = NP * CK * (int)sizeof(T);     // bytes of one tap's B tile
  static constexpr int B_STAGE = BPLANES * TP * B_TAP;       // bytes of one stage's B
  static constexpr int HBOX = PLANE_PIX * RB;                // bytes of one halo box
  static constexpr int H_BYTES = (int)align1024(HBOX);       // one halo buffer
  static constexpr int ACC = NP / 2;                         // accumulators per m64 row set
  // f32 sums each stage on the tensor cores from zero, then adds it to the
  // tile's sums in f32, rounded to nearest, as the forward does: the tensor
  // cores' adds truncate, and one accumulator through a whole tile drifted
  // toward zero by 1.7e-6 (the tail's conv2) to 1.2e-5 (block2's up half)
  // of the sum; summed a stage at a time, under 0.9e-6 (H100, batch 4)
  static constexpr bool STAGE_SUMS = kF32;
  // the ring (B, then halo buffers), the f32 lo plane, a zero row and the
  // mbarriers, past up to 1023 bytes that align the base to 1024
  static constexpr size_t smem() {
    return 1024 + RING * ((size_t)B_STAGE + H_BYTES) + (kF32 ? H_BYTES : 0) + 16 + 8 * RING;
  }
  // offset of byte `col` of halo pixel p in a halo buffer: TMA's swizzled image
  static __device__ __forceinline__ uint32_t hoff(int p, int col) {
    return swizzled<RB>(static_cast<uint32_t>(p * RB + col));
  }
};

// The pre-pack: B of every stage in wgmma's no-swizzle K-major image,
// packed[((ci_tile * S + s) * BPLANES + hl) * TP + t][n / 8][k / (16 / esize)][n % 8][16 B],
// s = plane * n_chunks + co / CK, t the plane's tap, n = ci - ci_tile * NP,
// k = co % CK; zero past Ci and Co.  One thread per (ci_tile, co, n).
template <typename T, int MODE, int NP>
__global__ void fused_conv3x3_dgrad_pack_kernel(const T* __restrict__ w, int w_stride, int Ci,
                                                int Co, int n_ci_tiles, int n_chunks,
                                                uint8_t* __restrict__ packed) {
  using G = Dg<T, MODE, NP>;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int co_pad = n_chunks * G::CK;
  if (idx >= n_ci_tiles * co_pad * NP) return;
  const int n = idx % NP, co = (idx / NP) % co_pad, ci_tile = idx / (NP * co_pad);
  const int ci = ci_tile * NP + n;
  float raw[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (ci < Ci && co < Co) {
    const T* src = w + (size_t)co * w_stride + (size_t)ci * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) raw[k] = to_float(src[k]);
  }
  float folded[taps_of<MODE>()];
  fold_taps<MODE>(raw, folded);
  const int chunk = co / G::CK, k = co % G::CK;
  constexpr int ES = sizeof(T);
  const int within = (n / 8) * G::KB * 128 + (k * ES / 16) * 128 + (n % 8) * 16 + (k * ES) % 16;
#pragma unroll
  for (int tap = 0; tap < taps_of<MODE>(); ++tap) {
    const int plane = tap / G::TP, t = tap % G::TP;
    const int s = plane * n_chunks + chunk;
    uint8_t* stage = packed + ((size_t)ci_tile * G::PLANES * n_chunks + s) * G::B_STAGE;
    if constexpr (G::kF32) {
      uint32_t hi, lo;
      split_tf32_bits(folded[tap], hi, lo);
      *reinterpret_cast<uint32_t*>(stage + t * G::B_TAP + within) = hi;
      *reinterpret_cast<uint32_t*>(stage + (G::TP + t) * G::B_TAP + within) = lo;
    } else {
      *reinterpret_cast<__nv_bfloat16*>(stage + t * G::B_TAP + within) =
          __float2bfloat16(folded[tap]);
    }
  }
}

template <typename T, int MODE, int NP>
__global__ void __launch_bounds__(DG_THREADS, (Dg<T, MODE, NP>::MIN_BLOCKS))
fused_conv3x3_dgrad_kernel(const T* __restrict__ gz, const uint8_t* __restrict__ packed,
                           T* __restrict__ gx, int N, int H, int W, int Ci, int Co, int n_chunks,
                           const __grid_constant__ CUtensorMap gz_map, bool tma, bool vec_out) {
  using G = Dg<T, MODE, NP>;
  constexpr bool kF32 = G::kF32;

  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* s_b = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-aligned
  // s_b [RING][B_STAGE], then the halo buffers [RING][H_BYTES] (hi in f32),
  // f32's lo plane [H_BYTES], one zero row of 16 bytes, the mbarriers
  uint8_t* s_h = s_b + G::RING * G::B_STAGE;
  uint8_t* s_l = s_h + G::RING * G::H_BYTES;
  uint32_t* s_zero = reinterpret_cast<uint32_t*>(s_l + (kF32 ? G::H_BYTES : 0));
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_zero + 4);  // [RING]

  Probe probe;
  PROBE_BEGIN(probe);
  const int Ho = MODE == kReflect ? H : 2 * H;
  const int Wo = MODE == kReflect ? W : 2 * W;
  const int n_ci_tiles = (Ci + NP - 1) / NP;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + G::R - 1) / G::R;
  const int n_tiles = tiles_x * tiles_y * N * n_ci_tiles;
  // this block's tiles: blockIdx.x, + gridDim.x, ...; each through S stages
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int S = G::PLANES * n_chunks;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rbase = warp * G::WR;      // this warp's first tile row

  struct Tile {
    int n, ci_tile, my0, mx0;
  };
  auto tile_of = [&](int k) {  // tx fastest, then ty, n, the input-channel tile
    int t = blockIdx.x + k * gridDim.x;
    Tile tl;
    tl.mx0 = (t % tiles_x) * TW;
    t /= tiles_x;
    tl.my0 = (t % tiles_y) * G::R;
    t /= tiles_y;
    tl.n = t % N;
    tl.ci_tile = t / N;
    return tl;
  };

  if (tid < 4) s_zero[tid] = 0u;
  if (tid == 0) {
    for (int i = 0; i < G::RING; ++i) mbar_init(&s_bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // global stage q = tile k * S + stage s into ring slot `buf`: (thread 0)
  // its B tiles, and the cotangent halo of plane s / n_chunks, channels of
  // chunk s % n_chunks (zero outside the map: the transposed conv's zero
  // padding; plane (pa, pb) at up2_reflect holds output pixels (2i + pa,
  // 2j + pb)), both completing on the slot's mbarrier
  auto issue = [&](int q, int buf) {
    const int k = q / S, s = q - k * S;
    const Tile tl = tile_of(k);
    const int plane = s / n_chunks, c0 = (s - plane * n_chunks) * G::CK;
    uint8_t* dst = s_h + buf * G::H_BYTES;
    if (tid == 0) {
      mbar_arrive_expect_tx(&s_bar[buf], G::B_STAGE + (tma ? G::HBOX : 0));
      bulk_copy_g2s(s_b + buf * G::B_STAGE,
                    packed + ((size_t)tl.ci_tile * S + s) * G::B_STAGE, G::B_STAGE,
                    &s_bar[buf]);
      if (tma) {  // one box; its out-of-range pixels and channels land as zeros
        if constexpr (MODE == kReflect)
          tma_load_4d(dst, &gz_map, c0, tl.mx0 - 1, tl.my0 - 1, tl.n, &s_bar[buf]);
        else  // every other output pixel of each axis: one phase
          tma_load_4d(dst, &gz_map, c0, 2 * (tl.mx0 - 1) + (plane & 1),
                      2 * (tl.my0 - 1) + (plane >> 1), tl.n, &s_bar[buf]);
      }
    }
    if (!tma) {  // plain loads into the same image
      const T* gn = gz + (size_t)tl.n * Ho * Wo * Co;
      for (int i = tid; i < G::PLANE_PIX * G::CK; i += DG_THREADS) {
        const int p = i / G::CK, cl = i - p * G::CK;
        const int y = tl.my0 - 1 + p / HC, x = tl.mx0 - 1 + p % HC;
        const int oy = MODE == kReflect ? y : 2 * y + (plane >> 1);
        const int ox = MODE == kReflect ? x : 2 * x + (plane & 1);
        const bool in = y >= 0 && y < H && x >= 0 && x < W && c0 + cl < Co;
        *reinterpret_cast<T*>(dst + G::hoff(p, cl * (int)sizeof(T))) =
            in ? gn[((size_t)oy * Wo + ox) * Co + c0 + cl] : from_float<T>(0.f);
      }
    }
  };

  float acc[G::WR][G::ACC];
  float sum[G::WR][G::ACC];  // STAGE_SUMS: the tile's sums over its stages

  // ldmatrix row address of this lane, as the forward's: pixel a_px of the
  // warp's row, bytes a_col.. of the k-step, through the swizzle
  const int a_px = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const uint32_t h_addr = smem_u32(s_h);
  const uint32_t l_addr = smem_u32(s_l);
  const uint32_t zero_addr = smem_u32(s_zero);
  const uint32_t b_addr = smem_u32(s_b);
  auto halo = [&](int hr, int hc, int kk) { return G::hoff(hr * HC + hc, a_col + 32 * kk); };

  // The pad's border folds.  Row (column) lo and hi of x read a second
  // cotangent row through weight row 0 and 2 (reflect: rows 1 and H-2;
  // up2_reflect: low-res rows 0 and H-1, through phase-tap rows pa + ty = 0
  // and 2).  They run as extra wgmmas only in tiles that hold such a row or
  // column, under conditions uniform over the block (so that the compiler
  // keeps the wgmmas asynchronous), each lane masked to the zero row unless
  // its pixel folds.
  const int lo_row = MODE == kReflect ? 1 : 0, hi_row = MODE == kReflect ? H - 2 : H - 1;
  const int lo_col = MODE == kReflect ? 1 : 0, hi_col = MODE == kReflect ? W - 2 : W - 1;

  // one fold term: this warp's A (16 pixels at halo offset `off`, bytes of
  // k-step kk already in it; the zero row where `live` is false) times B of
  // (tap t, k-step kk) of ring slot `buf` into c
  auto term = [&](float (&c)[G::ACC], uint32_t off, bool live, int buf, int t, int kk) {
    const uint32_t bt = b_addr + buf * G::B_STAGE + t * G::B_TAP + kk * 256;
    const uint64_t dh = wgmma_desc(bt, 128, G::KB * 128);
    uint32_t ah[4];
    ldmatrix_x4(live ? h_addr + buf * G::H_BYTES + off : zero_addr, ah);
    if constexpr (kF32) {
      uint32_t al[4];
      ldmatrix_x4(live ? l_addr + off : zero_addr, al);  // lo has one buffer
      const uint64_t dl = wgmma_desc(bt + G::TP * G::B_TAP, 128, G::KB * 128);
      wgmma_fence();
      wgmma_rs(c, al, dh, T{});
      wgmma_rs(c, ah, dl, T{});
      wgmma_rs(c, ah, dh, T{});
    } else {
      wgmma_fence();
      wgmma_rs(c, ah, dh, T{});
    }
  };

  const int total = my_tiles * S;
  for (int q = 0; q < G::RING - 1 && q < total; ++q) issue(q, q);
  for (int k = 0; k < my_tiles; ++k) {
    const Tile tl = tile_of(k);
#pragma unroll
    for (int m = 0; m < G::WR; ++m)
#pragma unroll
      for (int j = 0; j < G::ACC; ++j) {
        acc[m][j] = 0.f;
        if constexpr (G::STAGE_SUMS) sum[m][j] = 0.f;
      }
    for (int s = 0; s < S; ++s) {
      const int q = k * S + s;
      const int buf = q % G::RING;
      const int plane = s / n_chunks;
      mbar_wait(&s_bar[buf], (q / G::RING) & 1);  // stage q's B (and TMA halo) landed
      // stage q's halo is in for every thread, and every warpgroup is done with
      // stage q - 1 (its halo buffer and ring slot are free for stage q + 1,
      // which may be the next tile's first)
      __syncthreads();
      PROBE_MARK(probe, wait);
      // stage q + RING - 1 into the slot stage q - 1 freed
      if (q + G::RING - 1 < total) issue(q + G::RING - 1, (q + G::RING - 1) % G::RING);
      PROBE_MARK(probe, stage);
      if constexpr (kF32) {  // split once: hi in place, lo into s_l, 16 bytes at a time
        // (element-wise, so the swizzled image stays as it is)
        uint4* hb = reinterpret_cast<uint4*>(s_h + buf * G::H_BYTES);
        uint4* lb = reinterpret_cast<uint4*>(s_l);
#pragma unroll 4
        for (int i = tid; i < G::HBOX / 16; i += DG_THREADS) {
          uint4 h = hb[i], l;
          split_tf32_landed(__uint_as_float(h.x), h.x, l.x);
          split_tf32_landed(__uint_as_float(h.y), h.y, l.y);
          split_tf32_landed(__uint_as_float(h.z), h.z, l.z);
          split_tf32_landed(__uint_as_float(h.w), h.w, l.w);
          hb[i] = h;
          lb[i] = l;
        }
        fence_proxy_async();  // these writes before the TMA that next fills the buffer
        PROBE_MARK(probe, stage);
        __syncthreads();
        PROBE_MARK(probe, wait);
      }
      const uint32_t hbuf = buf * G::H_BYTES;  // this stage's halo buffer

      // the primary terms, step i = (tap t, k-step kk): A of step i + 1 is
      // loaded (into the other register set) while step i's wgmmas run (a
      // third set gained nothing and spilled at bf16's 128 registers)
      constexpr int SETS = 2;
      uint32_t ah[SETS][G::WR][4], al[SETS][G::WR][4];
      auto load_a = [&](int i, int set) {
        const int t = i / G::KSTEPS, kk = i % G::KSTEPS, tap = plane * G::TP + t;
        // weight row u and column v of the tap (reflect: dy, dx; up2_reflect:
        // pa + ty, pb + tx): pixel rr reads halo row rr + 2 - u, column a_px + 2 - v
        const int u = MODE == kReflect ? tap / 3 : (tap >> 3) + ((tap >> 1) & 1);
        const int v = MODE == kReflect ? tap % 3 : ((tap >> 2) & 1) + (tap & 1);
#pragma unroll
        for (int m = 0; m < G::WR; ++m) {
          const uint32_t off = halo(rbase + m + 2 - u, a_px + 2 - v, kk);
          ldmatrix_x4(h_addr + hbuf + off, ah[set][m]);
          if constexpr (kF32) ldmatrix_x4(l_addr + off, al[set][m]);
        }
      };
      auto mma_a = [&](int i, int set) {
        const int t = i / G::KSTEPS, kk = i % G::KSTEPS;
        const uint32_t bt = b_addr + buf * G::B_STAGE + t * G::B_TAP + kk * 256;
        const uint64_t dh = wgmma_desc(bt, 128, G::KB * 128);
        wgmma_fence();
#pragma unroll
        for (int m = 0; m < G::WR; ++m) {
          if constexpr (kF32) {
            const uint64_t dl = wgmma_desc(bt + G::TP * G::B_TAP, 128, G::KB * 128);
            wgmma_rs(acc[m], al[set][m], dh, T{});
            wgmma_rs(acc[m], ah[set][m], dl, T{});
          }
          wgmma_rs(acc[m], ah[set][m], dh, T{});
        }
        wgmma_commit();
      };
      load_a(0, 0);
#pragma unroll
      for (int i = 0; i < G::NSTEP; ++i) {
        mma_a(i, i % SETS);
        if (i + 1 < G::NSTEP) {
          wgmma_wait<SETS - 1>();  // step i - 1 is done: its register set is free
          load_a(i + 1, (i + 1) % SETS);
        }
      }
      wgmma_wait<0>();

      // the folds (block-uniform conditions; lanes masked by `live`)
      const bool fold_cols = (lo_col >= tl.mx0 && lo_col < tl.mx0 + TW) ||
                             (hi_col >= tl.mx0 && hi_col < tl.mx0 + TW);
      const bool fold_rows = (lo_row >= tl.my0 && lo_row < tl.my0 + G::R) ||
                             (hi_row >= tl.my0 && hi_row < tl.my0 + G::R);
      if (fold_cols || fold_rows) {
        const int mx = tl.mx0 + a_px;  // this lane's A pixel column
#pragma unroll
        for (int t = 0; t < G::TP; ++t) {
          const int tap = plane * G::TP + t;
          const int u = MODE == kReflect ? tap / 3 : (tap >> 3) + ((tap >> 1) & 1);
          const int v = MODE == kReflect ? tap % 3 : ((tap >> 2) & 1) + (tap & 1);
          const int pc = a_px + 2 - v;                           // primary column
          const int fc = MODE == kReflect ? a_px + v : a_px + 1;  // folded column
          const bool lane_fold = v == 0 ? mx == lo_col : mx == hi_col;
          const int fold_row = u == 0 ? lo_row : hi_row;
#pragma unroll
          for (int kk = 0; kk < G::KSTEPS; ++kk) {
#pragma unroll
            for (int m = 0; m < G::WR; ++m) {
              const int rr = rbase + m;
              const int fr = MODE == kReflect ? rr + u : rr + 1;  // folded halo row
              // some warp holds the fold row at its m-th row: uniform
              const int d = fold_row - tl.my0 - m;
              const bool row_fold = u != 1 && d >= 0 && d < G::R && d % G::WR == 0;
              const bool mine = tl.my0 + rr == fold_row;
              if (row_fold) term(acc[m], halo(fr, pc, kk), mine, buf, t, kk);
              if (v != 1 && fold_cols) {
                term(acc[m], halo(rr + 2 - u, fc, kk), lane_fold, buf, t, kk);
                if (row_fold) term(acc[m], halo(fr, fc, kk), lane_fold && mine, buf, t, kk);
              }
            }
            wgmma_commit();
            wgmma_wait<0>();
          }
        }
      }
#pragma unroll
      for (int m = 0; m < G::WR; ++m) wgmma_fence_regs(acc[m]);
      if constexpr (G::STAGE_SUMS) {
#pragma unroll
        for (int m = 0; m < G::WR; ++m)
#pragma unroll
          for (int j = 0; j < G::ACC; ++j) {
            sum[m][j] += acc[m][j];
            acc[m][j] = 0.f;
          }
      }
      PROBE_MARK(probe, mma);
    }
    // epilogue: lanes t and t^1 swap halves so each owns 4 consecutive
    // input channels of one pixel, as the forward's
    const bool odd = t4 & 1;
    const int ox = tl.mx0 + g + (odd ? 8 : 0);
#pragma unroll
    for (int m = 0; m < G::WR; ++m) {
      const int oy = tl.my0 + rbase + m;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const float* c = G::STAGE_SUMS ? &sum[m][4 * j] : &acc[m][4 * j];
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
        const float v[4] = {odd ? s0 : c[0], odd ? s1 : c[1], odd ? c[2] : s0,
                            odd ? c[3] : s1};
        const int ci0 = tl.ci_tile * NP + j * 8 + (t4 >> 1) * 4;
        if (oy >= H || ox >= W || ci0 >= Ci) continue;
        const size_t base = (((size_t)tl.n * H + oy) * W + ox) * Ci + ci0;
        if (vec_out) {  // Ci % 4 == 0 and aligned: all 4 channels valid
          store4(gx + base, v);
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (ci0 + r < Ci) gx[base + r] = from_float<T>(v[r]);
        }
      }
    }
    PROBE_MARK(probe, epi);
  }
  PROBE_END(probe, blockIdx.x);
}

template <typename T, int MODE, int NP>
int chunks_of(int Co) { return (Co + Dg<T, MODE, NP>::CK - 1) / Dg<T, MODE, NP>::CK; }

template <typename T, int MODE, int NP>
long long scratch_bytes(int Ci, int Co) {
  using G = Dg<T, MODE, NP>;
  return (long long)((Ci + NP - 1) / NP) * G::PLANES * chunks_of<T, MODE, NP>(Co) * G::B_STAGE;
}

template <typename T, int MODE, int NP>
int launch_pack(const void* w, int w_stride, int Ci, int Co, void* packed, cudaStream_t stream) {
  const int n_ci_tiles = (Ci + NP - 1) / NP, n_chunks = chunks_of<T, MODE, NP>(Co);
  const int threads = n_ci_tiles * n_chunks * Dg<T, MODE, NP>::CK * NP;
  fused_conv3x3_dgrad_pack_kernel<T, MODE, NP><<<(threads + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(w), w_stride, Ci, Co, n_ci_tiles, n_chunks,
      static_cast<uint8_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}

// The main kernel's grid: persistent, one block (f32 at N = 64) or two per
// SM of the current device, or one per tile when there are fewer tiles.
// Returns the blocks, or minus a CUDA error.
template <typename T, int MODE, int NP>
long long grid_of(int N, int H, int W, int Ci) {
  using G = Dg<T, MODE, NP>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  const long long tiles = (long long)((W + TW - 1) / TW) * ((H + G::R - 1) / G::R) * N *
                          ((Ci + NP - 1) / NP);
  const long long resident = (long long)sms * G::MIN_BLOCKS;
  return tiles < resident ? tiles : resident;
}

template <typename T, int MODE, int NP>
int launch_dgrad(const void* gz, const void* w, int w_stride, void* packed, long long capacity,
                 void* gx, int N, int H, int W, int Ci, int Co, cudaStream_t stream) {
  using G = Dg<T, MODE, NP>;
  if (scratch_bytes<T, MODE, NP>(Ci, Co) > capacity) return static_cast<int>(cudaErrorInvalidValue);
  if (const int err = launch_pack<T, MODE, NP>(w, w_stride, Ci, Co, packed, stream)) return err;
  constexpr size_t smem = G::smem();
  auto kernel = fused_conv3x3_dgrad_kernel<T, MODE, NP>;
  static std::atomic<uint64_t> smem_set{0};
  if (const int err = smem_limit_once(kernel, smem, smem_set)) return err;
  // the halo by TMA when its rows are whole 16-byte groups (Co a multiple of
  // 16 bytes) and gz is 16-byte aligned, else by plain loads
  const bool tma = Co > 0 && Co % (16 / sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(gz) % 16 == 0;
  const bool vec_out = Ci % 4 == 0 && reinterpret_cast<uintptr_t>(gx) % (4 * sizeof(T)) == 0;
  CUtensorMap map{};
  if (tma) {
    const int Ho = MODE == kReflect ? H : 2 * H, Wo = MODE == kReflect ? W : 2 * W;
    const uint32_t step = MODE == kReflect ? 1 : 2;  // up2: one output phase a box
    const uint32_t box[4] = {G::CK, step * HC, step * (G::R + 2), 1};
    if (const int err = nhwc_tensor_map<T, G::RB>(&map, gz, N, Ho, Wo, Co, box, step)) return err;
  }
  const long long grid = grid_of<T, MODE, NP>(N, H, W, Ci);
  if (grid < 0) return static_cast<int>(-grid);
  kernel<<<(int)grid, DG_THREADS, smem, stream>>>(static_cast<const T*>(gz),
                                                  static_cast<const uint8_t*>(packed),
                                                  static_cast<T*>(gx), N, H, W, Ci, Co,
                                                  chunks_of<T, MODE, NP>(Co), map, tma, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// Fn<T, MODE, NP>::run(args...).  The probe's build instantiates only the
// kernels its sites run (N = 64: Ci = 64); the others return -1 there.
template <template <typename, int, int> class Fn, typename T, int MODE, int NP, typename... Args>
auto run_built(Args... args) -> decltype(Fn<T, MODE, NP>::run(args...)) {
#ifdef FOOTPRINTS_PROBE
  if constexpr (NP != 64) return -1;
  else
#endif
    return Fn<T, MODE, NP>::run(args...);
}

// Dispatch on dtype (0 = f32, 1 = bf16), pad mode and N (32 when Ci <= 32).
template <template <typename, int, int> class Fn, typename... Args>
auto dispatch(int dtype, int pad_mode, int Ci, Args... args) {
  const bool narrow = Ci <= 32;
  if (dtype == 0) {
    if (pad_mode == kReflect)
      return narrow ? run_built<Fn, float, kReflect, 32>(args...)
                    : run_built<Fn, float, kReflect, 64>(args...);
    return narrow ? run_built<Fn, float, kUp2Reflect, 32>(args...)
                  : run_built<Fn, float, kUp2Reflect, 64>(args...);
  }
  if (pad_mode == kReflect)
    return narrow ? run_built<Fn, __nv_bfloat16, kReflect, 32>(args...)
                  : run_built<Fn, __nv_bfloat16, kReflect, 64>(args...);
  return narrow ? run_built<Fn, __nv_bfloat16, kUp2Reflect, 32>(args...)
                : run_built<Fn, __nv_bfloat16, kUp2Reflect, 64>(args...);
}

template <typename T, int MODE, int NP>
struct ScratchFn {
  static long long run(int Ci, int Co) { return scratch_bytes<T, MODE, NP>(Ci, Co); }
};
template <typename T, int MODE, int NP>
struct PackFn {
  static int run(const void* w, int w_stride, int Ci, int Co, void* packed, cudaStream_t s) {
    return launch_pack<T, MODE, NP>(w, w_stride, Ci, Co, packed, s);
  }
};
template <typename T, int MODE, int NP>
struct LaunchFn {
  static int run(const void* gz, const void* w, int w_stride, void* packed, long long capacity,
                 void* gx, int N, int H, int W, int Ci, int Co, cudaStream_t s) {
    return launch_dgrad<T, MODE, NP>(gz, w, w_stride, packed, capacity, gx, N, H, W, Ci, Co, s);
  }
};

bool valid_mode(int dtype, int pad_mode) {
  return (dtype == 0 || dtype == 1) && (pad_mode == kReflect || pad_mode == kUp2Reflect);
}

}  // namespace

// Bytes of scratch fused_conv3x3_dgrad_launch needs for the packed weights
// (dtype 0 = float32, 1 = bfloat16; pad_mode 0 = reflect, 1 = up2_reflect);
// -1 for an invalid dtype or mode.
extern "C" long long fused_conv3x3_dgrad_scratch(int dtype, int Ci, int Co, int pad_mode) {
  if (!valid_mode(dtype, pad_mode)) return -1;
  return dispatch<ScratchFn>(dtype, pad_mode, Ci, Ci, Co);
}

// The pre-pack alone (the first of fused_conv3x3_dgrad_launch's two
// launches): w OIHW [Co,Ci,3,3] with w_stride elements between output
// channels -> `packed`, fused_conv3x3_dgrad_scratch bytes, every byte written.
extern "C" int fused_conv3x3_dgrad_pack(int dtype, const void* w, int w_stride, int Ci, int Co,
                                        int pad_mode, void* packed, void* stream) {
  if (!valid_mode(dtype, pad_mode) || w_stride < Ci * 9)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)Ci * Co == 0) return 0;
  return dispatch<PackFn>(dtype, pad_mode, Ci, w, w_stride, Ci, Co, packed,
                          static_cast<cudaStream_t>(stream));
}

// dtype: 0 = float32, 1 = bfloat16.  pad_mode: 0 = reflect, 1 = up2_reflect.
// gz is NHWC [N,Ho,Wo,Co] (Ho x Wo = H x W at reflect, 2H x 2W at
// up2_reflect); w is OIHW [Co,Ci,3,3] with its last three dims contiguous
// and w_stride elements between output channels (>= Ci * 9); packed is
// 16-byte aligned scratch of `capacity` bytes (at least
// fused_conv3x3_dgrad_scratch's); gx is NHWC [N,H,W,Ci], every element
// written.  Two launches on `stream` (the pre-pack, the main kernel);
// returns cudaGetLastError() (0 on success).
extern "C" int fused_conv3x3_dgrad_launch(int dtype, const void* gz, const void* w,
                                          int w_stride, void* packed, long long capacity,
                                          void* gx, int N, int H, int W, int Ci, int Ho, int Wo,
                                          int Co, int pad_mode, void* stream) {
  if (!valid_mode(dtype, pad_mode)) return static_cast<int>(cudaErrorInvalidValue);
  const int f = pad_mode == kReflect ? 1 : 2;
  if (Ho != f * H || Wo != f * W || w_stride < Ci * 9 ||
      (pad_mode == kReflect && (H < 2 || W < 2)) || reinterpret_cast<uintptr_t>(packed) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)N * H * W * Ci == 0) return 0;
  return dispatch<LaunchFn>(dtype, pad_mode, Ci, gz, w, w_stride, packed, capacity, gx, N, H, W,
                            Ci, Co, static_cast<cudaStream_t>(stream));
}

#ifdef FOOTPRINTS_PROBE
template <typename T, int MODE, int NP>
struct GridFn {
  static long long run(int N, int H, int W, int Ci) { return grid_of<T, MODE, NP>(N, H, W, Ci); }
};

// The probe build: the main kernel's blocks for these shapes on the current
// device (minus a CUDA error).
extern "C" long long fused_conv3x3_dgrad_probe_blocks(int dtype, int N, int H, int W, int Ci,
                                                      int pad_mode) {
  if (!valid_mode(dtype, pad_mode)) return -static_cast<long long>(cudaErrorInvalidValue);
  return dispatch<GridFn>(dtype, pad_mode, Ci, N, H, W, Ci);
}

// The probe build: where the main kernel's blocks write their stamps
// (PROBE_FIELDS 64-bit words each, in block order, the first `blocks`
// blocks), or null for none.
extern "C" int fused_conv3x3_dgrad_probe_set(void* buf, long long blocks) {
  return probe_set(buf, blocks);
}
#endif
