// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV, from the
// forward's out and per-row logsumexp.  bf16 operands, f32 accumulation.
//
// Replaces the two backward kernels of simpletuner_tpu/ops/flash_attention.py,
// both launched by _flash_backward through pl.pallas_call:
//   * flash_bwd_dq_kernel  <- _bwd_dq_kernel  (one CTA per query tile, kv innermost)
//   * flash_bwd_dkv_kernel <- _bwd_dkv_kernel (one CTA per key tile, q innermost)
// They compute the same functions with the same rounding sites:
//   P  = exp(s * scale - lse), zeroed where the segment mask is false
//        (attend(i, j) = q_seg[i] == kv_seg[j] && kv_seg[j] != PAD), so padded
//        rows (lse = -1e30) and padded keys get exactly 0;
//   dP = dO V^T with bf16 operands; dS = P * (dP - delta), delta = rowsum(O dO)
//        in f32 (computed by the caller, as the Pallas wrapper does);
//   dQ = scale * bf16(dS) K;  dK = scale * bf16(dS)^T Q;  dV = bf16(P)^T dO.
//
// What bounds it: at the Flux shape each kernel does 3 (dq) or 4 (dkv)
// S x S x D products (1.3e11 flop each) against a few tens of MB of q, k, v,
// dO, lse and delta: tensor-core bound, not device-memory bound.  The S x S
// matrices (P, dP, dS) never leave registers.
//
// Design:
//   * the TPU split is kept: two kernels and no atomics, so the gradients are
//     deterministic; dq recomputes S and dP (as the dq Pallas kernel does);
//   * dq: 4 warps per CTA, 16 owned query rows per warp, mma.sync m16n8k16,
//     64-key tiles double-buffered with cp.async and their segment ids staged
//     in shared memory;
//   * dkv: warp-specialised TMA + wgmma (one producer warpgroup, two consumer
//     warpgroups of 64 key rows each, see the section below), with the
//     segment mask scheduled per tile pair (hopper::tile_class);
//   * ragged tails (S not a multiple of the tile) are masked with the
//     semantics of SEGMENT_PAD_ID padding; rows past S are never stored.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int OWN_ROWS = 64;        // rows a CTA owns: 16 per warp
constexpr int DQ_KV_TILE = 64;      // keys per streamed tile in the dq kernel

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (batch * heads, sq), f32
  const float* delta;  // (batch * heads, sq), f32
  const int32_t* q_seg;   // (batch, sq) or null (all zeros)
  const int32_t* kv_seg;  // (batch, sk) or null (all zeros)
  bf16* out0;  // dq (dq kernel) or dk (dkv kernel)
  bf16* out1;  // dv (dkv kernel)
  int64_t q_sb, q_sh, q_ss;  // element strides: batch, head, sequence
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t o0_sb, o0_sh, o0_ss;
  int64_t o1_sb, o1_sh, o1_ss;
  int heads, sq, sk;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

template <int D>
struct DqSmem {
  static constexpr int STRIDE = Row<D>::STRIDE;
  static constexpr int OWN = OWN_ROWS * STRIDE;    // Q, dO
  static constexpr int TILE = DQ_KV_TILE * STRIDE;  // K, V (x2 buffers)
  static constexpr int BYTES = (2 * OWN + 4 * TILE) * (int)sizeof(bf16) + 2 * DQ_KV_TILE * (int)sizeof(int);
};


// ---------------------------------------------------------------------------
// dQ: one CTA per (batch * head, 64 query rows), looping over 64-key tiles
// ---------------------------------------------------------------------------

template <int D, bool MASKED>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq_kernel(const BwdParams p) {
  using S = DqSmem<D>;
  constexpr int STRIDE = S::STRIDE;
  constexpr int DT = D / 8;            // 8-wide dQ column tiles
  constexpr int NT = DQ_KV_TILE / 8;   // 8-wide key column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + S::OWN;
  bf16* k_s = do_s + S::OWN;
  bf16* v_s = k_s + 2 * S::TILE;
  int* kv_id_s = reinterpret_cast<int*>(v_s + 2 * S::TILE);  // [2][DQ_KV_TILE]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int m0 = blockIdx.x * OWN_ROWS;

  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* dog = p.dout + b * p.do_sb + h * p.do_sh;
  const int n_tiles = (p.sk + DQ_KV_TILE - 1) / DQ_KV_TILE;

  load_tile<OWN_ROWS, D>(q_s, qg, p.q_ss, m0, p.sq, tid);
  load_tile<OWN_ROWS, D>(do_s, dog, p.do_ss, m0, p.sq, tid);
  load_tile<DQ_KV_TILE, D>(k_s, kg, p.k_ss, 0, p.sk, tid);
  load_tile<DQ_KV_TILE, D>(v_s, vg, p.v_ss, 0, p.sk, tid);
  cp_async_commit();
  if (MASKED && tid < DQ_KV_TILE) kv_id_s[tid] = segment_id(p.kv_seg, b, p.sk, tid);

  // this thread's query rows, their lse (base 2), delta and segment ids
  const int rows[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  float lse_log2[2], delta[2];
  int q_ids[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool valid = rows[i] < p.sq;
    lse_log2[i] = valid ? p.lse[(int64_t)bh * p.sq + rows[i]] * LOG2E : 0.f;
    delta[i] = valid ? p.delta[(int64_t)bh * p.sq + rows[i]] : 0.f;
    if (MASKED) q_ids[i] = segment_id(p.q_seg, b, p.sq, rows[i]);
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const bf16* qw = q_s + warp * 16 * STRIDE;
  const bf16* dow = do_s + warp * 16 * STRIDE;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int next = (buf ^ 1) * S::TILE;
      load_tile<DQ_KV_TILE, D>(k_s + next, kg, p.k_ss, (j + 1) * DQ_KV_TILE, p.sk, tid);
      load_tile<DQ_KV_TILE, D>(v_s + next, vg, p.v_ss, (j + 1) * DQ_KV_TILE, p.sk, tid);
      cp_async_commit();
      if (MASKED && tid < DQ_KV_TILE) {
        kv_id_s[(buf ^ 1) * DQ_KV_TILE + tid] =
            segment_id(p.kv_seg, b, p.sk, (j + 1) * DQ_KV_TILE + tid);
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + buf * S::TILE;
    const bf16* vs = v_s + buf * S::TILE;
    const int* kv_ids = kv_id_s + buf * DQ_KV_TILE;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a_q[4], a_do[4];
      load_a_frag<STRIDE>(a_q, qw, kk, g, t);
      load_a_frag<STRIDE>(a_do, dow, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b_k[2], b_v[2];
        load_b_frag<STRIDE>(b_k, ks, nt, kk, g, t);
        load_b_frag<STRIDE>(b_v, vs, nt, kk, g, t);
        mma_16816(s[nt], a_q, b_k);
        mma_16816(dp[nt], a_do, b_v);
      }
    }

    // P = exp(s - lse) under the mask, dS = P (dP - delta), kept in s
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pr = exp2f(s[nt][e] * p.scale_log2 - lse_log2[e >> 1]);
        if (MASKED && !attends(q_ids[e >> 1], kv_ids[nt * 8 + 2 * t + (e & 1)])) pr = 0.f;
        s[nt][e] = pr * (dp[nt][e] - delta[e >> 1]);
      }
    }

    // dQ += bf16(dS) K
#pragma unroll
    for (int kk = 0; kk < DQ_KV_TILE / 16; ++kk) {
      uint32_t a_ds[4];
      pack_a_frag(a_ds, s, kk);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t b_k[4];
        load_b_frag_trans<STRIDE>(b_k, ks, kk, dp2, lane);
        mma_16816(acc[2 * dp2], a_ds, b_k);
        mma_16816(acc[2 * dp2 + 1], a_ds, b_k + 2);
      }
    }
    __syncthreads();  // everyone is done with `buf` before it is refilled
  }

  bf16* og = p.out0 + b * p.o0_sb + h * p.o0_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.sq) continue;
    bf16* orow = og + (int64_t)rows[i] * p.o0_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(acc[dt][2 * i] * p.scale, acc[dt][2 * i + 1] * p.scale);
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one CTA per (batch * head, 128 key rows), streaming 64-query tiles
// ---------------------------------------------------------------------------
//
// One producer warpgroup and two consumer warpgroups of 64 key rows each
// (setmaxnreg: 24 / 240 registers).  K and V of the CTA are loaded once by
// TMA; Q and dO tiles of 64 rows stream through a 2-stage TMA ring, and the
// producer warp stages each tile's lse (base 2), delta and query ids in
// shared memory beside them before it arms the stage's barrier.  Per tile,
// each consumer warpgroup runs four wgmma products:
//   S^T  = K Q^T     (A = K, B = Q K-major, both in shared memory)
//   dP^T = V dO^T    (A = V, B = dO K-major)
//   dV  += P^T dO    (A = bf16(P^T) in registers, B = dO MN-major)
//   dK  += dS^T Q    (A = bf16(dS^T) in registers, B = Q MN-major)
// with dK and dV in f32 registers for the whole sweep.  The query tiles are
// scheduled against the CTA's key ids (hopper::tile_class): a skip tile is
// never loaded, a full tile takes no mask, a mixed tile masks per element.
// A key tile that is all pad streams nothing and writes exact zeros.

constexpr int DKV_BLOCK_N = 128;  // key rows per CTA, 64 per consumer warpgroup
constexpr int DKV_BLOCK_M = 64;   // queries per streamed tile
constexpr int DKV_STAGES = 2;
constexpr int DKV_THREADS = 384;
constexpr int DKV_CONSUMER_THREADS = 256;

// byte offsets from the 1024-aligned start of dynamic shared memory
template <int D>
struct DkvSmem {
  static constexpr int OWN = DKV_BLOCK_N * D * 2;   // K or V
  static constexpr int TILE = DKV_BLOCK_M * D * 2;  // one Q or dO stage
  static constexpr int K = 0;
  static constexpr int V = K + OWN;
  static constexpr int Q = V + OWN;
  static constexpr int DO = Q + DKV_STAGES * TILE;
  static constexpr int LSE = DO + DKV_STAGES * TILE;            // f32 [STAGES][64], base 2
  static constexpr int DELTA = LSE + DKV_STAGES * DKV_BLOCK_M * 4;  // f32 [STAGES][64]
  static constexpr int QID = DELTA + DKV_STAGES * DKV_BLOCK_M * 4;  // int [STAGES][64]
  static constexpr int BARS = QID + DKV_STAGES * DKV_BLOCK_M * 4;   // kv_full, full[STAGES], empty[STAGES]
  static constexpr int BOUNDS = BARS + 8 * (1 + 2 * DKV_STAGES);  // key id range and count
  static constexpr int CLASSES = BOUNDS + 16;                     // one byte per query tile
  static int bytes(int query_tiles) { return 1024 + CLASSES + ((query_tiles + 15) & ~15); }
};

template <int D>
__device__ __forceinline__ void product_dkv(float (&acc)[D / 2], const uint32_t* a, uint64_t desc) {
  if constexpr (D == 128) {
    hopper::wgmma_rs_n128(acc, a, desc);
  } else {
    hopper::wgmma_rs_n64(acc, a, desc);
  }
}

// P^T into s and dS^T = P^T (dP^T - delta) into dp for one tile: element
// 4 i + e is the thread's key row e / 2, query column 8 i + 2 t + e % 2 of
// the tile; a mixed tile zeroes P where the segment mask is false
template <bool MIXED>
__device__ __forceinline__ void probabilities(float (&s)[DKV_BLOCK_M / 2], float (&dp)[DKV_BLOCK_M / 2],
                                              float scale_log2, const float* lse, const float* delta,
                                              const int* q_ids, const int (&kv_ids)[2], int t) {
#pragma unroll
  for (int i = 0; i < DKV_BLOCK_M / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * i + 2 * t + (e & 1);
      float pr = hopper::fast_exp2(fmaf(s[4 * i + e], scale_log2, -lse[col]));
      if (MIXED && !attends(q_ids[col], kv_ids[e >> 1])) pr = 0.f;
      s[4 * i + e] = pr;
      dp[4 * i + e] = pr * (dp[4 * i + e] - delta[col]);
    }
  }
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                         const BwdParams p) {
  using S = DkvSmem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  float* lse_s = reinterpret_cast<float*>(smem + S::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + S::DELTA);
  int* qid_s = reinterpret_cast<int*>(smem + S::QID);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + DKV_STAGES;
  int* bounds = reinterpret_cast<int*>(smem + S::BOUNDS);
  uint8_t* classes = smem + S::CLASSES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int n0 = blockIdx.x * DKV_BLOCK_N;
  const int n_tiles = (p.sq + DKV_BLOCK_M - 1) / DKV_BLOCK_M;

  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], DKV_CONSUMER_THREADS);
    }
    hopper::mbar_init_fence();
    bounds[0] = 0x7fffffff;
    bounds[1] = -0x7fffffff - 1;
    bounds[2] = 0;
  }
  if (MASKED) {
    // the tile schedule: the CTA's key id range, then one class per query tile
    __syncthreads();
    if (tid < DKV_BLOCK_N) {
      const int id = segment_id(p.kv_seg, b, p.sk, n0 + tid);
      const bool valid = id != SEGMENT_PAD_ID;
      const int lo = __reduce_min_sync(0xffffffffu, valid ? id : 0x7fffffff);
      const int hi = __reduce_max_sync(0xffffffffu, valid ? id : -0x7fffffff - 1);
      const int n = __reduce_add_sync(0xffffffffu, valid ? 1 : 0);
      if (lane == 0) {
        atomicMin(&bounds[0], lo);
        atomicMax(&bounds[1], hi);
        atomicAdd(&bounds[2], n);
      }
    }
    __syncthreads();
    const int kv_lo = bounds[0];
    const int kv_hi = bounds[1];
    const int kv_n = bounds[2];
    for (int j = warp; j < n_tiles; j += DKV_THREADS / 32) {
      int lo = 0x7fffffff, hi = -0x7fffffff - 1;
#pragma unroll
      for (int r = 0; r < DKV_BLOCK_M / 32; ++r) {
        const int id = segment_id(p.q_seg, b, p.sq, j * DKV_BLOCK_M + r * 32 + lane);
        lo = min(lo, id);
        hi = max(hi, id);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) classes[j] = (uint8_t)hopper::tile_class(lo, hi, kv_lo, kv_hi, kv_n, DKV_BLOCK_N);
    }
  }
  __syncthreads();

  if (warp < 4) {
    // ------------------------------------------------------------ producer
    hopper::regs_dealloc<24>();
    if (warp == 0) {
      const float* lseg = p.lse + (int64_t)bh * p.sq;
      const float* deltag = p.delta + (int64_t)bh * p.sq;
      bool kv_loaded = false;
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < n_tiles; ++j) {
        if (MASKED && classes[j] == hopper::TILE_SKIP) continue;
        if (!kv_loaded && lane == 0) {
          hopper::mbar_expect_tx(kv_full, 2 * S::OWN);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(smem + S::K + c * DKV_BLOCK_N * 128, &tm_k, kv_full, c * 64, n0, h, b);
            hopper::tma_load_4d(smem + S::V + c * DKV_BLOCK_N * 128, &tm_v, kv_full, c * 64, n0, h, b);
          }
        }
        kv_loaded = true;
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        // per-query values; queries past sq get lse = delta = 0 and the pad
        // id (their P is masked, their dO zero-filled)
#pragma unroll
        for (int r = lane; r < DKV_BLOCK_M; r += 32) {
          const int row = j * DKV_BLOCK_M + r;
          const bool valid = row < p.sq;
          lse_s[stage * DKV_BLOCK_M + r] = valid ? lseg[row] * LOG2E : 0.f;
          delta_s[stage * DKV_BLOCK_M + r] = valid ? deltag[row] : 0.f;
          if (MASKED) qid_s[stage * DKV_BLOCK_M + r] = segment_id(p.q_seg, b, p.sq, row);
        }
        __syncwarp();
        if (lane == 0) {
          hopper::mbar_expect_tx(&full[stage], 2 * S::TILE);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(smem + S::Q + stage * S::TILE + c * DKV_BLOCK_M * 128, &tm_q, &full[stage],
                                c * 64, j * DKV_BLOCK_M, h, b);
            hopper::tma_load_4d(smem + S::DO + stage * S::TILE + c * DKV_BLOCK_M * 128, &tm_do, &full[stage],
                                c * 64, j * DKV_BLOCK_M, h, b);
          }
        }
        if (++stage == DKV_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::regs_alloc<240>();
    const int c = warp / 4 - 1;  // key rows [64 c, 64 c + 64) of the CTA's tile
    const int w = warp % 4;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int rows[2] = {n0 + 64 * c + 16 * w + g, n0 + 64 * c + 16 * w + g + 8};
    int kv_ids[2] = {0, 0};
    if (MASKED) {
      kv_ids[0] = segment_id(p.kv_seg, b, p.sk, rows[0]);
      kv_ids[1] = segment_id(p.kv_seg, b, p.sk, rows[1]);
    }
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    const uint32_t k_tile = hopper::smem_u32(smem + S::K);
    const uint32_t v_tile = hopper::smem_u32(smem + S::V);
    // ping-pong: the two warpgroups take turns to issue their products, so
    // one's elementwise work runs while the other's products occupy the
    // tensor cores; warpgroup c waits on barrier 1 + c and then lets the other
    // go.  Warpgroup 1's first pass lets warpgroup 0 start; warpgroup 0 takes
    // the surplus pass of warpgroup 1's last turn after the sweep.
    auto my_turn = [&]() { hopper::named_bar_sync(1 + c, DKV_CONSUMER_THREADS); };
    auto pass_turn = [&]() { hopper::named_bar_arrive(2 - c, DKV_CONSUMER_THREADS); };
    bool kv_waited = false;
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int cls = MASKED ? (int)classes[j] : hopper::TILE_FULL;
      if (cls == hopper::TILE_SKIP) continue;
      if (!kv_waited) {
        hopper::mbar_wait(kv_full, 0);
        kv_waited = true;
        if (c == 1) hopper::named_bar_arrive(1, DKV_CONSUMER_THREADS);  // warpgroup 0 issues first
      }
      const uint32_t q_tile = hopper::smem_u32(smem + S::Q + stage * S::TILE);
      const uint32_t do_tile = hopper::smem_u32(smem + S::DO + stage * S::TILE);
      const float* lse_t = lse_s + stage * DKV_BLOCK_M;
      const float* delta_t = delta_s + stage * DKV_BLOCK_M;
      const int* qid_t = qid_s + stage * DKV_BLOCK_M;

      // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 queries
      float s[DKV_BLOCK_M / 2], dp[DKV_BLOCK_M / 2];
#pragma unroll
      for (int i = 0; i < DKV_BLOCK_M / 2; ++i) s[i] = dp[i] = 0.f;
      hopper::mbar_wait(&full[stage], phase);
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      my_turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::wgmma_ss_n64(s, hopper::desc_k_major<DKV_BLOCK_N>(k_tile, c * 64 * 128, kk),
                             hopper::desc_k_major<DKV_BLOCK_M>(q_tile, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::wgmma_ss_n64(dp, hopper::desc_k_major<DKV_BLOCK_N>(v_tile, c * 64 * 128, kk),
                             hopper::desc_k_major<DKV_BLOCK_M>(do_tile, 0, kk), kk > 0);
      }
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P^T in s, dS^T = P^T (dP^T - delta) in dp; element 4 i + e is key
      // row rows[e / 2], query column 8 i + 2 t + e % 2 of the tile
      if (MASKED && cls == hopper::TILE_MIXED) {
        probabilities<true>(s, dp, p.scale_log2, lse_t, delta_t, qid_t, kv_ids, t);
      } else {
        probabilities<false>(s, dp, p.scale_log2, lse_t, delta_t, qid_t, kv_ids, t);
      }
      uint32_t pa[DKV_BLOCK_M / 4], dsa[DKV_BLOCK_M / 4];
#pragma unroll
      for (int kk = 0; kk < DKV_BLOCK_M / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[4 * kk + r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          dsa[4 * kk + r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      }

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q
      hopper::fence_regs(pa);
      hopper::fence_regs(dsa);
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      my_turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BLOCK_M / 16; ++kk) {
        product_dkv<D>(dv, &pa[4 * kk], hopper::desc_mn_major<DKV_BLOCK_M>(do_tile, kk));
      }
#pragma unroll
      for (int kk = 0; kk < DKV_BLOCK_M / 16; ++kk) {
        product_dkv<D>(dk, &dsa[4 * kk], hopper::desc_mn_major<DKV_BLOCK_M>(q_tile, kk));
      }
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      hopper::mbar_arrive(&empty[stage]);
      if (++stage == DKV_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (kv_waited && c == 0) my_turn();

    bf16* dkg = p.out0 + b * p.o0_sb + h * p.o0_sh;
    bf16* dvg = p.out1 + b * p.o1_sb + h * p.o1_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.sk) continue;
      bf16* krow = dkg + (int64_t)rows[r] * p.o0_ss + 2 * t;
      bf16* vrow = dvg + (int64_t)rows[r] * p.o1_ss + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(krow + 8 * i) =
            pack_bf16(dk[4 * i + 2 * r] * p.scale, dk[4 * i + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * i) = pack_bf16(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const BwdParams& p, int tiles, int batch_heads, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(tiles, batch_heads), NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int batch_heads, int masked, cudaStream_t stream) {
  const int tiles = (p.sq + OWN_ROWS - 1) / OWN_ROWS;
  return masked ? launch(flash_bwd_dq_kernel<D, true>, p, tiles, batch_heads, DqSmem<D>::BYTES, stream)
                : launch(flash_bwd_dq_kernel<D, false>, p, tiles, batch_heads, DqSmem<D>::BYTES, stream);
}

template <int D, bool MASKED>
cudaError_t launch_dkv_mode(const CUtensorMap* maps, const BwdParams& p, int batch_heads, cudaStream_t stream) {
  const int smem = DkvSmem<D>::bytes((p.sq + DKV_BLOCK_M - 1) / DKV_BLOCK_M);
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + DKV_BLOCK_N - 1) / DKV_BLOCK_N, batch_heads);
  flash_bwd_dkv_kernel<D, MASKED><<<grid, DKV_THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const CUtensorMap* maps, const BwdParams& p, int batch_heads, int masked,
                       cudaStream_t stream) {
  return masked ? launch_dkv_mode<D, true>(maps, p, batch_heads, stream)
                : launch_dkv_mode<D, false>(maps, p, batch_heads, stream);
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* q_seg, const void* kv_seg,
                      void* out0, void* out1, const int64_t* strides, int heads, int sq, int sk,
                      float sm_scale) {
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_seg = static_cast<const int32_t*>(q_seg);
  p.kv_seg = static_cast<const int32_t*>(kv_seg);
  p.out0 = static_cast<bf16*>(out0);
  p.out1 = static_cast<bf16*>(out1);
  int64_t* fields[18] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.k_sb,  &p.k_sh,  &p.k_ss,
                         &p.v_sb,  &p.v_sh,  &p.v_ss,  &p.do_sb, &p.do_sh, &p.do_ss,
                         &p.o0_sb, &p.o0_sh, &p.o0_ss, &p.o1_sb, &p.o1_sh, &p.o1_ss};
  for (int i = 0; i < 18; ++i) *fields[i] = strides[i];
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * LOG2E;
  return p;
}

}  // namespace

extern "C" int st_flash_bwd_abi_version() { return 2; }

// Common arguments of both entries.  q/k/v/dout: bf16 with unit stride on the
// last (head) dim and the given element strides (batch, head, sequence) in
// `strides` [q, k, v, dout, out0, out1] (18 values); lse/delta: contiguous
// (batch, heads, sq) f32; q_seg/kv_seg: contiguous int32 or null.  `masked` =
// 0 is only valid when there are no segment ids and both sq and sk are
// multiples of 64.  Each returns a cudaError_t (0 on a successful launch).

// dq (out0) = scale * dS K
extern "C" int st_flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, const void* q_seg,
                                    const void* kv_seg, void* dq, const int64_t* strides, int batch,
                                    int heads, int sq, int sk, int head_dim, float sm_scale,
                                    int masked, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, nullptr, strides,
                                  heads, sq, sk, sm_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_dq<32>(p, batch * heads, masked, s);
    case 64: return launch_dq<64>(p, batch * heads, masked, s);
    case 128: return launch_dq<128>(p, batch * heads, masked, s);
    default: return cudaErrorInvalidValue;
  }
}

// dk (out0) = scale * dS^T Q, dv (out1) = P^T dO; head_dim 64 or 128.
// `masked` = 0 is only valid when there are no segment ids, sq is a
// multiple of 64 and sk a multiple of 128.
extern "C" int st_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, const void* q_seg,
                                     const void* kv_seg, void* dk, void* dv, const int64_t* strides,
                                     int batch, int heads, int sq, int sk, int head_dim,
                                     float sm_scale, int masked, void* stream) {
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  const BwdParams p = make_params(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, strides, heads,
                                  sq, sk, sm_scale);
  CUtensorMap maps[4];  // q, k, v, dout
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const bool keys = i == 1 || i == 2;
    const cudaError_t err =
        hopper::make_tensor_map(&maps[i], bases[i], batch, heads, keys ? sk : sq, head_dim, strides[3 * i],
                                strides[3 * i + 1], strides[3 * i + 2], keys ? DKV_BLOCK_N : DKV_BLOCK_M);
    if (err != cudaSuccess) return err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 128 ? launch_dkv<128>(maps, p, batch * heads, masked, s)
                         : launch_dkv<64>(maps, p, batch * heads, masked, s);
}
