// Flash-attention backward for Hopper (sm_90a): dQ, and dK with dV, from the
// forward's out and per-row logsumexp.  bf16 operands, f32 accumulation.
//
// Replaces the two backward kernels of simpletuner_tpu/ops/flash_attention.py,
// both launched by _flash_backward through pl.pallas_call:
//   * flash_bwd_dq_kernel  <- _bwd_dq_kernel  (one CTA per query tile, keys streamed)
//   * flash_bwd_dkv_kernel <- _bwd_dkv_kernel (one CTA per key tile, queries streamed)
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
// matrices (P, dP, dS) never leave registers.  Head dims 64, 128 and 256
// are instances of the same two kernels; at 256 the tiles narrow and the dkv
// kernel splits D between its warpgroups (DqSmem, DkvSmem).
//
// Design, shared by both kernels:
//   * the TPU split is kept: two kernels and no atomics on a gradient, so the
//     gradients are bitwise deterministic; dq recomputes S and dP (as the dq Pallas kernel
//     does), since the dkv consumers have no registers left for a dQ tile;
//   * warp-specialised TMA + wgmma: one producer warpgroup (setmaxnreg 24)
//     whose first warp issues every TMA load, and two consumer warpgroups of
//     64 owned rows each (setmaxnreg 240) that keep their gradient tiles in
//     f32 registers for the whole sweep; the streamed tiles pass through an
//     mbarrier ring, and the two consumer warpgroups take turns to issue
//     their products (ping-pong on named barriers 1 and 2), so one's
//     elementwise work runs under the other's products;
//   * the segment mask is scheduled per tile pair (hopper::tile_class, the
//     rule of ops/flash_attention.py::tile_schedule): a skip tile is never
//     loaded, a full tile takes no mask, a mixed tile masks per element; a
//     CTA whose own rows are all pad streams nothing and writes exact zeros;
//   * ragged tails (S not a multiple of the tile) are masked with the
//     semantics of SEGMENT_PAD_ID padding; rows past S are never stored.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;

constexpr int THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_THREADS = 256;

struct BwdParams {
  const float* lse;    // (batch * heads, sq), f32
  const float* delta;  // (batch * heads, sq), f32
  const int32_t* q_seg;   // (batch, sq) or null (all zeros)
  const int32_t* kv_seg;  // (batch, sk) or null (all zeros)
  bf16* out0;  // dq (dq kernel) or dk (dkv kernel)
  bf16* out1;  // dv (dkv kernel)
  int64_t o0_sb, o0_sh, o0_ss;  // element strides: batch, head, sequence
  int64_t o1_sb, o1_sh, o1_ss;
  int heads, sq, sk;
  float scale;       // sm_scale
  float scale_log2;  // sm_scale * log2(e)
};

// ---------------------------------------------------------------------------
// dQ: one CTA per (batch * head, 128 query rows), streaming 64-key tiles
// ---------------------------------------------------------------------------
//
// Q and dO of the CTA are loaded once by TMA; K and V tiles of 64 keys stream
// through a 3-stage TMA ring, each released apart on its own "empty" barrier
// (V once dP has read it, K once dQ has), and the producer warp stages the
// key ids of a mixed tile in shared memory beside them.  Each consumer thread
// holds the lse (base 2), delta and query ids of its two rows in registers.
// Per tile, each consumer warpgroup runs three wgmma products:
//   S   = Q K^T      (A = Q K-major, B = K K-major, both in shared memory)
//   dP  = dO V^T     (A = dO, B = V K-major)
//   dQ += dS K       (A = bf16(dS) in registers, B = K MN-major)
// with dQ in f32 registers for the whole sweep, scaled and rounded to bf16
// once at the end.  S and dP of the next tile are issued together with the
// current tile's dS K, so the elementwise work of dS runs under that product
// (the loop issues both and waits on the older group with no branch between,
// or ptxas serializes the wgmma pipeline).  The key tiles are scheduled against the CTA's query ids
// (hopper::schedule_key_tiles, as in the forward).

constexpr int DQ_BLOCK_M = 128;  // query rows per CTA, 64 per consumer warpgroup

// byte offsets from the 1024-aligned start of dynamic shared memory, and the
// streamed key tiles: 64 keys in a 3-stage ring up to head dim 128.  At head
// dim 256, Q and dO take 128 KB, so K and V stream as 32-key tiles through 2
// stages (4 x 16 KB), and a consumer thread holds the 64 x 256 f32 dQ (128
// registers) beside S and dP of 64 x 32 (16 each).
template <int D>
struct DqSmem {
  static constexpr int DQ_BLOCK_N = D == 256 ? 32 : 64;  // keys per streamed tile
  static constexpr int DQ_STAGES = D == 256 ? 2 : 3;
  static constexpr int OWN = DQ_BLOCK_M * D * 2;   // Q or dO
  static constexpr int TILE = DQ_BLOCK_N * D * 2;  // one K or V stage
  static constexpr int Q = 0;
  static constexpr int DO = Q + OWN;
  static constexpr int K = DO + OWN;
  static constexpr int V = K + DQ_STAGES * TILE;
  static constexpr int KV_IDS = V + DQ_STAGES * TILE;  // int [STAGES][BLOCK_N]: key ids of a mixed tile
  // q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]
  static constexpr int BARS = KV_IDS + DQ_STAGES * DQ_BLOCK_N * 4;
  static constexpr int BOUNDS = BARS + 8 * (1 + 4 * DQ_STAGES);  // query id range of each row warp
  static constexpr int CLASSES = BOUNDS + 8 * (DQ_BLOCK_M / 32);  // one byte per key tile
  static int bytes(int key_tiles) { return 1024 + CLASSES + ((key_tiles + 15) & ~15); }
};

// dS = P (dP - delta) for one tile into dp, with P = exp(s scale - lse):
// element 4 i + e is the thread's query row e / 2, key 8 i + 2 t + e % 2 of
// the tile; a mixed tile zeroes P where the segment mask is false
template <int DQ_BLOCK_N, bool MIXED>
__device__ __forceinline__ void ds_tile(const float (&s)[DQ_BLOCK_N / 2], float (&dp)[DQ_BLOCK_N / 2],
                                        float scale_log2, const float (&lse)[2], const float (&delta)[2],
                                        const int (&q_ids)[2], const int* kv_ids, int t) {
#pragma unroll
  for (int i = 0; i < DQ_BLOCK_N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr = hopper::fast_exp2(fmaf(s[4 * i + e], scale_log2, -lse[e >> 1]));
      if (MIXED && !attends(q_ids[e >> 1], kv_ids[8 * i + 2 * t + (e & 1)])) pr = 0.f;
      dp[4 * i + e] = pr * (dp[4 * i + e] - delta[e >> 1]);
    }
  }
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                        const BwdParams p) {
  using S = DqSmem<D>;
  constexpr int DQ_BLOCK_N = S::DQ_BLOCK_N;
  constexpr int DQ_STAGES = S::DQ_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  int* kv_id_s = reinterpret_cast<int*>(smem + S::KV_IDS);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + DQ_STAGES;
  uint64_t* k_empty = v_full + DQ_STAGES;
  uint64_t* v_empty = k_empty + DQ_STAGES;
  int* bounds = reinterpret_cast<int*>(smem + S::BOUNDS);
  uint8_t* classes = smem + S::CLASSES;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int m0 = blockIdx.x * DQ_BLOCK_M;
  const int n_tiles = (p.sk + DQ_BLOCK_N - 1) / DQ_BLOCK_N;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], CONSUMER_THREADS);
      hopper::mbar_init(&v_empty[s], CONSUMER_THREADS);
    }
    hopper::mbar_init_fence();
  }
  // the tile schedule: query id range, then one class per key tile
  if (MASKED) {
    hopper::schedule_key_tiles<DQ_BLOCK_M, DQ_BLOCK_N, THREADS>(p.q_seg, p.kv_seg, b, p.sq, p.sk, m0, bounds,
                                                                classes);
  }
  __syncthreads();
  // the next tile at or after j that is not skipped (n_tiles when none)
  auto next_tile = [&](int j) {
    if (MASKED) {
      while (j < n_tiles && classes[j] == hopper::TILE_SKIP) ++j;
    }
    return j;
  };

  if (warp < 4) {
    // ------------------------------------------------------------ producer
    hopper::regs_dealloc<24>();
    if (warp == 0) {
      int stage = 0;
      uint32_t phase = 0;
      bool own_loaded = false;
      for (int j = next_tile(0); j < n_tiles; j = next_tile(j + 1)) {
        if (lane == 0 && !own_loaded) {
          hopper::mbar_expect_tx(q_full, 2 * S::OWN);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(smem + S::Q + c * DQ_BLOCK_M * 128, &tm_q, q_full, c * 64, m0, h, b);
            hopper::tma_load_4d(smem + S::DO + c * DQ_BLOCK_M * 128, &tm_do, q_full, c * 64, m0, h, b);
          }
        }
        own_loaded = true;
        hopper::mbar_wait(&k_empty[stage], phase ^ 1);
        if (MASKED && classes[j] == hopper::TILE_MIXED) {
#pragma unroll
          for (int r = 0; r < DQ_BLOCK_N / 32; ++r) {
            kv_id_s[stage * DQ_BLOCK_N + r * 32 + lane] =
                segment_id(p.kv_seg, b, p.sk, j * DQ_BLOCK_N + r * 32 + lane);
          }
        }
        __syncwarp();
        if (lane == 0) {
          hopper::mbar_expect_tx(&k_full[stage], S::TILE);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(smem + S::K + stage * S::TILE + c * DQ_BLOCK_N * 128, &tm_k, &k_full[stage],
                                c * 64, j * DQ_BLOCK_N, h, b);
          }
          hopper::mbar_wait(&v_empty[stage], phase ^ 1);
          hopper::mbar_expect_tx(&v_full[stage], S::TILE);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(smem + S::V + stage * S::TILE + c * DQ_BLOCK_N * 128, &tm_v, &v_full[stage],
                                c * 64, j * DQ_BLOCK_N, h, b);
          }
        }
        __syncwarp();
        if (++stage == DQ_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    hopper::regs_alloc<240>();
    const int c = warp / 4 - 1;  // query rows [64 c, 64 c + 64) of the CTA's tile
    const int w = warp % 4;
    const int t = lane & 3;
    const int rows[2] = {m0 + 64 * c + 16 * w + (lane >> 2), m0 + 64 * c + 16 * w + (lane >> 2) + 8};
    // this thread's rows: lse in base 2 and delta (0 past sq, where the
    // mask zeroes P), and their segment ids
    float lse[2], delta[2];
    int q_ids[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool valid = rows[r] < p.sq;
      lse[r] = valid ? p.lse[(int64_t)bh * p.sq + rows[r]] * LOG2E : 0.f;
      delta[r] = valid ? p.delta[(int64_t)bh * p.sq + rows[r]] : 0.f;
      if (MASKED) q_ids[r] = segment_id(p.q_seg, b, p.sq, rows[r]);
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float s[DQ_BLOCK_N / 2], dp[DQ_BLOCK_N / 2];
#pragma unroll
    for (int i = 0; i < DQ_BLOCK_N / 2; ++i) s[i] = dp[i] = 0.f;
    uint32_t dsa[DQ_BLOCK_N / 4];

    const uint32_t q_tile = hopper::smem_u32(smem + S::Q);
    const uint32_t do_tile = hopper::smem_u32(smem + S::DO);
    auto advance = [&](int& stage, uint32_t& phase) {
      if (++stage == DQ_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    // S = Q K^T and dP = dO V^T of the tile in `stage` (this warpgroup's 64
    // queries x 64 keys), issued and committed
    auto issue_scores = [&](int stage, uint32_t phase) {
      const uint32_t k_tile = hopper::smem_u32(smem + S::K + stage * S::TILE);
      const uint32_t v_tile = hopper::smem_u32(smem + S::V + stage * S::TILE);
      hopper::mbar_wait(&k_full[stage], phase);
      hopper::mbar_wait(&v_full[stage], phase);
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::wgmma_ss<DQ_BLOCK_N>(s, hopper::desc_k_major<DQ_BLOCK_M>(q_tile, c * 64 * 128, kk),
                                     hopper::desc_k_major<DQ_BLOCK_N>(k_tile, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::wgmma_ss<DQ_BLOCK_N>(dp, hopper::desc_k_major<DQ_BLOCK_M>(do_tile, c * 64 * 128, kk),
                                     hopper::desc_k_major<DQ_BLOCK_N>(v_tile, 0, kk), kk > 0);
      }
      hopper::wgmma_commit();
    };
    // dS = P (dP - delta) of the completed S and dP of tile j into dp;
    // releases the V stage
    auto scores_to_ds = [&](int j, int stage) {
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::mbar_arrive(&v_empty[stage]);
      if (MASKED && classes[j] == hopper::TILE_MIXED) {
        ds_tile<DQ_BLOCK_N, true>(s, dp, p.scale_log2, lse, delta, q_ids, kv_id_s + stage * DQ_BLOCK_N, t);
      } else {
        ds_tile<DQ_BLOCK_N, false>(s, dp, p.scale_log2, lse, delta, q_ids, kv_id_s, t);
      }
    };
    // dS re-packed as the bf16 A operand of dS K
    auto pack_ds = [&]() {
#pragma unroll
      for (int kk = 0; kk < DQ_BLOCK_N / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) dsa[4 * kk + r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    };
    // dQ += bf16(dS) K of the tile in `stage`, K read MN-major (its rows are
    // the contraction), issued and committed
    auto issue_dq = [&](int stage) {
      const uint32_t k_tile = hopper::smem_u32(smem + S::K + stage * S::TILE);
      hopper::fence_regs(dsa);
      hopper::fence_regs(dq);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BLOCK_N / 16; ++kk) {
        hopper::wgmma_rs<D, DQ_BLOCK_N>(dq, &dsa[4 * kk], k_tile, kk);
      }
      hopper::wgmma_commit();
    };
    // waits for every product in flight and releases the K stage
    auto retire_dq = [&](int stage) {
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      hopper::mbar_arrive(&k_empty[stage]);
    };

    // ping-pong: the two warpgroups take turns to issue their products, so
    // one's elementwise work runs while the other's products occupy the
    // tensor cores.  Warpgroup c waits on barrier 1 + c before it issues and
    // then lets the other go; warpgroup 1 lets warpgroup 0 go first and skips
    // its last pass.
    auto my_turn = [&]() { hopper::named_bar_sync(1 + c, CONSUMER_THREADS); };
    auto pass_turn = [&]() { hopper::named_bar_arrive(2 - c, CONSUMER_THREADS); };
    // Per tile pair: S and dP of the next tile and dQ += dS K of the current
    // one are in flight together while dS of the next tile is computed.
    int j = next_tile(0);
    if (j < n_tiles) {
      int stage = 0, next_stage = 0;  // ring stages of tile j and of the tile after it
      uint32_t next_phase = 0;
      hopper::mbar_wait(q_full, 0);
      if (c == 1) hopper::named_bar_arrive(1, CONSUMER_THREADS);
      my_turn();
      issue_scores(stage, 0);
      pass_turn();
      hopper::wgmma_wait<0>();
      scores_to_ds(j, stage);
      pack_ds();
      advance(next_stage, next_phase);
      for (int next = next_tile(j + 1); next < n_tiles; next = next_tile(j + 1)) {
        my_turn();
        issue_scores(next_stage, next_phase);
        issue_dq(stage);
        pass_turn();
        hopper::wgmma_wait<1>();  // S and dP of `next` have completed, dS K of j may still run
        scores_to_ds(next, next_stage);
        retire_dq(stage);
        pack_ds();
        j = next;
        stage = next_stage;
        advance(next_stage, next_phase);
      }
      my_turn();
      issue_dq(stage);
      if (c == 0) pass_turn();
      retire_dq(stage);
    }

    // epilogue: dq = scale * dS K, rounded once; a CTA that streamed nothing
    // writes exact zeros
    bf16* dqg = p.out0 + b * p.o0_sb + h * p.o0_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= p.sq) continue;
      bf16* qrow = dqg + (int64_t)rows[r] * p.o0_ss + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(qrow + 8 * i) =
            pack_bf16(dq[4 * i + 2 * r] * p.scale, dq[4 * i + 2 * r + 1] * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one CTA per (batch * head, 128 key rows), streaming 64-query tiles
// ---------------------------------------------------------------------------
//
// K and V of the CTA are loaded once by TMA; Q and dO tiles of 64 rows stream
// through a 2-stage TMA ring, and the producer warp stages each tile's lse
// (base 2), delta and query ids in shared memory beside them before it arms
// the stage's barrier.  Per tile, each consumer warpgroup runs four wgmma
// products:
//   S^T  = K Q^T     (A = K, B = Q K-major, both in shared memory)
//   dP^T = V dO^T    (A = V, B = dO K-major)
//   dV  += P^T dO    (A = bf16(P^T) in registers, B = dO MN-major)
//   dK  += dS^T Q    (A = bf16(dS^T) in registers, B = Q MN-major)
// with dK and dV in f32 registers for the whole sweep.  The query tiles are
// scheduled against the CTA's key ids.

// byte offsets from the 1024-aligned start of dynamic shared memory, and the
// tiles.  Up to head dim 128 a CTA owns 128 keys, 64 per consumer warpgroup,
// with dK and dV over all of D, and streams 64-query tiles.  At head dim 256
// a warpgroup's dK and dV of 64 keys would take 256 f32 registers a thread,
// above the 255 cap, so the D is split: both warpgroups share the CTA's 64
// keys, each owns one half of D of dK and dV (128 registers) and computes
// the whole S^T and dP^T of each tile (over all of D) for itself, with
// 32-query tiles (K and V 64 KB, 2 stages of Q and dO 64 KB).  The split
// spends half as many products again as the 4 that the function needs,
// and keeps the kernel free of any exchange between the warpgroups.
template <int D>
struct DkvSmem {
  static constexpr bool SPLIT_D = D == 256;  // each consumer warpgroup owns one half of D
  static constexpr int DKV_BLOCK_N = SPLIT_D ? 64 : 128;  // key rows per CTA
  static constexpr int DKV_BLOCK_M = SPLIT_D ? 32 : 64;   // queries per streamed tile
  static constexpr int DKV_STAGES = 2;
  static constexpr int ACC_D = SPLIT_D ? D / 2 : D;  // dK and dV columns per consumer warpgroup
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

// P^T into s and dS^T = P^T (dP^T - delta) into dp for one tile: element
// 4 i + e is the thread's key row e / 2, query column 8 i + 2 t + e % 2 of
// the tile; a mixed tile zeroes P where the segment mask is false
template <int DKV_BLOCK_M, bool MIXED>
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
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                         const BwdParams p) {
  using S = DkvSmem<D>;
  constexpr int DKV_BLOCK_N = S::DKV_BLOCK_N;
  constexpr int DKV_BLOCK_M = S::DKV_BLOCK_M;
  constexpr int DKV_STAGES = S::DKV_STAGES;
  constexpr int ACC_D = S::ACC_D;
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
      hopper::mbar_init(&empty[s], CONSUMER_THREADS);
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
    for (int j = warp; j < n_tiles; j += THREADS / 32) {
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
    // key rows [64 c, 64 c + 64) of the CTA's tile, or with the split D all
    // 64 keys and dK / dV columns [ACC_D c, ACC_D c + ACC_D)
    const int c = warp / 4 - 1;
    const int w = warp % 4;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int key0 = S::SPLIT_D ? 0 : 64 * c;  // first key row of the warpgroup within the CTA's tile
    const int col0 = S::SPLIT_D ? ACC_D * c : 0;
    const int rows[2] = {n0 + key0 + 16 * w + g, n0 + key0 + 16 * w + g + 8};
    int kv_ids[2] = {0, 0};
    if (MASKED) {
      kv_ids[0] = segment_id(p.kv_seg, b, p.sk, rows[0]);
      kv_ids[1] = segment_id(p.kv_seg, b, p.sk, rows[1]);
    }
    float dk[ACC_D / 2], dv[ACC_D / 2];
#pragma unroll
    for (int i = 0; i < ACC_D / 2; ++i) dk[i] = dv[i] = 0.f;

    const uint32_t k_tile = hopper::smem_u32(smem + S::K);
    const uint32_t v_tile = hopper::smem_u32(smem + S::V);
    // ping-pong: the two warpgroups take turns to issue their products, as in
    // the dq kernel; warpgroup 1's first pass lets warpgroup 0 start, and
    // warpgroup 0 takes the surplus pass of warpgroup 1's last turn after the
    // sweep
    auto my_turn = [&]() { hopper::named_bar_sync(1 + c, CONSUMER_THREADS); };
    auto pass_turn = [&]() { hopper::named_bar_arrive(2 - c, CONSUMER_THREADS); };
    bool kv_waited = false;
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int cls = MASKED ? (int)classes[j] : hopper::TILE_FULL;
      if (cls == hopper::TILE_SKIP) continue;
      if (!kv_waited) {
        hopper::mbar_wait(kv_full, 0);
        kv_waited = true;
        if (c == 1) hopper::named_bar_arrive(1, CONSUMER_THREADS);  // warpgroup 0 issues first
      }
      const uint32_t q_tile = hopper::smem_u32(smem + S::Q + stage * S::TILE);
      const uint32_t do_tile = hopper::smem_u32(smem + S::DO + stage * S::TILE);
      const float* lse_t = lse_s + stage * DKV_BLOCK_M;
      const float* delta_t = delta_s + stage * DKV_BLOCK_M;
      const int* qid_t = qid_s + stage * DKV_BLOCK_M;

      // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x DKV_BLOCK_M queries
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
        hopper::wgmma_ss<DKV_BLOCK_M>(s, hopper::desc_k_major<DKV_BLOCK_N>(k_tile, key0 * 128, kk),
                                      hopper::desc_k_major<DKV_BLOCK_M>(q_tile, 0, kk), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::wgmma_ss<DKV_BLOCK_M>(dp, hopper::desc_k_major<DKV_BLOCK_N>(v_tile, key0 * 128, kk),
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
        probabilities<DKV_BLOCK_M, true>(s, dp, p.scale_log2, lse_t, delta_t, qid_t, kv_ids, t);
      } else {
        probabilities<DKV_BLOCK_M, false>(s, dp, p.scale_log2, lse_t, delta_t, qid_t, kv_ids, t);
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

      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q, over the warpgroup's
      // columns of dO and Q (their column blocks are DKV_BLOCK_M * 128 bytes apart)
      const uint32_t col_off = (col0 / 64) * DKV_BLOCK_M * 128;
      hopper::fence_regs(pa);
      hopper::fence_regs(dsa);
      hopper::fence_regs(dv);
      hopper::fence_regs(dk);
      my_turn();
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BLOCK_M / 16; ++kk) {
        hopper::wgmma_rs<ACC_D, DKV_BLOCK_M>(dv, &pa[4 * kk], do_tile + col_off, kk);
      }
#pragma unroll
      for (int kk = 0; kk < DKV_BLOCK_M / 16; ++kk) {
        hopper::wgmma_rs<ACC_D, DKV_BLOCK_M>(dk, &dsa[4 * kk], q_tile + col_off, kk);
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
      bf16* krow = dkg + (int64_t)rows[r] * p.o0_ss + col0 + 2 * t;
      bf16* vrow = dvg + (int64_t)rows[r] * p.o1_ss + col0 + 2 * t;
#pragma unroll
      for (int i = 0; i < ACC_D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(krow + 8 * i) =
            pack_bf16(dk[4 * i + 2 * r] * p.scale, dk[4 * i + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(vrow + 8 * i) = pack_bf16(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
      }
    }
  }
}

// one launch of a backward kernel: maps = tensor maps of q, k, v and dout
template <typename Kernel>
cudaError_t launch(Kernel kernel, const CUtensorMap* maps, const BwdParams& p, dim3 grid, int smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const CUtensorMap* maps, const BwdParams& p, int batch_heads, int masked,
                      cudaStream_t stream) {
  constexpr int block_n = DqSmem<D>::DQ_BLOCK_N;
  const int smem = DqSmem<D>::bytes((p.sk + block_n - 1) / block_n);
  const dim3 grid((p.sq + DQ_BLOCK_M - 1) / DQ_BLOCK_M, batch_heads);
  return masked ? launch(flash_bwd_dq_kernel<D, true>, maps, p, grid, smem, stream)
                : launch(flash_bwd_dq_kernel<D, false>, maps, p, grid, smem, stream);
}

template <int D>
cudaError_t launch_dkv(const CUtensorMap* maps, const BwdParams& p, int batch_heads, int masked,
                       cudaStream_t stream) {
  using S = DkvSmem<D>;
  const int smem = S::bytes((p.sq + S::DKV_BLOCK_M - 1) / S::DKV_BLOCK_M);
  const dim3 grid((p.sk + S::DKV_BLOCK_N - 1) / S::DKV_BLOCK_N, batch_heads);
  return masked ? launch(flash_bwd_dkv_kernel<D, true>, maps, p, grid, smem, stream)
                : launch(flash_bwd_dkv_kernel<D, false>, maps, p, grid, smem, stream);
}

// tensor maps of q, k, v and dout, read through strides[0..11]; boxes of
// q_rows rows for q and dout, kv_rows for k and v
cudaError_t make_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v, const void* dout,
                      const int64_t* strides, int batch, int heads, int sq, int sk, int head_dim, int q_rows,
                      int kv_rows) {
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const bool keys = i == 1 || i == 2;
    const cudaError_t err =
        hopper::make_tensor_map(&maps[i], bases[i], batch, heads, keys ? sk : sq, head_dim, strides[3 * i],
                                strides[3 * i + 1], strides[3 * i + 2], keys ? kv_rows : q_rows);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

BwdParams make_params(const void* lse, const void* delta, const void* q_seg, const void* kv_seg, void* out0,
                      void* out1, const int64_t* strides, int heads, int sq, int sk, float sm_scale) {
  BwdParams p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.q_seg = static_cast<const int32_t*>(q_seg);
  p.kv_seg = static_cast<const int32_t*>(kv_seg);
  p.out0 = static_cast<bf16*>(out0);
  p.out1 = static_cast<bf16*>(out1);
  int64_t* fields[6] = {&p.o0_sb, &p.o0_sh, &p.o0_ss, &p.o1_sb, &p.o1_sh, &p.o1_ss};
  for (int i = 0; i < 6; ++i) *fields[i] = strides[12 + i];
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.scale = sm_scale;
  p.scale_log2 = sm_scale * LOG2E;
  return p;
}

}  // namespace

extern "C" int st_flash_bwd_abi_version() { return 4; }

// Common arguments of both entries.  q/k/v/dout: bf16 with unit stride on the
// last (head) dim and the given element strides (batch, head, sequence) in
// `strides` [q, k, v, dout, out0, out1] (18 values; multiples of 8, bases
// 16-byte aligned); lse/delta: contiguous (batch, heads, sq) f32;
// q_seg/kv_seg: contiguous int32 or null; head_dim 64, 128 or 256.  Each
// returns a cudaError_t (0 on a successful launch).

// dq (out0) = scale * dS K.  `masked` = 0 is only valid when there are no
// segment ids, sq is a multiple of 128 and sk a multiple of the key tile
// (64; 32 at head_dim 256).
extern "C" int st_flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, const void* q_seg,
                                    const void* kv_seg, void* dq, const int64_t* strides, int batch,
                                    int heads, int sq, int sk, int head_dim, float sm_scale,
                                    int masked, void* stream) {
  if (head_dim != 64 && head_dim != 128 && head_dim != 256) return cudaErrorInvalidValue;
  const int keys = head_dim == 256 ? DqSmem<256>::DQ_BLOCK_N : DqSmem<128>::DQ_BLOCK_N;
  CUtensorMap maps[4];
  const cudaError_t err = make_maps(maps, q, k, v, dout, strides, batch, heads, sq, sk, head_dim, DQ_BLOCK_M, keys);
  if (err != cudaSuccess) return err;
  const BwdParams p = make_params(lse, delta, q_seg, kv_seg, dq, nullptr, strides, heads, sq, sk, sm_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 256:
      return launch_dq<256>(maps, p, batch * heads, masked, s);
    case 128:
      return launch_dq<128>(maps, p, batch * heads, masked, s);
    default:
      return launch_dq<64>(maps, p, batch * heads, masked, s);
  }
}

// dk (out0) = scale * dS^T Q, dv (out1) = P^T dO.  `masked` = 0 is only
// valid when there are no segment ids, sq is a multiple of the query tile
// and sk of the key tile (64 and 128; 32 and 64 at head_dim 256).
extern "C" int st_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, const void* q_seg,
                                     const void* kv_seg, void* dk, void* dv, const int64_t* strides,
                                     int batch, int heads, int sq, int sk, int head_dim,
                                     float sm_scale, int masked, void* stream) {
  if (head_dim != 64 && head_dim != 128 && head_dim != 256) return cudaErrorInvalidValue;
  const bool wide = head_dim == 256;
  const int queries = wide ? DkvSmem<256>::DKV_BLOCK_M : DkvSmem<128>::DKV_BLOCK_M;
  const int keys = wide ? DkvSmem<256>::DKV_BLOCK_N : DkvSmem<128>::DKV_BLOCK_N;
  CUtensorMap maps[4];
  const cudaError_t err = make_maps(maps, q, k, v, dout, strides, batch, heads, sq, sk, head_dim, queries, keys);
  if (err != cudaSuccess) return err;
  const BwdParams p = make_params(lse, delta, q_seg, kv_seg, dk, dv, strides, heads, sq, sk, sm_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 256:
      return launch_dkv<256>(maps, p, batch * heads, masked, s);
    case 128:
      return launch_dkv<128>(maps, p, batch * heads, masked, s);
    default:
      return launch_dkv<64>(maps, p, batch * heads, masked, s);
  }
}
