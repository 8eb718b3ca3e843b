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
// What bounds it: like the forward, each CTA streams the other side's tiles
// (K/V, or Q/dO/lse/delta) through shared memory while its own 64 rows stay
// resident, doing 8 (dq) or 10 (dkv) x 64 x D flops per streamed row of
// 2 x 2 x D bytes, with the streamed head resident in L2 across the 72 CTAs
// that read it: tensor-core bound, not device-memory bound.  The S x S
// matrices (P, dP, dS) never leave registers: 16 rows per warp, one tile at a
// time.
//
// Design:
//   * the TPU split is kept: two kernels and no atomics, so the gradients are
//     deterministic; dq recomputes S and dP (as the dq Pallas kernel does);
//   * 4 warps per CTA, 16 owned rows per warp, mma.sync m16n8k16; S^T and
//     dP^T are computed directly in the dkv kernel (K and V are its A
//     operands), so dS^T is already in the A-fragment layout of dS^T Q;
//   * the streamed tiles are double-buffered with cp.async; the per-column
//     values (segment ids; lse and delta in dkv) are staged in shared memory
//     with them;
//   * ragged tails (S not a multiple of the tile) are masked with the
//     semantics of SEGMENT_PAD_ID padding; rows past S are never stored.
// wgmma/TMA, warp specialisation and merging dq into dkv are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int OWN_ROWS = 64;        // rows a CTA owns: 16 per warp
constexpr int DQ_KV_TILE = 64;      // keys per streamed tile in the dq kernel
constexpr int DKV_Q_TILE = 32;      // queries per streamed tile in the dkv kernel

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

template <int D>
struct DkvSmem {
  static constexpr int STRIDE = Row<D>::STRIDE;
  static constexpr int OWN = OWN_ROWS * STRIDE;    // K, V
  static constexpr int TILE = DKV_Q_TILE * STRIDE;  // Q, dO (x2 buffers)
  static constexpr int BYTES =
      (2 * OWN + 4 * TILE) * (int)sizeof(bf16) + 3 * 2 * DKV_Q_TILE * (int)sizeof(float);
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
// dK, dV: one CTA per (batch * head, 64 key rows), looping over 32-query tiles
// ---------------------------------------------------------------------------

template <int D, bool MASKED>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dkv_kernel(const BwdParams p) {
  using S = DkvSmem<D>;
  constexpr int STRIDE = S::STRIDE;
  constexpr int DT = D / 8;           // 8-wide dK/dV column tiles
  constexpr int NT = DKV_Q_TILE / 8;  // 8-wide query column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + S::OWN;
  bf16* q_s = v_s + S::OWN;
  bf16* do_s = q_s + 2 * S::TILE;
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * S::TILE);  // [2][DKV_Q_TILE], base 2
  float* delta_s = lse_s + 2 * DKV_Q_TILE;                      // [2][DKV_Q_TILE]
  int* q_id_s = reinterpret_cast<int*>(delta_s + 2 * DKV_Q_TILE);  // [2][DKV_Q_TILE]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int n0 = blockIdx.x * OWN_ROWS;

  const bf16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const bf16* dog = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lseg = p.lse + (int64_t)bh * p.sq;
  const float* deltag = p.delta + (int64_t)bh * p.sq;
  const int n_tiles = (p.sq + DKV_Q_TILE - 1) / DKV_Q_TILE;

  // per-query values of tile j into buffer `buf`; queries past sq get
  // lse = delta = 0 and the pad id (their P is masked, their dO is zero)
  auto stage_rows = [&](int j, int buf) {
    if (tid < DKV_Q_TILE) {
      const int row = j * DKV_Q_TILE + tid;
      const bool valid = row < p.sq;
      lse_s[buf * DKV_Q_TILE + tid] = valid ? lseg[row] * LOG2E : 0.f;
      delta_s[buf * DKV_Q_TILE + tid] = valid ? deltag[row] : 0.f;
      if (MASKED) q_id_s[buf * DKV_Q_TILE + tid] = segment_id(p.q_seg, b, p.sq, row);
    }
  };

  load_tile<OWN_ROWS, D>(k_s, kg, p.k_ss, n0, p.sk, tid);
  load_tile<OWN_ROWS, D>(v_s, vg, p.v_ss, n0, p.sk, tid);
  load_tile<DKV_Q_TILE, D>(q_s, qg, p.q_ss, 0, p.sq, tid);
  load_tile<DKV_Q_TILE, D>(do_s, dog, p.do_ss, 0, p.sq, tid);
  cp_async_commit();
  stage_rows(0, 0);

  // this thread's key rows and their segment ids
  const int rows[2] = {n0 + warp * 16 + g, n0 + warp * 16 + g + 8};
  int kv_ids[2] = {0, 0};
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < 2; ++i) kv_ids[i] = segment_id(p.kv_seg, b, p.sk, rows[i]);
  }

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const bf16* kw = k_s + warp * 16 * STRIDE;
  const bf16* vw = v_s + warp * 16 * STRIDE;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      const int next = (buf ^ 1) * S::TILE;
      load_tile<DKV_Q_TILE, D>(q_s + next, qg, p.q_ss, (j + 1) * DKV_Q_TILE, p.sq, tid);
      load_tile<DKV_Q_TILE, D>(do_s + next, dog, p.do_ss, (j + 1) * DKV_Q_TILE, p.sq, tid);
      cp_async_commit();
      stage_rows(j + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = q_s + buf * S::TILE;
    const bf16* dos = do_s + buf * S::TILE;
    const float* lse_t = lse_s + buf * DKV_Q_TILE;
    const float* delta_t = delta_s + buf * DKV_Q_TILE;
    const int* q_ids = q_id_s + buf * DKV_Q_TILE;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 32 queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a_k[4], a_v[4];
      load_a_frag<STRIDE>(a_k, kw, kk, g, t);
      load_a_frag<STRIDE>(a_v, vw, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b_q[2], b_do[2];
        load_b_frag<STRIDE>(b_q, qs, nt, kk, g, t);
        load_b_frag<STRIDE>(b_do, dos, nt, kk, g, t);
        mma_16816(s[nt], a_k, b_q);
        mma_16816(dp[nt], a_v, b_do);
      }
    }

    // P^T in s, dS^T = P^T (dP^T - delta) in dp; element e of tile nt is key
    // row rows[e >> 1], query column nt * 8 + 2t + (e & 1) of the tile
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float pr = exp2f(s[nt][e] * p.scale_log2 - lse_t[col]);
        if (MASKED && !attends(q_ids[col], kv_ids[e >> 1])) pr = 0.f;
        s[nt][e] = pr;
        dp[nt][e] = pr * (dp[nt][e] - delta_t[col]);
      }
    }

    // dV += bf16(P)^T dO and dK += bf16(dS)^T Q
#pragma unroll
    for (int kk = 0; kk < DKV_Q_TILE / 16; ++kk) {
      uint32_t a_p[4], a_ds[4];
      pack_a_frag(a_p, s, kk);
      pack_a_frag(a_ds, dp, kk);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t b_do[4], b_q[4];
        load_b_frag_trans<STRIDE>(b_do, dos, kk, dp2, lane);
        load_b_frag_trans<STRIDE>(b_q, qs, kk, dp2, lane);
        mma_16816(dv[2 * dp2], a_p, b_do);
        mma_16816(dv[2 * dp2 + 1], a_p, b_do + 2);
        mma_16816(dk[2 * dp2], a_ds, b_q);
        mma_16816(dk[2 * dp2 + 1], a_ds, b_q + 2);
      }
    }
    __syncthreads();  // everyone is done with `buf` before it is refilled
  }

  bf16* dkg = p.out0 + b * p.o0_sb + h * p.o0_sh;
  bf16* dvg = p.out1 + b * p.o1_sb + h * p.o1_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= p.sk) continue;
    bf16* krow = dkg + (int64_t)rows[i] * p.o0_ss + 2 * t;
    bf16* vrow = dvg + (int64_t)rows[i] * p.o1_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(krow + dt * 8) =
          pack_bf16(dk[dt][2 * i] * p.scale, dk[dt][2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(vrow + dt * 8) = pack_bf16(dv[dt][2 * i], dv[dt][2 * i + 1]);
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

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int batch_heads, int masked, cudaStream_t stream) {
  const int tiles = (p.sk + OWN_ROWS - 1) / OWN_ROWS;
  return masked ? launch(flash_bwd_dkv_kernel<D, true>, p, tiles, batch_heads, DkvSmem<D>::BYTES, stream)
                : launch(flash_bwd_dkv_kernel<D, false>, p, tiles, batch_heads, DkvSmem<D>::BYTES, stream);
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

extern "C" int st_flash_bwd_abi_version() { return 1; }

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

// dk (out0) = scale * dS^T Q, dv (out1) = P^T dO
extern "C" int st_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                     const void* lse, const void* delta, const void* q_seg,
                                     const void* kv_seg, void* dk, void* dv, const int64_t* strides,
                                     int batch, int heads, int sq, int sk, int head_dim,
                                     float sm_scale, int masked, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, lse, delta, q_seg, kv_seg, dk, dv, strides, heads,
                                  sq, sk, sm_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_dkv<32>(p, batch * heads, masked, s);
    case 64: return launch_dkv<64>(p, batch * heads, masked, s);
    case 128: return launch_dkv<128>(p, batch * heads, masked, s);
    default: return cudaErrorInvalidValue;
  }
}
