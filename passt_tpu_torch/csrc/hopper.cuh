// Hopper (sm_90a) building blocks shared by the attention forward
// (attention_fwd.cu) and backward (attention_bwd.cu, attention_bwd_fp32.cu)
// kernels, the int8 GEMM (int8_gemm.cu), F1 and B2 (ln_qkv.cu) and the fused
// MLP (fused_mlp.cu): mbarriers (local, and arrivals from another CTA of a
// cluster), TMA tensor maps and copies (4-D and 2-D tile loads, 2-D
// stores, 1-D bulk, shared memory to another CTA's), the wgmma
// products with their descriptors (K-major and MN-major, one or several
// 64-wide MN blocks, 128-byte swizzle; 64-byte swizzle for D = 32 rows;
// bf16/fp16 products at N = 32, 64, 128, 192 and 256 with either B layout,
// F1's at N = 192 and 256 and the attention forward's at N = 64 and 128
// with A from registers, the D = 32 attention kernels' at N = 32, and the
// GEMM's s8 ones), fences, waits and named barriers, the
// acquire / release accesses of the backward's ordered dQ sums, the
// thread-block cluster's rank, barrier and distributed shared memory loads,
// and the launch configuration with a cluster or programmatic dependent
// launch. The tensor maps are encoded on the host with
// cuTensorMapEncodeTiled fetched from the CUDA driver at run time, so no
// library needs -lcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace passt_hopper {

using passt_attn::Strides;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Whether the phase of the given parity has completed (the thread may be
// suspended for a while inside the test).
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return done;
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    while (!mbar_try(bar, parity)) {
    }
}

__device__ __forceinline__ uint64_t global_ns() {
    uint64_t t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}

// A wait that depends on other blocks (or on work they gate) ends the kernel
// with an error (a trap: the launch's next synchronization fails) once it
// has waited this long, instead of hanging the card.
constexpr uint64_t WAIT_LIMIT_NS = 10000000000ull;  // 10 s

// mbar_wait that traps after WAIT_LIMIT_NS; the clock is read only once the
// first test has failed.
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity) {
    if (mbar_try(bar, parity)) return;
    const uint64_t t0 = global_ns();
    while (!mbar_try(bar, parity))
        if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// TMA: the box at coordinates (c0, c1, c2, c3) of the map into shared memory,
// completing its bytes on the barrier.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma descriptor of a tile of 128-byte rows in shared memory, 128-byte
// swizzle, 8-row groups 1024 bytes apart (the start must be 1024-aligned
// but for the k step's 32-byte offset inside the swizzle span).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma descriptor of a tile of 64-byte rows (D = 32 in bf16/fp16) in shared
// memory, 64-byte swizzle (layout type 2), 8-row groups 512 bytes apart (the
// start must be 512-aligned but for the k step's 32-byte offset inside a
// row). It serves K-major operands and MN-major ones one 32-wide block wide
// (the transposed flag set: rows along K, each holding the 32 values of M or
// N); an MN-major k step of 16 rows is 1024 bytes: + 64.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// An MN-major operand's 64-wide block: 64 rows of K, 128 bytes each.
constexpr int MN_BLOCK_BYTES = 64 * 128;

// wgmma descriptor of an MN-major operand several 64-wide blocks wide: each
// block is 64 rows of K of 128 bytes (128-byte swizzle), the blocks
// MN_BLOCK_BYTES apart (the leading byte offset), 8-row K groups 1024 bytes
// apart. A k step of 16 rows is 2048 bytes: + 128.
__device__ __forceinline__ uint64_t sw128_mn_blocks_desc(const void* p) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(MN_BLOCK_BYTES >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma descriptor of an MN-major operand (the transposed flag set): rows of
// 128 bytes along K, each holding the 64 values of the M (or N) dimension,
// with the 128-byte swizzle; 8-row K groups 1024 bytes apart (the stride
// byte offset). The leading byte offset would step between 64-wide M (or N)
// blocks; for an operand one block wide the bits are sw128_desc's (several
// blocks: sw128_mn_blocks_desc). A k step of 16 rows is 2048 bytes: + 128.
__device__ __forceinline__ uint64_t sw128_mn_desc(const void* p) { return sw128_desc(p); }

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most `pending` committed groups of this warpgroup are in flight.
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(pending) : "memory");
}

// Keep the compiler from moving work on these registers across a wgmma
// issue or wait: the products write and read them asynchronously.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The accumulator operands d[i .. i + 7] of an inline wgmma, with constraint K
// ("+f" for fp32, "+r" for s32), and the register lists that name them.
#define PASST_WG_ACC8(K, i) \
    K(d[i]), K(d[i + 1]), K(d[i + 2]), K(d[i + 3]), K(d[i + 4]), K(d[i + 5]), K(d[i + 6]), K(d[i + 7])
#define PASST_WG_ACC16(K) PASST_WG_ACC8(K, 0), PASST_WG_ACC8(K, 8)
#define PASST_WG_ACC32(K) PASST_WG_ACC8(K, 0), PASST_WG_ACC8(K, 8), PASST_WG_ACC8(K, 16), PASST_WG_ACC8(K, 24)
#define PASST_WG_ACC64(K) PASST_WG_ACC32(K), PASST_WG_ACC8(K, 32), PASST_WG_ACC8(K, 40), PASST_WG_ACC8(K, 48), \
    PASST_WG_ACC8(K, 56)
#define PASST_WG_ACC96(K) PASST_WG_ACC64(K), PASST_WG_ACC8(K, 64), PASST_WG_ACC8(K, 72), PASST_WG_ACC8(K, 80), \
    PASST_WG_ACC8(K, 88)
#define PASST_WG_ACC128(K) PASST_WG_ACC96(K), PASST_WG_ACC8(K, 96), PASST_WG_ACC8(K, 104), \
    PASST_WG_ACC8(K, 112), PASST_WG_ACC8(K, 120)
#define PASST_WG_OUT64 PASST_WG_ACC64("+f")
#define PASST_WG_OUT32 PASST_WG_ACC32("+f")

#define PASST_WG_R0_16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define PASST_WG_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define PASST_WG_R32 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define PASST_WG_R64 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define PASST_WG_R96 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define PASST_WG_REGS16 "{" PASST_WG_R0_16 "}"
#define PASST_WG_REGS32 "{" PASST_WG_R0 "}"
#define PASST_WG_REGS64 "{" PASST_WG_R0 ", " PASST_WG_R32 "}"
#define PASST_WG_REGS96 "{" PASST_WG_R0 ", " PASST_WG_R32 ", " PASST_WG_R64 "}"
#define PASST_WG_REGS128 "{" PASST_WG_R0 ", " PASST_WG_R32 ", " PASST_WG_R64 ", " PASST_WG_R96 "}"

// S (64 x 128, fp32) [+]= A (64 x 16, shared) . B (128 x 16, shared)^T, both
// K-major; and O (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared,
// N-major: the transposed-B flag).
#define PASST_WGMMA_SS_N128(TY)                                                                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                       \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " PASST_WG_REGS64       \
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                                   \
                 : PASST_WG_OUT64                                                                    \
                 : "l"(a), "l"(b), "r"(accumulate))
// D (64 x 64, fp32) [+]= A (64 x 16) . B (16 x 64), both from shared memory;
// TA and TB are the transposed flags ("1": the operand is MN-major).
#define PASST_WGMMA_SS_N64(TY, TA, TB)                                                              \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                       \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " PASST_WG_REGS32        \
                 ", %32, %33, p, 1, 1, " TA ", " TB ";\n}\n"                                        \
                 : PASST_WG_OUT32                                                                    \
                 : "l"(a), "l"(b), "r"(accumulate))
#define PASST_WGMMA_RS_N64(TY)                                                                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                       \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " PASST_WG_REGS32        \
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                     \
                 : PASST_WG_OUT32                                                                    \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))

template <typename T> struct Wgmma;
template <> struct Wgmma<__nv_bfloat16> {
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
        PASST_WGMMA_SS_N128("bf16");
    }
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
        PASST_WGMMA_RS_N64("bf16");
    }
    static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
        PASST_WGMMA_SS_N64("bf16", "0", "0");
    }
    static __device__ __forceinline__ void ss64_bmn(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
        PASST_WGMMA_SS_N64("bf16", "0", "1");
    }
};
template <> struct Wgmma<__half> {
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
        PASST_WGMMA_SS_N128("f16");
    }
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
        PASST_WGMMA_RS_N64("f16");
    }
    static __device__ __forceinline__ void ss64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
        PASST_WGMMA_SS_N64("f16", "0", "0");
    }
    static __device__ __forceinline__ void ss64_bmn(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
        PASST_WGMMA_SS_N64("f16", "0", "1");
    }
};

// D (64 x 32, fp32) [+]= A (64 x 16) . B (16 x 32, shared memory, MN-major:
// the transposed-B flag), T bf16 or fp16: the D = 32 attention kernels'
// products whose N is the head dim. ss_mn: A from shared memory, MN-major
// (the transposed-A flag); rs: A from registers (each warp's mma.sync
// m16n8k16 A fragment of its 16 rows of the 64).
#define PASST_WGMMA_N32_SS(TY)                                                                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                       \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " PASST_WG_REGS16        \
                 ", %16, %17, p, 1, 1, 1, 1;\n}\n"                                                   \
                 : PASST_WG_ACC16("+f")                                                              \
                 : "l"(a), "l"(b), "r"(accumulate))
#define PASST_WGMMA_N32_RS(TY)                                                                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                       \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " PASST_WG_REGS16        \
                 ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                     \
                 : PASST_WG_ACC16("+f")                                                              \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))

template <typename T> struct Wgmma32;
template <> struct Wgmma32<__nv_bfloat16> {
    static __device__ __forceinline__ void ss_mn(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
        PASST_WGMMA_N32_SS("bf16");
    }
    static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
        PASST_WGMMA_N32_RS("bf16");
    }
};
template <> struct Wgmma32<__half> {
    static __device__ __forceinline__ void ss_mn(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
        PASST_WGMMA_N32_SS("f16");
    }
    static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
        PASST_WGMMA_N32_RS("f16");
    }
};

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing its bytes on the barrier.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from this CTA's shared memory into the shared memory of a CTA of the
// cluster, completing its bytes on that CTA's barrier (dst and bar:
// addresses from map_rank).
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
    asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(dst), "r"(smem_u32(src)), "r"(bytes), "r"(bar) : "memory");
}

// Bulk copies from shared memory to device memory (`bytes` a multiple of 16,
// both ends 16-byte aligned), tracked as bulk groups of this thread: a plain
// store, and an element-wise fp32 add into what is there.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_reduce_add(float* dst, const float* src, uint32_t bytes) {
    asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
                 :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// Wait until this thread's committed bulk groups have read their sources
// (the shared memory may be reused) ...
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
// ... or have completed their writes.
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Order this thread's generic-proxy accesses of device memory with its
// async-proxy ones (bulk copies), both ways.
__device__ __forceinline__ void fence_proxy_async_global() {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operands, TMA stores) once a barrier has been passed.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ int ld_acquire_gpu(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release_gpu(int* p, int v) {
    asm volatile("st.release.gpu.global.s32 [%0], %1;\n" :: "l"(p), "r"(v) : "memory");
}

// ---- thread-block clusters ----

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
    return r;
}
// Every thread of every CTA of the cluster: arrive (release), then wait
// (acquire) for the others' arrivals of the same phase.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_sync() {
    cluster_arrive();
    cluster_wait();
}

// The address of this CTA's shared variable p in the shared memory of CTA
// `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
    return r;
}
__device__ __forceinline__ float2 ld_cluster(uint32_t addr) {
    float2 v;
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
    return v;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(addr)
                 : "memory");
    return v;
}

// Arrive (release at CTA scope: no data is handed over, only a slot) on an
// mbarrier of a CTA of the cluster (an address from map_rank).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" :: "r"(addr) : "memory");
}

// TMA: shared memory into the box at (c0, c1) of a 2-D map (the parts past
// the tensor's edges are not written), tracked as a bulk group of this
// thread (bulk_commit, bulk_wait_read, bulk_wait).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
    asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
                 :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
                 : "memory");
}

// ---- host side: launches ----

// A launch configuration with a cluster of `cluster` CTAs along x (0: no
// cluster attribute) and, if pdl, programmatic dependent launch behind the
// previous kernel.
struct Launch {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[2];
    Launch(int grid, int threads, size_t smem, cudaStream_t stream, int cluster, bool pdl) {
        cfg.gridDim = dim3(grid);
        cfg.blockDim = dim3(threads);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        int n = 0;
        if (cluster > 0) {
            attr[n].id = cudaLaunchAttributeClusterDimension;
            attr[n].val.clusterDim.x = cluster;
            attr[n].val.clusterDim.y = 1;
            attr[n].val.clusterDim.z = 1;
            ++n;
        }
        if (pdl) {
            attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
            attr[n].val.programmaticStreamSerializationAllowed = 1;
            ++n;
        }
        cfg.attrs = attr;
        cfg.numAttrs = n;
    }
};

// ---- host side: TMA tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A tensor map over the (d, N, H, B) view of a [B, N, H, d] operand with
// (batch, token, head) strides, for tiles of the head dim padded to dp (32,
// 64 or 128; 0: dp = d, which is then 32 or 64): boxes of `rows` tokens of
// one head by one swizzle atom of columns, 32 at dp = 32 (64-byte rows, the
// 64-byte swizzle) and 64 otherwise (128-byte rows, the 128-byte swizzle,
// which spans at most 64 bf16 columns; a dp = 128 tile takes two boxes, at
// columns 0 and 64, into two atoms). The box is zero-filled past N and past
// d, so columns d .. dp - 1 of a tile arrive as zeros; a box's bytes, its
// zeros included, complete its barrier.
inline bool make_map(CUtensorMap* map, const void* ptr, bool bf16, int batch, int n, int heads, Strides s,
                     int rows, int d = 64, int dp = 0) {
    if (dp == 0) dp = d;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr || (dp != 64 && dp != 32 && dp != 128) || d <= 0 || d > dp || d % 8) return false;
    const int atom = dp == 32 ? 32 : 64;
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)heads, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)s.n * 2, (cuuint64_t)s.h * 2, (cuuint64_t)s.b * 2};
    const cuuint32_t box[4] = {(cuuint32_t)atom, (cuuint32_t)rows, 1, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
                  const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  atom == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// TMA: the box at coordinates (c0, c1) of a 2-D map into shared memory,
// completing its bytes on the barrier.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}

// D (64 x N, fp32) [+]= A (64 x 16) . B (16 x N), both from shared memory
// (128-byte swizzle), T bf16 or fp16; A K-major, B K-major (TB = 0) or
// MN-major (TB = 1, the transposed-B flag). NR = N / 2 accumulators a
// thread; IA, IB, IP and ITB number the operands after them (the two
// descriptors, the accumulate flag, TB).
template <typename T, int N, int TB> struct WgmmaF32;
#define PASST_WGMMA_F32(CT, TY, NN, NR, IA, IB, IP, ITB)                                                  \
    template <int TB> struct WgmmaF32<CT, NN, TB> {                                                       \
        static __device__ __forceinline__ void mma(float (&d)[NR], uint64_t a, uint64_t b, int accumulate) { \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                  \
                         "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32." TY "." TY " " PASST_WG_REGS##NR  \
                         ", %" IA ", %" IB ", p, 1, 1, 0, %" ITB ";\n}\n"                                      \
                         : PASST_WG_ACC##NR("+f")                                                         \
                         : "l"(a), "l"(b), "r"(accumulate), "n"(TB));                                       \
        }                                                                                                 \
    };
PASST_WGMMA_F32(__nv_bfloat16, "bf16", 64, 32, "32", "33", "34", "35")
PASST_WGMMA_F32(__nv_bfloat16, "bf16", 128, 64, "64", "65", "66", "67")
PASST_WGMMA_F32(__nv_bfloat16, "bf16", 192, 96, "96", "97", "98", "99")
PASST_WGMMA_F32(__nv_bfloat16, "bf16", 256, 128, "128", "129", "130", "131")
PASST_WGMMA_F32(__half, "f16", 128, 64, "64", "65", "66", "67")
PASST_WGMMA_F32(__half, "f16", 192, 96, "96", "97", "98", "99")
PASST_WGMMA_F32(__half, "f16", 256, 128, "128", "129", "130", "131")

// D (64 x N, fp32) [+]= A (64 x 16, registers) . B (16 x N, shared memory,
// K-major, 128-byte swizzle), T bf16 or fp16 (F1's products). A is each
// warp's mma.sync m16n8k16 A fragment of its 16 rows of the 64. NR = N / 2
// accumulators a thread; IA0-IA3, IB and IP number the operands after
// them (A's four registers, B's descriptor, the accumulate flag).
template <typename T, int N> struct WgmmaRsF32;
#define PASST_WGMMA_RS_F32(CT, TY, NN, NR, IA0, IA1, IA2, IA3, IB, IP)                                     \
    template <> struct WgmmaRsF32<CT, NN> {                                                                \
        static __device__ __forceinline__ void mma(float (&d)[NR], const uint32_t (&a)[4], uint64_t b,       \
                                                   int accumulate) {                                       \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                   \
                         "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32." TY "." TY " " PASST_WG_REGS##NR   \
                         ", {%" IA0 ", %" IA1 ", %" IA2 ", %" IA3 "}, %" IB ", p, 1, 1, 0;\n}\n"              \
                         : PASST_WG_ACC##NR("+f")                                                          \
                         : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));           \
        }                                                                                                  \
    };
PASST_WGMMA_RS_F32(__nv_bfloat16, "bf16", 64, 32, "32", "33", "34", "35", "36", "37")
PASST_WGMMA_RS_F32(__half, "f16", 64, 32, "32", "33", "34", "35", "36", "37")
PASST_WGMMA_RS_F32(__nv_bfloat16, "bf16", 192, 96, "96", "97", "98", "99", "100", "101")
PASST_WGMMA_RS_F32(__nv_bfloat16, "bf16", 256, 128, "128", "129", "130", "131", "132", "133")
PASST_WGMMA_RS_F32(__half, "f16", 192, 96, "96", "97", "98", "99", "100", "101")
PASST_WGMMA_RS_F32(__half, "f16", 256, 128, "128", "129", "130", "131", "132", "133")

// D (64 x N, fp32) += A (64 x 16, registers) . B (16 x N, shared memory,
// MN-major: the transposed-B flag; several 64-wide N blocks as
// sw128_mn_blocks_desc describes them), T bf16 or fp16: the attention
// forward's O += P V at the padded head dim DP = 128.
template <typename T, int N> struct WgmmaRsMn;
#define PASST_WGMMA_RS_MN(CT, TY, NN, NR, IA0, IA1, IA2, IA3, IB, IP)                                     \
    template <> struct WgmmaRsMn<CT, NN> {                                                                \
        static __device__ __forceinline__ void mma(float (&d)[NR], const uint32_t (&a)[4], uint64_t b) {   \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                  \
                         "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32." TY "." TY " " PASST_WG_REGS##NR  \
                         ", {%" IA0 ", %" IA1 ", %" IA2 ", %" IA3 "}, %" IB ", p, 1, 1, 1;\n}\n"              \
                         : PASST_WG_ACC##NR("+f")                                                         \
                         : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                   \
        }                                                                                                 \
    };
PASST_WGMMA_RS_MN(__nv_bfloat16, "bf16", 128, 64, "64", "65", "66", "67", "68", "69")
PASST_WGMMA_RS_MN(__half, "f16", 128, 64, "64", "65", "66", "67", "68", "69")

// D (64 x N, fp32) [+]= A (64 x 16) . B (16 x N), both from shared memory,
// T bf16 or fp16, N = 32 or 64; TA and TB the transposed flags (1: the
// operand is MN-major): the attention backward's kernel KV at every padded
// head dim.
template <typename T, int N, int TA, int TB> struct WgmmaSs;
#define PASST_WGMMA_SS(CT, TY, NN, NR, IA, IB, IP, ITA, ITB)                                               \
    template <int TA, int TB> struct WgmmaSs<CT, NN, TA, TB> {                                            \
        static __device__ __forceinline__ void mma(float (&d)[NR], uint64_t a, uint64_t b, int accumulate) { \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                  \
                         "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32." TY "." TY " " PASST_WG_REGS##NR  \
                         ", %" IA ", %" IB ", p, 1, 1, %" ITA ", %" ITB ";\n}\n"                              \
                         : PASST_WG_ACC##NR("+f")                                                         \
                         : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));                              \
        }                                                                                                 \
    };
PASST_WGMMA_SS(__nv_bfloat16, "bf16", 32, 16, "16", "17", "18", "19", "20")
PASST_WGMMA_SS(__nv_bfloat16, "bf16", 64, 32, "32", "33", "34", "35", "36")
PASST_WGMMA_SS(__half, "f16", 32, 16, "16", "17", "18", "19", "20")
PASST_WGMMA_SS(__half, "f16", 64, 32, "32", "33", "34", "35", "36")

// The GEMM's products: D (64 x N) [+]= A (64 x 32 bytes) . B (N x 32 bytes)^T,
// both K-major from shared memory (128-byte swizzle); int: s8 x s8 -> s32
// (k32), float: bf16 x bf16 -> f32 (k16, WgmmaF32). 8-bit wgmma takes only
// K-major operands. Accumulator element 4 j + e of a thread in warp w of the
// warpgroup is row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2.
template <typename Acc, int N> struct WgmmaGemm;
template <int N> struct WgmmaGemm<float, N> : WgmmaF32<__nv_bfloat16, N, 0> {};
#define PASST_WGMMA_S32(NN, NR, IA, IB, IP)                                                               \
    template <> struct WgmmaGemm<int, NN> {                                                               \
        static __device__ __forceinline__ void mma(int (&d)[NR], uint64_t a, uint64_t b, int accumulate) {   \
            asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                                  \
                         "wgmma.mma_async.sync.aligned.m64n" #NN "k32.s32.s8.s8 " PASST_WG_REGS##NR          \
                         ", %" IA ", %" IB ", p;\n}\n"                                                       \
                         : PASST_WG_ACC##NR("+r")                                                         \
                         : "l"(a), "l"(b), "r"(accumulate));                                                \
        }                                                                                                 \
    };
PASST_WGMMA_S32(128, 64, "64", "65", "66")
PASST_WGMMA_S32(192, 96, "96", "97", "98")
PASST_WGMMA_S32(256, 128, "128", "129", "130")

// A 2-D tensor map over a row-major [rows, cols] operand (row pitch
// `pitch` bytes, a multiple of 16) of 1-byte (int8) or 2-byte (bf16)
// elements; boxes of 128 bytes of a row by `box_rows` rows, 128-byte
// swizzle, zero fill past the edges.
inline bool make_map_2d(CUtensorMap* map, const void* ptr, bool bf16, long long rows, long long cols,
                        long long pitch, int box_rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)pitch};
    const cuuint32_t box[2] = {bf16 ? 64u : 128u, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                  const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace passt_hopper
