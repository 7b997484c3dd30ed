// The Hopper (sm_90a) helpers that the kernels built on wgmma, TMA and
// mbarriers share (csrc/conv_stage.cu, csrc/trunk.cu, csrc/swin_mlp.cu):
// the wgmma shared-memory matrix descriptor, mbarrier init/arrive/wait, the
// async proxy fence, the TMA window load and the 1-d bulk copy, the wgmma
// fence, commit and wait, the 256-thread consumer barrier, the accumulator
// fence and copy, and wgmma.mma_async m64nNk16 with bf16 B from shared
// memory (K-major, no-swizzle descriptors) and f32 accumulators, one
// specialisation per width N the kernels use: A from shared memory too, or
// from registers (`wgmma_bf16_ra`).
//
// Only make_desc and HOPPER_CONSUMERS are visible to a host compiler: a
// host build of a kernel supplies scalar stand-ins for the rest
// (tests/test_torch_conv_stage.py) before it includes the kernel.

#pragma once
#include <cstdint>

// A wgmma shared-memory matrix descriptor, no swizzle: start address,
// leading byte offset (between the two k8 core matrices of a k16 step)
// and stride byte offset (between 8-row groups), each >> 4.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFFu) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

// Threads of the two consumer warpgroups that consumer_sync() joins.
constexpr int HOPPER_CONSUMERS = 256;

#ifdef __CUDACC__
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}
// Generic-proxy writes to shared memory made visible to the async proxy
// (TMA and wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void tma_load_window(void* dst,
                                                const CUtensorMap* map,
                                                uint64_t* bar, int c0, int c1,
                                                int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// The 256 consumer threads only (the producer warp may have left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(HOPPER_CONSUMERS) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma fence, commit or wait.
template <int NI>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < NI / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The accumulators copied into other registers, for code that reads them
// on divergent paths (read there directly, ptxas inserts a warpgroup
// arrive on that path and serialises every wgmma: C7520).
template <int NI>
__device__ __forceinline__ void copy_acc(float* dst, const float* d) {
#pragma unroll
  for (int i = 0; i < NI / 2; ++i)
    asm volatile("mov.b32 %0, %1;" : "=f"(dst[i]) : "f"(d[i]));
}

template <int NI>
__device__ void wgmma_bf16(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<96>(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<192>(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

// The same product with A from registers (FlashAttention-3's way of
// feeding a product's own result back): a[0..3] hold the thread's 8 bf16
// values of the 64 x 16 A tile in the m64nNk16 register fragment, which is
// the f32 accumulator fragment of the 16 columns that make that k16 step,
// rounded and packed in pairs.  B is read from shared memory as above.
template <int NI>
__device__ void wgmma_bf16_ra(float* d, const uint32_t* a, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16_ra<32>(float* d, const uint32_t* a,
                                                  uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16_ra<64>(float* d, const uint32_t* a,
                                                  uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16_ra<96>(float* d, const uint32_t* a,
                                                  uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16_ra<128>(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#endif  // __CUDACC__
