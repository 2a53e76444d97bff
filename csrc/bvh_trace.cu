// One-thread-per-ray BVH traversal for NVIDIA GPUs (sm_90a), called from
// JAX through the XLA FFI. Python side: cse168_raytracer/ops/cuda_bvh.py.
//
// Tree: the binned-SAH binary tree of csrc/bvh_builder.cpp, relaid out by
// ops/cuda_bvh.py:
//
//   nodes (Nn, 16) int32, one 64-byte row per internal node:
//     [loL(3) hiL(3) loR(3) hiR(3) linkL linkR 0 0]
//     the boxes are float32 bit patterns; a link >= 0 is an internal
//     node row, < 0 a leaf with ~link = (first_tri << 6) | tri_count.
//     Boxes bound each triangle's acceptance band (beta, gamma may reach
//     -eps), not only its vertices: ops/intersect.accept_bounds.
//   tris (T, 20) f32, one row per triangle in leaf order: the Pluecker
//     operands of models/geometry.plucker_operands,
//     [beta(6) gamma(6) den(3) tnum(4) 0].
//   rays (8, N) f32 structure-of-arrays: ox oy oz dx dy dz tmin tmax.
//
// Each thread walks its own ray with a private stack, visiting the near
// child first and skipping entries whose entry distance lies past the
// best hit so far. Acceptance is ops/intersect.py's rule in float32:
//   beta >= -eps, gamma >= -eps, beta + gamma <= 1 + eps,
//   tmin <= t <= tmax, |den| >= den_tiny.
// The slab test is ops/accel.py `_slab`, including its NaN rule (an axis
// whose slab distance is NaN never culls).
//
// Outputs per ray: t (big on a miss), triangle row (0 on a miss), and
// two counters: ray-box tests (2 per internal node visited) and
// ray-triangle tests (every triangle of every leaf visited).
//
// The handler only enqueues the kernel on XLA's stream: it does not
// synchronise and does not allocate.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kLeafShift = 6;  // must match ops/cuda_bvh.LEAF_SHIFT
constexpr int kStack = 64;     // must match ops/cuda_bvh.MAX_STACK
constexpr int kMaxBlock = 256;

struct Ray {
  float ox, oy, oz, dx, dy, dz, rx, ry, rz, mx, my, mz, tmin, tmax;
};

__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly,
                                     float lz, float hx, float hy, float hz,
                                     float tmax, float* enter_out) {
  float tn = -INFINITY, tf = INFINITY;
  auto axis = [&](float lo, float hi, float o, float rcp) {
    float t0 = (lo - o) * rcp;
    float t1 = (hi - o) * rcp;
    if (isnan(t0) || isnan(t1)) return;  // jnp.minimum/maximum -> NaN -> pass
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  };
  axis(lx, hx, r.ox, r.rx);
  axis(ly, hy, r.oy, r.ry);
  axis(lz, hz, r.oz, r.rz);
  float enter = fmaxf(tn, r.tmin);
  float exit_ = fminf(tf, tmax);
  *enter_out = enter;
  return enter <= exit_;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kMaxBlock)
trace_kernel(const float* __restrict__ rays, int n,
             const float4* __restrict__ nodes,
             const float4* __restrict__ tris, float eps, float den_tiny,
             float big, float* __restrict__ t_out,
             int32_t* __restrict__ id_out, int32_t* __restrict__ box_out,
             int32_t* __restrict__ tri_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = rays[i];
  r.oy = rays[n + i];
  r.oz = rays[2 * n + i];
  r.dx = rays[3 * n + i];
  r.dy = rays[4 * n + i];
  r.dz = rays[5 * n + i];
  r.tmin = rays[6 * n + i];
  r.tmax = rays[7 * n + i];
  r.rx = 1.0f / r.dx;
  r.ry = 1.0f / r.dy;
  r.rz = 1.0f / r.dz;
  // moment m = cross(o, d)
  r.mx = r.oy * r.dz - r.oz * r.dy;
  r.my = r.oz * r.dx - r.ox * r.dz;
  r.mz = r.ox * r.dy - r.oy * r.dx;

  float best_t = big;
  int32_t best_id = 0;
  int32_t n_box = 0, n_tri = 0;

  int32_t stack_link[kStack];
  float stack_t[kStack];
  int sp = 0;
  int32_t link = 0;  // the root is internal node 0
  bool live = r.tmax >= r.tmin;  // empty intervals never traverse

  while (live) {
    if (link >= 0) {
      const float4* nd = nodes + 4 * link;
      const float4 a = __ldg(nd), b = __ldg(nd + 1), c = __ldg(nd + 2),
                   e = __ldg(nd + 3);
      const float cur = fminf(r.tmax, best_t);
      float tl, tr;
      const bool hl = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, cur, &tl);
      const bool hr = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, cur, &tr);
      n_box += 2;
      const int32_t ll = __float_as_int(e.x), lr = __float_as_int(e.y);
      if (hl && hr) {
        const bool l_near = tl <= tr;
        stack_link[sp] = l_near ? lr : ll;
        stack_t[sp] = l_near ? tr : tl;
        ++sp;
        link = l_near ? ll : lr;
        continue;
      }
      if (hl || hr) {
        link = hl ? ll : lr;
        continue;
      }
    } else {
      const uint32_t v = static_cast<uint32_t>(~link);
      const int first = static_cast<int>(v >> kLeafShift);
      const int count = static_cast<int>(v & ((1u << kLeafShift) - 1));
      n_tri += count;
      bool occluded = false;
      for (int j = first; j < first + count; ++j) {
        const float4* tp = tris + 5 * j;
        const float4 p0 = __ldg(tp), p1 = __ldg(tp + 1), p2 = __ldg(tp + 2),
                     p3 = __ldg(tp + 3), p4 = __ldg(tp + 4);
        // r6 = [d, m] against the beta/gamma/den columns, r4 = [o, 1]
        const float nb = r.dx * p0.x + r.dy * p0.y + r.dz * p0.z +
                         r.mx * p0.w + r.my * p1.x + r.mz * p1.y;
        const float ng = r.dx * p1.z + r.dy * p1.w + r.dz * p2.x +
                         r.mx * p2.y + r.my * p2.z + r.mz * p2.w;
        const float den = r.dx * p3.x + r.dy * p3.y + r.dz * p3.z;
        const float tn = r.ox * p3.w + r.oy * p4.x + r.oz * p4.y + p4.z;
        const bool den_ok = fabsf(den) >= den_tiny;
        const float inv = 1.0f / (den_ok ? den : 1.0f);
        const float beta = nb * inv, gamma = ng * inv, t = tn * inv;
        const bool ok = den_ok && beta >= -eps && gamma >= -eps &&
                        beta + gamma <= 1.0f + eps && t >= r.tmin &&
                        t <= r.tmax && t < best_t;
        if (ok) {
          best_t = t;
          best_id = j;
          if (kAnyHit) {
            occluded = true;
            break;
          }
        }
      }
      if (kAnyHit && occluded) break;
    }
    // pop the nearest pending subtree that can still beat best_t
    bool found = false;
    while (sp > 0) {
      --sp;
      if (stack_t[sp] <= fminf(r.tmax, best_t)) {
        link = stack_link[sp];
        found = true;
        break;
      }
    }
    if (!found) break;
  }
  t_out[i] = best_t;
  id_out[i] = best_id;
  box_out[i] = n_box;
  tri_out[i] = n_tri;
}

ffi::Error BvhTraceImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> rays,
                        ffi::Buffer<ffi::S32> nodes,
                        ffi::Buffer<ffi::F32> tris,
                        ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::S32> id_out,
                        ffi::ResultBuffer<ffi::S32> box_out,
                        ffi::ResultBuffer<ffi::S32> tri_out, int32_t any_hit,
                        int32_t block, float eps, float den_tiny, float big) {
  auto rdims = rays.dimensions();
  if (rdims.size() != 2 || rdims[0] != 8) {
    return ffi::Error::InvalidArgument("rays must be (8, N)");
  }
  const int64_t n = rdims[1];
  if (block <= 0 || block > kMaxBlock || n % block != 0) {
    return ffi::Error::InvalidArgument(
        "ray count must be a multiple of the block size (<= 256)");
  }
  if (nodes.dimensions().back() != 16 || tris.dimensions().back() != 20) {
    return ffi::Error::InvalidArgument("nodes must be (Nn, 16), tris (T, 20)");
  }
  if (n == 0) return ffi::Error::Success();
  const int grid = static_cast<int>(n / block);
  auto* nd = reinterpret_cast<const float4*>(nodes.typed_data());
  auto* tr = reinterpret_cast<const float4*>(tris.typed_data());
  auto kernel = any_hit ? trace_kernel<true> : trace_kernel<false>;
  kernel<<<grid, block, 0, stream>>>(
      rays.typed_data(), static_cast<int>(n), nd, tr, eps, den_tiny, big,
      t_out->typed_data(), id_out->typed_data(), box_out->typed_data(),
      tri_out->typed_data());
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(BvhTrace, BvhTraceImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rays
                                  .Arg<ffi::Buffer<ffi::S32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tris
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri row
                                  .Ret<ffi::Buffer<ffi::S32>>()  // box tests
                                  .Ret<ffi::Buffer<ffi::S32>>()  // tri tests
                                  .Attr<int32_t>("any_hit")
                                  .Attr<int32_t>("block")
                                  .Attr<float>("eps")
                                  .Attr<float>("den_tiny")
                                  .Attr<float>("big"));
