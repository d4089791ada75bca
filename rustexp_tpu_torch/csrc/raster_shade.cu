// The raster frame's shading and pack in one kernel, for Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package shades with plain jnp ops,
// and so did the port, as some 240 eager launches a frame. This kernel
// takes a raster kernel's attribute planes and writes the finished packed
// frame in one launch. Python wrapper: rustexp_tpu_torch/raster/shade.py::
// shade_pack_cuda; its plain PyTorch version, shade_pack_plain, sits
// beside it and is the chain this kernel repeats op for op.
//
// What it computes, for each pixel it walks: wr = 1 / lin[0], the colour
// lin[1:4] * wr; per pixel, the world position (unprojected from the
// pixel's (x, y, z) and wr through the inverse of the world-to-viewport
// chain, or lin[4:7] * wr) and the normal (lin[4:7] or lin[7:10], times
// wr), then the shader raster/shaders.py names by its index; the 11-bit
// gamma pack of core/colors.py (pack_abgr32_gamma_arith, with the
// reference's quirk that blue's negative test reads the red index); and
// the packed word where the coverage mask is set, else the background's.
// The pixels walked are either the whole frame or the blocks a rows list
// names (block_w pixels of one row each; entries >= h * (w / block_w) are
// padding and skipped). A rows list's planes are read from the full
// [h, w] outputs or, compact, from [n_rows, block_w] planes already
// gathered to the list; outside its blocks the frame is the background.
//
// The eye enters by value, and the ray matrix is formed from it in the
// kernel with inv_world_to_vp's operations in its order (the two constant
// matrices that depend only on the frame's size come by value too), so a
// frame's shade costs the host one launch and no copy.
//
// Bound. Bytes: the mask of each pixel walked; the planes, and z where
// rays are unprojected, of each covered pixel; the background where a
// pixel is not covered, and the frame written once (with a rows list, the
// background's copy and the covered words). At 512x512 that is 10.6 MB on
// a whole frame of 10 planes with 86% covered and 11.8 MB on a rows list
// of 7 planes and z with nearly all covered: ~3.2 and ~3.5 us at
// 3.35 TB/s. The cube-map set (1.5 MB) stays in L2. One thread a pixel,
// neighbouring threads on neighbouring words, so every plane is read in
// whole sectors.
//
// One kernel for every shader and mode: the shader index and the flags
// are arguments, the same for every thread of a launch, so nothing
// diverges. Specialising on them at compile time (66 kernels) runs
// 0.6-0.9 us a launch faster on an H100 at both bench scenes' shapes but
// takes 5.5 s more of nvcc at a checkout's first build, and the frame's
// time is the host's.
//
// Rounding. Built with -fmad=false, and every product, sum, quotient and
// root is spelled __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn, so
// each op rounds once to nearest as in the plain chain (no FMA, no
// reciprocal square root); float-to-int conversions saturate with NaN to
// 0, as core/colors.py's trunc_i32.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int MAX_PLANES = 10;
constexpr int THREADS = 128;
constexpr int CM_W = 64;                         // texels along a face
constexpr int CM_POWER = 6 * CM_W * CM_W * 3;    // floats of one power
constexpr int COS_0 = 0, COS_1 = 1, COS_8 = 2, COS_64 = 3, COS_512 = 4;

// Mirrors raster/shade.py's _ShadeArgs field for field.
struct ShadeArgs {
  const uint8_t* mask;   // bool coverage
  const float* z;        // depth, read when rays are unprojected
  const float* planes[MAX_PLANES];
  const int32_t* bg;     // [h, w] background words
  const int32_t* rows;   // [n_rows] block ids, or null: the whole frame
  const int32_t* y_rows; // [h] global row of each local row, or null
  const float* cm;       // [5, 6, 64, 64, 3] cube-map set
  const int32_t* curve;  // [2048] gamma curve
  int32_t* out;          // [h, w] packed frame
  int h, w, block_w, n_rows, compact, y0;
  float eye[3];
  float inv_persp[16];   // row-major 4x4
  float inv_vpm[16];
};

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }

// A Python float scalar operand: torch rounds the double to f32.
#define F32(x) static_cast<float>(x)

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {fa(a.x, b.x), fa(a.y, b.y), fa(a.z, b.z)};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {fs(a.x, b.x), fs(a.y, b.y), fs(a.z, b.z)};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {fm(a.x, b.x), fm(a.y, b.y), fm(a.z, b.z)};
}
__device__ __forceinline__ V3 muls(V3 a, float s) {
  return {fm(a.x, s), fm(a.y, s), fm(a.z, s)};
}
__device__ __forceinline__ V3 adds(V3 a, float s) {
  return {fa(a.x, s), fa(a.y, s), fa(a.z, s)};
}
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }

// shaders._dot: (x*x' + y*y') + z*z'.
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return fa(fa(fm(a.x, b.x), fm(a.y, b.y)), fm(a.z, b.z));
}

// shaders.normalize: v / sqrt(dot), the division form.
__device__ __forceinline__ V3 normalize(V3 v) {
  const float s = __fsqrt_rn(dot(v, v));
  return {fd(v.x, s), fd(v.y, s), fd(v.z, s)};
}

// shaders.fast_normalize: v * (1 / sqrt(dot)).
__device__ __forceinline__ V3 fast_normalize(V3 v) {
  return muls(v, fd(1.0f, __fsqrt_rn(dot(v, v))));
}

// shaders.reflect: i - n * (dot(n, i) * 2).
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
  return sub(i, muls(n, fm(dot(n, i), 2.0f)));
}

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// torch.clamp: NaN passes through.
__device__ __forceinline__ float clamp01(float v) {
  return is_nan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// core.colors.trunc_i32: truncate toward zero, saturate, NaN -> 0.
__device__ __forceinline__ int trunc_i32(float x) {
  if (is_nan(x)) return 0;
  if (x >= 2147483648.0f) return INT_MAX;
  if (x <= -2147483648.0f) return INT_MIN;
  return static_cast<int>(x);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// core.colors.fast_unit_pow16_arith: the LUT's semantics by four squarings.
__device__ __forceinline__ float pow16(float v) {
  const int idx = trunc_i32(fs(fm(v, 855.0f), 600.0f));
  const float x = fm(fa(static_cast<float>(clampi(idx, 0, 255)), 600.0f),
                     F32(1.0 / 855.0));
  const float x2 = fm(x, x), x4 = fm(x2, x2), x8 = fm(x4, x4);
  const float val = fm(x8, x8);
  return idx < 0 ? 0.0f : (idx > 255 ? 1.0f : val);
}

// shaders.cm_texel_from_dir and _texel_flat: the major-axis texel's flat
// index into one power's [6 * 64 * 64] texels.
__device__ __forceinline__ int cm_texel(V3 d) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  const bool x_major = (ax > ay) && (ax > az);
  const bool y_major = (ay > ax) && (ay > az);
  const int face = x_major ? (d.x > 0.0f ? 0 : 1)
                           : (y_major ? (d.y > 0.0f ? 2 : 3)
                                      : (d.z > 0.0f ? 4 : 5));
  const float major = x_major ? ax : (y_major ? ay : az);
  const float lo = F32(1e-30);
  const float inv = fd(1.0f, is_nan(major) ? major : fmaxf(major, lo));
  float u = fm(x_major ? d.z : d.x, inv);
  float v = fm(x_major ? d.y : (y_major ? d.z : d.y), inv);
  u = fm(fa(u, 1.0f), 0.5f);
  v = fm(fa(v, 1.0f), 0.5f);
  const int tx = clampi(trunc_i32(fm(u, static_cast<float>(CM_W))), 0,
                        CM_W - 1);
  const int ty = clampi(trunc_i32(fm(v, static_cast<float>(CM_W))), 0,
                        CM_W - 1);
  return (face * CM_W + ty) * CM_W + tx;
}

__device__ __forceinline__ V3 texel(const float* __restrict__ cm, int power,
                                    int flat) {
  const float* t = cm + power * CM_POWER + flat * 3;
  return {__ldg(t), __ldg(t + 1), __ldg(t + 2)};
}

__device__ __forceinline__ V3 lookup_dir(const float* __restrict__ cm,
                                         int power, V3 d) {
  return texel(cm, power, cm_texel(d));
}

// shaders.fresnel_conductor(cosi, 1.0, 1.1): eta * eta + k * k is a
// Python float, rounded to f32 where it meets a tensor.
__device__ __forceinline__ float fresnel(float cosi) {
  const float k2 = F32(1.0 * 1.0 + 1.1 * 1.1);
  const float tmp = fm(fm(k2, cosi), cosi);
  const float x = fm(2.0f, cosi);
  const float r_par2 = fd(fa(fs(tmp, x), 1.0f), fa(fa(tmp, x), 1.0f));
  const float cc = fm(cosi, cosi);
  const float r_per2 = fd(fa(fs(k2, x), cc), fa(fa(k2, x), cc));
  return fm(fa(r_par2, r_per2), 0.5f);
}

// shaders.normalize_phong_lobe of 8, 64 and 512.
constexpr float LOBE8 = 5.0f, LOBE64 = 33.0f, LOBE512 = 257.0f;

// The shader raster/shaders.py's SHADER_TABLE holds at index S, op for op.
template <int S>
__device__ __forceinline__ V3 shade(V3 p, V3 n, V3 col, V3 eye,
                                    const float* __restrict__ cm) {
  if constexpr (S == 0) {  // BakedColor
    return col;
  } else if constexpr (S == 1) {  // Normals
    return muls(adds(normalize(n), 1.0f), 0.5f);
  } else if constexpr (S == 2) {  // Headlight
    const V3 nn = fast_normalize(n);
    const V3 l = fast_normalize(sub(eye, p));
    return muls(mul(col, col), clamp01(dot(l, nn)));
  } else if constexpr (S == 3) {  // Plastic2xDirLight
    const V3 nn = fast_normalize(n);
    const V3 r = fast_normalize(reflect(sub(p, eye), nn));
    const float c = F32(0.577350269);
    const V3 l = v3(c, c, c);
    auto one_light = [&](V3 lv) {
      const float ldotn = clamp01(dot(lv, nn));
      const float ldotr = pow16(clamp01(dot(lv, r)));
      return fa(fm(ldotn, 0.25f), fm(ldotr, 0.75f));
    };
    const float o1 = one_light(l), o2 = one_light(neg(l));
    const V3 light = add(add(muls(v3(1.0f, 0.5f, 0.5f), o1),
                             muls(v3(0.5f, 0.5f, 1.0f), o2)),
                         v3(F32(0.05), F32(0.05), F32(0.05)));
    return mul(light, mul(col, col));
  } else if constexpr (S == 4) {  // CMDiffuse
    return mul(lookup_dir(cm, COS_1, fast_normalize(n)), mul(col, col));
  } else if constexpr (S == 5) {  // CMRefl
    const V3 nn = fast_normalize(n);
    const int rt = cm_texel(reflect(sub(p, eye), nn));
    const V3 c8 = texel(cm, COS_8, rt), c64 = texel(cm, COS_64, rt);
    return mul(add(add(lookup_dir(cm, COS_1, nn), muls(c8, LOBE8)),
                   muls(c64, LOBE64)),
               mul(col, col));
  } else if constexpr (S == 6) {  // CMCoated
    const V3 nn = fast_normalize(n);
    const V3 eyev = sub(p, eye);
    const int rt = cm_texel(reflect(eyev, nn));
    const float fres = fresnel(dot(neg(eyev), nn));
    const V3 c8 = texel(cm, COS_8, rt), c512 = texel(cm, COS_512, rt);
    return mul(add(add(muls(lookup_dir(cm, COS_1, nn), F32(0.85)),
                       muls(muls(c8, LOBE8), fres)),
                   muls(muls(muls(c512, LOBE512), fres), 1.5f)),
               mul(col, col));
  } else if constexpr (S == 7) {  // CMDiffRim
    const V3 nn = fast_normalize(n);
    const float fres = fresnel(dot(neg(sub(p, eye)), nn));
    return mul(adds(lookup_dir(cm, COS_1, nn), fm(fres, 0.75f)), col);
  } else if constexpr (S == 8) {  // CMGlossy
    const V3 nn = fast_normalize(n);
    const V3 r = reflect(sub(p, eye), nn);
    return mul(add(lookup_dir(cm, COS_1, nn),
                   muls(lookup_dir(cm, COS_8, r), LOBE8)),
               mul(col, col));
  } else if constexpr (S == 9) {  // CMGreenHighlight
    const V3 nn = fast_normalize(n);
    const V3 r = reflect(sub(p, eye), nn);
    return mul(add(lookup_dir(cm, COS_1, nn),
                   mul(muls(lookup_dir(cm, COS_64, r), LOBE64),
                       v3(F32(0.2), F32(0.8), F32(0.2)))),
               mul(col, col));
  } else if constexpr (S == 10) {  // CMRedMaterial
    const V3 nn = fast_normalize(n);
    const V3 r = reflect(sub(p, eye), nn);
    return mul(add(mul(lookup_dir(cm, COS_1, nn),
                       v3(F32(0.8), F32(0.2), F32(0.2))),
                   muls(lookup_dir(cm, COS_512, r), LOBE512)),
               mul(col, col));
  } else if constexpr (S == 11) {  // CMMetallic
    const V3 nn = fast_normalize(n);
    const int rt = cm_texel(reflect(sub(p, eye), nn));
    return mul(add(muls(texel(cm, COS_8, rt), LOBE8),
                   muls(texel(cm, COS_64, rt), LOBE64)),
               col);
  } else if constexpr (S == 12) {  // CMSuperShiny
    const V3 nn = fast_normalize(n);
    const int rt = cm_texel(reflect(sub(p, eye), nn));
    return mul(add(add(muls(texel(cm, COS_64, rt), LOBE64),
                       muls(texel(cm, COS_512, rt), LOBE512)),
                   texel(cm, COS_0, rt)),
               col);
  } else if constexpr (S == 13) {  // CMGold
    const V3 nn = fast_normalize(n);
    const V3 l = fast_normalize(sub(eye, p));
    const float ldotn = clamp01(dot(l, nn));
    const int rt = cm_texel(reflect(sub(p, eye), nn));
    const V3 c8 = texel(cm, COS_8, rt), c512 = texel(cm, COS_512, rt);
    return mul(mul(add(add(muls(lookup_dir(cm, COS_1, nn), ldotn),
                           muls(c8, LOBE8)),
                       muls(muls(c512, LOBE512), fs(1.0f, ldotn))),
                   v3(1.0f, F32(0.76), F32(0.33))),
               mul(col, col));
  } else if constexpr (S == 14) {  // CMBlue
    const V3 nn = fast_normalize(n);
    const V3 l = fast_normalize(sub(eye, p));
    const float ldotn = clamp01(dot(l, nn));
    const int rt = cm_texel(reflect(sub(p, eye), nn));
    const V3 c64 = texel(cm, COS_64, rt), c512 = texel(cm, COS_512, rt);
    return mul(add(add(muls(mul(lookup_dir(cm, COS_1, nn),
                                v3(F32(0.2), F32(0.2), F32(0.8))),
                            ldotn),
                       muls(muls(c64, LOBE64), 0.75f)),
                   muls(muls(c512, LOBE512), fs(1.0f, ldotn))),
               mul(col, col));
  } else {  // 15, CMBlinnSchlick
    static_assert(S == 15, "16 shaders");
    const V3 nn = fast_normalize(n);
    const V3 eyev = sub(p, eye);
    const V3 r = reflect(eyev, nn);
    const V3 nr = add(nn, r);
    const V3 h = muls(nr, fd(1.0f, __fsqrt_rn(dot(nr, nr))));
    float w = fs(1.0f, clamp01(dot(h, eyev)));
    w = fm(w, w);
    return mul(add(muls(mul(lookup_dir(cm, COS_1, nn),
                            v3(F32(0.8), F32(0.65), 1.0f)),
                        w),
                   muls(muls(lookup_dir(cm, COS_64, h), LOBE64),
                        fs(1.25f, w))),
               mul(col, col));
  }
}

// core.colors.pack_abgr32_gamma_arith for one pixel.
__device__ __forceinline__ int32_t gamma_pack(V3 c,
                                              const int32_t* __restrict__ curve) {
  const int ri = trunc_i32(fm(c.x, 2047.0f));
  const int gi = trunc_i32(fm(c.y, 2047.0f));
  const int bi = trunc_i32(fm(c.z, 2047.0f));
  auto chan = [&](int i, bool negative) {
    return negative ? 0 : (i > 2047 ? 255 : __ldg(curve + clampi(i, 0, 2047)));
  };
  return chan(ri, ri < 0) | (chan(gi, gi < 0) << 8) | (chan(bi, ri < 0) << 16);
}

// Rows 0-2 of inv_world_to_vp(eye): normalize the eye, the exact cross
// products, then (inv_look @ inv_persp) @ inv_vpm in _mm4_exact's
// left-to-right order (row i of a product needs only row i of its left).
__device__ void ray_matrix(const ShadeArgs& a, float* m) {
  const V3 e = v3(a.eye[0], a.eye[1], a.eye[2]);
  auto cross = [](V3 u, V3 v) {
    return v3(fs(fm(u.y, v.z), fm(u.z, v.y)), fs(fm(u.z, v.x), fm(u.x, v.z)),
              fs(fm(u.x, v.y), fm(u.y, v.x)));
  };
  const V3 za = normalize(e);
  const V3 xa = normalize(cross(v3(0.0f, 1.0f, 0.0f), za));
  const V3 ya = cross(za, xa);
  const float look[3][4] = {{xa.x, ya.x, za.x, e.x},
                            {xa.y, ya.y, za.y, e.y},
                            {xa.z, ya.z, za.z, e.z}};
  for (int i = 0; i < 3; ++i) {
    float row[4];
    for (int j = 0; j < 4; ++j) {
      float s = fm(look[i][0], a.inv_persp[j]);
      for (int k = 1; k < 4; ++k)
        s = fa(s, fm(look[i][k], a.inv_persp[4 * k + j]));
      row[j] = s;
    }
    for (int j = 0; j < 4; ++j) {
      float s = fm(row[0], a.inv_vpm[j]);
      for (int k = 1; k < 4; ++k) s = fa(s, fm(row[k], a.inv_vpm[4 * k + j]));
      m[4 * i + j] = s;
    }
  }
}

// Where thread t's pixel lies: its input word (src), its frame word
// (dst), its column and local row. False for no pixel: past the end, or
// a padding entry of the rows list.
__device__ __forceinline__ bool locate(const ShadeArgs& a, long long t,
                                       int* src, int* dst, int* x, int* ly) {
  if (a.rows) {
    if (t >= static_cast<long long>(a.n_rows) * a.block_w) return false;
    const int i = static_cast<int>(t / a.block_w);
    const int c = static_cast<int>(t % a.block_w);
    const int ntx = a.w / a.block_w;
    const int r = __ldg(a.rows + i);
    if (r < 0 || r >= a.h * ntx) return false;
    *ly = r / ntx;
    *x = (r % ntx) * a.block_w + c;
    *dst = r * a.block_w + c;
    *src = a.compact ? i * a.block_w + c : *dst;
  } else {
    if (t >= static_cast<long long>(a.h) * a.w) return false;
    *dst = *src = static_cast<int>(t);
    *ly = static_cast<int>(t / a.w);
    *x = static_cast<int>(t % a.w);
  }
  return true;
}

// shade<S> for the shader index of the launch.
__device__ __forceinline__ V3 shade_by(int shader, V3 p, V3 n, V3 col, V3 eye,
                                       const float* __restrict__ cm) {
  switch (shader) {
    case 0: return shade<0>(p, n, col, eye, cm);
    case 1: return shade<1>(p, n, col, eye, cm);
    case 2: return shade<2>(p, n, col, eye, cm);
    case 3: return shade<3>(p, n, col, eye, cm);
    case 4: return shade<4>(p, n, col, eye, cm);
    case 5: return shade<5>(p, n, col, eye, cm);
    case 6: return shade<6>(p, n, col, eye, cm);
    case 7: return shade<7>(p, n, col, eye, cm);
    case 8: return shade<8>(p, n, col, eye, cm);
    case 9: return shade<9>(p, n, col, eye, cm);
    case 10: return shade<10>(p, n, col, eye, cm);
    case 11: return shade<11>(p, n, col, eye, cm);
    case 12: return shade<12>(p, n, col, eye, cm);
    case 13: return shade<13>(p, n, col, eye, cm);
    case 14: return shade<14>(p, n, col, eye, cm);
    default: return shade<15>(p, n, col, eye, cm);
  }
}

// The linear colour of a covered pixel. `m`: ray_matrix's rows (rays only).
__device__ __forceinline__ V3 shade_rgb(const ShadeArgs& a, const float* m,
                                        int shader, bool per_pixel, bool rays,
                                        int src, int x, int ly) {
  const float wr = fd(1.0f, __ldg(a.planes[0] + src));
  auto plane = [&](int k) { return fm(__ldg(a.planes[k] + src), wr); };
  V3 out = v3(plane(1), plane(2), plane(3));
  if (per_pixel) {
    V3 p, n;
    if (rays) {
      n = v3(plane(4), plane(5), plane(6));
      const float xf = static_cast<float>(x);
      const float yf = static_cast<float>(
          a.y_rows ? __ldg(a.y_rows + ly) : ly + a.y0);
      const float zf = __ldg(a.z + src);
      float pw[3];
      for (int i = 0; i < 3; ++i)
        pw[i] = fm(wr, fa(fa(fa(fm(m[4 * i], xf), fm(m[4 * i + 1], yf)),
                             fm(m[4 * i + 2], zf)),
                          m[4 * i + 3]));
      p = v3(pw[0], pw[1], pw[2]);
    } else {
      p = v3(plane(4), plane(5), plane(6));
      n = v3(plane(7), plane(8), plane(9));
    }
    out = shade_by(shader, p, n, out, v3(a.eye[0], a.eye[1], a.eye[2]), a.cm);
  }
  return out;
}

// ---- the kernel and the C entry ----

// One thread a pixel. The shader index and the two flags are the same for
// every thread of a launch, so their branches do not diverge. A rows
// list's frame already holds the background (the entry copies it first),
// so only covered pixels are written there.
__global__ void __launch_bounds__(THREADS)
    shade_pack_kernel(const ShadeArgs a, int shader, int per_pixel,
                      int ray_world) {
  __shared__ float m[12];
  const bool rays = per_pixel && ray_world;
  if (rays) {
    if (threadIdx.x == 0) ray_matrix(a, m);
    __syncthreads();
  }
  const long long t = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  int src, dst, x, ly;
  if (!locate(a, t, &src, &dst, &x, &ly)) return;
  if (__ldg(a.mask + src))
    a.out[dst] = gamma_pack(
        shade_rgb(a, m, shader, per_pixel != 0, rays, src, x, ly), a.curve);
  else if (!a.rows)
    a.out[dst] = __ldg(a.bg + dst);
}

}  // namespace

// Shade and pack one frame on `stream`. `args` is a host struct of device
// pointers and values (raster/shade.py's _ShadeArgs). With a rows list the
// background is first copied into the frame. Returns the CUDA error code
// (0 = ok) and sets *launches to the grids launched (0 or 1).
extern "C" int rs_shade_pack(const void* args, int shader, int per_pixel,
                             int ray_world, void* stream, int* launches) {
  const ShadeArgs& a = *static_cast<const ShadeArgs*>(args);
  *launches = 0;
  if (shader < 0 || shader >= 16 || a.h <= 0 || a.w <= 0 ||
      (a.rows && (a.block_w <= 0 || a.w % a.block_w != 0 || a.n_rows < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool rows = a.rows != nullptr;
  if (rows) {
    const cudaError_t err = cudaMemcpyAsync(
        a.out, a.bg, static_cast<size_t>(a.h) * a.w * sizeof(int32_t),
        cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = rows ? static_cast<long long>(a.n_rows) * a.block_w
                               : static_cast<long long>(a.h) * a.w;
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  ShadeArgs value = a;
  void* params[] = {&value, &shader, &per_pixel, &ray_world};
  const cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(shade_pack_kernel), dim3(blocks),
      dim3(THREADS), params, 0, st);
  if (err == cudaSuccess) *launches = 1;
  return static_cast<int>(err);
}

extern "C" const char* rustexp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
