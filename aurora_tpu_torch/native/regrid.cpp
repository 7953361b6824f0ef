// Fast bilinear spherical regridding (periodic longitude wrap, linear latitude
// extrapolation) — the native data-plane kernel behind aurora_tpu_torch.batch.Batch.regrid.
//
// Semantics match scipy RegularGridInterpolator(method="linear", fill_value=None)
// over (lat, lon_extended) as used in aurora_tpu_torch/batch.py:interpolate_scipy
// (reference behaviour: aurora/batch.py:299-362). Weights are precomputed per output
// row/column and applied to every field; OpenMP parallelises over fields x rows.

#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Bracketing index + weight along one axis (monotone descending or ascending),
// linear extrapolation outside the range.
inline void bracket(const double* x, int64_t n, double q, int64_t* i0, double* w1) {
    const bool asc = x[n - 1] > x[0];
    int64_t lo = 0, hi = n - 1;
    if (asc) {
        if (q <= x[0]) { *i0 = 0; }
        else if (q >= x[n - 1]) { *i0 = n - 2; }
        else {
            while (hi - lo > 1) { int64_t m = (lo + hi) / 2; (x[m] <= q ? lo : hi) = m; }
            *i0 = lo;
        }
    } else {
        if (q >= x[0]) { *i0 = 0; }
        else if (q <= x[n - 1]) { *i0 = n - 2; }
        else {
            while (hi - lo > 1) { int64_t m = (lo + hi) / 2; (x[m] >= q ? lo : hi) = m; }
            *i0 = lo;
        }
    }
    const double x0 = x[*i0], x1 = x[*i0 + 1];
    *w1 = (q - x0) / (x1 - x0);  // may be <0 or >1: linear extrapolation
}

}  // namespace

extern "C" {

// v:       (nf, H, W) C-contiguous float64
// lat:     (H) strictly monotone (descending in Aurora)
// lon:     (W) strictly increasing, [0, 360)
// lat_new: (H2), lon_new: (W2)
// out:     (nf, H2, W2) preallocated
void regrid_bilinear(const double* v, int64_t nf, int64_t H, int64_t W,
                     const double* lat, const double* lon,
                     const double* lat_new, int64_t H2,
                     const double* lon_new, int64_t W2,
                     double* out) {
    // Extended longitude axis: [lon[W-1]-360, lon..., lon[0]+360] with column map
    // ext_col(k) = (k - 1 + W) % W  for k in [0, W+1].
    std::vector<double> lon_ext(W + 2);
    lon_ext[0] = lon[W - 1] - 360.0;
    for (int64_t j = 0; j < W; ++j) lon_ext[j + 1] = lon[j];
    lon_ext[W + 1] = lon[0] + 360.0;

    std::vector<int64_t> li0(H2), lj0(W2);
    std::vector<double> lw1(H2), jw1(W2);
    for (int64_t i = 0; i < H2; ++i) bracket(lat, H, lat_new[i], &li0[i], &lw1[i]);
    for (int64_t j = 0; j < W2; ++j)
        bracket(lon_ext.data(), W + 2, lon_new[j], &lj0[j], &jw1[j]);

    // Map extended columns back into [0, W).
    std::vector<int64_t> jc0(W2), jc1(W2);
    for (int64_t j = 0; j < W2; ++j) {
        jc0[j] = (lj0[j] - 1 + W) % W;
        jc1[j] = (lj0[j] + W) % W;
    }

#ifdef _OPENMP
#pragma omp parallel for collapse(2) schedule(static)
#endif
    for (int64_t f = 0; f < nf; ++f) {
        for (int64_t i = 0; i < H2; ++i) {
            const double wy = lw1[i];
            const double* r0 = v + (f * H + li0[i]) * W;
            const double* r1 = r0 + W;
            double* o = out + (f * H2 + i) * W2;
            for (int64_t j = 0; j < W2; ++j) {
                const double wx = jw1[j];
                const double a = r0[jc0[j]] * (1.0 - wx) + r0[jc1[j]] * wx;
                const double b = r1[jc0[j]] * (1.0 - wx) + r1[jc1[j]] * wx;
                o[j] = a * (1.0 - wy) + b * wy;
            }
        }
    }
}

}  // extern "C"
