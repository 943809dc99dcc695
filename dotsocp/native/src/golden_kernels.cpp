// Native golden-reference kernels for the DOT-SOCP operator core.
//
// Independent C++ implementations of the four compute kernels the reference
// ships as closed-source MEX binaries (mexProjSoc, mexBFd, mexBFdConj,
// mexsGS — semantics reconstructed at their call sites, see
// dotsocp/ops/cone.py and ops/sgs.py). They serve two roles:
//   1. an independent oracle for the JAX/Pallas ops in tests
//      (tests/test_native.py), replacing the binaries we cannot run;
//   2. a fast host-side fallback path for environments without an
//      accelerator (ctypes bindings in dotsocp/native/__init__.py).
//
// Array layout matches the framework: C-order, time axis leading.
//   phi / rhs : (nt, ny, nx)
//   q0        : (nt-1, ny, nx)
//   by        : (nt, ny-1, nx)      faces along y (axis 0 of space)
//   bx        : (nt, ny, nx-1)      faces along x (axis 1 of space)
//   z         : (10, nt-1, ny, nx)  cone columns leading
// Cone column convention (ops/cone.py): col 0 head, cols 1-4 y-faces
// [t-lo,f-lo],[t-lo,f-hi],[t-hi,f-lo],[t-hi,f-hi], cols 5-8 x-faces same
// order, col 9 tail.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {
const double INV_SQRT2 = 0.7071067811865475244;
}

extern "C" {

// Row-wise projection onto the Lorentz cone {z0 >= ||z1..||}.
// layout: in/out (cols, cells) C-order (column c at offset c*cells).
void proj_soc(double* out, const double* in, int64_t cells, int64_t cols) {
    for (int64_t i = 0; i < cells; ++i) {
        double z0 = in[i];
        double nrm2 = 0.0;
        for (int64_t c = 1; c < cols; ++c) {
            double v = in[c * cells + i];
            nrm2 += v * v;
        }
        double nrm = std::sqrt(nrm2);
        double coef;
        if (nrm <= z0) {
            coef = 1.0;
        } else if (nrm <= -z0) {
            coef = 0.0;
        } else {
            coef = nrm > 0.0 ? 0.5 * (1.0 + z0 / nrm) : 0.0;
        }
        double head = (nrm <= z0) ? z0 : coef * nrm;
        if (nrm == 0.0) head = std::max(z0, 0.0);
        out[i] = head;
        for (int64_t c = 1; c < cols; ++c) {
            out[c * cells + i] = coef * in[c * cells + i];
        }
    }
}

// z = scale_bf * (BF q) + scale_d * d  (2D).
void bfd2d(double* z, const double* q0, const double* by, const double* bx,
           int64_t nt, int64_t ny, int64_t nx,
           double scale_bf, double scale_d) {
    const int64_t cells = (nt - 1) * ny * nx;
    const double s = scale_bf * INV_SQRT2;
    for (int64_t k = 0; k < nt - 1; ++k) {
        for (int64_t i = 0; i < ny; ++i) {
            for (int64_t j = 0; j < nx; ++j) {
                const int64_t cell = (k * ny + i) * nx + j;
                const double v = q0[cell];
                z[cell] = scale_d - scale_bf * v;             // col 0
                z[9 * cells + cell] = scale_d + scale_bf * v; // col 9
                // y faces: by index (t, f, j), f in [0, ny-2];
                // cell i uses faces f = i-1 (lo) and f = i (hi)
                for (int tt = 0; tt < 2; ++tt) {
                    const int64_t t = k + tt;
                    double lo = (i - 1 >= 0) ? by[(t * (ny - 1) + (i - 1)) * nx + j] : 0.0;
                    double hi = (i <= ny - 2) ? by[(t * (ny - 1) + i) * nx + j] : 0.0;
                    z[(1 + 2 * tt) * cells + cell] = s * lo;
                    z[(2 + 2 * tt) * cells + cell] = s * hi;
                }
                // x faces: bx index (t, i, f), f in [0, nx-2]
                for (int tt = 0; tt < 2; ++tt) {
                    const int64_t t = k + tt;
                    double lo = (j - 1 >= 0) ? bx[(t * ny + i) * (nx - 1) + (j - 1)] : 0.0;
                    double hi = (j <= nx - 2) ? bx[(t * ny + i) * (nx - 1) + j] : 0.0;
                    z[(5 + 2 * tt) * cells + cell] = s * lo;
                    z[(6 + 2 * tt) * cells + cell] = s * hi;
                }
            }
        }
    }
}

// q = scale_bf * (BF)^T x  (2D adjoint; accumulates the scatter).
void bfd_conj2d(double* q0, double* by, double* bx, const double* x,
                int64_t nt, int64_t ny, int64_t nx, double scale_bf) {
    const int64_t cells = (nt - 1) * ny * nx;
    const double s = scale_bf * INV_SQRT2;
    std::memset(q0, 0, sizeof(double) * cells);
    std::memset(by, 0, sizeof(double) * nt * (ny - 1) * nx);
    std::memset(bx, 0, sizeof(double) * nt * ny * (nx - 1));
    for (int64_t k = 0; k < nt - 1; ++k) {
        for (int64_t i = 0; i < ny; ++i) {
            for (int64_t j = 0; j < nx; ++j) {
                const int64_t cell = (k * ny + i) * nx + j;
                q0[cell] = scale_bf * (x[9 * cells + cell] - x[cell]);
                for (int tt = 0; tt < 2; ++tt) {
                    const int64_t t = k + tt;
                    if (i - 1 >= 0)
                        by[(t * (ny - 1) + (i - 1)) * nx + j] += s * x[(1 + 2 * tt) * cells + cell];
                    if (i <= ny - 2)
                        by[(t * (ny - 1) + i) * nx + j] += s * x[(2 + 2 * tt) * cells + cell];
                    if (j - 1 >= 0)
                        bx[(t * ny + i) * (nx - 1) + (j - 1)] += s * x[(5 + 2 * tt) * cells + cell];
                    if (j <= nx - 2)
                        bx[(t * ny + i) * (nx - 1) + j] += s * x[(6 + 2 * tt) * cells + cell];
                }
            }
        }
    }
}

// Red-black symmetric Gauss-Seidel sweeps for
//   (scale * A^T A + eps I) phi = rhs   on the (nt, ny, nx) Neumann grid.
// Sweep order per iteration: parity-1, parity-0, parity-1 (ops/sgs.py).
static void sgs_color(double* phi, const double* rhs,
                      int64_t nt, int64_t ny, int64_t nx,
                      double scale, double eps, int parity) {
    const double wt = double((nt - 1)) * (nt - 1);
    const double wy = double((ny - 1)) * (ny - 1);
    const double wx = double((nx - 1)) * (nx - 1);
    for (int64_t t = 0; t < nt; ++t) {
        const double dt_deg = (t == 0 || t == nt - 1) ? 1.0 : 2.0;
        for (int64_t i = 0; i < ny; ++i) {
            const double dy_deg = (i == 0 || i == ny - 1) ? 1.0 : 2.0;
            for (int64_t j = 0; j < nx; ++j) {
                if (int((t + i + j) & 1) != parity) continue;
                const double dx_deg = (j == 0 || j == nx - 1) ? 1.0 : 2.0;
                const int64_t p = (t * ny + i) * nx + j;
                double nb = 0.0;
                if (t > 0) nb += wt * phi[p - ny * nx];
                if (t < nt - 1) nb += wt * phi[p + ny * nx];
                if (i > 0) nb += wy * phi[p - nx];
                if (i < ny - 1) nb += wy * phi[p + nx];
                if (j > 0) nb += wx * phi[p - 1];
                if (j < nx - 1) nb += wx * phi[p + 1];
                const double diag =
                    scale * (wt * dt_deg + wy * dy_deg + wx * dx_deg) + eps;
                phi[p] = (rhs[p] + scale * nb) / diag;
            }
        }
    }
}

void rb_sgs(double* phi, const double* rhs,
            int64_t nt, int64_t ny, int64_t nx,
            double scale, double eps, int its) {
    for (int s = 0; s < its; ++s) {
        sgs_color(phi, rhs, nt, ny, nx, scale, eps, 1);
        sgs_color(phi, rhs, nt, ny, nx, scale, eps, 0);
        sgs_color(phi, rhs, nt, ny, nx, scale, eps, 1);
    }
}

}  // extern "C"
