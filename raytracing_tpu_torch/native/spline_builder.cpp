// Native bicubic spline coefficient builder.
//
// Replaces the scipy/FITPACK fit of the reference's media pipeline
// (RT_bench.py:455-462, RectBivariateSpline kx=ky=3 with s=0) with a direct
// C++ construction: an interpolating cubic spline with not-a-knot boundary
// conditions per axis (FITPACK's s=0 knot choice drops the second and
// penultimate data sites, which IS the not-a-knot condition, so the tensor-
// product spline is mathematically identical), converted straight to
// per-cell polynomial coefficients — the table format the device evaluator
// consumes (raytracing_tpu/media/spline.py).
//
// Exposed as a tiny C ABI for ctypes; no Python dependencies.
//
// Layout: grids are row-major [ny][nx] with uniform spacing per axis.
// Output C has shape [ny-1][nx-1][4][4]:
//     S(y, x) = sum_{a,b} C[iy][ix][a][b] * uy^a * ux^b,
// with uy = (y - y_iy)/hy, ux = (x - x_ix)/hx normalized cell offsets.

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

// Solve the not-a-knot cubic spline for one 1-D sequence of n values at
// uniform unit spacing; emit per-cell coefficients c[i][k] (k=0..3) in the
// normalized cell coordinate u in [0, 1]:  p_i(u) = sum_k c[i][k] u^k.
//
// Unknowns are the knot slopes m_i (Hermite form).  Interior C2 continuity
// gives the classic tridiagonal m_{i-1} + 4 m_i + m_{i+1} = 3 (y_{i+1} -
// y_{i-1}); not-a-knot (continuity of the 3rd derivative across x_1 and
// x_{n-2}) gives the end rows  m_0 + 0 m_1 ... expressed below.
void spline1d_nak(const double* y, std::ptrdiff_t n, std::ptrdiff_t stride,
                  double* slopes /* n */) {
  if (n == 2) {  // single cell: straight line
    slopes[0] = slopes[1] = y[stride] - y[0];
    return;
  }
  if (n == 3) {  // one interior site: the spline is a single parabola
    // p(t) fit through 3 points at t = 0, 1, 2 (unit spacing)
    const double y0 = y[0], y1 = y[stride], y2 = y[2 * stride];
    // p'(t) = (y2 - y0)/2 + (y0 - 2 y1 + y2) (t - 1)
    const double lin = (y2 - y0) / 2.0, quad = y0 - 2.0 * y1 + y2;
    slopes[0] = lin - quad;
    slopes[1] = lin;
    slopes[2] = lin + quad;
    return;
  }

  // Tridiagonal system with not-a-knot end rows, solved by the Thomas
  // algorithm.  Not-a-knot at the left (p_0''' == p_1''' across x_1) for
  // uniform spacing reduces to:  m_0 + 0*m_1 - m_2 ... more conveniently,
  // use the standard formulation in terms of the first row
  //     m_0 + 2 m_1 = (5 y_1 - 4 y_0 - y_2) ... (derived below)
  // Derivation (unit spacing): cells [0,1] and [1,2] share one cubic
  // <=> d^3/du^3 equal:  with Hermite coefficients, p_i''' = 12(y_i -
  // y_{i+1}) + 6(m_i + m_{i+1}), so
  //     2(y_0 - y_1) + m_0 + m_1 = 2(y_1 - y_2) + m_1 + m_2
  // =>  m_0 - m_2 = 2(2 y_1 - y_0 - y_2)                        (row 0)
  // Combined with the interior row at i=1 to eliminate m_2:
  //     m_0 + 4 m_1 + m_2 = 3(y_2 - y_0)
  // =>  2 m_0 + 4 m_1 = 3(y_2 - y_0) + 2(2 y_1 - y_0 - y_2)
  //                   = 4 y_1 + y_2 - 5 y_0 ... /2:
  //     m_0 + 2 m_1 = (4 y_1 + y_2 - 5 y_0) / 2                 (row 0')
  // Symmetrically at the right end.
  std::vector<double> a(n), b(n), c(n), d(n);
  auto Y = [&](std::ptrdiff_t i) { return y[i * stride]; };

  b[0] = 1.0;
  c[0] = 2.0;
  d[0] = (4.0 * Y(1) + Y(2) - 5.0 * Y(0)) / 2.0;
  for (std::ptrdiff_t i = 1; i < n - 1; ++i) {
    a[i] = 1.0;
    b[i] = 4.0;
    c[i] = 1.0;
    d[i] = 3.0 * (Y(i + 1) - Y(i - 1));
  }
  a[n - 1] = 2.0;
  b[n - 1] = 1.0;
  d[n - 1] = (5.0 * Y(n - 1) - 4.0 * Y(n - 2) - Y(n - 3)) / 2.0;

  // Thomas sweep
  for (std::ptrdiff_t i = 1; i < n; ++i) {
    const double w = a[i] / b[i - 1];
    b[i] -= w * c[i - 1];
    d[i] -= w * d[i - 1];
  }
  slopes[n - 1] = d[n - 1] / b[n - 1];
  for (std::ptrdiff_t i = n - 2; i >= 0; --i) {
    slopes[i] = (d[i] - c[i] * slopes[i + 1]) / b[i];
  }
}

// Hermite -> power-basis conversion for one cell with endpoint values
// (y0, y1) and slopes (m0, m1) in normalized u:
//   c0 = y0, c1 = m0, c2 = 3(y1-y0) - 2 m0 - m1, c3 = 2(y0-y1) + m0 + m1.
inline void hermite_to_poly(double y0, double y1, double m0, double m1,
                            double* c4) {
  c4[0] = y0;
  c4[1] = m0;
  c4[2] = 3.0 * (y1 - y0) - 2.0 * m0 - m1;
  c4[3] = 2.0 * (y0 - y1) + m0 + m1;
}

}  // namespace

extern "C" {

// Build per-cell bicubic coefficients from a [ny][nx] grid (row-major,
// uniform spacing, normalized cell coordinates).  out has
// (ny-1)*(nx-1)*16 doubles, laid out [iy][ix][a(y-power)][b(x-power)].
// Returns 0 on success.
int rt_bicubic_cells(const double* grid, std::int64_t ny, std::int64_t nx,
                     double* out) {
  if (ny < 2 || nx < 2) return 1;
  const std::int64_t ncy = ny - 1, ncx = nx - 1;

  // 1) x-direction slopes for every row.
  std::vector<double> mx((size_t)ny * nx);
  for (std::int64_t j = 0; j < ny; ++j) {
    spline1d_nak(grid + j * nx, nx, 1, mx.data() + j * nx);
  }

  // 2) per-row x-cell coefficients: A[j][ix][b], b = x-power.
  std::vector<double> A((size_t)ny * ncx * 4);
  for (std::int64_t j = 0; j < ny; ++j) {
    for (std::int64_t i = 0; i < ncx; ++i) {
      hermite_to_poly(grid[j * nx + i], grid[j * nx + i + 1],
                      mx[j * nx + i], mx[j * nx + i + 1],
                      A.data() + ((size_t)j * ncx + i) * 4);
    }
  }

  // 3) spline each x-coefficient across y, then emit tensor cells.
  //    (the tensor-product spline's y-sections of each x-power coefficient
  //    are themselves not-a-knot cubics through the per-row values)
  std::vector<double> col(ny), my((size_t)ny);
  for (std::int64_t i = 0; i < ncx; ++i) {
    for (int b = 0; b < 4; ++b) {
      for (std::int64_t j = 0; j < ny; ++j) {
        col[j] = A[((size_t)j * ncx + i) * 4 + b];
      }
      spline1d_nak(col.data(), ny, 1, my.data());
      double c4[4];
      for (std::int64_t j = 0; j < ncy; ++j) {
        hermite_to_poly(col[j], col[j + 1], my[j], my[j + 1], c4);
        for (int a = 0; a < 4; ++a) {
          out[(((size_t)j * ncx + i) * 4 + a) * 4 + b] = c4[a];
        }
      }
    }
  }
  return 0;
}

// First-derivative grids matching np.gradient(Z, h, edge_order=2)
// (RT_bench.py:450): central differences inside, 3-point one-sided at the
// edges.  dx is along axis 1 (columns), dy along axis 0 (rows).
int rt_gradient2(const double* grid, std::int64_t ny, std::int64_t nx,
                 double h, double* ddx, double* ddy) {
  if (ny < 3 || nx < 3) return 1;
  const double inv2h = 0.5 / h, invh = 1.0 / h;
  for (std::int64_t j = 0; j < ny; ++j) {
    const double* r = grid + j * nx;
    double* o = ddx + j * nx;
    o[0] = (-1.5 * r[0] + 2.0 * r[1] - 0.5 * r[2]) * invh;
    for (std::int64_t i = 1; i < nx - 1; ++i)
      o[i] = (r[i + 1] - r[i - 1]) * inv2h;
    o[nx - 1] = (1.5 * r[nx - 1] - 2.0 * r[nx - 2] + 0.5 * r[nx - 3]) * invh;
  }
  for (std::int64_t i = 0; i < nx; ++i) {
    ddy[i] = (-1.5 * grid[i] + 2.0 * grid[nx + i] - 0.5 * grid[2 * nx + i]) * invh;
    for (std::int64_t j = 1; j < ny - 1; ++j)
      ddy[j * nx + i] = (grid[(j + 1) * nx + i] - grid[(j - 1) * nx + i]) * inv2h;
    ddy[(ny - 1) * nx + i] = (1.5 * grid[(ny - 1) * nx + i]
                              - 2.0 * grid[(ny - 2) * nx + i]
                              + 0.5 * grid[(ny - 3) * nx + i]) * invh;
  }
  return 0;
}

}  // extern "C"
