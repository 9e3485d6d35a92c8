// Native solid voxelizer: parity ray-cast with an XOR bit table.
//
// Host-side counterpart of the reference's 4-backend GPU
// voxelizer (`GPUFunctions/GPUVoxelize/voxelize.cpp:17-38,121` — per-triangle
// scan of the yz plane + atomic XOR into a bit table, then prefix pass).
// Voxelization is host-side setup work (SURVEY.md section 2.3 flags it as
// the one irregular op that does not map onto dense array math), so the native
// runtime owns it: OpenMP over triangles, std::atomic XOR into a packed
// x-bit table, prefix-XOR scan per (y,z) column.
//
// The arithmetic mirrors ops/voxelize.py::voxelize_solid exactly (same ray
// offsets, determinant threshold, and floor(x)+1 crossing index) so the two
// backends produce bit-identical masks.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// triangles: (n_tri, 3, 3) float64 already in voxel coordinates
// out: (N1, N2, N3) uint8, C-order
int voxelize_solid_native(const double* tri, int64_t n_tri,
                          int64_t N1, int64_t N2, int64_t N3,
                          uint8_t* out) {
    const double EPS_J = 2.4375e-4, EPS_K = 7.8125e-5;
    const int64_t words_per_col = (N1 + 1 + 31) / 32;
    const int64_t n_cols = N2 * N3;

    auto* bits = new (std::nothrow) std::atomic<uint32_t>[n_cols * words_per_col];
    if (!bits) return 1;
    for (int64_t i = 0; i < n_cols * words_per_col; ++i)
        bits[i].store(0u, std::memory_order_relaxed);

#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t t = 0; t < n_tri; ++t) {
        const double* a = tri + t * 9;
        const double* b = a + 3;
        const double* c = a + 6;
        double ymin = a[1] < b[1] ? a[1] : b[1]; ymin = ymin < c[1] ? ymin : c[1];
        double ymax = a[1] > b[1] ? a[1] : b[1]; ymax = ymax > c[1] ? ymax : c[1];
        double zmin = a[2] < b[2] ? a[2] : b[2]; zmin = zmin < c[2] ? zmin : c[2];
        double zmax = a[2] > b[2] ? a[2] : b[2]; zmax = zmax > c[2] ? zmax : c[2];

        int64_t j0 = (int64_t)std::ceil(ymin - EPS_J);
        int64_t j1 = (int64_t)std::floor(ymax - EPS_J);
        int64_t k0 = (int64_t)std::ceil(zmin - EPS_K);
        int64_t k1 = (int64_t)std::floor(zmax - EPS_K);
        if (j0 < 0) j0 = 0;
        if (j1 > N2 - 1) j1 = N2 - 1;
        if (k0 < 0) k0 = 0;
        if (k1 > N3 - 1) k1 = N3 - 1;

        const double d0 = b[1] - a[1], d1 = b[2] - a[2];
        const double e0 = c[1] - a[1], e1 = c[2] - a[2];
        const double det = d0 * e1 - d1 * e0;
        if (std::fabs(det) <= 1e-14) continue;
        const double inv = 1.0 / det;

        for (int64_t j = j0; j <= j1; ++j) {
            const double r0 = (double)j + EPS_J - a[1];
            for (int64_t k = k0; k <= k1; ++k) {
                const double r1 = (double)k + EPS_K - a[2];
                const double u = (r0 * e1 - r1 * e0) * inv;
                const double v = (d0 * r1 - d1 * r0) * inv;
                if (u < 0.0 || v < 0.0 || u + v > 1.0) continue;
                const double x_hit =
                    a[0] + u * (b[0] - a[0]) + v * (c[0] - a[0]);
                int64_t i_cross = (int64_t)std::floor(x_hit) + 1;
                if (i_cross > N1) continue;
                if (i_cross < 0) i_cross = 0;
                const int64_t col = j * N3 + k;
                bits[col * words_per_col + (i_cross >> 5)].fetch_xor(
                    1u << (i_cross & 31), std::memory_order_relaxed);
            }
        }
    }

    // prefix-XOR each column: voxel i inside iff an odd number of crossings
    // land at indices <= i
#pragma omp parallel for schedule(static)
    for (int64_t col = 0; col < n_cols; ++col) {
        const int64_t j = col / N3, k = col % N3;
        uint32_t parity = 0;
        for (int64_t w = 0; w < words_per_col; ++w) {
            uint32_t word = bits[col * words_per_col + w].load(
                std::memory_order_relaxed);
            const int64_t base = w << 5;
            if (!word && !parity) continue;
            for (int64_t bit = 0; bit < 32; ++bit) {
                const int64_t i = base + bit;
                if (i >= N1) break;  // crossings clipped to i==N1 are unused
                parity ^= (word >> bit) & 1u;
                if (parity) out[(i * N2 + j) * N3 + k] = 1;
            }
        }
    }
    delete[] bits;
    return 0;
}

}  // extern "C"
