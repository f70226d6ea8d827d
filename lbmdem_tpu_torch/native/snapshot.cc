// Native snapshot writer: a copy of the JAX package's
// lbmdem_tpu/native/snapshot.cc, built by lbmdem_tpu_torch/utils/native.py.
//
// Big-endian conversion + interleaving + buffered file output for
// multi-hundred-MB fluid frames, callable from Python via ctypes. The
// Python writer in utils/io_vtk.py remains the portable fallback and the
// format oracle (outputs are byte-identical; tested).
//
// Build: g++ -O3 -shared -fPIC -o libsnapshot.so snapshot.cc

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

inline uint32_t bswap(uint32_t v) { return __builtin_bswap32(v); }

// Convert float32 buffer to big-endian into out.
void to_be(const float* src, size_t n, std::vector<uint32_t>& out) {
  out.resize(n);
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  for (size_t i = 0; i < n; ++i) out[i] = bswap(s[i]);
}

bool write_block(FILE* f, const void* data, size_t bytes) {
  return fwrite(data, 1, bytes, f) == bytes;
}

}  // namespace

extern "C" {

// Writes a legacy-VTK STRUCTURED_POINTS fluid snapshot (binary,
// big-endian). eps may be null. Returns 0 on success, nonzero errno-ish
// code on failure.
int write_fluid_vtk(const char* path, int32_t ny, int32_t nx,
                    const float* rho, const float* ux, const float* uy,
                    const float* eps) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  const size_t n = static_cast<size_t>(ny) * nx;
  char head[256];
  int m = snprintf(head, sizeof(head),
                   "# vtk DataFile Version 3.0\n"
                   "lbmdem_tpu fluid snapshot\n"
                   "BINARY\n"
                   "DATASET STRUCTURED_POINTS\n"
                   "DIMENSIONS %d %d 1\n"
                   "ORIGIN 0 0 0\n"
                   "SPACING 1 1 1\n"
                   "POINT_DATA %zu\n"
                   "SCALARS rho float 1\nLOOKUP_TABLE default\n",
                   nx, ny, n);
  bool ok = write_block(f, head, m);

  std::vector<uint32_t> buf;
  to_be(rho, n, buf);
  ok = ok && write_block(f, buf.data(), n * 4) && write_block(f, "\n", 1);

  ok = ok && write_block(f, "VECTORS velocity float\n", 23);
  {
    std::vector<uint32_t> vel(3 * n);
    const uint32_t* sx = reinterpret_cast<const uint32_t*>(ux);
    const uint32_t* sy = reinterpret_cast<const uint32_t*>(uy);
    for (size_t i = 0; i < n; ++i) {
      vel[3 * i + 0] = bswap(sx[i]);
      vel[3 * i + 1] = bswap(sy[i]);
      vel[3 * i + 2] = 0;  // bswap(0.0f) == 0
    }
    ok = ok && write_block(f, vel.data(), 3 * n * 4) && write_block(f, "\n", 1);
  }

  if (eps != nullptr) {
    const char* hdr = "SCALARS eps float 1\nLOOKUP_TABLE default\n";
    ok = ok && write_block(f, hdr, strlen(hdr));
    to_be(eps, n, buf);
    ok = ok && write_block(f, buf.data(), n * 4) && write_block(f, "\n", 1);
  }
  if (fclose(f) != 0) ok = false;
  return ok ? 0 : 2;
}

// Appends particle trajectory rows: step,id,x,y,vx,vy,theta,omega for
// active disks. Returns 0 on success.
int append_particle_csv(const char* path, int64_t step, int32_t n,
                        const double* x, const double* v,
                        const double* theta, const double* omega,
                        const uint8_t* active, int32_t write_header) {
  FILE* f = fopen(path, "a");
  if (!f) return 1;
  if (write_header) fputs("step,id,x,y,vx,vy,theta,omega\n", f);
  for (int32_t i = 0; i < n; ++i) {
    if (!active[i]) continue;
    fprintf(f, "%lld,%d,%.17g,%.17g,%.17g,%.17g,%.17g,%.17g\n",
            static_cast<long long>(step), i, x[2 * i], x[2 * i + 1],
            v[2 * i], v[2 * i + 1], theta[i], omega[i]);
  }
  return fclose(f) == 0 ? 0 : 2;
}

}  // extern "C"
