// Native host-side runtime for fluidnet_tpu_torch.
//
// The reference keeps several host-side components in C++: the
// connected-component flood fill (generic/find_connected_fluid_components.cc),
// the binvox RLE voxel importer (obstacles_import_binvox.lua's inner loop),
// and a threaded data pipeline (torch/lib/data_parallel.lua over
// DataBinary). This library provides the equivalents on the host of the
// PyTorch port, exposed via ctypes (see fluidnet_tpu_torch/native/__init__.py):
//
//   fn_flood_fill       — label connected fluid components (4/6-conn),
//                         per batch, scanline stack fill.
//   fn_binvox_decode    — binvox RLE pair expansion.
//   fn_read_manta_frames— parse N binary frames into preallocated batch
//                         arrays, multi-threaded over frames.
//
// A copy of fluidnet_tpu/native/src/fluidnet_native.cpp (same entry points,
// same results). Built at first use by fluidnet_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -> build/native/libfluidnet_native.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// --- Connected components ---------------------------------------------------
// flags: int32 (B, Z, Y, X) flattened; fluid = bit 0.
// labels out: int32 same shape; -1 for non-fluid, else component id
// (0..n_components-1, per batch). Returns total number of components.
int64_t fn_flood_fill(const int32_t* flags, int32_t B, int32_t Z, int32_t Y,
                      int32_t X, int32_t* labels, int64_t* comp_sizes,
                      int64_t max_components) {
  const int64_t n = (int64_t)Z * Y * X;
  int64_t total_components = 0;
  std::vector<int64_t> stack;
  for (int32_t b = 0; b < B; ++b) {
    const int32_t* f = flags + b * n;
    int32_t* lab = labels + b * n;
    for (int64_t i = 0; i < n; ++i) lab[i] = -1;
    for (int64_t seed = 0; seed < n; ++seed) {
      if (!(f[seed] & 1) || lab[seed] >= 0) continue;
      const int32_t comp = (int32_t)total_components;
      int64_t size = 0;
      stack.clear();
      stack.push_back(seed);
      lab[seed] = comp;
      while (!stack.empty()) {
        const int64_t cur = stack.back();
        stack.pop_back();
        ++size;
        const int64_t k = cur / ((int64_t)Y * X);
        const int64_t rem = cur % ((int64_t)Y * X);
        const int64_t j = rem / X;
        const int64_t i = rem % X;
        const int64_t nbrs[6] = {
            (i > 0) ? cur - 1 : -1,
            (i < X - 1) ? cur + 1 : -1,
            (j > 0) ? cur - X : -1,
            (j < Y - 1) ? cur + X : -1,
            (k > 0) ? cur - (int64_t)Y * X : -1,
            (k < Z - 1) ? cur + (int64_t)Y * X : -1,
        };
        for (int d = 0; d < 6; ++d) {
          const int64_t nb = nbrs[d];
          if (nb >= 0 && (f[nb] & 1) && lab[nb] < 0) {
            lab[nb] = comp;
            stack.push_back(nb);
          }
        }
      }
      if (comp_sizes != nullptr && total_components < max_components) {
        comp_sizes[total_components] = size;
      }
      ++total_components;
    }
  }
  return total_components;
}

// --- binvox RLE --------------------------------------------------------------
// rle: (value, count) byte pairs. out: n_voxels bytes. Returns number of
// voxels written (may be < n_voxels on truncated input).
int64_t fn_binvox_decode(const uint8_t* rle, int64_t n_bytes, uint8_t* out,
                         int64_t n_voxels) {
  int64_t idx = 0;
  for (int64_t p = 0; p + 1 < n_bytes && idx < n_voxels; p += 2) {
    const uint8_t value = rle[p];
    int64_t count = rle[p + 1];
    if (idx + count > n_voxels) count = n_voxels - idx;
    memset(out + idx, value, (size_t)count);
    idx += count;
  }
  return idx;
}

// --- manta frame batch reader -------------------------------------------------
// Reads one frame file (the format of torch/lib/load_manta_file.lua) into
// the b-th slot of preallocated batch arrays:
//   u:       float32 (B, cu, Z, Y, X)
//   p:       float32 (B, 1, Z, Y, X)
//   flags:   int32   (B, 1, Z, Y, X)
//   density: float32 (B, 1, Z, Y, X)
// Returns 0 on success, negative error code otherwise.
static int read_one_frame(const char* path, int64_t b, float* u, float* p,
                          int32_t* flags, float* density, int32_t Z,
                          int32_t Y, int32_t X, int32_t cu) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int32_t header[5];
  if (fread(header, sizeof(int32_t), 5, f) != 5) { fclose(f); return -2; }
  const int32_t nx = header[1], ny = header[2], nz = header[3];
  const int32_t is3d = header[4];
  if (nx != X || ny != Y || nz != Z || (is3d ? 3 : 2) != cu) {
    fclose(f);
    return -3;
  }
  const int64_t n = (int64_t)Z * Y * X;
  for (int c = 0; c < cu; ++c) {
    if (fread(u + (b * cu + c) * n, sizeof(float), n, f) != (size_t)n) {
      fclose(f);
      return -4;
    }
  }
  if (fread(p + b * n, sizeof(float), n, f) != (size_t)n) { fclose(f); return -5; }
  if (fread(flags + b * n, sizeof(int32_t), n, f) != (size_t)n) {
    fclose(f);
    return -6;
  }
  if (fread(density + b * n, sizeof(float), n, f) != (size_t)n) {
    fclose(f);
    return -7;
  }
  fclose(f);
  return 0;
}

// paths: concatenated null-terminated strings, n_frames of them.
int32_t fn_read_manta_frames(const char* paths, int32_t n_frames, float* u,
                             float* p, int32_t* flags, float* density,
                             int32_t Z, int32_t Y, int32_t X, int32_t cu,
                             int32_t n_threads) {
  std::vector<const char*> ptrs(n_frames);
  const char* cur = paths;
  for (int32_t i = 0; i < n_frames; ++i) {
    ptrs[i] = cur;
    cur += strlen(cur) + 1;
  }
  if (n_threads < 1) n_threads = 1;
  std::vector<int> status(n_frames, 0);
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      for (int32_t i = t; i < n_frames; i += n_threads) {
        status[i] = read_one_frame(ptrs[i], i, u, p, flags, density, Z, Y, X,
                                   cu);
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int32_t i = 0; i < n_frames; ++i) {
    if (status[i] != 0) return status[i];
  }
  return 0;
}

}  // extern "C"
