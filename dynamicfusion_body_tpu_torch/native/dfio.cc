// Native I/O runtime of dynamicfusion_body_tpu_torch: a copy of the JAX
// package's native/dfio.cc (the port imports nothing of that package).
//
// The reference does all of its serialization in Python loops (OBJ writers
// at core/fusion_dm.py:339-354, per-line OBJ parsing at
// core/meshutil.py:12-29, struct-at-a-time .dist reads at
// core/sdf.py:36-67). At production mesh sizes (10^5-10^6 vertices per
// frame, one mesh per frame) those loops dominate host time, so the
// I/O layer routes them through this small C library (ctypes-bound,
// zero-copy on the numpy side; native/__init__.py builds it with g++).
//
// Exposed C ABI:
//   dfio_write_obj   — vertices/normals/faces -> OBJ text file
//   dfio_read_obj_counts / dfio_read_obj — two-pass OBJ parse
//   dfio_read_dist_header / dfio_read_dist — .dist volume loader
//     (format documented in the reference, core/sdf.py:10-21: negated
//     int32 x/y resolutions, f64 bbox, z-major f32 payload)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Write an OBJ. ind == nullptr -> plain style ("f a b c"); with a 4x4
// row-major ind, vertices/normals are mapped through its rotation +
// translation and faces use the v//vn style (reference FusionDM writer).
int dfio_write_obj(const char* path, const float* verts, int64_t n_verts,
                   const float* normals, const int32_t* faces,
                   int64_t n_faces, const double* ind) {
  FILE* f = fopen(path, "w");
  if (!f) return -1;
  std::vector<char> buf(1 << 22);
  setvbuf(f, buf.data(), _IOFBF, buf.size());

  double R[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
  double t[3] = {0, 0, 0};
  if (ind) {
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) R[r * 3 + c] = ind[r * 4 + c];
      t[r] = ind[r * 4 + 3];
    }
  }
  for (int64_t i = 0; i < n_verts; ++i) {
    const float* v = verts + 3 * i;
    double x = R[0] * v[0] + R[1] * v[1] + R[2] * v[2] + t[0];
    double y = R[3] * v[0] + R[4] * v[1] + R[5] * v[2] + t[1];
    double z = R[6] * v[0] + R[7] * v[1] + R[8] * v[2] + t[2];
    fprintf(f, "v %f %f %f\n", x, y, z);
  }
  if (normals) {
    for (int64_t i = 0; i < n_verts; ++i) {
      const float* n = normals + 3 * i;
      double x = R[0] * n[0] + R[1] * n[1] + R[2] * n[2];
      double y = R[3] * n[0] + R[4] * n[1] + R[5] * n[2];
      double z = R[6] * n[0] + R[7] * n[1] + R[8] * n[2];
      fprintf(f, "vn %f %f %f\n", x, y, z);
    }
  }
  if (ind && normals) {
    for (int64_t i = 0; i < n_faces; ++i) {
      const int32_t* fc = faces + 3 * i;
      fprintf(f, "f %d//%d %d//%d %d//%d\n", fc[0] + 1, fc[0] + 1, fc[1] + 1,
              fc[1] + 1, fc[2] + 1, fc[2] + 1);
    }
  } else {
    for (int64_t i = 0; i < n_faces; ++i) {
      const int32_t* fc = faces + 3 * i;
      fprintf(f, "f %d %d %d\n", fc[0] + 1, fc[1] + 1, fc[2] + 1);
    }
  }
  fclose(f);
  return 0;
}

// Pass 1: count vertices and faces so the caller can allocate.
int dfio_read_obj_counts(const char* path, int64_t* n_verts,
                         int64_t* n_faces) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  std::vector<char> buf(1 << 22);
  setvbuf(f, buf.data(), _IOFBF, buf.size());
  char line[1024];
  int64_t nv = 0, nf = 0;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && line[1] == ' ') ++nv;
    else if (line[0] == 'f' && line[1] == ' ') ++nf;
  }
  fclose(f);
  *n_verts = nv;
  *n_faces = nf;
  return 0;
}

// Pass 2: fill preallocated buffers. Handles "f a b c", "f a/b/c ...",
// "f a//c ..." forms; emits zero-based indices when the file is 1-based
// (detected like the reference: min index == 1 -> subtract).
int dfio_read_obj(const char* path, float* verts, int64_t n_verts,
                  int32_t* faces, int64_t n_faces) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  std::vector<char> buf(1 << 22);
  setvbuf(f, buf.data(), _IOFBF, buf.size());
  char line[1024];
  int64_t iv = 0, fi = 0;
  int32_t min_idx = INT32_MAX;
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      if (iv >= n_verts) continue;
      float x, y, z;
      if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        verts[3 * iv] = x;
        verts[3 * iv + 1] = y;
        verts[3 * iv + 2] = z;
        ++iv;
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      if (fi >= n_faces) continue;
      int32_t a[3];
      int got = 0;
      const char* p = line + 2;
      while (got < 3 && *p) {
        while (*p == ' ') ++p;
        char* end;
        long v = strtol(p, &end, 10);
        if (end == p) break;
        a[got++] = (int32_t)v;
        // skip /vt or //vn attachments
        p = end;
        while (*p && *p != ' ' && *p != '\n') ++p;
      }
      if (got == 3) {
        for (int k = 0; k < 3; ++k) {
          faces[3 * fi + k] = a[k];
          if (a[k] < min_idx) min_idx = a[k];
        }
        ++fi;
      }
    }
  }
  fclose(f);
  if (min_idx == 1) {
    for (int64_t i = 0; i < 3 * fi; ++i) faces[i] -= 1;
  }
  return 0;
}

// .dist header: resolutions (x, y stored negated) + f64 bbox min/max.
int dfio_read_dist_header(const char* path, int32_t* res_xyz, double* b_min,
                          double* b_max) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int32_t r[3];
  if (fread(r, 4, 3, f) != 3) { fclose(f); return -2; }
  res_xyz[0] = -r[0];
  res_xyz[1] = -r[1];
  res_xyz[2] = r[2];
  if (fread(b_min, 8, 3, f) != 3 || fread(b_max, 8, 3, f) != 3) {
    fclose(f);
    return -2;
  }
  fclose(f);
  return 0;
}

// Payload: reads the z-major (rz+1, ry+1, rx+1) f32 block and transposes
// to x-major (rx+1, ry+1, rz+1) into `volume` (caller-allocated).
int dfio_read_dist(const char* path, float* volume, int32_t rx, int32_t ry,
                   int32_t rz) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 12 + 48, SEEK_SET);
  const int64_t X = rx + 1, Y = ry + 1, Z = rz + 1;
  std::vector<float> zmajor((size_t)(X * Y * Z));
  if (fread(zmajor.data(), 4, zmajor.size(), f) != zmajor.size()) {
    fclose(f);
    return -2;
  }
  fclose(f);
  for (int64_t z = 0; z < Z; ++z)
    for (int64_t y = 0; y < Y; ++y)
      for (int64_t x = 0; x < X; ++x)
        volume[(x * Y + y) * Z + z] = zmajor[(z * Y + y) * X + x];
  return 0;
}

}  // extern "C"
