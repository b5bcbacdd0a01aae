// Native runtime for physimglobalpose_tpu_torch: hot host-side paths in C++.
// A copy of the JAX package's runtime/physim_runtime.cc (the same C ABI).
//
// The reference's runtime is C++ end-to-end (PCL/Bullet/GL); the port keeps
// device compute in PyTorch and its CUDA kernels and moves host-side hot
// loops here:
//  - binary/ascii PLY and OBJ mesh parsing (asset load; the Python
//    variable-length face walk is quadratically slow on 40k-face meshes),
//  - the O(N^2) PPF table build (asset prep; see ops/ppf.py for the
//    discretization contract, mirroring match4pcsBase.cc:582-598 + 150-160).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in the image).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- mesh loading

struct MeshOut {
  float* vertices;   // [n_vertices * 3]
  int32_t* faces;    // [n_faces * 3]
  int64_t n_vertices;
  int64_t n_faces;
};

static void mesh_fail(MeshOut* out) {
  out->vertices = nullptr;
  out->faces = nullptr;
  out->n_vertices = 0;
  out->n_faces = 0;
}

void physim_free(void* p) { free(p); }

static const char* find_token(const char* s, const char* tok) {
  return strstr(s, tok);
}

// Parse a PLY file (binary_little_endian or ascii). Returns 0 on success.
int physim_load_ply(const char* path, MeshOut* out) {
  mesh_fail(out);
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return 2;
  }
  fclose(f);
  buf[size] = 0;

  const char* hdr_end = find_token(buf.data(), "end_header");
  if (!hdr_end) return 3;
  const char* body = hdr_end + strlen("end_header");
  while (*body == '\r' || *body == '\n') body++;

  std::string header(buf.data(), hdr_end - buf.data());
  bool binary = header.find("binary_little_endian") != std::string::npos;
  bool ascii = header.find("format ascii") != std::string::npos;
  if (!binary && !ascii) return 4;

  struct Prop {
    int size;        // bytes (binary)
    bool is_double;
    bool is_list;
    int count_size;
    int index_size;
  };
  struct Elem {
    std::string name;
    long count;
    std::vector<Prop> props;
    std::vector<std::string> prop_names;
  };
  auto type_size = [](const std::string& t) -> int {
    if (t == "char" || t == "uchar" || t == "int8" || t == "uint8") return 1;
    if (t == "short" || t == "ushort" || t == "int16" || t == "uint16") return 2;
    if (t == "int" || t == "uint" || t == "int32" || t == "uint32" || t == "float" ||
        t == "float32")
      return 4;
    if (t == "double" || t == "float64") return 8;
    return -1;
  };

  std::vector<Elem> elems;
  {
    size_t pos = 0;
    while (pos < header.size()) {
      size_t eol = header.find('\n', pos);
      if (eol == std::string::npos) eol = header.size();
      std::string line = header.substr(pos, eol - pos);
      pos = eol + 1;
      char a[64], b[64], c[64], d[64], e[64];
      if (sscanf(line.c_str(), "element %63s %63s", a, b) == 2) {
        Elem el;
        el.name = a;
        el.count = atol(b);
        elems.push_back(el);
      } else if (elems.size() &&
                 sscanf(line.c_str(), "property list %63s %63s %63s", a, b, c) == 3) {
        Prop p{};
        p.is_list = true;
        p.count_size = type_size(a);
        p.index_size = type_size(b);
        elems.back().props.push_back(p);
        elems.back().prop_names.push_back(c);
      } else if (elems.size() && sscanf(line.c_str(), "property %63s %63s", d, e) == 2) {
        Prop p{};
        p.size = type_size(d);
        p.is_double = (strcmp(d, "double") == 0 || strcmp(d, "float64") == 0);
        elems.back().props.push_back(p);
        elems.back().prop_names.push_back(e);
      }
    }
  }

  std::vector<float> verts;
  std::vector<int32_t> faces;
  const char* p = body;
  const char* end = buf.data() + size;

  for (const Elem& el : elems) {
    int xi = -1, yi = -1, zi = -1;
    for (size_t i = 0; i < el.prop_names.size(); i++) {
      if (el.prop_names[i] == "x") xi = (int)i;
      if (el.prop_names[i] == "y") yi = (int)i;
      if (el.prop_names[i] == "z") zi = (int)i;
    }
    bool is_vertex = (el.name == "vertex");
    bool is_face = (el.name == "face");
    if (is_vertex) verts.reserve(el.count * 3);

    if (ascii) {
      for (long r = 0; r < el.count; r++) {
        // read one line worth of whitespace-separated tokens
        double vals[64];
        int vcount = 0;
        if (is_face && el.props.size() == 1 && el.props[0].is_list) {
          char* next;
          long k = strtol(p, &next, 10);
          p = next;
          std::vector<long> idx(k);
          for (long j = 0; j < k; j++) {
            idx[j] = strtol(p, &next, 10);
            p = next;
          }
          for (long t = 1; t + 1 <= k - 1; t++) {
            faces.push_back((int32_t)idx[0]);
            faces.push_back((int32_t)idx[t]);
            faces.push_back((int32_t)idx[t + 1]);
          }
          while (p < end && *p != '\n') p++;
          p++;
          continue;
        }
        for (size_t c2 = 0; c2 < el.props.size() && vcount < 64; c2++) {
          char* next;
          vals[vcount++] = strtod(p, &next);
          p = next;
        }
        while (p < end && *p != '\n') p++;
        p++;
        if (is_vertex && xi >= 0) {
          verts.push_back((float)vals[xi]);
          verts.push_back((float)vals[yi]);
          verts.push_back((float)vals[zi]);
        }
      }
    } else {
      for (long r = 0; r < el.count; r++) {
        if (is_vertex) {
          const char* row = p;
          float xyz[3] = {0, 0, 0};
          int off = 0;
          for (size_t c2 = 0; c2 < el.props.size(); c2++) {
            const Prop& pr = el.props[c2];
            if (pr.is_list) return 5;  // list prop on vertex unsupported
            double v = 0;
            if (pr.size == 4 && !pr.is_double) {
              float tmp;
              memcpy(&tmp, row + off, 4);
              v = tmp;
            } else if (pr.size == 8) {
              double tmp;
              memcpy(&tmp, row + off, 8);
              v = tmp;
            }
            if ((int)c2 == xi) xyz[0] = (float)v;
            if ((int)c2 == yi) xyz[1] = (float)v;
            if ((int)c2 == zi) xyz[2] = (float)v;
            off += pr.size;
          }
          verts.push_back(xyz[0]);
          verts.push_back(xyz[1]);
          verts.push_back(xyz[2]);
          p += off;
        } else {
          for (size_t c2 = 0; c2 < el.props.size(); c2++) {
            const Prop& pr = el.props[c2];
            if (!pr.is_list) {
              p += pr.size;
              continue;
            }
            long k = 0;
            if (pr.count_size == 1)
              k = *(const uint8_t*)p;
            else if (pr.count_size == 2) {
              uint16_t tmp;
              memcpy(&tmp, p, 2);
              k = tmp;
            } else {
              uint32_t tmp;
              memcpy(&tmp, p, 4);
              k = tmp;
            }
            p += pr.count_size;
            std::vector<long> idx(k);
            for (long j = 0; j < k; j++) {
              if (pr.index_size == 4) {
                int32_t tmp;
                memcpy(&tmp, p, 4);
                idx[j] = tmp;
              } else if (pr.index_size == 2) {
                uint16_t tmp;
                memcpy(&tmp, p, 2);
                idx[j] = tmp;
              } else {
                idx[j] = *(const uint8_t*)p;
              }
              p += pr.index_size;
            }
            // Only the vertex_indices list yields triangles (face elements
            // may carry extra lists, e.g. per-face texcoords).
            if (is_face && (el.prop_names[c2] == "vertex_indices" ||
                            el.prop_names[c2] == "vertex_index")) {
              for (long t = 1; t + 1 <= k - 1; t++) {
                faces.push_back((int32_t)idx[0]);
                faces.push_back((int32_t)idx[t]);
                faces.push_back((int32_t)idx[t + 1]);
              }
            }
          }
        }
        if (p > end) return 6;
      }
    }
  }

  out->n_vertices = (int64_t)(verts.size() / 3);
  out->n_faces = (int64_t)(faces.size() / 3);
  out->vertices = (float*)malloc(verts.size() * sizeof(float));
  memcpy(out->vertices, verts.data(), verts.size() * sizeof(float));
  out->faces = (int32_t*)malloc(faces.size() * sizeof(int32_t));
  if (!faces.empty()) memcpy(out->faces, faces.data(), faces.size() * sizeof(int32_t));
  return 0;
}

// Parse a Wavefront OBJ (v/f lines, fan triangulation). Returns 0 on success.
int physim_load_obj(const char* path, MeshOut* out) {
  mesh_fail(out);
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  std::vector<float> verts;
  std::vector<int32_t> faces;
  char line[4096];
  while (fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && (line[1] == ' ' || line[1] == '\t')) {
      float x, y, z;
      if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        verts.push_back(x);
        verts.push_back(y);
        verts.push_back(z);
      }
    } else if (line[0] == 'f' && (line[1] == ' ' || line[1] == '\t')) {
      std::vector<long> idx;
      char* tok = strtok(line + 2, " \t\r\n");
      while (tok) {
        idx.push_back(strtol(tok, nullptr, 10) - 1);
        tok = strtok(nullptr, " \t\r\n");
      }
      for (size_t t = 1; t + 1 < idx.size(); t++) {
        faces.push_back((int32_t)idx[0]);
        faces.push_back((int32_t)idx[t]);
        faces.push_back((int32_t)idx[t + 1]);
      }
    }
  }
  fclose(f);
  out->n_vertices = (int64_t)(verts.size() / 3);
  out->n_faces = (int64_t)(faces.size() / 3);
  out->vertices = (float*)malloc(verts.size() * sizeof(float));
  memcpy(out->vertices, verts.data(), verts.size() * sizeof(float));
  out->faces = (int32_t*)malloc(faces.size() * sizeof(int32_t));
  if (!faces.empty()) memcpy(out->faces, faces.data(), faces.size() * sizeof(int32_t));
  return 0;
}

// ---------------------------------------------------------------- PPF build

// Discretization contract shared with ops/ppf.py (reference
// match4pcsBase.cc:582-598, approximate_bin :150-160).
static inline int approx_bin(int val, int disc) {
  int lower = val - (val % disc);
  int upper = lower + disc;
  return (val - lower < upper - val) ? lower : upper;
}

// Build the CSR PPF table over all N^2-N directed pairs.
// Outputs are malloc'd; caller frees with physim_free.
int physim_build_ppf(
    const float* pts,      // [n*3]
    const float* nrm,      // [n*3]
    int64_t n,
    int trans_disc, int rot_disc, int max_dist_mm,
    int32_t** offsets_out,  // [n_bins]
    int32_t** counts_out,   // [n_bins]
    int32_t** pairs_out,    // [total*2]
    int64_t* n_bins_out, int64_t* total_out) {
  const int n_angle = 19;
  const int n_dist = max_dist_mm / trans_disc + 1;
  const int64_t n_bins = (int64_t)n_dist * n_angle * n_angle * n_angle;

  std::vector<int32_t> counts(n_bins, 0);
  std::vector<int64_t> bins;
  bins.reserve(n * n);
  std::vector<int32_t> pair_i, pair_j;
  pair_i.reserve(n * n);
  pair_j.reserve(n * n);

  auto angle_deg = [](const float* a, const float* b) -> int {
    float cx = a[1] * b[2] - a[2] * b[1];
    float cy = a[2] * b[0] - a[0] * b[2];
    float cz = a[0] * b[1] - a[1] * b[0];
    float cr = std::sqrt(cx * cx + cy * cy + cz * cz);
    float dt = a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
    return (int)(std::atan2(cr, dt) * 180.0 / M_PI);
  };

  for (int64_t i = 0; i < n; i++) {
    const float* p1 = pts + 3 * i;
    const float* n1 = nrm + 3 * i;
    for (int64_t j = 0; j < n; j++) {
      if (i == j) continue;
      const float* p2 = pts + 3 * j;
      const float* n2 = nrm + 3 * j;
      float u[3] = {p1[0] - p2[0], p1[1] - p2[1], p1[2] - p2[2]};
      float d = std::sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
      int f1 = (int)(d * 1000.0f);
      int db = approx_bin(f1, trans_disc) / trans_disc;
      if (db >= n_dist) continue;
      int a2 = approx_bin(angle_deg(n1, u), rot_disc) / rot_disc;
      int a3 = approx_bin(angle_deg(n2, u), rot_disc) / rot_disc;
      int a4 = approx_bin(angle_deg(n1, n2), rot_disc) / rot_disc;
      if (a2 > 18) a2 = 18;
      if (a3 > 18) a3 = 18;
      if (a4 > 18) a4 = 18;
      if (a2 < 0) a2 = 0;
      if (a3 < 0) a3 = 0;
      if (a4 < 0) a4 = 0;
      int64_t flat = (((int64_t)db * n_angle + a2) * n_angle + a3) * n_angle + a4;
      bins.push_back(flat);
      pair_i.push_back((int32_t)i);
      pair_j.push_back((int32_t)j);
      counts[flat]++;
    }
  }

  std::vector<int32_t> offsets(n_bins);
  int64_t run = 0;
  for (int64_t b = 0; b < n_bins; b++) {
    offsets[b] = (int32_t)run;
    run += counts[b];
  }
  const int64_t total = run;
  std::vector<int32_t> cursor(offsets.begin(), offsets.end());
  int32_t* pairs = (int32_t*)malloc(sizeof(int32_t) * 2 * (total ? total : 1));
  for (size_t k = 0; k < bins.size(); k++) {
    int32_t at = cursor[bins[k]]++;
    pairs[2 * at] = pair_i[k];
    pairs[2 * at + 1] = pair_j[k];
  }

  *offsets_out = (int32_t*)malloc(sizeof(int32_t) * n_bins);
  memcpy(*offsets_out, offsets.data(), sizeof(int32_t) * n_bins);
  *counts_out = (int32_t*)malloc(sizeof(int32_t) * n_bins);
  memcpy(*counts_out, counts.data(), sizeof(int32_t) * n_bins);
  *pairs_out = pairs;
  *n_bins_out = n_bins;
  *total_out = total;
  return 0;
}

}  // extern "C"
