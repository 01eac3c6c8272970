// Native scene-format codec: fast binary PLY vertex reader/writer.
//
// The analog of the reference's bulk RichPoint loader
// (/root/reference/apps/gsrast/SplatData.cpp:114-156): where the reference
// does one fread of N*sizeof(RichPoint) into an AoS vector, this library
// parses the header, then performs a single pass AoS->SoA de-interleave into
// caller-provided column buffers (the layout the JAX pipeline wants), using
// memcpy-per-field over a stack-allocated stride table. Exposed to Python
// through ctypes (gsrast_tpu/scene/native.py); no pybind11 dependency.
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

namespace {

struct Property {
  std::string name;
  int size;  // bytes
  char kind; // 'f' float, 'd' double, 'i' signed int, 'u' unsigned int
};

struct Header {
  long vertex_count = -1;
  long body_offset = -1;
  bool little_endian = true;
  bool binary = true;
  std::vector<Property> props;
};

int prop_size(const std::string& t, char* kind) {
  if (t == "float" || t == "float32") { *kind = 'f'; return 4; }
  if (t == "double" || t == "float64") { *kind = 'd'; return 8; }
  if (t == "char" || t == "int8") { *kind = 'i'; return 1; }
  if (t == "uchar" || t == "uint8") { *kind = 'u'; return 1; }
  if (t == "short" || t == "int16") { *kind = 'i'; return 2; }
  if (t == "ushort" || t == "uint16") { *kind = 'u'; return 2; }
  if (t == "int" || t == "int32") { *kind = 'i'; return 4; }
  if (t == "uint" || t == "uint32") { *kind = 'u'; return 4; }
  return -1;
}

bool parse_header(FILE* f, Header* h) {
  char line[4096];
  if (!fgets(line, sizeof line, f) || strncmp(line, "ply", 3) != 0) return false;
  bool in_vertex = false;
  while (fgets(line, sizeof line, f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.rfind("format", 0) == 0) {
      h->binary = s.find("binary") != std::string::npos;
      h->little_endian = s.find("big_endian") == std::string::npos;
    } else if (s.rfind("element", 0) == 0) {
      char name[256];
      long cnt;
      if (sscanf(s.c_str(), "element %255s %ld", name, &cnt) == 2) {
        in_vertex = strcmp(name, "vertex") == 0;
        if (in_vertex) h->vertex_count = cnt;
      }
    } else if (s.rfind("property", 0) == 0 && in_vertex) {
      char type[64], name[256];
      if (sscanf(s.c_str(), "property %63s %255s", type, name) == 2) {
        if (strcmp(type, "list") == 0) return false;
        Property p;
        p.name = name;
        p.size = prop_size(type, &p.kind);
        if (p.size < 0) return false;
        h->props.push_back(p);
      }
    } else if (s == "end_header") {
      h->body_offset = ftell(f);
      return h->vertex_count >= 0;
    }
  }
  return false;
}

}  // namespace

extern "C" {

// Parse header only. Returns vertex count (<0 on error); fills the
// property-name list as a '\n'-joined string into `names` (caller buffer).
long gsply_header(const char* path, char* names, long names_cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  bool ok = parse_header(f, &h);
  fclose(f);
  if (!ok) return -2;
  std::string joined;
  for (auto& p : h.props) {
    joined += p.name;
    joined += '\n';
  }
  if ((long)joined.size() + 1 > names_cap) return -3;
  memcpy(names, joined.c_str(), joined.size() + 1);
  return h.vertex_count;
}

// Read the vertex element, de-interleaving every property into float32
// column buffers `out[i]` of length vertex_count, in header property order.
// Returns 0 on success.
int gsply_read_f32(const char* path, float** out, int n_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  Header h;
  if (!parse_header(f, &h) || !h.binary || !h.little_endian) {
    fclose(f);
    return 2;  // python fallback handles ascii / big-endian
  }
  if ((int)h.props.size() != n_out) {
    fclose(f);
    return 3;
  }
  long stride = 0;
  std::vector<long> offsets(h.props.size());
  for (size_t i = 0; i < h.props.size(); i++) {
    offsets[i] = stride;
    stride += h.props[i].size;
  }
  fseek(f, h.body_offset, SEEK_SET);

  const long kChunk = 65536;
  std::vector<unsigned char> buf(kChunk * stride);
  long done = 0;
  while (done < h.vertex_count) {
    long want = h.vertex_count - done;
    if (want > kChunk) want = kChunk;
    long got = (long)fread(buf.data(), stride, want, f);
    if (got <= 0) {
      fclose(f);
      return 4;
    }
    for (size_t p = 0; p < h.props.size(); p++) {
      const Property& pr = h.props[p];
      float* dst = out[p] + done;
      const unsigned char* src = buf.data() + offsets[p];
      if (pr.kind == 'f' && pr.size == 4) {
        for (long r = 0; r < got; r++, src += stride) {
          float v;
          memcpy(&v, src, 4);
          dst[r] = v;
        }
      } else if (pr.kind == 'd') {
        for (long r = 0; r < got; r++, src += stride) {
          double v;
          memcpy(&v, src, 8);
          dst[r] = (float)v;
        }
      } else if (pr.kind == 'u') {
        for (long r = 0; r < got; r++, src += stride) {
          uint32_t v = 0;
          memcpy(&v, src, pr.size);
          dst[r] = (float)v;
        }
      } else {
        for (long r = 0; r < got; r++, src += stride) {
          int32_t v = 0;
          memcpy(&v, src, pr.size);
          // sign-extend smaller ints
          if (pr.size == 1) v = (int8_t)v;
          if (pr.size == 2) v = (int16_t)v;
          dst[r] = (float)v;
        }
      }
    }
    done += got;
  }
  fclose(f);
  return 0;
}

// Write a float32-SoA vertex element as binary_little_endian PLY.
// names: '\n'-joined property names. cols[i]: column i, length n.
int gsply_write_f32(const char* path, const char* names, float** cols,
                    int n_cols, long n) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  fprintf(f, "ply\nformat binary_little_endian 1.0\nelement vertex %ld\n", n);
  {
    std::string s(names);
    size_t pos = 0;
    while (pos < s.size()) {
      size_t nl = s.find('\n', pos);
      if (nl == std::string::npos) nl = s.size();
      fprintf(f, "property float %s\n", s.substr(pos, nl - pos).c_str());
      pos = nl + 1;
    }
  }
  fprintf(f, "end_header\n");
  const long kChunk = 65536;
  std::vector<float> buf(kChunk * n_cols);
  long done = 0;
  while (done < n) {
    long want = n - done;
    if (want > kChunk) want = kChunk;
    for (long r = 0; r < want; r++)
      for (int c = 0; c < n_cols; c++)
        buf[r * n_cols + c] = cols[c][done + r];
    if ((long)fwrite(buf.data(), sizeof(float) * n_cols, want, f) != want) {
      fclose(f);
      return 2;
    }
    done += want;
  }
  fclose(f);
  return 0;
}

}  // extern "C"
