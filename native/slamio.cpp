// Native IO runtime for orbslam3_jax: binary vocabulary load/save and
// fast dataset CSV parsing.
//
// The reference fork's flagship addition is a binary DBoW2 vocabulary
// loader (/root/reference/Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:
// 1442 loadFromBinaryFile / :1514 saveToBinaryFile). This implements the
// SAME on-disk format so vocabularies converted by the reference load
// here directly:
//   header:  u32 nb_nodes, u32 size_node, i32 k, i32 L, i32 scoring,
//            i32 weighting
//   record:  i32 parent, u8 desc[32], f32 weight, u8 is_leaf   (41 B)
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

struct VocabHeader {
  uint32_t nb_nodes;  // includes the root (record count = nb_nodes - 1)
  int32_t k;
  int32_t L;
  int32_t scoring;
  int32_t weighting;
};

// Reads the header only. Returns 0 on success.
int vocab_read_header(const char* path, VocabHeader* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint32_t nb_nodes = 0, size_node = 0;
  int32_t k, L, scoring, weighting;
  if (fread(&nb_nodes, 4, 1, f) != 1 || fread(&size_node, 4, 1, f) != 1 ||
      fread(&k, 4, 1, f) != 1 || fread(&L, 4, 1, f) != 1 ||
      fread(&scoring, 4, 1, f) != 1 || fread(&weighting, 4, 1, f) != 1) {
    fclose(f);
    return -2;
  }
  fclose(f);
  if (size_node != 41) return -3;  // parent(4) + desc(32) + weight(4) + leaf(1)
  out->nb_nodes = nb_nodes;
  out->k = k;
  out->L = L;
  out->scoring = scoring;
  out->weighting = weighting;
  return 0;
}

// Reads all node records into caller-allocated arrays sized (nb_nodes-1).
// parent: i32[n], desc: u8[n*32], weight: f32[n], is_leaf: u8[n].
int vocab_read_nodes(const char* path, int32_t* parent, uint8_t* desc,
                     float* weight, uint8_t* is_leaf, int64_t n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, 24, SEEK_SET) != 0) {
    fclose(f);
    return -2;
  }
  std::vector<uint8_t> buf(41);
  for (int64_t i = 0; i < n; ++i) {
    if (fread(buf.data(), 1, 41, f) != 41) {
      fclose(f);
      return -3;
    }
    memcpy(&parent[i], buf.data(), 4);
    memcpy(&desc[i * 32], buf.data() + 4, 32);
    memcpy(&weight[i], buf.data() + 36, 4);
    is_leaf[i] = buf[40];
  }
  fclose(f);
  return 0;
}

// Writes a vocabulary in the fork's binary format.
int vocab_write(const char* path, uint32_t nb_nodes, int32_t k, int32_t L,
                int32_t scoring, int32_t weighting, const int32_t* parent,
                const uint8_t* desc, const float* weight,
                const uint8_t* is_leaf) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint32_t size_node = 41;
  fwrite(&nb_nodes, 4, 1, f);
  fwrite(&size_node, 4, 1, f);
  fwrite(&k, 4, 1, f);
  fwrite(&L, 4, 1, f);
  fwrite(&scoring, 4, 1, f);
  fwrite(&weighting, 4, 1, f);
  int64_t n = (int64_t)nb_nodes - 1;
  for (int64_t i = 0; i < n; ++i) {
    fwrite(&parent[i], 4, 1, f);
    fwrite(&desc[i * 32], 1, 32, f);
    fwrite(&weight[i], 4, 1, f);
    fwrite(&is_leaf[i], 1, 1, f);
  }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Fast CSV parsing for EuRoC-style sensor files: rows of
// "int64_timestamp,<d> floats". Returns number of rows parsed, or -1.
// ts: i64[max_rows], vals: f64[max_rows * d].
// ---------------------------------------------------------------------------
int64_t parse_sensor_csv(const char* path, int d, int64_t* ts, double* vals,
                         int64_t max_rows) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char line[1024];
  int64_t row = 0;
  while (fgets(line, sizeof(line), f) && row < max_rows) {
    if (line[0] == '#' || line[0] == '\n' || line[0] == '\r') continue;
    char* p = line;
    char* end;
    long long t = strtoll(p, &end, 10);
    if (end == p) continue;
    p = end;
    int ok = 1;
    for (int j = 0; j < d; ++j) {
      while (*p == ',' || *p == ' ') ++p;
      double v = strtod(p, &end);
      if (end == p) {
        ok = 0;
        break;
      }
      vals[row * d + j] = v;
      p = end;
    }
    if (!ok) continue;
    ts[row] = (int64_t)t;
    ++row;
  }
  fclose(f);
  return row;
}

}  // extern "C"
