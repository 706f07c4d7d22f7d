// Native scene-container parser.
//
// Counterpart of the reference's loadModel file parse
// (test/RaytraceTest.cpp:87-198). Format:
//   [i32 nMeshes] then per mesh:
//     [i32 nQuads][f32 fileAlbedo]
//     nQuads x [4 x i32] quad vertex indices
//     [i32 nVerts]
//     nVerts x [4 x f32] xyzw positions
//
// This library does the *I/O and layout* work (read, validate, expose flat
// arrays); the semantic material assignment (light detection, per-mesh-index
// overrides, quad→triangle split) stays in Python where it is unit-tested
// against the reference's quirks (scene/loader.py). C ABI for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Mesh {
  float file_albedo = 0.f;
  std::vector<int32_t> quads;  // nQuads * 4
  std::vector<float> verts;    // nVerts * 4 (xyzw as stored)
};

struct SceneFile {
  std::vector<Mesh> meshes;
};

bool read_exact(FILE* f, void* dst, size_t n) {
  return fread(dst, 1, n, f) == n;
}

}  // namespace

extern "C" {

// Returns an opaque handle or nullptr on parse failure. `err` (optional,
// >=256 bytes) receives a message on failure.
void* oclpt_scene_load(const char* path, char* err, int err_len) {
  auto fail = [&](const char* msg) -> void* {
    if (err && err_len > 0) snprintf(err, err_len, "%s", msg);
    return nullptr;
  };
  FILE* f = fopen(path, "rb");
  if (!f) return fail("cannot open scene file");

  SceneFile* s = new SceneFile();
  int32_t n_meshes = 0;
  if (!read_exact(f, &n_meshes, 4) || n_meshes < 0 || n_meshes > 1 << 20) {
    delete s; fclose(f); return fail("bad mesh count");
  }
  s->meshes.resize(n_meshes);
  for (int32_t i = 0; i < n_meshes; ++i) {
    Mesh& m = s->meshes[i];
    int32_t n_quads = 0;
    if (!read_exact(f, &n_quads, 4) || n_quads < 0 || n_quads > 1 << 24) {
      delete s; fclose(f); return fail("bad quad count");
    }
    if (!read_exact(f, &m.file_albedo, 4)) {
      delete s; fclose(f); return fail("truncated albedo");
    }
    m.quads.resize(size_t(n_quads) * 4);
    if (n_quads && !read_exact(f, m.quads.data(), m.quads.size() * 4)) {
      delete s; fclose(f); return fail("truncated quad indices");
    }
    int32_t n_verts = 0;
    if (!read_exact(f, &n_verts, 4) || n_verts < 0 || n_verts > 1 << 24) {
      delete s; fclose(f); return fail("bad vert count");
    }
    m.verts.resize(size_t(n_verts) * 4);
    if (n_verts && !read_exact(f, m.verts.data(), m.verts.size() * 4)) {
      delete s; fclose(f); return fail("truncated vertices");
    }
  }
  // Trailing-bytes check (parity with loader.py's strict parse).
  long pos = ftell(f);
  fseek(f, 0, SEEK_END);
  long end = ftell(f);
  fclose(f);
  if (pos != end) { delete s; return fail("trailing bytes in scene file"); }
  return s;
}

int oclpt_scene_n_meshes(void* h) {
  return (int)static_cast<SceneFile*>(h)->meshes.size();
}

float oclpt_mesh_albedo(void* h, int i) {
  return static_cast<SceneFile*>(h)->meshes[i].file_albedo;
}

int oclpt_mesh_n_quads(void* h, int i) {
  return (int)(static_cast<SceneFile*>(h)->meshes[i].quads.size() / 4);
}

int oclpt_mesh_n_verts(void* h, int i) {
  return (int)(static_cast<SceneFile*>(h)->meshes[i].verts.size() / 4);
}

void oclpt_mesh_quads(void* h, int i, int32_t* out) {
  const auto& q = static_cast<SceneFile*>(h)->meshes[i].quads;
  memcpy(out, q.data(), q.size() * 4);
}

void oclpt_mesh_verts(void* h, int i, float* out) {
  const auto& v = static_cast<SceneFile*>(h)->meshes[i].verts;
  memcpy(out, v.data(), v.size() * 4);
}

void oclpt_scene_free(void* h) { delete static_cast<SceneFile*>(h); }

}  // extern "C"
