// Native PLY batch loader — the framework's data-IO runtime.
//
// The reference feeds training from a multiprocessing.Pool of python PLY
// parsers (reference: src/in_out.py:172-191). This is the native
// equivalent: a C++ extension that parses PLY vertex data (binary
// little/big endian + ascii) and bulk-loads whole file lists into one
// contiguous float32 buffer with a std::thread pool — no interpreter in the
// hot loop, no per-file numpy allocation.
//
// Exposed via the CPython C API (no pybind11 in this environment):
//   _ply_native.load_file(path)        -> (bytes, n_vertices)
//   _ply_native.load_batch(paths, n_threads) -> (bytes, n_files, n_vertices)
// The python wrapper (geometric_adv_tpu/data/native_loader.py) turns the
// bytes into numpy arrays with zero copies beyond the single buffer.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct PlyProp {
  std::string name;
  int byte_size;   // scalar property size
  bool is_float;   // f4/f8
  bool is_double;
  bool is_list;
  int count_size;  // list count size
  int item_size;   // list item size
};

struct PlyHeader {
  bool ascii = false;
  bool big_endian = false;
  long n_vertex = 0;
  std::vector<PlyProp> vertex_props;
  // trailing elements after vertex are ignored (we only need xyz)
  std::streampos data_start;
  int x_idx = -1, y_idx = -1, z_idx = -1;
};

int type_size(const std::string& t) {
  if (t == "char" || t == "int8" || t == "uchar" || t == "uint8") return 1;
  if (t == "short" || t == "int16" || t == "ushort" || t == "uint16") return 2;
  if (t == "int" || t == "int32" || t == "uint" || t == "uint32" ||
      t == "float" || t == "float32")
    return 4;
  if (t == "double" || t == "float64") return 8;
  return -1;
}

bool parse_header(std::ifstream& f, PlyHeader* h, std::string* err) {
  std::string line;
  if (!std::getline(f, line)) { *err = "empty file"; return false; }
  // strip \r
  if (!line.empty() && line.back() == '\r') line.pop_back();
  if (line != "ply") { *err = "not a PLY file"; return false; }

  bool in_vertex = false;
  bool seen_vertex = false;
  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    std::istringstream ss(line);
    std::string tok;
    ss >> tok;
    if (tok == "comment" || tok == "obj_info") continue;
    if (tok == "format") {
      std::string fmt;
      ss >> fmt;
      h->ascii = (fmt == "ascii");
      h->big_endian = (fmt == "binary_big_endian");
    } else if (tok == "element") {
      std::string name;
      long count;
      ss >> name >> count;
      in_vertex = (name == "vertex");
      if (in_vertex) {
        h->n_vertex = count;
        seen_vertex = true;
      } else if (seen_vertex && !in_vertex) {
        // a later element; vertex props are complete — fine for xyz loading
      }
    } else if (tok == "property") {
      if (!in_vertex) continue;  // only vertex properties matter
      std::string t1;
      ss >> t1;
      PlyProp p{};
      if (t1 == "list") {
        std::string ct, it, nm;
        ss >> ct >> it >> nm;
        p.is_list = true;
        p.count_size = type_size(ct);
        p.item_size = type_size(it);
        p.name = nm;
      } else {
        std::string nm;
        ss >> nm;
        p.byte_size = type_size(t1);
        p.is_float = (t1 == "float" || t1 == "float32");
        p.is_double = (t1 == "double" || t1 == "float64");
        p.name = nm;
      }
      if (p.byte_size < 0 || (p.is_list && (p.count_size < 0 || p.item_size < 0))) {
        *err = "unknown property type in: " + line;
        return false;
      }
      h->vertex_props.push_back(p);
    } else if (tok == "end_header") {
      h->data_start = f.tellg();
      for (size_t i = 0; i < h->vertex_props.size(); i++) {
        if (h->vertex_props[i].name == "x") h->x_idx = (int)i;
        if (h->vertex_props[i].name == "y") h->y_idx = (int)i;
        if (h->vertex_props[i].name == "z") h->z_idx = (int)i;
      }
      if (h->x_idx < 0 || h->y_idx < 0 || h->z_idx < 0) {
        *err = "vertex element missing x/y/z";
        return false;
      }
      return true;
    }
  }
  *err = "no end_header";
  return false;
}

inline float read_scalar_as_float(const unsigned char* p, const PlyProp& prop,
                                  bool big_endian) {
  unsigned char buf[8];
  std::memcpy(buf, p, prop.byte_size);
  if (big_endian) {
    for (int i = 0; i < prop.byte_size / 2; i++)
      std::swap(buf[i], buf[prop.byte_size - 1 - i]);
  }
  if (prop.is_double) {
    double d;
    std::memcpy(&d, buf, 8);
    return (float)d;
  }
  if (prop.is_float) {
    float v;
    std::memcpy(&v, buf, 4);
    return v;
  }
  // integer coordinate types are exotic; treat as int32/int16/int8
  long v = 0;
  std::memcpy(&v, buf, prop.byte_size);
  return (float)v;
}

// Load xyz of one file into out[n_vertex*3]. Returns n_vertex or -1.
long load_ply_xyz(const std::string& path, std::vector<float>* out,
                  std::string* err) {
  std::ifstream f(path, std::ios::binary);
  if (!f) { *err = "cannot open " + path; return -1; }
  PlyHeader h;
  if (!parse_header(f, &h, err)) { *err = path + ": " + *err; return -1; }

  out->resize((size_t)h.n_vertex * 3);

  if (h.ascii) {
    for (long i = 0; i < h.n_vertex; i++) {
      for (size_t j = 0; j < h.vertex_props.size(); j++) {
        const PlyProp& p = h.vertex_props[j];
        if (p.is_list) {
          long cnt; f >> cnt;
          double skip;
          for (long k = 0; k < cnt; k++) f >> skip;
          continue;
        }
        double v; f >> v;
        if ((int)j == h.x_idx) (*out)[i * 3 + 0] = (float)v;
        else if ((int)j == h.y_idx) (*out)[i * 3 + 1] = (float)v;
        else if ((int)j == h.z_idx) (*out)[i * 3 + 2] = (float)v;
      }
    }
    return h.n_vertex;
  }

  // binary: compute the fixed vertex stride (lists in vertex elems are rare
  // and unsupported for the fast path)
  long stride = 0;
  std::vector<long> offsets(h.vertex_props.size());
  for (size_t j = 0; j < h.vertex_props.size(); j++) {
    if (h.vertex_props[j].is_list) {
      *err = path + ": list property inside vertex element unsupported";
      return -1;
    }
    offsets[j] = stride;
    stride += h.vertex_props[j].byte_size;
  }
  std::vector<unsigned char> raw((size_t)h.n_vertex * stride);
  f.read((char*)raw.data(), (std::streamsize)raw.size());
  if (f.gcount() != (std::streamsize)raw.size()) {
    *err = path + ": truncated vertex data";
    return -1;
  }
  const int xi = h.x_idx, yi = h.y_idx, zi = h.z_idx;
  for (long i = 0; i < h.n_vertex; i++) {
    const unsigned char* base = raw.data() + (size_t)i * stride;
    (*out)[i * 3 + 0] = read_scalar_as_float(
        base + offsets[xi], h.vertex_props[xi], h.big_endian);
    (*out)[i * 3 + 1] = read_scalar_as_float(
        base + offsets[yi], h.vertex_props[yi], h.big_endian);
    (*out)[i * 3 + 2] = read_scalar_as_float(
        base + offsets[zi], h.vertex_props[zi], h.big_endian);
  }
  return h.n_vertex;
}

PyObject* py_load_file(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  std::vector<float> data;
  std::string err;
  long n;
  Py_BEGIN_ALLOW_THREADS
  n = load_ply_xyz(path, &data, &err);
  Py_END_ALLOW_THREADS
  if (n < 0) {
    PyErr_SetString(PyExc_ValueError, err.c_str());
    return nullptr;
  }
  PyObject* bytes =
      PyBytes_FromStringAndSize((const char*)data.data(),
                                (Py_ssize_t)(data.size() * sizeof(float)));
  if (!bytes) return nullptr;
  return Py_BuildValue("(Nl)", bytes, n);
}

PyObject* py_load_batch(PyObject*, PyObject* args) {
  PyObject* path_list;
  int n_threads = 8;
  if (!PyArg_ParseTuple(args, "O|i", &path_list, &n_threads)) return nullptr;
  if (!PyList_Check(path_list)) {
    PyErr_SetString(PyExc_TypeError, "expected a list of paths");
    return nullptr;
  }
  Py_ssize_t n_files = PyList_Size(path_list);
  if (n_files == 0) {
    PyErr_SetString(PyExc_ValueError, "empty path list");
    return nullptr;
  }
  std::vector<std::string> paths(n_files);
  for (Py_ssize_t i = 0; i < n_files; i++) {
    PyObject* item = PyList_GetItem(path_list, i);
    const char* s = PyUnicode_AsUTF8(item);
    if (!s) return nullptr;
    paths[i] = s;
  }

  // first file defines n_vertex (homogeneous batch, like the reference's
  // preallocated [len(files), n, 3] array, src/in_out.py:173-175)
  std::string err0;
  std::vector<float> first;
  long n_vertex = -1;
  Py_BEGIN_ALLOW_THREADS
  n_vertex = load_ply_xyz(paths[0], &first, &err0);
  Py_END_ALLOW_THREADS
  if (n_vertex < 0) {
    PyErr_SetString(PyExc_ValueError, err0.c_str());
    return nullptr;
  }

  size_t per_file = (size_t)n_vertex * 3;
  PyObject* bytes =
      PyBytes_FromStringAndSize(nullptr,
                                (Py_ssize_t)(per_file * n_files * sizeof(float)));
  if (!bytes) return nullptr;
  float* out = (float*)PyBytes_AsString(bytes);
  std::memcpy(out, first.data(), per_file * sizeof(float));

  std::atomic<long> next(1);
  std::atomic<bool> failed(false);
  std::string fail_msg;
  std::mutex fail_mu;

  auto worker = [&]() {
    std::vector<float> buf;
    std::string err;
    while (true) {
      long i = next.fetch_add(1);
      if (i >= (long)n_files || failed.load()) return;
      long n = load_ply_xyz(paths[i], &buf, &err);
      if (n != n_vertex) {
        std::lock_guard<std::mutex> lk(fail_mu);
        failed.store(true);
        fail_msg = n < 0 ? err
                         : paths[i] + ": vertex count mismatch in batch";
        return;
      }
      std::memcpy(out + (size_t)i * per_file, buf.data(),
                  per_file * sizeof(float));
    }
  };

  Py_BEGIN_ALLOW_THREADS
  {
    int nt = n_threads < 1 ? 1 : n_threads;
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; t++) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  Py_END_ALLOW_THREADS

  if (failed.load()) {
    Py_DECREF(bytes);
    PyErr_SetString(PyExc_ValueError, fail_msg.c_str());
    return nullptr;
  }
  return Py_BuildValue("(Nnl)", bytes, (Py_ssize_t)n_files, n_vertex);
}

PyMethodDef methods[] = {
    {"load_file", py_load_file, METH_VARARGS,
     "load_file(path) -> (float32 bytes, n_vertices)"},
    {"load_batch", py_load_batch, METH_VARARGS,
     "load_batch(paths, n_threads=8) -> (float32 bytes, n_files, n_vertices)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ply_native",
    "Native PLY batch loader", -1, methods,
};

}  // namespace

extern "C" PyMODINIT_FUNC PyInit__ply_native(void) {
  return PyModule_Create(&moduledef);
}
