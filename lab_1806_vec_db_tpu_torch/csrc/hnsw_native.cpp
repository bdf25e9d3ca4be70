// Native (C++) HNSW query engine: low-latency single-query search.
//
// The PyTorch port's own copy of the JAX package's engine
// (native/hnsw_native.cpp), shipped with the port's package so that an
// installed package can build it (models/native.py, g++ at first use).
// Everything from the "Behavior parity" line on is byte-identical to that
// file; tests/test_torch_native.py holds the two equal.  The port serves a
// single query on a host (device="cpu") store with it, over the same dense
// link arrays the device search uses (no separate index format); a CUDA
// store answers a single query on the card.
//
// Behavior parity with the reference implementation:
// - greedy descent through upper levels (hnsw_index.rs:306-350)
// - best-first beam search with ef bound and the `check_candidate`
//   termination rule (hnsw_index.rs:258-291, candidate_pair.rs:55-57)
// - (distance, index) tie ordering (candidate_pair.rs:36-40)
// - L2Sqr / Cosine distances (distance/mod.rs:18-28)
//
// Exposed via the CPython C API (no pybind11 in this environment).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct Level {
  const int32_t* pos;    // (cap,) node id -> row, -1 if absent
  const int32_t* links;  // (n_rows, m)
  Py_ssize_t m;
};

struct View {
  const float* vecs;      // (cap, dim)
  Py_ssize_t dim;
  const int32_t* links0;  // (cap, max_m0)
  Py_ssize_t max_m0;
  std::vector<Level> upper;  // index l-1 => level l
  int dist;  // 0 = l2sqr, 1 = cosine
};

// fast-math scoped to the two distance kernels only: float reassociation
// lets GCC vectorize the reduction (AVX-512 on this host, ~16x the scalar
// chain); inputs are finite and the ~1-ulp reassociation error is far below
// the quantization noise every caller already tolerates.
__attribute__((optimize("fast-math", "tree-vectorize"))) static inline float
dot(const float* a, const float* b, Py_ssize_t d) {
  float s = 0.f;
  for (Py_ssize_t i = 0; i < d; ++i) s += a[i] * b[i];
  return s;
}

__attribute__((optimize("fast-math", "tree-vectorize"))) static inline float
distance(const View& v, const float* q, float q_cache, int32_t idx) {
  const float* x = v.vecs + (Py_ssize_t)idx * v.dim;
  if (v.dist == 0) {
    float s = 0.f;
    for (Py_ssize_t i = 0; i < v.dim; ++i) {
      float t = q[i] - x[i];
      s += t * t;
    }
    return s;
  }
  float d = dot(q, x, v.dim);
  float nx = std::sqrt(dot(x, x, v.dim));
  float denom = std::max(q_cache * nx, 1e-10f);
  return 1.f - d / denom;
}

static inline void prefetch_row(const View& v, int32_t idx) {
  // touch the row head; the hardware prefetcher streams the rest
  if (idx < 0) return;
  const char* p = (const char*)(v.vecs + (Py_ssize_t)idx * v.dim);
  __builtin_prefetch(p, 0, 1);
  __builtin_prefetch(p + 256, 0, 1);
}

struct Cand {
  float d;
  int32_t idx;
};
struct CmpMin {  // min-heap by (d, idx)
  bool operator()(const Cand& a, const Cand& b) const {
    return a.d > b.d || (a.d == b.d && a.idx > b.idx);
  }
};
struct CmpMax {  // max-heap by (d, idx)
  bool operator()(const Cand& a, const Cand& b) const {
    return a.d < b.d || (a.d == b.d && a.idx < b.idx);
  }
};

// Greedy hill-climb on one upper level.
static int32_t greedy_level(const View& v, const Level& lv, const float* q,
                            float q_cache, int32_t cur) {
  float cur_d = distance(v, q, q_cache, cur);
  bool moved = true;
  while (moved) {
    moved = false;
    int32_t row = lv.pos[cur];
    if (row < 0) break;
    const int32_t* nbrs = lv.links + (Py_ssize_t)row * lv.m;
    for (Py_ssize_t j = 0; j < lv.m; ++j) {
      int32_t nb = nbrs[j];
      if (nb < 0) continue;
      float nd = distance(v, q, q_cache, nb);
      if (nd < cur_d) {
        cur_d = nd;
        cur = nb;
        moved = true;
      }
    }
  }
  return cur;
}

// Best-first beam search on level 0 (reference search_on_level_fn shape).
static void search_level0(const View& v, const float* q, float q_cache,
                          int32_t entry, int ef, std::vector<Cand>& out,
                          std::vector<uint8_t>& visited) {
  std::priority_queue<Cand, std::vector<Cand>, CmpMin> queue;
  std::priority_queue<Cand, std::vector<Cand>, CmpMax> result;  // size <= ef

  float ed = distance(v, q, q_cache, entry);
  visited[entry] = 1;
  queue.push({ed, entry});
  result.push({ed, entry});

  while (!queue.empty()) {
    Cand c = queue.top();
    queue.pop();
    if ((int)result.size() >= ef) {
      Cand worst = result.top();
      if (c.d > worst.d || (c.d == worst.d && c.idx > worst.idx)) break;
    }
    const int32_t* nbrs = v.links0 + (Py_ssize_t)c.idx * v.max_m0;
    for (Py_ssize_t j = 0; j < v.max_m0; ++j)
      if (nbrs[j] >= 0 && !visited[nbrs[j]]) prefetch_row(v, nbrs[j]);
    for (Py_ssize_t j = 0; j < v.max_m0; ++j) {
      int32_t nb = nbrs[j];
      if (nb < 0) continue;
      if (visited[nb]) continue;
      visited[nb] = 1;
      float nd = distance(v, q, q_cache, nb);
      if ((int)result.size() < ef) {
        result.push({nd, nb});
        queue.push({nd, nb});
      } else {
        Cand worst = result.top();
        if (nd < worst.d || (nd == worst.d && nb < worst.idx)) {
          result.pop();
          result.push({nd, nb});
          queue.push({nd, nb});
        }
      }
    }
  }
  out.clear();
  out.reserve(result.size());
  while (!result.empty()) {
    out.push_back(result.top());
    result.pop();
  }
  std::reverse(out.begin(), out.end());
}

static bool get_buffer(PyObject* obj, Py_buffer* buf, const char* name,
                       const char* fmt_want) {
  if (PyObject_GetBuffer(obj, buf, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0) {
    return false;
  }
  (void)name;
  (void)fmt_want;
  return true;
}

// hnsw_knn(vecs f32 (cap, dim), links0 i32 (cap, max_m0),
//          upper [(pos i32 (cap,), links i32 (rows, m)), ...],
//          entry int, query f32 (dim,), k int, ef int, dist int,
//          n int) -> (ids list, dists list)
static PyObject* hnsw_knn(PyObject*, PyObject* args) {
  PyObject *vecs_o, *links0_o, *upper_o, *query_o;
  Py_ssize_t entry, k, ef, dist, n;
  if (!PyArg_ParseTuple(args, "OOOnOnnnn", &vecs_o, &links0_o, &upper_o,
                        &entry, &query_o, &k, &ef, &dist, &n)) {
    return nullptr;
  }

  Py_buffer vecs_b{}, links0_b{}, query_b{};
  if (!get_buffer(vecs_o, &vecs_b, "vecs", "f")) return nullptr;
  if (!get_buffer(links0_o, &links0_b, "links0", "i")) {
    PyBuffer_Release(&vecs_b);
    return nullptr;
  }
  if (!get_buffer(query_o, &query_b, "query", "f")) {
    PyBuffer_Release(&vecs_b);
    PyBuffer_Release(&links0_b);
    return nullptr;
  }

  View v{};
  v.vecs = (const float*)vecs_b.buf;
  v.dim = vecs_b.shape[1];
  v.links0 = (const int32_t*)links0_b.buf;
  v.max_m0 = links0_b.shape[1];
  v.dist = (int)dist;

  std::vector<Py_buffer> upper_bufs;
  bool ok = true;
  Py_ssize_t n_upper = PyList_Size(upper_o);
  for (Py_ssize_t l = 0; l < n_upper && ok; ++l) {
    PyObject* pair = PyList_GetItem(upper_o, l);
    PyObject* pos_o = PyTuple_GetItem(pair, 0);
    PyObject* lnk_o = PyTuple_GetItem(pair, 1);
    Py_buffer pb{}, lb{};
    if (!get_buffer(pos_o, &pb, "pos", "i")) {
      ok = false;
      break;
    }
    if (!get_buffer(lnk_o, &lb, "links", "i")) {
      PyBuffer_Release(&pb);
      ok = false;
      break;
    }
    upper_bufs.push_back(pb);
    upper_bufs.push_back(lb);
    Level lv{};
    lv.pos = (const int32_t*)pb.buf;
    lv.links = (const int32_t*)lb.buf;
    lv.m = lb.ndim == 2 ? lb.shape[1] : 0;
    v.upper.push_back(lv);
  }

  PyObject* out = nullptr;
  if (ok) {
    const float* q = (const float*)query_b.buf;
    float q_cache =
        v.dist == 0 ? dot(q, q, v.dim) : std::sqrt(dot(q, q, v.dim));

    std::vector<Cand> res;
    std::vector<uint8_t> visited((size_t)n, 0);
    int32_t cur = (int32_t)entry;

    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t l = (Py_ssize_t)v.upper.size(); l >= 1; --l) {
      cur = greedy_level(v, v.upper[l - 1], q, q_cache, cur);
    }
    search_level0(v, q, q_cache, cur, (int)std::max(ef, k), res, visited);
    Py_END_ALLOW_THREADS

    Py_ssize_t n_out = std::min((Py_ssize_t)res.size(), k);
    PyObject* ids = PyList_New(n_out);
    PyObject* ds = PyList_New(n_out);
    for (Py_ssize_t i = 0; i < n_out; ++i) {
      PyList_SET_ITEM(ids, i, PyLong_FromLong(res[i].idx));
      PyList_SET_ITEM(ds, i, PyFloat_FromDouble(res[i].d));
    }
    out = PyTuple_Pack(2, ids, ds);
    Py_DECREF(ids);
    Py_DECREF(ds);
  }

  for (auto& b : upper_bufs) PyBuffer_Release(&b);
  PyBuffer_Release(&vecs_b);
  PyBuffer_Release(&links0_b);
  PyBuffer_Release(&query_b);
  if (!ok && !PyErr_Occurred()) {
    PyErr_SetString(PyExc_ValueError, "bad upper level buffers");
  }
  return out;
}

// flat_knn(vecs f32 (cap, dim), query f32 (dim,), n int, k int, dist int)
//   -> (ids list, dists list)   — native exact scan for tiny tables where
//   device dispatch costs more than the scan itself.
static PyObject* flat_knn(PyObject*, PyObject* args) {
  PyObject *vecs_o, *query_o;
  Py_ssize_t n, k, dist;
  if (!PyArg_ParseTuple(args, "OOnnn", &vecs_o, &query_o, &n, &k, &dist)) {
    return nullptr;
  }
  Py_buffer vecs_b{}, query_b{};
  if (!get_buffer(vecs_o, &vecs_b, "vecs", "f")) return nullptr;
  if (!get_buffer(query_o, &query_b, "query", "f")) {
    PyBuffer_Release(&vecs_b);
    return nullptr;
  }
  View v{};
  v.vecs = (const float*)vecs_b.buf;
  v.dim = vecs_b.shape[1];
  v.dist = (int)dist;
  const float* q = (const float*)query_b.buf;
  float q_cache = v.dist == 0 ? dot(q, q, v.dim) : std::sqrt(dot(q, q, v.dim));

  std::priority_queue<Cand, std::vector<Cand>, CmpMax> best;
  Py_BEGIN_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; ++i) {
    float d = distance(v, q, q_cache, (int32_t)i);
    if ((Py_ssize_t)best.size() < k) {
      best.push({d, (int32_t)i});
    } else if (d < best.top().d ||
               (d == best.top().d && (int32_t)i < best.top().idx)) {
      best.pop();
      best.push({d, (int32_t)i});
    }
  }
  Py_END_ALLOW_THREADS

  std::vector<Cand> res;
  res.reserve(best.size());
  while (!best.empty()) {
    res.push_back(best.top());
    best.pop();
  }
  std::reverse(res.begin(), res.end());

  PyObject* ids = PyList_New((Py_ssize_t)res.size());
  PyObject* ds = PyList_New((Py_ssize_t)res.size());
  for (Py_ssize_t i = 0; i < (Py_ssize_t)res.size(); ++i) {
    PyList_SET_ITEM(ids, i, PyLong_FromLong(res[i].idx));
    PyList_SET_ITEM(ds, i, PyFloat_FromDouble(res[i].d));
  }
  PyObject* out = PyTuple_Pack(2, ids, ds);
  Py_DECREF(ids);
  Py_DECREF(ds);
  PyBuffer_Release(&vecs_b);
  PyBuffer_Release(&query_b);
  return out;
}

static PyMethodDef methods[] = {
    {"hnsw_knn", hnsw_knn, METH_VARARGS,
     "Serial HNSW kNN over dense link arrays"},
    {"flat_knn", flat_knn, METH_VARARGS, "Serial exact kNN scan"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                                       "_vecdb_native",
                                       "Native HNSW/Flat query engine",
                                       -1,
                                       methods,
                                       nullptr,
                                       nullptr,
                                       nullptr,
                                       nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__vecdb_native(void) {
  return PyModule_Create(&moduledef);
}
