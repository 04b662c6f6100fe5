// Python entry points of the kernel library (module `_pt_kernels`).
//
// The library's C entries are bound with ctypes, whose argument conversion
// costs ~2.4 us a call on the H100 host (tools/torch_rms_norm_probe.py:
// pt_rms_norm refused before any launch). RMSNorm runs 33 times a decode
// step on the host-bound serving path, so its wrapper calls the same C
// entries through these METH_FASTCALL functions instead: the arguments are
// Python ints (pointers, sizes, the stream handle; None for a null
// pointer) and one float, converted here, and the C entry's cudaError_t
// comes back as an int. The paged attention of the decode and
// chunked-prefill steps (16 calls a step, over bf16, f32 or int8 pages), the
// RoPE and cache append before it (16 a step), the old quantize-on-append and
// the streamed weights' dequantization (16 a step) are called the same way.
// Host code only; built into the same shared library, which _build.py also
// imports as an extension module.
#include <Python.h>
#include <stdint.h>

extern "C" int pt_rms_norm(const void* x, const void* w, void* y,
                           int64_t rows, int h, float eps, int mode,
                           void* stream);
extern "C" int pt_rms_norm_bwd(const void* x, const void* g, const void* w,
                               void* gx, void* part, void* gw, int64_t rows,
                               int h, float eps, int mode, int blocks,
                               void* stream);
extern "C" int pt_paged_attention(const void* q, const void* k, const void* v,
                                  void* out, const void* t2b, const void* pos,
                                  const void* bt, int T, int HQ, int HKV,
                                  int D, int bs, int max_blocks, int B,
                                  int dtype, float scale_div, void* stream);
extern "C" int pt_paged_attention_int8(const void* q, const void* k,
                                       const void* v, const void* ks,
                                       const void* vs, void* out,
                                       const void* t2b, const void* pos,
                                       const void* bt, int T, int HQ, int HKV,
                                       int D, int bs, int max_blocks, int B,
                                       int dtype, float scale_div,
                                       void* stream);
extern "C" int pt_kv_quant(const void* k, const void* v, int64_t k_stride,
                           int64_t v_stride, const void* page,
                           const void* slot, void* kc, void* vc, void* ks,
                           void* vs, int T, int HKV, int D, int bs, int dtype,
                           void* stream);
extern "C" int pt_rope_append(const void* qkv, int64_t row_stride,
                              const void* cos, const void* sin,
                              const void* page, const void* slot, void* kc,
                              void* vc, void* ks, void* vs, void* q_out,
                              void* k_out, void* v_out, int T, int HQ,
                              int HKV, int D, int bs, int dtype, int int8,
                              void* stream);
extern "C" int pt_weight_dequant(int mode, int dtype, int n,
                                 const void* const* codes,
                                 const void* const* scales,
                                 void* const* outs, const int* in_dims,
                                 const int* out_dims, void* stream);

namespace {

// A pointer argument: an int, or None for null. False with a Python error
// set if it is neither.
bool as_ptr(PyObject* o, void** out) {
  if (o == Py_None) {
    *out = nullptr;
    return true;
  }
  *out = PyLong_AsVoidPtr(o);
  return !PyErr_Occurred();
}

// An int argument that fits a C int.
bool as_int(PyObject* o, int* out) {
  const long v = PyLong_AsLong(o);
  if (v == -1 && PyErr_Occurred()) return false;
  if (v < INT32_MIN || v > INT32_MAX) {
    PyErr_SetString(PyExc_OverflowError, "argument does not fit a C int");
    return false;
  }
  *out = static_cast<int>(v);
  return true;
}

bool as_int64(PyObject* o, int64_t* out) {
  *out = PyLong_AsLongLong(o);
  return !(*out == -1 && PyErr_Occurred());
}

bool as_float(PyObject* o, float* out) {
  const double v = PyFloat_AsDouble(o);
  if (v == -1.0 && PyErr_Occurred()) return false;
  *out = static_cast<float>(v);
  return true;
}

bool arity(const char* name, Py_ssize_t n, Py_ssize_t want) {
  if (n == want) return true;
  PyErr_Format(PyExc_TypeError, "%s takes %zd arguments (%zd given)", name,
               want, n);
  return false;
}

// rms_norm(x, w, y, rows, h, eps, mode, stream) -> cudaError_t
PyObject* rms_norm(PyObject*, PyObject* const* a, Py_ssize_t n) {
  void *x, *w, *y, *stream;
  int64_t rows;
  int h, mode;
  float eps;
  if (!arity("rms_norm", n, 8) || !as_ptr(a[0], &x) || !as_ptr(a[1], &w) ||
      !as_ptr(a[2], &y) || !as_int64(a[3], &rows) || !as_int(a[4], &h) ||
      !as_float(a[5], &eps) || !as_int(a[6], &mode) ||
      !as_ptr(a[7], &stream))
    return nullptr;
  return PyLong_FromLong(pt_rms_norm(x, w, y, rows, h, eps, mode, stream));
}

// rms_norm_bwd(x, g, w, gx, part, gw, rows, h, eps, mode, blocks, stream)
// -> cudaError_t
PyObject* rms_norm_bwd(PyObject*, PyObject* const* a, Py_ssize_t n) {
  void *x, *g, *w, *gx, *part, *gw, *stream;
  int64_t rows;
  int h, mode, blocks;
  float eps;
  if (!arity("rms_norm_bwd", n, 12) || !as_ptr(a[0], &x) ||
      !as_ptr(a[1], &g) || !as_ptr(a[2], &w) || !as_ptr(a[3], &gx) ||
      !as_ptr(a[4], &part) || !as_ptr(a[5], &gw) ||
      !as_int64(a[6], &rows) || !as_int(a[7], &h) || !as_float(a[8], &eps) ||
      !as_int(a[9], &mode) || !as_int(a[10], &blocks) ||
      !as_ptr(a[11], &stream))
    return nullptr;
  return PyLong_FromLong(pt_rms_norm_bwd(x, g, w, gx, part, gw, rows, h, eps,
                                         mode, blocks, stream));
}

// paged_attention(q, k, v, out, t2b, pos, bt, T, HQ, HKV, D, bs, max_blocks,
// B, dtype, scale_div, stream) -> cudaError_t
PyObject* paged_attention(PyObject*, PyObject* const* a, Py_ssize_t n) {
  void *q, *k, *v, *out, *t2b, *pos, *bt, *stream;
  int T, HQ, HKV, D, bs, max_blocks, B, dtype;
  float scale_div;
  if (!arity("paged_attention", n, 17) || !as_ptr(a[0], &q) ||
      !as_ptr(a[1], &k) || !as_ptr(a[2], &v) || !as_ptr(a[3], &out) ||
      !as_ptr(a[4], &t2b) || !as_ptr(a[5], &pos) || !as_ptr(a[6], &bt) ||
      !as_int(a[7], &T) || !as_int(a[8], &HQ) || !as_int(a[9], &HKV) ||
      !as_int(a[10], &D) || !as_int(a[11], &bs) ||
      !as_int(a[12], &max_blocks) || !as_int(a[13], &B) ||
      !as_int(a[14], &dtype) || !as_float(a[15], &scale_div) ||
      !as_ptr(a[16], &stream))
    return nullptr;
  return PyLong_FromLong(pt_paged_attention(q, k, v, out, t2b, pos, bt, T, HQ,
                                            HKV, D, bs, max_blocks, B, dtype,
                                            scale_div, stream));
}

// paged_attention_int8(q, k, v, ks, vs, out, t2b, pos, bt, T, HQ, HKV, D, bs,
// max_blocks, B, dtype, scale_div, stream) -> cudaError_t
PyObject* paged_attention_int8(PyObject*, PyObject* const* a, Py_ssize_t n) {
  void *q, *k, *v, *ks, *vs, *out, *t2b, *pos, *bt, *stream;
  int T, HQ, HKV, D, bs, max_blocks, B, dtype;
  float scale_div;
  if (!arity("paged_attention_int8", n, 19) || !as_ptr(a[0], &q) ||
      !as_ptr(a[1], &k) || !as_ptr(a[2], &v) || !as_ptr(a[3], &ks) ||
      !as_ptr(a[4], &vs) || !as_ptr(a[5], &out) || !as_ptr(a[6], &t2b) ||
      !as_ptr(a[7], &pos) || !as_ptr(a[8], &bt) || !as_int(a[9], &T) ||
      !as_int(a[10], &HQ) || !as_int(a[11], &HKV) || !as_int(a[12], &D) ||
      !as_int(a[13], &bs) || !as_int(a[14], &max_blocks) ||
      !as_int(a[15], &B) || !as_int(a[16], &dtype) ||
      !as_float(a[17], &scale_div) || !as_ptr(a[18], &stream))
    return nullptr;
  return PyLong_FromLong(pt_paged_attention_int8(q, k, v, ks, vs, out, t2b,
                                                 pos, bt, T, HQ, HKV, D, bs,
                                                 max_blocks, B, dtype,
                                                 scale_div, stream));
}

// kv_quant(k, v, k_stride, v_stride, page, slot, kc, vc, ks, vs, T, HKV, D,
// bs, dtype, stream) -> cudaError_t
PyObject* kv_quant(PyObject*, PyObject* const* a, Py_ssize_t n) {
  void *k, *v, *page, *slot, *kc, *vc, *ks, *vs, *stream;
  int64_t k_stride, v_stride;
  int T, HKV, D, bs, dtype;
  if (!arity("kv_quant", n, 16) || !as_ptr(a[0], &k) || !as_ptr(a[1], &v) ||
      !as_int64(a[2], &k_stride) || !as_int64(a[3], &v_stride) ||
      !as_ptr(a[4], &page) || !as_ptr(a[5], &slot) || !as_ptr(a[6], &kc) ||
      !as_ptr(a[7], &vc) || !as_ptr(a[8], &ks) || !as_ptr(a[9], &vs) ||
      !as_int(a[10], &T) || !as_int(a[11], &HKV) || !as_int(a[12], &D) ||
      !as_int(a[13], &bs) || !as_int(a[14], &dtype) ||
      !as_ptr(a[15], &stream))
    return nullptr;
  return PyLong_FromLong(pt_kv_quant(k, v, k_stride, v_stride, page, slot, kc,
                                     vc, ks, vs, T, HKV, D, bs, dtype,
                                     stream));
}

// rope_append(qkv, row_stride, cos, sin, page, slot, kc, vc, ks, vs, q_out,
// k_out, v_out, T, HQ, HKV, D, bs, dtype, int8, stream) -> cudaError_t
PyObject* rope_append(PyObject*, PyObject* const* a, Py_ssize_t n) {
  void *qkv, *cos, *sin, *page, *slot, *kc, *vc, *ks, *vs, *q_out, *k_out,
      *v_out, *stream;
  int64_t row_stride;
  int T, HQ, HKV, D, bs, dtype, int8;
  if (!arity("rope_append", n, 21) || !as_ptr(a[0], &qkv) ||
      !as_int64(a[1], &row_stride) || !as_ptr(a[2], &cos) ||
      !as_ptr(a[3], &sin) || !as_ptr(a[4], &page) || !as_ptr(a[5], &slot) ||
      !as_ptr(a[6], &kc) || !as_ptr(a[7], &vc) || !as_ptr(a[8], &ks) ||
      !as_ptr(a[9], &vs) || !as_ptr(a[10], &q_out) ||
      !as_ptr(a[11], &k_out) || !as_ptr(a[12], &v_out) ||
      !as_int(a[13], &T) || !as_int(a[14], &HQ) || !as_int(a[15], &HKV) ||
      !as_int(a[16], &D) || !as_int(a[17], &bs) || !as_int(a[18], &dtype) ||
      !as_int(a[19], &int8) || !as_ptr(a[20], &stream))
    return nullptr;
  return PyLong_FromLong(pt_rope_append(qkv, row_stride, cos, sin, page, slot,
                                        kc, vc, ks, vs, q_out, k_out, v_out,
                                        T, HQ, HKV, D, bs, dtype, int8,
                                        stream));
}

// weight_dequant(mode, dtype, n, then four (codes, scales, out, in_dim,
// out_dim) segments, the unused ones (None, None, None, 0, 0), stream)
// -> cudaError_t
PyObject* weight_dequant(PyObject*, PyObject* const* a, Py_ssize_t n) {
  constexpr int kSegments = 4;
  int mode, dtype, count;
  void* codes[kSegments];
  void* scales[kSegments];
  void* outs[kSegments];
  int in_dims[kSegments], out_dims[kSegments];
  void* stream;
  if (!arity("weight_dequant", n, 4 + 5 * kSegments) ||
      !as_int(a[0], &mode) || !as_int(a[1], &dtype) || !as_int(a[2], &count))
    return nullptr;
  for (int i = 0; i < kSegments; ++i) {
    PyObject* const* s = a + 3 + 5 * i;
    if (!as_ptr(s[0], &codes[i]) || !as_ptr(s[1], &scales[i]) ||
        !as_ptr(s[2], &outs[i]) || !as_int(s[3], &in_dims[i]) ||
        !as_int(s[4], &out_dims[i]))
      return nullptr;
  }
  if (!as_ptr(a[3 + 5 * kSegments], &stream)) return nullptr;
  return PyLong_FromLong(pt_weight_dequant(mode, dtype, count, codes, scales,
                                           outs, in_dims, out_dims, stream));
}

PyMethodDef methods[] = {
    {"rms_norm", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(
                     rms_norm)),
     METH_FASTCALL, "pt_rms_norm; returns its cudaError_t"},
    {"rms_norm_bwd",
     reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(rms_norm_bwd)),
     METH_FASTCALL, "pt_rms_norm_bwd; returns its cudaError_t"},
    {"paged_attention",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)()>(paged_attention)),
     METH_FASTCALL, "pt_paged_attention; returns its cudaError_t"},
    {"paged_attention_int8",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)()>(paged_attention_int8)),
     METH_FASTCALL, "pt_paged_attention_int8; returns its cudaError_t"},
    {"kv_quant",
     reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(kv_quant)),
     METH_FASTCALL, "pt_kv_quant; returns its cudaError_t"},
    {"rope_append",
     reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(rope_append)),
     METH_FASTCALL, "pt_rope_append; returns its cudaError_t"},
    {"weight_dequant",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)()>(weight_dequant)),
     METH_FASTCALL, "pt_weight_dequant; returns its cudaError_t"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_pt_kernels",
                      "The kernel library's Python entry points.", -1,
                      methods};

}  // namespace

PyMODINIT_FUNC PyInit__pt_kernels() { return PyModule_Create(&module); }
