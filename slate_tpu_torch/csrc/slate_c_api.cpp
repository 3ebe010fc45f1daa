// The C API of slate_tpu_torch: the entry points of include/slate_tpu.h over
// the PyTorch port.
//
// Each entry point checks its LAPACK-style arguments here, before the runtime
// starts, then calls one function of the Python module slate_tpu_torch.c_api
// (slate_<name> calls c_api.<name>) with its scalars as Python numbers and
// strings and its buffers as memoryviews over the caller's memory (writable
// where the header lets the routine write).  The Python side views them
// column-major and writes results back through them.
//
// One interpreter serves the process.  In a C or Fortran program the first
// call starts one (Py_InitializeEx) and puts the checkout this library was
// built from first on sys.path; loaded into a Python process (ctypes), the
// library uses that process's interpreter.  Either way every entry point
// takes the interpreter's lock for its call (PyGILState_Ensure).
//
// Codes: a failed start of the runtime returns -999 (slate_init, the first
// call), a Python exception -998; both print the reason on stderr.

#include <Python.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstdlib>
#include <string>

#include "slate_tpu.h"

namespace {

PyObject* g_mod = nullptr;      // slate_tpu_torch.c_api
bool g_we_initialized = false;  // this library started the interpreter

// The directory that holds slate_tpu_torch/: the library lives in
// <root>/slate_tpu_torch/_build/.
std::string checkout_root() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(&checkout_root), &info) == 0 ||
      info.dli_fname == nullptr)
    return "";
  char* real = realpath(info.dli_fname, nullptr);
  if (real == nullptr) return "";
  std::string path = real;
  free(real);
  for (int up = 0; up < 3; ++up) {
    size_t cut = path.find_last_of('/');
    if (cut == std::string::npos) return "";
    path.resize(cut);
  }
  return path;
}

int ensure_init() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
    PyEval_SaveThread();  // every entry point takes the lock itself
  }
  if (g_mod != nullptr) return 0;
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = 0;
  if (g_we_initialized) {
    std::string root = checkout_root();
    PyObject* path = PySys_GetObject("path");  // borrowed
    PyObject* entry = PyUnicode_DecodeFSDefault(root.c_str());
    if (path != nullptr && entry != nullptr && !root.empty() &&
        PySequence_Contains(path, entry) == 0)
      PyList_Insert(path, 0, entry);
    Py_XDECREF(entry);
  }
  PyObject* mod = PyImport_ImportModule("slate_tpu_torch.c_api");
  PyObject* r = mod != nullptr ? PyObject_CallMethod(mod, "init", nullptr) : nullptr;
  if (r == nullptr) {
    PyErr_Print();
    Py_XDECREF(mod);
    rc = -999;
  } else {
    Py_DECREF(r);
    g_mod = mod;
  }
  PyGILState_Release(gil);
  return rc;
}

// Python values for the argument tuple (new references).
PyObject* py(int v) { return PyLong_FromLong(v); }
PyObject* py(long v) { return PyLong_FromLong(v); }
PyObject* py(double v) { return PyFloat_FromDouble(v); }
PyObject* py(char v) { return PyUnicode_FromOrdinal(static_cast<unsigned char>(v)); }
PyObject* py(PyObject* v) { return v; }  // steals

// A memoryview over `bytes` of the caller's memory, None for a NULL pointer.
PyObject* mem(void* p, int64_t bytes) {
  if (p == nullptr) Py_RETURN_NONE;
  return PyMemoryView_FromMemory(static_cast<char*>(p), bytes, PyBUF_WRITE);
}
PyObject* cmem(const void* p, int64_t bytes) {  // read-only
  if (p == nullptr) Py_RETURN_NONE;
  return PyMemoryView_FromMemory(static_cast<char*>(const_cast<void*>(p)), bytes,
                                 PyBUF_READ);
}

PyObject* pack() { return PyTuple_New(0); }

template <class... T>
PyObject* pack(T... v) {
  PyObject* items[] = {py(v)...};
  PyObject* t = PyTuple_New(sizeof...(v));
  for (size_t i = 0; i < sizeof...(v); ++i) {
    if (items[i] == nullptr || t == nullptr) {
      for (PyObject* o : items) Py_XDECREF(o);
      Py_XDECREF(t);
      return nullptr;
    }
  }
  for (size_t i = 0; i < sizeof...(v); ++i) PyTuple_SET_ITEM(t, i, items[i]);
  return t;
}

// One entry point's call: the runtime started and the interpreter's lock held
// for its lifetime (ok false when the runtime did not start).
struct Call {
  PyGILState_STATE gil;
  bool ok = false;
  Call() {
    if (ensure_init() != 0) return;
    gil = PyGILState_Ensure();
    ok = true;
  }
  ~Call() {
    if (ok) PyGILState_Release(gil);
  }
  Call(const Call&) = delete;
  Call& operator=(const Call&) = delete;

  // c_api.<fn>(*args) (args stolen): its result, or nullptr with the
  // exception printed
  PyObject* run(const char* fn, PyObject* args) {
    PyObject* r = nullptr;
    if (args != nullptr) {
      PyObject* f = PyObject_GetAttrString(g_mod, fn);
      if (f != nullptr) r = PyObject_CallObject(f, args);
      Py_XDECREF(f);
      Py_DECREF(args);
    }
    if (r == nullptr) PyErr_Print();
    return r;
  }

  // the result as an int code: info, a handle, or -998 on an exception
  int64_t code(const char* fn, PyObject* args) {
    PyObject* r = run(fn, args);
    if (r == nullptr) return -998;
    long long v = r == Py_None ? 0 : PyLong_AsLongLong(r);
    Py_DECREF(r);
    if (v == -1 && PyErr_Occurred()) {
      PyErr_Print();
      return -998;
    }
    return v;
  }

  int info(const char* fn, PyObject* args) {
    return static_cast<int>(code(fn, args));
  }

  // the handle's (rows, cols); false when there is no such handle
  bool shape(int64_t h, int64_t* rows, int64_t* cols) {
    PyObject* r = run("matrix_shape", pack(h));
    bool ok = r != nullptr && PyTuple_Check(r) && PyTuple_Size(r) == 2;
    if (ok) {
      *rows = PyLong_AsLongLong(PyTuple_GET_ITEM(r, 0));
      *cols = PyLong_AsLongLong(PyTuple_GET_ITEM(r, 1));
    }
    Py_XDECREF(r);
    return ok;
  }
};

bool is_n(char c) { return c == 'n' || c == 'N'; }
bool is_v(char c) { return c == 'v' || c == 'V'; }
bool is_left(char c) { return c == 'l' || c == 'L'; }
int64_t at_least_1(int64_t v) { return v > 1 ? v : 1; }

// alpha / beta of the complex gemms: one interleaved element each
struct Element {
  const void* p;
  int64_t esz;
};
PyObject* py(Element e) { return cmem(e.p, e.esz); }

template <class S>
int gemm_impl(const char* fn, char transa, char transb, int64_t m, int64_t n, int64_t k,
              S alpha, const void* A, int64_t lda, const void* B, int64_t ldb, S beta,
              void* C, int64_t ldc, int64_t esz) {
  int64_t acols = is_n(transa) ? k : m;
  int64_t bcols = is_n(transb) ? n : k;
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(transa, transb, m, n, k, alpha, cmem(A, lda * acols * esz), lda,
                         cmem(B, ldb * bcols * esz), ldb, beta, mem(C, ldc * n * esz),
                         ldc));
}

int gesv_impl(const char* fn, int64_t n, int64_t nrhs, void* A, int64_t lda,
              int64_t* ipiv, void* B, int64_t ldb, int64_t esz) {
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(n, nrhs, mem(A, lda * n * esz), lda, mem(ipiv, n * 8),
                         mem(B, ldb * nrhs * esz), ldb));
}

int posv_impl(const char* fn, char uplo, int64_t n, int64_t nrhs, void* A, int64_t lda,
              void* B, int64_t ldb, int64_t esz) {
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(uplo, n, nrhs, mem(A, lda * n * esz), lda,
                         mem(B, ldb * nrhs * esz), ldb));
}

int potrf_impl(const char* fn, char uplo, int64_t n, void* A, int64_t lda, int64_t esz) {
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(uplo, n, mem(A, lda * n * esz), lda));
}

int getrf_impl(const char* fn, int64_t m, int64_t n, void* A, int64_t lda, int64_t* ipiv,
               int64_t esz) {
  Call c;
  if (!c.ok) return -999;
  int64_t k = m < n ? m : n;
  return c.info(fn, pack(m, n, mem(A, lda * n * esz), lda, mem(ipiv, k * 8)));
}

int getrs_impl(const char* fn, char trans, int64_t n, int64_t nrhs, const void* A,
               int64_t lda, const int64_t* ipiv, void* B, int64_t ldb, int64_t esz) {
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(trans, n, nrhs, cmem(A, lda * n * esz), lda, cmem(ipiv, n * 8),
                         mem(B, ldb * nrhs * esz), ldb));
}

int trsm_impl(const char* fn, char side, char uplo, char transa, char diag, int64_t m,
              int64_t n, double alpha, const void* A, int64_t lda, void* B, int64_t ldb,
              int64_t esz) {
  int64_t ka = is_left(side) ? m : n;
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(side, uplo, transa, diag, m, n, alpha, cmem(A, lda * ka * esz),
                         lda, mem(B, ldb * n * esz), ldb));
}

int heev_impl(const char* fn, char jobz, char uplo, int64_t n, void* A, int64_t lda,
              void* W, int64_t esz, int64_t wsz) {
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(jobz, uplo, n, mem(A, lda * n * esz), lda, mem(W, n * wsz)));
}

int gesvd_impl(const char* fn, char jobu, char jobvt, int64_t m, int64_t n, void* A,
               int64_t lda, double* S, void* U, int64_t ldu, void* VT, int64_t ldvt,
               int64_t esz) {
  Call c;
  if (!c.ok) return -999;
  int64_t k = m < n ? m : n;
  return c.info(fn, pack(jobu, jobvt, m, n, mem(A, lda * n * esz), lda, mem(S, k * 8),
                         mem(U, ldu * k * esz), ldu, mem(VT, ldvt * n * esz), ldvt));
}

int pbsv_impl(const char* fn, char uplo, int64_t n, int64_t kd, int64_t nrhs, void* AB,
              int64_t ldab, void* B, int64_t ldb, int64_t esz) {
  if (ldab < kd + 1) return -6;
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(uplo, n, kd, nrhs, mem(AB, ldab * n * esz), ldab,
                         mem(B, ldb * nrhs * esz), ldb));
}

int gbsv_impl(const char* fn, int64_t n, int64_t kl, int64_t ku, int64_t nrhs,
              const void* AB, int64_t ldab, void* B, int64_t ldb, int64_t esz) {
  if (ldab < 2 * kl + ku + 1) return -6;  // the dgbsv layout, factor rows included
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(n, kl, ku, nrhs, cmem(AB, ldab * n * esz), ldab,
                         mem(B, ldb * nrhs * esz), ldb));
}

int sysv_impl(const char* fn, char uplo, int64_t n, int64_t nrhs, const void* A,
              int64_t lda, void* B, int64_t ldb, int64_t esz) {
  Call c;
  if (!c.ok) return -999;
  return c.info(fn, pack(uplo, n, nrhs, cmem(A, lda * n * esz), lda,
                         mem(B, ldb * nrhs * esz), ldb));
}

int64_t create_impl(const char* fn, int64_t m, int64_t n, const void* data, int64_t lda,
                    int64_t esz) {
  Call c;
  if (!c.ok) return 0;
  int64_t h = c.code(fn, pack(m, n, cmem(data, lda * n * esz), lda));
  return h > 0 ? h : 0;
}

int read_impl(const char* fn, int64_t h, void* out, int64_t ld, int64_t esz) {
  Call c;
  if (!c.ok) return -999;
  int64_t rows, cols;
  if (!c.shape(h, &rows, &cols)) return -1;
  if (ld < rows) return -7;  // an undersized ld has a code of its own
  return c.info(fn, pack(h, mem(out, ld * cols * esz), ld));
}

}  // namespace

extern "C" {

int slate_init(void) { return ensure_init(); }

void slate_finalize(void) {
  if (!Py_IsInitialized()) return;
  if (g_mod != nullptr) {
    // the device finishes and the process group ends before the interpreter
    PyGILState_STATE gil = PyGILState_Ensure();
    PyObject* r = PyObject_CallMethod(g_mod, "finalize", nullptr);
    if (r == nullptr) PyErr_Print();
    Py_XDECREF(r);
    Py_CLEAR(g_mod);
    PyGILState_Release(gil);
  }
  if (g_we_initialized) {
    PyGILState_Ensure();
    Py_Finalize();
    g_we_initialized = false;
  }
}

const char* slate_version(void) { return "slate_tpu_torch-c-api 2.0"; }

int slate_gridinit(int p, int q) {
  Call c;
  if (!c.ok) return -999;
  return c.info("gridinit", pack(p, q));
}

void slate_gridexit(void) {
  Call c;
  if (c.ok) c.info("gridexit", pack());
}

// BLAS-3 ---------------------------------------------------------------------

int slate_dgemm(char transa, char transb, int64_t m, int64_t n, int64_t k, double alpha,
                const double* A, int64_t lda, const double* B, int64_t ldb, double beta,
                double* C, int64_t ldc) {
  return gemm_impl("dgemm", transa, transb, m, n, k, alpha, A, lda, B, ldb, beta, C, ldc,
                   8);
}

int slate_sgemm(char transa, char transb, int64_t m, int64_t n, int64_t k, float alpha,
                const float* A, int64_t lda, const float* B, int64_t ldb, float beta,
                float* C, int64_t ldc) {
  return gemm_impl("sgemm", transa, transb, m, n, k, double(alpha), A, lda, B, ldb,
                   double(beta), C, ldc, 4);
}

int slate_zgemm(char transa, char transb, int64_t m, int64_t n, int64_t k,
                const void* alpha, const void* A, int64_t lda, const void* B, int64_t ldb,
                const void* beta, void* C, int64_t ldc) {
  return gemm_impl("zgemm", transa, transb, m, n, k, Element{alpha, 16}, A, lda, B, ldb,
                   Element{beta, 16}, C, ldc, 16);
}

int slate_cgemm(char transa, char transb, int64_t m, int64_t n, int64_t k,
                const void* alpha, const void* A, int64_t lda, const void* B, int64_t ldb,
                const void* beta, void* C, int64_t ldc) {
  return gemm_impl("cgemm", transa, transb, m, n, k, Element{alpha, 8}, A, lda, B, ldb,
                   Element{beta, 8}, C, ldc, 8);
}

// linear systems -----------------------------------------------------------

int slate_dgesv(int64_t n, int64_t nrhs, double* A, int64_t lda, int64_t* ipiv, double* B,
                int64_t ldb) {
  return gesv_impl("dgesv", n, nrhs, A, lda, ipiv, B, ldb, 8);
}

int slate_sgesv(int64_t n, int64_t nrhs, float* A, int64_t lda, int64_t* ipiv, float* B,
                int64_t ldb) {
  return gesv_impl("sgesv", n, nrhs, A, lda, ipiv, B, ldb, 4);
}

int slate_zgesv(int64_t n, int64_t nrhs, void* A, int64_t lda, int64_t* ipiv, void* B,
                int64_t ldb) {
  return gesv_impl("zgesv", n, nrhs, A, lda, ipiv, B, ldb, 16);
}

int slate_cgesv(int64_t n, int64_t nrhs, void* A, int64_t lda, int64_t* ipiv, void* B,
                int64_t ldb) {
  return gesv_impl("cgesv", n, nrhs, A, lda, ipiv, B, ldb, 8);
}

int slate_dposv(char uplo, int64_t n, int64_t nrhs, double* A, int64_t lda, double* B,
                int64_t ldb) {
  return posv_impl("dposv", uplo, n, nrhs, A, lda, B, ldb, 8);
}

int slate_sposv(char uplo, int64_t n, int64_t nrhs, float* A, int64_t lda, float* B,
                int64_t ldb) {
  return posv_impl("sposv", uplo, n, nrhs, A, lda, B, ldb, 4);
}

int slate_zposv(char uplo, int64_t n, int64_t nrhs, void* A, int64_t lda, void* B,
                int64_t ldb) {
  return posv_impl("zposv", uplo, n, nrhs, A, lda, B, ldb, 16);
}

int slate_cposv(char uplo, int64_t n, int64_t nrhs, void* A, int64_t lda, void* B,
                int64_t ldb) {
  return posv_impl("cposv", uplo, n, nrhs, A, lda, B, ldb, 8);
}

int slate_dpotrf(char uplo, int64_t n, double* A, int64_t lda) {
  return potrf_impl("dpotrf", uplo, n, A, lda, 8);
}

int slate_spotrf(char uplo, int64_t n, float* A, int64_t lda) {
  return potrf_impl("spotrf", uplo, n, A, lda, 4);
}

int slate_zpotrf(char uplo, int64_t n, void* A, int64_t lda) {
  return potrf_impl("zpotrf", uplo, n, A, lda, 16);
}

int slate_cpotrf(char uplo, int64_t n, void* A, int64_t lda) {
  return potrf_impl("cpotrf", uplo, n, A, lda, 8);
}

int slate_dgetrf(int64_t m, int64_t n, double* A, int64_t lda, int64_t* ipiv) {
  return getrf_impl("dgetrf", m, n, A, lda, ipiv, 8);
}

int slate_sgetrf(int64_t m, int64_t n, float* A, int64_t lda, int64_t* ipiv) {
  return getrf_impl("sgetrf", m, n, A, lda, ipiv, 4);
}

int slate_dgetrs(char trans, int64_t n, int64_t nrhs, const double* A, int64_t lda,
                 const int64_t* ipiv, double* B, int64_t ldb) {
  return getrs_impl("dgetrs", trans, n, nrhs, A, lda, ipiv, B, ldb, 8);
}

int slate_sgetrs(char trans, int64_t n, int64_t nrhs, const float* A, int64_t lda,
                 const int64_t* ipiv, float* B, int64_t ldb) {
  return getrs_impl("sgetrs", trans, n, nrhs, A, lda, ipiv, B, ldb, 4);
}

int slate_dtrsm(char side, char uplo, char transa, char diag, int64_t m, int64_t n,
                double alpha, const double* A, int64_t lda, double* B, int64_t ldb) {
  return trsm_impl("dtrsm", side, uplo, transa, diag, m, n, alpha, A, lda, B, ldb, 8);
}

int slate_strsm(char side, char uplo, char transa, char diag, int64_t m, int64_t n,
                float alpha, const float* A, int64_t lda, float* B, int64_t ldb) {
  return trsm_impl("strsm", side, uplo, transa, diag, m, n, alpha, A, lda, B, ldb, 4);
}

int slate_dgels(char trans, int64_t m, int64_t n, int64_t nrhs, double* A, int64_t lda,
                double* B, int64_t ldb) {
  Call c;
  if (!c.ok) return -999;
  return c.info("dgels", pack(trans, m, n, nrhs, mem(A, lda * n * 8), lda,
                              mem(B, ldb * nrhs * 8), ldb));
}

// eigen / SVD --------------------------------------------------------------

int slate_dsyev(char jobz, char uplo, int64_t n, double* A, int64_t lda, double* W) {
  return heev_impl("dsyev", jobz, uplo, n, A, lda, W, 8, 8);
}

int slate_zheev(char jobz, char uplo, int64_t n, void* A, int64_t lda, double* W) {
  return heev_impl("zheev", jobz, uplo, n, A, lda, W, 16, 8);
}

int slate_cheev(char jobz, char uplo, int64_t n, void* A, int64_t lda, float* W) {
  return heev_impl("cheev", jobz, uplo, n, A, lda, W, 8, 4);
}

int slate_dgesvd(char jobu, char jobvt, int64_t m, int64_t n, double* A, int64_t lda,
                 double* S, double* U, int64_t ldu, double* VT, int64_t ldvt) {
  return gesvd_impl("dgesvd", jobu, jobvt, m, n, A, lda, S, U, ldu, VT, ldvt, 8);
}

int slate_zgesvd(char jobu, char jobvt, int64_t m, int64_t n, void* A, int64_t lda,
                 double* S, void* U, int64_t ldu, void* VT, int64_t ldvt) {
  return gesvd_impl("zgesvd", jobu, jobvt, m, n, A, lda, S, U, ldu, VT, ldvt, 16);
}

int slate_dsyevx(char jobz, char uplo, int64_t n, double* A, int64_t lda, int64_t il,
                 int64_t iu, double* W, double* Z, int64_t ldz) {
  // -(1-based position of the first invalid argument), before the runtime
  bool wantz = is_v(jobz);
  if (!wantz && !is_n(jobz)) return -1;
  if (uplo != 'l' && uplo != 'L' && uplo != 'u' && uplo != 'U') return -2;
  if (n < 0) return -3;
  if (A == nullptr) return -4;
  if (lda < at_least_1(n)) return -5;
  if (il < 1) return -6;
  if (iu > n || iu < il) return -7;
  if (W == nullptr) return -8;
  if (wantz && Z == nullptr) return -9;
  if (wantz && ldz < at_least_1(n)) return -10;
  Call c;
  if (!c.ok) return -999;
  int64_t k = iu - il + 1;
  return c.info("dsyevx", pack(jobz, uplo, n, mem(A, lda * n * 8), lda, il, iu,
                               mem(W, k * 8), mem(Z, ldz * k * 8), ldz));
}

int slate_dgesvdx(char jobu, char jobvt, int64_t m, int64_t n, double* A, int64_t lda,
                  int64_t il, int64_t iu, double* S, double* U, int64_t ldu, double* VT,
                  int64_t ldvt) {
  // -(1-based position of the first invalid argument), before the runtime;
  // U is m x k (ldu >= m), VT is k x n (ldvt >= k)
  bool wantu = is_v(jobu), wantvt = is_v(jobvt);
  if (!wantu && !is_n(jobu)) return -1;
  if (!wantvt && !is_n(jobvt)) return -2;
  if (m < 0) return -3;
  if (n < 0) return -4;
  if (A == nullptr) return -5;
  if (lda < at_least_1(m)) return -6;
  int64_t kmin = m < n ? m : n;
  int64_t k = iu - il + 1;
  if (il < 1) return -7;
  if (iu > kmin || iu < il) return -8;
  if (S == nullptr) return -9;
  if (wantu && U == nullptr) return -10;
  if (wantu && ldu < at_least_1(m)) return -11;
  if (wantvt && VT == nullptr) return -12;
  if (wantvt && ldvt < at_least_1(k)) return -13;
  Call c;
  if (!c.ok) return -999;
  return c.info("dgesvdx", pack(jobu, jobvt, m, n, mem(A, lda * n * 8), lda, il, iu,
                                mem(S, k * 8), mem(U, ldu * k * 8), ldu,
                                mem(VT, ldvt * n * 8), ldvt));
}

int slate_dsygv(int64_t itype, char jobz, char uplo, int64_t n, double* A, int64_t lda,
                double* B, int64_t ldb, double* W) {
  Call c;
  if (!c.ok) return -999;
  return c.info("dsygv", pack(itype, jobz, uplo, n, mem(A, lda * n * 8), lda,
                              mem(B, ldb * n * 8), ldb, mem(W, n * 8)));
}

// norms --------------------------------------------------------------------

double slate_dlange(char norm, int64_t m, int64_t n, const double* A, int64_t lda) {
  Call c;
  if (!c.ok) return -1.0;
  PyObject* r = c.run("dlange", pack(norm, m, n, cmem(A, lda * n * 8), lda));
  if (r == nullptr) return -1.0;
  double v = PyFloat_AsDouble(r);
  Py_DECREF(r);
  if (v == -1.0 && PyErr_Occurred()) PyErr_Print();
  return v;
}

// band and indefinite ------------------------------------------------------

int slate_dpbsv(char uplo, int64_t n, int64_t kd, int64_t nrhs, double* AB, int64_t ldab,
                double* B, int64_t ldb) {
  return pbsv_impl("dpbsv", uplo, n, kd, nrhs, AB, ldab, B, ldb, 8);
}

int slate_spbsv(char uplo, int64_t n, int64_t kd, int64_t nrhs, float* AB, int64_t ldab,
                float* B, int64_t ldb) {
  return pbsv_impl("spbsv", uplo, n, kd, nrhs, AB, ldab, B, ldb, 4);
}

int slate_dgbsv(int64_t n, int64_t kl, int64_t ku, int64_t nrhs, const double* AB,
                int64_t ldab, double* B, int64_t ldb) {
  return gbsv_impl("dgbsv", n, kl, ku, nrhs, AB, ldab, B, ldb, 8);
}

int slate_sgbsv(int64_t n, int64_t kl, int64_t ku, int64_t nrhs, const float* AB,
                int64_t ldab, float* B, int64_t ldb) {
  return gbsv_impl("sgbsv", n, kl, ku, nrhs, AB, ldab, B, ldb, 4);
}

int slate_dsysv(char uplo, int64_t n, int64_t nrhs, const double* A, int64_t lda,
                double* B, int64_t ldb) {
  return sysv_impl("dsysv", uplo, n, nrhs, A, lda, B, ldb, 8);
}

int slate_ssysv(char uplo, int64_t n, int64_t nrhs, const float* A, int64_t lda, float* B,
                int64_t ldb) {
  return sysv_impl("ssysv", uplo, n, nrhs, A, lda, B, ldb, 4);
}

int slate_zhesv(char uplo, int64_t n, int64_t nrhs, const void* A, int64_t lda, void* B,
                int64_t ldb) {
  return sysv_impl("zhesv", uplo, n, nrhs, A, lda, B, ldb, 16);
}

int slate_chesv(char uplo, int64_t n, int64_t nrhs, const void* A, int64_t lda, void* B,
                int64_t ldb) {
  return sysv_impl("chesv", uplo, n, nrhs, A, lda, B, ldb, 8);
}

// matrix handles -----------------------------------------------------------

int64_t slate_matrix_create_d(int64_t m, int64_t n, const double* data, int64_t lda) {
  return create_impl("matrix_create_d", m, n, data, lda, 8);
}

int64_t slate_matrix_create_s(int64_t m, int64_t n, const float* data, int64_t lda) {
  return create_impl("matrix_create_s", m, n, data, lda, 4);
}

int64_t slate_matrix_create_z(int64_t m, int64_t n, const void* data, int64_t lda) {
  return create_impl("matrix_create_z", m, n, data, lda, 16);
}

int64_t slate_matrix_create_c(int64_t m, int64_t n, const void* data, int64_t lda) {
  return create_impl("matrix_create_c", m, n, data, lda, 8);
}

int slate_matrix_read_d(int64_t h, double* out, int64_t ld) {
  return read_impl("matrix_read_d", h, out, ld, 8);
}

int slate_matrix_read_s(int64_t h, float* out, int64_t ld) {
  return read_impl("matrix_read_s", h, out, ld, 4);
}

int slate_matrix_read_z(int64_t h, void* out, int64_t ld) {
  return read_impl("matrix_read_z", h, out, ld, 16);
}

int slate_matrix_read_c(int64_t h, void* out, int64_t ld) {
  return read_impl("matrix_read_c", h, out, ld, 8);
}

void slate_matrix_destroy(int64_t h) {
  Call c;
  if (c.ok) c.info("matrix_destroy", pack(h));
}

int slate_matrix_gemm(char transa, char transb, double alpha, int64_t hA, int64_t hB,
                      double beta, int64_t hC) {
  Call c;
  if (!c.ok) return -999;
  return c.info("matrix_gemm", pack(transa, transb, alpha, hA, hB, beta, hC));
}

int slate_matrix_potrf(int64_t h, char uplo) {
  Call c;
  if (!c.ok) return -999;
  return c.info("matrix_potrf", pack(h, uplo));
}

int slate_matrix_gesv(int64_t hA, int64_t hB) {
  Call c;
  if (!c.ok) return -999;
  return c.info("matrix_gesv", pack(hA, hB));
}

int slate_matrix_syev(int64_t h, char jobz, char uplo, double* W) {
  Call c;
  if (!c.ok) return -999;
  int64_t rows, cols;
  if (!c.shape(h, &rows, &cols)) return -1;
  return c.info("matrix_syev", pack(h, jobz, uplo, mem(W, rows * 8)));
}

int slate_matrix_gesvd(int64_t h, double* S, int64_t* hU, int64_t* hVT) {
  Call c;
  if (!c.ok) return -999;
  int64_t rows, cols;
  if (!c.shape(h, &rows, &cols)) return -1;
  int64_t k = rows < cols ? rows : cols;
  PyObject* r = c.run("matrix_gesvd", pack(h, mem(S, k * 8), static_cast<int>(hU != nullptr),
                                           static_cast<int>(hVT != nullptr)));
  if (r == nullptr) return -998;
  long long info = -998, u = 0, vt = 0;
  if (!PyArg_ParseTuple(r, "LLL", &info, &u, &vt)) PyErr_Print();
  Py_DECREF(r);
  if (hU != nullptr) *hU = u;
  if (hVT != nullptr) *hVT = vt;
  return static_cast<int>(info);
}

}  // extern "C"
