// The library's Python binding: the kernel library is also a CPython
// extension module (gf3x_torch.utils.device loads it by path), and each C
// entry point is reachable from Python through a METH_FASTCALL trampoline
// that converts its arguments in place. A ctypes call spends about 2 µs a
// launch converting ten arguments; this one about 0.1 µs, which matters
// where the whole launch is a few µs (kernel 7 on one recording).
//
// Each trampoline converts every argument by its entry's format ('p' an
// address, 'l' an integer, 'f' a float) before it calls the entry, so a bad
// argument raises in Python and launches nothing; it returns the entry's
// CUDA error code. Its last argument is the CUDA device the tensors live
// on: where that is not the current device it launches nothing and returns
// kOtherDevice, and the caller switches device and calls again (a check in
// C costs a cudaGetDevice; torch's Python-bound getter costs more than the
// rest of the conversion).
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cuda_runtime.h>

#include <cstring>

extern "C" {
int gf3x_cut_symbols(const float*, const int*, float*, float*, long long,
                     long long, long long, int, int, int, int, int, int, int,
                     void*);
int gf3x_gather_cut(const float*, const int*, float*, long long, long long,
                    long long, long long, int, void*);
int gf3x_gather_cut_group(const float*, const int*, float*, long long,
                          long long, long long, long long, int, void*);
int gf3x_cut_dft(const float*, const int*, const int*, const float*, float*,
                 float*, long long, long long, long long, int, int, int, int,
                 int, int, int, int, int, float, int, int, int, int, int, int,
                 int, void*);
int gf3x_fused_eq_demap(const float*, const float*, const float*,
                        const float*, const int*, float*, float*, float*,
                        float*, float*, long long, int, int, int, int, int,
                        const float*, int, int, float, int, float, float, int,
                        int, int, float, float, float*, int, int, int, float*,
                        int*, void*);
int gf3x_eq_track(const float*, const float*, const float*, const float*,
                  const int*, float*, float*, float*, float*, long long, int,
                  int, int, int, int, int, float, int, float, float, int, int,
                  int, float*, int, int, int, void*);
int gf3x_demap_bins(const float*, const float*, const float*, const int*,
                    float*, float*, float*, long long, int, int, int, int,
                    float, float, const float*, int, int, int, void*);
int gf3x_minsum_check(const float*, float*, unsigned char*, int*, int*,
                      const int*, const int*, const int*, long long, int, int,
                      int, int, int, void*);
int gf3x_minsum_decode_blocks(int*, int, int, int, void*);
int gf3x_minsum_decode(const float*, float*, unsigned char*, int*, int*,
                       float*, long long*, const int*, const int*, const int*,
                       long long, int, int, int, int, int, int, int, int,
                       void*);
int gf3x_fec_gather(const float*, const int*, const unsigned char*, float*,
                    long long, long long, int, int, void*);
int gf3x_fec_gather_tile(const float*, const unsigned char*, float*,
                         long long, long long, int, int, int, int, int, int,
                         void*);
int gf3x_czt_pre(const float*, const float2*, float2*, long long, long long,
                 long long, long long, int, int, void*);
int gf3x_czt_post(const float2*, const float2*, float2*, long long, int, int,
                  void*);
int gf3x_czt_fused(const float*, const float2*, const float2*, const float2*,
                   const float2*, float2*, long long, long long, long long,
                   long long, int, int, int, void*);
int gf3x_isi_onset(const float2*, const float*, const float*, float*,
                   long long, int, int, int, int, int, float, float, void*);
int gf3x_llr_hist(const float*, const int*, int*, long long, long long, int,
                  int, void*);
const char* gf3x_error_string(int);
}

namespace {

constexpr int kMaxArgs = 40;
constexpr long kOtherDevice = -1;   // not a cudaError_t value;
                                    // utils/device.py's _OTHER_DEVICE

union Val {
    void* p;
    long long l;
    double d;
};

// An address that converts to whichever pointer type the entry takes.
struct Addr {
    void* p;
    template <class T>
    operator T*() const { return static_cast<T*>(p); }
};

// a[0..n) converted by `fmt` into v; false, with a Python error set, on a
// wrong count or a value of the wrong kind.
bool convert(const char* name, const char* fmt, PyObject* const* a,
             Py_ssize_t n, Val* v) {
    const Py_ssize_t want = static_cast<Py_ssize_t>(std::strlen(fmt));
    if (n != want) {
        PyErr_Format(PyExc_TypeError, "%s takes %zd arguments (%zd given)",
                     name, want, n);
        return false;
    }
    for (Py_ssize_t i = 0; i < n; ++i) {
        switch (fmt[i]) {
        case 'p': v[i].p = PyLong_AsVoidPtr(a[i]); break;
        case 'l': v[i].l = PyLong_AsLongLong(a[i]); break;
        default: v[i].d = PyFloat_AsDouble(a[i]); break;
        }
    }
    return !PyErr_Occurred();
}

#define P(i) (Addr{v[i].p})
#define L(i) (v[i].l)
#define I(i) (static_cast<int>(v[i].l))
#define F(i) (static_cast<float>(v[i].d))

// The call's arguments by `fmt`, then the device (an integer).
#define ENTRY(name, fmt, call)                                             \
    PyObject* py_##name(PyObject*, PyObject* const* a, Py_ssize_t n) {     \
        static_assert(sizeof(fmt) <= kMaxArgs, "too many arguments");      \
        Val v[kMaxArgs];                                                   \
        if (!convert(#name, fmt "l", a, n, v)) return nullptr;             \
        int current = -1;                                                  \
        const cudaError_t e = cudaGetDevice(&current);                     \
        if (e != cudaSuccess) return PyLong_FromLong(e);                   \
        if (current != v[n - 1].l) return PyLong_FromLong(kOtherDevice);   \
        return PyLong_FromLong(call);                                      \
    }

ENTRY(gf3x_cut_symbols, "ppppllllllllllp",
      gf3x_cut_symbols(P(0), P(1), P(2), P(3), L(4), L(5), L(6), I(7), I(8),
                       I(9), I(10), I(11), I(12), I(13), P(14)))
ENTRY(gf3x_gather_cut, "ppplllllp",
      gf3x_gather_cut(P(0), P(1), P(2), L(3), L(4), L(5), L(6), I(7), P(8)))
ENTRY(gf3x_gather_cut_group, "ppplllllp",
      gf3x_gather_cut_group(P(0), P(1), P(2), L(3), L(4), L(5), L(6), I(7),
                            P(8)))
ENTRY(gf3x_cut_dft, "ppppppllllllllllllflllllllp",
      gf3x_cut_dft(P(0), P(1), P(2), P(3), P(4), P(5), L(6), L(7), L(8),
                   I(9), I(10), I(11), I(12), I(13), I(14), I(15), I(16),
                   I(17), F(18), I(19), I(20), I(21), I(22), I(23), I(24),
                   I(25), P(26)))
ENTRY(gf3x_fused_eq_demap, "ppppppppppllllllpllflfflllffplllppp",
      gf3x_fused_eq_demap(P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7),
                          P(8), P(9), L(10), I(11), I(12), I(13), I(14),
                          I(15), P(16), I(17), I(18), F(19), I(20), F(21),
                          F(22), I(23), I(24), I(25), F(26), F(27), P(28),
                          I(29), I(30), I(31), P(32), P(33), P(34)))
ENTRY(gf3x_eq_track, "ppppppppplllllllflfflllplllp",
      gf3x_eq_track(P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7), P(8),
                    L(9), I(10), I(11), I(12), I(13), I(14), I(15), F(16),
                    I(17), F(18), F(19), I(20), I(21), I(22), P(23), I(24),
                    I(25), I(26), P(27)))
ENTRY(gf3x_demap_bins, "ppppppplllllffplllp",
      gf3x_demap_bins(P(0), P(1), P(2), P(3), P(4), P(5), P(6), L(7), I(8),
                      I(9), I(10), I(11), F(12), F(13), P(14), I(15), I(16),
                      I(17), P(18)))
ENTRY(gf3x_minsum_check, "ppppppppllllllp",
      gf3x_minsum_check(P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7), L(8),
                        I(9), I(10), I(11), I(12), I(13), P(14)))
ENTRY(gf3x_minsum_decode_blocks, "plllp",
      gf3x_minsum_decode_blocks(P(0), I(1), I(2), I(3), P(4)))
ENTRY(gf3x_minsum_decode, "pppppppppplllllllllp",
      gf3x_minsum_decode(P(0), P(1), P(2), P(3), P(4), P(5), P(6), P(7),
                         P(8), P(9), L(10), I(11), I(12), I(13), I(14),
                         I(15), I(16), I(17), I(18), P(19)))
ENTRY(gf3x_fec_gather, "ppppllllp",
      gf3x_fec_gather(P(0), P(1), P(2), P(3), L(4), L(5), I(6), I(7), P(8)))
ENTRY(gf3x_fec_gather_tile, "pppllllllllp",
      gf3x_fec_gather_tile(P(0), P(1), P(2), L(3), L(4), I(5), I(6), I(7),
                           I(8), I(9), I(10), P(11)))
ENTRY(gf3x_czt_pre, "pppllllllp",
      gf3x_czt_pre(P(0), P(1), P(2), L(3), L(4), L(5), L(6), I(7), I(8),
                   P(9)))
ENTRY(gf3x_czt_post, "ppplllp",
      gf3x_czt_post(P(0), P(1), P(2), L(3), I(4), I(5), P(6)))
ENTRY(gf3x_czt_fused, "pppppplllllllp",
      gf3x_czt_fused(P(0), P(1), P(2), P(3), P(4), P(5), L(6), L(7), L(8),
                     L(9), I(10), I(11), I(12), P(13)))
ENTRY(gf3x_isi_onset, "ppppllllllffp",
      gf3x_isi_onset(P(0), P(1), P(2), P(3), L(4), I(5), I(6), I(7), I(8),
                     I(9), F(10), F(11), P(12)))
ENTRY(gf3x_llr_hist, "pppllllp",
      gf3x_llr_hist(P(0), P(1), P(2), L(3), L(4), I(5), I(6), P(7)))

PyObject* py_gf3x_error_string(PyObject*, PyObject* const* a, Py_ssize_t n) {
    Val v[1];
    if (!convert("gf3x_error_string", "l", a, n, v)) return nullptr;
    return PyUnicode_FromString(gf3x_error_string(I(0)));
}

#define METHOD(name)                                                      \
    {#name,                                                               \
     reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)()>(py_##name)), \
     METH_FASTCALL, nullptr}

PyMethodDef kMethods[] = {
    METHOD(gf3x_cut_symbols),    METHOD(gf3x_gather_cut),
    METHOD(gf3x_gather_cut_group), METHOD(gf3x_cut_dft),
    METHOD(gf3x_fused_eq_demap), METHOD(gf3x_eq_track),
    METHOD(gf3x_demap_bins),     METHOD(gf3x_minsum_check),
    METHOD(gf3x_minsum_decode_blocks), METHOD(gf3x_minsum_decode),
    METHOD(gf3x_fec_gather),     METHOD(gf3x_fec_gather_tile),
    METHOD(gf3x_czt_pre),        METHOD(gf3x_czt_post),
    METHOD(gf3x_czt_fused),      METHOD(gf3x_isi_onset),
    METHOD(gf3x_llr_hist),       METHOD(gf3x_error_string),
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "gf3x_kernels", nullptr, -1,
                       kMethods};

}  // namespace

extern "C" __attribute__((visibility("default"))) PyObject*
PyInit_gf3x_kernels() {
    return PyModule_Create(&kModule);
}
