// Python bindings of the launchers.  Each source's `extern "C"` launchers
// become the METH_FASTCALL functions of one CPython extension module named
// after the source (PY_LAUNCHERS at its end), loaded by ops/kernels.py.
// Each argument goes from a Python int straight to the launcher's own
// parameter type, read from its declaration: a pointer (None is NULL, the
// stream is a pointer too), an unsigned or a signed integer.  A launch
// returns the launcher's cudaError as a Python int.
//
// Why not ctypes: its argtypes conversion runs per argument through
// Python objects and costs several times this binding's whole call,
// which matters where a kernel's device time is a few microseconds
// (chip_smoke.py's launch_path line times both bindings of K4's
// launcher).  The header needs only Python.h, so a build still takes
// seconds.
//
// Built with -DNTB_NO_PYTHON (the native bridge's library, csrc/bridge.cu)
// the header includes nothing and PY_LAUNCHERS expands to nothing, so the
// same sources link into a library with no Python dependency; without the
// flag the extension modules are what they always were.

#pragma once

#ifndef NTB_NO_PYTHON

#include <Python.h>

#include <cstddef>
#include <tuple>
#include <type_traits>
#include <utility>

namespace py_launchers {

template <typename T>
T arg(PyObject* o) {
  if constexpr (std::is_pointer_v<T>) {
    return o == Py_None ? nullptr
                        : reinterpret_cast<T>(PyLong_AsVoidPtr(o));
  } else if constexpr (std::is_unsigned_v<T>) {
    return static_cast<T>(PyLong_AsUnsignedLongLongMask(o));
  } else {
    return static_cast<T>(PyLong_AsLongLong(o));
  }
}

template <typename... P, std::size_t... I>
PyObject* call(int (*f)(P...), PyObject* const* a,
               std::index_sequence<I...>) {
  // braced initialisation converts left to right
  std::tuple<P...> args{arg<P>(a[I])...};
  if (PyErr_Occurred()) return nullptr;
  return PyLong_FromLong(std::apply(f, args));
}

template <typename... P>
PyObject* bind(int (*f)(P...), const char* name, PyObject* const* a,
               Py_ssize_t n) {
  if (n != static_cast<Py_ssize_t>(sizeof...(P))) {
    PyErr_Format(PyExc_TypeError, "%s takes %d arguments, got %zd", name,
                 static_cast<int>(sizeof...(P)), n);
    return nullptr;
  }
  return call(f, a, std::index_sequence_for<P...>{});
}

}  // namespace py_launchers

#define PY_LAUNCHER(fn)                                                 \
  {                                                                     \
    #fn,                                                                \
        reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>( \
            +[](PyObject*, PyObject* const* a, Py_ssize_t n) {          \
              return py_launchers::bind(fn, #fn, a, n);                 \
            })),                                                        \
        METH_FASTCALL, nullptr                                          \
  }

#define PY_LAUNCHERS(module, ...)                                          \
  static PyMethodDef module##_launchers[] = {__VA_ARGS__,                  \
                                             {nullptr, nullptr, 0,         \
                                              nullptr}};                   \
  static PyModuleDef module##_module = {PyModuleDef_HEAD_INIT, #module,    \
                                        nullptr, -1, module##_launchers}; \
  PyMODINIT_FUNC PyInit_##module(void) { return PyModule_Create(&module##_module); }

#else  // NTB_NO_PYTHON

#define PY_LAUNCHERS(module, ...)

#endif  // NTB_NO_PYTHON
