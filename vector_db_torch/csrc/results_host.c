/* The facade's SearchResult objects of one call, built on the host.
 *
 * core/types.make_results_batch's bulk branch finishes a call's [Q, k]
 * answers in numpy (the root, the similarity and its rounding) and hands
 * the arrays here; this file does no arithmetic.  It builds each object as
 * the frozen dataclass's own __init__ would store it: the type's tp_new
 * with no arguments (object.__new__), then id, distance and similarity in
 * field order through PyObject_GenericSetAttr (object.__setattr__).  On
 * CPython 3.12 the fields stay in the instance's inline values; no
 * per-object dict exists until a caller asks for vars().
 *
 * Built with the host C compiler against the interpreter's headers at
 * first use (ops/kernels._Library) and loaded with ctypes.PyDLL, so every
 * call holds the GIL.  A failure releases what was built and returns NULL
 * with the Python error set, which ctypes raises.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

#define N_FIELDS 3

/* the field names, interned once (under the GIL) and kept for the process */
static PyObject *field_names[N_FIELDS];

static int intern_field_names(void) {
    static const char *const text[N_FIELDS] = {"id", "distance", "similarity"};
    for (int f = 0; f < N_FIELDS; f++) {
        if (field_names[f] == NULL) {
            field_names[f] = PyUnicode_InternFromString(text[f]);
            if (field_names[f] == NULL) return -1;
        }
    }
    return 0;
}

/* One object with its three fields, or NULL with the error set. */
static PyObject *build_one(PyTypeObject *type, PyObject *no_args, int64_t id,
                           double distance, double similarity) {
    PyObject *obj = type->tp_new(type, no_args, NULL);
    if (obj == NULL) return NULL;
    PyObject *values[N_FIELDS] = {PyLong_FromLongLong(id),
                                  PyFloat_FromDouble(distance),
                                  PyFloat_FromDouble(similarity)};
    int failed = 0;
    for (int f = 0; f < N_FIELDS; f++) {
        failed = failed || values[f] == NULL
                 || PyObject_GenericSetAttr(obj, field_names[f], values[f]) < 0;
        Py_XDECREF(values[f]);
    }
    if (failed) Py_CLEAR(obj);
    return obj;
}

/* list[list[type]] of the q rows of [q, k] C-contiguous arrays: entry
 * (r, c) becomes type(id=ids[r, c], distance=dist[r, c],
 * similarity=sim[r, c]) where keep[r, c] is nonzero (every entry where keep
 * is NULL), in column order. */
PyObject *vdb_build_results(PyObject *type_obj, const int64_t *ids,
                            const double *dist, const double *sim,
                            const uint8_t *keep, Py_ssize_t q, Py_ssize_t k) {
    if (!PyType_Check(type_obj)) {
        PyErr_SetString(PyExc_TypeError, "vdb_build_results: not a type");
        return NULL;
    }
    if (q < 0 || k < 0) {
        PyErr_SetString(PyExc_ValueError, "vdb_build_results: negative shape");
        return NULL;
    }
    PyTypeObject *type = (PyTypeObject *)type_obj;
    if (type->tp_new == NULL) {
        PyErr_SetString(PyExc_TypeError, "vdb_build_results: type has no tp_new");
        return NULL;
    }
    if (intern_field_names() < 0) return NULL;
    PyObject *no_args = PyTuple_New(0);
    if (no_args == NULL) return NULL;
    PyObject *out = PyList_New(q);
    if (out == NULL) goto fail;
    for (Py_ssize_t r = 0; r < q; r++) {
        const Py_ssize_t base = r * k;
        Py_ssize_t n = k;
        if (keep != NULL) {
            n = 0;
            for (Py_ssize_t c = 0; c < k; c++) n += keep[base + c] != 0;
        }
        PyObject *row = PyList_New(n);
        if (row == NULL) goto fail;
        PyList_SET_ITEM(out, r, row);   /* out owns it from here */
        Py_ssize_t at = 0;
        for (Py_ssize_t c = 0; c < k; c++) {
            const Py_ssize_t e = base + c;
            if (keep != NULL && !keep[e]) continue;
            PyObject *obj = build_one(type, no_args, ids[e], dist[e], sim[e]);
            if (obj == NULL) goto fail;
            PyList_SET_ITEM(row, at++, obj);
        }
    }
    Py_DECREF(no_args);
    return out;

fail:
    /* a list's unset items are NULL, which its deallocation skips */
    Py_XDECREF(out);
    Py_DECREF(no_args);
    return NULL;
}
