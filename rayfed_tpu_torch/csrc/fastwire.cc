/* fastwire (C++): the native data-plane engine for the FTP1 wire protocol.
 *
 * The role the reference delegates to native dependencies (Ray's C++ core
 * and gRPC's C-core move its bytes; SURVEY.md C14/§2, ref
 * fed/proxy/grpc/grpc_proxy.py:23) is filled here by a CPython extension
 * that owns the hot receive path end-to-end:
 *
 *   - sendv:              vectored header+payload sends (writev), GIL off
 *   - recv_exact:         exact-length receive into a caller buffer
 *   - recv_prefix_header: frame prefix + header in ONE GIL-released
 *                         window, with magic/version/size-cap validation
 *                         BEFORE any allocation
 *   - recv_scatter:       the whole payload scatter-read into C-pooled
 *                         buffers via readv — one GIL window, one
 *                         syscall batch across segment boundaries
 *   - a C-side buffer pool (PooledBuf) recycling large receive blocks
 *     across frames, replacing the Python-side refcount-scanning pool on
 *     the native path (fresh 100MB allocations cost page faults + munmap
 *     per frame; the pool makes steady-state receives allocation-free)
 *
 * Plaintext sockets only — TLS connections stay on the Python ssl path.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <fcntl.h>
#include <poll.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>

#include <mutex>
#include <vector>

#define MAX_IOV 64

/* ------------------------------------------------------------------ */
/* fd polling                                                          */
/* ------------------------------------------------------------------ */

/* Wait for the fd to become ready; returns 0 ok, -1 timeout, errno>0 error. */
static int wait_fd(int fd, short events, long timeout_ms) {
    struct pollfd pfd = {fd, events, 0};
    for (;;) {
        int rc = poll(&pfd, 1, timeout_ms < 0 ? -1 : (int)timeout_ms);
        if (rc > 0) return 0;
        if (rc == 0) return -1;
        if (errno == EINTR) continue;
        return errno;
    }
}

/* Receive exactly n bytes into p. Returns 0 ok, -1 timeout, -2 EOF,
 * errno>0 error. Caller must NOT hold the GIL. */
static int recv_all(int fd, char *p, size_t n, long timeout_ms) {
    while (n > 0) {
        ssize_t rc = recv(fd, p, n, 0);
        if (rc > 0) {
            p += rc;
            n -= (size_t)rc;
            continue;
        }
        if (rc == 0) return -2;
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
            int w = wait_fd(fd, POLLIN, timeout_ms);
            if (w == 0) continue;
            return w;
        }
        return errno;
    }
    return 0;
}

/* Raise the Python exception matching a recv_all/err code. */
static PyObject *raise_io(int err, const char *what) {
    if (err == -2) {
        PyErr_Format(PyExc_ConnectionError,
                     "peer closed connection mid-%s", what);
        return NULL;
    }
    if (err == -1) {
        PyErr_Format(PyExc_TimeoutError, "fastwire %s timed out", what);
        return NULL;
    }
    errno = err;
    return PyErr_SetFromErrno(PyExc_OSError);
}

/* ------------------------------------------------------------------ */
/* C-side buffer pool                                                  */
/* ------------------------------------------------------------------ */

struct Block {
    char *p;
    size_t size;
};

/* Free blocks, oldest first; total tracks free bytes only (a block handed
 * to a PooledBuf is accounted by that object, not the pool). All pool
 * state is touched with the GIL held (take/put run from Python-visible
 * entry/exit points), so the mutex guards only against future no-GIL
 * builds and direct C callers. */
static std::mutex pool_mu;
static std::vector<Block> pool_blocks;
static size_t pool_free_bytes = 0;
static size_t pool_cap = (size_t)2 << 30; /* overridden at module init */
static const size_t POOL_MIN = (size_t)1 << 20;
static const size_t POOL_ALIGN = 64;

static char *block_alloc(size_t n) {
    void *p = NULL;
    if (posix_memalign(&p, POOL_ALIGN, n) != 0) return NULL;
    return (char *)p;
}

/* Best-fit take: smallest free block with n <= size <= 4n (a huge block
 * must not be burned on a small frame). Returns {NULL, n} when the pool
 * has no candidate and the caller should allocate. */
static Block pool_take(size_t n) {
    Block out = {NULL, n};
    if (n < POOL_MIN || pool_cap == 0) return out;
    std::lock_guard<std::mutex> g(pool_mu);
    size_t best = (size_t)-1;
    size_t best_size = 0;
    for (size_t i = 0; i < pool_blocks.size(); i++) {
        size_t sz = pool_blocks[i].size;
        if (sz >= n && sz <= (n << 2) &&
            (best == (size_t)-1 || sz < best_size)) {
            best = i;
            best_size = sz;
        }
    }
    if (best != (size_t)-1) {
        out = pool_blocks[best];
        pool_blocks.erase(pool_blocks.begin() + best);
        pool_free_bytes -= out.size;
    }
    return out;
}

static void pool_put(Block b) {
    if (b.size < POOL_MIN || pool_cap == 0) {
        free(b.p);
        return;
    }
    std::vector<Block> evicted;
    {
        std::lock_guard<std::mutex> g(pool_mu);
        pool_blocks.push_back(b);
        pool_free_bytes += b.size;
        /* Evict oldest-first until the cap holds — including down to an
         * empty pool, so a single block larger than FEDTPU_RECV_POOL_MB
         * is freed instead of retained forever. */
        while (pool_free_bytes > pool_cap && !pool_blocks.empty()) {
            evicted.push_back(pool_blocks.front());
            pool_free_bytes -= pool_blocks.front().size;
            pool_blocks.erase(pool_blocks.begin());
        }
    }
    for (auto &e : evicted) free(e.p);
}

/* ------------------------------------------------------------------ */
/* PooledBuf: a writable buffer-protocol object returning its block to  */
/* the pool on dealloc (all consumer views hold a strong reference, so  */
/* dealloc implies no live exports).                                    */
/* ------------------------------------------------------------------ */

typedef struct {
    PyObject_HEAD
    char *ptr;
    size_t alloc_size; /* underlying block size (pool key) */
    Py_ssize_t len;    /* exposed length */
} PooledBuf;

static void PooledBuf_dealloc(PyObject *self) {
    PooledBuf *pb = (PooledBuf *)self;
    if (pb->ptr) {
        Block b = {pb->ptr, pb->alloc_size};
        pool_put(b);
        pb->ptr = NULL;
    }
    Py_TYPE(self)->tp_free(self);
}

static int PooledBuf_getbuffer(PyObject *self, Py_buffer *view, int flags) {
    PooledBuf *pb = (PooledBuf *)self;
    if (pb->ptr == NULL) {
        PyErr_SetString(PyExc_ValueError, "PooledBuf is released");
        return -1;
    }
    return PyBuffer_FillInfo(view, self, pb->ptr, pb->len, 0, flags);
}

static PyBufferProcs PooledBuf_as_buffer = {
    PooledBuf_getbuffer,
    NULL,
};

static Py_ssize_t PooledBuf_length(PyObject *self) {
    return ((PooledBuf *)self)->len;
}

static PySequenceMethods PooledBuf_as_sequence = {
    PooledBuf_length, /* sq_length — len(buf) == payload bytes */
};

static PyTypeObject PooledBuf_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    "rayfed_tpu._fastwire.PooledBuf", /* tp_name */
    sizeof(PooledBuf),                /* tp_basicsize */
};

/* New PooledBuf of n bytes (pool hit or fresh aligned allocation).
 * Caller must hold the GIL. Returns NULL with an exception set. */
static PyObject *pooledbuf_new(size_t n) {
    Block b = pool_take(n);
    if (b.p == NULL) {
        b.size = n;
        b.p = block_alloc(n ? n : 1);
        if (b.p == NULL) return PyErr_NoMemory();
    }
    PooledBuf *pb = PyObject_New(PooledBuf, &PooledBuf_Type);
    if (pb == NULL) {
        pool_put(b);
        return NULL;
    }
    pb->ptr = b.p;
    pb->alloc_size = b.size;
    pb->len = (Py_ssize_t)n;
    return (PyObject *)pb;
}

/* pool_trim() -> None: drop every free block (transport stop hook). */
static PyObject *fastwire_pool_trim(PyObject *self, PyObject *args) {
    std::vector<Block> dropped;
    {
        std::lock_guard<std::mutex> g(pool_mu);
        dropped.swap(pool_blocks);
        pool_free_bytes = 0;
    }
    for (auto &b : dropped) free(b.p);
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* sendv                                                               */
/* ------------------------------------------------------------------ */

/* sendv(fd, timeout_ms, buffers_sequence) -> None
 * Sends every buffer fully, in order, via writev — any number of
 * buffers; the syscalls batch MAX_IOV iovecs at a time (a model
 * pytree's frame can easily carry hundreds of leaf buffers). */
static PyObject *fastwire_sendv(PyObject *self, PyObject *args) {
    int fd;
    long timeout_ms;
    PyObject *seq;
    if (!PyArg_ParseTuple(args, "ilO", &fd, &timeout_ms, &seq))
        return NULL;

    PyObject *fast = PySequence_Fast(seq, "buffers must be a sequence");
    if (!fast) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);

    std::vector<Py_buffer> views;
    std::vector<struct iovec> iov;
    views.reserve((size_t)n);
    iov.reserve((size_t)n);
    size_t total = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        Py_buffer view;
        if (PyObject_GetBuffer(item, &view, PyBUF_C_CONTIGUOUS) < 0) {
            for (auto &v : views) PyBuffer_Release(&v);
            Py_DECREF(fast);
            return NULL;
        }
        views.push_back(view);
        struct iovec v;
        v.iov_base = view.buf;
        v.iov_len = (size_t)view.len;
        total += (size_t)view.len;
        iov.push_back(v);
    }

    int err = 0;        /* errno, or -1 for poll timeout */
    size_t sent = 0;
    Py_BEGIN_ALLOW_THREADS;
    size_t first = 0;
    while (sent < total) {
        while (first < iov.size() && iov[first].iov_len == 0) first++;
        int cnt = (int)(iov.size() - first);
        if (cnt > MAX_IOV) cnt = MAX_IOV;
        ssize_t rc = writev(fd, &iov[first], cnt);
        if (rc < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                int w = wait_fd(fd, POLLOUT, timeout_ms);
                if (w == 0) continue;
                err = (w == -1) ? -1 : w;
                break;
            }
            err = errno;
            break;
        }
        sent += (size_t)rc;
        size_t done = (size_t)rc;
        while (done > 0 && first < iov.size()) {
            if (done >= iov[first].iov_len) {
                done -= iov[first].iov_len;
                iov[first].iov_len = 0;
                first++;
            } else {
                iov[first].iov_base = (char *)iov[first].iov_base + done;
                iov[first].iov_len -= done;
                done = 0;
            }
        }
    }
    Py_END_ALLOW_THREADS;

    for (auto &v : views) PyBuffer_Release(&v);
    Py_DECREF(fast);

    if (err == -1) {
        PyErr_SetString(PyExc_TimeoutError, "fastwire send timed out");
        return NULL;
    }
    if (err != 0) {
        errno = err;
        return PyErr_SetFromErrno(PyExc_OSError);
    }
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* recv_exact                                                          */
/* ------------------------------------------------------------------ */

/* recv_exact(fd, timeout_ms, writable_buffer) -> None
 * Fills the buffer completely or raises (ConnectionError on EOF). */
static PyObject *fastwire_recv_exact(PyObject *self, PyObject *args) {
    int fd;
    long timeout_ms;
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "ilw*", &fd, &timeout_ms, &buf))
        return NULL;

    int err;
    Py_BEGIN_ALLOW_THREADS;
    err = recv_all(fd, (char *)buf.buf, (size_t)buf.len, timeout_ms);
    Py_END_ALLOW_THREADS;
    PyBuffer_Release(&buf);
    if (err != 0) return raise_io(err, "recv");
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* recv_prefix_header                                                  */
/* ------------------------------------------------------------------ */

/* recv_prefix_header(fd, timeout_ms, magic4, version, max_header,
 *                    max_payload) -> (ftype, plen, header_bytes)
 *
 * Reads the fixed FTP1 prefix (4s magic, u8 version, u8 ftype, u32 hlen,
 * u64 plen, big-endian — proxy/tcp/wire.py frame layout) and the msgpack
 * header blob in one GIL-released window. Magic, version and both size
 * caps are validated BEFORE any allocation, so a hostile frame costs no
 * memory (ValueError; the Python layer maps it to WireError and tears
 * the connection down). */
static PyObject *fastwire_recv_prefix_header(PyObject *self, PyObject *args) {
    int fd;
    long timeout_ms;
    const char *magic;
    Py_ssize_t magic_len;
    int version;
    unsigned long long max_header, max_payload;
    if (!PyArg_ParseTuple(args, "ily#iKK", &fd, &timeout_ms, &magic,
                          &magic_len, &version, &max_header, &max_payload))
        return NULL;
    if (magic_len != 4) {
        PyErr_SetString(PyExc_ValueError, "magic must be 4 bytes");
        return NULL;
    }

    unsigned char prefix[18]; /* 4 + 1 + 1 + 4 + 8 */
    char *hdr = NULL;
    int err = 0;            /* recv_all code */
    int bad = 0;            /* 1 magic, 2 version, 3 hlen, 4 plen, 5 oom */
    unsigned int hlen = 0;
    unsigned long long plen = 0;
    unsigned int ftype = 0;
    unsigned int ver = 0;

    Py_BEGIN_ALLOW_THREADS;
    err = recv_all(fd, (char *)prefix, 18, timeout_ms);
    if (err == 0) {
        ver = prefix[4];
        ftype = prefix[5];
        hlen = ((unsigned int)prefix[6] << 24) |
               ((unsigned int)prefix[7] << 16) |
               ((unsigned int)prefix[8] << 8) | (unsigned int)prefix[9];
        plen = 0;
        for (int i = 0; i < 8; i++)
            plen = (plen << 8) | (unsigned long long)prefix[10 + i];
        if (memcmp(prefix, magic, 4) != 0) {
            bad = 1;
        } else if (ver != (unsigned int)version) {
            bad = 2;
        } else if ((unsigned long long)hlen > max_header) {
            bad = 3;
        } else if (plen > max_payload) {
            bad = 4;
        } else {
            hdr = (char *)malloc(hlen ? hlen : 1);
            if (hdr == NULL) {
                bad = 5;
            } else {
                err = recv_all(fd, hdr, hlen, timeout_ms);
            }
        }
    }
    Py_END_ALLOW_THREADS;

    if (err != 0) {
        free(hdr);
        return raise_io(err, "recv");
    }
    switch (bad) {
    case 1:
        PyErr_Format(PyExc_ValueError, "bad magic %.4s", (char *)prefix);
        return NULL;
    case 2:
        PyErr_Format(PyExc_ValueError, "unsupported wire version %u", ver);
        return NULL;
    case 3:
        PyErr_Format(PyExc_ValueError, "header length %u exceeds cap", hlen);
        return NULL;
    case 4:
        PyErr_Format(PyExc_ValueError,
                     "payload length %llu exceeds cap %llu", plen,
                     max_payload);
        return NULL;
    case 5:
        return PyErr_NoMemory();
    }
    PyObject *hbytes = PyBytes_FromStringAndSize(hdr, (Py_ssize_t)hlen);
    free(hdr);
    if (hbytes == NULL) return NULL;
    PyObject *out = Py_BuildValue("IKN", ftype, plen, hbytes);
    return out;
}

/* ------------------------------------------------------------------ */
/* recv_frame_small                                                    */
/* ------------------------------------------------------------------ */

/* recv_frame_small(fd, timeout_ms, magic4, version, max_header,
 *                  max_payload, small_max)
 *     -> (ftype, plen, header_bytes, payload | None)
 *
 * The latency-path sibling of recv_prefix_header: when the frame's
 * payload fits within small_max, the prefix, header AND payload are all
 * received inside ONE GIL-released window — a small frame costs a single
 * GIL round-trip instead of three (prefix+header, sizes, scatter).
 * Validation order and error codes match recv_prefix_header exactly.
 * For plen > small_max the payload slot is None and the caller falls
 * through to the scatter/pooled machinery unchanged. The payload comes
 * back as a writable bytearray (consumers build numpy views on it). */
static PyObject *fastwire_recv_frame_small(PyObject *self, PyObject *args) {
    int fd;
    long timeout_ms;
    const char *magic;
    Py_ssize_t magic_len;
    int version;
    unsigned long long max_header, max_payload, small_max;
    if (!PyArg_ParseTuple(args, "ily#iKKK", &fd, &timeout_ms, &magic,
                          &magic_len, &version, &max_header, &max_payload,
                          &small_max))
        return NULL;
    if (magic_len != 4) {
        PyErr_SetString(PyExc_ValueError, "magic must be 4 bytes");
        return NULL;
    }

    unsigned char prefix[18]; /* 4 + 1 + 1 + 4 + 8 */
    char *hdr = NULL;
    char *pay = NULL;
    int err = 0;            /* recv_all code */
    int bad = 0;            /* 1 magic, 2 version, 3 hlen, 4 plen, 5 oom */
    unsigned int hlen = 0;
    unsigned long long plen = 0;
    unsigned int ftype = 0;
    unsigned int ver = 0;
    int inlined = 0;        /* payload received in this window */

    Py_BEGIN_ALLOW_THREADS;
    err = recv_all(fd, (char *)prefix, 18, timeout_ms);
    if (err == 0) {
        ver = prefix[4];
        ftype = prefix[5];
        hlen = ((unsigned int)prefix[6] << 24) |
               ((unsigned int)prefix[7] << 16) |
               ((unsigned int)prefix[8] << 8) | (unsigned int)prefix[9];
        plen = 0;
        for (int i = 0; i < 8; i++)
            plen = (plen << 8) | (unsigned long long)prefix[10 + i];
        if (memcmp(prefix, magic, 4) != 0) {
            bad = 1;
        } else if (ver != (unsigned int)version) {
            bad = 2;
        } else if ((unsigned long long)hlen > max_header) {
            bad = 3;
        } else if (plen > max_payload) {
            bad = 4;
        } else {
            hdr = (char *)malloc(hlen ? hlen : 1);
            if (hdr == NULL) {
                bad = 5;
            } else {
                err = recv_all(fd, hdr, hlen, timeout_ms);
                if (err == 0 && plen <= small_max) {
                    inlined = 1;
                    pay = (char *)malloc(plen ? (size_t)plen : 1);
                    if (pay == NULL) {
                        bad = 5;
                    } else {
                        err = recv_all(fd, pay, (size_t)plen, timeout_ms);
                    }
                }
            }
        }
    }
    Py_END_ALLOW_THREADS;

    if (err != 0) {
        free(hdr);
        free(pay);
        return raise_io(err, "recv");
    }
    switch (bad) {
    case 1:
        PyErr_Format(PyExc_ValueError, "bad magic %.4s", (char *)prefix);
        return NULL;
    case 2:
        PyErr_Format(PyExc_ValueError, "unsupported wire version %u", ver);
        return NULL;
    case 3:
        PyErr_Format(PyExc_ValueError, "header length %u exceeds cap", hlen);
        return NULL;
    case 4:
        PyErr_Format(PyExc_ValueError,
                     "payload length %llu exceeds cap %llu", plen,
                     max_payload);
        return NULL;
    case 5:
        free(hdr);
        free(pay);
        return PyErr_NoMemory();
    }
    PyObject *hbytes = PyBytes_FromStringAndSize(hdr, (Py_ssize_t)hlen);
    free(hdr);
    if (hbytes == NULL) {
        free(pay);
        return NULL;
    }
    PyObject *pobj;
    if (inlined) {
        pobj = PyByteArray_FromStringAndSize(pay, (Py_ssize_t)plen);
        free(pay);
        if (pobj == NULL) {
            Py_DECREF(hbytes);
            return NULL;
        }
    } else {
        pobj = Py_None;
        Py_INCREF(pobj);
    }
    return Py_BuildValue("IKNN", ftype, plen, hbytes, pobj);
}

/* ------------------------------------------------------------------ */
/* recv_scatter                                                        */
/* ------------------------------------------------------------------ */

/* recv_scatter(fd, timeout_ms, sizes) -> [PooledBuf, ...]
 *
 * Allocates one pooled buffer per size and fills them all in a single
 * GIL-released window with readv batched across segment boundaries —
 * a segmented tree payload costs the same GIL/syscall structure as a
 * contiguous one. Caller is responsible for size validation (the frame's
 * plen was already capped by recv_prefix_header). */
static PyObject *fastwire_recv_scatter(PyObject *self, PyObject *args) {
    int fd;
    long timeout_ms;
    PyObject *sizes;
    if (!PyArg_ParseTuple(args, "ilO", &fd, &timeout_ms, &sizes))
        return NULL;

    PyObject *fast = PySequence_Fast(sizes, "sizes must be a sequence");
    if (!fast) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject *out = PyList_New(n);
    if (!out) {
        Py_DECREF(fast);
        return NULL;
    }

    std::vector<struct iovec> iov;
    iov.reserve((size_t)n);
    int failed = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        size_t sz = (size_t)PyLong_AsUnsignedLongLong(item);
        if (PyErr_Occurred()) {
            failed = 1;
            break;
        }
        PyObject *pb = pooledbuf_new(sz);
        if (pb == NULL) {
            failed = 1;
            break;
        }
        PyList_SET_ITEM(out, i, pb); /* steals */
        struct iovec v;
        v.iov_base = ((PooledBuf *)pb)->ptr;
        v.iov_len = sz;
        iov.push_back(v);
    }
    Py_DECREF(fast);
    if (failed) {
        Py_DECREF(out);
        return NULL;
    }

    int err = 0;
    Py_BEGIN_ALLOW_THREADS;
    size_t first = 0;
    while (first < iov.size()) {
        if (iov[first].iov_len == 0) {
            first++;
            continue;
        }
        int cnt = (int)(iov.size() - first);
        if (cnt > MAX_IOV) cnt = MAX_IOV;
        ssize_t rc = readv(fd, &iov[first], cnt);
        if (rc < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) {
                int w = wait_fd(fd, POLLIN, timeout_ms);
                if (w == 0) continue;
                err = (w == -1) ? -1 : w;
                break;
            }
            err = errno;
            break;
        }
        if (rc == 0) {
            err = -2;
            break;
        }
        size_t done = (size_t)rc;
        while (done > 0 && first < iov.size()) {
            if (done >= iov[first].iov_len) {
                done -= iov[first].iov_len;
                iov[first].iov_len = 0;
                first++;
            } else {
                iov[first].iov_base = (char *)iov[first].iov_base + done;
                iov[first].iov_len -= done;
                done = 0;
            }
        }
    }
    Py_END_ALLOW_THREADS;

    if (err != 0) {
        Py_DECREF(out);
        return raise_io(err, "recv");
    }
    return out;
}

/* ------------------------------------------------------------------ */
/* epoll reactor core                                                  */
/* ------------------------------------------------------------------ */

/* reactor_new() -> epfd (close-on-exec). The Python reactor thread owns
 * the fd and closes it with reactor_close(). */
static PyObject *fastwire_reactor_new(PyObject *self, PyObject *args) {
    int epfd = epoll_create1(EPOLL_CLOEXEC);
    if (epfd < 0) return PyErr_SetFromErrno(PyExc_OSError);
    return PyLong_FromLong(epfd);
}

static PyObject *fastwire_reactor_close(PyObject *self, PyObject *args) {
    int epfd;
    if (!PyArg_ParseTuple(args, "i", &epfd)) return NULL;
    close(epfd);
    Py_RETURN_NONE;
}

/* reactor_ctl(epfd, op, fd, events) -> None
 * op: 1 add, 2 del, 3 mod (the kernel EPOLL_CTL_* values). ``events`` is
 * the raw epoll event mask (select.EPOLLIN|...). Level-triggered on
 * purpose: interest management (read always on, write only while the
 * send ring is non-empty) lives in Python, and level semantics make a
 * missed edge impossible. */
static PyObject *fastwire_reactor_ctl(PyObject *self, PyObject *args) {
    int epfd, op, fd;
    unsigned int events;
    if (!PyArg_ParseTuple(args, "iiiI", &epfd, &op, &fd, &events))
        return NULL;
    struct epoll_event ev;
    memset(&ev, 0, sizeof(ev));
    ev.events = events;
    ev.data.fd = fd;
    if (epoll_ctl(epfd, op, fd, &ev) < 0)
        return PyErr_SetFromErrno(PyExc_OSError);
    Py_RETURN_NONE;
}

#define REACTOR_MAX_EVENTS 128

/* reactor_wait(epfd, timeout_ms) -> list[(fd, events)]
 * One GIL-released epoll_wait, whole ready set in one call. */
static PyObject *fastwire_reactor_wait(PyObject *self, PyObject *args) {
    int epfd;
    long timeout_ms;
    if (!PyArg_ParseTuple(args, "il", &epfd, &timeout_ms)) return NULL;

    struct epoll_event evs[REACTOR_MAX_EVENTS];
    int n, err = 0;
    Py_BEGIN_ALLOW_THREADS;
    for (;;) {
        n = epoll_wait(epfd, evs, REACTOR_MAX_EVENTS,
                       timeout_ms < 0 ? -1 : (int)timeout_ms);
        if (n >= 0) break;
        if (errno == EINTR) continue;
        err = errno;
        break;
    }
    Py_END_ALLOW_THREADS;
    if (err != 0) {
        errno = err;
        return PyErr_SetFromErrno(PyExc_OSError);
    }
    PyObject *out = PyList_New(n);
    if (!out) return NULL;
    for (int i = 0; i < n; i++) {
        PyObject *t = Py_BuildValue("(iI)", evs[i].data.fd,
                                    (unsigned int)evs[i].events);
        if (!t) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, i, t);
    }
    return out;
}

/* Nonblocking vectored write of one connection's ready chunks.
 * Returns bytes written (>= 0; 0 means EAGAIN before any byte), or
 * -errno on a hard socket error. Never raises for socket errors — the
 * caller maps negatives to its break machinery. Caller must NOT hold
 * buffer views it mutates concurrently. */
static ssize_t writev_nb(int fd, std::vector<struct iovec> &iov) {
    size_t first = 0, sent = 0;
    while (first < iov.size()) {
        while (first < iov.size() && iov[first].iov_len == 0) first++;
        if (first >= iov.size()) break;
        int cnt = (int)(iov.size() - first);
        if (cnt > MAX_IOV) cnt = MAX_IOV;
        ssize_t rc = writev(fd, &iov[first], cnt);
        if (rc < 0) {
            if (errno == EINTR) continue;
            if (errno == EAGAIN || errno == EWOULDBLOCK) break;
            return -(ssize_t)errno;
        }
        sent += (size_t)rc;
        size_t done = (size_t)rc;
        while (done > 0 && first < iov.size()) {
            if (done >= iov[first].iov_len) {
                done -= iov[first].iov_len;
                iov[first].iov_len = 0;
                first++;
            } else {
                iov[first].iov_base = (char *)iov[first].iov_base + done;
                iov[first].iov_len -= done;
                done = 0;
            }
        }
    }
    return (ssize_t)sent;
}

/* Collect buffer views for one job into (views, iov). Returns 0 ok. */
static int collect_iov(PyObject *bufseq, std::vector<Py_buffer> &views,
                       std::vector<struct iovec> &iov) {
    PyObject *fast = PySequence_Fast(bufseq, "buffers must be a sequence");
    if (!fast) return -1;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        Py_buffer view;
        if (PyObject_GetBuffer(item, &view, PyBUF_C_CONTIGUOUS) < 0) {
            Py_DECREF(fast);
            return -1;
        }
        views.push_back(view);
        struct iovec v;
        v.iov_base = view.buf;
        v.iov_len = (size_t)view.len;
        iov.push_back(v);
    }
    Py_DECREF(fast);
    return 0;
}

/* sendv_nb(fd, buffers) -> int
 * One nonblocking gather-write; partial writes are the caller's problem
 * (it advances its send ring by the return value). */
static PyObject *fastwire_sendv_nb(PyObject *self, PyObject *args) {
    int fd;
    PyObject *seq;
    if (!PyArg_ParseTuple(args, "iO", &fd, &seq)) return NULL;

    std::vector<Py_buffer> views;
    std::vector<struct iovec> iov;
    if (collect_iov(seq, views, iov) < 0) {
        for (auto &v : views) PyBuffer_Release(&v);
        return NULL;
    }
    ssize_t rc;
    Py_BEGIN_ALLOW_THREADS;
    rc = writev_nb(fd, iov);
    Py_END_ALLOW_THREADS;
    for (auto &v : views) PyBuffer_Release(&v);
    return PyLong_FromSsize_t(rc);
}

/* flush_many(jobs) -> list[int]
 * Batched submission: jobs is a sequence of (fd, buffers); every ready
 * connection's pending chunks are flushed inside ONE GIL window — N
 * writable peers cost one GIL round-trip, not N. Per-job result is
 * bytes written or -errno (a dead peer must not fail its neighbours'
 * flushes). */
static PyObject *fastwire_flush_many(PyObject *self, PyObject *args) {
    PyObject *jobs;
    if (!PyArg_ParseTuple(args, "O", &jobs)) return NULL;
    PyObject *fast = PySequence_Fast(jobs, "jobs must be a sequence");
    if (!fast) return NULL;
    Py_ssize_t njobs = PySequence_Fast_GET_SIZE(fast);

    struct JobIov {
        int fd;
        size_t viv_start, viv_len; /* slice into the shared views vector */
        std::vector<struct iovec> iov;
        ssize_t result;
    };
    std::vector<Py_buffer> views;
    std::vector<JobIov> parsed;
    parsed.reserve((size_t)njobs);
    for (Py_ssize_t i = 0; i < njobs; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        int fd;
        PyObject *bufseq;
        if (!PyArg_ParseTuple(item, "iO", &fd, &bufseq)) {
            for (auto &v : views) PyBuffer_Release(&v);
            Py_DECREF(fast);
            return NULL;
        }
        JobIov j;
        j.fd = fd;
        j.viv_start = views.size();
        if (collect_iov(bufseq, views, j.iov) < 0) {
            for (auto &v : views) PyBuffer_Release(&v);
            Py_DECREF(fast);
            return NULL;
        }
        j.viv_len = views.size() - j.viv_start;
        j.result = 0;
        parsed.push_back(std::move(j));
    }

    Py_BEGIN_ALLOW_THREADS;
    for (auto &j : parsed) j.result = writev_nb(j.fd, j.iov);
    Py_END_ALLOW_THREADS;

    for (auto &v : views) PyBuffer_Release(&v);
    Py_DECREF(fast);

    PyObject *out = PyList_New(njobs);
    if (!out) return NULL;
    for (Py_ssize_t i = 0; i < njobs; i++) {
        PyObject *v = PyLong_FromSsize_t(parsed[(size_t)i].result);
        if (!v) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, i, v);
    }
    return out;
}

/* recv_into_nb(fd, writable_buffer) -> int
 * Nonblocking drain: recv repeatedly into the buffer until it is full
 * or the socket would block — one GIL window for the whole burst.
 * Returns bytes read (0 = would block before any byte), -2 on EOF with
 * nothing read this call, or -errno on a hard error with nothing read
 * (partial reads return the partial count; the condition resurfaces on
 * the next call). */
static PyObject *fastwire_recv_into_nb(PyObject *self, PyObject *args) {
    int fd;
    Py_buffer buf;
    if (!PyArg_ParseTuple(args, "iw*", &fd, &buf)) return NULL;

    ssize_t got = 0, result = 0;
    Py_BEGIN_ALLOW_THREADS;
    char *p = (char *)buf.buf;
    size_t n = (size_t)buf.len;
    while ((size_t)got < n) {
        ssize_t rc = recv(fd, p + got, n - (size_t)got, 0);
        if (rc > 0) {
            got += rc;
            continue;
        }
        if (rc == 0) {
            result = (got > 0) ? got : -2;
            goto done;
        }
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
            result = got;
            goto done;
        }
        result = (got > 0) ? got : -(ssize_t)errno;
        goto done;
    }
    result = got;
done:;
    Py_END_ALLOW_THREADS;
    PyBuffer_Release(&buf);
    return PyLong_FromSsize_t(result);
}

/* ------------------------------------------------------------------ */
/* shm ring: same-host zero-copy bulk lane                             */
/* ------------------------------------------------------------------ */

/* One single-producer ring in a /dev/shm-backed file. The sender
 * (creator) serializes payloads directly into it and ships only a tiny
 * descriptor frame (ring name + offset + length) over the socket lane;
 * the receiver maps the same file and adopts the bytes zero-copy as a
 * ShmBuf that the pooled decode path consumes like any other buffer.
 *
 * Layout: a 4096-byte file header {u64 magic, u64 cap}, then a cap-byte
 * data region of 64-byte-aligned chunks. Each chunk starts with a
 * 64-byte header {u32 magic, u32 state, u64 size} (size = whole chunk,
 * header + payload + padding, a multiple of 64), so adopted payloads are
 * 64-byte aligned — the same alignment the receive pool guarantees.
 *
 * Concurrency contract: head/tail live in the CREATOR's ShmRing struct,
 * not in shared memory — the receiver never scans the ring, it only maps
 * explicit offsets named by descriptor frames. The one cross-process
 * mutation is the chunk ``state`` flag: the receiver's ShmBuf dealloc
 * atomically flips it to RELEASED, and the creator lazily reclaims
 * contiguous released chunks from head on each push. A push that cannot
 * find room returns None and the Python layer falls back to the socket
 * lane — the ring can stall a push, never lose one. */

#define SHM_FILE_HDR 4096
#define SHM_CHUNK_HDR 64
#define SHM_ALIGN 64
#define SHM_FILE_MAGIC 0x4645445450534852ULL /* "FEDTPSHR" */
#define SHM_CHUNK_MAGIC 0x46435348u          /* "FCSH" */
#define SHM_STATE_INFLIGHT 0u
#define SHM_STATE_RELEASED 1u

typedef struct {
    uint32_t magic;
    uint32_t state;
    uint64_t size;
    char pad[SHM_CHUNK_HDR - 16];
} ShmChunkHdr;

typedef struct {
    uint64_t magic;
    uint64_t cap;
} ShmFileHdr;

typedef struct {
    PyObject_HEAD
    char *base;        /* mmap base (file offset 0); NULL once unmapped */
    size_t cap;        /* data-region capacity in bytes */
    int fd;
    int creator;
    int closed;
    uint64_t head;     /* creator-side cumulative reclaim counter */
    uint64_t tail;     /* creator-side cumulative write counter */
    char path[256];
} ShmRing;

static char *shm_data(ShmRing *r) { return r->base + SHM_FILE_HDR; }

#if defined(__x86_64__) || defined(_M_X64)
#include <emmintrin.h>
/* Bulk copy with non-temporal stores: a pushed payload is read next by
 * the RECEIVER process, so filling the sender's cache with it is pure
 * waste — streaming stores skip the read-for-ownership and raise copy
 * bandwidth ~25% on this class of host. Head/tail fragments and small
 * copies go through plain memcpy. */
static void shm_copy(char *dst, const char *src, size_t n) {
    const size_t NT_MIN = (size_t)1 << 20;
    if (n < NT_MIN) {
        memcpy(dst, src, n);
        return;
    }
    size_t head = ((uintptr_t)dst) & 15 ? 16 - (((uintptr_t)dst) & 15) : 0;
    if (head) {
        memcpy(dst, src, head);
        dst += head;
        src += head;
        n -= head;
    }
    size_t i = 0;
    for (; i + 64 <= n; i += 64) {
        __m128i a = _mm_loadu_si128((const __m128i *)(src + i));
        __m128i b = _mm_loadu_si128((const __m128i *)(src + i + 16));
        __m128i c = _mm_loadu_si128((const __m128i *)(src + i + 32));
        __m128i d = _mm_loadu_si128((const __m128i *)(src + i + 48));
        _mm_stream_si128((__m128i *)(dst + i), a);
        _mm_stream_si128((__m128i *)(dst + i + 16), b);
        _mm_stream_si128((__m128i *)(dst + i + 32), c);
        _mm_stream_si128((__m128i *)(dst + i + 48), d);
    }
    _mm_sfence();
    if (i < n) memcpy(dst + i, src + i, n - i);
}
#else
static void shm_copy(char *dst, const char *src, size_t n) {
    memcpy(dst, src, n);
}
#endif

static void ShmRing_dealloc(PyObject *self) {
    ShmRing *r = (ShmRing *)self;
    if (r->creator && !r->closed && r->path[0]) unlink(r->path);
    if (r->base) munmap(r->base, SHM_FILE_HDR + r->cap);
    if (r->fd >= 0) close(r->fd);
    Py_TYPE(self)->tp_free(self);
}

static PyTypeObject ShmRing_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    "rayfed_tpu._fastwire.ShmRing", /* tp_name */
    sizeof(ShmRing),                /* tp_basicsize */
};

/* ShmBuf: a read-through view of one adopted chunk's payload. Dealloc
 * flips the chunk's release flag so the creator can reclaim the space —
 * the exact PooledBuf contract, with the pool replaced by the ring. */
typedef struct {
    PyObject_HEAD
    ShmRing *ring;     /* strong ref keeps the mapping alive */
    char *ptr;
    Py_ssize_t len;
    ShmChunkHdr *chunk;
} ShmBuf;

static void ShmBuf_dealloc(PyObject *self) {
    ShmBuf *sb = (ShmBuf *)self;
    if (sb->chunk) {
        __atomic_store_n(&sb->chunk->state, SHM_STATE_RELEASED,
                         __ATOMIC_RELEASE);
        sb->chunk = NULL;
    }
    Py_XDECREF((PyObject *)sb->ring);
    Py_TYPE(self)->tp_free(self);
}

static int ShmBuf_getbuffer(PyObject *self, Py_buffer *view, int flags) {
    ShmBuf *sb = (ShmBuf *)self;
    if (sb->ptr == NULL) {
        PyErr_SetString(PyExc_ValueError, "ShmBuf is released");
        return -1;
    }
    return PyBuffer_FillInfo(view, self, sb->ptr, sb->len, 0, flags);
}

static PyBufferProcs ShmBuf_as_buffer = {
    ShmBuf_getbuffer,
    NULL,
};

static Py_ssize_t ShmBuf_length(PyObject *self) {
    return ((ShmBuf *)self)->len;
}

static PySequenceMethods ShmBuf_as_sequence = {
    ShmBuf_length, /* sq_length — len(buf) == payload bytes */
};

static PyTypeObject ShmBuf_Type = {
    PyVarObject_HEAD_INIT(NULL, 0)
    "rayfed_tpu._fastwire.ShmBuf", /* tp_name */
    sizeof(ShmBuf),                /* tp_basicsize */
};

/* Ring names come off the wire (descriptor frames), so they are
 * validated as a single flat filename before touching the filesystem. */
static int shm_name_ok(const char *name) {
    size_t n = strlen(name);
    if (n == 0 || n > 200) return 0;
    for (size_t i = 0; i < n; i++) {
        char c = name[i];
        if (!((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
              (c >= '0' && c <= '9') || c == '-' || c == '_' || c == '.'))
            return 0;
    }
    if (name[0] == '.') return 0;
    return 1;
}

static PyObject *shm_ring_alloc(void) {
    ShmRing *r = PyObject_New(ShmRing, &ShmRing_Type);
    if (r == NULL) return NULL;
    r->base = NULL;
    r->cap = 0;
    r->fd = -1;
    r->creator = 0;
    r->closed = 0;
    r->head = 0;
    r->tail = 0;
    r->path[0] = '\0';
    return (PyObject *)r;
}

/* shm_ring_create(name, capacity) -> ShmRing
 * Creates /dev/shm/<name> (0600, O_EXCL) sized header + capacity and
 * maps it. The creator owns head/tail and unlinks the file on close. */
static PyObject *fastwire_shm_ring_create(PyObject *self, PyObject *args) {
    const char *name;
    unsigned long long cap_arg;
    if (!PyArg_ParseTuple(args, "sK", &name, &cap_arg)) return NULL;
    if (!shm_name_ok(name)) {
        PyErr_Format(PyExc_ValueError, "bad shm ring name %.220s", name);
        return NULL;
    }
    size_t cap = (size_t)cap_arg;
    if (cap < SHM_ALIGN) cap = SHM_ALIGN;
    cap = (cap + SHM_ALIGN - 1) & ~((size_t)SHM_ALIGN - 1);

    ShmRing *r = (ShmRing *)shm_ring_alloc();
    if (r == NULL) return NULL;
    snprintf(r->path, sizeof(r->path), "/dev/shm/%s", name);
    r->fd = open(r->path, O_RDWR | O_CREAT | O_EXCL | O_CLOEXEC, 0600);
    if (r->fd < 0) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, r->path);
        r->path[0] = '\0';
        Py_DECREF(r);
        return NULL;
    }
    if (ftruncate(r->fd, (off_t)(SHM_FILE_HDR + cap)) != 0) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, r->path);
        unlink(r->path);
        r->path[0] = '\0';
        Py_DECREF(r);
        return NULL;
    }
    r->base = (char *)mmap(NULL, SHM_FILE_HDR + cap,
                           PROT_READ | PROT_WRITE, MAP_SHARED, r->fd, 0);
    if (r->base == MAP_FAILED) {
        r->base = NULL;
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, r->path);
        unlink(r->path);
        r->path[0] = '\0';
        Py_DECREF(r);
        return NULL;
    }
    r->cap = cap;
    r->creator = 1;
    ShmFileHdr *h = (ShmFileHdr *)r->base;
    h->cap = (uint64_t)cap;
    /* Magic last: an attacher that races creation sees zero magic and
     * fails attach instead of reading a half-written header. */
    __atomic_store_n(&h->magic, SHM_FILE_MAGIC, __ATOMIC_RELEASE);
    return (PyObject *)r;
}

/* shm_ring_attach(name) -> ShmRing
 * Maps an existing ring read-write (the release flags are written
 * through this mapping). Never unlinks. */
static PyObject *fastwire_shm_ring_attach(PyObject *self, PyObject *args) {
    const char *name;
    if (!PyArg_ParseTuple(args, "s", &name)) return NULL;
    if (!shm_name_ok(name)) {
        PyErr_Format(PyExc_ValueError, "bad shm ring name %.220s", name);
        return NULL;
    }
    ShmRing *r = (ShmRing *)shm_ring_alloc();
    if (r == NULL) return NULL;
    snprintf(r->path, sizeof(r->path), "/dev/shm/%s", name);
    r->fd = open(r->path, O_RDWR | O_CLOEXEC);
    if (r->fd < 0) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, r->path);
        Py_DECREF(r);
        return NULL;
    }
    struct stat st;
    if (fstat(r->fd, &st) != 0) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, r->path);
        Py_DECREF(r);
        return NULL;
    }
    if (st.st_size < (off_t)SHM_FILE_HDR) {
        PyErr_Format(PyExc_ValueError, "shm ring %.220s truncated", name);
        Py_DECREF(r);
        return NULL;
    }
    r->base = (char *)mmap(NULL, (size_t)st.st_size,
                           PROT_READ | PROT_WRITE, MAP_SHARED, r->fd, 0);
    if (r->base == MAP_FAILED) {
        r->base = NULL;
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, r->path);
        Py_DECREF(r);
        return NULL;
    }
    ShmFileHdr *h = (ShmFileHdr *)r->base;
    uint64_t magic = __atomic_load_n(&h->magic, __ATOMIC_ACQUIRE);
    uint64_t cap = h->cap;
    if (magic != SHM_FILE_MAGIC || cap == 0 ||
        (uint64_t)st.st_size < SHM_FILE_HDR + cap) {
        munmap(r->base, (size_t)st.st_size);
        r->base = NULL;
        PyErr_Format(PyExc_ValueError,
                     "shm ring %.220s has bad header (magic/cap)", name);
        Py_DECREF(r);
        return NULL;
    }
    r->cap = (size_t)cap;
    return (PyObject *)r;
}

static int shm_check_ring(PyObject *obj, const char **why) {
    if (!PyObject_TypeCheck(obj, &ShmRing_Type)) {
        *why = "expected a ShmRing";
        return -1;
    }
    ShmRing *r = (ShmRing *)obj;
    if (r->base == NULL || r->closed) {
        *why = "ring is closed";
        return -1;
    }
    return 0;
}

/* Advance head over contiguous released chunks. Creator only. */
static void shm_reclaim(ShmRing *r) {
    while (r->head < r->tail) {
        size_t pos = (size_t)(r->head % r->cap);
        ShmChunkHdr *c = (ShmChunkHdr *)(shm_data(r) + pos);
        if (c->magic != SHM_CHUNK_MAGIC) break; /* corrupted: stop */
        if (__atomic_load_n(&c->state, __ATOMIC_ACQUIRE) !=
            SHM_STATE_RELEASED)
            break;
        uint64_t size = c->size;
        if (size < SHM_CHUNK_HDR || size % SHM_ALIGN != 0 ||
            r->head + size > r->tail)
            break; /* corrupted size: stop reclaiming, ring degrades */
        r->head += size;
    }
}

/* shm_ring_push(ring, buffers) -> payload offset | None
 * Copies the buffers back-to-back into one chunk (GIL released for the
 * byte work) and returns the data-region offset of the payload, or None
 * when the ring has no contiguous room (caller waits or falls back). */
static PyObject *fastwire_shm_ring_push(PyObject *self, PyObject *args) {
    PyObject *ring_obj, *seq;
    if (!PyArg_ParseTuple(args, "OO", &ring_obj, &seq)) return NULL;
    const char *why = NULL;
    if (shm_check_ring(ring_obj, &why) < 0) {
        PyErr_SetString(PyExc_ValueError, why);
        return NULL;
    }
    ShmRing *r = (ShmRing *)ring_obj;
    if (!r->creator) {
        PyErr_SetString(PyExc_ValueError,
                        "only the creating side may push into a shm ring");
        return NULL;
    }

    PyObject *fast = PySequence_Fast(seq, "buffers must be a sequence");
    if (!fast) return NULL;
    Py_ssize_t nbufs = PySequence_Fast_GET_SIZE(fast);
    std::vector<Py_buffer> views;
    views.reserve((size_t)nbufs);
    size_t total = 0;
    for (Py_ssize_t i = 0; i < nbufs; i++) {
        PyObject *item = PySequence_Fast_GET_ITEM(fast, i);
        Py_buffer view;
        if (PyObject_GetBuffer(item, &view, PyBUF_C_CONTIGUOUS) < 0) {
            for (auto &v : views) PyBuffer_Release(&v);
            Py_DECREF(fast);
            return NULL;
        }
        views.push_back(view);
        total += (size_t)view.len;
    }
    Py_DECREF(fast);

    size_t need = (SHM_CHUNK_HDR + total + SHM_ALIGN - 1) &
                  ~((size_t)SHM_ALIGN - 1);
    int fits = 0;
    size_t pos = 0;
    if (need <= r->cap) {
        shm_reclaim(r);
        pos = (size_t)(r->tail % r->cap);
        size_t wrem = (pos + need > r->cap) ? r->cap - pos : 0;
        size_t free_bytes = r->cap - (size_t)(r->tail - r->head);
        if (free_bytes >= wrem + need) {
            fits = 1;
            if (wrem) {
                /* Wrap marker: a pre-released chunk covering the unusable
                 * region tail, so reclaim walks past it naturally. */
                ShmChunkHdr *w = (ShmChunkHdr *)(shm_data(r) + pos);
                w->magic = SHM_CHUNK_MAGIC;
                w->size = (uint64_t)wrem;
                __atomic_store_n(&w->state, SHM_STATE_RELEASED,
                                 __ATOMIC_RELEASE);
                r->tail += wrem;
                pos = 0;
            }
        }
    }
    if (!fits) {
        for (auto &v : views) PyBuffer_Release(&v);
        Py_RETURN_NONE;
    }

    char *dst = shm_data(r) + pos + SHM_CHUNK_HDR;
    Py_BEGIN_ALLOW_THREADS;
    for (auto &v : views) {
        shm_copy(dst, (const char *)v.buf, (size_t)v.len);
        dst += (size_t)v.len;
    }
    Py_END_ALLOW_THREADS;
    for (auto &v : views) PyBuffer_Release(&v);

    ShmChunkHdr *c = (ShmChunkHdr *)(shm_data(r) + pos);
    c->magic = SHM_CHUNK_MAGIC;
    c->size = (uint64_t)need;
    __atomic_store_n(&c->state, SHM_STATE_INFLIGHT, __ATOMIC_RELEASE);
    r->tail += need;
    return PyLong_FromSize_t(pos + SHM_CHUNK_HDR);
}

/* shm_ring_adopt(ring, offset, nbytes) -> ShmBuf
 * Zero-copy view of a pushed payload; validated against the chunk header
 * so a bad descriptor raises instead of exposing arbitrary ring bytes. */
static PyObject *fastwire_shm_ring_adopt(PyObject *self, PyObject *args) {
    PyObject *ring_obj;
    unsigned long long off, nbytes;
    if (!PyArg_ParseTuple(args, "OKK", &ring_obj, &off, &nbytes))
        return NULL;
    const char *why = NULL;
    if (shm_check_ring(ring_obj, &why) < 0) {
        PyErr_SetString(PyExc_ValueError, why);
        return NULL;
    }
    ShmRing *r = (ShmRing *)ring_obj;
    if (off < SHM_CHUNK_HDR || off % SHM_ALIGN != 0 || off > r->cap ||
        nbytes > r->cap - off) {
        PyErr_Format(PyExc_ValueError,
                     "shm descriptor out of range (off=%llu len=%llu "
                     "cap=%zu)", off, nbytes, r->cap);
        return NULL;
    }
    ShmChunkHdr *c =
        (ShmChunkHdr *)(shm_data(r) + (size_t)off - SHM_CHUNK_HDR);
    if (c->magic != SHM_CHUNK_MAGIC ||
        __atomic_load_n(&c->state, __ATOMIC_ACQUIRE) !=
            SHM_STATE_INFLIGHT ||
        (uint64_t)SHM_CHUNK_HDR + nbytes > c->size) {
        PyErr_SetString(PyExc_ValueError,
                        "shm descriptor does not name a live chunk");
        return NULL;
    }
    ShmBuf *sb = PyObject_New(ShmBuf, &ShmBuf_Type);
    if (sb == NULL) return NULL;
    Py_INCREF(r);
    sb->ring = r;
    sb->ptr = shm_data(r) + (size_t)off;
    sb->len = (Py_ssize_t)nbytes;
    sb->chunk = c;
    return (PyObject *)sb;
}

/* shm_ring_cancel(ring, offset) -> None
 * Release a pushed chunk whose descriptor frame was never delivered
 * (sender-side fallback path) so its space is reclaimable. */
static PyObject *fastwire_shm_ring_cancel(PyObject *self, PyObject *args) {
    PyObject *ring_obj;
    unsigned long long off;
    if (!PyArg_ParseTuple(args, "OK", &ring_obj, &off)) return NULL;
    const char *why = NULL;
    if (shm_check_ring(ring_obj, &why) < 0) {
        PyErr_SetString(PyExc_ValueError, why);
        return NULL;
    }
    ShmRing *r = (ShmRing *)ring_obj;
    if (off < SHM_CHUNK_HDR || off % SHM_ALIGN != 0 || off > r->cap) {
        PyErr_SetString(PyExc_ValueError, "shm cancel offset out of range");
        return NULL;
    }
    ShmChunkHdr *c =
        (ShmChunkHdr *)(shm_data(r) + (size_t)off - SHM_CHUNK_HDR);
    if (c->magic != SHM_CHUNK_MAGIC) {
        PyErr_SetString(PyExc_ValueError, "shm cancel offset not a chunk");
        return NULL;
    }
    __atomic_store_n(&c->state, SHM_STATE_RELEASED, __ATOMIC_RELEASE);
    Py_RETURN_NONE;
}

/* shm_ring_occupancy(ring) -> (used_bytes, capacity)
 * Creator-side view after a reclaim pass (telemetry + wait-for-space). */
/* shm_ring_chunk_state(ring, off) -> int
 * Atomic read of a chunk's state word (0 inflight, 1 released) so the
 * sender can reclaim ONLY still-inflight chunks after a peer death —
 * cancelling a chunk the receiver already released would be a
 * double-release (the sanitizer treats it as one). */
static PyObject *fastwire_shm_ring_chunk_state(PyObject *self,
                                               PyObject *args) {
    PyObject *ring_obj;
    unsigned long long off;
    if (!PyArg_ParseTuple(args, "OK", &ring_obj, &off)) return NULL;
    const char *why = NULL;
    if (shm_check_ring(ring_obj, &why) < 0) {
        PyErr_SetString(PyExc_ValueError, why);
        return NULL;
    }
    ShmRing *r = (ShmRing *)ring_obj;
    if (off < SHM_CHUNK_HDR || off % SHM_ALIGN != 0 || off > r->cap) {
        PyErr_SetString(PyExc_ValueError, "shm chunk offset out of range");
        return NULL;
    }
    ShmChunkHdr *c =
        (ShmChunkHdr *)(shm_data(r) + (size_t)off - SHM_CHUNK_HDR);
    if (c->magic != SHM_CHUNK_MAGIC) {
        PyErr_SetString(PyExc_ValueError, "shm offset not a chunk");
        return NULL;
    }
    return PyLong_FromUnsignedLong(
        __atomic_load_n(&c->state, __ATOMIC_ACQUIRE));
}

static PyObject *fastwire_shm_ring_occupancy(PyObject *self, PyObject *args) {
    PyObject *ring_obj;
    if (!PyArg_ParseTuple(args, "O", &ring_obj)) return NULL;
    const char *why = NULL;
    if (shm_check_ring(ring_obj, &why) < 0) {
        PyErr_SetString(PyExc_ValueError, why);
        return NULL;
    }
    ShmRing *r = (ShmRing *)ring_obj;
    if (r->creator) shm_reclaim(r);
    return Py_BuildValue("(KK)", (unsigned long long)(r->tail - r->head),
                         (unsigned long long)r->cap);
}

/* shm_ring_close(ring) -> None
 * Creator: unlink the file (new attaches fail, live mappings survive).
 * Both sides: refuse further push/adopt. The mapping itself is unmapped
 * at dealloc, AFTER the last adopted ShmBuf is gone — ShmBufs hold a
 * strong ring reference, so close can never pull bytes out from under a
 * consumer. */
static PyObject *fastwire_shm_ring_close(PyObject *self, PyObject *args) {
    PyObject *ring_obj;
    if (!PyArg_ParseTuple(args, "O", &ring_obj)) return NULL;
    if (!PyObject_TypeCheck(ring_obj, &ShmRing_Type)) {
        PyErr_SetString(PyExc_TypeError, "expected a ShmRing");
        return NULL;
    }
    ShmRing *r = (ShmRing *)ring_obj;
    if (!r->closed) {
        if (r->creator && r->path[0]) unlink(r->path);
        if (r->fd >= 0) {
            close(r->fd);
            r->fd = -1;
        }
        r->closed = 1;
    }
    Py_RETURN_NONE;
}

/* ------------------------------------------------------------------ */
/* crc32c (Castagnoli) — frame-integrity fast path                     */
/* ------------------------------------------------------------------ */

static uint32_t crc32c_table[256];

static void crc32c_init_table(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = i;
        for (int j = 0; j < 8; j++)
            crc = (crc >> 1) ^ (0x82F63B78u & (uint32_t)(-(int32_t)(crc & 1)));
        crc32c_table[i] = crc;
    }
}

/* crc32c(data, crc=0) -> int
 * Streaming CRC-32C over one contiguous buffer; pass the previous
 * return value as `crc` to accumulate across buffers (zlib.crc32
 * calling convention). GIL released while crunching. */
static PyObject *fastwire_crc32c(PyObject *self, PyObject *args) {
    Py_buffer view;
    unsigned int crc_in = 0;
    if (!PyArg_ParseTuple(args, "y*|I", &view, &crc_in)) return NULL;
    uint32_t crc = crc_in ^ 0xFFFFFFFFu;
    const unsigned char *p = (const unsigned char *)view.buf;
    Py_ssize_t n = view.len;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t k = 0; k < n; k++)
        crc = crc32c_table[(crc ^ p[k]) & 0xFF] ^ (crc >> 8);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    return PyLong_FromUnsignedLong(crc ^ 0xFFFFFFFFu);
}

/* ------------------------------------------------------------------ */
/* module                                                              */
/* ------------------------------------------------------------------ */

static PyMethodDef fastwire_methods[] = {
    {"crc32c", fastwire_crc32c, METH_VARARGS,
     "crc32c(data, crc=0) -> int: streaming CRC-32C (Castagnoli)."},
    {"sendv", fastwire_sendv, METH_VARARGS,
     "sendv(fd, timeout_ms, buffers): fully send all buffers via writev."},
    {"recv_exact", fastwire_recv_exact, METH_VARARGS,
     "recv_exact(fd, timeout_ms, buffer): fill the writable buffer."},
    {"recv_prefix_header", fastwire_recv_prefix_header, METH_VARARGS,
     "recv_prefix_header(fd, timeout_ms, magic, version, max_header, "
     "max_payload) -> (ftype, plen, header_bytes)."},
    {"recv_frame_small", fastwire_recv_frame_small, METH_VARARGS,
     "recv_frame_small(fd, timeout_ms, magic, version, max_header, "
     "max_payload, small_max) -> (ftype, plen, header_bytes, "
     "payload|None): whole small frame in one GIL-released window."},
    {"recv_scatter", fastwire_recv_scatter, METH_VARARGS,
     "recv_scatter(fd, timeout_ms, sizes) -> list of pooled buffers."},
    {"pool_trim", fastwire_pool_trim, METH_NOARGS,
     "pool_trim(): free every idle pooled receive block."},
    {"reactor_new", fastwire_reactor_new, METH_NOARGS,
     "reactor_new() -> epoll fd (close-on-exec)."},
    {"reactor_close", fastwire_reactor_close, METH_VARARGS,
     "reactor_close(epfd): close the epoll fd."},
    {"reactor_ctl", fastwire_reactor_ctl, METH_VARARGS,
     "reactor_ctl(epfd, op, fd, events): EPOLL_CTL_{ADD=1,DEL=2,MOD=3}."},
    {"reactor_wait", fastwire_reactor_wait, METH_VARARGS,
     "reactor_wait(epfd, timeout_ms) -> [(fd, events)] in one "
     "GIL-released epoll_wait."},
    {"sendv_nb", fastwire_sendv_nb, METH_VARARGS,
     "sendv_nb(fd, buffers) -> bytes written (0 on EAGAIN, -errno on "
     "error); one nonblocking writev batch."},
    {"flush_many", fastwire_flush_many, METH_VARARGS,
     "flush_many([(fd, buffers), ...]) -> [bytes|-errno]: flush many "
     "connections' send rings in one GIL window."},
    {"recv_into_nb", fastwire_recv_into_nb, METH_VARARGS,
     "recv_into_nb(fd, buffer) -> bytes read (0 would-block, -2 EOF, "
     "-errno error); drains a burst in one GIL window."},
    {"shm_ring_create", fastwire_shm_ring_create, METH_VARARGS,
     "shm_ring_create(name, capacity) -> ShmRing under /dev/shm."},
    {"shm_ring_attach", fastwire_shm_ring_attach, METH_VARARGS,
     "shm_ring_attach(name) -> ShmRing mapping an existing ring."},
    {"shm_ring_push", fastwire_shm_ring_push, METH_VARARGS,
     "shm_ring_push(ring, buffers) -> payload offset, or None when the "
     "ring has no room (caller waits or falls back to the socket lane)."},
    {"shm_ring_adopt", fastwire_shm_ring_adopt, METH_VARARGS,
     "shm_ring_adopt(ring, offset, nbytes) -> ShmBuf zero-copy view; "
     "its dealloc releases the chunk back to the creator."},
    {"shm_ring_cancel", fastwire_shm_ring_cancel, METH_VARARGS,
     "shm_ring_cancel(ring, offset): release an undelivered chunk."},
    {"shm_ring_chunk_state", fastwire_shm_ring_chunk_state, METH_VARARGS,
     "shm_ring_chunk_state(ring, offset) -> 0 inflight / 1 released."},
    {"shm_ring_occupancy", fastwire_shm_ring_occupancy, METH_VARARGS,
     "shm_ring_occupancy(ring) -> (used_bytes, capacity)."},
    {"shm_ring_close", fastwire_shm_ring_close, METH_VARARGS,
     "shm_ring_close(ring): unlink (creator) and refuse further ops; "
     "live ShmBufs keep the mapping alive until they are dropped."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef fastwire_module = {
    PyModuleDef_HEAD_INIT, "_fastwire",
    "Native (C++) data-plane engine for the rayfed_tpu FTP1 protocol.", -1,
    fastwire_methods,
};

PyMODINIT_FUNC PyInit__fastwire(void) {
    crc32c_init_table();
    PooledBuf_Type.tp_dealloc = PooledBuf_dealloc;
    PooledBuf_Type.tp_flags = Py_TPFLAGS_DEFAULT;
    PooledBuf_Type.tp_doc = "Pooled receive buffer (writable, buffer protocol)";
    PooledBuf_Type.tp_as_buffer = &PooledBuf_as_buffer;
    PooledBuf_Type.tp_as_sequence = &PooledBuf_as_sequence;
    PooledBuf_Type.tp_new = NULL; /* C-internal construction only */
    if (PyType_Ready(&PooledBuf_Type) < 0) return NULL;

    ShmRing_Type.tp_dealloc = ShmRing_dealloc;
    ShmRing_Type.tp_flags = Py_TPFLAGS_DEFAULT;
    ShmRing_Type.tp_doc = "Same-host shared-memory ring (/dev/shm file)";
    ShmRing_Type.tp_new = NULL; /* C-internal construction only */
    if (PyType_Ready(&ShmRing_Type) < 0) return NULL;

    ShmBuf_Type.tp_dealloc = ShmBuf_dealloc;
    ShmBuf_Type.tp_flags = Py_TPFLAGS_DEFAULT;
    ShmBuf_Type.tp_doc =
        "Adopted shm chunk payload (buffer protocol); dealloc releases "
        "the chunk back to the ring's creator";
    ShmBuf_Type.tp_as_buffer = &ShmBuf_as_buffer;
    ShmBuf_Type.tp_as_sequence = &ShmBuf_as_sequence;
    ShmBuf_Type.tp_new = NULL; /* C-internal construction only */
    if (PyType_Ready(&ShmBuf_Type) < 0) return NULL;

    const char *cap_mb = getenv("FEDTPU_RECV_POOL_MB");
    if (cap_mb != NULL) {
        char *end = NULL;
        long v = strtol(cap_mb, &end, 10);
        if (end != cap_mb && *end == '\0' && v >= 0)
            pool_cap = (size_t)v << 20;
    }

    PyObject *m = PyModule_Create(&fastwire_module);
    if (m == NULL) return NULL;
    Py_INCREF(&PooledBuf_Type);
    if (PyModule_AddObject(m, "PooledBuf", (PyObject *)&PooledBuf_Type) < 0) {
        Py_DECREF(&PooledBuf_Type);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&ShmRing_Type);
    if (PyModule_AddObject(m, "ShmRing", (PyObject *)&ShmRing_Type) < 0) {
        Py_DECREF(&ShmRing_Type);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&ShmBuf_Type);
    if (PyModule_AddObject(m, "ShmBuf", (PyObject *)&ShmBuf_Type) < 0) {
        Py_DECREF(&ShmBuf_Type);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
