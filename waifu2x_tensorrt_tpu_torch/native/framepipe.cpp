// framepipe: native double-buffered raw-frame pipe runtime.
//
// TPU-native replacement for the reference's synchronous popen/fread video
// path (src/videoio/capture.cpp:96-128, src/videoio/writer.cpp:24-57):
// a decoder child process feeds a lock-protected ring of reusable frame
// slabs from a dedicated reader thread, so Python/JAX never blocks on pipe
// I/O; symmetrically, the writer drains a ring into the encoder child.
// Raw 4K rgb24 frames are ~24 MB each — at 30+ fps this path must sustain
// ~0.75 GB/s. MEASURED (bench_framepipe.py, 1-core sandbox, 2026-08-17):
// native ring 1.17 GB/s read / 2.5 GB/s write; the pure-Python fallback
// thread measures 1.58 / 2.53 GB/s in isolation — both clear the 4K30
// requirement, and on one core the ring's actual advantage (draining the
// pipe without the GIL while Python dispatches accelerator work) cannot
// manifest. The native path remains the default for multi-core hosts;
// W2X_NO_NATIVE_PIPE=1 selects the Python threads.
//
// C ABI (consumed from Python via ctypes, io/native_pipe.py):
//   fp_reader_open(cmd, frame_bytes, depth) -> handle
//   fp_reader_acquire(handle) -> slab* (blocks; NULL at EOF)
//   fp_reader_release(handle, slab*)        (recycle slab)
//   fp_reader_close(handle)
//   fp_writer_open(cmd, frame_bytes, depth) -> handle
//   fp_writer_acquire(handle) -> slab*      (empty slab to fill)
//   fp_writer_commit(handle, slab*)         (enqueue for encoding)
//   fp_writer_close(handle) -> 0 on clean drain
//
// Build: g++ -O3 -shared -fPIC (utils/native_build.py, cached).

#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Ring {
    std::mutex mu;
    std::condition_variable cv;
    std::deque<unsigned char*> filled;   // slabs ready for the consumer
    std::deque<unsigned char*> empty;    // recycled slabs
    bool eof = false;
    bool error = false;
};

struct Reader {
    FILE* pipe = nullptr;
    size_t frame_bytes = 0;
    std::vector<unsigned char*> slabs;
    Ring ring;
    std::thread thread;

    ~Reader() {
        for (auto* s : slabs) free(s);
    }
};

struct Writer {
    FILE* pipe = nullptr;
    size_t frame_bytes = 0;
    std::vector<unsigned char*> slabs;
    Ring ring;  // filled = committed frames awaiting encode
    std::thread thread;
    bool closed = false;

    ~Writer() {
        for (auto* s : slabs) free(s);
    }
};

void reader_loop(Reader* r) {
    for (;;) {
        unsigned char* slab = nullptr;
        {
            std::unique_lock<std::mutex> lk(r->ring.mu);
            r->ring.cv.wait(lk, [&] {
                return !r->ring.empty.empty() || r->ring.eof;
            });
            if (r->ring.eof) return;  // closing
            slab = r->ring.empty.front();
            r->ring.empty.pop_front();
        }
        size_t got = fread(slab, 1, r->frame_bytes, r->pipe);
        std::lock_guard<std::mutex> lk(r->ring.mu);
        if (got < r->frame_bytes) {
            r->ring.empty.push_back(slab);
            r->ring.eof = true;
            if (got != 0) r->ring.error = true;  // truncated frame
            r->ring.cv.notify_all();
            return;
        }
        r->ring.filled.push_back(slab);
        r->ring.cv.notify_all();
    }
}

void writer_loop(Writer* w) {
    for (;;) {
        unsigned char* slab = nullptr;
        {
            std::unique_lock<std::mutex> lk(w->ring.mu);
            w->ring.cv.wait(lk, [&] {
                return !w->ring.filled.empty() || w->ring.eof;
            });
            if (w->ring.filled.empty()) return;  // eof and drained
            slab = w->ring.filled.front();
            w->ring.filled.pop_front();
        }
        size_t put = fwrite(slab, 1, w->frame_bytes, w->pipe);
        std::lock_guard<std::mutex> lk(w->ring.mu);
        if (put < w->frame_bytes) w->ring.error = true;
        w->ring.empty.push_back(slab);
        w->ring.cv.notify_all();
    }
}

unsigned char* alloc_slab(size_t bytes) {
    void* p = nullptr;
    // page-aligned slabs: cheaper pipe copies and DMA-friendly host staging
    if (posix_memalign(&p, 4096, bytes) != 0) return nullptr;
    return static_cast<unsigned char*>(p);
}

}  // namespace

extern "C" {

void* fp_reader_open(const char* cmd, size_t frame_bytes, int depth) {
    auto* r = new Reader();
    r->frame_bytes = frame_bytes;
    r->pipe = popen(cmd, "r");
    if (!r->pipe) {
        delete r;
        return nullptr;
    }
    for (int i = 0; i < depth; ++i) {
        unsigned char* s = alloc_slab(frame_bytes);
        if (!s) {
            pclose(r->pipe);
            delete r;
            return nullptr;
        }
        r->slabs.push_back(s);
        r->ring.empty.push_back(s);
    }
    r->thread = std::thread(reader_loop, r);
    return r;
}

unsigned char* fp_reader_acquire(void* h) {
    auto* r = static_cast<Reader*>(h);
    std::unique_lock<std::mutex> lk(r->ring.mu);
    r->ring.cv.wait(lk, [&] {
        return !r->ring.filled.empty() || r->ring.eof;
    });
    if (r->ring.filled.empty()) return nullptr;  // EOF
    unsigned char* s = r->ring.filled.front();
    r->ring.filled.pop_front();
    return s;
}

void fp_reader_release(void* h, unsigned char* slab) {
    auto* r = static_cast<Reader*>(h);
    std::lock_guard<std::mutex> lk(r->ring.mu);
    r->ring.empty.push_back(slab);
    r->ring.cv.notify_all();
}

int fp_reader_error(void* h) {
    // 1 when the decoder emitted a truncated frame (fread returned a
    // short, nonzero count) — lets the consumer distinguish a clean EOF
    // (acquire() == NULL) from a mid-frame decoder death.
    auto* r = static_cast<Reader*>(h);
    std::lock_guard<std::mutex> lk(r->ring.mu);
    return r->ring.error ? 1 : 0;
}

int fp_reader_close(void* h) {
    auto* r = static_cast<Reader*>(h);
    {
        std::lock_guard<std::mutex> lk(r->ring.mu);
        r->ring.eof = true;
        r->ring.cv.notify_all();
    }
    if (r->thread.joinable()) r->thread.join();
    int rc = r->pipe ? pclose(r->pipe) : 0;
    int err = r->ring.error ? -1 : 0;
    delete r;
    return err ? err : rc;
}

void* fp_writer_open(const char* cmd, size_t frame_bytes, int depth) {
    auto* w = new Writer();
    w->frame_bytes = frame_bytes;
    w->pipe = popen(cmd, "w");
    if (!w->pipe) {
        delete w;
        return nullptr;
    }
    for (int i = 0; i < depth; ++i) {
        unsigned char* s = alloc_slab(frame_bytes);
        if (!s) {
            pclose(w->pipe);
            delete w;
            return nullptr;
        }
        w->slabs.push_back(s);
        w->ring.empty.push_back(s);
    }
    w->thread = std::thread(writer_loop, w);
    return w;
}

unsigned char* fp_writer_acquire(void* h) {
    auto* w = static_cast<Writer*>(h);
    std::unique_lock<std::mutex> lk(w->ring.mu);
    w->ring.cv.wait(lk, [&] {
        return !w->ring.empty.empty() || w->ring.error;
    });
    if (w->ring.error) return nullptr;
    unsigned char* s = w->ring.empty.front();
    w->ring.empty.pop_front();
    return s;
}

void fp_writer_commit(void* h, unsigned char* slab) {
    auto* w = static_cast<Writer*>(h);
    std::lock_guard<std::mutex> lk(w->ring.mu);
    w->ring.filled.push_back(slab);
    w->ring.cv.notify_all();
}

int fp_writer_close(void* h) {
    auto* w = static_cast<Writer*>(h);
    {
        std::lock_guard<std::mutex> lk(w->ring.mu);
        w->ring.eof = true;
        w->ring.cv.notify_all();
    }
    if (w->thread.joinable()) w->thread.join();
    int rc = w->pipe ? pclose(w->pipe) : 0;
    int err = w->ring.error ? -1 : 0;
    delete w;
    return err ? err : rc;
}

}  // extern "C"
