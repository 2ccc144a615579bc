// Native writer of the track-photometries CSV: the rows that
// pipeline/fast_experiment.py::write_track_rows_csv writes through
// csv.writer for run_experiment's rows, laid out byte for byte from
// arrays instead of from per-row Python objects, on several threads.
//
// One row per trace, in the excel dialect (',' between cells, "\r\n"
// after each row):
//   CHANNEL, FIELD, H, W, CATEGORY, then C values
// The channel and category cells come as tables of texts that the caller
// quoted with csv.writer, so the core never decides quoting. FIELD, H and
// W are integers in decimal, H and W "None" where flagged; a value is
// repr(float) (pyrepr.h), or "0" where flagged None.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <charconv>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <unistd.h>

#include "pyrepr.h"

namespace {

// Texts end to end, text i in [off[i], off[i + 1]).
struct Table {
    const char* text;
    const int64_t* off;
    int64_t n;
    char* put(char* p, int32_t i) const {
        const int64_t len = off[i + 1] - off[i];
        std::memcpy(p, text + off[i], static_cast<size_t>(len));
        return p + len;
    }
    int64_t longest() const {
        int64_t m = 0;
        for (int64_t i = 0; i < n; i++) m = std::max(m, off[i + 1] - off[i]);
        return m;
    }
};

struct Inputs {
    int64_t C;
    const int32_t* channel;
    Table channels;
    const int64_t* field;
    const int64_t* h;
    const int64_t* w;
    const uint8_t* h_none;
    const uint8_t* w_none;
    const int32_t* category;
    Table categories;
    const double* values;
    const uint8_t* none;
};

char* put_int(char* p, int64_t v) {
    return std::to_chars(p, p + 20, v).ptr;  // 20: "-9223372036854775808"
}

// The most bytes a row can take: its texts, three integers or "None",
// C values of at most 24 characters, the commas and "\r\n".
int64_t row_bound(const Inputs& in) {
    return in.channels.longest() + in.categories.longest() + 3 * 20 +
           in.C * 25 + 6;
}

// Formats rows [lo, hi) from p on; returns the end.
char* format_rows(const Inputs& in, int64_t lo, int64_t hi, char* p) {
    for (int64_t i = lo; i < hi; i++) {
        p = in.channels.put(p, in.channel[i]);
        *p++ = ',';
        p = put_int(p, in.field[i]);
        *p++ = ',';
        if (in.h_none[i]) {
            std::memcpy(p, "None", 4);
            p += 4;
        } else {
            p = put_int(p, in.h[i]);
        }
        *p++ = ',';
        if (in.w_none[i]) {
            std::memcpy(p, "None", 4);
            p += 4;
        } else {
            p = put_int(p, in.w[i]);
        }
        *p++ = ',';
        p = in.categories.put(p, in.category[i]);
        const double* v = in.values + i * in.C;
        const uint8_t* none = in.none + i * in.C;
        for (int64_t c = 0; c < in.C; c++) {
            *p++ = ',';
            if (none[c]) {
                *p++ = '0';
            } else {
                p = pyrepr::put_double(p, v[c]);
            }
        }
        *p++ = '\r';
        *p++ = '\n';
    }
    return p;
}

bool write_all(int fd, const char* p, size_t n) {
    while (n > 0) {
        ssize_t w = ::write(fd, p, n);
        if (w < 0) {
            if (errno == EINTR) continue;
            return false;
        }
        p += w;
        n -= static_cast<size_t>(w);
    }
    return true;
}

}  // namespace

// Rows a block holds: the unit a thread formats and the writer writes.
constexpr int64_t BLOCK_ROWS = 2048;
// Blocks formatted ahead of the writer at most, a thread: bounds the
// text held in memory whatever the number of rows.
constexpr int64_t AHEAD = 4;

// Writes the N rows of C values to the open file descriptor fd at its
// offset, in blocks of BLOCK_ROWS rows. With more than one block and
// n_threads > 1, up to n_threads threads take the blocks in order and
// format each into a buffer of its own, while this thread writes the
// blocks in order as each is done. Returns N; or -1 with err[0] = errno
// if a write failed (the file then holds the blocks before it).
extern "C" int64_t trcsv_write(
    int32_t fd, int64_t N, int64_t C, const int32_t* channel,
    const char* channel_text, const int64_t* channel_off,
    int64_t n_channels, const int64_t* field, const int64_t* h,
    const int64_t* w, const uint8_t* h_none, const uint8_t* w_none,
    const int32_t* category, const char* category_text,
    const int64_t* category_off, int64_t n_categories,
    const double* values, const uint8_t* none, int32_t n_threads,
    int64_t* err) {
    const Inputs in{C, channel, {channel_text, channel_off, n_channels},
                    field, h, w, h_none, w_none, category,
                    {category_text, category_off, n_categories}, values,
                    none};
    const int64_t bound = row_bound(in);
    const int64_t n_blocks = (N + BLOCK_ROWS - 1) / BLOCK_ROWS;
    const int64_t nt = std::max<int64_t>(
        1, std::min<int64_t>(n_threads, n_blocks));
    auto rows_of = [&](int64_t b) {
        return std::min(BLOCK_ROWS, N - b * BLOCK_ROWS);
    };
    if (nt == 1) {
        std::unique_ptr<char[]> buf(
            new char[static_cast<size_t>(std::min(BLOCK_ROWS, N) * bound)]);
        for (int64_t b = 0; b < n_blocks; b++) {
            const int64_t lo = b * BLOCK_ROWS;
            char* end = format_rows(in, lo, lo + rows_of(b), buf.get());
            if (!write_all(fd, buf.get(),
                           static_cast<size_t>(end - buf.get()))) {
                err[0] = errno;
                return -1;
            }
        }
        return N;
    }
    struct Block {
        std::unique_ptr<char[]> text;
        size_t size = 0;
        bool done = false;
    };
    std::vector<Block> blocks(static_cast<size_t>(n_blocks));
    std::mutex mutex;
    std::condition_variable changed;
    std::atomic<int64_t> next{0};
    int64_t written = 0;  // blocks written, under the mutex
    bool failed = false;  // a write failed: the threads stop
    auto work = [&] {
        for (int64_t b = next++; b < n_blocks; b = next++) {
            {
                std::unique_lock<std::mutex> lock(mutex);
                changed.wait(lock, [&] {
                    return failed || b < written + AHEAD * nt;
                });
                if (failed) return;
            }
            const int64_t lo = b * BLOCK_ROWS;
            std::unique_ptr<char[]> text(
                new char[static_cast<size_t>(rows_of(b) * bound)]);
            char* end = format_rows(in, lo, lo + rows_of(b), text.get());
            {
                std::lock_guard<std::mutex> lock(mutex);
                blocks[b].size = static_cast<size_t>(end - text.get());
                blocks[b].text = std::move(text);
                blocks[b].done = true;
            }
            changed.notify_all();
        }
    };
    std::vector<std::thread> threads;
    for (int64_t k = 0; k < nt; k++) threads.emplace_back(work);
    int64_t result = N;
    for (int64_t b = 0; b < n_blocks; b++) {
        std::unique_ptr<char[]> text;
        size_t size;
        {
            std::unique_lock<std::mutex> lock(mutex);
            changed.wait(lock, [&] { return blocks[b].done; });
            text = std::move(blocks[b].text);
            size = blocks[b].size;
        }
        const bool ok = write_all(fd, text.get(), size);
        {
            std::lock_guard<std::mutex> lock(mutex);
            if (ok) {
                written = b + 1;
            } else {
                failed = true;
            }
        }
        changed.notify_all();
        if (!ok) {
            err[0] = errno;
            result = -1;
            break;
        }
    }
    for (auto& t : threads) t.join();
    return result;
}
