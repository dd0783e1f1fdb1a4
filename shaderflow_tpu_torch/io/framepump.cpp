// The frame pump: an ordered, asynchronous writer of frames to a file
// descriptor (an encoder's stdin), so the export renders batch k + 1 while
// the encoder still takes batch k.
//
// pump_submit copies a frame into a free slot of a fixed ring and returns;
// one worker thread writes the filled slots to the descriptor in the order
// they were submitted. With every slot full, pump_submit waits for the
// worker to free one. A failed write(2) sets a sticky error (-errno): the
// worker then drops what is queued, and every later call returns it.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libframepump.so framepump.cpp -lpthread
// C API (ctypes):
//   void* pump_create(int fd, size_t slot_size, int slots)      // nullptr on bad sizes
//   long  pump_submit(void* pump, const void* data, size_t len) // 0, or -errno
//   long  pump_flush(void* pump)      // wait until every slot is written; 0 or -errno
//   long  pump_error(void* pump)      // the sticky error, 0 if none
//   long  pump_destroy(void* pump)    // flush, stop the worker, free; 0 or -errno

#include <condition_variable>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <errno.h>
#include <unistd.h>

namespace {

class FramePump {
public:
    FramePump(int fd, size_t slot_size, int slots)
        : fd_(fd), slot_size_(slot_size), data_(static_cast<size_t>(slots)),
          lengths_(static_cast<size_t>(slots), 0) {
        for (auto& slot : data_) {
            slot.resize(slot_size);
        }
        worker_ = std::thread([this] { run(); });
    }

    // Copy `len` bytes into the next slot (waiting for one to be free) and
    // queue it behind the slots already submitted. Submitters take turns,
    // so the slot copied into unlocked is the next one queued.
    long submit(const void* data, size_t len) {
        if (len > slot_size_) {
            return -EINVAL;
        }
        std::lock_guard<std::mutex> turn(submit_mutex_);
        std::unique_lock<std::mutex> lock(mutex_);
        freed_.wait(lock, [this] { return error_ != 0 || queued_ < data_.size(); });
        if (error_ != 0) {
            return error_;
        }
        const size_t slot = (head_ + queued_) % data_.size();
        // The slot is the submitter's until it is queued: copy unlocked
        lock.unlock();
        std::memcpy(data_[slot].data(), data, len);
        lock.lock();
        lengths_[slot] = len;
        ++queued_;
        filled_.notify_one();
        return 0;
    }

    long flush() {
        std::unique_lock<std::mutex> lock(mutex_);
        freed_.wait(lock, [this] { return queued_ == 0; });
        return error_;
    }

    long error() {
        std::lock_guard<std::mutex> lock(mutex_);
        return error_;
    }

    long stop() {
        const long status = flush();
        {
            std::lock_guard<std::mutex> lock(mutex_);
            stopping_ = true;
        }
        filled_.notify_one();
        worker_.join();
        return status;
    }

private:
    // Write the oldest queued slot, free it, and go on, until stopped with
    // nothing queued. After an error, queued slots are freed unwritten.
    void run() {
        std::unique_lock<std::mutex> lock(mutex_);
        for (;;) {
            filled_.wait(lock, [this] { return stopping_ || queued_ > 0; });
            if (queued_ == 0) {
                return;
            }
            const size_t slot = head_;
            const bool failed = error_ != 0;
            lock.unlock();
            const long status = failed ? 0 : write_all(data_[slot].data(), lengths_[slot]);
            lock.lock();
            if (status != 0) {
                error_ = status;
            }
            head_ = (head_ + 1) % data_.size();
            --queued_;
            freed_.notify_all();
        }
    }

    long write_all(const char* data, size_t len) {
        while (len > 0) {
            const ssize_t wrote = ::write(fd_, data, len);
            if (wrote < 0) {
                if (errno == EINTR) {
                    continue;
                }
                return -static_cast<long>(errno);
            }
            data += wrote;
            len -= static_cast<size_t>(wrote);
        }
        return 0;
    }

    const int fd_;
    const size_t slot_size_;
    std::vector<std::vector<char>> data_;
    std::vector<size_t> lengths_;
    size_t head_ = 0;       // the oldest queued slot
    size_t queued_ = 0;     // slots submitted and not yet written
    long error_ = 0;
    bool stopping_ = false;
    std::mutex submit_mutex_;          // one submitter at a time
    std::mutex mutex_;                 // the ring's state above
    std::condition_variable filled_;   // a slot was queued, or stop
    std::condition_variable freed_;    // a slot was written (or dropped)
    std::thread worker_;
};

}  // namespace

extern "C" {

void* pump_create(int fd, size_t slot_size, int slots) {
    if (fd < 0 || slot_size == 0 || slots < 1) {
        return nullptr;
    }
    return new FramePump(fd, slot_size, slots);
}

long pump_submit(void* pump, const void* data, size_t len) {
    return pump ? static_cast<FramePump*>(pump)->submit(data, len) : -EINVAL;
}

long pump_flush(void* pump) {
    return pump ? static_cast<FramePump*>(pump)->flush() : -EINVAL;
}

long pump_error(void* pump) {
    return pump ? static_cast<FramePump*>(pump)->error() : -EINVAL;
}

long pump_destroy(void* pump) {
    if (!pump) {
        return -EINVAL;
    }
    auto* owned = static_cast<FramePump*>(pump);
    const long status = owned->stop();
    delete owned;
    return status;
}

}  // extern "C"
