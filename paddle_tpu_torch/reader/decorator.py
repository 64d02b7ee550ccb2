"""Reader combinators (reference: python/paddle/reader/decorator.py;
counterpart ``paddle_tpu/reader/decorator.py``, the port's own copy).

A reader is a zero-arg callable yielding samples.  All combinators return a
new reader and never consume the source until iterated.
"""

import itertools
import queue
import random
import threading

__all__ = ["cache", "map_readers", "shuffle", "chain", "compose",
           "buffered", "firstn", "xmap_readers", "multiprocess_reader"]


def cache(reader):
    """Read all samples into memory once, then serve from the cache."""
    all_data = []
    loaded = [False]

    def impl():
        if not loaded[0]:
            all_data.extend(reader())
            loaded[0] = True
        return iter(all_data)

    return impl


def map_readers(func, *readers):
    """Yield func(*samples) over zipped source readers."""

    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle: fill a buf_size window, emit in random order."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            random.shuffle(buf)
            yield from buf

    return data_reader


def chain(*readers):
    """Concatenate readers back to back."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


def compose(*readers, **kwargs):
    """Zip readers into flattened tuples; check_alignment guards ragged
    sources (reference raises ComposeNotAligned)."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum([make_tuple(o) for o in outputs], ())
        else:
            for outputs in zip(*rs):
                yield sum([make_tuple(o) for o in outputs], ())

    return reader


class ComposeNotAligned(ValueError):
    pass


def buffered(reader, size):
    """Background-thread prefetch through a bounded queue (the host half of
    the reference's double-buffering ``reader/buffered_reader.cc``)."""

    class _End:
        def __init__(self, err=None):
            self.err = err

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)

        def read_worker():
            err = None
            try:
                for d in r:
                    q.put(d)
            except BaseException as exc:  # re-raised on the consumer side
                err = exc
            finally:
                q.put(_End(err))

        t = threading.Thread(target=read_worker, daemon=True)
        t.start()
        e = q.get()
        while not isinstance(e, _End):
            yield e
            e = q.get()
        if e.err is not None:
            raise e.err

    return data_reader


def firstn(reader, n):
    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over samples with worker threads (reference uses threads
    too — the mappers are numpy/PIL work that releases the GIL)."""

    end = object()

    def data_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        out_order = [0]
        order_cv = threading.Condition()

        def read_worker():
            for i, d in enumerate(reader()):
                in_q.put((i, d) if order else d)
            in_q.put(end)

        def handle_worker():
            sample = in_q.get()
            while sample is not end:
                if order:
                    i, d = sample
                    r = mapper(d)
                    with order_cv:
                        order_cv.wait_for(lambda: out_order[0] == i)
                        out_q.put(r)
                        out_order[0] += 1
                        order_cv.notify_all()
                else:
                    out_q.put(mapper(sample))
                sample = in_q.get()
            in_q.put(end)
            out_q.put(end)

        threading.Thread(target=read_worker, daemon=True).start()
        workers = []
        for _ in range(process_num):
            t = threading.Thread(target=handle_worker, daemon=True)
            t.start()
            workers.append(t)

        finished = 0
        while finished < process_num:
            sample = out_q.get()
            if sample is end:
                finished += 1
            else:
                yield sample

    return data_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave multiple readers via worker threads (reference uses
    multiprocessing; thread workers keep the same API without fork issues
    under a live CUDA context)."""

    end = object()

    def data_reader():
        q = queue.Queue(queue_size)

        def worker(r):
            try:
                for d in r():
                    q.put(d)
            finally:
                q.put(end)

        for r in readers:
            threading.Thread(target=worker, args=(r,), daemon=True).start()
        finished = 0
        while finished < len(readers):
            sample = q.get()
            if sample is end:
                finished += 1
            else:
                yield sample

    return data_reader
