"""Reader creators (reference: python/paddle/reader/creator.py;
counterpart ``paddle_tpu/reader/creator.py``): ``np_array`` and
``text_file``.  ``recordio`` needs the native recordio scanner, which
the port does not have yet (ROADMAP queue 1 item 14)."""

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    def reader():
        for e in x:
            yield e
    return reader


def text_file(path):
    def reader():
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")
    return reader


def recordio(paths, buf_size=100, n_threads=2):
    raise NotImplementedError(
        "reader.creator.recordio needs the native recordio scanner, which "
        "is not ported yet (ROADMAP queue 1 item 14)")
