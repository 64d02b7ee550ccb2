"""Data-input layers (reference: python/paddle/fluid/layers/io.py;
counterpart ``paddle_tpu/fluid/layers/io.py``): ``data`` declares a feed
slot; ``py_reader``, ``create_py_reader_by_data``, ``double_buffer`` and
``read_file`` bind a host reader pipeline to the program, so
``exe.run(program)`` pulls batches from the port's ``GeneratorLoader``
(``fluid/reader.py``, which owns the queue and the device prefetch the
reference's double_buffer op provided) and raises
``core.EOFException`` at the pass end."""

from .. import unique_name
from ..framework import default_main_program, default_startup_program
from ..data_types import canonical_dtype


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block()
    var = block.create_var(name=name, shape=shape,
                           dtype=canonical_dtype(dtype),
                           stop_gradient=stop_gradient, is_data=True,
                           lod_level=lod_level)
    # mirror into startup program so program pairs share the declaration
    sb = default_startup_program().global_block()
    if not sb.has_var_local(name):
        sb.create_var(name=name, shape=shape, dtype=canonical_dtype(dtype),
                      stop_gradient=stop_gradient, is_data=True,
                      lod_level=lod_level)
    return var


class FileReader:
    """Host-side reader-pipeline handle (stands in for the reference's
    reader Variable).  ``_make`` yields per-sample tuples of ndarrays."""

    def __init__(self, make, shapes, dtypes, batched=False, batch_size=None,
                 use_double_buffer=False):
        self._make = make
        self.shapes = [list(s) for s in shapes]
        self.dtypes = list(dtypes)
        self._batched = batched
        self._batch_size = batch_size
        self._double_buffer = use_double_buffer
        self._loader = None

    # reference py_reader-style control surface
    def start(self):
        if self._loader is not None:
            self._loader.start()

    def reset(self):
        if self._loader is not None:
            self._loader.reset()


def double_buffer(reader, place=None, name=None):
    """create_double_buffer_reader equivalent: turns on the loader's
    background device prefetch."""
    return FileReader(reader._make, reader.shapes, reader.dtypes,
                      reader._batched, reader._batch_size,
                      use_double_buffer=True)


def read_file(reader):
    """Bind the pipeline to the current program and emit its data vars;
    exe.run then pulls batches (raises core.EOFException at pass end)."""
    from ..reader import GeneratorLoader

    if isinstance(reader, GeneratorLoader):      # py_reader handle
        return (reader._feed_list if len(reader._feed_list) > 1
                else reader._feed_list[0])
    feed_vars = []
    for s, dt in zip(reader.shapes, reader.dtypes):
        feed_vars.append(data(
            name=unique_name.generate("_read_file"), shape=list(s),
            dtype=dt, append_batch_size=False))
    loader = GeneratorLoader(feed_vars, capacity=8,
                             use_double_buffer=reader._double_buffer,
                             iterable=False)
    if reader._batched:
        loader.set_sample_generator(reader._make, reader._batch_size,
                                    drop_last=True)
    else:
        # unbatched stream: every sample is one feed (batch dim included)
        loader.set_sample_list_generator(
            lambda: ([sample] for sample in reader._make()))
    reader._loader = loader
    loader.start()
    return feed_vars if len(feed_vars) > 1 else feed_vars[0]


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """In-program python feed queue (reference layers/io.py py_reader):
    returns a PyReader handle; read_file(handle) yields its data vars."""
    from ..reader import PyReader

    feed_vars = []
    for s, dt in zip(shapes, dtypes):
        feed_vars.append(data(
            name=unique_name.generate(name or "_py_reader"),
            shape=[d for d in s if d != -1], dtype=dt))
    return PyReader(feed_list=feed_vars, capacity=capacity,
                    use_double_buffer=use_double_buffer, iterable=False)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    from ..reader import PyReader
    return PyReader(feed_list=list(feed_list), capacity=capacity,
                    use_double_buffer=use_double_buffer, iterable=False)
