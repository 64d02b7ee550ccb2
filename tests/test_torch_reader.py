"""The port's reader tier (paddle_tpu_torch.reader, ``paddle_tpu_torch.
batch``, ``fluid.DataFeeder``) against paddle_tpu's, and its input
pipeline (``fluid.reader``: FeedRing, DataLoader, PyReader) on the CPU.

- The decorators, ``batch`` and ``DataFeeder`` give the same samples as
  paddle_tpu's on the same seeded sources (``shuffle`` under the same
  ``random`` seed; ``multiprocess_reader`` interleaves, so as a multiset).
- ``FLAGS_feed_ring_depth=2`` (the ring) and 0 (the synchronous
  lookahead) give bit-equal feeds and bit-equal training.
- Closing a ring in mid-stream joins its producer; a producer error names
  its batch index; a non-iterable loader raises ``EOFException`` at the
  end of a pass; ``reset`` leaves no producer thread; a program-bound
  windowed loader runs through a plain ``run()``; ``py_reader`` and
  ``read_file`` bind a loader to the program; ``set_sample_generator``
  batches as paddle_tpu's loader does.
"""

import random
import threading
import time

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu import reader as jreader

import paddle_tpu_torch
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import reader
from paddle_tpu_torch.fluid import flags
from paddle_tpu_torch.fluid.core import EOFException
from paddle_tpu_torch.fluid.reader import (DataLoaderWorkerError,
                                           FeedRing, FeedRingError)


def _samples(n=23, seed=0):
    rng = np.random.RandomState(seed)

    def r():
        for i in range(n):
            yield (rng.randn(3).astype(np.float32), i)
    return r


def _collect(pkg_reader, batch_fn, seed):
    """Every decorator of one package over the same sources."""
    src = _samples()
    cached = list(_samples()())
    np_src = pkg_reader.creator.np_array(cached)
    out = {}
    random.seed(seed)
    out["shuffle"] = list(pkg_reader.shuffle(np_src, 5)())
    out["chain"] = list(pkg_reader.chain(np_src, np_src)())
    out["compose"] = list(pkg_reader.compose(np_src, np_src)())
    out["map"] = list(pkg_reader.map_readers(
        lambda a, b: (a[0] + b[0], a[1] * b[1]), np_src, np_src)())
    out["buffered"] = list(pkg_reader.buffered(np_src, 4)())
    out["firstn"] = list(pkg_reader.firstn(np_src, 7)())
    out["xmap"] = list(pkg_reader.xmap_readers(
        lambda s: (s[0] * 2, s[1]), np_src, 3, 4, order=True)())
    c = pkg_reader.cache(src)
    out["cache"] = list(c()) + list(c())
    out["multiprocess"] = sorted(
        (s[1] for s in pkg_reader.multiprocess_reader(
            [np_src, np_src])()))
    out["batch"] = list(batch_fn(np_src, 4, drop_last=False)())
    out["batch_drop"] = list(batch_fn(np_src, 4, drop_last=True)())
    return out


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for e in x for y in _flat(e)]
    return [np.asarray(x)]


def test_decorators_and_batch_give_the_samples_of_paddle_tpu():
    got = _collect(reader, paddle_tpu_torch.batch, seed=11)
    want = _collect(jreader, paddle_tpu.batch, seed=11)
    assert got.keys() == want.keys()
    for k in got:
        assert len(got[k]) == len(want[k]), k
        for a, b in zip(_flat(got[k]), _flat(want[k])):
            np.testing.assert_array_equal(a, b, err_msg=k)
    with pytest.raises(reader.decorator.ComposeNotAligned):
        list(reader.compose(reader.creator.np_array([1, 2]),
                            reader.creator.np_array([1]))())
    with pytest.raises(NotImplementedError, match="item 14"):
        reader.creator.recordio(["x.recordio"])


def _mlp(pkg, seed=3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=8, act="relu")
        logits = pkg.layers.fc(h, size=3)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _batches(n=6, batch=5, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 6).astype(np.float32),
             rng.randint(0, 3, (batch, 1)).astype(np.int64))
            for _ in range(n)]


def test_data_feeder_matches_paddle_tpu():
    main, _, _ = _mlp(fluid)
    jmain, _, _ = _mlp(jfluid)
    samples = [(np.arange(6, dtype=np.float32) + i, [i % 3])
               for i in range(4)]
    got = fluid.DataFeeder([main.global_block().var("x"),
                            main.global_block().var("y")]).feed(samples)
    want = jfluid.DataFeeder([jmain.global_block().var("x"),
                              jmain.global_block().var("y")]).feed(samples)
    for n in ("x", "y"):
        np.testing.assert_array_equal(got[n], want[n])


def _with_depth(depth):
    prev = flags.get_flag("feed_ring_depth")
    flags.set_flag("feed_ring_depth", depth)
    return prev


def _train_through_loader(depth, steps_per_run=None):
    """Losses and parameters of a pass over _batches() pulled by a
    program-bound loader at ring depth ``depth``."""
    prev = _with_depth(depth)
    try:
        main, startup, loss = _mlp(fluid)
        with fluid.program_guard(main, startup):
            loader = fluid.io.DataLoader.from_generator(
                feed_list=[main.global_block().var("x"),
                           main.global_block().var("y")],
                capacity=2, iterable=False, steps_per_run=steps_per_run)
        loader.set_batch_generator(_batches)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        loader.start()
        losses = []
        while True:
            try:
                out = exe.run(main, fetch_list=[loss], scope=scope,
                              return_numpy=False)
            except EOFException:
                break
            losses.append(out[0].numpy().ravel())
        params = {p.name: scope.find_var_numpy(p.name)
                  for p in main.global_block().all_parameters()}
        return np.concatenate(losses), params, scope.step_counter
    finally:
        flags.set_flag("feed_ring_depth", prev)


def test_ring_is_bit_equal_to_depth_0_and_loader_ends_with_eof():
    l2, p2, n2 = _train_through_loader(2)
    l0, p0, n0 = _train_through_loader(0)
    assert len(l2) == 6 and n2 == n0 == 7
    np.testing.assert_array_equal(l2, l0)
    for n in p2:
        np.testing.assert_array_equal(p2[n], p0[n], err_msg=n)


def test_windowed_program_bound_loader_runs_through_plain_run():
    """steps_per_run=4 over 6 batches: a window of 4 and a trailing
    window of 2, pulled by exe.run() with no feed; the same numbers as
    the per-step loader."""
    lw, pw, nw = _train_through_loader(2, steps_per_run=4)
    l1, p1, n1 = _train_through_loader(2)
    assert nw == n1
    np.testing.assert_array_equal(lw, l1)
    for n in pw:
        np.testing.assert_array_equal(pw[n], p1[n], err_msg=n)


def _ring_threads():
    return [t for t in threading.enumerate()
            if t.name == "feed-ring-producer" and t.is_alive()]


def test_iterable_ring_feeds_equal_depth_0():
    main, _, _ = _mlp(fluid)
    feeds = {}
    for depth in (2, 0):
        prev = _with_depth(depth)
        try:
            loader = fluid.io.DataLoader.from_generator(
                feed_list=[main.global_block().var("x"),
                           main.global_block().var("y")],
                capacity=2, steps_per_run=2)
            loader.set_batch_generator(_batches, places=fluid.CPUPlace())
            feeds[depth] = [{k: v.numpy().copy() for k, v in d.items()}
                            for d in loader()]
        finally:
            flags.set_flag("feed_ring_depth", prev)
    assert len(feeds[2]) == len(feeds[0]) == 3
    for a, b in zip(feeds[2], feeds[0]):
        for k in a:
            assert a[k].shape[0] == 2
            np.testing.assert_array_equal(a[k], b[k])


def test_closing_in_mid_stream_joins_the_producer():
    def endless():
        i = 0
        while True:
            yield {"x": np.full((2, 2), i, np.float32)}
            i += 1
    ring = FeedRing(lambda d: d, endless(), depth=2)
    got = [next(ring)["x"][0, 0] for _ in range(3)]
    assert got == [0, 1, 2]
    assert _ring_threads()
    ring.close()
    assert not _ring_threads()
    with pytest.raises(StopIteration):
        next(ring)


def _failing(at):
    def gen():
        for i, b in enumerate(_batches()):
            if i == at:
                raise IOError("shard %d is corrupt" % i)
            yield b
    return gen


def test_a_producer_error_names_its_batch_index():
    ring = FeedRing(lambda d: d, (dict(x=b[0]) for b in _failing(3)()),
                    depth=2)
    with pytest.raises(IOError, match="shard 3") as e:
        for _ in ring:
            pass
    assert isinstance(e.value.__cause__, FeedRingError)
    assert e.value.__cause__.batch_index == 3
    main, startup, loss = _mlp(fluid)
    with fluid.program_guard(main, startup):
        loader = fluid.io.DataLoader.from_generator(
            feed_list=[main.global_block().var("x"),
                       main.global_block().var("y")], iterable=False)
    loader.set_batch_generator(_failing(3))
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    loader.start()
    for _ in range(3):
        exe.run(main, fetch_list=[loss], scope=scope)
    with pytest.raises(DataLoaderWorkerError, match="around batch 3"):
        exe.run(main, fetch_list=[loss], scope=scope)


def test_reset_leaves_no_ring_threads():
    main, startup, loss = _mlp(fluid)
    with fluid.program_guard(main, startup):
        loader = fluid.io.PyReader(
            feed_list=[main.global_block().var("x"),
                       main.global_block().var("y")], iterable=False)

    def slow():
        for b in _batches():
            time.sleep(0.01)
            yield b
    loader.decorate_batch_generator(slow)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(2):          # a restart must not leak the first ring
        loader.start()
        exe.run(main, fetch_list=[loss], scope=scope)
        assert _ring_threads()
        loader.reset()
        assert not _ring_threads()


def test_py_reader_and_read_file_bind_to_the_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        r = fluid.layers.py_reader(capacity=4, shapes=[[-1, 6], [-1, 1]],
                                   dtypes=["float32", "int64"])
        x, y = fluid.layers.read_file(r)
        h = fluid.layers.fc(x, size=3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(h, y))
    r.decorate_batch_generator(_batches)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    r.start()
    n = 0
    with pytest.raises(EOFException):
        while True:
            exe.run(main, fetch_list=[loss], scope=scope)
            n += 1
    assert n == 6


def _sample_loader(pkg, main, return_list):
    loader = pkg.DataLoader.from_generator(
        feed_list=[main.global_block().var("x"),
                   main.global_block().var("y")],
        capacity=4, return_list=return_list)

    def samples():
        rng = np.random.RandomState(9)
        for i in range(11):
            yield rng.randn(6).astype(np.float32), [i % 3]
    loader.set_sample_generator(samples, batch_size=4, drop_last=False,
                                places=pkg.CPUPlace())
    return loader


@pytest.mark.parametrize("return_list", [False, True])
def test_sample_generator_loader_gives_the_batches_of_paddle_tpu(
        return_list):
    """set_sample_generator (DataFeeder batching, a short last batch kept)
    through the iterable loader of each package."""
    main, _, _ = _mlp(fluid)
    jmain, _, _ = _mlp(jfluid)
    got = list(_sample_loader(fluid, main, return_list)())
    want = list(_sample_loader(jfluid, jmain, return_list)())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        if not return_list:
            assert g.keys() == w.keys()
            g, w = [g[k] for k in ("x", "y")], [w[k] for k in ("x", "y")]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
