"""The port's Dataset tier (``fluid.DatasetFactory``, MultiSlot text
files) and ``Executor.train_from_dataset`` / ``infer_from_dataset``
against paddle_tpu's, on the CPU.

Files: MultiSlot text written from a seed, one instance per line — the
tiny DeepFM's slots (8 sparse ids, 4 dense features, a label).

- Parsing the same files gives the same arrays as paddle_tpu
  (``FileInstantDataset``, batch by batch); ``QueueDataset`` with two
  reader threads streams every instance; ``InMemoryDataset`` shuffles to
  the same order as paddle_tpu under one seed; a dense slot with the
  wrong count raises; a ``.recordio`` shard raises naming ROADMAP item
  14; ``set_pipe_command("zcat")`` reads gzip'd shards; window stacking
  (``stack_feed_dicts``, ``stack_batch_windows``) gives the JAX windows.
- Tiny DeepFM (``deepfm.tiny_config()``, Adam 1e-3, batch 16),
  ``train_from_dataset(steps_per_run=2)`` over 8 batches from JAX's
  startup persistables: the losses the loop prints (the last inner step
  of each window) ``rtol 1e-4``, every persistable ``atol 1e-5``; the
  ring and depth 0 give the same bits; ``infer_from_dataset`` runs.
"""

import os
import re

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.models import deepfm as jdeepfm

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import flags
from paddle_tpu_torch.models import deepfm
from test_torch_common import _empty_jax_step_event_ring  # noqa: F401

BATCH, N_BATCHES = 16, 8


def write_multislot(path, cfg, n, seed):
    """``n`` MultiSlot lines: ``F`` sparse ids, ``dense_dim`` floats and
    one label per line."""
    rng = np.random.RandomState(seed)
    F, D = cfg.num_fields, cfg.dense_dim
    with open(path, "w") as f:
        for _ in range(n):
            ids = rng.randint(0, cfg.sparse_feature_dim, F)
            dense = rng.rand(D).astype(np.float32)
            label = rng.randint(0, 2)
            f.write("%d %s %d %s 1 %d\n" % (
                F, " ".join(map(str, ids)), D,
                " ".join("%.6g" % v for v in dense), label))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("multislot")
    cfg = deepfm.tiny_config()
    n = BATCH * N_BATCHES // 2
    return [write_multislot(d / ("part-%d.txt" % i), cfg, n, seed=i)
            for i in range(2)]


def build(pkg, mod, cfg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        out = mod.build_train(cfg, lr=1e-3)
    return main, startup, out


def dataset(pkg, main, files, kind="FileInstantDataset", thread=1):
    ds = pkg.DatasetFactory().create_dataset(kind)
    ds.set_batch_size(BATCH)
    ds.set_thread(thread)
    ds.set_filelist(files)
    blk = main.global_block()
    ds.set_use_var([blk.var("sparse_ids"), blk.var("dense_value"),
                    blk.var("label")])
    return ds


def test_parsing_gives_the_arrays_of_paddle_tpu(files):
    cfg = deepfm.tiny_config()
    pmain, _, _ = build(fluid, deepfm, cfg)
    jmain, _, _ = build(jfluid, jdeepfm, jdeepfm.tiny_config())
    got = list(dataset(fluid, pmain, files))
    want = list(dataset(jfluid, jmain, files))
    assert len(got) == len(want) == N_BATCHES
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k].astype(g[k].dtype))
    assert got[0]["sparse_ids"].shape == (BATCH, cfg.num_fields, 1)


def test_queue_dataset_streams_everything(files):
    main, _, _ = build(fluid, deepfm, deepfm.tiny_config())
    ds = dataset(fluid, main, files, "QueueDataset", thread=2)
    got = list(ds)
    assert sum(len(b["label"]) for b in got) == BATCH * N_BATCHES
    ref = list(dataset(fluid, main, files))

    def rows(batches):
        return sorted(tuple(r) for b in batches
                      for r in b["sparse_ids"].reshape(len(b["label"]), -1))
    assert rows(got) == rows(ref)
    with pytest.raises(RuntimeError, match="InMemoryDataset"):
        ds.local_shuffle()


def test_in_memory_shuffle_is_the_order_of_paddle_tpu(files):
    pmain, _, _ = build(fluid, deepfm, deepfm.tiny_config())
    jmain, _, _ = build(jfluid, jdeepfm, jdeepfm.tiny_config())
    order = []
    for pkg, main in ((fluid, pmain), (jfluid, jmain)):
        ds = dataset(pkg, main, files, "InMemoryDataset")
        ds.load_into_memory()
        ds.local_shuffle()
        ds.global_shuffle()         # one trainer: a second local shuffle
        order.append([b["sparse_ids"].ravel().tolist() for b in ds])
    assert order[0] == order[1]
    assert order[0] != [b["sparse_ids"].ravel().tolist()
                        for b in dataset(fluid, pmain, files)]


def test_wrong_dense_count_and_recordio_raise(tmp_path):
    cfg = deepfm.tiny_config()
    main, _, _ = build(fluid, deepfm, cfg)
    bad = tmp_path / "bad.txt"
    bad.write_text("%d %s 3 0.1 0.2 0.3 1 0\n" % (
        cfg.num_fields, " ".join(["1"] * cfg.num_fields)))
    with pytest.raises(ValueError, match="dense slot 'dense_value'"):
        list(dataset(fluid, main, [str(bad)]))
    with pytest.raises(NotImplementedError, match="item 14"):
        list(dataset(fluid, main, [str(tmp_path / "x.recordio")]))


def _printed_losses(text):
    """The per-window losses train_from_dataset printed (print_period=1)."""
    return [float(m) for m in re.findall(
        r"\[train_from_dataset\] batch \d+: \S+=\[\s*([-0-9.e+]+)", text)]


def test_train_from_dataset_matches_paddle_tpu(files, capsys):
    cfg = deepfm.tiny_config()
    jmain, jstartup, jout = build(jfluid, jdeepfm, jdeepfm.tiny_config())
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    names = sorted(v.name for v in jmain.list_vars() if v.persistable)
    init = {n: np.array(jscope.find_var(n)) for n in names}
    step0 = jscope.step_counter
    capsys.readouterr()
    jstat = jexe.train_from_dataset(
        jmain, dataset(jfluid, jmain, files), scope=jscope,
        fetch_list=[jout["loss"]], print_period=1, steps_per_run=2)
    jlosses = _printed_losses(capsys.readouterr().out)

    pmain, _, pout = build(fluid, deepfm, cfg)
    runs = {}
    for depth in (2, 0):
        prev = flags.get_flag("feed_ring_depth")
        flags.set_flag("feed_ring_depth", depth)
        try:
            pscope = fluid.Scope()
            fluid.load_numpy_params(pscope, init, fluid.CPUPlace())
            pscope.step_counter = step0
            pexe = fluid.Executor(fluid.CPUPlace())
            stat = pexe.train_from_dataset(
                pmain, dataset(fluid, pmain, files), scope=pscope,
                fetch_list=[pout["loss"]], print_period=1, steps_per_run=2)
            runs[depth] = (stat, _printed_losses(capsys.readouterr().out),
                           {n: pscope.find_var_numpy(n) for n in names})
        finally:
            flags.set_flag("feed_ring_depth", prev)
    stat, plosses, pstate = runs[2]
    assert stat == jstat == {"steps": N_BATCHES, "preempted": False,
                             "rollbacks": 0}
    assert len(plosses) == len(jlosses) == N_BATCHES // 2
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    for n in names:
        np.testing.assert_allclose(pstate[n], np.array(jscope.find_var(n)),
                                   atol=1e-5, err_msg=n)
        np.testing.assert_array_equal(pstate[n], runs[0][2][n], err_msg=n)
    assert runs[0][1] == plosses


def test_infer_from_dataset_runs(files):
    cfg = deepfm.tiny_config()
    main, startup, out = build(fluid, deepfm, cfg)
    infer = main.clone(for_test=True)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    before = scope.step_counter
    stat = exe.infer_from_dataset(infer, dataset(fluid, main, files),
                                  scope=scope, fetch_list=[out["predict"]],
                                  steps_per_run=4)
    assert stat == {"steps": N_BATCHES, "preempted": False, "rollbacks": 0}
    assert scope.step_counter == before + N_BATCHES


def test_pipe_command_reads_compressed_shards(files, tmp_path):
    import gzip
    import shutil
    gz = []
    for f in files:
        with open(f, "rb") as src, gzip.open(str(tmp_path / (
                os.path.basename(f) + ".gz")), "wb") as dst:
            shutil.copyfileobj(src, dst)
        gz.append(str(tmp_path / (os.path.basename(f) + ".gz")))
    main, _, _ = build(fluid, deepfm, deepfm.tiny_config())
    ds = dataset(fluid, main, gz)
    ds.set_pipe_command("zcat")
    got = list(ds)
    want = list(dataset(fluid, main, files))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


def test_window_stacking_matches_paddle_tpu():
    """stack_feed_dicts and stack_batch_windows (full, shape-change and
    trailing flushes) give the JAX package's windows; a staging buffer
    goes back to its pool only when no staged tensor shares it."""
    import torch
    from paddle_tpu.fluid import dataset as jds
    from paddle_tpu_torch.fluid import dataset as pds
    rng = np.random.RandomState(4)
    feeds = [{"a": rng.randn(3, 2).astype(np.float32),
              "b": rng.randint(0, 9, (3, 1))} for _ in range(5)]
    feeds += [{"a": rng.randn(2, 2).astype(np.float32),
               "b": rng.randint(0, 9, (2, 1))} for _ in range(3)]
    for k in ("a", "b"):
        np.testing.assert_array_equal(pds.stack_feed_dicts(feeds[:4])[k],
                                      jds.stack_feed_dicts(feeds[:4])[k])
    with pytest.raises(ValueError, match="cannot stack slot"):
        pds.stack_feed_dicts(feeds[3:6])
    got = list(pds.stack_batch_windows(iter(feeds), 2))
    want = list(jds.stack_batch_windows(iter(feeds), 2))
    assert [w["a"].shape for w in got] == [w["a"].shape for w in want] == \
        [(2, 3, 2), (2, 3, 2), (1, 3, 2), (2, 2, 2), (1, 2, 2)]
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    base = np.zeros((4, 4), np.float32)
    assert pds._staging_reusable(base, torch.from_numpy(base).clone())
    assert not pds._staging_reusable(base, torch.from_numpy(base))
    assert not pds._staging_reusable(base, base)
