"""Checkpoint / model save-load (reference: python/paddle/fluid/io.py;
counterpart ``paddle_tpu/fluid/io.py``, whose files these are).

Reference semantics: ``save_persistables`` builds a program of ``save`` ops
executed by the Executor (io.py:475); inference export prunes the program to
the feed→fetch slice and serializes ProgramDesc + params (io.py:921).  Here
variables are torch tensors in the Scope, saved as one ``.npy`` per var
(bfloat16 as its bits, ``data_types.to_host``), and an inference model is
the reference's ``__model__`` ProgramDesc plus LoDTensor parameter files
(``proto_compat.py``), so exports of either package load in the other.

Loads put tensors on the executor's device (``executor=None``: the device
of the variable the scope already holds, else ``CUDAPlace(0)``).  A
32-bit value of a declared 64-bit variable (how ``paddle_tpu`` holds
int64 and float64) is widened to the declared dtype.

Crash safety: every saver stages its files and commits through
``checkpoint.atomic_dir`` (tmp-dir + rename / per-file replace), and every
loader is strict by default — see checkpoint.py.
"""

import json
import os
import pickle

import numpy as np
import torch

from . import framework
from .data_types import from_host, to_numpy, widens
from .framework import (Program, Block, Operator, Variable, Parameter,
                        default_main_program)
from .executor import CUDAPlace, device_for_place, global_scope
# fluid.io.DataLoader / PyReader (reference fluid/io.py re-exports them)
from .reader import DataLoader, PyReader  # noqa: F401

# program serialization format versions this package loads (the
# reference's framework/version.h IsProgramVersionSupported)
SUPPORTED_PROGRAM_VERSIONS = (1,)


def _is_persistable(var):
    # feed/fetch holders and readers are persistable in the desc but carry
    # no tensor value (reference io.py is_persistable type exclusions)
    return (var.persistable and not var.is_data
            and getattr(var, "type", None) not in
            ("feed_minibatch", "fetch_list", "reader", "raw"))


def _set_loaded(scope, executor, var, arr):
    """Put a loaded host array into ``scope`` as ``var``'s tensor: on the
    executor's device, widened where the JAX package narrowed (int64 held as
    int32, float64 as float32), else in the array's own dtype."""
    held = scope.find_var(var.name)
    if executor is not None:
        device = executor.device
    elif isinstance(held, torch.Tensor):
        device = held.device
    else:
        device = device_for_place(CUDAPlace(0))
    want = var.dtype if widens(var.dtype, arr.dtype) else None
    scope.set_var(var.name, from_host(arr, device, want))


def _read_ref_lod_tensor(dirname, var_name):
    """Resolve + read a reference-layout parameter file (one raw
    LoDTensor stream named by the var, lod_tensor.cc:222); None when no
    file exists."""
    from . import proto_compat
    for candidate in (var_name, var_name.replace("/", "__")):
        path = os.path.join(dirname, candidate)
        if os.path.isfile(path):
            with open(path, "rb") as f:
                arr, _ = proto_compat.read_lod_tensor(f)
            return arr
    return None


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Crash-safe: all files are staged in a ``<dirname>.tmp-*`` dir and
    committed through ``checkpoint.atomic_dir`` (whole-dir rename for a
    fresh target, per-file atomic replace into an existing one), so a
    kill mid-save never leaves a partially-written model dir."""
    import io as _io
    from .checkpoint import atomic_dir, write_array, write_file

    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    # one host snapshot of every var (bfloat16 as its bits)
    snap = global_scope().snapshot([var.name for var in vars])
    if filename is not None:
        blob = {var.name: snap[var.name] for var in vars
                if var.name in snap}
        fname = filename if filename.endswith(".npz") else filename + ".npz"
        buf = _io.BytesIO()
        np.savez(buf, **blob)
        with atomic_dir(dirname) as tmp:
            write_file(os.path.join(tmp, fname), buf.getvalue(),
                       "combine:" + fname)
        return
    with atomic_dir(dirname) as tmp:
        for var in vars:
            val = snap.get(var.name)
            if val is None:
                continue
            write_array(
                os.path.join(tmp, var.name.replace("/", "__") + ".npy"),
                val, point="tensor:" + var.name)


def save_params(executor, dirname, main_program=None, filename=None):
    main_program = main_program or default_main_program()
    save_vars(executor, dirname, main_program,
              vars=[v for v in main_program.list_vars()
                    if isinstance(v, Parameter)],
              filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program,
              predicate=_is_persistable, filename=filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, strict=True):
    """Strict by default: a requested var with no ``.npy``, no npz entry,
    and no reference LoDTensor file raises a ``RuntimeError`` naming the
    variable and directory — a truncated checkpoint must never resume
    silently from garbage (``strict=False`` skips missing vars)."""
    main_program = main_program or default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = global_scope()
    if filename is not None:
        path = os.path.join(dirname, filename)
        if not filename.endswith(".npz"):
            path += ".npz"            # np.savez appended it on save
        blob = np.load(path)
        missing = [var.name for var in vars if var.name not in blob]
        if strict and missing:
            # raised BEFORE any set_var: a strict failure must not leave
            # the scope half-loaded
            raise RuntimeError(
                "load_vars: no saved value for variable(s) %s in %r — "
                "the checkpoint is incomplete/torn for this program "
                "(pass strict=False to skip missing vars)"
                % (missing, path))
        for var in vars:
            if var.name in blob:
                _set_loaded(scope, executor, var, blob[var.name])
        return
    staged = []
    for var in vars:
        path = os.path.join(dirname, var.name.replace("/", "__") + ".npy")
        if os.path.exists(path):
            staged.append((var, np.load(path)))
            continue
        arr = _read_ref_lod_tensor(dirname, var.name)
        if arr is not None:
            staged.append((var, arr))
            continue
        if strict:
            # before any set_var, so the scope stays untouched
            raise RuntimeError(
                "load_vars: no saved value for variable %r in %r (no "
                "'%s.npy', no npz entry, no reference LoDTensor file) — "
                "the checkpoint is incomplete/torn for this program "
                "(pass strict=False to skip missing vars)"
                % (var.name, dirname, var.name.replace("/", "__")))
    for var, arr in staged:
        _set_loaded(scope, executor, var, arr)


def load_params(executor, dirname, main_program=None, filename=None,
                strict=True):
    main_program = main_program or default_main_program()
    load_vars(executor, dirname, main_program,
              vars=[v for v in main_program.list_vars()
                    if isinstance(v, Parameter)],
              filename=filename, strict=strict)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      strict=True):
    load_vars(executor, dirname, main_program,
              predicate=_is_persistable, filename=filename, strict=strict)


# ---------------------------------------------------------------------------
# Program serialization (ProgramDesc analogue, framework.proto)
# ---------------------------------------------------------------------------

def program_to_dict(program):
    blocks = []
    for b in program.blocks:
        vars_ = []
        for v in b.vars.values():
            vars_.append({
                "name": v.name, "shape": list(v.shape) if v.shape else None,
                "dtype": v.dtype, "persistable": v.persistable,
                "stop_gradient": v.stop_gradient, "is_data": v.is_data,
                "is_parameter": isinstance(v, Parameter),
                # startup-program mirrors of parameters (layer_helper
                # marking) — kept distinct from is_parameter so the
                # round-trip does not promote them to Parameter instances
                "param_backed": bool(getattr(v, "_param_backed", False)),
                "trainable": getattr(v, "trainable", None),
            })
        ops = []
        for op in b.ops:
            attrs = {}
            for k, val in op.attrs.items():
                if isinstance(val, np.ndarray):
                    attrs[k] = {"__ndarray__": val.tolist(),
                                "dtype": str(val.dtype)}
                else:
                    attrs[k] = val
            ops.append({"type": op.type, "inputs": op.inputs,
                        "outputs": op.outputs, "attrs": attrs})
        blocks.append({"idx": b.idx, "parent_idx": b.parent_idx,
                       "vars": vars_, "ops": ops})
    return {"blocks": blocks, "random_seed": program.random_seed,
            "version": 1}


def dict_to_program(d):
    v = d.get("version", 1)
    if v not in SUPPORTED_PROGRAM_VERSIONS:
        raise RuntimeError(
            "Program was saved with format version %r, which this build "
            "cannot load (supported: %s) — matching the reference's "
            "IsProgramVersionSupported check (framework/version.h)"
            % (v, SUPPORTED_PROGRAM_VERSIONS))
    program = Program()
    program.random_seed = d.get("random_seed", 0)
    program.blocks = []
    for bd in d["blocks"]:
        b = Block(program, bd["idx"], bd["parent_idx"])
        program.blocks.append(b)
        for vd in bd["vars"]:
            if vd.get("is_parameter"):
                v = Parameter(b, shape=vd["shape"], dtype=vd["dtype"],
                              name=vd["name"],
                              trainable=bool(vd.get("trainable", True)))
            else:
                v = Variable(b, name=vd["name"], shape=vd["shape"],
                             dtype=vd["dtype"],
                             persistable=vd["persistable"],
                             stop_gradient=vd["stop_gradient"],
                             is_data=vd["is_data"])
                if vd.get("param_backed"):
                    v.is_parameter = True
            b.vars[v.name] = v
        for od in bd["ops"]:
            attrs = {}
            for k, val in od["attrs"].items():
                if isinstance(val, dict) and "__ndarray__" in val:
                    attrs[k] = np.asarray(val["__ndarray__"],
                                          dtype=val["dtype"])
                else:
                    attrs[k] = val
            op = Operator(b, od["type"], attrs=attrs)
            op.inputs = {k: list(v) for k, v in od["inputs"].items()}
            op.outputs = {k: list(v) for k, v in od["outputs"].items()}
            b.ops.append(op)
    program._bump_version()
    return program


# order manifest written beside the exported model; see
# save_inference_model (positional streams need an explicit order
# record, not a shape-based heuristic).  It also records the FEED/FETCH
# order: positional consumers (the
# predictor's run([arrays]), ServingExecutor.submit([arrays])) follow
# this saved order, never a dict-iteration reconstruction — feed ops
# missing their ``col`` attrs (hand-built or foreign descs) would
# otherwise key by op-encounter order and could silently permute
# same-shaped inputs.
_ORDER_MANIFEST = "__params_order__"


def prune_program(program, feed_names, fetch_names):
    """Dead-op elimination for inference extraction (framework/prune.cc).

    Backward/optimize ops are dropped by role first (as the reference's
    prune does): an sgd op *writes* a weight the forward *reads*, so the
    reverse reachability walk alone would wrongly keep the whole training
    tail alive."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    train_roles = framework.OpRole.Backward | framework.OpRole.Optimize
    fwd_ops = [op for op in block.ops
               if not (op.attr(framework.OP_ROLE_KEY, 0) & train_roles)]
    needed = set(fetch_names)
    keep = []
    for op in reversed(fwd_ops):
        if any(n in needed for n in op.output_arg_names()):
            keep.append(op)
            needed.update(n for n in op.input_arg_names())
    block.ops = list(reversed(keep))
    pruned._bump_version()
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    """io.py:921 contract: prune to the inference slice, serialize program +
    persistable params.

    The model is written in the reference's binary format — a ProgramDesc
    protobuf ``__model__`` with prepended feed / appended fetch ops, and
    parameters as LoDTensor streams (one file per param named by the var,
    or a single save_combine-layout file when ``params_filename`` is
    given) — so models exported here load in the reference and vice versa
    (proto_compat.py).
    """
    from . import proto_compat

    main_program = main_program or default_main_program()
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in target_vars]
    import io as _io
    from .checkpoint import atomic_dir, write_file

    pruned = prune_program(main_program, feeded_var_names, fetch_names)
    prepend_feed_ops(pruned, list(feeded_var_names))
    append_fetch_ops(pruned, fetch_names)
    model_filename = model_filename or "__model__"

    # every persistable var of the exported desc must carry a value: the
    # combined stream is positional (no names), so the saver and any
    # loader must agree on exactly the _is_persistable set AND its order.
    # The reference iterates sorted(save_var_map.keys()) (reference
    # io.py:230,652), so the combined stream is in sorted-name order.
    # Gathered BEFORE any file is staged so a missing value aborts with
    # the directory untouched.
    persistable = [v for v in sorted(pruned.list_vars(),
                                     key=lambda v: v.name)
                   if _is_persistable(v)]
    snap = global_scope().snapshot([v.name for v in persistable])
    params = []
    for v in persistable:
        val = snap.get(v.name)
        if val is None:
            raise RuntimeError(
                "persistable variable %r has no value in the scope — run "
                "the startup program (and any initialization) before "
                "save_inference_model" % v.name)
        params.append((v, val))
    if params_filename == _ORDER_MANIFEST:
        raise ValueError(
            "params_filename %r collides with the order-manifest "
            "file written beside it — pick another name"
            % params_filename)

    # explicit order manifest: every positional stream of
    # the export gets an explicit order record.  "order" covers the
    # combined params stream (several same-shaped tensors — stacked
    # layers, q/k/v/o projections — would otherwise load silently
    # permuted; shape checks can't catch that); "feed_order"/
    # "fetch_order" are the positional FEED contract — loaders hand them
    # to positional consumers (predictor run([arrays]),
    # ServingExecutor.submit([arrays])) instead of reconstructing order
    # from feed-op col attrs, which hand-built/foreign descs may lack.
    # The reference loader ignores extra files, so interop is unaffected.
    order = {"version": 2, "params_file": params_filename,
             "feed_order": [v.name if isinstance(v, Variable) else v
                            for v in feeded_var_names],
             "fetch_order": list(fetch_names)}
    if params_filename is not None:
        order["order"] = [v.name for v, _ in params]

    # stage the whole export (program + params + order manifest) and
    # commit in one shot (checkpoint.atomic_dir): a kill mid-export can
    # never leave a model dir whose __model__ disagrees with its params
    with atomic_dir(dirname) as tmp:
        write_file(os.path.join(tmp, model_filename),
                   proto_compat.serialize_program(pruned),
                   "model:" + model_filename)
        write_file(os.path.join(tmp, _ORDER_MANIFEST),
                   json.dumps(order).encode(),
                   "combine:" + _ORDER_MANIFEST)
        if params_filename is not None:
            buf = _io.BytesIO()
            proto_compat.write_combined(buf, [val for _, val in params])
            write_file(os.path.join(tmp, params_filename), buf.getvalue(),
                       "combine:" + params_filename)
        else:
            for v, val in params:
                buf = _io.BytesIO()
                proto_compat.write_lod_tensor(buf, val)
                write_file(os.path.join(tmp, v.name.replace("/", "__")),
                           buf.getvalue(), "tensor:" + v.name)
    return fetch_names


def _strip_feed_fetch(program):
    """Extract feed/fetch names from the structural ops (reference
    load_inference_model reads them the same way) and remove the ops +
    holder vars, returning (feed_names, fetch_names)."""
    block = program.global_block()
    feed, fetch = {}, {}
    kept = []
    for op in block.ops:
        if op.type == "feed":
            feed[op.attrs.get("col", len(feed))] = op.outputs["Out"][0]
        elif op.type == "fetch":
            fetch[op.attrs.get("col", len(fetch))] = op.inputs["X"][0]
        else:
            kept.append(op)
    block.ops = kept
    for holder in ("feed", "fetch"):
        block.vars.pop(holder, None)
    program._bump_version()
    return ([feed[k] for k in sorted(feed)],
            [fetch[k] for k in sorted(fetch)])


def _manifest_order(manifest, key, names, dirname):
    """Reorder ``names`` to the saved manifest's ``key`` record (the
    positional feed/fetch contract).  Absent manifest/key (reference
    exports, pre-serving manifests) keeps the program-derived order; a
    manifest naming a DIFFERENT set fails loudly — the model dir mixes
    artifacts from different exports."""
    if manifest is None:
        return names
    saved = manifest.get(key)
    if not saved:
        return names
    saved = [str(n) for n in saved]
    if sorted(saved) != sorted(names):
        raise ValueError(
            "order manifest in %r disagrees with the program's %s: "
            "manifest %s vs program %s — the model dir mixes artifacts "
            "from different exports" % (dirname, key, saved, names))
    return saved


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Loads models written by this repo (protobuf, or the older pickle
    format) AND models exported by the reference (``__model__``
    ProgramDesc + LoDTensor param files)."""
    from . import proto_compat

    model_filename = model_filename or "__model__"
    with open(os.path.join(dirname, model_filename), "rb") as f:
        raw = f.read()
    manifest = None
    manifest_path = os.path.join(dirname, _ORDER_MANIFEST)
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
        if params_filename is None and manifest.get("params_file"):
            # the manifest knows how its own export stored params —
            # callers no longer have to guess the combined filename
            # (loading such a dir without it used to FileNotFoundError)
            params_filename = manifest["params_file"]
    if proto_compat.looks_like_program_desc(raw):
        program = proto_compat.parse_program(raw)
        feed_names, fetch_names = _strip_feed_fetch(program)
        # the saved manifest's feed/fetch order is authoritative for
        # positional consumers (predictor run([arrays]), serving):
        # feed-op col attrs reconstruct it for our own exports, but
        # hand-built/foreign descs may lack cols, and op-encounter
        # order is a dict-iteration accident there
        feed_names = _manifest_order(manifest, "feed_order", feed_names,
                                     dirname)
        fetch_names = _manifest_order(manifest, "fetch_order",
                                      fetch_names, dirname)
        scope = global_scope()
        # sorted-name order to match the reference's combined-stream
        # contract (reference io.py:230,652) — program order differs
        persistable = sorted(
            (v for v in program.list_vars() if _is_persistable(v)),
            key=lambda v: v.name)
        if params_filename is not None:
            # prefer the explicit order manifest (written by this repo's
            # exporter) — it is authoritative even when several
            # persistables share a shape, which the legacy shape guard
            # below cannot disambiguate
            order = None
            if manifest is not None and "order" in manifest:
                if manifest.get("params_file") in (None, params_filename):
                    order = list(manifest.get("order") or [])
                    have = {v.name for v in persistable}
                    if len(order) != len(persistable) or \
                            set(order) != have:
                        raise ValueError(
                            "params order manifest does not match the "
                            "program's persistable set (%d names in "
                            "manifest vs %d persistables): manifest-only "
                            "%s, program-only %s — the model dir mixes "
                            "artifacts from different exports"
                            % (len(order), len(persistable),
                               sorted(set(order) - have),
                               sorted(have - set(order))))
            with open(os.path.join(dirname, params_filename), "rb") as f:
                arrs = proto_compat.read_combined(f, len(persistable))
            if order is not None:
                byname = {v.name: v for v in persistable}
                stream_vars = [byname[n] for n in order]
            else:
                stream_vars = persistable
            for v, a in zip(stream_vars, arrs):
                # positional stream with no manifest: a shape mismatch
                # means the saver used a different var order (e.g. a
                # older export in program order) — mis-assigning
                # silently would swap same-shaped params, so fail loudly
                vshape = tuple(-1 if d is None else int(d)
                               for d in (v.shape or ()))
                if vshape and -1 not in vshape and \
                        tuple(a.shape) != vshape:
                    if order is not None:
                        raise ValueError(
                            "combined params stream disagrees with the "
                            "order manifest at %r: stream has shape %s, "
                            "program expects %s — the stream and "
                            "__params_order__ come from different "
                            "exports" % (v.name, tuple(a.shape), vshape))
                    raise ValueError(
                        "combined params stream order mismatch at %r: "
                        "stream has shape %s, program expects %s — the "
                        "file was likely saved with an older (program-"
                        "order) exporter; re-export it" %
                        (v.name, tuple(a.shape), vshape))
                _set_loaded(scope, executor, v, a)
        else:
            for v in persistable:
                arr = _read_ref_lod_tensor(dirname, v.name)
                if arr is None:
                    raise FileNotFoundError(
                        "no parameter file for persistable variable %r in "
                        "%r — if the model was exported with a combined "
                        "params file, pass params_filename" % (v.name,
                                                               dirname))
                _set_loaded(scope, executor, v, arr)
    else:
        meta = pickle.loads(raw)
        program = dict_to_program(meta["program"])
        feed_names = meta["feed_names"]
        fetch_names = meta["fetch_names"]
        load_persistables(executor, dirname, program)
    block = program.global_block()
    fetch_vars = [block.var(n) for n in fetch_names]
    return program, feed_names, fetch_vars


def is_parameter(var):
    """True iff the variable is a Parameter (reference io.py:73)."""
    return isinstance(var, Parameter)


def is_persistable(var):
    return bool(getattr(var, "persistable", False))


def get_parameter_value(para, executor):
    """Fetch a parameter's current value (reference io.py:181)."""
    if not is_parameter(para):
        raise TypeError(
            "para should be a Parameter, got %r" % type(para).__name__)
    return get_parameter_value_by_name(para.name, executor)


def get_parameter_value_by_name(name, executor, program=None):
    """The value as a numpy array (bfloat16 widened to float32, as a
    fetch returns it)."""
    v = global_scope().find_var(name)
    if v is None:
        raise ValueError(
            "parameter %r is not initialized in the scope — run the "
            "startup program first" % name)
    return to_numpy(v)


def prepend_feed_ops(inference_program, feed_target_names,
                     feed_holder_name="feed"):
    """Prepend feed ops binding feed slots (reference io.py:1053).  The
    executor feeds by name, so the ops are structural markers — but they
    carry the reference's full holder-var wiring (X=['feed'], col attr)
    so the serialized ProgramDesc loads in the reference."""
    block = inference_program.global_block()
    if feed_holder_name not in block.vars:
        block.create_var(name=feed_holder_name, persistable=True,
                         type="feed_minibatch")
    for i, name in enumerate(feed_target_names):
        block._insert_op(i, "feed", inputs={"X": [feed_holder_name]},
                         outputs={"Out": [name]}, attrs={"col": i})
    return inference_program


def append_fetch_ops(inference_program, fetch_target_names,
                     fetch_holder_name="fetch"):
    block = inference_program.global_block()
    if fetch_holder_name not in block.vars:
        block.create_var(name=fetch_holder_name, persistable=True,
                         type="fetch_list")
    for i, name in enumerate(fetch_target_names):
        block.append_op("fetch", inputs={"X": [name]},
                        outputs={"Out": [fetch_holder_name]},
                        attrs={"col": i})
    return inference_program
