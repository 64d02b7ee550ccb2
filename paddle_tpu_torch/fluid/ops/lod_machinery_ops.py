"""LoD bookkeeping machinery and the PS helper ops (counterpart
``paddle_tpu/fluid/ops/lod_machinery_ops.py``).

LoD machinery (reference ``operators/lod_rank_table_op.cc``,
``lod_tensor_to_array_op``, ``array_to_lod_tensor_op``,
``shrink_rnn_memory_op``, ``rnn_memory_helper_op``,
``reorder_lod_tensor_by_rank_op``, ``split_lod_tensor_op`` /
``merge_lod_tensor_op``), on the JAX package's static shapes: a LoD
rank table is a ``[B, 2]`` int32 tensor of (original index, length)
rows sorted by descending length, ties by index (the reference's
``LoDRankTable`` items); row counts never shrink, and the rows of a
finished sequence are zeros instead of being dropped, so
``merge(split(x)) == x`` exactly.  ``lod_tensor_to_array`` makes a
:class:`control_flow_ops.TensorArray` of T entries, entry t the step-t
rows in rank-table order.

PS helpers: ``split_ids`` / ``merge_ids`` / ``split_byref`` /
``split_selected_rows`` / ``lookup_sparse_table`` / ``ref_by_trainer_id``
/ ``prefetch``, on the JAX package's fixed-length layouts: ``split_ids``
emits one full-length slab per part with that part's ids compacted to
the front and -1 padding (the reference emits ragged SelectedRows), and
``merge_ids`` reads the same compacted order back.
"""

import numpy as np
import torch

from ..registry import register_op
from .control_flow_ops import TensorArray


# ---------------------------------------------------------------------------
# LoD rank-table machinery (JAX :27-137)
# ---------------------------------------------------------------------------

def _table(ctx, slot="RankTable"):
    return ctx.i(slot).to(torch.int64)


def _rows_mask(keep, x):
    """``keep`` ``[B]`` bool broadcast over x's trailing dims."""
    return keep.reshape((-1,) + (1,) * (x.dim() - 1))


@register_op("lod_rank_table", nondiff_inputs=("X", "Length"),
             stop_gradient=True)
def _lod_rank_table(ctx, op):
    """(index, length) rows sorted by length, longest first, ties by
    index (framework/lod_rank_table.h)."""
    x = ctx.i("X")
    ln = ctx.i_opt("Length")
    B = x.shape[0]
    if ln is None:
        ln = torch.full((B,), x.shape[1] if x.dim() > 1 else 1,
                        dtype=torch.int32, device=x.device)
    else:
        ln = ln.reshape(-1).to(torch.int32)
    order = torch.sort(-ln, stable=True).indices.to(torch.int32)
    ctx.set("Out", torch.stack([order, ln[order.long()]], dim=1))


@register_op("max_sequence_len", nondiff_inputs=("RankTable",),
             stop_gradient=True)
def _max_sequence_len(ctx, op):
    """The longest length (the table's first row), ``[1]`` int32 (JAX
    asks for int64, which JAX without x64 makes int32)."""
    ctx.set("Out", _table(ctx)[0, 1].to(torch.int32).reshape(1))


@register_op("lod_tensor_to_array", nondiff_inputs=("RankTable",))
def _lod_tensor_to_array(ctx, op):
    """x ``[B, T, ...]`` to a T-entry array: entry t holds every
    sequence's step-t row in rank-table order, zeros past a sequence's
    length."""
    x = ctx.i("X")
    table = _table(ctx)
    order, lns = table[:, 0], table[:, 1]
    B, T = x.shape[0], x.shape[1]
    xs = x[order]
    steps = torch.arange(T, device=x.device)[None, :] < lns[:, None]
    xs = torch.where(steps.reshape((B, T) + (1,) * (x.dim() - 2)), xs,
                     torch.zeros((), dtype=x.dtype, device=x.device))
    buf = torch.movedim(xs, 1, 0)
    ctx.set("Out", TensorArray(
        buf, torch.full((), T, dtype=torch.int32, device=x.device), T,
        x.device))


@register_op("array_to_lod_tensor", nondiff_inputs=("RankTable",))
def _array_to_lod_tensor(ctx, op):
    """Inverse of lod_tensor_to_array: ``[B, T, ...]`` in the original
    row order."""
    arr = ctx.i("X")
    order = _table(ctx)[:, 0]
    buf = arr.buffer if isinstance(arr, TensorArray) else arr
    x = torch.movedim(buf, 0, 1)
    ctx.set("Out", x[torch.argsort(order)])


@register_op("shrink_rnn_memory", nondiff_inputs=("I", "RankTable"))
def _shrink_rnn_memory(ctx, op):
    """Rows of X (rank-table order) whose sequence goes on past step I
    stay; the others become zeros (the reference drops them: the same
    active prefix, the table being sorted by length)."""
    x = ctx.i("X")
    i = ctx.i("I").reshape(()).to(torch.int64)
    alive = _table(ctx)[:, 1] > i
    ctx.set("Out", torch.where(_rows_mask(alive, x), x,
                               torch.zeros((), dtype=x.dtype,
                                           device=x.device)))


@register_op("rnn_memory_helper")
def _rnn_memory_helper(ctx, op):
    ctx.set("Out", ctx.i("X"))


@register_op("rnn_memory_helper_grad")
def _rnn_memory_helper_grad(ctx, op):
    """Out@GRAD passed through, zeros where there is none (JAX :114)."""
    g = ctx.i_opt("Out@GRAD")
    ctx.set("X@GRAD", torch.zeros_like(ctx.i("X")) if g is None else g)


@register_op("reorder_lod_tensor_by_rank", nondiff_inputs=("RankTable",))
def _reorder_lod_tensor_by_rank(ctx, op):
    ctx.set("Out", ctx.i("X")[_table(ctx)[:, 0]])


@register_op("split_lod_tensor", nondiff_inputs=("Mask",))
def _split_lod_tensor(ctx, op):
    """IfElse's split (split_lod_tensor_op.cc): the rows keep their
    place; OutTrue zeroes the rows the mask drops, OutFalse the rows it
    keeps."""
    x = ctx.i("X")
    m = _rows_mask(ctx.i("Mask").reshape(-1).to(torch.bool), x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ctx.set("OutTrue", torch.where(m, x, zero))
    ctx.set("OutFalse", torch.where(m, zero, x))


@register_op("merge_lod_tensor", nondiff_inputs=("Mask",))
def _merge_lod_tensor(ctx, op):
    x_true = ctx.i("InTrue")
    m = _rows_mask(ctx.i("Mask").reshape(-1).to(torch.bool), x_true)
    ctx.set("Out", torch.where(m, x_true, ctx.i("InFalse")))


# ---------------------------------------------------------------------------
# PS helper ops (JAX :140-269)
# ---------------------------------------------------------------------------


@register_op("split_ids", stop_gradient=True)
def _split_ids(ctx, op):
    """operators/distributed_ops/split_ids_op: partition ids by
    ``id % n_parts``."""
    ids = ctx.i("Ids").reshape(-1).to(torch.int32)
    n_parts = len(op.output("Out"))
    N = ids.shape[0]
    for p in range(n_parts):
        m = torch.remainder(ids, n_parts) == p
        slot = torch.cumsum(m.to(torch.int64), 0) - 1
        out = torch.full((N + 1,), -1, dtype=torch.int32, device=ids.device)
        # ids outside the part land on the extra slot N, then dropped
        out[torch.where(m, slot, torch.full_like(slot, N))] = ids
        ctx.set("Out", out[:N], idx=p)


@register_op("merge_ids", stop_gradient=True)
def _merge_ids(ctx, op):
    """operators/distributed_ops/merge_ids_op: reassemble per-part rows
    (aligned with split_ids' compacted order) back into Ids order."""
    ids = ctx.i("Ids").reshape(-1).to(torch.int32)
    rows = [ctx.env[n] for n in op.input("X")]   # one row tensor per part
    n_parts = len(rows)
    N = ids.shape[0]
    D = rows[0].shape[-1]
    out = torch.zeros((N, D), dtype=rows[0].dtype, device=ids.device)
    for p in range(n_parts):
        m = torch.remainder(ids, n_parts) == p
        pos = torch.cumsum(m.to(torch.int64), 0) - 1
        gathered = rows[p][pos.clamp(0, rows[p].shape[0] - 1)]
        out = torch.where(m.unsqueeze(-1), gathered, out)
    ctx.set("Out", out)


@register_op("split_byref", stop_gradient=True)
def _split_byref(ctx, op):
    """operators/split_byref_op.cc: split rows by the ``sections`` attr
    (the var-slicing primitive under slice_var_up)."""
    x = ctx.i("X")
    sections = [int(s) for s in
                (ctx.attr("sections", None) or
                 ctx.attr("height_sections", None) or [])]
    if not sections:
        n = len(op.output("Out"))
        sections = [x.shape[0] // n] * n
    start = 0
    for i, s in enumerate(sections):
        ctx.set("Out", x[start:start + s], idx=i)
        start += s


register_op("split_selected_rows", stop_gradient=True)(_split_byref)


@register_op("lookup_sparse_table", nondiff_inputs=("Ids",))
def _lookup_sparse_table(ctx, op):
    """operators/lookup_sparse_table_op.cc: auto-growing sparse-table
    lookup.  Dense here: rows are pre-allocated, missing ids read the
    init value (zeros)."""
    w = ctx.i("W")
    ids = ctx.i("Ids").reshape(-1).to(torch.int64)
    rows = w[ids.clamp(0, w.shape[0] - 1)]
    oob = (ids < 0) | (ids >= w.shape[0])
    ctx.set("Out", torch.where(oob.unsqueeze(-1), torch.zeros_like(rows),
                               rows))


@register_op("ref_by_trainer_id", nondiff_inputs=("TrainerId",),
             stop_gradient=True)
def _ref_by_trainer_id(ctx, op):
    """operators/ref_by_trainer_id_op.cc: select X[trainer_id] (on the
    device: no read of the id back to the host)."""
    xs = [ctx.env[n] for n in op.input("X")]
    tid = ctx.i("TrainerId").reshape(1).to(torch.int64)
    stacked = torch.stack(xs)
    pick = torch.index_select(stacked, 0, tid.clamp(0, len(xs) - 1))
    ctx.set("Out", pick[0])


@register_op("prefetch", nondiff_inputs=("X",), stop_gradient=True)
def _prefetch(ctx, op):
    """operators/distributed_ops/prefetch_op.cc: fetch sparse-table rows
    for each id split from the pservers (parameter_prefetch.cc path),
    through the same host client as distributed_lookup_table."""
    from ...distributed import ps
    from .distributed_ops import _host, _to_device

    names = op.input("X")
    table_names = ctx.attr("table_names", None) or \
        [ctx.attr("table_name", "table")] * len(names)
    sections = [list(s) for s in ctx.attr("sections", []) or []] or None
    emb_dim = ctx.attr("emb_dim", None)
    if emb_dim is None:
        # reference prefetch ops carry no emb_dim; infer from the
        # declared output var shape
        var = ctx.block._find_var_recursive(op.output("Out")[0])
        shp = None if var is None else var.shape
        if not shp or shp[-1] in (None, -1):
            raise RuntimeError(
                "prefetch: cannot infer the row width — set the emb_dim "
                "attr or declare the output var shape")
        emb_dim = int(shp[-1])
    if sections is None:
        raise RuntimeError(
            "prefetch: the 'sections' attr [(slice, endpoint, begin, "
            "end), ...] is required — the transpiler records it when "
            "slicing the table (distribute_transpiler.py)")
    dtype = ctx.attr("table_dtype", "float32")
    for i, n in enumerate(names):
        flat = _host(ctx.env[n], "prefetch").reshape(-1).astype(np.int32)
        table = table_names[min(i, len(table_names) - 1)]
        rows = ps.prefetch_rows(table, sections, flat)
        ctx.set("Out", _to_device(ctx, np.asarray(rows).reshape(
            flat.shape[0], int(emb_dim)), dtype), idx=i)
