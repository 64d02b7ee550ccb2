"""The devices of this rank (counterpart ``paddle_tpu/fluid/mesh_utils.py``,
its device half only).

The JAX package builds a ``jax.sharding.Mesh`` over every device of the
world and maps the step with ``shard_map`` over its ``dp`` axis: one
process drives all devices.  The port runs one process per rank
(``fluid/distributed.py``), and each process sees only the card the
launcher gave it, so there is no mesh to build and no ``shard_map``:
the collectives of a program are ``torch.distributed`` calls on a
process group (``ops/collective_ops.py``).  What is left is the device
query: which ``torch.device`` values this process drives, and the
model-parallel layout: where a rank sits among the groups of each axis
of a ``(dp, mp, sp, ep)`` or pipelined ``(dp, pp, mp, sp, ep)`` layout,
row-major over the world's ranks as the JAX package's meshes lay out
its devices (:func:`layout_coords`).
"""

import torch

from . import distributed


def local_devices(platform=None):
    """The ``torch.device`` list this rank drives: the CPU when
    ``platform == "cpu"``, else its card(s) — every id of
    PADDLE_LOCAL_DEVICE_IDS (the launcher's ``--selected_devices``), or
    card 0 outside the launcher.  Raises when a card is asked for and
    PyTorch sees none."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "local_devices: no CUDA device is visible; pass "
            "platform='cpu' to ask for the host")
    _c, _n, _r, ids = distributed.parallel_env_from_env()
    return [torch.device("cuda", i) for i in (ids or [0])]


def ordered_devices(platform=None):
    """Every device of ``platform`` this process can see, in id order
    (the CPU is one device)."""
    if platform == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ordered_devices: no CUDA device is visible; pass "
            "platform='cpu' to ask for the host")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


# ---------------------------------------------------------------------------
# Model-parallel groups (counterpart of the JAX package's meshes:
# ("dp", mp|sp|ep...) for tensor, sequence and expert parallelism,
# paddle_tpu/fluid/executor.py:_model_parallel_axes, and ("dp", "pp",
# "mp"[, "sp"][, "ep"]) for a pipeline, paddle_tpu/fluid/pipeline.py)
# ---------------------------------------------------------------------------

AXES = ("mp", "sp", "ep")


def _unravel(rank, dims):
    """Row-major coordinates of ``rank`` over ``dims``."""
    out = []
    for d in reversed(dims):
        out.append(rank % d)
        rank //= d
    return out[::-1]


def _ravel(coords, dims):
    r = 0
    for c, d in zip(coords, dims):
        r = r * d + c
    return r


def _line(coords, dims, i):
    """The ranks whose coordinates equal ``coords`` except on axis ``i``."""
    out = []
    for j in range(dims[i]):
        c = list(coords)
        c[i] = j
        out.append(_ravel(c, dims))
    return out


class Coords:
    """Where rank ``global_rank`` sits on ``axis`` of a row-major layout
    of the world's ranks over ``layout`` ((name, size) pairs, ``dp``
    first).

    ``group`` is the process group of this rank's line along ``axis``
    (None when it is the whole world, the default group), ``dp_group``
    the group of its dp replicas, the line along ``dp`` (None when there
    is one replica or when it is the world).  ``rank`` is this rank's
    coordinate on ``axis``, ``dp_rank`` its coordinate on ``dp``;
    ``group_ranks`` and ``dp_ranks`` list the world ranks of both
    lines."""

    def __init__(self, axis, layout, global_rank, group=None,
                 dp_group=None):
        names = [n for n, _ in layout]
        dims = [int(d) for _, d in layout]
        coords = _unravel(global_rank, dims)
        i, k = names.index(axis), names.index("dp")
        self.axis = axis
        self.degree = dims[i]
        self.layout = tuple(zip(names, dims))
        self.coords = dict(zip(names, coords))
        self.dp_size = dims[k]
        self.rank = coords[i]
        self.dp_rank = coords[k]
        self.group_ranks = _line(coords, dims, i)
        self.dp_ranks = _line(coords, dims, k)
        self.group = group
        self.dp_group = dp_group

    def fold(self, axes):
        """This rank's row-major index over ``dp`` and ``axes`` (the
        axes whose shards a computation runs on): ranks that differ only
        on the other axes compute the same values and share it.  With
        the default layout, ``fold([axis])`` is the global rank."""
        r = 0
        for name, d in self.layout:
            if name == "dp" or name in axes:
                r = r * d + self.coords[name]
        return r


_coords = {}


def layout_coords(layout):
    """{axis: :class:`Coords`} of this rank for every axis of ``layout``
    ((name, size) pairs, ``dp`` first, row-major over the world's first
    ranks) but ``dp`` and the axes of size 1, with the process groups of
    every axis of more than one rank: built on first use by
    ``new_group`` on every rank in the same order (each axis of the
    layout in turn, its lines in row-major order), as the ops of one
    program reach it on every rank together.  A rank past the layout's
    ranks gets {}; without a world the layout must hold one rank."""
    layout = tuple((str(n), int(s)) for n, s in layout)
    d = distributed._dist()
    world = d.get_world_size() if d is not None else 1
    total = 1
    for _n, s in layout:
        total *= s
    if total > world:
        raise ValueError("the layout %s needs %d ranks, the world has %d"
                         % (dict(layout), total, world))
    key = (layout, world)
    if key in _coords and _coords[key][0] is d:
        return _coords[key][1]
    me = d.get_rank() if d is not None else 0
    names = [n for n, _ in layout]
    dims = [s for _, s in layout]
    inside = me < total
    mine = _unravel(me, dims) if inside else None
    groups = {}
    for i, (name, size) in enumerate(layout):
        if d is None or size == 1:
            continue
        if size == world:
            groups[name] = None          # the default group: every rank
            continue
        others = [j for j in range(len(dims)) if j != i]
        for line in range(total // size):
            c = [0] * len(dims)
            for j, v in zip(others, _unravel(line, [dims[j]
                                                   for j in others])):
                c[j] = v
            grp = d.new_group(ranks=_line(c, dims, i))
            if inside and all(c[j] == mine[j] for j in others):
                groups[name] = grp
    out = {}
    for name, size in layout:
        if name == "dp" or size == 1 or not inside:
            continue
        out[name] = Coords(name, layout, me, group=groups.get(name),
                           dp_group=groups.get("dp"))
    _coords[key] = (d, out)
    return out


def reset_model_parallel_coords():
    """Forget the cached groups (a new world was joined)."""
    _coords.clear()
