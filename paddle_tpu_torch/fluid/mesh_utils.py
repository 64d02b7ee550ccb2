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
model-parallel layout: where a rank sits among the ``(dp, mp|sp|ep)``
groups that tensor, sequence and expert parallelism run over
(:func:`model_parallel_coords`).
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
# Model-parallel groups (counterpart of the JAX package's (dp, mp|sp|ep)
# mesh, paddle_tpu/fluid/executor.py:_model_parallel_axes)
# ---------------------------------------------------------------------------

AXES = ("mp", "sp", "ep")


class Coords:
    """Where this rank sits in a ``(dp, axis)`` layout of ``world`` ranks:
    the model-parallel group of ``axis`` is ``degree`` consecutive ranks
    (rank // degree names it), the dp group the ranks at the same place
    in every such group.

    ``group`` is the process group of this rank's model-parallel group
    (None when it is the whole world, the default group), ``dp_group``
    the group of its dp replicas (None when there is one replica or when
    it is the world).  ``rank`` is this rank's index in ``group``,
    ``dp_rank`` its index in ``dp_group``."""

    def __init__(self, axis, degree, world, global_rank, group=None,
                 dp_group=None):
        if degree < 1 or world % degree:
            raise ValueError(
                "%s_degree=%d does not divide a world of %d rank(s)"
                % (axis, degree, world))
        self.axis = axis
        self.degree = int(degree)
        self.world = int(world)
        self.global_rank = int(global_rank)
        self.dp_size = world // degree
        self.rank = global_rank % degree
        self.dp_rank = global_rank // degree
        self.group_ranks = list(range(self.dp_rank * degree,
                                      (self.dp_rank + 1) * degree))
        self.dp_ranks = list(range(self.rank, world, degree))
        self.group = group
        self.dp_group = dp_group


_coords = {}


def model_parallel_coords(axis, degree):
    """:class:`Coords` of this rank for ``axis`` at ``degree``, with its
    process groups: built on first use by ``new_group`` on every rank in
    the same order (every model-parallel group, then every dp group), as
    the ops of one program reach it on every rank together.  In a world
    of one (no process group) the degree must be 1."""
    if axis not in AXES:
        raise ValueError("model-parallel axis must be one of %s, got %r"
                         % (AXES, axis))
    d = distributed._dist()
    world = d.get_world_size() if d is not None else 1
    key = (axis, int(degree), world)
    if key in _coords and _coords[key][0] is d:
        return _coords[key][1]
    me = d.get_rank() if d is not None else 0
    c = Coords(axis, degree, world, me)
    if d is None or degree == 1:
        pass
    elif degree == world:
        c.group = None                   # the default group: every rank
    else:
        for g in range(world // degree):
            grp = d.new_group(ranks=list(range(g * degree,
                                               (g + 1) * degree)))
            if g == c.dp_rank:
                c.group = grp
        for j in range(degree):
            grp = d.new_group(ranks=list(range(j, world, degree)))
            if j == c.rank:
                c.dp_group = grp
    _coords[key] = (d, c)
    return c


def reset_model_parallel_coords():
    """Forget the cached groups (a new world was joined)."""
    _coords.clear()
