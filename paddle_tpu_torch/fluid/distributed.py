"""The multi-process world of the port: one process per rank over
``torch.distributed`` (counterpart ``paddle_tpu/fluid/distributed.py``).

Where the JAX package runs one process over N devices and maps the
program with ``shard_map``, the port follows torch's own idiom: each rank
is a process of its own, driving one device, and the collectives of a
program are ``torch.distributed`` calls on a process group.

- :func:`init` joins the world through a ``tcp://`` rendezvous (the
  ``PADDLE_*`` environment that ``paddle_tpu_torch.distributed.launch``
  exports; :func:`parallel_env_from_env`).  The backend is NCCL when the
  rank's device is a card, gloo only when the caller asks for the CPU
  (``place=CPUPlace()``) or names it (``backend="gloo"``).  A failed NCCL
  init raises; nothing retries on gloo.  A world of one is a no-op
  unless the caller names a backend.
- :func:`process_index` / :func:`process_count` / :func:`is_chief`: the
  identity every layer shares (telemetry labels, the chief's saves).
- :func:`barrier`, :func:`any_process`, :func:`consensus_flags`,
  :func:`all_processes_equal`: the host-side collectives of the training
  loop (the stop consensus of ``train_from_dataset``) and of fleet's
  chief-only saves.  Each counts in
  ``distributed_collective_calls_total{kind}``.
- :func:`shutdown` destroys the process group.
- :func:`ring_group` / :func:`register_ring`: ``ring_id`` → process
  group.  Ring 0 is the world; further rings are groups that the
  ``c_comm_init`` op builds (ops/collective_ops.py).  A model-parallel
  program's run resolves its ring 0 to its dp group itself
  (``lowering.ExecState.ring_group``).
  :func:`ring_levels`: a ring's two levels (node groups and the group of
  node roots) for hierarchical allreduce.

The JAX module's ``ensure_cpu_collectives`` and
``cpu_collectives_supported`` choose XLA's CPU transport; torch's gloo
backend needs no such switch, so the port has neither.
"""

import datetime
import os
import sys
import warnings

import torch

from . import telemetry

_m_collectives = telemetry.counter(
    "distributed_collective_calls_total",
    "host-side collective entries (barrier/consensus), by kind")

_state = {
    "connected": False,     # this module created the process group
    "process_id": 0,
    "num_processes": 1,
}
# ring_id -> ProcessGroup (ring 0, the world, is None: the default group)
_rings = {}
# (ring_id, nnodes) -> the ring's two levels (hierarchical allreduce)
_levels = {}

# rendezvous and collective timeout of the process group
TIMEOUT_S = 600


def _dist():
    """``torch.distributed`` once this process has a world, else None.
    Reads ``sys.modules``: it never imports torch.distributed itself."""
    d = sys.modules.get("torch.distributed")
    if d is not None and d.is_available() and d.is_initialized():
        return d
    return None


def parallel_env_from_env():
    """(coordinator, num_processes, process_id, local_device_ids) from
    the PADDLE_* environment the launcher exports."""
    nproc = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    coord = os.environ.get("PADDLE_DIST_COORDINATOR")
    if coord is None:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        if eps:
            ip, port = eps.split(",")[0].rsplit(":", 1)
            coord = "%s:%d" % (ip, int(port) + 1017)
    raw = os.environ.get("PADDLE_LOCAL_DEVICE_IDS", "")
    local_ids = [int(d) for d in raw.replace(",", " ").split()] \
        if raw.strip() else None
    return coord, nproc, rank, local_ids


def local_device_index():
    """The card this rank drives: the first of PADDLE_LOCAL_DEVICE_IDS
    (the launcher's ``--selected_devices``), else 0."""
    _coord, _n, _r, ids = parallel_env_from_env()
    return ids[0] if ids else 0


def init(coordinator_address=None, num_processes=None, process_id=None,
         backend=None, place=None):
    """Join the world of ranks.  Every argument defaults to the
    launcher's environment, so scripts call ``init()`` unconditionally.
    ``backend`` is ``"nccl"`` or ``"gloo"``; by default NCCL on
    ``CUDAPlace(local_device_index())``, gloo when ``place`` is a
    ``CPUPlace``.  A world of one is a no-op unless ``backend`` is
    named: then it gets a process group of its own (the collectives
    run, on one rank).  Idempotent; a second call with another identity
    raises.  Returns ``(process_id, num_processes)``."""
    from .executor import CPUPlace
    env_coord, env_nproc, env_rank, _ids = parallel_env_from_env()
    coordinator_address = coordinator_address or env_coord
    num_processes = env_nproc if num_processes is None \
        else int(num_processes)
    process_id = env_rank if process_id is None else int(process_id)
    if _state["connected"]:
        if (num_processes, process_id) != (_state["num_processes"],
                                           _state["process_id"]):
            raise RuntimeError(
                "fluid.distributed.init called twice with a different "
                "identity: already process %d/%d, asked for %d/%d"
                % (_state["process_id"], _state["num_processes"],
                   process_id, num_processes))
        return _state["process_id"], _state["num_processes"]
    if num_processes <= 1 and backend is None:
        return 0, 1
    if not coordinator_address:
        raise ValueError(
            "fluid.distributed.init: num_processes=%d but no coordinator "
            "address — pass coordinator_address= or launch via "
            "paddle_tpu_torch.distributed.launch (it exports "
            "PADDLE_DIST_COORDINATOR)" % num_processes)
    if backend is None:
        backend = "gloo" if isinstance(place, CPUPlace) else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend must be 'nccl' or 'gloo', got %r"
                         % (backend,))
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fluid.distributed.init: the NCCL backend needs a CUDA "
                "device and PyTorch sees none; pass place=CPUPlace() or "
                "backend='gloo' to run the world on the host")
        torch.cuda.set_device(local_device_index())
    import torch.distributed as dist
    dist.init_process_group(
        backend=backend, init_method="tcp://" + coordinator_address,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _state.update(connected=True, process_id=dist.get_rank(),
                  num_processes=dist.get_world_size())
    _rings.clear()
    _levels.clear()
    _forget_model_parallel_groups()
    telemetry.set_process_index(_state["process_id"],
                                _state["num_processes"])
    return _state["process_id"], _state["num_processes"]


def shutdown():
    """Destroy the process group this module created (idempotent), so a
    later :func:`init` can join another world (``fluid/elastic.py``).

    Every checkpoint manager's save in flight is joined first
    (``checkpoint.wait_all``): its commit polls storage only, so the
    fence needs no collective.  A failed save becomes a warning here —
    teardown does not raise."""
    ckpt = sys.modules.get(__name__.rsplit(".", 1)[0] + ".checkpoint")
    if ckpt is not None:
        try:
            ckpt.wait_all()
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:   # noqa: BLE001 — teardown goes on
            warnings.warn(
                "in-flight checkpoint save failed during shutdown (%s: "
                "%s) — the last committed checkpoint remains the latest"
                % (type(e).__name__, e), stacklevel=2)
    was = _state["connected"]
    _state.update(connected=False, process_id=0, num_processes=1)
    _rings.clear()
    _levels.clear()
    _forget_model_parallel_groups()
    telemetry.set_process_index(None)
    d = _dist()
    if was and d is not None:
        d.destroy_process_group()


def process_index():
    """This process's rank (0 without a world)."""
    d = _dist()
    return d.get_rank() if d is not None else 0


def process_count():
    """Ranks in the world (1 without one)."""
    d = _dist()
    return d.get_world_size() if d is not None else 1


def is_chief():
    """True on rank 0, the one writer of fleet's saves."""
    return process_index() == 0


def backend():
    """The process group's backend name, or None without a world."""
    d = _dist()
    return d.get_backend() if d is not None else None


def comm_device():
    """The device a host-side collective's payload must live on: the
    card for NCCL, the host for gloo."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _forget_model_parallel_groups():
    mesh = sys.modules.get(__name__.rsplit(".", 1)[0] + ".mesh_utils")
    if mesh is not None:
        mesh.reset_model_parallel_coords()


def register_ring(ring_id, group):
    _rings[int(ring_id)] = group


def ring_group(ring_id):
    """The process group of ``ring_id``: ring 0 is the world (None, the
    default group); another ring must have been built by ``c_comm_init``
    in this world, or this raises."""
    ring_id = int(ring_id or 0)
    if ring_id == 0:
        return None
    if ring_id not in _rings:
        raise RuntimeError(
            "ring_id %d has no process group: run the startup program "
            "(its c_comm_init ops build the rings) first" % ring_id)
    return _rings[ring_id]


class Levels:
    """The two levels of a hierarchical ring (reference nccl_helper.h:246;
    the JAX package's ("dcn", "ici") mesh): ``nnodes`` nodes of
    ``per_node`` consecutive ranks.  ``intra`` is this rank's node group,
    ``inter`` the group of every node's first rank (None on the other
    ranks), ``root`` the global rank of this node's first rank."""

    def __init__(self, world, nnodes, intra, inter, root):
        self.world = world
        self.nnodes = nnodes
        self.per_node = world // nnodes
        self.intra = intra
        self.inter = inter
        self.root = root


def ring_levels(ring_id, nnodes):
    """The two levels of ring ``ring_id`` over ``nnodes`` nodes, built on
    first use.  Building calls ``new_group`` once per node and once for
    the node roots, on every rank in the same order, so every rank must
    reach its first two-level collective (or the startup's
    ``c_comm_init``) together — as the ops of one program do."""
    key = (int(ring_id or 0), int(nnodes))
    if key in _levels:
        return _levels[key]
    d = _dist()
    base = ring_group(ring_id)
    ranks = list(range(d.get_world_size())) if base is None else \
        sorted(d.get_process_group_ranks(base))
    world = len(ranks)
    if world % nnodes:
        raise RuntimeError(
            "hierarchical allreduce: %d ranks not divisible by nnodes=%d"
            % (world, nnodes))
    per = world // nnodes
    me = d.get_rank()
    intra = inter = None
    for n in range(nnodes):
        g = d.new_group(ranks=ranks[n * per:(n + 1) * per])
        if me in ranks[n * per:(n + 1) * per]:
            intra = g
    g = d.new_group(ranks=ranks[::per])
    if me in ranks[::per]:
        inter = g
    pos = ranks.index(me)
    levels = Levels(world, nnodes, intra, inter, ranks[pos - pos % per])
    _levels[key] = levels
    return levels


def barrier(name="fluid-barrier"):
    """Block until every rank reaches this named point (no-op in a world
    of one)."""
    _m_collectives.inc(kind="barrier")
    with telemetry.span("barrier", phase="barrier:%s" % name, name=name):
        d = _dist()
        if d is None or d.get_world_size() <= 1:
            return
        d.barrier()


def any_process(value):
    """Global OR of one host-side bool (no-op in a world of one): the
    preemption-stop consensus."""
    return consensus_flags(value)[0]


def consensus_flags(*values):
    """Element-wise global OR of several host-side bools in ONE
    all-reduce (MAX of 0/1), so the training loop's stop and rollback
    verdicts share a single collective per consensus boundary.  Every
    rank must call this at the same points with the same arity."""
    _m_collectives.inc(kind="consensus")
    with telemetry.span("consensus", phase="consensus"):
        d = _dist()
        if d is None or d.get_world_size() <= 1:
            return tuple(bool(v) for v in values)
        t = torch.tensor([1 if v else 0 for v in values], dtype=torch.int32,
                         device=comm_device())
        d.all_reduce(t, op=d.ReduceOp.MAX)
        return tuple(bool(b) for b in t.cpu().tolist())


def all_processes_equal(value, name="value"):
    """Raise unless the host number ``value`` is the same on every rank
    (a check of world-visible settings); returns it.  One all-reduce of
    (value, -value) under MAX: equal everywhere iff max == -(-min)."""
    d = _dist()
    if d is None or d.get_world_size() <= 1:
        return value
    _m_collectives.inc(kind="equal")
    t = torch.tensor([float(value), -float(value)], dtype=torch.float64,
                     device=comm_device())
    d.all_reduce(t, op=d.ReduceOp.MAX)
    hi, neg_lo = t.cpu().tolist()
    if hi != -neg_lo:
        raise RuntimeError("%s differs across processes: from %r to %r"
                           % (name, -neg_lo, hi))
    return value
