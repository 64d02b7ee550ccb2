"""The devices of this rank (counterpart ``paddle_tpu/fluid/mesh_utils.py``,
its device half only).

The JAX package builds a ``jax.sharding.Mesh`` over every device of the
world and maps the step with ``shard_map`` over its ``dp`` axis: one
process drives all devices.  The port runs one process per rank
(``fluid/distributed.py``), and each process sees only the card the
launcher gave it, so there is no mesh to build and no ``shard_map``:
the collectives of a program are ``torch.distributed`` calls on a
process group (``ops/collective_ops.py``).  What is left is the device
query: which ``torch.device`` values this process drives.
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
