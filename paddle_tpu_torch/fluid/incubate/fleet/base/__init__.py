from . import role_maker  # noqa: F401
from .fleet_base import Fleet, DistributedOptimizer  # noqa: F401
