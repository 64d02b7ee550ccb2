"""The parameter-server fleet (counterpart ``paddle_tpu/fluid/incubate/
fleet/parameter_server``) is ROADMAP queue 1 item 13b: every entry
raises naming it."""

from ..base.fleet_base import Fleet


def _item_13b():
    return NotImplementedError(
        "the parameter-server fleet (DistributeTranspiler, pservers) is "
        "not ported yet (ROADMAP queue 1 item 13b)")


class ParameterServerFleet(Fleet):
    def init(self, role_maker=None):
        raise _item_13b()

    def distributed_optimizer(self, optimizer, strategy=None):
        raise _item_13b()

    def minimize(self, loss, **kwargs):
        raise _item_13b()


fleet = ParameterServerFleet()
