"""Fleet facade (reference: incubate/fleet/base/fleet_base.py:37;
counterpart ``paddle_tpu/fluid/incubate/fleet/base/fleet_base.py``).

Unified distributed-training entry: ``fleet.init(role)`` then wrap the
optimizer with a DistributedOptimizer; worker/server lifecycle mirrors the
reference API (init_worker / init_server / run_server / stop_worker are
no-ops for the collective mode, which has no server processes).
"""

import abc


class Fleet(metaclass=abc.ABCMeta):
    def __init__(self):
        self._role_maker = None
        self._is_initialized = False
        self._executor = None

    def init(self, role_maker=None):
        from .role_maker import PaddleCloudRoleMaker
        if role_maker is None:
            role_maker = PaddleCloudRoleMaker(is_collective=True)
        self._role_maker = role_maker
        role_maker.generate_role()
        self._is_initialized = True

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def server_num(self):
        return self._role_maker.server_num()

    def server_endpoints(self):
        return self._role_maker.get_pserver_endpoints()

    def worker_endpoints(self):
        return self._role_maker.get_trainer_endpoints()

    # lifecycle hooks — collective mode needs none of these
    def init_worker(self):
        pass

    def init_server(self, model_dir=None):
        pass

    def run_server(self):
        pass

    def stop_worker(self):
        pass

    @abc.abstractmethod
    def distributed_optimizer(self, optimizer, strategy=None):
        pass

    @abc.abstractmethod
    def minimize(self, loss, **kwargs):
        pass


class DistributedOptimizer(metaclass=abc.ABCMeta):
    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy

    def backward(self, loss, **kwargs):
        return self._optimizer.backward(loss, **kwargs)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    @abc.abstractmethod
    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        pass
