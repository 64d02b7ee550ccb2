"""Role makers: derive the process's distributed identity.

Reference: ``python/paddle/fluid/incubate/fleet/base/role_maker.py`` (491
LoC; counterpart ``paddle_tpu/fluid/incubate/fleet/base/role_maker.py``) —
roles from ``PADDLE_*`` env (PaddleCloudRoleMaker) or user args
(UserDefinedRoleMaker).  ``python -m paddle_tpu_torch.distributed.launch``
exports that environment to each rank.
"""

import os


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role_is_generated = False
        self._role = Role.WORKER
        self._current_id = 0

    def generate_role(self):
        self._role_is_generated = True

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return max(len(self._worker_endpoints), 1)

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-driven role maker (PADDLE_TRAINER_ID / PADDLE_TRAINER_ENDPOINTS /
    PADDLE_PORT ... — the launch.py contract, SURVEY.md §2.4c)."""

    def __init__(self, is_collective=False):
        super().__init__()
        self._is_collective = is_collective

    def generate_role(self):
        if self._role_is_generated:
            return
        if self._is_collective:
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
            eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
            self._worker_endpoints = [e for e in eps.split(",") if e]
            self._role = Role.WORKER
        else:
            training_role = os.environ.get("TRAINING_ROLE", "TRAINER")
            if training_role == "TRAINER":
                self._role = Role.WORKER
                self._current_id = int(os.environ.get("PADDLE_TRAINER_ID",
                                                      0))
            else:
                self._role = Role.SERVER
                port = os.environ.get("PADDLE_PORT", "")
                ip = os.environ.get("POD_IP", "")
                cur = "%s:%s" % (ip, port)
                self._server_endpoints = [
                    e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST",
                                              "").split(",") if e]
                self._current_id = self._server_endpoints.index(cur) \
                    if cur in self._server_endpoints else 0
            eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
            self._worker_endpoints = [e for e in eps.split(",") if e]
        self._role_is_generated = True


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_num = worker_num
        self._server_endpoints = server_endpoints or []

    def worker_num(self):
        return self._worker_num

    def generate_role(self):
        self._role_is_generated = True
