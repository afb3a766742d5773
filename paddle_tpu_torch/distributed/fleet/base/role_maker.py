"""Role makers: who am I in the job?  (counterpart of
paddle_tpu/distributed/fleet/base/role_maker.py): PaddleCloudRoleMaker
reads the launcher's PADDLE_* contract, else the live process group;
UserDefinedRoleMaker takes the topology as arguments."""

from __future__ import annotations

import os


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints = []
        self._server_endpoints = []
        self._role_is_generated = False

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_num(self):
        raise NotImplementedError

    def worker_index(self):
        raise NotImplementedError

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def _generate_role(self):
        self._role_is_generated = True


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._generate_role()

    def _generate_role(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        self._worker_endpoints = eps.split(",") if eps else []
        self._worker_index = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
        n = os.environ.get("PADDLE_TRAINERS_NUM")
        if n is not None:
            self._worker_num = int(n)
        elif self._worker_endpoints:
            self._worker_num = len(self._worker_endpoints)
        else:
            self._worker_num = _process_count()
        self._role_is_generated = True

    def worker_num(self):
        return self._worker_num

    def worker_index(self):
        return self._worker_index


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True, current_id=0, role=Role.WORKER,
                 worker_num=1, worker_endpoints=None, server_endpoints=None,
                 **kwargs):
        super().__init__()
        self._worker_index_ = current_id
        self._worker_num_ = worker_num
        self._worker_endpoints = worker_endpoints or []
        self._server_endpoints = server_endpoints or []
        self._role = role
        self._role_is_generated = True

    def worker_num(self):
        return self._worker_num_

    def worker_index(self):
        return self._worker_index_


def _process_count():
    from ... import parallel

    return parallel.process_count()
