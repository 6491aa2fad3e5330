"""Role makers: derive this process's role in a PS/collective cluster (a
copy of ``paddle_tpu/distributed/fleet/role_maker.py``, which imports
nothing of JAX: the port keeps its own).

Reference parity: python/paddle/distributed/fleet/base/role_maker.py
(PaddleCloudRoleMaker reads the launcher's env: TRAINING_ROLE,
PADDLE_PSERVERS_IP_PORT_LIST, PADDLE_TRAINER_ENDPOINTS,
PADDLE_TRAINER_ID, PADDLE_PORT/POD_IP; UserDefinedRoleMaker takes
explicit values).
"""
import os


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def _is_worker(self):
        return self._role == Role.WORKER

    def _is_server(self):
        return self._role == Role.SERVER

    def _worker_index(self):
        return self._current_id if self._role == Role.WORKER else -1

    def _server_index(self):
        return self._current_id if self._role == Role.SERVER else -1

    def _worker_num(self):
        return len(self._worker_endpoints)

    def _server_num(self):
        return len(self._server_endpoints)

    def _get_trainer_endpoints(self):
        return list(self._worker_endpoints)

    def _get_pserver_endpoints(self):
        return list(self._server_endpoints)


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reference: role_maker.py PaddleCloudRoleMaker — env-driven."""

    def __init__(self, is_collective=False, **kwargs):
        self._is_collective = is_collective
        self._server_endpoints = [
            e for e in os.environ.get("PADDLE_PSERVERS_IP_PORT_LIST",
                                      "").split(",") if e]
        self._worker_endpoints = [
            e for e in os.environ.get("PADDLE_TRAINER_ENDPOINTS",
                                      "").split(",") if e]
        role = os.environ.get("TRAINING_ROLE", "TRAINER").upper()
        if is_collective or role in ("TRAINER", "WORKER"):
            self._role = Role.WORKER
            self._current_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        else:
            self._role = Role.SERVER
            ip = os.environ.get("POD_IP", "127.0.0.1")
            port = os.environ.get("PADDLE_PORT", "0")
            ep = f"{ip}:{port}"
            if self._server_endpoints and ep not in self._server_endpoints:
                raise ValueError(
                    f"current endpoint {ep} (POD_IP:PADDLE_PORT) is not "
                    f"in PADDLE_PSERVERS_IP_PORT_LIST "
                    f"{self._server_endpoints}")
            self._current_id = (self._server_endpoints.index(ep)
                                if self._server_endpoints else 0)


class UserDefinedRoleMaker(RoleMakerBase):
    """Reference: role_maker.py UserDefinedRoleMaker — explicit args."""

    def __init__(self, is_collective=False, current_id=0, role=Role.WORKER,
                 worker_num=None, worker_endpoints=None,
                 server_endpoints=None, **kwargs):
        self._is_collective = is_collective
        self._role = role
        self._current_id = int(current_id)
        self._worker_endpoints = list(worker_endpoints or [])
        if worker_num and not self._worker_endpoints:
            self._worker_endpoints = [""] * int(worker_num)
        self._server_endpoints = list(server_endpoints or [])
