"""paddle.distributed.fleet.utils (a copy of
``paddle_tpu/distributed/fleet/utils/__init__.py``; reference
python/paddle/distributed/fleet/utils/__init__.py __all__ = [LocalFS,
recompute, DistributedInfer, HDFSClient])."""
from ..utils_fs import LocalFS, HDFSClient  # noqa: F401
from ...utils_recompute import recompute  # noqa: F401


class DistributedInfer:
    """Reference: fleet/utils/ps_util.py DistributedInfer — pulls the
    latest sparse params from the PS before inference. Reduced: with the
    TCP PS, init_distributed_infer_env warms the local cache by pulling
    the listed tables; get_dist_infer_program is the identity (the jit
    program already contains the dense part)."""

    def __init__(self, main_program=None, startup_program=None):
        self._main = main_program

    def init_distributed_infer_env(self, exe=None, loss=None,
                                   role_maker=None, dirname=None):
        from ..fleet_base import ps_client
        client = ps_client()
        if client is not None and dirname:
            client.load(dirname)
        return exe

    def get_dist_infer_program(self):
        return self._main
