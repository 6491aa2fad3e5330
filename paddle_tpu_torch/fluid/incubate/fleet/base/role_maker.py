"""Legacy role makers (reference: fluid/incubate/fleet/base/role_maker.py).

The modern role makers already speak the same env protocol
(PADDLE_TRAINER_ID / TRAINING_ROLE / PADDLE_PSERVERS_IP_PORT_LIST), so
the legacy names re-export them. `Role` keeps the legacy WORKER/SERVER
constants. MPI-based role makers need an MPI runtime this stack does
not ship; they raise with the modern replacement named.
"""
from .....distributed.fleet.role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker)


class MPISymetricRoleMaker(RoleMakerBase):  # noqa: N801 (reference name)
    """Reference: role_maker.py MPISymetricRoleMaker (mpi4py-based)."""

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "MPI role makers need an MPI runtime (mpi4py), which this "
            "image does not ship. Use PaddleCloudRoleMaker (env-driven, "
            "works with paddle.distributed.launch) or "
            "UserDefinedRoleMaker instead.")


MPIRoleMaker = MPISymetricRoleMaker
