from . import fleet_base, mode, role_maker  # noqa: F401
from .mode import Mode  # noqa: F401
