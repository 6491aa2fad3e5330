"""Legacy parameter-server fleet namespace (reference:
fluid/incubate/fleet/parameter_server/ — distribute_transpiler mode
delegates to the modern PS runtime; binary PSLib mode is not portable).
"""
from .mode import DistributedMode  # noqa: F401
