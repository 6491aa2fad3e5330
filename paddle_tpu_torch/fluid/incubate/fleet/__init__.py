"""Legacy (pre-2.0) fleet API, kept import-compatible.

Reference: python/paddle/fluid/incubate/fleet/ — `base` (Fleet/Mode/
role makers), `collective` (Collective fleet + CollectiveOptimizer),
`parameter_server.distribute_transpiler` (FleetTranspiler + the
Sync/Async/HalfAsync/Geo strategy factory), `parameter_server.pslib`
(binary PSLib — not portable, raises with guidance here).

These all delegate to the modern `paddle.distributed.fleet` runtime:
one PS/collective implementation, two API skins.
"""
from . import base  # noqa: F401
