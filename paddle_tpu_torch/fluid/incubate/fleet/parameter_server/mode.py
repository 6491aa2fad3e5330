"""Reference: fluid/incubate/fleet/parameter_server/mode.py —
PS communication modes."""


class DistributedMode:
    SYNC = 0
    ASYNC = 1
    HALF_ASYNC = 2
    GEO = 3
