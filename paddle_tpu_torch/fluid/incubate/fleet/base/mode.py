"""Reference: fluid/incubate/fleet/base/mode.py:30 — fleet run modes."""


class Mode:
    TRANSPILER = 1
    PSLIB = 2
    COLLECTIVE = 3
