"""Binary PSLib mode (reference:
fluid/incubate/fleet/parameter_server/pslib/__init__.py).

PSLib is a closed-source baidu PS binary the reference links against
when built WITH_PSLIB; it is not portable to this stack. The public
entry raises and names the working replacement (the transpiler-mode
legacy skin or the modern fleet API, both backed by the port's PS
runtime in distributed/ps/).
"""


class PSLib:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "binary PSLib is not available on this stack; use "
            "fluid.incubate.fleet.parameter_server.distribute_transpiler"
            ".fleet (same API, modern PS runtime underneath) or "
            "paddle.distributed.fleet directly")


def fleet(*a, **k):
    raise NotImplementedError(
        "binary PSLib is not available on this stack; use "
        "fluid.incubate.fleet.parameter_server.distribute_transpiler"
        ".fleet or paddle.distributed.fleet")
