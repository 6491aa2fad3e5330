"""Pre-2.0 incubate namespace (a port of ``paddle_tpu/fluid/incubate/``;
reference: python/paddle/fluid/incubate/).

The legacy fleet surface stays alive as a thin delegation layer over
`paddle.distributed.fleet` (the modern runtime); see the fleet/
subpackage.
"""
from . import fleet  # noqa: F401
