"""``paddle.incubate`` (a port of part of ``paddle_tpu/incubate/``):
``moe`` (the mixture of experts with expert parallelism) and
``checkpoint`` (sharded checkpoints over ``torch.distributed.checkpoint``).
The rest of the reference's incubate — ``LookAhead``, ``ModelAverage``,
``softmax_mask_fuse`` / ``softmax_mask_fuse_upper_triangle``, ``asp`` and
``checkpoint.auto_checkpoint`` — is still to be ported (queue 1 item 14).
"""
from . import moe  # noqa: F401
from . import checkpoint  # noqa: F401
