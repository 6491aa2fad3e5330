"""paddle.fluid compat namespace (a port of ``paddle_tpu/fluid/``).

Reference parity: python/paddle/fluid/ — the pre-2.0 API layer that much
existing user code still imports (fluid.dygraph.guard, fluid.layers.*,
fluid.Executor, fluid.ParamAttr, ...). Everything here forwards to the
modern paddle_tpu_torch modules; it exists so reference-era scripts port
without rewrites. New code should use the top-level API.

``fluid.CUDAPlace(0)`` is ``cuda:0``; ``fluid.Executor()`` runs on the
device of the program's parameters, the card unless the caller asks for
``CPUPlace``. ``is_compiled_with_cuda`` is the port's own: True where
torch sees a card (the reference's says False).
"""
from ..core.device import (  # noqa: F401
    CPUPlace, CUDAPlace, CUDAPinnedPlace, is_compiled_with_cuda,
)
from ..nn.initializer import ParamAttr  # noqa: F401
from .. import regularizer  # noqa: F401
from ..static import (  # noqa: F401
    Executor, Program, default_main_program, default_startup_program,
    program_guard, data,
)
from ..core.dispatch import no_grad  # noqa: F401
from ..core.lod import (  # noqa: F401
    LoDTensor, create_lod_tensor, create_random_int_lodtensor,
)
from .. import optimizer  # noqa: F401
from . import dygraph  # noqa: F401
from . import layers  # noqa: F401
from . import io  # noqa: F401
from . import incubate  # noqa: F401
from ..nn import initializer  # noqa: F401
from ..nn.clip import (  # noqa: F401
    ClipGradByValue, ClipGradByNorm, ClipGradByGlobalNorm,
)
from ..core.flags import get_flags, set_flags  # noqa: F401,E402


class CompiledProgram:
    """Reference: fluid/compiler.py CompiledProgram — ``Executor.run``
    already runs each feed signature of a program as one CUDA graph on
    the card, and data parallelism is ``paddle.distributed``'s, so both
    are identity wrappers."""

    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        return self


class ExecutionStrategy:
    num_threads = 1
    num_iteration_per_drop_scope = 100


class BuildStrategy:
    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1
    reduce_strategy = ReduceStrategy.AllReduce
    fuse_all_reduce_ops = True
    memory_optimize = True
