from .mp_layers import (  # noqa: F401
    VocabParallelEmbedding, ColumnParallelLinear, RowParallelLinear,
    ParallelCrossEntropy,
)
from .parallel_wrappers import (  # noqa: F401
    TensorParallel, PipelineParallel, ShardingParallel,
)
from .random import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
from .sequence_parallel import (  # noqa: F401
    SequenceParallelAttention, ring_attention, ulysses_attention,
)
# pp_layers (PipelineLayer, LayerDesc, SharedLayerDesc) comes with the
# pipeline engine, queue 1 item 13
