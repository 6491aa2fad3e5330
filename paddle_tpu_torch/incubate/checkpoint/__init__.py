from . import sharded  # noqa: F401
from .sharded import (AsyncShardedSaver, load_sharded,  # noqa: F401
                      load_sharded_train_state, save_sharded,
                      save_sharded_train_state)
