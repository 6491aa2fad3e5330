"""``python -m paddle_tpu_torch.distributed.launch`` (reference
``python -m paddle.distributed.launch``, fleet/launch.py:396): forwards
to ``launch_mod.launch()``."""
from .launch_mod import launch

if __name__ == "__main__":
    launch()
