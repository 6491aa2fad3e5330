"""The layers of the port's ``nn`` (``paddle_tpu/nn/layer``)."""
