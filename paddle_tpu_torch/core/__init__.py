"""The eager core of the port (a port of ``paddle_tpu/core``): dtypes,
devices and Places, flags, errors, the Tensor, the op dispatcher and the
backward engine on torch's autograd, and the random generators."""
