"""InputSpec (a port of ``paddle_tpu/static/input_spec.py``; reference:
python/paddle/static/input.py InputSpec)."""


class InputSpec:
    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tuple(tensor.shape), tensor.dtype.name,
                   name or tensor.name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, str(ndarray.dtype), name)

    def batch(self, batch_size):
        self.shape = (batch_size,) + tuple(self.shape)
        return self

    def unbatch(self):
        self.shape = tuple(self.shape[1:])
        return self
