"""Reference ``tensor/attribute.py``: shape, rank, real, imag and the
like, at the package's top level, forwarded here."""


def __getattr__(name):
    import paddle_tpu_torch as paddle
    return getattr(paddle, name)
