"""Reference ``tensor/random.py``: rand, randn, randint, randperm,
uniform, normal, multinomial and the like, at the package's top level
(drawn from explicit generators), forwarded here."""


def __getattr__(name):
    import paddle_tpu_torch as paddle
    return getattr(paddle, name)
