"""Reference ``tensor/to_string.py``: the printing options, at the
package's top level, forwarded here."""


def __getattr__(name):
    import paddle_tpu_torch as paddle
    return getattr(paddle, name)
