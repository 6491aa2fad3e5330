"""``paddle.jit`` (a port of ``paddle_tpu/jit/__init__.py``): ``to_static``
(whole-step CUDA-graph capture, ``to_static.py``, after the dy2static
conversion of ``dy2static.py``), ``not_to_static``,
``ProgramTranslator``, ``set_code_level``/``set_verbosity`` and
``TracedLayer``, and ``save``/``load``/``TranslatedLayer``
(``jit/save_load.py``: the forward recorded as a static ``Program``)."""
from ..core.trace import ToStaticError  # noqa: F401
from .save_load import TranslatedLayer, load, save  # noqa: F401
from .to_static import TracedFunction, not_to_static, to_static  # noqa: F401


class ProgramTranslator:
    """Reference: dygraph_to_static/program_translator.py:232 — global
    enable/disable switch for to_static conversion."""

    _instance = None
    _enabled = [True]

    @classmethod
    def get_instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self, enable_to_static):
        self._enabled[0] = bool(enable_to_static)

    @property
    def enable_to_static(self):
        return self._enabled[0]


def set_code_level(level=100, also_to_stdout=False):
    """Reference: jit.set_code_level — above 0, each function dy2static
    converts from now on has its converted source printed (the three
    passes' output)."""
    from . import dy2static
    dy2static._code_level[0] = int(level)


def set_verbosity(level=0, also_to_stdout=False):
    return None


class TracedLayer:
    """Reference: fluid/dygraph/jit.py TracedLayer — trace a layer once
    and replay the captured step; ``save_inference_model`` saves it with
    ``jit.save``, the inputs given to ``trace`` its input spec (what the
    reference's docstring promises; its own call passes no spec and
    raises)."""

    def __init__(self, layer, traced, inputs=None):
        self._layer = layer
        self._traced = traced
        self._inputs = list(inputs) if inputs is not None else None

    @staticmethod
    def trace(layer, inputs):
        traced = to_static(layer.forward)
        outs = traced(*inputs)
        return outs, TracedLayer(layer, traced, inputs)

    def __call__(self, *inputs):
        return self._traced(*inputs)

    def save_inference_model(self, path, feed=None, fetch=None, **kwargs):
        save(self._layer, path, input_spec=self._inputs)
