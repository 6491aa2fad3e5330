"""``paddle.jit`` (a port of ``paddle_tpu/jit/__init__.py``): ``to_static``
(whole-step CUDA-graph capture, ``to_static.py``, after the dy2static
conversion of ``dy2static.py``), ``not_to_static``,
``ProgramTranslator``, ``set_code_level``/``set_verbosity`` and
``TracedLayer``. ``jit.save``/``jit.load`` (``jit/save_load.py``) are not
ported yet: ``TracedLayer.save_inference_model`` raises."""
from ..core.trace import ToStaticError  # noqa: F401
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
    and replay the captured step."""

    def __init__(self, layer, traced):
        self._layer = layer
        self._traced = traced

    @staticmethod
    def trace(layer, inputs):
        traced = to_static(layer.forward)
        outs = traced(*inputs)
        return outs, TracedLayer(layer, traced)

    def __call__(self, *inputs):
        return self._traced(*inputs)

    def save_inference_model(self, path, feed=None, fetch=None, **kwargs):
        raise NotImplementedError(
            "TracedLayer.save_inference_model needs jit.save, which is not "
            "ported yet (paddle_tpu/jit/save_load.py)")
