"""Pipeline layer declaration (a port of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``).

``LayerDesc`` builds a layer when the ``PipelineLayer`` is made;
``SharedLayerDesc`` builds one layer for every item with its key (a tied
embedding, say), which both ends of the pipeline then use. The items are
Paddle-surface ``Layer``s or plain callables, as the reference's.
``PipelineLayer`` keeps the reference's segmentation
(``_segment``: ``seg_method="uniform"`` or balanced by parameter count)
and its ``forward_stage``/``apply_items``/``loss``;
``PipelineParallel`` (``parallel_wrappers.py``) runs it one stage a rank,
its homogeneous run of blocks split over the ``pp`` group.
"""
import numpy as np

from ....nn.layer.container import LayerList
from ....nn.layer_base import Layer


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """Reference pp_layers.py:62: a layer shared between stages (e.g. a
    tied embedding); every item with the same ``key`` is the same
    layer, called through ``forward_func(layer, x)`` when given."""

    def __init__(self, key, layer_cls, forward_func=None, shared_weight_attr
                 ="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def param_count(layer):
    """The number of parameter elements of a surface ``Layer``."""
    return sum(int(p._value.numel()) for p in layer.parameters())


class PipelineLayer(Layer):
    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self._seg_method = seg_method
        self._recompute_interval = recompute_interval
        self._shared = {}
        built = []
        for item in layers:
            if isinstance(item, SharedLayerDesc):
                if item.layer_name in self._shared:
                    layer = self._shared[item.layer_name]
                else:
                    layer = item.build_layer()
                    self._shared[item.layer_name] = layer
                built.append((layer, item.forward_func))
            elif isinstance(item, LayerDesc):
                built.append((item.build_layer(), None))
            elif isinstance(item, Layer):
                built.append((item, None))
            elif callable(item):
                built.append((item, "fn"))
            else:
                raise TypeError(f"bad pipeline item {item!r}")
        self.run_function = built
        self._layers_list = LayerList(
            [l for l, tag in built if isinstance(l, Layer)])
        self._segments = self._segment(built, self._num_stages)

    def _segment(self, built, num_stages):
        """Reference pp_layers.py:76 — uniform or by parameter count."""
        n = len(built)
        if self._seg_method == "uniform" or num_stages == 1:
            bounds = np.linspace(0, n, num_stages + 1).astype(int)
        else:   # "layer:param" style: balance by parameter count
            weights = [param_count(l) + 1 if isinstance(l, Layer) else 1
                       for l, _ in built]
            cum = np.cumsum(weights)
            total = cum[-1]
            bounds = [0]
            for s in range(1, num_stages):
                bounds.append(int(np.searchsorted(cum,
                                                  total * s / num_stages)))
            bounds.append(n)
            bounds = np.asarray(bounds)
        return [(int(bounds[i]), int(bounds[i + 1]))
                for i in range(num_stages)]

    def get_num_stages(self):
        return self._num_stages

    def stage_segments(self):
        return self._segments

    @staticmethod
    def apply_items(items, x):
        """Run a sequence of (layer, tag) items — the one dispatch point
        for a stage and for the pipeline's segmentation."""
        for layer, tag in items:
            if tag is not None and tag != "fn" and callable(tag):
                x = tag(layer, x)
            else:
                x = layer(x)
        return x

    def forward_stage(self, x, stage):
        lo, hi = self._segments[stage]
        return self.apply_items(self.run_function[lo:hi], x)

    def forward(self, x):
        for stage in range(self._num_stages):
            x = self.forward_stage(x, stage)
        return x

    def loss(self, output, label):
        if self._loss_fn is None:
            return output
        return self._loss_fn(output, label)
