"""``paddle.summary`` and ``paddle.flops`` (a port of
``paddle_tpu/hapi/summary.py``): the parameter table of a network's leaf
layers, and an analytic FLOP count per leaf layer from one eval forward
of zeros. ``summary``'s ``input_size``, ``dtypes`` and ``input`` are
taken and not read, as in the reference."""
import numpy as np


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    rows = []
    total_params = 0
    trainable_params = 0
    for name, layer in net.named_sublayers(include_self=True):
        n_params = sum(p.size for p in layer._parameters.values()
                       if p is not None)
        n_train = sum(p.size for p in layer._parameters.values()
                      if p is not None and p.trainable)
        if not layer._sub_layers:  # leaf layers only in the table
            rows.append((name or type(layer).__name__,
                         type(layer).__name__, n_params))
        total_params += n_params
        trainable_params += n_train
    width = max([len(r[0]) for r in rows] + [10]) + 2
    lines = [f"{'Layer':<{width}}{'Type':<24}{'Params':>12}",
             "-" * (width + 36)]
    for name, typ, n in rows:
        lines.append(f"{name:<{width}}{typ:<24}{n:>12,}")
    lines.append("-" * (width + 36))
    lines.append(f"Total params: {total_params:,}")
    lines.append(f"Trainable params: {trainable_params:,}")
    print("\n".join(lines))
    return {"total_params": total_params,
            "trainable_params": trainable_params}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Analytic FLOPs of one forward, counted per leaf layer from its
    hyper-parameters and output shape (conv, linear, the norms,
    activations, pools); ``custom_ops`` maps a layer class to
    ``fn(layer, inputs, output)`` returning its FLOPs."""
    from .. import nn
    from ..core.dispatch import no_grad
    from ..ops.creation import zeros

    if isinstance(input_size, (list, tuple)) and input_size and \
            isinstance(input_size[0], int):
        shapes = [tuple(input_size)]
    else:
        shapes = [tuple(s) for s in input_size]

    total = 0
    rows = []
    # a forward with hooks learns each leaf layer's output shape
    xs = [zeros(list(s)) for s in shapes]
    records = []

    hooks = []

    def make_hook(layer):
        def hook(lyr, inputs, output):
            records.append((lyr, inputs, output))
        return hook

    for _, layer in net.named_sublayers(include_self=True):
        if not layer._sub_layers:
            hooks.append(layer.register_forward_post_hook(make_hook(layer)))
    was_training = net.training
    net.eval()
    try:
        with no_grad():
            net(*xs)
    finally:
        if was_training:
            net.train()
        for h in hooks:
            h.remove()

    for layer, inputs, output in records:
        f = 0
        out = output[0] if isinstance(output, (list, tuple)) else output
        o_numel = int(np.prod(out.shape)) if hasattr(out, "shape") else 0
        if custom_ops and type(layer) in custom_ops:
            f = custom_ops[type(layer)](layer, inputs, output)
        elif isinstance(layer, nn.Conv2D):
            kh, kw = layer._kernel_size
            cin = layer._in_channels
            f = o_numel * cin // layer._groups * kh * kw * 2
        elif isinstance(layer, nn.Linear):
            f = o_numel * layer.weight.shape[0] * 2
        elif isinstance(layer, (nn.BatchNorm2D, nn.BatchNorm1D, nn.BatchNorm,
                                nn.LayerNorm)):
            f = o_numel * 2
        elif isinstance(layer, (nn.ReLU, nn.Sigmoid, nn.Tanh, nn.GELU)):
            f = o_numel
        elif isinstance(layer, (nn.AvgPool2D, nn.MaxPool2D,
                                nn.AdaptiveAvgPool2D)):
            f = o_numel
        total += f
        if print_detail:
            rows.append((type(layer).__name__, f))
    if print_detail:
        for name, f in rows:
            print(f"{name:<28}{f:>16,}")
    print(f"Total Flops: {total}")
    return total
