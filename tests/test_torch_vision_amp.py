"""paddle_tpu_torch's vision path under ``auto_cast`` against the JAX
package's on the CPU: the dtype of every sublayer's output of a
``resnet18`` under O1 and O2, its loss, its grads' dtypes and its running
statistics. The reference casts at its dispatcher by op name: under O2
the float inputs of every op off its black list, ``batch_norm_train``
and ``batch_norm_infer`` included (their names are not the black list's
``batch_norm``), under O1 those of the white list's ``conv2d`` and
``linear`` alone, where a batch norm's f32 scale then promotes a bf16 x
to f32. The port's ops carry the same names through ``cast_inputs``.

bf16 activations: the loss within 2e-2 relative, the running statistics
within 2e-2.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def _dtype_map(P, model, x, y, level):
    seen = []
    for name, layer in model.named_sublayers():
        layer.register_forward_post_hook(
            lambda lay, inp, out, name=name: seen.append(
                (name, out.dtype.name)))
    with P.amp.auto_cast(level=level, dtype="bfloat16"):
        out = model(P.to_tensor(x))
        loss = P.nn.CrossEntropyLoss()(out, P.to_tensor(y))
    loss.backward()
    grads = {n: p.grad.dtype.name for n, p in model.named_parameters()}
    stats = {k: v.numpy() for k, v in model.state_dict().items()
             if k.endswith(("_mean", "_variance"))}
    return (seen, out.dtype.name, loss.dtype.name,
            float(P.cast(loss, "float32").numpy()), grads, stats)


@pytest.mark.parametrize("level", ["O1", "O2"])
def test_auto_cast_dtype_of_every_layer(level):
    """Under O2 the convs, batch norms, pools and the head are bf16;
    under O1 the convs and the head are bf16 and the batch norms f32.
    The grads are f32 (the weights are f32, the casts recorded) and the
    running statistics stay f32."""
    ref.seed(0)
    r = ref.vision.models.resnet18(num_classes=10)
    t = paddle.vision.models.resnet18(num_classes=10)
    assert t.set_state_dict({k: np.asarray(v.numpy())
                             for k, v in r.state_dict().items()}) == []
    rs = np.random.RandomState(5)
    x = rs.randn(4, 3, 64, 64).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.int64)
    (rseen, rout, rld, rloss, rgr, rst), (tseen, tout, tld, tloss, tgr,
                                          tst) = (
        _dtype_map(P, m, x, y, level) for P, m in ((ref, r), (paddle, t)))
    assert tseen == rseen
    assert (tout, tld) == (rout, rld)
    assert tgr == rgr and set(tgr.values()) == {"float32"}
    kinds = dict(tseen)
    low = "bfloat16"
    assert kinds["conv1"] == low and kinds["fc"] == low
    assert kinds["bn1"] == (low if level == "O2" else "float32")
    assert kinds["maxpool"] == (low if level == "O2" else "float32")
    np.testing.assert_allclose(tloss, rloss, rtol=2e-2)
    for k in rst:
        assert tst[k].dtype == np.float32
        np.testing.assert_allclose(tst[k], rst[k], rtol=2e-2, atol=2e-2)
