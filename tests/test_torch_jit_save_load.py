"""paddle_tpu_torch's ``jit.save`` / ``jit.load`` against the JAX
package's on the CPU: each model built in both packages (the reference's
weights carried into the port's layer of the same structure), saved and
loaded in each, the loaded outputs compared with each other and with the
layer (rtol 1e-5; f32 sums in another order).

Programs do not cross between the packages (the reference's
``.pdmodel`` is jax.export's StableHLO; the port's is its static
``Program``): the port's ``jit.load`` of a reference file raises naming
that. Parameters do: either package's ``.pdiparams`` loads into the
other's layer. A loaded model reads every parameter from its
``.pdiparams``, the position embedding too (a lookup on no input, which
the port records because ``jit.save`` binds every parameter to a
Variable). ``TracedLayer.save_inference_model`` raises in the reference
(it saves with no input spec) and saves in the port.
"""
import os
import pickle
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod
from test_torch_deploy_cuda import surface_gpt

RTOL, ATOL = 1e-5, 1e-6
PACKAGES = (ref, paddle)


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def carry(src, dst):
    """The reference layer ``src``'s state dict (numpy) into the port's
    ``dst`` of the same structure."""
    sd = {k: np.asarray(v.numpy()) for k, v in src.state_dict().items()}
    assert list(sd) == list(dst.state_dict()), (list(sd)[:6],
                                                list(dst.state_dict())[:6])
    assert dst.set_state_dict(sd) == []


def _gpt_cfg():
    from paddle_tpu.text.models import TransformerLMConfig
    return TransformerLMConfig(vocab_size=128, hidden_size=32, num_layers=2,
                               num_heads=2, max_seq_len=16, dropout=0.0)


def _pair(build, seed=0):
    """``build(P)`` in both packages, the reference's weights in the
    port's, both in eval mode."""
    ref.seed(seed)
    r = build(ref)
    r.eval()
    p = build(paddle)
    carry(r, p)
    p.eval()
    return r, p


def _gpt_pair():
    from paddle_tpu.text.models import GPTForCausalLM
    cfg = _gpt_cfg()
    return _pair(lambda P: GPTForCausalLM(cfg) if P is ref
                 else surface_gpt(paddle, cfg))


def _mlp(P):
    nn = P.nn
    return nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Linear(8, 3))


def _conv(P):
    nn = P.nn
    return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.ReLU(),
                         nn.MaxPool2D(2, 2), nn.Flatten(),
                         nn.Linear(4 * 4 * 4, 5))


def _save_both(r, p, tmp_path, tag, spec):
    """Save the pair in each package under ``tag``; returns the paths."""
    paths = {}
    for P, layer in ((ref, r), (paddle, p)):
        paths[P] = str(tmp_path / f"{tag}_{P.__name__}")
        P.jit.save(layer, paths[P], input_spec=[
            P.static.InputSpec(list(s), dt) for s, dt in spec])
    return paths


def _run(P, layer, x):
    return layer(P.to_tensor(x)).numpy()


def test_jit_save_dynamic_batch_dim(tmp_path):
    """The reference's case (InputSpec([None, 6])): any batch size
    through the loaded program, in both packages."""
    r, p = _pair(_mlp)
    paths = _save_both(r, p, tmp_path, "dyn", [((None, 6), "float32")])
    lr, lp = ref.jit.load(paths[ref]), paddle.jit.load(paths[paddle])
    for bs in (1, 2, 7):
        x = np.random.RandomState(bs).randn(bs, 6).astype("float32")
        want = _run(paddle, p, x)
        got = _run(paddle, lp, x)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got, _run(ref, lr, x), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(_run(ref, lr, x), _run(ref, r, x),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["conv", "gpt"])
def test_save_load_in_both_packages(tmp_path, kind):
    """A conv net at a fixed shape; the 2-layer GPT with a free batch:
    the port's program takes any batch (the dims that follow the feed's
    -1 stay -1 while it records), the reference's jax.export of it falls
    back to the example shape (batch 1, with its warning), so the two
    loaded models meet at batch 1."""
    if kind == "conv":
        r, p = _pair(_conv, seed=1)
        spec = [((2, 3, 8, 8), "float32")]
        xs = [np.random.RandomState(1).randn(2, 3, 8, 8).astype("float32")]
    else:
        r, p = _gpt_pair()
        spec = [((None, 16), "int64")]
        xs = [np.random.RandomState(2).randint(0, 128, (b, 16)).astype(
            "int64") for b in (1, 3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        paths = _save_both(r, p, tmp_path, kind, spec)
    lr, lp = ref.jit.load(paths[ref]), paddle.jit.load(paths[paddle])
    for x in xs:
        np.testing.assert_allclose(_run(paddle, lp, x), _run(paddle, p, x),
                                   rtol=RTOL, atol=ATOL)
    x = xs[0]
    got = _run(paddle, lp, x)
    np.testing.assert_allclose(got, _run(ref, lr, x), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_run(ref, lr, x), _run(ref, r, x),
                               rtol=RTOL, atol=ATOL)
    # the loaded layer's state dict: the structured names, the values
    sd = lp.state_dict()
    assert list(sd) == list(p.state_dict())
    for k, v in p.state_dict().items():
        np.testing.assert_array_equal(sd[k].numpy(), v.numpy())
    assert lp.eval() is lp
    with pytest.raises(RuntimeError, match="inference-only"):
        lp.train()


def test_pdmodel_holds_no_parameter_values(tmp_path):
    r, p = _gpt_pair()
    path = str(tmp_path / "gpt")
    paddle.jit.save(p, path, input_spec=[paddle.static.InputSpec(
        [None, 16], "int64")])
    with open(path + ".pdmodel", "rb") as f:
        blob = pickle.load(f)
    with open(path + ".pdmeta", "rb") as f:
        meta = pickle.load(f)
    assert meta["num_inputs"] == 1
    assert meta["param_names"] == list(p.state_dict())
    pnames = set(meta["program_names"].values())
    assert pnames and pnames <= set(blob["persist"])
    for n in pnames:
        assert blob["persist"][n][0] is None, n
        assert blob["vars"][n][0] == list(p.state_dict()[
            next(s for s, q in meta["program_names"].items() if q == n)].shape)
    # the constants kept in the program (the position ids) are small
    kept = sum(np.asarray(v[0]).nbytes for n, v in blob["persist"].items()
               if n not in pnames)
    assert kept <= 16 * 8
    assert os.path.getsize(path + ".pdmodel") < os.path.getsize(
        path + ".pdiparams")


def test_pdiparams_cross_between_packages(tmp_path):
    r, p = _gpt_pair()
    paths = _save_both(r, p, tmp_path, "x", [((None, 16), "int64")])
    from paddle_tpu.text.models import GPTForCausalLM
    ref.seed(5)
    r2 = GPTForCausalLM(_gpt_cfg())
    r2.eval()
    paddle.seed(5)
    p2 = surface_gpt(paddle, _gpt_cfg())
    p2.eval()
    # the port's file into the reference's layer, and the reverse
    assert r2.set_state_dict(ref.load(paths[paddle] + ".pdiparams")) == []
    assert p2.set_state_dict(paddle.load(paths[ref] + ".pdiparams")) == []
    x = np.random.RandomState(3).randint(0, 128, (2, 16)).astype("int64")
    np.testing.assert_allclose(_run(ref, r2, x), _run(ref, r, x),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_run(paddle, p2, x), _run(paddle, p, x),
                               rtol=RTOL, atol=ATOL)


def test_reference_pdmodel_raises_clearly(tmp_path):
    r, _ = _pair(_mlp)
    path = str(tmp_path / "refmodel")
    ref.jit.save(r, path, input_spec=[ref.static.InputSpec([2, 6],
                                                           "float32")])
    with pytest.raises(ValueError, match="StableHLO"):
        paddle.jit.load(path)


def test_position_embedding_read_from_pdiparams(tmp_path):
    """The stale-parameter trap: change the position embedding in a
    saved .pdiparams; the loaded model gives the eager model's logits
    with that change, in both packages (batch 1: the reference's GPT
    program is saved at its example shape)."""
    r, p = _gpt_pair()
    paths = _save_both(r, p, tmp_path, "pos", [((None, 16), "int64")])
    x = np.random.RandomState(4).randint(0, 128, (1, 16)).astype("int64")
    key = "gpt.position_embeddings.weight"
    for P, layer in ((ref, r), (paddle, p)):
        before = _run(P, layer, x)
        sd = P.load(paths[P] + ".pdiparams")
        new = np.asarray(sd[key]) + np.random.RandomState(8).randn(
            *np.shape(sd[key])).astype("float32")
        sd[key] = new
        P.save(sd, paths[P] + ".pdiparams")
        loaded = P.jit.load(paths[P])
        layer.gpt.position_embeddings.weight.set_value(new)
        want = _run(P, layer, x)
        assert np.abs(want - before).max() > 1e-3
        np.testing.assert_allclose(_run(P, loaded, x), want, rtol=RTOL,
                                   atol=ATOL)


def test_traced_layer_save_inference_model(tmp_path):
    """The reference's TracedLayer.save_inference_model passes no input
    spec to jit.save and raises; the port saves with the inputs given
    to trace(), as the reference's docstring promises."""
    x = np.random.RandomState(6).randn(2, 4).astype("float32")
    ref.seed(0)
    r = ref.nn.Sequential(ref.nn.Linear(4, 3))
    _, traced = ref.jit.TracedLayer.trace(r, [ref.to_tensor(x)])
    with pytest.raises(ValueError, match="input_spec"):
        traced.save_inference_model(str(tmp_path / "ref_traced"))
    p = paddle.nn.Sequential(paddle.nn.Linear(4, 3))
    carry(r, p)
    outs, traced = paddle.jit.TracedLayer.trace(p, [paddle.to_tensor(x)])
    path = str(tmp_path / "traced")
    traced.save_inference_model(path)
    loaded = paddle.jit.load(path)
    np.testing.assert_allclose(_run(paddle, loaded, x), outs.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs.numpy(), _run(ref, r, x), rtol=RTOL,
                               atol=ATOL)


def test_feed_with_a_wrong_fixed_dim_raises(tmp_path):
    p = _mlp(paddle)
    path = str(tmp_path / "m")
    paddle.jit.save(p, path, input_spec=[paddle.static.InputSpec(
        [None, 6], "float32")])
    loaded = paddle.jit.load(path)
    with pytest.raises(ValueError, match="'x0': dim 1 is 5"):
        loaded(paddle.to_tensor(np.zeros((2, 5), "float32")))
    with pytest.raises(ValueError, match="rank"):
        loaded(paddle.to_tensor(np.zeros((6,), "float32")))
    with pytest.raises(ValueError, match="dtype"):
        loaded(paddle.to_tensor(np.zeros((2, 6), "float64")))


def test_torch_module_refused(tmp_path):
    """A torch.nn.Module goes through torch.export
    (tests/test_torch_jit_save_module.py); refused are a module without
    an input_spec and an object that is neither a Layer nor a Module."""
    from paddle_tpu_torch.text.models import GPTForCausalLM, TransformerLMConfig
    m = GPTForCausalLM(TransformerLMConfig(vocab_size=64, hidden_size=32,
                                           num_layers=1, num_heads=2,
                                           max_seq_len=8), device="cpu")
    with pytest.raises(ValueError, match="input_spec"):
        paddle.jit.save(m, str(tmp_path / "t"))
    with pytest.raises((TypeError, AttributeError)):
        paddle.jit.save(object(), str(tmp_path / "o"), input_spec=[
            paddle.static.InputSpec([1, 8], "int64")])


def test_static_inference_model_and_jit_files_cross(tmp_path):
    """static.load_inference_model reads a jit.save model (its values
    from the .pdiparams), and jit.load reads a static program saved by
    static.save_inference_model (its values in the .pdmodel)."""
    p = _mlp(paddle)
    p.eval()
    x = np.random.RandomState(7).randn(3, 6).astype("float32")
    want = _run(paddle, p, x)
    path = str(tmp_path / "j")
    paddle.jit.save(p, path, input_spec=[paddle.static.InputSpec(
        [None, 6], "float32")])
    prog, feeds, fetch = paddle.static.load_inference_model(path)
    exe = paddle.static.Executor(paddle.CPUPlace())
    got, = exe.run(prog, feed={feeds[0]: x}, fetch_list=fetch)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    paddle.enable_static()
    try:
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            xv = paddle.static.data("x", [None, 6], "float32")
            out = p(xv)
        spath = str(tmp_path / "s")
        paddle.static.save_inference_model(spath, [xv], [out], program=main)
    finally:
        paddle.disable_static()
    loaded = paddle.jit.load(spath)
    np.testing.assert_allclose(_run(paddle, loaded, x), want, rtol=RTOL,
                               atol=ATOL)


def test_set_state_dict_calls_after_load_hook():
    """The repair: Layer.set_state_dict calls each sublayer's
    _after_load_state_dict, as the reference's does."""
    calls = {}
    for P in PACKAGES:
        class Hooked(P.nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = P.nn.Linear(2, 2)
                self.seen = None

            def _after_load_state_dict(self):
                self.seen = self.fc.weight.numpy().copy()

        outer = P.nn.Sequential(Hooked())
        sd = {k: np.full(v.shape, 3.0, "float32")
              for k, v in outer.state_dict().items()}
        outer.set_state_dict(sd)
        calls[P] = outer[0].seen
    np.testing.assert_array_equal(calls[paddle], calls[ref])
    assert calls[paddle] is not None and (calls[paddle] == 3.0).all()


def test_the_import_boundary_walks_the_new_modules():
    """test_torch_gpt.py's boundary test walks every module of the
    package: the deployment modules are among them, and none imports JAX
    or the reference."""
    from test_torch_gpt import REPO, _imports
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    for module in ("version.py", "jit/save_load.py", "jit/__init__.py",
                   "inference/__init__.py", "quantization/__init__.py",
                   "onnx.py", "onnx_proto/__init__.py",
                   "onnx_proto/paddle_tpu_onnx_pb2.py",
                   "device/__init__.py", "device/cuda.py"):
        path = REPO / "paddle_tpu_torch" / module
        assert path in files, module
        bad = [n for n in _imports(path) if n.split(".")[0] in
               ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")]
        assert not bad, (module, bad)
