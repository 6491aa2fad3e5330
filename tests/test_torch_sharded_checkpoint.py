"""Sharded checkpoints in the port (incubate/checkpoint/sharded.py, over
torch.distributed.checkpoint) against the reference's contract
(tests/test_sharded_checkpoint.py): a round trip in place, overwrite,
missing keys and shapes refused before anything is read, the async
saver; then across topologies over two gloo rank processes
(tests/torch_dist_worker.py, suite ``ckpt``, about 15 s): a tiny GPT at
mp = 2 saves its shards and one process loads them whole (the reference's
weights, bit for bit); the ranks load a whole checkpoint into their
shards (convert.tp_state_dict_from_paddle_tpu's cut, bit for bit); ZeRO-2
ranks save their train state, each its partition, and one process loads
the parameters and every optimizer state tensor, bit for bit, and resumes
(the next step's loss equal to the ranks' next loss). The files are DCP's,
not orbax's: the packages share values, not checkpoint files.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.text.models import GPTForCausalLM, TransformerLMConfig

from _torch_dist import run_ranks
from torch_dist_worker import TINY_GPT, zero_batch
from paddle_tpu_torch import optimizer as port_opt
from paddle_tpu_torch.incubate.checkpoint import sharded
from paddle_tpu_torch.text import convert, models


def _np(t):
    return np.asarray(t.numpy())


def _dense(ref):
    m = models.GPTForCausalLM(models.TransformerLMConfig(**TINY_GPT),
                              device="cpu")
    m.load_state_dict(convert.state_dict_from_paddle_tpu(ref))
    return m


def test_roundtrip_plain(tmp_path):
    lin = torch.nn.Linear(6, 4)
    sharded.save_sharded(dict(lin.named_parameters()), tmp_path / "c")
    other = torch.nn.Linear(6, 4)
    vals = sharded.load_sharded(tmp_path / "c",
                                target=dict(other.named_parameters()))
    assert sorted(vals) == ["bias", "weight"]
    for k, p in lin.named_parameters():
        assert torch.equal(p, dict(other.named_parameters())[k])


def test_overwrite_and_missing_keys(tmp_path):
    a = {"w": torch.ones(3)}
    sharded.save_sharded(a, tmp_path / "c")
    sharded.save_sharded({"w": torch.full((3,), 2.0)}, tmp_path / "c")
    assert torch.equal(sharded.load_sharded(tmp_path / "c")["w"],
                       torch.full((3,), 2.0))
    with pytest.raises(KeyError, match="no entries"):
        sharded.load_sharded(tmp_path / "c", target={"v": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        sharded.load_sharded(tmp_path / "c", target={"w": torch.zeros(4)})


def test_async_saver_overlaps(tmp_path):
    saver = sharded.AsyncShardedSaver()
    state = {"w": torch.arange(12.0).reshape(3, 4)}
    saver.save(state, tmp_path / "a")
    state2 = {"w": torch.arange(12.0).reshape(3, 4) * 2}
    saver.save(state2, tmp_path / "b")      # joins the first
    saver.close()
    assert torch.equal(sharded.load_sharded(tmp_path / "a")["w"],
                       state["w"])
    assert torch.equal(sharded.load_sharded(tmp_path / "b")["w"],
                       state2["w"])


def test_train_state_without_sidecar_is_refused(tmp_path):
    lin = torch.nn.Linear(3, 2)
    opt = port_opt.AdamW(1e-3, parameters=lin.named_parameters())
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    sharded.save_sharded_train_state(dict(lin.named_parameters()), opt,
                                     tmp_path / "t")
    (tmp_path / "t_meta.json").unlink()
    with pytest.raises(FileNotFoundError, match="sidecar"):
        sharded.load_sharded_train_state(tmp_path / "t",
                                         dict(lin.named_parameters()), opt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    paddle.seed(41)
    ref = {k: _np(v) for k, v in GPTForCausalLM(
        TransformerLMConfig(**TINY_GPT)).state_dict().items()}
    root = tmp_path_factory.mktemp("ckpt")
    sharded.save_sharded(dict(_dense(ref).named_parameters()),
                         root / "dense")
    inputs = {f"ckpt.{k}": v for k, v in ref.items()}
    inputs["ckptdir"] = np.array(str(root))
    lines, arrays = run_ranks("ckpt", 2, tmp_path_factory.mktemp("ranks"),
                              inputs)
    return ref, root, lines, arrays


def test_tp_shards_load_whole_in_one_process(runs):
    ref, root, _, _ = runs
    m = _dense({k: np.zeros_like(v) for k, v in ref.items()})
    sharded.load_sharded(root / "tp", dict(m.named_parameters()))
    got = convert.state_dict_to_paddle_tpu(
        {k: v.detach() for k, v in m.named_parameters()})
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_whole_checkpoint_loads_into_tp_shards(runs):
    ref, _, _, arrays = runs
    for r, a in enumerate(arrays):
        want = convert.tp_state_dict_from_paddle_tpu(ref, r, 2)
        for k, v in want.items():
            np.testing.assert_array_equal(a[f"loaded.{k}"], v.numpy(),
                                          err_msg=f"rank {r} {k}")


def test_zero_train_state_loads_in_one_process(runs):
    """The two ZeRO ranks' checkpoint at world 1: every parameter and
    every state tensor of both partitions, bit for bit; a step resumed
    from it gives the step the ranks would take (the ranks' mean loss at
    step 3 is the one-process loss, as the ZeRO tests hold)."""
    ref, root, lines, arrays = runs
    m = _dense(ref)
    opt = port_opt.AdamW(1e-3, parameters=m.named_parameters())
    sharded.load_sharded_train_state(root / "zero",
                                     dict(m.named_parameters()), opt)
    for k, p in m.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      arrays[0][f"zero.param.{k}"])
    names = {id(p): k for k, p in m.named_parameters()}
    got = {f"{names[pid]}_{kind}": t.numpy()
           for kind, store in opt._accumulators.items()
           for pid, t in store.items()}
    want = {}
    for a in arrays:
        want.update({k[len("zero.opt."):]: v for k, v in a.items()
                     if k.startswith("zero.opt.")})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert sum(line["state_bytes"] for line in lines) == sum(
        v.nbytes for v in want.values())
    ids, labels = (torch.from_numpy(a) for a in zero_batch())
    loss = m(ids, labels=labels)
    loss.backward()
    opt.step()
    assert np.isfinite(loss.item())


@pytest.fixture
def on_cpu():
    """The port's current place is the CPU for the test, unset after (a
    place left set would reach later tests in the same worker)."""
    import paddle_tpu_torch as port
    from paddle_tpu_torch.core import device as device_mod
    port.set_device("cpu")
    yield
    device_mod._current_place = None


def test_save_runs_the_pending_lazy_graph(tmp_path, on_cpu):
    """A surface layer's SGD step deferred by lazy eager, then saved at
    once: the file holds the stepped weights (the reference's _to_arrays
    flushes its LazyArrays the same way)."""
    import paddle_tpu_torch as port
    from paddle_tpu_torch.core import lazy
    lin = port.nn.Linear(3, 2)
    before = lin.bias.numpy().copy()
    opt = port.optimizer.SGD(0.5, parameters=lin.parameters())
    loss = lin(port.to_tensor(np.ones((4, 3), np.float32))).sum()
    loss.backward()
    opt.step()
    assert lazy.enabled()
    sharded.save_sharded(lin.state_dict(), tmp_path / "s")
    got = sharded.load_sharded(tmp_path / "s")
    for k, p in lin.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), p.numpy(), err_msg=k)
    # the step ran: the bias moved by 0.5 x its grad (4 rows: 4)
    np.testing.assert_allclose(got["bias"].numpy(), before - 2.0)
