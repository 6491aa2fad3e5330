"""Parallel model wrappers (a port of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_wrappers.py``).

``TensorParallel`` (reference meta_parallel/tensor_parallel.py): at
construction the parameters that every ``mp`` rank holds whole are
broadcast from the ``mp`` group's first rank, and every parameter from
the first rank of the ``dp`` and ``sp`` groups; after each backward the
grads are summed over ``sp`` and averaged over ``dp``
(``parallel.GradSync``). The split parameters need no sync over ``mp``:
each rank's grad of its shard is whole, the ``_c_identity`` /
``_mp_allreduce`` pairs of the layers having summed what crosses ranks.

``ShardingParallel`` (reference sharding_parallel.py): the parameters
broadcast from the first rank of the ``sharding`` and ``dp`` groups, the
grads averaged over ``dp`` after each backward; the ``sharding`` group's
reduction and the partitioned update are the optimizer's
(``distributed.sharding``). With ``sharding_configs["stage"] == 3`` the
parameters are partitioned too (``p_g_os``: gathered on use).

``PipelineParallel`` (reference :118-160, 360-395): one stage a rank of
the ``pp`` group. The model is cut as the reference cuts it: its
``pp_segments()`` (``pre``, ``blocks``, ``post``), or a
``PipelineLayer``'s longest run of alike blocks with what precedes it as
``pre`` and what follows (and the loss) as ``post``, its
``recompute_interval`` blocks at a time recomputed in the backward
(``utils_recompute``). Stage ``s`` holds
the blocks ``np.array_split(range(L), pp)[s]`` (the reference's grouping;
uneven counts need no padded slots), the first stage runs ``pre``, the
last ``post``. ``train_batch`` splits the batch into
``pipeline_configs["accumulate_steps"]`` microbatches and runs them by
1F1B (``distributed.pipeline.run_schedule``); the loss comes back on
every rank. The reference runs ``post`` once on the whole batch, whose
loss is a mean over the batch's kept tokens, so each microbatch's loss
(and grad) is weighted by its share of those tokens (``count`` of the
segments; equal shares without one). Every rank builds the whole model;
all parameters are broadcast from the first stage at construction, then
each stage frees the storage of every parameter it does not run (the
other stages' blocks, ``pre`` off the first, ``post`` off the last), so
it holds its share of the weights, and updates the parameters it runs.
``full_state_dict`` gathers the whole model. A parameter both ends use (the
tied embedding) has a copy on the first and on the last stage: before
each step their grads are summed over a group of those two ranks
(Paddle's ``SharedLayerDesc`` weight sync), so the copies stay equal,
and the clip counts it once (``HybridParallelClipGrad`` sums the norm
over ``pp``). Divergences: the reference's one SPMD program becomes a
process per stage, and dropout streams under ``pp`` are each rank's own
(the reference splits one key per block).
"""
import numpy as np
import torch

from ....nn.layer_base import Layer
from ... import collective
from ...parallel import GradSync, Wrapper, sync_params, torch_leaves
from ...sharding import _free
from .mp_layers import split_of


class _MetaParallelBase(Wrapper):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers)
        self._hcg = hcg
        self._strategy = strategy


class TensorParallel(_MetaParallelBase):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        params = torch_leaves(layers)
        mp = hcg.get_model_parallel_group()
        dp = hcg.get_data_parallel_group()
        sp = hcg.get_sequence_parallel_group()
        whole = [p for p in params if split_of(p) is None]
        sync_params(whole, [(mp, mp.ranks[0])])
        sync_params(params, [(dp, dp.ranks[0]), (sp, sp.ranks[0])])
        self._grad_sync = GradSync(params, avg_group=dp, sum_group=sp)


class ShardingParallel(_MetaParallelBase):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        from ...sharding import level_of, partition_model
        params = torch_leaves(layers)
        sh = hcg.get_sharding_parallel_group()
        dp = hcg.get_data_parallel_group()
        sync_params(params, [(sh, sh.ranks[0]), (dp, dp.ranks[0])])
        self._grad_sync = GradSync(params, avg_group=dp)
        partition_model(layers, sh, level_of(strategy))

    def full_state_dict(self):
        """The state dict with every parameter whole (at ``p_g_os`` each
        gathered from its owner); every rank of the group must call it."""
        from ...sharding import gathered
        with gathered(self._layers):
            return {k: v.detach().clone()
                    for k, v in self._layers.state_dict().items()}


# ------------------------------------------------------------- pipeline

def _layer_signature(layer):
    """Two layers stack in the pipeline's block run iff their class and
    their state's names, shapes and dtypes agree."""
    if not isinstance(layer, (Layer, torch.nn.Module)):
        return None
    sig = tuple(sorted((k, tuple(getattr(v, "shape", ())),
                        str(getattr(v, "dtype", "")))
                       for k, v in layer.state_dict().items()))
    return (type(layer).__name__, sig)


def _leaves_of(items):
    out = []
    for layer, _ in items:
        if hasattr(layer, "parameters"):
            out.extend(getattr(p, "_value", p) for p in layer.parameters())
    return out


def _segments_from_pipeline_layer(model):
    """Reference :156-200: the longest contiguous run of alike blocks
    that hold state is pipelined; what precedes it is ``pre``, what
    follows it and the loss ``post``."""
    items = model.run_function
    sigs = [_layer_signature(l) for l, _ in items]
    best, i = (0, 0), 0
    while i < len(items):
        if sigs[i] is None or not sigs[i][1]:
            i += 1
            continue
        j = i
        while j < len(items) and sigs[j] == sigs[i]:
            j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    lo, hi = best
    if hi - lo < 2:
        raise ValueError(
            "PipelineLayer has no homogeneous block run to pipeline")
    pre_items, block_items, post_items = items[:lo], items[lo:hi], \
        items[hi:]
    run = type(model).apply_items
    segs = {"pre": lambda x: run(pre_items, x),
            "blocks": [l for l, _ in block_items],
            "post": lambda h, label: model.loss(run(post_items, h), label),
            "pre_params": _leaves_of(pre_items),
            "post_params": _leaves_of(post_items)}
    every = int(model._recompute_interval or 0)
    if every > 0:
        segs["recompute_interval"] = every
    return segs


def _surface(model):
    return isinstance(model, Layer)


class PipelineParallel(_MetaParallelBase):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, hcg, strategy)
        self._acc_steps = 1
        if strategy is not None:
            self._acc_steps = int(strategy.pipeline_configs.get(
                "accumulate_steps", 1))
        self._segs = segs = self._segments()
        pp = self._pp = hcg.get_pipe_parallel_group()
        self._stage, self._n = pp.rank, pp.nranks
        blocks = segs["blocks"]
        groups = np.array_split(np.arange(len(blocks)), self._n)
        self.stage_blocks = [int(i) for i in groups[self._stage]]
        self._blocks = [blocks[i] for i in self.stage_blocks]
        first, last = self._stage == 0, self._stage == self._n - 1
        pre, post = segs["pre_params"], segs["post_params"]
        ids_pre, ids_post = {id(p) for p in pre}, {id(p) for p in post}
        self._shared = [p for p in pre if id(p) in ids_post]
        params = torch_leaves(layers)
        # the parameters this stage runs (and so updates)
        mine = {id(p) for b in self._blocks for p in torch_leaves(b)}
        if first:
            mine |= ids_pre
        if last:
            mine |= ids_post
        self._local = [p for p in params if id(p) in mine]
        # the stage that updates each parameter (block by block; pre's on
        # the first stage, post's alone on the last)
        self._owner = {id(p): 0 for p in params}
        for s, g in enumerate(groups):
            for i in g:
                for p in torch_leaves(blocks[i]):
                    self._owner[id(p)] = s
        for p in post:
            if id(p) not in ids_pre:
                self._owner[id(p)] = self._n - 1
        mp = hcg.get_model_parallel_group()
        dp = hcg.get_data_parallel_group()
        whole = [p for p in params if split_of(p) is None]
        sync_params(whole, [(mp, mp.ranks[0])])
        sync_params(params, [(pp, pp.ranks[0]), (dp, dp.ranks[0])])
        # the two ends of every pp group share a group (every process
        # makes each one, in one order)
        self._ends = pp
        if self._n > 2:
            for ranks in hcg.mesh.axis_groups("pp"):
                g = collective.new_group([ranks[0], ranks[-1]],
                                         axis="pp_ends")
                if pp.ranks[0] == ranks[0]:
                    self._ends = g
        for p in self._shared:
            # counted once in the clip's norm: on the first stage
            p.pp_norm_counted_elsewhere = not first and self._n > 1
        # this stage's share of the weights: what it does not run holds no
        # storage from here on (a tensor sharing storage with one it runs
        # keeps it)
        kept = {p.untyped_storage().data_ptr() for p in self._local}
        for p in params:
            if id(p) not in mine and \
                    p.untyped_storage().data_ptr() not in kept:
                _free(p)
        self._grad_sync = GradSync(self._local, avg_group=dp)
        self._grad_sync.enabled = False
        self._device = params[0].device if params else torch.device("cpu")

    # -- segmentation ---------------------------------------------------
    def _segments(self):
        model = self._layers
        if hasattr(model, "pp_segments"):
            return model.pp_segments()
        from .pp_layers import PipelineLayer
        if isinstance(model, PipelineLayer):
            return _segments_from_pipeline_layer(model)
        raise TypeError(
            "pipeline parallelism needs a model with pp_segments() or a "
            "PipelineLayer container; got " + type(model).__name__)

    def _call(self, fn, *args):
        """``fn`` on torch tensors: a surface model's segments take and
        give the eager core's Tensors."""
        if not _surface(self._layers):
            return fn(*args)
        from ....core.tensor import Tensor
        wrapped = [None if a is None else Tensor._wrap(a) for a in args]
        out = fn(*wrapped)
        return out._value if isinstance(out, Tensor) else out

    def _run_blocks(self, x):
        run = self._segs.get("run_blocks")
        if run is not None:
            return run(self._blocks, x)
        every = self._segs.get("recompute_interval", 0)
        if not every:
            for blk in self._blocks:
                x = self._call(blk, x)
            return x
        # each run of ``every`` blocks keeps only its input and runs again
        # in the backward (the reference's recompute_interval)
        from ...utils_recompute import recompute
        for i in range(0, len(self._blocks), every):
            chunk = self._blocks[i:i + every]

            def run_chunk(t, chunk=chunk):
                for blk in chunk:
                    t = self._call(blk, t)
                return t
            x = recompute(run_chunk, x) if x.requires_grad else run_chunk(x)
        return x

    @staticmethod
    def _torch(x):
        from ....core.tensor import Tensor
        return x._value if isinstance(x, Tensor) else x

    def _weights(self, ys, m):
        count = self._segs.get("count")
        if count is None or ys is None:
            return [1.0 / m] * m
        counts = [float(count(y)) for y in ys]
        total = sum(counts)
        return [c / total if total else 0.0 for c in counts]

    # -- the schedule ---------------------------------------------------
    def _run(self, data, train, scaler=None, want_output=False):
        from ....core import lazy
        from ... import pipeline
        x, label = data
        x = self._torch(x)
        label = None if label is None else self._torch(label)
        m = self._acc_steps
        if x.shape[0] % m:
            raise ValueError(f"batch size {x.shape[0]} must be a multiple "
                             f"of accumulate_steps {m}")
        xs = x.chunk(m)
        ys = None if label is None else label.chunk(m)
        w = self._weights(ys, m)
        first, last = self._stage == 0, self._stage == self._n - 1
        p2p = pipeline.P2P(self._pp, self._device)
        inputs, outs = {}, []
        total = torch.zeros((), dtype=torch.float32, device=self._device)

        def fwd(i, h):
            if h is None:
                h = self._call(self._segs["pre"], xs[i])
            elif train and h.is_floating_point():
                h.requires_grad_()
            inputs[i] = h
            h = self._run_blocks(h)
            if not last:
                return h
            if want_output:
                outs.append(self._call(self._segs["post"], h, None))
                return outs[-1]
            loss = self._call(self._segs["post"], h,
                              None if ys is None else ys[i]) * w[i]
            total.add_(loss.detach().float())
            if scaler is not None:
                loss = self._torch(scaler.scale(loss))
            return loss

        def bwd(i, out, grad):
            torch.autograd.backward(out, grad)
            h = inputs.pop(i)
            return h.grad if not first else None

        lazy.flush()
        with lazy.suspended(), torch.set_grad_enabled(train):
            pipeline.run_schedule(p2p, m, fwd, bwd if train else None)
        if want_output:
            out = pipeline.broadcast_from_last(
                torch.cat(outs) if last else None, self._pp, self._device)
        else:
            out = pipeline.broadcast_from_last(total if last else None,
                                               self._pp, self._device)
        if _surface(self._layers):
            from ....core.tensor import Tensor
            return Tensor._wrap(out)
        return out

    def _sync_shared(self):
        """Sum the two copies' grads of each parameter both ends use."""
        if self._n == 1 or self._stage not in (0, self._n - 1):
            return
        for p in self._shared:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            collective.all_reduce(p.grad, group=self._ends)

    def _found_inf(self, scaler, optimizer):
        """Unscale this stage's grads and agree over ``pp`` on whether any
        was not finite (every stage skips the step together)."""
        scaler.unscale_(optimizer)
        if scaler._found_inf is None:
            return
        flag = torch.tensor(float(scaler._found_inf), device=self._device)
        collective.all_reduce(flag, op="max", group=self._pp)
        scaler._found_inf = bool(flag.item())

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """Reference pipeline_parallel.py:114: the microbatches' forward
        and backward (grads on the parameters), then the step; returns
        the batch's loss on every rank."""
        loss = self._run(data, True, scaler)
        self._sync_shared()
        if self._grad_sync.groups:
            self._grad_sync.sync()
        if scaler is not None:
            self._found_inf(scaler, optimizer)
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        """The batch's loss (or with ``compute_loss=False`` the last
        stage's output) on every rank, forward only."""
        was = self._layers.training
        self.eval()
        try:
            return self._run(data, False, want_output=not compute_loss)
        finally:
            if was:
                self.train()

    def full_state_dict(self):
        """Every parameter's current value on every rank, each from the
        stage that updates it. Every rank of the ``pp`` group must call
        it."""
        out = {}
        for name, p in self._layers.named_parameters():
            leaf = getattr(p, "_value", p)
            src = self._owner[id(leaf)]
            t = leaf.detach().clone() if src == self._stage else \
                torch.empty_like(leaf)
            collective.broadcast(t, src=self._pp.ranks[src], group=self._pp)
            out[name] = t
        return out
