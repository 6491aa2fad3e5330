"""GPT causal LM and BERT pretraining (single-device branches of
``paddle_tpu/text/models.py``).

``torch.nn.Module``s with the reference's names, so a reference
``state_dict()`` loads through ``text.convert``: pre-norm blocks,
LayerNorm eps 1e-5, fused QKV, tanh-approximated GELU and a head tied to
the word embedding (``logits = h @ wemb.T``) or, with
``tie_embeddings=False``, a separate ``lm_head``. Attention goes through
``ops.attention.scaled_dot_product_attention`` and so through the flash
kernels on the card, forward and backward; the tied head's loss through
``ops.fused_ce.fused_linear_cross_entropy`` and so through the fused
cross-entropy kernels; plain matmuls stay ``torch.matmul``, as the
reference left them to XLA. Dropout draws from an explicit generator
(``ops.nn_ops.dropout``).

With ``use_mp=True`` and a hybrid topology whose ``mp`` group has more
than one rank (``distributed.fleet.init``), the blocks and the word
embedding are tensor-parallel (reference models.py:48-55, 70-100,
112-118): the fused QKV and the first MLP linear are
``ColumnParallelLinear`` (the QKV split by heads: each rank holds q, k
and v of its ``num_heads / mp`` heads), the attention's output and the
second MLP linear ``RowParallelLinear``, the word embedding
``VocabParallelEmbedding``, and the tied head's loss the vocab-split
``fused_linear_cross_entropy_tp`` (K5-K7 on each rank's shard, reference
:321-340). With ``use_sp=True`` and an ``sp`` group of more than one
rank, each rank runs ``S / sp`` of every sequence (the model takes the
whole ``[b, S]`` ids and labels and keeps its block, with its positions
offset by its rank), attention goes through ``ring_attention`` or
``ulysses_attention`` (``sp_mode``), and the loss's sum and valid count
are all-reduced over ``sp``; the parameters' grads are then partial sums
over the group, which ``fleet.distributed_model``'s wrapper adds up.
Without such groups both flags build the dense model, as in the
reference. ``state_dict()`` of a tensor-parallel model is the dense
model's (split weights gathered whole).

With ``recompute=True`` each block keeps only its input in the forward
and is run again in the backward (``_BlockRecompute``), with the dropout
generator's state and the ``auto_cast`` state of its forward.

``decode_forward_builder`` is the KV-cache decode math that
``GPTForCausalLM.generate`` and the serving programs share (reference
``_decode_forward_builder``), with the reference's ``lax.scan`` over
layers as a Python loop and the cache updated in place.
"""
import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

from ..amp.auto_cast import amp_state, resume
from ..core import rng
from ..core.device import resolve_device
from ..distributed import collective, topology
from ..distributed.fleet.meta_parallel import mp_layers
from ..distributed.fleet.meta_parallel import sequence_parallel as sp_attn
from ..ops import attention as attn_ops
from ..ops import fused_ce, nn_ops


class TransformerLMConfig:
    """The reference's knobs and defaults for the single-device GPT; the
    defaults are GPT-124M (vocab 50304, hidden 768, 12 layers, 12 heads,
    1024 positions). ``recompute`` recomputes each block in the
    backward. ``use_mp``/``use_sp``: tensor and sequence parallelism
    over the hybrid topology's ``mp``/``sp`` groups (the module's
    docstring); ``sp_mode`` ``"ring"`` or ``"ulysses"``.
    ``use_flash_attention`` is stored and, as in the reference, not
    consulted: attention always takes the flash path."""

    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_seq_len=1024,
                 dropout=0.1, use_mp=False, tie_embeddings=True,
                 use_flash_attention=True, initializer_range=0.02,
                 recompute=False, use_sp=False, sp_mode="ring"):
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple "
                             f"of num_heads {num_heads}")
        if sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"sp_mode must be 'ring' or 'ulysses', got "
                             f"{sp_mode!r}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size or hidden_size * 4
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.tie_embeddings = tie_embeddings
        self.use_flash_attention = use_flash_attention
        self.initializer_range = initializer_range
        self.recompute = recompute
        self.use_mp = use_mp
        self.use_sp = use_sp
        self.sp_mode = sp_mode


def _group_of(axis):
    """The hybrid topology's group of ``axis`` when it has more than one
    rank, else None (the dense model)."""
    hcg = topology.get_hybrid_communicate_group()
    if hcg is None or int(hcg.mesh.shape[axis]) == 1:
        return None
    return hcg.group(axis)


def _mp_group(cfg):
    return _group_of("mp") if getattr(cfg, "use_mp", False) else None


def _sp_group(cfg):
    return _group_of("sp") if getattr(cfg, "use_sp", False) else None


class SelfAttention(nn.Module):
    """Fused-QKV attention, causal (the GPT's) or not (BERT's); with an
    ``mp`` group, this rank's heads; with an ``sp`` group, ring or
    Ulysses attention over the ranks' sequence blocks."""

    def __init__(self, cfg, device=None, dropout_generator=None,
                 causal=True):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.causal = causal
        self.dropout = cfg.dropout
        self.dropout_generator = dropout_generator
        mp = _mp_group(cfg)
        self.sp_group = _sp_group(cfg)
        self.sp_mode = getattr(cfg, "sp_mode", "ring")
        if mp is not None:
            if cfg.num_heads % mp.nranks:
                raise ValueError(f"num_heads {cfg.num_heads} is not a "
                                 f"multiple of mp {mp.nranks}")
            self.local_heads = cfg.num_heads // mp.nranks
            self.qkv = mp_layers.ColumnParallelLinear(
                h, 3 * h, gather_output=False, chunks=3, mp_group=mp,
                device=device)
            self.out = mp_layers.RowParallelLinear(
                h, h, input_is_parallel=True, mp_group=mp, device=device)
        else:
            self.local_heads = cfg.num_heads
            self.qkv = nn.Linear(h, 3 * h, device=device)
            self.out = nn.Linear(h, h, device=device)

    def forward(self, x, attn_mask=None):
        b, s, _ = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.local_heads, self.head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        if self.sp_group is not None and attn_mask is None:
            fn = sp_attn.ring_attention if self.sp_mode == "ring" \
                else sp_attn.ulysses_attention
            o = fn(q, k, v, causal=self.causal, group=self.sp_group)
        else:
            o = attn_ops.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=self.causal)
        o = self.out(o.transpose(1, 2).reshape(
            b, s, self.local_heads * self.head_dim))
        if self.dropout:
            o = nn_ops.dropout(o, self.dropout, training=self.training,
                               generator=self.dropout_generator)
        return o


class MLP(nn.Module):
    def __init__(self, cfg, device=None, dropout_generator=None):
        super().__init__()
        mp = _mp_group(cfg)
        if mp is not None:
            self.fc1 = mp_layers.ColumnParallelLinear(
                cfg.hidden_size, cfg.intermediate_size, gather_output=False,
                mp_group=mp, device=device)
            self.fc2 = mp_layers.RowParallelLinear(
                cfg.intermediate_size, cfg.hidden_size,
                input_is_parallel=True, mp_group=mp, device=device)
        else:
            self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                 device=device)
            self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                 device=device)
        self.dropout = cfg.dropout
        self.dropout_generator = dropout_generator

    def forward(self, x):
        x = self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        if self.dropout:
            x = nn_ops.dropout(x, self.dropout, training=self.training,
                               generator=self.dropout_generator)
        return x


class Block(nn.Module):
    """Transformer block: pre-norm (the GPT's) or post-norm (BERT's,
    ``ln1(x + attn(x))`` then ``ln2(x + mlp(x))``)."""

    def __init__(self, cfg, device=None, dropout_generator=None,
                 causal=True, pre_norm=True):
        super().__init__()
        self.pre_norm = pre_norm
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, device=device)
        self.attn = SelfAttention(cfg, device, dropout_generator, causal)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5, device=device)
        self.mlp = MLP(cfg, device, dropout_generator)

    def forward(self, x, attn_mask=None):
        if self.pre_norm:
            x = x + self.attn(self.ln1(x), attn_mask)
            return x + self.mlp(self.ln2(x))
        x = self.ln1(x + self.attn(x, attn_mask))
        return self.ln2(x + self.mlp(x))


@contextmanager
def _rng_replay(generator, state):
    """Run with ``generator`` at ``state``, then put back the state it
    had (nothing to do without a generator)."""
    if generator is None:
        yield
        return
    left = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(left)


class _BlockRecompute(torch.autograd.Function):
    """A block whose activations are not kept: the forward saves only
    its input, the backward runs the block again and differentiates it
    (reference ``distributed/utils_recompute.py:17-73``). Its dropout
    draws from an explicit generator (``ops.nn_ops.dropout``), which
    ``torch.utils.checkpoint``'s RNG preservation does not see, so the
    state of ``generator`` before the forward is replayed for the
    recomputation and the state the forward left is put back after it.
    ``amp.auto_cast`` is a ``TorchFunctionMode`` that the backward would
    run outside of, so the forward's cast state is re-entered too.
    ``mask`` is the attention mask (or None), a constant; ``params`` are
    the block's parameters, passed so that autograd gives them their
    grads."""

    @staticmethod
    def forward(ctx, block, generator, mask, x, *params):
        ctx.block, ctx.generator, ctx.mask = block, generator, mask
        ctx.rng_state = None if generator is None else generator.get_state()
        ctx.amp = amp_state()
        ctx.save_for_backward(x)
        return block(x, mask)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        needs = ctx.needs_input_grad[3:]
        x = x.detach().requires_grad_(needs[0])
        with torch.enable_grad(), \
                _rng_replay(ctx.generator, ctx.rng_state), resume(ctx.amp):
            y = ctx.block(x, ctx.mask)
        inputs = [x, *ctx.block.parameters()]
        got = iter(torch.autograd.grad(
            y, [t for t, n in zip(inputs, needs) if n], grad,
            allow_unused=True))
        return (None, None, None,
                *(next(got) if n else None for n in needs))


class _TransformerCore(nn.Module):
    """Embeddings, blocks and the final LayerNorm (reference
    ``_TransformerCore``, models.py:134-211). ``causal``/``pre_norm``:
    the GPT's (True, True) or BERT's (False, False); a BERT core adds
    token-type embeddings. ``ln_f`` is a parameter of every core, but
    only a pre-norm core applies it, as the reference's."""

    def __init__(self, cfg, device=None, dropout_generator=None,
                 causal=True, pre_norm=True, with_token_type=False):
        super().__init__()
        self.cfg = cfg
        self.dropout_generator = dropout_generator
        self.pre_norm = pre_norm
        # the groups fixed at build, which the shards were cut for; the
        # forward reads these, never the topology of the moment
        self.mp_group = mp = _mp_group(cfg)
        self.sp_group = _sp_group(cfg)
        if mp is not None:
            self.word_embeddings = mp_layers.VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size, mp_group=mp, device=device)
        else:
            self.word_embeddings = nn.Embedding(
                cfg.vocab_size, cfg.hidden_size, device=device)
        self.position_embeddings = nn.Embedding(
            cfg.max_seq_len, cfg.hidden_size, device=device)
        self.token_type_embeddings = nn.Embedding(
            2, cfg.hidden_size, device=device) if with_token_type else None
        self.blocks = nn.ModuleList(
            [Block(cfg, device, dropout_generator, causal, pre_norm)
             for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=1e-5, device=device)

    def embed(self, input_ids, token_type_ids=None, pos_offset=0):
        """The embeddings' sum (and its dropout): the blocks' input."""
        s = input_ids.shape[1]
        pos = torch.arange(pos_offset, pos_offset + s,
                           device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if self.token_type_embeddings is not None \
                and token_type_ids is not None:
            x = x + self.token_type_embeddings(token_type_ids)
        if self.cfg.dropout:
            x = nn_ops.dropout(x, self.cfg.dropout, training=self.training,
                               generator=self.dropout_generator)
        return x

    def run_blocks(self, x, attn_mask=None, blocks=None):
        """``blocks`` (all of them by default) in turn, each recomputed in
        the backward under ``cfg.recompute``."""
        blocks = self.blocks if blocks is None else blocks
        if self.cfg.recompute and self.training and x.requires_grad:
            # the generator the blocks' dropout draws from
            gen = None
            if self.cfg.dropout:
                gen = self.dropout_generator
                if gen is None:
                    gen = rng.default_generator(x.device)
            for blk in blocks:
                x = _BlockRecompute.apply(blk, gen, attn_mask, x,
                                          *blk.parameters())
        else:
            for blk in blocks:
                x = blk(x, attn_mask)
        return x

    def forward(self, input_ids, token_type_ids=None, attn_mask=None,
                pos_offset=0):
        x = self.run_blocks(self.embed(input_ids, token_type_ids,
                                       pos_offset), attn_mask)
        return self.ln_f(x) if self.pre_norm else x


class GPTModel(_TransformerCore):
    """Decoder-only causal LM core (GPT style: pre-norm)."""


def _divide_seq(s, sp):
    if s % sp:
        raise ValueError(f"sequence length {s} is not a multiple of sp {sp}")
    return s // sp


def _gather_seq(t, group):
    """Every rank's sequence block of ``t`` ``[b, s/sp, ...]`` put back
    in order (the grad of this rank's block backward)."""
    return collective._c_concat(t.transpose(1, -1), group).transpose(1, -1)


class GPTForCausalLM(nn.Module):
    """``GPTForCausalLM(cfg)`` builds on the card; ``device="cpu"`` asks
    for the CPU. ``generator`` (a CPU ``torch.Generator``) makes the
    random weights reproducible: every matrix and embedding is
    N(0, initializer_range), biases 0, LayerNorm 1/0.
    ``dropout_generator`` (a ``torch.Generator`` on the model's device)
    draws the dropout masks; without it they come from the port's
    default generator for the device, which ``paddle_tpu_torch.seed``
    seeds."""

    def __init__(self, cfg, device=None, generator=None,
                 dropout_generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, dev, dropout_generator)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias=False, device=dev)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator=None):
        std = self.cfg.initializer_range
        for name, p in self.named_parameters():
            if p.dim() == 2:
                # a split weight: the whole one drawn, this rank's shard
                # kept, so every topology starts from the same weights
                split = mp_layers.split_of(p)
                w = torch.randn(p.shape if split is None
                                else split.full_shape,
                                generator=generator) * std
                if split is not None:
                    w = mp_layers.shard_of(p, w)
                p.copy_(w)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)

    @property
    def device(self):
        return self.gpt.word_embeddings.weight.device

    def forward(self, input_ids, labels=None):
        """Logits ``[b, s, vocab]``, or with ``labels`` ``[b, s]`` the mean
        cross-entropy of each position's logits against its label
        (``-100`` ignored; no shift, as in the reference). The tied head
        computes the loss with the fused linear cross-entropy, so its
        logits never exist (reference ``_head_loss``, models.py:301-320)."""
        sp = self.gpt.sp_group
        offset = 0
        if sp is not None:      # this rank's block of every sequence
            s_local = _divide_seq(input_ids.shape[1], sp.nranks)
            offset = sp.rank * s_local
            input_ids = input_ids[:, offset:offset + s_local]
            if labels is not None:
                labels = labels[:, offset:offset + s_local]
        return self._head(self.gpt(input_ids, pos_offset=offset), labels)

    def _head(self, h, labels=None):
        """The logits of the final hidden states ``h`` (this rank's
        sequence block under sp), or with ``labels`` the mean loss."""
        sp = self.gpt.sp_group
        mp = self.gpt.mp_group
        if labels is None:
            if self.cfg.tie_embeddings:
                wemb = self.gpt.word_embeddings.weight
                if mp is not None:      # the vocab-split logits gathered
                    logits = collective._c_concat(torch.matmul(
                        collective._c_identity(h, mp), wemb.t()), mp)
                else:
                    logits = torch.matmul(h, wemb.t())
            else:
                logits = self.lm_head(h)
            if sp is not None:
                logits = _gather_seq(logits, sp)
            return logits
        flat = labels.reshape(-1)
        x = h.reshape(-1, self.cfg.hidden_size)
        if self.cfg.tie_embeddings:
            wemb = self.gpt.word_embeddings.weight
            if mp is not None:
                # tp_fused_applicable holds by construction: the vocab
                # divides over mp (VocabParallelEmbedding checks it). The
                # reference refuses it under pp > 1, where its program is
                # cut into stages before the head; here the head runs
                # whole on the last stage's mp group, whose shards of the
                # tied weight are the first stage's (PipelineParallel
                # sums the two copies' grads), so K5-K7 on each shard
                # compute the reference's composition
                per_tok = fused_ce.fused_linear_cross_entropy_tp(
                    x, wemb, flat, mp)
            else:
                per_tok = fused_ce.fused_linear_cross_entropy(x, wemb, flat)
            total = per_tok.sum()
        elif sp is None:
            return nn_ops.cross_entropy(
                self.lm_head(h).reshape(-1, self.cfg.vocab_size), flat)
        else:
            total = nn_ops.cross_entropy(
                self.lm_head(x), flat, reduction="sum")
        # mean over the tokens that are not ignored (all of the sp
        # group's tokens: the sum and the count all-reduced)
        valid = (flat != -100).float().sum()
        if sp is not None:
            total = collective._mp_allreduce(total, group=sp)
            collective.all_reduce(valid, group=sp)
        return total / valid.clamp(min=1.0)

    def pp_segments(self):
        """The pipeline's cut of the model (reference models.py:788-808):
        ``pre`` the embeddings, ``blocks`` the transformer blocks (run
        through ``run_blocks``, which recomputes them under
        ``cfg.recompute``), ``post`` the final LayerNorm and the head's
        mean loss over a microbatch, ``count`` the tokens a loss averages
        over (``PipelineParallel`` weights each microbatch by its share of
        the batch's), and the parameters ``pre`` and ``post`` read (the
        tied embedding in both)."""
        core = self.gpt
        if core.sp_group is not None:
            raise ValueError("pipeline parallelism does not combine with "
                             "use_sp here")
        wemb = core.word_embeddings.weight
        head = [wemb] if self.cfg.tie_embeddings \
            else list(self.lm_head.parameters())
        return {"pre": lambda ids: core.embed(ids),
                "blocks": list(core.blocks),
                "run_blocks": lambda blocks, x: core.run_blocks(
                    x, blocks=blocks),
                "post": lambda h, labels=None: self._head(core.ln_f(h),
                                                          labels),
                "count": lambda labels: (labels != -100).sum(),
                "pre_params": [wemb, core.position_embeddings.weight],
                "post_params": list(core.ln_f.parameters()) + head}

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=0, seed=0, num_beams=1):
        """Autoregressive decoding (reference ``generate``,
        models.py:619-786) over an f32 KV cache ``[L, b, heads, prompt +
        max_new_tokens, head_dim]``, with the decode math of the serving
        engine (``decode_forward_builder``): a prefill of the prompt,
        then one token a step. Greedy when ``temperature <= 0`` or
        ``top_k == 1``; otherwise a draw from ``softmax(logits /
        temperature)`` over the logits at or above the ``top_k``-th
        largest (ties kept; 0 = the full vocab), from a
        ``torch.Generator`` on the model's device seeded with ``seed``:
        the same seed gives the same tokens, not the reference's.
        ``num_beams > 1`` is deterministic beam search over the summed
        log-probabilities; the best beam is returned. Returns the prompt
        and the new tokens, int64 ``[b, prompt + max_new_tokens]`` on the
        model's device."""
        cfg = self.cfg
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        b, s0 = ids.shape
        n_new = int(max_new_tokens)
        total = s0 + n_new
        if total > cfg.max_seq_len:
            raise ValueError(f"prompt {s0} + max_new_tokens "
                             f"{max_new_tokens} exceeds max_seq_len "
                             f"{cfg.max_seq_len}")
        if n_new <= 0:
            return ids.clone()
        K = int(num_beams)
        if K < 1:
            raise ValueError(f"num_beams must be >= 1, got {num_beams}")
        if K > 1:
            if K > cfg.vocab_size:
                raise ValueError(f"num_beams {K} > vocab size "
                                 f"{cfg.vocab_size}")
            if temperature not in (1.0, 0.0) or top_k or seed:
                raise ValueError(
                    "num_beams > 1 is deterministic beam search; "
                    "temperature/top_k/seed do not apply (use "
                    "num_beams=1 for sampling)")
        nh = cfg.num_heads
        hd = cfg.hidden_size // nh
        params = self.export_decode_params()
        head = params["head"]
        _, hidden_t = decode_forward_builder(nh, hd, cfg.hidden_size)
        kc = torch.zeros(cfg.num_layers, b, nh, total, hd, device=dev)
        vc = torch.zeros_like(kc)
        logits = hidden_t(params, ids, 0, kc, vc)[:, -1] @ head
        if K > 1:
            return torch.cat([ids, self._beam_search(
                params, hidden_t, logits, kc, vc, s0, n_new, K)], 1)

        greedy = temperature <= 0 or top_k == 1
        kk = min(int(top_k), cfg.vocab_size)
        temp = float(torch.tensor(max(temperature, 1e-6),
                                  dtype=torch.float32))
        gen = None if greedy else torch.Generator(device=dev).manual_seed(
            int(seed))

        def pick(lg):
            if greedy:
                return lg.argmax(-1)
            lg = lg / temp
            if kk > 0:
                kth = lg.topk(kk, dim=-1).values[:, -1:]
                lg = lg.masked_fill(lg < kth, -1e30)
            # Gumbel-max: argmax(lg + G) is a draw from softmax(lg)
            u = torch.rand(lg.shape, generator=gen, device=dev)
            return (lg - torch.log(-torch.log(u))).argmax(-1)

        out = [pick(logits)]
        for i in range(1, n_new):
            h = hidden_t(params, out[-1][:, None], s0 + i - 1, kc, vc)
            out.append(pick(h[:, -1] @ head))
        return torch.cat([ids, torch.stack(out, 1)], 1)

    def _beam_search(self, params, hidden_t, logits, kc, vc, s0, n_new, K):
        """The reference's ``beam_decode``: K beams a row join the batch,
        each step keeps the K best of the K x vocab extensions by summed
        log-probability (ties to the lower flat index) and gathers the
        caches and sequences by beam. ``[b, n_new]``, the best beam."""
        b, V = logits.shape
        L, _, nh, total, hd = kc.shape
        rows = torch.arange(b, device=logits.device)[:, None]
        scores, tok = _top(torch.log_softmax(logits, -1), K)
        kc = kc.repeat_interleave(K, dim=1)
        vc = vc.repeat_interleave(K, dim=1)
        seqs = torch.zeros(b, K, n_new, dtype=torch.long,
                           device=logits.device)
        seqs[:, :, 0] = tok
        for i in range(1, n_new):
            h = hidden_t(params, tok.reshape(b * K, 1), s0 + i - 1, kc, vc)
            lp = torch.log_softmax(h[:, -1] @ params["head"], -1)
            cand = scores[:, :, None] + lp.reshape(b, K, V)
            scores, flat = _top(cand.reshape(b, K * V), K)
            beam, tok = flat // V, flat % V
            kc = kc.view(L, b, K, nh, total, hd)[:, rows, beam].reshape(
                L, b * K, nh, total, hd)
            vc = vc.view(L, b, K, nh, total, hd)[:, rows, beam].reshape(
                L, b * K, nh, total, hd)
            seqs = seqs[rows, beam]
            seqs[:, :, i] = tok
        return seqs[:, 0]

    @torch.no_grad()
    def export_decode_params(self):
        """Weights as the decode programs consume them, snapshotted now:
        per-layer tensors stacked on a leading layer axis (``stacked``)
        with matrices as ``[in, out]`` (``x @ W``, the reference's
        layout), per-layer views of them (``layers``), the embeddings,
        the final LayerNorm and the (tied or separate) head."""
        if self.gpt.mp_group is not None:
            raise NotImplementedError(
                "decoding a tensor-parallel model: load its state_dict() "
                "(the whole weights) into a dense GPTForCausalLM")

        def W(t):
            return t.detach().clone()

        per_layer = []
        for blk in self.gpt.blocks:
            per_layer.append({
                "ln1_w": W(blk.ln1.weight), "ln1_b": W(blk.ln1.bias),
                "qkv_w": W(blk.attn.qkv.weight.t()),
                "qkv_b": W(blk.attn.qkv.bias),
                "out_w": W(blk.attn.out.weight.t()),
                "out_b": W(blk.attn.out.bias),
                "ln2_w": W(blk.ln2.weight), "ln2_b": W(blk.ln2.bias),
                "fc1_w": W(blk.mlp.fc1.weight.t()),
                "fc1_b": W(blk.mlp.fc1.bias),
                "fc2_w": W(blk.mlp.fc2.weight.t()),
                "fc2_b": W(blk.mlp.fc2.bias)})
        stacked = {k: torch.stack([p[k] for p in per_layer])
                   for k in per_layer[0]}
        layers = [{k: v[i] for k, v in stacked.items()}
                  for i in range(len(per_layer))]
        wemb = W(self.gpt.word_embeddings.weight)
        head = wemb.t() if self.cfg.tie_embeddings \
            else W(self.lm_head.weight.t())
        return {"stacked": stacked, "layers": layers, "wemb": wemb,
                "pemb": W(self.gpt.position_embeddings.weight),
                "lnf_w": W(self.gpt.ln_f.weight),
                "lnf_b": W(self.gpt.ln_f.bias), "head": head}

    def build_serving_fns(self, num_slots, cache_len, sampling=False):
        """The slot-pool programs of the serving engine (reference
        models.py:466-608), over caches ``kc/vc [L, num_slots, nh,
        cache_len, hd]`` written IN PLACE; ``toks``/``pos`` ``[S]`` stay
        on the device and come back as new tensors:

          prefill(params, tokens [G, bucket], lengths [G], slots [G],
                  toks, pos, kc, vc[, seeds, temps, topks, topps])
                  -> (first [G], toks', pos')
              One same-bucket admission group in one call: the G claimed
              slots' caches are gathered, ``hidden_t`` runs over the
              group from position 0 and the slices scatter back. Prompts
              are right-padded to the bucket (causal masking hides pad
              rows from real ones, the decode's length mask afterwards).
              ``toks[slots] = first``, ``pos[slots] = lengths``;

          decode_step(params, toks, pos, kc, vc[, seeds, temps, topks,
                      topps]) -> (next [S], pos + 1)
              Every slot writes its row at its own position, clamped to
              ``cache_len - 1`` (where the reference's
              dynamic_update_slice clamps), the position embedding's
              index to the table's last row, and attends through
              ``ops.attention.cached_slot_attention`` with ``lengths =
              pos + 1``.

        ``sampling=True`` appends the per-slot sampling parameters
        (``serving.sched.sampling``; key index ``lengths - 1`` for a
        prefill, ``pos`` for a decode). Both programs use the decode
        math of ``decode_forward_builder``."""
        from ..serving.sched.sampling import build_sampling_head

        cfg = self.cfg
        nh = cfg.num_heads
        C = int(cache_len)
        layers_t, hidden_t = decode_forward_builder(
            nh, cfg.hidden_size // nh, cfg.hidden_size)
        head = build_sampling_head(cfg.vocab_size) if sampling else None

        def prefill(params, tokens, lengths, slots, toks, pos, kc, vc,
                    *samp):
            sl = slots.long()
            kcs = kc.index_select(1, sl)             # [L, G, nh, C, hd]
            vcs = vc.index_select(1, sl)
            h = hidden_t(params, tokens, 0, kcs, vcs)
            kc[:, sl] = kcs
            vc[:, sl] = vcs
            G = tokens.shape[0]
            last = h[torch.arange(G, device=h.device),
                     (lengths - 1).long()] @ params["head"]   # [G, vocab]
            if head is None:
                first = last.argmax(-1).to(torch.int32)
            else:
                first = head(last, samp[0], lengths - 1, *samp[1:])
            toks = toks.clone()
            pos = pos.clone()
            toks[sl] = first
            # the next decode writes each member at its prompt length
            pos[sl] = lengths.to(pos.dtype)
            return first, toks, pos

        def decode_step(params, toks, pos, kc, vc, *samp):
            S = toks.shape[0]
            # parked and idle slots' positions keep incrementing past the
            # table: clamp so their (ignored) row reads in bounds
            x = params["wemb"][toks.long()] + params["pemb"][
                pos.clamp(max=params["pemb"].shape[0] - 1).long()]
            sidx = torch.arange(S, device=toks.device)
            wpos = pos.clamp(max=C - 1).long()
            lengths = pos + 1

            def attend(i, q, k, v):
                kc[i][sidx, :, wpos] = k[:, :, 0]
                vc[i][sidx, :, wpos] = v[:, :, 0]
                return attn_ops.cached_slot_attention(
                    q[:, :, 0], kc[i], vc[i], lengths)[:, :, None]

            logits = layers_t(params, x[:, None], attend)[:, 0] \
                @ params["head"]
            if head is None:
                nxt = logits.argmax(-1).to(torch.int32)
            else:
                nxt = head(logits, samp[0], pos, *samp[1:])
            return nxt, pos + 1

        return prefill, decode_step

    def build_chunk_prefill_fn(self, cache_len, sampling=False):
        """The chunked-prefill program over the slot pool
        (``serving.sched.programs.build_chunk_fns``)."""
        from ..serving.sched.programs import build_chunk_fns
        return build_chunk_fns(self.cfg, cache_len, sampling=sampling)

    def build_spec_verify_fn(self, num_slots, cache_len, spec_k):
        """The speculative k-token verify program over the slot pool
        (``serving.spec.programs``)."""
        from ..serving.spec.programs import build_spec_verify_fn
        return build_spec_verify_fn(self.cfg, num_slots, cache_len, spec_k)

    def build_paged_spec_verify_fn(self, num_slots, block_size, num_blocks,
                                   blocks_per_slot, spec_k):
        """The speculative verify program over the paged pool."""
        from ..serving.spec.programs import build_paged_spec_verify_fn
        return build_paged_spec_verify_fn(self.cfg, num_slots, block_size,
                                          num_blocks, blocks_per_slot,
                                          spec_k)


def _top(x, k):
    """The ``k`` largest of each row of ``x`` and their indices, ties
    to the lower index, as ``lax.top_k`` breaks them (``torch.topk``
    promises no order among equal values)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def decode_forward_builder(num_heads, head_dim, hidden_size):
    """KV-cache decode math shared by ``generate`` and every serving
    program. Returns ``(layers_t, hidden_t)``:

      layers_t(params, x [S, t, hidden], attend) -> h [S, t, hidden]

    the blocks over embedded inputs ``x``, each block's attention left to
    ``attend(i, q, k, v)``: q/k/v ``[S, nh, t, hd]`` of layer i in, the
    attention output ``[S, nh, t, hd]`` out (``attend`` also writes layer
    i's cache, where and how its pool wants it). The result is the final
    LayerNorm's output, so ``h @ params["head"]`` are the logits.

      hidden_t(params, tok [bb, t], pos, kc, vc) -> h [bb, t, hidden]

    ``layers_t`` over a contiguous cache kc/vc ``[L, bb, nh, total,
    hd]`` (the reference forward_t): rows ``pos..pos+t`` written IN PLACE
    (the reference returned new arrays), attention causal over the cache,
    positions beyond the live prefix masked to -1e30 so stale contents
    carry exactly zero weight. ``pos`` is a Python int."""
    nh, hd = num_heads, head_dim
    rsd = math.sqrt(hd)

    def ln(x, w, b):
        return F.layer_norm(x, (x.shape[-1],), w, b, 1e-5)

    def layers_t(pr, x, attend):
        S, t = x.shape[0], x.shape[1]
        for i, p in enumerate(pr["layers"]):
            h_ = ln(x, p["ln1_w"], p["ln1_b"])
            qkv = h_ @ p["qkv_w"] + p["qkv_b"]
            qkv = qkv.reshape(S, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
            o = attend(i, qkv[0], qkv[1], qkv[2])
            o = o.permute(0, 2, 1, 3).reshape(S, t, hidden_size)
            x = x + (o @ p["out_w"] + p["out_b"])
            h2 = ln(x, p["ln2_w"], p["ln2_b"])
            m = F.gelu(h2 @ p["fc1_w"] + p["fc1_b"], approximate="tanh")
            x = x + (m @ p["fc2_w"] + p["fc2_b"])
        return ln(x, pr["lnf_w"], pr["lnf_b"])

    def hidden_t(pr, tok, pos, kc, vc):
        t = tok.shape[1]
        total = kc.shape[3]
        dev = tok.device
        # out-of-range position rows clamp, as a JAX gather does
        pidx = (pos + torch.arange(t, device=dev)).clamp(
            max=pr["pemb"].shape[0] - 1)
        x = pr["wemb"][tok] + pr["pemb"][pidx]
        # dynamic_update_slice semantics: the start clamps so the update
        # fits
        w0 = min(max(pos, 0), total - t)
        kpos = torch.arange(total, device=dev)[None, None, None, :]
        qpos = pos + torch.arange(t, device=dev)[None, None, :, None]
        masked = kpos > qpos

        def attend(i, q, k, v):
            kc[i][:, :, w0:w0 + t] = k
            vc[i][:, :, w0:w0 + t] = v
            s = torch.einsum("bhtd,bhsd->bhts", q, kc[i]) / rsd
            s = s.masked_fill(masked, -1e30)
            return torch.einsum("bhts,bhsd->bhtd", torch.softmax(s, dim=-1),
                                vc[i])

        return layers_t(pr, x, attend)

    return layers_t, hidden_t


class BertModel(_TransformerCore):
    """Encoder core (BERT style: post-norm, non-causal, token types; the
    reference's ``BertModel``, models.py:812-824) and its pooler
    ``tanh(Linear(h[:, 0]))``."""

    def __init__(self, cfg, device=None, dropout_generator=None):
        super().__init__(cfg, device, dropout_generator, causal=False,
                         pre_norm=False, with_token_type=True)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                device=device)

    def forward(self, input_ids, token_type_ids=None, attn_mask=None):
        h = super().forward(input_ids, token_type_ids, attn_mask)
        return h, torch.tanh(self.pooler(h[:, 0]))


class BertForPretraining(nn.Module):
    """MLM and NSP heads over ``BertModel`` (reference models.py:826-855,
    the objective of its config 3, BERT-base pretraining). The MLM
    transform is ``gelu(approximate=True)`` then LayerNorm; its logits
    are ``t @ word_embeddings.weight^T`` (the head tied to the word
    embeddings); the loss is the mean cross-entropy over the positions
    whose label is not -1, plus the NSP cross-entropy of
    ``nsp_head(pooled)`` when ``next_sentence_labels`` are given.

    Built on the card unless ``device`` says otherwise. The weights are
    made from ``generator`` (a CPU ``torch.Generator``; without one, the
    port's default CPU generator, which ``paddle_tpu_torch.seed`` seeds),
    never from torch's global one: the modules are built on the meta
    device and every matrix and embedding drawn N(0,
    initializer_range), biases 0, LayerNorm 1/0."""

    def __init__(self, cfg, device=None, generator=None,
                 dropout_generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        h = cfg.hidden_size
        meta = torch.device("meta")
        self.bert = BertModel(cfg, meta, dropout_generator)
        self.mlm_transform = nn.Linear(h, h, device=meta)
        self.mlm_ln = nn.LayerNorm(h, eps=1e-5, device=meta)
        self.nsp_head = nn.Linear(h, 2, device=meta)
        self.to_empty(device=dev)
        self.init_weights(generator)

    def init_weights(self, generator=None):
        if generator is None:
            generator = rng.default_generator(torch.device("cpu"))
        GPTForCausalLM.init_weights(self, generator)

    @property
    def device(self):
        return self.bert.word_embeddings.weight.device

    def forward(self, input_ids, token_type_ids=None, masked_lm_labels=None,
                next_sentence_labels=None):
        h, pooled = self.bert(input_ids, token_type_ids)
        t = self.mlm_ln(F.gelu(self.mlm_transform(h), approximate="tanh"))
        logits = torch.matmul(t, self.bert.word_embeddings.weight.t())
        if masked_lm_labels is None:
            return logits
        loss = nn_ops.cross_entropy(
            logits.reshape(-1, self.cfg.vocab_size),
            masked_lm_labels.reshape(-1), ignore_index=-1)
        if next_sentence_labels is not None:
            loss = loss + nn_ops.cross_entropy(
                self.nsp_head(pooled), next_sentence_labels.reshape(-1))
        return loss


def bert_base(vocab_size=30522, max_seq_len=512, device=None,
              generator=None, dropout_generator=None, **kwargs):
    """BERT-base pretraining (reference ``bert_base``, models.py:858-862;
    its BASELINE config 3): hidden 768, 12 layers, 12 heads, about 110 M
    parameters."""
    cfg = TransformerLMConfig(vocab_size=vocab_size, hidden_size=768,
                              num_layers=12, num_heads=12,
                              max_seq_len=max_seq_len, **kwargs)
    return BertForPretraining(cfg, device, generator, dropout_generator)
