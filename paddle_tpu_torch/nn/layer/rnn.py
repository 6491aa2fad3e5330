"""Recurrent layers (a port of ``paddle_tpu/nn/layer/rnn.py``): ``LSTM``,
``GRU`` and ``SimpleRNN`` over ``RNNBase``, the cells, ``RNN`` and
``BiRNN`` over any cell, ``BeamSearchDecoder`` and ``dynamic_decode``.

The reference runs one ``lax.scan`` per layer and direction inside the
ops ``lstm_layer``, ``gru_layer`` and ``simple_rnn_layer``: gates
``x W_ih^T + h W_hh^T + b_ih + b_hh``, split LSTM ``i, f, g, o`` and GRU
``r, z, c`` with ``n = tanh(ic + r * hc)``. Torch's fused RNN ops
(``torch._VF.lstm``, ``gru``, ``rnn_tanh``, ``rnn_relu``; for a cell's
single step ``torch.lstm_cell``/``gru_cell``) compute the same math in
the same gate order, so each op calls one of them, one layer and one
direction at a time, on the layer's own parameters (no ``nn.LSTM``
holds copies of them). The reverse direction is the reference's
``scan(reverse=True)`` over the whole padded length: flip, run, flip.
On the card ``_VF`` reaches cuDNN's RNN, in f32 and in bf16;
weights that are not one flat buffer make cuDNN copy them on every call
(``chip_smoke.py`` phase 23a prints which kernels ran and what the copy
costs). No TPU kernel computes an
RNN, so nothing here is a port of one.

As in the reference, ``sequence_length`` is taken and not read by
``RNNBase``, ``RNN`` and ``BiRNN``, so padding reaches the final states
and the reverse direction; ``get_initial_states`` does not read
``shape``; ``dynamic_decode`` does not read its ``**kwargs``. The ops
carry the reference's names, so ``amp.auto_cast`` casts them by its
rule: O2 runs each in bf16, O1 in f32.
"""
import torch

from ..layer_base import Layer
from .. import initializer as init_mod
from ...core.dispatch import register_op
from ...core.tensor import Tensor
from ...ops import manipulation


def _one_dtype(*ts):
    """``ts`` at the widest float dtype among them: the reference's
    ``jnp`` body promotes a bf16 input against f32 weights (O1), torch's
    fused ops take one dtype."""
    dt = None
    for t in ts:
        if t is not None:
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return [None if t is None else t.to(dt) for t in ts]


def _fused(fn, x, hx, w_ih, w_hh, b_ih, b_hh, reverse):
    """One layer, one direction of torch's fused op ``fn`` over
    ``x [T, B, I]``; the reverse direction runs on the flipped sequence
    and its outputs are flipped back."""
    params = [w_ih, w_hh] + ([b_ih, b_hh] if b_ih is not None else [])
    if reverse:
        x = x.flip(0)
    out = fn(x, hx, params, b_ih is not None, 1, 0.0,
             torch.is_grad_enabled(), False, False)
    y = out[0].flip(0) if reverse else out[0]
    return (y,) + tuple(s[0] for s in out[1:])


@register_op("lstm_layer")
def _lstm_layer(x, h0, c0, w_ih, w_hh, b_ih, b_hh, *, reverse, cell=False):
    """x ``[T, B, I]`` time-major; returns ``(y, h, c)``. A cell's step
    (``cell``, T = 1) runs ``torch.lstm_cell``."""
    x, h0, c0, w_ih, w_hh, b_ih, b_hh = _one_dtype(
        x, h0, c0, w_ih, w_hh, b_ih, b_hh)
    if b_ih is None:
        b_hh = None
    if cell:
        h, c = torch.lstm_cell(x[0], (h0, c0), w_ih, w_hh, b_ih, b_hh)
        return h[None], h, c
    return _fused(torch._VF.lstm, x, (h0[None], c0[None]), w_ih, w_hh, b_ih,
                  b_hh, reverse)


@register_op("gru_layer")
def _gru_layer(x, h0, w_ih, w_hh, b_ih, b_hh, *, reverse, cell=False):
    x, h0, w_ih, w_hh, b_ih, b_hh = _one_dtype(x, h0, w_ih, w_hh, b_ih,
                                               b_hh)
    if b_ih is None:
        b_hh = None
    if cell:
        h = torch.gru_cell(x[0], h0, w_ih, w_hh, b_ih, b_hh)
        return h[None], h
    return _fused(torch._VF.gru, x, h0[None], w_ih, w_hh, b_ih, b_hh,
                  reverse)


@register_op("simple_rnn_layer")
def _simple_rnn_layer(x, h0, w_ih, w_hh, b_ih, b_hh, *, reverse,
                      activation):
    x, h0, w_ih, w_hh, b_ih, b_hh = _one_dtype(x, h0, w_ih, w_hh, b_ih,
                                               b_hh)
    if b_ih is None:
        b_hh = None
    fn = torch._VF.rnn_tanh if activation == "tanh" else torch._VF.rnn_relu
    return _fused(fn, x, h0[None], w_ih, w_hh, b_ih, b_hh, reverse)


def _zeros(shape, like):
    """Zeros on ``like``'s device in its dtype (a Tensor)."""
    v = like._v
    return Tensor._wrap(torch.zeros(shape, dtype=v.dtype, device=v.device))


class RNNBase(Layer):
    GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None):
        super().__init__()
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = 2 if direction in ("bidirect", "bidirectional") else 1
        g = self.GATES[mode]
        std = 1.0 / (hidden_size ** 0.5)
        self._all_weights = []
        for layer in range(num_layers):
            for d in range(self.bidirect):
                in_sz = input_size if layer == 0 else hidden_size * self.bidirect
                suffix = "_reverse" if d else ""
                shapes = [((g * hidden_size, in_sz), weight_ih_attr, False),
                          ((g * hidden_size, hidden_size), weight_hh_attr,
                           False),
                          ((g * hidden_size,), bias_ih_attr, True),
                          ((g * hidden_size,), bias_hh_attr, True)]
                names = [f"weight_ih_l{layer}{suffix}",
                         f"weight_hh_l{layer}{suffix}",
                         f"bias_ih_l{layer}{suffix}",
                         f"bias_hh_l{layer}{suffix}"]
                for n, (shape, attr, is_bias) in zip(names, shapes):
                    self.add_parameter(n, self.create_parameter(
                        shape, attr, is_bias=is_bias,
                        default_initializer=init_mod.Uniform(-std, std)))
                self._all_weights.append(names)

    def _run_layer(self, x, h0, c0, names, reverse):
        w_ih, w_hh, b_ih, b_hh = (getattr(self, n) for n in names)
        if self.mode == "LSTM":
            return _lstm_layer(x, h0, c0, w_ih, w_hh, b_ih, b_hh,
                               reverse=reverse)
        if self.mode == "GRU":
            y, h = _gru_layer(x, h0, w_ih, w_hh, b_ih, b_hh, reverse=reverse)
            return y, h, None
        act = "tanh" if self.mode == "RNN_TANH" else "relu"
        y, h = _simple_rnn_layer(x, h0, w_ih, w_hh, b_ih, b_hh,
                                 reverse=reverse, activation=act)
        return y, h, None

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...ops import nn_ops
        x = inputs
        if not self.time_major:
            x = manipulation.transpose(x, (1, 0, 2))
        batch = x.shape[1]
        nstates = self.num_layers * self.bidirect
        if initial_states is None:
            shape = (nstates, batch, self.hidden_size)
            h0_all = _zeros(shape, x)
            c0_all = _zeros(shape, x) if self.mode == "LSTM" else None
        elif self.mode == "LSTM":
            h0_all, c0_all = initial_states
        else:
            h0_all, c0_all = initial_states, None
        h_outs, c_outs = [], []
        idx = 0
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.bidirect):
                c0 = c0_all[idx] if c0_all is not None else None
                y, h, c = self._run_layer(x, h0_all[idx], c0,
                                          self._all_weights[idx],
                                          reverse=bool(d))
                outs.append(y)
                h_outs.append(h)
                if c is not None:
                    c_outs.append(c)
                idx += 1
            x = outs[0] if len(outs) == 1 else manipulation.concat(outs,
                                                                   axis=-1)
            if self.dropout and layer < self.num_layers - 1:
                x = nn_ops.dropout(x, p=self.dropout, training=self.training)
        y = x
        if not self.time_major:
            y = manipulation.transpose(y, (1, 0, 2))
        h_final = manipulation.stack(h_outs, axis=0)
        if self.mode == "LSTM":
            return y, (h_final, manipulation.stack(c_outs, axis=0))
        return y, h_final


class LSTM(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)


class GRU(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)


class SimpleRNN(RNNBase):
    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        mode = "RNN_TANH" if activation == "tanh" else "RNN_RELU"
        super().__init__(mode, input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)


def _cell_params(layer, gates, input_size, hidden_size, attrs):
    std = 1.0 / (hidden_size ** 0.5)
    w_ih_attr, w_hh_attr, b_ih_attr, b_hh_attr = attrs
    for n, shape, attr, is_bias in (
            ("weight_ih", (gates * hidden_size, input_size), w_ih_attr, False),
            ("weight_hh", (gates * hidden_size, hidden_size), w_hh_attr,
             False),
            ("bias_ih", (gates * hidden_size,), b_ih_attr, True),
            ("bias_hh", (gates * hidden_size,), b_hh_attr, True)):
        setattr(layer, n, layer.create_parameter(
            shape, attr, is_bias=is_bias,
            default_initializer=init_mod.Uniform(-std, std)))


class LSTMCell(Layer):
    """One LSTM step; in the reference (and here) a ``Layer``, not an
    ``RNNCellBase``."""

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.hidden_size = hidden_size
        _cell_params(self, 4, input_size, hidden_size,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                      bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            b = inputs.shape[0]
            h = _zeros((b, self.hidden_size), inputs)
            c = _zeros((b, self.hidden_size), inputs)
        else:
            h, c = states
        x1 = manipulation.unsqueeze(inputs, axis=0)
        _, h_new, c_new = _lstm_layer(x1, h, c, self.weight_ih,
                                      self.weight_hh, self.bias_ih,
                                      self.bias_hh, reverse=False, cell=True)
        return h_new, (h_new, c_new)


class GRUCell(Layer):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.hidden_size = hidden_size
        _cell_params(self, 3, input_size, hidden_size,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                      bias_hh_attr))

    def forward(self, inputs, states=None):
        if states is None:
            states = _zeros((inputs.shape[0], self.hidden_size), inputs)
        x1 = manipulation.unsqueeze(inputs, axis=0)
        _, h_new = _gru_layer(x1, states, self.weight_ih, self.weight_hh,
                              self.bias_ih, self.bias_hh, reverse=False,
                              cell=True)
        return h_new, h_new


class RNNCellBase(Layer):
    """The protocol of a cell for ``RNN``, ``BiRNN`` and
    ``dynamic_decode``: ``forward(inputs, states) -> (outputs,
    new_states)`` and ``get_initial_states``."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        """``init_value``-filled ``[B, hidden_size]`` states on
        ``batch_ref``'s device (``shape`` is taken and not read; the
        ``LSTMCell`` branch never runs, since ``LSTMCell`` is no
        ``RNNCellBase``, as in the reference)."""
        from ...core import dtype as dtype_mod
        b = batch_ref.shape[batch_dim_idx]
        hs = getattr(self, "hidden_size")
        dt = dtype_mod.to_torch_dtype(dtype or "float32")
        dev = batch_ref._v.device

        def full():
            return Tensor._wrap(torch.full((b, hs), init_value, dtype=dt,
                                           device=dev))
        if isinstance(self, LSTMCell):
            return full(), full()
        return full()

    @property
    def state_shape(self):
        hs = getattr(self, "hidden_size")
        if isinstance(self, LSTMCell):
            return ((hs,), (hs,))
        return (hs,)


class SimpleRNNCell(RNNCellBase):
    """One tanh (or relu) step built of ``matmul``, ``add`` and ``tanh``
    as the reference builds it, so under O1 its products are bf16 while
    ``SimpleRNN``'s op stays f32."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.activation = activation
        _cell_params(self, 1, input_size, hidden_size,
                     (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                      bias_hh_attr))

    def forward(self, inputs, states=None):
        from ...ops import math as m, nn_ops
        if states is None:
            states = self.get_initial_states(inputs)
        pre = m.add(
            m.add(m.matmul(inputs, manipulation.t(self.weight_ih)),
                  self.bias_ih),
            m.add(m.matmul(states, manipulation.t(self.weight_hh)),
                  self.bias_hh))
        out = nn_ops.relu(pre) if self.activation == "relu" \
            else m.tanh(pre)
        return out, out


class RNN(Layer):
    """Any cell scanned over the time axis by a Python loop."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        x = inputs if self.time_major else \
            manipulation.transpose(inputs, (1, 0, 2))
        T = x.shape[0]
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        states = initial_states
        outs = [None] * T
        for t in steps:
            y, states = self.cell(x[t], states)
            outs[t] = y
        out = manipulation.stack(outs, axis=0)
        if not self.time_major:
            out = manipulation.transpose(out, (1, 0, 2))
        return out, states


class BiRNN(Layer):
    """A forward and a backward cell, outputs concatenated on the feature
    axis."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        ifw = ibw = None
        if initial_states is not None:
            ifw, ibw = initial_states
        out_f, st_f = self.rnn_fw(inputs, ifw)
        out_b, st_b = self.rnn_bw(inputs, ibw)
        out = manipulation.concat([out_f, out_b], axis=-1)
        return out, (st_f, st_b)


class BeamSearchDecoder(Layer):
    """Beam expansion over a cell and an output layer, run by
    ``dynamic_decode``."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        super().__init__()
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn


def dynamic_decode(decoder, inits=None, max_step_num=32, **kwargs):
    """The reference's beam search (rnn.py:400-477), driven from the host:
    beam 0 starts at 0 and beams 1..k-1 at -1e9; a finished beam may only
    emit ``end_token``, at no cost; the top-k over ``beam x V`` picks
    ``parent = i // V`` and ``word = i % V``, the finished flags and the
    states (a flat tuple of ``[B, H]``, or one) are regathered by parent;
    it always runs ``max_step_num`` steps, then ``gather_tree``. The
    top-k is ``topk``'s, which orders ties as ``lax.top_k`` does (beam
    scores of ``-1e9 + log p`` round many candidates to one f32 value).
    Returns ``(ids [B, T, beam], final_states)``."""
    from ...ops import math as m, nn_ops, search
    cell = decoder.cell
    beam = decoder.beam_size
    if inits is None:
        raise ValueError("dynamic_decode requires initial states (inits)")
    states = inits
    h0 = states[0] if isinstance(states, (tuple, list)) else states
    b = h0.shape[0]
    dev = h0._v.device

    def tile(t):
        return manipulation.reshape(
            manipulation.tile(manipulation.unsqueeze(t, 1), (1, beam, 1)),
            (b * beam, -1))
    if isinstance(states, (tuple, list)):
        states = type(states)(tile(s) for s in states)
    else:
        states = tile(states)
    tok = Tensor._wrap(torch.full((b * beam,), decoder.start_token,
                                  dtype=torch.int64, device=dev))
    log_probs = torch.full((b, beam), -1e9, dtype=torch.float32, device=dev)
    log_probs[:, 0] = 0.0
    finished = torch.zeros((b, beam), dtype=torch.bool, device=dev)
    end = decoder.end_token
    offsets = (torch.arange(b, device=dev) * beam)[:, None]
    ids_steps, parents_steps = [], []
    for _ in range(max_step_num):
        emb = decoder.embedding_fn(tok) if decoder.embedding_fn \
            else manipulation.unsqueeze(m.cast(tok, "float32"), -1)
        out, states = cell(emb, states)
        logits = decoder.output_fn(out) if decoder.output_fn else out
        logp = nn_ops.log_softmax(logits, axis=-1).value
        V = logp.shape[-1]
        logp = logp.reshape(b, beam, V)
        frozen = torch.full((V,), -1e9, dtype=logp.dtype, device=dev)
        frozen[end] = 0.0
        logp = torch.where(finished[..., None], frozen, logp)
        total = log_probs[..., None] + logp
        top_v, top_i = search.topk(Tensor._wrap(total.reshape(b, beam * V)),
                                   beam)
        log_probs, top_i = top_v.value, top_i.value
        parent = top_i // V
        word = top_i % V
        ids_steps.append(word)
        parents_steps.append(parent)
        finished = torch.gather(finished, -1, parent) | (word == end)
        flat_parent = (parent + offsets).reshape(-1)

        def regather(s):
            return Tensor._wrap(torch.index_select(s.value, 0, flat_parent))
        if isinstance(states, (tuple, list)):
            states = type(states)(regather(s) for s in states)
        else:
            states = regather(states)
        tok = Tensor._wrap(word.reshape(b * beam))
    seqs = nn_ops.gather_tree(Tensor._wrap(torch.stack(ids_steps)),
                              Tensor._wrap(torch.stack(parents_steps)))
    return manipulation.transpose(seqs, (1, 0, 2)), states
