"""``paddle.inference`` (a port of ``paddle_tpu/inference/__init__.py``).

Reference parity: paddle/fluid/inference/api/analysis_predictor.h:82
AnalysisPredictor and the paddle_infer Python API (Config,
create_predictor, zero-copy input/output handles, PredictorPool). A
saved model is ``jit.save``'s program and parameters; the predictor runs
``jit.load``'s ``TranslatedLayer``: the program replayed as one CUDA
graph a feed signature on the card, through the port's kernels.

``Config.enable_use_gpu(memory_pool_init_size_mb, device_id)`` does what
it says: the predictor runs on ``cuda:<device_id>`` (the default device
is the current one, the card unless ``set_device('cpu')``). The knobs
that do nothing here warn once each, naming what runs instead:
``enable_tensorrt_engine`` and ``switch_ir_optim(False)``.

A ``PredictorPool``'s predictors share one copy of the parameters on the
device, each with its own executor and graphs, so threads serve
concurrently; captures take ``jit.save_load.CAPTURE_LOCK`` alone.
"""
import pickle
import warnings

import numpy as np
import torch

from ..core import device as device_mod
from ..jit.save_load import load_program, translated

_warned_knobs = set()

_RUNS_INSTEAD = ("the predictor replays the saved program as a CUDA graph "
                 "through the port's kernels")


def _warn_unsupported(knob, equivalent):
    """One warning per knob that does nothing here, naming what runs
    instead (a user flipping it deserves to learn that)."""
    if knob in _warned_knobs:
        return
    _warned_knobs.add(knob)
    warnings.warn(
        f"paddle.inference.Config.{knob} has no effect in paddle_tpu_torch: "
        f"{equivalent}", UserWarning, stacklevel=3)


class Config:
    """Reference: AnalysisConfig. The model path and execution knobs."""

    def __init__(self, prog_file=None, params_file=None):
        if prog_file is not None and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[:-len(".pdmodel")]
        self._model_prefix = prog_file
        self._enable_memory_optim = True
        self._device = None    # None: the current device

    def set_prog_file(self, path):
        self._model_prefix = path[:-len(".pdmodel")] \
            if path.endswith(".pdmodel") else path

    def model_dir(self):
        return self._model_prefix

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = torch.device("cuda", int(device_id))

    def enable_memory_optim(self, flag=True):
        self._enable_memory_optim = flag

    def switch_ir_optim(self, flag=True):
        if not flag:
            _warn_unsupported(
                "switch_ir_optim(False)",
                f"there is no IR pass pipeline to turn off; {_RUNS_INSTEAD}")

    def enable_tensorrt_engine(self, *a, **k):
        _warn_unsupported(
            "enable_tensorrt_engine",
            f"there is no TensorRT engine; {_RUNS_INSTEAD}, and "
            "paddle_tpu_torch.quantization (PTQ/QAT, convert_to_int8) runs "
            "int8 products")

    def disable_glog_info(self):
        pass  # a logging knob; nothing to warn about


class _IOHandle:
    def __init__(self, predictor, name, is_input):
        self._p = predictor
        self.name = name
        self._is_input = is_input

    def reshape(self, shape):
        pass

    def copy_from_cpu(self, arr):
        self._p._inputs[self.name] = np.asarray(arr)

    def copy_to_cpu(self):
        return self._p._outputs[self.name]

    def share_external_data(self, arr):
        self.copy_from_cpu(arr)


class Predictor:
    def __init__(self, config, _loaded=None):
        dev = device_mod.resolve_device(config._device)
        prefix = config.model_dir()
        if _loaded is None:
            _loaded = load_program(prefix, dev)
        self._layer = translated(_loaded, dev)
        with open(prefix + ".pdmeta", "rb") as f:
            meta = pickle.load(f)
        self._input_names = [f"x{i}" for i in range(meta["num_inputs"])]
        self._inputs = {}
        self._outputs = {}
        self._output_names = []
        # memory_optim (reference: AnalysisConfig::EnableMemoryOptim —
        # reuse/free buffers between runs): drop the previous run's
        # outputs before the next instead of keeping them resident
        self._memory_optim = bool(getattr(config,
                                          "_enable_memory_optim", True))

    @property
    def layer(self):
        """The TranslatedLayer this predictor runs."""
        return self._layer

    def get_input_names(self):
        return list(self._input_names)

    def get_input_handle(self, name):
        return _IOHandle(self, name, True)

    def run(self, inputs=None):
        if inputs is not None:  # direct call style
            arrs = [np.asarray(a) for a in inputs]
        else:
            arrs = [self._inputs[n] for n in self._input_names]
        if self._memory_optim:
            self._outputs = {}          # free previous run's outputs
        outs = self._layer.run(arrs, to_numpy=True)
        self._output_names = [f"out{i}" for i in range(len(outs))]
        self._outputs = dict(zip(self._output_names, outs))
        # staged inputs stay resident (reference AnalysisPredictor
        # semantics: run() is repeatable without re-copying inputs)
        if inputs is not None:
            return [self._outputs[n] for n in self._output_names]
        return True

    def get_output_names(self):
        return list(self._output_names) or ["out0"]

    def get_output_handle(self, name):
        return _IOHandle(self, name, False)


def create_predictor(config):
    return Predictor(config)


PrecisionType = type("PrecisionType", (), {"Float32": 0, "Half": 1,
                                           "Bfloat16": 2, "Int8": 3})
PlaceType = type("PlaceType", (), {"CPU": 0, "GPU": 1, "XPU": 2, "TPU": 4})


class DataType:  # reference: paddle_infer.DataType enum
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6


_DTYPE_BYTES = {DataType.FLOAT32: 4, DataType.INT64: 8,
                DataType.INT32: 4, DataType.UINT8: 1, DataType.INT8: 1,
                DataType.FLOAT16: 2, DataType.BFLOAT16: 2}


def get_num_bytes_of_data_type(dtype):
    return _DTYPE_BYTES[dtype]


def get_version():
    from .. import __version__
    return f"paddle_tpu_torch inference {__version__}"


def create_serving_engine(model, **kwargs):
    """Continuous-batching serving entry point, the multi-request
    analogue of create_predictor for autoregressive decode: the port's
    ``serving.ServingEngine`` over a live ``text.models.GPTForCausalLM``
    with the reference's knobs (num_slots, max_len, buckets, bucket_min,
    prefill_group_sizes, async_depth, eos_id, ...). A knob the port's
    ``ServingConfig`` refuses (``donate_buffers``: PyTorch has no buffer
    donation) raises there."""
    from ..serving import ServingEngine
    return ServingEngine(model, **kwargs)


class PredictorPool:
    """Reference: paddle_infer.PredictorPool — N predictors over one
    config (a thread each). The program and parameters are loaded once;
    each predictor runs them through its own executor, so its feeds,
    graphs and outputs are its own."""

    def __init__(self, config, size=1):
        loaded = load_program(config.model_dir(),
                              device_mod.resolve_device(config._device))
        self._predictors = [Predictor(config, loaded)
                            for _ in range(int(size))]

    def retrive(self, idx):  # reference spells it 'retrive'
        return self._predictors[idx]

    retrieve = retrive
