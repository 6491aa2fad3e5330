"""Legacy Fleet base (reference: fluid/incubate/fleet/base/fleet_base.py:42
`Fleet`, :273 `DistributedOptimizer`).

Every query/lifecycle verb delegates to the modern
`paddle.distributed.fleet` module-level API, so a legacy `fleet`
singleton and the modern one observe the same runtime state.
"""
from .....distributed import fleet as _modern
from .mode import Mode


class Fleet:
    """Abstract legacy fleet. Subclasses: Collective (collective mode),
    FleetTranspiler (parameter-server mode)."""

    def __init__(self, mode):
        self._mode = mode
        self._role_maker = None
        self._optimizer = None

    # --- queries (reference fleet_base.py:61-153) ---
    def is_first_worker(self):
        return _modern.is_first_worker()

    def worker_index(self):
        return _modern.worker_index()

    def worker_num(self):
        return _modern.worker_num()

    def is_worker(self):
        return _modern.is_worker()

    def worker_endpoints(self, to_string=False):
        return _modern.worker_endpoints(to_string=to_string)

    def server_num(self):
        return _modern.server_num()

    def server_index(self):
        return _modern.server_index()

    def server_endpoints(self, to_string=False):
        return _modern.server_endpoints(to_string=to_string)

    def is_server(self):
        return _modern.is_server()

    def is_xpu(self):
        return False

    def split_files(self, files):
        """Shard a file list across workers (reference :163)."""
        return _modern.util.get_file_shard(files)

    def barrier_worker(self):
        _modern.barrier_worker()

    def all_reduce_worker(self, input, output=None):  # noqa: A002
        res = _modern.util.all_reduce(input, mode="sum",
                                      comm_world="worker")
        if output is not None:
            # legacy contract: the caller-provided buffer receives the
            # reduction (reference fleet_base.py:222). np.asarray on a
            # list/Tensor would copy, silently dropping the write, so
            # only buffers we can genuinely mutate are accepted.
            import numpy as np
            arr = np.asarray(res)
            if isinstance(output, np.ndarray):
                output[...] = arr
            elif isinstance(output, list):
                output[:] = np.atleast_1d(arr).tolist()
            elif hasattr(output, "set_value"):  # a port Tensor —
                # set_value validates shape and goes through the
                # trace-aware value setter (a raw _value write would be
                # invisible to an active trace)
                output.set_value(arr)
            else:
                raise TypeError(
                    "all_reduce_worker: cannot write in place into "
                    f"{type(output).__name__}; pass an ndarray/list/"
                    "Tensor or use the return value")
        return res

    # --- lifecycle ---
    def init(self, role_maker=None):
        # In the legacy API the FLEET INSTANCE determines the mode
        # (Collective vs FleetTranspiler), not the role maker; the
        # modern init branches solely on role_maker._is_collective, so
        # stamp the instance's mode onto the role maker.
        is_coll = self._mode == Mode.COLLECTIVE
        if role_maker is None:
            from .role_maker import PaddleCloudRoleMaker
            role_maker = PaddleCloudRoleMaker(is_collective=is_coll)
        else:
            role_maker._is_collective = is_coll
        self._role_maker = role_maker
        _modern.init(role_maker=role_maker, is_collective=is_coll)
        return self

    def init_worker(self):
        _modern.init_worker()

    def init_server(self, model_dir=None, **kwargs):
        _modern.init_server(model_dir, **kwargs)

    def run_server(self):
        _modern.run_server()

    def stop_worker(self):
        _modern.stop_worker()

    def distributed_optimizer(self, optimizer, strategy=None):
        raise NotImplementedError

    def save_inference_model(self, executor=None, dirname=None,
                             feeded_var_names=None, target_vars=None,
                             main_program=None, export_for_deployment=True):
        return _modern.save_inference_model(
            executor, dirname, feeded_var_names, target_vars,
            main_program, export_for_deployment=export_for_deployment)

    def save_persistables(self, executor=None, dirname=None,
                          main_program=None):
        return _modern.save_persistables(executor, dirname, main_program)


class DistributedOptimizer:
    """Legacy distributed-optimizer wrapper (reference :273): holds the
    inner optimizer; minimize() is the entry point."""

    def __init__(self, optimizer, strategy=None):
        self._optimizer = optimizer
        self._strategy = strategy
        # the modern wrap (meta-optimizers + hybrid clip) is stateful —
        # e.g. GradientMerge accumulation counters — so it must be
        # built ONCE and reused across minimize() calls
        self._modern_opt = None

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        loss.backward()
        return []

    def apply_gradients(self, params_grads):
        self._optimizer.step()

    def _wrapped(self):
        if self._modern_opt is None:
            self._modern_opt = _modern.distributed_optimizer(
                self._optimizer)
        return self._modern_opt

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        return self._wrapped().minimize(loss,
                                        startup_program=startup_program)
