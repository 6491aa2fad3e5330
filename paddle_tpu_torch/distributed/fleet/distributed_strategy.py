"""DistributedStrategy (a copy of
``paddle_tpu/distributed/fleet/distributed_strategy.py``, which imports
nothing of JAX: the port keeps its own).

Reference parity: python/paddle/distributed/fleet/base/distributed_strategy.py
backed by paddle/fluid/framework/distributed_strategy.proto:159-211. Plain
python properties instead of protobuf; the accepted keys mirror the proto
fields so reference configs port directly. ``check_conflicts`` takes the
world size (ranks) where the reference takes the device count.
"""
import copy


class DistributedStrategy:
    def __init__(self):
        # proto defaults (distributed_strategy.proto:159-211)
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0, "incr_every_n_steps": 1000,
            "decr_every_n_nan_or_inf": 2, "incr_ratio": 2.0,
            "decr_ratio": 0.8, "use_dynamic_loss_scaling": True,
            "custom_white_list": [], "custom_black_list": [],
            "use_pure_fp16": False, "use_bf16": True,
        }
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.sharding = False
        self.sharding_configs = {"sharding_degree": 1, "stage": 1,
                                 "offload": False}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lars = False
        self.lars_configs = {}
        self.lamb = False
        self.lamb_configs = {}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "rampup_step": 1,
                            "sparsity": [0.999]}
        self.fp16_allreduce = False
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.adaptive_localsgd = False
        self.adaptive_localsgd_configs = {"init_k_steps": 1, "begin_step": 1}
        self.a_sync = False
        self.a_sync_configs = {}
        self.elastic = False
        self.auto = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sp_degree": 1,
        }
        self.find_unused_parameters = False
        self.heter_ccl_mode = False

    _DEGREE_KEYS = ("dp_degree", "mp_degree", "pp_degree",
                    "sharding_degree", "sp_degree")

    def __setattr__(self, key, value):
        if key == "hybrid_configs" and hasattr(self, "hybrid_configs"):
            # validate instead of silently absorbing typos: a misspelled
            # degree key would otherwise quietly stay 1 (reference:
            # distributed_strategy.py check_configs_key)
            unknown = set(value) - set(self._DEGREE_KEYS)
            if unknown:
                raise ValueError(
                    f"unknown hybrid_configs keys {sorted(unknown)}; "
                    f"valid keys: {list(self._DEGREE_KEYS)}")
            for k, v in value.items():
                if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                    raise ValueError(
                        f"hybrid_configs[{k!r}] must be a positive int, "
                        f"got {v!r}")
            merged = dict(self.hybrid_configs)
            merged.update(value)
            object.__setattr__(self, key, merged)
            return
        if key.endswith("_configs") and hasattr(self, key) \
                and isinstance(getattr(self, key), dict) \
                and isinstance(value, dict):
            known = set(getattr(self, key))
            unknown = set(value) - known
            if known and unknown:
                raise ValueError(
                    f"unknown {key} keys {sorted(unknown)}; valid: "
                    f"{sorted(known)}")
            merged = dict(getattr(self, key))
            merged.update(value)
            object.__setattr__(self, key, merged)
            return
        if not hasattr(self, key) and hasattr(self, "heter_ccl_mode"):
            # object fully constructed: unknown attribute = typo
            raise AttributeError(
                f"DistributedStrategy has no field {key!r} (reference "
                "proto: distributed_strategy.proto:159-211)")
        object.__setattr__(self, key, value)

    # the meta-optimizers, which the port does not run yet (queue 1 item 13)
    META_OPTIMIZERS = ("gradient_merge", "lars", "lamb", "dgc",
                       "fp16_allreduce", "localsgd", "adaptive_localsgd")

    def check_conflicts(self, device_count=None):
        """Minimal strategy-compiler conflict rules (reference:
        fleet/base/strategy_compiler.py + meta-optimizer
        _can_apply/_disable_strategy chains)."""
        errs = []
        if self.a_sync and (self.pipeline or self.tensor_parallel
                            or self.sharding):
            errs.append("a_sync (parameter-server mode) cannot combine "
                        "with pipeline/tensor_parallel/sharding")
        if self.dgc and self.fp16_allreduce:
            errs.append("dgc and fp16_allreduce are mutually exclusive")
        if (self.localsgd or self.adaptive_localsgd) and self.pipeline:
            errs.append("localsgd cannot combine with pipeline")
        if self.localsgd and self.adaptive_localsgd:
            errs.append("localsgd and adaptive_localsgd are exclusive")
        hc = self.hybrid_configs
        total = 1
        for k in self._DEGREE_KEYS:
            total *= hc.get(k, 1)
        if device_count is not None and total not in (1, device_count):
            errs.append(
                f"hybrid degrees multiply to {total} but "
                f"{device_count} ranks are available")
        if errs:
            raise ValueError("DistributedStrategy conflicts: "
                             + "; ".join(errs))
        return True

    def __repr__(self):
        flags = [k for k in ("amp", "recompute", "pipeline", "tensor_parallel",
                             "sharding", "gradient_merge", "lars", "lamb",
                             "dgc", "localsgd", "a_sync")
                 if getattr(self, k)]
        return f"DistributedStrategy(enabled={flags}, hybrid={self.hybrid_configs})"

    def copy(self):
        return copy.deepcopy(self)
