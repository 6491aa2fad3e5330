"""The port's public surface against the reference's, module by module.

For the top level and for every module of ``paddle_tpu/`` the public
names of the reference (its ``__all__`` where it is a literal list, else
the names its source binds at top level: functions, classes,
assignments and relative imports, the names not starting with ``_``;
read from the source, so nothing of JAX is imported) are attributes of
the module at the same path in ``paddle_tpu_torch/``, and every
reference module has such a module. ``LEFT_OUT`` lists each name and
file the port leaves out, with its reason; a name is in it only while
the port lacks it.
"""
import ast
import importlib
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "paddle_tpu")
PORT = os.path.join(ROOT, "paddle_tpu_torch")

IMPORT = ("an import the reference's module makes for its own use (a "
          "module alias, or a name public where it is defined); the port's "
          "module needs no such binding")
JAX_ONLY = "a JAX or XLA object, or a helper over one; the port has none"
OWN_AUTOGRAD = ("the reference's own autograd engine's node; the port runs "
                "torch's autograd")
JAX_RNG = ("the reference's JAX PRNG key generator; the port draws from "
           "torch.Generators (core.rng.default_generator)")
NO_GATE = ("the reference's switch between its Pallas paged kernel and the "
           "XLA gather path; the port's paged decode always launches its "
           "CUDA kernel (K4) on the card")

LEFT_OUT = {
    # files
    "core/jax_compat.py": {None: "shims over JAX versions' API; the port "
                                 "imports no JAX"},
    "ops/pallas_compat.py": {None: "shims over Pallas' API; the port's "
                                   "kernels are CUDA C++ (csrc/)"},
    # names, by reference module
    "analysis/concurrency.py": {"lint_jaxpr": JAX_ONLY},
    "amp/grad_scaler.py": {"register_op": IMPORT},
    "autograd/__init__.py": {"GradNode": OWN_AUTOGRAD},
    "core/__init__.py": dict.fromkeys(
        ["Parameter", "Tensor", "enable_grad", "is_grad_enabled",
         "no_grad", "register_op"], IMPORT),
    "core/dispatch.py": {"lazy_mod": IMPORT, "trace_mod": IMPORT},
    "core/dtype.py": {"to_jax_dtype": JAX_ONLY},
    "core/engine.py": {"GradNode": OWN_AUTOGRAD, "lazy_mod": IMPORT},
    "core/flags.py": {"init_compilation_cache": "XLA's persistent "
                      "compilation cache; the port compiles no programs "
                      "(its kernels build once into _build/)"},
    "core/lazy.py": {
        "add": "the reference's deferred add on JAX arrays (its engine's "
               "grad accumulation); the port accumulates in torch",
        "dispatch_vjp": "the reference's deferred jax.vjp; the port's "
                        "backward is torch's autograd",
        "ever_enabled": JAX_ONLY,
        "scalar_const": "XLA constants for the reference's traced "
                        "scalars; the port binds scalars as consts",
        "static_int_exponent": "the reference's pow lowering choice in "
                               "XLA; torch's pow needs none",
        "trace_mod": IMPORT},
    "core/rng.py": {"Generator": JAX_RNG, "next_key": JAX_RNG,
                    "Tensor": IMPORT, "register_op": IMPORT},
    "core/tensor.py": {"trace_mod": IMPORT},
    "distributed/collective.py": {"Tensor": IMPORT, "register_op": IMPORT,
                                  "topology": IMPORT},
    "distributed/fleet/distributed_embedding.py": dict.fromkeys(
        ["Layer", "Parameter", "Tensor", "init_mod", "nn_ops", "no_grad",
         "register_op", "shard_constraint"], IMPORT),
    "distributed/fleet/hybrid_optimizer.py": {"opt_mod": IMPORT,
                                              "topology": IMPORT},
    "distributed/fleet/meta_optimizers.py": {"no_grad": IMPORT,
                                             "register_op": IMPORT},
    "distributed/fleet/meta_parallel/mp_layers.py": dict.fromkeys(
        ["Layer", "init_mod", "nn_ops", "register_op", "shard_constraint"],
        IMPORT),
    "distributed/fleet/meta_parallel/parallel_wrappers.py": dict.fromkeys(
        ["Tensor", "manipulation", "math_ops"], IMPORT),
    "distributed/fleet/meta_parallel/random.py": {"Generator": JAX_RNG},
    "distributed/fleet/meta_parallel/sequence_parallel.py": {
        "Tensor": IMPORT, "register_op": IMPORT},
    "distributed/parallel.py": {"Layer": IMPORT, "Tensor": IMPORT},
    "distributed/sharding/__init__.py": {"trace_mod": IMPORT},
    "distributed/utils_recompute.py": dict.fromkeys(
        ["enable_grad", "no_grad", "rng_mod"], IMPORT),
    "distribution/__init__.py": {"register_op": IMPORT},
    "incubate/asp.py": {"no_grad": IMPORT},
    "incubate/moe.py": dict.fromkeys(
        ["Layer", "init_mod", "register_op", "shard_constraint"], IMPORT),
    "inference/__init__.py": {"Tensor": IMPORT},
    "jit/save_load.py": {"TracedFunction": IMPORT, "trace_mod": IMPORT},
    "nn/clip.py": {"register_op": IMPORT},
    "nn/layer/container.py": {"Parameter": IMPORT},
    "observability/__init__.py": {
        "executable_cost": "reads an XLA executable's cost analysis; the "
                           "port compiles no executables (its roofline "
                           "counts bytes and operations from shapes, "
                           "observability.perf)",
        "watch_jax_lowering": "hooks JAX's lowering; the port has none"},
    "observability/watchdog.py": {
        "executable_cost": "as observability.executable_cost",
        "watch_jax_lowering": "as observability.watch_jax_lowering"},
    "observability/perf/__init__.py": {
        "REF_HBM_BPS": "a TPU's peak rates, the "
                       "reference's fallback; the port's roofline reads "
                       "the card's by name (perf.roofline)",
        "REF_PEAK_FLOPS": "as REF_HBM_BPS"},
    "observability/perf/roofline.py": {"REF_HBM_BPS": "as perf.REF_HBM_BPS",
                                       "REF_PEAK_FLOPS": "as perf.REF_HBM_BPS"},
    "ops/__init__.py": {"patch_symbolic": "attaches the Tensor methods to "
                        "the reference's static Variable; the port's "
                        "Variable is a Tensor subclass and inherits them"},
    "ops/creation.py": {"trace_mod": IMPORT},
    "ops/fused_ce.py": {"register_op": IMPORT},
    "ops/math.py": {"trace_mod": IMPORT},
    "ops/nn_ops.py": {"rng_mod": IMPORT},
    "ops/paged_attention.py": dict.fromkeys(
        ["kernel_requested", "kernel_viable", "use_paged_kernel"], NO_GATE),
    "ops/reduction.py": {"dtype_mod": IMPORT},
    "optimizer/optimizer.py": {"no_grad": IMPORT},
    "optimizer/optimizers.py": {"register_op": IMPORT},
    "serving/engine.py": dict.fromkeys(
        ["TRASH_BLOCK", "abstract_signature", "device_memory_stats",
         "executable_cost"], IMPORT),
    "static/program.py": {"rec_slice": "the reference's slice of a "
                          "program's records for its JAX replay of a "
                          "backward; the port's program runs torch's "
                          "autograd"},
    "text/models.py": dict.fromkeys(
        ["ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
         "creation", "manipulation", "math_ops", "shard_constraint"], IMPORT),
    "utils/cpp_extension.py": {"Tensor": IMPORT},
}


def _reference_names(path):
    """(public names of the reference module's source, from __all__)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names, declared = set(), None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
                        if n.id == "__all__":
                            try:
                                declared = ast.literal_eval(node.value)
                            except ValueError:
                                pass
        elif isinstance(node, ast.ImportFrom) and node.level > 0:
            names.update(a.asname or a.name for a in node.names)
    if declared is not None:
        return set(declared), True
    return {n for n in names if not n.startswith("_")}, False


def _modules():
    out = []
    for dirpath, _, files in os.walk(REF):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), REF))
    return sorted(out)


def _port_module(rel):
    mod = "paddle_tpu_torch." + rel[:-3].replace(os.sep, ".")
    if mod.endswith(".__init__"):
        mod = mod[:-len(".__init__")]
    return importlib.import_module(mod)


@pytest.mark.parametrize("rel", _modules())
def test_reference_names_exist_in_the_port(rel):
    left = LEFT_OUT.get(rel, {})
    if None in left:
        assert not os.path.exists(os.path.join(PORT, rel)), \
            f"{rel} is ported now: take it out of LEFT_OUT"
        return
    assert os.path.exists(os.path.join(PORT, rel)), \
        f"no counterpart of paddle_tpu/{rel}"
    names, _ = _reference_names(os.path.join(REF, rel))
    port = _port_module(rel)
    missing = sorted(n for n in names if not hasattr(port, n))
    assert set(missing) == set(left), (
        f"{rel}: missing without a reason {sorted(set(missing) - set(left))}"
        f"; listed but present {sorted(set(left) - set(missing))}")
    for reason in left.values():
        assert reason


def test_every_left_out_entry_names_a_reference_module():
    assert set(LEFT_OUT) <= set(_modules())


def test_top_level_names():
    """The 23 names the port's top level lacked before this surface was
    closed, each bound."""
    import paddle_tpu_torch as paddle
    for name in ("batch", "check_shape", "compat", "disable_dygraph",
                 "dtype", "elementwise_mul", "enable_dygraph",
                 "get_cuda_rng_state", "hub", "in_dygraph_mode",
                 "is_grad_enabled_", "monkey_patch_math_varbase",
                 "monkey_patch_variable", "NPUPlace", "rank",
                 "set_cuda_rng_state", "set_grad_enabled",
                 "set_printoptions", "sysconfig", "tanh_", "TPUPlace",
                 "VarBase", "XPUPlace"):
        assert hasattr(paddle, name), name
