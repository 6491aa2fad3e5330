"""fluid.io compat (a port of ``paddle_tpu/fluid/io.py``; reference
python/paddle/fluid/io.py: save_persistables/save_inference_model/
load_inference_model + the reader decorators re-exported). Forwards to
``static.save``/``load`` and ``jit.save``/``load``; ``model=`` may be a
Paddle-surface Layer or a ``torch.nn.Module`` (``jit.save``'s
``torch.export`` path)."""
from ..framework.io_utils import save, load  # noqa: F401
from ..reader import (  # noqa: F401
    map_readers, shuffle, chain, compose, buffered, firstn, cache,
    xmap_readers,
)


def save_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    """Reference: fluid/io.py save_persistables — walk the program's
    persistable vars and save them. The static Program tracks its
    persistables (static/program.py register_persist), so this forwards
    to static.save on that program."""
    import os
    from .. import static
    prog = main_program if main_program is not None \
        else static.default_main_program()
    os.makedirs(dirname or ".", exist_ok=True)
    path = os.path.join(dirname or ".", filename or "persistables")
    return static.save(prog, path)


def load_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    """Reference: fluid/io.py load_persistables counterpart. A file of
    this program (every name its own) loads by name. Names are counters
    of the package that made them, so a file the reference wrote names
    the same parameters otherwise: its parameters (``param_<n>``, the
    name both packages give a Parameter) are then matched by position
    with the program's Parameters, which the same fluid code makes in the
    same order, each of the same shape. The rest of such a file is not
    loaded: the reference's optimizer accumulators (the port's optimizer
    keeps its own state), and its batch norms' moving statistics, which
    its static program freezes at their first run's values beside values
    it took at build."""
    import os
    import re
    from .. import static
    from ..core.tensor import Parameter
    prog = main_program if main_program is not None \
        else static.default_main_program()
    path = os.path.join(dirname or ".", filename or "persistables")
    state = static.load_program_state(path)
    if not set(state) <= set(prog.persist):
        mine = [n for n, t in prog.persist.items()
                if isinstance(t, Parameter)]
        theirs = [a for k, a in state.items()
                  if re.fullmatch(r"param_\d+", k)]
        if len(mine) != len(theirs) or any(
                tuple(prog.persist[n].shape) != tuple(a.shape)
                for n, a in zip(mine, theirs)):
            raise ValueError(
                f"{path}.pdparams: its {len(theirs)} parameters match "
                f"neither the names nor the order and shapes of the "
                f"program's {len(mine)}")
        state = dict(zip(mine, theirs))
    static.set_program_state(prog, state)


def save_inference_model(dirname, feeded_var_names=None, target_vars=None,
                         executor=None, main_program=None, model=None,
                         input_spec=None, **kwargs):
    from .. import jit
    if model is None:
        raise NotImplementedError(
            "pass model= (an nn.Layer or a torch.nn.Module): this stack "
            "exports through jit.save, not ProgramDesc files")
    return jit.save(model, dirname, input_spec=input_spec)


def load_inference_model(dirname, executor=None, **kwargs):
    from .. import jit
    return jit.load(dirname)
