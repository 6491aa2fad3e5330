#!/usr/bin/env python3
"""What the card holds after each Paddle-surface phase (19-27) of another
checkout's chip_smoke.py, printed as this checkout's chip_smoke.py prints
it after its own phases (``memory_report``): allocated and reserved GiB
after a garbage collection and ``torch.cuda.empty_cache``, the CUDA
graphs alive, and the reserved segments of the default pool and of the
graph pools with the GiB in use in them.

    python3 tools/phase_memory.py TREE [chip_smoke.py arguments]

TREE is a checkout of the repository (an older commit's, unpacked with
``git archive``): its chip_smoke.py runs from TREE with TREE's
paddle_tpu_torch, each phase function wrapped to print the report when
it returns. Needs one card; exits with that script's code.
"""
import functools
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = {"phase_core": 19, "phase_paddle_nn": 20, "phase_bert": 21,
          "phase_vision": 22, "phase_rnn": 23, "phase_static": 24,
          "phase_dy2static": 25, "phase_deploy": 26, "phase_lazy": 27}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    tree = os.path.abspath(sys.argv[1])
    report = _load("_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    os.chdir(tree)
    sys.path.insert(0, tree)
    smoke = _load("_smoke_tree", os.path.join(tree, "chip_smoke.py"))

    def wrap(fn, n):
        @functools.wraps(fn)
        def run(*a, **k):
            out = fn(*a, **k)
            import torch
            report.memory_report(torch, f"after phase {n}")
            return out
        return run

    for name, n in PHASES.items():
        if hasattr(smoke, name):
            setattr(smoke, name, wrap(getattr(smoke, name), n))
    sys.argv = [os.path.join(tree, "chip_smoke.py")] + sys.argv[2:]
    sys.exit(smoke.main())


if __name__ == "__main__":
    main()
