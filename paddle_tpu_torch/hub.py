"""``paddle.hub`` (a port of ``paddle_tpu/hub.py``; Paddle's
``python/paddle/hub.py``): ``list``/``help``/``load`` of the model
entry points a repository's ``hubconf.py`` exposes.

A source is a local directory holding ``hubconf.py`` or an importable
module path (for example ``"paddle_tpu_torch.vision.models"``); the
reference's ``github``/``gitee`` sources raise, as they do there.
"""
import importlib
import importlib.util
import os
import sys


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, "hubconf.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no hubconf.py in {repo_dir}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["hubconf"] = mod
    spec.loader.exec_module(mod)
    return mod


def _resolve(repo_dir, source):
    if source in ("github", "gitee"):
        raise RuntimeError(
            "remote hub sources are unavailable in this environment; "
            "use source='local' with a directory containing hubconf.py, "
            "or an importable module path")
    if os.path.isdir(repo_dir):
        return _load_hubconf(repo_dir)
    return importlib.import_module(repo_dir)


def _entrypoints(mod):
    return {name: fn for name, fn in vars(mod).items()
            if callable(fn) and not name.startswith("_")
            and not isinstance(fn, type)}


def list(repo_dir, source="local", force_reload=False):  # noqa: A001
    """Names of callable model entrypoints exposed by the repo."""
    return sorted(_entrypoints(_resolve(repo_dir, source)))


def help(repo_dir, model, source="local", force_reload=False):  # noqa: A001
    fns = _entrypoints(_resolve(repo_dir, source))
    if model not in fns:
        raise ValueError(f"unknown model {model!r}; have {sorted(fns)}")
    return fns[model].__doc__


def load(repo_dir, model, source="local", force_reload=False, **kwargs):
    """Instantiate `model` from the repo's entrypoints."""
    fns = _entrypoints(_resolve(repo_dir, source))
    if model not in fns:
        raise ValueError(f"unknown model {model!r}; have {sorted(fns)}")
    return fns[model](**kwargs)
