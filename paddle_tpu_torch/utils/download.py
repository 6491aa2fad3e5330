"""Where datasets and weights are looked for (the port's copy of
``paddle_tpu/utils/download.py``). Nothing is downloaded: a file must
already be in place, or ``get_path_from_url`` raises."""
import hashlib
import os

DATA_HOME = os.path.expanduser("~/.cache/paddle_tpu/dataset")
WEIGHTS_HOME = os.path.expanduser("~/.cache/paddle_tpu/weights")


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def get_path_from_url(url, root_dir=None, md5sum=None, check_exist=True):
    """The local copy of ``url``'s file under ``root_dir`` (default
    ``DATA_HOME``); raises where there is none. ``md5sum`` and
    ``check_exist`` are taken and, as in the reference, not read."""
    root_dir = root_dir or DATA_HOME
    fname = os.path.join(root_dir, os.path.basename(url))
    if os.path.exists(fname):
        return fname
    raise RuntimeError(
        f"downloads are disabled; place {os.path.basename(url)} under "
        f"{root_dir} (wanted from {url})")


def get_weights_path_from_url(url, md5sum=None):
    """The local copy of ``url``'s weights under ``WEIGHTS_HOME``."""
    return get_path_from_url(url, WEIGHTS_HOME, md5sum)
