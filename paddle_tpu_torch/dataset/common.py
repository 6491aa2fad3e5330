"""A port of ``paddle_tpu/dataset/common.py``.

Reference: dataset/common.py — DATA_HOME + download/md5 helpers.
Zero-egress: download() only resolves already-present local files."""
import hashlib
import os

from ..utils.download import DATA_HOME  # noqa: F401

__all__ = []


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Resolve the local cached path for a dataset file. This
    environment has no egress: if the file is not already under
    DATA_HOME/<module_name>, raise with the expected location (the
    class-based datasets used by the delegating readers fall back to
    synthetic data instead of calling this)."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(dirname,
                            save_name or url.split("/")[-1])
    if os.path.exists(filename):
        if md5sum and md5file(filename) != md5sum:
            raise RuntimeError(
                f"{filename} exists but its md5 does not match {md5sum} "
                f"(corrupt or truncated copy — replace the file)")
        return filename
    raise RuntimeError(
        f"dataset file not present at {filename} and this host has no "
        f"network egress; place the file there manually or use the "
        f"class-based paddle.vision/text datasets (synthetic fallback)")
