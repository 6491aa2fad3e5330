"""``paddle.version`` (a port of ``paddle_tpu/version.py``; reference:
python/paddle/version.py, generated at build time there, static here).
``paddle_tpu_torch.__version__`` is ``full_version``.
"""
full_version = "2.1.0+tpu.0.1.0"
major = "2"
minor = "1"
patch = "0"
rc = "0"
commit = "torch-cuda-port"
istaged = False

__all__ = ["full_version", "major", "minor", "patch", "rc", "commit",
           "show"]


def show():
    print(f"full_version: {full_version}")
    print(f"major: {major}")
    print(f"minor: {minor}")
    print(f"patch: {patch}")
    print(f"rc: {rc}")
    print(f"commit: {commit}")
