"""``paddle.vision`` of the port (a port of ``paddle_tpu/vision``):
``models`` (LeNet, the ResNets, VGG, MobileNet V1/V2), ``ops``,
``transforms``, ``datasets`` and the image backend."""
from . import datasets, models, ops, transforms  # noqa: F401

_image_backend = ["pil"]


def set_image_backend(backend):
    """``'pil'`` or ``'cv2'``."""
    if backend not in ("pil", "cv2"):
        raise ValueError(f"unknown image backend {backend!r}")
    _image_backend[0] = backend


def get_image_backend():
    return _image_backend[0]


def image_load(path, backend=None):
    """The image at ``path`` through PIL (imported here); the ``cv2``
    backend raises, as the reference's does."""
    backend = backend or _image_backend[0]
    if backend == "cv2":
        raise RuntimeError("cv2 is not available in this build; use 'pil'")
    from PIL import Image
    return Image.open(path)
