"""A port of ``paddle_tpu/dataset/image.py``.

Reference: dataset/image.py — HWC numpy image utilities (the
reference shells out to cv2; these are pure-numpy equivalents, with
PIL used only for file decoding when available)."""
import numpy as np

__all__ = []


def load_image_bytes(data, is_color=True):
    import io

    from PIL import Image
    img = Image.open(io.BytesIO(data))
    img = img.convert("RGB" if is_color else "L")
    return np.asarray(img)


def load_image(path, is_color=True):
    with open(path, "rb") as f:
        return load_image_bytes(f.read(), is_color)


def _resize(im, h, w):
    """Nearest-neighbor resize (HWC or HW)."""
    src_h, src_w = im.shape[:2]
    rows = (np.arange(h) * (src_h / h)).astype(int).clip(0, src_h - 1)
    cols = (np.arange(w) * (src_w / w)).astype(int).clip(0, src_w - 1)
    return im[rows][:, cols]


def resize_short(im, size):
    """Scale so the SHORT side equals `size` (reference :193)."""
    h, w = im.shape[:2]
    if h < w:
        return _resize(im, size, int(round(w * size / h)))
    return _resize(im, int(round(h * size / w)), size)


def to_chw(im, order=(2, 0, 1)):
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = max((h - size) // 2, 0)
    w0 = max((w - size) // 2, 0)
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = np.random.randint(0, max(h - size, 0) + 1)
    w0 = np.random.randint(0, max(w - size, 0) + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train,
                     is_color=True, mean=None):
    """Reference :323 — resize-short, crop (random+flip when training,
    center otherwise), CHW, optional mean subtraction."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color)
        if np.random.randint(2):
            im = left_right_flip(im, is_color)
    else:
        im = center_crop(im, crop_size, is_color)
    if im.ndim == 3:
        im = to_chw(im)
    im = im.astype("float32")
    if mean is not None:
        mean = np.asarray(mean, "float32")
        im = im - (mean if mean.ndim != 1 else mean[:, None, None])
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(load_image(filename, is_color), resize_size,
                            crop_size, is_train, is_color, mean)
