"""Vision transforms (a port of ``paddle_tpu/vision/transforms``): numpy
CHW float implementations of the common set, host-side. The random ones
draw from numpy's global generator, as the reference's do, so a
``np.random.seed`` gives both packages the same draws. ``Resize`` is
``jax.image.resize``'s antialiased linear resize there, and the port's
own (``ops.nn_ops.image_resize``, on the CPU) here; its
``interpolation`` is taken and, as in the reference, not read."""
import numpy as np
import torch


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class Normalize:
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, img):
        img = np.asarray(img, np.float32)
        return (img - self.mean) / self.std


class ToTensor:
    def __init__(self, data_format="CHW"):
        pass

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        elif arr.ndim == 3 and arr.shape[-1] in (1, 3, 4):
            arr = arr.transpose(2, 0, 1)
        if arr.max() > 1.5:
            arr = arr / 255.0
        return arr


class Resize:
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        from ...ops.nn_ops import image_resize
        arr = np.asarray(img, np.float32)
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3, 4)
        if not chw and arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        out = image_resize(torch.from_numpy(np.ascontiguousarray(arr)),
                           (arr.shape[0],) + self.size, "linear")
        return out.numpy()


class RandomHorizontalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.ascontiguousarray(np.asarray(img)[..., ::-1])
        return np.asarray(img)


class RandomCrop:
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def __call__(self, img):
        arr = np.asarray(img)
        if self.padding:
            arr = np.pad(arr, ((0, 0), (self.padding, self.padding),
                               (self.padding, self.padding)), mode="constant")
        h, w = arr.shape[-2:]
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        return arr[..., i:i + th, j:j + tw]


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[-2:]
        th, tw = self.size
        i = (h - th) // 2
        j = (w - tw) // 2
        return arr[..., i:i + th, j:j + tw]


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


class BaseTransform:
    """Subclass and implement ``_apply_image`` (and ``_apply_<key>`` for
    the other ``keys``)."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        if self.keys is None:
            return self._apply_image(inputs)
        inputs = list(inputs)
        for i, k in enumerate(self.keys):
            fn = getattr(self, f"_apply_{k}", None)
            if fn is not None:
                inputs[i] = fn(inputs[i])
        return tuple(inputs)

    def _apply_image(self, img):
        return img


class RandomVerticalFlip:
    def __init__(self, prob=0.5):
        self.prob = prob

    def __call__(self, img):
        if np.random.rand() < self.prob:
            return np.ascontiguousarray(np.asarray(img)[..., ::-1, :])
        return np.asarray(img)


class Transpose:
    """HWC -> CHW by default."""

    def __init__(self, order=(2, 0, 1)):
        self.order = tuple(order)

    def __call__(self, img):
        return np.asarray(img).transpose(self.order)


class RandomResizedCrop:
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        h, w = arr.shape[-2:]
        area = h * w
        for _ in range(10):
            target = area * np.random.uniform(*self.scale)
            ar = np.exp(np.random.uniform(np.log(self.ratio[0]),
                                          np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target * ar)))
            ch = int(round(np.sqrt(target / ar)))
            if 0 < cw <= w and 0 < ch <= h:
                i = np.random.randint(0, h - ch + 1)
                j = np.random.randint(0, w - cw + 1)
                crop_arr = arr[..., i:i + ch, j:j + cw]
                return Resize(self.size)(crop_arr)
        return Resize(self.size)(CenterCrop(min(h, w))(arr))


def _rgb_to_gray(arr):
    # arr CHW with C==3
    r, g, b = arr[0], arr[1], arr[2]
    return 0.299 * r + 0.587 * g + 0.114 * b


class Grayscale:
    def __init__(self, num_output_channels=1):
        self.n = num_output_channels

    def __call__(self, img):
        arr = np.asarray(img, np.float32)
        if arr.shape[0] == 1:
            gray = arr[0]
        else:
            gray = _rgb_to_gray(arr)
        return np.repeat(gray[None], self.n, axis=0)


class BrightnessTransform:
    def __init__(self, value):
        self.value = float(value)

    def __call__(self, img):
        if self.value == 0:
            return np.asarray(img)
        alpha = np.random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, alpha)


class ContrastTransform:
    def __init__(self, value):
        if value < 0:
            raise ValueError("contrast value must be non-negative")
        self.value = float(value)

    def __call__(self, img):
        if self.value == 0:
            return np.asarray(img)
        alpha = np.random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, alpha)


class SaturationTransform:
    def __init__(self, value):
        self.value = float(value)

    def __call__(self, img):
        if self.value == 0:
            return np.asarray(img)
        alpha = np.random.uniform(max(0.0, 1 - self.value), 1 + self.value)
        return adjust_saturation(img, alpha)


class HueTransform:
    def __init__(self, value):
        if not 0 <= value <= 0.5:
            raise ValueError("hue value must be in [0, 0.5]")
        self.value = float(value)

    def __call__(self, img):
        if self.value == 0:
            return np.asarray(img)
        return adjust_hue(img, np.random.uniform(-self.value, self.value))


class ColorJitter:
    """The four jitters in a random order."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.ts = [BrightnessTransform(brightness),
                   ContrastTransform(contrast),
                   SaturationTransform(saturation), HueTransform(hue)]

    def __call__(self, img):
        order = np.random.permutation(len(self.ts))
        for i in order:
            img = self.ts[i](img)
        return img


class Pad:
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = (padding,) * 4 if isinstance(padding, int) else \
            (tuple(padding) * 2 if len(padding) == 2 else tuple(padding))
        self.fill = fill
        self.mode = padding_mode

    def __call__(self, img):
        arr = np.asarray(img)
        left, top, right, bottom = self.padding
        pad_width = ((0, 0), (top, bottom), (left, right))
        if self.mode == "constant":
            return np.pad(arr, pad_width, mode="constant",
                          constant_values=self.fill)
        return np.pad(arr, pad_width, mode=self.mode)


class RandomRotation:
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0):
        if isinstance(degrees, (int, float)):
            degrees = (-degrees, degrees)
        self.degrees = tuple(degrees)
        self.fill = fill

    def __call__(self, img):
        angle = np.random.uniform(*self.degrees)
        return rotate(img, angle, fill=self.fill)


def hflip(img):
    return np.ascontiguousarray(np.asarray(img)[..., ::-1])


def vflip(img):
    return np.ascontiguousarray(np.asarray(img)[..., ::-1, :])


def crop(img, top, left, height, width):
    return np.asarray(img)[..., top:top + height, left:left + width]


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


def pad(img, padding, fill=0, padding_mode="constant"):
    return Pad(padding, fill, padding_mode)(img)


def to_grayscale(img, num_output_channels=1):
    return Grayscale(num_output_channels)(img)


def adjust_brightness(img, brightness_factor):
    return np.asarray(img, np.float32) * brightness_factor


def adjust_contrast(img, contrast_factor):
    arr = np.asarray(img, np.float32)
    mean = _rgb_to_gray(arr).mean() if arr.shape[0] == 3 else arr.mean()
    return arr * contrast_factor + mean * (1 - contrast_factor)


def adjust_saturation(img, saturation_factor):
    arr = np.asarray(img, np.float32)
    if arr.shape[0] != 3:
        return arr
    gray = _rgb_to_gray(arr)[None]
    return arr * saturation_factor + gray * (1 - saturation_factor)


def adjust_hue(img, hue_factor):
    arr = np.asarray(img, np.float32)
    if hue_factor == 0 or arr.shape[0] != 3:
        return arr
    shift = hue_factor * 2 * np.pi
    u, w_ = np.cos(shift), np.sin(shift)
    t_yiq = np.array([[0.299, 0.587, 0.114],
                      [0.596, -0.274, -0.321],
                      [0.211, -0.523, 0.311]], np.float32)
    t_rot = np.array([[1, 0, 0], [0, u, -w_], [0, w_, u]], np.float32)
    t_rgb = np.linalg.inv(t_yiq) @ t_rot @ t_yiq
    return (t_rgb @ arr.reshape(3, -1)).reshape(arr.shape)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate CHW image by `angle` degrees (nearest sampling)."""
    arr = np.asarray(img, np.float32)
    h, w = arr.shape[-2:]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else center
    rad = -np.deg2rad(angle)  # positive angle = counterclockwise (PIL)
    cos_a, sin_a = np.cos(rad), np.sin(rad)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    # inverse mapping: output pixel -> source pixel
    sx = cos_a * (xx - cx) + sin_a * (yy - cy) + cx
    sy = -sin_a * (xx - cx) + cos_a * (yy - cy) + cy
    sxi = np.round(sx).astype(np.int64)
    syi = np.round(sy).astype(np.int64)
    valid = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
    sxi = np.clip(sxi, 0, w - 1)
    syi = np.clip(syi, 0, h - 1)
    out = arr[..., syi, sxi]
    out = np.where(valid, out, fill)
    return out.astype(arr.dtype)
