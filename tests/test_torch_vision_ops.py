"""paddle_tpu_torch's ``vision.ops``, ``vision.transforms``,
``vision.datasets``, ``io``'s dataset classes and ``vision``'s image
backend against the JAX package's on the CPU: tests/test_vision_ops.py's
scenarios (yolo_box against its numpy golden, yolo_loss, nms, roi_align,
deform_conv2d against conv2d, read_file) in both packages and each op's
values and grads against the reference's on the same inputs;
tests/test_transforms.py's transform scenarios (:12-53, :73-76) in both
packages and every transform against the reference's (the random ones
after the same ``np.random.seed``: both draw from numpy's global
generator); the datasets from local files written here (MNIST's idx,
CIFAR's pickle archive, a folder of .npy images) and their seeded
stand-ins where no file is.

Values at f32 ``allclose`` rtol 1e-5 / atol 1e-5, grads at rtol 1e-4 /
atol 1e-5; ``Resize`` (the port's resize against ``jax.image.resize``)
at 1e-5.
"""
import gzip
import io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import device as device_mod

RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def on_the_cpu():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    paddle.set_device("cpu")
    yield
    device_mod._current_place = None
    torch.set_num_threads(before)


def V(P):
    return P.vision.ops


def T(P):
    return P.vision.transforms


def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def _yolo_box_np(x, img_size, anchors, class_num, conf_thresh, downsample,
                 clip_bbox=True, scale=1.0):
    n, c, h, w = x.shape
    an_num = len(anchors) // 2
    bias = -0.5 * (scale - 1.0)
    input_h, input_w = downsample * h, downsample * w
    boxes = np.zeros((n, an_num * h * w, 4), np.float32)
    scores = np.zeros((n, an_num * h * w, class_num), np.float32)
    pred = x.reshape(n, an_num, 5 + class_num, h, w)
    for b in range(n):
        img_h, img_w = img_size[b]
        idx = 0
        for k in range(an_num):
            for i in range(h):
                for j in range(w):
                    conf = _sig(pred[b, k, 4, i, j])
                    if conf >= conf_thresh:
                        cx = (j + _sig(pred[b, k, 0, i, j]) * scale
                              + bias) * img_w / w
                        cy = (i + _sig(pred[b, k, 1, i, j]) * scale
                              + bias) * img_h / h
                        bw = (np.exp(pred[b, k, 2, i, j]) * anchors[2 * k]
                              * img_w / input_w)
                        bh = (np.exp(pred[b, k, 3, i, j])
                              * anchors[2 * k + 1] * img_h / input_h)
                        x1, y1 = cx - bw / 2, cy - bh / 2
                        x2, y2 = cx + bw / 2, cy + bh / 2
                        if clip_bbox:
                            x1, y1 = max(x1, 0), max(y1, 0)
                            x2 = min(x2, img_w - 1)
                            y2 = min(y2, img_h - 1)
                        boxes[b, idx] = [x1, y1, x2, y2]
                        scores[b, idx] = conf * _sig(pred[b, k, 5:, i, j])
                    idx += 1
    return boxes, scores


@pytest.mark.parametrize("P", [ref, paddle], ids=["ref", "port"])
class TestVisionOpsScenarios:
    """tests/test_vision_ops.py, each scenario in both packages."""

    def test_yolo_box_matches_numpy(self, P):
        np.random.seed(0)
        anchors = [10, 13, 16, 30]
        x = np.random.randn(2, 2 * 8, 4, 4).astype("float32")
        img_size = np.array([[128, 128], [96, 64]], "int64")
        boxes, scores = V(P).yolo_box(P.to_tensor(x), P.to_tensor(img_size),
                                      anchors, 3, conf_thresh=0.3,
                                      downsample_ratio=32)
        eb, es = _yolo_box_np(x, img_size, anchors, 3, 0.3, 32)
        np.testing.assert_allclose(boxes.numpy(), eb, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(scores.numpy(), es, rtol=1e-4, atol=1e-5)

    def test_yolo_loss_finite_and_sensitive_to_targets(self, P):
        np.random.seed(1)
        x = P.to_tensor(np.random.randn(2, 3 * 9, 8, 8).astype("float32"))
        gt_box = np.zeros((2, 5, 4), "float32")
        gt_box[:, 0] = [0.5, 0.5, 0.3, 0.4]
        gt_label = np.zeros((2, 5), "int64")
        args = ([10, 13, 16, 30, 33, 23], [0, 1, 2], 4)
        loss = V(P).yolo_loss(x, P.to_tensor(gt_box), P.to_tensor(gt_label),
                              *args, ignore_thresh=0.7, downsample_ratio=32)
        assert loss.shape == [2] and np.all(np.isfinite(loss.numpy()))
        loss0 = V(P).yolo_loss(
            x, P.to_tensor(np.zeros((2, 5, 4), "float32")),
            P.to_tensor(gt_label), *args, ignore_thresh=0.7,
            downsample_ratio=32)
        assert not np.allclose(loss.numpy(), loss0.numpy())

    def test_nms_golden(self, P):
        boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30],
                          [0, 0, 9.8, 10]], "float32")
        scores = np.array([0.9, 0.8, 0.7, 0.95], "float32")
        keep = V(P).nms(P.to_tensor(boxes), iou_threshold=0.5,
                        scores=P.to_tensor(scores))
        assert keep.numpy().tolist() == [3, 2]
        cats = np.array([0, 1, 2, 3], "int64")
        keep2 = V(P).nms(P.to_tensor(boxes), 0.5, P.to_tensor(scores),
                         P.to_tensor(cats), categories=[0, 1, 2, 3])
        assert sorted(keep2.numpy().tolist()) == [0, 1, 2, 3]

    def test_roi_align_constant_map(self, P):
        x = np.full((1, 2, 8, 8), 7.0, np.float32)
        boxes = np.array([[0, 0, 8, 8], [2, 2, 6, 6]], "float32")
        out = V(P).roi_align(P.to_tensor(x), P.to_tensor(boxes),
                             P.to_tensor(np.array([2], "int32")),
                             output_size=2, spatial_scale=1.0,
                             aligned=False)
        assert tuple(out.shape) == (2, 2, 2, 2)
        np.testing.assert_allclose(out.numpy(), 7.0, rtol=1e-5)

    def test_deform_conv2d_zero_offsets_equals_conv2d(self, P):
        np.random.seed(2)
        x = np.random.randn(2, 4, 6, 6).astype("float32")
        w = np.random.randn(8, 4, 3, 3).astype("float32")
        offset = np.zeros((2, 18, 6, 6), "float32")
        out = V(P).deform_conv2d(P.to_tensor(x), P.to_tensor(offset),
                                 P.to_tensor(w), stride=1, padding=1)
        want = P.nn.functional.conv2d(P.to_tensor(x), P.to_tensor(w), None,
                                      1, 1, 1, 1)
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)

    def test_deform_conv2d_layer_and_mask(self, P):
        layer = V(P).DeformConv2D(4, 8, 3, padding=1, deformable_groups=1)
        x = P.to_tensor(np.random.randn(1, 4, 5, 5).astype("float32"))
        offset = P.to_tensor(
            0.1 * np.random.randn(1, 18, 5, 5).astype("float32"))
        mask = P.to_tensor(np.ones((1, 9, 5, 5), "float32"))
        out = layer(x, offset, mask)
        assert tuple(out.shape) == (1, 8, 5, 5)
        out.sum().backward()
        assert layer.weight.grad is not None

    def test_read_file_roundtrip(self, P, tmp_path):
        p = tmp_path / "blob.bin"
        p.write_bytes(bytes(range(16)))
        assert V(P).read_file(str(p)).numpy().tolist() == list(range(16))

    def test_nms_categories_filter_and_global_topk(self, P):
        boxes = P.to_tensor(np.array([
            [0, 0, 10, 10], [100, 100, 110, 110], [200, 200, 210, 210],
            [300, 300, 310, 310], [400, 400, 410, 410]], "float32"))
        scores = P.to_tensor(np.array([.9, .8, .7, .6, .5], "float32"))
        cats = P.to_tensor(np.array([0, 1, 0, 1, 2], "int64"))
        keep = V(P).nms(boxes, 0.5, scores=scores, category_idxs=cats,
                        categories=[0, 1]).numpy()
        np.testing.assert_array_equal(keep, [0, 1, 2, 3])
        keep1 = V(P).nms(boxes, 0.5, scores=scores, category_idxs=cats,
                         categories=[0, 1], top_k=1).numpy()
        np.testing.assert_array_equal(keep1, [0])
        keep_dup = V(P).nms(boxes, 0.5, scores=scores, category_idxs=cats,
                            categories=[0, 0]).numpy()
        np.testing.assert_array_equal(keep_dup, [0, 2])
        keep_t = V(P).nms(boxes, 0.5, scores=scores, category_idxs=cats,
                          categories=P.to_tensor(np.array([0], "int64")))
        np.testing.assert_array_equal(keep_t.numpy(), [0, 2])
        with pytest.raises(ValueError):
            V(P).nms(boxes, 0.5, scores=scores, categories=[1, 2])


def _cot(k, shape):
    return np.asarray(np.random.RandomState(100 + k).randn(*shape),
                      np.float32)


def _run(P, fn, inputs, grad_idx):
    ts = []
    for i, a in enumerate(inputs):
        t = P.to_tensor(a)
        if i in grad_idx:
            t.stop_gradient = False
        ts.append(t)
    out = fn(P, *ts)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    if grad_idx:
        total = None
        for k, o in enumerate(outs):
            term = (o * P.to_tensor(_cot(k, o.shape))).sum()
            total = term if total is None else total + term
        total.backward()
    return [o.numpy() for o in outs], [ts[i].grad.numpy() for i in grad_idx]


_rs = np.random.RandomState(0)
_GT = np.zeros((2, 4, 4), np.float32)
_GT[0, :2] = [[0.3, 0.4, 0.2, 0.3], [0.7, 0.6, 0.4, 0.2]]
_GT[1, 0] = [0.5, 0.5, 0.6, 0.5]
_BOXES = np.array([[0.5, 1.0, 6.0, 7.5], [2.2, 0.3, 7.9, 4.4],
                   [1.0, 1.0, 3.0, 3.0]], np.float32)
CASES = {
    "yolo_box_clip_scale": (lambda P, x, s: V(P).yolo_box(
        x, s, [10, 13, 16, 30], 3, conf_thresh=0.2, downsample_ratio=16,
        scale_x_y=1.2), [_rs.randn(2, 16, 3, 4).astype(np.float32),
                         np.array([[64, 80], [48, 48]], np.int64)], [0]),
    "yolo_box_no_clip": (lambda P, x, s: V(P).yolo_box(
        x, s, [10, 13], 2, conf_thresh=0.0, clip_bbox=False),
        [_rs.randn(1, 7, 2, 2).astype(np.float32),
         np.array([[64, 64]], np.int64)], [0]),
    "yolo_loss": (lambda P, x, b, lab: V(P).yolo_loss(
        x, b, lab, [10, 13, 16, 30, 33, 23, 30, 61], [1, 2], 3,
        ignore_thresh=0.5, downsample_ratio=8),
        [_rs.randn(2, 16, 4, 4).astype(np.float32), _GT,
         np.array([[1, 2, 0, 0], [0, 0, 0, 0]], np.int64)], [0]),
    "yolo_loss_no_smooth_scored": (lambda P, x, b, lab, sc: V(P).yolo_loss(
        x, b, lab, [10, 13, 16, 30, 33, 23], [0, 1, 2], 3,
        ignore_thresh=0.6, downsample_ratio=8, gt_score=sc,
        use_label_smooth=False),
        [_rs.randn(2, 24, 4, 4).astype(np.float32), _GT,
         np.array([[1, 2, 0, 0], [2, 0, 0, 0]], np.int64),
         np.array([[0.5, 1.0, 1, 1], [0.8, 1, 1, 1]], np.float32)], [0]),
    "deform_conv2d_offsets_mask_bias": (lambda P, x, o, w, m, b:
                                        V(P).deform_conv2d(
        x, o, w, b, stride=1, padding=1, mask=m),
        [_rs.randn(2, 4, 5, 5).astype(np.float32),
         (0.7 * _rs.randn(2, 18, 5, 5)).astype(np.float32),
         _rs.randn(6, 4, 3, 3).astype(np.float32),
         _rs.rand(2, 9, 5, 5).astype(np.float32),
         _rs.randn(6).astype(np.float32)], [0, 1, 2, 3, 4]),
    "deform_conv2d_groups_strided": (lambda P, x, o, w: V(P).deform_conv2d(
        x, o, w, stride=2, padding=1, dilation=1, deformable_groups=2,
        groups=2),
        [_rs.randn(1, 4, 6, 6).astype(np.float32),
         (0.5 * _rs.randn(1, 36, 3, 3)).astype(np.float32),
         _rs.randn(4, 2, 3, 3).astype(np.float32)], [0, 1, 2]),
    "roi_align_aligned": (lambda P, x, b: V(P).roi_align(
        x, b, np.array([2, 1]), output_size=(2, 3), spatial_scale=0.5,
        sampling_ratio=2),
        [_rs.randn(2, 3, 6, 5).astype(np.float32), _BOXES * 2], [0, 1]),
    "roi_align_not_aligned_default_ratio": (lambda P, x, b: V(P).roi_align(
        x, b, np.array([1, 2]), output_size=2, aligned=False),
        [_rs.randn(2, 2, 8, 8).astype(np.float32), _BOXES], [0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_vision_op_against_the_reference(name):
    fn, inputs, grad_idx = CASES[name]
    (w, wg), (g, gg) = (_run(P, fn, inputs, grad_idx) for P in (ref, paddle))
    for a, b in zip(g, w):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=ATOL)


def test_nms_random_boxes_against_the_reference():
    rs = np.random.RandomState(4)
    xy = rs.uniform(0, 50, (40, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(5, 20, (40, 2))],
                           1).astype(np.float32)
    scores = rs.rand(40).astype(np.float32)
    cats = rs.randint(0, 3, 40)
    for kw in (dict(), dict(category_idxs=cats),
               dict(category_idxs=cats, categories=[0, 2], top_k=7)):
        got = [V(P).nms(P.to_tensor(boxes), 0.4, P.to_tensor(scores),
                        **kw).numpy() for P in (ref, paddle)]
        np.testing.assert_array_equal(got[1], got[0])


def test_decode_jpeg_against_the_reference(tmp_path):
    from PIL import Image
    rgb = (np.random.RandomState(5).rand(6, 7, 3) * 255).astype(np.uint8)
    path = tmp_path / "img.jpg"
    Image.fromarray(rgb).save(path, quality=95)
    for mode in ("unchanged", "rgb", "gray"):
        got = [V(P).decode_jpeg(V(P).read_file(str(path)), mode).numpy()
               for P in (ref, paddle)]
        assert got[1].dtype == np.uint8 and got[1].shape == got[0].shape
        np.testing.assert_array_equal(got[1], got[0])


def _img():
    np.random.seed(5)
    return np.random.rand(3, 16, 16).astype("float32")


@pytest.mark.parametrize("P", [ref, paddle], ids=["ref", "port"])
class TestTransformScenarios:
    """tests/test_transforms.py:12-53 and :73-76, in both packages."""

    def test_geometric_transforms(self, P):
        img = _img()
        assert T(P).Pad(2)(img).shape == (3, 20, 20)
        assert T(P).Pad((1, 2))(img).shape == (3, 20, 18)
        np.testing.assert_allclose(T(P).rotate(img, 90),
                                   np.rot90(img, 1, axes=(1, 2)), atol=1e-4)
        np.testing.assert_allclose(T(P).hflip(img), img[..., ::-1])
        np.testing.assert_allclose(T(P).vflip(img), img[..., ::-1, :])
        assert T(P).RandomRotation(30)(img).shape == (3, 16, 16)
        assert T(P).RandomResizedCrop(8)(img).shape == (3, 8, 8)
        assert T(P).RandomVerticalFlip(1.0)(img).shape == (3, 16, 16)
        assert T(P).Transpose()(img.transpose(1, 2, 0)).shape == (3, 16, 16)
        assert T(P).crop(img, 2, 3, 5, 6).shape == (3, 5, 6)

    def test_color_transforms(self, P):
        img = _img()
        assert T(P).ColorJitter(0.2, 0.2, 0.2, 0.1)(img).shape == (3, 16, 16)
        g = T(P).Grayscale(1)(img)
        assert g.shape == (1, 16, 16)
        np.testing.assert_allclose(
            g[0], 0.299 * img[0] + 0.587 * img[1] + 0.114 * img[2],
            rtol=1e-5)
        np.testing.assert_allclose(T(P).adjust_brightness(img, 2.0),
                                   img * 2.0)
        np.testing.assert_allclose(T(P).adjust_hue(img, 0.0), img)
        h = T(P).adjust_hue(img, 0.25)
        assert h.shape == img.shape and not np.allclose(h, img)

    def test_base_transform_keys(self, P):
        class AddOne(T(P).BaseTransform):
            def __init__(self):
                super().__init__(keys=("image", "label"))

            def _apply_image(self, img):
                return img + 1

        img = _img()
        out_img, label = AddOne()((img, 7))
        np.testing.assert_allclose(out_img, img + 1)
        assert label == 7

    def test_adjust_hue_grayscale_no_crash(self, P):
        img = np.zeros((1, 8, 8), np.float32)
        np.testing.assert_allclose(T(P).adjust_hue(img, 0.1), img)


TRANSFORMS = {
    "Normalize": lambda P: T(P).Normalize([0.5, 0.4, 0.3], [0.2, 0.3, 0.4]),
    "ToTensor": lambda P: T(P).ToTensor(),
    "Resize_shrink": lambda P: T(P).Resize((7, 5)),
    "Resize_grow": lambda P: T(P).Resize(23),
    "Resize_hwc": lambda P: lambda img: T(P).Resize((9, 11))(
        img.transpose(1, 2, 0) * 255),
    "resize_fn": lambda P: lambda img: T(P).resize(img, (4, 20)),
    "RandomHorizontalFlip": lambda P: T(P).RandomHorizontalFlip(0.5),
    "RandomVerticalFlip": lambda P: T(P).RandomVerticalFlip(0.5),
    "RandomCrop": lambda P: T(P).RandomCrop(9, padding=2),
    "CenterCrop": lambda P: T(P).CenterCrop((5, 8)),
    "RandomResizedCrop": lambda P: T(P).RandomResizedCrop((6, 10)),
    "Grayscale3": lambda P: T(P).Grayscale(3),
    "BrightnessTransform": lambda P: T(P).BrightnessTransform(0.4),
    "ContrastTransform": lambda P: T(P).ContrastTransform(0.4),
    "SaturationTransform": lambda P: T(P).SaturationTransform(0.4),
    "HueTransform": lambda P: T(P).HueTransform(0.3),
    "ColorJitter": lambda P: T(P).ColorJitter(0.3, 0.3, 0.3, 0.2),
    "Pad_reflect": lambda P: T(P).Pad((1, 2, 3, 4), padding_mode="reflect"),
    "Pad_fill": lambda P: T(P).Pad(3, fill=0.5),
    "RandomRotation": lambda P: T(P).RandomRotation(40, fill=-1),
    "Compose": lambda P: T(P).Compose([T(P).CenterCrop(12),
                                       T(P).Resize(6),
                                       T(P).Normalize(0.5, 0.25)]),
    "to_grayscale": lambda P: lambda img: T(P).to_grayscale(img, 3),
    "adjust_contrast": lambda P: lambda img: T(P).adjust_contrast(img, 0.3),
    "adjust_saturation": lambda P: lambda img: T(P).adjust_saturation(img,
                                                                      1.7),
    "adjust_hue": lambda P: lambda img: T(P).adjust_hue(img, -0.2),
    "rotate_center": lambda P: lambda img: T(P).rotate(img, 33,
                                                       center=(4, 6)),
    "center_crop_pad_fns": lambda P: lambda img: T(P).pad(
        T(P).center_crop(img, 10), [1, 2]),
    "to_tensor_normalize_fns": lambda P: lambda img: T(P).normalize(
        T(P).to_tensor(img * 255), [0.1, 0.2, 0.3], [1, 2, 3]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_against_the_reference(name):
    img = np.random.RandomState(6).rand(3, 13, 15).astype(np.float32)
    got = []
    for P in (ref, paddle):
        np.random.seed(7)
        out = TRANSFORMS[name](P)(img)
        got.append(np.asarray(out))
    assert got[1].shape == got[0].shape
    np.testing.assert_allclose(got[1], got[0], rtol=RTOL, atol=ATOL)


def _write_mnist(root, prefix, n, seed):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    os.makedirs(root, exist_ok=True)
    ip = os.path.join(root, f"{prefix}-images-idx3-ubyte.gz")
    lp = os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp


def _same_samples(a, b, idx):
    for i in idx:
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_from_local_idx_files(tmp_path, cls):
    ip, lp = _write_mnist(str(tmp_path), "t10k", 7, 8)
    sets = [getattr(P.vision.datasets, cls)(
        image_path=ip, label_path=lp, mode="test",
        transform=T(P).Normalize(0.5, 0.5)) for P in (ref, paddle)]
    assert len(sets[1]) == len(sets[0]) == 7
    _same_samples(sets[0], sets[1], range(7))
    img, label = sets[1][3]
    assert img.shape == (1, 28, 28) and label.dtype == np.int64


def test_cifar_from_a_local_archive(tmp_path):
    rs = np.random.RandomState(9)
    path = tmp_path / "cifar-10-python.tar.gz"
    with tarfile.open(path, "w:gz") as tf:
        for name, n in (("data_batch_1", 5), ("test_batch", 3)):
            blob = pickle.dumps({b"data": rs.randint(
                0, 256, (n, 3072)).astype(np.uint8),
                b"labels": rs.randint(0, 10, n).tolist()})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    for mode, n in (("train", 5), ("test", 3)):
        sets = [P.vision.datasets.Cifar10(data_file=str(path), mode=mode)
                for P in (ref, paddle)]
        assert len(sets[1]) == len(sets[0]) == n
        _same_samples(sets[0], sets[1], range(n))


def test_stand_ins_where_no_file_is(tmp_path):
    """As the reference's: MNIST and Cifar stand in seeded FakeData of
    their shapes where the files are absent; Flowers and VOC2012 are such
    stand-ins; FakeData itself is seeded numpy."""
    missing = str(tmp_path / "absent")
    pairs = [
        [P.vision.datasets.MNIST(missing, missing, mode="test")
         for P in (ref, paddle)],
        [P.vision.datasets.Cifar100(data_file=missing, mode="test")
         for P in (ref, paddle)],
        [P.vision.datasets.Flowers(mode="valid") for P in (ref, paddle)],
        [P.vision.datasets.VOC2012() for P in (ref, paddle)],
        [P.vision.datasets.FakeData(20, (3, 8, 8), 4, seed=3)
         for P in (ref, paddle)],
    ]
    for a, b in pairs:
        assert len(a) == len(b)
        _same_samples(a, b, (0, len(a) // 2, len(a) - 1))


def test_folders_of_npy_images(tmp_path):
    rs = np.random.RandomState(10)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / cls / "sub")
        for i in range(2):
            np.save(tmp_path / cls / f"{i}.npy",
                    rs.rand(3, 4, 4).astype(np.float32))
        np.save(tmp_path / cls / "sub" / "x.npy",
                rs.rand(3, 4, 4).astype(np.float32))
        (tmp_path / cls / "notes.txt").write_text("not an image")
    for name in ("DatasetFolder", "ImageFolder"):
        sets = [getattr(P.vision.datasets, name)(str(tmp_path))
                for P in (ref, paddle)]
        assert len(sets[1]) == len(sets[0]) == 6
        _same_samples(sets[0], sets[1], range(6))
    assert paddle.vision.datasets.DatasetFolder(str(tmp_path)).classes == \
        ["cat", "dog"]
    os.makedirs(tmp_path / "empty")
    for P in (ref, paddle):
        with pytest.raises(RuntimeError):
            P.vision.datasets.ImageFolder(str(tmp_path / "empty"))


def test_io_dataset_classes():
    xs = np.arange(12, dtype=np.float32).reshape(6, 2)
    ys = np.arange(6)
    got = []
    for P in (ref, paddle):
        io_ = P.io.dataset
        td = io_.TensorDataset([P.to_tensor(xs), ys])
        sub = io_.Subset(td, [5, 0, 3])
        cat = io_.ConcatDataset([sub, td])
        comp = io_.ComposeDataset([td, io_.TensorDataset([ys * 2])])
        chain = [v for v in io_.ChainDataset([[1, 2], [3]])]
        np.random.seed(11)
        parts = io_.random_split(td, [4, 2])
        got.append(([np.concatenate([np.atleast_1d(v) for v in cat[i]])
                     for i in range(len(cat))],
                    [np.concatenate([np.atleast_1d(v) for v in comp[i]])
                     for i in range(len(comp))],
                    chain, [p.indices for p in parts], len(td)))
        with pytest.raises((AssertionError, ValueError)):
            io_.TensorDataset([xs, ys[:3]])
        with pytest.raises(RuntimeError):
            len(io_.IterableDataset())
    (a_cat, a_comp, a_chain, a_split, a_n), (b_cat, b_comp, b_chain,
                                             b_split, b_n) = got
    assert a_chain == b_chain and a_split == b_split and a_n == b_n
    for a, b in zip(a_cat + a_comp, b_cat + b_comp):
        np.testing.assert_array_equal(a, b)


def test_image_backend(tmp_path):
    from PIL import Image
    path = tmp_path / "a.png"
    Image.fromarray(np.zeros((3, 4, 3), np.uint8)).save(path)
    v = paddle.vision
    assert v.get_image_backend() == "pil"
    assert v.image_load(str(path)).size == (4, 3)
    with pytest.raises(ValueError):
        v.set_image_backend("opencv")
    v.set_image_backend("cv2")
    try:
        with pytest.raises(RuntimeError):
            v.image_load(str(path))
    finally:
        v.set_image_backend("pil")
