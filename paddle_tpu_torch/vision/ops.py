"""``paddle.vision.ops`` of the port (a port of
``paddle_tpu/vision/ops.py``): ``yolo_box``, ``yolo_loss``,
``deform_conv2d`` / ``DeformConv2D``, ``roi_align``, ``nms``,
``read_file`` and ``decode_jpeg``.

The first four are ops of the eager core in plain torch, dense and
vectorized as the reference's: the grid decode, the anchor matching and
the bilinear taps are gathers, the deformable conv's contraction one
product a group. ``nms`` is greedy suppression on the host in numpy, as
the reference's (an inference post-process, sequential by nature);
``decode_jpeg`` imports PIL at the call.
"""
import numpy as np
import torch

from ..core.dispatch import register_op
from ..core.tensor import Tensor
from ..nn import initializer as init_mod
from ..nn.layer_base import Layer


def _host(t):
    return t.numpy() if isinstance(t, Tensor) else np.asarray(t)


@register_op("yolo_box")
def _yolo_box(x, img_size, *, anchors, class_num, conf_thresh,
              downsample_ratio, clip_bbox, scale_x_y):
    """The boxes ``[N, an * H * W, 4]`` (x1, y1, x2, y2) and scores
    ``[N, an * H * W, class_num]`` of a YOLOv3 head; a cell under
    ``conf_thresh`` gives zeros."""
    n, c, h, w = x.shape
    an_num = len(anchors) // 2
    bias = -0.5 * (scale_x_y - 1.0)
    input_h = downsample_ratio * h
    input_w = downsample_ratio * w
    dev = x.device
    pred = x.reshape(n, an_num, 5 + class_num, h, w).float()
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None,
                                                              None, :]
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[None, None,
                                                              :, None]
    img_h = img_size[:, 0].float()[:, None, None, None]
    img_w = img_size[:, 1].float()[:, None, None, None]
    anc = torch.tensor(anchors, dtype=torch.float32,
                       device=dev).reshape(an_num, 2)
    anc_w = anc[:, 0][None, :, None, None]
    anc_h = anc[:, 1][None, :, None, None]
    cx = (grid_x + torch.sigmoid(pred[:, :, 0]) * scale_x_y + bias) \
        * img_w / w
    cy = (grid_y + torch.sigmoid(pred[:, :, 1]) * scale_x_y + bias) \
        * img_h / h
    bw = torch.exp(pred[:, :, 2]) * anc_w * img_w / input_w
    bh = torch.exp(pred[:, :, 3]) * anc_h * img_h / input_h
    conf = torch.sigmoid(pred[:, :, 4])
    keep = (conf >= conf_thresh).float()
    x1, y1 = cx - bw / 2, cy - bh / 2
    x2, y2 = cx + bw / 2, cy + bh / 2
    if clip_bbox:
        x1 = torch.clamp(x1, min=0.0)
        y1 = torch.clamp(y1, min=0.0)
        x2 = torch.minimum(x2, img_w - 1.0)
        y2 = torch.minimum(y2, img_h - 1.0)
    boxes = torch.stack([x1, y1, x2, y2], dim=2) * keep[:, :, None]
    scores = conf[:, :, None] * torch.sigmoid(pred[:, :, 5:]) \
        * keep[:, :, None]
    boxes = boxes.permute(0, 1, 3, 4, 2).reshape(n, -1, 4)
    scores = scores.permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    return boxes, scores


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, clip_bbox=True, name=None,
             scale_x_y=1.0):
    return _yolo_box(x, img_size, anchors=tuple(anchors),
                     class_num=class_num, conf_thresh=conf_thresh,
                     downsample_ratio=downsample_ratio,
                     clip_bbox=clip_bbox, scale_x_y=scale_x_y)


def _bce(pred_logit, target):
    p = torch.clamp(torch.sigmoid(pred_logit), 1e-7, 1.0 - 1e-7)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))


def _wh_iou(w1, h1, w2, h2):
    inter = torch.minimum(w1, w2) * torch.minimum(h1, h2)
    return inter / (w1 * h1 + w2 * h2 - inter + 1e-9)


@register_op("yolov3_loss")
def _yolo_loss(x, gt_box, gt_label, gt_score, *, anchors, anchor_mask,
               class_num, ignore_thresh, downsample_ratio, use_label_smooth,
               scale_x_y):
    """The YOLOv3 loss a sample: each gt box matched to its best anchor
    of all by w/h IoU in input pixels, BCE on x/y and L1 on w/h weighted
    by ``2 - w h``, per-class BCE, and objectness BCE with predictions
    whose IoU with any gt exceeds ``ignore_thresh`` left out. ``gt_box``
    ``[N, B, 4]`` normalized cx, cy, w, h; ``gt_score`` the mixup weight.
    ``scale_x_y`` is taken and not read, as in the reference."""
    n, c, h, w = x.shape
    dev = x.device
    mask_num = len(anchor_mask)
    an_all = torch.tensor(anchors, dtype=torch.float32,
                          device=dev).reshape(-1, 2)
    input_size = downsample_ratio * h
    pred = x.reshape(n, mask_num, 5 + class_num, h, w).float()
    valid = (gt_box[:, :, 2] > 0).float()

    gw = gt_box[:, :, 2] * input_size
    gh = gt_box[:, :, 3] * input_size
    ious = _wh_iou(gw[:, :, None], gh[:, :, None],
                   an_all[None, None, :, 0], an_all[None, None, :, 1])
    best_an = ious.argmax(dim=-1)
    mask_arr = torch.tensor(anchor_mask, dtype=torch.long, device=dev)
    hit = best_an[:, :, None] == mask_arr[None, None, :]
    local_slot = hit.int().argmax(dim=-1)
    in_head = hit.any(dim=-1).float() * valid

    gi = torch.clamp((gt_box[:, :, 0] * w).int(), 0, w - 1).long()
    gj = torch.clamp((gt_box[:, :, 1] * h).int(), 0, h - 1).long()
    tx = gt_box[:, :, 0] * w - gi.float()
    ty = gt_box[:, :, 1] * h - gj.float()
    head = an_all[mask_arr]
    tw = torch.log(torch.clamp(gw[:, :, None] / head[None, None, :, 0],
                               min=1e-9))
    th = torch.log(torch.clamp(gh[:, :, None] / head[None, None, :, 1],
                               min=1e-9))
    tw = torch.take_along_dim(tw, local_slot[:, :, None], dim=-1)[:, :, 0]
    th = torch.take_along_dim(th, local_slot[:, :, None], dim=-1)[:, :, 0]
    box_scale = 2.0 - gt_box[:, :, 2] * gt_box[:, :, 3]

    flat = pred.permute(0, 1, 3, 4, 2).reshape(n, mask_num * h * w,
                                               5 + class_num)
    gt_idx = local_slot * h * w + gj * w + gi
    pg = torch.take_along_dim(flat, gt_idx[:, :, None], dim=1)

    wsc = in_head * gt_score * box_scale
    loss_xy = (_bce(pg[:, :, 0], tx) + _bce(pg[:, :, 1], ty)) * wsc
    loss_wh = ((pg[:, :, 2] - tw).abs() + (pg[:, :, 3] - th).abs()) * wsc

    smooth_pos = 1.0 - 1.0 / class_num if use_label_smooth else 1.0
    smooth_neg = 1.0 / class_num if use_label_smooth else 0.0
    onehot = (torch.arange(class_num, device=dev)[None, None, :]
              == gt_label[:, :, None]).float()
    tcls = onehot * smooth_pos + (1.0 - onehot) * smooth_neg
    loss_cls = _bce(pg[:, :, 5:], tcls).sum(-1) * in_head * gt_score

    obj_logit = pred[:, :, 4]
    grid_x = (torch.arange(w, dtype=torch.float32, device=dev)
              + 0.5)[None, None, None, :]
    grid_y = (torch.arange(h, dtype=torch.float32, device=dev)
              + 0.5)[None, None, :, None]
    px = (grid_x - 0.5 + torch.sigmoid(pred[:, :, 0])) / w
    py = (grid_y - 0.5 + torch.sigmoid(pred[:, :, 1])) / h
    pw = torch.exp(pred[:, :, 2]) * head[None, :, 0, None, None] / input_size
    ph = torch.exp(pred[:, :, 3]) * head[None, :, 1, None, None] / input_size
    px1, py1 = px - pw / 2, py - ph / 2
    px2, py2 = px + pw / 2, py + ph / 2

    def gt_edge(i, j, sign):
        return (gt_box[:, :, i] + sign * gt_box[:, :, j] / 2)[
            :, None, None, None, :]

    gx1, gy1 = gt_edge(0, 2, -1), gt_edge(1, 3, -1)
    gx2, gy2 = gt_edge(0, 2, 1), gt_edge(1, 3, 1)
    iw = torch.clamp(torch.minimum(px2[..., None], gx2)
                     - torch.maximum(px1[..., None], gx1), min=0.0)
    ih = torch.clamp(torch.minimum(py2[..., None], gy2)
                     - torch.maximum(py1[..., None], gy1), min=0.0)
    inter = iw * ih
    area_p = (pw * ph)[..., None]
    area_g = (gt_box[:, :, 2] * gt_box[:, :, 3])[:, None, None, None, :]
    iou = inter / (area_p + area_g - inter + 1e-9)
    iou = iou * valid[:, None, None, None, :]
    ignore = iou.amax(dim=-1) > ignore_thresh

    cells = mask_num * h * w
    tobj = torch.zeros((n, cells), device=dev).scatter_reduce(
        1, gt_idx, in_head, reduce="amax")
    tobj_w = torch.zeros((n, cells), device=dev).scatter_reduce(
        1, gt_idx, in_head * gt_score, reduce="amax")
    tobj = tobj.reshape(n, mask_num, h, w)
    tobj_w = tobj_w.reshape(n, mask_num, h, w)
    obj_weight = torch.where(tobj > 0, tobj_w,
                             torch.where(ignore, 0.0, 1.0))
    loss_obj = _bce(obj_logit, tobj) * obj_weight
    return (loss_xy.sum(-1) + loss_wh.sum(-1) + loss_cls.sum(-1)
            + loss_obj.sum((1, 2, 3)))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    if gt_score is None:
        from ..ops.creation import ones
        gt_score = ones(list(gt_box.shape[:2]), "float32")
    return _yolo_loss(x, gt_box, gt_label, gt_score,
                      anchors=tuple(anchors), anchor_mask=tuple(anchor_mask),
                      class_num=class_num, ignore_thresh=ignore_thresh,
                      downsample_ratio=downsample_ratio,
                      use_label_smooth=use_label_smooth,
                      scale_x_y=scale_x_y)


def _bilinear_sample(img, y, x):
    """Bilinear values of ``img`` ``[C, H, W]`` at ``y``, ``x`` (one
    shape): ``[C, *shape]``, each tap outside the map 0."""
    h, w = img.shape[1:]
    y0, x0 = torch.floor(y), torch.floor(x)
    y1, x1 = y0 + 1, x0 + 1
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1

    def tap(yy, xx):
        inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        yc = torch.clamp(yy, 0, h - 1).long()
        xc = torch.clamp(xx, 0, w - 1).long()
        return img[:, yc, xc] * inside.to(img.dtype)

    return (tap(y0, x0) * (wy0 * wx0) + tap(y0, x1) * (wy0 * wx1)
            + tap(y1, x0) * (wy1 * wx0) + tap(y1, x1) * (wy1 * wx1))


@register_op("deformable_conv")
def _deform_conv2d(x, offset, weight, mask, *, stride, padding, dilation,
                   deformable_groups, groups, has_mask):
    """The deformable conv (v2, modulated, when ``mask`` is given): each
    tap sampled bilinearly at its offset position, then one product a
    group over the sampled columns."""
    n, cin, h, w = x.shape
    cout, cin_g, kh, kw = weight.shape
    sh, sw = stride
    ph, pw = padding
    dh, dw = dilation
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dev = x.device
    base_y = (torch.arange(ho, device=dev) * sh - ph).reshape(1, ho, 1)
    base_x = (torch.arange(wo, device=dev) * sw - pw).reshape(1, 1, wo)
    ky = torch.arange(kh, device=dev).repeat_interleave(kw)
    kx = torch.arange(kw, device=dev).repeat(kh)
    off = offset.reshape(n, deformable_groups, kh * kw, 2, ho, wo)
    m = mask.reshape(n, deformable_groups, kh * kw, ho, wo) if has_mask \
        else None
    cpg = cin // deformable_groups
    samples = []
    for b in range(n):
        cols = []
        for g in range(deformable_groups):
            img = x[b, g * cpg:(g + 1) * cpg]
            pos_y = base_y + (ky * dh).reshape(-1, 1, 1) + off[b, g, :, 0]
            pos_x = base_x + (kx * dw).reshape(-1, 1, 1) + off[b, g, :, 1]
            sampled = _bilinear_sample(img, pos_y, pos_x)
            if has_mask:
                sampled = sampled * m[b, g][None]
            cols.append(sampled)
        samples.append(torch.cat(cols, dim=0))
    cols = torch.stack(samples)              # [N, cin, kh*kw, ho, wo]
    wmat = weight.reshape(cout, cin_g * kh * kw)
    cg, og = cin // groups, cout // groups
    outs = []
    for g in range(groups):
        col_g = cols[:, g * cg:(g + 1) * cg].reshape(n, cg * kh * kw, ho, wo)
        outs.append(torch.einsum("nkhw,ok->nohw", col_g,
                                 wmat[g * og:(g + 1) * og]))
    return torch.cat(outs, dim=1)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    def _pair(v):
        return tuple(v) if isinstance(v, (list, tuple)) else (v, v)
    out = _deform_conv2d(x, offset, weight, mask,
                         stride=_pair(stride), padding=_pair(padding),
                         dilation=_pair(dilation),
                         deformable_groups=deformable_groups, groups=groups,
                         has_mask=mask is not None)
    if bias is not None:
        out = out + bias.reshape([1, -1, 1, 1])
    return out


class DeformConv2D(Layer):
    """Weight ``[out, in/groups, kh, kw]`` drawn ``KaimingNormal``, as
    ``Conv2D``'s."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = tuple(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size, kernel_size)
        self._attrs = dict(stride=stride, padding=padding, dilation=dilation,
                           deformable_groups=deformable_groups, groups=groups)
        fan_in = (in_channels // groups) * ks[0] * ks[1]
        self.weight = self.create_parameter(
            (out_channels, in_channels // groups) + ks,
            attr=init_mod.ParamAttr._to_attr(weight_attr),
            default_initializer=init_mod.KaimingNormal(fan_in=fan_in))
        self.bias = None if bias_attr is False else self.create_parameter(
            (out_channels,), attr=init_mod.ParamAttr._to_attr(bias_attr),
            is_bias=True)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias,
                             mask=mask, **self._attrs)


@register_op("roi_align")
def _roi_align(x, boxes, box_batch_idx, *, output_size, spatial_scale,
               sampling_ratio, aligned):
    """The mean of ``sampling_ratio``^2 (2 when it is not positive)
    bilinear samples over each of the ``output_size`` bins of each box."""
    ph, pw = output_size
    off = 0.5 if aligned else 0.0
    s = sampling_ratio if sampling_ratio > 0 else 2
    dev = x.device
    ar_h = torch.arange(ph, device=dev)[:, None]
    ar_w = torch.arange(pw, device=dev)[:, None]
    sub = (torch.arange(s, device=dev)[None, :] + 0.5)
    outs = []
    for box, bidx in zip(boxes, box_batch_idx.tolist()):
        x1 = box[0] * spatial_scale - off
        y1 = box[1] * spatial_scale - off
        rw = box[2] * spatial_scale - off - x1
        rh = box[3] * spatial_scale - off - y1
        if not aligned:
            rw = torch.clamp(rw, min=1.0)
            rh = torch.clamp(rh, min=1.0)
        bin_h, bin_w = rh / ph, rw / pw
        iy = ar_h * bin_h + y1 + sub * bin_h / s
        ix = ar_w * bin_w + x1 + sub * bin_w / s
        yy = iy.reshape(-1)[:, None].expand(ph * s, pw * s)
        xx = ix.reshape(-1)[None, :].expand(ph * s, pw * s)
        vals = _bilinear_sample(x[bidx], yy, xx)
        outs.append(vals.reshape(-1, ph, s, pw, s).mean(dim=(2, 4)))
    return torch.stack(outs)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """``[K, C, ph, pw]`` for the K boxes ``[K, 4]`` (x1, y1, x2, y2),
    ``boxes_num`` of them to each image in order."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    nums = _host(boxes_num).astype("int64")
    batch_idx = np.repeat(np.arange(len(nums)), nums).astype("int32")
    return _roi_align(x, boxes, torch.from_numpy(batch_idx),
                      output_size=tuple(output_size),
                      spatial_scale=spatial_scale,
                      sampling_ratio=sampling_ratio, aligned=aligned)


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy suppression on the host: the kept indices in descending
    score order (input order without ``scores``). With ``category_idxs``
    a box suppresses only boxes of its category; ``categories`` then
    keeps the listed ones and ``top_k`` cuts the merged list."""
    if categories is not None and category_idxs is None:
        raise ValueError("nms: `categories` requires `category_idxs`")
    b = _host(boxes)
    order = np.arange(len(b)) if scores is None \
        else np.argsort(-_host(scores))
    cats = _host(category_idxs) if category_idxs is not None \
        else np.zeros(len(b), np.int64)
    x1, y1, x2, y2 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    areas = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    keep = []
    suppressed = np.zeros(len(b), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx1 = np.maximum(x1[i], x1)
        yy1 = np.maximum(y1[i], y1)
        xx2 = np.minimum(x2[i], x2)
        yy2 = np.minimum(y2[i], y2)
        inter = np.clip(xx2 - xx1, 0, None) * np.clip(yy2 - yy1, 0, None)
        iou = inter / (areas[i] + areas - inter + 1e-9)
        suppressed |= (iou > iou_threshold) & (cats == cats[i])
        suppressed[i] = True
    keep = np.asarray(keep, np.int64)
    if categories is not None:
        cat_set = {int(c) for c in _host(categories).reshape(-1)}
        keep = keep[np.isin(cats[keep], list(cat_set))]
    if top_k is not None:
        keep = keep[:top_k]
    return Tensor(keep)


def read_file(filename, name=None):
    """The file's bytes as a uint8 Tensor."""
    with open(filename, "rb") as f:
        data = f.read()
    return Tensor(np.frombuffer(data, np.uint8).copy())


def decode_jpeg(x, mode="unchanged", name=None):
    """JPEG bytes -> a CHW uint8 Tensor, decoded by PIL on the host
    (imported here; ``mode`` ``"gray"``, ``"rgb"`` or ``"unchanged"``)."""
    import io
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decode_jpeg needs PIL, which is not "
                           "installed") from e
    data = bytes(np.asarray(_host(x), np.uint8))
    img = Image.open(io.BytesIO(data))
    if mode == "gray":
        arr = np.asarray(img.convert("L"))[None]
    else:
        img = img.convert("RGB") if mode == "rgb" else img
        arr = np.asarray(img)
        arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return Tensor(arr.copy())
