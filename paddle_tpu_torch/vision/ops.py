"""Detection and vision operators (counterpart of
``paddle_tpu/vision/ops.py``): ``nms``, ``roi_align``, ``roi_pool``,
``psroi_pool``, ``box_coder``, ``deform_conv2d``, the layers
``DeformConv2D``, ``RoIAlign``, ``RoIPool``, ``PSRoIPool`` and
``ConvNormActivation``; ``read_file`` and ``decode_jpeg`` raise.

Plain torch ops, computing what the JAX ones compute (the JAX package
has no Pallas kernel here): the same sampling grids (``roi_align``'s
adaptive grid is the per-axis maximum over the call's boxes, capped at
8 samples a bin), the same clamping and bin boundaries. Host reads, as
in the JAX package: ``nms`` (its output size depends on the data),
``roi_pool``'s bin boundaries, and ``roi_align``'s adaptive grid and
``boxes_num``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..nn import initializer as I
from ..nn.parameter import ParamAttr

__all__ = [
    "nms", "roi_align", "roi_pool", "box_coder", "deform_conv2d",
    "DeformConv2D", "RoIAlign", "RoIPool", "ConvNormActivation",
    "read_file", "decode_jpeg", "psroi_pool", "PSRoIPool",
]


def _host(t):
    return (t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t))


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Hard NMS over [N, 4] x1y1x2y2 boxes, per category; the kept
    indices by descending score (int64, on the boxes' device). A host op
    by nature: the kept count depends on the data."""
    b = _host(boxes)
    n = b.shape[0]
    s = (_host(scores) if scores is not None
         else np.arange(n, 0, -1, dtype=np.float32))
    cats = (_host(category_idxs) if category_idxs is not None
            else np.zeros(n, np.int64))
    areas = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    keep = []
    for c in np.unique(cats):
        idx = np.where(cats == c)[0]
        order = idx[np.argsort(-s[idx])]
        while order.size:
            i = order[0]
            keep.append(i)
            rest = order[1:]
            if not rest.size:
                break
            xx1 = np.maximum(b[i, 0], b[rest, 0])
            yy1 = np.maximum(b[i, 1], b[rest, 1])
            xx2 = np.minimum(b[i, 2], b[rest, 2])
            yy2 = np.minimum(b[i, 3], b[rest, 3])
            inter = (np.clip(xx2 - xx1, 0, None)
                     * np.clip(yy2 - yy1, 0, None))
            iou = inter / (areas[i] + areas[rest] - inter + 1e-9)
            order = rest[iou <= iou_threshold]
    keep = np.array(sorted(keep, key=lambda i: -s[i]), np.int64)
    if top_k is not None:
        keep = keep[:top_k]
    device = boxes.device if isinstance(boxes, torch.Tensor) else None
    return torch.as_tensor(keep, device=device)


def _bilinear(feat, ys, xs):
    """feat [R, C, H, W] sampled at ys, xs [R, P] -> [R, C, P]: the JAX
    ``_bilinear_gather`` (corners clamped into the image, weights into
    [0, 1])."""
    r, c, h, w = feat.shape
    y0 = ys.floor().long().clamp(0, h - 1)
    x0 = xs.floor().long().clamp(0, w - 1)
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).clamp(0.0, 1.0).unsqueeze(1)
    wx = (xs - x0).clamp(0.0, 1.0).unsqueeze(1)
    flat = feat.reshape(r, c, h * w)

    def g(yy, xx):
        return flat.gather(2, (yy * w + xx).unsqueeze(1).expand(-1, c, -1))

    return (g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x1) * (1 - wy) * wx
            + g(y1, x0) * wy * (1 - wx) + g(y1, x1) * wy * wx)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


# roi_align's adaptive grid is shared by the call's boxes; past 8 samples
# a bin per axis the bin average is within f32 noise of the integral
_SR_CAP = 8


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True):
    """RoIAlign: each of the ph x pw bins the mean of sr_y x sr_x bilinear
    samples. x [N, C, H, W]; boxes [R, 4]; boxes_num [N] boxes per image.
    Differentiable in x and boxes."""
    ph, pw = _pair(output_size)
    img_idx = np.repeat(np.arange(len(_host(boxes_num))), _host(boxes_num))
    off = 0.5 if aligned else 0.0
    if sampling_ratio > 0:
        sr_y = sr_x = int(sampling_ratio)
    elif boxes.shape[0]:
        bx = _host(boxes)
        sr_y = min(_SR_CAP, max(1, int(np.ceil(
            (bx[:, 3] - bx[:, 1]).max() * spatial_scale / ph))))
        sr_x = min(_SR_CAP, max(1, int(np.ceil(
            (bx[:, 2] - bx[:, 0]).max() * spatial_scale / pw))))
    else:
        sr_y = sr_x = 1
    if boxes.shape[0] == 0:
        return x.new_zeros((0, x.shape[1], ph, pw))
    feats = x[torch.as_tensor(img_idx, device=x.device)]
    x1, y1, x2, y2 = (boxes[:, k] * spatial_scale - off for k in range(4))
    bh = torch.clamp(y2 - y1, min=1e-4) / ph
    bw = torch.clamp(x2 - x1, min=1e-4) / pw
    dev, dt = x.device, boxes.dtype
    ar = lambda n: torch.arange(n, device=dev, dtype=dt)   # noqa: E731
    # [R, ph, pw, sr_y, sr_x]
    iy = (ar(ph)[None, :, None, None, None] * bh[:, None, None, None, None]
          + y1[:, None, None, None, None]
          + (ar(sr_y)[None, None, None, :, None] + 0.5)
          * bh[:, None, None, None, None] / sr_y)
    ix = (ar(pw)[None, None, :, None, None] * bw[:, None, None, None, None]
          + x1[:, None, None, None, None]
          + (ar(sr_x)[None, None, None, None, :] + 0.5)
          * bw[:, None, None, None, None] / sr_x)
    shape = (boxes.shape[0], ph, pw, sr_y, sr_x)
    iy, ix = iy.expand(shape), ix.expand(shape)
    vals = _bilinear(feats, iy.reshape(len(iy), -1), ix.reshape(len(ix), -1))
    return vals.reshape(len(iy), x.shape[1], ph, pw,
                        sr_y * sr_x).mean(-1)


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Max over each bin's integer sub-window, the boundaries from the
    host's box values (as the JAX op). Differentiable in x."""
    ph, pw = _pair(output_size)
    bx = _host(boxes)
    img_idx = np.repeat(np.arange(len(_host(boxes_num))), _host(boxes_num))
    h, w = x.shape[-2], x.shape[-1]
    outs = []
    for r in range(bx.shape[0]):
        feat = x[int(img_idx[r])]
        x1 = int(round(bx[r, 0] * spatial_scale))
        y1 = int(round(bx[r, 1] * spatial_scale))
        x2 = max(int(round(bx[r, 2] * spatial_scale)), x1 + 1)
        y2 = max(int(round(bx[r, 3] * spatial_scale)), y1 + 1)
        x1, y1 = min(x1, w - 1), min(y1, h - 1)
        x2, y2 = min(x2, w), min(y2, h)
        bins = []
        for i in range(ph):
            ys = y1 + (y2 - y1) * i // ph
            ye = max(y1 + (y2 - y1) * (i + 1) // ph, ys + 1)
            for j in range(pw):
                xs = x1 + (x2 - x1) * j // pw
                xe = max(x1 + (x2 - x1) * (j + 1) // pw, xs + 1)
                bins.append(feat[:, ys:ye, xs:xe].amax(dim=(-2, -1)))
        outs.append(torch.stack(bins, -1).reshape(feat.shape[0], ph, pw))
    if not outs:
        return x.new_zeros((0, x.shape[1], ph, pw))
    return torch.stack(outs)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0):
    """Position-sensitive RoI pool: channel group (i, j) feeds bin (i,
    j), averaged within the bin (``roi_align`` with 2 x 2 samples,
    unaligned, as the JAX op)."""
    ph, pw = _pair(output_size)
    c_out = x.shape[1] // (ph * pw)
    pooled = roi_align(x, boxes, boxes_num, (ph, pw), spatial_scale,
                       sampling_ratio=2, aligned=False)
    pd = pooled.reshape(-1, ph * pw, c_out, ph, pw).movedim(2, -1)
    ii = torch.arange(ph, device=x.device)[:, None]
    jj = torch.arange(pw, device=x.device)[None, :]
    return pd[:, ii * pw + jj, ii, jj].permute(0, 3, 1, 2)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0):
    """Encode or decode boxes against priors (center-size form); with a
    3-D decode target, ``axis`` 0 pairs prior k with ``target_box[:,
    k]``, 1 with ``target_box[k, :]``. No gradient, as in JAX."""
    if axis not in (0, 1):
        raise ValueError(f"box_coder axis must be 0 or 1, got {axis}")
    pb = torch.as_tensor(prior_box)
    tb = torch.as_tensor(target_box, device=pb.device)
    var = (torch.as_tensor(prior_box_var, device=pb.device)
           if prior_box_var is not None else torch.ones_like(pb))
    norm = 0.0 if box_normalized else 1.0
    pw = pb[..., 2] - pb[..., 0] + norm
    ph = pb[..., 3] - pb[..., 1] + norm
    pcx = pb[..., 0] + pw * 0.5
    pcy = pb[..., 1] + ph * 0.5
    if (code_type == "decode_center_size" and axis == 1
            and tb.dim() == pb.dim() + 1):
        pw, ph, pcx, pcy = (a[..., :, None] for a in (pw, ph, pcx, pcy))
        if var.dim() == pb.dim():
            var = var[..., :, None, :]
    if code_type == "encode_center_size":
        tw = tb[..., 2] - tb[..., 0] + norm
        th = tb[..., 3] - tb[..., 1] + norm
        tcx = tb[..., 0] + tw * 0.5
        tcy = tb[..., 1] + th * 0.5
        out = torch.stack([(tcx - pcx) / pw / var[..., 0],
                           (tcy - pcy) / ph / var[..., 1],
                           torch.log(tw / pw) / var[..., 2],
                           torch.log(th / ph) / var[..., 3]], -1)
    else:
        ocx = var[..., 0] * tb[..., 0] * pw + pcx
        ocy = var[..., 1] * tb[..., 1] * ph + pcy
        ow = torch.exp(var[..., 2] * tb[..., 2]) * pw
        oh = torch.exp(var[..., 3] * tb[..., 3]) * ph
        out = torch.stack([ocx - ow * 0.5, ocy - oh * 0.5,
                           ocx + ow * 0.5 - norm, ocy + oh * 0.5 - norm],
                          -1)
    return out.detach()


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None):
    """Deformable convolution v1 (v2 with ``mask``): each kernel tap
    samples the padded input bilinearly at its offset position (offsets
    [n, dg * 2 * kh * kw, ho, wo], (y, x) pairs per tap and deformable
    group), then one contraction with the weights."""
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    n, cin, h, w = x.shape
    cout, _, kh, kw = weight.shape
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if groups != 1:
        raise NotImplementedError(
            "deform_conv2d groups>1 (channel-grouped weights) is not "
            "supported; deformable_groups IS supported")
    dg = int(deformable_groups)
    if cin % dg != 0:
        raise ValueError(
            f"deformable_groups={dg} must divide in_channels={cin}")
    cg = cin // dg
    xp = torch.nn.functional.pad(x, (pw, pw, ph, ph))
    base_y = (torch.arange(ho, device=x.device) * sh)[:, None]
    base_x = (torch.arange(wo, device=x.device) * sw)[None, :]
    cols = []
    for ki in range(kh):
        for kj in range(kw):
            t = ki * kw + kj
            groups_out = []
            for g in range(dg):
                base = g * 2 * kh * kw
                ys = base_y + ki * dh + offset[:, base + 2 * t]
                xs = base_x + kj * dw + offset[:, base + 2 * t + 1]
                sampled = _bilinear(xp[:, g * cg:(g + 1) * cg],
                                    ys.reshape(n, -1), xs.reshape(n, -1))
                sampled = sampled.reshape(n, cg, ho, wo)
                if mask is not None:
                    sampled = sampled * mask[:, g * kh * kw + t][:, None]
                groups_out.append(sampled)
            cols.append(torch.cat(groups_out, dim=1))
    col = torch.stack(cols, 2)                      # [n, cin, kh kw, ho, wo]
    out = torch.einsum("nckhw,ock->nohw", col,
                       weight.reshape(cout, cin, kh * kw))
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


class DeformConv2D(nn.Layer):
    """Learnable weight (Xavier-uniform) and bias (zeros) over
    ``deform_conv2d``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        ks = _pair(kernel_size)
        self._attrs = dict(stride=stride, padding=padding,
                           dilation=dilation,
                           deformable_groups=deformable_groups,
                           groups=groups)
        self.weight = self.create_parameter(
            shape=[out_channels, in_channels // groups, *ks],
            attr=ParamAttr._to_attr(weight_attr) if weight_attr
            else ParamAttr(initializer=I.XavierUniform()))
        if bias_attr is False:
            self.add_parameter("bias", None)
        else:
            self.bias = self.create_parameter(
                shape=[out_channels],
                attr=ParamAttr._to_attr(bias_attr) if bias_attr
                else ParamAttr(initializer=I.Constant(0.0)))

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, mask=mask,
                             **self._attrs)


class _RoILayer(nn.Layer):
    _op = None

    def __init__(self, output_size, spatial_scale=1.0):
        super().__init__()
        self._output_size = output_size
        self._spatial_scale = spatial_scale

    def forward(self, x, boxes, boxes_num):
        return type(self)._op(x, boxes, boxes_num, self._output_size,
                              self._spatial_scale)


class RoIAlign(_RoILayer):
    _op = staticmethod(roi_align)


class RoIPool(_RoILayer):
    _op = staticmethod(roi_pool)


class PSRoIPool(_RoILayer):
    _op = staticmethod(psroi_pool)


class ConvNormActivation(nn.Sequential):
    """Conv2D + norm + activation; the convolution has a bias only when
    there is no norm layer (unless ``bias`` says otherwise)."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=None, groups=1, norm_layer=nn.BatchNorm2D,
                 activation_layer=nn.ReLU, dilation=1, bias=None):
        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        if bias is None:
            bias = norm_layer is None
        layers = [nn.Conv2D(in_channels, out_channels, kernel_size,
                            stride=stride, padding=padding,
                            dilation=dilation, groups=groups,
                            bias_attr=None if bias else False)]
        if norm_layer is not None:
            layers.append(norm_layer(out_channels))
        if activation_layer is not None:
            layers.append(activation_layer())
        super().__init__(*layers)


def read_file(filename, name=None):
    raise NotImplementedError(
        "read_file needs an image codec, which the port does not bind: "
        "feed decoded arrays through vision.datasets / vision.transforms")


def decode_jpeg(x, mode="unchanged", name=None):
    raise NotImplementedError(
        "decode_jpeg needs libjpeg, which the port does not bind: feed "
        "decoded arrays through vision.datasets / vision.transforms")
