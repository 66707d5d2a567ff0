"""The port's ``vision.ops``, ``grid_sample``, ``affine_grid`` and the
bicubic and area ``interpolate`` modes against the JAX package's, on the
CPU.

The cases are those of ``tests/test_vision_ops.py`` run through both
packages on the same seeded numpy inputs: outputs within 1e-5 relative
L2 (f32; ``nms`` indices equal), and where the JAX op is differentiable
the gradients of the inputs under a seeded cotangent within 1e-5.
``interpolate`` goes up and down in size (the down case antialiased),
in one, two and three dimensions,
``grid_sample`` takes both ``align_corners`` and both padding modes the
JAX op tells apart (zeros, and border for any other).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as jF
from paddle_tpu.vision import ops as JV
from paddle_tpu_torch import ops as pF
from paddle_tpu_torch import vision
from paddle_tpu_torch.vision import ops as PV

TOL = 1e-5


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _x(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _both(fn_j, fn_p, arrays, grad=(), tol=TOL):
    """Run ``fn_j`` on JAX tensors and ``fn_p`` on torch tensors of the
    same numpy ``arrays``; outputs within ``tol``, and the gradients of
    the inputs whose index is in ``grad`` under a seeded cotangent."""
    jt = [paddle.to_tensor(a, stop_gradient=i not in grad)
          for i, a in enumerate(arrays)]
    pt = [torch.tensor(a, requires_grad=i in grad)
          for i, a in enumerate(arrays)]
    jo, po = fn_j(*jt), fn_p(*pt)
    assert tuple(po.shape) == tuple(jo.shape)
    assert rel(po.detach().numpy(), jo.numpy()) <= tol
    if grad:
        cot = np.random.RandomState(9).randn(*jo.shape).astype(np.float32)
        (jo * paddle.to_tensor(cot)).sum().backward()
        (po * torch.from_numpy(cot)).sum().backward()
        for i in grad:
            assert rel(pt[i].grad.numpy(), jt[i].grad.numpy()) <= tol, i
    return jo, po


def test_vision_ops_is_exported():
    assert vision.ops is PV and set(PV.__all__) == set(JV.__all__)


@pytest.mark.parametrize("case", ["overlap", "categories_topk", "random"])
def test_nms_matches_jax(case):
    if case == "overlap":
        boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]],
                         np.float32)
        kw = dict(iou_threshold=0.5)
        scores, cats = np.array([0.9, 0.8, 0.7], np.float32), None
    elif case == "categories_topk":
        boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [2, 2, 12, 12]],
                         np.float32)
        scores = np.array([0.5, 0.9, 0.8], np.float32)
        cats = np.array([0, 1, 0], np.int64)
        kw = dict(iou_threshold=0.5, categories=[0, 1], top_k=2)
    else:
        rng = np.random.RandomState(3)
        xy = rng.rand(40, 2).astype(np.float32) * 50
        boxes = np.concatenate([xy, xy + 5 + rng.rand(40, 2) * 20], 1) \
            .astype(np.float32)
        scores = rng.rand(40).astype(np.float32)
        cats = rng.randint(0, 3, 40).astype(np.int64)
        kw = dict(iou_threshold=0.3)
    j = JV.nms(paddle.to_tensor(boxes), scores=paddle.to_tensor(scores),
               category_idxs=None if cats is None else paddle.to_tensor(
                   cats), **kw)
    p = PV.nms(torch.from_numpy(boxes), scores=torch.from_numpy(scores),
               category_idxs=None if cats is None else torch.from_numpy(
                   cats), **kw)
    assert p.dtype == torch.int64
    assert p.tolist() == j.numpy().tolist()


ROI_BOXES = np.array([[1.0, 1.0, 6.0, 6.0], [0.5, 2.0, 7.5, 7.0],
                      [2.0, 0.0, 5.0, 3.5]], np.float32)
ROI_NUM = np.array([2, 1], np.int32)


@pytest.mark.parametrize("kw", [dict(output_size=2),
                                dict(output_size=(3, 2), sampling_ratio=2,
                                     aligned=False, spatial_scale=0.5)],
                         ids=["adaptive", "fixed"])
def test_roi_align_matches_jax_with_gradients(kw):
    x = _x(2, 3, 8, 8)
    num = ROI_NUM

    def j(xt, bt):
        return JV.roi_align(xt, bt, paddle.to_tensor(num), **kw)

    def p(xt, bt):
        return PV.roi_align(xt, bt, torch.from_numpy(num), **kw)

    _both(j, p, [x, ROI_BOXES], grad=(0, 1))


def test_roi_align_wide_box_and_layer_match_jax():
    x = np.full((1, 1, 6, 64), 1.75, np.float32)
    box = np.array([[0.0, 1.0, 60.0, 5.0]], np.float32)
    num = np.array([1], np.int32)
    _both(lambda a, b: JV.roi_align(a, b, paddle.to_tensor(num), 2),
          lambda a, b: PV.roi_align(a, b, torch.from_numpy(num), 2),
          [x, box])
    _both(lambda a, b: JV.RoIAlign(2)(a, b, paddle.to_tensor(num)),
          lambda a, b: PV.RoIAlign(2)(a, b, torch.from_numpy(num)),
          [_x(1, 4, 8, 8), np.array([[0.0, 0.0, 7.0, 7.0]], np.float32)])


@pytest.mark.parametrize("op", ["roi_pool", "psroi_pool"])
def test_roi_pools_match_jax_with_gradients(op):
    x = _x(2, 12, 8, 8, seed=1)
    num = ROI_NUM
    _both(lambda a, b: getattr(JV, op)(a, b, paddle.to_tensor(num), 2),
          lambda a, b: getattr(PV, op)(a, b, torch.from_numpy(num), 2),
          [x, ROI_BOXES], grad=(0,))
    layer = {"roi_pool": "RoIPool", "psroi_pool": "PSRoIPool"}[op]
    _both(lambda a, b: getattr(JV, layer)(2)(a, b, paddle.to_tensor(num)),
          lambda a, b: getattr(PV, layer)(2)(a, b, torch.from_numpy(num)),
          [x, ROI_BOXES])


def test_box_coder_matches_jax():
    rng = np.random.RandomState(0)
    prior = rng.rand(3, 4).astype(np.float32)
    prior[:, 2:] += 1.0
    var = np.ones((3, 4), np.float32) * 0.5
    target = rng.rand(3, 4).astype(np.float32) + [0, 0, 1.5, 1.5]
    target = target.astype(np.float32)
    deltas = ((rng.rand(3, 5, 4) - 0.5) * 0.2).astype(np.float32)
    for normalized in (True, False):
        _both(lambda a, b, c: JV.box_coder(a, b, c,
                                           box_normalized=normalized),
              lambda a, b, c: PV.box_coder(a, b, c,
                                           box_normalized=normalized),
              [prior, var, target])
    for axis in (0, 1):
        pri = prior if axis == 1 else (rng.rand(5, 4) + [0, 0, 1, 1]) \
            .astype(np.float32)
        _both(lambda a, c: JV.box_coder(a, None, c, "decode_center_size",
                                        axis=axis),
              lambda a, c: PV.box_coder(a, None, c, "decode_center_size",
                                        axis=axis),
              [pri, deltas])
    _both(lambda a, c: JV.box_coder(a, [1.0, 1.0, 0.5, 0.5], c,
                                    "decode_center_size", axis=1),
          lambda a, c: PV.box_coder(a, [1.0, 1.0, 0.5, 0.5], c,
                                    "decode_center_size", axis=1),
          [prior, deltas])
    with pytest.raises(ValueError):
        PV.box_coder(torch.from_numpy(prior), None,
                     torch.from_numpy(deltas), "decode_center_size", axis=2)


@pytest.mark.parametrize("dg,masked", [(1, False), (2, True)])
def test_deform_conv2d_matches_jax_with_gradients(dg, masked):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 6, 6).astype(np.float32)
    w = rng.randn(3, 4, 3, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    off = (rng.randn(2, dg * 18, 4, 4) * 0.7).astype(np.float32)
    arrays = [x, off, w, b]
    if masked:
        arrays.append(rng.rand(2, dg * 9, 4, 4).astype(np.float32))

    def j(*t):
        return JV.deform_conv2d(t[0], t[1], t[2], t[3],
                                deformable_groups=dg,
                                mask=t[4] if masked else None)

    def p(*t):
        return PV.deform_conv2d(t[0], t[1], t[2], t[3],
                                deformable_groups=dg,
                                mask=t[4] if masked else None)

    _both(j, p, arrays, grad=(0, 2, 3))
    with pytest.raises(NotImplementedError, match="groups"):
        PV.deform_conv2d(torch.from_numpy(x), torch.from_numpy(off),
                         torch.from_numpy(w[:, :2]), groups=2)


def test_layers_match_jax():
    paddle.seed(0)
    j = JV.DeformConv2D(4, 3, 3, padding=1)
    p = PV.DeformConv2D(4, 3, 3, padding=1)
    p.set_state_dict({k: v.numpy() for k, v in j.state_dict().items()})
    x = _x(1, 4, 5, 5)
    off = (np.random.RandomState(2).randn(1, 18, 5, 5) * 0.5).astype(
        np.float32)
    _both(j, p, [x, off])
    j = JV.ConvNormActivation(3, 8, kernel_size=3, stride=2)
    p = PV.ConvNormActivation(3, 8, kernel_size=3, stride=2)
    assert [n for n, _ in p.named_parameters()] == [
        n for n, _ in j.named_parameters()]
    p.set_state_dict({k: v.numpy() for k, v in j.state_dict().items()})
    _both(j, p, [_x(2, 3, 8, 8)], grad=(0,))


def test_read_file_and_decode_jpeg_raise():
    with pytest.raises(NotImplementedError, match="codec"):
        PV.read_file("x.jpg")
    with pytest.raises(NotImplementedError, match="libjpeg"):
        PV.decode_jpeg(torch.zeros(4, dtype=torch.uint8))


# -- grid_sample, affine_grid, interpolate ------------------------------------
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_matches_jax_with_gradients(align_corners, padding_mode):
    x = _x(2, 3, 5, 7)
    # points inside and up to 30 % outside [-1, 1]
    grid = (np.random.RandomState(1).rand(2, 4, 6, 2) * 2.6 - 1.3).astype(
        np.float32)
    kw = dict(padding_mode=padding_mode, align_corners=align_corners)
    _both(lambda a, g: jF.grid_sample(a, g, **kw),
          lambda a, g: pF.grid_sample(a, g, **kw), [x, grid], grad=(0, 1))


@pytest.mark.parametrize("align_corners", [True, False])
def test_affine_grid_matches_jax(align_corners):
    theta = (np.random.RandomState(0).randn(2, 2, 3) * 0.5).astype(
        np.float32)
    _both(lambda t: paddle.affine_grid(
              t, [2, 3, 4, 5], align_corners=align_corners),
          lambda t: pF.affine_grid(t, [2, 3, 4, 5],
                                   align_corners=align_corners),
          [theta], grad=(0,))
    theta3 = (np.random.RandomState(1).randn(1, 3, 4) * 0.5).astype(
        np.float32)
    _both(lambda t: paddle.affine_grid(
              t, [1, 2, 3, 4, 5], align_corners=align_corners),
          lambda t: pF.affine_grid(t, [1, 2, 3, 4, 5],
                                   align_corners=align_corners), [theta3])


@pytest.mark.parametrize("mode", ["bicubic", "area", "bilinear"])
@pytest.mark.parametrize("size", [(13, 17), (4, 3), (9, 5)],
                         ids=["up", "down", "mixed"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_interpolate_modes_match_jax(mode, size, align_corners):
    x = _x(2, 3, 8, 6)
    kw = dict(size=list(size), mode=mode, align_corners=align_corners)
    _both(lambda a: jF.interpolate(a, **kw),
          lambda a: pF.interpolate(a, **kw), [x], grad=(0,))


def test_interpolate_1d_and_3d_and_scale_factor_match_jax():
    x = _x(2, 3, 10)
    for kw in (dict(size=[4], mode="area"),
               dict(size=[3], mode="linear"),
               dict(scale_factor=2.5, mode="bicubic", data_format="NCL")):
        _both(lambda a: jF.interpolate(a, **kw),
              lambda a: pF.interpolate(a, **kw), [x])
    x3 = _x(1, 2, 6, 5, 4)
    for kw in (dict(size=[3, 7, 2], mode="trilinear"),
               dict(size=[9, 2, 4], mode="area", data_format="NCDHW")):
        _both(lambda a: jF.interpolate(a, **kw),
              lambda a: pF.interpolate(a, **kw), [x3])
    with pytest.raises(ValueError, match="mode"):
        pF.interpolate(torch.zeros(1, 1, 4, 4), size=[2, 2], mode="lanczos")
