"""The port's vision zoo against the JAX package's, on the CPU.

Each factory is built in both packages (``num_classes=7``), the JAX
state dict (weights and batch-norm running statistics) copied into the
port's model (``device="cpu"``), and both run an eval-mode forward on
the same seeded numpy images at the sizes of ``tests/test_vision_zoo.py``:
logits within 1e-4 relative L2 (f32; the convolutions sum in other
orders through up to ~100 layers). The heaviest JAX forwards (DenseNet,
InceptionV3, GoogLeNet, the MobileNetV3s, VGG-11, as
``tests/test_vision_zoo.py`` marks them, and MobileNetV2 and SqueezeNet
1.0, 20 s each here) are marked slow; every family keeps a case in
tier 1.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision import models as JM
from paddle_tpu_torch.vision import models as PM

TOL = 1e-4

CASES = [
    # (factory, kwargs, input hw, slow)
    ("mobilenet_v1", dict(), 64, False),
    ("mobilenet_v2", dict(), 64, True),
    ("mobilenet_v3_small", dict(), 64, True),
    ("mobilenet_v3_large", dict(), 64, True),
    ("vgg11", dict(), 64, True),
    ("vgg16", dict(batch_norm=True), 64, False),
    ("alexnet", dict(), 96, False),
    ("squeezenet1_0", dict(), 96, True),
    ("squeezenet1_1", dict(), 96, False),
    ("shufflenet_v2_x0_25", dict(), 64, False),
    ("densenet121", dict(), 64, True),
    ("googlenet", dict(), 64, True),
    ("inception_v3", dict(), 96, True),
]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _carry(jm, pm):
    missing, unexpected = pm.set_state_dict(
        {k: v.numpy() for k, v in jm.state_dict().items()})
    assert not missing and not unexpected, (missing, unexpected)


@pytest.mark.parametrize("name,kwargs,hw", [
    pytest.param(n, kw, hw, id=n,
                 marks=(pytest.mark.slow,) if slow else ())
    for n, kw, hw, slow in CASES])
def test_factory_forward_matches_jax(name, kwargs, hw):
    paddle.seed(0)
    jm = getattr(JM, name)(num_classes=7, **kwargs)
    pm = getattr(PM, name)(num_classes=7, device="cpu", **kwargs)
    _carry(jm, pm)
    jm.eval()
    pm.eval()
    x = np.random.RandomState(0).randn(2, 3, hw, hw).astype(np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    want = jm(paddle.to_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 7)
    assert rel(got, want) <= TOL


def test_lenet_matches_jax():
    paddle.seed(0)
    jm, pm = JM.LeNet(num_classes=10), PM.LeNet(num_classes=10)
    _carry(jm, pm)
    x = np.random.RandomState(1).randn(3, 1, 28, 28).astype(np.float32)
    assert rel(pm(torch.from_numpy(x)).detach().numpy(),
               jm(paddle.to_tensor(x)).numpy()) <= TOL


def test_factories_seed_place_and_refuse_pretrained():
    a = PM.mobilenet_v1(num_classes=3, device="cpu", seed=1)
    b = PM.mobilenet_v1(num_classes=3, device="cpu", seed=1)
    c = PM.mobilenet_v1(num_classes=3, device="cpu", seed=2)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    assert next(a.parameters()).device.type == "cpu"
    for name in ("mobilenet_v2", "vgg11", "densenet121", "googlenet",
                 "shufflenet_v2_x1_0", "inception_v3", "squeezenet1_1",
                 "alexnet"):
        with pytest.raises(ValueError, match="pretrained"):
            getattr(PM, name)(pretrained=True, device="cpu")


def test_parameter_names_are_the_jax_ones():
    paddle.seed(0)
    for name in ("shufflenet_v2_x0_25", "squeezenet1_1"):
        jm = getattr(JM, name)(num_classes=5)
        pm = getattr(PM, name)(num_classes=5, device="cpu")
        assert [n for n, _ in pm.named_parameters()] == [
            n for n, _ in jm.named_parameters()]
        assert set(pm.state_dict()) == set(jm.state_dict())
