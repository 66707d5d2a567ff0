"""The port's DiT against the JAX package's, on the CPU.

The JAX model's ``state_dict`` (numpy) loads into the port's through
``models.convert.load_reference_state`` unchanged: every ``nn.Linear``
weight transposed, ``pos_embed`` [1, n, d], the ``num_classes + 1``-row
``y_embed`` and the zero ``ada`` projections as they are. On those
weights the forward agrees within 1e-5 (``DiTConfig.tiny()`` and
``tiny(learn_sigma=True)``, depth 2, and one block at ``dit_b_4``'s and
``dit_xl_2``'s widths, whose d 72 takes the math form), and one ``TrainStep``
with AdamW, run 3 times on the bench's MSE-to-noise loss, gives JAX's
losses within 1e-5 and its parameters within 1e-5 relative L2.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import dit as jax_dit
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    DiT,
    DiTConfig,
    dit_b_4,
    dit_xl_2,
    load_reference_state,
)
from paddle_tpu_torch.models.dit import _timestep_embedding
from paddle_tpu_torch.optimizer import AdamW

TOL = dict(atol=1e-5, rtol=1e-5)
CONFIGS = {"tiny": {}, "tiny_learn_sigma": {"learn_sigma": True}}


def _jax_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _perturb_ada(jax_model, seed=3):
    """Non-zero ``ada`` (JAX initialises it to zero, so every block would
    be the identity) on the JAX side, before the state is copied."""
    rng = np.random.RandomState(seed)
    state = _jax_state(jax_model)
    for k in state:
        if ".ada." in k:
            state[k] = (0.05 * rng.randn(*state[k].shape)).astype(np.float32)
    jax_model.set_state_dict({k: paddle.to_tensor(v)
                              for k, v in state.items()})
    return state


def _inputs(cfg, b=2, seed=4):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, cfg.in_channels, cfg.input_size,
                  cfg.input_size).astype(np.float32)
    t = rng.randint(0, 1000, (b,)).astype(np.int32)
    y = rng.randint(0, cfg.num_classes, (b,)).astype(np.int64)
    target = rng.randn(*x.shape).astype(np.float32)
    return x, t, y, target


def _pair(over, seed=0):
    paddle.seed(seed)
    jm = jax_dit.DiT(jax_dit.DiTConfig.tiny(**over))
    pm = DiT(DiTConfig.tiny(**over), device="cpu")
    return jm, pm


def test_reference_state_loads_as_it_is():
    jm, pm = _pair({})
    state = _jax_state(jm)
    load_reference_state(pm, state)
    cfg = pm.config
    n = (cfg.input_size // cfg.patch_size) ** 2
    assert tuple(pm.pos_embed.shape) == (1, n, cfg.hidden_size)
    np.testing.assert_array_equal(pm.pos_embed.detach().numpy(),
                                  state["pos_embed"])
    assert tuple(pm.y_embed.weight.shape) == (cfg.num_classes + 1,
                                              cfg.hidden_size)
    np.testing.assert_array_equal(pm.y_embed.weight.detach().numpy(),
                                  state["y_embed.weight"])
    np.testing.assert_array_equal(pm.blocks[0].qkv.weight.detach().numpy(),
                                  state["blocks.0.qkv.weight"].T)
    np.testing.assert_array_equal(
        pm.t_embed.fc1.weight.detach().numpy(), state["t_embed.fc1.weight"].T)
    for blk in pm.blocks:
        assert not blk.ada.weight.any() and not blk.ada.bias.any()
    # the port's own initialisation draws pos_embed as the JAX package
    # does, and zeroes ada too
    own = DiT(DiTConfig.tiny(), device="cpu")
    np.testing.assert_array_equal(own.pos_embed.detach().numpy(),
                                  state["pos_embed"])
    assert not any(blk.ada.weight.any() for blk in own.blocks)
    assert sorted(dict(own.named_parameters())) == sorted(state)


def test_timestep_embedding_matches_jax():
    t = np.array([0, 1, 17, 999], np.int32)
    got = _timestep_embedding(torch.from_numpy(t), 256)
    want = jax_dit._timestep_embedding(paddle.to_tensor(t), 256)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_forward_matches_jax(config):
    jm, pm = _pair(CONFIGS[config])
    load_reference_state(pm, _perturb_ada(jm))
    x, t, y, _ = _inputs(pm.config)
    want = jm(paddle.to_tensor(x), paddle.to_tensor(t),
              paddle.to_tensor(y)).numpy()
    got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    assert got.shape == want.shape == (
        2, pm.out_channels, pm.config.input_size, pm.config.input_size)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


NAMED = {"dit_b_4": dit_b_4, "dit_xl_2": dit_xl_2}


@pytest.mark.parametrize("name", sorted(NAMED))
def test_named_configs_are_jax_s(monkeypatch, name):
    # the named models build the JAX package's configs (caught before
    # the build: dit_xl_2 holds 675M parameters)
    seen = {}

    def capture(key):
        def build(config, *args, **kwargs):
            seen[key] = dict(vars(config))
        return build

    monkeypatch.setattr(jax_dit, "DiT", capture("jax"))
    getattr(jax_dit, name)(num_classes=10)
    import paddle_tpu_torch.models.dit as port_dit
    monkeypatch.setattr(port_dit, "DiT", capture("port"))
    NAMED[name](num_classes=10)
    assert seen["port"] == seen["jax"]


@pytest.mark.parametrize("name,input_size", [("dit_b_4", 8),
                                             ("dit_xl_2", 4)])
def test_named_widths_one_block_match_jax(name, input_size):
    # one block at the named models' widths (d 64 for b_4; d 72 for
    # xl_2, not a flash head dim); their depth is fixed, so the block
    # is built from the config
    over = {"dit_b_4": dict(patch_size=4, hidden_size=768, num_heads=12),
            "dit_xl_2": dict(patch_size=2, hidden_size=1152,
                             num_heads=16)}[name]
    over.update(depth=1, input_size=input_size, num_classes=10)
    paddle.seed(0)
    jm = jax_dit.DiT(jax_dit.DiTConfig(**over))
    pm = DiT(DiTConfig(**over), device="cpu")
    cfg = pm.config
    load_reference_state(pm, _perturb_ada(jm))
    x, t, y, _ = _inputs(cfg)
    want = jm(paddle.to_tensor(x), paddle.to_tensor(t),
              paddle.to_tensor(y)).numpy()
    got = pm(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5,
                               rtol=1e-5)


def _mse(m, x, t, y, target):
    # with learn_sigma the first c channels are the noise prediction
    return ((m(x, t, y)[:, :target.shape[1]] - target) ** 2).mean()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_step_matches_jax(config):
    # bench.py's step (AdamW, MSE against a noise target) from the JAX
    # model's own initial weights (ada zero), 3 calls of one TrainStep.
    # With ada zero the first step's gradients of the attention and MLP
    # weights are exactly 0 and the second's tiny: an element at f32
    # rounding noise (the two frameworks' summation orders disagreeing
    # in sign) moves by ~lr whichever way the rounding tips when epsilon
    # is tiny. epsilon = 1e-3 keeps each step proportional to the
    # gradient there, as in test_torch_train.
    jm, pm = _pair(CONFIGS[config], seed=1)
    load_reference_state(pm, _jax_state(jm))
    kw = dict(learning_rate=1e-3, epsilon=1e-3)
    jstep = paddle.jit.TrainStep(
        jm, _mse, paddle.optimizer.AdamW(parameters=jm.parameters(), **kw),
        donate=False)
    tstep = TrainStep(pm, _mse, AdamW(parameters=pm.named_parameters(),
                                      **kw))
    data = _inputs(pm.config, b=4, seed=5)
    jl = [float(jstep(*(paddle.to_tensor(a) for a in data)).numpy())
          for _ in range(3)]
    tl = [tstep(*(torch.from_numpy(a) for a in data)).item()
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0]
    jparams = dict(jm.named_parameters())
    linear = {f"{n}.weight" for n, m in pm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in pm.named_parameters():
        want = jparams[name].numpy()
        want = want.T if name in linear else want
        got = p.detach().numpy()
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-5, (name, rel)


def test_dit_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiT(DiTConfig.tiny())
