"""The port's U-Net translators and pixel-wise autoencoders against the JAX
package's: the same seeded inputs, flax weights drawn from a seed (kernels,
biases and BatchNorm parameters and statistics, so each of them and the
transposed convs' layout count) carried across by ``models.convert``,
outputs within rtol 1e-4, atol 1e-5 (``tests/test_models.py``). A
reference-named torch state dict loads into the port with ``strict=True``.
The translators' pad wrapper against JAX's."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as tnn

from mdir_tpu.learning.wrappers import \
    ReflectPadMakeDivisible as JaxReflectPad
from mdir_tpu.models import MODEL_LABELS as JAX_MODEL_LABELS
from mdir_tpu.models import autoencoder as jax_autoencoder
from mdir_tpu.models import initialize_model as jax_initialize_model
from mdir_tpu.models import torch_import
from mdir_tpu.models import unet as jax_unet

from mdir_tpu_torch.learning.wrappers import ReflectPadMakeDivisible
from mdir_tpu_torch.models import MODEL_LABELS, initialize_model
from mdir_tpu_torch.models.convert import from_jax_variables

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, old)


def seeded_variables(module, hw, rng):
    """The flax variables of ``module`` (shapes from ``jax.eval_shape``, no
    init compile) drawn from ``rng``: kernels N(0, 1/fan_in), biases and
    BatchNorm parameters and statistics around their defaults, variances
    positive."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + hw + (3,), jnp.float32))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            value = rng.randn(*leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        elif name == "var":
            value = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            value = (name == "scale") + 0.1 * rng.randn(*leaf.shape)
        return value.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


# (flax class, factory keys, input (H, W)): the p2p family at 2 nested
# levels (3 stride-2 stages) with its BatchNorm/bias/Dropout options, the
# resize-convolution variant at an odd size, the classic U-Net, and the
# three autoencoders
CASES = [
    (jax_unet.P2pUNet, {"nested_levels": 2}, (40, 48)),
    (jax_unet.ShallowP2pUNet, {"nested_levels": 2}, (40, 48)),
    (jax_unet.OutconvP2pUNet, {"nested_levels": 2, "batchnorm": True,
                               "dropout": 0.5}, (40, 48)),
    (jax_unet.InconvP2pUNet, {"nested_levels": 2}, (40, 48)),
    (jax_unet.AlignedP2pUNet, {"nested_levels": 2}, (40, 48)),
    (jax_unet.OutconvP2pUNetDynamicInterpolate,
     {"nested_levels": 2, "batchnorm": True}, (37, 45)),
    (jax_unet.OutconvP2pUNetDynamicInterpolate,
     {"nested_levels": 2, "upsample": "nearest"}, (37, 45)),
    (jax_unet.OrigUNet, {"nested_levels": 2}, (40, 48)),
    (jax_autoencoder.PixelConvRegr, {"hidden": [8]}, (21, 17)),
    (jax_autoencoder.PixelConvRes,
     {"hidden": [8, 5], "out_channels": 2, "hidden_activation": "tanh"},
     (21, 17)),
    (jax_autoencoder.AutoencoderRegr,
     {"hidden": [8, 4], "reception_field": 5}, (21, 17)),
]
LABELS = {cls: label for label, cls in (
    ("p2p_unet", jax_unet.P2pUNet),
    ("shallow_p2p_unet", jax_unet.ShallowP2pUNet),
    ("outconv_unet", jax_unet.OutconvP2pUNet),
    ("inconv_p2p_unet", jax_unet.InconvP2pUNet),
    ("aligned_p2p_unet", jax_unet.AlignedP2pUNet),
    ("outconv_dynint_unet", jax_unet.OutconvP2pUNetDynamicInterpolate),
    ("orig_unet", jax_unet.OrigUNet),
    ("pixelconv_regr", jax_autoencoder.PixelConvRegr),
    ("pixelconv_res", jax_autoencoder.PixelConvRes),
    ("autoencoder_regr", jax_autoencoder.AutoencoderRegr))}


@pytest.mark.parametrize("cls,keys,hw", CASES,
                         ids=["%s-%d" % (LABELS[c[0]], i) for i, c in
                              enumerate(CASES)])
def test_model_matches_jax(cls, keys, hw):
    keys = {"in_channels": 3, "out_channels": 3, **keys}
    rng = np.random.RandomState(0)
    module = cls(**{k: tuple(v) if k == "hidden" else v
                    for k, v in keys.items()})
    variables = seeded_variables(module, hw, rng)
    port = initialize_model({"architecture": LABELS[cls], **keys},
                            device="cpu")
    port.load_state_dict(from_jax_variables(variables), strict=True)

    x = rng.rand(2, *hw, 3).astype(np.float32) * 2 - 1
    ref = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        ours = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_registry_meta_matches_jax():
    params = {"architecture": "p2p_unet", "in_channels": 3,
              "out_channels": 2, "nested_levels": 1}
    assert initialize_model(dict(params), device="cpu").meta \
        == jax_initialize_model(dict(params)).meta \
        == {"in_channels": 3, "out_channels": 2}
    # every label of the JAX package's registry builds in the port
    assert set(LABELS.values()) | {"identity", "cirnet", "cirnet_branched"} \
        == set(MODEL_LABELS) == set(JAX_MODEL_LABELS)


def test_identity_passes_through():
    port = initialize_model({"architecture": "identity"}, device="cpu")
    x = torch.randn(2, 3, 5, 7)
    assert torch.equal(port(x), x)
    assert port.meta == jax_initialize_model(
        {"architecture": "identity"}).meta


class TorchSkip(tnn.Module):
    """The reference's pix2pix skip block (``tests/test_models.py``)."""

    def __init__(self, nested, outer_ch, inter_ch):
        super().__init__()
        mods = [tnn.Conv2d(outer_ch, inter_ch, 4, 2, 1, bias=False)]
        if nested:
            mods += [tnn.BatchNorm2d(inter_ch), tnn.LeakyReLU(0.2), nested]
        else:
            mods += [tnn.ReLU()]
        nested_ch = inter_ch * (2 if nested else 1)
        mods += [tnn.ConvTranspose2d(nested_ch, outer_ch, 4, 2, 1,
                                     bias=False),
                 tnn.BatchNorm2d(outer_ch), tnn.ReLU()]
        self.nested = tnn.Sequential(*mods)

    def forward(self, x):
        return torch.cat([x, self.nested(x)], dim=1)


def reference_p2p_unet(nested_levels, seed):
    """The reference torch P2pUNet's ``Sequential``, with seeded BatchNorm
    statistics and affine parameters."""
    torch.manual_seed(seed)
    blocks = [(64, 128), (128, 256), (256, 512), (512, 512)][:nested_levels]
    inner = None
    for cin, cout in reversed(blocks):
        inner = TorchSkip(inner, cin, cout)
    net = tnn.Sequential(
        tnn.Conv2d(3, 64, 4, 2, 1, bias=False), tnn.LeakyReLU(0.2), inner,
        tnn.ConvTranspose2d(128, 3, 4, 2, 1, bias=True), tnn.Tanh())
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, tnn.BatchNorm2d):
                module.running_mean.normal_(0, 0.1)
                module.running_var.uniform_(0.5, 1.5)
                module.weight.normal_(1, 0.1)
                module.bias.normal_(0, 0.1)
    return net.eval()


def test_reference_state_dict_loads_strict_and_matches():
    """A reference-named P2pUNet state dict loads as it is (num_batches_tracked
    included, as torch writes it) and gives the reference's output; the JAX
    package reads the same numbers to the same output."""
    from mdir_tpu_torch.learning.network import _restore_weights

    ref_net = reference_p2p_unet(2, seed=0)
    state = {"outerblock." + k: v for k, v in ref_net.state_dict().items()}
    assert any(k.endswith("num_batches_tracked") for k in state)
    params = {"architecture": "p2p_unet", "in_channels": 3,
              "out_channels": 3, "nested_levels": 2}
    port = initialize_model(params, device="cpu")
    _restore_weights(port, state)

    x = np.random.RandomState(1).rand(1, 3, 40, 56).astype(np.float32)
    with torch.no_grad():
        expected = ref_net(torch.from_numpy(x)).numpy()
        ours = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, expected, rtol=RTOL, atol=ATOL)

    module = jax_unet.P2pUNet(nested_levels=2)
    variables = torch_import.import_state_dict(
        seeded_variables(module, (40, 56), np.random.RandomState(2)),
        {k: v.numpy() for k, v in state.items()})
    theirs = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(
        x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("hw,divisor", [((100, 90), 32), ((64, 64), 32),
                                        ((33, 47), 8), ((5, 3), 4)])
def test_reflectpad_divisible_matches_jax(hw, divisor):
    x = np.random.RandomState(2).rand(1, *hw, 3).astype(np.float32)
    theirs = JaxReflectPad(divisor)
    ours = ReflectPadMakeDivisible(divisor)
    ref, ref_meta = theirs.preprocess(jnp.asarray(x), None)
    out, meta = ours.preprocess(torch.from_numpy(x).permute(0, 3, 1, 2),
                                None)
    assert meta == ref_meta
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(ref))
    assert all(side % divisor == 0 for side in out.shape[-2:])
    back = ours.postprocess(out * 2, None, meta)
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(theirs.postprocess(ref * 2, None,
                                                                ref_meta)))
    np.testing.assert_array_equal(back.permute(0, 2, 3, 1).numpy(), 2 * x)
    with pytest.raises(ValueError, match="crops"):
        ours.postprocess(torch.zeros(8, 1), None, meta)
