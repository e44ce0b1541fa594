"""The FLOP counter on the reference trunks, and the trunks' output
sizes."""
import pytest
import torch

from reference import flops, nets


@pytest.mark.parametrize("arch,cfg,gmac", [
    ("vgg", nets.VGG16, 15.35), ("resnet", nets.RESNET101, 7.80)])
def test_published_gmac_at_224(arch, cfg, gmac):
    assert flops.trunk_flops(arch, cfg, (224, 224)) / 2e9 \
        == pytest.approx(gmac, abs=0.006)


@pytest.mark.parametrize("arch,cfg", [("vgg", [8, "M", 16, "M", 32, "M"]),
                                      ("resnet", [1, 1, 1, 1])])
@pytest.mark.parametrize("hw", [(64, 48), (37, 91), (33, 17)])
def test_feature_hw_is_the_forward_size(arch, cfg, hw):
    gen = torch.Generator().manual_seed(0)
    params = nets.draw_params(arch, cfg, gen, "cpu")
    out = nets.features(arch, cfg, params, torch.rand((1, 3) + hw))
    assert tuple(out.shape[2:]) == nets.feature_hw(arch, cfg, hw)
    assert out.shape[1] == nets.out_channels(arch, cfg)


def test_flops_grow_with_the_pixels():
    small = flops.trunk_flops("vgg", nets.VGG16, (512, 384))
    big = flops.trunk_flops("vgg", nets.VGG16, (1024, 768))
    assert big == pytest.approx(4 * small, rel=0.01)
