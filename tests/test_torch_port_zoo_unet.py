"""PyTorch port vs the JAX package: MS_SpikingformerFlowNet and
SpikingMultiResUNet, float64, eval and train mode with the running
statistics (``torch_port_zoo_cases``), on the tiny zoo geometry of
``torch_port_harness.zoo_pair`` (T = 4, base 8, 32x32):

- MS_SpikingformerFlowNet with its MS_PED embed (K1's plain twin in eval,
  the pair-local form in train), with a temporal window of 3 and of 1 (the
  raw-refold attention in both modes);
- SpikingMultiResUNet with the registry's defaults (SEW, sfn regroup,
  upsample-conv decoders), and built directly MS with the chunk regroup and
  transposed-conv decoders.
"""

import pytest

from sdformerflow_tpu.models.snn_flownet import (
    SpikingMultiResUNetFlow as JUNet)
from sdformerflow_tpu_torch.models.common import SpikingConfig
from sdformerflow_tpu_torch.models.snn_flownet import SpikingMultiResUNetFlow

from torch_port_harness import JSpikingConfig, zoo_pair
from torch_port_zoo_cases import (  # noqa: F401
    eval_and_train_match, one_torch_thread)

PED = "MS_PED_Spiking_PatchEmbed_Conv_sfn"
CASES = {
    "ms-ped-psn-BN": dict(patch_embed_type=PED, depths=(2, 1, 1)),
    "ms-ped-window3-upsample": dict(
        patch_embed_type=PED, window_size=(3, 3, 3),
        model_cfg={"use_upsample_conv": True}),
    "ms-ped-window1-plif": dict(patch_embed_type=PED, window_size=(1, 3, 3),
                                neuron_type="plif"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ms_flownet_matches_jax_f64(case):
    jmodel, tmodel = zoo_pair("MS_SpikingformerFlowNet", **CASES[case])
    eval_and_train_match(jmodel, tmodel)


def test_spiking_unet_registry_defaults_match_jax_f64():
    jmodel, tmodel = zoo_pair("SpikingMultiResUNet")
    assert type(tmodel.decoder0).__name__ == "SpikingDecoderLayer"
    assert tuple(tmodel.encoder0.conv.weight.shape) == (16, 2, 5, 5)
    eval_and_train_match(jmodel, tmodel)


def test_spiking_unet_ms_chunk_transpose_matches_jax_f64():
    kw = dict(num_steps=4, v_th=0.3, neuron_type="lif", spike_norm="BNTT")
    net = dict(num_bins=4, base_num_channels=8, use_upsample_conv=False,
               input_sfn=False, ms=True)
    jmodel = JUNet(cfg=JSpikingConfig(**kw), **net)
    tmodel = SpikingMultiResUNetFlow(SpikingConfig(**kw), **net)
    assert type(tmodel.decoder0).__name__ == \
        "MSSpikingTransposeDecoderLayer"
    eval_and_train_match(jmodel, tmodel)
