"""PyTorch port vs the JAX package: the SEW SpikingformerFlowNet of the
SNN zoo through the registry, float64, on the tiny zoo geometry
(``torch_port_harness.zoo_pair``: T = 4, base 8, depths (1, 1, 1), window
(2, 3, 3), 32x32). Each case is one of the ten patch embeds with another
neuron and norm, so that every neuron type (if, lif, slttlif, plif, psn,
glif), every norm JAX accepts (BN, BN_notrack, TDBN, BNTT, GN, IN, LN),
both swin versions and both decoders are held against JAX, in eval and in
train mode with the running statistics (``torch_port_zoo_cases``); the
other embeds are in ``test_torch_port_zoo_embeds.py``. The first case is
the card's geometry cut down: Conv_sfn embed, PSN + BN, swin-v1, a shifted
block (the shift mask)."""

import pytest

from torch_port_harness import zoo_pair
from torch_port_zoo_cases import (  # noqa: F401
    eval_and_train_match, one_torch_thread)

CASES = {
    "conv_sfn-psn-BN-shift": dict(depths=(2, 1, 1)),
    "ms_conv_sfn-lif-BN-upsample": dict(
        patch_embed_type="MS_Spiking_PatchEmbed_Conv_sfn", neuron_type="lif",
        model_cfg={"use_upsample_conv": True}),
    "sfn-if-GN": dict(patch_embed_type="Spiking_PatchEmbed_sfn",
                      neuron_type="if", spike_norm="GN", v_reset=0.0),
    "ms_sfn-slttlif-BNTT": dict(patch_embed_type="MS_Spiking_PatchEmbed_sfn",
                                neuron_type="slttlif", spike_norm="BNTT"),
    "conv-plif-TDBN": dict(patch_embed_type="Spiking_PatchEmbed_Conv",
                           neuron_type="plif", spike_norm="TDBN"),
    "v2-psn-BN-shift": dict(arc_type="swinv2", depths=(2, 1, 1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sew_flownet_matches_jax_f64(case):
    jmodel, tmodel = zoo_pair("SpikingformerFlowNet", **CASES[case])
    eval_and_train_match(jmodel, tmodel)
