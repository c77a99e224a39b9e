"""PyTorch port vs the JAX package: the SEW SpikingformerFlowNet with the
patch embeds ``test_torch_port_zoo_models.py`` leaves to this file (the
two Local embeds, MS_Spiking_PatchEmbed_Conv and
MS_Spiking_PatchEmbed_Conv_Local), float64, eval and train mode with the
running statistics (``torch_port_zoo_cases``), on the tiny zoo geometry of
``torch_port_harness.zoo_pair``."""

import pytest

from torch_port_harness import zoo_pair
from torch_port_zoo_cases import (  # noqa: F401
    eval_and_train_match, one_torch_thread)

CASES = {
    "local-psn-BN_notrack": dict(patch_embed_type="Spiking_PatchEmbedLocal",
                                 spike_norm="BN_notrack"),
    "ms_local-psn-IN": dict(patch_embed_type="MS_Spiking_PatchEmbedLocal",
                            spike_norm="IN"),
    # 4 stages, 3 encoders: out_indices (1, 2, 3) with their LN norm{i}
    "ms_conv-glif-LN-out123": dict(
        patch_embed_type="MS_Spiking_PatchEmbed_Conv", neuron_type="glif",
        spike_norm="LN", depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
        out_indices=(1, 2, 3)),
    # 8 bins in 2 temporal blocks of T = 4: the stages run at D = 2
    "ms_conv_local-lif-BN": dict(
        patch_embed_type="MS_Spiking_PatchEmbed_Conv_Local",
        neuron_type="lif", model_cfg={"num_bins": 8}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sew_flownet_embed_matches_jax_f64(case):
    kw = dict(CASES[case])
    bins = kw.get("model_cfg", {}).get("num_bins", 4)
    jmodel, tmodel = zoo_pair("SpikingformerFlowNet", **kw)
    eval_and_train_match(jmodel, tmodel, num_bins=bins)
