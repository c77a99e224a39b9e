"""The plain MS_SpikingformerFlowNet_en4 (SDformerFlow) of a configuration."""

from __future__ import annotations


def build(program: dict):
    """MS_SpikingformerFlowNet_en4 of a config in the program's schema,
    built as the program's registry builds it, from the frozen copy of its
    model code (``reference/snn``)."""
    from ..snn.common import SpikingConfig, SwinConfig
    from ..snn.snn_flownet import SpikingformerFlowNet
    model = dict(program.get("model", {}))
    sn = model.get("spiking_neuron") or program.get("spiking_neuron") or {}
    sig = "sigmoid" in str(sn.get("surrogate_fun") or "").lower()
    spiking = SpikingConfig(
        num_steps=int(sn.get("num_steps", 10)),
        v_th=float(sn.get("v_th", 1.0)),
        v_reset=(None if sn.get("v_reset") is None
                 else float(sn.get("v_reset"))),
        neuron_type=str(sn.get("neuron_type", "lif")),
        surrogate="sigmoid" if sig else "atan",
        surrogate_alpha=4.0 if sig else 2.0,
        tau=float(sn.get("tau", 2.0)),
        detach_reset=bool(sn.get("detach_reset", True)),
        spike_norm=sn.get("spike_norm", "BN"))
    st = program.get("swin_transformer", {}) or {}
    arc, embed = st["use_arc"]
    crop = program.get("loader", {}).get("crop")
    swin = SwinConfig(
        arc_type=arc, patch_embed_type=embed,
        input_size=tuple(int(v) for v in st.get("input_size",
                                                crop or (288, 384))),
        patch_size=tuple(int(v) for v in st["swin_patch_size"]),
        depths=tuple(int(v) for v in st["swin_depths"]),
        num_heads=tuple(int(v) for v in st["swin_num_heads"]),
        out_indices=tuple(int(v) for v in st["swin_out_indices"]),
        window_size=tuple(int(v) for v in st["window_size"]),
        pretrained_window_size=tuple(
            int(v) for v in st.get("pretrained_window_size", (0, 0, 0))),
        mlp_ratio=float(st.get("mlp_ratio", 4.0)),
        qk_scale=st.get("qk_scale", 0.125),
        drop_path_rate=float(st.get("drop_path_rate", 0.2)))
    return SpikingformerFlowNet(
        swin=swin, cfg=spiking, num_bins=model.get("num_bins", 10),
        base_num_channels=model.get("base_num_channels", 96),
        kernel_size=model.get("kernel_size", 3), num_encoders=4,
        use_upsample_conv=model.get("use_upsample_conv", False), ms=True)
