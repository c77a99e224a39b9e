"""The plain STTFlowNet of a configuration."""

from __future__ import annotations

from .. import stt_model


def build(program: dict):
    """STTFlowNet of a config in the program's schema."""
    model, st = program["model"], program["swin_transformer"]
    crop = program["loader"]["crop"]
    data = program.get("data", {})
    arc, embed = st["use_arc"]
    swin = stt_model.SwinConfig(
        arc_type=arc, patch_embed_type=embed, input_size=tuple(crop),
        patch_size=tuple(st["swin_patch_size"]),
        depths=tuple(st["swin_depths"]), num_heads=tuple(st["swin_num_heads"]),
        out_indices=tuple(st["swin_out_indices"]),
        window_size=tuple(st["window_size"]),
        pretrained_window_size=tuple(st.get("pretrained_window_size",
                                            (0, 0, 0))),
        mlp_ratio=float(st.get("mlp_ratio", 4.0)),
        drop_path_rate=float(st.get("drop_path_rate", 0.2)))
    bins = int(data.get("num_frames", 10)) * int(data.get("num_chunks", 1))
    return stt_model.STTFlowNet(
        swin, num_bins=model.get("num_bins", 10),
        base_num_channels=model.get("base_num_channels", 96),
        kernel_size=model.get("kernel_size", 3), num_encoders=len(
            st["swin_depths"]),
        use_upsample_conv=model.get("use_upsample_conv", True),
        norm=model.get("norm"), final_activation=model.get("final_activation"),
        norm_input=bool(model.get("norm_input", False)),
        encoding=model.get("encoding", "voxel"), input_bins=bins)
