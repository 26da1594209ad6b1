"""Named model presets (counterpart of ``spiking_fullsubnet_tpu/models/presets.py``)."""

from __future__ import annotations


def flagship_m(seed: int = 0, device=None, **overrides):
    """Spiking-FullSubNet M (954k params) as the JAX package's flagship
    preset (baseline_m.toml [model.args]: fb 320 x 2, sb 224 x 2, cutoffs
    [32, 128], df [5, 3, 1], centres [4, 32, 64], neighbours [15, 15, 15],
    pre-LayerNorm, BN, shared weights): a ``build`` bundle with random
    weights from ``seed`` on ``device`` (default ``cuda``)."""
    from .spiking_fullsubnet import build

    args = dict(
        n_fft=512,
        hop_length=128,
        win_length=512,
        fdrc=0.5,
        fb_input_size=64,
        fb_hidden_size=320,
        fb_num_layers=2,
        fb_proj_size=64,
        fb_output_activate_function=False,
        sb_hidden_size=224,
        sb_num_layers=2,
        freq_cutoffs=[0, 32, 128, 256],
        df_orders=[5, 3, 1],
        center_freq_sizes=[4, 32, 64],
        neighbor_freq_sizes=[15, 15, 15],
        use_pre_layer_norm_fb=True,
        use_pre_layer_norm_sb=True,
        bn=True,
        shared_weights=True,
        sequence_model="GSN",
        num_spks=1,
    )
    args.update(overrides)
    return build(seed=seed, device=device, **args)
