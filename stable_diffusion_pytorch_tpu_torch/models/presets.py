"""Model-size presets (the JAX package's models/presets.py; a test pins them equal).

``sd15``: the Stable-Diffusion-1.5-scale stack, UNet channels 320/640/1280/1280
with 8 heads and attention at latent 64^2/32^2/16^2 plus the 8^2 bottleneck,
an f8 VAE (128/256/512/512, 32 groups) and the linear 1000-step schedule.
"""

from stable_diffusion_pytorch_tpu_torch.config import AutoencoderConfig, DDPMConfig, UnetConfig


def reference_unet_config() -> UnetConfig:
    return UnetConfig()


def sd15_unet_config() -> UnetConfig:
    return UnetConfig(
        num_res_blocks=2,
        n_heads=8,
        attention_resolutions=[1, 2, 4],
        channels_list=[320, 640, 1280, 1280],
        time_emb_dim=1280,
        dropout=0.0,
        n_layers=1,
        context_dim=768,
    )


def sd15_autoencoder_config() -> AutoencoderConfig:
    return AutoencoderConfig(
        in_channels=3,
        latent_channels=4,
        out_channels=3,
        autoencoder_channels_list=[128, 256, 512, 512],
        autoencoder_num_res_blocks=2,
        groups=32,
        kl_weight=1.0,
    )


def sd15_ddpm_config() -> DDPMConfig:
    return DDPMConfig(noise_schedule="linear", noise_steps=1000)
